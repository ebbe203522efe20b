"""Detector families: everything in the benchmark that depends on the
architecture, one module a family.

A configuration file names its family under `"family"` (without the key:
`pointpillars`); `harness.family` loads `benchmark/families/<name>.py`,
resolved as a traffic mix's name is, so that a relative name such as
`../tests/toy_family` finds a family kept beside the tests. A family
module is plain `torch` and `numpy` over the benchmark's own files: it
imports nothing of the program and nothing of JAX. It provides:

- `geometry(config_path)`: the grid, sizes and anchors of one
  configuration file, as the family's reference reads it (`run.geo`);
- `make_weights(seed, geo, device)`: the weights, made on the device from
  the seed, under the program's `state_dict` keys, which the program loads
  strictly and the reference is handed alike;
- `reference_network(weights, geo, device)`: the plain float32 reference
  holding a copy of those weights;
- `point_cloud(n, rng)`: one n-point sweep in the layout the model takes,
  drawn from a `numpy` generator (`traffic.cloud_pool` calls it);
- `reference_frame(net, points, geo, device)`: the reference's view of
  one sweep, worked out from the raw points once and judged against as
  often as there are answers to judge;
- `check_frame(expected, annos, where)` → `compare.Checked`: the
  program's annos of that sweep judged; the numbers compared, under the
  names of the configuration's `compare_limits`, the valid candidate count
  of each NMS row, and a line for the log;
- `control_annos(net, points, geo, device)`: the control's annos of one
  sweep, the reference computed in the precision below the
  configuration's (`benchmark/control.py`);
- `stage_calls(mod, points, num_points, stage, post)`: one group of frames
  through the program's stage functions, eagerly, each stage inside
  `with stage(name):` (the eager stage pass of a traced run; `post` is the
  program's `postprocess` module);
- `network_flops(geo)`: one frame's forward pass, two FLOPs per
  multiply-add; `scatter_bytes(geo, batch)`: one launch of the BEV scatter;
  `KERNELS`: the names in `counts.KERNELS` of the program's kernels that
  the family's frames run; `NMS_RANK_CAP`: the boxes an NMS row holds.

The faults of `benchmark/control.py` are planted in the program's entry
points and edit answers in the program's own output format, so every
family shares them.
"""

"""The readings that a detector cell's limits (`compare_limits`) are set from.

    python3 benchmark/control.py --workload NAME --seeds 12 [--control-seeds 3] [--first-seed N]

For each seed, in one process, at the cell's own sizes: the weights and
the inputs as a run makes them, the program's answers through the cell's
timed entry (`Detector.detect` for a stream, `infer_batch_jit` at the
mix's batch for offline batches) on as many frames as a run compares
and, on the first `--control-seeds` seeds, the control (the plain
reference in the program's place, computed in float8 e4m3, the precision
below the configuration's bfloat16) and each fault of `FAULTS` that the
cell's kind can have, planted in the program's timed entry. The
configuration's family (`benchmark/families/<family>.py`) makes the
weights, the sweeps, the float32 reference, the control and the judgement.
Prints one line a seed, reading and number compared, then per number the
largest program reading and the smallest control and fault readings. The
benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark.lib import harness, traffic  # noqa: E402


def alter_answer(det) -> None:
    """The first kept box of every `detect` call placed a body length off."""
    inner = det.detect

    def detect(points):
        annos = inner(points)
        if len(annos["location"]):
            annos["location"] = annos["location"].copy()
            annos["location"][0, 0] += annos["dimensions"][0, 0]
        return annos

    det.detect = detect


def _batch_fault(edit):
    def plant(det) -> None:
        inner = det.infer_batch_jit

        def infer_batch_jit(points, counts):
            return edit(inner(points, counts))

        det.infer_batch_jit = infer_batch_jit
    return plant


@_batch_fault
def alter_batch_answer(out):
    """Frame 0's first kept box of each class placed a body length off."""
    boxes = out.boxes.clone()
    boxes[0, :, 0, 0] += boxes[0, :, 0, 3]
    return out._replace(boxes=boxes)


@_batch_fault
def leave_out_half(out):
    """The second half of the batch comes back with nothing kept."""
    valid = out.valid.clone()
    valid[valid.shape[0] // 2:] = False
    return out._replace(valid=valid)


# the faults a cell of each kind can have, each planted in the program's detector
FAULTS = {"stream": {"answer_altered": alter_answer},
          "offline": {"answer_altered": alter_batch_answer, "half_batch_empty": leave_out_half}}


def program_answers(det, cfg, mix: dict, frames: list[np.ndarray]) -> list[dict]:
    from det3d_tpu_torch.postprocess import Detections, to_annos

    if mix["kind"] == "stream":
        return [det.detect(f) for f in frames]
    b, out = mix["batch"], []
    for i in range(0, len(frames), b):
        padded = [det.pad_points(f) for f in frames[i:i + b]]
        dets = det.infer_batch_jit(np.stack([p for p, _ in padded]), np.asarray([n for _, n in padded], np.int32))
        out += [to_annos(cfg, Detections(dets.boxes[j], dets.scores[j], dets.valid[j])) for j in range(b)]
    return out


def readings(workload: str, seeds: list[int], control_seeds: int, device: str = "cuda", spec=None) -> dict:
    from det3d_tpu_torch.config import load_config
    from det3d_tpu_torch.pipeline import Detector

    spec = spec or harness.load_spec()
    cell = harness.find_cell(spec, workload)
    config = next(c for c in spec["configs"] if c["name"] == cell["config"])
    path = harness.ROOT / config["file"]
    mix = json.loads((harness.BENCH / "traffic" / f"{cell['traffic']}.json").read_text())
    fam = harness.family(json.loads(path.read_text()))
    cfg, geo = load_config(path), fam.geometry(path)
    n_frames = mix.get("compare", mix.get("compare_batches", 1) * mix.get("batch", 1))
    faults = FAULTS[mix["kind"]]
    out = {"program": [], "control": [], **{name: [] for name in faults}}
    for si, seed in enumerate(seeds):
        w = fam.make_weights(seed, geo, device)
        pool = traffic.cloud_pool(mix, seed, fam.point_cloud)
        picks = traffic.rng(seed, 7).choice(len(pool), min(n_frames, len(pool)), replace=False)
        frames = [pool[int(i)] for i in picks]
        answers = {}
        for name, plant in [("program", None)] + (list(faults.items()) if si < control_seeds else []):
            det = Detector(cfg, device=device)
            det.load_state_dict(w)
            if plant is not None:
                plant(det)
            answers[name] = program_answers(det, cfg, mix, frames)
            del det
        net = fam.reference_network(w, geo, device)
        if si < control_seeds:
            answers["control"] = [fam.control_annos(net, f, geo, device) for f in frames]
        worst = {name: {} for name in answers}
        for i, f in enumerate(frames):
            expected = fam.reference_frame(net, f, geo, device)
            for name, a in answers.items():
                for number, v in fam.check_frame(expected, a[i], f"seed {seed} {name}").numbers.items():
                    worst[name][number] = max(worst[name].get(number, 0.0), v)
        for name, got in worst.items():
            out[name].append(got)
            for number, v in got.items():
                print(f"seed {seed}: {name} {number} {v:.6g}", flush=True)
        del net
        if device == "cuda":
            torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--first-seed", type=int, default=2**31 + 101)
    args = p.parse_args(argv)
    seeds = [args.first_seed + 7919 * i for i in range(args.seeds)]
    out = readings(args.workload, seeds, args.control_seeds)
    summary = {"workload": args.workload}
    for key, rows in out.items():
        if rows:
            pick = max if key == "program" else min
            summary[key] = {number: pick(r[number] for r in rows) for number in rows[0]}
    print(json.dumps({**summary, "readings": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

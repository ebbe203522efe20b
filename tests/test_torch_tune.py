"""The port's autotuner (`det3d_tpu_torch/tune.py`) and its `tune` command
on the CPU, on the pattern of tests/test_tune.py at its TINY config: the
levers are the JAX tuner's; a pack_w-only search measures and skips what
the JAX tuner's does and reports its keys; the tuned JSON loads and
carries the choices; the packed-only levers are skipped while pack_w is
off and measured once it is on; the blocked levers are skipped off the
card; each trial holds the host clock's ms (the deciding time on the CPU)
and no device ms. The levers' equality tests are elsewhere
(tests/test_torch_layouts.py, tests/test_torch_options.py); this checks
the search.
"""

from __future__ import annotations

import json

import pytest
import torch

from det3d_tpu_torch import cli
from det3d_tpu_torch import tune as T
from det3d_tpu_torch.config import load_config
from test_torch_tmpdirs import removed, tmp_path  # noqa: F401

torch.set_num_threads(1)

TINY = {
    "detection_range": [-16.0, -16.0, -2.5, 16.0, 16.0, 8.5],
    "center_limit": [-16.0, -16.0, -10.0, 16.0, 16.0, 10.0],
    "voxel_size": [1.0, 1.0, 11.0],
    "max_voxels": 256,
    "max_num_points": 5,
    "max_points": 2048,
    "max_gt_boxes": 8,
    "compute_dtype": "float32",
}
SMALL_RUN = dict(mode="both", infer_iters=2, train_iters=1, batch_size=1)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tune")
    path = tmp / "tiny.json"
    path.write_text(json.dumps(TINY))
    yield tmp, path
    removed(tmp)


@pytest.fixture(scope="module")
def pack_w_runs(tiny):
    """The port's and the JAX tuner's pack_w-only searches of TINY."""
    from det3d_tpu.tune import tune as jax_tune

    tmp, path = tiny
    port = T.tune(str(path), out_path=str(tmp / "port.json"), only_levers=("pack_w",), device="cpu", **SMALL_RUN)
    jax = jax_tune(str(path), out_path=str(tmp / "jax.json"), only_levers=("pack_w",), **SMALL_RUN)
    return port, jax


def test_levers_are_the_jax_tuners():
    from det3d_tpu.tune import LEVERS

    assert [(n, c, m) for n, c, m, _ in T.LEVERS] == [(n, c, m) for n, c, m, _ in LEVERS]
    assert {n for n, _, _, card_only in T.LEVERS if card_only} == {n for n, _, _, tpu in LEVERS if tpu}
    assert T.PACKED_ONLY == {n for n, _, _, _ in T.LEVERS} - {"pack_w"}
    cfg = load_config({})
    for name, candidates, _, _ in T.LEVERS:
        assert getattr(cfg, name) in candidates


def measured(report) -> set:
    return {k for m in report["modes"].values() for t in m["trials"] for k in t["levers"]}


def test_pack_w_search_matches_the_jax_report(pack_w_runs):
    port, jax = pack_w_runs
    assert set(jax) <= set(port) and port["timed_by"] == "host clock (cpu)"
    assert set(port["modes"]) == set(jax["modes"]) == {"infer", "train"}
    for name in ("infer", "train"):
        assert set(jax["modes"][name]) <= set(port["modes"][name])
        # infer measures the flip; train inherits the decision and times its baseline only
        assert len(port["modes"][name]["trials"]) == len(jax["modes"][name]["trials"]) == (2 if name == "infer" else 1)
        assert port["modes"][name]["final_ms"] <= port["modes"][name]["trials"][0]["ms"]
        for trial in port["modes"][name]["trials"]:
            assert trial["device_ms"] is None and trial["ms"] == trial["host_ms"] > 0
    assert measured(port) == measured(jax) == {"pack_w"}
    assert port["skipped"] == jax["skipped"] == []
    # the flip each tries is the other default: the port's network is dense
    assert port["modes"]["infer"]["trials"][1]["levers"] == {"pack_w": True}
    assert jax["modes"]["infer"]["trials"][1]["levers"] == {"pack_w": False}


def test_tuned_config_loads_and_carries_choices(pack_w_runs, tiny):
    tmp, _ = tiny
    port, _ = pack_w_runs
    raw = json.loads((tmp / "port.json").read_text())
    assert raw["_tuned_on"] == "cpu" and port["out"] == str(tmp / "port.json")
    cfg = load_config(str(tmp / "port.json"))
    for lever, value in port["chosen"].items():
        assert getattr(cfg, lever) == value
    assert cfg.max_voxels == TINY["max_voxels"] and cfg.max_points == TINY["max_points"]


def test_packed_only_levers_skip_while_pack_w_is_off(tiny):
    tmp, path = tiny
    report = T.tune(str(path), out_path=str(tmp / "off.json"), only_levers=("fuse_in_stats", "split_head",
                                                                             "block0_blocked", "late_blocked_train"),
                    device="cpu", **SMALL_RUN)
    assert measured(report) == set() and report["chosen"] == {}
    reasons = {s["lever"]: s["reason"] for s in report["skipped"]}
    assert reasons == {"fuse_in_stats": T.PACKED_ONLY_REASON, "split_head": T.PACKED_ONLY_REASON,
                       "block0_blocked": T.CARD_ONLY_REASON, "late_blocked_train": T.CARD_ONLY_REASON}
    assert reasons["fuse_in_stats"] == "acts on the packed network only; pack_w is off"


def test_packed_only_levers_are_measured_with_pack_w_on(tiny):
    tmp, path = tiny
    report = T.tune(str(path), out_path=str(tmp / "on.json"), only_levers=("fuse_in_stats", "split_head"),
                    config_overrides={"pack_w": True}, device="cpu", **dict(SMALL_RUN, mode="infer"))
    assert report["skipped"] == []
    flips = [t["levers"] for t in report["modes"]["infer"]["trials"][1:]]
    assert {"fuse_in_stats": False} in flips and any(f.get("split_head") is False for f in flips)


def test_unknown_lever_is_refused(tiny):
    _, path = tiny
    with pytest.raises(ValueError, match="unknown lever"):
        T.tune(str(path), only_levers=("scatter_subtile",), device="cpu")


def test_cli_tune_writes_the_report_and_the_tuned_json(tiny):
    tmp, path = tiny
    report = tmp / "report.json"
    cli.main(["tune", "--config", str(path), "--device", "cpu", "--levers", "pack_w", "--iters", "2",
              "--train-iters", "1", "--batch-size", "1", "--report", str(report)])
    got = json.loads(report.read_text())
    assert set(got["modes"]) == {"infer", "train"} and got["out"] == str(tmp / "tiny_torch_tuned.json")
    assert json.loads((tmp / "tiny_torch_tuned.json").read_text())["_tuned_on"] == "cpu"

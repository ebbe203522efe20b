"""A second detector family for the CPU tests, made of this file alone:
PointPillars' reference, weights, sweeps, stage calls and yardstick,
judged under a number of its own, `toy_gap`, the larger of `det_gap`'s
explain and cover terms (each kept box explained by one of the
reference's candidates; each isolated candidate of the reference kept or
excused), with the overlap term left out. `toy_config.json` names it by
the relative name `../tests/toy_family`.
"""

from __future__ import annotations

from benchmark.families import pointpillars as pp
from benchmark.lib import compare

geometry = pp.geometry
make_weights = pp.make_weights
reference_network = pp.reference_network
point_cloud = pp.point_cloud
reference_frame = pp.reference_frame
control_annos = pp.control_annos
stage_calls = pp.stage_calls
network_flops = pp.network_flops
scatter_bytes = pp.scatter_bytes
KERNELS = pp.KERNELS
NMS_RANK_CAP = pp.NMS_RANK_CAP


def check_frame(cands, annos: dict, where: str) -> compare.Checked:
    got = pp.judge_frame(annos, cands, where)
    gap = max(got["explain"], got["cover"])
    return compare.Checked({"toy_gap": gap}, [c.top_k for c in cands], f"toy_gap {gap:.6g}, {got['kept']} boxes kept")

"""Three chained steps of the spatial (1, 2) hybrid step and of the 2-rank
data-parallel step against the one-process chain, every step compared: is
a miss at step 3 the spatial code's, or float32 rounding that Adam's first
update amplifies? On the CPU, two gloo ranks spawned as in
tests/test_torch_parallel.py (this module's jobs, which the ranks import
by name; no JAX). Each rank compares its chain with the one-process chain
it computes itself, step by step, and returns per tensor only the largest
difference and the reference's largest element (float64) or each step's
ratios to the bounds (float32), so no model-sized record leaves a rank.

* float64, asserted: the RPN and the shared head (`model.double()`) on the
  ranks' slabs at sp 2 (halo exchange, spatial InstanceNorm, the preds'
  `gather_rows`) and data-parallel at dp 2 (a sample a rank, gradients
  averaged), each 3 steps of the port's clip + Adam update
  (`Trainer.apply_gradients`) against the one-process model: outputs, input
  gradients, weight gradients and the weights after each step within 1e-9
  of each tensor's largest element. `Trainer` itself computes in float32
  (voxelizer, PFN, matcher), so the float64 chain starts at the canvas.
* float32, recorded: the hybrid step and the data-parallel step, 3 steps
  at batch 2 of the small config, and the one-process step with its two
  samples swapped, each against the one-process chain; each step's ratios
  to phase 15(b)'s bounds (chip_smoke.dp_compare, gradients by norm:
  loss rtol 1e-5 at step 1 and 1e-4 after, gradients |Δg| within 1e-2 of
  |g| per tensor, weights within k·2·lr at step k, running statistics
  rtol 1e-5 + 1e-6) are printed (`pytest -s`); the first step is held to
  them, as the card holds it.
"""

from __future__ import annotations

import types

import numpy as np
import pytest
import torch

import test_torch_parallel as tp
import test_torch_spatial as ts
from det3d_tpu_torch.models.pointpillars import PointPillars, init_weights
from det3d_tpu_torch.parallel import mesh as pm
from det3d_tpu_torch.parallel import spatial as sp
from det3d_tpu_torch.train.trainer import Trainer, TrainState

torch.set_num_threads(1)

STEPS = 3
BATCH = 2
F64_RTOL = 1e-9


# --- what a rank runs ------------------------------------------------------------


def ratios_record(records: list[dict], want: list[dict], lr: float) -> dict:
    """A chain's losses and each step's ratios to the bounds against the
    one-process chain `want`."""
    return dict(losses=[r["loss"] for r in records], lr=lr,
                ratios=[dp_ratios(g, w, lr, k) for k, (g, w) in enumerate(zip(records, want), 1)])


def job_hybrid_chain(mesh, cfg, global_batches):
    """`make_spatial_train` at (1, 2), every step's ratios to the bounds
    against the one-process chain computed here."""
    hybrid = pm.make_hybrid_mesh(1, mesh.world, device="cpu")
    trainer, step = pm.make_spatial_train(cfg, hybrid)
    state = pm.replicated(hybrid.world, trainer, trainer.init_state(0))
    out = []
    for gb in global_batches:
        state, loss, _ = step(state, pm.shard_batch(hybrid.data, gb))
        out.append(ts.step_record(trainer, state, loss))
    return ratios_record(out, ts.one_process_steps(cfg, global_batches), state.lr)


def job_dp_chain(mesh, cfg, global_batches):
    """`make_sharded_train_step` over the group, every step's ratios to the
    bounds against the one-process chain computed here."""
    trainer = Trainer(cfg, device="cpu")
    state = pm.replicated(mesh, trainer, trainer.init_state(0))
    step = pm.make_sharded_train_step(trainer, mesh)
    out = []
    for gb in global_batches:
        state, loss, _ = step(state, pm.shard_batch(mesh, gb))
        out.append(ts.step_record(trainer, state, loss))
    return ratios_record(out, ts.one_process_steps(cfg, global_batches), state.lr)


def job_rpn_chain(mesh, cfg, xs, mode):
    """This rank's float64 chain (`rpn_head_chain` in `mode`) against the
    one-process chain computed here, in step: for each step, each tensor's
    (name, max |got - want|, max |want|), `want` cut to what the rank
    holds (its slab's input gradient; at "data" its sample's preds, and
    its input gradient times the batch: the rank's loss is its sample's,
    the one process's the batch's mean)."""
    r = mesh.rank
    out = []
    for g, w in zip(rpn_head_chain(mesh, cfg, xs, mode), rpn_head_chain(None, cfg, xs)):
        pairs = [(key, g["preds"][key], v[r:r + 1] if mode == "data" else v) for key, v in w["preds"].items()]
        if mode == "spatial":
            lo, hi = sp.slab_bounds(w["dx"].shape[2], mesh.world)[0][r]
            pairs.append(("dx", g["dx"], w["dx"][:, :, lo:hi]))
        else:
            pairs.append(("dx", g["dx"], w["dx"][r:r + 1] * BATCH))
        pairs += [(f"grad {n}", g["grads"][n], v) for n, v in w["grads"].items()]
        pairs += [(f"weight {n}", g["params"][n], v) for n, v in w["params"].items()]
        out.append([(what, float((got - want).abs().max()), float(want.abs().max())) for what, got, want in pairs])
    return out


def rpn_head_chain(mesh, cfg, xs, mode="one"):
    """The float64 RPN + shared head over the canvases `xs` (B, 64, nx, ny),
    a clip + Adam step each against a seeded cotangent of the whole preds,
    loss Σ(preds · cot) / B. `mode`: "one" (this process, the whole
    batch), "spatial" (this rank's slab, the preds gathered, the gradients
    summed over the ranks) or "data" (this rank's sample, the gradients
    averaged). Yields every step's record: the preds (whole), the input
    gradient, the reduced weight gradients and the weights after the
    update. `mesh`: the rank's group (None for "one")."""
    model = init_weights(PointPillars(cfg), 0).double()
    params = list(model.rpn.parameters()) + list(model.heads.parameters())
    names = [f"rpn.{n}" for n, _ in model.rpn.named_parameters()] + [f"heads.{n}" for n, _ in
                                                                      model.heads.named_parameters()]
    state = TrainState(step=0, mu=[torch.zeros_like(p) for p in params], nu=[torch.zeros_like(p) for p in params],
                       lr=float(cfg.learning_rate))
    plan = sp.SpatialPlan.of(mesh, cfg.grid_size[0]) if mode == "spatial" else None
    for k, x in enumerate(xs):
        b = x.shape[0]
        if mode == "spatial":
            lo, hi = plan.rows(0)
            x = x[:, :, lo:hi]
        elif mode == "data":
            x = x[mesh.rank:mesh.rank + 1]
        xt = torch.from_numpy(np.ascontiguousarray(x, np.float64)).contiguous(
            memory_format=torch.channels_last).requires_grad_()
        for p in params:
            p.grad = None
        feats = model.rpn(xt, spatial=plan)
        preds = model.heads(feats)
        if plan is not None:
            preds = sp.gather_rows(preds, mesh, plan.bounds[1])
        rng = np.random.RandomState(100 + k)
        loss = 0.0
        for key in sorted(preds):
            cot = rng.randn(b, *preds[key].shape[1:])
            if mode == "data":
                cot = cot[mesh.rank:mesh.rank + 1]
            loss = loss + (preds[key] * torch.from_numpy(cot)).sum() / (1 if mode == "data" else b)
        loss.backward()
        if mode == "spatial":
            pm.pmean_gradients(params, mesh, 1)
        elif mode == "data":
            pm.pmean_gradients(params, mesh)
        record = dict(preds={key: v.detach().clone() for key, v in preds.items()}, dx=xt.grad.clone(),
                      grads={n: p.grad.clone() for n, p in zip(names, params)})
        Trainer.apply_gradients(types.SimpleNamespace(params=params), state)
        record["params"] = {n: p.detach().clone() for n, p in zip(names, params)}
        yield record


# --- inputs and the group ------------------------------------------------------------


def canvases(cfg, seed=0):
    """STEPS sparse canvases (BATCH, 64, nx, ny), as the scatter makes."""
    return [ts.rpn_inputs(cfg, b=BATCH, seed=seed + k)[0].astype(np.float64) for k in range(STEPS)]


@pytest.fixture(scope="module")
def chains(tmp_path_factory):
    small, mid = ts.small_cfg(batch_size=BATCH), ts.mid_cfg()
    batches = ts.hybrid_batches(ts.small_cfg(), BATCH, n=STEPS)
    jobs = [
        ("hybrid", job_hybrid_chain, dict(cfg=small, global_batches=batches)),
        ("dp", job_dp_chain, dict(cfg=small, global_batches=batches)),
        ("rpn_spatial_small", job_rpn_chain, dict(cfg=small, xs=canvases(small), mode="spatial")),
        ("rpn_spatial_mid", job_rpn_chain, dict(cfg=mid, xs=canvases(mid), mode="spatial")),
        ("rpn_data_small", job_rpn_chain, dict(cfg=small, xs=canvases(small), mode="data")),
    ]
    ranks = tp.run_group(2, tmp_path_factory.mktemp("f1"), jobs)
    swapped = [b._replace(**{f: getattr(b, f)[::-1].copy() for f in b._fields}) for b in batches]
    lr = ranks["hybrid"][0]["lr"]
    return dict(ranks=ranks, swapped=ratios_record(ts.one_process_steps(small, swapped),
                                                   ts.one_process_steps(small, batches), lr))


# --- float64: the spatial and data-parallel code are exact -------------------------------


@pytest.mark.parametrize("run,which", [("rpn_spatial_small", "small"), ("rpn_spatial_mid", "mid"),
                                       ("rpn_data_small", "small")])
def test_float64_chain_matches_one_process_every_step(run, which, chains):
    """Every tensor of every step within 1e-9 of its one-process
    counterpart's largest element (`job_rpn_chain` on each rank)."""
    model = PointPillars(ts.small_cfg())
    n_params = len(list(model.rpn.parameters())) + len(list(model.heads.parameters()))
    by_rank = chains["ranks"][run]
    assert len(by_rank) == 2
    for r, steps in enumerate(by_rank):
        assert len(steps) == STEPS
        for k, rows in enumerate(steps, 1):
            assert sum(what.startswith("grad ") for what, _, _ in rows) == n_params
            assert sum(what.startswith("weight ") for what, _, _ in rows) == n_params
            assert any(what == "dx" for what, _, _ in rows)
            for what, err, scale in rows:
                assert err <= F64_RTOL * scale + 1e-300, f"{run} ({which}) rank {r} step {k} {what}: " \
                                                         f"{err:.3e} of {scale:.3e}"


# --- float32: recorded, the first step held ----------------------------------------------


def dp_ratios(got: dict, want: dict, lr: float, k: int) -> dict[str, float]:
    """Step k's worst of each quantity over phase 15(b)'s bound."""
    rtol = 1e-5 if k == 1 else 1e-4
    out = {"loss": max(abs(got["loss"][n] - v) / (rtol * abs(v) + 1e-12) for n, v in want["loss"].items())}
    out["grads by norm"] = max(float((got["grads"][n] - g).norm()) / (1e-2 * float(g.norm()) + 1e-30)
                               for n, g in want["grads"].items())
    out["params"] = max(float((got["sd"][n] - want["sd"][n]).abs().max()) / (k * 2 * lr) for n in want["grads"])
    out["batch stats"] = max(float(((got["sd"][n] - w).abs() / (1e-5 * w.abs() + 1e-6)).max())
                             for n, w in want["sd"].items() if "running" in n)
    return out


def test_float32_chains_recorded_against_one_process(chains):
    runs = {"hybrid (1, 2)": chains["ranks"]["hybrid"], "data-parallel, 2 ranks": chains["ranks"]["dp"],
            "one process, samples swapped": [chains["swapped"]]}
    for name, by_rank in runs.items():
        for rec in by_rank[1:]:
            assert rec["losses"] == by_rank[0]["losses"], f"{name}: ranks differ"
        assert len(by_rank[0]["ratios"]) == STEPS
        for k, ratios in enumerate(by_rank[0]["ratios"], 1):
            assert all(np.isfinite(v) for v in ratios.values()), (name, k, ratios)
            print(f"F1 f32 {name}, step {k}: " + ", ".join(f"{q} {v:.3f}" for q, v in ratios.items()))
            if k == 1:
                assert all(v <= 1.0 for v in ratios.values()), (name, ratios)

"""Shared helpers for the PyTorch port's parity tests (no tests here).

Each parity test feeds the same numpy inputs, made from a seed, to a JAX
function (CPU) and to its counterpart in `det3d_tpu_torch` (CPU tensors).
Weights come from the JAX `init_variables(PRNGKey(0))` and cross through the
port's own weight bridge (`det3d_tpu_torch.weights`), loaded strictly.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import torch

import det3d_tpu_torch.config as tcfg
from det3d_tpu_torch.pipeline import Detector as TorchDetector
from det3d_tpu_torch.postprocess import PostProcessParams as TorchParams
from det3d_tpu_torch.weights import to_tensors, variables_to_state_dict

torch.set_num_threads(1)

CPU = torch.device("cpu")


def small_cfg():
    import __graft_entry__ as g

    return g._small_cfg()


def mid_cfg():
    from tools.make_golden import mid_cfg

    return mid_cfg()


LAYOUT_FIELDS = frozenset({"pack_w", "block0_blocked", "block0_blocked_train", "late_blocked_train",
                           "fuse_in_stats", "split_head"})


def to_torch_cfg(cfg, layout: bool = False) -> tcfg.Config:
    """The port's Config with every field the port shares with the JAX one;
    the layout levers keep the port's defaults (the dense network) unless
    `layout` asks for the JAX config's."""
    specs = tuple(tcfg.ClassSpec(**dataclasses.asdict(s)) for s in cfg.class_specs)
    names = {f.name for f in dataclasses.fields(tcfg.Config)} - {"class_specs"}
    if not layout:
        names -= LAYOUT_FIELDS
    return tcfg.Config(**{n: getattr(cfg, n) for n in names}, class_specs=specs)


def numpy_variables(variables) -> dict:
    return jax.tree.map(np.asarray, variables)


def bridged_state_dict(variables) -> dict[str, torch.Tensor]:
    """JAX variables → the port's state_dict (CPU tensors)."""
    return to_tensors(variables_to_state_dict(numpy_variables(variables)))


def jax_variables(jax_detector):
    return jax_detector.init_variables(jax.random.PRNGKey(0))


def torch_detector(jax_cfg, variables, approx_topk=None) -> TorchDetector:
    """The port's CPU detector for a JAX config, carrying the JAX weights."""
    det = TorchDetector(to_torch_cfg(jax_cfg), device=CPU, postprocess_params=TorchParams(approx_topk=approx_topk))
    return det.load_state_dict(bridged_state_dict(variables))


def golden_detectors(which: str):
    """(JAX detector, its variables, the port's detector) exactly as
    tools/make_golden.make_detector builds the goldens."""
    from tools.make_golden import make_detector

    jdet = make_detector(which)
    variables = jax_variables(jdet)
    # make_golden forces the bucketed top-k on for "mid" only
    approx = True if which == "mid" else None
    return jdet, variables, torch_detector(jdet.cfg, variables, approx_topk=approx)


def jax_train_step(jcfg, samples, state=None) -> dict:
    """JAX's f32 `Trainer.train_step` on `samples` from `state` (a fresh
    `init_state(PRNGKey(0))` by default), with the gradients that reach its
    optimizer captured in front of it: the config, the samples, the loss
    terms, the metric counts, and the weights before and after and the
    gradients as the port's `state_dict` (numpy)."""
    import jax.numpy as jnp
    import optax

    from det3d_tpu.train.trainer import Trainer as JaxTrainer
    from det3d_tpu.train.trainer import host_batch as jax_host_batch

    trainer = JaxTrainer(jcfg)
    capture = optax.GradientTransformation(lambda p: jax.tree.map(jnp.zeros_like, p), lambda u, s, p=None: (u, u))
    trainer.optimizer = optax.chain(capture, trainer.optimizer)
    if state is None:
        state = trainer.init_state(jax.random.PRNGKey(0))
    else:
        state = state._replace(opt_state=(capture.init(state.params), state.opt_state))
    new_state, loss, counts = jax.jit(trainer.train_step)(state, jax_host_batch(jcfg, samples))
    before = numpy_variables({"params": state.params, "batch_stats": state.batch_stats})
    after = numpy_variables({"params": new_state.params, "batch_stats": new_state.batch_stats})
    grads = numpy_variables({"params": new_state.opt_state[0], "batch_stats": new_state.batch_stats})
    return dict(
        cfg=jcfg, samples=samples, loss={k: float(v) for k, v in loss.items()},
        counts={k: np.asarray(v) for k, v in counts.items()},
        before=before, after=variables_to_state_dict(after), grads=variables_to_state_dict(grads),
    )

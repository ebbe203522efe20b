"""Parity of the port's layout path pieces with the JAX package, on the CPU:
the s2d and blocked-halo s2d scatters (plain versions and their autograd
backwards), the weight packing, the packed convolutions, the packed and
blocked InstanceNorms, and the packed and late-blocked RPN.

Tolerances, each with its reason:
  * scatters: bit-equal (they move values); their gradients atol 1e-6 (the
    same gathers and adds, JAX's grad goes through tanh in XLA);
  * packed kernels: equal (the packing moves values and zeros);
  * packed convolutions and InstanceNorms: rtol/atol 1e-5 in float32
    (other summation orders);
  * RPN: rtol/atol 1e-4 in float32 (a deep stack of convolutions whose
    sums run in other orders);
  * late-blocked RPN gradients: against the port's own packed RPN, rtol
    1e-3 / atol 2e-4 elementwise, the JAX package's tolerances for its
    late-blocked RPN against its dense one; against JAX's late-blocked RPN,
    the norm of the difference within 1 % of the gradient's norm, per
    tensor. Elementwise, gradients from two evaluation orders differ in
    patches: a ReLU input within float32 rounding of 0 falls on the other
    side of the kink, and every input and early-layer gradient under that
    unit's receptive field moves. JAX alone shows it: its jitted and eager
    input gradients differ by up to 0.029 (0.9 % of the largest) on 13 % of
    the elements, a norm difference of 0.24 %, and 1e-6 of noise on the
    input moves the gradient by up to 0.05. A halo bookkeeping fault would
    move whole rows by the gradient's size, a norm difference of tens of %.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_parity_utils as pu
from det3d_tpu.kernels.scatter_pallas import scatter_to_bev_s2d_blocked as jax_blocked
from det3d_tpu.kernels.scatter_pallas import scatter_to_bev_s2d_pallas
from det3d_tpu.models import pointpillars as jpp
from det3d_tpu_torch.kernels import scatter_cuda
from det3d_tpu_torch.models import pointpillars as tpp
from test_torch_kernels import scatter_case

torch.set_num_threads(1)

CL = torch.channels_last


def nchw(a: np.ndarray) -> torch.Tensor:
    """An NHWC numpy map → the NCHW tensor in channels_last memory."""
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


# --- the s2d scatters -----------------------------------------------------


class TestS2dScatter:
    GRID = (12, 20)

    @pytest.mark.parametrize("w_major", [False, True])
    def test_plain_bit_equal_to_jax(self, w_major):
        feats, coors = scatter_case(2, 41, 8, self.GRID, 30, 1)
        xla = np.asarray(jpp.scatter_to_bev_s2d(jnp.asarray(feats), jnp.asarray(coors), self.GRID))
        pallas = np.asarray(scatter_to_bev_s2d_pallas(jnp.asarray(feats), jnp.asarray(coors), self.GRID, True,
                                                      w_major))
        np.testing.assert_array_equal(pallas, xla)
        got = scatter_cuda.scatter_to_bev_s2d_plain(torch.from_numpy(feats), torch.from_numpy(coors), self.GRID,
                                                    w_major)
        np.testing.assert_array_equal(got.numpy(), xla)
        # W-major memory: the logical tensor is a transposed view
        assert got.transpose(1, 2).is_contiguous() == w_major

    @pytest.mark.parametrize("w_major", [False, True])
    def test_grad_matches_jax(self, w_major):
        feats, coors = scatter_case(2, 41, 8, self.GRID, 30, 2)
        w = np.random.RandomState(3).randn(2, 6, 10, 32).astype(np.float32)
        want = jax.grad(lambda f: jnp.sum(jnp.tanh(
            scatter_to_bev_s2d_pallas(f, jnp.asarray(coors), self.GRID, True, w_major)) * w))(jnp.asarray(feats))
        ft = torch.from_numpy(feats).requires_grad_()
        before = scatter_cuda.s2d_bwd_counter.launches
        out = scatter_cuda.scatter_to_bev_s2d(ft, torch.from_numpy(coors), self.GRID, w_major)
        (torch.tanh(out) * torch.from_numpy(w)).sum().backward()
        assert scatter_cuda.s2d_bwd_counter.launches == before  # CPU: the plain gather
        np.testing.assert_allclose(ft.grad.numpy(), np.asarray(want), rtol=0, atol=1e-6)
        assert not ft.grad[torch.from_numpy(coors[..., 0] < 0)].any()  # empty slots

    def test_drops_rows_outside_the_grid(self):
        feats, coors = scatter_case(1, 20, 4, (8, 8), 12, 4)
        keep = coors[0, :, 0] >= 0
        row = int(np.flatnonzero(keep)[0])
        outside = coors.copy()
        outside[0, row, 0] = 8  # outside the grid: dropped like an empty slot, zero gradient
        dropped = coors.copy()
        dropped[0, row] = -1
        keep[row] = False
        ft = torch.from_numpy(feats).requires_grad_()
        out = scatter_cuda.scatter_to_bev_s2d(ft, torch.from_numpy(outside), (8, 8))
        want = scatter_cuda.scatter_to_bev_s2d_plain(torch.from_numpy(feats), torch.from_numpy(dropped), (8, 8))
        assert torch.equal(out, want)
        out.sum().backward()
        assert not ft.grad[0, row].any() and (ft.grad[0, torch.from_numpy(keep)] == 1).all()

    @pytest.mark.parametrize("bad", ["odd_grid", "kernel_on_cpu", "bwd_on_cpu"])
    def test_rejects_bad_input(self, bad):
        feats, coors = (torch.from_numpy(a) for a in scatter_case(1, 20, 4, (8, 8), 10, 5))
        with pytest.raises(ValueError):
            if bad == "odd_grid":
                scatter_cuda.scatter_to_bev_s2d(feats, coors, (8, 7))
            elif bad == "kernel_on_cpu":
                scatter_cuda.scatter_to_bev_s2d_cuda(feats, coors, (8, 8))
            else:
                scatter_cuda.scatter_to_bev_s2d_bwd_cuda(torch.zeros(1, 4, 4, 16), coors)


class TestBlockedScatter:
    GRID, NBLK, HALO = (24, 20), 3, (4, 3)

    def test_plain_bit_equal_to_jax(self):
        feats, coors = scatter_case(2, 57, 8, self.GRID, 40, 0)
        want = np.asarray(jax_blocked(jnp.asarray(feats), jnp.asarray(coors), self.GRID, self.NBLK, self.HALO,
                                      True))
        got = scatter_cuda.scatter_to_bev_s2d_blocked_plain(torch.from_numpy(feats), torch.from_numpy(coors),
                                                            self.GRID, self.NBLK, self.HALO)
        assert got.shape == (2, 3, 4 + 4 + 3, 10, 32)
        np.testing.assert_array_equal(got.numpy(), want)

    def test_grad_matches_jax_with_both_halos(self):
        feats, coors = scatter_case(2, 57, 8, self.GRID, 40, 11)
        bi, y2, phase, places = scatter_cuda._blocked_places(torch.from_numpy(coors), self.GRID, self.NBLK,
                                                             self.HALO)
        both = places[1][0] & places[2][0]
        assert both.any() and (places[1][0] & ~places[2][0]).any() and (places[2][0] & ~places[1][0]).any()
        w = np.random.RandomState(12).randn(2, 3, 11, 10, 32).astype(np.float32)
        want = jax.grad(lambda f: jnp.sum(jnp.tanh(
            jax_blocked(f, jnp.asarray(coors), self.GRID, self.NBLK, self.HALO, True)) * w))(jnp.asarray(feats))
        ft = torch.from_numpy(feats).requires_grad_()
        out = scatter_cuda.scatter_to_bev_s2d_blocked(ft, torch.from_numpy(coors), self.GRID, self.NBLK, self.HALO)
        (torch.tanh(out) * torch.from_numpy(w)).sum().backward()
        np.testing.assert_allclose(ft.grad.numpy(), np.asarray(want), rtol=0, atol=1e-6)

    def test_blocks_reassemble_the_s2d_canvas(self):
        feats, coors = (torch.from_numpy(a) for a in scatter_case(2, 57, 8, self.GRID, 40, 13))
        plain = scatter_cuda.scatter_to_bev_s2d_plain(feats, coors, self.GRID)
        blk = scatter_cuda.scatter_to_bev_s2d_blocked_plain(feats, coors, self.GRID, self.NBLK, self.HALO)
        ht, hb = self.HALO
        padded = torch.nn.functional.pad(plain, (0, 0, 0, 0, ht, hb))
        for k in range(self.NBLK):
            assert torch.equal(blk[:, k], padded[:, 4 * k:4 * k + 4 + ht + hb])

    @pytest.mark.parametrize("nblk,halo", [(5, (4, 3)), (4, (4, 3)), (3, (5, 0))])
    def test_rejects_bad_blocking(self, nblk, halo):
        feats, coors = (torch.from_numpy(a) for a in scatter_case(1, 20, 4, self.GRID, 10, 14))
        with pytest.raises(ValueError):
            scatter_cuda.scatter_to_bev_s2d_blocked(feats, coors, self.GRID, nblk, halo)


# --- weight packing and packed convolutions -----------------------------------


def conv_weight(o, c, k, seed):
    return (np.random.RandomState(seed).randn(o, c, k, k) / np.sqrt(c * k * k)).astype(np.float32)


@pytest.mark.parametrize("kind", ["entry", "res", "down"])
def test_pack_kernels_equal_jax(kind):
    w = conv_weight(6, 5, 3, 0)  # OIHW, the bridged layout
    jax_pack = {"entry": jpp._pack_entry_kernel, "res": jpp._pack_res_kernel, "down": jpp._pack_down_kernel}[kind]
    want = np.asarray(jax_pack(jnp.asarray(w.transpose(2, 3, 1, 0)))).transpose(3, 2, 0, 1)
    port_pack = {"entry": tpp.pack_entry_kernel, "res": tpp.pack_res_kernel, "down": tpp.pack_down_kernel}[kind]
    got = port_pack(torch.from_numpy(w))
    np.testing.assert_array_equal(got.numpy(), want)


PACKED_INPUTS = {  # kind: (NHWC input shape, in channels of the dense kernel, out channels)
    "entry": ((2, 6, 8, 16), 4, 6), "res": ((2, 6, 5, 10), 5, 5), "down": ((2, 6, 5, 10), 5, 7),
    "entry_valid": ((2, 6, 8, 16), 4, 6), "res_valid": ((2, 6, 5, 10), 5, 5), "down_valid": ((2, 7, 5, 10), 5, 7),
}


@pytest.mark.parametrize("kind", list(PACKED_INPUTS))
def test_packed_conv_matches_jax(kind):
    shape, c, o = PACKED_INPUTS[kind]
    x = np.random.RandomState(1).randn(*shape).astype(np.float32)
    w = conv_weight(o, c, 3, 2)
    want = jpp.PackedConv(o, c, kind, jnp.float32).apply({"params": {"kernel": jnp.asarray(w.transpose(2, 3, 1, 0))}},
                                                          jnp.asarray(x))
    got = tpp.packed_conv(nchw(x), torch.from_numpy(w), kind)
    assert got.is_contiguous(memory_format=CL)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_packed_conv_pads_channels_last():
    """The asymmetric pads go through F.pad, which keeps channels_last, so
    the convolution gets its input without a layout copy; symmetric ones
    take the convolution's own padding."""
    x = nchw(np.random.RandomState(3).randn(1, 4, 6, 8).astype(np.float32))
    padded = torch.nn.functional.pad(x, (0, 0, 1, 0))
    assert padded.is_contiguous(memory_format=CL)
    w = torch.randn(3, 8, 3, 3)
    # kernel 3, stride 2, (1, 0) on an even axis: the same outputs as padding 1
    ref = torch.nn.functional.conv2d(x, w, None, 2, 1)
    torch.testing.assert_close(tpp.conv2d_padded(x, w, (2, 2), ((1, 0), (1, 0))), ref, rtol=0, atol=0)


def test_packed_pointwise_matches_jax():
    x = np.random.RandomState(4).randn(2, 5, 4, 12).astype(np.float32)
    w = np.random.RandomState(5).randn(6, 7).astype(np.float32)  # HWIO (1, 1, 6, 7) of JAX
    want = jpp.PackedPointwise(7, 6, jnp.float32).apply({"params": {"kernel": jnp.asarray(w[None, None])}},
                                                        jnp.asarray(x))
    got = tpp.packed_pointwise(nchw(x), torch.from_numpy(w)[:, :, None, None])  # ConvTranspose2d (I, O, 1, 1)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_pack_columns_is_a_view():
    y = torch.randn(2, 3, 4, 6).contiguous(memory_format=CL)
    p = tpp.pack_columns(y)
    assert p.shape == (2, 6, 4, 3) and p.data_ptr() == y.data_ptr() and p.is_contiguous(memory_format=CL)
    # channel q·O + o of packed column w2 is channel o of column 2·w2 + q
    assert torch.equal(p[:, 3:, :, 1], y[:, :, :, 3]) and torch.equal(p[:, :3, :, 2], y[:, :, :, 4])
    assert torch.equal(tpp.unpack_columns(p), y)
    with pytest.raises(RuntimeError):
        tpp.pack_columns(torch.randn(2, 3, 4, 6))  # not channels_last: no silent copy


# --- instance norms ------------------------------------------------------------


def test_packed_instance_norm_matches_jax():
    r = np.random.RandomState(6)
    x = (r.randn(2, 5, 4, 12) * 2 + 0.5).astype(np.float32)
    g = r.randn(*x.shape).astype(np.float32)
    y_j, vjp = jax.vjp(lambda a: jpp._instance_norm(a, "in", packed=True), jnp.asarray(x))
    (dx_j,) = vjp(jnp.asarray(g))
    np.testing.assert_allclose(nhwc(tpp.instance_norm(nchw(x), packed=True)), np.asarray(y_j), rtol=1e-5, atol=1e-5)
    xt = nchw(x).requires_grad_()
    y = tpp.InstanceNormFn.apply(xt, True)
    y.backward(nchw(g))
    np.testing.assert_allclose(nhwc(y), np.asarray(y_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(nhwc(xt.grad), np.asarray(dx_j), rtol=1e-5, atol=1e-5)
    # the packed statistics are the unpacked map's
    dense = tpp.instance_norm(tpp.unpack_columns(nchw(x).contiguous(memory_format=CL)))
    torch.testing.assert_close(tpp.pack_columns(dense), tpp.instance_norm(nchw(x), packed=True), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("packed,top,bot", [(True, 3, 3), (False, 2, 1), (True, 0, 0)])
def test_blocked_instance_norm_matches_jax(packed, top, bot):
    r = np.random.RandomState(7)
    bsz, nblk, valid, w2, c = 2, 3, 4, 5, 6
    x5 = (r.randn(bsz, nblk, valid + top + bot, w2, c) * 2 + 0.5).astype(np.float32)
    g5 = r.randn(*x5.shape).astype(np.float32)
    y_j, vjp = jax.vjp(lambda a: jpp._instance_norm_blocked(a, top, bot, valid, packed), jnp.asarray(x5))
    (dx_j,) = vjp(jnp.asarray(g5))
    y_j, dx_j = np.asarray(y_j), np.asarray(dx_j)

    def flat(a):  # (B, nblk, R, W, C) → (B·nblk, C, R, W), channels_last
        return nchw(a.reshape((bsz * nblk,) + a.shape[2:]))

    xt = flat(x5).requires_grad_()
    y = tpp.instance_norm_blocked(xt, nblk, top, bot, valid, packed)
    y.backward(flat(g5))
    np.testing.assert_allclose(nhwc(y).reshape(y_j.shape), y_j, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(nhwc(xt.grad).reshape(dx_j.shape), dx_j, rtol=1e-5, atol=1e-5)
    if top:  # the out-of-canvas margin rows are zero after the normalise
        assert not y_j[:, 0, :top].any() and not nhwc(y).reshape(y_j.shape)[:, 0, :top].any()
        assert not y_j[:, -1, -bot:].any()


# --- the RPN -----------------------------------------------------------------


def torch_rpn(rpn_params) -> tpp.RPN:
    """The port's RPN carrying a JAX RPN's parameters, through the weight bridge."""
    model = tpp.PointPillars(pu.to_torch_cfg(pu.small_cfg()))
    model.load_state_dict(pu.bridged_state_dict(jax_model_variables_with_rpn(pu.numpy_variables(rpn_params))),
                          strict=True)
    return model.rpn


def test_packed_rpn_matches_jax():
    x = np.random.RandomState(8).randn(2, 16, 12, 256).astype(np.float32)  # s2d canvas of a 32x24 grid
    rpn_j = jpp.RPN(compute_dtype=jnp.float32, pack_w=True, fuse_in_stats=False)
    v = jax.jit(rpn_j.init)(jax.random.PRNGKey(1), jnp.asarray(x))
    want = np.asarray(jax.jit(rpn_j.apply)(v, jnp.asarray(x)))
    with torch.no_grad():
        got = torch_rpn(v["params"])(nchw(x), pack_w=True)
    assert got.shape == (2, 320, 16, 12) and got.is_contiguous(memory_format=CL)
    np.testing.assert_allclose(nhwc(got), want, rtol=1e-4, atol=1e-4)


def test_late_blocking_counts():
    assert (tpp.late_blocking(128), tpp.late_blocking(64), tpp.late_blocking(200), tpp.late_blocking(100)) == (
        4, 2, 4, 2)
    assert tpp.late_blocking(40) == 1
    assert tpp.block0_blocking((800, 800)) == (8, (4, 3)) and tpp.block0_blocking((16, 16))[0] == 1
    assert tpp.block0_blocking((32, 32))[0] == 2


def jax_model_variables_with_rpn(rpn_tree):
    """A full JAX-model variables tree (zeros elsewhere) holding `rpn_tree`
    as its RPN parameters, for the weight bridge."""
    cfg = pu.small_cfg()
    shapes = jax.eval_shape(lambda: jpp.PointPillars(cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8, 5, 4)), jnp.zeros((1, 8), jnp.int32),
        jnp.full((1, 8, 3), -1, jnp.int32)))
    tree = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    tree["params"]["rpn"] = rpn_tree
    return tree


@pytest.fixture(scope="module")
def late_blocked_case():
    """The late-blocked RPN on a tall narrow packed canvas that engages both
    late blocks (block2 rows_out 128 → 4 blocks, block3 64 → 2), as the JAX
    package's own test does: JAX's output and input and parameter gradients
    (through the weight bridge's mapping, whose transposes and deconv flip
    carry gradients as they carry weights), and the port's late-blocked and
    packed RPNs from the same weights."""
    r = np.random.RandomState(7)
    x = r.randn(1, 256, 16, 256).astype(np.float32)
    rpn_j = jpp.RPN(compute_dtype=jnp.float32, pack_w=True, fuse_in_stats=False, late_blocked=True)
    v = jax.jit(rpn_j.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    out = np.asarray(jax.jit(rpn_j.apply)(v, jnp.asarray(x)))
    w = r.randn(*out.shape).astype(np.float32)
    g_p, g_x = jax.jit(jax.grad(lambda p, xx: jnp.sum(jnp.tanh(rpn_j.apply(p, xx) / 4.0) * w), argnums=(0, 1)))(
        v, jnp.asarray(x))
    grads = pu.bridged_state_dict(jax_model_variables_with_rpn(pu.numpy_variables(g_p["params"])))
    jax_result = dict(out=out, x=np.asarray(g_x), **{n[4:]: g.numpy() for n, g in grads.items() if n.startswith("rpn.")})
    rpn = torch_rpn(v["params"])
    port = {}
    for late in (True, False):
        xt = nchw(x).requires_grad_()
        o = rpn(xt, pack_w=True, late_blocked=late)
        rpn.zero_grad()
        (torch.tanh(o / 4.0) * nchw(w)).sum().backward()
        port[late] = dict(out=nhwc(o), x=nhwc(xt.grad), **{n: p.grad.numpy().copy() for n, p in rpn.named_parameters()})
    return jax_result, port[True], port[False]


def test_late_blocked_rpn_matches_jax(late_blocked_case):
    want, got, _ = late_blocked_case
    assert len(got) == 2 + 19  # output, input, 16 convolutions and 3 upsample kernels
    np.testing.assert_allclose(got["out"], want["out"], rtol=1e-4, atol=1e-4)
    for name in got:
        if name != "out":
            err = np.linalg.norm(got[name] - want[name]) / np.linalg.norm(want[name])
            assert err <= 1e-2, (name, err)


def test_late_blocked_rpn_gradients_equal_packed_rpn(late_blocked_case):
    """The port's late-blocked RPN against its own packed RPN, elementwise:
    one framework, the same function up to float32 statistics association."""
    _, late, packed = late_blocked_case
    np.testing.assert_allclose(late["out"], packed["out"], rtol=1e-4, atol=1e-4)
    for name in late:
        np.testing.assert_allclose(late[name], packed[name], rtol=1e-3, atol=2e-4, err_msg=name)

"""The RPN's InstanceNorm + ReLU op `det3d::in_relu` (kernels/norm_cuda.py)
and where the RPN takes it.

CPU half: the op on a CPU tensor is the plain pair bit for bit (dense and
packed, bf16 and float32, channels_last and contiguous); its fake and
torch.library's checks; the tiles `plan` picks; the wrapper's refusals;
the RPN on the CPU, under grad and in float64 keeps the plain pair, and an
exported dense or packed network records the op once a pair (19 a frame).

GPU half (marker `gpu`; skips without a card, decided in a fixture): the
kernel against the plain version at the 20 cm RPN's map shapes, batch 1
and 4, bf16 and float32, dense and packed. The statistics are float32
sums in another order than torch's, so they agree within float32
reassociation: |Δmean| ≤ 2e-5·mean|x| and |Δinv| ≤ 2e-5·inv·(1 +
mean²·inv²), a few ulps of each sum (whose error is at most ~k·eps of the
sum of magnitudes, k the longest chain of additions) carried through
var = E[x²] − mean², which multiplies a relative error by mean²/var. With
the statistics fixed, the output is bit-equal to the plain version's. Two
calls and a captured replay are bit-equal to a call; the scratch needs no
initialisation; bad input is refused. This file imports nothing of JAX.
On the card, from the repository root:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_norm.py
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from det3d_tpu_torch.config import load_config
from det3d_tpu_torch.data.synthetic import sample_scene
from det3d_tpu_torch.kernels import norm_cuda
from det3d_tpu_torch.models import pointpillars as pp
from test_torch_tmpdirs import tmp_path  # noqa: F401

torch.set_num_threads(1)

OP = "det3d.in_relu.default"
# (C, H, W, packed) of the 20 cm RPN's maps: block1 and deconv1, block2,
# block3, deconv2 and deconv3 on the dense network; block1 and deconv1,
# deconv2 and deconv3 on the packed one
SHAPES_20CM = [(64, 400, 400, False), (128, 200, 200, False), (256, 100, 100, False), (128, 400, 400, False),
               (128, 400, 200, True), (256, 400, 200, True)]
SMS_H100 = 132


def small_cfg(**kw):
    """The 32x32-grid geometry of chip_smoke.small_config."""
    return load_config({
        "detection_range": [-16.0, -16.0, -2.5, 16.0, 16.0, 8.5],
        "center_limit": [-16.0, -16.0, -10.0, 16.0, 16.0, 10.0],
        "voxel_size": [1.0, 1.0, 11.0], "max_voxels": 256, "max_num_points": 5,
        "max_points": 4096, "max_gt_boxes": 8, "compute_dtype": "float32", **kw,
    })


def rpn_map(b, c, h, w, dtype, device="cpu", seed=0):
    """A map like a convolution's output: per-channel offsets and scales,
    channels_last memory."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((b, h, w, c), generator=gen) * (0.5 + torch.rand(c, generator=gen))
    x = x + torch.randn((b, 1, 1, c), generator=gen)
    return x.to(device, dtype).permute(0, 3, 1, 2)


def op_count(program) -> int:
    return sum(str(n.target) == OP for n in program.graph.nodes)


class _Packed(torch.nn.Module):
    def __init__(self, rpn):
        super().__init__()
        self.rpn = rpn

    def forward(self, x):
        return self.rpn(x, pack_w=True)


# --- CPU half ------------------------------------------------------------------


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("layout", ["channels_last", "contiguous"])
def test_cpu_op_is_the_plain_pair_bit_for_bit(packed, dtype, layout):
    x = rpn_map(2, 32, 9, 6, dtype)
    if layout == "contiguous":
        x = x.contiguous()
    got = norm_cuda.in_relu(x, packed)
    want = torch.relu(pp.instance_norm(x, packed))
    assert got.dtype == dtype and got.stride() == x.stride()
    assert torch.equal(got.view(torch.int16 if dtype == torch.bfloat16 else torch.int32),
                       want.view(torch.int16 if dtype == torch.bfloat16 else torch.int32))
    assert torch.equal(norm_cuda.in_relu_plain(x, packed), want)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fake_gives_shape_dtype_and_strides(dtype):
    with FakeTensorMode():
        x = torch.empty((4, 7, 5, 64), dtype=dtype).permute(0, 3, 1, 2)
        y = torch.ops.det3d.in_relu(x, True)
    assert y.shape == (4, 64, 7, 5) and y.dtype == dtype and y.stride() == x.stride()


@pytest.mark.parametrize("packed", [False, True])
def test_opcheck(packed):
    torch.library.opcheck(torch.ops.det3d.in_relu.default, (rpn_map(2, 16, 4, 6, torch.bfloat16), packed))


@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("shape", SHAPES_20CM)
def test_plan_covers_every_row_with_several_blocks_an_sm(batch, shape):
    c, h, w, _ = shape
    rows = h * w
    p = norm_cuda.plan(batch, rows, c, SMS_H100)
    groups = norm_cuda.THREADS // (c // norm_cuda.VEC)
    assert p.rows_per_tile % groups == 0
    assert (p.tiles - 1) * p.rows_per_tile < rows <= p.tiles * p.rows_per_tile
    assert batch * p.tiles >= SMS_H100  # at least a block on every SM, at batch 1 and 4
    assert p.rows_per_tile >= groups * norm_cuda.MIN_ROWS_PER_THREAD or p.tiles == 1


def test_plan_of_a_small_map_is_one_tile():
    assert norm_cuda.plan(1, 12, 64, SMS_H100) == norm_cuda.Plan(1, 32)


@pytest.mark.parametrize("bad", ["3d", "float64", "nchw", "channels", "packed_channels", "cpu"])
def test_kernel_input_is_checked(bad):
    x = rpn_map(1, 64, 4, 4, torch.bfloat16)
    packed = False
    if bad == "3d":
        x = x[0]
    elif bad == "float64":
        x = x.double()
    elif bad == "nchw":
        x = x.contiguous()
    elif bad == "channels":
        x = rpn_map(1, 12, 4, 4, torch.bfloat16)
    elif bad == "packed_channels":
        x, packed = rpn_map(1, 24, 4, 4, torch.bfloat16), True
    with pytest.raises((ValueError, TypeError)):
        norm_cuda.check_kernel_input(x, packed)
    with pytest.raises((ValueError, TypeError)):
        norm_cuda.in_relu_cuda(x, packed)


@pytest.mark.parametrize("mode", ["no_grad", "grad", "float64"])
def test_rpn_on_the_cpu_keeps_the_plain_pair(mode):
    """On the CPU, in training and in float64 the RPN runs the modules' own
    pair: a stand-in in the op's place is never called, and the output is
    the plain network's."""
    dtype = torch.float64 if mode == "float64" else torch.float32
    rpn = pp.RPN().to(dtype)
    calls = []
    x = rpn_map(1, 64, 16, 16, dtype).requires_grad_(mode == "grad")
    with torch.set_grad_enabled(mode == "grad"):
        want = rpn(x)
        rpn.in_relu = lambda m, packed: calls.append(m) or norm_cuda.in_relu_plain(m, packed)
        got = rpn(x)
    assert calls == [] and torch.equal(got, want)
    if mode == "grad":
        got.sum().backward()
        assert x.grad is not None


@pytest.mark.parametrize("mode", ["dense", "dense_nchw", "packed", "grad", "float64"])
def test_exported_rpn_records_the_op_once_a_pair(mode):
    """`torch.export` of the inference network records det3d::in_relu for
    each of its 19 pairs, dense and packed, whatever the strides of the
    traced maps; with a gradient wanted or in float64 none."""
    rpn = pp.RPN()
    x = rpn_map(1, 64, 16, 16, torch.float32)
    if mode == "dense_nchw":
        module, x = rpn, x.contiguous()
    elif mode == "packed":
        module, x = _Packed(rpn), rpn_map(1, 256, 8, 8, torch.float32)
    elif mode == "float64":
        module, x = rpn.double(), x.double()
    else:
        module = rpn
    with torch.set_grad_enabled(mode == "grad"):
        program = torch.export.export(module, (x,), strict=False)
    assert op_count(program) == (19 if mode in ("dense", "dense_nchw", "packed") else 0)


def test_exported_dense_detector_records_19_pairs(tmp_path):  # noqa: F811
    from det3d_tpu_torch.deploy.export import PROGRAM, export_detector
    from det3d_tpu_torch.deploy.runtime import ExportedDetector
    from det3d_tpu_torch.pipeline import Detector

    cfg = small_cfg()
    export_detector(cfg, out_dir=tmp_path / "art", device="cpu")
    assert op_count(torch.export.load(str(tmp_path / "art" / PROGRAM))) == 19
    # the op's CPU implementation is the live detector's plain pair
    points = sample_scene(cfg, np.random.RandomState(0), (2, 5), ground_points=1000)["points"]
    got = ExportedDetector(tmp_path / "art", "cpu").detect(points)
    want = Detector(cfg, torch.device("cpu")).init_weights(0).detect(points)
    assert len(want["name"]) > 0
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


# --- GPU half --------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip with -m gpu)")
    return torch.device("cuda")


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32 if t.element_size() == 4 else torch.int16)


def _statistics(x: torch.Tensor, packed: bool):
    """The kernel's (mean, inv), each (B, C), from its statistics pass."""
    p = norm_cuda.kernel_plan(x)
    partial, stats = norm_cuda.scratch(x, p)
    norm_cuda.launch(x, packed, torch.empty_like(x), partial, stats, p, parts=1)
    return stats[:, 0], stats[:, 1]


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", SHAPES_20CM)
def test_kernel_against_the_plain_version(cuda, batch, dtype, shape):
    c, h, w, packed = shape
    x = rpn_map(batch, c, h, w, dtype, cuda, seed=c + h)
    mean_k, inv_k = _statistics(x, packed)
    mean_p, inv_p, _ = norm_cuda.in_moments(x, packed)
    scale = x.float().abs().mean(dim=(2, 3))
    assert ((mean_k - mean_p).abs() <= 2e-5 * scale).all()
    assert ((inv_k - inv_p).abs() <= 2e-5 * inv_p * (1 + mean_p**2 * inv_p**2)).all()
    # with the plain statistics, the apply pass is the plain one bit for bit
    p = norm_cuda.kernel_plan(x)
    partial, stats = norm_cuda.scratch(x, p)
    stats.copy_(torch.stack([mean_p, inv_p], dim=1))
    out = torch.empty_like(x)
    norm_cuda.launch(x, packed, out, partial, stats, p, parts=2)
    assert torch.equal(_bits(out), _bits(torch.relu(norm_cuda.normalize(x, mean_p, inv_p))))
    # the whole op: the kernel's statistics, applied the same way
    before = norm_cuda.counter.launches
    got = norm_cuda.in_relu(x, packed)
    assert norm_cuda.counter.launches == before + 1 and got.stride() == x.stride()
    assert torch.equal(_bits(got), _bits(torch.relu(norm_cuda.normalize(x, mean_k, inv_k))))


@pytest.mark.gpu
@pytest.mark.parametrize("packed", [False, True])
def test_two_calls_and_a_replay_are_bit_equal(cuda, packed):
    x = rpn_map(1, 128, 400, 200, torch.bfloat16, cuda)
    first = norm_cuda.in_relu(x, packed)
    assert torch.equal(_bits(norm_cuda.in_relu(x, packed)), _bits(first))
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        norm_cuda.in_relu(x, packed)  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = norm_cuda.in_relu(x, packed)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(_bits(captured), _bits(first))


@pytest.mark.gpu
def test_scratch_needs_no_initialisation(cuda):
    x = rpn_map(4, 64, 400, 400, torch.bfloat16, cuda)
    p = norm_cuda.kernel_plan(x)
    partial, stats = norm_cuda.scratch(x, p)
    partial.fill_(float("nan"))
    stats.fill_(float("nan"))
    out = torch.full_like(x, float("nan"))
    norm_cuda.launch(x, False, out, partial, stats, p)
    assert torch.equal(_bits(out), _bits(norm_cuda.in_relu(x, False)))


@pytest.mark.gpu
@pytest.mark.parametrize("bad", ["float64", "nchw", "channels", "offset", "packed_channels"])
def test_kernel_refuses_bad_input(cuda, bad):
    x = rpn_map(1, 64, 8, 8, torch.bfloat16, cuda)
    packed = False
    if bad == "float64":
        x = x.double()
    elif bad == "nchw":
        x = x.contiguous()
    elif bad == "channels":
        x = rpn_map(1, 12, 8, 8, torch.bfloat16, cuda)
    elif bad == "offset":  # channels_last memory 2 bytes off 16-byte alignment
        x = torch.randn(x.numel() + 1, device=cuda).to(x.dtype)[1:].view(1, 8, 8, 64).permute(0, 3, 1, 2)
    elif bad == "packed_channels":
        x, packed = rpn_map(1, 24, 8, 8, torch.bfloat16, cuda), True
    before = norm_cuda.counter.launches
    with pytest.raises((ValueError, TypeError)):
        norm_cuda.in_relu(x, packed)
    assert norm_cuda.counter.launches == before


@pytest.mark.gpu
def test_export_on_the_card_records_19_pairs(cuda, tmp_path):  # noqa: F811
    """The trace sees NCHW strides where cuDNN runs channels_last memory;
    the program records the op at every pair all the same, as the live
    network takes it."""
    from det3d_tpu_torch.deploy.export import PROGRAM, export_detector

    export_detector(small_cfg(), out_dir=tmp_path / "art", device=cuda)
    assert op_count(torch.export.load(str(tmp_path / "art" / PROGRAM))) == 19


@pytest.mark.gpu
@pytest.mark.parametrize("packed", [False, True])
def test_rpn_on_the_card_takes_the_op_in_inference_only(cuda, packed):
    """19 calls an inference forward (dense or packed), none under grad; the
    op's network against the plain one's within 2 % (relative norm): the
    statistics differ in their last bits, which moves a value of a bf16 map
    by at most an ulp (0.8 %) at each of the 19 normalisations."""
    rpn = pp.RPN().to(cuda)
    x = rpn_map(1, 256 if packed else 64, 64, 32 if packed else 64, torch.bfloat16, cuda)
    before = norm_cuda.counter.launches
    with torch.no_grad():
        got = rpn(x, pack_w=packed)
    assert norm_cuda.counter.launches == before + 19
    rpn.in_relu = norm_cuda.in_relu_plain
    with torch.no_grad():
        want = rpn(x, pack_w=packed)
    assert ((got.float() - want.float()).norm() / want.float().norm()).item() <= 0.02
    rpn.in_relu = norm_cuda.in_relu
    before = norm_cuda.counter.launches
    rpn(x.requires_grad_(), pack_w=packed).float().sum().backward()
    assert norm_cuda.counter.launches == before


@pytest.mark.gpu
def test_rpn_on_the_card_refuses_a_map_the_kernel_does_not_take(cuda):
    """An NCHW canvas makes NCHW maps, which the kernel does not take: the
    inference forward raises rather than run the plain pair in its place."""
    rpn = pp.RPN().to(cuda)
    x = rpn_map(1, 64, 64, 64, torch.bfloat16, cuda).contiguous()
    with torch.no_grad(), pytest.raises(ValueError, match="channels_last"):
        rpn(x)

"""InstanceNorm + ReLU of the RPN: the CUDA kernels' wrapper and the plain version.

The InstanceNorm is InstanceNorm2d without affine, eps 1e-3, over (H, W) of
an NCHW map, as the JAX package computes it: float32 single-pass sums, the
biased variance, and the normalisation applied in the map's dtype. A
`packed` map is w-parity packed (channel j and j + C/2 hold columns 2w and
2w + 1 of one logical channel) and is normalised as the unpacked map would
be. The statistics helpers and `instance_norm` live here beside the kernel
as its plain version; `models.pointpillars` builds its training
normalisations on them.

`in_relu(x, packed)` is the PyTorch custom op `det3d::in_relu`, so
`torch.export` records it as one node and a CUDA graph captures its
launches: on a CPU tensor it runs the plain version `relu(instance_norm(x,
packed))`; on a CUDA tensor it launches `csrc/instance_norm.cu` (statistics,
finalize, apply: three launches, one call) or raises for input the kernel
does not take; its fake gives the output's shape, dtype and strides. The
kernel replaces no Pallas kernel: on the TPU, XLA fuses these statistics into
the producing convolution. It has no gradient: the RPN calls it only where no
gradient is wanted.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from det3d_tpu_torch.kernels import build

THREADS = 256  # csrc/instance_norm.cu's block for the two passes
VEC = 8  # channels a thread owns
MAX_CHANNELS = THREADS * VEC
BLOCKS_PER_SM = 4  # blocks of a pass the tiles aim at, over the whole batch
MIN_ROWS_PER_THREAD = 8  # rows a thread sums at least, so that small maps make few partials
_DTYPES = (torch.float32, torch.bfloat16)

# calls of the CUDA kernels: one per `in_relu` call on a CUDA tensor
counter = build.LaunchCounter()


# --- the plain version -----------------------------------------------------------


def parity_sum(s: torch.Tensor) -> torch.Tensor:
    """(B, 2C) per-channel sums of a packed map → (B, C) sums of its logical
    channels (channel j and j + C are one channel at even and odd columns)."""
    c2 = s.shape[-1] // 2
    return s[:, :c2] + s[:, c2:]


def moments_from_sums(s1: torch.Tensor, s2: torch.Tensor, n: int, packed: bool):
    """(B, C) float32 sums over n elements per channel → mean,
    rsqrt(var + 1e-3) and the count. `packed`: channels j and j + C/2 are
    one logical channel at even and odd columns, so their sums merge (the
    JAX package's `_moments_from_sums`)."""
    if packed:
        s1, s2, n = parity_sum(s1), parity_sum(s2), 2 * n
    mean = s1 / n
    var = torch.clamp(s2 / n - mean * mean, min=0.0)
    inv = torch.rsqrt(var + 1e-3)
    if packed:
        mean, inv = torch.cat([mean, mean], dim=-1), torch.cat([inv, inv], dim=-1)
    return mean, inv, n


def in_moments(x: torch.Tensor, packed: bool = False):
    """Per-(sample, channel) float32 mean and rsqrt(var + 1e-3) of an NCHW
    map, from single-pass sums; and the element count per channel. A
    float64 map keeps float64 (a reference computation's precision)."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    return moments_from_sums(xf.sum(dim=(2, 3)), (xf * xf).sum(dim=(2, 3)), x.shape[2] * x.shape[3], packed)


def broadcast(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """(B, C) statistics broadcast over an NCHW map, in its dtype."""
    return t[:, :, None, None].to(like.dtype)


def normalize(x: torch.Tensor, mean: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """(x − mean)·inv in x's dtype, rounded after each operation."""
    return (x - broadcast(mean, x)) * broadcast(inv, x)


def instance_norm(x: torch.Tensor, packed: bool = False) -> torch.Tensor:
    """InstanceNorm2d without affine, eps 1e-3, over (H, W) of an NCHW map
    (reference :128): float32 single-pass moments, the biased variance, and
    the normalisation applied in the input dtype, as the JAX package does.
    `packed`: a w-parity packed map, normalised as the unpacked map would be."""
    mean, inv, _ = in_moments(x, packed)
    return normalize(x, mean, inv)


def in_relu_plain(x: torch.Tensor, packed: bool = False) -> torch.Tensor:
    """The plain version, on any device: `relu(instance_norm(x, packed))`."""
    return torch.relu(instance_norm(x, packed))


# --- the kernel ----------------------------------------------------------------


class Plan(NamedTuple):
    """How `csrc/instance_norm.cu` cuts a map: `tiles` tiles of
    `rows_per_tile` memory rows (pixels) per sample, each one block of both
    passes and one partial of the statistics."""

    tiles: int
    rows_per_tile: int


def plan(batch: int, rows: int, channels: int, sms: int) -> Plan:
    """Tiles for a (batch, rows, channels) map on a card of `sms` SMs: about
    BLOCKS_PER_SM blocks an SM over the whole batch, but no fewer than
    MIN_ROWS_PER_THREAD rows a thread; a tile is a whole number of the rows
    a block has in flight (THREADS / (channels / VEC))."""
    groups = THREADS // (channels // VEC)
    want = -(-BLOCKS_PER_SM * sms // batch)
    most = max(1, rows // (groups * MIN_ROWS_PER_THREAD))
    per_tile = -(-rows // max(1, min(want, most)))
    per_tile = -(-per_tile // groups) * groups
    return Plan(-(-rows // per_tile), per_tile)


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("instance_norm")
    fn = lib.det3d_in_relu
    i32 = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [i32, ctypes.c_int64, i32, i32, i32, i32, i32, i32, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def check_kernel_input(x: torch.Tensor, packed: bool) -> None:
    """Raise for a map the kernel does not take (the device last, so that
    the other checks run on CPU tensors too)."""
    if x.dim() != 4 or x.numel() == 0:
        raise ValueError(f"expected a non-empty NCHW map, got {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"the map must be float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"the map must be an NCHW view of channels_last memory, got strides {x.stride()}")
    c = x.shape[1]
    if c % VEC or c > MAX_CHANNELS or (packed and c % (2 * VEC)):
        raise ValueError(f"{c} channels: the kernel takes a multiple of {VEC} ({2 * VEC} packed) up to "
                         f"{MAX_CHANNELS}")
    if x.shape[0] > 65535:
        raise ValueError(f"batch {x.shape[0]} over the kernel's 65535")
    if x.data_ptr() % 16:
        raise ValueError("the map must be 16-byte aligned")
    if x.device.type != "cuda":
        raise ValueError(f"in_relu_cuda needs a CUDA tensor, got {x.device}")


def scratch(x: torch.Tensor, p: Plan) -> tuple[torch.Tensor, torch.Tensor]:
    """(partials (B, tiles, 2, C), statistics (B, 2, C): mean then inv), float32
    and not initialised: the kernels write every value before they read it."""
    b, c = x.shape[:2]
    return (torch.empty((b, p.tiles, 2, c), dtype=torch.float32, device=x.device),
            torch.empty((b, 2, c), dtype=torch.float32, device=x.device))


def launch(x: torch.Tensor, packed: bool, out: torch.Tensor, partial: torch.Tensor, stats: torch.Tensor,
           p: Plan, parts: int = 3) -> None:
    """Launch `csrc/instance_norm.cu` on a checked map, uncounted: the
    statistics into `stats` (parts 1), `out` from `stats` (2), or both (3),
    which is how the passes are tested and timed apart."""
    b, c, h, w = x.shape
    with torch.cuda.device(x.device):  # the runtime launches on the current device
        err = _lib().det3d_in_relu(
            x.data_ptr(), out.data_ptr(), partial.data_ptr(), stats.data_ptr(), b, h * w, c, x.element_size(),
            p.tiles, p.rows_per_tile, int(packed), parts, torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"instance_norm.cu failed with CUDA error {err}")


def kernel_plan(x: torch.Tensor) -> Plan:
    b, c, h, w = x.shape
    return plan(b, h * w, c, _sms(x.device.index if x.device.index is not None else torch.cuda.current_device()))


def in_relu_cuda(x: torch.Tensor, packed: bool = False) -> torch.Tensor:
    """Launch `csrc/instance_norm.cu` on a CUDA map: relu(instance_norm(x,
    packed)) in x's dtype and channels_last memory."""
    check_kernel_input(x, packed)
    b, c, h, w = x.shape
    out = torch.empty((b, h, w, c), dtype=x.dtype, device=x.device).permute(0, 3, 1, 2)
    p = kernel_plan(x)
    launch(x, packed, out, *scratch(x, p), p)
    counter.launches += 1
    return out


_in_relu_op = torch.library.custom_op(
    "det3d::in_relu", in_relu_plain, mutates_args=(), device_types="cpu", schema="(Tensor x, bool packed) -> Tensor",
)
_in_relu_op.register_kernel("cuda")(in_relu_cuda)
_in_relu_op.register_fake(lambda x, packed: torch.empty_like(x))


def in_relu(x: torch.Tensor, packed: bool = False) -> torch.Tensor:
    """relu(instance_norm(x, packed)) of an NCHW map: the CUDA kernel for a
    CUDA tensor, the plain version for a CPU tensor (the op `det3d::in_relu`)."""
    return _in_relu_op(x, bool(packed))

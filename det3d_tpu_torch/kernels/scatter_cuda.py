"""BEV canvas scatters: the CUDA kernels' wrappers and their plain versions.

Pillar features (B, V, C) and pillar coordinates (B, V, 3) become a
zero-initialised canvas: row v lands on cell (x, y) = coors[b, v, :2]; rows
whose x is negative (empty pillar slots) are dropped, and so are rows
outside the grid. Cells are unique, so no two rows collide. Three canvases:

  * `scatter_to_bev`: the dense canvas (B, nx, ny, C); counterpart of
    `scatter_to_bev_pallas` in the JAX package (kernels/scatter_pallas.py,
    `_canvas_kernel`, VJP `_scatter_bwd`);
  * `scatter_to_bev_s2d`: the 4-phase space-to-depth canvas
    (B, nx/2, ny/2, 4C), cell (x/2, y/2), channel block phase =
    (x%2)·2 + y%2; `w_major` computes it in W-major memory and returns the
    logical tensor as a transposed view. Counterpart of
    `scatter_to_bev_s2d_pallas` (`_canvas_s2d_kernel`, VJP
    `_scatter_s2d_bwd`);
  * `scatter_to_bev_s2d_blocked`: the s2d canvas as `nblk` row blocks with
    `halo` = (ht, hb) duplicated neighbour rows, (B, nblk, rb + ht + hb,
    ny/2, 4C) with rb = (nx/2)/nblk, zeros past the canvas edge.
    Counterpart of `scatter_to_bev_s2d_blocked` (`_canvas_s2d_blocked_kernel`,
    VJP `_scatter_s2d_blocked_bwd`).

Each is a PyTorch custom op (`det3d::scatter_to_bev`,
`det3d::scatter_to_bev_s2d`, `det3d::scatter_to_bev_s2d_blocked`, over the
same `ctypes` launches), so `torch.export` records it as one node and a
CUDA graph captures its launches. Each is differentiable in the features:
its backward, an op too (`det3d::*_bwd`), gathers each kept row's cotangent
from the canvas (zero for dropped rows), summed over the halo copies for
the blocked canvas. Every op has a CPU implementation, the plain version
(`*_plain`), a CUDA implementation, which launches `csrc/scatter.cu` or
raises, and a fake one that gives the output's shape, dtype and strides;
there is no fallback from one device to the other. Each kernel has its own
launch counter.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from det3d_tpu_torch.kernels import build

_DTYPES = (torch.float32, torch.bfloat16)


# launches of the CUDA kernels: one per forward / backward on CUDA tensors
counter = build.LaunchCounter()
bwd_counter = build.LaunchCounter()
s2d_counter = build.LaunchCounter()
s2d_bwd_counter = build.LaunchCounter()
blocked_counter = build.LaunchCounter()
blocked_bwd_counter = build.LaunchCounter()


def _check(pillar_features: torch.Tensor, coors: torch.Tensor, grid_xy) -> None:
    if pillar_features.dim() != 3 or coors.dim() != 3 or coors.shape[-1] != 3:
        raise ValueError(
            f"expected feats (B, V, C) and coors (B, V, 3), got "
            f"{tuple(pillar_features.shape)} and {tuple(coors.shape)}"
        )
    if pillar_features.shape[:2] != coors.shape[:2]:
        raise ValueError("feats and coors disagree on (B, V)")
    if pillar_features.dtype not in _DTYPES:
        raise TypeError(f"feats must be float32 or bfloat16, got {pillar_features.dtype}")
    if coors.dtype != torch.int32:
        raise TypeError(f"coors must be int32, got {coors.dtype}")
    if pillar_features.device != coors.device:
        raise ValueError("feats and coors are on different devices")
    if len(grid_xy) != 2 or min(grid_xy) < 1:
        raise ValueError(f"bad grid {grid_xy}")


def scatter_to_bev_plain(pillar_features: torch.Tensor, coors: torch.Tensor, grid_xy) -> torch.Tensor:
    """The plain PyTorch scatter, on any device."""
    _check(pillar_features, coors, grid_xy)
    nx, ny = grid_xy
    b, v, c = pillar_features.shape
    bi, x, y, keep = _kept_rows(coors, grid_xy)
    canvas = pillar_features.new_zeros((b, nx, ny, c))
    canvas[bi[keep], x[keep], y[keep]] = pillar_features[keep]
    return canvas


def _kept_rows(coors: torch.Tensor, grid_xy):
    """(batch index, x, y, keep) of every pillar row; `keep` drops empty
    slots and rows outside the grid."""
    nx, ny = grid_xy
    b, v = coors.shape[:2]
    x = coors[..., 0].long()
    y = coors[..., 1].long()
    keep = (x >= 0) & (x < nx) & (y >= 0) & (y < ny)
    bi = torch.arange(b, device=coors.device)[:, None].expand(b, v)
    return bi, x, y, keep


def scatter_to_bev_bwd_plain(grad_canvas: torch.Tensor, coors: torch.Tensor) -> torch.Tensor:
    """The plain backward on any device: (B, nx, ny, C) canvas cotangent →
    (B, V, C) feature cotangent, each kept row's cell gathered, zero
    elsewhere."""
    b, nx, ny, c = grad_canvas.shape
    bi, x, y, keep = _kept_rows(coors, (nx, ny))
    dfeats = grad_canvas.new_zeros((b, coors.shape[1], c))
    dfeats[keep] = grad_canvas[bi[keep], x[keep], y[keep]]
    return dfeats


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("scatter")
    ptrs, i32, i64 = [ctypes.c_void_p] * 3, ctypes.c_int, ctypes.c_int64
    for name, ints in (
        ("det3d_scatter_to_bev", [i32] * 6),
        ("det3d_scatter_to_bev_s2d", [i32] * 7),
        ("det3d_scatter_to_bev_s2d_blocked", [i32] * 9),
        ("det3d_scatter_to_bev_bwd", [i32] * 6 + [i64] * 3),
        ("det3d_scatter_to_bev_s2d_bwd", [i32] * 6 + [i64] * 3),
        ("det3d_scatter_to_bev_s2d_blocked_bwd", [i32] * 9 + [i64] * 4),
    ):
        fn = getattr(lib, name)
        fn.argtypes = ptrs + ints + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    fn = lib.det3d_scatter_to_bev_s2d_blocked_bwd_piece_bytes
    fn.argtypes = ptrs[:2] + [i32] * 2 + [i64] * 4
    fn.restype = ctypes.c_int
    return lib


def _check_kernel_inputs(pillar_features: torch.Tensor, coors: torch.Tensor, name: str) -> None:
    if pillar_features.device.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {pillar_features.device}")
    if not (pillar_features.is_contiguous() and coors.is_contiguous()):
        raise ValueError("feats and coors must be contiguous")


def _check_grad(grad_canvas: torch.Tensor, coors: torch.Tensor, ndim: int, name: str, phases: int = 1) -> None:
    if grad_canvas.dim() != ndim or coors.dim() != 3 or coors.shape[-1] != 3 or grad_canvas.shape[0] != coors.shape[0]:
        raise ValueError(f"{name}: expected a {ndim}-d grad and coors (B, V, 3), got "
                         f"{tuple(grad_canvas.shape)} and {tuple(coors.shape)}")
    if grad_canvas.dtype not in _DTYPES or coors.dtype != torch.int32:
        raise TypeError(f"grad must be float32 or bfloat16 and coors int32, got {grad_canvas.dtype}, {coors.dtype}")
    if grad_canvas.device.type != "cuda" or coors.device != grad_canvas.device:
        raise ValueError(f"{name} needs CUDA tensors, got {grad_canvas.device}, {coors.device}")
    if grad_canvas.stride(-1) != 1 and grad_canvas.shape[-1] > 1:
        raise ValueError(f"grad must have unit channel stride, got strides {grad_canvas.stride()}")
    if grad_canvas.shape[-1] % phases:
        raise ValueError(f"a grad of {phases} phases per cell needs a multiple of {phases} channels, "
                         f"got {grad_canvas.shape[-1]}")
    if not coors.is_contiguous():
        raise ValueError("coors must be contiguous")


def scatter_to_bev_cuda(pillar_features: torch.Tensor, coors: torch.Tensor, grid_xy) -> torch.Tensor:
    """Launch `csrc/scatter.cu` on CUDA tensors (fill + row copy)."""
    _check(pillar_features, coors, grid_xy)
    _check_kernel_inputs(pillar_features, coors, "scatter_to_bev_cuda")
    nx, ny = grid_xy
    b, v, c = pillar_features.shape
    canvas = torch.empty((b, nx, ny, c), dtype=pillar_features.dtype, device=pillar_features.device)
    stream = torch.cuda.current_stream(pillar_features.device).cuda_stream
    with torch.cuda.device(pillar_features.device):  # the runtime launches on the current device
        err = _lib().det3d_scatter_to_bev(
            pillar_features.data_ptr(), coors.data_ptr(), canvas.data_ptr(),
            b, v, c, pillar_features.element_size(), nx, ny, stream,
        )
    if err != 0:
        raise RuntimeError(f"scatter.cu failed with CUDA error {err}")
    counter.launches += 1
    return canvas


def scatter_to_bev_bwd_cuda(grad_canvas: torch.Tensor, coors: torch.Tensor) -> torch.Tensor:
    """Launch the backward gather of `csrc/scatter.cu` on CUDA tensors. The
    cotangent is read through its strides (channels must be its innermost,
    unit-stride axis), so the channels-last map a convolution hands back is
    never copied."""
    _check_grad(grad_canvas, coors, 4, "scatter_to_bev_bwd_cuda")
    b, nx, ny, c = grad_canvas.shape
    v = coors.shape[1]
    dfeats = torch.empty((b, v, c), dtype=grad_canvas.dtype, device=grad_canvas.device)
    sb, sx, sy, _ = grad_canvas.stride()
    with torch.cuda.device(grad_canvas.device):  # the runtime launches on the current device
        err = _lib().det3d_scatter_to_bev_bwd(
            grad_canvas.data_ptr(), coors.data_ptr(), dfeats.data_ptr(),
            b, v, c, grad_canvas.element_size(), nx, ny, sb, sx, sy,
            torch.cuda.current_stream(grad_canvas.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"scatter.cu backward failed with CUDA error {err}")
    bwd_counter.launches += 1
    return dfeats


def _op(name: str, schema: str, cpu, cuda, fake):
    """Register the op `det3d::<name>(<schema>)`: `cpu` on the CPU, `cuda`
    on the card, `fake` for tracing."""
    op = torch.library.custom_op(f"det3d::{name}", cpu, mutates_args=(), device_types="cpu", schema=schema)
    op.register_kernel("cuda")(cuda)
    op.register_fake(fake)
    return op


def _save_coors(ctx, inputs, output):
    ctx.save_for_backward(inputs[1])


_scatter_op = _op(
    "scatter_to_bev", "(Tensor feats, Tensor coors, int nx, int ny) -> Tensor",
    lambda f, c, nx, ny: scatter_to_bev_plain(f, c, (nx, ny)),
    lambda f, c, nx, ny: scatter_to_bev_cuda(f, c, (nx, ny)),
    lambda f, c, nx, ny: f.new_empty((f.shape[0], nx, ny, f.shape[2])),
)
_scatter_bwd_op = _op(
    "scatter_to_bev_bwd", "(Tensor grad, Tensor coors) -> Tensor",
    scatter_to_bev_bwd_plain, scatter_to_bev_bwd_cuda,
    lambda g, c: g.new_empty((g.shape[0], c.shape[1], g.shape[3])),
)
_scatter_op.register_autograd(lambda ctx, g: (_scatter_bwd_op(g, ctx.saved_tensors[0]), None, None, None),
                              setup_context=_save_coors)


def scatter_to_bev(pillar_features: torch.Tensor, coors: torch.Tensor, grid_xy) -> torch.Tensor:
    """(B, V, C) features + (B, V, 3) int32 coords → (B, nx, ny, C) canvas,
    differentiable in the features: the CUDA kernels for CUDA tensors, the
    plain versions for CPU tensors (the op `det3d::scatter_to_bev`)."""
    _check(pillar_features, coors, grid_xy)
    return _scatter_op(pillar_features, coors, int(grid_xy[0]), int(grid_xy[1]))


# --- the space-to-depth canvases -------------------------------------------


def _check_s2d(pillar_features: torch.Tensor, coors: torch.Tensor, grid_xy) -> None:
    _check(pillar_features, coors, grid_xy)
    if grid_xy[0] % 2 or grid_xy[1] % 2:
        raise ValueError(f"the s2d canvas needs an even grid, got {grid_xy}")


def blocked_rows(grid_xy, nblk: int, halo) -> tuple[int, int]:
    """(rows per block rb, rows per block with halos rtot) of the blocked
    s2d canvas. nblk must divide nx/2 and each halo be at most rb rows, so
    that a pillar has at most one halo copy on each side."""
    nx2 = grid_xy[0] // 2
    ht, hb = halo
    if nblk < 1 or nx2 % nblk:
        raise ValueError(f"{nblk} blocks do not divide the {nx2} s2d rows")
    rb = nx2 // nblk
    if min(ht, hb) < 0 or max(ht, hb) > rb:
        raise ValueError(f"halo {tuple(halo)} must lie within 0..{rb} rows (one block)")
    return rb, rb + ht + hb


def _s2d_index(coors: torch.Tensor, grid_xy):
    """(batch index, x/2, y/2, phase, keep) of every pillar row; the
    coordinates of dropped rows are 0."""
    bi, x, y, keep = _kept_rows(coors, grid_xy)
    x, y = torch.where(keep, x, 0), torch.where(keep, y, 0)
    return bi, x // 2, y // 2, (x % 2) * 2 + y % 2, keep


def _blocked_places(coors: torch.Tensor, grid_xy, nblk: int, halo):
    """(batch index, y/2, phase, places) of every pillar row, where places
    are the (present, block, local row) of its own copy, of its copy in the
    block above's bottom halo and of its copy in the block below's top
    halo. Block and row are clamped into range where `present` is false."""
    rb, rtot = blocked_rows(grid_xy, nblk, halo)
    ht, hb = halo
    bi, r, y2, phase, keep = _s2d_index(coors, grid_xy)
    j0 = r // rb
    off = r - j0 * rb
    places = (
        (keep, j0, off + ht),
        (keep & (off < hb) & (j0 > 0), (j0 - 1).clamp(min=0), (off + rb + ht).clamp(max=rtot - 1)),
        (keep & (off >= rb - ht) & (j0 < nblk - 1), (j0 + 1).clamp(max=nblk - 1), (off - rb + ht).clamp(min=0)),
    )
    return bi, y2, phase, places


def scatter_to_bev_s2d_plain(pillar_features: torch.Tensor, coors: torch.Tensor, grid_xy,
                             w_major: bool = False) -> torch.Tensor:
    """The plain s2d scatter, on any device: (B, nx/2, ny/2, 4C); with
    `w_major` the same logical tensor, a view of W-major memory."""
    _check_s2d(pillar_features, coors, grid_xy)
    nx2, ny2 = grid_xy[0] // 2, grid_xy[1] // 2
    b, v, c = pillar_features.shape
    bi, x2, y2, phase, keep = _s2d_index(coors, grid_xy)
    if w_major:
        canvas = pillar_features.new_zeros((b, ny2, nx2, 4, c))
        canvas[bi[keep], y2[keep], x2[keep], phase[keep]] = pillar_features[keep]
        return canvas.reshape(b, ny2, nx2, 4 * c).transpose(1, 2)
    canvas = pillar_features.new_zeros((b, nx2, ny2, 4, c))
    canvas[bi[keep], x2[keep], y2[keep], phase[keep]] = pillar_features[keep]
    return canvas.reshape(b, nx2, ny2, 4 * c)


def scatter_to_bev_s2d_bwd_plain(grad_canvas: torch.Tensor, coors: torch.Tensor) -> torch.Tensor:
    """The plain s2d backward on any device: (B, nx/2, ny/2, 4C) cotangent
    (either memory order) → (B, V, C), each kept row's cell and phase
    gathered, zero elsewhere."""
    b, nx2, ny2, c4 = grad_canvas.shape
    bi, x2, y2, phase, keep = _s2d_index(coors, (2 * nx2, 2 * ny2))
    g5 = grad_canvas.unflatten(-1, (4, c4 // 4))
    dfeats = grad_canvas.new_zeros((b, coors.shape[1], c4 // 4))
    dfeats[keep] = g5[bi[keep], x2[keep], y2[keep], phase[keep]]
    return dfeats


def scatter_to_bev_s2d_blocked_plain(pillar_features: torch.Tensor, coors: torch.Tensor, grid_xy,
                                     nblk: int, halo) -> torch.Tensor:
    """The plain blocked s2d scatter, on any device:
    (B, nblk, rb + ht + hb, ny/2, 4C), each pillar at its own block and at
    its copies in the neighbours' halos."""
    _check_s2d(pillar_features, coors, grid_xy)
    _, rtot = blocked_rows(grid_xy, nblk, halo)
    ny2 = grid_xy[1] // 2
    b, v, c = pillar_features.shape
    bi, y2, phase, places = _blocked_places(coors, grid_xy, nblk, halo)
    canvas = pillar_features.new_zeros((b, nblk, rtot, ny2, 4, c))
    for present, blk, row in places:
        canvas[bi[present], blk[present], row[present], y2[present], phase[present]] = pillar_features[present]
    return canvas.reshape(b, nblk, rtot, ny2, 4 * c)


def scatter_to_bev_s2d_blocked_bwd_plain(grad_canvas: torch.Tensor, coors: torch.Tensor, halo) -> torch.Tensor:
    """The plain blocked backward on any device: (B, nblk, rtot, ny/2, 4C)
    cotangent → (B, V, C), the sum (own + above) + below of a kept row's
    copies (each term 0 where there is no copy), zero for dropped rows."""
    b, nblk, rtot, ny2, c4 = grad_canvas.shape
    nx2 = nblk * (rtot - halo[0] - halo[1])
    bi, y2, phase, places = _blocked_places(coors, (2 * nx2, 2 * ny2), nblk, halo)
    g6 = grad_canvas.unflatten(-1, (4, c4 // 4))
    dfeats = None
    for present, blk, row in places:
        part = torch.where(present[..., None], g6[bi, blk, row, y2, phase], 0)
        dfeats = part if dfeats is None else dfeats + part
    return dfeats


def scatter_to_bev_s2d_cuda(pillar_features: torch.Tensor, coors: torch.Tensor, grid_xy,
                            w_major: bool = False) -> torch.Tensor:
    """Launch the s2d scatter of `csrc/scatter.cu` on CUDA tensors (fill +
    row copy); `w_major` fills (B, ny/2, nx/2, 4C) memory and returns its
    (B, nx/2, ny/2, 4C) transposed view."""
    _check_s2d(pillar_features, coors, grid_xy)
    _check_kernel_inputs(pillar_features, coors, "scatter_to_bev_s2d_cuda")
    nx, ny = grid_xy
    b, v, c = pillar_features.shape
    shape = (b, ny // 2, nx // 2, 4 * c) if w_major else (b, nx // 2, ny // 2, 4 * c)
    canvas = torch.empty(shape, dtype=pillar_features.dtype, device=pillar_features.device)
    with torch.cuda.device(pillar_features.device):  # the runtime launches on the current device
        err = _lib().det3d_scatter_to_bev_s2d(
            pillar_features.data_ptr(), coors.data_ptr(), canvas.data_ptr(),
            b, v, c, pillar_features.element_size(), nx, ny, int(w_major),
            torch.cuda.current_stream(pillar_features.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"scatter.cu s2d failed with CUDA error {err}")
    s2d_counter.launches += 1
    return canvas.transpose(1, 2) if w_major else canvas


def scatter_to_bev_s2d_bwd_cuda(grad_canvas: torch.Tensor, coors: torch.Tensor) -> torch.Tensor:
    """Launch the s2d backward gather of `csrc/scatter.cu` on the logical
    (B, nx/2, ny/2, 4C) cotangent, read through its strides (channels its
    unit-stride axis) in either memory order, never copied."""
    _check_grad(grad_canvas, coors, 4, "scatter_to_bev_s2d_bwd_cuda", phases=4)
    b, nx2, ny2, c4 = grad_canvas.shape
    v = coors.shape[1]
    dfeats = torch.empty((b, v, c4 // 4), dtype=grad_canvas.dtype, device=grad_canvas.device)
    sb, sx, sy, _ = grad_canvas.stride()
    with torch.cuda.device(grad_canvas.device):  # the runtime launches on the current device
        err = _lib().det3d_scatter_to_bev_s2d_bwd(
            grad_canvas.data_ptr(), coors.data_ptr(), dfeats.data_ptr(),
            b, v, c4 // 4, grad_canvas.element_size(), 2 * nx2, 2 * ny2, sb, sx, sy,
            torch.cuda.current_stream(grad_canvas.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"scatter.cu s2d backward failed with CUDA error {err}")
    s2d_bwd_counter.launches += 1
    return dfeats


def scatter_to_bev_s2d_blocked_cuda(pillar_features: torch.Tensor, coors: torch.Tensor, grid_xy,
                                    nblk: int, halo) -> torch.Tensor:
    """Launch the blocked s2d scatter of `csrc/scatter.cu` on CUDA tensors
    (fill + up to three row copies per pillar)."""
    _check_s2d(pillar_features, coors, grid_xy)
    _check_kernel_inputs(pillar_features, coors, "scatter_to_bev_s2d_blocked_cuda")
    _, rtot = blocked_rows(grid_xy, nblk, halo)
    nx, ny = grid_xy
    b, v, c = pillar_features.shape
    canvas = torch.empty((b, nblk, rtot, ny // 2, 4 * c), dtype=pillar_features.dtype,
                         device=pillar_features.device)
    with torch.cuda.device(pillar_features.device):  # the runtime launches on the current device
        err = _lib().det3d_scatter_to_bev_s2d_blocked(
            pillar_features.data_ptr(), coors.data_ptr(), canvas.data_ptr(),
            b, v, c, pillar_features.element_size(), nx, ny, nblk, halo[0], halo[1],
            torch.cuda.current_stream(pillar_features.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"scatter.cu blocked s2d failed with CUDA error {err}")
    blocked_counter.launches += 1
    return canvas


def scatter_to_bev_s2d_blocked_bwd_cuda(grad_canvas: torch.Tensor, coors: torch.Tensor, halo) -> torch.Tensor:
    """Launch the blocked backward of `csrc/scatter.cu`: the (B, nblk, rtot,
    ny/2, 4C) cotangent read through its strides, each kept row's copies
    summed in the plain version's order."""
    _check_grad(grad_canvas, coors, 5, "scatter_to_bev_s2d_blocked_bwd_cuda", phases=4)
    b, nblk, rtot, ny2, c4 = grad_canvas.shape
    nx2 = nblk * (rtot - halo[0] - halo[1])
    blocked_rows((2 * nx2, 2 * ny2), nblk, halo)
    v = coors.shape[1]
    dfeats = torch.empty((b, v, c4 // 4), dtype=grad_canvas.dtype, device=grad_canvas.device)
    sb, sj, sr, sy, _ = grad_canvas.stride()
    with torch.cuda.device(grad_canvas.device):  # the runtime launches on the current device
        err = _lib().det3d_scatter_to_bev_s2d_blocked_bwd(
            grad_canvas.data_ptr(), coors.data_ptr(), dfeats.data_ptr(),
            b, v, c4 // 4, int(grad_canvas.dtype == torch.bfloat16), 2 * nx2, 2 * ny2, nblk, halo[0], halo[1],
            sb, sj, sr, sy, torch.cuda.current_stream(grad_canvas.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"scatter.cu blocked s2d backward failed with CUDA error {err}")
    blocked_bwd_counter.launches += 1
    return dfeats


def blocked_bwd_piece_bytes(grad_canvas: torch.Tensor) -> int:
    """The piece width in bytes that `scatter_to_bev_s2d_blocked_bwd_cuda`
    launches its kernel with for `grad_canvas`, as csrc/scatter.cu picks it:
    16, or one element where the cotangent's pointer or strides are not
    16-byte aligned (its dfeats, a fresh allocation, always is)."""
    sb, sj, sr, sy, _ = grad_canvas.stride()
    return _lib().det3d_scatter_to_bev_s2d_blocked_bwd_piece_bytes(
        grad_canvas.data_ptr(), 0, grad_canvas.shape[-1] // 4, int(grad_canvas.dtype == torch.bfloat16),
        sb, sj, sr, sy)


def _s2d_fake(f, c, nx, ny, w_major):
    b, _, ch = f.shape
    if w_major:
        return f.new_empty((b, ny // 2, nx // 2, 4 * ch)).transpose(1, 2)
    return f.new_empty((b, nx // 2, ny // 2, 4 * ch))


_s2d_op = _op(
    "scatter_to_bev_s2d", "(Tensor feats, Tensor coors, int nx, int ny, bool w_major) -> Tensor",
    lambda f, c, nx, ny, w_major: scatter_to_bev_s2d_plain(f, c, (nx, ny), w_major),
    lambda f, c, nx, ny, w_major: scatter_to_bev_s2d_cuda(f, c, (nx, ny), w_major),
    _s2d_fake,
)
_s2d_bwd_op = _op(
    "scatter_to_bev_s2d_bwd", "(Tensor grad, Tensor coors) -> Tensor",
    scatter_to_bev_s2d_bwd_plain, scatter_to_bev_s2d_bwd_cuda,
    lambda g, c: g.new_empty((g.shape[0], c.shape[1], g.shape[3] // 4)),
)
_s2d_op.register_autograd(lambda ctx, g: (_s2d_bwd_op(g, ctx.saved_tensors[0]), None, None, None, None),
                          setup_context=_save_coors)


def _blocked_fake(f, c, nx, ny, nblk, ht, hb):
    _, rtot = blocked_rows((nx, ny), nblk, (ht, hb))
    return f.new_empty((f.shape[0], nblk, rtot, ny // 2, 4 * f.shape[2]))


def _save_blocked(ctx, inputs, output):
    ctx.save_for_backward(inputs[1])
    ctx.halo = (inputs[5], inputs[6])


_blocked_op = _op(
    "scatter_to_bev_s2d_blocked",
    "(Tensor feats, Tensor coors, int nx, int ny, int nblk, int ht, int hb) -> Tensor",
    lambda f, c, nx, ny, nblk, ht, hb: scatter_to_bev_s2d_blocked_plain(f, c, (nx, ny), nblk, (ht, hb)),
    lambda f, c, nx, ny, nblk, ht, hb: scatter_to_bev_s2d_blocked_cuda(f, c, (nx, ny), nblk, (ht, hb)),
    _blocked_fake,
)
_blocked_bwd_op = _op(
    "scatter_to_bev_s2d_blocked_bwd", "(Tensor grad, Tensor coors, int ht, int hb) -> Tensor",
    lambda g, c, ht, hb: scatter_to_bev_s2d_blocked_bwd_plain(g, c, (ht, hb)),
    lambda g, c, ht, hb: scatter_to_bev_s2d_blocked_bwd_cuda(g, c, (ht, hb)),
    lambda g, c, ht, hb: g.new_empty((g.shape[0], c.shape[1], g.shape[4] // 4)),
)
_blocked_op.register_autograd(
    lambda ctx, g: (_blocked_bwd_op(g, ctx.saved_tensors[0], *ctx.halo),) + (None,) * 6,
    setup_context=_save_blocked)


def scatter_to_bev_s2d(pillar_features: torch.Tensor, coors: torch.Tensor, grid_xy,
                       w_major: bool = False) -> torch.Tensor:
    """(B, V, C) features + (B, V, 3) int32 coords → (B, nx/2, ny/2, 4C) s2d
    canvas, differentiable in the features: the CUDA kernels for CUDA
    tensors, the plain versions for CPU tensors (`det3d::scatter_to_bev_s2d`)."""
    _check_s2d(pillar_features, coors, grid_xy)
    return _s2d_op(pillar_features, coors, int(grid_xy[0]), int(grid_xy[1]), bool(w_major))


def scatter_to_bev_s2d_blocked(pillar_features: torch.Tensor, coors: torch.Tensor, grid_xy,
                               nblk: int, halo) -> torch.Tensor:
    """(B, V, C) features + (B, V, 3) int32 coords → (B, nblk, rb + ht + hb,
    ny/2, 4C) blocked s2d canvas, differentiable in the features (the
    backward sums each pillar's halo copies): the CUDA kernels for CUDA
    tensors, the plain versions for CPU tensors
    (`det3d::scatter_to_bev_s2d_blocked`)."""
    _check_s2d(pillar_features, coors, grid_xy)
    blocked_rows(grid_xy, nblk, halo)
    return _blocked_op(pillar_features, coors, int(grid_xy[0]), int(grid_xy[1]), int(nblk), int(halo[0]),
                       int(halo[1]))

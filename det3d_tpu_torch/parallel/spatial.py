"""One frame's RPN split along x over the ranks of a spatial group: the
slab partition, the halo exchange around every 3x3 convolution, the
InstanceNorm statistics summed over the slabs, and the gather of the
head's outputs.

Counterpart of what GSPMD does for the JAX package's spatial modes
(parallel/mesh.py `make_spatial_infer`, `make_spatial_train`: the canvas
pinned sharded along x by `PointPillars.canvas_sharding`, every
convolution partitioned with automatic halo exchanges). PyTorch has no
such compiler, so the collectives are written here, forward and backward:

  * `slab_bounds(nx, sp)`: the coarse map (block 3's resolution, nx/8
    rows) split into `sp` contiguous ranges whose sizes differ by at most
    one, larger ones first; level l (0 the canvas, 3 the coarse map) takes
    the coarse bounds times 2^(3-l). Every 3x3 convolution then needs one
    halo row a side (a stride-2 one reads only the low one, and gets both:
    one code path), a kernel = stride upsample none, the 1x1 head none.
    More ranks than coarse rows raise (GSPMD would pad: a divergence by
    decision).
  * `halo_exchange(x, mesh)`: the slab with its neighbours' edge rows
    around it (zeros at the canvas's edges), from one all-gather of every
    rank's two edge rows; its backward sends each halo row's cotangent to
    the row's owner, which adds it to its edge row's gradient (one more
    all-gather).
  * `spatial_instance_norm(x, mesh, n_global)`: InstanceNorm whose float32
    [Σx, Σx²] are summed over the slabs (one all-reduce) and divided by
    the whole map's element count; the analytic backward of
    `models.pointpillars.InstanceNormFn` with [Σg, Σg·x̂] summed the same
    way (one all-reduce).
  * `gather_rows(preds, mesh, bounds)`: the head's slab outputs gathered
    along the feature map's x axis (dim 3 of the (N, k, nch, fx, fy)
    contract), padded to the largest slab and trimmed; its backward is
    this rank's own slice of the cotangent, since every rank of the group
    computes the same loss from the gathered outputs (a reduce-scatter
    would multiply the gradients by the group's size).

Every collective is counted on the mesh by kind (`DataMesh.collectives`).
All of them are all-gathers and all-reduces, which NCCL and gloo both run
on CUDA and CPU tensors; the halo rows and the preds travel as bytes, so
bf16 maps cross gloo too, and the statistics are float32.
"""

from __future__ import annotations

import dataclasses

import torch

LEVELS = 3  # stride-2 blocks between the canvas and the coarse map


def slab_bounds(nx: int, sp: int, levels: int = LEVELS) -> list[list[tuple[int, int]]]:
    """bounds[l][r] = (lo, hi): rank r's rows of the level-l map, l = 0 the
    canvas (nx rows) to `levels` the coarse map (nx / 2^levels rows)."""
    scale = 2**levels
    if nx % scale:
        raise ValueError(f"a spatial split needs nx divisible by {scale}, got nx={nx}")
    coarse = nx // scale
    if not 1 <= sp <= coarse:
        raise ValueError(f"{sp} spatial ranks for nx={nx}: at most nx/{scale} = {coarse} (one coarse row each)")
    base, extra = divmod(coarse, sp)
    sizes = [base + (r < extra) for r in range(sp)]
    edges = [sum(sizes[:r]) for r in range(sp + 1)]
    coarse_bounds = [(edges[r], edges[r + 1]) for r in range(sp)]
    return [[(lo << (levels - lv), hi << (levels - lv)) for lo, hi in coarse_bounds] for lv in range(levels + 1)]


@dataclasses.dataclass(frozen=True)
class SpatialPlan:
    """A spatial group (`parallel.mesh.DataMesh`) and the slabs of one
    canvas of `nx` rows over it: what `PointPillars.forward(spatial=...)`
    needs."""

    mesh: object
    nx: int
    bounds: tuple

    @classmethod
    def of(cls, mesh, nx: int) -> "SpatialPlan":
        if not mesh.member:
            raise ValueError("this process is outside the spatial group")
        return cls(mesh, nx, tuple(tuple(level) for level in slab_bounds(nx, mesh.world)))

    def rows(self, level: int) -> tuple[int, int]:
        """This rank's (lo, hi) rows of the level-`level` map."""
        return self.bounds[level][self.mesh.rank]

    def global_rows(self, level: int) -> int:
        return self.nx >> level


# --- halo exchange ------------------------------------------------------------


def all_gather_bytes(t: torch.Tensor, mesh) -> torch.Tensor:
    """Every rank's `t` (one shape on every rank) stacked on a new leading
    axis in rank order, through one all-gather of its bytes: a copy, exact
    in any dtype, and one that gloo runs for bf16 too."""
    raw = t.contiguous().view(torch.uint8)
    return mesh.all_gather(raw[None]).view(t.dtype)


class _HaloExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        every = all_gather_bytes(torch.stack([x[:, :, 0], x[:, :, -1]]), mesh)  # (world, 2, B, C, W)
        b, c, h, w = x.shape
        fmt = torch.channels_last if x.is_contiguous(memory_format=torch.channels_last) else torch.contiguous_format
        out = torch.empty((b, c, h + 2, w), dtype=x.dtype, device=x.device, memory_format=fmt)
        out[:, :, 1:h + 1] = x
        r = mesh.rank
        out[:, :, 0] = every[r - 1, 1] if r > 0 else 0       # the lower neighbour's last row
        out[:, :, h + 1] = every[r + 1, 0] if r + 1 < mesh.world else 0  # the upper neighbour's first row
        return out

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        h = g.shape[2] - 2
        # halo cotangents: row 0 belongs to the lower neighbour's last row,
        # row h + 1 to the upper neighbour's first row
        every = all_gather_bytes(torch.stack([g[:, :, 0], g[:, :, h + 1]]), mesh)
        dx = g[:, :, 1:h + 1].clone()
        r = mesh.rank
        if r > 0:
            dx[:, :, 0] += every[r - 1, 1]       # what the lower neighbour's bottom halo (my first row) received
        if r + 1 < mesh.world:
            dx[:, :, h - 1] += every[r + 1, 0]   # what the upper neighbour's top halo (my last row) received
        return dx, None


def halo_exchange(x: torch.Tensor, mesh) -> torch.Tensor:
    """An NCHW slab (B, C, h, W) → (B, C, h + 2, W) with the neighbouring
    ranks' edge rows above and below it, zeros past the canvas; the
    backward adds each halo row's cotangent to its owner's edge row."""
    return _HaloExchange.apply(x, mesh)


def halo_conv(x: torch.Tensor, conv, mesh) -> torch.Tensor:
    """A 3x3 convolution with padding 1 (stride 1 or 2) on a slab: the halo
    rows stand for the row padding; the columns keep padding 1. `conv`'s
    float32 weight is cast to the slab's dtype, as `Conv2d.forward` does."""
    return torch.nn.functional.conv2d(halo_exchange(x, mesh), conv.weight.to(x.dtype), None, conv.stride, (0, 1))


# --- InstanceNorm over the slabs -------------------------------------------------


def _bc(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return t[:, :, None, None].to(like.dtype)


class _SpatialInstanceNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, n_global):
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        c = x.shape[1]
        sums = mesh.all_reduce_(torch.cat([xf.sum(dim=(2, 3)), (xf * xf).sum(dim=(2, 3))], dim=1))
        mean = sums[:, :c] / n_global
        var = torch.clamp(sums[:, c:] / n_global - mean * mean, min=0.0)
        inv = torch.rsqrt(var + 1e-3)
        ctx.save_for_backward(x, mean, inv)
        ctx.mesh, ctx.n = mesh, n_global
        return (x - _bc(mean, x)) * _bc(inv, x)

    @staticmethod
    def backward(ctx, g):
        x, mean, inv = ctx.saved_tensors
        c = x.shape[1]
        inv_c = _bc(inv, x)
        xhat = (x - _bc(mean, x)) * inv_c
        acc = torch.promote_types(g.dtype, torch.float32)
        sums = ctx.mesh.all_reduce_(torch.cat([g.to(acc).sum(dim=(2, 3)), (g * xhat).to(acc).sum(dim=(2, 3))], dim=1))
        m_g, m_gx = sums[:, :c] / ctx.n, sums[:, c:] / ctx.n
        dx = inv_c * (g - _bc(m_g, g) - xhat * _bc(m_gx, g))
        return dx.to(x.dtype), None, None


def spatial_instance_norm(x: torch.Tensor, mesh, n_global: int) -> torch.Tensor:
    """InstanceNorm (no affine, eps 1e-3) of the map whose slabs the ranks
    hold, on this rank's slab x (B, C, h, W): float32 [Σx, Σx²] (float64
    for a float64 slab) summed over the group and divided by `n_global` (the
    whole map's H·W), the normalisation in x's dtype; the backward sums
    [Σg, Σg·x̂] the same way."""
    return _SpatialInstanceNorm.apply(x, mesh, n_global)


# --- the head's outputs --------------------------------------------------------


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, mesh, bounds):
        ctx.lo, ctx.hi = bounds[mesh.rank]
        most = max(hi - lo for lo, hi in bounds)
        pad = most - y.shape[3]
        if pad:
            y = torch.cat([y, y.new_zeros((*y.shape[:3], pad, y.shape[4]))], dim=3)
        every = all_gather_bytes(y, mesh)
        return torch.cat([every[r, :, :, :, :hi - lo] for r, (lo, hi) in enumerate(bounds)], dim=3)

    @staticmethod
    def backward(ctx, g):
        return g[:, :, :, ctx.lo:ctx.hi].contiguous(), None, None


def gather_rows(preds: dict[str, torch.Tensor], mesh, bounds) -> dict[str, torch.Tensor]:
    """The head's slab outputs (N, k, nch, rows, fy) → the whole feature
    map's, every pred in one all-gather along dim 3; `bounds` are the
    ranks' (lo, hi) rows of the feature map. The backward is this rank's
    own slice of the cotangent."""
    keys = list(preds)
    ks = [preds[k].shape[1] for k in keys]
    whole = _GatherRows.apply(torch.cat([preds[k] for k in keys], dim=1), mesh, tuple(bounds))
    return dict(zip(keys, whole.split(ks, dim=1)))

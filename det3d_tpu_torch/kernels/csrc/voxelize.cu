// Pillar voxelization of a batch of padded point clouds: points (B, N, C)
// float32 and counts (B,) int32 on the card → voxels (B, V, P, C), coors
// (B, V, 3), points per voxel (B, V) and pillars (B,), bit-identical to the
// plain version (`ops/voxelize.voxelize`, frame by frame) in both slot orders.
//
// Replaces no Pallas kernel: the JAX package leaves voxelization to XLA. On
// this card the plain version was ~30 library launches a frame: two stable
// sorts over every padded row with int64 indices, a flipped `cummin` (a serial
// scan along one row), flips, concatenations and two gathers; ~1.1 ms of a
// 20 cm frame's replay.
//
// What bounds it on the H100: bytes. The real points are read (≤ N·C·4 B) and
// the buffers written (V·P·C·4 B): an ntusl frame (130 000 x 16 B in, 16 000 x
// 15 x 4 x 4 B out) ≈ 6 MB, 2 µs at 3.35 TB/s; a CenterPoint-PP frame (360 000
// x 20 B in, 60 000 x 20 x 5 x 4 B out) ≈ 31 MB, 9 µs. The per-cell table
// (8 bytes a cell: 5 MB at 800 x 800, 2 MB at 512 x 512) stays in the 50 MB L2.
//
// Design: six launches on one stream, one call for the whole batch; rows at
// and after a frame's count exit at once, and nothing else reads them.
//   vox_reset   the cell table to {no row, 0 points}, the slot table to
//               "empty", the pillar counts to 0.
//   vox_bin     a thread per row: the cell id as the plain version floors it
//               (IEEE subtract and divide, -fmad=false), then atomicMin of the
//               row into its cell's first row and atomicAdd of its count.
//   vox_count   a block per tile of 1024 rows (first-occurrence order) or
//               cells (cell-id order): how many pillar heads (a row that is
//               its cell's first row; an occupied cell) and how many points
//               they hold.
//   vox_number  the same tiles: each sums the tiles before it (at most a few
//               hundred pairs), scans its own, and numbers its heads. A head's
//               number is its slot: arrival order of the heads, exactly the
//               plain version's sort of the head rows, or cell-id order. The
//               points before it give its segment's offset. Kept heads (slot
//               < V) write their slot into the cell table and {cell, offset,
//               count} into the slot table; the last tile writes min(pillars,
//               V).
//   vox_append  a thread per row of a kept pillar appends its row index to
//               its pillar's segment (an atomicAdd of the slot's fill; the
//               order within a segment is whatever the atomics give).
//   vox_fill    a warp per slot: the P smallest row indices of its segment in
//               ascending order into the warp's P words of dynamic shared
//               memory (a rank by 32 shuffles when the pillar holds at most 32
//               points, else P rounds of a warp-wide minimum above the last,
//               so any P serves), then the slot's P x C floats as 16-byte
//               stores (single floats before the first 16-byte boundary and
//               after the last), zeros past the count; its coors (-1 when
//               empty) and count.
// No result depends on the order in which atomics land: a minimum, a count,
// and a segment whose entries are sorted before use. No host synchronisation:
// the counts are read on the card; every scratch word is written by
// vox_reset or before it is read.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;                   // rows or cells a thread owns in the scan passes
constexpr int kTile = kThreads * kItems;    // rows or cells of a scan tile
constexpr int kWarps = kThreads / 32;       // slots of a fill block
constexpr int kMaxPointsPerVoxel = 48 * 1024 / (kWarps * 4);  // vox_fill's rows in the default 48 KB of shared memory
constexpr int kEmpty = INT_MAX;             // the first row of a cell no point fell in
constexpr unsigned kFull = 0xffffffffu;

struct Grid {
  float size[3];
  float offset[3];
  int n[3];  // nx, ny, nz
};

// The cell of a point, or -1 outside the grid: floor((p − offset) / size) per
// axis, each operation rounded as the plain version's tensors round it, and
// the float → int32 conversion of torch's `.to(torch.int32)` on the card.
__device__ __forceinline__ int cell_of(const float* p, const Grid& g) {
  int c[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    c[d] = (int)floorf(__fdiv_rn(__fsub_rn(p[d], g.offset[d]), g.size[d]));
    if (c[d] < 0 || c[d] >= g.n[d]) return -1;
  }
  return (c[0] * g.n[1] + c[1]) * g.n[2] + c[2];
}

__device__ __forceinline__ int limit_of(const int* num_points, int b, int n) {
  const int k = num_points[b];
  return k < n ? k : n;
}

// One item of a scan: a pillar head, its cell and its points.
struct Item {
  int head, cell, count;
};

// Item `idx` of frame b: row idx (kRows, first-occurrence order) or cell idx.
template <bool kRows>
__device__ __forceinline__ Item item(int idx, int lim, const float* pts, const int2* table, int c, const Grid& g) {
  Item it{0, -1, 0};
  if (idx >= lim) return it;
  if (kRows) {
    const int cell = cell_of(pts + (int64_t)idx * c, g);
    if (cell < 0) return it;
    const int2 t = table[cell];
    if (t.x == idx) it = Item{1, cell, t.y};
  } else {
    const int2 t = table[idx];
    if (t.y > 0) it = Item{1, idx, t.y};
  }
  return it;
}

// Exclusive prefix of (heads, points) over the block, and the block's total.
__device__ __forceinline__ int2 block_scan(int2 v, int2* total) {
  __shared__ int2 warp_sums[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int2 inc = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int hx = __shfl_up_sync(kFull, inc.x, o), hy = __shfl_up_sync(kFull, inc.y, o);
    if (lane >= o) {
      inc.x += hx;
      inc.y += hy;
    }
  }
  __syncthreads();  // warp_sums of an earlier call read
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  int2 before = make_int2(0, 0), all = make_int2(0, 0);
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int2 s = warp_sums[w];
    if (w < warp) {
      before.x += s.x;
      before.y += s.y;
    }
    all.x += s.x;
    all.y += s.y;
  }
  *total = all;
  return make_int2(before.x + inc.x - v.x, before.y + inc.y - v.y);
}

// --- the launches -------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
vox_reset(int2* __restrict__ table, int64_t table_len, int4* __restrict__ slots, int64_t slot_len,
          int* __restrict__ voxel_num, int B) {
  const int64_t i0 = (int64_t)blockIdx.x * kThreads + threadIdx.x, stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = i0; i < table_len; i += stride) table[i] = make_int2(kEmpty, 0);
  for (int64_t i = i0; i < slot_len; i += stride) slots[i] = make_int4(-1, 0, 0, 0);
  if (i0 < B) voxel_num[i0] = 0;
}

__global__ void __launch_bounds__(kThreads)
vox_bin(const float* __restrict__ points, const int* __restrict__ num_points, int2* __restrict__ table, int n,
        int c, Grid g, int cells) {
  const int b = blockIdx.y, r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= limit_of(num_points, b, n)) return;
  const int cell = cell_of(points + ((int64_t)b * n + r) * c, g);
  if (cell < 0) return;
  int2* t = table + (int64_t)b * cells + cell;
  atomicMin(&t->x, r);
  atomicAdd(&t->y, 1);
}

template <bool kRows>
__global__ void __launch_bounds__(kThreads)
vox_count(const float* __restrict__ points, const int* __restrict__ num_points, const int2* __restrict__ table,
          int2* __restrict__ tile_sums, int n, int c, Grid g, int cells, int tiles) {
  const int b = blockIdx.y, base = blockIdx.x * kTile;
  const int lim = kRows ? limit_of(num_points, b, n) : cells;
  if (base >= lim) return;
  const float* pts = points + (int64_t)b * n * c;
  const int2* tab = table + (int64_t)b * cells;
  int2 sum = make_int2(0, 0);
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const Item it = item<kRows>(base + k * kThreads + threadIdx.x, lim, pts, tab, c, g);
    sum.x += it.head;
    sum.y += it.count;
  }
  int2 total;
  block_scan(sum, &total);
  if (threadIdx.x == 0) tile_sums[(int64_t)b * tiles + blockIdx.x] = total;
}

template <bool kRows>
__global__ void __launch_bounds__(kThreads)
vox_number(const float* __restrict__ points, const int* __restrict__ num_points, int2* __restrict__ table,
           const int2* __restrict__ tile_sums, int4* __restrict__ slots, int* __restrict__ voxel_num, int n, int c,
           Grid g, int cells, int tiles, int max_voxels) {
  const int b = blockIdx.y, t = blockIdx.x, base = t * kTile;
  const int lim = kRows ? limit_of(num_points, b, n) : cells;
  if (base >= lim) return;
  const float* pts = points + (int64_t)b * n * c;
  int2* tab = table + (int64_t)b * cells;
  // the heads and points of the tiles before this one
  int2 pre = make_int2(0, 0);
  for (int j = threadIdx.x; j < t; j += kThreads) {
    const int2 s = tile_sums[(int64_t)b * tiles + j];
    pre.x += s.x;
    pre.y += s.y;
  }
  int2 earlier;
  block_scan(pre, &earlier);
  // this thread's kItems consecutive items, in order
  Item its[kItems];
  int2 own = make_int2(0, 0);
  const int first = base + threadIdx.x * kItems;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    its[k] = item<kRows>(first + k, lim, pts, tab, c, g);
    own.x += its[k].head;
    own.y += its[k].count;
  }
  int2 total;
  int2 at = block_scan(own, &total);
  at.x += earlier.x;
  at.y += earlier.y;
  int4* frame_slots = slots + (int64_t)b * max_voxels;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (!its[k].head) continue;
    if (at.x < max_voxels) {
      frame_slots[at.x] = make_int4(its[k].cell, at.y, its[k].count, 0);
      tab[its[k].cell].x = -(at.x + 1);  // the cell's slot, for vox_append
    }
    at.x += 1;
    at.y += its[k].count;
  }
  if (threadIdx.x == 0 && t == (lim - 1) / kTile) {
    const int pillars = earlier.x + total.x;
    voxel_num[b] = pillars < max_voxels ? pillars : max_voxels;
  }
}

__global__ void __launch_bounds__(kThreads)
vox_append(const float* __restrict__ points, const int* __restrict__ num_points, const int2* __restrict__ table,
           int4* __restrict__ slots, int* __restrict__ seg, int n, int c, Grid g, int cells, int max_voxels) {
  const int b = blockIdx.y, r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= limit_of(num_points, b, n)) return;
  const int cell = cell_of(points + ((int64_t)b * n + r) * c, g);
  if (cell < 0) return;
  const int x = table[(int64_t)b * cells + cell].x;
  if (x >= 0) return;  // a pillar past the cap
  int4* slot = slots + (int64_t)b * max_voxels + (-x - 1);
  const int place = atomicAdd(&slot->w, 1);
  seg[(int64_t)b * n + slot->y + place] = r;
}

// The float at `f` of a slot's P x C: point k = f / C's channel, or 0 past
// the slot's count.
__device__ __forceinline__ float slot_float(const float* pts, const int* rows, int count, int c, int f) {
  const int k = f / c;
  return k < count ? pts[(int64_t)rows[k] * c + (f - k * c)] : 0.f;
}

__global__ void __launch_bounds__(kThreads)
vox_fill(const float* __restrict__ points, const int4* __restrict__ slots, const int* __restrict__ seg,
         float* __restrict__ voxels, int* __restrict__ coors, int* __restrict__ npv, int n, int c, Grid g,
         int max_voxels, int mp) {
  extern __shared__ int rows[];  // kWarps x mp: each warp's slot's rows in ascending order
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.y, s = blockIdx.x * kWarps + warp;
  if (s >= max_voxels) return;  // the whole warp
  const int64_t slot = (int64_t)b * max_voxels + s;
  const int4 info = slots[slot];
  const int held = info.x >= 0 ? info.z : 0;
  const int count = held < mp ? held : mp;
  const int* sg = seg + (int64_t)b * n + info.y;
  int* mine = rows + warp * mp;
  if (held <= 32) {
    const int v = lane < held ? sg[lane] : INT_MAX;
    int rank = 0;
#pragma unroll
    for (int l = 0; l < 32; ++l) rank += __shfl_sync(kFull, v, l) < v;
    if (lane < held && rank < mp) mine[rank] = v;
  } else {
    int last = -1;
    for (int k = 0; k < count; ++k) {
      int m = INT_MAX;
      for (int i = lane; i < held; i += 32) {
        const int e = sg[i];
        if (e > last && e < m) m = e;
      }
      m = __reduce_min_sync(kFull, m);
      if (lane == 0) mine[k] = m;
      last = m;
    }
  }
  __syncwarp();
  if (lane < 3) {
    int v = -1;
    if (count > 0) {
      const int yz = g.n[1] * g.n[2], rem = info.x % yz;
      v = lane == 0 ? info.x / yz : lane == 1 ? rem / g.n[2] : rem % g.n[2];
    }
    coors[slot * 3 + lane] = v;
  }
  if (lane == 0) npv[slot] = count;
  // the slot's floats: a head up to the first 16-byte boundary, float4s, a tail
  const float* pts = points + (int64_t)b * n * c;
  float* out = voxels + slot * mp * c;
  const int total = mp * c;
  const int lead = (int)((16 - reinterpret_cast<uintptr_t>(out) % 16) % 16 / 4);
  const int head = lead < total ? lead : total;
  const int quads = (total - head) / 4, body = head + 4 * quads;
  if (lane < head) out[lane] = slot_float(pts, mine, count, c, lane);
  float4* out4 = reinterpret_cast<float4*>(out + head);
  for (int i = lane; i < quads; i += 32) {
    const int f = head + 4 * i;
    int k = f / c, ch = f - k * c;  // one division a float4: the next floats step through the channels
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      v[e] = k < count ? pts[(int64_t)mine[k] * c + ch] : 0.f;
      if (++ch == c) {
        ch = 0;
        ++k;
      }
    }
    out4[i] = make_float4(v[0], v[1], v[2], v[3]);
  }
  if (lane < total - body) out[body + lane] = slot_float(pts, mine, count, c, body + lane);
}

cudaError_t checked() { return cudaGetLastError(); }

}  // namespace

// points (B, n, C) float32; num_points (B,) int32; voxels (B, V, P, C) float32;
// coors (B, V, 3), npv (B, V), voxel_num (B,) int32; the scratch, int32 words
// at 16-byte aligned addresses: slots (B, V, 4), table (B, cells, 2),
// tile_sums (B, tiles, 2), seg (B, n). tiles = ceil(n / 1024) with fcfs, else
// ceil(cells / 1024). Returns a CUDA error code (0 on success).
extern "C" int det3d_voxelize(const float* points, const int* num_points, float* voxels, int* coors, int* npv,
                              int* voxel_num, void* slots, void* table, void* tile_sums, int* seg, int B, int n, int c,
                              float sx, float sy, float sz, float ox, float oy, float oz, int nx, int ny, int nz,
                              int max_voxels, int mp, int fcfs, void* stream_ptr) {
  const int64_t cells = (int64_t)nx * ny * nz;
  if (B < 1 || B > 65535 || n < 1 || c < 3 || nx < 1 || ny < 1 || nz < 1 || cells > INT_MAX || max_voxels < 1 ||
      max_voxels > n || mp < 1 || mp > kMaxPointsPerVoxel)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const Grid g{{sx, sy, sz}, {ox, oy, oz}, {nx, ny, nz}};
  const int ncells = (int)cells;
  const int tiles = (int)(((fcfs ? (int64_t)n : cells) + kTile - 1) / kTile);
  int2* tab = static_cast<int2*>(table);
  int4* slt = static_cast<int4*>(slots);
  int2* sums = static_cast<int2*>(tile_sums);
  const int64_t table_len = (int64_t)B * cells, slot_len = (int64_t)B * max_voxels;
  const int64_t reset_want = ((table_len > slot_len ? table_len : slot_len) + kThreads - 1) / kThreads;
  const int reset_blocks = (int)(reset_want < 2048 ? reset_want : 2048);
  const dim3 rows_grid((n + kThreads - 1) / kThreads, B), tiles_grid(tiles, B);
  cudaError_t err;
  vox_reset<<<reset_blocks, kThreads, 0, stream>>>(tab, table_len, slt, slot_len, voxel_num, B);
  if ((err = checked()) != cudaSuccess) return (int)err;
  vox_bin<<<rows_grid, kThreads, 0, stream>>>(points, num_points, tab, n, c, g, ncells);
  if ((err = checked()) != cudaSuccess) return (int)err;
  if (fcfs) {
    vox_count<true><<<tiles_grid, kThreads, 0, stream>>>(points, num_points, tab, sums, n, c, g, ncells, tiles);
    if ((err = checked()) != cudaSuccess) return (int)err;
    vox_number<true><<<tiles_grid, kThreads, 0, stream>>>(points, num_points, tab, sums, slt, voxel_num, n, c, g,
                                                          ncells, tiles, max_voxels);
  } else {
    vox_count<false><<<tiles_grid, kThreads, 0, stream>>>(points, num_points, tab, sums, n, c, g, ncells, tiles);
    if ((err = checked()) != cudaSuccess) return (int)err;
    vox_number<false><<<tiles_grid, kThreads, 0, stream>>>(points, num_points, tab, sums, slt, voxel_num, n, c, g,
                                                           ncells, tiles, max_voxels);
  }
  if ((err = checked()) != cudaSuccess) return (int)err;
  vox_append<<<rows_grid, kThreads, 0, stream>>>(points, num_points, tab, slt, seg, n, c, g, ncells, max_voxels);
  if ((err = checked()) != cudaSuccess) return (int)err;
  const dim3 fill_grid((max_voxels + kWarps - 1) / kWarps, B);
  vox_fill<<<fill_grid, kThreads, kWarps * mp * sizeof(int), stream>>>(points, slt, seg, voxels, coors, npv, n, c, g,
                                                                       max_voxels, mp);
  return (int)checked();
}

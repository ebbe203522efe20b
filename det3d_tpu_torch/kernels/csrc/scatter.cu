// BEV canvas scatters: pillar features -> zero-initialised canvas, in three
// canvas layouts, and their backwards, the per-pillar row gathers of the
// canvas cotangent.
//
// Replaces, in det3d_tpu/kernels/scatter_pallas.py:
//   * `_canvas_kernel` (through `scatter_to_bev_pallas`), the dense canvas
//     (B, nx, ny, C), and the gather of its VJP `_scatter_bwd` (:290);
//   * `_canvas_s2d_kernel` (through `scatter_to_bev_s2d_pallas`), the
//     4-phase space-to-depth (s2d) canvas (B, nx/2, ny/2, 4C): pillar (x, y)
//     lands at cell (x/2, y/2), channel block phase = (x%2)*2 + y%2, in
//     H-major memory or, for `w_major`, in W-major memory ([y/2][x/2]); and
//     the gather of its VJP `_scatter_s2d_bwd` (:178);
//   * `_canvas_s2d_blocked_kernel` (through `scatter_to_bev_s2d_blocked`),
//     the s2d canvas cut into nblk row blocks with duplicated halo rows,
//     (B, nblk, rb + ht + hb, ny/2, 4C), zeros past the canvas edge; and the
//     gather of its VJP `_scatter_s2d_blocked_bwd` (:421), which sums a
//     pillar's cotangent over every block it was written to.
//
// What bounds them on the H100: memory. At 20 cm the canvas is 800 x 800 x
// 64 values in every layout (164 MB in f32, 82 MB in bf16; the blocked
// canvas 1.14x that, 8 blocks of 50 + 7 rows) and is written once, against
// 4.1 MB of features and 0.2 MB of coordinates read: nearly all of it the
// zero fill. The backwards read only the kept rows (up to three per pillar
// for the blocked canvas) and write dfeats (B, V, C) once.
//
// Design: the TPU kernels turned each canvas tile into one-hot MXU matmuls
// because Mosaic has no unaligned per-row dynamic store. Hopper stores any
// row directly, so the sort, the searchsorted and the tiles are gone:
//   1. cudaMemsetAsync zero-fills the canvas (the copy engine streams it at
//      close to the memory rate; it is part of each entry point);
//   2. one launch copies every pillar row to its place. Threads of a block
//      cover consecutive 16-byte pieces of consecutive rows, so the feature
//      reads coalesce and each row lands as whole 16-byte stores. Rows
//      outside the grid (x < 0 marks an empty pillar slot) are skipped;
//      canvas cells are unique, so no two threads write one address. The
//      dense and both s2d orders share the kernel's code, only the
//      destination row differs (`canvas_row`); the layout is a template
//      argument, so each is its own kernel with its own name in a profile. The blocked kernel writes a row to its
//      own block and, near a block edge, to the neighbour's halo (at most
//      one neighbour a side, since both halos are at most rb rows).
// The forward copies move bytes, not values: f32 and bf16 share them, and
// the result is bit-equal to the plain PyTorch scatter.
//
// Backwards: dfeats[b, v, :] is the cotangent at the pillar's place, zero
// for the rows the forward dropped. One thread per 16-byte piece of a
// dfeats row, so the writes coalesce and each gathered row is read as whole
// 16-byte pieces. The cotangent is read through its strides, so the
// channels-last map a convolution hands back is gathered in place, with no
// copy. The blocked backward adds the up to three places in the plain
// version's order, (own + above) + below, always adding (0 where a
// neighbour holds no copy) and rounding to the type after each add, so it
// is bit-equal to the plain gather in bf16 too (no multiply, nothing to
// contract). At the train shapes its whole grid fits in one wave and its
// bytes take ~2.4 us at the memory rate, so its time is latency: the
// launch, the coordinate load, then the copies' loads, then the store. So
// it is launched as a programmatic dependent of the kernel before it, its
// blocks cover whole rows with no 64-bit division, and each thread loads
// all copies of its piece at once (`gather_rows_blocked` below).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

enum Layout : int { kDense = 0, kS2dH = 1, kS2dW = 2 };

// Row of pillar (b, x, y) in a canvas of `layout`, counted in C-wide feature
// rows (for the s2d layouts each cell holds 4 of them, one per phase); -1
// for a pillar outside the grid.
__device__ __forceinline__ int64_t canvas_row(int layout, int64_t b, int x, int y, int nx, int ny) {
  if (x < 0 || x >= nx || y < 0 || y >= ny) return -1;
  if (layout == kDense) return (b * nx + x) * (int64_t)ny + y;
  int nx2 = nx >> 1, ny2 = ny >> 1;
  int64_t cell = layout == kS2dH ? (b * nx2 + (x >> 1)) * (int64_t)ny2 + (y >> 1)
                                 : (b * ny2 + (y >> 1)) * (int64_t)nx2 + (x >> 1);
  return cell * 4 + (x & 1) * 2 + (y & 1);
}

template <typename Vec, int kLayout>
__global__ void __launch_bounds__(kThreads)
scatter_rows(const Vec* __restrict__ feats,      // (B*V, vecs_per_row)
             const int32_t* __restrict__ coors,  // (B*V, 3)
             Vec* __restrict__ canvas,           // rows of vecs_per_row, in `kLayout`
             int64_t total_vecs, int vecs_per_row, int V, int nx, int ny) {
  int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (t >= total_vecs) return;
  int64_t row = t / vecs_per_row;  // pillar index over B*V
  int piece = (int)(t - row * vecs_per_row);
  int64_t dst = canvas_row(kLayout, row / V, coors[row * 3 + 0], coors[row * 3 + 1], nx, ny);
  if (dst < 0) return;
  canvas[dst * vecs_per_row + piece] = feats[t];
}

// Blocked s2d canvas (B, nblk, rtot, ny2, 4, vecs_per_row), rtot = rb+ht+hb:
// pillar row r = x/2 lives in block j0 = r / rb at local row off + ht
// (off = r - j0*rb), in block j0-1's bottom halo when off < hb, and in block
// j0+1's top halo when off >= rb - ht.
template <typename Vec>
__global__ void __launch_bounds__(kThreads)
scatter_rows_blocked(const Vec* __restrict__ feats, const int32_t* __restrict__ coors,
                     Vec* __restrict__ canvas, int64_t total_vecs, int vecs_per_row, int V,
                     int nx, int ny, int nblk, int rb, int ht, int hb) {
  int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (t >= total_vecs) return;
  int64_t row = t / vecs_per_row;
  int piece = (int)(t - row * vecs_per_row);
  int x = coors[row * 3 + 0];
  int y = coors[row * 3 + 1];
  if (x < 0 || x >= nx || y < 0 || y >= ny) return;
  int64_t b = row / V;
  int r = x >> 1, ny2 = ny >> 1, rtot = rb + ht + hb;
  int j0 = r / rb, off = r - j0 * rb;
  int64_t tail = (int64_t)(y >> 1) * 4 + (x & 1) * 2 + (y & 1);  // (y2, phase) within a block row
  Vec v = feats[t];
  auto put = [&](int j, int local_row) {
    int64_t dst = ((b * nblk + j) * rtot + local_row) * (int64_t)ny2 * 4 + tail;
    canvas[dst * vecs_per_row + piece] = v;
  };
  put(j0, off + ht);
  if (off < hb && j0 > 0) put(j0 - 1, off + rb + ht);
  if (off >= rb - ht && j0 < nblk - 1) put(j0 + 1, off - rb + ht);
}

template <typename Vec, int kLayout>
__global__ void __launch_bounds__(kThreads)
gather_rows(const char* __restrict__ grad,       // (B, nx', ny', C') with channel stride 1
            const int32_t* __restrict__ coors,   // (B*V, 3)
            Vec* __restrict__ dfeats,            // (B*V, vecs_per_row)
            int64_t total_vecs, int vecs_per_row, int V, int nx, int ny,
            int64_t sb, int64_t sx, int64_t sy, int64_t row_bytes) {  // strides in bytes
  int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (t >= total_vecs) return;
  int64_t row = t / vecs_per_row;
  int piece = (int)(t - row * vecs_per_row);
  int x = coors[row * 3 + 0];
  int y = coors[row * 3 + 1];
  Vec out{};
  if (x >= 0 && x < nx && y >= 0 && y < ny) {
    // the dense canvas (B, nx, ny, C), or the logical s2d canvas
    // (B, nx/2, ny/2, 4C) in either memory order: its strides say which
    const char* src = kLayout == kDense
        ? grad + (row / V) * sb + x * sx + y * sy
        : grad + (row / V) * sb + (x >> 1) * sx + (y >> 1) * sy + ((x & 1) * 2 + (y & 1)) * row_bytes;
    out = reinterpret_cast<const Vec*>(src)[piece];
  }
  dfeats[t] = out;
}

// Element arithmetic of the blocked backward: f32 adds as is; bf16 (raw
// 16-bit patterns) widens exactly, adds in f32 and rounds to nearest even,
// as PyTorch's bf16 add does.
__device__ __forceinline__ float add_round(float a, float b) { return a + b; }
__device__ __forceinline__ uint16_t add_round(uint16_t a, uint16_t b) {
  float s = __uint_as_float((uint32_t)a << 16) + __uint_as_float((uint32_t)b << 16);
  return __bfloat16_as_ushort(__float2bfloat16_rn(s));
}

template <typename T, int N>
struct alignas(sizeof(T) * N) Piece {
  T v[N];
};

// Read-only loads of a piece, by its width: the cotangent is read once,
// through the non-coherent cache.
template <typename P>
__device__ __forceinline__ P load_piece(const P* p) {
  P out;
  if constexpr (sizeof(P) == 16) {
    *reinterpret_cast<uint4*>(&out) = __ldg(reinterpret_cast<const uint4*>(p));
  } else if constexpr (sizeof(P) == 4) {
    *reinterpret_cast<unsigned*>(&out) = __ldg(reinterpret_cast<const unsigned*>(p));
  } else {
    *reinterpret_cast<unsigned short*>(&out) = __ldg(reinterpret_cast<const unsigned short*>(p));
  }
  return out;
}

// The blocked backward is launched as a programmatic dependent of the
// kernel before it (Hopper: its blocks may be dispatched once every block of
// the kernel ahead of it in the stream has exited, and wait with
// `griddepcontrol.wait`, before their first load, until that kernel has
// finished and its writes are visible; the launch latency, 40 % of the old
// kernel's time, overlaps the other kernel's tail). Nothing is read or
// written before the wait, so whatever wrote the cotangent or the
// coordinates, however recently, is seen. BLOCKED_BWD_PDL=0 launches it in
// stream order, for experiments/kernel_redesigns.py to time the two.
#ifndef BLOCKED_BWD_PDL
#define BLOCKED_BWD_PDL 1
#endif
constexpr int kBlockedBwdThreads = 256;

// The blocked backward. Block (px, py): px threads cover a row's pieces
// (looping where a row has more than 32), py rows side by side, so a warp
// reads and writes whole neighbouring rows; the batch is the grid's y. No
// division but the one by rb (32-bit): every index is a row or a piece of
// one sample, the sample's base the only 64-bit product. A thread loads its
// row's coordinates, makes all copies' addresses, then loads every copy
// together (predicated: a copy the row lacks is a 0 that costs no load), so
// its three loads are in flight behind one coordinate load's latency.
template <typename T, int N>
__global__ void __launch_bounds__(kBlockedBwdThreads)
gather_rows_blocked(const char* __restrict__ grad,      // (B, nblk, rtot, ny2, 4C), channel stride 1
                    const int32_t* __restrict__ coors,  // (B*V, 3)
                    Piece<T, N>* __restrict__ dfeats,   // (B*V, pieces)
                    int V, int pieces, int nx, int ny, int nblk, int rb, int ht, int hb, int64_t sb,
                    int64_t sj, int64_t sr, int64_t sy, int64_t row_bytes) {
  using P = Piece<T, N>;
#if BLOCKED_BWD_PDL
  asm volatile("griddepcontrol.wait;" ::: "memory");
#endif
  const int b = blockIdx.y;
  const int row = blockIdx.x * blockDim.y + threadIdx.y;
  if (row >= V) return;
  const int32_t* c = coors + ((int64_t)b * V + row) * 3;
  const int x = __ldg(c), y = __ldg(c + 1);
  const bool in = x >= 0 && x < nx && y >= 0 && y < ny;
  const int r = in ? x >> 1 : 0;
  const int j0 = r / rb, off = r - j0 * rb;
  const char* base = grad + b * sb + (in ? (y >> 1) * sy + ((x & 1) * 2 + (y & 1)) * row_bytes : 0);
  const bool has_above = in && off < hb && j0 > 0, has_below = in && off >= rb - ht && j0 < nblk - 1;
  const P* own_src = reinterpret_cast<const P*>(base + j0 * sj + (off + ht) * sr);
  const P* above_src = reinterpret_cast<const P*>(base + (j0 - 1) * sj + (off + rb + ht) * sr);
  const P* below_src = reinterpret_cast<const P*>(base + (j0 + 1) * sj + (off - rb + ht) * sr);
  P* out = dfeats + ((int64_t)b * V + row) * pieces;
  for (int piece = threadIdx.x; piece < pieces; piece += blockDim.x) {
    P own{}, above{}, below{};
    if (in) own = load_piece(own_src + piece);
    if (has_above) above = load_piece(above_src + piece);
    if (has_below) below = load_piece(below_src + piece);
    P sum;
#pragma unroll
    for (int i = 0; i < N; ++i) sum.v[i] = add_round(add_round(own.v[i], above.v[i]), below.v[i]);
    out[piece] = sum;
  }
}

inline unsigned blocks_for(int64_t total) { return (unsigned)((total + kThreads - 1) / kThreads); }

template <typename Vec, int kLayout>
cudaError_t launch(const void* feats, const int32_t* coors, void* canvas, int B, int V, int row_bytes,
                   int nx, int ny, cudaStream_t stream) {
  int vecs_per_row = row_bytes / (int)sizeof(Vec);
  int64_t total = (int64_t)B * V * vecs_per_row;
  if (total == 0) return cudaSuccess;
  scatter_rows<Vec, kLayout><<<blocks_for(total), kThreads, 0, stream>>>(
      static_cast<const Vec*>(feats), coors, static_cast<Vec*>(canvas), total, vecs_per_row, V, nx, ny);
  return cudaGetLastError();
}

template <typename Vec>
cudaError_t launch_blocked(const void* feats, const int32_t* coors, void* canvas, int B, int V,
                           int row_bytes, int nx, int ny, int nblk, int ht, int hb, cudaStream_t stream) {
  int vecs_per_row = row_bytes / (int)sizeof(Vec);
  int64_t total = (int64_t)B * V * vecs_per_row;
  if (total == 0) return cudaSuccess;
  scatter_rows_blocked<Vec><<<blocks_for(total), kThreads, 0, stream>>>(
      static_cast<const Vec*>(feats), coors, static_cast<Vec*>(canvas), total, vecs_per_row, V, nx, ny,
      nblk, (nx >> 1) / nblk, ht, hb);
  return cudaGetLastError();
}

template <typename Vec, int kLayout>
cudaError_t launch_bwd(const void* grad, const int32_t* coors, void* dfeats, int B, int V, int row_bytes,
                       int nx, int ny, int64_t sb, int64_t sx, int64_t sy, cudaStream_t stream) {
  int vecs_per_row = row_bytes / (int)sizeof(Vec);
  int64_t total = (int64_t)B * V * vecs_per_row;
  if (total == 0) return cudaSuccess;
  gather_rows<Vec, kLayout><<<blocks_for(total), kThreads, 0, stream>>>(
      static_cast<const char*>(grad), coors, static_cast<Vec*>(dfeats), total, vecs_per_row, V, nx, ny,
      sb, sx, sy, row_bytes);
  return cudaGetLastError();
}

template <typename T, int N>
cudaError_t launch_blocked_bwd(const void* grad, const int32_t* coors, void* dfeats, int B, int V,
                               int row_bytes, int nx, int ny, int nblk, int ht, int hb, int64_t sb,
                               int64_t sj, int64_t sr, int64_t sy, cudaStream_t stream) {
  int pieces = row_bytes / (int)sizeof(Piece<T, N>);
  if ((int64_t)B * V * pieces == 0) return cudaSuccess;
  int px = pieces < 32 ? pieces : 32;
  dim3 block(px, kBlockedBwdThreads / px);
  dim3 grid((unsigned)((V + block.y - 1) / block.y), (unsigned)B);
  cudaLaunchConfig_t config = {};
  config.gridDim = grid;
  config.blockDim = block;
  config.stream = stream;
  cudaLaunchAttribute attribute[1];
  attribute[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attribute[0].val.programmaticStreamSerializationAllowed = BLOCKED_BWD_PDL;
  config.attrs = attribute;
  config.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&config, gather_rows_blocked<T, N>,
                                       static_cast<const char*>(grad), coors, static_cast<Piece<T, N>*>(dfeats), V,
                                       pieces, nx, ny, nblk, (nx >> 1) / nblk, ht, hb, sb, sj, sr, sy,
                                       (int64_t)row_bytes);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The widest piece that divides a row and keeps every pointer, stride and
// row start aligned (the caching allocator hands out 256-byte aligned blocks).
inline int piece_bytes(int row_bytes, uintptr_t addresses) {
  if (row_bytes % 16 == 0 && addresses % 16 == 0) return 16;
  if (row_bytes % 4 == 0 && addresses % 4 == 0) return 4;
  return 2;
}

template <int kLayout>
int scatter_impl(const void* feats, const void* coors, void* canvas, size_t canvas_bytes, int B, int V,
                 int C, int elem_bytes, int nx, int ny, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err = cudaMemsetAsync(canvas, 0, canvas_bytes, stream);
  if (err != cudaSuccess) return (int)err;
  const int32_t* c = static_cast<const int32_t*>(coors);
  int row_bytes = C * elem_bytes;
  switch (piece_bytes(row_bytes, reinterpret_cast<uintptr_t>(feats) | reinterpret_cast<uintptr_t>(canvas))) {
    case 16: return (int)launch<uint4, kLayout>(feats, c, canvas, B, V, row_bytes, nx, ny, stream);
    case 4: return (int)launch<uint32_t, kLayout>(feats, c, canvas, B, V, row_bytes, nx, ny, stream);
    default: return (int)launch<uint16_t, kLayout>(feats, c, canvas, B, V, row_bytes, nx, ny, stream);
  }
}

template <int kLayout>
int gather_impl(const void* grad, const void* coors, void* dfeats, int B, int V, int C, int elem_bytes,
                int nx, int ny, int64_t sb, int64_t sx, int64_t sy, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int32_t* c = static_cast<const int32_t*>(coors);
  int row_bytes = C * elem_bytes;
  sb *= elem_bytes;
  sx *= elem_bytes;
  sy *= elem_bytes;
  uintptr_t addresses = reinterpret_cast<uintptr_t>(grad) | reinterpret_cast<uintptr_t>(dfeats) |
                        (uintptr_t)sb | (uintptr_t)sx | (uintptr_t)sy;
  switch (piece_bytes(row_bytes, addresses)) {
    case 16: return (int)launch_bwd<uint4, kLayout>(grad, c, dfeats, B, V, row_bytes, nx, ny, sb, sx, sy, stream);
    case 4: return (int)launch_bwd<uint32_t, kLayout>(grad, c, dfeats, B, V, row_bytes, nx, ny, sb, sx, sy, stream);
    default: return (int)launch_bwd<uint16_t, kLayout>(grad, c, dfeats, B, V, row_bytes, nx, ny, sb, sx, sy, stream);
  }
}

// The piece width in bytes the blocked backward takes: 16 where the row and
// every pointer and stride (in bytes) are 16-byte multiples, else one
// element.
int blocked_bwd_piece_bytes(const void* grad, const void* dfeats, int row_bytes, int elem_bytes, int64_t sb,
                            int64_t sj, int64_t sr, int64_t sy) {
  uintptr_t addresses = reinterpret_cast<uintptr_t>(grad) | reinterpret_cast<uintptr_t>(dfeats) |
                        (uintptr_t)sb | (uintptr_t)sj | (uintptr_t)sr | (uintptr_t)sy;
  return piece_bytes(row_bytes, addresses) == 16 ? 16 : elem_bytes;
}

}  // namespace

// In every entry point: feats (B, V, C) of `elem_bytes`-wide values and
// coors (B, V, 3) int32 are contiguous; the output is written in full; all
// pointers are device pointers and the launch goes on `stream`. Each
// returns the CUDA error of its fill or launch (0 on success).

// The dense canvas (B, nx, ny, C), contiguous.
extern "C" int det3d_scatter_to_bev(const void* feats, const void* coors, void* canvas, int B, int V, int C,
                                    int elem_bytes, int nx, int ny, void* stream_ptr) {
  size_t canvas_bytes = (size_t)B * nx * ny * C * elem_bytes;
  return scatter_impl<kDense>(feats, coors, canvas, canvas_bytes, B, V, C, elem_bytes, nx, ny, stream_ptr);
}

// The s2d canvas, contiguous: (B, nx/2, ny/2, 4C), or for `w_major`
// (B, ny/2, nx/2, 4C). nx and ny are even.
extern "C" int det3d_scatter_to_bev_s2d(const void* feats, const void* coors, void* canvas, int B, int V,
                                        int C, int elem_bytes, int nx, int ny, int w_major,
                                        void* stream_ptr) {
  size_t canvas_bytes = (size_t)B * nx * ny * C * elem_bytes;
  return w_major ? scatter_impl<kS2dW>(feats, coors, canvas, canvas_bytes, B, V, C, elem_bytes, nx, ny, stream_ptr)
                 : scatter_impl<kS2dH>(feats, coors, canvas, canvas_bytes, B, V, C, elem_bytes, nx, ny, stream_ptr);
}

// The blocked s2d canvas (B, nblk, rb + ht + hb, ny/2, 4C), contiguous,
// rb = (nx/2) / nblk rows per block; nx and ny even, nblk divides nx/2,
// ht <= rb and hb <= rb.
extern "C" int det3d_scatter_to_bev_s2d_blocked(const void* feats, const void* coors, void* canvas, int B,
                                                int V, int C, int elem_bytes, int nx, int ny, int nblk,
                                                int ht, int hb, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  int rb = (nx >> 1) / nblk;
  size_t canvas_bytes = (size_t)B * nblk * (rb + ht + hb) * (ny >> 1) * 4 * C * elem_bytes;
  cudaError_t err = cudaMemsetAsync(canvas, 0, canvas_bytes, stream);
  if (err != cudaSuccess) return (int)err;
  const int32_t* c = static_cast<const int32_t*>(coors);
  int row_bytes = C * elem_bytes;
  switch (piece_bytes(row_bytes, reinterpret_cast<uintptr_t>(feats) | reinterpret_cast<uintptr_t>(canvas))) {
    case 16: return (int)launch_blocked<uint4>(feats, c, canvas, B, V, row_bytes, nx, ny, nblk, ht, hb, stream);
    case 4: return (int)launch_blocked<uint32_t>(feats, c, canvas, B, V, row_bytes, nx, ny, nblk, ht, hb, stream);
    default: return (int)launch_blocked<uint16_t>(feats, c, canvas, B, V, row_bytes, nx, ny, nblk, ht, hb, stream);
  }
}

// Backward of the dense scatter: grad (B, nx, ny, C) with channel stride 1
// and strides sb, sx, sy (in elements) over b, x, y; dfeats (B, V, C)
// contiguous.
extern "C" int det3d_scatter_to_bev_bwd(const void* grad, const void* coors, void* dfeats, int B, int V,
                                        int C, int elem_bytes, int nx, int ny, int64_t sb, int64_t sx,
                                        int64_t sy, void* stream_ptr) {
  return gather_impl<kDense>(grad, coors, dfeats, B, V, C, elem_bytes, nx, ny, sb, sx, sy, stream_ptr);
}

// Backward of the s2d scatter: grad is the logical (B, nx/2, ny/2, 4C)
// canvas with channel stride 1 and strides sb, sx, sy (in elements) over
// b, x/2, y/2, in either memory order.
extern "C" int det3d_scatter_to_bev_s2d_bwd(const void* grad, const void* coors, void* dfeats, int B, int V,
                                            int C, int elem_bytes, int nx, int ny, int64_t sb, int64_t sx,
                                            int64_t sy, void* stream_ptr) {
  return gather_impl<kS2dH>(grad, coors, dfeats, B, V, C, elem_bytes, nx, ny, sb, sx, sy, stream_ptr);
}

// Backward of the blocked scatter: grad (B, nblk, rb + ht + hb, ny/2, 4C)
// with channel stride 1 and strides sb, sj, sr, sy (in elements) over b,
// block, local row, y/2. `is_bf16` picks the element arithmetic (else f32).
extern "C" int det3d_scatter_to_bev_s2d_blocked_bwd(const void* grad, const void* coors, void* dfeats, int B,
                                                    int V, int C, int is_bf16, int nx, int ny, int nblk,
                                                    int ht, int hb, int64_t sb, int64_t sj, int64_t sr,
                                                    int64_t sy, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int32_t* c = static_cast<const int32_t*>(coors);
  int elem_bytes = is_bf16 ? 2 : 4;
  int row_bytes = C * elem_bytes;
  sb *= elem_bytes;
  sj *= elem_bytes;
  sr *= elem_bytes;
  sy *= elem_bytes;
  bool wide = blocked_bwd_piece_bytes(grad, dfeats, row_bytes, elem_bytes, sb, sj, sr, sy) == 16;
  if (is_bf16)
    return wide ? (int)launch_blocked_bwd<uint16_t, 8>(grad, c, dfeats, B, V, row_bytes, nx, ny, nblk, ht, hb,
                                                       sb, sj, sr, sy, stream)
                : (int)launch_blocked_bwd<uint16_t, 1>(grad, c, dfeats, B, V, row_bytes, nx, ny, nblk, ht, hb,
                                                       sb, sj, sr, sy, stream);
  return wide ? (int)launch_blocked_bwd<float, 4>(grad, c, dfeats, B, V, row_bytes, nx, ny, nblk, ht, hb, sb,
                                                  sj, sr, sy, stream)
              : (int)launch_blocked_bwd<float, 1>(grad, c, dfeats, B, V, row_bytes, nx, ny, nblk, ht, hb, sb,
                                                  sj, sr, sy, stream);
}

// The piece width in bytes that `det3d_scatter_to_bev_s2d_blocked_bwd`
// takes for these arguments (strides in elements): 16, or the element size.
extern "C" int det3d_scatter_to_bev_s2d_blocked_bwd_piece_bytes(const void* grad, const void* dfeats, int C,
                                                                int is_bf16, int64_t sb, int64_t sj,
                                                                int64_t sr, int64_t sy) {
  int elem_bytes = is_bf16 ? 2 : 4;
  return blocked_bwd_piece_bytes(grad, dfeats, C * elem_bytes, elem_bytes, sb * elem_bytes, sj * elem_bytes,
                                 sr * elem_bytes, sy * elem_bytes);
}

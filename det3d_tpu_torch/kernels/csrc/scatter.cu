// BEV canvas scatter: pillar features -> zero-initialised dense canvas, and
// its backward, the per-pillar row gather of the canvas cotangent.
//
// Replaces: det3d_tpu/kernels/scatter_pallas.py `_canvas_kernel`
// (through `scatter_to_bev_pallas` / `_scatter_fwd_impl`) and the gather of
// its VJP `_scatter_bwd` (scatter_pallas.py:290-299).
//
// What bounds it on the H100: memory. At 20 cm the canvas is
// 800 x 800 x 64 values (164 MB in f32, 82 MB in bf16) and is written once,
// against 4.1 MB of features and 0.2 MB of coordinates read: about 50 us
// (f32) or 25 us (bf16) at 3.35 TB/s, nearly all of it the zero fill.
//
// Design: the TPU kernel turned each canvas tile into one-hot MXU matmuls
// because Mosaic has no unaligned per-row dynamic store. Hopper stores any
// row directly, so the sort, the searchsorted and the tiles are gone:
//   1. cudaMemsetAsync zero-fills the canvas (the copy engine streams it at
//      close to the memory rate; it is part of this entry point, not a
//      separate allocation-time fill);
//   2. one launch copies every pillar row to its cell. Threads of a block
//      cover consecutive 16-byte pieces of consecutive rows, so the feature
//      reads coalesce and each row lands as whole 16-byte stores. Rows whose
//      x coordinate is negative (empty pillar slots) are skipped; canvas
//      cells are unique, so no two threads write one address.
// The copy moves bytes, not values: f32 and bf16 share one kernel, and the
// result is bit-equal to the plain PyTorch scatter.
//
// Backward: dfeats[b, v, :] = g[b, x, y, :] for the rows the forward kept,
// zero for the others. Bound by bytes: the gathered rows are read once and
// dfeats (B, V, C) is written once (4.1 MB in bf16 at 20 cm); the rest of
// the 82 MB cotangent canvas is never touched. Same layout of work as the
// forward: one thread per 16-byte piece of a dfeats row, so the writes
// coalesce and each gathered row is read as whole 16-byte pieces. The
// cotangent is read through its (b, x, y) strides, so a channels-last
// gradient map from the convolution is gathered in place, with no copy.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename Vec>
__global__ void __launch_bounds__(kThreads)
scatter_rows(const Vec* __restrict__ feats,    // (B*V, vecs_per_row)
             const int32_t* __restrict__ coors,  // (B*V, 3)
             Vec* __restrict__ canvas,          // (B, nx, ny, vecs_per_row)
             int64_t total_vecs, int vecs_per_row, int V, int nx, int ny) {
  int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (t >= total_vecs) return;
  int64_t row = t / vecs_per_row;          // pillar index over B*V
  int piece = (int)(t - row * vecs_per_row);
  int x = coors[row * 3 + 0];
  int y = coors[row * 3 + 1];
  if (x < 0 || x >= nx || y < 0 || y >= ny) return;
  int64_t b = row / V;
  int64_t cell = (b * nx + x) * (int64_t)ny + y;
  canvas[cell * vecs_per_row + piece] = feats[t];
}

template <typename Vec>
cudaError_t launch(const void* feats, const int32_t* coors, void* canvas, int B, int V,
                   int row_bytes, int nx, int ny, cudaStream_t stream) {
  int vecs_per_row = row_bytes / (int)sizeof(Vec);
  int64_t total = (int64_t)B * V * vecs_per_row;
  if (total == 0) return cudaSuccess;
  int64_t blocks = (total + kThreads - 1) / kThreads;
  scatter_rows<Vec><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const Vec*>(feats), coors, static_cast<Vec*>(canvas), total,
      vecs_per_row, V, nx, ny);
  return cudaGetLastError();
}

template <typename Vec>
__global__ void __launch_bounds__(kThreads)
gather_rows(const char* __restrict__ grad,        // (B, nx, ny, C), channel stride 1
            const int32_t* __restrict__ coors,   // (B*V, 3)
            Vec* __restrict__ dfeats,            // (B*V, vecs_per_row)
            int64_t total_vecs, int vecs_per_row, int V, int nx, int ny,
            int64_t sb, int64_t sx, int64_t sy) {  // strides of grad in bytes
  int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (t >= total_vecs) return;
  int64_t row = t / vecs_per_row;
  int piece = (int)(t - row * vecs_per_row);
  int x = coors[row * 3 + 0];
  int y = coors[row * 3 + 1];
  Vec out{};
  if (x >= 0 && x < nx && y >= 0 && y < ny) {
    const char* src = grad + (row / V) * sb + x * sx + y * sy;
    out = reinterpret_cast<const Vec*>(src)[piece];
  }
  dfeats[t] = out;
}

template <typename Vec>
cudaError_t launch_bwd(const void* grad, const int32_t* coors, void* dfeats, int B, int V,
                       int row_bytes, int nx, int ny, int64_t sb, int64_t sx, int64_t sy,
                       cudaStream_t stream) {
  int vecs_per_row = row_bytes / (int)sizeof(Vec);
  int64_t total = (int64_t)B * V * vecs_per_row;
  if (total == 0) return cudaSuccess;
  int64_t blocks = (total + kThreads - 1) / kThreads;
  gather_rows<Vec><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const char*>(grad), coors, static_cast<Vec*>(dfeats), total, vecs_per_row, V,
      nx, ny, sb, sx, sy);
  return cudaGetLastError();
}

}  // namespace

// feats (B, V, C) of `elem_bytes`-wide values, coors (B, V, 3) int32,
// canvas (B, nx, ny, C) written in full. All pointers are device pointers
// of contiguous tensors; the launch goes on `stream`. Returns the CUDA
// error of the fill or the launch (0 on success).
extern "C" int det3d_scatter_to_bev(const void* feats, const void* coors, void* canvas,
                                    int B, int V, int C, int elem_bytes, int nx, int ny,
                                    void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  size_t canvas_bytes = (size_t)B * nx * ny * C * elem_bytes;
  cudaError_t err = cudaMemsetAsync(canvas, 0, canvas_bytes, stream);
  if (err != cudaSuccess) return (int)err;
  const int32_t* c = static_cast<const int32_t*>(coors);
  int row_bytes = C * elem_bytes;
  // the widest piece that divides a row and keeps both base pointers
  // aligned (the caching allocator hands out 256-byte aligned blocks)
  uintptr_t base = reinterpret_cast<uintptr_t>(feats) | reinterpret_cast<uintptr_t>(canvas);
  if (row_bytes % 16 == 0 && base % 16 == 0)
    return (int)launch<uint4>(feats, c, canvas, B, V, row_bytes, nx, ny, stream);
  if (row_bytes % 4 == 0 && base % 4 == 0)
    return (int)launch<uint32_t>(feats, c, canvas, B, V, row_bytes, nx, ny, stream);
  return (int)launch<uint16_t>(feats, c, canvas, B, V, row_bytes, nx, ny, stream);
}

// grad (B, nx, ny, C) of `elem_bytes`-wide values with channel stride 1 and
// strides sb, sx, sy (in elements) over b, x, y; coors (B, V, 3) int32;
// dfeats (B, V, C) contiguous, written in full. Device pointers, launched on
// `stream`. Returns the CUDA error of the launch (0 on success).
extern "C" int det3d_scatter_to_bev_bwd(const void* grad, const void* coors, void* dfeats,
                                        int B, int V, int C, int elem_bytes, int nx, int ny,
                                        int64_t sb, int64_t sx, int64_t sy, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int32_t* c = static_cast<const int32_t*>(coors);
  int row_bytes = C * elem_bytes;
  sb *= elem_bytes;
  sx *= elem_bytes;
  sy *= elem_bytes;
  // the widest piece that divides a row and keeps every row start aligned
  uintptr_t base = reinterpret_cast<uintptr_t>(grad) | reinterpret_cast<uintptr_t>(dfeats) |
                   (uintptr_t)sb | (uintptr_t)sx | (uintptr_t)sy;
  if (row_bytes % 16 == 0 && base % 16 == 0)
    return (int)launch_bwd<uint4>(grad, c, dfeats, B, V, row_bytes, nx, ny, sb, sx, sy, stream);
  if (row_bytes % 4 == 0 && base % 4 == 0)
    return (int)launch_bwd<uint32_t>(grad, c, dfeats, B, V, row_bytes, nx, ny, sb, sx, sy, stream);
  return (int)launch_bwd<uint16_t>(grad, c, dfeats, B, V, row_bytes, nx, ny, sb, sx, sy, stream);
}

// The blocked backward as csrc/scatter.cu launched it from its port until
// its redesign: one thread per 16-byte piece of a dfeats row over the whole
// (B*V, pieces) array, the row, batch and piece found by 64-bit divisions,
// the coordinates loaded by every thread of a row, then its up to three
// copies behind two data-dependent branches. Kept to be timed beside the
// kernel that replaced it (experiments/kernel_redesigns.py, chip_smoke.py
// phase 9); same C interface as `det3d_scatter_to_bev_s2d_blocked_bwd`.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float add_round(float a, float b) { return a + b; }
__device__ __forceinline__ uint16_t add_round(uint16_t a, uint16_t b) {
  float s = __uint_as_float((uint32_t)a << 16) + __uint_as_float((uint32_t)b << 16);
  return __bfloat16_as_ushort(__float2bfloat16_rn(s));
}

template <typename T, int N>
struct alignas(sizeof(T) * N) Piece {
  T v[N];
};

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
gather_rows_blocked_per_piece(const char* __restrict__ grad, const int32_t* __restrict__ coors,
                              Piece<T, N>* __restrict__ dfeats, int64_t total_vecs, int vecs_per_row, int V,
                              int nx, int ny, int nblk, int rb, int ht, int hb, int64_t sb, int64_t sj,
                              int64_t sr, int64_t sy, int64_t row_bytes) {
  int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (t >= total_vecs) return;
  int64_t row = t / vecs_per_row;
  int piece = (int)(t - row * vecs_per_row);
  int x = coors[row * 3 + 0];
  int y = coors[row * 3 + 1];
  Piece<T, N> out{};
  if (x >= 0 && x < nx && y >= 0 && y < ny) {
    int r = x >> 1;
    int j0 = r / rb, off = r - j0 * rb;
    const char* base = grad + (row / V) * sb + (y >> 1) * sy + ((x & 1) * 2 + (y & 1)) * row_bytes;
    auto at = [&](int j, int local_row) {
      return reinterpret_cast<const Piece<T, N>*>(base + j * sj + local_row * sr)[piece];
    };
    out = at(j0, off + ht);
    Piece<T, N> above{}, below{};  // zeros where the neighbour holds no copy
    if (off < hb && j0 > 0) above = at(j0 - 1, off + rb + ht);
    if (off >= rb - ht && j0 < nblk - 1) below = at(j0 + 1, off - rb + ht);
#pragma unroll
    for (int i = 0; i < N; ++i) out.v[i] = add_round(add_round(out.v[i], above.v[i]), below.v[i]);
  }
  dfeats[t] = out;
}

template <typename T, int N>
cudaError_t launch(const void* grad, const int32_t* coors, void* dfeats, int B, int V, int row_bytes, int nx,
                   int ny, int nblk, int ht, int hb, int64_t sb, int64_t sj, int64_t sr, int64_t sy,
                   cudaStream_t stream) {
  int vecs_per_row = row_bytes / (int)sizeof(Piece<T, N>);
  int64_t total = (int64_t)B * V * vecs_per_row;
  if (total == 0) return cudaSuccess;
  gather_rows_blocked_per_piece<T, N><<<(unsigned)((total + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
      static_cast<const char*>(grad), coors, static_cast<Piece<T, N>*>(dfeats), total, vecs_per_row, V, nx, ny,
      nblk, (nx >> 1) / nblk, ht, hb, sb, sj, sr, sy, row_bytes);
  return cudaGetLastError();
}

}  // namespace

extern "C" int det3d_blocked_bwd_per_piece(const void* grad, const void* coors, void* dfeats, int B, int V, int C,
                                           int is_bf16, int nx, int ny, int nblk, int ht, int hb, int64_t sb,
                                           int64_t sj, int64_t sr, int64_t sy, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int32_t* c = static_cast<const int32_t*>(coors);
  int elem_bytes = is_bf16 ? 2 : 4;
  int row_bytes = C * elem_bytes;
  sb *= elem_bytes;
  sj *= elem_bytes;
  sr *= elem_bytes;
  sy *= elem_bytes;
  uintptr_t addresses = reinterpret_cast<uintptr_t>(grad) | reinterpret_cast<uintptr_t>(dfeats) |
                        (uintptr_t)sb | (uintptr_t)sj | (uintptr_t)sr | (uintptr_t)sy;
  bool wide = row_bytes % 16 == 0 && addresses % 16 == 0;
  if (is_bf16)
    return wide ? (int)launch<uint16_t, 8>(grad, c, dfeats, B, V, row_bytes, nx, ny, nblk, ht, hb, sb, sj, sr, sy,
                                           stream)
                : (int)launch<uint16_t, 1>(grad, c, dfeats, B, V, row_bytes, nx, ny, nblk, ht, hb, sb, sj, sr, sy,
                                           stream);
  return wide ? (int)launch<float, 4>(grad, c, dfeats, B, V, row_bytes, nx, ny, nblk, ht, hb, sb, sj, sr, sy, stream)
              : (int)launch<float, 1>(grad, c, dfeats, B, V, row_bytes, nx, ny, nblk, ht, hb, sb, sj, sr, sy, stream);
}

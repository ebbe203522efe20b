// Exact greedy NMS over a batch of classes, one thread block per class.
//
// Replaces: det3d_tpu/kernels/nms_pallas.py `_nms_kernel`
// (through `nms_keep_pallas` / `greedy_nms_pallas`).
//
// What bounds it on the H100: latency, not bytes or operations. The inputs
// are 16 KB of boxes per class and the pairwise IoU is ~15 MFLOP for
// K = 1000, so the roofline bound is well under a microsecond; the greedy
// sweep is sequential in K.
//
// Design (the classic bitmask NMS, both phases in one launch):
//   phase 1: the block's threads fill the suppression matrix
//            S[i][j] = (IoU(i, j) > thr) & (i < j) & valid[i] & valid[j]
//            as 32-bit words, K rows x ceil(K/32) words, in dynamic shared
//            memory (132 KB at K = 1000; rows padded by one word so neither
//            phase meets bank conflicts). Consecutive threads take
//            consecutive rows of one word column, so box j is a broadcast.
//   phase 2: one warp sweeps the rows in score order. Lane l holds word l
//            of the `removed` mask in a register; row i is alive when its
//            bit is clear (one shuffle), and a kept row ORs its mask row in.
//            This is the exact sequential greedy, not the TPU's frontier
//            iteration (that was a Mosaic workaround for dynamic indexing).
// The IoU is evaluated with the same operations in the same order as the
// plain PyTorch version (ops/nms.py iou_pixel_convention), each rounded on
// its own: the library is compiled with -fmad=false and IEEE division, and
// the intrinsics below make the rounding explicit, so the keep masks agree
// exactly. K is at most 1024 (one word of `removed` per lane).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxK = 1024;
constexpr int kWords = kMaxK / 32;
constexpr int kThreads = 512;

__device__ __forceinline__ bool suppresses(float4 a, float4 b, float thr) {
  // boxes are [x1, y1, x2, y2]; the +1 pixel convention of the reference
  float iw = fmaxf(__fadd_rn(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 1.0f), 0.0f);
  float ih = fmaxf(__fadd_rn(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 1.0f), 0.0f);
  float inter = __fmul_rn(iw, ih);
  float area_a = __fmul_rn(__fadd_rn(__fsub_rn(a.z, a.x), 1.0f), __fadd_rn(__fsub_rn(a.w, a.y), 1.0f));
  float area_b = __fmul_rn(__fadd_rn(__fsub_rn(b.z, b.x), 1.0f), __fadd_rn(__fsub_rn(b.w, b.y), 1.0f));
  float iou = __fdiv_rn(inter, __fsub_rn(__fadd_rn(area_a, area_b), inter));
  return iou > thr;
}

__global__ void __launch_bounds__(kThreads)
nms_kernel(const float* __restrict__ boxes,     // (ncls, K, 4)
           const uint8_t* __restrict__ valid,   // (ncls, K)
           uint8_t* __restrict__ keep,          // (ncls, K)
           int K, float thr) {
  extern __shared__ uint32_t mask[];            // K rows of `stride` words
  __shared__ float4 sbox[kMaxK];
  __shared__ uint8_t svalid[kMaxK];
  __shared__ uint32_t keep_words[kWords];

  const int cls = blockIdx.x;
  const int words = (K + 31) / 32;
  const int stride = words + 1;
  const float* b = boxes + (size_t)cls * K * 4;
  for (int i = threadIdx.x; i < K; i += kThreads) {
    sbox[i] = make_float4(b[4 * i], b[4 * i + 1], b[4 * i + 2], b[4 * i + 3]);
    svalid[i] = valid[(size_t)cls * K + i];
  }
  __syncthreads();

  // phase 1: suppression words; item t covers row i = t % K, word w = t / K
  for (int t = threadIdx.x; t < K * words; t += kThreads) {
    const int w = t / K;
    const int i = t - w * K;
    const int j0 = w * 32;
    uint32_t bits = 0;
    if (svalid[i] && j0 + 31 > i) {
      const float4 a = sbox[i];
      const int jend = min(j0 + 32, K);
      for (int j = max(j0, i + 1); j < jend; ++j) {
        if (svalid[j] && suppresses(a, sbox[j], thr)) bits |= 1u << (j - j0);
      }
    }
    mask[i * stride + w] = bits;
  }
  __syncthreads();

  // phase 2: the sequential greedy sweep, one warp
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    uint32_t removed = 0;
    uint32_t kept = 0;
    for (int i = 0; i < K; ++i) {
      const uint32_t word = __shfl_sync(0xffffffffu, removed, i >> 5);
      const bool alive = svalid[i] && !((word >> (i & 31)) & 1u);  // warp-uniform
      if (alive) {
        if (lane < words) removed |= mask[i * stride + lane];
        if (lane == (i >> 5)) kept |= 1u << (i & 31);
      }
    }
    keep_words[lane] = kept;
  }
  __syncthreads();

  for (int j = threadIdx.x; j < K; j += kThreads) {
    keep[(size_t)cls * K + j] = (uint8_t)((keep_words[j >> 5] >> (j & 31)) & 1u);
  }
}

}  // namespace

// boxes (ncls, K, 4) f32 minmax in descending score order, valid (ncls, K)
// bool, keep (ncls, K) bool written in full; contiguous device tensors,
// launched on `stream`. The caller applies the post_max_size rank cap.
// Returns the CUDA error of the launch (0 on success).
extern "C" int det3d_nms_keep(const void* boxes, const void* valid, void* keep, int ncls,
                              int K, float iou_threshold, void* stream_ptr) {
  if (K < 1 || K > kMaxK) return (int)cudaErrorInvalidValue;
  if (ncls == 0) return 0;
  const int words = (K + 31) / 32;
  const size_t smem = (size_t)K * (words + 1) * sizeof(uint32_t);
  cudaError_t err =
      cudaFuncSetAttribute(nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  nms_kernel<<<ncls, kThreads, smem, static_cast<cudaStream_t>(stream_ptr)>>>(
      static_cast<const float*>(boxes), static_cast<const uint8_t*>(valid),
      static_cast<uint8_t*>(keep), K, iou_threshold);
  return (int)cudaGetLastError();
}

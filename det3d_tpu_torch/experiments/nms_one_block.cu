// The one-block-per-class greedy NMS kernel that `kernels/csrc/nms.cu`
// replaced, kept for measurement only: `experiments/kernel_redesigns.py`
// times it beside the mask + sweep design in one run and reads how its time
// splits between its two phases. Nothing of the package launches it.
//
// One block of 512 threads per class, both phases in one launch:
//   phase 1: the block's threads fill the suppression matrix
//            S[i][j] = (IoU(i, j) > thr) & (i < j) & valid[i] & valid[j]
//            as 32-bit words, K rows x ceil(K/32) words, in dynamic shared
//            memory (132 KB at K = 1000; rows padded by one word).
//   phase 2: one warp sweeps the rows in score order. Lane l holds word l
//            of the `removed` mask in a register; row i is alive when its
//            bit is clear (one shuffle), and a kept row ORs its mask row in.
// `stamps` (ncls, 4) receives thread 0's clock64() at the start, after
// phase 1, after phase 2 and at the end; `phases` cuts a phase out (bit 0:
// run phase 1, bit 1: run phase 2), which leaves the keep mask wrong and is
// only for timing one phase alone.

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
           int K, float thr, long long* __restrict__ stamps, int phases) {
  extern __shared__ uint32_t mask[];            // K rows of `stride` words
  __shared__ float4 sbox[kMaxK];
  __shared__ uint8_t svalid[kMaxK];
  __shared__ uint32_t keep_words[kWords];

  const int cls = blockIdx.x;
  if (threadIdx.x == 0) stamps[4 * cls] = clock64();
  const int words = (K + 31) / 32;
  const int stride = words + 1;
  const float* b = boxes + (size_t)cls * K * 4;
  for (int i = threadIdx.x; i < K; i += kThreads) {
    sbox[i] = make_float4(b[4 * i], b[4 * i + 1], b[4 * i + 2], b[4 * i + 3]);
    svalid[i] = valid[(size_t)cls * K + i];
  }
  __syncthreads();

  // phase 1: suppression words; item t covers row i = t % K, word w = t / K
  for (int t = threadIdx.x; (phases & 1) && t < K * words; t += kThreads) {
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
  if (threadIdx.x == 0) stamps[4 * cls + 1] = clock64();

  // phase 2: the sequential greedy sweep, one warp
  if ((phases & 2) && threadIdx.x < 32) {
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
  if (threadIdx.x == 0) stamps[4 * cls + 2] = clock64();

  for (int j = threadIdx.x; j < K; j += kThreads) {
    keep[(size_t)cls * K + j] = (uint8_t)((keep_words[j >> 5] >> (j & 31)) & 1u);
  }
  __syncthreads();
  if (threadIdx.x == 0) stamps[4 * cls + 3] = clock64();
}

}  // namespace

// boxes (ncls, K, 4) f32 minmax in descending score order, valid (ncls, K)
// bool, keep (ncls, K) bool written in full, stamps (ncls, 4) int64;
// contiguous device tensors, launched on `stream`. Returns the CUDA error of
// the launch (0 on success).
extern "C" int det3d_nms_one_block(const void* boxes, const void* valid, void* keep, int ncls, int K,
                                   float iou_threshold, void* stamps, int phases, void* stream_ptr) {
  if (K < 1 || K > kMaxK) return (int)cudaErrorInvalidValue;
  if (ncls == 0) return 0;
  const int words = (K + 31) / 32;
  const size_t smem = (size_t)K * (words + 1) * sizeof(uint32_t);
  cudaError_t err =
      cudaFuncSetAttribute(nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  nms_kernel<<<ncls, kThreads, smem, static_cast<cudaStream_t>(stream_ptr)>>>(
      static_cast<const float*>(boxes), static_cast<const uint8_t*>(valid),
      static_cast<uint8_t*>(keep), K, iou_threshold, static_cast<long long*>(stamps), phases);
  return (int)cudaGetLastError();
}

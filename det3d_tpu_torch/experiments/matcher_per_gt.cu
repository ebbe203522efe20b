// The anchor target matcher before the cull by anchor-chunk boxes: every
// anchor visits every gt of its class. Kept to be timed beside
// kernels/csrc/matcher.cu by experiments/kernel_redesigns.py; the package
// launches it nowhere else. Its own notes follow.
//
// Anchor target matcher: per-gt max IoU (pass 1), then per-anchor
// assignment (pass 2), for every class and every sample of a batch.
//
// Replaces: det3d_tpu/kernels/matcher_pallas.py `_gt_max_kernel` (pass 1)
// and `_assign_kernel` (pass 2), through `assign_class_pallas`.
//
// What bounds it on the H100: memory. Pass 2 reads 44 bytes of anchor
// geometry and one mask byte per anchor and writes 40 bytes of targets per
// anchor and sample; at 20 cm (1.44 M anchors, batch 2) that is about
// 180 MB, ~54 us at 3.35 TB/s. The IoU work is ~19 float32 operations per
// pair of an included anchor and a valid gt of its class: at ~30 gt per
// frame it stays below the byte time.
//
// Design. The TPU kernels tiled 3200 anchors, padded the anchor set and
// gathered the matched gt with a one-hot MXU product. Here one thread owns
// one anchor of one sample, and the sample's G <= 256 gt rows (standup box,
// 7-vector, class) sit in shared memory; blockIdx.y is the sample, and one
// launch of each pass covers every class: per-class anchor ranges and
// thresholds come in a small table.
//   pass 1: each warp reduces the IoU of its 32 anchors with gt g by
//           shuffles, one lane folds it into a shared per-gt maximum, and the
//           block folds those into the global maximum with one atomicMax per
//           gt. IoUs of contributing pairs are >= 0, so their float bits
//           order like ints; the global maximum starts as int -1 (all bytes
//           0xff) and stays below 0 when no pair contributes, which decodes
//           to the -1 of an excluded pair.
//   pass 2: each thread loops over the gt of its anchor's class for the max
//           and the FIRST argmax (strict >, ascending g: jnp.argmax's and
//           torch.argmax's tie rule), the force-match test ov == gmax[g] &
//           gmax[g] > 0, the labels, the encode of the matched gt, weights
//           and the direction target.
//   Each block loads its sample's gt tables once and builds one ascending
//   list of gt rows per class, then walks chunks of 256 anchors with a
//   stride of the grid; a chunk of one class (every chunk, when class
//   ranges are multiples of 256, as at 20 cm: 160 000 anchors a channel)
//   loops over its class's rows only.
// Exactness: force-matching compares pass 2's IoU with pass 1's, so both
// call the one `iou` below, written in iou_matrix's order of operations with
// every operation rounded on its own (__f*_rn intrinsics; the library is
// also built with -fmad=false -prec-div=true). Labels, weights and dir equal
// the plain version's; the targets' log goes through the device's logf.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxG = 256;
constexpr int kMaxClasses = 8;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kChunkBlocks = 132 * 4;  // blocks per sample

// IoU of a gt standup box b and an anchor standup box q, both
// [x1, y1, x2, y2]: ops/geometry.iou_matrix(gt_bv, anchors_bv, eps=0).
__device__ __forceinline__ float iou(float4 b, float4 q) {
  const float iw = __fsub_rn(fminf(b.z, q.z), fmaxf(b.x, q.x));
  const float ih = __fsub_rn(fminf(b.w, q.w), fmaxf(b.y, q.y));
  const float inter = (iw > 0.0f && ih > 0.0f) ? __fmul_rn(iw, ih) : 0.0f;
  const float area_b = __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
  const float area_q = __fmul_rn(__fsub_rn(q.z, q.x), __fsub_rn(q.w, q.y));
  const float uni = __fsub_rn(__fadd_rn(area_b, area_q), inter);
  return inter > 0.0f ? __fdiv_rn(inter, uni) : 0.0f;
}

__device__ __forceinline__ int class_of(int a, const int* cstart, int ncls) {
  int c = 0;
  while (c + 1 < ncls && a >= cstart[c + 1]) ++c;
  return c;
}

// per-sample gt tables in shared memory; `cls` is the 0-based class of a
// valid gt, -1 for padding (never equal to an anchor's class)
__device__ __forceinline__ void load_gt(int b, int G, const float* gt_bv, const int32_t* gt_cls,
                                        const uint8_t* gt_valid, float4* sbv, int* scls) {
  for (int g = threadIdx.x; g < G; g += kThreads) {
    const float* p = gt_bv + ((size_t)b * G + g) * 4;
    sbv[g] = make_float4(p[0], p[1], p[2], p[3]);
    scls[g] = gt_valid[(size_t)b * G + g] ? gt_cls[(size_t)b * G + g] - 1 : -1;
  }
}

// Each class's valid gt rows in ascending order (so the first-argmax rule
// holds), one list per class in shared memory; built after the gt tables
// are loaded and synchronised, and synchronised here.
__device__ __forceinline__ void class_gt_lists(int G, int ncls, const int* scls,
                                               int (*lists)[kMaxG], int* counts) {
  if (threadIdx.x < ncls) {
    int n = 0;
    for (int g = 0; g < G; ++g)
      if (scls[g] == (int)threadIdx.x) lists[threadIdx.x][n++] = g;
    counts[threadIdx.x] = n;
  }
  __syncthreads();
}

// The gt rows a chunk's anchors can match: its class's list where the
// whole chunk lies in one class (always, when class ranges are multiples of
// the chunk), else every row (each thread then skips other classes' rows).
// Block-uniform.
struct ChunkRows {
  const int* list;  // nullptr: rows 0 .. n-1
  int n;
  __device__ __forceinline__ int operator[](int k) const { return list ? list[k] : k; }
};

__device__ __forceinline__ ChunkRows chunk_rows(int a0, int A, int G, const int* sstart, int ncls,
                                                int (*lists)[kMaxG], const int* counts) {
  const int a1 = min(a0 + kThreads, A) - 1;
  const int c0 = class_of(a0, sstart, ncls);
  if (c0 == class_of(a1, sstart, ncls)) return ChunkRows{lists[c0], counts[c0]};
  return ChunkRows{nullptr, G};
}

__global__ void __launch_bounds__(kThreads)
gt_max_kernel(const float* __restrict__ anchors_bv,   // (A, 4)
              const uint8_t* __restrict__ mask,       // (B, A)
              const float* __restrict__ gt_bv,        // (B, G, 4)
              const int32_t* __restrict__ gt_cls,     // (B, G), 1-based
              const uint8_t* __restrict__ gt_valid,   // (B, G)
              const int32_t* __restrict__ cstart,     // (ncls + 1,)
              int ncls, int A, int G,
              int32_t* __restrict__ gmax_bits) {      // (B, G), starts at -1
  __shared__ float4 sbv[kMaxG];
  __shared__ int scls[kMaxG];
  __shared__ int sbest[kMaxG];
  __shared__ int sstart[kMaxClasses + 1];
  __shared__ int lists[kMaxClasses][kMaxG];
  __shared__ int counts[kMaxClasses];
  const int b = blockIdx.y;
  load_gt(b, G, gt_bv, gt_cls, gt_valid, sbv, scls);
  for (int g = threadIdx.x; g < G; g += kThreads) sbest[g] = -1;
  if (threadIdx.x <= ncls) sstart[threadIdx.x] = cstart[threadIdx.x];
  __syncthreads();
  class_gt_lists(G, ncls, scls, lists, counts);

  const int lane = threadIdx.x & 31;
  const int chunks = (A + kThreads - 1) / kThreads;
  for (int chunk = blockIdx.x; chunk < chunks; chunk += gridDim.x) {  // block-uniform
    const ChunkRows rows = chunk_rows(chunk * kThreads, A, G, sstart, ncls, lists, counts);
    const int a = chunk * kThreads + threadIdx.x;
    const bool in = a < A && mask[(size_t)b * A + a];
    const int cls = in ? class_of(a, sstart, ncls) : -2;
    float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
    if (in) q = reinterpret_cast<const float4*>(anchors_bv)[a];
    for (int k = 0; k < rows.n; ++k) {
      const int g = rows[k];
      const bool act = in && scls[g] == cls;
      if (!__any_sync(kFull, act)) continue;  // warp-uniform
      float v = act ? iou(sbv[g], q) : -1.0f;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
      if (lane == 0 && v >= 0.0f) atomicMax(&sbest[g], __float_as_int(v));
    }
  }
  __syncthreads();
  for (int g = threadIdx.x; g < G; g += kThreads) {
    if (sbest[g] >= 0) atomicMax(&gmax_bits[(size_t)b * G + g], sbest[g]);
  }
}

__device__ __forceinline__ void assign_anchor(
    int b, int a, int A, const float* __restrict__ anchors, const float* __restrict__ anchors_bv,
    const uint8_t* __restrict__ mask, const ChunkRows& rows, const float4* sbv, const int* scls,
    const float* sgmax, const float (*sbox)[7], const int* sstart, const float (*sthr)[2], int ncls,
    int32_t* __restrict__ labels, float* __restrict__ targets, float* __restrict__ weights,
    int32_t* __restrict__ dirs) {
  const size_t ba = (size_t)b * A + a;
  const float* an = anchors + (size_t)a * 7;
  const float ra = an[6];
  int label = -1;
  int arg = 0;
  if (mask[ba]) {
    const int cls = class_of(a, sstart, ncls);
    const float4 q = reinterpret_cast<const float4*>(anchors_bv)[a];
    float amax = -1.0f;
    bool force = false;
    for (int k = 0; k < rows.n; ++k) {
      const int g = rows[k];
      if (scls[g] != cls) continue;  // IoU -1: never the max, never forced
      const float ov = iou(sbv[g], q);
      if (ov > amax) { amax = ov; arg = g; }
      force |= (ov == sgmax[g]) && (sgmax[g] > 0.0f);
    }
    const bool pos = force || amax >= sthr[cls][0];
    const bool bg = amax < sthr[cls][1];
    label = pos ? 1 : (bg ? 0 : -1);
  }
  const bool fg = label > 0;
  float t[7] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (fg) {
    const float* gb = sbox[arg];
    const float la = an[3], wa = an[4], ha = an[5];
    const float diagonal = __fsqrt_rn(__fadd_rn(__fmul_rn(la, la), __fmul_rn(wa, wa)));
    t[0] = __fdiv_rn(__fsub_rn(gb[0], an[0]), diagonal);
    t[1] = __fdiv_rn(__fsub_rn(gb[1], an[1]), diagonal);
    t[2] = __fdiv_rn(__fsub_rn(gb[2], an[2]), ha);
    t[3] = logf(__fdiv_rn(gb[3], la));
    t[4] = logf(__fdiv_rn(gb[4], wa));
    t[5] = logf(__fdiv_rn(gb[5], ha));
    t[6] = __fsub_rn(gb[6], ra);
  }
  labels[ba] = label;
  weights[ba] = fg ? 1.0f : 0.0f;
  float* tb = targets + (size_t)b * 7 * A + a;
#pragma unroll
  for (int k = 0; k < 7; ++k) tb[(size_t)k * A] = t[k];
  // from the (zero-filled where not fg) yaw target, for every anchor
  dirs[ba] = __fadd_rn(t[6], ra) > 0.0f ? 1 : 0;
}

__global__ void __launch_bounds__(kThreads)
assign_kernel(const float* __restrict__ anchors,      // (A, 7)
              const float* __restrict__ anchors_bv,   // (A, 4)
              const uint8_t* __restrict__ mask,       // (B, A)
              const float* __restrict__ gt_boxes,     // (B, G, 7)
              const float* __restrict__ gt_bv,        // (B, G, 4)
              const int32_t* __restrict__ gt_cls,     // (B, G), 1-based
              const uint8_t* __restrict__ gt_valid,   // (B, G)
              const int32_t* __restrict__ gmax_bits,  // (B, G) from pass 1
              const int32_t* __restrict__ cstart,     // (ncls + 1,)
              const float* __restrict__ thresholds,   // (ncls, 2): matched, unmatched
              int ncls, int A, int G,
              int32_t* __restrict__ labels,           // (B, A)
              float* __restrict__ targets,            // (B, 7, A)
              float* __restrict__ weights,            // (B, A)
              int32_t* __restrict__ dirs) {           // (B, A)
  __shared__ float4 sbv[kMaxG];
  __shared__ int scls[kMaxG];
  __shared__ float sgmax[kMaxG];
  __shared__ float sbox[kMaxG][7];
  __shared__ int sstart[kMaxClasses + 1];
  __shared__ float sthr[kMaxClasses][2];
  __shared__ int lists[kMaxClasses][kMaxG];
  __shared__ int counts[kMaxClasses];
  const int b = blockIdx.y;
  load_gt(b, G, gt_bv, gt_cls, gt_valid, sbv, scls);
  for (int i = threadIdx.x; i < G * 7; i += kThreads) sbox[i / 7][i % 7] = gt_boxes[(size_t)b * G * 7 + i];
  for (int g = threadIdx.x; g < G; g += kThreads) {
    const int bits = gmax_bits[(size_t)b * G + g];
    sgmax[g] = bits < 0 ? -1.0f : __int_as_float(bits);
  }
  if (threadIdx.x <= ncls) sstart[threadIdx.x] = cstart[threadIdx.x];
  if (threadIdx.x < ncls) {
    sthr[threadIdx.x][0] = thresholds[2 * threadIdx.x];
    sthr[threadIdx.x][1] = thresholds[2 * threadIdx.x + 1];
  }
  __syncthreads();
  class_gt_lists(G, ncls, scls, lists, counts);

  const int chunks = (A + kThreads - 1) / kThreads;
  for (int chunk = blockIdx.x; chunk < chunks; chunk += gridDim.x) {
    const ChunkRows rows = chunk_rows(chunk * kThreads, A, G, sstart, ncls, lists, counts);
    const int a = chunk * kThreads + threadIdx.x;
    if (a < A)
      assign_anchor(b, a, A, anchors, anchors_bv, mask, rows, sbv, scls, sgmax, sbox, sstart, sthr,
                    ncls, labels, targets, weights, dirs);
  }
}

// blocks walk the anchor chunks of their sample with a stride of the grid:
// about one resident wave per sample, so each block loads its gt tables
// once for ~10 chunks at 20 cm
dim3 grid_for(int A, int B) {
  const int chunks = (A + kThreads - 1) / kThreads;
  return dim3(chunks < kChunkBlocks ? chunks : kChunkBlocks, B);
}

bool bad_sizes(int B, int A, int G, int ncls) {
  return B < 0 || A < 0 || G < 1 || G > kMaxG || ncls < 1 || ncls > kMaxClasses;
}

}  // namespace

// Pass 1. anchors_bv (A, 4) f32, mask (B, A) bool, gt_bv (B, G, 4) f32,
// gt_cls (B, G) int32 1-based, gt_valid (B, G) bool, cstart (ncls + 1)
// int32 anchor offsets of the classes; writes gmax_bits (B, G) int32: the
// float bits of each gt's best IoU over its class's included anchors, or
// -1 where no such anchor exists. Contiguous device tensors, launched on
// `stream`. Returns the CUDA error (0 on success).
extern "C" int det3d_matcher_per_gt_max(const void* anchors_bv, const void* mask, const void* gt_bv,
                                    const void* gt_cls, const void* gt_valid, const void* cstart,
                                    int ncls, int B, int A, int G, void* gmax_bits,
                                    void* stream_ptr) {
  if (bad_sizes(B, A, G, ncls)) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err = cudaMemsetAsync(gmax_bits, 0xff, (size_t)B * G * sizeof(int32_t), stream);
  if (err != cudaSuccess || B == 0 || A == 0) return (int)err;
  gt_max_kernel<<<grid_for(A, B), kThreads, 0, stream>>>(
      static_cast<const float*>(anchors_bv), static_cast<const uint8_t*>(mask),
      static_cast<const float*>(gt_bv), static_cast<const int32_t*>(gt_cls),
      static_cast<const uint8_t*>(gt_valid), static_cast<const int32_t*>(cstart), ncls, A, G,
      static_cast<int32_t*>(gmax_bits));
  return (int)cudaGetLastError();
}

// Pass 2. As pass 1, plus anchors (A, 7) f32, gt_boxes (B, G, 7) f32, pass
// 1's gmax_bits and thresholds (ncls, 2) f32 [matched, unmatched]; writes
// labels (B, A) int32, targets (B, 7, A) f32, weights (B, A) f32 and dirs
// (B, A) int32 in full. Returns the CUDA error (0 on success).
extern "C" int det3d_matcher_per_gt_assign(const void* anchors, const void* anchors_bv, const void* mask,
                                    const void* gt_boxes, const void* gt_bv, const void* gt_cls,
                                    const void* gt_valid, const void* gmax_bits,
                                    const void* cstart, const void* thresholds, int ncls, int B,
                                    int A, int G, void* labels, void* targets, void* weights,
                                    void* dirs, void* stream_ptr) {
  if (bad_sizes(B, A, G, ncls)) return (int)cudaErrorInvalidValue;
  if (B == 0 || A == 0) return 0;
  assign_kernel<<<grid_for(A, B), kThreads, 0, static_cast<cudaStream_t>(stream_ptr)>>>(
      static_cast<const float*>(anchors), static_cast<const float*>(anchors_bv),
      static_cast<const uint8_t*>(mask), static_cast<const float*>(gt_boxes),
      static_cast<const float*>(gt_bv), static_cast<const int32_t*>(gt_cls),
      static_cast<const uint8_t*>(gt_valid), static_cast<const int32_t*>(gmax_bits),
      static_cast<const int32_t*>(cstart), static_cast<const float*>(thresholds), ncls, A, G,
      static_cast<int32_t*>(labels), static_cast<float*>(targets), static_cast<float*>(weights),
      static_cast<int32_t*>(dirs));
  return (int)cudaGetLastError();
}

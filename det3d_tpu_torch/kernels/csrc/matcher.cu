// Anchor target matcher: per-gt max IoU (pass 1), then per-anchor
// assignment (pass 2), for every class and every sample of a batch.
//
// Replaces: det3d_tpu/kernels/matcher_pallas.py `_gt_max_kernel` (pass 1)
// and `_assign_kernel` (pass 2), through `assign_class_pallas`.
//
// What bounds it on the H100: memory, and almost only pass 2's output.
// Pass 2 writes 40 bytes per anchor and sample (labels, weights, dir and
// seven target planes) and reads one mask byte per anchor and sample and the
// anchors' yaw plane: at 20 cm (1.44 M anchors, batch 2) ~124 MB, ~37 us at
// 3.35 TB/s; the library's fill of the 115 MB of output alone takes 37 us.
// Pass 1 must read only the mask (2.9 MB, ~1 us): its time is its launch,
// its tables and a chain of load latencies. The arithmetic is no bound: a
// gt of a few metres overlaps some hundreds of the 1.44 M anchors, and the
// IoU of a disjoint pair is exactly 0.
//
// Design. The flat anchor order is (channel, x, y), so a run of
// consecutive anchors is a thin strip of the map. A warp owns a chunk of
// kChunk = 128 consecutive anchors of one sample at a time, 4 per lane, and
// a static table holds one standup bounding box per chunk (`chunk_bv`, made
// by targets.chunk_boxes for any anchor set). Per chunk the warp first
// builds its candidate list: the valid gt rows of the chunk's classes whose
// standup box is not disjoint from the chunk's box, in ascending row order
// (ballot + prefix count), in shared memory. The test keeps a row on any
// doubt (it is written as "not disjoint", so NaN keeps the row) and can only
// keep too many. Most chunks have no candidate (72 % on a real frame pair);
// a chunk that has one loads its anchors' standup boxes and runs `iou` on
// its candidates only. `iou` starts with the two interval tests and returns
// 0 for a disjoint pair before any area or division. Nothing in the loop
// synchronises the block: warps walk their chunks independently with a
// stride of the grid, and a chunk that straddles two classes takes the same
// route (its list holds both classes' rows, and an anchor skips the rows of
// the other class).
//   pass 1: a lane folds each candidate's IoUs over its 4 anchors and does
//           one shared atomicMax on the gt's slot where the result is
//           positive (int bits of a float >= 0 order like ints). What the
//           cull never visits is given back exactly: a disjoint pair of an
//           included anchor and a valid gt of its class contributes 0, so
//           the kernel also ORs one "class has an included anchor" bit per
//           class and folds bits 0 into the maximum of that class's valid gt;
//           a gt stays at -1 (the memset's 0xff) only where its class has no
//           included anchor. Blocks read the global slot before the global
//           atomicMax, so a slot takes a few atomics, not one per block. A
//           warp fetches its next chunk's mask and box before it works on
//           the current one.
//   pass 2: an included anchor starts from the result of a row of zeros
//           (max 0 and the class's first valid row as argmax where its class
//           has a valid gt, else -1 and row 0) and walks the candidates with
//           the strict > in ascending order (the first-argmax rule of
//           jnp.argmax and torch.argmax) and the force-match test
//           ov == gmax[g] & gmax[g] > 0. Anchors come from a planar table
//           (`anchors_t`, (7, A)): every anchor reads its yaw from one
//           coalesced plane and the other six only where it is positive.
//           Labels, weights, dir and the seven target planes leave as
//           16-byte streaming stores, 4 anchors a lane; an A that is not a
//           multiple of 4 (or a misaligned pointer) takes the scalar
//           instantiation of the same code. Pass 2 may be launched while
//           pass 1 still runs (programmatic dependent launch): a warp waits
//           for pass 1 only before its first chunk with a candidate, and
//           there its lanes read pass 1's maxima of the chunk's candidates
//           from global memory, one candidate a lane, beside the boxes.
//           What is left above the fill's time is the chunks with a
//           candidate: their boxes are read while the card's memory is busy
//           with the stores.
// Exactness: force-matching compares pass 2's IoU with pass 1's, so both
// call the one `iou` below, written in iou_matrix's order of operations with
// every operation rounded on its own (__f*_rn intrinsics; the library is
// also built with -fmad=false -prec-div=true, and without -ftz). Labels,
// weights and dir equal the plain version's; the targets' log goes through
// the device's logf.

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef MATCHER_BLOCKS_P1
#define MATCHER_BLOCKS_P1 (132 * 2)  // blocks per sample, pass 1
#endif
#ifndef MATCHER_BLOCKS_P2
#define MATCHER_BLOCKS_P2 (132 * 8)  // blocks per sample, pass 2
#endif
#ifndef MATCHER_STREAMING_STORES
#define MATCHER_STREAMING_STORES 1   // pass 2's outputs bypass the caches' keep-list
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPerLane = 4;              // consecutive anchors of a lane
constexpr int kChunk = 32 * kPerLane;    // consecutive anchors of a warp
constexpr int kMaxG = 256;
constexpr int kMaxClasses = 8;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNone = 0x7fffffff;

// IoU of a gt standup box b and an anchor standup box q, both
// [x1, y1, x2, y2]: ops/geometry.iou_matrix(gt_bv, anchors_bv, eps=0). A
// pair that fails an interval test has intersection 0 and IoU 0.
__device__ __forceinline__ float iou(float4 b, float4 q) {
  const float iw = __fsub_rn(fminf(b.z, q.z), fmaxf(b.x, q.x));
  const float ih = __fsub_rn(fminf(b.w, q.w), fmaxf(b.y, q.y));
  if (!(iw > 0.0f && ih > 0.0f)) return 0.0f;
  const float inter = __fmul_rn(iw, ih);
  const float area_b = __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
  const float area_q = __fmul_rn(__fsub_rn(q.z, q.x), __fsub_rn(q.w, q.y));
  const float uni = __fsub_rn(__fadd_rn(area_b, area_q), inter);
  return inter > 0.0f ? __fdiv_rn(inter, uni) : 0.0f;
}

// A sample's gt rows in shared memory.
struct GtTables {
  float4 bv[kMaxG];             // standup boxes
  int cls[kMaxG];               // 0-based class of a valid row, else -1
  int first[kMaxClasses];       // first valid row of each class, kNone: none
  int start[kMaxClasses + 1];   // flat anchor offsets of the classes
  int rows;                     // 1 + the last valid row
};

__device__ __forceinline__ int class_of(int a, const int* start, int ncls) {
  int c = 0;
  while (c + 1 < ncls && a >= start[c + 1]) ++c;
  return c;
}

// Loads the tables of sample b; a valid row whose class is outside
// 1 .. ncls matches no anchor, like padding. Synchronises the block.
__device__ __forceinline__ void load_gt(int b, int G, int ncls, const float* gt_bv,
                                        const int32_t* gt_cls, const uint8_t* gt_valid,
                                        const int32_t* cstart, GtTables& gt) {
  if (threadIdx.x < kMaxClasses) gt.first[threadIdx.x] = kNone;
  if (threadIdx.x <= ncls) gt.start[threadIdx.x] = cstart[threadIdx.x];
  if (threadIdx.x == 0) gt.rows = 0;
  __syncthreads();
  for (int g = threadIdx.x; g < G; g += kThreads) {
    const float* p = gt_bv + ((size_t)b * G + g) * 4;
    gt.bv[g] = make_float4(p[0], p[1], p[2], p[3]);
    int c = gt_valid[(size_t)b * G + g] ? gt_cls[(size_t)b * G + g] - 1 : -1;
    if (c >= ncls) c = -1;
    gt.cls[g] = c;
    if (c >= 0) {
      atomicMin(&gt.first[c], g);
      atomicMax(&gt.rows, g + 1);
    }
  }
  __syncthreads();
}

// What a lane loads from device memory for every chunk, whatever the chunk
// holds. Pass 1, whose time is a chain of load latencies, fetches a warp's
// next chunk before it works on the current one; pass 2 gained nothing by it.
struct Fetched {
  float4 box;           // standup bounding box of the chunk's anchors
  uint32_t mask;        // byte j: the sample's mask of anchor a0 + j, 0 past the end
  float yaw[kPerLane];  // pass 2 only: the anchors' yaw, 0 past the end
};

template <bool kVec, bool kYaw>
__device__ __forceinline__ Fetched fetch(int chunk, int chunks, int A, const float* __restrict__ chunk_bv,
                                         const uint8_t* __restrict__ mask,
                                         const float* __restrict__ yaw) {
  Fetched f;
  f.box = make_float4(0.f, 0.f, 0.f, 0.f);
  f.mask = 0u;
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) f.yaw[j] = 0.0f;
  if (chunk >= chunks) return f;  // warp-uniform
  const int a0 = chunk * kChunk + (threadIdx.x & 31) * kPerLane;
  f.box = __ldg(reinterpret_cast<const float4*>(chunk_bv) + chunk);
  if (kVec) {
    if (a0 < A) {
      f.mask = __ldg(reinterpret_cast<const uint32_t*>(mask + a0));
      if (kYaw) {
        const float4 w = __ldg(reinterpret_cast<const float4*>(yaw + a0));
        f.yaw[0] = w.x; f.yaw[1] = w.y; f.yaw[2] = w.z; f.yaw[3] = w.w;
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      if (a0 + j < A) {
        f.mask |= (uint32_t)__ldg(mask + a0 + j) << (8 * j);
        if (kYaw) f.yaw[j] = __ldg(yaw + a0 + j);
      }
    }
  }
  return f;
}

// The lane's place in a warp's chunk, and the chunk's classes.
struct Chunk {
  int a0;       // the lane's first anchor
  int c_lo;     // class of the chunk's first anchor
  int c_hi;     // class of its last anchor
  float4 box;   // standup bounding box of its anchors
};

__device__ __forceinline__ Chunk chunk_of(int chunk, int A, int ncls, const GtTables& gt, float4 box) {
  Chunk ch;
  const int first = chunk * kChunk;
  ch.a0 = first + (threadIdx.x & 31) * kPerLane;
  ch.box = box;
  ch.c_lo = class_of(first, gt.start, ncls);
  ch.c_hi = class_of(min(first + kChunk, A) - 1, gt.start, ncls);
  return ch;
}

// The chunk's candidate rows, ascending, into the warp's list; returns
// their number (warp-uniform). A row stays unless its box is surely disjoint
// from the chunk's box: a pair with a positive intersection has
// min(b.z, q.z) > max(b.x, q.x), so b.z > q.x >= box.x and b.x < q.z <= box.z.
__device__ __forceinline__ int candidates(const GtTables& gt, const Chunk& ch, uint8_t* list) {
  const int lane = threadIdx.x & 31;
  int n = 0;
  __syncwarp();  // the warp has done with the list of its last chunk
  for (int g0 = 0; g0 < gt.rows; g0 += 32) {
    const int g = g0 + lane;
    bool keep = false;
    if (g < gt.rows) {
      const int c = gt.cls[g];
      const float4 b = gt.bv[g];
      keep = c >= ch.c_lo && c <= ch.c_hi && !(b.z <= ch.box.x) && !(ch.box.z <= b.x) &&
             !(b.w <= ch.box.y) && !(ch.box.w <= b.y);
    }
    const unsigned m = __ballot_sync(kFull, keep);
    if (keep) list[n + __popc(m & ((1u << lane) - 1u))] = (uint8_t)g;
    n += __popc(m);
  }
  __syncwarp();
  return n;
}

// in[j]: anchor a0 + j exists and the sample's mask includes it; cls[j]: its
// class (block-uniform where the chunk has one class).
__device__ __forceinline__ void lane_anchors(const Chunk& ch, uint32_t mask, int A, int ncls,
                                             const GtTables& gt, bool in[kPerLane], int cls[kPerLane]) {
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    in[j] = ((mask >> (8 * j)) & 0xffu) != 0u;
    cls[j] = ch.c_lo == ch.c_hi ? ch.c_lo : class_of(min(ch.a0 + j, A - 1), gt.start, ncls);
  }
}

__device__ __forceinline__ void load_boxes(const float* __restrict__ anchors_bv, int a0, int A,
                                           float4 q[kPerLane]) {
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    q[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (a0 + j < A) q[j] = __ldg(reinterpret_cast<const float4*>(anchors_bv) + a0 + j);
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
gt_max_kernel(const float* __restrict__ anchors_bv,   // (A, 4)
              const float* __restrict__ chunk_bv,     // (ceil(A / kChunk), 4)
              const uint8_t* __restrict__ mask,       // (B, A)
              const float* __restrict__ gt_bv,        // (B, G, 4)
              const int32_t* __restrict__ gt_cls,     // (B, G), 1-based
              const uint8_t* __restrict__ gt_valid,   // (B, G)
              const int32_t* __restrict__ cstart,     // (ncls + 1,)
              int ncls, int A, int G,
              int32_t* gmax_bits) {                   // (B, G), starts at -1
  __shared__ GtTables gt;
  __shared__ int sbest[kMaxG];
  __shared__ unsigned sany;  // bit c: class c has an included anchor in this block's chunks
  __shared__ uint8_t slist[kWarps][kMaxG];
#if __CUDA_ARCH__ >= 900
  cudaTriggerProgrammaticLaunchCompletion();  // pass 2 may start; it waits for this grid itself
#endif
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int chunks = (A + kChunk - 1) / kChunk;
  const int stride = gridDim.x * kWarps;
  const uint8_t* bmask = mask + (size_t)b * A;
  int chunk = blockIdx.x * kWarps + warp;
  Fetched cur = fetch<kVec, false>(chunk, chunks, A, chunk_bv, bmask, nullptr);
  for (int g = threadIdx.x; g < G; g += kThreads) sbest[g] = -1;
  if (threadIdx.x == 0) sany = 0u;
  load_gt(b, G, ncls, gt_bv, gt_cls, gt_valid, cstart, gt);

  unsigned any = 0u;
  for (; chunk < chunks; chunk += stride) {
    const Fetched next = fetch<kVec, false>(chunk + stride, chunks, A, chunk_bv, bmask, nullptr);
    const Chunk ch = chunk_of(chunk, A, ncls, gt, cur.box);
    bool in[kPerLane];
    int cls[kPerLane];
    lane_anchors(ch, cur.mask, A, ncls, gt, in, cls);
#pragma unroll
    for (int j = 0; j < kPerLane; ++j)
      if (in[j]) any |= 1u << cls[j];
    const int n = candidates(gt, ch, slist[warp]);
    if (n > 0 && cur.mask != 0u) {  // n is warp-uniform; a lane reads the list it helped to write
      float4 q[kPerLane];
      load_boxes(anchors_bv, ch.a0, A, q);
      for (int k = 0; k < n; ++k) {
        const int g = slist[warp][k];
        const float4 bx = gt.bv[g];
        const int gc = gt.cls[g];
        float best = 0.0f;
#pragma unroll
        for (int j = 0; j < kPerLane; ++j)
          if (in[j] && cls[j] == gc) best = fmaxf(best, iou(bx, q[j]));
        if (best > 0.0f) atomicMax(&sbest[g], __float_as_int(best));
      }
    }
    cur = next;
  }
  any = __reduce_or_sync(kFull, any);
  if (lane == 0 && any) atomicOr(&sany, any);
  __syncthreads();
  for (int g = threadIdx.x; g < G; g += kThreads) {
    const int c = gt.cls[g];
    if (c < 0) continue;
    int v = sbest[g];
    if ((sany >> c) & 1u) v = max(v, 0);  // its disjoint pairs contribute IoU 0
    int32_t* slot = gmax_bits + (size_t)b * G + g;
    if (v >= 0 && v > *reinterpret_cast<volatile int32_t*>(slot)) atomicMax(slot, v);
  }
}

template <bool kVec>
__device__ __forceinline__ void store4(float* p, int a0, int A, const float v[kPerLane]) {
  if (kVec) {
    const float4 w = make_float4(v[0], v[1], v[2], v[3]);
#if MATCHER_STREAMING_STORES
    __stcs(reinterpret_cast<float4*>(p + a0), w);
#else
    *reinterpret_cast<float4*>(p + a0) = w;
#endif
  } else {
#pragma unroll
    for (int j = 0; j < kPerLane; ++j)
      if (a0 + j < A) p[a0 + j] = v[j];
  }
}

template <bool kVec>
__device__ __forceinline__ void store4(int32_t* p, int a0, int A, const int v[kPerLane]) {
  if (kVec) {
    const int4 w = make_int4(v[0], v[1], v[2], v[3]);
#if MATCHER_STREAMING_STORES
    __stcs(reinterpret_cast<int4*>(p + a0), w);
#else
    *reinterpret_cast<int4*>(p + a0) = w;
#endif
  } else {
#pragma unroll
    for (int j = 0; j < kPerLane; ++j)
      if (a0 + j < A) p[a0 + j] = v[j];
  }
}

// Plane k of the regression target of gt box gb against anchor a (planes of
// anchors_t): ops/geometry.box_encode_transposed, every operation rounded on
// its own. Only a positive anchor comes here, so a plane recomputes what it
// shares with the others rather than keep it in registers.
__device__ __forceinline__ float encode_plane(int k, const float* gb, const float* __restrict__ anchors_t,
                                              int a, int A, float ra) {
  const float* an = anchors_t + a;  // plane p at an[p * A]
  if (k < 2) {
    const float la = an[(size_t)3 * A], wa = an[(size_t)4 * A];
    const float diagonal = __fsqrt_rn(__fadd_rn(__fmul_rn(la, la), __fmul_rn(wa, wa)));
    return __fdiv_rn(__fsub_rn(gb[k], an[(size_t)k * A]), diagonal);
  }
  if (k == 2) return __fdiv_rn(__fsub_rn(gb[2], an[(size_t)2 * A]), an[(size_t)5 * A]);
  if (k < 6) return logf(__fdiv_rn(gb[k], an[(size_t)k * A]));
  return __fsub_rn(gb[6], ra);
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
assign_kernel(const float* __restrict__ anchors_t,    // (7, A): planes x y z l w h yaw
              const float* __restrict__ anchors_bv,   // (A, 4)
              const float* __restrict__ chunk_bv,     // (ceil(A / kChunk), 4)
              const uint8_t* __restrict__ mask,       // (B, A)
              const float* __restrict__ gt_boxes,     // (B, G, 7)
              const float* __restrict__ gt_bv,        // (B, G, 4)
              const int32_t* __restrict__ gt_cls,     // (B, G), 1-based
              const uint8_t* __restrict__ gt_valid,   // (B, G)
              const int32_t* gmax_bits,               // (B, G) from pass 1, which may still run
              const int32_t* __restrict__ cstart,     // (ncls + 1,)
              const float* __restrict__ thresholds,   // (ncls, 2): matched, unmatched
              int ncls, int A, int G,
              int32_t* __restrict__ labels,           // (B, A)
              float* __restrict__ targets,            // (B, 7, A)
              float* __restrict__ weights,            // (B, A)
              int32_t* __restrict__ dirs) {           // (B, A)
  __shared__ GtTables gt;
  __shared__ float sbox[kMaxG][7];
  __shared__ float sthr[kMaxClasses][2];
  __shared__ uint8_t slist[kWarps][kMaxG];
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int chunks = (A + kChunk - 1) / kChunk;
  const int stride = gridDim.x * kWarps;
  const uint8_t* bmask = mask + (size_t)b * A;
  const float* yaw = anchors_t + (size_t)6 * A;
  // nothing here is written by pass 1
  for (int i = threadIdx.x; i < G * 7; i += kThreads) sbox[i / 7][i % 7] = gt_boxes[(size_t)b * G * 7 + i];
  if (threadIdx.x < ncls) {
    sthr[threadIdx.x][0] = thresholds[2 * threadIdx.x];
    sthr[threadIdx.x][1] = thresholds[2 * threadIdx.x + 1];
  }
  load_gt(b, G, ncls, gt_bv, gt_cls, gt_valid, cstart, gt);

  bool waited = false;  // warp-uniform: pass 1's result is complete and visible
  for (int chunk = blockIdx.x * kWarps + warp; chunk < chunks; chunk += stride) {
    const Fetched cur = fetch<kVec, true>(chunk, chunks, A, chunk_bv, bmask, yaw);
    const Chunk ch = chunk_of(chunk, A, ncls, gt, cur.box);
    const int a0 = ch.a0;
    bool in[kPerLane];
    int cls[kPerLane];
    lane_anchors(ch, cur.mask, A, ncls, gt, in, cls);
    const int n = candidates(gt, ch, slist[warp]);

    // the result of a row of zeros: what every pair the cull drops gives
    float amax[kPerLane];
    int arg[kPerLane];
    bool force[kPerLane];
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const int f = gt.first[cls[j]];
      amax[j] = f != kNone ? 0.0f : -1.0f;
      arg[j] = f != kNone ? f : 0;
      force[j] = false;
    }
    if (n > 0) {  // warp-uniform
      if (!waited) {
#if __CUDA_ARCH__ >= 900
        cudaGridDependencySynchronize();
#endif
        waited = true;
      }
      // every lane walks the list (the shuffles below need the whole warp);
      // a lane without an included anchor loads no box and matches nothing
      float4 q[kPerLane];
      load_boxes(anchors_bv, a0, cur.mask != 0u ? A : 0, q);
      for (int k0 = 0; k0 < n; k0 += 32) {
        // lane l brings pass 1's maximum of candidate k0 + l: one load in
        // flight a candidate, beside the boxes', not one after the other
        int my_bits = -1;
        if (k0 + lane < n) my_bits = __ldcg(gmax_bits + (size_t)b * G + slist[warp][k0 + lane]);
        const int kn = min(32, n - k0);
        for (int k = 0; k < kn; ++k) {
          const int g = slist[warp][k0 + k];
          const float4 bx = gt.bv[g];
          const int gc = gt.cls[g];
          const int bits = __shfl_sync(kFull, my_bits, k);
          const float gm = bits < 0 ? -1.0f : __int_as_float(bits);
#pragma unroll
          for (int j = 0; j < kPerLane; ++j) {
            if (!(in[j] && cls[j] == gc)) continue;  // IoU -1: never the max, never forced
            const float ov = iou(bx, q[j]);
            if (ov > amax[j]) { amax[j] = ov; arg[j] = g; }
            force[j] |= (ov == gm) && (gm > 0.0f);
          }
        }
      }
    }

    int label[kPerLane];
    float wgt[kPerLane];
    int dir[kPerLane];
    bool any_fg = false;
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      label[j] = -1;
      if (in[j]) {
        const bool pos = force[j] || amax[j] >= sthr[cls[j]][0];
        const bool bg = amax[j] < sthr[cls[j]][1];
        label[j] = pos ? 1 : (bg ? 0 : -1);
      }
      const bool fg = label[j] > 0;
      any_fg |= fg;
      wgt[j] = fg ? 1.0f : 0.0f;
      // from the (zero-filled where not fg) yaw target, for every anchor
      const float t6 = fg ? __fsub_rn(sbox[arg[j]][6], cur.yaw[j]) : 0.0f;
      dir[j] = __fadd_rn(t6, cur.yaw[j]) > 0.0f ? 1 : 0;
    }
    if (a0 < A) {
      const size_t row = (size_t)b * A;
      store4<kVec>(labels + row, a0, A, label);
      store4<kVec>(weights + row, a0, A, wgt);
      store4<kVec>(dirs + row, a0, A, dir);
      float* planes = targets + row * 7;
      if (!any_fg) {  // nearly every lane: seven stores of zeros
        const float zero[kPerLane] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int k = 0; k < 7; ++k) store4<kVec>(planes + (size_t)k * A, a0, A, zero);
      } else {
#pragma unroll
        for (int k = 0; k < 7; ++k) {
          float t[kPerLane];
#pragma unroll
          for (int j = 0; j < kPerLane; ++j)
            t[j] = label[j] > 0 ? encode_plane(k, sbox[arg[j]], anchors_t, a0 + j, A, cur.yaw[j]) : 0.0f;
          store4<kVec>(planes + (size_t)k * A, a0, A, t);
        }
      }
    }
  }
#if __CUDA_ARCH__ >= 900
  // no block ends before pass 1 has: what follows on the stream may read its result
  if (!waited) cudaGridDependencySynchronize();
#endif
}

// warps walk the chunks of their sample with a stride of the grid, so a
// block loads its sample's gt tables once for several chunks
dim3 grid_for(int A, int B, int blocks_per_sample) {
  const int chunks = (A + kChunk - 1) / kChunk;
  const int blocks = (chunks + kWarps - 1) / kWarps;
  return dim3(blocks < blocks_per_sample ? blocks : blocks_per_sample, B);
}

bool bad_sizes(int B, int A, int G, int ncls, int nchunks) {
  return B < 0 || A < 0 || G < 1 || G > kMaxG || ncls < 1 || ncls > kMaxClasses ||
         nchunks != (A + kChunk - 1) / kChunk;
}

bool aligned(const void* p, uintptr_t bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }

}  // namespace

// Anchors of one row of `chunk_bv`: the table must be made for this size.
extern "C" int det3d_matcher_chunk() { return kChunk; }

// Pass 1. anchors_bv (A, 4) f32, chunk_bv (nchunks, 4) f32 bounding boxes
// of each det3d_matcher_chunk() consecutive anchors, mask (B, A) bool, gt_bv
// (B, G, 4) f32, gt_cls (B, G) int32 1-based, gt_valid (B, G) bool, cstart
// (ncls + 1) int32 anchor offsets of the classes; writes gmax_bits (B, G)
// int32: the float bits of each gt's best IoU over its class's included
// anchors, or -1 where no such anchor exists. `parts` bit 0: set gmax_bits
// to -1 first (a memset ahead of the kernel), bit 1: launch the kernel; a
// caller passes 3. Contiguous device tensors, launched on `stream`. Returns
// the CUDA error (0 on success).
extern "C" int det3d_matcher_gt_max(const void* anchors_bv, const void* chunk_bv, const void* mask,
                                    const void* gt_bv, const void* gt_cls, const void* gt_valid,
                                    const void* cstart, int ncls, int B, int A, int G, int nchunks,
                                    int parts, void* gmax_bits, void* stream_ptr) {
  if (bad_sizes(B, A, G, ncls, nchunks) || !aligned(anchors_bv, 16) || !aligned(chunk_bv, 16))
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (parts & 1) {
    cudaError_t err = cudaMemsetAsync(gmax_bits, 0xff, (size_t)B * G * sizeof(int32_t), stream);
    if (err != cudaSuccess) return (int)err;
  }
  if (!(parts & 2) || B == 0 || A == 0) return 0;
  const bool vec = A % kPerLane == 0 && aligned(mask, 4);
  auto kernel = vec ? gt_max_kernel<true> : gt_max_kernel<false>;
  kernel<<<grid_for(A, B, MATCHER_BLOCKS_P1), kThreads, 0, stream>>>(
      static_cast<const float*>(anchors_bv), static_cast<const float*>(chunk_bv),
      static_cast<const uint8_t*>(mask), static_cast<const float*>(gt_bv),
      static_cast<const int32_t*>(gt_cls), static_cast<const uint8_t*>(gt_valid),
      static_cast<const int32_t*>(cstart), ncls, A, G, static_cast<int32_t*>(gmax_bits));
  return (int)cudaGetLastError();
}

// Pass 2. As pass 1, plus anchors_t (7, A) f32 planes, gt_boxes (B, G, 7)
// f32, pass 1's gmax_bits and thresholds (ncls, 2) f32 [matched,
// unmatched]; writes labels (B, A) int32, targets (B, 7, A) f32, weights
// (B, A) f32 and dirs (B, A) int32 in full. `early` != 0 lets the kernel
// start while the kernel ahead of it on the stream still runs; it waits for
// that kernel before it reads gmax_bits or ends, and reads every other input
// at once, so that kernel must be pass 1. Returns the CUDA error (0 on
// success).
extern "C" int det3d_matcher_assign(const void* anchors_t, const void* anchors_bv, const void* chunk_bv,
                                    const void* mask, const void* gt_boxes, const void* gt_bv,
                                    const void* gt_cls, const void* gt_valid, const void* gmax_bits,
                                    const void* cstart, const void* thresholds, int ncls, int B,
                                    int A, int G, int nchunks, int early, void* labels, void* targets,
                                    void* weights, void* dirs, void* stream_ptr) {
  if (bad_sizes(B, A, G, ncls, nchunks) || !aligned(anchors_bv, 16) || !aligned(chunk_bv, 16))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || A == 0) return 0;
  const bool vec = A % kPerLane == 0 && aligned(mask, 4) && aligned(anchors_t, 16) &&
                   aligned(labels, 16) && aligned(targets, 16) && aligned(weights, 16) &&
                   aligned(dirs, 16);
  auto kernel = vec ? assign_kernel<true> : assign_kernel<false>;
  cudaLaunchConfig_t config = {};
  config.gridDim = grid_for(A, B, MATCHER_BLOCKS_P2);
  config.blockDim = dim3(kThreads);
  config.stream = static_cast<cudaStream_t>(stream_ptr);
  cudaLaunchAttribute attr = {};
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  config.attrs = &attr;
  config.numAttrs = early ? 1 : 0;
  return (int)cudaLaunchKernelEx(
      &config, kernel, static_cast<const float*>(anchors_t), static_cast<const float*>(anchors_bv),
      static_cast<const float*>(chunk_bv), static_cast<const uint8_t*>(mask),
      static_cast<const float*>(gt_boxes), static_cast<const float*>(gt_bv),
      static_cast<const int32_t*>(gt_cls), static_cast<const uint8_t*>(gt_valid),
      static_cast<const int32_t*>(gmax_bits), static_cast<const int32_t*>(cstart),
      static_cast<const float*>(thresholds), ncls, A, G, static_cast<int32_t*>(labels),
      static_cast<float*>(targets), static_cast<float*>(weights), static_cast<int32_t*>(dirs));
}

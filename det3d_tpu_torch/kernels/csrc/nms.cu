// Exact greedy NMS over a batch of classes: a suppression mask built by the
// whole card, then one short sweep per class.
//
// Replaces: det3d_tpu/kernels/nms_pallas.py `_nms_kernel`
// (through `nms_keep_pallas` / `greedy_nms_pallas`).
//
// What bounds it on the H100: latency, not bytes or operations. The inputs
// are 16 KB of boxes per class and the pairwise IoU is ~7.5 M operations per
// class at K = 1000, well under a microsecond of the card's float32 rate; the
// greedy sweep is K decisions that each depend on the one before.
//
// Design, two launches back to back on one stream, the second started early:
//   mask_tiles  grid (upper-triangle pairs of 64-box tiles, classes), 256
//               threads. The tile's 64 column boxes, their areas and their
//               valid bits are staged in shared memory; thread (row, span)
//               holds its row's box and area in registers and tests 16
//               columns (a warp shares its span, so every column read is a
//               broadcast); disjoint boxes, nearly every pair, skip the
//               division. The 16-bit pieces meet in shared memory and leave
//               as two 32-bit words per row of
//                 S[i][j] = (IoU(i, j) > thr) & (i < j) & valid[i] & valid[j]
//               in a scratch tensor (ncls, K, 32) whose rows are one 128-byte
//               line. 408 blocks of 8 warps at 3 x 1000: every scheduler of
//               the card has a few warps to switch between. Only tiles on or
//               above the diagonal are written; nothing else is ever read,
//               so the scratch needs no memset.
//   sweep       one warp per class. The class's rows come into shared memory
//               (128 KB at K = 1000) as 1-D bulk copies, one per chunk of 32
//               rows, each completing on its own mbarrier, so the first
//               chunks are swept while the later ones are in flight. The
//               rows are walked in chunks of 32: every lane loads the
//               chunk's 32 diagonal words D[b] = S[32c + b][word c]
//               (broadcast reads) and its own word of the 32 rows, all while
//               the chunk before is being decided, takes r = removed[c] and
//               the chunk's valid word, and decides the 32 rows in registers:
//                 if (valid_b & ~r_b) { kept_b = 1; r |= D[b]; }
//               fully unrolled, a shift and a three-input logic operation
//               per row on a rotating copy of r (`decide_row`), no shuffle,
//               no predicate and no memory access in the chain. Then lane
//               l > c ORs its word of every kept row into its word of
//               `removed`.
//               K dependent (shuffle + two shared-memory reads) steps become
//               K two-operation register steps plus loads that wait for
//               nothing. The sweep is launched early (programmatic dependent
//               launch): its barriers and valid words are ready when the
//               mask kernel's grid completes.
//               This is the exact sequential greedy, not the TPU kernel's
//               frontier iteration (a workaround for dynamic indexing there).
// The IoU is evaluated with the same operations in the same order as the
// plain PyTorch version (ops/nms.py iou_pixel_convention), each rounded on
// its own: the library is compiled with -fmad=false and IEEE division, and
// the intrinsics below make the rounding explicit. A box's area is computed
// once per box by the same three operations the plain version uses per pair,
// so its bits are the same and the keep masks agree exactly. K is at most
// 1024 (one word of `removed` per lane).
//
// Rotated boxes (the center model's NMS, CenterPoint's `rotate_nms_pcdet`):
// `det3d_nms_keep_rotated` launches a second `mask_tiles`, an overload over
// rotated BEV boxes [cx, cy, dx, dy, angle] and their corners (computed by
// the caller, ops/rotated_iou.py `rbbox_corners`), in the same tile layout,
// and hands its mask to the same `sweep`. A pair of valid boxes i < j is
// first tested by its circumscribed circles (ops/nms.py `circles_meet`); a
// pair whose circles meet is clipped: the rotated IoU of ops/rotated_iou.py
// (criterion -1) with the same 24 candidate vertices, the same order of
// operations, the fixed-order sums and the stable angle sort, each operation
// rounded on its own, so the keep sets equal the plain version's
// (ops/nms.py `greedy_keep_rotated`). Row i's box is the first box of the
// pair there too.
//
// Measured and dropped (NVIDIA H100 80GB HBM3, 700 W, 3 x 1000 boxes;
// experiments/kernel_redesigns.py, times in PERF.md): the one-block-per-class
// kernel that built the matrix with 512 threads in shared memory and swept
// it with a shuffle and two shared-memory reads per row (5/6 of its time was
// the matrix, on 3 of 132 SMs); a mask kernel of 64 threads a tile with 64
// IoUs and 64 divisions each (2.5x slower than this one: too few warps per
// scheduler); the sweep launched only when the mask kernel has finished
// (~2 us slower than the early launch); a chain of a test and a predicated
// OR per row, and one of mask arithmetic that the compiler routed through a
// multiply (both ~10 % slower than the rotating word); one launch in which
// the last tile block of a class runs the sweep (experiments/
// nms_one_launch.cu: 0.034 against 0.024 ms; every tile block then has to be
// launched with the sweep's 128 KB of shared memory, one block per SM, and
// the early launch already hides the second launch).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxK = 1024;
constexpr int kRowWords = 32;  // words per mask row: kMaxK bits, one 128-byte line
constexpr int kTile = 64;      // boxes per tile side; two words per row and tile
constexpr int kSpan = 16;      // columns per thread of the mask kernel
constexpr int kMaskThreads = kTile * (kTile / kSpan);
constexpr int kChunk = 32;     // rows per sweep chunk: one word of `removed`
constexpr int kChunkWords = kChunk * kRowWords;

__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(__fadd_rn(__fsub_rn(b.z, b.x), 1.0f), __fadd_rn(__fsub_rn(b.w, b.y), 1.0f));
}

__device__ __forceinline__ bool suppresses(float4 a, float area_a, float4 b, float area_b, float thr) {
  // boxes are [x1, y1, x2, y2]; the +1 pixel convention of the reference
  float iw = fmaxf(__fadd_rn(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 1.0f), 0.0f);
  float ih = fmaxf(__fadd_rn(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 1.0f), 0.0f);
  float inter = __fmul_rn(iw, ih);
  float both = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  // disjoint boxes, nearly every pair: 0 / both is 0 (NaN for both = 0 or NaN)
  // and needs no division
  if (inter == 0.0f) return 0.0f > thr && both != 0.0f && both == both;
  return __fdiv_rn(inter, both) > thr;
}

__device__ __forceinline__ float4 load_box(const float* boxes, int i) {
  return make_float4(boxes[4 * i], boxes[4 * i + 1], boxes[4 * i + 2], boxes[4 * i + 3]);
}

// One block's tile of the mask: `pair` counts the tile pairs (tr, tc),
// tc >= tr, row by row.
__device__ __forceinline__ void mask_tile(const float* __restrict__ boxes,    // (ncls, K, 4)
                                          const uint8_t* __restrict__ valid,  // (ncls, K)
                                          uint32_t* __restrict__ mask,        // (ncls, K, kRowWords)
                                          int K, int tiles, float thr, int pair, int cls) {
  __shared__ float4 col_box[kTile];
  __shared__ float col_area[kTile];
  __shared__ uint32_t col_valid[kTile / 32];
  __shared__ uint32_t part[kTile / kSpan][kTile];  // [span][row]: kSpan suppression bits

  int tr = 0;
  int tc = pair;
  while (tc >= tiles - tr) {
    tc -= tiles - tr;
    ++tr;
  }
  tc += tr;
  const int t = threadIdx.x;
  const float* b = boxes + (size_t)cls * K * 4;
  const uint8_t* v = valid + (size_t)cls * K;

  if (t < kTile) {  // two whole warps stage the tile's columns
    const int j = tc * kTile + t;  // columns past K are invalid boxes of zeros
    const float4 box_j = j < K ? load_box(b, j) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    col_box[t] = box_j;
    col_area[t] = box_area(box_j);
    const uint32_t ballot = __ballot_sync(0xffffffffu, j < K && v[j]);
    if ((t & 31) == 0) col_valid[t >> 5] = ballot;
  }
  __syncthreads();

  // thread (row, span): kSpan columns of one row; a warp shares its span, so
  // every column read is a broadcast
  const int row = t % kTile;
  const int span = t / kTile;
  const int i = tr * kTile + row;
  const int j0 = tc * kTile + span * kSpan;
  uint32_t bits = 0;
  if (i < K && v[i] && j0 + kSpan - 1 > i) {  // some column of the span lies right of the diagonal
    const float4 a = load_box(b, i);
    const float area_a = box_area(a);
#pragma unroll
    for (int c = 0; c < kSpan; ++c) {
      if (suppresses(a, area_a, col_box[span * kSpan + c], col_area[span * kSpan + c], thr)) bits |= 1u << c;
    }
    bits &= col_valid[span * kSpan / 32] >> (span * kSpan % 32);
    if (i >= j0) bits &= ~((2u << (i - j0)) - 1u);  // only columns j > i
  }
  part[span][row] = bits & ((1u << kSpan) - 1u);
  __syncthreads();

  if (t < kTile * (kTile / 32) && tr * kTile + row < K) {  // thread (row, word)
    const int w = t / kTile;
    uint32_t word = 0;
#pragma unroll
    for (int s = 0; s < 32 / kSpan; ++s) word |= part[w * (32 / kSpan) + s][row] << (s * kSpan);
    mask[((size_t)cls * K + i) * kRowWords + 2 * tc + w] = word;
  }
}

__global__ void __launch_bounds__(kMaskThreads)
mask_tiles(const float* __restrict__ boxes, const uint8_t* __restrict__ valid, uint32_t* __restrict__ mask,
           int K, int tiles, float thr) {
  // the sweep may be launched now: it waits for this grid before it reads the mask
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  mask_tile(boxes, valid, mask, K, tiles, thr, blockIdx.x, blockIdx.y);
}

__device__ __forceinline__ uint32_t shared_address(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void wait_for(const uint64_t* barrier) {  // its first phase
  const uint32_t bar = shared_address(barrier);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(0)
        : "memory");
  }
}

struct ChunkRows {         // what one lane reads of a chunk of kChunk rows
  uint32_t diag[kChunk];   // the chunk's own word of every row (the same in every lane)
  uint32_t word[kChunk];   // this lane's word of every row
};

struct SweepState {
  uint32_t removed;      // lane l: word l of the suppressed set
  uint32_t kept;         // lane l: word l of the keep mask
  uint32_t valid_word;   // lane l: the valid flags of rows 32l .. 32l + 31
  int lane;
  int words;             // words of each row that mask_tiles wrote
};

__device__ __forceinline__ void load_chunk(ChunkRows& into, const uint32_t* chunk, int c, int lane) {
#pragma unroll
  for (int b = 0; b < kChunk; ++b) {
    into.diag[b] = chunk[b * kRowWords + c];
    into.word[b] = chunk[b * kRowWords + lane];
  }
}

// One row of the chain. `x` is the removed word rotated so that the bit of
// the row to decide is bit 31: m is all ones if the row is removed, and the
// next row's x is x rotated by one, with the row's diagonal word `e` (rotated
// to match by the caller) ORed in unless m. The shift and the rotate wait for
// the same x, so a row costs two dependent operations, both with register
// results in one pipe: with a predicate or a multiply between them the sweep
// ran ~10 % longer. (The warp is alone on its SM, so the rest of the loop is
// kept short too: every operation takes its turn in that warp.)
__device__ __forceinline__ void decide_row(uint32_t& x, uint32_t e) {
  asm("{\n\t"
      ".reg .b32 m, y;\n\t"
      "shr.s32 m, %0, 31;\n\t"
      "shf.r.wrap.b32 y, %0, %0, 1;\n\t"
      "lop3.b32 %0, y, m, %1, 0xF2;\n\t"  // y | (~m & e)
      "}"
      : "+r"(x)
      : "r"(e));
}

// acc |= word if the row's bit of `select` is set, in two operations
__device__ __forceinline__ void or_if(uint32_t& acc, uint32_t select, uint32_t bit, uint32_t word) {
  asm("{\n\t"
      ".reg .pred p;\n\t"
      ".reg .b32 t;\n\t"
      "and.b32 t, %1, %2;\n\t"
      "setp.ne.b32 p, t, 0;\n\t"
      "@p or.b32 %0, %0, %3;\n\t"
      "}"
      : "+r"(acc)
      : "r"(select), "r"(bit), "r"(word));
}

__device__ __forceinline__ void sweep_chunk(SweepState& s, const ChunkRows& rows, int c) {
  const uint32_t alive = __shfl_sync(0xffffffffu, s.valid_word, c);  // rows past K are not valid
  // a row that is not valid counts as removed: it is not kept and ORs nothing
  const uint32_t r = __shfl_sync(0xffffffffu, s.removed, c) | ~alive;
  uint32_t x = __funnelshift_l(r, r, 31);  // row 0's bit at bit 31
#pragma unroll
  for (int b = 0; b < kChunk; ++b) decide_row(x, __funnelshift_l(rows.diag[b], rows.diag[b], (30 - b) & 31));
  // a row's bit is final when the row is decided: later rows set only later bits
  const uint32_t k = ~__funnelshift_l(x, x, 1);
  if (s.lane == c) s.kept = k;
  // words left of the diagonal and past `words` were never written
  const uint32_t spread = (s.lane > c && s.lane < s.words) ? k : 0u;
  uint32_t gather[2] = {0u, 0u};
#pragma unroll
  for (int b = 0; b < kChunk; ++b) or_if(gather[b % 2], spread, 1u << b, rows.word[b]);
  s.removed |= gather[0] | gather[1];
}

// One warp's sweep of class `cls`. `rows` is shared memory for whole chunks
// of kChunk rows, `arrived` one barrier per chunk; `ready` runs once the
// barriers and valid words are set up, before the mask is first read.
template <typename Ready>
__device__ __forceinline__ void sweep_class(const uint32_t* __restrict__ mask,  // (ncls, K, kRowWords)
                                            const uint8_t* __restrict__ valid,  // (ncls, K)
                                            uint8_t* __restrict__ keep,         // (ncls, K)
                                            int K, int words,  // words of each row that mask_tile wrote
                                            int cls, int lane, uint32_t* rows, uint64_t* arrived, Ready ready) {
  const int chunks = (K + kChunk - 1) / kChunk;
  const uint32_t* src = mask + (size_t)cls * K * kRowWords;
  const uint8_t* v = valid + (size_t)cls * K;

  // everything up to `ready` may overlap the mask kernel's run
  if (lane < chunks) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(shared_address(&arrived[lane])), "r"(1)
                 : "memory");
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncwarp();

  // the valid flags as words: lane c holds rows 32c .. 32c + 31
  uint8_t flag[kMaxK / kChunk];
#pragma unroll
  for (int c = 0; c < kMaxK / kChunk; ++c) {
    const int i = c * kChunk + lane;
    flag[c] = i < K ? v[i] : (uint8_t)0;
  }
  uint32_t valid_word = 0;
#pragma unroll
  for (int c = 0; c < kMaxK / kChunk; ++c) {
    const uint32_t ballot = __ballot_sync(0xffffffffu, flag[c] != 0);
    if (lane == c) valid_word = ballot;
  }

  ready();

  // lane c brings chunk c in: a bulk copy that completes on arrived[c]
  if (lane < chunks) {
    const uint32_t bar = shared_address(&arrived[lane]);
    const uint32_t bytes = (uint32_t)min(kChunk, K - lane * kChunk) * kRowWords * sizeof(uint32_t);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
            shared_address(rows + lane * kChunkWords)),
        "l"(src + (size_t)lane * kChunkWords), "r"(bytes), "r"(bar)
        : "memory");
  }

  // two sets of registers in turn: the next chunk's loads are in flight
  // while the chain of this one runs
  SweepState state = {0u, 0u, valid_word, lane, words};
  ChunkRows even, odd;
  wait_for(&arrived[0]);
  load_chunk(even, rows, 0, lane);
  for (int c = 0; c < chunks; c += 2) {
    if (c + 1 < chunks) {
      wait_for(&arrived[c + 1]);
      load_chunk(odd, rows + (c + 1) * kChunkWords, c + 1, lane);
    }
    sweep_chunk(state, even, c);
    if (c + 1 < chunks) {
      if (c + 2 < chunks) {
        wait_for(&arrived[c + 2]);
        load_chunk(even, rows + (c + 2) * kChunkWords, c + 2, lane);
      }
      sweep_chunk(state, odd, c + 1);
    }
  }
  const uint32_t kept = state.kept;

  for (int c = 0; c < chunks; ++c) {
    const uint32_t word = __shfl_sync(0xffffffffu, kept, c);
    const int i = c * kChunk + lane;
    if (i < K) keep[(size_t)cls * K + i] = (uint8_t)((word >> lane) & 1u);
  }
}

__global__ void __launch_bounds__(32)
sweep(const uint32_t* __restrict__ mask, const uint8_t* __restrict__ valid, uint8_t* __restrict__ keep, int K,
      int words) {
  extern __shared__ __align__(128) uint32_t rows[];
  __shared__ __align__(8) uint64_t arrived[kMaxK / kChunk];
  sweep_class(mask, valid, keep, K, words, blockIdx.x, threadIdx.x, rows, arrived, [] {
    // the mask kernel's grid is complete and its writes are visible after this
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
  });
}

// --- rotated boxes -------------------------------------------------------------

constexpr float kCircleSlack = 1e-5f;  // ops/nms.py CIRCLE_SLACK

struct RBox {
  float x[4], y[4];  // corners, ops/rotated_iou.py rbbox_corners order
  float cx, cy;
  float reach;       // half the diagonal: the circumscribed circle's radius
  float area;        // dx * dy
};

__device__ __forceinline__ RBox load_rbox(const float* rboxes, const float* corners, int i) {
  RBox b;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    b.x[k] = corners[8 * i + 2 * k];
    b.y[k] = corners[8 * i + 2 * k + 1];
  }
  const float dx = rboxes[5 * i + 2], dy = rboxes[5 * i + 3];
  b.cx = rboxes[5 * i];
  b.cy = rboxes[5 * i + 1];
  b.area = __fmul_rn(dx, dy);
  b.reach = __fmul_rn(__fsqrt_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy))), 0.5f);
  return b;
}

__device__ __forceinline__ bool circles_meet(const RBox& a, const RBox& b) {
  const float dx = __fsub_rn(a.cx, b.cx), dy = __fsub_rn(a.cy, b.cy);
  const float r = __fmul_rn(__fadd_rn(a.reach, b.reach), __fadd_rn(1.0f, kCircleSlack));
  return __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)) <= __fmul_rn(r, r);
}

// ops/rotated_iou.py _point_in_quad: the inclusive projection test with a relative epsilon
__device__ __forceinline__ bool in_quad(float px, float py, const RBox& q) {
  const float abx = __fsub_rn(q.x[1], q.x[0]), aby = __fsub_rn(q.y[1], q.y[0]);
  const float adx = __fsub_rn(q.x[3], q.x[0]), ady = __fsub_rn(q.y[3], q.y[0]);
  const float apx = __fsub_rn(px, q.x[0]), apy = __fsub_rn(py, q.y[0]);
  const float abab = __fadd_rn(__fmul_rn(abx, abx), __fmul_rn(aby, aby));
  const float abap = __fadd_rn(__fmul_rn(abx, apx), __fmul_rn(aby, apy));
  const float adad = __fadd_rn(__fmul_rn(adx, adx), __fmul_rn(ady, ady));
  const float adap = __fadd_rn(__fmul_rn(adx, apx), __fmul_rn(ady, apy));
  const float tol = __fmul_rn(1e-6f, __fadd_rn(abab, adad));
  return abap >= -tol && abap <= __fadd_rn(abab, tol) && adap >= -tol && adap <= __fadd_rn(adad, tol);
}

// (r - p) x (q - p) > 0, as _edge_intersections' gt_cross
__device__ __forceinline__ bool gt_cross(float px, float py, float qx, float qy, float rx, float ry) {
  return __fmul_rn(__fsub_rn(ry, py), __fsub_rn(qx, px)) > __fmul_rn(__fsub_rn(qy, py), __fsub_rn(rx, px));
}

// ops/rotated_iou.py rotated_intersection_area for one pair: a's corners,
// b's corners, then the 16 edge crossings (edge i of a, edge j of b at
// 8 + 4i + j); the centroid and the fan area as fixed-order sums
__device__ __noinline__ float rotated_inter(const RBox& a, const RBox& b) {
  float px[24], py[24];
  uint32_t valid = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    px[k] = a.x[k];
    py[k] = a.y[k];
    px[4 + k] = b.x[k];
    py[4 + k] = b.y[k];
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (in_quad(a.x[k], a.y[k], b)) valid |= 1u << k;
    if (in_quad(b.x[k], b.y[k], a)) valid |= 1u << (4 + k);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float a0x = a.x[i], a0y = a.y[i], a1x = a.x[(i + 1) & 3], a1y = a.y[(i + 1) & 3];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float b0x = b.x[j], b0y = b.y[j], b1x = b.x[(j + 1) & 3], b1y = b.y[(j + 1) & 3];
      const bool acd = gt_cross(a0x, a0y, b0x, b0y, b1x, b1y);
      const bool bcd = gt_cross(a1x, a1y, b0x, b0y, b1x, b1y);
      const bool abc = gt_cross(a0x, a0y, a1x, a1y, b0x, b0y);
      const bool abd = gt_cross(a0x, a0y, a1x, a1y, b1x, b1y);
      const int v = 8 + 4 * i + j;
      if ((acd != bcd) && (abc != abd)) valid |= 1u << v;
      const float bax = __fsub_rn(a1x, a0x), bay = __fsub_rn(a1y, a0y);
      const float dcx = __fsub_rn(b1x, b0x), dcy = __fsub_rn(b1y, b0y);
      const float abba = __fsub_rn(__fmul_rn(a0x, a1y), __fmul_rn(a1x, a0y));
      const float cddc = __fsub_rn(__fmul_rn(b0x, b1y), __fmul_rn(b1x, b0y));
      float dh = __fsub_rn(__fmul_rn(bay, dcx), __fmul_rn(bax, dcy));
      if (dh == 0.0f) dh = 1e-12f;
      px[v] = __fdiv_rn(__fsub_rn(__fmul_rn(abba, dcx), __fmul_rn(bax, cddc)), dh);
      py[v] = __fdiv_rn(__fsub_rn(__fmul_rn(abba, dcy), __fmul_rn(bay, cddc)), dh);
    }
  }
  const int count = __popc(valid);
  if (count < 3) return 0.0f;  // no triangle: the sum of 22 zeros
  float sx = (valid & 1u) ? px[0] : 0.0f;
  float sy = (valid & 1u) ? py[0] : 0.0f;
  for (int k = 1; k < 24; ++k) {
    const bool on = (valid >> k) & 1u;
    sx = __fadd_rn(sx, on ? px[k] : 0.0f);
    sy = __fadd_rn(sy, on ? py[k] : 0.0f);
  }
  const float denom = (float)count;
  const float cx = __fdiv_rn(sx, denom), cy = __fdiv_rn(sy, denom);
  // the valid vertices in index order, sorted stably by angle about the centroid
  float key[24];
  int order[24];
  int n = 0;
  for (int k = 0; k < 24; ++k) {
    if (!((valid >> k) & 1u)) continue;
    const float ang = atan2f(__fsub_rn(py[k], cy), __fsub_rn(px[k], cx));
    int at = n++;
    while (at > 0 && key[at - 1] > ang) {
      key[at] = key[at - 1];
      order[at] = order[at - 1];
      --at;
    }
    key[at] = ang;
    order[at] = k;
  }
  const float p0x = px[order[0]], p0y = py[order[0]];
  float area = 0.0f;
  for (int t = 0; t < 22; ++t) {
    float tri = 0.0f;
    if (t + 2 < count) {
      const float p1x = px[order[t + 1]], p1y = py[order[t + 1]];
      const float p2x = px[order[t + 2]], p2y = py[order[t + 2]];
      tri = __fdiv_rn(fabsf(__fsub_rn(__fmul_rn(__fsub_rn(p0x, p2x), __fsub_rn(p1y, p2y)),
                                      __fmul_rn(__fsub_rn(p0y, p2y), __fsub_rn(p1x, p2x)))),
                      2.0f);
    }
    area = t == 0 ? tri : __fadd_rn(area, tri);
  }
  return area;
}

__device__ __forceinline__ bool rotated_suppresses(const RBox& a, const RBox& b, float thr) {
  const float inter = rotated_inter(a, b);
  float both = __fsub_rn(__fadd_rn(a.area, b.area), inter);
  if (both == 0.0f) both = 1e-12f;
  return __fdiv_rn(inter, both) > thr;
}

// One block's tile of the rotated mask, in mask_tile's layout: columns
// staged in shared memory, thread (row, span) tests kSpan columns, each
// valid pair right of the diagonal by its circles first
__device__ __forceinline__ void mask_tile_rotated(const float* __restrict__ rboxes,   // (rows, K, 5)
                                                  const float* __restrict__ corners,  // (rows, K, 4, 2)
                                                  const uint8_t* __restrict__ valid,  // (rows, K)
                                                  uint32_t* __restrict__ mask,        // (rows, K, kRowWords)
                                                  int K, int tiles, float thr, int pair, int row_set) {
  __shared__ RBox col_box[kTile];
  __shared__ uint32_t col_valid[kTile / 32];
  __shared__ uint32_t part[kTile / kSpan][kTile];

  int tr = 0;
  int tc = pair;
  while (tc >= tiles - tr) {
    tc -= tiles - tr;
    ++tr;
  }
  tc += tr;
  const int t = threadIdx.x;
  const float* rb = rboxes + (size_t)row_set * K * 5;
  const float* cn = corners + (size_t)row_set * K * 8;
  const uint8_t* v = valid + (size_t)row_set * K;

  if (t < kTile) {
    const int j = tc * kTile + t;
    bool live = false;
    if (j < K) {
      col_box[t] = load_rbox(rb, cn, j);
      live = v[j] != 0;
    }
    const uint32_t ballot = __ballot_sync(0xffffffffu, live);
    if ((t & 31) == 0) col_valid[t >> 5] = ballot;
  }
  __syncthreads();

  const int row = t % kTile;
  const int span = t / kTile;
  const int i = tr * kTile + row;
  const int j0 = tc * kTile + span * kSpan;
  uint32_t bits = 0;
  if (i < K && v[i] && j0 + kSpan - 1 > i) {
    uint32_t live = (col_valid[span * kSpan / 32] >> (span * kSpan % 32)) & ((1u << kSpan) - 1u);
    if (i >= j0) live &= ~((2u << (i - j0)) - 1u);  // only columns j > i
    if (live) {
      const RBox a = load_rbox(rb, cn, i);
#pragma unroll 1
      for (int c = 0; c < kSpan; ++c) {
        if (!((live >> c) & 1u)) continue;
        const RBox& b = col_box[span * kSpan + c];
        if (circles_meet(a, b) && rotated_suppresses(a, b, thr)) bits |= 1u << c;
      }
    }
  }
  part[span][row] = bits;
  __syncthreads();

  if (t < kTile * (kTile / 32) && tr * kTile + row < K) {
    const int w = t / kTile;
    uint32_t word = 0;
#pragma unroll
    for (int s = 0; s < 32 / kSpan; ++s) word |= part[w * (32 / kSpan) + s][row] << (s * kSpan);
    mask[((size_t)row_set * K + i) * kRowWords + 2 * tc + w] = word;
  }
}

// the rotated overload: the trace names both kernels `mask_tiles(`
__global__ void __launch_bounds__(kMaskThreads)
mask_tiles(const float* __restrict__ rboxes, const float* __restrict__ corners, const uint8_t* __restrict__ valid,
           uint32_t* __restrict__ mask, int K, int tiles, float thr) {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  mask_tile_rotated(rboxes, corners, valid, mask, K, tiles, thr, blockIdx.x, blockIdx.y);
}

}  // namespace

namespace {

// the sweep over a mask of `rows` rows of K boxes, started early when `parts` has bit 2
int launch_sweep(const void* mask, const void* valid, void* keep, int rows, int K, int tiles, int parts,
                 cudaStream_t stream) {
  const int chunks = (K + kChunk - 1) / kChunk;
  const size_t smem = (size_t)chunks * kChunkWords * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(sweep, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(rows);
  config.blockDim = dim3(32);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute early = {};  // start while the mask kernel runs; the sweep waits for it itself
  early.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  early.val.programmaticStreamSerializationAllowed = 1;
  config.attrs = &early;
  config.numAttrs = (parts & 4) ? 1 : 0;
  return (int)cudaLaunchKernelEx(&config, sweep, static_cast<const uint32_t*>(mask),
                                 static_cast<const uint8_t*>(valid), static_cast<uint8_t*>(keep), K, 2 * tiles);
}

}  // namespace

// boxes (ncls, K, 4) f32 minmax in descending score order, valid (ncls, K)
// bool, keep (ncls, K) bool written in full, mask (ncls, K, 32) int32 scratch
// (not initialised by the caller); contiguous device tensors, launched on
// `stream`. `parts` is 7 for the whole function: bit 0 launches the mask
// kernel, bit 1 the sweep (alone: over the mask of an earlier call, for
// timing the two apart), bit 2 lets the sweep start before the kernel ahead
// of it in the stream has finished. The caller applies the post_max_size
// rank cap. Returns the CUDA error of the launches (0 on success).
extern "C" int det3d_nms_keep(const void* boxes, const void* valid, void* keep, void* mask, int ncls,
                              int K, float iou_threshold, int parts, void* stream_ptr) {
  if (K < 1 || K > kMaxK || ncls < 0 || ncls > 65535) return (int)cudaErrorInvalidValue;
  if (ncls == 0) return 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int tiles = (K + kTile - 1) / kTile;
  if (parts & 1) {
    mask_tiles<<<dim3(tiles * (tiles + 1) / 2, ncls), kMaskThreads, 0, stream>>>(
        static_cast<const float*>(boxes), static_cast<const uint8_t*>(valid), static_cast<uint32_t*>(mask), K,
        tiles, iou_threshold);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (parts & 2) return launch_sweep(mask, valid, keep, ncls, K, tiles, parts, stream);
  return 0;
}

// The rotated version: rboxes (rows, K, 5) f32 [cx, cy, dx, dy, angle] in
// descending score order, corners (rows, K, 4, 2) f32 their corners
// (ops/rotated_iou.py rbbox_corners), valid (rows, K) bool, keep, mask and
// `parts` as det3d_nms_keep's.
extern "C" int det3d_nms_keep_rotated(const void* rboxes, const void* corners, const void* valid, void* keep,
                                      void* mask, int rows, int K, float iou_threshold, int parts,
                                      void* stream_ptr) {
  if (K < 1 || K > kMaxK || rows < 0 || rows > 65535) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int tiles = (K + kTile - 1) / kTile;
  if (parts & 1) {
    mask_tiles<<<dim3(tiles * (tiles + 1) / 2, rows), kMaskThreads, 0, stream>>>(
        static_cast<const float*>(rboxes), static_cast<const float*>(corners), static_cast<const uint8_t*>(valid),
        static_cast<uint32_t*>(mask), K, tiles, iou_threshold);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (parts & 2) return launch_sweep(mask, valid, keep, rows, K, tiles, parts, stream);
  return 0;
}

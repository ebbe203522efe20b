// Fence copy: an identity copy of a tensor into a new contiguous tensor.
//
// Replaces: det3d_tpu/kernels/fence_pallas.py `_copy_kernel` (through
// `s2b_fence` / `_fence_impl`). There the copy was an opaque custom call
// that kept a compiler pass out of the train graph; the train step wraps
// `cls_preds` in it, and the port's step does the same.
//
// What bounds it on the H100: memory. `cls_preds` at 20 cm, batch 2, bf16
// is 2 x 9 x 400 x 400 values, 5.76 MB read and 5.76 MB written: ~3.4 us at
// 3.35 TB/s. The source is a view into the head's channels-last output, 18
// useful bytes in every 180, so its reads touch ~1.5 32-byte sectors per
// pixel (~15 MB): no copy of that view goes under ~6.3 us from device memory.
//
// Design: the wrapper orders the iteration space by falling source stride
// (up to 6 axes; unit axes dropped, mergeable axes merged) and picks one of
// three kernels by the shape of the strides:
//   contiguous  one merged axis: 16 bytes per thread. The output of the
//               wrapper is 16-byte aligned; a source that is not (a storage
//               offset) is read in the widest pieces its address allows and
//               still stored as 16 bytes. The last numel % 16 bytes go one
//               by one.
//   transpose   the source's unit-stride run C (the 9 channels of
//               `cls_preds`; one or two axes, as in the head's (anchor, k)
//               `box_preds`) is not the output's unit-stride axis P (the
//               160 000 pixels). A block takes a tile of `tile` pixels x all
//               of C, reads it in source order (neighbouring threads on
//               neighbouring source elements, which keeps the reads at ~1.5
//               sectors per pixel; 8 loads in flight per thread, since the
//               view spans more than the L2 and most reads wait for device
//               memory), writes it into shared memory transposed,
//               rows padded to an odd number of 16-byte pieces so that the
//               C rows fall on different banks, and writes it out in output
//               order: for each c, `tile` consecutive pixels as 16-byte
//               stores, whole 128-byte lines instead of 2-byte pieces over 9
//               planes. The outer axes come from the block index: one
//               division per block and per 16-byte store, none per element.
//               A row whose start or tail is not 16-byte aligned falls back
//               to element stores inside the same kernel.
//   generic     anything else (sliced, stepped, rank 6): one element per
//               thread over the ordered iteration space, the writes merging
//               in the L2. This was the only kernel before the other two.
// Index arithmetic of the generic kernel is 32-bit where every offset fits.
// Every kernel moves bytes, so the result is bit-equal to
// `x.clone(memory_format=torch.contiguous_format)` for any dtype.
//
// Measured and dropped (NVIDIA H100 80GB HBM3, 700 W): `cls_preds` through
// the generic kernel, and a copy in the output's order, which reads every
// pixel's sector once per channel; PERF.md has the times.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRank = 6;
constexpr int kVecBytes = 16;
constexpr int kBatch = 8;  // loads a thread of the transpose kernel keeps in flight

struct Layout {  // the iteration space, outermost axis first
  int rank;
  int64_t sizes[kMaxRank];
  int64_t src[kMaxRank];  // source strides, in elements
  int64_t dst[kMaxRank];  // output strides, in elements
};

// --- contiguous: 16-byte stores, loads of Piece bytes ----------------------

template <typename Piece>
__global__ void __launch_bounds__(kThreads)
copy_contiguous(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst, int64_t vectors, int tail) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i < vectors) {
    constexpr int kPieces = kVecBytes / sizeof(Piece);
    Piece pieces[kPieces];
    const Piece* from = reinterpret_cast<const Piece*>(src + kVecBytes * i);
#pragma unroll
    for (int p = 0; p < kPieces; ++p) pieces[p] = from[p];
    uint4 v;
    memcpy(&v, pieces, kVecBytes);
    reinterpret_cast<uint4*>(dst)[i] = v;
  }
  if (blockIdx.x == 0 && threadIdx.x < tail) {
    dst[kVecBytes * vectors + threadIdx.x] = src[kVecBytes * vectors + threadIdx.x];
  }
}

cudaError_t launch_contiguous(const void* src, void* dst, int64_t bytes, cudaStream_t stream) {
  if (reinterpret_cast<uintptr_t>(dst) % kVecBytes != 0) return cudaErrorInvalidValue;
  const int64_t vectors = bytes / kVecBytes;
  const int tail = (int)(bytes % kVecBytes);
  const int64_t blocks = vectors == 0 ? 1 : (vectors + kThreads - 1) / kThreads;
  if (blocks > INT32_MAX) return cudaErrorInvalidValue;
  const uint8_t* s = static_cast<const uint8_t*>(src);
  uint8_t* d = static_cast<uint8_t*>(dst);
  const uintptr_t address = reinterpret_cast<uintptr_t>(src);
  const unsigned grid = (unsigned)blocks;
  if (address % 16 == 0) copy_contiguous<uint4><<<grid, kThreads, 0, stream>>>(s, d, vectors, tail);
  else if (address % 8 == 0) copy_contiguous<uint64_t><<<grid, kThreads, 0, stream>>>(s, d, vectors, tail);
  else if (address % 4 == 0) copy_contiguous<uint32_t><<<grid, kThreads, 0, stream>>>(s, d, vectors, tail);
  else if (address % 2 == 0) copy_contiguous<uint16_t><<<grid, kThreads, 0, stream>>>(s, d, vectors, tail);
  else copy_contiguous<uint8_t><<<grid, kThreads, 0, stream>>>(s, d, vectors, tail);
  return cudaGetLastError();
}

// --- transpose: (pixel, C) in the source, (C, pixel) in the output ----------

struct Transpose {
  int outer;                      // axes taken from the block index
  int64_t sizes[kMaxRank];        // of the outer axes
  int64_t src[kMaxRank];
  int64_t dst[kMaxRank];
  int64_t pixels;                 // P: output stride 1
  int64_t pixel_src;              // its source stride
  int run;                        // C = run0 * run1 source-contiguous elements per pixel
  int run1;                       // the inner axis of the run (C itself for a one-axis run)
  int64_t dst0, dst1;             // output strides of the run's two axes
  int tile;                       // pixels per block, a power of two
  int row;                        // elements per shared-memory row (tile + padding)
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
copy_transpose(const T* __restrict__ src, T* __restrict__ dst, Transpose plan) {
  extern __shared__ __align__(16) unsigned char shared[];
  T* tile = reinterpret_cast<T*>(shared);

  const int64_t tiles = (plan.pixels + plan.tile - 1) / plan.tile;
  int64_t rest = blockIdx.x;
  const int64_t p0 = (rest % tiles) * plan.tile;
  rest /= tiles;
  int64_t from = p0 * plan.pixel_src;
  int64_t to = p0;
  for (int d = plan.outer - 1; d >= 0; --d) {
    const int64_t q = rest / plan.sizes[d];
    const int64_t r = rest - q * plan.sizes[d];
    from += r * plan.src[d];
    to += r * plan.dst[d];
    rest = q;
  }
  const int np = (int)min((int64_t)plan.tile, plan.pixels - p0);  // pixels of this tile

  // in: source order, element i of the tile is (pixel i / C, channel i % C);
  // each thread steps by kThreads elements without dividing again, and has
  // kBatch loads in flight before it stores any of them
  const int C = plan.run;
  int p = threadIdx.x / C;
  int c = threadIdx.x - p * C;
  const int step_p = kThreads / C;
  const int step_c = kThreads - step_p * C;
  const int64_t step = step_p * plan.pixel_src + step_c;
  int64_t offset = from + p * plan.pixel_src + c;
  for (int i = threadIdx.x; i < np * C; i += kBatch * kThreads) {
    T value[kBatch];
    int slot[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      slot[u] = c * plan.row + p;
      if (i + u * kThreads < np * C) value[u] = src[offset];
      p += step_p;
      c += step_c;
      offset += step;
      if (c >= C) {
        c -= C;
        ++p;
        offset += plan.pixel_src - C;
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (i + u * kThreads < np * C) tile[slot[u]] = value[u];
    }
  }
  __syncthreads();

  // out: output order, 16 bytes of consecutive pixels of one channel a thread
  constexpr int kVec = kVecBytes / sizeof(T);
  const int vectors = plan.tile / kVec;  // per row; a power of two
  for (int i = threadIdx.x; i < C * vectors; i += kThreads) {
    const int cc = i / vectors;
    const int first = (i - cc * vectors) * kVec;
    if (first >= np) continue;
    const int c0 = cc / plan.run1;
    const int c1 = cc - c0 * plan.run1;
    T* out = dst + to + c0 * plan.dst0 + c1 * plan.dst1 + first;
    const T* in = tile + cc * plan.row + first;
    if (first + kVec <= np && reinterpret_cast<uintptr_t>(out) % kVecBytes == 0) {
      *reinterpret_cast<uint4*>(out) = *reinterpret_cast<const uint4*>(in);
    } else {
      for (int e = 0; e < kVec && first + e < np; ++e) out[e] = in[e];
    }
  }
}

template <typename T>
cudaError_t launch_transpose(const void* src, void* dst, const Layout& layout, int inner, int tile, int row,
                             cudaStream_t stream) {
  const int pixel_axis = layout.rank - inner - 1;
  if (inner < 1 || inner > 2 || pixel_axis < 0 || tile < kVecBytes || (tile & (tile - 1)) != 0 || row < tile ||
      (row * sizeof(T)) % kVecBytes != 0)
    return cudaErrorInvalidValue;
  Transpose plan;
  plan.outer = pixel_axis;
  int64_t blocks = 1;
  for (int d = 0; d < pixel_axis; ++d) {
    plan.sizes[d] = layout.sizes[d];
    plan.src[d] = layout.src[d];
    plan.dst[d] = layout.dst[d];
    blocks *= layout.sizes[d];
  }
  plan.pixels = layout.sizes[pixel_axis];
  plan.pixel_src = layout.src[pixel_axis];
  plan.run1 = (int)layout.sizes[layout.rank - 1];
  plan.dst1 = layout.dst[layout.rank - 1];
  plan.run = plan.run1;
  plan.dst0 = 0;
  if (inner == 2) {
    plan.run *= (int)layout.sizes[layout.rank - 2];
    plan.dst0 = layout.dst[layout.rank - 2];
  }
  plan.tile = tile;
  plan.row = row;
  blocks *= (plan.pixels + tile - 1) / tile;
  const size_t shared = (size_t)plan.run * row * sizeof(T);
  if (blocks > INT32_MAX || shared > 48 * 1024) return cudaErrorInvalidValue;
  copy_transpose<T><<<(unsigned)blocks, kThreads, shared, stream>>>(static_cast<const T*>(src),
                                                                    static_cast<T*>(dst), plan);
  return cudaGetLastError();
}

// --- generic: one element per thread ------------------------------------------

template <typename T, typename Index>
__global__ void __launch_bounds__(kThreads)
copy_strided(const T* __restrict__ src, T* __restrict__ dst, Index n, Layout layout) {
  for (Index i = (Index)blockIdx.x * kThreads + threadIdx.x; i < n; i += (Index)gridDim.x * kThreads) {
    Index rem = i;
    Index from = 0;
    Index to = 0;
    for (int d = layout.rank - 1; d >= 0; --d) {
      const Index size = (Index)layout.sizes[d];
      const Index q = rem / size;
      const Index r = rem - q * size;
      from += r * (Index)layout.src[d];
      to += r * (Index)layout.dst[d];
      rem = q;
    }
    dst[to] = src[from];
  }
}

unsigned grid_for(int64_t n) {
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  return (unsigned)(blocks < 132 * 32 ? blocks : 132 * 32);  // grid-stride beyond
}

template <typename T>
cudaError_t launch_strided(const void* src, void* dst, int64_t n, const Layout& layout,
                           cudaStream_t stream) {
  int64_t last = 0;  // the largest source offset (outputs end at n - 1)
  for (int d = 0; d < layout.rank; ++d) last += (layout.sizes[d] - 1) * layout.src[d];
  if (n <= INT32_MAX && last <= INT32_MAX)
    copy_strided<T, int32_t><<<grid_for(n), kThreads, 0, stream>>>(
        static_cast<const T*>(src), static_cast<T*>(dst), (int32_t)n, layout);
  else
    copy_strided<T, int64_t><<<grid_for(n), kThreads, 0, stream>>>(
        static_cast<const T*>(src), static_cast<T*>(dst), n, layout);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(int route, const void* src, void* dst, int64_t numel, const Layout& layout, int inner,
                   int tile, int row, cudaStream_t stream) {
  switch (route) {
    case 0: return launch_contiguous(src, dst, numel * (int64_t)sizeof(T), stream);
    case 1: return launch_transpose<T>(src, dst, layout, inner, tile, row, stream);
    case 2: return launch_strided<T>(src, dst, numel, layout, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Copy `numel` elements of `elem_bytes` (1, 2, 4 or 8) from `src` into
// `dst` over the iteration space of `rank` <= 6 axes with `sizes`, source
// strides `src_strides` and output strides `dst_strides` (host arrays, in
// elements; rank 0 is one element). `route` names the kernel: 0 contiguous
// (the layout is not read), 1 transpose (the last `inner` axes are the
// source's unit-stride run, the axis before them has output stride 1 and is
// cut into tiles of `tile` pixels held in shared-memory rows of `row`
// elements, the axes before that come from the block index), 2 generic.
// Device pointers; launched on `stream`. Returns the CUDA error (0 on
// success).
extern "C" int det3d_fence_copy(const void* src, void* dst, int64_t numel, int elem_bytes, int route,
                                int rank, const int64_t* sizes, const int64_t* src_strides,
                                const int64_t* dst_strides, int inner, int tile, int row,
                                void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (numel == 0) return 0;
  if (rank < 0 || rank > kMaxRank) return (int)cudaErrorInvalidValue;
  Layout layout;
  layout.rank = rank;
  for (int d = 0; d < rank; ++d) {
    layout.sizes[d] = sizes[d];
    layout.src[d] = src_strides[d];
    layout.dst[d] = dst_strides[d];
  }
  switch (elem_bytes) {
    case 1: return (int)launch<uint8_t>(route, src, dst, numel, layout, inner, tile, row, stream);
    case 2: return (int)launch<uint16_t>(route, src, dst, numel, layout, inner, tile, row, stream);
    case 4: return (int)launch<uint32_t>(route, src, dst, numel, layout, inner, tile, row, stream);
    case 8: return (int)launch<uint64_t>(route, src, dst, numel, layout, inner, tile, row, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

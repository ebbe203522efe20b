// Fence copy: an identity copy of a tensor into a new contiguous tensor.
//
// Replaces: det3d_tpu/kernels/fence_pallas.py `_copy_kernel` (through
// `s2b_fence` / `_fence_impl`). On the TPU the copy was an opaque custom
// call that kept XLA's space-to-batch pass out of the train graph; the
// train step wraps `cls_preds` in it, and the port's step does the same.
//
// What bounds it on the H100: memory. `cls_preds` at 20 cm, batch 2, bf16
// is 2 x 9 x 400 x 400 values, 5.76 MB read and 5.76 MB written: ~3.4 us at
// 3.35 TB/s.
//
// Design: the source, such as the head's `cls_preds` view into its
// channels-last output, is copied one element per thread over an
// iteration space that the wrapper orders by falling source stride (up to
// 6 axes; unit axes dropped, mergeable axes merged): neighbouring threads
// read neighbouring source elements, and the writes, scattered over the
// 5.76 MB output, merge in the L2. `cls_preds` becomes (b, pixel,
// channel): each warp reads ~4 pixels' 9 channels. (In the output's order
// every pixel's sector is read once per channel: 0.10 ms on the H100.)
// Index arithmetic is 32-bit where every offset fits. The copy moves
// bytes, so the result is bit-equal to `x.clone()` for any dtype.

#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRank = 6;

struct Layout {  // the iteration space, outermost axis first
  int rank;
  int64_t sizes[kMaxRank];
  int64_t src[kMaxRank];  // source strides, in elements
  int64_t dst[kMaxRank];  // output strides, in elements
};

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

}  // namespace

// Copy `numel` elements of `elem_bytes` (1, 2, 4 or 8) from `src` into
// `dst` over the iteration space of `rank` <= 6 axes with `sizes`, source
// strides `src_strides` and output strides `dst_strides` (host arrays, in
// elements; rank 0 is one element). Device pointers; launched on `stream`.
// Returns the CUDA error (0 on success).
extern "C" int det3d_fence_copy(const void* src, void* dst, int64_t numel, int elem_bytes,
                                int rank, const int64_t* sizes, const int64_t* src_strides,
                                const int64_t* dst_strides, void* stream_ptr) {
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
    case 1: return (int)launch_strided<uint8_t>(src, dst, numel, layout, stream);
    case 2: return (int)launch_strided<uint16_t>(src, dst, numel, layout, stream);
    case 4: return (int)launch_strided<uint32_t>(src, dst, numel, layout, stream);
    case 8: return (int)launch_strided<uint64_t>(src, dst, numel, layout, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

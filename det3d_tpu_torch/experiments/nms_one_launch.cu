// Greedy NMS in one launch, for measurement only: the mask tiles of
// `kernels/csrc/nms.cu`, and the sweep run by the last tile block of each
// class to finish. `experiments/kernel_redesigns.py` times it beside the
// two launches that the package makes. Nothing of the package launches it.
//
// Every block counts itself done on its class's counter after a
// __threadfence(); the block that takes the last count sets the counter
// back to 0 for the next call and sweeps with its first warp. The sweep's
// bulk copies read what other blocks wrote with ordinary stores, so a proxy
// fence goes before them. Every block of the grid has to be launched with
// the sweep's shared memory (128 KB at K = 1000), so one block runs per SM.

#include "../kernels/csrc/nms.cu"

namespace {

__global__ void __launch_bounds__(kMaskThreads)
tiles_then_sweep(const float* __restrict__ boxes, const uint8_t* __restrict__ valid,
                 uint8_t* __restrict__ keep, uint32_t* __restrict__ mask,
                 unsigned* __restrict__ done,  // (ncls,), zero before the first call
                 int K, int tiles, float thr) {
  extern __shared__ __align__(128) uint32_t rows[];
  __shared__ __align__(8) uint64_t arrived[kMaxK / kChunk];
  __shared__ bool last;

  const int cls = blockIdx.y;
  mask_tile(boxes, valid, mask, K, tiles, thr, blockIdx.x, cls);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&done[cls], 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  if (threadIdx.x == 0) done[cls] = 0;
  if (threadIdx.x < 32) {
    sweep_class(mask, valid, keep, K, 2 * tiles, cls, threadIdx.x, rows, arrived, [] {
      __threadfence();
      asm volatile("fence.proxy.async;\n" ::: "memory");
    });
  }
}

}  // namespace

// As det3d_nms_keep, in one launch; `done` (ncls,) uint32 zeros.
extern "C" int det3d_nms_one_launch(const void* boxes, const void* valid, void* keep, void* mask, void* done,
                                    int ncls, int K, float iou_threshold, void* stream_ptr) {
  if (K < 1 || K > kMaxK || ncls < 1 || ncls > 65535) return (int)cudaErrorInvalidValue;
  const int tiles = (K + kTile - 1) / kTile;
  const int chunks = (K + kChunk - 1) / kChunk;
  const size_t smem = (size_t)chunks * kChunkWords * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(tiles_then_sweep, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  tiles_then_sweep<<<dim3(tiles * (tiles + 1) / 2, ncls), kMaskThreads, smem, static_cast<cudaStream_t>(stream_ptr)>>>(
      static_cast<const float*>(boxes), static_cast<const uint8_t*>(valid), static_cast<uint8_t*>(keep),
      static_cast<uint32_t*>(mask), static_cast<unsigned*>(done), K, tiles, iou_threshold);
  return (int)cudaGetLastError();
}

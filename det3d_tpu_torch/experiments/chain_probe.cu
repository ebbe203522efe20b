// How long the sweep's register chain takes by itself, for measurement only:
// one warp runs `decide_row` of `kernels/csrc/nms.cu` on 32 words held in
// registers, `reps` x 32 rows, between two clock64() stamps. Held against the
// cycles per chunk that the whole sweep takes, it says how much of the sweep
// is the chain and how much the rest of the loop (loads, rotations, the OR of
// the kept rows), which a lone warp runs in turn with the chain.

#include "../kernels/csrc/nms.cu"

namespace {

__global__ void chain_alone(const uint32_t* __restrict__ words, uint32_t* __restrict__ out,
                            long long* __restrict__ cycles, int reps) {
  uint32_t e[kChunk];
#pragma unroll
  for (int b = 0; b < kChunk; ++b) e[b] = words[b * kRowWords + threadIdx.x];
  uint32_t x = words[threadIdx.x];
  __syncwarp();
  const long long start = clock64();
  for (int r = 0; r < reps; ++r) {
#pragma unroll
    for (int b = 0; b < kChunk; ++b) decide_row(x, e[b]);
  }
  const long long end = clock64();
  out[threadIdx.x] = x;  // keeps the chain alive
  if (threadIdx.x == 0) cycles[0] = end - start;
}

}  // namespace

// words: 32 x 32 uint32, out: 32 uint32, cycles: 1 int64; one warp.
extern "C" int det3d_chain_alone(const void* words, void* out, void* cycles, int reps, void* stream_ptr) {
  chain_alone<<<1, 32, 0, static_cast<cudaStream_t>(stream_ptr)>>>(
      static_cast<const uint32_t*>(words), static_cast<uint32_t*>(out), static_cast<long long*>(cycles), reps);
  return (int)cudaGetLastError();
}

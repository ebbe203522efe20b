// InstanceNorm (no affine, eps 1e-3) + ReLU over (H, W) of an NCHW map in
// channels_last memory: the RPN's 19 normalisation pairs of an inference frame.
//
// Replaces no Pallas kernel: on the TPU, XLA fuses these statistics into the
// producing convolution's epilogue (det3d_tpu/models/pointpillars.py
// `_instance_norm`); cuDNN cannot, so on this card the pair was seven passes of
// plain PyTorch over each map (a float32 copy, its square, two sums, two
// broadcast bf16 passes and the ReLU), about 34 bytes an element.
//
// What bounds it on the H100: memory. The work is one read of the map for the
// sums and one read and one write to normalise and rectify: 6 bytes an element
// in bf16, 0.83 GB over a 20 cm frame's 138 M elements, 0.25 ms at 3.35 TB/s.
// Most maps (5-41 MB) fit the 50 MB L2, so the second read mostly hits it.
//
// Design, three launches back to back on one stream:
//   in_stats     grid (tiles, B), 256 threads. Memory row r of sample b holds
//                its C channels contiguously; a thread owns 8 channels (16
//                bytes of bf16, 32 of float32) of every `groups`-th row of
//                its tile, 4 rows in flight, and keeps float32 Σx and Σx² in
//                registers. The block's groups meet in shared memory, summed
//                in a fixed order, and leave as one (2, C) partial per tile.
//                The wrapper picks the tiles (`norm_cuda.plan`) so that batch
//                1 and batch 4 both put several blocks on each SM.
//   in_finalize  grid (B, channel chunks), 32 channels x 32 slices of the
//                tiles. Each thread sums its slice of the partials in double,
//                the slices meet in a fixed order, and the channel's float32
//                sums give mean = Σx/n and inv = 1/sqrt(max(Σx²/n − mean², 0)
//                + 1e-3), the plain version's formula (`moments_from_sums`).
//                A packed map's chunk holds channels j and j + C/2, one
//                logical channel at even and odd columns, and merges them.
//   in_apply     grid (tiles, B), the rows as in_stats: 16-byte loads and
//                stores of max(r(r(x − r(mean)) · r(inv)), 0), where r rounds
//                to bf16 as the plain version's bf16 tensors do (float32: no
//                rounding). For equal statistics the output is bit-equal to
//                the plain version's.
// The second and third launch start early (programmatic dependent launch)
// and wait for the grid before them. No atomics: every sum has a fixed order,
// so a replay is bit-reproducible. Every partial and statistic is written
// before it is read, so the scratch needs no initialisation. Built with
// -fmad=false and IEEE division: the apply pass's two roundings stay two,
// and the statistics divide as the plain version does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;      // channels a thread owns
constexpr int kUnroll = 4;   // rows a thread has in flight
constexpr int kChunk = 32;   // channels of a finalize block
constexpr int kSlices = 32;  // slices of the tiles in a finalize block
constexpr int kMaxChannels = kThreads * kVec;

// --- 8 channels of one row ----------------------------------------------------

template <typename T>
struct Row;

template <>
struct Row<__nv_bfloat16> {
  uint4 raw;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) { raw = *reinterpret_cast<const uint4*>(p); }
  __device__ __forceinline__ void load_last(const __nv_bfloat16* p) { raw = __ldcs(reinterpret_cast<const uint4*>(p)); }
  __device__ __forceinline__ void unpack(float v[kVec]) const {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < kVec / 2; ++i) {
      float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p, const float v[kVec]) {
    uint4 out;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
    for (int i = 0; i < kVec / 2; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = out;
  }
  __device__ __forceinline__ static float round(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }
};

template <>
struct Row<float> {
  float4 raw[2];
  __device__ __forceinline__ void load(const float* p) {
    raw[0] = reinterpret_cast<const float4*>(p)[0];
    raw[1] = reinterpret_cast<const float4*>(p)[1];
  }
  __device__ __forceinline__ void load_last(const float* p) {
    raw[0] = __ldcs(reinterpret_cast<const float4*>(p));
    raw[1] = __ldcs(reinterpret_cast<const float4*>(p) + 1);
  }
  __device__ __forceinline__ void unpack(float v[kVec]) const {
    v[0] = raw[0].x; v[1] = raw[0].y; v[2] = raw[0].z; v[3] = raw[0].w;
    v[4] = raw[1].x; v[5] = raw[1].y; v[6] = raw[1].z; v[7] = raw[1].w;
  }
  __device__ __forceinline__ static void store(float* p, const float v[kVec]) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
  __device__ __forceinline__ static float round(float v) { return v; }
};

// The rows of a tile that thread (group, lane) visits: r0 + group, then every
// `groups`-th row below r1.
struct Span {
  int64_t r0, r1;
  int groups, group, lane;
  bool active;
};

__device__ __forceinline__ Span tile_span(int64_t rows, int c, int rows_per_tile) {
  Span s;
  const int lanes = c / kVec;
  s.groups = kThreads / lanes;
  s.group = threadIdx.x / lanes;
  s.lane = threadIdx.x % lanes;
  s.active = s.group < s.groups;
  s.r0 = (int64_t)blockIdx.x * rows_per_tile;
  s.r1 = s.r0 + rows_per_tile < rows ? s.r0 + rows_per_tile : rows;
  return s;
}

// --- pass 1: per-tile sums ----------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
in_stats(const T* __restrict__ x, float* __restrict__ partial, int64_t rows, int c, int rows_per_tile) {
  __shared__ float sums[2][kMaxChannels];
  const Span s = tile_span(rows, c, rows_per_tile);
  float s1[kVec], s2[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) s1[k] = s2[k] = 0.f;
  if (s.active) {
    const T* base = x + (int64_t)blockIdx.y * rows * c + s.lane * kVec;
    int64_t r = s.r0 + s.group;
    for (; r + (int64_t)(kUnroll - 1) * s.groups < s.r1; r += (int64_t)kUnroll * s.groups) {
      Row<T> in[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) in[u].load(base + (r + (int64_t)u * s.groups) * c);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float v[kVec];
        in[u].unpack(v);
#pragma unroll
        for (int k = 0; k < kVec; ++k) {
          s1[k] += v[k];
          s2[k] += v[k] * v[k];
        }
      }
    }
    for (; r < s.r1; r += s.groups) {
      Row<T> in;
      in.load(base + r * c);
      float v[kVec];
      in.unpack(v);
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        s1[k] += v[k];
        s2[k] += v[k] * v[k];
      }
    }
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      sums[0][s.group * c + s.lane * kVec + k] = s1[k];
      sums[1][s.group * c + s.lane * kVec + k] = s2[k];
    }
  }
  __syncthreads();
  float* out = partial + ((int64_t)blockIdx.y * gridDim.x + blockIdx.x) * 2 * c;
  for (int ch = threadIdx.x; ch < c; ch += kThreads) {
    float a = 0.f, q = 0.f;
    for (int g = 0; g < s.groups; ++g) {
      a += sums[0][g * c + ch];
      q += sums[1][g * c + ch];
    }
    out[ch] = a;
    out[c + ch] = q;
  }
}

// --- finalize: the tiles' sums → mean and inv ---------------------------------

// The channel of slot `slot` (0..31) of chunk `chunk`: 32 consecutive
// channels, or for a packed map 16 logical channels j and their partners
// j + C/2. -1 past the end.
__device__ __forceinline__ int chunk_channel(int chunk, int slot, int c, int packed) {
  if (!packed) {
    const int ch = chunk * kChunk + slot;
    return ch < c ? ch : -1;
  }
  const int half = c / 2, j = chunk * (kChunk / 2) + slot % (kChunk / 2);
  return j < half ? j + (slot < kChunk / 2 ? 0 : half) : -1;
}

__global__ void __launch_bounds__(kChunk * kSlices)
in_finalize(const float* __restrict__ partial, float* __restrict__ stats, int tiles, int c, int64_t n, int packed) {
  cudaGridDependencySynchronize();  // the partials of in_stats
  __shared__ double sums[2][kSlices][kChunk];
  const int slot = threadIdx.x % kChunk, slice = threadIdx.x / kChunk, b = blockIdx.x;
  const int ch = chunk_channel(blockIdx.y, slot, c, packed);
  double a = 0.0, q = 0.0;
  if (ch >= 0) {
    const float* p = partial + (int64_t)b * tiles * 2 * c + ch;
#pragma unroll 8
    for (int t = slice; t < tiles; t += kSlices) {
      a += (double)p[(int64_t)t * 2 * c];
      q += (double)p[(int64_t)t * 2 * c + c];
    }
  }
  sums[0][slice][slot] = a;
  sums[1][slice][slot] = q;
  __syncthreads();
  if (slice == 0) {
    for (int i = 1; i < kSlices; ++i) {
      a += sums[0][i][slot];
      q += sums[1][i][slot];
    }
    sums[0][0][slot] = a;
    sums[1][0][slot] = q;
  }
  __syncthreads();
  if (slice != 0 || ch < 0) return;
  float count = (float)n;
  if (packed) {  // slots s and s + 16 hold channels j and j + C/2
    const int j = slot % (kChunk / 2);
    a = sums[0][0][j] + sums[0][0][j + kChunk / 2];
    q = sums[1][0][j] + sums[1][0][j + kChunk / 2];
    count = (float)(2 * n);
  }
  const float s1 = (float)a, s2 = (float)q;
  const float mean = s1 / count;
  const float var = fmaxf(s2 / count - mean * mean, 0.f);
  float* out = stats + (int64_t)b * 2 * c;
  out[ch] = mean;
  out[c + ch] = 1.f / sqrtf(var + 1e-3f);
}

// --- pass 2: normalise and rectify ---------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
in_apply(const T* __restrict__ x, const float* __restrict__ stats, T* __restrict__ y, int64_t rows, int c,
         int rows_per_tile) {
  cudaGridDependencySynchronize();  // the statistics of in_finalize
  const Span s = tile_span(rows, c, rows_per_tile);
  if (!s.active) return;
  const float* st = stats + (int64_t)blockIdx.y * 2 * c + s.lane * kVec;
  float mean[kVec], inv[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    mean[k] = Row<T>::round(st[k]);
    inv[k] = Row<T>::round(st[c + k]);
  }
  const int64_t offset = (int64_t)blockIdx.y * rows * c + s.lane * kVec;
  const T* src = x + offset;
  T* dst = y + offset;
  auto emit = [&](const Row<T>& in, int64_t r) {
    float v[kVec];
    in.unpack(v);
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const float p = Row<T>::round(Row<T>::round(v[k] - mean[k]) * inv[k]);
      v[k] = p < 0.f ? 0.f : p;  // torch.relu: NaN passes
    }
    Row<T>::store(dst + r * c, v);
  };
  int64_t r = s.r0 + s.group;
  for (; r + (int64_t)(kUnroll - 1) * s.groups < s.r1; r += (int64_t)kUnroll * s.groups) {
    Row<T> in[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) in[u].load_last(src + (r + (int64_t)u * s.groups) * c);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) emit(in[u], r + (int64_t)u * s.groups);
  }
  for (; r < s.r1; r += s.groups) {
    Row<T> in;
    in.load_last(src + r * c);
    emit(in, r);
  }
}

template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, dim3 grid, int threads, bool early, cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t config = {};
  config.gridDim = grid;
  config.blockDim = dim3(threads);
  config.stream = stream;
  cudaLaunchAttribute attribute[1];
  attribute[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attribute[0].val.programmaticStreamSerializationAllowed = 1;
  config.attrs = attribute;
  config.numAttrs = early ? 1 : 0;
  cudaError_t err = cudaLaunchKernelEx(&config, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T>
cudaError_t run(const void* x, void* y, float* partial, float* stats, int B, int64_t rows, int c, int tiles,
                int rows_per_tile, int packed, int parts, cudaStream_t stream) {
  const T* in = static_cast<const T*>(x);
  cudaError_t err = cudaSuccess;
  if (parts & 1) {
    in_stats<T><<<dim3(tiles, B), kThreads, 0, stream>>>(in, partial, rows, c, rows_per_tile);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const int chunks = packed ? (c / 2 + kChunk / 2 - 1) / (kChunk / 2) : (c + kChunk - 1) / kChunk;
    err = launch(in_finalize, dim3(B, chunks), kChunk * kSlices, true, stream, (const float*)partial, stats, tiles,
                 c, rows, packed);
    if (err != cudaSuccess) return err;
  }
  if (parts & 2) {
    err = launch(in_apply<T>, dim3(tiles, B), kThreads, (parts & 1) != 0, stream, in, (const float*)stats,
                 static_cast<T*>(y), rows, c, rows_per_tile);
  }
  return err;
}

}  // namespace

// x, y: (B, rows, C) in memory (an NCHW map in channels_last memory, rows =
// H·W), bf16 (elt_bytes 2) or float32 (4), 16-byte aligned; partial: (B,
// tiles, 2, C) float32 scratch; stats: (B, 2, C) float32, mean then inv.
// parts: 1 the statistics into `stats`, 2 the output from `stats`, 3 both.
extern "C" int det3d_in_relu(const void* x, void* y, void* partial, void* stats, int B, int64_t rows, int c,
                             int elt_bytes, int tiles, int rows_per_tile, int packed, int parts, void* stream_ptr) {
  if (B < 1 || B > 65535 || rows < 1 || c < kVec || c % kVec || c > kMaxChannels || tiles < 1 ||
      rows_per_tile < 1 || (int64_t)tiles * rows_per_tile < rows || (packed && c % (2 * kVec)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  float* p = static_cast<float*>(partial);
  float* s = static_cast<float*>(stats);
  if (elt_bytes == 2)
    return (int)run<__nv_bfloat16>(x, y, p, s, B, rows, c, tiles, rows_per_tile, packed, parts, stream);
  if (elt_bytes == 4) return (int)run<float>(x, y, p, s, B, rows, c, tiles, rows_per_tile, packed, parts, stream);
  return (int)cudaErrorInvalidValue;
}

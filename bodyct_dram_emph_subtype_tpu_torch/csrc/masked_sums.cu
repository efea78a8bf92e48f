// Kernel F: lung-masked sums over NDHWC volumes.
//
//   num[b, c] = sum over voxels v of dense[b, v, c] * lung[b, v]
//   den[b]    = sum over voxels v of lung[b, v]
//
// float32 dense (B, D, H, W, C) and lung (B, D, H, W, 1), contiguous;
// float32 num (B, C) and den (B,).  C <= 127 (the TPU kernel's limit: C + 1
// sums in one 128-lane row).
//
// Replaces the Pallas TPU kernel
//   bodyct_dram_emph_subtype_tpu/ops/pallas_kernels.py:46 masked_sums_pallas
//       (pallas_call at :52; lung_masked_fraction_pallas at :69 divides)
// which streams (H, W) slices over a sequential (B, D) grid and accumulates
// the C + 1 sums of a sample in one output row that every grid step
// revisits.
//
// Design: Hopper blocks run in parallel and in no order, so nothing can
// carry that row from block to block.  A grid of (S, B) blocks cuts each
// sample's voxels into S contiguous ranges.  A block's threads stride over
// its range keeping float32 partials in registers; the block reduces them
// in a fixed order (warp shuffles, then shared memory) and writes one row
// of C + 1 partials into a [B, S, C + 1] workspace that the wrapper
// allocates through torch.  A second launch sums each sample's S rows in
// order.  No atomics: two runs give the same bits, so a lesion percentage
// does not move from run to run.  The lung sum adds 0/1 values, exact
// while a sample has fewer than 2^24 voxels.
//
// Two block loops:
//  - C = 1, 2 or 4 (the dRAM maps have C = 2): 16-byte loads of dense, each
//    holding 4 / C whole voxels, beside one load of their 4 / C lung values;
//    every thread keeps all C + 1 partials;
//  - any other C: thread t owns channel t % C of voxel lane t / C, so a warp
//    reads consecutive floats of dense; one partial per thread, and the
//    threads of channel 0 also sum the lung.
//
// What bounds it on the H100: every input byte is read once for one
// multiply-add, so memory: (C + 1) * 4 bytes per voxel over 3.35 TB/s.
// Offsets are 64-bit.
#include "common.cuh"

namespace dram {
namespace {

constexpr int MT = 256;      // threads per block
constexpr int kMaxC = 127;

struct SumArgs {
  const float* dense;  // (B, N, C)
  const float* lung;   // (B, N)
  float* ws;           // (B, S, C + 1) partial rows
  int64_t N;           // voxels per sample
  int C;
  int64_t chunk;       // voxels per range, a multiple of 4
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum K per-thread partials over the block in a fixed order and write them
// to out[0..K).
template <int K>
__device__ __forceinline__ void block_sum_store(const float (&acc)[K],
                                                float* out) {
  __shared__ float red[MT / 32][K];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const float v = warp_sum(acc[j]);
    if (lane == 0) red[warp][j] = v;
  }
  __syncthreads();
  if (threadIdx.x < K) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < MT / 32; ++w) s += red[w][threadIdx.x];
    out[threadIdx.x] = s;
  }
}

// C in {1, 2, 4}; needs N % (4 / C) == 0 and 16-byte aligned dense.
template <int C>
__global__ void __launch_bounds__(MT) masked_sums_vec(SumArgs a) {
  constexpr int VPL = 4 / C;  // voxels per 16-byte load
  const int b = blockIdx.y;
  const int64_t v0 = (int64_t)blockIdx.x * a.chunk;
  const int64_t v1 = v0 + a.chunk < a.N ? v0 + a.chunk : a.N;
  const float* __restrict__ dense = a.dense + (int64_t)b * a.N * C;
  const float* __restrict__ lung = a.lung + (int64_t)b * a.N;
  float acc[C + 1];
#pragma unroll
  for (int j = 0; j <= C; ++j) acc[j] = 0.f;
  // v0, v1 and N are multiples of VPL, so no load straddles the range end
#pragma unroll 4
  for (int64_t v = v0 + (int64_t)threadIdx.x * VPL; v < v1;
       v += (int64_t)MT * VPL) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(dense + v * C));
    const float xs[4] = {x.x, x.y, x.z, x.w};
    float l[VPL];
    if constexpr (VPL == 4) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(lung + v));
      l[0] = q.x; l[1] = q.y; l[2] = q.z; l[3] = q.w;
    } else if constexpr (VPL == 2) {
      const float2 q = __ldg(reinterpret_cast<const float2*>(lung + v));
      l[0] = q.x; l[1] = q.y;
    } else {
      l[0] = __ldg(lung + v);
    }
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
#pragma unroll
      for (int c = 0; c < C; ++c) acc[c] = fmaf(xs[k * C + c], l[k], acc[c]);
      acc[C] += l[k];
    }
  }
  block_sum_store<C + 1>(acc, a.ws + ((int64_t)b * gridDim.x + blockIdx.x) *
                                         (C + 1));
}

// Any C <= kMaxC: thread t sums channel t % C over voxel lane t / C.
__global__ void __launch_bounds__(MT) masked_sums_any(SumArgs a) {
  __shared__ float part[MT];
  __shared__ float lpart[MT];
  const int C = a.C;
  const int lanes = MT / C;  // voxels per step
  const int t = threadIdx.x;
  const int c = t % C, lane = t / C;
  const int b = blockIdx.y;
  const int64_t v0 = (int64_t)blockIdx.x * a.chunk;
  const int64_t v1 = v0 + a.chunk < a.N ? v0 + a.chunk : a.N;
  const float* __restrict__ dense = a.dense + (int64_t)b * a.N * C;
  const float* __restrict__ lung = a.lung + (int64_t)b * a.N;
  float acc = 0.f, lacc = 0.f;
  if (lane < lanes) {
    for (int64_t v = v0 + lane; v < v1; v += lanes) {
      const float l = __ldg(lung + v);
      acc = fmaf(__ldg(dense + v * C + c), l, acc);
      if (c == 0) lacc += l;
    }
  }
  part[t] = acc;
  lpart[t] = lacc;
  __syncthreads();
  float* out = a.ws + ((int64_t)b * gridDim.x + blockIdx.x) * (C + 1);
  if (t < C) {
    float s = 0.f;
    for (int g = 0; g < lanes; ++g) s += part[g * C + t];
    out[t] = s;
  } else if (t == C) {
    float s = 0.f;
    for (int g = 0; g < lanes; ++g) s += lpart[g * C];
    out[C] = s;
  }
}

// num[b, j] (j < C) and den[b] (j == C): the S rows of sample b summed in
// order s = 0..S-1.
__global__ void sum_rows_kernel(const float* __restrict__ ws,
                                float* __restrict__ num,
                                float* __restrict__ den, int B, int S, int C) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * (C + 1)) return;
  const int b = i / (C + 1), j = i % (C + 1);
  const float* row = ws + (int64_t)b * S * (C + 1) + j;
  float s = 0.f;
  for (int k = 0; k < S; ++k) s += row[(int64_t)k * (C + 1)];
  if (j < C)
    num[b * C + j] = s;
  else
    den[b] = s;
}

}  // namespace
}  // namespace dram

extern "C" int masked_sums(const float* dense, const float* lung, float* ws,
                           float* num, float* den, int B, int D, int H, int W,
                           int C, int S, void* stream) {
  using namespace dram;
  if (B <= 0 || B > 65535 || D <= 0 || H <= 0 || W <= 0 || C <= 0 ||
      C > kMaxC || S <= 0 || S > 65535 || ws == nullptr)
    return (int)cudaErrorInvalidValue;
  const int64_t N = (int64_t)D * H * W;
  const int64_t per = (N + S - 1) / S;
  SumArgs a{dense, lung, ws, N, C, (per + 3) / 4 * 4};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)S, (unsigned)B);
  const bool aligned = reinterpret_cast<uintptr_t>(dense) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(lung) % 16 == 0;
  const bool vec = aligned && (C == 1 || C == 2 || C == 4) &&
                   N % (4 / C) == 0;
  if (vec && C == 1)
    masked_sums_vec<1><<<grid, MT, 0, s>>>(a);
  else if (vec && C == 2)
    masked_sums_vec<2><<<grid, MT, 0, s>>>(a);
  else if (vec)
    masked_sums_vec<4><<<grid, MT, 0, s>>>(a);
  else
    masked_sums_any<<<grid, MT, 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n = B * (C + 1);
  sum_rows_kernel<<<(n + 127) / 128, 128, 0, s>>>(ws, num, den, B, S, C);
  return (int)cudaGetLastError();
}

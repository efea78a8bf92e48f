// Kernel F: lung-masked sums over NDHWC volumes.
//
//   num[b, c] = sum over voxels v of dense[b, v, c] * lung[b, v]
//   den[b]    = sum over voxels v of lung[b, v]
//
// float32 or bfloat16 dense (B, D, H, W, C) and float32 lung (B, D, H, W, 1),
// contiguous; float32 num (B, C) and den (B,).  C <= 127 (the TPU kernel's
// limit: C + 1 sums in one 128-lane row).  A bf16 map is read as bf16 and
// widened in registers: the same products as a float32 copy, since the
// widening is exact.
//
// Replaces the Pallas TPU kernel
//   bodyct_dram_emph_subtype_tpu/ops/pallas_kernels.py:46 masked_sums_pallas
//       (pallas_call at :52; lung_masked_fraction_pallas at :69 divides)
// which streams (H, W) slices over a sequential (B, D) grid and accumulates
// the C + 1 sums of a sample in one output row that every grid step
// revisits.
//
// What bounds it on the H100: every input byte is read once for one
// multiply-add, so memory: C * sizeof(dense) + 4 bytes per voxel over
// 3.35 TB/s (7.4 us for a (2, 64, 112, 144, 2) float32 map).
//
// Design: one launch per call.  Hopper blocks run in parallel and in no
// order, so nothing can carry that row from block to block.  A grid of
// (S, B) blocks, kBlocksPerSM per SM (one wave on the card: the wrapper's
// masked_sums_splits sizes S), cuts each sample's voxels into S contiguous
// ranges.  A block's threads stride over its range with kUnroll independent
// 16-byte loads in flight before their FMAs (half as many where a load
// holds 8 voxels), keep float32 partials in registers, reduce them in a
// fixed order (warp shuffles, then shared memory) and write one row of
// C + 1 partials into a [B, S, C + 1] workspace.  Of the grids tried on an
// H100 (2 blocks of 8 loads per SM, 4 of 4, 8 of 2) this one ran fastest;
// what is left above the bound is a fixed cost per call: the launch, the
// election and the final sum, each one or two L2 round trips.  Then the "last block done" pattern: each block fences its row
// and takes a ticket of its sample with atomicInc; the block that draws the
// last ticket sums the S rows of that sample, thread t a fixed subset of
// rows in a fixed order, then a fixed pairwise tree in shared memory.  The
// atomic only elects that block, it adds no value, so two runs give the
// same bits whichever block finishes first and a lesion percentage does not
// move from run to run.  atomicInc wraps the ticket back to 0 on the last
// draw, so a call leaves its tickets as it found them (the wrapper keeps
// one zeroed ticket array per device and stream, and calls on one stream
// run in order).  The lung sum adds 0/1 values, exact while a sample has
// fewer than 2^24 voxels.
//
// Two block loops:
//  - C = 1, 2 or 4 (the dRAM maps have C = 2), 16-byte aligned inputs and
//    a voxel count that whole loads tile: 16-byte loads of dense, each
//    holding 16 / (C * sizeof(dense)) whole voxels, beside one or two loads
//    of their lung values; every thread keeps all C + 1 partials;
//  - anything else (other C, a ragged voxel count, a misaligned view):
//    thread t owns channel t % C of voxel lane t / C, so a warp reads
//    consecutive elements of dense; one partial per thread and one lung
//    sum, of which channel 0's are kept.
// Offsets are 64-bit.
#include "common.cuh"

namespace dram {
namespace {

constexpr int MT = 256;            // threads per block
constexpr int kBlocksPerSM = 2;    // resident blocks per SM the grid plans
constexpr int kUnroll = 8;         // independent loads in flight per thread
constexpr int kChunkAlign = 8;     // voxels: a range is whole 16-byte loads
constexpr int kMaxC = 127;

template <typename T>
struct SumArgs {
  const T* dense;       // (B, N, C)
  const float* lung;    // (B, N)
  float* ws;            // (B, S, C + 1) partial rows
  unsigned* tickets;    // (B,) zero between calls
  float* num;           // (B, C)
  float* den;           // (B,)
  int64_t N;            // voxels per sample
  int C;
  int64_t chunk;        // voxels per range, a multiple of kChunkAlign
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

// Add the g rows of the [g][K] table t (shared memory, g * K <= MT) into
// its row 0 in a fixed pairwise order: row i takes row i + ceil(n / 2)
// while n rows remain.  Needs a barrier before; ends with one.
__device__ __forceinline__ void fold_rows(float* t, int K, int g) {
  for (int n = g; n > 1;) {
    const int half = (n + 1) >> 1;
    for (int i = threadIdx.x; i < (n - half) * K; i += MT)
      t[i] += t[i + half * K];
    __syncthreads();
    n = half;
  }
}

// The last-block election: after the block's row is stored, true in the
// one block of sample b that drew the last of the S tickets (and the
// ticket is back at 0).
__device__ __forceinline__ bool last_of_sample(unsigned* ticket) {
  __shared__ bool last;
  __threadfence();     // this block's row is visible before its ticket
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicInc(ticket, gridDim.x - 1) == gridDim.x - 1;
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// A float32 load from L2 (the coherence point of the card) that the
// compiler keeps after the election's fence.
__device__ __forceinline__ float load_l2(const float* p) {
  float v;
  asm volatile("ld.global.cg.f32 %0, [%1];" : "=f"(v) : "l"(p) : "memory");
  return v;
}

// The final sum of sample b in its last block: thread t owns column
// j = t % K and sums rows t / K, t / K + g, ... (g = MT / K) in that order,
// read from L2 (other blocks wrote them); then fold_rows.
template <typename T>
__device__ void final_sum(const SumArgs<T>& a, int b) {
  __shared__ float part[MT];
  const int K = a.C + 1, g = MT / K, t = threadIdx.x, S = gridDim.x;
  const float* rows = a.ws + (int64_t)b * S * K;
  if (t < g * K) {
    float s = 0.f;
#pragma unroll 4
    for (int r = t / K; r < S; r += g)
      s += load_l2(rows + (int64_t)r * K + t % K);
    part[t] = s;
  }
  __syncthreads();
  fold_rows(part, K, g);
  if (t < a.C)
    a.num[(int64_t)b * a.C + t] = part[t];
  else if (t == a.C)
    a.den[b] = part[t];
}

// 16 bytes of dense: loaded raw, widened to float32 where they are used.
template <typename T>
struct Vec16 {
  static constexpr int kN = 16 / sizeof(T);
  static __device__ __forceinline__ void widen(const uint4& q,
                                               float (&x)[kN]) {
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
    if constexpr (sizeof(T) == 4) {
#pragma unroll
      for (int i = 0; i < 4; ++i) x[i] = __uint_as_float(w[i]);
    } else {
      // a bf16 is the high half of the float32 of the same value (exact)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        x[2 * i] = __uint_as_float(w[i] << 16);
        x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
      }
    }
  }
};

// VPL consecutive float32 lung values, VPL in {1, 2, 4, 8}, aligned.
template <int VPL>
__device__ __forceinline__ void load_lung(const float* p, float (&l)[VPL]) {
  if constexpr (VPL >= 4) {
#pragma unroll
    for (int i = 0; i < VPL; i += 4) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(p + i));
      l[i] = q.x; l[i + 1] = q.y; l[i + 2] = q.z; l[i + 3] = q.w;
    }
  } else if constexpr (VPL == 2) {
    const float2 q = __ldg(reinterpret_cast<const float2*>(p));
    l[0] = q.x; l[1] = q.y;
  } else {
    l[0] = __ldg(p);
  }
}

// C in {1, 2, 4}; needs N % (16 / (C * sizeof(T))) == 0 and 16-byte
// aligned dense and lung.
template <typename T, int C>
__global__ void __launch_bounds__(MT, kBlocksPerSM)
masked_sums_vec(SumArgs<T> a) {
  constexpr int kN = Vec16<T>::kN;
  constexpr int VPL = kN / C;                 // voxels per 16-byte load
  constexpr int64_t kStep = (int64_t)MT * VPL;
  constexpr int U = VPL > 4 ? kUnroll / 2 : kUnroll;  // <= 32 lung values
  const int b = blockIdx.y;
  const int64_t v0 = (int64_t)blockIdx.x * a.chunk;
  const int64_t v1 = v0 + a.chunk < a.N ? v0 + a.chunk : a.N;
  const T* __restrict__ dense = a.dense + (int64_t)b * a.N * C;
  const float* __restrict__ lung = a.lung + (int64_t)b * a.N;
  float acc[C + 1];
#pragma unroll
  for (int j = 0; j <= C; ++j) acc[j] = 0.f;
  // v0, v1 and N are multiples of VPL, so no load straddles the range end;
  // a load past it is skipped and adds zeros
  for (int64_t base = v0 + (int64_t)threadIdx.x * VPL; base < v1;
       base += U * kStep) {
    uint4 raw[U];
    float l[U][VPL];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t v = base + u * kStep;
      if (v < v1) {
        raw[u] = __ldg(reinterpret_cast<const uint4*>(dense + v * C));
        load_lung<VPL>(lung + v, l[u]);
      } else {
        raw[u] = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
        for (int k = 0; k < VPL; ++k) l[u][k] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float x[kN];
      Vec16<T>::widen(raw[u], x);
#pragma unroll
      for (int k = 0; k < VPL; ++k) {
#pragma unroll
        for (int c = 0; c < C; ++c)
          acc[c] = fmaf(x[k * C + c], l[u][k], acc[c]);
        acc[C] += l[u][k];
      }
    }
  }
  block_sum_store<C + 1>(
      acc, a.ws + ((int64_t)b * gridDim.x + blockIdx.x) * (C + 1));
  if (last_of_sample(a.tickets + b)) final_sum(a, b);
}

// Any C <= kMaxC, any alignment and voxel count: thread t sums channel
// t % C over voxel lane t / C.
template <typename T>
__global__ void __launch_bounds__(MT, kBlocksPerSM)
masked_sums_any(SumArgs<T> a) {
  __shared__ float part[MT];
  __shared__ float lpart[MT];
  const int C = a.C;
  const int lanes = MT / C;  // voxels per step
  const int t = threadIdx.x;
  const int c = t % C, lane = t / C;
  const int b = blockIdx.y;
  const int64_t v0 = (int64_t)blockIdx.x * a.chunk;
  const int64_t v1 = v0 + a.chunk < a.N ? v0 + a.chunk : a.N;
  const T* __restrict__ dense = a.dense + (int64_t)b * a.N * C;
  const float* __restrict__ lung = a.lung + (int64_t)b * a.N;
  float acc = 0.f, lacc = 0.f;
  if (lane < lanes) {
    for (int64_t base = v0 + lane; base < v1; base += kUnroll * lanes) {
      float x[kUnroll], l[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t v = base + (int64_t)u * lanes;
        const bool in = v < v1;
        x[u] = in ? to_f32(__ldg(dense + v * C + c)) : 0.f;
        l[u] = in ? __ldg(lung + v) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        acc = fmaf(x[u], l[u], acc);
        lacc += l[u];
      }
    }
  }
  part[t] = acc;
  lpart[t] = lacc;
  __syncthreads();
  fold_rows(part, C, lanes);
  fold_rows(lpart, C, lanes);
  float* out = a.ws + ((int64_t)b * gridDim.x + blockIdx.x) * (C + 1);
  if (t < C)
    out[t] = part[t];
  else if (t == C)
    out[C] = lpart[0];
  if (last_of_sample(a.tickets + b)) final_sum(a, b);
}

template <typename T>
int launch(const SumArgs<T>& a, int B, int S, cudaStream_t s) {
  const dim3 grid((unsigned)S, (unsigned)B);
  constexpr int kN = Vec16<T>::kN;
  const bool aligned = reinterpret_cast<uintptr_t>(a.dense) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(a.lung) % 16 == 0;
  const bool vec = aligned && (a.C == 1 || a.C == 2 || a.C == 4) &&
                   a.N % (kN / a.C) == 0;
  if (vec && a.C == 1)
    masked_sums_vec<T, 1><<<grid, MT, 0, s>>>(a);
  else if (vec && a.C == 2)
    masked_sums_vec<T, 2><<<grid, MT, 0, s>>>(a);
  else if (vec)
    masked_sums_vec<T, 4><<<grid, MT, 0, s>>>(a);
  else
    masked_sums_any<T><<<grid, MT, 0, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace dram

extern "C" int masked_sums(int dtype, const void* dense, const float* lung,
                           float* ws, unsigned* tickets, float* num,
                           float* den, int B, int D, int H, int W, int C,
                           int S, void* stream) {
  using namespace dram;
  if (B <= 0 || B > 65535 || D <= 0 || H <= 0 || W <= 0 || C <= 0 ||
      C > kMaxC || S <= 0 || S > 65535 || ws == nullptr ||
      tickets == nullptr || (dtype != kF32 && dtype != kBF16))
    return (int)cudaErrorInvalidValue;
  const int64_t N = (int64_t)D * H * W;
  const int64_t per = (N + S - 1) / S;
  const int64_t chunk = (per + kChunkAlign - 1) / kChunkAlign * kChunkAlign;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return launch(SumArgs<float>{static_cast<const float*>(dense), lung, ws,
                                 tickets, num, den, N, C, chunk},
                  B, S, s);
  return launch(SumArgs<__nv_bfloat16>{
                    static_cast<const __nv_bfloat16*>(dense), lung, ws,
                    tickets, num, den, N, C, chunk},
                B, S, s);
}

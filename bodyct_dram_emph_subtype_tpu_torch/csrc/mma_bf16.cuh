// The bfloat16 tensor-core main loop shared by kernels A and B
// (conv3x3x3.cu) and D (conv3x3x3_wgrad.cu): a block tile of float32
// accumulators in registers over a K loop in steps of BK = 32 elements.
//
// - Operands reach shared memory through a ring of STAGES = 4 stages.  Each
//   thread issues 16-byte cp.async.cg copies, zero-filled through
//   src_size = 0 where the chunk lies outside the operand (conv padding,
//   rows past M, channels past C, voxels past a split's range; the source
//   address stays a valid one), or, where a 16-byte copy cannot be used
//   (C or O not a multiple of 8, an unaligned tensor), stores 8 values it
//   gathered with plain loads.  One commit group per step:
//   cp.async.wait_group STAGES-2 leaves the next steps in flight while the
//   block computes on the oldest, and one __syncthreads per step both
//   publishes that stage and frees the one the next copy overwrites.
// - 8 warps each own a warp tile of the block tile.  A K step is two
//   mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 per 16 x 8
//   fragment, fed by ldmatrix.x4 (.trans where the stored tile is K-major:
//   always for B, and for A in kernel D).
// - Tiles are XOR-swizzled by 16-byte chunk, so the eight rows that one
//   ldmatrix phase reads fall into eight different bank groups.
//
// Not here yet: wgmma (warpgroup MMA reading shared memory through
// descriptors) fed by TMA, the card's full tensor-core rate.
#pragma once

#include "common.cuh"

namespace dram {
namespace mma {

constexpr int BK = 32;      // K elements per step: two k16 MMAs
constexpr int STAGES = 4;   // cp.async ring depth
constexpr int NT = 256;     // threads per block: 8 warps
constexpr int PROMOTE_STEPS = 64;   // K steps per WarpTile::promote

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, or 16 zero bytes when !valid (src is not read
// then, but must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The 16 bits of one bf16 in device memory.
__device__ __forceinline__ uint32_t bits(const bf16* p) {
  return __bfloat16_as_ushort(*p);
}

// One 16-byte chunk of 8 bf16 into shared memory; get(e) gives the bits of
// element e (0 for a zero).
template <typename Get>
__device__ __forceinline__ void store8(bf16* dst, Get get) {
  uint4 u;
  u.x = get(0) | (get(1) << 16);
  u.y = get(2) | (get(3) << 16);
  u.z = get(4) | (get(5) << 16);
  u.w = get(6) | (get(7) << 16);
  *reinterpret_cast<uint4*>(dst) = u;
}

// Element offset of 16-byte chunk `chunk` of row `row` in a tile whose
// rows hold NC chunks.  NC = 4 (an M x 32 tile): the chunk is XORed with
// (row / 2) % 4, so rows r..r+7 of one chunk cover the 8 bank groups of a
// 128-byte line; NC >= 8: XORed with row % 8.
template <int NC>
__device__ __forceinline__ int swz(int row, int chunk) {
  if constexpr (NC == 4)
    return row * 32 + ((chunk ^ ((row >> 1) & 3)) << 3);
  else
    return row * NC * 8 + ((chunk ^ (row & 7)) << 3);
}

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// c += a (16 x 16, row) * b (16 x 8, col), float32 accumulators.
__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4],
                                          const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One warp's share of a BM x BN block tile: WARPS_M x WARPS_N warps, each
// (BM / WARPS_M) x (BN / WARPS_N) as MI x NI fragments of 16 x 8.  A stage
// holds A as BM x BK (row = m, K contiguous; A_KMAJOR: BK x BM, M
// contiguous) and B as BK x BN (N contiguous).
template <int BM, int BN, int WARPS_M, int WARPS_N, bool A_KMAJOR>
struct WarpTile {
  static_assert(WARPS_M * WARPS_N * 32 == NT, "8 warps per block");
  static constexpr int WM = BM / WARPS_M;
  static constexpr int WN = BN / WARPS_N;
  static constexpr int MI = WM / 16;
  static constexpr int NI = WN / 8;
  static_assert(WM % 16 == 0 && WN % 16 == 0, "whole ldmatrix.x4 tiles");
  static constexpr int NACC = MI * NI * 4;   // accumulators per thread

  float acc[MI][NI][4];
  int wm0, wn0, lane;

  __device__ __forceinline__ WarpTile() {
    const int warp = threadIdx.x >> 5;
    lane = threadIdx.x & 31;
    wm0 = (warp % WARPS_M) * WM;
    wn0 = (warp / WARPS_M) * WN;
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
  }

  // Block-tile row and column of acc[mi][ni][2 * half + j]: the m16n8
  // fragment holds rows lane/4 (+8 for half 1), columns 2*(lane%4) + j.
  __device__ __forceinline__ int row(int mi, int half) const {
    return wm0 + mi * 16 + (lane >> 2) + half * 8;
  }
  __device__ __forceinline__ int col(int ni, int j) const {
    return wn0 + ni * 8 + 2 * (lane & 3) + j;
  }

  // Two-level accumulation for long K loops.  mma.sync adds its products
  // into the float32 accumulator with truncation, so over thousands of
  // steps the sum drifts by about one float32 ulp per MMA.  Every
  // PROMOTE_STEPS steps promote() adds
  // the accumulators into this thread's running float32 sum in shared
  // memory (NACC floats at stride NT from sum + threadIdx.x, which no other
  // thread touches: no barrier) with rounding to nearest, and restarts
  // them from zero; finish() adds the sum back.  The order is fixed, so
  // reruns stay bit-equal.
  __device__ __forceinline__ void promote(float* sum) {
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float* p = sum + ((mi * NI + ni) * 4 + e) * NT + threadIdx.x;
          *p += acc[mi][ni][e];
          acc[mi][ni][e] = 0.f;
        }
  }
  __device__ __forceinline__ void finish(const float* sum) {
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[mi][ni][e] += sum[((mi * NI + ni) * 4 + e) * NT + threadIdx.x];
  }

  // One BK step on the stage (As, Bs).
  __device__ __forceinline__ void step(const bf16* As, const bf16* Bs) {
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      uint32_t a[MI][4], b[NI][2];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        if constexpr (A_KMAJOR) {
          // matrices (m 0-7 | 8-15) x (k 0-7 | 8-15), stored k-major
          const int k = ks * 16 + ((lane >> 4) << 3) + (lane & 7);
          const int chunk = (wm0 + mi * 16) / 8 + ((lane >> 3) & 1);
          ldsm_x4_trans(a[mi], As + swz<BM / 8>(k, chunk));
        } else {
          const int r = wm0 + mi * 16 + (lane & 15);
          ldsm_x4(a[mi], As + swz<BK / 8>(r, ks * 2 + (lane >> 4)));
        }
      }
#pragma unroll
      for (int nj = 0; nj < NI / 2; ++nj) {
        // matrices (k 0-7 | 8-15) x (n 0-7 | 8-15) of two n8 fragments
        const int k = ks * 16 + (((lane >> 3) & 1) << 3) + (lane & 7);
        const int chunk = (wn0 + nj * 16) / 8 + (lane >> 4);
        uint32_t r[4];
        ldsm_x4_trans(r, Bs + swz<BN / 8>(k, chunk));
        b[2 * nj][0] = r[0];
        b[2 * nj][1] = r[1];
        b[2 * nj + 1][0] = r[2];
        b[2 * nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) mma_16816(acc[mi][ni], a[mi], b[ni]);
    }
  }
};

// The ring over nsteps K steps: load(stage) fills the next step in order
// (steps 0, 1, 2, ...), compute(stage) consumes one.  Every thread of the
// block calls it.  On return every copy has landed and every thread has
// finished computing, so the caller may reuse the ring's shared memory.
template <typename Load, typename Compute>
__device__ __forceinline__ void ring(int nsteps, Load load, Compute compute) {
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nsteps) load(s);
    cp_async_commit();
  }
  for (int step = 0; step < nsteps; ++step) {
    cp_async_wait<STAGES - 2>();   // this thread's copies of `step` landed
    __syncthreads();               // everyone's; and step - 1 is consumed
    const int next = step + STAGES - 1;
    if (next < nsteps) load(next % STAGES);
    cp_async_commit();
    compute(step % STAGES);
  }
  cp_async_wait_all();
  __syncthreads();
}

// Let `kernel` take `bytes` of dynamic shared memory (above 48 KB only by
// this attribute).  A refusal is returned, and cleared from the runtime's
// last error so that it does not surface at a later launch.
template <typename Kernel>
cudaError_t allow_smem(Kernel* kernel, int bytes) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) cudaGetLastError();
  return err;
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace mma
}  // namespace dram

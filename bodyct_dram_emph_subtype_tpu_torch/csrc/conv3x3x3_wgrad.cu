// Kernel D: weight gradient of the 3x3x3 stride-1 pad-1 convolution on
// NDHWC activations.
//
//   dW[kd,kh,kw,c,o] = sum_{b,d,h,w} x[b,d+kd-1,h+kh-1,w+kw-1,c] * g[b,d,h,w,o]
//
// with x read as zero outside the volume (the conv padding).  float32 or
// bfloat16 x and g; accumulates and writes float32 (3,3,3,C,O).
//
// Replaces the Pallas TPU kernel
//   bodyct_dram_emph_subtype_tpu/ops/roll_conv.py:682 roll_conv_wgrad
//       (pallas_call at :718, called from roll_conv_packed's VJP at :820)
// which sweeps a rolling ring of W-pair packed input planes and keeps one
// persistent (3,3,KB*2C,2O) float32 accumulator in VMEM across its whole
// sequential grid.
//
// Design: a GEMM with a small output, M = 27*C rows (tap, channel) by
// N = O, and a huge reduction over K = B*D*H*W voxels (258 k at layer1,
// 2.06 M at the half-resolution decoder for B=2).  Hopper blocks run in
// parallel and in no order, so nothing can carry an accumulator from
// block to block the way the TPU grid does.  K is split instead: block
// (i, j, s) owns rows [128i, 128i+128) of 27*C, output channels
// [64j, 64j+64) and the s-th contiguous range of voxels (a multiple of WK
// long).  Each block writes its partial into a [S, 27*C, O] workspace that
// the wrapper allocates through torch, and a second launch sums the S
// partials in a fixed order, so two runs give the same bits (no float
// atomics).  With S = 1 the first launch writes the result directly.  A
// block whose range is short or empty still writes its whole tile.
//
// What bounds it on the H100: 2 FLOP per x-g voxel pair and 27*C*O pairs
// per voxel, so, like the forward conv, it is bound by arithmetic, on the
// bf16 tensor cores.
//
// bfloat16: the tensor-core loop of mma_bf16.cuh.  Per K step of 32
// voxels, cp.async copies the x taps of the block's rows for those voxels
// (a 16-byte chunk is 8 channels of one tap of one voxel, zero-filled
// outside the volume and past the range's end, so the ring never reads
// beyond it) as a voxel-major [32][128] tile, and the 32 rows of g as a
// [32][64] tile; both reach the MMAs through ldmatrix.trans.  Each thread
// keeps the (d, h, w) of its two voxels and steps them by 32, so the
// gather needs no division in the loop.  With C % 8 != 0 the x chunks are
// gathered with plain loads, each of the 8 rows at its own tap; with
// O % 8 != 0 likewise for g.  mma.sync truncates as it accumulates, which
// over a range's thousands of steps would drift past the float32 check
// (2.7e-4 of the peak at 229 k voxels, measured), so every 64 steps the
// accumulators are promoted into a float32 sum kept in shared memory.  All
// sums run in a fixed order, so reruns stay bit-equal.
//
// float32: an FMA loop on the CUDA cores (an 8 x 4 micro tile in float32
// registers per thread); the tensor cores would round float32 operands to
// TF32 and break the 5e-5 of the peak that the float32 check holds.
//
// Waits for a later step: wgmma fed by TMA.  The TPU kernel's W-pair
// packed parity blocks and their fold back onto logical taps are a lane
// layout and are not carried over.  Offsets are 64-bit.
#include "common.cuh"
#include "mma_bf16.cuh"

namespace dram {
namespace {

constexpr int WM = 128;  // rows of 27*C per block
constexpr int WN = 64;   // output channels per block
constexpr int WK = 32;   // voxels per K step; a split's range is a multiple
constexpr int FK = 16;   // voxels per step of the float32 FMA loop
constexpr int WT = 256;  // float32: 16 x 16 threads, each an 8 x 4 micro tile
static_assert(WK == mma::BK && WK % FK == 0, "ranges suit both loops");

struct WgradArgs {
  const void* x;   // (B, D, H, W, C) T
  const void* g;   // (B, D, H, W, O) T
  float* out;      // (S, 27*C, O) float32 partials (or the result at S = 1)
  int B, D, H, W, C, O;
  int64_t chunk;   // voxels per split, a multiple of WK
};

// ---------------------------------------------------------------------------
// float32: the CUDA-core FMA loop.

template <bool VEC>
__global__ void __launch_bounds__(WT) wgrad_f32_kernel(WgradArgs a) {
  __shared__ __align__(16) float As[FK][WM];  // x taps, voxel-major
  __shared__ __align__(16) float Bs[FK][WN];  // g rows, voxel-major

  const float* __restrict__ x = static_cast<const float*>(a.x);
  const float* __restrict__ g = static_cast<const float*>(a.g);
  const int tid = threadIdx.x;
  const int R = 27 * a.C;
  const int64_t M = (int64_t)a.B * a.D * a.H * a.W;
  const int r0 = blockIdx.x * WM;
  const int n0 = blockIdx.y * WN;
  const int64_t k_begin = (int64_t)blockIdx.z * a.chunk;
  const int64_t k_end = k_begin + a.chunk < M ? k_begin + a.chunk : M;

  // load role: one voxel of the K step, 8 rows of x and 4 channels of g
  const int lk = tid >> 4;
  const int lr = (tid & 15) * 8;
  const int lc = (tid & 15) * 4;
  // the (kd, kh, kw, c) of each of this thread's 8 rows is fixed
  int tap_d[8], tap_h[8], tap_w[8], chan[8];
  bool row_ok[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int r = r0 + lr + j;
    row_ok[j] = r < R;
    const int tap = row_ok[j] ? r / a.C : 0;
    chan[j] = row_ok[j] ? r - tap * a.C : 0;
    tap_d[j] = tap / 9 - 1;
    tap_h[j] = (tap / 3) % 3 - 1;
    tap_w[j] = tap % 3 - 1;
  }
  // compute role: rows ty*8.., output channels tx*4..
  const int ty = tid >> 4;
  const int tx = tid & 15;

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int64_t k0 = k_begin; k0 < k_end; k0 += FK) {
    const int64_t m = k0 + lk;
    const bool m_ok = m < k_end;
    int vd = 0, vh = 0, vw = 0;
    int64_t vb = 0;
    if (m_ok) {
      int64_t q = m;
      vw = (int)(q % a.W); q /= a.W;
      vh = (int)(q % a.H); q /= a.H;
      vd = (int)(q % a.D); vb = q / a.D;
    }
    float v[8];
    if (VEC) {
      // C % 8 == 0: the 8 rows are 8 consecutive channels of one tap
      const int id = vd + tap_d[0], ih = vh + tap_h[0], iw = vw + tap_w[0];
      const bool in_vol = m_ok && row_ok[0] && id >= 0 && id < a.D &&
                          ih >= 0 && ih < a.H && iw >= 0 && iw < a.W;
      if (in_vol) {
        const float* p = x + (((vb * a.D + id) * a.H + ih) * (int64_t)a.W +
                              iw) * (int64_t)a.C + chan[0];
        const float4 u0 = *reinterpret_cast<const float4*>(p);
        const float4 u1 = *reinterpret_cast<const float4*>(p + 4);
        v[0] = u0.x; v[1] = u0.y; v[2] = u0.z; v[3] = u0.w;
        v[4] = u1.x; v[5] = u1.y; v[6] = u1.z; v[7] = u1.w;
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = 0.f;
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int id = vd + tap_d[j], ih = vh + tap_h[j], iw = vw + tap_w[j];
        const bool in_vol = m_ok && row_ok[j] && id >= 0 && id < a.D &&
                            ih >= 0 && ih < a.H && iw >= 0 && iw < a.W;
        v[j] = in_vol ? x[(((vb * a.D + id) * a.H + ih) * (int64_t)a.W + iw) *
                              (int64_t)a.C + chan[j]]
                      : 0.f;
      }
    }
    *reinterpret_cast<float4*>(&As[lk][lr]) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(&As[lk][lr + 4]) =
        make_float4(v[4], v[5], v[6], v[7]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int o = n0 + lc + j;
      Bs[lk][lc + j] = (m_ok && o < a.O) ? g[m * a.O + o] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < FK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[k][ty * 8]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[k][ty * 8 + 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[4] = {b0.x, b0.y, b0.z, b0.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  // every block writes its whole tile (zeros for an empty voxel range), so
  // the reduction reads S complete partials
  float* out = a.out + (int64_t)blockIdx.z * R * a.O;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = r0 + ty * 8 + i;
    if (r >= R) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int o = n0 + tx * 4 + j;
      if (o < a.O) out[(int64_t)r * a.O + o] = acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16: the tensor-core loop of mma_bf16.cuh.

using WgradWarp = mma::WarpTile<WM, WN, 4, 2, true>;
constexpr int kRingBytes =
    mma::STAGES * (WK * WM + WK * WN) * (int)sizeof(__nv_bfloat16);
// After the ring: every thread's running float32 sum (WarpTile::promote).
constexpr int kSmemBytes =
    kRingBytes + WgradWarp::NACC * mma::NT * (int)sizeof(float);

// A voxel of the range as a linear index and its (d, h, w), stepped
// forward without division.
struct Voxel {
  int64_t m;
  int d, h, w;

  __device__ __forceinline__ void set(int64_t idx, const WgradArgs& a) {
    m = idx;
    int64_t q = idx;
    w = (int)(q % a.W); q /= a.W;
    h = (int)(q % a.H); q /= a.H;
    d = (int)(q % a.D);
  }
  __device__ __forceinline__ void advance(int n, const WgradArgs& a) {
    m += n;
    w += n;
    while (w >= a.W) {
      w -= a.W;
      if (++h == a.H) {
        h = 0;
        if (++d == a.D) d = 0;
      }
    }
  }
};

// VA: 16-byte cp.async copies of x (C % 8 == 0, x 16-byte aligned), else
// plain loads; VB: the same for g (O % 8 == 0, g aligned).
template <bool VA, bool VB>
__global__ void __launch_bounds__(mma::NT, 2) wgrad_mma_kernel(WgradArgs a) {
  using bf16 = __nv_bfloat16;
  using Warp = WgradWarp;
  constexpr int A_ELEMS = WK * WM;
  constexpr int STAGE = A_ELEMS + WK * WN;
  extern __shared__ uint4 smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);

  const bf16* __restrict__ x = static_cast<const bf16*>(a.x);
  const bf16* __restrict__ g = static_cast<const bf16*>(a.g);
  const int tid = threadIdx.x;
  const int R = 27 * a.C;
  const int64_t M = (int64_t)a.B * a.D * a.H * a.W;
  const int r0 = blockIdx.x * WM;
  const int n0 = blockIdx.y * WN;
  const int64_t k_begin = (int64_t)blockIdx.z * a.chunk;
  const int64_t k_end = k_begin + a.chunk < M ? k_begin + a.chunk : M;
  const int nsteps =
      k_end > k_begin ? (int)((k_end - k_begin + WK - 1) / WK) : 0;

  // x role: a fixed chunk of 8 of the block's rows, for voxels kv and
  // kv + 16 of each step; the tap offsets and channel of each row
  const int a_chunk = tid & 15;
  const int a_kv = tid >> 4;
  int tap_d[8], tap_h[8], tap_w[8], chan[8];
  bool row_ok[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int r = r0 + a_chunk * 8 + e;
    row_ok[e] = r < R;
    const int tap = row_ok[e] ? r / a.C : 0;
    chan[e] = row_ok[e] ? r - tap * a.C : 0;
    tap_d[e] = tap / 9 - 1;
    tap_h[e] = (tap / 3) % 3 - 1;
    tap_w[e] = tap % 3 - 1;
  }
  // the voxel offset of tap e's input from its output voxel
  auto delta = [&](int e) {
    return ((int64_t)tap_d[e] * a.H + tap_h[e]) * a.W + tap_w[e];
  };
  const int64_t delta0 = delta(0);
  Voxel vox[2];
  vox[0].set(k_begin + a_kv, a);
  vox[1].set(k_begin + a_kv + 16, a);
  // g role: one voxel of the step, one chunk of 8 output channels
  const int b_kv = tid >> 3;
  const int b_chunk = tid & 7;
  int64_t l_k0 = k_begin;   // first voxel of the step to load next

  auto in_vol = [&](const Voxel& v, int e) {
    const int id = v.d + tap_d[e], ih = v.h + tap_h[e], iw = v.w + tap_w[e];
    return v.m < k_end && row_ok[e] && id >= 0 && id < a.D && ih >= 0 &&
           ih < a.H && iw >= 0 && iw < a.W;
  };

  auto load = [&](int stage) {
    bf16* As = smem + stage * STAGE;
    bf16* Bs = As + A_ELEMS;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      Voxel& v = vox[j];
      bf16* dst = As + mma::swz<WM / 8>(a_kv + 16 * j, a_chunk);
      if constexpr (VA) {
        // C % 8 == 0: the 8 rows are 8 consecutive channels of one tap
        const bool ok = in_vol(v, 0);
        mma::cp_async16(dst, ok ? x + (v.m + delta0) * a.C + chan[0] : x, ok);
      } else {
        mma::store8(dst, [&](int e) {
          return in_vol(v, e) ? mma::bits(x + (v.m + delta(e)) * a.C + chan[e])
                              : 0u;
        });
      }
      v.advance(WK, a);
    }
    const int64_t m = l_k0 + b_kv;
    const int o = n0 + b_chunk * 8;
    bf16* dst = Bs + mma::swz<WN / 8>(b_kv, b_chunk);
    const bf16* src = g + m * a.O + o;
    if constexpr (VB) {
      const bool ok = m < k_end && o < a.O;
      mma::cp_async16(dst, ok ? src : g, ok);
    } else {
      mma::store8(dst, [&](int e) {
        return m < k_end && o + e < a.O ? mma::bits(src + e) : 0u;
      });
    }
    l_k0 += WK;
  };

  // a range holds up to ~230 k voxels: the MMAs' truncating sums are
  // promoted to a float32 sum every PROMOTE_STEPS steps (2048 voxels)
  Warp t;
  float* sum = reinterpret_cast<float*>(smem + mma::STAGES * STAGE);
#pragma unroll
  for (int e = 0; e < Warp::NACC; ++e) sum[e * mma::NT + tid] = 0.f;
  int done = 0;
  mma::ring(nsteps, load, [&](int stage) {
    const bf16* As = smem + stage * STAGE;
    t.step(As, As + A_ELEMS);
    if (++done % mma::PROMOTE_STEPS == 0) t.promote(sum);
  });
  t.finish(sum);

  // every block writes its whole tile (zeros for an empty voxel range), so
  // the reduction reads S complete partials
  float* out = a.out + (int64_t)blockIdx.z * R * a.O;
  const bool pair = a.O % 2 == 0;   // then r * O + o is even for an even o
#pragma unroll
  for (int mi = 0; mi < Warp::MI; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + t.row(mi, half);
      if (r >= R) continue;
#pragma unroll
      for (int ni = 0; ni < Warp::NI; ++ni) {
        const int o = n0 + t.col(ni, 0);
        if (o >= a.O) continue;
        float* p = out + (int64_t)r * a.O + o;
        const float v0 = t.acc[mi][ni][2 * half];
        const float v1 = t.acc[mi][ni][2 * half + 1];
        if (pair) {
          *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
        } else {
          p[0] = v0;
          if (o + 1 < a.O) p[1] = v1;
        }
      }
    }
}

// out[i] = sum over s = 0..S-1 of ws[s][i], in that order
__global__ void sum_partials_kernel(const float* __restrict__ ws,
                                    float* __restrict__ out, int64_t n,
                                    int S) {
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < S; ++k) s += ws[(int64_t)k * n + i];
    out[i] = s;
  }
}

template <bool VA, bool VB>
cudaError_t launch_mma(const WgradArgs& a, dim3 grid, cudaStream_t stream) {
  auto* kernel = wgrad_mma_kernel<VA, VB>;
  const cudaError_t err = mma::allow_smem(kernel, kSmemBytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, mma::NT, kSmemBytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_wgrad(WgradArgs a, float* ws, float* out, int S,
                         cudaStream_t stream) {
  const int64_t M = (int64_t)a.B * a.D * a.H * a.W;
  const int64_t per = (M + S - 1) / S;
  a.chunk = (per + WK - 1) / WK * WK;
  a.out = S == 1 ? out : ws;
  const dim3 grid((unsigned)((27 * a.C + WM - 1) / WM),
                  (unsigned)((a.O + WN - 1) / WN), (unsigned)S);
  cudaError_t err;
  if constexpr (sizeof(T) == 4) {
    // 128-bit gathers need every voxel row 16-byte aligned
    if (a.C % 8 == 0 && mma::aligned16(a.x))
      wgrad_f32_kernel<true><<<grid, WT, 0, stream>>>(a);
    else
      wgrad_f32_kernel<false><<<grid, WT, 0, stream>>>(a);
    err = cudaGetLastError();
  } else {
    const bool va = a.C % 8 == 0 && mma::aligned16(a.x);
    const bool vb = a.O % 8 == 0 && mma::aligned16(a.g);
    err = va && vb ? launch_mma<true, true>(a, grid, stream)
          : va     ? launch_mma<true, false>(a, grid, stream)
          : vb     ? launch_mma<false, true>(a, grid, stream)
                   : launch_mma<false, false>(a, grid, stream);
  }
  if (err != cudaSuccess || S == 1) return err;
  const int64_t n = (int64_t)27 * a.C * a.O;
  const int64_t blocks = (n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096;
  sum_partials_kernel<<<(unsigned)blocks, 256, 0, stream>>>(ws, out, n, S);
  return cudaGetLastError();
}

}  // namespace
}  // namespace dram

extern "C" int conv3x3x3_wgrad(int dtype, const void* x, const void* g,
                               float* ws, float* out, int B, int D, int H,
                               int W, int C, int O, int S, void* stream) {
  using namespace dram;
  if (B <= 0 || D <= 0 || H <= 0 || W <= 0 || C <= 0 || O <= 0 || S <= 0 ||
      S > 65535 || (S > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  WgradArgs a{x, g, nullptr, B, D, H, W, C, O, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return (int)launch_wgrad<float>(a, ws, out, S, s);
  if (dtype == kBF16) return (int)launch_wgrad<__nv_bfloat16>(a, ws, out, S, s);
  return (int)cudaErrorInvalidValue;
}

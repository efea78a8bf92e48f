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
// Design: a GEMM with a small output, (27*C) x O, and a huge reduction over
// K = B*D*H*W voxels (258 k at layer1, 2.06 M at the half-resolution
// decoder for B=2).  Hopper blocks run in parallel and in no order, so
// nothing can carry an accumulator from block to block the way the TPU grid
// does.  K is split instead: block (i, j, s) owns rows [128i, 128i+128) of
// 27*C, output channels [64j, 64j+64) and the s-th contiguous range of
// voxels.  Per K step it gathers 16 voxels' taps of x into shared memory
// (the tap of each row is fixed per thread; rows outside the volume read as
// zero, exactly as kernel A gathers its input rows), the 16 matching rows of
// g beside them, and each thread accumulates an 8 x 4 micro tile in float32
// registers.  Each block writes its partial into a [S, 27*C, O] workspace
// that the wrapper allocates through torch, and a second launch sums the S
// partials in a fixed order, so two runs give the same bits (no float
// atomics).  With S = 1 the first launch writes the result directly.
//
// What bounds it on the H100: 2 FLOP per x-g voxel pair and 27*C*O pairs
// per voxel, so, like the forward conv, it is bound by arithmetic; this
// first version runs the FMAs on the CUDA cores in float32 (no tensor
// cores, TMA or wgmma yet).  The TPU kernel's W-pair packed parity blocks
// and their fold back onto logical taps are a lane layout and are not
// carried over.  Offsets are 64-bit.
#include "common.cuh"

namespace dram {
namespace {

constexpr int WM = 128;  // rows of 27*C per block
constexpr int WN = 64;   // output channels per block
constexpr int WK = 16;   // voxels per K step
constexpr int WT = 256;  // 16 x 16 threads, each an 8 x 4 micro tile

struct WgradArgs {
  const void* x;   // (B, D, H, W, C) T
  const void* g;   // (B, D, H, W, O) T
  float* out;      // (S, 27*C, O) float32 partials (or the result at S = 1)
  int B, D, H, W, C, O;
  int64_t chunk;   // voxels per split, a multiple of WK
};

template <typename T, bool VEC>
__global__ void __launch_bounds__(WT) wgrad_kernel(WgradArgs a) {
  __shared__ __align__(16) float As[WK][WM];  // x taps, voxel-major
  __shared__ __align__(16) float Bs[WK][WN];  // g rows, voxel-major

  const T* __restrict__ x = static_cast<const T*>(a.x);
  const T* __restrict__ g = static_cast<const T*>(a.g);
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

  for (int64_t k0 = k_begin; k0 < k_end; k0 += WK) {
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
        const T* p = x + (((vb * a.D + id) * a.H + ih) * (int64_t)a.W + iw) *
                             (int64_t)a.C + chan[0];
        if constexpr (sizeof(T) == 4) {
          const float4 u0 = *reinterpret_cast<const float4*>(p);
          const float4 u1 = *reinterpret_cast<const float4*>(p + 4);
          v[0] = u0.x; v[1] = u0.y; v[2] = u0.z; v[3] = u0.w;
          v[4] = u1.x; v[5] = u1.y; v[6] = u1.z; v[7] = u1.w;
        } else {
          const uint4 u = *reinterpret_cast<const uint4*>(p);
          const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float2 f = __bfloat1622float2(h2[j]);
            v[2 * j] = f.x;
            v[2 * j + 1] = f.y;
          }
        }
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
        v[j] = in_vol ? to_f32(x[(((vb * a.D + id) * a.H + ih) *
                                      (int64_t)a.W + iw) * (int64_t)a.C +
                                 chan[j]])
                      : 0.f;
      }
    }
    *reinterpret_cast<float4*>(&As[lk][lr]) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(&As[lk][lr + 4]) =
        make_float4(v[4], v[5], v[6], v[7]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int o = n0 + lc + j;
      Bs[lk][lc + j] = (m_ok && o < a.O) ? to_f32(g[m * a.O + o]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < WK; ++k) {
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

template <typename T>
cudaError_t launch_wgrad(WgradArgs a, float* ws, float* out, int S,
                         cudaStream_t stream) {
  const int64_t M = (int64_t)a.B * a.D * a.H * a.W;
  const int64_t per = (M + S - 1) / S;
  a.chunk = (per + WK - 1) / WK * WK;
  a.out = S == 1 ? out : ws;
  const dim3 grid((unsigned)((27 * a.C + WM - 1) / WM),
                  (unsigned)((a.O + WN - 1) / WN), (unsigned)S);
  // 128-bit gathers need every voxel row 16-byte aligned
  const bool vec = (a.C % 8 == 0) &&
                   (reinterpret_cast<uintptr_t>(a.x) % 16 == 0);
  if (vec)
    wgrad_kernel<T, true><<<grid, WT, 0, stream>>>(a);
  else
    wgrad_kernel<T, false><<<grid, WT, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
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

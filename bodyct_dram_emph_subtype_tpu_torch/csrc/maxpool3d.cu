// Kernel C: 3-D max-pool, kernel 3, stride 2, padding 1 (-inf padding), on
// NDHWC activations.
//
// Replaces the Pallas TPU kernel
//   bodyct_dram_emph_subtype_tpu/ops/maxpool_kernel.py:161 max_pool_quads
//       (via max_pool_k3s2p1_pallas, :205)
// and the pool stage of
//   bodyct_dram_emph_subtype_tpu/ops/layer1_kernel.py:388
//       _fused_pool_layer1_quadview (the port runs this kernel, then the
//       block stack of fused_layer1).
//
// What bounds it on the H100: one max per input element read, and an
// output an eighth of the input: memory, at best the input's and the
// output's bytes over HBM bandwidth.  Max is exact, so the result equals
// the plain version bit for bit.
//
// Design (the vector path: C a multiple of 8 bf16 or 4 float32 values and
// 16-byte aligned tensors, every activation of the model):
// - A thread owns one 16-byte vector of channels (8 bf16 or 4 float32) of
//   one output column (ho, wo) and walks a range of KD output planes along
//   D, so the block derives its coordinates once and the walk has no
//   division.  Consecutive threads take consecutive vectors, then
//   consecutive wo: a warp's loads of one window tap are whole 128-byte
//   lines.
// - The max is separable.  Each input D-plane's 3 x 3 (H, W) window max is
//   computed once, from nine 16-byte loads whose H/W overlap with the
//   neighbouring columns is served from L1; output plane p takes the max of
//   planes 2p - 1, 2p and 2p + 1, and the odd plane 2p + 1 is kept in
//   registers for plane p + 1.  So each input plane is read from memory
//   once per range (the first plane of a range, 2p0 - 1, twice).
// - Padding: a window index below 0 or past the end is clamped to the
//   nearest index inside the volume, which is inside the same window
//   (k3 s2 p1 windows always hold their centre), so the duplicate leaves
//   the max unchanged and no -inf is needed.
// - bf16 maxima are taken on pairs (__hmax2) without widening.
// The scalar path (C not a multiple of the vector, or an unaligned tensor;
// ragged test shapes only) keeps one thread per output element.
// The TPU kernel's quad-lane W view, its depth-plane ring and its bitcast
// lane rolls exist for the TPU's 128-lane vector registers and VMEM and are
// not carried over.
#include <math.h>
#include <string.h>

#include "common.cuh"

namespace dram {
namespace {

constexpr int kThreads = 256;
constexpr int kPlanes = 8;       // output D-planes per thread's walk (KD)

// Lane-wise max of two 16-byte vectors of T.
template <typename T>
__device__ __forceinline__ uint32_t max32(uint32_t x, uint32_t y) {
  if constexpr (sizeof(T) == 4) {
    return __float_as_uint(fmaxf(__uint_as_float(x), __uint_as_float(y)));
  } else {
    __nv_bfloat162 a, b;
    memcpy(&a, &x, 4);
    memcpy(&b, &y, 4);
    const __nv_bfloat162 r = __hmax2(a, b);
    uint32_t u;
    memcpy(&u, &r, 4);
    return u;
  }
}

template <typename T>
__device__ __forceinline__ uint4 vmax(uint4 a, uint4 b) {
  return make_uint4(max32<T>(a.x, b.x), max32<T>(a.y, b.y),
                    max32<T>(a.z, b.z), max32<T>(a.w, b.w));
}

// Vector path: grid (ceil(Ho*Wo*CV / kThreads), ceil(Do / kPlanes), B).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    max_pool3d_vec_kernel(const T* __restrict__ x, T* __restrict__ out, int D,
                          int H, int W, int C, int Do, int Ho, int Wo) {
  constexpr int VEC = 16 / sizeof(T);
  const int CV = C / VEC;
  const int q = blockIdx.x * kThreads + threadIdx.x;
  if (q >= Ho * Wo * CV) return;
  const int cv = q % CV;
  const int wo = (q / CV) % Wo;
  const int ho = q / CV / Wo;
  const int b = blockIdx.z;
  const int p0 = blockIdx.y * kPlanes;
  const int p1 = min(p0 + kPlanes, Do);
  // the nine in-plane offsets of the window, clamped into the volume
  int off[9];
#pragma unroll
  for (int kh = 0; kh < 3; ++kh) {
    const int ih = min(max(2 * ho - 1 + kh, 0), H - 1);
#pragma unroll
    for (int kw = 0; kw < 3; ++kw) {
      const int iw = min(max(2 * wo - 1 + kw, 0), W - 1);
      off[kh * 3 + kw] = (ih * W + iw) * C + cv * VEC;
    }
  }
  const int64_t plane = (int64_t)H * W * C;
  const T* xb = x + (int64_t)b * D * plane;
  auto hw_max = [&](int d) {
    const T* src = xb + (int64_t)d * plane;
    uint4 m = __ldg(reinterpret_cast<const uint4*>(src + off[0]));
#pragma unroll
    for (int i = 1; i < 9; ++i)
      m = vmax<T>(m, __ldg(reinterpret_cast<const uint4*>(src + off[i])));
    return m;
  };
  uint4 odd = hw_max(max(2 * p0 - 1, 0));      // plane 2p0 - 1, clamped
  T* dst = out + (((int64_t)b * Do + p0) * Ho + ho) * Wo * C +
           (int64_t)wo * C + cv * VEC;
  const int64_t out_plane = (int64_t)Ho * Wo * C;
  for (int p = p0; p < p1; ++p) {
    const uint4 even = hw_max(2 * p);
    const uint4 next = hw_max(min(2 * p + 1, D - 1));
    *reinterpret_cast<uint4*>(dst) = vmax<T>(vmax<T>(odd, even), next);
    odd = next;
    dst += out_plane;
  }
}

// Scalar path: one thread per output element.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    max_pool3d_k3s2p1_kernel(const T* __restrict__ x, T* __restrict__ out,
                             int D, int H, int W, int C, int Do, int Ho,
                             int Wo, int64_t total) {
  const int64_t idx = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= total) return;
  const int c = (int)(idx % C);
  int64_t r = idx / C;
  const int wo = (int)(r % Wo); r /= Wo;
  const int ho = (int)(r % Ho); r /= Ho;
  const int d0 = (int)(r % Do);
  const int64_t b = r / Do;
  float m = -INFINITY;
#pragma unroll
  for (int kd = 0; kd < 3; ++kd) {
    const int id = 2 * d0 - 1 + kd;
    if (id < 0 || id >= D) continue;
#pragma unroll
    for (int kh = 0; kh < 3; ++kh) {
      const int ih = 2 * ho - 1 + kh;
      if (ih < 0 || ih >= H) continue;
      const int64_t row = ((b * D + id) * H + ih) * (int64_t)W;
#pragma unroll
      for (int kw = 0; kw < 3; ++kw) {
        const int iw = 2 * wo - 1 + kw;
        if (iw < 0 || iw >= W) continue;
        m = fmaxf(m, to_f32(x[(row + iw) * C + c]));
      }
    }
  }
  out[idx] = from_f32<T>(m);
}

template <typename T>
cudaError_t launch(const void* x, void* out, int B, int D, int H, int W,
                   int C, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const int Do = (D - 1) / 2 + 1, Ho = (H - 1) / 2 + 1, Wo = (W - 1) / 2 + 1;
  const bool vec = C % VEC == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                   (int64_t)H * W * C < INT32_MAX &&
                   (int64_t)Ho * Wo * (C / VEC) < INT32_MAX;
  if (vec) {
    const int64_t cols = (int64_t)Ho * Wo * (C / VEC);
    const dim3 grid((unsigned)((cols + kThreads - 1) / kThreads),
                    (unsigned)((Do + kPlanes - 1) / kPlanes), (unsigned)B);
    if (grid.x > 0x7fffffffu || grid.y > 65535 || grid.z > 65535)
      return cudaErrorInvalidConfiguration;
    max_pool3d_vec_kernel<T><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(out), D, H, W, C, Do, Ho,
        Wo);
    return cudaGetLastError();
  }
  const int64_t total = (int64_t)B * Do * Ho * Wo * C;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  max_pool3d_k3s2p1_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), D, H, W, C, Do, Ho, Wo,
      total);
  return cudaGetLastError();
}

}  // namespace
}  // namespace dram

extern "C" int max_pool3d_k3s2p1(int dtype, const void* x, void* out, int B,
                                 int D, int H, int W, int C, void* stream) {
  using namespace dram;
  if (B <= 0 || D <= 0 || H <= 0 || W <= 0 || C <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return (int)launch<float>(x, out, B, D, H, W, C, s);
  if (dtype == kBF16)
    return (int)launch<__nv_bfloat16>(x, out, B, D, H, W, C, s);
  return (int)cudaErrorInvalidValue;
}

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
// Design: one thread per output element, channel fastest, so a warp reads
// 32 consecutive channels of each of the 27 window voxels (coalesced) and
// writes 32 consecutive outputs.  The TPU kernel's quad-lane W view, its
// depth-plane ring and its bitcast lane rolls exist for the TPU's 128-lane
// vector registers and VMEM and are not carried over.
//
// What bounds it on the H100: it reads each input element about 27/8
// times (mostly from L1/L2) and writes 1/8 of it, with one max per read:
// memory bound, at best the input's bytes over HBM bandwidth.  Max is
// exact, so the result equals the plain version bit for bit.
#include <math.h>

#include "common.cuh"

namespace dram {
namespace {

constexpr int kThreads = 256;

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
  const int Do = (D - 1) / 2 + 1, Ho = (H - 1) / 2 + 1, Wo = (W - 1) / 2 + 1;
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

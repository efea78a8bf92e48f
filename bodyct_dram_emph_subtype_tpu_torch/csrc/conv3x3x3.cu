// Kernels A and B: 3x3x3 stride-1 pad-1 convolution on NDHWC activations
// with a fused per-channel epilogue.
//
//   A  conv3x3x3_affine        out = relu?(acc*scale[o] + shift[o] + residual?)
//   B  conv3x3x3_heads_sigmoid out = sigmoid(heads(relu(acc*scale + shift)))
//
// Replaces the Pallas TPU kernels
//   bodyct_dram_emph_subtype_tpu/ops/roll_conv.py:311 _roll_conv_impl
//       (rolling-ring packed conv + affine/ReLU epilogue, kernel A)
//   bodyct_dram_emph_subtype_tpu/ops/roll_conv.py:502 roll_conv_heads_sigmoid
//       (the same conv + 1x1x1 heads + sigmoid epilogue, kernel B)
// and, as a loop of kernel-A launches, the conv phase of
//   bodyct_dram_emph_subtype_tpu/ops/layer1_kernel.py:142 fused_layer1.
// With an identity epilogue and a dilation d (tap (kd,kh,kw) reads the
// input at d*(k-1), zero padding d) kernel A also replaces the opt-in conv
// mode kernels
//   bodyct_dram_emph_subtype_tpu/ops/pallas_conv.py:80 _pallas_conv3d_impl
//   bodyct_dram_emph_subtype_tpu/ops/tap_conv.py:118 _tap_conv3d_impl
//   bodyct_dram_emph_subtype_tpu/ops/flat_conv.py:140 _flat_conv_impl
// which compute one stride-1 3^3 conv in three MXU-filling layouts; the
// dilated layer3/4 convs, which the TPU runs on space-to-batch subgrids,
// run here on the logical tensor at d = 2 and 4.
//
// Design: an implicit GEMM, M = B*D*H*W output voxels, N = O output
// channels, K = 27 taps x C input channels.  A block owns a BM x BN output
// tile and walks K one tap and one BK-channel chunk at a time: the input
// rows of that tap are gathered (zero outside the volume, which is the
// conv padding) into shared memory, the weight chunk beside them, and each
// thread accumulates an 8 x 4 micro tile in float32 registers.  The TPU
// kernel's W-pair lane packing, its VMEM ring of halo'd planes and its
// compact K=4C tap matrices exist to fill 128-lane TPU tiles and are not
// carried over.
//
// What bounds it on the H100: at the decoder's shapes the conv does 27*C
// multiply-adds per loaded output element, far above the card's
// FLOP/byte balance, so it is bound by arithmetic.  This first version
// runs the FMAs on the CUDA cores in float32 (no tensor cores), with
// 128-bit input gathers when C allows and L1/L2 serving the 27-fold tap
// reuse of each input row; wgmma/TMA tiles are later work.  Offsets are
// 64-bit: the us2 input at B=4 holds 528 M elements.
#include "common.cuh"

namespace dram {
namespace {

constexpr int BM = 128;  // output voxels per block
constexpr int BN = 64;   // output channels per block
constexpr int BK = 16;   // input channels per K step
constexpr int NT = 256;  // 16 x 16 threads, each an 8 x 4 micro tile
constexpr int kMaxHeads = 8;

struct ConvArgs {
  const void* x;         // (B, D, H, W, C) T
  const void* w;         // (3, 3, 3, C, O) T
  const float* scale;    // (O,)
  const float* shift;    // (O,)
  const void* residual;  // (B, D, H, W, O) T or null          (kernel A)
  void* out;             // (B, D, H, W, O) T | (..., n_heads) f32
  const void* head_w;    // (O, n_heads) T                     (kernel B)
  const float* head_b;   // (n_heads,)                         (kernel B)
  int n_heads;
  int B, D, H, W, C, O;
  int relu;
  int dil;               // tap spacing and zero padding (1: plain 3^3)
};

// Gather 8 consecutive input channels of one voxel row into registers.
template <typename T, bool VEC>
__device__ __forceinline__ void load8(const T* row, int c, int C, bool ok,
                                      float v[8]) {
  if (VEC && ok && c + 8 <= C) {
    if constexpr (sizeof(T) == 4) {
      const float4 a = *reinterpret_cast<const float4*>(row + c);
      const float4 b = *reinterpret_cast<const float4*>(row + c + 4);
      v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
      v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
    } else {
      const uint4 u = *reinterpret_cast<const uint4*>(row + c);
      const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(p[j]);
        v[2 * j] = f.x;
        v[2 * j + 1] = f.y;
      }
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
    v[j] = (ok && c + j < C) ? to_f32(row[c + j]) : 0.f;
}

template <typename T, bool VEC, bool HEADS>
__global__ void __launch_bounds__(NT) conv3x3x3_kernel(ConvArgs a) {
  // As: input taps (k-major), Bs: weights (k-major); the heads epilogue
  // reuses the same storage for the rounded activation tile.
  constexpr int kMain = BK * BM + BK * BN;
  constexpr int kHeads = BM * (BN + 1);
  __shared__ __align__(16) float smem[HEADS && kHeads > kMain ? kHeads : kMain];
  float (*As)[BM] = reinterpret_cast<float (*)[BM]>(smem);
  float (*Bs)[BN] = reinterpret_cast<float (*)[BN]>(smem + BK * BM);

  const T* __restrict__ x = static_cast<const T*>(a.x);
  const T* __restrict__ w = static_cast<const T*>(a.w);
  const int tid = threadIdx.x;
  const int64_t M = (int64_t)a.B * a.D * a.H * a.W;
  const int64_t m0 = (int64_t)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  // load role for the input tile: one voxel row, 8 channels
  const int a_row = tid >> 1;
  const int a_col = (tid & 1) * 8;
  const int64_t am = m0 + a_row;
  const bool a_valid = am < M;
  int ad = 0, ah = 0, aw = 0;
  int64_t ab = 0;
  if (a_valid) {
    int64_t r = am;
    aw = (int)(r % a.W); r /= a.W;
    ah = (int)(r % a.H); r /= a.H;
    ad = (int)(r % a.D); ab = r / a.D;
  }
  // load role for the weight tile: one input channel, 4 output channels
  const int b_row = tid >> 4;
  const int b_col = (tid & 15) * 4;
  // compute role: voxel rows ty*8.., output channels tx*4..
  const int ty = tid >> 4;
  const int tx = tid & 15;

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int tap = 0; tap < 27; ++tap) {
    const int id = ad + (tap / 9 - 1) * a.dil;
    const int ih = ah + ((tap / 3) % 3 - 1) * a.dil;
    const int iw = aw + (tap % 3 - 1) * a.dil;
    const bool in_vol = a_valid && id >= 0 && id < a.D && ih >= 0 &&
                        ih < a.H && iw >= 0 && iw < a.W;
    const T* xrow =
        in_vol ? x + (((ab * a.D + id) * a.H + ih) * (int64_t)a.W + iw) *
                         (int64_t)a.C
               : x;
    const T* wtap = w + (int64_t)tap * a.C * a.O;
    for (int c0 = 0; c0 < a.C; c0 += BK) {
      float v[8];
      load8<T, VEC>(xrow, c0 + a_col, a.C, in_vol, v);
#pragma unroll
      for (int j = 0; j < 8; ++j) As[a_col + j][a_row] = v[j];
      {
        const int c = c0 + b_row;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int o = n0 + b_col + j;
          Bs[b_row][b_col + j] =
              (c < a.C && o < a.O) ? to_f32(wtap[(int64_t)c * a.O + o]) : 0.f;
        }
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < BK; ++k) {
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
  }

  if constexpr (!HEADS) {
    T* out = static_cast<T*>(a.out);
    const T* res = static_cast<const T*>(a.residual);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int64_t m = m0 + ty * 8 + i;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int o = n0 + tx * 4 + j;
        if (o >= a.O) continue;
        float v = acc[i][j] * a.scale[o] + a.shift[o];
        if (res != nullptr) v += to_f32(res[m * a.O + o]);
        if (a.relu) v = fmaxf(v, 0.f);
        out[m * a.O + o] = from_f32<T>(v);
      }
    }
  } else {
    // Heads epilogue (the whole O fits one block: the host checks O <= BN).
    // The rounding chain of roll_conv.py:466-474: the ReLU'd activation is
    // rounded to the compute dtype, the head matmul accumulates in f32 and
    // rounds to the compute dtype, the bias add runs in the compute dtype,
    // and only the sigmoid runs in f32.
    float (*Hs)[BN + 1] = reinterpret_cast<float (*)[BN + 1]>(smem);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int o = tx * 4 + j;
        const float v = fmaxf(acc[i][j] * (o < a.O ? a.scale[o] : 0.f) +
                                  (o < a.O ? a.shift[o] : 0.f),
                              0.f);
        Hs[ty * 8 + i][o] = o < a.O ? round_through<T>(v) : 0.f;
      }
    __syncthreads();
    const T* hw = static_cast<const T*>(a.head_w);
    float* out = static_cast<float*>(a.out);
    const int nh = a.n_heads;
    for (int idx = tid; idx < BM * nh; idx += NT) {
      const int r = idx / nh;
      const int h = idx - r * nh;
      const int64_t m = m0 + r;
      if (m >= M) continue;
      float s = 0.f;
      for (int o = 0; o < a.O; ++o) s = fmaf(Hs[r][o], to_f32(hw[o * nh + h]), s);
      const float logit =
          round_through<T>(round_through<T>(s) + round_through<T>(a.head_b[h]));
      out[m * nh + h] = 1.f / (1.f + expf(-logit));
    }
  }
}

template <typename T, bool HEADS>
cudaError_t launch(const ConvArgs& a, cudaStream_t stream) {
  const int64_t M = (int64_t)a.B * a.D * a.H * a.W;
  const int64_t gx = (M + BM - 1) / BM;
  if (gx > 0x7fffffff) return cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)gx, (unsigned)((a.O + BN - 1) / BN));
  // 128-bit gathers need every voxel row 16-byte aligned
  const bool vec = (a.C % 8 == 0) &&
                   (reinterpret_cast<uintptr_t>(a.x) % 16 == 0);
  if (vec)
    conv3x3x3_kernel<T, true, HEADS><<<grid, NT, 0, stream>>>(a);
  else
    conv3x3x3_kernel<T, false, HEADS><<<grid, NT, 0, stream>>>(a);
  return cudaGetLastError();
}

bool bad_shape(const ConvArgs& a) {
  return a.B <= 0 || a.D <= 0 || a.H <= 0 || a.W <= 0 || a.C <= 0 ||
         a.O <= 0 || a.dil <= 0;
}

}  // namespace
}  // namespace dram

extern "C" int conv3x3x3_affine(int dtype, const void* x, const void* w,
                                const float* scale, const float* shift,
                                const void* residual, void* out, int B, int D,
                                int H, int W, int C, int O, int relu, int dil,
                                void* stream) {
  using namespace dram;
  ConvArgs a{x, w, scale, shift, residual, out, nullptr, nullptr, 0,
             B, D, H, W, C, O, relu, dil};
  if (bad_shape(a)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return (int)launch<float, false>(a, s);
  if (dtype == kBF16) return (int)launch<__nv_bfloat16, false>(a, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int conv3x3x3_heads_sigmoid(int dtype, const void* x, const void* w,
                                       const float* scale, const float* shift,
                                       const void* head_w, const float* head_b,
                                       void* out, int n_heads, int B, int D,
                                       int H, int W, int C, int O,
                                       void* stream) {
  using namespace dram;
  ConvArgs a{x, w, scale, shift, nullptr, out, head_w, head_b, n_heads,
             B, D, H, W, C, O, 1, 1};
  if (bad_shape(a) || O > BN || n_heads <= 0 || n_heads > kMaxHeads)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return (int)launch<float, true>(a, s);
  if (dtype == kBF16) return (int)launch<__nv_bfloat16, true>(a, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* dram_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Kernel E: the stem in one pass -- k7 s2 p3 conv of a 1-channel NDHWC
// volume, folded eval BatchNorm, ReLU, one rounding to the storage type,
// and the k3 s2 p1 max-pool of the rounded stem.
//
//   stem[b,s,c]   = T(relu(sum_k x[b, 2s+k-3] * w[k,c] * mul[c] + add[c]))
//   pooled[b,p,c] = max over s in 2p-1 .. 2p+1 (each axis) of stem[b,s,c]
//
// Replaces the Pallas TPU kernel
//   bodyct_dram_emph_subtype_tpu/ops/stem_kernel.py:241 fused_stem_pool
// (conv + BN + ReLU + pool with the stem plane ring in VMEM, the stem
// written once, the pool never re-reading it from HBM).
//
// Design: a block owns a PD x PH x PW tile of pooled voxels.  It computes
// the stem voxels that tile pools over -- its own 2P stem voxels per axis
// plus the one-voxel halo below them that the neighbouring block owns and
// recomputes here -- into shared memory, rounded, writes the stem voxels
// it owns (every stem voxel is written exactly once over the grid), then
// pools from shared memory.  The stem never makes a round trip through
// device memory.  Halo voxels outside the volume are zero: the stem is
// post-ReLU, so a zero pad gives the same maxima as -inf, and every pool
// window holds at least one voxel of the volume.  Max-pooling commutes
// with the monotone rounding, so the pooled values are the maxima of the
// rounded stem, as the Pallas kernel computes them.
//
// The conv: Cin = 1 gives K = 343 taps per output channel.  The input
// tile (15 x 23 x 23 voxels) and all 343 x 64 weights sit in shared memory
// as float32; each of the 512 threads accumulates 8 stem voxels x 8
// channels in float32 registers (10 shared loads per 64 FMAs).
//
// What bounds it on the H100: per stem voxel 64 x 343 multiply-adds
// against 64 output bytes (bf16) written, far above the card's FLOP/byte
// balance, so arithmetic.  This first version runs the FMAs on the CUDA
// cores in float32 and recomputes the low halo (405 computed stem voxels
// in 512 thread slots for 256 owned: 2x the conv's FLOPs); tensor-core
// tiles and a halo-free schedule are later work.
#include "common.cuh"

namespace dram {
namespace {

constexpr int F = 64;                            // stem channels
constexpr int PD = 2, PH = 4, PW = 4;            // pooled voxels per block
constexpr int SD = 2 * PD + 1, SH = 2 * PH + 1, SW = 2 * PW + 1;  // 5 9 9
constexpr int NS = SD * SH * SW;                 // stem voxels per block
constexpr int ID = 2 * SD + 5, IH = 2 * SH + 5, IW = 2 * SW + 5;  // input
constexpr int NI = ID * IH * IW;
constexpr int NTAP = 343;
constexpr int NT = 512;                          // 64 voxel x 8 channel groups
constexpr int KV = 8;                            // stem voxels per thread
constexpr int KC = 8;                            // channels per thread
static_assert(NT / KC * KV >= NS, "one pass covers the stem tile");

struct StemArgs {
  const void* x;       // (B, D, H, W) T
  const void* w;       // (7, 7, 7, F) T
  const float* mul;    // (F,)
  const float* add;    // (F,)
  void* stem;          // (B, D/2, H/2, W/2, F) T
  void* pooled;        // (B, D/4, H/4, W/4, F) T
  int B, D, H, W;
};

template <typename T>
constexpr size_t smem_bytes() {
  return sizeof(float) * (NTAP * F + NI) + sizeof(T) * NS * F;
}

template <typename T>
__global__ void __launch_bounds__(NT) stem_pool_kernel(StemArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ws = reinterpret_cast<float*>(smem_raw);         // [343][64]
  float* xs = ws + NTAP * F;                               // [ID][IH][IW]
  T* st = reinterpret_cast<T*>(xs + NI);                   // [NS][64]

  const int tid = threadIdx.x;
  const int D2 = a.D / 2, H2 = a.H / 2, W2 = a.W / 2;
  const int D4 = D2 / 2, H4 = H2 / 2, W4 = W2 / 2;
  const int nd = (D4 + PD - 1) / PD;
  const int b = blockIdx.z / nd;
  const int pd0 = (blockIdx.z % nd) * PD;
  const int ph0 = blockIdx.y * PH;
  const int pw0 = blockIdx.x * PW;
  // stem tile origin (the low halo) and input tile origin
  const int sd0 = 2 * pd0 - 1, sh0 = 2 * ph0 - 1, sw0 = 2 * pw0 - 1;
  const int id0 = 2 * sd0 - 3, ih0 = 2 * sh0 - 3, iw0 = 2 * sw0 - 3;

  const T* __restrict__ w = static_cast<const T*>(a.w);
  for (int i = tid; i < NTAP * F; i += NT) ws[i] = to_f32(w[i]);
  const T* __restrict__ x =
      static_cast<const T*>(a.x) + (int64_t)b * a.D * a.H * a.W;
  for (int i = tid; i < NI; i += NT) {
    const int u = i % IW, r = i / IW;
    const int t = r % IH, s = r / IH;
    const int gd = id0 + s, gh = ih0 + t, gw = iw0 + u;
    const bool in = gd >= 0 && gd < a.D && gh >= 0 && gh < a.H && gw >= 0 &&
                    gw < a.W;
    xs[i] = in ? to_f32(x[((int64_t)gd * a.H + gh) * a.W + gw]) : 0.f;
  }
  __syncthreads();

  // compute role: voxels v = i*64 + vg (i < KV), channels cg*8 .. cg*8+7
  const int vg = tid >> 3;
  const int cg = tid & 7;
  int base[KV];
#pragma unroll
  for (int i = 0; i < KV; ++i) {
    const int v = min(i * (NT / KC) + vg, NS - 1);
    const int vd = v / (SH * SW), vh = (v / SW) % SH, vw = v % SW;
    base[i] = (2 * vd * IH + 2 * vh) * IW + 2 * vw;
  }
  float acc[KV][KC];
#pragma unroll
  for (int i = 0; i < KV; ++i)
#pragma unroll
    for (int j = 0; j < KC; ++j) acc[i][j] = 0.f;

  for (int kd = 0; kd < 7; ++kd) {
    for (int kh = 0; kh < 7; ++kh) {
      const int off = kd * IH * IW + kh * IW;
      const float* wrow = ws + ((kd * 7 + kh) * 7) * F + cg * KC;
#pragma unroll
      for (int kw = 0; kw < 7; ++kw) {
        const float4 w0 = *reinterpret_cast<const float4*>(wrow + kw * F);
        const float4 w1 = *reinterpret_cast<const float4*>(wrow + kw * F + 4);
        const float wv[KC] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int i = 0; i < KV; ++i) {
          const float xv = xs[base[i] + off + kw];
#pragma unroll
          for (int j = 0; j < KC; ++j) acc[i][j] = fmaf(xv, wv[j], acc[i][j]);
        }
      }
    }
  }

  // epilogue: BN affine, ReLU, one rounding; shared tile + owned stem out
  float mv[KC], av[KC];
#pragma unroll
  for (int j = 0; j < KC; ++j) {
    mv[j] = a.mul[cg * KC + j];
    av[j] = a.add[cg * KC + j];
  }
  T* __restrict__ stem_out = static_cast<T*>(a.stem);
#pragma unroll
  for (int i = 0; i < KV; ++i) {
    const int v = i * (NT / KC) + vg;
    if (v >= NS) continue;
    const int vd = v / (SH * SW), vh = (v / SW) % SH, vw = v % SW;
    const int gd = sd0 + vd, gh = sh0 + vh, gw = sw0 + vw;
    const bool in = gd >= 0 && gd < D2 && gh >= 0 && gh < H2 && gw >= 0 &&
                    gw < W2;
    T vals[KC];
#pragma unroll
    for (int j = 0; j < KC; ++j)
      vals[j] = from_f32<T>(in ? fmaxf(acc[i][j] * mv[j] + av[j], 0.f) : 0.f);
#pragma unroll
    for (int j = 0; j < KC; ++j) st[v * F + cg * KC + j] = vals[j];
    // the low halo (local index 0 on any axis) belongs to the block below
    if (in && vd > 0 && vh > 0 && vw > 0) {
      T* dst = stem_out + ((((int64_t)b * D2 + gd) * H2 + gh) * W2 + gw) * F +
               cg * KC;
#pragma unroll
      for (int j = 0; j < KC; ++j) dst[j] = vals[j];
    }
  }
  __syncthreads();

  // pool: each thread one pooled voxel x 8 channels per pass
  T* __restrict__ pool_out = static_cast<T*>(a.pooled);
  for (int idx = tid; idx < PD * PH * PW * (F / KC); idx += NT) {
    const int g = idx % (F / KC);
    const int q = idx / (F / KC);
    const int qd = q / (PH * PW), qh = (q / PW) % PH, qw = q % PW;
    const int pd = pd0 + qd, ph = ph0 + qh, pw = pw0 + qw;
    if (pd >= D4 || ph >= H4 || pw >= W4) continue;
    float m[KC];
#pragma unroll
    for (int j = 0; j < KC; ++j) m[j] = 0.f;
    for (int dd = 0; dd < 3; ++dd)
      for (int dh = 0; dh < 3; ++dh)
        for (int dw = 0; dw < 3; ++dw) {
          const T* src =
              st + (((2 * qd + dd) * SH + 2 * qh + dh) * SW + 2 * qw + dw) * F +
              g * KC;
#pragma unroll
          for (int j = 0; j < KC; ++j) m[j] = fmaxf(m[j], to_f32(src[j]));
        }
    T* dst = pool_out + ((((int64_t)b * D4 + pd) * H4 + ph) * W4 + pw) * F +
             g * KC;
#pragma unroll
    for (int j = 0; j < KC; ++j) dst[j] = from_f32<T>(m[j]);
  }
}

template <typename T>
cudaError_t launch(const StemArgs& a, cudaStream_t stream) {
  const int D4 = a.D / 4, H4 = a.H / 4, W4 = a.W / 4;
  const int64_t gz = (int64_t)a.B * ((D4 + PD - 1) / PD);
  if (gz > 65535) return cudaErrorInvalidConfiguration;
  const dim3 grid((W4 + PW - 1) / PW, (H4 + PH - 1) / PH, (unsigned)gz);
  const size_t bytes = smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(
      stem_pool_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  stem_pool_kernel<T><<<grid, NT, bytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace
}  // namespace dram

extern "C" int stem_pool(int dtype, const void* x, const void* w,
                         const float* mul, const float* add, void* stem,
                         void* pooled, int B, int D, int H, int W,
                         void* stream) {
  using namespace dram;
  if (B <= 0 || D <= 0 || H <= 0 || W <= 0 || D % 4 || H % 4 || W % 4)
    return (int)cudaErrorInvalidValue;
  StemArgs a{x, w, mul, add, stem, pooled, B, D, H, W};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return (int)launch<float>(a, s);
  if (dtype == kBF16) return (int)launch<__nv_bfloat16>(a, s);
  return (int)cudaErrorInvalidValue;
}

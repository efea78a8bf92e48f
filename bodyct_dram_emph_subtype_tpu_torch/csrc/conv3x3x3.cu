// Kernels A and B: 3x3x3 stride-1 convolution (taps d*(k-1), zero padding
// d, d = 1 by default) on NDHWC activations with a fused per-channel
// epilogue.
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
// With an identity epilogue and a dilation d kernel A also replaces the
// opt-in conv mode kernels
//   bodyct_dram_emph_subtype_tpu/ops/pallas_conv.py:80 _pallas_conv3d_impl
//   bodyct_dram_emph_subtype_tpu/ops/tap_conv.py:118 _tap_conv3d_impl
//   bodyct_dram_emph_subtype_tpu/ops/flat_conv.py:140 _flat_conv_impl
// which compute one stride-1 3^3 conv in three MXU-filling layouts; the
// dilated layer3/4 convs, which the TPU runs on space-to-batch subgrids,
// run here on the logical tensor at d = 2 and 4.  The training dgrad is
// kernel A on the flipped, I/O-transposed weights.
//
// Design: an implicit GEMM, M = B*D*H*W output voxels, N = O output
// channels, K = 27 taps x C input channels, walked one tap and one chunk
// of input channels at a time; the input rows of a tap are gathered with
// zeros outside the volume, which is the conv padding.  The TPU kernel's
// W-pair lane packing, its VMEM ring of halo'd planes and its compact
// K=4C tap matrices exist to fill 128-lane TPU tiles and are not carried
// over.
//
// What bounds it on the H100: at the decoder's shapes the conv does 27*C
// multiply-adds per output element, far above the card's FLOP/byte
// balance, so it is bound by arithmetic, on the bf16 tensor cores.
//
// bfloat16, every site of the port's main paths: the tensor-core loop of
// mma_bf16.cuh.  A block owns a 128 x BN output tile (BN = 64, or 128 where
// O is wide, tile_n).  Per K step of 32 channels of one tap, cp.async
// copies the gathered input rows (16 bytes per copy, zero-filled outside
// the volume and past M) and the weight slab w[tap][c0:c0+32][n0:n0+BN]
// into the 4-stage ring, and 8 warps run mma.sync m16n8k16 with float32
// accumulators on the oldest stage while the next ones are in flight; the
// 64-column tile promotes them into float32 sums every 64 steps (promotes).
// With C % 8 != 0 (or an unaligned x) the same loop gathers the input
// with plain loads, with O % 8 != 0 the weights.  The epilogue applies
// scale, shift, residual and ReLU to the accumulator fragments and rounds
// once.  Kernel B is the same loop; its epilogue drains the ring and
// reuses it for the rounded activation tile that the heads read.
//
// float32: an FMA loop on the CUDA cores (an 8 x 4 micro tile in float32
// registers per thread).  The tensor cores would round float32 operands
// to TF32 and break the float32 parity bounds (2e-5 and 1e-5 of the peak).
//
// Waits for a later step: wgmma fed by TMA.  TMA's tiled mode can load one
// shifted box per tap, with the padding as its out-of-bounds zero fill (it
// needs C % 8 == 0), and wgmma reads both operands from shared memory at
// the full tensor-core rate.
//
// Offsets are 64-bit: the us2 input at B=4 holds 528 M elements.
#include "common.cuh"
#include "mma_bf16.cuh"

namespace dram {
namespace {

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

// Kernel B's heads over a block's rows: Hs holds BM rows of ReLU'd
// activations rounded to T (row stride LD, zero past O).  The rounding
// chain of roll_conv.py:466-474: the head matmul accumulates in f32 and
// rounds to T, the bias add runs in T, and only the sigmoid runs in f32.
template <typename T, int BM, int LD>
__device__ void heads_sigmoid_rows(const float* Hs, const ConvArgs& a,
                                   int64_t m0, int64_t M) {
  const T* hw = static_cast<const T*>(a.head_w);
  float* out = static_cast<float*>(a.out);
  const int nh = a.n_heads;
  for (int idx = threadIdx.x; idx < BM * nh; idx += blockDim.x) {
    const int r = idx / nh;
    const int h = idx - r * nh;
    const int64_t m = m0 + r;
    if (m >= M) continue;
    float s = 0.f;
    for (int o = 0; o < a.O; ++o)
      s = fmaf(Hs[r * LD + o], to_f32(hw[o * nh + h]), s);
    const float logit =
        round_through<T>(round_through<T>(s) + round_through<T>(a.head_b[h]));
    out[m * nh + h] = 1.f / (1.f + expf(-logit));
  }
}

// ---------------------------------------------------------------------------
// float32: the CUDA-core FMA loop.

constexpr int FBM = 128;  // output voxels per block
constexpr int FBN = 64;   // output channels per block
constexpr int FBK = 16;   // input channels per K step
constexpr int FNT = 256;  // 16 x 16 threads, each an 8 x 4 micro tile

// Gather 8 consecutive input channels of one voxel row into registers.
template <bool VEC>
__device__ __forceinline__ void load8(const float* row, int c, int C, bool ok,
                                      float v[8]) {
  if (VEC && ok && c + 8 <= C) {
    const float4 a = *reinterpret_cast<const float4*>(row + c);
    const float4 b = *reinterpret_cast<const float4*>(row + c + 4);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
    return;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = (ok && c + j < C) ? row[c + j] : 0.f;
}

template <bool VEC, bool HEADS>
__global__ void __launch_bounds__(FNT) conv3x3x3_f32_kernel(ConvArgs a) {
  // As: input taps (k-major), Bs: weights (k-major); the heads epilogue
  // reuses the same storage for the rounded activation tile.
  constexpr int kMain = FBK * FBM + FBK * FBN;
  constexpr int kHeads = FBM * (FBN + 1);
  __shared__ __align__(16) float smem[HEADS && kHeads > kMain ? kHeads : kMain];
  float (*As)[FBM] = reinterpret_cast<float (*)[FBM]>(smem);
  float (*Bs)[FBN] = reinterpret_cast<float (*)[FBN]>(smem + FBK * FBM);

  const float* __restrict__ x = static_cast<const float*>(a.x);
  const float* __restrict__ w = static_cast<const float*>(a.w);
  const int tid = threadIdx.x;
  const int64_t M = (int64_t)a.B * a.D * a.H * a.W;
  const int64_t m0 = (int64_t)blockIdx.x * FBM;
  const int n0 = blockIdx.y * FBN;

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
    const float* xrow =
        in_vol ? x + (((ab * a.D + id) * a.H + ih) * (int64_t)a.W + iw) *
                         (int64_t)a.C
               : x;
    const float* wtap = w + (int64_t)tap * a.C * a.O;
    for (int c0 = 0; c0 < a.C; c0 += FBK) {
      float v[8];
      load8<VEC>(xrow, c0 + a_col, a.C, in_vol, v);
#pragma unroll
      for (int j = 0; j < 8; ++j) As[a_col + j][a_row] = v[j];
      {
        const int c = c0 + b_row;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int o = n0 + b_col + j;
          Bs[b_row][b_col + j] =
              (c < a.C && o < a.O) ? wtap[(int64_t)c * a.O + o] : 0.f;
        }
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < FBK; ++k) {
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
    float* out = static_cast<float*>(a.out);
    const float* res = static_cast<const float*>(a.residual);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int64_t m = m0 + ty * 8 + i;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int o = n0 + tx * 4 + j;
        if (o >= a.O) continue;
        float v = acc[i][j] * a.scale[o] + a.shift[o];
        if (res != nullptr) v += res[m * a.O + o];
        if (a.relu) v = fmaxf(v, 0.f);
        out[m * a.O + o] = v;
      }
    }
  } else {
    // the whole O fits one block: the host checks O <= kTileNSmall = FBN
    constexpr int LD = FBN + 1;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int o = tx * 4 + j;
        const float v = fmaxf(acc[i][j] * (o < a.O ? a.scale[o] : 0.f) +
                                  (o < a.O ? a.shift[o] : 0.f),
                              0.f);
        smem[(ty * 8 + i) * LD + o] = o < a.O ? v : 0.f;
      }
    __syncthreads();
    heads_sigmoid_rows<float, FBM, LD>(smem, a, m0, M);
  }
}

// ---------------------------------------------------------------------------
// bfloat16: the tensor-core loop of mma_bf16.cuh.

constexpr int kTileM = 128;       // output voxels per block
constexpr int kTileNSmall = 64;   // output channels per block
constexpr int kTileNLarge = 128;  // ... where O is wide (tile_n)

// The column tile of a launch: 128 where it pads O to no more columns than
// 64 would (O = 70, 128, 256, 512), else 64 (O <= 64, 136, 576).
int tile_n(int O) {
  const int large = (O + kTileNLarge - 1) / kTileNLarge * kTileNLarge;
  const int small = (O + kTileNSmall - 1) / kTileNSmall * kTileNSmall;
  return O > kTileNSmall && large == small ? kTileNLarge : kTileNSmall;
}

template <int BN>
__host__ __device__ constexpr int ring_bytes() {
  return mma::STAGES * (kTileM * mma::BK + mma::BK * BN) *
         (int)sizeof(__nv_bfloat16);
}

// 8 warps as 4 x 2 (32 x 32 warp tiles) at BN = 64, 2 x 4 (64 x 32) at 128.
template <int BN>
using ConvWarp = mma::WarpTile<kTileM, BN, BN == kTileNSmall ? 4 : 2,
                               BN == kTileNSmall ? 2 : 4, false>;

// The 64-column tile promotes its sums (WarpTile::promote): 27 * C / 32 K
// steps reach 486 at C = 576, where the truncating MMA sums alone put some
// outputs 2 bf16 ulps off (measured).  Its float32 sums take 32 KB beside
// the ring, and two blocks still fit an SM; the 128-column tile's would
// take 64 KB more and has no room for a second block.
template <int BN>
__host__ __device__ constexpr bool promotes() {
  return BN == kTileNSmall;
}

template <int BN>
__host__ __device__ constexpr int smem_bytes() {
  return ring_bytes<BN>() +
         (promotes<BN>() ? ConvWarp<BN>::NACC * mma::NT * (int)sizeof(float)
                         : 0);
}

// VA: 16-byte cp.async gathers of x (C % 8 == 0, x 16-byte aligned), else
// plain loads; VB: the same for the weights (O % 8 == 0, w aligned).
template <int BN, bool VA, bool VB, bool HEADS>
__global__ void __launch_bounds__(mma::NT, 2)
    conv3x3x3_mma_kernel(ConvArgs a) {
  using bf16 = __nv_bfloat16;
  constexpr int BM = kTileM, BK = mma::BK;
  using Warp = ConvWarp<BN>;
  constexpr int A_ELEMS = BM * BK;
  constexpr int STAGE = A_ELEMS + BK * BN;
  constexpr int B_CHUNKS = BN / 64;  // weight chunks per thread per step
  extern __shared__ uint4 smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);

  const bf16* __restrict__ x = static_cast<const bf16*>(a.x);
  const bf16* __restrict__ w = static_cast<const bf16*>(a.w);
  const int tid = threadIdx.x;
  const int64_t M = (int64_t)a.B * a.D * a.H * a.W;
  const int64_t m0 = (int64_t)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  // gather role: one voxel row, two 16-byte chunks (16 channels) per step
  const int a_row = tid >> 1;
  const int a_chunk = (tid & 1) * 2;
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
  // weight role: one input channel of the step, B_CHUNKS chunks of 8 outputs
  const int b_row = tid >> 3;
  const int b_chunk = (tid & 7) * B_CHUNKS;

  // the step to load next: its tap, first channel and this thread's row
  int l_tap = 0, l_c0 = 0;
  bool in_vol = false;
  const bf16* xrow = x;
  auto set_tap = [&](int tap) {
    const int id = ad + (tap / 9 - 1) * a.dil;
    const int ih = ah + ((tap / 3) % 3 - 1) * a.dil;
    const int iw = aw + (tap % 3 - 1) * a.dil;
    in_vol = a_valid && id >= 0 && id < a.D && ih >= 0 && ih < a.H &&
             iw >= 0 && iw < a.W;
    xrow = in_vol ? x + (((ab * a.D + id) * a.H + ih) * (int64_t)a.W + iw) *
                            (int64_t)a.C
                  : x;
  };
  set_tap(0);

  auto load = [&](int stage) {
    bf16* As = smem + stage * STAGE;
    bf16* Bs = As + A_ELEMS;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int chunk = a_chunk + j;
      const int c = l_c0 + chunk * 8;
      bf16* dst = As + mma::swz<BK / 8>(a_row, chunk);
      if constexpr (VA) {
        const bool ok = in_vol && c < a.C;
        mma::cp_async16(dst, ok ? xrow + c : x, ok);
      } else {
        mma::store8(dst, [&](int e) {
          return in_vol && c + e < a.C ? mma::bits(xrow + c + e) : 0u;
        });
      }
    }
    const int c = l_c0 + b_row;
#pragma unroll
    for (int j = 0; j < B_CHUNKS; ++j) {
      const int chunk = b_chunk + j;
      const int o = n0 + chunk * 8;
      bf16* dst = Bs + mma::swz<BN / 8>(b_row, chunk);
      const bf16* src = w + ((int64_t)l_tap * a.C + c) * a.O + o;
      if constexpr (VB) {
        const bool ok = c < a.C && o < a.O;
        mma::cp_async16(dst, ok ? src : w, ok);
      } else {
        mma::store8(dst, [&](int e) {
          return c < a.C && o + e < a.O ? mma::bits(src + e) : 0u;
        });
      }
    }
    l_c0 += BK;
    if (l_c0 >= a.C) {
      l_c0 = 0;
      if (++l_tap < 27) set_tap(l_tap);
    }
  };

  Warp t;
  [[maybe_unused]] float* sum =
      reinterpret_cast<float*>(smem + mma::STAGES * STAGE);
  if constexpr (promotes<BN>()) {
#pragma unroll
    for (int e = 0; e < Warp::NACC; ++e) sum[e * mma::NT + tid] = 0.f;
  }
  [[maybe_unused]] int done = 0;
  const int nsteps = 27 * ((a.C + BK - 1) / BK);
  mma::ring(nsteps, load, [&](int stage) {
    const bf16* As = smem + stage * STAGE;
    t.step(As, As + A_ELEMS);
    if constexpr (promotes<BN>()) {
      if (++done % mma::PROMOTE_STEPS == 0) t.promote(sum);
    }
  });
  if constexpr (promotes<BN>()) t.finish(sum);

  if constexpr (!HEADS) {
    bf16* out = static_cast<bf16*>(a.out);
    const bf16* res = static_cast<const bf16*>(a.residual);
    // bf16 pairs where O is even (then m * O + o is even for an even o)
    const bool pair = a.O % 2 == 0 &&
                      reinterpret_cast<uintptr_t>(out) % 4 == 0 &&
                      reinterpret_cast<uintptr_t>(res) % 4 == 0;
#pragma unroll
    for (int ni = 0; ni < Warp::NI; ++ni) {
      const int o = n0 + t.col(ni, 0);
      if (o >= a.O) continue;
      const bool two = o + 1 < a.O;
      const float sc0 = a.scale[o], sh0 = a.shift[o];
      const float sc1 = two ? a.scale[o + 1] : 0.f;
      const float sh1 = two ? a.shift[o + 1] : 0.f;
#pragma unroll
      for (int mi = 0; mi < Warp::MI; ++mi)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int64_t m = m0 + t.row(mi, half);
          if (m >= M) continue;
          const int64_t i = m * a.O + o;
          float v0 = t.acc[mi][ni][2 * half] * sc0 + sh0;
          float v1 = t.acc[mi][ni][2 * half + 1] * sc1 + sh1;
          if (res != nullptr) {
            if (pair) {
              const float2 r = __bfloat1622float2(
                  *reinterpret_cast<const __nv_bfloat162*>(res + i));
              v0 += r.x;
              v1 += r.y;
            } else {
              v0 += to_f32(res[i]);
              if (two) v1 += to_f32(res[i + 1]);
            }
          }
          if (a.relu) {
            v0 = fmaxf(v0, 0.f);
            v1 = fmaxf(v1, 0.f);
          }
          if (pair) {
            *reinterpret_cast<__nv_bfloat162*>(out + i) =
                __floats2bfloat162_rn(v0, v1);
          } else {
            out[i] = from_f32<bf16>(v0);
            if (two) out[i + 1] = from_f32<bf16>(v1);
          }
        }
    }
  } else {
    // the ring is drained: its storage takes the rounded activations
    // (one column tile: the host checks O <= BN)
    constexpr int LD = BN + 1;
    static_assert(BM * LD * (int)sizeof(float) <= ring_bytes<BN>(),
                  "the activation tile fits the ring");
    float* Hs = reinterpret_cast<float*>(smem_raw);
#pragma unroll
    for (int mi = 0; mi < Warp::MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < Warp::NI; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = t.row(mi, e >> 1);
          const int o = t.col(ni, e & 1);
          const float v = fmaxf(t.acc[mi][ni][e] * (o < a.O ? a.scale[o] : 0.f) +
                                    (o < a.O ? a.shift[o] : 0.f),
                                0.f);
          Hs[r * LD + o] = o < a.O ? round_through<bf16>(v) : 0.f;
        }
    __syncthreads();
    heads_sigmoid_rows<bf16, BM, LD>(Hs, a, m0, M);
  }
}

template <int BN, bool VA, bool VB, bool HEADS>
cudaError_t launch_mma(const ConvArgs& a, dim3 grid, cudaStream_t stream) {
  auto* kernel = conv3x3x3_mma_kernel<BN, VA, VB, HEADS>;
  constexpr int bytes = smem_bytes<BN>();
  const cudaError_t err = mma::allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, mma::NT, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <int BN, bool HEADS>
cudaError_t launch_bf16(const ConvArgs& a, cudaStream_t stream) {
  const int64_t M = (int64_t)a.B * a.D * a.H * a.W;
  const int64_t gx = (M + kTileM - 1) / kTileM;
  if (gx > 0x7fffffff) return cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)gx, (unsigned)((a.O + BN - 1) / BN));
  const bool va = a.C % 8 == 0 && mma::aligned16(a.x);
  const bool vb = a.O % 8 == 0 && mma::aligned16(a.w);
  if (va && vb) return launch_mma<BN, true, true, HEADS>(a, grid, stream);
  if (va) return launch_mma<BN, true, false, HEADS>(a, grid, stream);
  if (vb) return launch_mma<BN, false, true, HEADS>(a, grid, stream);
  return launch_mma<BN, false, false, HEADS>(a, grid, stream);
}

template <bool HEADS>
cudaError_t launch_f32(const ConvArgs& a, cudaStream_t stream) {
  const int64_t M = (int64_t)a.B * a.D * a.H * a.W;
  const int64_t gx = (M + FBM - 1) / FBM;
  if (gx > 0x7fffffff) return cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)gx, (unsigned)((a.O + FBN - 1) / FBN));
  // 128-bit gathers need every voxel row 16-byte aligned
  if (a.C % 8 == 0 && mma::aligned16(a.x))
    conv3x3x3_f32_kernel<true, HEADS><<<grid, FNT, 0, stream>>>(a);
  else
    conv3x3x3_f32_kernel<false, HEADS><<<grid, FNT, 0, stream>>>(a);
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
  if (dtype == kF32) return (int)launch_f32<false>(a, s);
  if (dtype == kBF16)
    return (int)(tile_n(O) == kTileNLarge
                     ? launch_bf16<kTileNLarge, false>(a, s)
                     : launch_bf16<kTileNSmall, false>(a, s));
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
  static_assert(FBN == kTileNSmall, "both dtypes keep O in one column tile");
  if (bad_shape(a) || O > kTileNSmall || n_heads <= 0 || n_heads > kMaxHeads)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return (int)launch_f32<true>(a, s);
  if (dtype == kBF16) return (int)launch_bf16<kTileNSmall, true>(a, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* dram_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

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
// What bounds it on the H100, at the B=2 deployment shape: in bfloat16 the
// bytes and the FLOPs about equally -- 33 MB in, the 264 MB stem (the
// decoder's us2 concatenates it, so it must be written) and 33 MB pooled
// out take 0.099 ms at 3.35 TB/s, the 90.6 GFLOP of the conv 0.092 ms on
// the tensor cores; in float32 the FLOPs on the CUDA cores.
//
// bfloat16: the conv as a GEMM on the tensor cores (stem_mma_kernel).
// - M = the stem voxels of a block's tile, N = the 64 channels, K = taps.
//   K takes form (b) of the two forms at hand: the stride-2 conv of one
//   channel is a stride-1 4^3 conv over the 2x2x2 space-to-depth of the
//   input, 8 channels, with the 7^3 weights zero-padded to 8^3 (one zero
//   tap low on each axis) and laid out as (4, 4, 4, 8, 64) = 512 x 64
//   (ops/stem_kernel.py::stem_weights_s2d).  Each (voxel, tap) row of the
//   A operand is then 8 channels = 16 contiguous bytes of the
//   space-to-depth tile, so ldmatrix reads the A fragments straight from
//   that tile with one row address per lane, as kernel A gathers its taps.
//   Form (a), im2col with K = 343 padded to 352, takes 1.45x fewer MMAs but
//   needs its A tile built element by element (7 taps per row do not make
//   16-byte rows), which costs more shared-memory traffic than the MMAs it
//   saves.  K = 512 is 32 k16 steps per output, under WarpTile::promote's
//   64-step interval: the float32 accumulators need no promotion.
// - A persistent grid of one block per SM walks work items (sample, pooled
//   8 x 8 (H, W) tile, range of pooled D-planes).  The block stages the
//   512 x 64 bf16 weights (64 KB, swizzled) once, for every item it takes.
// - An item walks its stem planes along D.  Stem plane sd reads
//   space-to-depth planes sd-2 .. sd+1, which a ring of 5 shared-memory
//   slots holds (20 x 20 voxels x 8 channels each, filled with 4-byte
//   cp.async copies from the logical input, zero outside the volume); the
//   copy of plane sd+2 is in flight while plane sd computes.  No D halo is
//   recomputed: each stem plane is computed once (the first plane of a D
//   range, 2p0-1, twice).
// - The (H, W) tile is 17 x 17 stem voxels for 8 x 8 pooled ones: the 16 x
//   16 it owns plus the one-voxel low halo that the neighbouring tile owns
//   and that its pool windows reach, recomputed here (289 / 256 = 1.13x).
//   The 289 rows are 19 m16 fragments: 8 warps as 4 (M, 5/5/5/4 fragments)
//   x 2 (N, 32 columns).
// - Epilogue: folded BN in float32, ReLU, one rounding to bf16, into a
//   swizzled shared stem tile (zero outside the volume: the stem is
//   post-ReLU, so a zero pad gives the same maxima as -inf, and every pool
//   window holds a voxel of the volume).  The owned voxels go to device
//   memory as 16-byte stores; each pooled column takes the 3 x 3 (H, W) max
//   of the tile, and the D max of planes 2p-1, 2p, 2p+1 carries the odd
//   plane's (H, W) max in registers.  Max-pooling commutes with the
//   monotone rounding, so the pooled values are the maxima of the rounded
//   stem, as the Pallas kernel computes them.
// float32 stays on the CUDA cores (stem_f32_kernel: the tensor cores would
// round float32 operands to TF32): a block owns a 2 x 4 x 4 pooled tile and
// computes its 5 x 9 x 9 stem voxels, the low halo included, in float32
// FMAs from an input tile and the 343 x 64 weights in shared memory.
#include <string.h>

#include "mma_bf16.cuh"

namespace dram {
namespace {

constexpr int F = 64;                            // stem channels

// ---- bfloat16: tensor cores ----
constexpr int kPoolTile = 8;                     // pooled voxels per axis
constexpr int kStemTile = 2 * kPoolTile + 1;     // 17 stem voxels per axis
constexpr int kStemVox = kStemTile * kStemTile;  // 289 rows of M
constexpr int kMFrags = (kStemVox + 15) / 16;    // 19 m16 fragments
constexpr int kS2dTile = kStemTile + 3;          // 20 s2d voxels per axis
constexpr int kS2dBytes = kS2dTile * kS2dTile * 16;   // one ring slot
constexpr int kRing = 5;                         // s2d plane slots
constexpr int kTaps = 64;                        // 4 x 4 x 4
constexpr int kK = kTaps * 8;                    // 512
constexpr int kWarpsM = 4;                       // warps along M
constexpr int kWarpsN = 2;                       // warps along N
constexpr int kWarpFrags = 5;                    // m16 fragments per warp
constexpr int kWarpCols = F / kWarpsN;           // 32
constexpr int kWeightBytes = kK * F * 2;         // 65536
constexpr int kStemBytes = kStemVox * F * 2;     // 36992
constexpr int kSmemBytes = kWeightBytes + kRing * kS2dBytes + kStemBytes;
static_assert(kWarpsM * kWarpsN * 32 == mma::NT, "8 warps");
static_assert(kWarpsM * kWarpFrags >= kMFrags, "the warps cover M");
static_assert(kK / 16 <= mma::PROMOTE_STEPS, "no promotion needed");

struct StemArgs {
  const void* x;       // (B, D, H, W) T
  const void* w;       // bf16: (512, F) s2d weights; f32: (7, 7, 7, F)
  const float* mul;    // (F,)
  const float* add;    // (F,)
  void* stem;          // (B, D/2, H/2, W/2, F) T
  void* pooled;        // (B, D/4, H/4, W/4, F) T
  int B, D, H, W;
  int chunks;          // pooled D-ranges per (sample, tile); <= 0: the
                       // count stem_chunks picks (bf16 only)
};

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   mma::smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ uint32_t hmax2(uint32_t x, uint32_t y) {
  __nv_bfloat162 a, b;
  memcpy(&a, &x, 4);
  memcpy(&b, &y, 4);
  const __nv_bfloat162 r = __hmax2(a, b);
  uint32_t u;
  memcpy(&u, &r, 4);
  return u;
}

__device__ __forceinline__ uint4 vmax(uint4 a, uint4 b) {
  return make_uint4(hmax2(a.x, b.x), hmax2(a.y, b.y), hmax2(a.z, b.z),
                    hmax2(a.w, b.w));
}

// Element offset of 16-byte chunk `chunk` of stem voxel `v` in the shared
// stem tile (64 channels = 8 chunks per voxel, XOR-swizzled by v % 8).
__device__ __forceinline__ int stem_at(int v, int chunk) {
  return v * F + ((chunk ^ (v & 7)) << 3);
}

__global__ void __launch_bounds__(mma::NT, 1) stem_mma_kernel(StemArgs a) {
  using mma::bf16;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ws = reinterpret_cast<bf16*>(smem);                       // [512][64]
  unsigned char* ring = smem + kWeightBytes;                      // 5 slots
  bf16* st = reinterpret_cast<bf16*>(ring + kRing * kS2dBytes);   // [289][64]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % kWarpsM, wn = warp / kWarpsM;
  const int nfr = min(kWarpFrags, kMFrags - wm * kWarpFrags);
  const int D2 = a.D / 2, H2 = a.H / 2, W2 = a.W / 2;
  const int D4 = D2 / 2, H4 = H2 / 2, W4 = W2 / 2;
  const int nth = (H4 + kPoolTile - 1) / kPoolTile;
  const int ntw = (W4 + kPoolTile - 1) / kPoolTile;
  const int per = (D4 + a.chunks - 1) / a.chunks;   // pooled planes per range
  const int items = a.B * a.chunks * nth * ntw;
  const bf16* __restrict__ x = static_cast<const bf16*>(a.x);
  bf16* __restrict__ stem_out = static_cast<bf16*>(a.stem);
  bf16* __restrict__ pool_out = static_cast<bf16*>(a.pooled);

  // the weights, once per block
  {
    const bf16* w = static_cast<const bf16*>(a.w);
    for (int i = tid; i < kK * 8; i += mma::NT) {
      const int k = i >> 3, chunk = i & 7;
      mma::cp_async16(ws + mma::swz<8>(k, chunk), w + k * F + chunk * 8, true);
    }
    mma::cp_async_commit();
  }
  // this lane's ldmatrix row in each of its fragments (byte offset in a
  // ring slot, tap (0, 0, 0)): the voxel of M row m, and for lanes 16..31
  // the second tap of the k16 step (the next W tap, one voxel on)
  int a_off[kWarpFrags];
#pragma unroll
  for (int mi = 0; mi < kWarpFrags; ++mi) {
    const int m = min((wm * kWarpFrags + mi) * 16 + (lane & 15), kStemVox - 1);
    a_off[mi] = ((m / kStemTile) * kS2dTile + m % kStemTile + (lane >> 4)) * 16;
  }
  // the BN affine of this thread's accumulator columns
  float mv[4][2], av[4][2];
#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = wn * kWarpCols + ni * 8 + 2 * (lane & 3) + j;
      mv[ni][j] = a.mul[c];
      av[ni][j] = a.add[c];
    }

  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    int r = item;
    const int tw = r % ntw; r /= ntw;
    const int th = r % nth; r /= nth;
    const int chunk = r % a.chunks;
    const int b = r / a.chunks;
    const int p0 = chunk * per, p1 = min(p0 + per, D4);
    if (p0 >= p1) continue;                        // (uniform over the block)
    const int ph0 = th * kPoolTile, pw0 = tw * kPoolTile;
    const int sh0 = 2 * ph0 - 1, sw0 = 2 * pw0 - 1;  // stem tile origin
    const int j0 = sh0 - 2, k0 = sw0 - 2;            // s2d tile origin
    const int sd_begin = p0 == 0 ? 0 : 2 * p0 - 1, sd_end = 2 * p1;
    const bf16* xb = x + (int64_t)b * a.D * a.H * a.W;

    // s2d plane i (input planes 2i, 2i+1) into ring slot (i + 2) % kRing:
    // channel (qd * 2 + qh) * 2 + qw of s2d voxel (r, c) is
    // x[2i + qd, 2(j0 + r) + qh, 2(k0 + c) + qw]; one 4-byte copy per qw pair
    auto load_plane = [&](int i) {
      unsigned char* slot = ring + ((i + 2) % kRing) * kS2dBytes;
      const bool din = i >= 0 && i < D2;
      for (int e = tid; e < 2 * 2 * kS2dTile * kS2dTile; e += mma::NT) {
        const int c = e % kS2dTile;
        const int rq = e / kS2dTile;               // (qd, r, qh)
        const int qh = rq & 1, rr = (rq >> 1) % kS2dTile;
        const int qd = rq / (2 * kS2dTile);
        const int gh = 2 * (j0 + rr) + qh, gw = 2 * (k0 + c);
        const bool in = din && gh >= 0 && gh < a.H && gw >= 0 && gw < a.W;
        const bf16* src =
            in ? xb + ((int64_t)(2 * i + qd) * a.H + gh) * a.W + gw : x;
        cp_async4(slot + ((rr * kS2dTile + c) * 8 + (qd * 2 + qh) * 2) * 2,
                  src, in);
      }
    };

    mma::cp_async_wait_all();
    __syncthreads();              // the previous item is done with the ring
#pragma unroll 1
    for (int i = sd_begin - 2; i < sd_begin + 2; ++i) {
      load_plane(i);
      mma::cp_async_commit();
    }
    uint4 even[2], carry[2];

#pragma unroll 1
    for (int sd = sd_begin; sd < sd_end; ++sd) {
      if (sd + 2 <= sd_end) load_plane(sd + 2);
      mma::cp_async_commit();
      mma::cp_async_wait<1>();    // planes sd-2 .. sd+1 (and the weights)
      __syncthreads();

      // ---- the conv of stem plane sd: M 289 (304) x N 64 x K 512 ----
      float acc[kWarpFrags][4][4];
#pragma unroll
      for (int mi = 0; mi < kWarpFrags; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
      // k16 step s covers taps 2s and 2s+1: (td, th, tw) and (td, th, tw+1)
#pragma unroll 1
      for (int td = 0; td < 4; ++td) {
        // s2d plane sd + td - 2 sits in slot (sd + td) % kRing
        const unsigned char* slot = ring + ((sd + td) % kRing) * kS2dBytes;
#pragma unroll
        for (int s8 = 0; s8 < 8; ++s8) {
          const int step = td * 8 + s8;
          const unsigned char* base =
              slot + ((s8 >> 1) * kS2dTile + (s8 & 1) * 2) * 16;
          uint32_t af[kWarpFrags][4], bfr[4][2];
#pragma unroll
          for (int mi = 0; mi < kWarpFrags; ++mi)
            if (mi < nfr)
              mma::ldsm_x4(af[mi],
                           reinterpret_cast<const bf16*>(base + a_off[mi]));
#pragma unroll
          for (int nj = 0; nj < 2; ++nj) {
            const int k = step * 16 + (((lane >> 3) & 1) << 3) + (lane & 7);
            const int ch = (wn * kWarpCols + nj * 16) / 8 + (lane >> 4);
            uint32_t q[4];
            mma::ldsm_x4_trans(q, ws + mma::swz<8>(k, ch));
            bfr[2 * nj][0] = q[0];
            bfr[2 * nj][1] = q[1];
            bfr[2 * nj + 1][0] = q[2];
            bfr[2 * nj + 1][1] = q[3];
          }
#pragma unroll
          for (int mi = 0; mi < kWarpFrags; ++mi)
            if (mi < nfr)
#pragma unroll
              for (int ni = 0; ni < 4; ++ni)
                mma::mma_16816(acc[mi][ni], af[mi], bfr[ni]);
        }
      }

      // ---- epilogue: BN, ReLU, one rounding, into the shared stem tile ----
#pragma unroll
      for (int mi = 0; mi < kWarpFrags; ++mi) {
        if (mi >= nfr) continue;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int m = (wm * kWarpFrags + mi) * 16 + (lane >> 2) + 8 * half;
          if (m >= kStemVox) continue;
          const int gh = sh0 + m / kStemTile, gw = sw0 + m % kStemTile;
          const bool in = gh >= 0 && gh < H2 && gw >= 0 && gw < W2;
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) {
            const int c = wn * kWarpCols + ni * 8 + 2 * (lane & 3);
            const float* v = acc[mi][ni] + 2 * half;
            const float v0 = fmaxf(v[0] * mv[ni][0] + av[ni][0], 0.f);
            const float v1 = fmaxf(v[1] * mv[ni][1] + av[ni][1], 0.f);
            *reinterpret_cast<__nv_bfloat162*>(st + stem_at(m, c >> 3) +
                                               (c & 7)) =
                __floats2bfloat162_rn(in ? v0 : 0.f, in ? v1 : 0.f);
          }
        }
      }
      __syncthreads();

      // ---- the owned stem voxels out, 16 bytes a store ----
      if (sd >= 2 * p0) {
        for (int e = tid; e < 16 * 16 * 8; e += mma::NT) {
          const int ch = e & 7, o = e >> 3;
          const int lr = 1 + (o >> 4), lc = 1 + (o & 15);
          const int gh = sh0 + lr, gw = sw0 + lc;
          if (gh >= H2 || gw >= W2) continue;
          const uint4 v = *reinterpret_cast<const uint4*>(
              st + stem_at(lr * kStemTile + lc, ch));
          *reinterpret_cast<uint4*>(
              stem_out + ((((int64_t)b * D2 + sd) * H2 + gh) * W2 + gw) * F +
              ch * 8) = v;
        }
      }
      // ---- the pool: (H, W) max per plane, D max over planes 2p-1..2p+1 ----
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int e = tid + i * mma::NT;       // 8 x 8 columns x 8 chunks
        const int ch = e & 7, o = e >> 3;
        const int qh = o >> 3, qw = o & 7;
        const int v0 = 2 * qh * kStemTile + 2 * qw;
        uint4 hw = *reinterpret_cast<const uint4*>(st + stem_at(v0, ch));
#pragma unroll
        for (int dh = 0; dh < 3; ++dh)
#pragma unroll
          for (int dw = 0; dw < 3; ++dw)
            if (dh | dw)
              hw = vmax(hw, *reinterpret_cast<const uint4*>(
                                st + stem_at(v0 + dh * kStemTile + dw, ch)));
        if ((sd & 1) == 0) {                   // sd = 2p
          even[i] = hw;
          if (sd == 0) carry[i] = hw;          // plane -1 is padding
        } else {                               // sd = 2p + 1
          const int p = sd >> 1, ph = ph0 + qh, pw = pw0 + qw;
          if (sd > sd_begin && ph < H4 && pw < W4)
            *reinterpret_cast<uint4*>(
                pool_out + ((((int64_t)b * D4 + p) * H4 + ph) * W4 + pw) * F +
                ch * 8) = vmax(vmax(carry[i], even[i]), hw);
          carry[i] = hw;
        }
      }
    }
  }
  mma::cp_async_wait_all();
}

// ---- float32: CUDA cores ----
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

constexpr size_t f32_smem_bytes() {
  return sizeof(float) * (NTAP * F + NI + NS * F);
}

__global__ void __launch_bounds__(NT) stem_f32_kernel(StemArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ws = reinterpret_cast<float*>(smem_raw);         // [343][64]
  float* xs = ws + NTAP * F;                               // [ID][IH][IW]
  float* st = xs + NI;                                     // [NS][64]

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

  const float* __restrict__ w = static_cast<const float*>(a.w);
  for (int i = tid; i < NTAP * F; i += NT) ws[i] = w[i];
  const float* __restrict__ x =
      static_cast<const float*>(a.x) + (int64_t)b * a.D * a.H * a.W;
  for (int i = tid; i < NI; i += NT) {
    const int u = i % IW, r = i / IW;
    const int t = r % IH, s = r / IH;
    const int gd = id0 + s, gh = ih0 + t, gw = iw0 + u;
    const bool in = gd >= 0 && gd < a.D && gh >= 0 && gh < a.H && gw >= 0 &&
                    gw < a.W;
    xs[i] = in ? x[((int64_t)gd * a.H + gh) * a.W + gw] : 0.f;
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

  // epilogue: BN affine, ReLU; shared tile + owned stem out
  float mv[KC], av[KC];
#pragma unroll
  for (int j = 0; j < KC; ++j) {
    mv[j] = a.mul[cg * KC + j];
    av[j] = a.add[cg * KC + j];
  }
  float* __restrict__ stem_out = static_cast<float*>(a.stem);
#pragma unroll
  for (int i = 0; i < KV; ++i) {
    const int v = i * (NT / KC) + vg;
    if (v >= NS) continue;
    const int vd = v / (SH * SW), vh = (v / SW) % SH, vw = v % SW;
    const int gd = sd0 + vd, gh = sh0 + vh, gw = sw0 + vw;
    const bool in = gd >= 0 && gd < D2 && gh >= 0 && gh < H2 && gw >= 0 &&
                    gw < W2;
    float vals[KC];
#pragma unroll
    for (int j = 0; j < KC; ++j)
      vals[j] = in ? fmaxf(acc[i][j] * mv[j] + av[j], 0.f) : 0.f;
#pragma unroll
    for (int j = 0; j < KC; ++j) st[v * F + cg * KC + j] = vals[j];
    // the low halo (local index 0 on any axis) belongs to the block below
    if (in && vd > 0 && vh > 0 && vw > 0) {
      float* dst = stem_out + ((((int64_t)b * D2 + gd) * H2 + gh) * W2 + gw) *
                                  F + cg * KC;
#pragma unroll
      for (int j = 0; j < KC; ++j) dst[j] = vals[j];
    }
  }
  __syncthreads();

  // pool: each thread one pooled voxel x 8 channels per pass
  float* __restrict__ pool_out = static_cast<float*>(a.pooled);
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
          const float* src =
              st + (((2 * qd + dd) * SH + 2 * qh + dh) * SW + 2 * qw + dw) * F +
              g * KC;
#pragma unroll
          for (int j = 0; j < KC; ++j) m[j] = fmaxf(m[j], src[j]);
        }
    float* dst = pool_out + ((((int64_t)b * D4 + pd) * H4 + ph) * W4 + pw) * F +
                 g * KC;
#pragma unroll
    for (int j = 0; j < KC; ++j) dst[j] = m[j];
  }
}

cudaError_t launch_f32(const StemArgs& a, cudaStream_t stream) {
  const int D4 = a.D / 4, H4 = a.H / 4, W4 = a.W / 4;
  const int64_t gz = (int64_t)a.B * ((D4 + PD - 1) / PD);
  if (gz > 65535) return cudaErrorInvalidConfiguration;
  const dim3 grid((W4 + PW - 1) / PW, (H4 + PH - 1) / PH, (unsigned)gz);
  const int bytes = (int)f32_smem_bytes();
  const cudaError_t err = mma::allow_smem(stem_f32_kernel, bytes);
  if (err != cudaSuccess) return err;
  stem_f32_kernel<<<grid, NT, bytes, stream>>>(a);
  return cudaGetLastError();
}

// The pooled D-ranges per (sample, tile): the count that makes the
// persistent grid's longest block walk the fewest stem planes (a range of
// n pooled planes walks 2n of them, plus one recomputed below it).
int stem_chunks(int tiles, int D4, int blocks) {
  int best = 1;
  int64_t best_cost = -1;
  for (int n = 1; n <= D4; ++n) {
    const int per = (D4 + n - 1) / n;
    if ((n - 1) * per >= D4) continue;                // an empty range
    const int64_t rounds = ((int64_t)tiles * n + blocks - 1) / blocks;
    const int64_t cost = rounds * (2 * per + (n > 1 ? 1 : 0));
    if (best_cost < 0 || cost < best_cost) {
      best = n;
      best_cost = cost;
    }
  }
  return best;
}

cudaError_t launch_bf16(StemArgs a, cudaStream_t stream) {
  cudaError_t err = mma::allow_smem(stem_mma_kernel, kSmemBytes);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, stem_mma_kernel, mma::NT, kSmemBytes)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int H4 = a.H / 4, W4 = a.W / 4, D4 = a.D / 4;
  const int tiles = a.B * ((H4 + kPoolTile - 1) / kPoolTile) *
                    ((W4 + kPoolTile - 1) / kPoolTile);
  const int blocks = sms * per_sm;
  if (a.chunks <= 0) a.chunks = stem_chunks(tiles, D4, blocks);
  const int64_t items = (int64_t)tiles * a.chunks;
  const int grid = (int)(items < blocks ? items : blocks);
  stem_mma_kernel<<<grid, mma::NT, kSmemBytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace
}  // namespace dram

extern "C" int stem_pool(int dtype, const void* x, const void* w,
                         const float* mul, const float* add, void* stem,
                         void* pooled, int B, int D, int H, int W,
                         int chunks, void* stream) {
  using namespace dram;
  if (B <= 0 || D <= 0 || H <= 0 || W <= 0 || D % 4 || H % 4 || W % 4 ||
      chunks > D / 4)
    return (int)cudaErrorInvalidValue;
  StemArgs a{x, w, mul, add, stem, pooled, B, D, H, W, chunks};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return (int)launch_f32(a, s);
  if (dtype == kBF16) {
    if (!mma::aligned16(w) || !mma::aligned16(stem) || !mma::aligned16(pooled)
        || reinterpret_cast<uintptr_t>(x) % 4)
      return (int)cudaErrorInvalidValue;
    return (int)launch_bf16(a, s);
  }
  return (int)cudaErrorInvalidValue;
}

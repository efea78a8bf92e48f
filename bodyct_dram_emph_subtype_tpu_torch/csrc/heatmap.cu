// Kernel G: the processor's heatmaps, resampled and quantised on the card.
//
//   stage 1 (device path): up = resize(half, (D, H, W)); up[ess == 0] = 0
//   stage 2 (both paths):  heat = uint8(trunc(clip(resize(map, crop), 0, 1)
//                                             * 255))
//
// where resize is the two-tap align_corners linear resize of
// data/host_preprocess.py::resize_linear_matmul_np: one 1-D pass per axis,
// the axes in ascending order of out / in (a stable sort), each pass
// x0 * (1 - w) + x1 * w in float32.  The maps are NDHWC with C = 2 (the
// CLE and PSE maps side by side): stage 1 reads float16 half maps
// (B, d, h, w, 2) and the uint8 ess mask (B, D, H, W) and writes float32
// (B, D, H, W, 2); stage 2 reads float32 (B, D, H, W, 2) and writes, per
// scan b and map c, its crop's voxels in row-major order at the start of
// row (b, c) of a (B, 2, N) uint8 buffer.
//
// Replaces no TPU kernel: the JAX package upsamples, un-crops and
// quantises the heatmaps with numpy on the host, and the port did the same
// on its single postprocess thread (inference/processor.py).
//
// Exactness: every output byte equals the numpy code's.  A pass of numpy
// computes each element of its output from two elements of its input with
// three separately rounded float32 operations; a voxel of the result is a
// fixed function of the 2x2x2 cube of input voxels at its taps.  Each
// thread gathers that cube and lerps it along the axes in numpy's order:
// four lerps along the first axis, two along the second, one along the
// third, each (x0 * (1 - w)) + (x1 * w) with __fsub_rn, __fmul_rn and
// __fadd_rn, so no multiply-add is contracted into an FMA.  The taps
// (i0, i1, w) come from the host's float64-derived tables
// (host_preprocess.py::_linear_taps), uploaded with each call.  The
// quantisation is windowing(x, (0, 1)) cast to uint8: clip, times 255 in
// float32, truncation.
//
// What bounds it on the H100: memory.  Per B = 2 cohort batch stage 1
// reads 8.3 MB of half maps and 16.5 MB of ess and writes 132 MB; stage 2
// reads those 132 MB and writes 124 MB of crops: about 0.12 ms at
// 3.35 TB/s.  The gathers re-read each input voxel up to 8 times (once
// per neighbouring output), from L1 and L2: consecutive threads take
// consecutive output voxels along W, whose cubes overlap.
//
// Design: one launch per stage per batch, grid (voxel blocks, B).  A
// table of int32 entries, one per scan (stage 1: one for the batch), holds
// the output extents, the axis order and the offsets of three tap arrays
// (i0, i1, the bits of w), each as long as its output axis.  The axis
// order is one of six permutations, uniform across a block: a switch picks
// the instantiation with compile-time lerp indices, so the cube stays in
// registers.  A stage-2 thread writes 4 consecutive voxels of both maps
// (a 4-byte store each where the row's 4 voxels are inside the crop; the
// rows are padded to 16 bytes).  A scan whose entry has a zero extent
// (one this rank does not write) costs one early exit per block.  Offsets
// are 64-bit.
#include <cuda_fp16.h>

#include "common.cuh"

namespace dram {
namespace {

constexpr int MT = 256;          // threads per block
constexpr int kMaps = 2;         // CLE and PSE, channels-last
constexpr int kVox = 4;          // stage-2 output voxels per thread
constexpr int kEntry = 8;        // table header ints (see the wrapper)

struct Taps {
  int i0[3], i1[3];
  float w[3];
};

// The taps of output voxel (o0, o1, o2) of the table entry whose header
// starts at e: {n0, n1, n2, perm, off0, off1, off2, 0}, axis a's arrays
// i0[n_a], i1[n_a], w[n_a] at e + off_a.
__device__ __forceinline__ Taps load_taps(const int* __restrict__ e,
                                          const int o[3]) {
  Taps t;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const int* tab = e + __ldg(e + 4 + a);
    const int n = __ldg(e + a);
    t.i0[a] = __ldg(tab + o[a]);
    t.i1[a] = __ldg(tab + n + o[a]);
    t.w[a] = __int_as_float(__ldg(tab + 2 * n + o[a]));
  }
  return t;
}

__device__ __forceinline__ float lerp(float x0, float x1, float w) {
  return __fadd_rn(__fmul_rn(x0, __fsub_rn(1.f, w)), __fmul_rn(x1, w));
}

// v[b0 * 4 + b1 * 2 + b2]: the cube's value at tap b_a of axis a (0: i0,
// 1: i1).  Lerped along A0, then A1, then A2.
template <int A0, int A1, int A2>
__device__ __forceinline__ float resample(float (&v)[8], const float w[3]) {
  constexpr int s0 = 4 >> A0, s1 = 4 >> A1, s2 = 4 >> A2;
#pragma unroll
  for (int i = 0; i < 8; ++i)
    if ((i & s0) == 0) v[i] = lerp(v[i], v[i | s0], w[A0]);
#pragma unroll
  for (int i = 0; i < 8; ++i)
    if ((i & (s0 | s1)) == 0) v[i] = lerp(v[i], v[i | s1], w[A1]);
  return lerp(v[0], v[s2], w[A2]);
}

// The two maps' values at the taps of one output voxel, resampled.
// Load(vox) returns the (CLE, PSE) pair of input voxel vox as float2.
template <int A0, int A1, int A2, typename Load>
__device__ __forceinline__ float2 voxel(const Taps& t, int in1, int in2,
                                        Load load) {
  float c[8], p[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int j0 = (i & 4) ? t.i1[0] : t.i0[0];
    const int j1 = (i & 2) ? t.i1[1] : t.i0[1];
    const int j2 = (i & 1) ? t.i1[2] : t.i0[2];
    const float2 x = load(((int64_t)j0 * in1 + j1) * in2 + j2);
    c[i] = x.x;
    p[i] = x.y;
  }
  return make_float2(resample<A0, A1, A2>(c, t.w),
                     resample<A0, A1, A2>(p, t.w));
}

__device__ __forceinline__ unsigned quantise(float x) {
  return __float2uint_rz(__fmul_rn(fminf(fmaxf(x, 0.f), 1.f), 255.f));
}

struct UpArgs {
  const __half2* half;   // (B, d, h, w) pairs
  const uint8_t* ess;    // (B, D, H, W)
  const int* table;      // one entry: (D, H, W) from (d, h, w)
  float2* out;           // (B, D, H, W) pairs
  int d, h, w, D, H, W;
};

template <int A0, int A1, int A2>
__device__ __forceinline__ void upsample_voxel(const UpArgs& a, int b,
                                               int64_t n) {
  const int o[3] = {(int)(n / ((int64_t)a.H * a.W)), (int)(n / a.W % a.H),
                    (int)(n % a.W)};
  const Taps t = load_taps(a.table, o);
  const __half2* src = a.half + (int64_t)b * a.d * a.h * a.w;
  const int64_t N = (int64_t)a.D * a.H * a.W;
  float2 r = voxel<A0, A1, A2>(t, a.h, a.w, [&](int64_t v) {
    return __half22float2(src[v]);
  });
  if (__ldg(a.ess + b * N + n) == 0) r = make_float2(0.f, 0.f);
  a.out[b * N + n] = r;
}

__global__ void __launch_bounds__(MT) heatmap_upsample_kernel(UpArgs a) {
  const int64_t n = (int64_t)blockIdx.x * MT + threadIdx.x;
  const int b = blockIdx.y;
  if (n >= (int64_t)a.D * a.H * a.W) return;
  switch (__ldg(a.table + 3)) {
    case 0: upsample_voxel<0, 1, 2>(a, b, n); break;
    case 1: upsample_voxel<0, 2, 1>(a, b, n); break;
    case 2: upsample_voxel<1, 0, 2>(a, b, n); break;
    case 3: upsample_voxel<1, 2, 0>(a, b, n); break;
    case 4: upsample_voxel<2, 0, 1>(a, b, n); break;
    default: upsample_voxel<2, 1, 0>(a, b, n); break;
  }
}

struct CropArgs {
  const float2* maps;    // (B, D, H, W) pairs
  const int* table;      // B entries: each scan's crop from (D, H, W)
  uint8_t* out;          // (B, 2, N)
  int D, H, W;
  int64_t N;             // row length, a multiple of 16
};

template <int A0, int A1, int A2>
__device__ __forceinline__ void crop_voxels(const CropArgs& a, int b,
                                            const int* __restrict__ e,
                                            int64_t n0, int64_t count) {
  const int n1 = __ldg(e + 1), n2 = __ldg(e + 2);
  int o[3] = {(int)(n0 / ((int64_t)n1 * n2)), (int)(n0 / n2 % n1),
              (int)(n0 % n2)};
  const float2* src = a.maps + (int64_t)b * a.D * a.H * a.W;
  unsigned q[kMaps][kVox];
#pragma unroll
  for (int k = 0; k < kVox; ++k) {
    q[0][k] = q[1][k] = 0;
    if (n0 + k < count) {
      const Taps t = load_taps(e, o);
      const float2 r = voxel<A0, A1, A2>(t, a.H, a.W, [&](int64_t v) {
        return src[v];
      });
      q[0][k] = quantise(r.x);
      q[1][k] = quantise(r.y);
    }
    if (++o[2] == n2) {   // the next voxel in row-major order
      o[2] = 0;
      if (++o[1] == n1) {
        o[1] = 0;
        ++o[0];
      }
    }
  }
#pragma unroll
  for (int c = 0; c < kMaps; ++c) {
    uint8_t* row = a.out + ((int64_t)b * kMaps + c) * a.N + n0;
    if (n0 + kVox <= count) {
      *reinterpret_cast<unsigned*>(row) =
          q[c][0] | q[c][1] << 8 | q[c][2] << 16 | q[c][3] << 24;
    } else {
      for (int k = 0; k < kVox && n0 + k < count; ++k)
        row[k] = (uint8_t)q[c][k];
    }
  }
}

__global__ void __launch_bounds__(MT) heatmap_crops_kernel(CropArgs a) {
  const int b = blockIdx.y;
  const int* __restrict__ e = a.table + b * kEntry;
  const int64_t count = (int64_t)__ldg(e) * __ldg(e + 1) * __ldg(e + 2);
  const int64_t n0 = ((int64_t)blockIdx.x * MT + threadIdx.x) * kVox;
  if (n0 >= count) return;
  switch (__ldg(e + 3)) {
    case 0: crop_voxels<0, 1, 2>(a, b, e, n0, count); break;
    case 1: crop_voxels<0, 2, 1>(a, b, e, n0, count); break;
    case 2: crop_voxels<1, 0, 2>(a, b, e, n0, count); break;
    case 3: crop_voxels<1, 2, 0>(a, b, e, n0, count); break;
    case 4: crop_voxels<2, 0, 1>(a, b, e, n0, count); break;
    default: crop_voxels<2, 1, 0>(a, b, e, n0, count); break;
  }
}

}  // namespace
}  // namespace dram

extern "C" int heatmap_upsample(const void* half, const uint8_t* ess,
                                const int* table, float* out, int B, int d,
                                int h, int w, int D, int H, int W,
                                void* stream) {
  using namespace dram;
  if (B <= 0 || B > 65535 || d <= 0 || h <= 0 || w <= 0 || D <= 0 ||
      H <= 0 || W <= 0 || table == nullptr)
    return (int)cudaErrorInvalidValue;
  const int64_t N = (int64_t)D * H * W;
  const dim3 grid((unsigned)((N + MT - 1) / MT), (unsigned)B);
  heatmap_upsample_kernel<<<grid, MT, 0, static_cast<cudaStream_t>(stream)>>>(
      UpArgs{static_cast<const __half2*>(half), ess, table,
             reinterpret_cast<float2*>(out), d, h, w, D, H, W});
  return (int)cudaGetLastError();
}

extern "C" int heatmap_crops(const float* maps, const int* table,
                             uint8_t* out, int B, int D, int H, int W,
                             int N, void* stream) {
  using namespace dram;
  if (B <= 0 || B > 65535 || D <= 0 || H <= 0 || W <= 0 || N <= 0 ||
      N % 16 != 0 || table == nullptr)
    return (int)cudaErrorInvalidValue;
  const int64_t per_block = (int64_t)MT * kVox;
  const dim3 grid((unsigned)((N + per_block - 1) / per_block), (unsigned)B);
  heatmap_crops_kernel<<<grid, MT, 0, static_cast<cudaStream_t>(stream)>>>(
      CropArgs{reinterpret_cast<const float2*>(maps), table, out, D, H, W,
               (int64_t)N});
  return (int)cudaGetLastError();
}

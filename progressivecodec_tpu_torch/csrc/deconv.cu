// g_s's transposed convolution for Hopper (sm_90a): ConvTranspose2d with
// kernel 5, stride 2, padding 2 and output_padding 1, float32, NCHW.
//
// Replaces no Pallas kernel: the JAX package leaves its transposed
// convolutions to XLA (progressivecodec_tpu/ops/conv.py), and the port ran
// them on cuDNN's deterministic backward-data algorithms.  Plain PyTorch
// version: progressivecodec_tpu_torch/ops/deconv_cuda.py:deconv2d_subpixel
// (four stride-1 convolutions); the port's CPU path is F.conv_transpose2d.
// The kernel has no backward: under autograd the port keeps cuDNN.
//
// What it computes, by the sub-pixel split.  Output pixel (2i+a, 2j+b)
// gathers input (i+dy, j+dx) through tap (ky, kx) = (a+2-2dy, b+2-2dx),
// dy, dx in {-1, 0, 1}, for the taps that lie in 0..4: 3 rows for a = 0,
// 2 for a = 1, and the same in x.  The four phases are four stride-1
// convolutions of 3x3, 3x2, 2x3 and 2x2 taps over the input, 25 taps in
// all per input position and output channel: no inserted zeros.
//   y[n, co, 2i+a, 2j+b] = bias[co] + sum_ci sum_(dy,dx) x[n, ci, i+dy, j+dx]
//                                      * w[ci, co, a+2-2dy, b+2-2dx]
// Each output is summed over ci in ascending order, then dy, then dx, by
// one thread in float32 FMA, and written once: no atomics, no TF32, the
// same bits on every run.
//
// What bounds it: float32 FMA.  At 768x512 the four layers are 32.1 GMAC,
// 64.2 GFLOP (0.96 ms at the H100 SXM's 66.9 TFLOP/s), and their bytes are
// two orders of magnitude below the FLOPs at the HBM rate.
//
// What the design does about it:
//   * A CTA takes a tile of input positions (8*WM rows by 4*P columns) and
//     a tile of output channels.  Per stage it brings kChunk input
//     channels of the input tile with a one-pixel halo and the matching
//     weights, all 25 taps of its channel tile, into shared memory with
//     cp.async, two stages deep, zero-filled outside the map and past Cin.
//     Each staged input element serves all four phases and all 25 taps.
//   * A warp covers 8 x 4P positions and CPT output channels: lane l holds
//     row l/4 and the columns l%4 + 4k, k < P, so each scalar load of the
//     input reads 32 banks (rows 20 floats apart in shared memory).  A
//     thread keeps 4 phases x P positions x CPT channels in registers; per
//     input channel it loads 9P input values and, per tap, its CPT weights
//     as float4 broadcasts, and issues 25*P*CPT FMAs.
//   * Weights come packed (Cin, 25, Cout) by the wrapper, so a tap's
//     channels are contiguous: 16-byte copies, float4 reads.
//   * Epilogue: bias, then each thread stores its (2j, 2j+1) pairs as
//     float2; the four lanes of a row write 32 contiguous bytes, so every
//     sector is written whole.
//   * Two instances, chosen by Cout (ops/deconv_cuda.py:plan).  "wide"
//     (WM 1, WN 4, CPT 8, P 2: 32 channels and 8x8 positions per CTA, 138
//     registers, three CTAs per SM) for Cout > 3, padded to 32; at 768x512
//     its first layer launches 144 CTAs.  "narrow" (WM 4, WN 1, CPT 3, P 4:
//     32x16 positions, Cout padded to 4 in the packing) for g_s's last
//     layer, 3 channels.  Measured against 16- and 64-channel tiles, P 4
//     with 32 channels (255 registers, two CTAs per SM) and narrow tiles of
//     8 and 16 rows, these were the fastest at every g_s layer of 768x512
//     (batch 1 and 8) and 2048x1024 (PERF.md, PR 20).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kK = 5;
constexpr int kTaps = kK * kK;
constexpr int kRows = 8;        // input rows of a warp's tile (lane / 4)
constexpr int kLaneCols = 4;    // lanes along a row (lane % 4)
constexpr int kChunk = 8;       // input channels per stage
constexpr int kStages = 2;
// Shared-memory floats per staged row: 20*r mod 32 is a distinct multiple
// of 4 for r < 8, so the lanes (r, c < 4) of a load hit 32 distinct banks.
constexpr int kStride = 20;
constexpr int kMaxDevices = 64;

// WM x WN warps: WM along rows, WN along output channels; CPT output
// channels and P positions (kLaneCols apart on its row) per thread.
template <int WM, int WN, int CPT, int P>
struct Tile {
  static constexpr int kThreads = 32 * WM * WN;
  static constexpr int kCols = kLaneCols * P;  // input columns of a tile
  static constexpr int kHaloCols = kCols + 2;
  static constexpr int kCps = (CPT + 3) / 4 * 4;  // packed channels of a warp
  static constexpr int kCot = WN * kCps;          // packed channels of a CTA
  static constexpr int kTileRows = kRows * WM;
  static constexpr int kXRows = kTileRows + 2;
  static constexpr int kXPlane = kXRows * kStride;
  static constexpr int kXStage = kChunk * kXPlane;
  static constexpr int kWStage = kChunk * kTaps * kCot;
  static constexpr int kStage = kXStage + kWStage;
  static constexpr int kSmemBytes = kStages * kStage * 4;
  static_assert(kXStage % 4 == 0, "weights of a stage start on 16 bytes");
  static_assert(kHaloCols <= kStride, "a staged row fits its stride");
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Input channels [c0, c0 + kChunk) of the tile at (i0, j0) with its halo,
// and their packed weights for channels [co0, co0 + kCot), into one stage.
template <class T>
__device__ __forceinline__ void load_stage(float* sx, float* sw, const float* __restrict__ x,
                                           const float* __restrict__ wp, int n, int cin, int h,
                                           int w, int coutp, int c0, int i0, int j0, int co0) {
  constexpr int kHaloCols = T::kHaloCols;
  constexpr int kPlane = T::kXRows * kHaloCols;
  for (int e = threadIdx.x; e < kChunk * kPlane; e += T::kThreads) {
    const int ci = e / kPlane;
    const int rem = e - ci * kPlane;
    const int rr = rem / kHaloCols;
    const int cc = rem - rr * kHaloCols;
    const int c = c0 + ci, gi = i0 - 1 + rr, gj = j0 - 1 + cc;
    const bool ok = c < cin && gi >= 0 && gi < h && gj >= 0 && gj < w;
    const float* src = ok ? x + ((static_cast<int64_t>(n) * cin + c) * h + gi) * w + gj : x;
    cp_async4(sx + ci * T::kXPlane + rr * kStride + cc, src, ok);
  }
  constexpr int kRow = kTaps * T::kCot;
  for (int e = threadIdx.x; e < kChunk * kRow / 4; e += T::kThreads) {
    const int f = 4 * e;
    const int ci = f / kRow;
    const int rem = f - ci * kRow;
    const int t = rem / T::kCot;
    const int q = rem - t * T::kCot;
    const int c = c0 + ci;
    const bool ok = c < cin;
    const float* src = ok ? wp + (static_cast<int64_t>(c) * kTaps + t) * coutp + co0 + q : wp;
    cp_async16(sw + f, src, ok);
  }
}

// One stage into the accumulators.  xs: the thread's first input value
// (its row, column c, the halo's top-left); ws: its warp's channels.
template <class T, int CPT, int P>
__device__ __forceinline__ void compute_stage(const float* xs, const float* ws,
                                              float (&acc)[2][2][P][CPT]) {
#pragma unroll 1
  for (int ci = 0; ci < kChunk; ++ci) {
    const float* xc = xs + ci * T::kXPlane;
    const float* wc = ws + ci * kTaps * T::kCot;
#pragma unroll
    for (int dyi = 0; dyi < 3; ++dyi) {  // dy = dyi - 1
      float xv[P][3];
#pragma unroll
      for (int k = 0; k < P; ++k)
#pragma unroll
        for (int dxi = 0; dxi < 3; ++dxi) xv[k][dxi] = xc[dyi * kStride + kLaneCols * k + dxi];
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const int ky = a + 4 - 2 * dyi;
        if (ky > 4) continue;
#pragma unroll
        for (int dxi = 0; dxi < 3; ++dxi) {
#pragma unroll
          for (int b = 0; b < 2; ++b) {
            const int kx = b + 4 - 2 * dxi;
            if (kx > 4) continue;
            float wv[T::kCps];
            const float4* w4 = reinterpret_cast<const float4*>(wc + (ky * kK + kx) * T::kCot);
#pragma unroll
            for (int v = 0; v < T::kCps / 4; ++v) {
              const float4 t4 = w4[v];
              wv[4 * v] = t4.x;
              wv[4 * v + 1] = t4.y;
              wv[4 * v + 2] = t4.z;
              wv[4 * v + 3] = t4.w;
            }
#pragma unroll
            for (int k = 0; k < P; ++k)
#pragma unroll
              for (int q = 0; q < CPT; ++q) acc[a][b][k][q] = fmaf(xv[k][dxi], wv[q], acc[a][b][k][q]);
          }
        }
      }
    }
  }
}

template <int WM, int WN, int CPT, int P>
__global__ void __launch_bounds__(32 * WM * WN)
deconv_s2k5_kernel(const float* __restrict__ x, const float* __restrict__ wp,
                   const float* __restrict__ bias, float* __restrict__ y, int cin, int cout,
                   int coutp, int h, int w, int tiles_w, int co_tiles) {
  using T = Tile<WM, WN, CPT, P>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);

  const int n = blockIdx.y;
  const int co_tile = blockIdx.x % co_tiles;
  const int pos = blockIdx.x / co_tiles;
  const int i0 = (pos / tiles_w) * T::kTileRows;
  const int j0 = (pos % tiles_w) * T::kCols;
  const int co0 = co_tile * T::kCot;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp / WN, wn = warp % WN;
  const int r = wm * kRows + lane / kLaneCols, c = lane % kLaneCols;

  float acc[2][2][P][CPT];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b)
#pragma unroll
      for (int k = 0; k < P; ++k)
#pragma unroll
        for (int q = 0; q < CPT; ++q) acc[a][b][k][q] = 0.f;

  const int chunks = (cin + kChunk - 1) / kChunk;
  load_stage<T>(smem, smem + T::kXStage, x, wp, n, cin, h, w, coutp, 0, i0, j0, co0);
  cp_async_commit();
  for (int s = 0; s < chunks; ++s) {
    if (s + 1 < chunks) {
      float* next = smem + ((s + 1) % kStages) * T::kStage;
      load_stage<T>(next, next + T::kXStage, x, wp, n, cin, h, w, coutp, (s + 1) * kChunk, i0,
                    j0, co0);
    }
    cp_async_commit();  // an empty group after the last chunk keeps the count
    cp_async_wait<1>();
    __syncthreads();
    const float* cur = smem + (s % kStages) * T::kStage;
    compute_stage<T, CPT, P>(cur + r * kStride + c, cur + T::kXStage + wn * T::kCps, acc);
    __syncthreads();
  }

  const int i = i0 + r;
  if (i >= h) return;
  const int64_t ow = 2 * static_cast<int64_t>(w);
#pragma unroll
  for (int q = 0; q < CPT; ++q) {
    const int co = co0 + wn * T::kCps + q;
    if (co >= cout) continue;
    const float bq = bias ? bias[co] : 0.f;
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      float* yr = y + ((static_cast<int64_t>(n) * cout + co) * 2 * h + 2 * i + a) * ow;
#pragma unroll
      for (int k = 0; k < P; ++k) {
        const int j = j0 + c + kLaneCols * k;
        if (j < w)
          *reinterpret_cast<float2*>(yr + 2 * j) =
              make_float2(acc[a][0][k][q] + bq, acc[a][1][k][q] + bq);
      }
    }
  }
}

template <int WM, int WN, int CPT, int P>
int launch(const float* x, const float* wp, const float* bias, float* y, int batch, int cin,
           int cout, int coutp, int h, int w, cudaStream_t stream) {
  using T = Tile<WM, WN, CPT, P>;
  if (coutp % T::kCot != 0 || cout > coutp || (CPT < T::kCps && coutp != T::kCot))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool attr_set[kMaxDevices] = {};  // one attribute call per instance and device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!attr_set[dev]) {
    e = cudaFuncSetAttribute(deconv_s2k5_kernel<WM, WN, CPT, P>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmemBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set[dev] = true;
  }
  const int tiles_h = (h + T::kTileRows - 1) / T::kTileRows;
  const int tiles_w = (w + T::kCols - 1) / T::kCols;
  const int co_tiles = coutp / T::kCot;
  const dim3 grid(tiles_h * tiles_w * co_tiles, batch);
  deconv_s2k5_kernel<WM, WN, CPT, P><<<grid, T::kThreads, T::kSmemBytes, stream>>>(
      x, wp, bias, y, cin, cout, coutp, h, w, tiles_w, co_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// instance 0: wide (32 channels, 8x8 positions); 1: narrow (3 channels).
// x (batch, cin, h, w), wp (cin, 25, coutp) packed and 16-byte aligned,
// bias (cout,) or null, y (batch, cout, 2h, 2w); float32, contiguous.
extern "C" int deconv_s2k5(int instance, const void* x, const void* wp, const void* bias, void* y,
                           int batch, int cin, int cout, int coutp, int h, int w, void* stream) {
  if (batch <= 0 || cin <= 0 || h <= 0 || w <= 0 || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* xf = static_cast<const float*>(x);
  const auto* wf = static_cast<const float*>(wp);
  const auto* bf = static_cast<const float*>(bias);
  auto* yf = static_cast<float*>(y);
  auto* s = static_cast<cudaStream_t>(stream);
  switch (instance) {
    case 0: return launch<1, 4, 8, 2>(xf, wf, bf, yf, batch, cin, cout, coutp, h, w, s);
    case 1: return launch<4, 1, 3, 4>(xf, wf, bf, yf, batch, cin, cout, coutp, h, w, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

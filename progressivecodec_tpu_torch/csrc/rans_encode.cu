// PCT1 interleaved-rANS encode scan for Hopper (sm_90a).
//
// Replaces the TPU kernel progressivecodec_tpu/coder/rans_pallas.py:
// encode_scan_rev_pallas (and its XLA twin rans_device.encode_scan_rev).
// Plain PyTorch twin: progressivecodec_tpu_torch/coder/rans_cuda.py:
// rans_encode_scan_plain.
//
// What it computes: K independent 32-bit rANS lanes walk P rows that the
// caller already reversed into encode order.  Per row and lane, with
// sf = start<<16 | freq and keep flag k:
//   freq = k ? freq : 1
//   flag = k && state >= freq<<16     (renormalise: emit the low 16 bits)
//   word = state & 0xFFFF             (written for every cell)
//   state = flag ? state>>16 : state
//   state = k ? (state/freq)<<16 + state%freq + start : state
// Outputs: final states (K), words (P,K) u16, flags (P,K) u8.
//
// What bounds it: each lane is a chain of P dependent steps, so the time is
// P times the latency of one step, not the 8 bytes per cell it moves (about
// 2.4 us at the flagship grid).  Measured on the first design (one row
// ahead, native u32 / and %), a row took 183 ns, 108 of them the division.
//
// What the design does about it:
//   * The division leaves the chain's slow path.  After the renorm,
//     y < freq<<16 <= 2^32, so q = y / freq < 2^16.  With r = an
//     approximate float reciprocal of freq (rcp.approx, within 1 ulp,
//     computed from the tile and not from the state), q' = trunc(float(y)
//     * r) is within 2^16 * 2^-22 < 1 of y / freq, so q' is q - 1, q or
//     q + 1; one test of y - q'*freq against 0 and freq corrects it.  The
//     chain is then renorm test -> I2F -> FMUL -> F2I -> multiply-subtract
//     -> two compares -> multiply-add, with no branch, so the unrolled rows
//     of a tile interleave their off-chain work with it.
//   * sf and keep arrive through a ring of kStages tiles of kTileRows rows
//     in shared memory, loaded by cp.async two to three tiles (32-48 rows)
//     ahead of the chain.
//   * One warp per CTA, one lane per thread, so the K/32 CTAs spread over as
//     many SMs; each row's word and flag stores are coalesced (64 and 32
//     bytes per warp).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kRansL = 1u << 16;
constexpr int kTileRows = 16;
constexpr int kStages = 4;

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 1/f within 1 ulp, without the slow path of the IEEE reciprocal.
__device__ __forceinline__ float approx_rcp(uint32_t f) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(static_cast<float>(f)));
  return r;
}

// One cell: word and flag out, the state after it returned.
__device__ __forceinline__ uint32_t encode_cell(uint32_t x, uint32_t sf, bool keep, uint16_t* word,
                                                uint8_t* flag_out) {
  const uint32_t start = sf >> 16;
  const uint32_t freq = keep ? (sf & 0xFFFFu) : 1u;
  const float rcp = approx_rcp(freq);
  const bool flag = keep && x >= (freq << 16);
  *word = static_cast<uint16_t>(x & 0xFFFFu);
  *flag_out = flag ? 1 : 0;
  const uint32_t y = flag ? x >> 16 : x;
  const uint32_t q0 = __float2uint_rz(__uint2float_rn(y) * rcp);
  const int r0 = static_cast<int>(y - q0 * freq);
  const uint32_t q = q0 - (r0 < 0 ? 1u : 0u) + (r0 >= static_cast<int>(freq) ? 1u : 0u);
  // (q << 16) + y % freq == y + q * (65536 - freq)
  return keep ? y + start + q * (65536u - freq) : x;
}

__global__ void __launch_bounds__(32)
rans_encode_scan_kernel(const uint32_t* __restrict__ sf, const uint8_t* __restrict__ kp,
                        uint32_t* __restrict__ states, uint16_t* __restrict__ words,
                        uint8_t* __restrict__ flags, int rows, int lanes) {
  __shared__ __align__(16) uint32_t sf_s[kStages][kTileRows][32];
  __shared__ __align__(16) uint8_t kp_s[kStages][kTileRows][32];
  const int t = threadIdx.x;
  const int col0 = blockIdx.x * 32;
  const int lane = col0 + t;
  const int tiles = (rows + kTileRows - 1) / kTileRows;

  // tile `tile` into slot tile % kStages: sf 16 rows x 128 B (4 copies per
  // thread), keep 16 rows x 32 B (1 copy per thread); rows past P zero-fill
  auto issue = [&](int tile) {
    const int slot = tile % kStages;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = t + 32 * j;
      const int row = c >> 3;
      const int part = 4 * (c & 7);
      const int grow = tile * kTileRows + row;
      const bool in = grow < rows;
      cp_async16(&sf_s[slot][row][part], in ? sf + static_cast<size_t>(grow) * lanes + col0 + part : sf,
                 in ? 16 : 0);
    }
    const int row = t >> 1;
    const int part = 16 * (t & 1);
    const int grow = tile * kTileRows + row;
    const bool in = grow < rows;
    cp_async16(&kp_s[slot][row][part], in ? kp + static_cast<size_t>(grow) * lanes + col0 + part : kp,
               in ? 16 : 0);
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < tiles) issue(s);
    cp_async_commit();
  }

  uint32_t x = kRansL;
  for (int tile = 0; tile < tiles; ++tile) {
    cp_async_wait<kStages - 2>();
    __syncwarp();
    if (tile + kStages - 1 < tiles) issue(tile + kStages - 1);
    cp_async_commit();
    const int slot = tile % kStages;
    const int r0 = tile * kTileRows;
    const size_t i0 = static_cast<size_t>(r0) * lanes + lane;
    if (r0 + kTileRows <= rows) {
      // a whole tile, unrolled: the reciprocals and loads of later rows are
      // scheduled among the chain's steps
#pragma unroll
      for (int j = 0; j < kTileRows; ++j) {
        const size_t i = i0 + static_cast<size_t>(j) * lanes;
        x = encode_cell(x, sf_s[slot][j][t], kp_s[slot][j][t] != 0, words + i, flags + i);
      }
    } else {  // the last, partial tile
      for (int j = 0; j < rows - r0; ++j) {
        const size_t i = i0 + static_cast<size_t>(j) * lanes;
        x = encode_cell(x, sf_s[slot][j][t], kp_s[slot][j][t] != 0, words + i, flags + i);
      }
    }
  }
  cp_async_wait<0>();
  states[lane] = x;
}

}  // namespace

// C interface for ctypes.  Every pointer is a device pointer; `stream` is a
// cudaStream_t.  Needs lanes % 32 == 0 and sf, kp 16-byte aligned.  Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int rans_encode_scan(const void* sf, const void* kp, void* states, void* words,
                                void* flags, int rows, int lanes, void* stream) {
  if (lanes <= 0 || lanes % 32 != 0) return static_cast<int>(cudaErrorInvalidValue);
  rans_encode_scan_kernel<<<lanes / 32, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(sf), static_cast<const uint8_t*>(kp),
      static_cast<uint32_t*>(states), static_cast<uint16_t*>(words),
      static_cast<uint8_t*>(flags), rows, lanes);
  return static_cast<int>(cudaGetLastError());
}

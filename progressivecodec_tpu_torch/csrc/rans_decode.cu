// PCT1 interleaved-rANS decode scan of one stage, for Hopper (sm_90a).
//
// Replaces progressivecodec_tpu/coder/rans_device.py:decode_stage_scan and
// its PCT1-G form decode_stage_grouped, XLA lax.scans with no Pallas
// version (PyTorch has no scan, and a Python loop would cost about ten
// launches per row).  Plain PyTorch twins:
// progressivecodec_tpu_torch/coder/rans_cuda.py:rans_decode_scan_plain and
// rans_decode_scan_grouped_plain, which reach each symbol through the
// 64 MiB dec_sf table instead.
//
// What it computes: K lanes walk P rows in decode order.  Per row and lane,
// with CDF row idx and keep flag k:
//   cum  = state & 0xFFFF                      (emitted for every cell)
//   s    = the symbol of row idx whose [start, start + freq) holds cum
//   adv  = freq*(state>>16) + cum - start
//   flag = k && adv < L
// The flagged lanes take renorm words from the shared stream in lane order:
// lane j reads stream[offset + rank_j], rank_j being the number of flagged
// lanes below j; then offset += number of flagged lanes and
// state = k ? (flag ? adv<<16 | word : adv) : state.
// Outputs: cums (P,K) i32, final states (K) and final offset.
//
// PCT1-G (grouped): the K lanes form G groups of kt = K/G lanes; group g
// owns lanes [g*kt, (g+1)*kt), its own stream row and its own offset, and
// the rank and the offset above run within the group.  One launch decodes
// every group: CTA g is group g.  The single stream is the case G = 1.
//
// What bounds it: the lanes are coupled through that prefix count and the
// shared offset, so a launch takes P times the latency of one row plus a
// prologue that brings the stage's table on chip, not bytes: the bytes it
// moves (about 9 per cell) would take a few microseconds.  The row is a
// chain of dependent shared-memory loads (bucket, search steps for the
// worst of the K lanes, starts, counts, ring word), and the K/32 warps share
// one SM's shared-memory pipe; PERF.md gives the row's split.  The
// prologue, split on an H100 (chip_smoke.scan_split: one-row less zero-row
// launches, less one row; PERF.md), took 2.5 us per stage for the
// single stream, and before the grouped redesign below 2.6 / 3.3 / 9.7 us
// at G = 2 / 4 / 16 (kt = 256 / 128 / 32: the CTA's own warps issued
// ~12,000 16-byte cp.async, one warp alone at G = 16); after it 2.4 / 2.4 /
// 2.6 us, beside ~163 rows per stage at 440-715 ns each.
//
// What the design does about it: one CTA of kt threads per group (rounded
// up to whole warps; a padding thread keeps nothing, takes no word and
// stores nothing), one lane each, and nothing but shared memory on the
// row's dependent chain.
//   * The stage's CDF rows (starts as u16, the row's n+1 entries, the last
//     one 65536 stored as 0) come into dynamic shared memory at launch, with
//     a bucket table per row: bucket b holds the symbol at cum = b << shift,
//     and a flag when the bucket holds only freq-1 symbols (the tails of a
//     wide row), whose start is cum itself.  A lookup is one bucket load
//     and, unless flagged, a 4-ary search between two buckets, which is
//     empty for most cells; the search loop is warp-uniform.  The host
//     picks the finest shift that fits the budget and builds the stage's
//     bucket table at that shift on first use (rans_cuda.CompactCdf).
//   * The grouped launch's table (190-227 KB at K=512) comes by bulk
//     copies completed on an mbarrier, not by thousands of 16-byte cp.async
//     from the CTA's own threads: one thread arms the barrier with the
//     table's bytes, the first warp issues the copies, they land while the
//     rings' cp.async prologue runs, and row 0 waits on the barrier's
//     phase.  Its G CTAs run as thread-block clusters of c CTAs (c the
//     largest divisor of G up to 8, rans_cuda.decode_cluster; each CTA is a
//     whole SM of one GPC, since the table takes nearly all of its shared
//     memory): each CTA issues 1/c of the table multicast to every CTA of
//     its cluster, so L2 serves the table once per cluster (0.5-0.8 us per
//     stage less than the same copies without a cluster).  A relaxed
//     cluster barrier after every CTA has armed its barrier (whose
//     initialisation fence.mbarrier_init releases to the cluster) orders
//     the multicasts after their targets' arming; a cluster of one runs the
//     same barriers (ordering thread 0's arming before its warp's copies),
//     which the card measured no slower than skipping them.  A second,
//     split cluster barrier (arrive once the CTA's table has landed, wait
//     before exit) keeps a CTA from exiting while a multicast copy it
//     issued may still be writing into a peer: distributed shared memory
//     must not be accessed after its CTA exits, and a CTA's own barrier
//     only says that its own copy has landed.  The arrive is off the row's chain, and by
//     exit every peer has long arrived.  The single stream keeps its
//     threads' cp.async prologue: its 16 warps take 2.5 us, and the bulk
//     copies without a cluster took 2.9 us at G = 2 and 4.
//   * A stage whose rows do not fit at any shift runs the same search over
//     the compact table in global memory (table_in_smem = 0), copies no
//     table and launches without a cluster.
//   * The stream ahead of offset lives in a ring in shared memory, refilled
//     by cp.async 256 words per warp every kRefill rows, kRefill rows before
//     it is read (one commit and one wait per refill); reads past the end
//     of the stream give 0 (zero-filled copies).
//   * idx and keep come kDepth rows ahead through a ring of the same kind;
//     a lane reads its next row's inputs at the top of the current row, off
//     the chain.  The copies are 16 bytes, so a group's columns are read in
//     place only when kt % 16 == 0; the wrapper stages other groups into
//     padded blocks of whole warps first.
//   * The renorm rank: __ballot_sync + __popc within the warp; each warp's
//     count is one byte in shared memory, so after the one __syncthreads of
//     the row lane l of every warp reads warp l's count and two
//     __reduce_add_sync give the counts below the warp and the total.
//   * A group of one warp (kt <= 32, kOneWarp) takes the rank and the total
//     from its ballot alone: no count bytes, no __syncthreads and no
//     __reduce_add_sync on its row.  Its lanes read each other's ring
//     copies, so a refill row waits for its copies and then __syncwarp()s,
//     which also orders the ring slots' earlier reads before their refill.
//     At kt = 32 it took 439 ns against 531 ns before the redesign; in an
//     earlier build of this kernel, 458 ns against 498 ns with the exchange
//     row (PERF.md).
//   * A stream or group of kt > 1024 lanes, more than one CTA holds, spans
//     C CTAs of w threads (kSpan; rans_cuda.decode_span: C = 8 and w = kt / 8
//     up to 8192 lanes, then the fewest CTAs of at most 1024, C <= 64),
//     CTA c taking lanes [c * w, (c + 1) * w).  Every CTA of the group
//     reads the group's whole stream and keeps its offset, and a lane's
//     word lies at the offset plus the flagged lanes of the lower CTAs plus
//     its rank in its own CTA, so after each row's count the C CTAs
//     exchange their totals (span_exchange).  Up to 8 CTAs the group is a
//     thread-block cluster: the totals travel by st.async into the peers'
//     shared memory, completing on a barrier per row parity, and the table
//     comes by the cluster's multicast copies as in the grouped launch.
//     Above 8 (kt > 8192) the group's CTAs are a share of a cooperative
//     grid, every CTA resident, the totals through global memory.  A
//     flagged lane reads its word straight from the stream in global
//     memory, where it sits in L2 (ring_words 0): a ring of the group's
//     whole window in each CTA (2 * kRefill * C * w words, refilled by all
//     its warps) made the row 5 ns faster at K = 2048 and 129 ns slower at
//     K = 4096, where it took the shared memory of a finer bucket table,
//     and its prologue made the stages slower at both (PERF.md).  On an
//     H100 the exchange cost ~370 ns a row at 2 to 8 CTAs of up to 512 lanes
//     with that ring, as much at 2 and 4 CTAs as at 8 (PERF.md, the spanning
//     rows' split table), so a full cluster of the narrowest CTAs is the
//     default; without the ring, 349-412 ns at 8 CTAs of 192 to 1024 lanes
//     and ~1,270 ns on the grid of 16 (PERF.md, after the ring's A/B).

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr uint32_t kRansL = 1u << 16;
constexpr int kRefill = 4;                // rows from a ring refill to the next
constexpr int kDepth = kRefill + 2;       // rows of idx / keep loaded ahead
constexpr int kSlots = kDepth + kRefill - 1;  // rows of idx / keep in the ring
constexpr int kChunk = 256;               // stream words per warp copy: 32 threads x 16 B
constexpr uint32_t kRunFlag = 0x8000u;    // bucket of freq-1 symbols only
constexpr uint32_t kBulkBytes = 8192;     // table bytes per bulk copy
constexpr int kMaxCluster = 8;            // the portable cluster size
constexpr int kMaxSpan = 64;              // CTAs of one stream: 65,535 lanes in CTAs of 1,024

struct DecodeArgs {
  const uint32_t* states_in;  // (K,)
  const int32_t* offset_in;   // (G,)
  const uint16_t* stream;     // group g's row at stream + g * n_stream
  long long n_stream;         // words of each row; reads past it give 0
  const int32_t* idx;         // group g's (P, kt) block at idx + g * in_group,
  const uint8_t* kp;          // rows in_row apart; the same for kp
  long long in_group;
  int in_row;
  const uint16_t* starts;   // compact CDF table, all rows
  const uint16_t* buckets;  // the stage's rows of the table at `shift`
  const int2* meta;         // (R,) {base in starts, n symbols}
  int row0, nrows;          // the stage's rows [row0, row0 + nrows)
  int span_base, span_len;  // their entries in starts (multiples of 8)
  int shift, bucket_stride; // buckets in shared memory
  int ring_words;           // stream ring, a power of two
  uint32_t* states_out;  // (K,)
  int32_t* offset_out;   // (G,)
  int32_t* cums;         // (P, K): group g's columns from g * kt
  int rows, kt;          // rows and lanes of one group
  int lanes;             // threads per CTA: kt rounded up to whole warps, or
                         // the group's share of C CTAs (kSpan)
  int ctas;              // CTAs per group (kSpan; 1 otherwise)
  uint32_t* xchg;        // the grid path's row totals: (G, 2, ctas), -1 at launch
};

struct Layout {
  int bases, starts, buckets, idx, kp, ring, bar, xchg, total;
};

__host__ __device__ inline int round16(int b) { return (b + 15) & ~15; }

__host__ __device__ inline Layout layout(const DecodeArgs& a, bool table_in_smem, bool span) {
  Layout l;
  int off = 64;  // warp counts, two rows of 32 bytes
  l.bases = off;
  l.starts = l.buckets = off;
  if (table_in_smem) {
    off += round16(a.nrows * 2);  // u16 row bases
    l.starts = off;
    off += round16(a.span_len * 2);
    l.buckets = off;
    off += round16(a.nrows * a.bucket_stride * 2);
  }
  l.idx = off;
  off += kSlots * a.lanes * 4;
  l.kp = off;
  off += kSlots * a.lanes;
  l.ring = off;
  off += a.ring_words * 2;
  // the table's mbarrier last: placed after the warp counts, it shifts every
  // region by 16 bytes, and the card measured the single stream's prologue
  // 1.2 us and the grouped row up to 40 ns slower so (PERF.md)
  l.bar = off;
  off += 16;
  // a spanning stream's row totals, two rows of kMaxSpan words, and the
  // cluster's two row barriers
  l.xchg = off;
  if (span) off += 2 * kMaxSpan * 4 + 16;
  l.total = off;
  return l;
}

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

// The table's completion barrier, its bulk copies and the cluster.
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_arm(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
}
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t cluster_size() {
  uint32_t n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n));
  return n;
}
// Relaxed: the arrivals order no memory (fence.mbarrier_init releases the
// barriers' initialisation to the cluster).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}
// The spanning stream's exchange.  On the cluster path a CTA sends its row
// total into each peer's slot by an asynchronous store over distributed
// shared memory that completes on the peer's row barrier; on the grid path
// the totals go through global memory.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void st_async_peer(const uint32_t* slot, const uint64_t* bar, uint32_t peer,
                                              uint32_t v) {
  uint32_t rs, rb;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(rs) : "r"(smem_u32(slot)), "r"(peer));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(rb) : "r"(smem_u32(bar)), "r"(peer));
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.u32 [%0], %1, [%2];\n" ::"r"(rs),
               "r"(v), "r"(rb)
               : "memory");
}
__device__ __forceinline__ void st_release_gpu(uint32_t* p, uint32_t v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}
__device__ __forceinline__ uint32_t ld_acquire_gpu(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// One row's exchange between the C CTAs of a spanning stream (kSpan): the
// CTA's `total` (its flagged lanes) goes to every CTA of its group, each
// warp reads the C totals back, `before` gains those of the lower CTAs and
// `total` becomes the group's.  The slots alternate between two rows; a CTA
// writes row r + 2 into a slot only after it has the reader's total of row
// r + 1, which the reader sends after reading row r.
//   kSpan 1, a cluster: warp 0's lane p stores the total into CTA p's slot
// with st.async, which completes on CTA p's barrier of the row's parity;
// every warp waits on its own barrier (armed for C * 4 bytes), and thread 0
// arms it again for row r + 2.  No thread polls: the card measured all warps
// polling their slots 320 ns a row slower, and warp 0 polling alone behind
// a CTA barrier 90 ns slower (PERF.md).
//   kSpan 2, a cooperative grid: thread 0 publishes the total in global
// memory with release, tagged with its row ((r mod 2^20) << 12 | total, the
// slots filled with 0xFFFFFFFF at launch), warp 0 polls the C slots with
// acquire and copies them into shared memory, and a CTA barrier hands them
// to the other warps.
template <int kSpan>
__device__ __forceinline__ void span_exchange(const DecodeArgs& a, uint32_t* xchg_s, uint64_t* row_bar, int g,
                                              int rank, int r, int warp, int wl, uint32_t& before,
                                              uint32_t& total) {
  uint32_t* slots = xchg_s + (r & 1) * kMaxSpan;
  if (kSpan == 1) {
    uint64_t* bar = row_bar + (r & 1);
    if (warp == 0 && wl < a.ctas) st_async_peer(slots + rank, bar, wl, total);
    mbar_wait(bar, (r >> 1) & 1);
    if (warp == 0 && wl == 0 && r + 2 < a.rows) mbar_expect(bar, 4u * a.ctas);
  } else {
    const uint32_t tag = static_cast<uint32_t>(r) & 0xFFFFFu;
    uint32_t* gs = a.xchg + (static_cast<size_t>(g) * 2 + (r & 1)) * a.ctas;
    if (warp == 0) {
      if (wl == 0) st_release_gpu(gs + rank, (tag << 12) | total);
      for (int c = wl; c < a.ctas; c += 32) {
        uint32_t v = ld_acquire_gpu(gs + c);
        while ((v >> 12) != tag) v = ld_acquire_gpu(gs + c);
        slots[c] = v & 0xFFFu;
      }
    }
    __syncthreads();
  }
  const uint32_t lo = wl < a.ctas ? slots[wl] : 0u;
  const uint32_t hi = kSpan == 2 && wl + 32 < a.ctas ? slots[wl + 32] : 0u;
  before += __reduce_add_sync(0xFFFFFFFFu, (wl < rank ? lo : 0u) + (wl + 32 < rank ? hi : 0u));
  total = __reduce_add_sync(0xFFFFFFFFu, lo + hi);
}

// The table's copies: `bytes` at src into the same offsets of dst in every
// CTA of the cluster, completing on each CTA's barrier at `bar`, in chunks
// of kBulkBytes.  Chunk k is issued by CTA k % ncta, lane (k / ncta) % 32
// of its first warp; the caller is that warp.
__device__ __forceinline__ void bulk_table(void* dst, const void* src, uint32_t bytes, uint64_t* bar,
                                           uint32_t rank, uint32_t ncta, int wl) {
  const uint32_t n = (bytes + kBulkBytes - 1) / kBulkBytes;
  const uint16_t mask = static_cast<uint16_t>((1u << ncta) - 1u);
  for (uint32_t k = rank + ncta * wl; k < n; k += 32 * ncta) {
    const uint32_t off = k * kBulkBytes, len = min(kBulkBytes, bytes - off);
    const uint32_t d = smem_u32(static_cast<unsigned char*>(dst) + off);
    const void* s = static_cast<const unsigned char*>(src) + off;
    if (ncta == 1)
      asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
                   ::"r"(d), "l"(s), "r"(len), "r"(smem_u32(bar))
                   : "memory");
    else
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster"
          " [%0], [%1], %2, [%3], %4;\n" ::"r"(d),
          "l"(s), "r"(len), "r"(smem_u32(bar)), "h"(mask)
          : "memory");
  }
}

// This thread's share of a refill of kRefill rows of idx and keep: one
// 16-byte copy of idx (row j_idx of the refill, column c_idx), and one of
// keep for threads below lanes / 4; none for a chunk that starts at or past
// the group's kt columns.  Fixed per thread, worked out once.
struct RowCopy {
  int j_idx, c_idx, j_kp, c_kp;  // j < 0: no copy
};

template <bool kGrouped>
__device__ __forceinline__ RowCopy row_copy(int lanes, int kt) {
  const int t = threadIdx.x;
  const int q = lanes >> 2;   // idx copies per row
  const int qk = lanes >> 4;  // keep copies per row
  RowCopy c;
  c.c_idx = 4 * (t % q);
  c.j_idx = !kGrouped || c.c_idx < kt ? t / q : -1;
  c.c_kp = 16 * (t % qk);
  c.j_kp = t < kRefill * qk && (!kGrouped || c.c_kp < kt) ? t / qk : -1;
  return c;
}

// Rows [r0, r0 + kRefill) of this group's idx and keep (those below
// `rows`) into ring slots row % kSlots.
template <bool kGrouped>
__device__ __forceinline__ void issue_rows(const DecodeArgs& a, const RowCopy& c, const int32_t* idx,
                                           const uint8_t* kp, int32_t* idx_ring, uint8_t* kp_ring,
                                           int r0) {
  const int rr = r0 + c.j_idx;
  if ((!kGrouped || c.j_idx >= 0) && rr < a.rows)
    cp_async16(idx_ring + (rr % kSlots) * a.lanes + c.c_idx,
               idx + static_cast<size_t>(rr) * a.in_row + c.c_idx, 16);
  const int rk = r0 + c.j_kp;
  if (c.j_kp >= 0 && rk < a.rows)
    cp_async16(kp_ring + (rk % kSlots) * a.lanes + c.c_kp,
               kp + static_cast<size_t>(rk) * a.in_row + c.c_kp, 16);
}

// Stream chunk c (words [c*kChunk, (c+1)*kChunk)) of this group's row into
// the ring, by one warp.
__device__ __forceinline__ void issue_chunk(const DecodeArgs& a, const uint16_t* stream, uint16_t* ring,
                                            long long c) {
  const int wl = threadIdx.x & 31;
  const long long p0 = c * kChunk + 8 * wl;
  const long long avail = a.n_stream - p0;
  const int bytes = avail >= 8 ? 16 : (avail > 0 ? static_cast<int>(avail) * 2 : 0);
  cp_async16(ring + ((c * kChunk) & (a.ring_words - 1)) + 8 * wl, bytes ? stream + p0 : stream, bytes);
}

// kGrouped = false is the single stream: one CTA, kt = lanes, so the group
// offsets and the padding tests compile away.  kOneWarp: a grouped CTA of
// one warp (lanes == 32).  kSpan (grouped): each group spans a.ctas CTAs of
// a.lanes threads, CTA rank c taking the group's lanes [c * lanes, (c + 1) *
// lanes); 1: the group is a thread-block cluster, 2: a share of a
// cooperative grid.
template <bool kSmemTable, bool kGrouped, bool kOneWarp, int kSpan>
__global__ void __launch_bounds__(1024) rans_decode_scan_kernel(const DecodeArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout l = layout(a, kSmemTable, kSpan != 0);
  uint8_t* counts = smem;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + l.bar);  // the table's copies
  uint16_t* base_s = reinterpret_cast<uint16_t*>(smem + l.bases);  // rows' first entries
  uint16_t* starts_s = reinterpret_cast<uint16_t*>(smem + l.starts);
  uint16_t* bucket_s = reinterpret_cast<uint16_t*>(smem + l.buckets);
  int32_t* idx_ring = reinterpret_cast<int32_t*>(smem + l.idx);
  uint8_t* kp_ring = smem + l.kp;
  uint16_t* ring = reinterpret_cast<uint16_t*>(smem + l.ring);
  uint32_t* xchg_s = reinterpret_cast<uint32_t*>(smem + l.xchg);  // kSpan: the row totals
  uint64_t* row_bar = reinterpret_cast<uint64_t*>(xchg_s + 2 * kMaxSpan);  // kSpan 1: the rows' barriers

  const int t = threadIdx.x;
  const int rank = kSpan ? static_cast<int>(blockIdx.x) % a.ctas : 0;  // the CTA's place in its group
  const int g = kSpan ? static_cast<int>(blockIdx.x) / a.ctas : kGrouped ? blockIdx.x : 0;  // the group
  // kept at run time in the one-warp row too: with lanes = 32 and warp = 0
  // compiled in, its row ran ~80 ns slower on the card (PERF.md)
  const int lanes = a.lanes;
  const int warp = t >> 5;
  const int wl = t & 31;
  const int nwarps = lanes >> 5;
  const unsigned below = (1u << wl) - 1u;
  const int ring_mask = a.ring_words - 1;
  const int ring_chunks = a.ring_words / kChunk;
  const int ncols = kSpan ? min(lanes, a.kt - rank * lanes) : a.kt;  // the CTA's lanes of its group
  const bool live = !kGrouped || t < ncols;  // not a padding thread
  const int lane = g * a.kt + rank * lanes + t;  // column in the (P, K) grids
  const uint16_t* stream = a.stream + g * a.n_stream;
  const int32_t* idx = a.idx + g * a.in_group + rank * lanes;
  const uint8_t* kp = a.kp + g * a.in_group + rank * lanes;

  uint32_t x = live ? a.states_in[lane] : kRansL;
  int offset = a.offset_in[g];
  // the same for every CTA of a launch, so a cluster returns here whole
  if (a.rows == 0) {
    if (live) a.states_out[lane] = x;
    if (t == 0 && rank == 0) a.offset_out[g] = offset;
    return;
  }

  // ---- prologue: the table (by bulk copies in the grouped launch, by the
  // CTA's cp.async in the single stream), the first kDepth rows and a full
  // stream ring (none when spanning) by cp.async, all in flight together
  constexpr bool kBulk = kSmemTable && kGrouped && kSpan != 2;
  const uint32_t ncta = kBulk ? cluster_size() : 1u;
  const uint32_t starts_bytes = 2u * a.span_len;
  const uint32_t bucket_bytes = 2u * a.nrows * a.bucket_stride;
  if (kBulk && t == 0) mbar_arm(bar, starts_bytes + bucket_bytes);
  if (kSpan == 1 && t == 0) {
    // rows 0 and 1 wait for the C totals' bytes; each is armed again later
    mbar_arm(row_bar, 4u * a.ctas);
    mbar_arm(row_bar + 1, 4u * a.ctas);
  }
  for (int e = t; e < 64; e += lanes) counts[e] = 0;
  if (kSmemTable) {
    for (int e = t; e < a.nrows; e += lanes) {
      const int2 m = a.meta[a.row0 + e];
      base_s[e] = static_cast<uint16_t>(m.x - a.span_base);
    }
  }
  if (kSmemTable && !kBulk) {
    for (int c = t; c < a.span_len / 8; c += lanes)
      cp_async16(starts_s + 8 * c, a.starts + a.span_base + 8 * c, 16);
    for (int c = t; c < a.nrows * a.bucket_stride / 8; c += lanes)
      cp_async16(bucket_s + 8 * c, a.buckets + 8 * c, 16);
  }
  const RowCopy rcopy = row_copy<kGrouped>(lanes, ncols);
  for (int rr = 0; rr < kDepth; rr += kRefill)
    issue_rows<kGrouped>(a, rcopy, idx, kp, idx_ring, kp_ring, rr);
  long long filled = offset / kChunk;  // next chunk to copy
  for (int c = warp; c < ring_chunks; c += nwarps) issue_chunk(a, stream, ring, filled + c);
  filled += ring_chunks;
  cp_async_commit();
  if (kBulk || kSpan == 1) {
    // every CTA of the cluster has armed its barriers before any copy or
    // total lands (in a cluster of one: the issuing warp sees thread 0's
    // arming)
    cluster_arrive();
    cluster_wait();
    if (kBulk && warp == 0) {
      const uint32_t crank = cluster_rank();
      bulk_table(starts_s, a.starts + a.span_base, starts_bytes, bar, crank, ncta, wl);
      bulk_table(bucket_s, a.buckets, bucket_bytes, bar, crank, ncta, wl);
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  if (kBulk) {
    mbar_wait(bar, 0);
    cluster_arrive();  // this CTA's table has landed; waited on at exit
  }

  // this lane's inputs of row rr: keep, its CDF row's entries and buckets
  struct RowIn {
    bool keep;
    int rbase, rn, bbase;
  };
  auto load_row = [&](int rr) {
    const int slot = (rr % kSlots) * lanes + t;
    RowIn in;
    in.keep = live && rr < a.rows && kp_ring[slot] != 0;
    const int rel = min(max(idx_ring[slot] - a.row0, 0), a.nrows - 1);
    in.bbase = rel * a.bucket_stride;
    in.rn = 1;
    if (kSmemTable) {
      in.rbase = base_s[rel];
    } else {
      const int2 m = a.meta[a.row0 + rel];
      in.rbase = m.x;
      in.rn = m.y;
    }
    return in;
  };
  RowIn cur = load_row(0);
  const uint16_t* starts = kSmemTable ? starts_s : a.starts;

  size_t i = lane;
  const size_t out_row = kSpan ? static_cast<size_t>(gridDim.x / a.ctas) * a.kt
                         : kGrouped ? static_cast<size_t>(gridDim.x) * a.kt : lanes;  // K
  for (int r = 0; r < a.rows; ++r, i += out_row) {
    // the next row's inputs do not depend on the state: their loads go out
    // first and land while this row's chain runs
    const RowIn next_in = load_row(r + 1);
    const bool keep = cur.keep;
    const int rbase = cur.rbase, rn = cur.rn, bbase = cur.bbase;
    const uint32_t cum = x & 0xFFFFu;
    if (live) a.cums[i] = static_cast<int32_t>(cum);
    // every lane runs the lookup (a lane that keeps nothing searches an
    // empty range), so a warp leaves the search loop together
    uint32_t lo, hi, e = 0u;
    if (kSmemTable) {
      const uint16_t* bk = bucket_s + bbase + (cum >> a.shift);
      e = bk[0];
      lo = e & ~kRunFlag;
      hi = bk[1] & ~kRunFlag;
    } else {
      lo = 0u;
      hi = static_cast<uint32_t>(rn - 1);
    }
    const bool run = (e & kRunFlag) != 0u;  // start = cum, freq = 1
    if (!keep || run) hi = lo;
    const uint16_t* st = starts + rbase;
    // 4-ary search for the last entry <= cum in [lo, hi] (st[lo] <= cum
    // holds throughout): three probes per step, loaded together by the
    // lanes still searching
    while (__any_sync(0xFFFFFFFFu, lo < hi)) {
      if (lo < hi) {
        const uint32_t w = hi - lo;
        const uint32_t m1 = lo + (w + 3u) / 4u, m2 = lo + (2u * w + 3u) / 4u;
        const uint32_t m3 = lo + (3u * w + 3u) / 4u;
        const bool b1 = st[m1] <= cum, b2 = st[m2] <= cum, b3 = st[m3] <= cum;
        hi = b3 ? hi : b2 ? m3 - 1u : b1 ? m2 - 1u : m1 - 1u;
        lo = b3 ? m3 : b2 ? m2 : b1 ? m1 : lo;
      }
    }
    const uint32_t start = run ? cum : st[lo];
    const uint32_t next = run ? cum + 1u : ((static_cast<uint32_t>(st[lo + 1]) - 1u) & 0xFFFFu) + 1u;
    uint32_t adv = (next - start) * (x >> 16) + cum - start;
    const bool flag = keep && adv < kRansL;
    const unsigned ballot = __ballot_sync(0xFFFFFFFFu, flag);
    uint32_t before, total;
    if (kOneWarp) {
      // the copies of the last refill, kRefill rows ago, have landed, and
      // every lane's reads of the slots refilled below are done
      if (r % kRefill == 0) {
        cp_async_wait<0>();
        __syncwarp();
      }
      before = 0u;
      total = __popc(ballot);
    } else {
      uint8_t* cnt = counts + 32 * (r & 1);
      if (wl == 0) cnt[warp] = static_cast<uint8_t>(__popc(ballot));
      if (r % kRefill == 0) cp_async_wait<0>();
      __syncthreads();
      // lane l holds warp l's count (0 past the last warp); two warp sums
      const uint32_t c = cnt[wl];
      before = __reduce_add_sync(0xFFFFFFFFu, wl < warp ? c : 0u);
      total = __reduce_add_sync(0xFFFFFFFFu, c);
      if (kSpan) span_exchange<kSpan>(a, xchg_s, row_bar, g, rank, r, warp, wl, before, total);
    }
    // every lane reads (the ring index is masked), only flagged lanes use it
    const int pos = offset + static_cast<int>(before) + __popc(ballot & below);
    // a spanning stream has no ring: the word comes from global memory
    const uint32_t word = kSpan ? (flag && pos < a.n_stream ? stream[pos] : 0u) : ring[pos & ring_mask];
    if (flag) adv = (adv << 16) | word;
    if (keep) x = adv;

    // refill every kRefill rows: idx / keep kDepth rows ahead, the stream
    // chunks wholly below offset
    if (r % kRefill == 0) {
      issue_rows<kGrouped>(a, rcopy, idx, kp, idx_ring, kp_ring, r + kDepth);
      if (!kSpan) {
        const long long free_chunks = offset / kChunk + ring_chunks - filled;
        const int n_issue = static_cast<int>(min(free_chunks, static_cast<long long>(nwarps)));
        if (warp < n_issue) issue_chunk(a, stream, ring, filled + warp);
        filled += max(n_issue, 0);
      }
      cp_async_commit();
    }

    offset += static_cast<int>(total);
    cur = next_in;
  }
  cp_async_wait<0>();
  if (live) a.states_out[lane] = x;
  if (t == 0 && rank == 0) a.offset_out[g] = offset;
  // every peer's table has landed: no copy issued here still writes there
  if (kBulk) cluster_wait();
}

constexpr int kMaxDevices = 64;

template <bool kSmemTable, bool kGrouped, bool kOneWarp, int kSpan>
int launch(const DecodeArgs& a, int groups, int cluster, int smem_cap, cudaStream_t stream) {
  const int bytes = layout(a, kSmemTable, kSpan != 0).total;
  if (bytes > smem_cap) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = rans_decode_scan_kernel<kSmemTable, kGrouped, kOneWarp, kSpan>;
  // lift the kernel's dynamic shared-memory limit to the device's opt-in
  // maximum, once per device (setting it twice from racing threads is
  // harmless)
  static std::atomic<bool> lifted[kMaxDevices];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= kMaxDevices || !lifted[device].load(std::memory_order_relaxed)) {
    int optin = 0;
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (device < kMaxDevices) lifted[device].store(true, std::memory_order_relaxed);
  }
  // the grouped shared-table path runs as clusters of `cluster` CTAs, a
  // spanning group as a cluster of its a.ctas CTAs (kSpan 1) or as a share
  // of a cooperative grid, every CTA resident (kSpan 2); the single stream
  // and the grouped global-table path copy no table by bulk copies and have
  // none
  cudaLaunchAttribute attr[1];
  if (kSpan == 2) {
    attr[0].id = cudaLaunchAttributeCooperative;
    attr[0].val.cooperative = 1;
  } else {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = kSpan == 1 ? a.ctas : cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(groups * a.ctas);
  cfg.blockDim = dim3(a.lanes);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = (kSmemTable && kGrouped) || kSpan ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  const cudaError_t last = cudaGetLastError();  // and clear it
  return static_cast<int>(err != cudaSuccess ? err : last);
}

// Checks shared by every entry, then the launch of `groups` groups.
// kSpan = -1: a spanning launch, its route (cluster or grid) from `grid`.
template <bool kGrouped, int kSpan>
int run(DecodeArgs& a, int groups, int cluster, bool grid, const void* starts, const void* buckets,
        const void* meta, int row0, int nrows, int span_base, int span_len, int shift, int bucket_stride,
        int ring_words, int table_in_smem, int smem_cap, void* states_out, void* offset_out, void* cums,
        int rows, void* stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (groups < 1 || a.kt < 1 || a.lanes % 32 || a.lanes < 32 || a.lanes > 1024) return bad;
  if (kSpan == 0) {
    if (a.ctas != 1 || a.lanes < a.kt || a.lanes - a.kt >= 32) return bad;
    if (cluster < 1 || cluster > kMaxCluster || groups % cluster || (!table_in_smem && cluster != 1))
      return bad;
  } else {
    // every CTA holds at least one of its group's lanes
    if (a.ctas < 2 || a.ctas > (grid ? kMaxSpan : kMaxCluster) || a.ctas * a.lanes < a.kt ||
        (a.ctas - 1) * a.lanes >= a.kt || (grid && a.xchg == nullptr))
      return bad;
  }
  // a spanning stream has no ring
  if (kSpan == 0 ? ring_words < 2 * kRefill * a.lanes + kChunk || (ring_words & (ring_words - 1)) != 0
                 : ring_words != 0)
    return bad;
  if (nrows < 1 || a.in_row % 16 || a.in_group % 16 || rows < 0) return bad;
  if (table_in_smem && (shift < 1 || shift > 16 || bucket_stride % 8 || span_base % 8 ||
                        span_len % 8 || span_len > 65536))
    return bad;
  a.starts = static_cast<const uint16_t*>(starts);
  a.buckets = static_cast<const uint16_t*>(buckets);
  a.meta = static_cast<const int2*>(meta);
  a.row0 = row0;
  a.nrows = nrows;
  a.span_base = span_base;
  a.span_len = span_len;
  a.shift = shift;
  a.bucket_stride = bucket_stride;
  a.ring_words = ring_words;
  a.states_out = static_cast<uint32_t*>(states_out);
  a.offset_out = static_cast<int32_t*>(offset_out);
  a.cums = static_cast<int32_t*>(cums);
  a.rows = rows;
  auto s = static_cast<cudaStream_t>(stream);
  if (kSpan != 0) {
    if (grid)
      return table_in_smem ? launch<true, true, false, 2>(a, groups, 1, smem_cap, s)
                           : launch<false, true, false, 2>(a, groups, 1, smem_cap, s);
    return table_in_smem ? launch<true, true, false, 1>(a, groups, 1, smem_cap, s)
                         : launch<false, true, false, 1>(a, groups, 1, smem_cap, s);
  }
  // the one-warp row is the grouped launch's (kGrouped as kOneWarp: the
  // single stream instantiates no one-warp kernel)
  const bool one_warp = kGrouped && a.lanes == 32;
  if (table_in_smem)
    return one_warp ? launch<true, kGrouped, kGrouped, 0>(a, groups, cluster, smem_cap, s)
                    : launch<true, kGrouped, false, 0>(a, groups, cluster, smem_cap, s);
  return one_warp ? launch<false, kGrouped, kGrouped, 0>(a, groups, 1, smem_cap, s)
                  : launch<false, kGrouped, false, 0>(a, groups, 1, smem_cap, s);
}

DecodeArgs grouped_args(const void* states_in, const void* offset_in, const void* streams,
                        long long row_words, const void* idx, const void* kp, long long in_group,
                        int in_row, int kt, int lanes, int ctas) {
  DecodeArgs a;
  a.states_in = static_cast<const uint32_t*>(states_in);
  a.offset_in = static_cast<const int32_t*>(offset_in);
  a.stream = static_cast<const uint16_t*>(streams);
  a.n_stream = row_words;
  a.idx = static_cast<const int32_t*>(idx);
  a.kp = static_cast<const uint8_t*>(kp);
  a.in_group = in_group;
  a.in_row = in_row;
  a.kt = kt;
  a.lanes = lanes;
  a.ctas = ctas;
  a.xchg = nullptr;
  return a;
}

}  // namespace

// C interface for ctypes.  Every pointer is a device pointer; `stream` is a
// cudaStream_t.  The wrapper's plan_decode picks shift, bucket_stride and
// ring_words with the same layout; the launch refuses more than smem_cap
// bytes.  They need the compact table's arguments as planned, starts,
// buckets and the idx / keep blocks 16-byte aligned, and ring_words a power
// of two >= 2 * kRefill * (the CTA's threads) + kChunk (0 for a spanning
// stream, which reads its words from global memory).  They return
// cudaGetLastError() after the launch (0 = launched).

// One stream of `lanes` lanes: 32 <= lanes <= 1024, lanes % 32 == 0; idx
// and kp (rows, lanes), stream (n_stream,) with the stream 16-byte aligned.
extern "C" int rans_decode_scan(const void* states_in, const void* offset_in,
                                const void* stream_words, long long n_stream, const void* idx,
                                const void* kp, const void* starts, const void* buckets,
                                const void* meta, int row0, int nrows, int span_base, int span_len,
                                int shift, int bucket_stride, int ring_words, int table_in_smem,
                                int smem_cap, void* states_out, void* offset_out, void* cums,
                                int rows, int lanes, void* stream) {
  if (lanes < 32 || lanes > 1024 || lanes % 32 != 0) return static_cast<int>(cudaErrorInvalidValue);
  DecodeArgs a = grouped_args(states_in, offset_in, stream_words, n_stream, idx, kp, 0, lanes, lanes,
                              lanes, 1);
  return run<false, 0>(a, 1, 1, false, starts, buckets, meta, row0, nrows, span_base, span_len, shift,
                       bucket_stride, ring_words, table_in_smem, smem_cap, states_out, offset_out, cums,
                       rows, stream);
}

// G = `groups` streams of kt lanes each (K = groups * kt lanes in all),
// one CTA of `lanes` threads each (kt rounded up to whole warps, kt <=
// 1024), in clusters of `cluster` CTAs (1 <= cluster <= 8, a divisor of G;
// 1 on the global-table path).  A cluster that cannot be scheduled fails
// the launch.  states_in (K,), offset_in (G,), streams (G, row_words) with
// row_words % 8 == 0 when G > 1; group g's idx / kp block starts at element
// g * in_group and its rows lie in_row elements apart (in_row, in_group
// multiples of 16); cums (rows, K).
extern "C" int rans_decode_scan_grouped(const void* states_in, const void* offset_in,
                                        const void* streams, long long row_words, const void* idx,
                                        const void* kp, long long in_group, int in_row,
                                        const void* starts, const void* buckets, const void* meta,
                                        int row0, int nrows, int span_base, int span_len, int shift,
                                        int bucket_stride, int ring_words, int table_in_smem,
                                        int smem_cap, void* states_out, void* offset_out, void* cums,
                                        int rows, int groups, int kt, int lanes, int cluster,
                                        void* stream) {
  if (groups > 1 && row_words % 8) return static_cast<int>(cudaErrorInvalidValue);  // 16-byte aligned rows
  DecodeArgs a = grouped_args(states_in, offset_in, streams, row_words, idx, kp, in_group, in_row, kt,
                              lanes, 1);
  return run<true, 0>(a, groups, cluster, false, starts, buckets, meta, row0, nrows, span_base, span_len,
                      shift, bucket_stride, ring_words, table_in_smem, smem_cap, states_out, offset_out,
                      cums, rows, stream);
}

// The same for groups of kt > 1024 lanes, each spanning `ctas` CTAs of
// `lanes` threads (the last CTA holds the rest of the group): thread-block
// clusters of `ctas` CTAs (2 <= ctas <= 8), or with `grid` one cooperative
// grid of every group's CTAs (ctas <= 64) exchanging row totals through
// `xchg`, (groups, 2, ctas) uint32 filled with 0xFFFFFFFF.  A launch that
// cannot be scheduled (cluster or grid) fails.  Group g's idx / kp block
// holds ctas * lanes columns when staged (in_row = ctas * lanes), else kt.
extern "C" int rans_decode_scan_span(const void* states_in, const void* offset_in, const void* streams,
                                     long long row_words, const void* idx, const void* kp,
                                     long long in_group, int in_row, const void* starts,
                                     const void* buckets, const void* meta, int row0, int nrows,
                                     int span_base, int span_len, int shift, int bucket_stride,
                                     int ring_words, int table_in_smem, int smem_cap, void* states_out,
                                     void* offset_out, void* cums, int rows, int groups, int kt,
                                     int lanes, int ctas, int grid, void* xchg, void* stream) {
  if (groups > 1 && row_words % 8) return static_cast<int>(cudaErrorInvalidValue);
  DecodeArgs a = grouped_args(states_in, offset_in, streams, row_words, idx, kp, in_group, in_row, kt,
                              lanes, ctas);
  a.xchg = static_cast<uint32_t*>(xchg);
  return run<true, -1>(a, groups, 1, grid != 0, starts, buckets, meta, row0, nrows, span_base, span_len,
                       shift, bucket_stride, ring_words, table_in_smem, smem_cap, states_out, offset_out,
                       cums, rows, stream);
}

// Batch-invariant small-M matrix product for Hopper (sm_90a): the
// decode, verify and suffix-fill GEMMs of the serving path.
//
// No TPU kernel stands behind it: the JAX package takes these products
// as XLA einsums outside any Pallas kernel (paddle_tpu/models/gpt.py
// `_wmm` and the tied head).  The port needs a kernel of its own because
// of one property: every output row is a function of that row of x and
// of w alone, bit for bit, whatever M is.  cuBLAS picks its algorithm,
// its tiles and its split-K from M, so a verify pass (M = B (k + 1))
// and a decode step (M = B) rounded the same row differently, and a
// speculative stream left the plain one at near-ties.
//
// Contract: y [M, N] = x [M, K] @ w, x row-major with rows K apart; w
// either [K, N] with N contiguous ("kn", the layer weights) or [N, K]
// with K contiguous ("nk", the tied table read as wte.t()), rows ldw
// apart.  bfloat16 operands give bfloat16 or float32 output, float32
// operands float32.  K, N and ldw are multiples of 8 (16-byte rows for
// the tensor maps).  One launch takes at most 256 rows; the wrapper cuts
// larger M into chunks of 256 rows, which changes no row's arithmetic.
//
// What bounds it on the H100: the weight bytes.  Up to 256 rows a weight
// element feeds at most 512 operations (256 a byte of bf16), below the
// ~295 operations a byte at which the tensor cores would bind, so the
// least time is K N element bytes over 3.35 TB/s.  gpt3_1p3b, bf16: qkv
// 25.2 MB = 7.5 us, proj 8.4 MB = 2.5 us, fc1 and fc2 33.6 MB = 10.0 us,
// the head 206 MB = 61.5 us (its float32 output adds 1.6 MB at M 8).
//
// What held the first design (a block of 4 warps on 64 columns, mma.sync,
// a cp.async ring) at 0.21-0.53 of that bound at M 8 and 0.10-0.36 at
// M 32-64 (PERF.md, P1):
// * x was staged again by every 64-column tile: at M 64 as many L2 to SM
//   bytes of x as of weights (qkv 26 MB against 25 MB);
// * split-K partials went through device memory in float32 and the last
//   block of a tile summed them serially: at M 64 9.4 MB of traffic for
//   qkv's 25.2 MB of weights, 8.4 MB for proj's 8.4, and a scratch
//   allocation and arrival counters every call;
// * the grid did not divide evenly over the 132 SMs (qkv 288 blocks of
//   11 stages, proj 256 blocks of 4), so some SMs streamed a third more
//   bytes than others;
// * the same four warps issued the copies and the products; and at most
//   64 rows a launch, so a 128-row suffix pass read every weight twice.
//
// Design:
// * The operands are swapped: the kernel computes y^T = w^T x^T with
//   wgmma m64n64k16, the weights as the 64-row A operand and the rows of
//   x as B.  A block owns 128 weight columns: two consumer warpgroups of
//   64 columns each, so each staged x slice feeds 16 KB of weights (the
//   first design: 8 KB).  An "nk" tile is K-major A; a "kn" tile is
//   MN-major A (the instruction's transpose flag), so neither layout is
//   transposed by hand.  x is K-major B.
// * Rows go in fixed groups of 64, one m64n64k16 chain a group with its
//   own 32 accumulators a thread; a launch takes up to 4 groups (256
//   rows), and only the groups that hold rows are loaded and multiplied.
//   A row's arithmetic is the same instruction, K order and split at
//   every M: bit-identity holds by construction.
// * One thread of a producer warpgroup (its registers given to the
//   consumers by setmaxnreg: 40 against 232) issues 2-D TMA copies
//   (cp.async.bulk.tensor, the 128-byte swizzle that wgmma's descriptor
//   names) of the weight tile and of x's group slices into a ring of
//   192 KB for a block alone (8 stages at one group, 6 at two, 4 at
//   four) or 160 KB in a cluster (6, 5, 3): 48-128 KB of weights in
//   flight an SM, with full and empty mbarriers.  The consumers wait on
//   "full", run wgmma, keep one stage's products in flight and release
//   the stage before it.  The tensor maps are encoded on the host through the
//   driver entry point (no -lcuda) and cached by (address, shape,
//   stride, box): the weights' live as long as the engine, x's
//   addresses recur from the caching allocator.
// * The plan (the wrapper's row_gemm_plan) cuts a product into units of
//   (column tile, K split) from (K, N) and the card's SM and cluster
//   counts only, never from M: the K splits of a tile are the ranks of
//   one thread-block cluster (1-8), rank r owning stages
//   [r ks / C, (r + 1) ks / C); a persistent grid of q clusters walks the
//   tiles q apart, so every SM of the grid streams the same weight bytes
//   to within one unit.  The plan takes the cluster size that leaves the
//   busiest SM the fewest 16 KB stages, then the smaller cluster.
//   gpt3_1p3b on the H100 (132 SMs; clusters of 4 and 8 fit 30 and 15
//   times): qkv 48 tiles, C 2, 16 stages an SM on 96 SMs (the card's
//   mean 11.6); proj 16 tiles, C 4, 8 stages on 64 (3.9); fc1 64 tiles,
//   C 2, 16 on 128 (15.5); fc2 16 tiles of 128 stages, C 4, 32 on 64
//   (15.5); the head 393 tiles, no split, 3 tiles a block, 96 stages on
//   131 (95.3).  No size does better on that card: 48 and 16 tiles do
//   not spread over 15 clusters of 8 or 30 of 4.
// * Split-K is summed in the cluster: after a tile's run each rank
//   pushes its float32 partial of one row group, straight from the
//   accumulators, into the shared memory of the rank that owns each
//   16-column chunk (st.async through distributed shared memory,
//   completing on the owner's mbarrier: no fence, no remote read); the
//   owner sums the ranks' slots in rank order 0, 1, ..., C - 1, rounds
//   once and writes y with coalesced stores.  Two receive buffers
//   alternate by round, so no rank waits for another to have read.  A
//   block alone stores its partial in its own buffer.  No partials in
//   device memory, no counters, no allocation beside y.
// * float32 operands (the reference phases only) keep the CUDA-core
//   design: thread (c, r) sums column c of rows r, r + 2, ... in one
//   fmaf chain, k ascending; they take the same plan, the same cluster
//   sum and the same 256-row launches.
//
// Measured on the H100 (chip_smoke.py's row_gemm phase,
// tools/row_gemm_plans.py; PERF.md) and dropped:
// * a cluster sum by remote reads after cluster-scope release arrives,
//   which wait for the thread's outstanding stores: proj at M 8 took
//   13.1 us and fc2 21.6 against 11.8 and 20.1 with the pushes;
// * pushes by a block alone to itself: slower than plain stores once a
//   round carries many rows (one 4-byte remote store a value);
// * a lone producer warp (288 threads): the block is budgeted as three
//   warpgroups either way (168 registers), the 4-group instances
//   spilled and slowed, and setmaxnreg faults on a partial warpgroup;
// * waiting for each stage's products before releasing it (no gain),
//   and splitting K only until about half the SMs stream (slower once
//   the pushes made a split cheap).
// Clusters of 4 and 8 fit 30 and 15 times on the H100 (a cluster stays
// in one GPC), so qkv streams on 96 SMs and proj and fc2 on 64.  Any
// launch reads ~4.9 us of CUDA-event time (a one-cycle kernel); past
// that floor qkv, fc1 and fc2 stream at ~2.0-2.2 TB/s at M 8 and the
// head at 2.9, so the layer products sit near cuBLAS and the first
// design, and the head below both.

#include <cooperative_groups.h>
#include <cuda.h>

#include <cstdint>
#include <mutex>
#include <unordered_map>

#include "tc_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kBN = 128;            // weight columns a tile
constexpr int kBK = 64;             // K a stage: 128 bytes of bf16
constexpr int kGroup = 64;          // rows a group (wgmma's N)
constexpr int kMaxRows = 256;       // rows a launch: 4 groups
constexpr int kConsumers = 256;     // two warpgroups
constexpr int kThreads = kConsumers + 128;   // and the producer warpgroup
constexpr int kWBytes = kBN * kBK * 2;       // 16 KB of weights a stage
constexpr int kXBytes = kGroup * kBK * 2;    // 8 KB of x a group
constexpr int kChunk = 16;                   // columns a reduction chunk
constexpr int kChunks = kBN / kChunk;
constexpr int kRecvBytes = kGroup * kBN * 4;  // one round's receive buffer
// the ring and the receive buffers share 224 KB: two buffers and a
// 160 KB ring in a cluster, one buffer and a 192 KB ring alone
constexpr int kDataBytes = 229376;
constexpr int kBarBytes = 256;
constexpr int kSmemBytes = 1024 + kDataBytes + kBarBytes;

template <int G>
__host__ __device__ constexpr int stage_bytes() {
  return kWBytes + G * kXBytes;
}

// receive buffers of a cluster of C blocks: one alone, two alternating
__device__ __forceinline__ int recv_buffers(int C) { return C > 1 ? 2 : 1; }

template <int G>
__device__ __forceinline__ int ring_stages(int C) {
  return (kDataBytes - recv_buffers(C) * kRecvBytes) / stage_bytes<G>();
}

static_assert((kDataBytes - kRecvBytes) / stage_bytes<1>() * 16 + 16
                  <= kBarBytes, "mbarriers");
static_assert((kDataBytes - 2 * kRecvBytes) / stage_bytes<4>() >= 3,
              "ring depth");
static_assert(kSmemBytes <= 232448, "shared memory");

// ---------------------------------------------------------------------------
// mbarriers, TMA and wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// the same, acquiring at cluster scope what the other ranks released
__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar,
                                                  uint32_t parity) {
  const long long t0 = clock64();
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > kStallCycles) __trap();
  } while (!done);
}

// Registers a thread of this warpgroup may hold from here on.  The
// block's three warpgroups start at 168 registers a thread; the
// producer's (one thread of it issues the copies) gives most of its
// share to the two consumer warpgroups (128 x 40 + 256 x 232 <= 65536).
template <int R>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// the shared::cluster address of `addr` (a shared::cta address) in rank
// `rank`'s shared memory
__device__ __forceinline__ uint32_t mapa(uint32_t addr, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(addr), "r"(rank));
  return out;
}

// 4 bytes into a cluster rank's shared memory, completing on that rank's
// mbarrier `bar` (both shared::cluster addresses); asynchronous, no
// fence
__device__ __forceinline__ void st_async(uint32_t addr, float v,
                                         uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];\n" ::"r"(addr),
      "r"(__float_as_uint(v)), "r"(bar)
      : "memory");
}

// the cluster barrier in two halves (release, acquire)
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// 2-D tile (c0 innermost) of the tensor map into shared memory at dst;
// the bytes complete on the mbarrier
__device__ __forceinline__ void tma_2d(uint32_t dst, const CUtensorMap* map,
                                       uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma's shared-memory descriptor of a tile in the 128-byte swizzle
// (layout 1), 8-row groups 1024 bytes apart (the stride offset).  K-major
// (an "nk" weight tile, x): one swizzle row spans the 64 K values of a
// stage, the leading offset is unused, and the k16 steps advance the
// start by 32 bytes.  MN-major (a "kn" weight tile: rows are K, 128
// bytes of 64 columns each): the stride offset steps 8 K rows, the
// leading offset would step the next 64 columns (one block here), and
// the k16 steps advance the start by 16 rows = 2048 bytes.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lead) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | (static_cast<uint64_t>(lead >> 4) << 16)
         | (static_cast<uint64_t>(1024 >> 4) << 32)
         | (static_cast<uint64_t>(1) << 62);
}

// d (64 weight columns x 64 rows of x, float32) += A * B: A 64 x 16 by
// descriptor, K-major (TA 0) or MN-major (TA 1); B 64 x 16, K-major
template <int TA>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %35, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %34, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "n"(TA), "r"(1));
}

// keeps the compiler from moving accumulator reads across the
// asynchronous products' wait
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// the 256 threads that sum (the bf16 consumers; the whole f32 block)
__device__ __forceinline__ void sum_bar() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

__device__ __forceinline__ void store4(bf16* out, long long i, float4 v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&a);
  u.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(out + i) = u;
}

__device__ __forceinline__ void store4(float* out, long long i, float4 v) {
  *reinterpret_cast<float4*>(out + i) = v;
}

// ---------------------------------------------------------------------------
// The split-K sum in the cluster, one round a row group of a tile
// ---------------------------------------------------------------------------

// The K splits of a tile sum in the cluster, one round a row group.  The
// tile's 128 columns are 8 chunks of 16; rank p owns chunks p, p + C, ...
// (C divides 8).  Each rank pushes its float32 partial of a column
// straight from registers into the owner's receive buffer with st.async,
// slot [sender][chunk][row][column], which completes on the owner's
// "recv" mbarrier (no fence, no remote read); the owner sums the slots
// in rank order, rounds once and stores y.  Two receive buffers
// alternate by round: a sender fills buffer r % 2 of round r only after
// it has received the owner's round r - 1, which the owner sends after
// reading its round r - 2.  A block alone (C 1) writes its partial into
// its one buffer with plain stores instead: 4-byte remote stores to
// itself cost ~4 us a full 64-row group.
struct ClusterSum {
  uint32_t buf;       // receive buffer 0 (shared::cta; 1 follows)
  float* gbuf;        // the same, generic
  uint32_t recv;      // its mbarrier (buffer 1's at + 8)
  int C;
  int rank;

  // where this rank's partial of tile column `col` goes in round r: the
  // owner's slot of row 0 and its mbarrier (shared::cluster), or, alone,
  // this block's own slot
  struct Dest {
    uint32_t addr;
    uint32_t bar;
    float* own;
  };

  // before round r's pushes: one thread tells this rank's mbarrier the
  // bytes round r brings in (128 / C columns of `rows` rows from each of
  // the C ranks)
  __device__ __forceinline__ void begin(int r, int tid, int rows) const {
    if (C > 1 && tid == 0) {
      mbar_expect_tx(recv + 8 * (r & 1), static_cast<uint32_t>(kBN * rows * 4));
    }
  }

  __device__ __forceinline__ Dest dest(int r, int col) const {
    const int chunk = col / kChunk;
    if (C == 1) {
      return {0u, 0u, gbuf + chunk * kGroup * kChunk + col % kChunk};
    }
    const int owner = chunk % C;
    const int local = chunk / C;
    return {mapa(buf + (r & 1) * kRecvBytes
                     + ((rank * (kChunks / C) + local) * kGroup * kChunk
                        + col % kChunk) * 4,
                 owner),
            mapa(recv + 8 * (r & 1), owner), nullptr};
  }

  // row m of that column's partial
  __device__ __forceinline__ void put(const Dest& d, int m, float v) const {
    if (C == 1) {
      d.own[m * kChunk] = v;
    } else {
      st_async(d.addr + m * kChunk * 4, v, d.bar);
    }
  }

  // after this rank's puts of round r: wait for every rank's, sum this
  // rank's columns over the ranks in order and write rows [0, rows) of
  // the group to out (row-major, N columns; tile columns from n0)
  template <typename OutT>
  __device__ __forceinline__ void finish(int r, int tid, OutT* out,
                                         int rows, int N, int n0) const {
    if (C > 1) {
      mbar_wait_cluster(recv + 8 * (r & 1), (r >> 1) & 1);
    } else {
      sum_bar();   // every thread's partial is in
    }
    const float* in = gbuf + (C > 1 ? (r & 1) * (kRecvBytes / 4) : 0);
    const int chunks = kChunks / C;
    // an item is 4 columns of one row of one of this rank's chunks
    const int items = rows * chunks * (kChunk / 4);
    for (int i = tid; i < items; i += kConsumers) {
      const int f = i % (kChunk / 4);
      const int local = (i / (kChunk / 4)) % chunks;
      const int m = i / (kChunk / 4) / chunks;
      const int col = (rank + local * C) * kChunk + 4 * f;
      const float* at = in + (local * kGroup + m) * kChunk + 4 * f;
      float4 acc = *reinterpret_cast<const float4*>(at);
      for (int q = 1; q < C; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(
            at + q * chunks * kGroup * kChunk);
        acc.x += v.x;
        acc.y += v.y;
        acc.z += v.z;
        acc.w += v.w;
      }
      if (n0 + col < N) {
        store4(out, static_cast<long long>(m) * N + n0 + col, acc);
      }
    }
    // this buffer's reads are done before this rank's next pushes
    sum_bar();
  }
};

// ---------------------------------------------------------------------------
// bfloat16 operands: wgmma, TMA ring, producer warp
// ---------------------------------------------------------------------------

// One cluster walks tiles q, q + Q, ...; rank r of it owns K stages
// [r ks / C, (r + 1) ks / C) of each.  rows <= 64 G.
template <int G, bool NK, typename OutT>
__global__ void __launch_bounds__(kThreads, 1)
    row_gemm_bf16_kernel(const __grid_constant__ CUtensorMap wmap,
                         const __grid_constant__ CUtensorMap xmap,
                         OutT* __restrict__ out, int rows, int K, int N) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  // [receive buffers][ring][mbarriers], 1024-byte aligned
  const uint32_t base = (raw + 1023u) & ~1023u;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int S = ring_stages<G>(C);
  const uint32_t ring = base + recv_buffers(C) * kRecvBytes;
  const uint32_t bars = base + kDataBytes;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (S + s); };
  const ClusterSum sum{
      base, reinterpret_cast<float*>(smem_raw + (base - raw)),
      bars + 16 * S, C, static_cast<int>(cluster.block_rank())};
  const int q0 = blockIdx.x / C;
  const int Q = gridDim.x / C;
  const int ks = (K + kBK - 1) / kBK;
  const int s0 = sum.rank * ks / C;
  const int s1 = (sum.rank + 1) * ks / C;
  const int n_tiles = (N + kBN - 1) / kBN;
  const int gv = (rows + kGroup - 1) / kGroup;
  const int tid = threadIdx.x;

  if (tid == kConsumers) {
    prefetch_map(&wmap);
    prefetch_map(&xmap);
    for (int s = 0; s < S; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumers / 32);
    }
    mbar_init(sum.recv, 1);
    mbar_init(sum.recv + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // every rank's barriers exist before any thread waits on them or any
  // rank pushes to them; the producer starts its copies without waiting
  // (its own barriers), the others wait here
  if (C > 1) {
    cluster_arrive();
    if (tid < kConsumers) cluster_wait();
  } else {
    __syncthreads();
  }

  // the two roles never meet again (setmaxnreg needs it); no rank leaves
  // while a push to it is pending, since it waits for every push of
  // every round
  if (tid >= kConsumers) {
    regs_dec<40>();
    // the producer: one thread issues every copy
    if (tid == kConsumers) {
      int slot = 0;
      uint32_t phase = 0;
      for (int t = q0; t < n_tiles; t += Q) {
        const int n0 = t * kBN;
        // a "kn" tile's second half lies past N at N % 128 <= 64: it is
        // not loaded (its columns are never stored)
        const bool half = !NK && n0 + kBN / 2 >= N;
        const uint32_t tx = (half ? kWBytes / 2 : kWBytes) + gv * kXBytes;
        for (int s = s0; s < s1; ++s) {
          mbar_wait(empty(slot), phase ^ 1);
          const uint32_t st = ring + slot * stage_bytes<G>();
          mbar_expect_tx(full(slot), tx);
          const int k0 = s * kBK;
          if constexpr (NK) {
            tma_2d(st, &wmap, full(slot), k0, n0);   // [128 n][64 k]
          } else {
            tma_2d(st, &wmap, full(slot), n0, k0);   // [64 k][64 n] x 2
            if (!half) {
              tma_2d(st + kWBytes / 2, &wmap, full(slot), n0 + 64, k0);
            }
          }
          for (int g = 0; g < gv; ++g) {
            tma_2d(st + kWBytes + g * kXBytes, &xmap, full(slot), k0,
                   g * kGroup);
          }
          if (++slot == S) {
            slot = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    regs_inc<232>();
    // the consumers: warpgroup wg owns weight columns 64 wg .. 64 wg + 63
    const int wg = tid >> 7;
    const int lane = tid & 31;
    const uint32_t lead = NK ? 16u : 8192u;
    float acc[G][32];
    int slot = 0;
    uint32_t phase = 0;
    int round = 0;
    for (int t = q0; t < n_tiles; t += Q) {
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[g][i] = 0.f;
      int prev = 0;
      for (int s = s0; s < s1; ++s) {
        mbar_wait(full(slot), phase);
        const uint32_t st = ring + slot * stage_bytes<G>();
        const uint32_t wa = st + wg * (kWBytes / 2);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          const uint64_t da = NK ? sw128_desc(wa + 32 * kk, lead)
                                 : sw128_desc(wa + 2048 * kk, lead);
#pragma unroll
          for (int g = 0; g < G; ++g) {
            if (g < gv) {
              wgmma_m64n64k16<NK ? 0 : 1>(
                  acc[g], da,
                  sw128_desc(st + kWBytes + g * kXBytes + 32 * kk, 16u));
            }
          }
        }
        wgmma_commit();
        if (s > s0) {
          wgmma_wait<1>();            // the products of the stage before
          if (lane == 0) mbar_arrive(empty(prev));
        }
        prev = slot;
        if (++slot == S) {
          slot = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int g = 0; g < G; ++g) fence_acc(acc[g]);
      if (lane == 0) mbar_arrive(empty(prev));

      // accumulator i of group g: weight column 64 wg + 16 (warp % 4) +
      // lane / 4 + 8 ((i / 2) % 2), row 8 (i / 4) + 2 (lane % 4) + i % 2
      const int col = wg * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
      const int row = 2 * (lane & 3);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if (g < gv) {
          const int grows = min(rows - g * kGroup, kGroup);
          sum.begin(round, tid, grows);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const ClusterSum::Dest d = sum.dest(round, col + 8 * h);
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int m = 8 * j + row + e;
                if (m < grows) sum.put(d, m, acc[g][4 * j + 2 * h + e]);
              }
          }
          sum.finish(round, tid, out + static_cast<long long>(g) * kGroup * N,
                     grows, N, t * kBN);
          ++round;
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// float32 operands on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kF32Smem = (kBK * kBN + kGroup * kBK) * 4 + 2 * kRecvBytes + 16;

template <bool NK>
__global__ void __launch_bounds__(kConsumers, 1)
    row_gemm_f32_kernel(const float* __restrict__ x,
                        const float* __restrict__ w, float* __restrict__ out,
                        int rows, int K, int N, long long ldw) {
  extern __shared__ __align__(16) float fsmem[];
  float* sw = fsmem;                       // [kBK][kBN]
  float* sx = sw + kBK * kBN;              // [kGroup][kBK]
  float* recv = sx + kGroup * kBK;         // 2 x [kGroup][kBN]
  const uint32_t bars = smem_u32(recv + 2 * kRecvBytes / 4);
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const ClusterSum sum{smem_u32(recv), recv, bars, C,
                       static_cast<int>(cluster.block_rank())};
  const int q0 = blockIdx.x / C;
  const int Q = gridDim.x / C;
  const int ks = (K + kBK - 1) / kBK;
  const int s0 = sum.rank * ks / C;
  const int s1 = (sum.rank + 1) * ks / C;
  const int n_tiles = (N + kBN - 1) / kBN;
  const int gv = (rows + kGroup - 1) / kGroup;
  const int tid = threadIdx.x;
  const int c = tid & (kBN - 1);     // the column this thread sums
  const int r0 = tid / kBN;          // rows r0, r0 + 2, ...
  constexpr int kRowsPer = kGroup / 2;

  if (tid == 0) {
    mbar_init(sum.recv, 1);
    mbar_init(sum.recv + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster.sync();

  int round = 0;
  for (int t = q0; t < n_tiles; t += Q) {
    const int n0 = t * kBN;
    for (int g = 0; g < gv; ++g, ++round) {
      const float* xg = x + static_cast<long long>(g) * kGroup * K;
      const int grows = min(rows - g * kGroup, kGroup);
      float acc[kRowsPer];
#pragma unroll
      for (int i = 0; i < kRowsPer; ++i) acc[i] = 0.f;
      for (int s = s0; s < s1; ++s) {
        const int k0 = s * kBK;
        __syncthreads();   // the previous stage's reads are done
        for (int i = tid; i < kBK * kBN / 4; i += kConsumers) {
          float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
          if constexpr (NK) {
            // output column n0 + i / 16, k0 + 4 (i % 16) .. + 3
            const int r = i / (kBK / 4);
            const int q = (i % (kBK / 4)) * 4;
            if (n0 + r < N && k0 + q < K) {
              v = *reinterpret_cast<const float4*>(
                  w + static_cast<long long>(n0 + r) * ldw + k0 + q);
            }
            sw[q * kBN + r] = v.x;
            sw[(q + 1) * kBN + r] = v.y;
            sw[(q + 2) * kBN + r] = v.z;
            sw[(q + 3) * kBN + r] = v.w;
          } else {
            const int r = i / (kBN / 4);
            const int q = (i % (kBN / 4)) * 4;
            if (k0 + r < K && n0 + q < N) {
              v = *reinterpret_cast<const float4*>(
                  w + static_cast<long long>(k0 + r) * ldw + n0 + q);
            }
            *reinterpret_cast<float4*>(sw + r * kBN + q) = v;
          }
        }
        for (int i = tid; i < kGroup * kBK / 4; i += kConsumers) {
          const int m = i / (kBK / 4);
          const int q = (i % (kBK / 4)) * 4;
          float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
          if (m < grows && k0 + q < K) {
            v = *reinterpret_cast<const float4*>(
                xg + static_cast<long long>(m) * K + k0 + q);
          }
          *reinterpret_cast<float4*>(sx + m * kBK + q) = v;
        }
        __syncthreads();
#pragma unroll 4
        for (int k = 0; k < kBK; ++k) {
          const float wv = sw[k * kBN + c];
#pragma unroll
          for (int i = 0; i < kRowsPer; ++i) {
            acc[i] = fmaf(sx[(r0 + 2 * i) * kBK + k], wv, acc[i]);
          }
        }
      }
      sum.begin(round, tid, grows);
      const ClusterSum::Dest d = sum.dest(round, c);
#pragma unroll
      for (int i = 0; i < kRowsPer; ++i) {
        if (r0 + 2 * i < grows) sum.put(d, r0 + 2 * i, acc[i]);
      }
      sum.finish(round, tid, out + static_cast<long long>(g) * kGroup * N,
                 grows, N, n0);
    }
  }
}

// ---------------------------------------------------------------------------
// Host: tensor maps, launches
// ---------------------------------------------------------------------------

using EncodeFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                              void*, const cuuint64_t*, const cuuint64_t*,
                              const cuuint32_t*, const cuuint32_t*,
                              CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion,
                              CUtensorMapFloatOOBfill);

// codes past the CUDA runtime's: the driver's encoder is missing, or
// refused a map (kEncodeFailed + its CUresult)
constexpr int kNoEncoder = 100000;
constexpr int kEncodeFailed = 200000;

EncodeFn encoder() {
  static EncodeFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &status);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
    return err == cudaSuccess && status == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeFn>(p)
               : nullptr;
  }();
  return fn;
}

struct MapKey {
  uint64_t ptr, inner, outer, stride;
  uint32_t box_inner, box_outer;
  bool operator==(const MapKey& o) const {
    return ptr == o.ptr && inner == o.inner && outer == o.outer
           && stride == o.stride && box_inner == o.box_inner
           && box_outer == o.box_outer;
  }
};

struct MapHash {
  size_t operator()(const MapKey& k) const {
    uint64_t h = k.ptr;
    for (uint64_t v : {k.inner, k.outer, k.stride,
                       (static_cast<uint64_t>(k.box_inner) << 32)
                           | k.box_outer}) {
      h = (h ^ v) * 0x100000001b3ull;
    }
    return static_cast<size_t>(h ^ (h >> 29));
  }
};

// The tensor maps made so far: a map depends on nothing but its key, so
// a hit is always right (a new tensor at a reused address with another
// shape is another key).  Cleared when it grows past kMaxMaps.
constexpr size_t kMaxMaps = 4096;
std::mutex g_maps_mu;
std::unordered_map<MapKey, CUtensorMap, MapHash> g_maps;

// A bf16 2-D map of a row-major [outer, inner] matrix, rows `stride`
// elements apart, box [box_outer][box_inner] in the 128-byte swizzle,
// zeros past the edges.  0 or an error code.
int tensor_map(CUtensorMap* out, const void* ptr, uint64_t inner,
               uint64_t outer, uint64_t stride, uint32_t box_inner,
               uint32_t box_outer) {
  const MapKey key{reinterpret_cast<uint64_t>(ptr), inner, outer, stride,
                   box_inner, box_outer};
  std::lock_guard<std::mutex> lock(g_maps_mu);
  const auto it = g_maps.find(key);
  if (it != g_maps.end()) {
    *out = it->second;
    return 0;
  }
  const EncodeFn encode = encoder();
  if (encode == nullptr) return kNoEncoder;
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {stride * 2};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t step[2] = {1, 1};
  CUtensorMap map;
  const CUresult r = encode(
      &map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
      dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return kEncodeFailed + static_cast<int>(r);
  if (g_maps.size() >= kMaxMaps) g_maps.clear();
  g_maps.emplace(key, map);
  *out = map;
  return 0;
}

cudaLaunchConfig_t cluster_config(int blocks, int threads, int smem,
                                  cudaStream_t s, cudaLaunchAttribute* attr,
                                  int C) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

template <int G, bool NK, typename OutT>
int launch_bf16(const void* x, const void* w, void* out, int rows, int K,
                int N, long long ldw, int C, int Q, cudaStream_t s) {
  const auto kernel = row_gemm_bf16_kernel<G, NK, OutT>;
  static const cudaError_t ready = allow_smem(kernel, kSmemBytes);
  if (ready != cudaSuccess) return static_cast<int>(ready);
  CUtensorMap wmap;
  CUtensorMap xmap;
  int rc = NK ? tensor_map(&wmap, w, K, N, ldw, kBK, kBN)
              : tensor_map(&wmap, w, N, K, ldw, 64, kBK);
  if (rc != 0) return rc;
  rc = tensor_map(&xmap, x, K, rows, K, kBK, kGroup);
  if (rc != 0) return rc;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      cluster_config(Q * C, kThreads, kSmemBytes, s, attr, C);
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, wmap, xmap, static_cast<OutT*>(out), rows, K, N);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <bool NK>
int launch_f32(const void* x, const void* w, void* out, int rows, int K,
               int N, long long ldw, int C, int Q, cudaStream_t s) {
  const auto kernel = row_gemm_f32_kernel<NK>;
  static const cudaError_t ready = allow_smem(kernel, kF32Smem);
  if (ready != cudaSuccess) return static_cast<int>(ready);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      cluster_config(Q * C, kConsumers, kF32Smem, s, attr, C);
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const float*>(x),
      static_cast<const float*>(w), static_cast<float*>(out), rows, K, N,
      ldw);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <int G>
int dispatch_bf16(int nk, int f32out, const void* x, const void* w,
                  void* out, int rows, int K, int N, long long ldw, int C,
                  int Q, cudaStream_t s) {
  if (f32out) {
    return nk ? launch_bf16<G, true, float>(x, w, out, rows, K, N, ldw, C,
                                            Q, s)
              : launch_bf16<G, false, float>(x, w, out, rows, K, N, ldw, C,
                                             Q, s);
  }
  return nk ? launch_bf16<G, true, bf16>(x, w, out, rows, K, N, ldw, C, Q, s)
            : launch_bf16<G, false, bf16>(x, w, out, rows, K, N, ldw, C, Q,
                                          s);
}

}  // namespace

// y [M, N] = x [M, K] @ w for M <= 256 rows.  dtype 0 float32, 1
// bfloat16; nk 1 when w is [N, K] (K contiguous), 0 when [K, N] (N
// contiguous); f32out 1 for a float32 y from bfloat16 operands.  The
// plan: `splits` K splits (the cluster size, 1-8, at most the K stages)
// and `clusters` clusters in the persistent grid.  Launches on `stream`,
// allocates nothing; returns 0, a CUDA error (the launch's, then
// cudaGetLastError()), or a code past 100000 for a tensor map the
// driver would not make.
extern "C" int pt_row_gemm(const void* x, const void* w, void* out,
                           int dtype, int nk, int f32out, int M, int K,
                           int N, long long ldw, int splits, int clusters,
                           void* stream) {
  if (M == 0 || N == 0) return 0;
  const int ks = (K + kBK - 1) / kBK;
  if (M < 0 || M > kMaxRows || K < 1 || K % 8 || N % 8 || ldw % 8
      || dtype < 0 || dtype > 1 || splits < 1 || kChunks % splits
      || splits > ks || clusters < 1 || ldw < (nk ? K : N)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return nk ? launch_f32<true>(x, w, out, M, K, N, ldw, splits, clusters,
                                 s)
              : launch_f32<false>(x, w, out, M, K, N, ldw, splits, clusters,
                                  s);
  }
  if (M <= kGroup) {
    return dispatch_bf16<1>(nk, f32out, x, w, out, M, K, N, ldw, splits,
                            clusters, s);
  }
  if (M <= 2 * kGroup) {
    return dispatch_bf16<2>(nk, f32out, x, w, out, M, K, N, ldw, splits,
                            clusters, s);
  }
  return dispatch_bf16<4>(nk, f32out, x, w, out, M, K, N, ldw, splits,
                          clusters, s);
}

// Clusters of `size` blocks of the bfloat16 kernel that the current card
// holds at once (every instance has the same block and shared memory),
// or minus a CUDA error.
extern "C" int pt_row_gemm_max_clusters(int size) {
  const auto kernel = row_gemm_bf16_kernel<4, false, bf16>;
  cudaError_t err = allow_smem(kernel, kSmemBytes);
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      cluster_config(size, kThreads, kSmemBytes, nullptr, attr, size);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

// Dynamic shared memory (bytes) of a block: dtype 1 bfloat16, 0 float32.
extern "C" int pt_row_gemm_smem_bytes(int dtype) {
  return dtype == 1 ? kSmemBytes : kF32Smem;
}

// Tensor maps held in the cache.
extern "C" int pt_row_gemm_cached_maps() {
  std::lock_guard<std::mutex> lock(g_maps_mu);
  return static_cast<int>(g_maps.size());
}

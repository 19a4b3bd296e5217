// Temperature, top-k, top-p and a keyed Gumbel-max draw of one token a
// row, on JAX's threefry stream, in one launch (sm_90a).  Wrapper:
// paddle_tpu_torch/incubate/nn/kernels/sampling.py (sample_rows,
// gumbel_argmax); plain version: sampling.sample_rows_plain =
// gumbel_argmax_plain(filter_logits_plain(...)), its exact selection
// rule sampling.cut_values_plain.
//
// Replaces no TPU kernel.  The JAX package filters and draws in XLA:
// paddle_tpu/models/decoding.py _filter_logits (:25, a sort, softmax
// and cumsum) and jax.random.categorical (sample_token :46,
// _sample_one :55).  The port ran the same filter in torch before this
// kernel (topk, a full sort of [R, V], exp, cumsum, gather, two
// masked_fills: ~60 launches a draw) and then a draw kernel.  This
// kernel reads the raw logits once and does all of it in one launch,
// which keeps the draw on the device and capturable in a CUDA graph.
//
// Function: raw float32 logits [R, V] -> int32 tokens [R].  x =
// logits / T (IEEE division).  kth = the k-th largest x, duplicates
// counted, when 0 < k < V (else -inf).  cut = the top-p cut when top_p
// < 1 (else -inf).  Kept: neither x < kth nor x < cut.  Row r draws
// argmax_j(x_j + g_j) over the kept values, the first index among equal
// maxima (NaN above everything, -0 equal to +0, an all -inf row gives
// token 0), g_j = -logf(-logf(u_j)) and u_j the float32 uniform of
// [tiny, 1) that jax.random.uniform builds from bits_j = o0 ^ o1,
// (o0, o1) = threefry2x32(key_r, (hi, lo) of base_r + j).  Keys: the
// engines' rule, key_r = fold_in(PRNGKey(seeds[b]), pos[b] + w) for row
// r = b * window + w, base_r = 0 (from device seeds and positions: no
// host sync, no key tensor); or the generate rule, one key (two uint32
// words in int64) for the whole [R, V] draw, base_r = r * V.
//
// Exact thresholds.  Values are ordered by 32-bit keys (order_key: NaN
// above +inf, -0 as +0).  kth is the largest key v with count(key >= v)
// >= k: integer counts.  The top-p cut, over the values not below kth:
// each one's mass m = floor(expf(x - max) 2^B), B = 53 - ceil(log2 V),
// so a row's total stays within 2^53; the cut is the largest key v with
// mass(key >= v) >= ceil(float32(top_p) total), computed in 64-bit
// integers (mass_threshold).  A row whose maximum is NaN, +inf or -inf
// cuts at that maximum, as JAX's NaN softmax does.  Every quantity
// that decides a token (counts, masses, the packed maximum) is an
// integer sum or maximum, so a row's token does not depend on R, on
// the cluster size or on the order of the atomics: the decode step
// (R 8) and the verify pass (R 32) draw the same tokens.  JAX's float
// softmax and cumsum can put the cut elsewhere only where the mass at
// the cut lies within rounding of top_p (a top-p near-tie).
//
// Numerics of the draw: threefry is integer arithmetic, bit for bit
// JAX's; logf is CUDA's accurate logf (no fast math): like XLA:CPU's
// log it is not correctly rounded, so the noise can differ from JAX's
// and torch.log's by an ulp, which moves a token only at a near-tie of
// two perturbed scores.
//
// Design: one thread-block cluster of C blocks of 1024 threads a row
// (C 16, 8, 4 or 2: sampling_plan takes the size that runs the R rows
// in the fewest waves, then, under top-k, one that gathers at most 512
// candidates, then the largest).  Rank c copies its slice of L
// logits (a multiple of 4: 16-byte aligned) into shared memory with
// 1-D bulk copies (cp.async.bulk onto an mbarrier; plain loads when V
// is not a multiple of 4), divides by T in place and never reads
// device memory again; thread 0 derives the row's key while the copy
// is in flight.
// * Under top-k (the serving path) the cluster gathers: every value at
//   or above the row's k-th largest is at or above its own block's k-th
//   largest, so each block finds the 16-bit bucket of its local k-th
//   largest (two local radix passes over per-warp shared histograms,
//   the first built in the division loop) and pushes its values in and
//   above that bucket, as (key, index) pairs, into rank 0's shared
//   memory (slots from a distributed shared memory atomicAdd).  After
//   one cluster barrier rank 0 alone holds every candidate (~k a
//   block) and finishes: the k-th key is the largest whose count of
//   candidates at or above it reaches k; the maximum is among them; a
//   value at or above kth is kept by top-p when the fixed-point mass of
//   the values strictly above it is below the threshold (that is being
//   at or above the cut); threefry and the two logs run on the kept
//   values only (~20 of 50304 under top-k 20).
// * Without top-k, or when ties make more than kMaxCand candidates,
//   each threshold is the cluster's radix select: four 8-bit digit
//   passes, each a per-warp histogram of the values that match the
//   digits found so far, summed into the block's published histogram,
//   one cluster barrier, then every block sums the C published
//   histograms through distributed shared memory and finds the digit
//   by a suffix scan (published histograms alternate between two
//   buffers, so one barrier a pass suffices); every block draws over
//   its kept values and pushes its packed (score, ~index) maximum to
//   rank 0.
// No global atomics, no scratch, nothing allocated: one launch.  What
// the card showed shaped it (PERF.md, row S1's findings): in a first
// design of 256 threads a block the passes' own latency dominated, not
// the cluster barriers (match.any and the 64-bit shared atomics' CAS
// loops in a loop at eight warps an SM); at 1024 threads every
// block-wide barrier and every phase costs ~0.1-1 us, so the gather
// keeps them few.
//
// Bound: bytes (R V 4 read, R 4 written) against the operations the
// function needs, counted from the built kernel's SASS (chip_smoke.py
// sampler_bound): a division, key and histogram step a logit (the
// division loop), a compare a logit under a filter, a mass (expf) for
// each value not below the k-th under top-p, and threefry and the two
// logs a kept value, over the 128 issue slots an SM has a clock.  The
// kernel's own extra passes (its second count pass, the gather, four
// mass passes under top-p alone) are not in it.  At [8, 50304] under
// top-k 20 the bytes bind (0.00048 ms).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 256;              // 8-bit digits
constexpr int kMaxCluster = 16;
constexpr int kMaxCand = 2048;          // candidates rank 0 gathers
constexpr int kCopyFloats = 4096;       // floats a bulk copy (16 KB)
constexpr float kTiny = 1.17549435e-38f;   // float32 smallest normal
// dynamic shared memory: published histograms [2][kBins], the warps'
// histograms [kWarps][kBins] (64-bit bins), rank 0's candidates
// [kMaxCand], the mbarrier's 16 bytes, then the slice; sampling.py
// SMEM_FIXED is the same sum
constexpr int kSliceOffset = (2 + kWarps) * kBins * 8 + kMaxCand * 8 + 16;
constexpr int kSmemLimit = 231424;      // 227 KB less room for static
static_assert(kWarps == 32, "block reductions take one warp's lanes");
static_assert(kBins % 32 == 0 && kBins <= kThreads, "bins");
static_assert(kMaxCand + kMaxCand / 2 <= kWarps * kBins,
              "the finish's arrays");
static_assert(kSliceOffset % 16 == 0, "bulk copies need 16-byte rows");

// A wait longer than this many cycles (~8.7 s at 1.98 GHz) is a barrier
// that can never complete: trap, so that the launch fails instead of
// hanging the card.
constexpr long long kStallCycles = 1ll << 34;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// threefry2x32, 20 rounds, in place on (x0, x1)
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0;
  x1 += k1;
#define PT_ROUND(r) x0 += x1; x1 = rotl(x1, r) ^ x0;
#define PT_GROUP_A PT_ROUND(13) PT_ROUND(15) PT_ROUND(26) PT_ROUND(6)
#define PT_GROUP_B PT_ROUND(17) PT_ROUND(29) PT_ROUND(16) PT_ROUND(24)
  PT_GROUP_A
  x0 += k1; x1 += k2 + 1u;
  PT_GROUP_B
  x0 += k2; x1 += k0 + 2u;
  PT_GROUP_A
  x0 += k0; x1 += k1 + 3u;
  PT_GROUP_B
  x0 += k1; x1 += k2 + 4u;
  PT_GROUP_A
  x0 += k2; x1 += k0 + 5u;
#undef PT_GROUP_B
#undef PT_GROUP_A
#undef PT_ROUND
}

// jax.random.gumbel's "low" mode from one word of random bits
__device__ __forceinline__ float gumbel_of(uint32_t bits) {
  const float f = __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
  const float u = fmaxf(kTiny, __fadd_rn(f, kTiny));
  return -logf(-logf(u));
}

// order-preserving key of a float: larger value, larger key; NaN above
// +inf; -0 as +0
__device__ __forceinline__ uint32_t order_key(float x) {
  uint32_t b = __float_as_uint(x);
  if (b == 0x80000000u) b = 0u;
  return (x != x) ? 0xFFFFFFFFu
                  : ((b & 0x80000000u) ? ~b : (b | 0x80000000u));
}

// the value of a key (+0 for the key of -0 and +0, NaN for NaN's)
__device__ __forceinline__ float key_value(uint32_t k) {
  if (k == 0xFFFFFFFFu) return __uint_as_float(0x7FC00000u);
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7FFFFFFFu) : ~k);
}

// order-preserving key of (score, index): larger score first, then the
// smaller index
__device__ __forceinline__ unsigned long long pack(float s, uint32_t j) {
  return (static_cast<unsigned long long>(order_key(s)) << 32)
         | (0xFFFFFFFFu - j);
}

__device__ __forceinline__ unsigned long long umax64(unsigned long long a,
                                                     unsigned long long b) {
  return a > b ? a : b;
}

// ceil(p total) exactly for p = float32 top_p, at least 1 (p <= 0: the
// cut at the maximum); total when p rounds to 1.  total < 2^53 + 1.
__device__ __forceinline__ unsigned long long mass_threshold(
    unsigned long long total, float p) {
  if (!(p > 0.0f)) return 1ull;
  if (p >= 1.0f) return total;
  const uint32_t b = __float_as_uint(p);
  const uint32_t e = b >> 23;
  const unsigned long long mant = (b & 0x7FFFFFu) | (e ? 0x800000u : 0u);
  // p = mant 2^-(t + 24)
  const int t = (e ? 150 - static_cast<int>(e) : 149) - 24;
  const unsigned long long hi = total >> 24, lo = total & 0xFFFFFFull;
  const unsigned long long a2 = mant * hi + ((mant * lo) >> 24);
  const unsigned long long lo2 = (mant * lo) & 0xFFFFFFull;
  unsigned long long q;
  bool rem;
  if (t >= 63) {
    q = 0ull;
    rem = (a2 | lo2) != 0ull;
  } else {
    q = a2 >> t;
    rem = (a2 & ((1ull << t) - 1ull)) != 0ull || lo2 != 0ull;
  }
  q += rem ? 1ull : 0ull;
  return q ? q : 1ull;
}

// ---------------------------------------------------------------------------
// mbarriers, bulk copies and the cluster barrier
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long t0 = clock64();
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > kStallCycles) __trap();
  } while (!done);
}

// `bytes` (a multiple of 16) from global to this block's shared memory,
// completing on the mbarrier
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// the cluster barrier in two halves (release, acquire)
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

template <typename T>
__device__ __forceinline__ T warp_max(T v) {
  for (int o = 16; o > 0; o >>= 1) {
    const T w = __shfl_xor_sync(0xFFFFFFFFu, v, o);
    v = v > w ? v : w;
  }
  return v;
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------


struct Args {
  const float* logits;
  int V, L, tma;
  float temperature;
  int top_k, has_p;
  float top_p;
  int mass_bits;
  const int* seeds;
  const int* pos;
  int window;
  const long long* key;
  int* out;
};

// the block's scalars (static shared memory)
struct Ctl {
  unsigned long long best[kMaxCluster];   // rank 0: each rank's winner
  unsigned long long wred[kWarps];        // block reductions
  unsigned long long wsum[kBins / 32];    // a scan's warp sums
  unsigned long long above;               // weight above the digit found
  unsigned long long at;                  // weight at or above it
  uint32_t digit;
  uint32_t cta_max;                       // this block's largest key
  uint32_t row_max;                       // the row's largest key
  unsigned long long key_base;            // the row's first counter
  uint32_t k0, k1;                        // the row's key
  uint32_t counts[kMaxCluster];           // candidates each rank gathers
  uint32_t gathered;                      // rank 0: candidate slots taken
  uint32_t slot;                          // this block's slots taken
  uint32_t base;                          // this block's first slot
};

struct Block {
  cg::cluster_group cluster;
  int C, n;
  const float* xs;                        // the slice, divided by T
  unsigned long long* pub;                // [2][kBins], read by the cluster
  unsigned long long* sub;                // [kWarps][kBins] (or 32-bit)
  unsigned int* ckey;                     // rank 0: [kMaxCand] candidate keys
  unsigned int* cidx;                     // and their indices in the row
  Ctl* ctl;
  int buf;                                // the published buffer in turn
};

__device__ __forceinline__ unsigned long long block_max(Ctl& ctl,
                                                        unsigned long long v) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_max(v);
  if (lane == 0) ctl.wred[warp] = v;
  __syncthreads();
  v = warp_max(ctl.wred[lane]);
  __syncthreads();
  return v;
}

// two maxima at once (one pair of barriers)
__device__ __forceinline__ void block_max2(Ctl& ctl, uint32_t& a,
                                           uint32_t& b) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned long long v =
      (static_cast<unsigned long long>(warp_max(a)) << 32) | warp_max(b);
  if (lane == 0) ctl.wred[warp] = v;
  __syncthreads();
  v = ctl.wred[lane];
  a = warp_max(static_cast<uint32_t>(v >> 32));
  b = warp_max(static_cast<uint32_t>(v));
  __syncthreads();
}

// the first kBins threads (eight warps) among themselves
__device__ __forceinline__ void bins_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kBins) : "memory");
}

// Threads 0..kBins-1, thread t holding bin t's weight g: after the call
// s is the weight of the bins >= t, total the weight of them all.
__device__ __forceinline__ void suffix_sums(Ctl& ctl, unsigned long long g,
                                            unsigned long long& s,
                                            unsigned long long& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  s = g;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned long long y = __shfl_down_sync(0xFFFFFFFFu, s, o);
    if (lane + o < 32) s += y;
  }
  if (lane == 0) ctl.wsum[warp] = s;
  bins_sync();
  unsigned long long higher = 0ull;
  total = 0ull;
#pragma unroll
  for (int w = 0; w < kBins / 32; ++w) {
    const unsigned long long t = ctl.wsum[w];
    total += t;
    if (w > warp) higher += t;
  }
  s += higher;
}

// the digit: the last bin whose suffix still reaches need (one thread)
__device__ __forceinline__ void pick_digit(Ctl& ctl, unsigned long long g,
                                           unsigned long long s,
                                           unsigned long long above,
                                           unsigned long long need) {
  if (above + s >= need && above + s - g < need) {
    ctl.digit = threadIdx.x;
    ctl.above = above + s - g;
    ctl.at = above + s;
  }
}

// This block alone: the top 8 npass bits of the largest key v with
// count(keys >= v) >= need over key_at(i), i < n (need <= n), by
// per-warp 32-bit histograms (pass 0's already built by the caller);
// ctl.at is then the count of keys in and above that bucket.
template <typename KeyAt>
__device__ uint32_t local_select(Block& k, int n, KeyAt key_at, uint32_t need,
                                 int npass) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  Ctl& ctl = *k.ctl;
  unsigned int* sub = reinterpret_cast<unsigned int*>(k.sub);
  unsigned int* mine = sub + warp * kBins;
  uint32_t prefix = 0u;
  unsigned long long above = 0ull;
  for (int pass = 0; pass < npass; ++pass) {
    const int shift = 24 - 8 * pass;
    const uint32_t hi = pass == 0 ? 0u : (0xFFFFFFFFu << (shift + 8));
    if (pass > 0) {
      for (int b = lane; b < kBins; b += 32) mine[b] = 0u;
      __syncwarp();
      for (int i = tid; i < n; i += kThreads) {
        const uint32_t key = key_at(i);
        if (((key ^ prefix) & hi) == 0u)
          atomicAdd(mine + ((key >> shift) & 255u), 1u);
      }
    }
    __syncthreads();
    if (tid < kBins) {
      unsigned long long g = 0ull, s, total;
#pragma unroll 8
      for (int w = 0; w < kWarps; ++w) g += sub[w * kBins + tid];
      suffix_sums(ctl, g, s, total);
      pick_digit(ctl, g, s, above, need);
    }
    __syncthreads();
    prefix |= ctl.digit << shift;
    above = ctl.above;
  }
  return prefix;
}

// warp 0 reads every rank's largest key after a cluster barrier
__device__ __forceinline__ void pull_row_max(Block& k) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    uint32_t m = lane < k.C ? *k.cluster.map_shared_rank(&k.ctl->cta_max, lane)
                            : 0u;
    m = warp_max(m);
    if (lane == 0) k.ctl->row_max = m;
  }
}

// The cluster's select: the largest key v with weight(values with key
// >= v) >= need, need = need_of(total weight), over the whole row: four
// passes of 8-bit digits, one cluster barrier each.  COUNT: the weight
// is 1 a value (32-bit bins); else weight(x, key) a value (64-bit bins;
// 0: not counted).  pull_max: read the row's maximum at the first
// barrier.
template <bool COUNT, typename Weight, typename Need>
__device__ uint32_t radix_select(Block& k, Weight weight, Need need_of,
                                 bool pull_max) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  Ctl& ctl = *k.ctl;
  unsigned int* sub32 = reinterpret_cast<unsigned int*>(k.sub);
  uint32_t prefix = 0u;
  unsigned long long above = 0ull, need = 0ull;
  for (int pass = 0; pass < 4; ++pass) {
    const int shift = 24 - 8 * pass;
    const uint32_t hi = pass == 0 ? 0u : (0xFFFFFFFFu << (shift + 8));
    for (int b = lane; b < kBins; b += 32) {
      if (COUNT) sub32[warp * kBins + b] = 0u;
      else k.sub[warp * kBins + b] = 0ull;
    }
    __syncwarp();
    for (int i = tid; i < k.n; i += kThreads) {
      const float x = k.xs[i];
      const uint32_t key = order_key(x);
      if (((key ^ prefix) & hi) != 0u) continue;
      const uint32_t bin = (key >> shift) & 255u;
      if (COUNT) {
        atomicAdd(sub32 + warp * kBins + bin, 1u);
      } else {
        const unsigned long long w = weight(x, key);
        if (w) atomicAdd(k.sub + warp * kBins + bin, w);
      }
    }
    __syncthreads();
    unsigned long long* pub = k.pub + k.buf * kBins;
    if (tid < kBins) {
      unsigned long long h = 0ull;
#pragma unroll 8
      for (int w = 0; w < kWarps; ++w)
        h += COUNT ? sub32[w * kBins + tid] : k.sub[w * kBins + tid];
      pub[tid] = h;
    }
    cluster_sync();
    if (pull_max && pass == 0) pull_row_max(k);
    if (tid < kBins) {
      // bin tid of the cluster: the sum of the C published histograms
      unsigned long long g = 0ull, s, total;
#pragma unroll 4
      for (int r = 0; r < k.C; ++r)
        g += k.cluster.map_shared_rank(pub, r)[tid];
      suffix_sums(ctl, g, s, total);
      if (pass == 0) need = need_of(total);
      pick_digit(ctl, g, s, above, need);
    }
    __syncthreads();
    prefix |= ctl.digit << shift;
    above = ctl.above;
    k.buf ^= 1;
  }
  return prefix;
}

// the mass of a value at or above kth, 0 below it
__device__ __forceinline__ unsigned long long mass_of(float x, uint32_t key,
                                                      uint32_t kth_key,
                                                      float mx, double scale) {
  if (key < kth_key) return 0ull;
  return static_cast<unsigned long long>(
      static_cast<double>(expf(__fsub_rn(x, mx))) * scale);
}

// one kept value's packed (score, ~index) under the row's key
__device__ __forceinline__ unsigned long long draw_one(
    float x, uint32_t j, uint32_t k0, uint32_t k1, unsigned long long base) {
  const unsigned long long c = base + j;
  uint32_t x0 = static_cast<uint32_t>(c >> 32);
  uint32_t x1 = static_cast<uint32_t>(c);
  threefry2x32(k0, k1, x0, x1);
  return pack(__fadd_rn(x, gumbel_of(x0 ^ x1)), j);
}

// Rank 0 alone, over the M gathered candidates (every value of the row
// at or above the k-th largest is among them, and so is the maximum).
// The k-th key is the largest whose count of keys at or above it
// reaches k.  Under top-p a value at or above it is kept when the mass
// of the values strictly above it is below the threshold: that is
// being at or above the cut, the largest key whose mass at or above it
// reaches the threshold.  Then the draw over the kept values.
__device__ void finish_gathered(const Args& a, Block& k, int M, int row) {
  const int tid = threadIdx.x, lane = tid & 31;
  Ctl& ctl = *k.ctl;
  const unsigned int* ckey = k.ckey;
  // the values at or above kth (candidate numbers) and their masses, in
  // the histograms' space
  unsigned long long* mass = k.sub;
  unsigned int* list = reinterpret_cast<unsigned int*>(mass + kMaxCand);
  // every candidate's count of candidates at or above it, keys four at
  // a time
  uint32_t kth_key = 0u, mk = 0u;
  for (int i = tid; i < M; i += kThreads) {
    const uint32_t key = ckey[i];
    uint32_t g0 = 0u, g1 = 0u, g2 = 0u, g3 = 0u;
    const int M4 = M & ~3;
#pragma unroll 4
    for (int j = 0; j < M4; j += 4) {
      const uint4 q = *reinterpret_cast<const uint4*>(ckey + j);
      g0 += q.x >= key ? 1u : 0u;
      g1 += q.y >= key ? 1u : 0u;
      g2 += q.z >= key ? 1u : 0u;
      g3 += q.w >= key ? 1u : 0u;
    }
    for (int j = M4; j < M; ++j) g0 += ckey[j] >= key ? 1u : 0u;
    if (g0 + g1 + g2 + g3 >= static_cast<uint32_t>(a.top_k))
      kth_key = max(kth_key, key);
    mk = max(mk, key);
  }
  block_max2(ctl, kth_key, mk);
  const float kth = key_value(kth_key);
  const float mx = key_value(mk);
  const bool exact_p = a.has_p && isfinite(mx);
  const double scale = ldexp(1.0, a.mass_bits);
  for (int i = tid; i < M; i += kThreads) {
    const uint32_t key = ckey[i];
    if (key < kth_key) continue;
    const uint32_t slot = atomicAdd(&ctl.slot, 1u);
    list[slot] = static_cast<unsigned int>(i);
    mass[slot] =
        exact_p ? mass_of(key_value(key), key, kth_key, mx, scale) : 0ull;
  }
  __syncthreads();
  const int M2 = static_cast<int>(ctl.slot);
  unsigned long long need = 0ull;
  if (exact_p) {
    // every warp sums the masses itself: no barrier
    unsigned long long total = 0ull;
    for (int j = lane; j < M2; j += 32) total += mass[j];
    for (int o = 16; o > 0; o >>= 1)
      total += __shfl_xor_sync(0xFFFFFFFFu, total, o);
    need = mass_threshold(total, a.top_p);
  }
  // a NaN or +inf maximum cuts at itself (nothing, or all but +inf)
  const float cut = a.has_p && !exact_p ? mx : -INFINITY;
  unsigned long long best = pack(-INFINITY, 0u);
  for (int i = tid; i < M2; i += kThreads) {
    const uint32_t key = ckey[list[i]];
    const float x = key_value(key);
    if (x < kth || x < cut || x == -INFINITY) continue;
    if (exact_p) {
      unsigned long long above = 0ull;
#pragma unroll 4
      for (int j = 0; j < M2; ++j)
        if (ckey[list[j]] > key) above += mass[j];
      if (above >= need) continue;
    }
    best = umax64(best, draw_one(x, k.cidx[list[i]], ctl.k0, ctl.k1,
                                 ctl.key_base));
  }
  best = block_max(ctl, best);
  if (tid == 0)
    a.out[row] = static_cast<int>(0xFFFFFFFFu - static_cast<uint32_t>(best));
}

__global__ void __launch_bounds__(kThreads, 1)
sampling_filter_draw_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ Ctl ctl;
  Block k{cg::this_cluster()};
  k.C = static_cast<int>(k.cluster.num_blocks());
  const int rank = static_cast<int>(k.cluster.block_rank());
  const int row = blockIdx.x / k.C;
  const int tid = threadIdx.x;
  k.pub = reinterpret_cast<unsigned long long*>(smem);
  k.sub = k.pub + 2 * kBins;
  k.ckey = reinterpret_cast<unsigned int*>(k.sub + kWarps * kBins);
  k.cidx = k.ckey + kMaxCand;
  unsigned long long* bar = k.sub + kWarps * kBins + kMaxCand;
  float* xs = reinterpret_cast<float*>(smem + kSliceOffset);
  k.xs = xs;
  k.ctl = &ctl;
  k.buf = 0;
  const int start = rank * a.L;
  k.n = max(0, min(a.L, a.V - start));
  const float* src = a.logits + static_cast<size_t>(row) * a.V + start;
  if (tid == 0) {
    ctl.gathered = 0u;
    ctl.slot = 0u;
  }

  // every block of the cluster has started (and rank 0 has zeroed its
  // slot count) before the first remote access
  cluster_arrive();

  // the slice, once, divided by T in place; this block's largest key;
  // thread 0 derives the row's key while the copy is in flight (read
  // after the block's next barrier)
  const bool copy = a.tma && k.n > 0;
  if (copy && tid == 0) {
    const uint32_t b = smem_addr(bar);
    mbar_init(b, 1);
    mbar_expect_tx(b, static_cast<uint32_t>(k.n) * 4u);
    for (int off = 0; off < k.n; off += kCopyFloats)
      bulk_copy(smem_addr(xs + off), src + off,
                static_cast<uint32_t>(min(kCopyFloats, k.n - off)) * 4u, b);
  }
  if (copy) __syncthreads();
  if (tid == 0) {
    // one key over the [R, V] draw, or fold_in(PRNGKey(seed), p) =
    // threefry2x32((0, seed), (0, p)) with p = pos + w in int32 as JAX
    // adds it
    if (a.key != nullptr) {
      ctl.k0 = static_cast<uint32_t>(a.key[0]);
      ctl.k1 = static_cast<uint32_t>(a.key[1]);
      ctl.key_base =
          static_cast<unsigned long long>(row) * static_cast<unsigned>(a.V);
    } else {
      const int b = row / a.window;
      const int w = row - b * a.window;
      uint32_t x0 = 0u, x1 = static_cast<uint32_t>(a.pos[b] + w);
      threefry2x32(0u, static_cast<uint32_t>(a.seeds[b]), x0, x1);
      ctl.k0 = x0;
      ctl.k1 = x1;
      ctl.key_base = 0ull;
    }
  }
  if (copy) {
    mbar_wait(smem_addr(bar), 0);
  } else {
    for (int i = tid; i < k.n; i += kThreads) xs[i] = src[i];
  }
  // under top-k (and more logits than k) the loop also builds pass 0 of
  // the local select: the warps' histograms of the keys' top byte
  const bool local_k = a.top_k > 0 && k.n > a.top_k;
  unsigned int* mine = reinterpret_cast<unsigned int*>(k.sub) +
                       (tid >> 5) * kBins;
  if (local_k) {
    for (int b = tid & 31; b < kBins; b += 32) mine[b] = 0u;
    __syncwarp();
  }
  uint32_t kmax = 0u;
  for (int i = tid; i < k.n; i += kThreads) {
    const float x = __fdiv_rn(xs[i], a.temperature);
    xs[i] = x;
    const uint32_t key = order_key(x);
    kmax = max(kmax, key);
    if (local_k) atomicAdd(mine + (key >> 24), 1u);
  }
  kmax = static_cast<uint32_t>(block_max(ctl, kmax));
  if (tid == 0) ctl.cta_max = kmax;
  cluster_wait();
  const uint32_t k0 = ctl.k0, k1 = ctl.k1;
  const unsigned long long base = ctl.key_base;

  uint32_t kth_key = 0u;
  float kth = -INFINITY;
  if (a.top_k > 0) {
    // Gather: every value of the row at or above the k-th largest is at
    // or above its own block's k-th largest, so each block sends the
    // values of the 16-bit bucket of its local k-th largest and above
    // to rank 0, which finishes alone when they fit.
    uint32_t tk = 0u, nloc = static_cast<uint32_t>(k.n);
    if (local_k) {
      tk = local_select(k, k.n, [xs](int i) { return order_key(xs[i]); },
                        static_cast<uint32_t>(a.top_k), 2);
      nloc = static_cast<uint32_t>(ctl.at);
    }
    if (tid == 0)
      ctl.base = atomicAdd(k.cluster.map_shared_rank(&ctl.gathered, 0), nloc);
    if (tid < k.C) *k.cluster.map_shared_rank(&ctl.counts[rank], tid) = nloc;
    __syncthreads();
    const uint32_t first = ctl.base;
    unsigned int* key0 = k.cluster.map_shared_rank(k.ckey, 0);
    unsigned int* idx0 = k.cluster.map_shared_rank(k.cidx, 0);
    for (int i = tid; i < k.n; i += kThreads) {
      const uint32_t key = order_key(xs[i]);
      if (key < tk) continue;
      const uint32_t slot = first + atomicAdd(&ctl.slot, 1u);
      if (slot < kMaxCand) {
        key0[slot] = key;
        idx0[slot] = static_cast<uint32_t>(start + i);
      }
    }
    cluster_sync();
    uint32_t M = 0u;
    for (int r = 0; r < k.C; ++r) M += ctl.counts[r];
    if (M <= kMaxCand) {
      if (rank == 0) {
        if (tid == 0) ctl.slot = 0u;
        __syncthreads();
        finish_gathered(a, k, static_cast<int>(M), row);
      }
      return;
    }
    // too many ties to gather: the cluster's select
    kth_key = radix_select<true>(
        k, [](float, uint32_t) { return 1ull; },
        [&a](unsigned long long) {
          return static_cast<unsigned long long>(a.top_k);
        },
        true);
    kth = key_value(kth_key);
  }

  // top-p: the cut, by exact fixed-point masses of the values >= kth
  float cut = -INFINITY;
  if (a.has_p) {
    if (a.top_k == 0) {
      cluster_sync();
      pull_row_max(k);
      __syncthreads();
    }
    const float mx = key_value(ctl.row_max);
    if (!isfinite(mx)) {
      cut = mx;
    } else {
      const double scale = ldexp(1.0, a.mass_bits);
      const float p = a.top_p;
      const uint32_t v = radix_select<false>(
          k,
          [kth_key, mx, scale](float x, uint32_t key) {
            return mass_of(x, key, kth_key, mx, scale);
          },
          [p](unsigned long long total) { return mass_threshold(total, p); },
          false);
      cut = key_value(v);
    }
  }

  // the draw over the kept values; an all -inf row keeps token 0
  unsigned long long best = pack(-INFINITY, 0u);
  for (int i = tid; i < k.n; i += kThreads) {
    const float x = xs[i];
    if (x < kth || x < cut || x == -INFINITY) continue;
    best = umax64(best, draw_one(x, static_cast<uint32_t>(start + i), k0, k1,
                                 base));
  }
  best = block_max(ctl, best);
  if (tid == 0) *k.cluster.map_shared_rank(&ctl.best[rank], 0) = best;
  cluster_sync();
  if (rank == 0 && tid == 0) {
    unsigned long long m = ctl.best[0];
    for (int r = 1; r < k.C; ++r) m = umax64(m, ctl.best[r]);
    a.out[row] = static_cast<int>(0xFFFFFFFFu - static_cast<uint32_t>(m));
  }
}

int set_attributes(int smem) {
  static int allowed = 0;
  static bool wide = false;   // clusters of 16 allowed
  if (!wide) {
    const cudaError_t err = cudaFuncSetAttribute(
        sampling_filter_draw_kernel,
        cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
    wide = true;
  }
  if (smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        sampling_filter_draw_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed = smem;
  }
  return 0;
}

cudaLaunchConfig_t cluster_config(int blocks, int smem, cudaStream_t s,
                                  cudaLaunchAttribute* attr, int C) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
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

}  // namespace

extern "C" {

// One draw: R rows of V raw float32 logits, clusters of C blocks (2, 4,
// 8 or 16), rank c holding logits [c L, (c + 1) L) of its row (L a
// multiple of 4, C L >= V); tma 1 when V is a multiple of 4 and the
// logits 16-byte aligned.  top_k 0 for no top-k (else 0 < top_k < V);
// has_p 0 for no top-p; mass_bits = 53 - ceil(log2 V).  Exactly one of
// (seeds, pos) [R / window] int32 and key [2] int64 is given.  Launches
// on `stream`, allocates nothing; returns 0 or a CUDA error (the
// launch's, then cudaGetLastError()).
int pt_sample_rows(const float* logits, int R, int V, int L, int C, int tma,
                   float temperature, int top_k, int has_p, float top_p,
                   int mass_bits, const int* seeds, const int* pos,
                   int window, const long long* key, int* out,
                   void* stream) {
  if (R == 0) return 0;
  const long long smem = kSliceOffset + 4ll * L;
  if (R < 0 || V < 1 || L < 4 || L % 4
      || (C != 2 && C != 4 && C != 8 && C != 16)
      || static_cast<long long>(C) * L < V || smem > kSmemLimit
      || static_cast<long long>(R) * C > 0x7FFFFFFFll || top_k < 0
      || top_k >= V || window < 1 || R % window
      || (key == nullptr) == (seeds == nullptr || pos == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int rc = set_attributes(static_cast<int>(smem));
  if (rc != 0) return rc;
  Args a{logits, V, L, tma, temperature, top_k, has_p, top_p, mass_bits,
         seeds, pos, window, key, out};
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      cluster_config(R * C, static_cast<int>(smem),
                     static_cast<cudaStream_t>(stream), attr, C);
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, sampling_filter_draw_kernel, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Clusters of C blocks with `smem` bytes of dynamic shared memory each
// that the current card holds at once, or minus a CUDA error.
int pt_sample_rows_max_clusters(int C, int smem) {
  const int rc = set_attributes(smem);
  if (rc != 0) return -rc;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(C, smem, nullptr, attr, C);
  int n = 0;
  const cudaError_t err = cudaOccupancyMaxActiveClusters(
      &n, sampling_filter_draw_kernel, &cfg);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}


}  // extern "C"

// Flash attention for Hopper (sm_90a): the forward and the two-pass
// backward (dK/dV, then dQ) of softmax(Q K^T * scale) V.
//
// Replaces the TPU kernels of paddle_tpu/incubate/nn/kernels/
// flash_attention.py: _single_fwd_kernel and _fwd_kernel (the forward,
// with lse), _single_bwd_kernel, _bwd_fused_kernel, _bwd_dkv_kernel and
// _bwd_dq_kernel (the backward).  The single-block/streaming split there
// exists only to fit TPU VMEM; here one forward kernel and one backward
// pair serve every length.  Same contract as the streaming path:
// q [B, Sq, nH, hD], k/v [B, Sk, nH, hD]; causal masks key j from query i
// unless j <= i + offset, where `offset` is the run-time q-vs-k position
// offset of the ring variant (flash_attention_with_lse, `traced_offset`
// there; 0 for plain flash attention); masked scores are -1e30 (NEG_INF);
// lse [B, nH, Sq] is float32, out is written in q's dtype.  The backward
// takes lse and delta = rowsum(dO * O) - g_lse [B, nH, Sq] (computed
// outside, as the JAX wrapper computes it in XLA) and recomputes
// P = exp(S - lse).
//
// Masked scores are exponentiated like any others, as in the TPU kernels,
// so a query row with no visible key (i + offset < 0) gets p = exp(0) = 1
// on every key: its out is the mean of v's rows, its lse -1e30 (+ log Sk,
// which vanishes in float32), and in the backward p = exp(-1e30 - lse) = 1
// again.  Keys past Sk (a ragged tile) count no time: the TPU kernel
// counts the padding of its own block_k there, so for fully masked rows
// of a ragged Sk the two differ.  A row with a visible key sees key 0, so
// its masked scores give exp(-1e30 - m) = 0 exactly, and a tile past the
// diagonal can be skipped; only a tile whose every row has a visible key
// (q0 + offset >= 0) skips, every other visits all key tiles.  At offset
// 0 no row is fully masked: the loops and the values are those of the
// zero-offset contract, bit for bit.
//
// What bounds it on the H100: 4*hD operations per visible (query, key)
// pair and head in the forward (half the pairs under the causal mask),
// 8*hD in the dK/dV pass and 6*hD in the dQ pass, against reading each
// operand once.  At training lengths (S >= 1024, hD = 128) that is
// hundreds of operations per byte.  At the bf16 tensor-core rate (989
// TFLOP/s) and 3.35 TB/s the bound of GPT training's [8, 1024, 16x128]
// is 0.040 ms for the forward (its bytes; its operations take 0.035),
// 0.070 ms for dK/dV and 0.052 for dQ (operations); at LLaMA training's
// [4, 2048, 32x128] 0.139, 0.278 and 0.209 ms (operations).
//
// Float32 runs as three TF32 products a product on the tensor cores; at
// [2, 1024, 16x128] causal (524,800 visible pairs a head) the bounds at
// the CUDA cores' 67 TFLOP/s are 0.1283 ms (forward), 0.2567 (dK/dV) and
// 0.1925 (dQ), and as three TF32 products at 495 TFLOP/s 0.052, 0.1042
// and 0.0782 ms, all set by the operations.
//
// Two designs, chosen by dtype here (dtype 1 -> bf16, 0 -> float32):
//
// bfloat16: the tensor-core kernels (*_tc_kernel), FlashAttention-2's
// structure on mma.sync.m16n8k16 (bf16 operands, float32 accumulators):
// * Every product runs on the tensor cores: Q K^T, P V, dO V^T in the
//   forward and dQ pass; K Q^T, V dO^T, P^T dO and dS^T Q in the dK/dV
//   pass, dS K in the dQ pass.  Operands come from shared memory through
//   ldmatrix, with .trans where the contraction runs along the stored
//   rows (V in P V, K in dS K, Q and dO in the dK/dV pass).
// * Tiles are staged as bf16 in shared memory in an XOR-swizzled layout
//   (16-byte chunk c of row r at c ^ (r mod 8), hD 32: c ^ (r/2 mod 4)),
//   so ldmatrix reads eight rows without a bank conflict.  They arrive by
//   cp.async.cg 16-byte copies straight from the strided [B, S, nH, hD]
//   operands (the packed qkv slices need no copy); rows past Sq or Sk are
//   zero-filled by the copy (src-size 0), never read.  A ring of two
//   stages lets tile t+1 load while tile t computes.
// * Forward and dQ: a block of kWarps warps owns 16 * kWarps query rows,
//   each warp 16 of them, so a row's max and sum reduce within a quad of
//   lanes and m, l stay in registers; K/V tiles of kBN = 64 keys stream
//   through the ring.  The score accumulators become the A operand of
//   the next product in registers, with no trip through shared memory:
//   P for P V, dS = (P (dP - delta)) scale for dS K.
// * dK/dV: a block owns 16 * kWarps keys, each warp 16, and walks query
//   tiles of kBQ = 64 (Q, dO, lse and delta staged by cp.async) in two
//   halves of 32.  It computes the transposed tiles S^T = K Q^T and
//   dP^T = V dO^T, so P^T and dS^T (scale folded in) are already A
//   fragments for dV += P^T dO and dK += dS^T Q.
// * P and dS enter their products as two bf16 halves, hi = bf16(x) and
//   lo = bf16(x - hi), each through its own mma: 16 bits of P and dS,
//   where the TPU kernels round both to the input dtype (p.astype(v.dtype)
//   in _fwd_kernel, ds.astype(q.dtype) in _bwd_dkv_kernel).  One bf16
//   rounding is not reproducible: two correct float32 computations of a
//   score (another summation order) land on either side of a bf16 tie,
//   and in a sum that cancels one step of one large P (or of dS ~ 1 in a
//   fully masked row, where p = 1) is many steps of the result, past the
//   per-element limit (one bf16 step + 1e-3) that chip_smoke.py and the
//   card tests hold these kernels to.  chip_smoke.py's rounding witness
//   shows it on the backward rounded once, computed in float32 and in
//   float64.  The lo halves cost one more mma per product of P or dS:
//   1.5 times the mma of one rounding in the forward and dK/dV, 1.33
//   times in dQ.  l sums the unrounded p, as JAX does.
// * Tile skipping as above, per block, and within a block per warp: a
//   warp whose 16 rows (keys) see nothing of a tile skips its products
//   when every row of the block has a visible key; the values are those
//   of computing it (exact zeros added).
// * No atomics: dK/dV blocks own key tiles and dQ blocks own query tiles,
//   so every result is written once and runs are deterministic.  The
//   fused one-pass backward (dQ accumulated across key blocks with
//   float32 atomics) would save the recomputation of S and dP, but the
//   order of those atomic adds changes from run to run, and with it dQ.
//
// float32 is the models' default dtype (GPTConfig.dtype and
// LlamaConfig.dtype are torch.float32, as in the JAX package), and
// use_flash=None sends CUDA training attention here (models/common.py
// _causal_attention): gpt3_1p3b at its defaults trains through these
// kernels, 24 launches of each a step at [2, 1024, 16x128].  All three
// (flash_attention_{fwd,bwd_dkv,bwd_dq}_tf32x3_kernel) run each float32
// product as three TF32 products on wgmma.  The tensor cores take no
// float32 operand and the CUDA cores' float32 rate is a seventh of the
// TF32 rate, so each operand splits into hi = tf32(x) and lo = tf32(x -
// hi) (tc_common.cuh tf32_split, tf32x3.py's rule) and each product runs
// as hi.hi + hi.lo + lo.hi (lo.lo, <= 2^-22 of it, dropped): ~22 bits an
// operand, where one TF32 pass keeps 11 and misses the float32 limits.
// wgmma, not mma.sync: with the three products, the bf16 kernels' warp
// layout on mma.sync.m16n8k8 ran slower than SDPA on the card.  Common
// to the three:
// * tf32 wgmma takes only K-major operands (no transpose) from shared
//   memory: sub-tiles of 32 floats, one 128-byte swizzled row a tile row
//   (kmajor_off).  An operand whose contraction runs along its stored
//   rows is stored transposed on its way in, [HD][32] (vt_off): V in the
//   forward, Q and dO in dK/dV, K in dQ.
// * A score accumulator is the A fragment of the next product, in
//   registers, with no trip through shared memory: step j's A column t is
//   the accumulator's column 8j + 2t and column t + 4 column 8j + 2t + 1,
//   and the transposed tiles store each 8 rows in that order (vt_off).
// * Each operand is split once, where it is staged.  Q is multiplied by
//   the scale in float32 before its split, as the plain versions have it.
// * The contract above holds: masked scores -1e30 and exponentiated,
//   keys past Sk counting nothing, the causal skips, the run-time offset
//   (offset 0: the same launch as the zero-offset call), lse and delta
//   float32 (delta computed outside).  expf and IEEE division keep the
//   rest float32.  No atomics: every output is written once, by the block
//   that owns its rows, and runs give the same bits.
// * Blocks run the longest tiles of every head first (the last query
//   tiles in the forward and dQ, key tile 0 in dK/dV): under the causal
//   mask a tile's work grows (shrinks) with its position, and the grid
//   runs in waves.
// Forward: a block is two warpgroups of 64 query rows; K/V tiles of 32
// keys.  S = (Q scale) K^T is wgmma m64n32k8 with Q and K K-major as they
// lie; O += P V is m64n(hD)k8 with P from registers and V^T in shared
// memory.  Q is split once a block and K once a tile, in place (hi) and
// beside (lo), by the threads whose cp.async copies they are; V is loaded
// into registers a tile ahead, split and stored transposed (a warp writes
// one 128-byte row of V^T at a time).  Q and K hi and lo and two slots of
// V^T hi and lo take 225 KB at hD 128: one block an SM.  K is single-
// buffered (its copies fly during the softmax and P V); tile it + 1's V^T
// is stored into the other slot while tile it's S runs.  A warpgroup
// whose rows see none of a tile skips it.
// dK/dV and dQ recompute P = exp(S - lse) and dS = P (dP - delta).  A
// block is two warpgroups: a consumer that owns 64 resident rows and
// runs the products, P and dS, and a producer that streams the other
// operand's tiles.  The producer loads a tile's rows into registers a
// tile ahead (lane pairs read 32 contiguous bytes of a row), splits them,
// stores the K-major hi/lo tiles once the consumer's score products of
// the tile before are done, then the transposed hi/lo tiles once its
// accumulating products are done; four mbarriers (K-major full and
// empty, transposed full and empty; mbar_wait traps after ~8.7 s) carry
// the hand-over.  So a tile's split and K-major stores run beside the
// consumer's P, dS and accumulating products of the tile before, and its
// transposed stores beside its own score products.  (Staging by the
// consumer itself, between its products, took 37 % of dK/dV's time and
// 43 % of dQ's at [2, 1024, 16x128]: PERF.md.)  The warpgroup index
// comes through a shuffle: with a plain threadIdx test ptxas takes the
// consumer's path for divergent and serializes its wgmma ("Potential
// Performance Loss", twice the time; chip_smoke.py prints such notes).
// * dK/dV: the block owns 64 keys; K and V are split once into resident
//   tiles.  It walks query tiles of BQ = 16 rows at hD 128 (32 below),
//   skipping under the causal mask those whose rows all see a key and
//   whose last row does not see the block's first key; rows with no
//   visible key are visited in full.  S^T = K (Q scale)^T and dP^T = V
//   dO^T are m64nBQk8 with K and V as A and Q, dO K-major as they lie;
//   P^T and dS^T = P^T (dP^T - delta), split in registers, are the A
//   fragments of dV += P^T dO and dK += dS^T (Q scale) with dO^T and
//   (Q scale)^T as B.  Shared memory at hD 128: K, V hi/lo 4 x 32 KB,
//   Q, dO hi/lo 4 x 8 KB, Q^T, dO^T hi/lo 4 x 16 KB ([128][32] rows, 16
//   positions used), lse and delta [2][16] (two slots: the producer
//   fills the next visit's while the consumer reads this one's),
//   mbarriers, 1 KB of alignment: 230,688 of 232,448 bytes.  BQ 32
//   would take 256 KB, and K, V as register A operands 128 registers a
//   thread.  Registers: dK and dV 64 each a thread, S^T and dP^T 8 each,
//   the P and dS fragments 32, a stage sum 32.
// * dQ: the block owns 64 query rows; Q scale and dO are split once into
//   resident tiles.  It walks key tiles of 32, up to its last visible key
//   under the causal mask.  S = (Q scale) K^T and dP = dO V^T are
//   m64n32k8 with K and V K-major as they lie; dS, split in registers, is
//   the A fragment of dQ += dS K with K^T as B; dQ * scale at the end (a
//   float32 multiply, as the plain version).  Shared memory at hD 128:
//   Q, dO hi/lo 4 x 32 KB, K, V hi/lo 4 x 16 KB, K^T hi/lo 2 x 16 KB,
//   mbarriers, alignment: 230,432 bytes.
// * Sums: the tensor cores add each k8 step into the float32 accumulator
//   with truncation, so one chain over all of Sq (Sk) drifts: 1024 / 8 x
//   3 = 384 truncating adds.  So each query (key) tile's products are
//   summed from zero (6 wgmma in dK/dV at hD 128, 12 in dQ; dK/dV in two
//   halves of 64 columns at hD 128, for registers) and added to dK, dV
//   (dQ) with rounding adds.  At [2, 1024, 16x128] one chain took 0.28
//   of the emulation limit (chip_smoke.TF32X3_REL) on dK and dV, these
//   sums 0.08, for ~6 % of dK/dV's time (PERF.md); the chain's
//   drift grows with S.
//
// Left for later work: TMA copies, the fused backward (see above), the
// consumer's own elementwise work beside its products (two consumer
// warpgroups need a second copy of the streamed tiles: no room at hD
// 128), and skipping the ring's fully masked blocks (every row of the
// block with no visible key) outside the kernels.

#include <cstdint>

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "tc_common.cuh"

namespace {

constexpr float kNegInf = -1e30f;

struct Strides {
  long long b, t, h;
};

// ---------------------------------------------------------------------------
// bfloat16: the tensor-core kernels (building blocks in tc_common.cuh)
// ---------------------------------------------------------------------------

constexpr int kBN = 64;  // keys of a K/V tile (forward, dQ)
constexpr int kBQ = 64;  // query rows of a Q/dO tile (dK/dV)
// warps of a block, 16 rows (keys) each.  chip_smoke.py prints each
// instance's registers, spills and shared memory: at hD 128 dK/dV holds
// two 16 x 128 float32 accumulators a warp and spills a few words (tried:
// 8 warps, halves of 16 queries, P^T dO before dP^T, the halves not
// unrolled; none removed the spill, none was faster)
constexpr int kFwdWarps = 4;
constexpr int kDqWarps = 4;
constexpr int kDkvWarps = 4;

// Stage rows row0 .. row0+ROWS-1 of one (batch, head) slice into a
// swizzled tile with cp.async; rows at or past n_rows are zero-filled.
template <int HD, int ROWS, int NT>
__device__ __forceinline__ void stage_tile(bf16* dst, const bf16* base,
                                           long long s_tok, int row0,
                                           int n_rows) {
  constexpr int kCPR = HD / 8;
#pragma unroll
  for (int idx = threadIdx.x; idx < ROWS * kCPR; idx += NT) {
    const int r = idx / kCPR;
    const int c = idx % kCPR;
    const bool ok = row0 + r < n_rows;
    const bf16* src = ok ? base + (row0 + r) * s_tok + c * 8 : base;
    cp_async16(smem_u32(dst + swz<HD>(r, c)), src, ok);
  }
}

__device__ __forceinline__ long long floor_div(long long a, long long b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

// Accumulator element e of n8 tile j sits at row g + 8 (e / 2), column
// 8 j + 2 t + e % 2 (g = lane / 4, t = lane % 4).

template <int HD, int W>
constexpr int fwd_tc_smem_bytes() {
  return (16 * W + 4 * kBN) * HD * 2;
}

template <int HD, int W>
__global__ void __launch_bounds__(32 * W)
flash_attention_fwd_tc_kernel(const bf16* __restrict__ q,
                              const bf16* __restrict__ k,
                              const bf16* __restrict__ v,
                              bf16* __restrict__ out, float* __restrict__ lse,
                              int Sq, int Sk, int nH, Strides qs, Strides ks,
                              Strides vs, float scale, int causal,
                              int offset) {
  constexpr int BM = 16 * W;
  constexpr int NT = 32 * W;
  constexpr int NJ = kBN / 8;  // n8 tiles of a score row
  constexpr int ND = HD / 8;   // n8 tiles of an output row
  extern __shared__ __align__(128) unsigned char tc_smem[];
  bf16* sQ = reinterpret_cast<bf16*>(tc_smem);
  bf16* sK = sQ + BM * HD;        // [2][kBN][HD]
  bf16* sV = sK + 2 * kBN * HD;   // [2][kBN][HD]

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BM;  // long tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int w0 = q0 + warp * 16;
  const bf16* kb = k + b * ks.b + h * ks.h;
  const bf16* vb = v + b * vs.b + h * vs.h;

  const int k_end = causal && q0 + offset >= 0
                        ? min(Sk, q0 + BM + offset) : Sk;
  const int n_tiles = (k_end + kBN - 1) / kBN;
  const bool skips = causal && q0 + offset >= 0;

  stage_tile<HD, BM, NT>(sQ, q + b * qs.b + h * qs.h, qs.t, q0, Sq);
  stage_tile<HD, kBN, NT>(sK, kb, ks.t, 0, Sk);
  stage_tile<HD, kBN, NT>(sV, vb, vs.t, 0, Sk);
  cp_async_commit();

  float o[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this lane's share of the row sums

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * kBN;
    if (it + 1 < n_tiles) {
      const int st = (it + 1) & 1;
      stage_tile<HD, kBN, NT>(sK + st * kBN * HD, kb, ks.t, k0 + kBN, Sk);
      stage_tile<HD, kBN, NT>(sV + st * kBN * HD, vb, vs.t, k0 + kBN, Sk);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* cK = sK + (it & 1) * kBN * HD;
    const bf16* cV = sV + (it & 1) * kBN * HD;
    // this warp's rows see no key of the tile: p = 0 on all of it
    if (!(skips && k0 > w0 + 15 + offset)) {
      float s[NJ][4];
      qk_tile<HD, NJ>(s, sQ, warp * 16, cK, 0, lane);
      const bool masked =
          k0 + kBN > Sk || (causal && k0 + kBN - 1 > w0 + offset);
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = __fmul_rn(s[j][e], scale);
          if (masked) {
            const int qi = w0 + g + ((e >> 1) << 3);
            const int kj = k0 + j * 8 + 2 * t + (e & 1);
            if (causal && kj > qi + offset) x = kNegInf;
            if (kj >= Sk) x = -INFINITY;  // not a key: p = 0 in every row
          }
          s[j][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m[r], quad_max(mx[r]));
        corr[r] = __expf(m[r] - m_new);
        m[r] = m_new;
        l[r] *= corr[r];
      }
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        o[j][0] *= corr[0];
        o[j][1] *= corr[0];
        o[j][2] *= corr[1];
        o[j][3] *= corr[1];
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = __expf(s[j][e] - m[e >> 1]);
          l[e >> 1] += p;
          s[j][e] = p;
        }
#pragma unroll
      for (int kc = 0; kc < kBN / 16; ++kc) {
        pv_step<HD>(o, s[2 * kc], s[2 * kc + 1], cV, kc * 16, lane);
      }
    }
    __syncthreads();  // the stage is read by all before it is refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = w0 + g + 8 * r;
    const float lr = quad_sum(l[r]);
    const float l_safe = lr == 0.f ? 1.f : lr;
    if (qi < Sq) {
      bf16* orow = out + ((static_cast<long long>(b) * Sq + qi) * nH + h) * HD;
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        const __nv_bfloat162 pr = __floats2bfloat162_rn(
            o[j][2 * r] / l_safe, o[j][2 * r + 1] / l_safe);
        *reinterpret_cast<__nv_bfloat162*>(orow + j * 8 + 2 * t) = pr;
      }
      if (t == 0)
        lse[(static_cast<long long>(b) * nH + h) * Sq + qi] =
            m[r] + logf(l_safe);
    }
  }
}

template <int HD, int W>
constexpr int dq_tc_smem_bytes() {
  return (2 * 16 * W + 4 * kBN) * HD * 2;
}

template <int HD, int W>
__global__ void __launch_bounds__(32 * W)
flash_attention_bwd_dq_tc_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dq, int Sq, int Sk, int nH, Strides qs, Strides ks,
    Strides vs, Strides ds, float scale, int causal, int offset) {
  constexpr int BM = 16 * W;
  constexpr int NT = 32 * W;
  constexpr int NJ = kBN / 8;
  constexpr int ND = HD / 8;
  extern __shared__ __align__(128) unsigned char tc_smem[];
  bf16* sQ = reinterpret_cast<bf16*>(tc_smem);
  bf16* sO = sQ + BM * HD;        // dO
  bf16* sK = sO + BM * HD;        // [2][kBN][HD]
  bf16* sV = sK + 2 * kBN * HD;   // [2][kBN][HD]

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BM;  // long tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int w0 = q0 + warp * 16;
  const long long row = (static_cast<long long>(b) * nH + h) * Sq;
  const bf16* kb = k + b * ks.b + h * ks.h;
  const bf16* vb = v + b * vs.b + h * vs.h;

  const int k_end = causal && q0 + offset >= 0
                        ? min(Sk, q0 + BM + offset) : Sk;
  const int n_tiles = (k_end + kBN - 1) / kBN;
  const bool skips = causal && q0 + offset >= 0;

  stage_tile<HD, BM, NT>(sQ, q + b * qs.b + h * qs.h, qs.t, q0, Sq);
  stage_tile<HD, BM, NT>(sO, dout + b * ds.b + h * ds.h, ds.t, q0, Sq);
  stage_tile<HD, kBN, NT>(sK, kb, ks.t, 0, Sk);
  stage_tile<HD, kBN, NT>(sV, vb, vs.t, 0, Sk);
  cp_async_commit();

  float lr[2];
  float dr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = w0 + g + 8 * r;
    lr[r] = qi < Sq ? lse[row + qi] : 0.f;
    dr[r] = qi < Sq ? delta[row + qi] : 0.f;
  }
  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * kBN;
    if (it + 1 < n_tiles) {
      const int st = (it + 1) & 1;
      stage_tile<HD, kBN, NT>(sK + st * kBN * HD, kb, ks.t, k0 + kBN, Sk);
      stage_tile<HD, kBN, NT>(sV + st * kBN * HD, vb, vs.t, k0 + kBN, Sk);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* cK = sK + (it & 1) * kBN * HD;
    const bf16* cV = sV + (it & 1) * kBN * HD;
    if (!(skips && k0 > w0 + 15 + offset)) {
      float s[NJ][4];
      float dp[NJ][4];
      qk_tile<HD, NJ>(s, sQ, warp * 16, cK, 0, lane);
      qk_tile<HD, NJ>(dp, sO, warp * 16, cV, 0, lane);
      const bool masked =
          k0 + kBN > Sk || (causal && k0 + kBN - 1 > w0 + offset);
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = __fmul_rn(s[j][e], scale);
          bool key = true;
          if (masked) {
            const int qi = w0 + g + ((e >> 1) << 3);
            const int kj = k0 + j * 8 + 2 * t + (e & 1);
            if (causal && kj > qi + offset) x = kNegInf;
            key = kj < Sk;
          }
          const float p = key ? __expf(x - lr[e >> 1]) : 0.f;
          // (p * (dp - delta)) * scale, as _bwd_dq_kernel computes ds
          s[j][e] = __fmul_rn(__fmul_rn(p, dp[j][e] - dr[e >> 1]), scale);
        }
#pragma unroll
      for (int kc = 0; kc < kBN / 16; ++kc) {
        pv_step<HD>(acc, s[2 * kc], s[2 * kc + 1], cK, kc * 16, lane);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = w0 + g + 8 * r;
    if (qi < Sq) {
      bf16* orow = dq + ((static_cast<long long>(b) * Sq + qi) * nH + h) * HD;
#pragma unroll
      for (int j = 0; j < ND; ++j)
        *reinterpret_cast<__nv_bfloat162*>(orow + j * 8 + 2 * t) =
            __floats2bfloat162_rn(acc[j][2 * r], acc[j][2 * r + 1]);
    }
  }
}

template <int HD, int W>
constexpr int dkv_tc_smem_bytes() {
  return (2 * 16 * W + 4 * kBQ) * HD * 2 + 4 * kBQ * 4;
}

template <int HD, int W>
__global__ void __launch_bounds__(32 * W)
flash_attention_bwd_dkv_tc_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq, int Sk, int nH,
    Strides qs, Strides ks, Strides vs, Strides ds, float scale, int causal,
    int offset) {
  constexpr int BK = 16 * W;  // keys of the block
  constexpr int NT = 32 * W;
  constexpr int kSub = 32;    // queries a warp takes at once
  constexpr int NJ = kSub / 8;
  constexpr int ND = HD / 8;
  extern __shared__ __align__(128) unsigned char tc_smem[];
  bf16* sK = reinterpret_cast<bf16*>(tc_smem);
  bf16* sV = sK + BK * HD;
  bf16* sQ = sV + BK * HD;           // [2][kBQ][HD]
  bf16* sO = sQ + 2 * kBQ * HD;      // [2][kBQ][HD] dO
  float* sL = reinterpret_cast<float*>(sO + 2 * kBQ * HD);  // [2][kBQ]
  float* sD = sL + 2 * kBQ;                                 // [2][kBQ]

  const int k0 = blockIdx.x * BK;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int kw = k0 + warp * 16;  // first key of this warp
  const long long row = (static_cast<long long>(b) * nH + h) * Sq;
  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* ob = dout + b * ds.b + h * ds.h;

  // Under the causal mask, query tile i (rows q0 = i kBQ ..) is skipped
  // when every row has a visible key (q0 + offset >= 0) and its last row
  // does not see key k0 (q0 + kBQ - 1 + offset < k0): the tiles
  // [skip_lo, skip_hi).  The rest are visited in order.
  const int nq = (Sq + kBQ - 1) / kBQ;
  int skip_lo = nq;
  int skip_hi = nq;
  if (causal) {
    const long long lo = -floor_div(offset, kBQ);
    const long long hi =
        floor_div(static_cast<long long>(k0) - offset - kBQ, kBQ) + 1;
    const long long clo = lo < 0 ? 0 : (lo > nq ? nq : lo);
    const long long chi = hi < 0 ? 0 : (hi > nq ? nq : hi);
    if (clo < chi) {
      skip_lo = static_cast<int>(clo);
      skip_hi = static_cast<int>(chi);
    }
  }
  const int n_visit = nq - (skip_hi - skip_lo);

  auto stage_q = [&](int it, int st) {
    const int q0 = (it < skip_lo ? it : it + skip_hi - skip_lo) * kBQ;
    stage_tile<HD, kBQ, NT>(sQ + st * kBQ * HD, qb, qs.t, q0, Sq);
    stage_tile<HD, kBQ, NT>(sO + st * kBQ * HD, ob, ds.t, q0, Sq);
    for (int r = threadIdx.x; r < kBQ; r += NT) {
      const bool ok = q0 + r < Sq;
      cp_async4(smem_u32(sL + st * kBQ + r), ok ? lse + row + q0 + r : lse,
                ok);
      cp_async4(smem_u32(sD + st * kBQ + r), ok ? delta + row + q0 + r : delta,
                ok);
    }
  };

  stage_tile<HD, BK, NT>(sK, k + b * ks.b + h * ks.h, ks.t, k0, Sk);
  stage_tile<HD, BK, NT>(sV, v + b * vs.b + h * vs.h, vs.t, k0, Sk);
  if (n_visit > 0) stage_q(0, 0);
  cp_async_commit();

  float gk[ND][4];
  float gv[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      gk[j][e] = 0.f;
      gv[j][e] = 0.f;
    }

  for (int it = 0; it < n_visit; ++it) {
    const int q0 = (it < skip_lo ? it : it + skip_hi - skip_lo) * kBQ;
    if (it + 1 < n_visit) stage_q(it + 1, (it + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int st = it & 1;
    const bf16* cQ = sQ + st * kBQ * HD;
    const bf16* cO = sO + st * kBQ * HD;
    const float* cL = sL + st * kBQ;
    const float* cD = sD + st * kBQ;
    // this warp's keys are past Sk, or no row of the tile sees them
    const bool idle = kw >= Sk || (causal && q0 + offset >= 0 &&
                                   q0 + kBQ - 1 + offset < kw);
    if (!idle) {
      const bool masked = q0 + kBQ > Sq || kw + 16 > Sk ||
                          (causal && kw + 15 > q0 + offset);
#pragma unroll
      for (int sub = 0; sub < kBQ / kSub; ++sub) {
        float s[NJ][4];   // S^T [key][query], then P^T
        float dp[NJ][4];  // dP^T [key][query], then dS^T
        qk_tile<HD, NJ>(s, sK, warp * 16, cQ, sub * kSub, lane);
        qk_tile<HD, NJ>(dp, sV, warp * 16, cO, sub * kSub, lane);
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = sub * kSub + j * 8 + 2 * t + (e & 1);
            float x = __fmul_rn(s[j][e], scale);
            bool in = true;
            if (masked) {
              const int qi = q0 + c;
              const int kj = kw + g + ((e >> 1) << 3);
              if (causal && kj > qi + offset) x = kNegInf;
              in = qi < Sq && kj < Sk;
            }
            const float p = in ? __expf(x - cL[c]) : 0.f;
            s[j][e] = p;
            // (p * (dp - delta)) * scale, as _bwd_dkv_kernel computes ds
            dp[j][e] = __fmul_rn(__fmul_rn(p, dp[j][e] - cD[c]), scale);
          }
#pragma unroll
        for (int kc = 0; kc < kSub / 16; ++kc) {
          pv_step<HD>(gv, s[2 * kc], s[2 * kc + 1], cO, sub * kSub + kc * 16,
                      lane);
          pv_step<HD>(gk, dp[2 * kc], dp[2 * kc + 1], cQ,
                      sub * kSub + kc * 16, lane);
        }
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kj = kw + g + 8 * r;
    if (kj < Sk) {
      const long long o = ((static_cast<long long>(b) * Sk + kj) * nH + h) * HD;
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(dk + o + j * 8 + 2 * t) =
            __floats2bfloat162_rn(gk[j][2 * r], gk[j][2 * r + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dv + o + j * 8 + 2 * t) =
            __floats2bfloat162_rn(gv[j][2 * r], gv[j][2 * r + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// float32 forward: three TF32 products a product on wgmma
// ---------------------------------------------------------------------------

constexpr int kF32Warps = 8;     // two warpgroups of 64 query rows
constexpr int kF32BM = 16 * kF32Warps;
constexpr int kF32BN = 32;       // keys of a K/V tile: one 128-byte row

// d (64 x 16 float32, one warpgroup) = (scale_d ? d : 0) + A * B^T: A
// 64 x 8 and B 16 x 8 TF32, both K-major in 128-byte-swizzled shared
// memory, named by descriptors
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[8], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(scale_d));
}

// the same, 64 x 32: B 32 x 8
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[16], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 32 float32, one warpgroup) = (scale_d ? d : 0) + A * B^T: A
// 64 x 8 TF32 in registers (a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
// of each warp's 16 rows), B 32 x 8 TF32, K-major in shared memory
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[16],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

// d (64 x 64 float32, one warpgroup) = (scale_d ? d : 0) + A * B^T: A
// 64 x 8 TF32 in registers (a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
// of each warp's 16 rows), B 64 x 8 TF32, K-major in shared memory
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

// d (64 x 128 float32, one warpgroup) = (scale_d ? d : 0) + A * B^T: A
// 64 x 8 TF32 in registers (a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
// of each warp's 16 rows), B 128 x 8 TF32, K-major in shared memory
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

// Q and K tiles are K-major [ROWS][HD] in hD / 32 sub-tiles of 32 floats
// (one 128-byte swizzled row each): chunk c of row r is sub-tile c / 8.
template <int ROWS>
__device__ __forceinline__ uint32_t kmajor_off(int r, int c) {
  return (c >> 3) * (ROWS * 128) + sw128(r, c & 7);
}

// V^T: [HD][32 keys], one 128-byte swizzled row a column of V; key j of
// the tile sits at p(j) = 8 (j / 8) + (j % 8) / 2 + 4 (j % 2), so the P V
// step's B column t is key 2t and column t + 4 key 2t + 1 (see below).
__device__ __forceinline__ uint32_t vt_off(int d, int j) {
  const int p = (j & ~7) | ((j & 7) >> 1) | ((j & 1) << 2);
  return sw128(d, p >> 2) + (p & 3) * 4;
}

// cp.async rows row0 .. row0+ROWS-1 of one (batch, head) slice into a
// K-major tile at byte address dst; rows at or past n_rows are zeros.
// Thread i copies chunks i, i + NT, ...
template <int HD, int ROWS, int NT>
__device__ __forceinline__ void stage_kmajor(uint32_t dst, const float* base,
                                             long long s_tok, int row0,
                                             int n_rows) {
  constexpr int kCPR = HD / 4;
#pragma unroll
  for (int idx = threadIdx.x; idx < ROWS * kCPR; idx += NT) {
    const int r = idx / kCPR;
    const int c = idx % kCPR;
    const bool ok = row0 + r < n_rows;
    cp_async16(dst + kmajor_off<ROWS>(r, c),
               ok ? base + (row0 + r) * s_tok + c * 4 : base, ok);
  }
}

// Split the chunks this thread copied (times `mul`) into `hi` (in place)
// and `lo`, generic pointers to the two tiles.
template <int HD, int ROWS, int NT>
__device__ __forceinline__ void split_kmajor(unsigned char* hi,
                                             unsigned char* lo, float mul) {
  constexpr int kCPR = HD / 4;
#pragma unroll
  for (int idx = threadIdx.x; idx < ROWS * kCPR; idx += NT) {
    const uint32_t o = kmajor_off<ROWS>(idx / kCPR, idx % kCPR);
    float4 x = *reinterpret_cast<const float4*>(hi + o);
    if (mul != 1.f) {
      x.x = __fmul_rn(x.x, mul);
      x.y = __fmul_rn(x.y, mul);
      x.z = __fmul_rn(x.z, mul);
      x.w = __fmul_rn(x.w, mul);
    }
    uint4 h, l;
    tf32_split(x.x, h.x, l.x);
    tf32_split(x.y, h.y, l.y);
    tf32_split(x.z, h.z, l.z);
    tf32_split(x.w, h.w, l.w);
    *reinterpret_cast<uint4*>(hi + o) = h;
    *reinterpret_cast<uint4*>(lo + o) = l;
  }
}

template <int HD>
constexpr int fwd_tf32x3_smem_bytes() {
  return (2 * kF32BM + 6 * kF32BN) * HD * 4 + 1024;
}

template <int HD>
__global__ void __launch_bounds__(32 * kF32Warps, 1)
flash_attention_fwd_tf32x3_kernel(const float* __restrict__ q,
                                  const float* __restrict__ k,
                                  const float* __restrict__ v,
                                  float* __restrict__ out,
                                  float* __restrict__ lse, int Sq, int Sk,
                                  int nH, Strides qs, Strides ks, Strides vs,
                                  float scale, int causal, int offset) {
  constexpr int BM = kF32BM;
  constexpr int NT = 32 * kF32Warps;
  constexpr int ND = HD / 8;          // n8 tiles of an output row
  constexpr int KQ = BM * HD * 4;     // bytes of a Q tile (hi or lo)
  constexpr int KK = kF32BN * HD * 4; // bytes of a K tile, and of V^T's
  constexpr int VPT = HD / 32;        // V chunks a thread stages a tile
  extern __shared__ unsigned char fa_smem[];
  const uint32_t base = (smem_u32(fa_smem) + 1023u) & ~1023u;
  unsigned char* const gbase = fa_smem + (base - smem_u32(fa_smem));
  // Q hi, Q lo, K hi, K lo, then V^T hi and lo of two tiles in turn
  const uint32_t sQh = base, sQl = base + KQ, sKh = base + 2 * KQ,
                 sKl = sKh + KK, sV = sKl + KK;

  // the longest query tiles of every head first: a block's work grows
  // with its tile under the causal mask, and the grid runs in waves
  const int heads = gridDim.y * gridDim.z;
  const int lin = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y *
                                            blockIdx.z);
  const int q0 = (gridDim.x - 1 - lin / heads) * BM;
  const int h = lin % heads % gridDim.y;
  const int b = lin % heads / gridDim.y;
  const int wg = threadIdx.x >> 7;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wg0 = q0 + wg * 64;                   // this warpgroup's rows
  const int w0 = q0 + warp * 16;                  // this warp's rows
  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;

  const int k_end = causal && q0 + offset >= 0
                        ? min(Sk, q0 + BM + offset) : Sk;
  const int n_tiles = (k_end + kF32BN - 1) / kF32BN;
  const bool skips = causal && q0 + offset >= 0;

  // V tile it: lane j loads key it*32 + j, hD chunks warp + 8 i
  float4 vreg[VPT];
  auto load_v = [&](int it) {
    const int key = it * kF32BN + lane;
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int c = warp + 8 * i;
      vreg[i] = key < Sk ? *reinterpret_cast<const float4*>(
                               vb + key * vs.t + c * 4)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  // ... then split and transposed into V^T hi / lo of slot `it & 1`: a
  // warp writes one 128-byte row at a time
  auto store_v = [&](int it) {
    unsigned char* vh = gbase + (sV - base) + (it & 1) * 2 * KK;
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int c = warp + 8 * i;
      const float x[4] = {vreg[i].x, vreg[i].y, vreg[i].z, vreg[i].w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        uint32_t hi, lo;
        tf32_split(x[e], hi, lo);
        const uint32_t o = vt_off(4 * c + e, lane);
        *reinterpret_cast<uint32_t*>(vh + o) = hi;
        *reinterpret_cast<uint32_t*>(vh + KK + o) = lo;
      }
    }
  };

  stage_kmajor<HD, BM, NT>(sQh, q + b * qs.b + h * qs.h, qs.t, q0, Sq);
  stage_kmajor<HD, kF32BN, NT>(sKh, kb, ks.t, 0, Sk);
  cp_async_commit();
  load_v(0);
  cp_async_wait<0>();
  // q * scale in float32 (as the plain versions have it), then split;
  // Q once a block, K and V once a tile, by the threads that staged them
  split_kmajor<HD, BM, NT>(gbase, gbase + KQ, scale);
  split_kmajor<HD, kF32BN, NT>(gbase + 2 * KQ, gbase + 2 * KQ + KK, 1.f);
  store_v(0);
  if (1 < n_tiles) load_v(1);
  fence_proxy_async();
  __syncthreads();

  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this lane's share of the row sums
  // this warpgroup's 64 rows in the Q tiles: its A descriptors
  const uint64_t dQh = sw128_desc(sQh + wg * 64 * 128);
  const uint64_t dQl = sw128_desc(sQl + wg * 64 * 128);
  const uint64_t dKh = sw128_desc(sKh);
  const uint64_t dKl = sw128_desc(sKl);

  float s[16] = {};
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * kF32BN;
    // this warpgroup's rows see no key of the tile: p = 0 on all of it
    const bool idle = skips && k0 > wg0 + 63 + offset;
    if (!idle) {
      // S = (Q scale) K^T: 3 products a k8 step, one accumulator chain;
      // a sub-tile of 32 floats is 4 steps of 32 bytes
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 8; ++kk) {
        const uint64_t step = (kk >> 2) * (BM * 128 >> 4) + 2 * (kk & 3);
        const uint64_t kstep = (kk >> 2) * (kF32BN * 128 >> 4) + 2 * (kk & 3);
        wgmma_tf32_ss(s, dQh + step, dKh + kstep, kk > 0);
        wgmma_tf32_ss(s, dQh + step, dKl + kstep, 1);
        wgmma_tf32_ss(s, dQl + step, dKh + kstep, 1);
      }
      wgmma_commit();
    }
    // tile it + 1's V^T into the other slot (its readers, the P V of tile
    // it - 1, are done), while S runs; then tile it + 2's V loads
    if (it + 1 < n_tiles) {
      store_v(it + 1);
      fence_proxy_async();
      if (it + 2 < n_tiles) load_v(it + 2);
    }
    if (!idle) {
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < 16; ++i) asm volatile("" : "+f"(s[i])::"memory");
    }
    __syncthreads();  // both warpgroups are done reading K
    if (it + 1 < n_tiles) stage_kmajor<HD, kF32BN, NT>(sKh, kb, ks.t,
                                                       k0 + kF32BN, Sk);
    cp_async_commit();
    if (!idle) {
      const bool masked =
          k0 + kF32BN > Sk || (causal && k0 + kF32BN - 1 > wg0 + offset);
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[4 * j + e];
          if (masked) {
            const int qi = w0 + g + ((e >> 1) << 3);
            const int kj = k0 + j * 8 + 2 * t + (e & 1);
            if (causal && kj > qi + offset) x = kNegInf;
            if (kj >= Sk) x = -INFINITY;  // not a key: p = 0 in every row
          }
          s[4 * j + e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m[r], quad_max(mx[r]));
        corr[r] = expf(m[r] - m_new);
        m[r] = m_new;
        l[r] *= corr[r];
      }
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        o[4 * j] *= corr[0];
        o[4 * j + 1] *= corr[0];
        o[4 * j + 2] *= corr[1];
        o[4 * j + 3] *= corr[1];
      }
      // P = exp(S - m), split: the A fragment of k8 step j takes key 2t
      // as column t and key 2t + 1 as column t + 4 — where the score
      // accumulators hold them — and V^T stores its keys in that order
      uint32_t ph[4][4];
      uint32_t pl[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[e] = expf(s[4 * j + e] - m[e >> 1]);
          l[e >> 1] += p[e];
        }
        tf32_split(p[0], ph[j][0], pl[j][0]);
        tf32_split(p[2], ph[j][1], pl[j][1]);
        tf32_split(p[1], ph[j][2], pl[j][2]);
        tf32_split(p[3], ph[j][3], pl[j][3]);
      }
      const uint64_t dVh = sw128_desc(sV + (it & 1) * 2 * KK);
      const uint64_t dVl = dVh + (KK >> 4);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wgmma_tf32_rs(o, ph[j], dVh + 2 * j);
        wgmma_tf32_rs(o, ph[j], dVl + 2 * j);
        wgmma_tf32_rs(o, pl[j], dVh + 2 * j);
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) asm volatile("" : "+f"(o[i])::"memory");
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          asm volatile("" : "+r"(ph[j][e])::"memory");
          asm volatile("" : "+r"(pl[j][e])::"memory");
        }
    }
    if (it + 1 < n_tiles) {
      cp_async_wait<0>();
      split_kmajor<HD, kF32BN, NT>(gbase + 2 * KQ, gbase + 2 * KQ + KK, 1.f);
      fence_proxy_async();
      // tile it + 1's K and V^T, split, for wgmma; both warpgroups are
      // done reading tile it's V^T slot, which tile it + 2 refills
      __syncthreads();
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = w0 + g + 8 * r;
    const float lr = quad_sum(l[r]);
    const float l_safe = lr == 0.f ? 1.f : lr;
    if (qi < Sq) {
      float* orow = out + ((static_cast<long long>(b) * Sq + qi) * nH + h) * HD;
#pragma unroll
      for (int j = 0; j < ND; ++j)
        *reinterpret_cast<float2*>(orow + 8 * j + 2 * t) =
            make_float2(o[4 * j + 2 * r] / l_safe, o[4 * j + 2 * r + 1] / l_safe);
      if (t == 0)
        lse[(static_cast<long long>(b) * nH + h) * Sq + qi] =
            m[r] + logf(l_safe);
    }
  }
}

// ---------------------------------------------------------------------------
// float32 backward: dK/dV and dQ, three TF32 products a product on wgmma
// ---------------------------------------------------------------------------

constexpr int kBwdRows = 64;      // keys (dK/dV) or query rows (dQ) of a block
constexpr int kBwdThreads = 256;  // a consumer and a producer warpgroup
constexpr int kDqBN = 32;         // keys of a dQ K/V tile

// The block's mbarriers (8 bytes each, 128 arrivals a phase, one phase
// a tile): the producer's K-major tiles full, the consumer done with
// them, the transposed tiles full, the consumer done with them.
enum Bar { kKmFull = 0, kKmEmpty = 1, kTFull = 2, kTEmpty = 3 };
constexpr int kBarBytes = 32;

// query rows of a dK/dV Q/dO tile: 16 at hD 128 (shared memory), else 32
template <int HD>
__host__ __device__ constexpr int dkv_bq() {
  return HD == 128 ? 16 : 32;
}

// The producer warpgroup streams the tiles that are not resident: a
// thread holds NC 16-byte chunks of an [ROWS][HD] tile in registers,
// chunk slot idx = p + 128 n.  In the pair order lane pairs read the 32
// contiguous bytes of chunks 2m and 2m + 1 of one row (slot idx: row
// (idx / 2) % ROWS, chunk 2 (idx / 2 ROWS) + idx % 2), so a warp's
// transposed writes fall in two rows of the [HD][32] tile four apart,
// whose swizzles differ: no bank conflicts.  Else row by row.
template <int HD, int ROWS, bool PAIRS>
__device__ __forceinline__ void tile_chunk(int idx, int& r, int& c) {
  if (PAIRS) {
    r = (idx >> 1) % ROWS;
    c = 2 * (idx / (2 * ROWS)) + (idx & 1);
  } else {
    r = idx / (HD / 4);
    c = idx % (HD / 4);
  }
}

// rows row0 .. row0+ROWS-1 of one (batch, head) slice into registers;
// rows at or past n_rows are zeros
template <int HD, int ROWS, bool PAIRS, int NC>
__device__ __forceinline__ void load_chunks(float4 (&x)[NC], const float* base,
                                            long long s_tok, int row0,
                                            int n_rows, int p) {
  static_assert(NC * 512 == ROWS * HD, "chunks a producer thread holds");
#pragma unroll
  for (int n = 0; n < NC; ++n) {
    int r, c;
    tile_chunk<HD, ROWS, PAIRS>(p + 128 * n, r, c);
    x[n] = row0 + r < n_rows
               ? *reinterpret_cast<const float4*>(base + (row0 + r) * s_tok +
                                                  c * 4)
               : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// ... split (times `mul`, in float32) into h and l, stored into the
// K-major tiles `hi` and `lo` (generic pointers)
template <int HD, int ROWS, bool PAIRS, int NC>
__device__ __forceinline__ void store_split(const float4 (&x)[NC],
                                            uint4 (&h)[NC], uint4 (&l)[NC],
                                            unsigned char* hi,
                                            unsigned char* lo, float mul,
                                            int p) {
#pragma unroll
  for (int n = 0; n < NC; ++n) {
    int r, c;
    tile_chunk<HD, ROWS, PAIRS>(p + 128 * n, r, c);
    float4 v = x[n];
    if (mul != 1.f) {
      v.x = __fmul_rn(v.x, mul);
      v.y = __fmul_rn(v.y, mul);
      v.z = __fmul_rn(v.z, mul);
      v.w = __fmul_rn(v.w, mul);
    }
    tf32_split(v.x, h[n].x, l[n].x);
    tf32_split(v.y, h[n].y, l[n].y);
    tf32_split(v.z, h[n].z, l[n].z);
    tf32_split(v.w, h[n].w, l[n].w);
    const uint32_t o = kmajor_off<ROWS>(r, c);
    *reinterpret_cast<uint4*>(hi + o) = h[n];
    *reinterpret_cast<uint4*>(lo + o) = l[n];
  }
}

// ... and transposed into the [HD][32] tiles `thi` and `tlo` (vt_off:
// row d of the operand's column d, its row r at position p(r))
template <int HD, int ROWS, int NC>
__device__ __forceinline__ void store_transposed(const uint4 (&h)[NC],
                                                 const uint4 (&l)[NC],
                                                 unsigned char* thi,
                                                 unsigned char* tlo, int p) {
#pragma unroll
  for (int n = 0; n < NC; ++n) {
    int r, c;
    tile_chunk<HD, ROWS, true>(p + 128 * n, r, c);
    const uint32_t hv[4] = {h[n].x, h[n].y, h[n].z, h[n].w};
    const uint32_t lv[4] = {l[n].x, l[n].y, l[n].z, l[n].w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const uint32_t o = vt_off(4 * c + e, r);
      *reinterpret_cast<uint32_t*>(thi + o) = hv[e];
      *reinterpret_cast<uint32_t*>(tlo + o) = lv[e];
    }
  }
}

// The A fragment of k8 step j from a 64 x 8n score accumulator: columns t
// and t + 4 are the accumulator's columns 2t and 2t + 1 (the B tiles store
// their rows in that order, vt_off), split into hi and lo.
template <int N>
__device__ __forceinline__ void acc_split(const float (&x)[N], int j,
                                          uint32_t (&hi)[4],
                                          uint32_t (&lo)[4]) {
  tf32_split(x[4 * j], hi[0], lo[0]);
  tf32_split(x[4 * j + 2], hi[1], lo[1]);
  tf32_split(x[4 * j + 1], hi[2], lo[2]);
  tf32_split(x[4 * j + 3], hi[3], lo[3]);
}

// d = the three products of the A fragments (hi, lo) of NJ k8 steps and
// the B tiles dBh, dBl ([rows of d][32], K-major): one chain from zero,
// waited for
template <int NJ, int ND>
__device__ __forceinline__ void tf32x3_chain(float (&d)[ND],
                                             uint32_t (&hi)[NJ][4],
                                             uint32_t (&lo)[NJ][4],
                                             uint64_t dBh, uint64_t dBl) {
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    wgmma_tf32_rs(d, hi[j], dBh + 2 * j, j == 0 ? 0 : 1);
    wgmma_tf32_rs(d, hi[j], dBl + 2 * j);
    wgmma_tf32_rs(d, lo[j], dBh + 2 * j);
  }
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < ND; ++i) asm volatile("" : "+f"(d[i])::"memory");
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      asm volatile("" : "+r"(hi[j][e])::"memory");
      asm volatile("" : "+r"(lo[j][e])::"memory");
    }
}

// sum (64 x HD, this thread's HD / 2 values) += those products, NP
// columns at a time as a chain from zero (B from row d0 of its tiles),
// added to sum with rounding adds: the tensor cores' truncating adds
// stay within one tile's products.
template <int NJ, int HD, int NP>
__device__ __forceinline__ void acc_products(float (&sum)[HD / 2],
                                             uint32_t (&hi)[NJ][4],
                                             uint32_t (&lo)[NJ][4],
                                             uint64_t dBh, uint64_t dBl) {
#pragma unroll
  for (int d0 = 0; d0 < HD; d0 += NP) {
    float part[NP / 2];
    const uint64_t o = d0 * 128 >> 4;
    tf32x3_chain<NJ>(part, hi, lo, dBh + o, dBl + o);
#pragma unroll
    for (int i = 0; i < NP / 2; ++i)
      sum[d0 / 2 + i] = __fadd_rn(sum[d0 / 2 + i], part[i]);
  }
}

template <int HD>
constexpr int dkv_tf32x3_smem_bytes() {
  // K and V hi/lo [64][HD], Q and dO hi/lo [BQ][HD], Q^T and dO^T hi/lo
  // [HD][32], lse and delta [2][BQ], the mbarriers, alignment
  return 4 * kBwdRows * HD * 4 + 4 * dkv_bq<HD>() * HD * 4 + 4 * HD * 128 +
         4 * dkv_bq<HD>() * 4 + kBarBytes + 1024;
}

template <int HD>
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_attention_bwd_dkv_tf32x3_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dk, float* __restrict__ dv, int Sq, int Sk, int nH,
    Strides qs, Strides ks, Strides vs, Strides ds, float scale, int causal,
    int offset) {
  constexpr int BQ = dkv_bq<HD>();
  constexpr int NJ = BQ / 8;             // k8 steps of a query tile
  constexpr int NP = HD < 64 ? HD : 64;  // columns of a stage sum
  constexpr int NC = BQ * HD / 512;      // chunks a producer thread stages
  constexpr int KK = kBwdRows * HD * 4;  // bytes of a K or V tile
  constexpr int KQ = BQ * HD * 4;        // bytes of a Q or dO tile
  constexpr int KT = HD * 128;           // bytes of a transposed tile
  extern __shared__ unsigned char fa_smem[];
  const uint32_t base = (smem_u32(fa_smem) + 1023u) & ~1023u;
  unsigned char* const gbase = fa_smem + (base - smem_u32(fa_smem));
  const uint32_t sKh = base, sKl = sKh + KK, sVh = sKl + KK, sVl = sVh + KK;
  const uint32_t sQh = sVl + KK, sQl = sQh + KQ, sOh = sQl + KQ,
                 sOl = sOh + KQ;                         // dO
  const uint32_t sQTh = sOl + KQ, sQTl = sQTh + KT, sOTh = sQTl + KT,
                 sOTl = sOTh + KT;                       // Q^T, dO^T
  float* const sL = reinterpret_cast<float*>(gbase + (sOTl + KT - base));
  float* const sD = sL + 2 * BQ;                         // [2][BQ] each
  const uint32_t bars = smem_u32(sD + 2 * BQ);
  auto at = [&](uint32_t a) { return gbase + (a - base); };

  // key tile 0 of every head first: under the causal mask a key tile's
  // work shrinks with its position, and the grid runs in waves
  const int heads = gridDim.y * gridDim.z;
  const int lin = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y *
                                            blockIdx.z);
  const int k0 = lin / heads * kBwdRows;
  const int h = lin % heads % gridDim.y;
  const int b = lin % heads / gridDim.y;
  const long long row = (static_cast<long long>(b) * nH + h) * Sq;

  // Under the causal mask, query tile i (rows q0 = i BQ ..) is skipped
  // when every row has a visible key (q0 + offset >= 0) and its last row
  // does not see key k0 (q0 + BQ - 1 + offset < k0): the tiles [skip_lo,
  // skip_hi).  The rest are visited in order.
  const int nq = (Sq + BQ - 1) / BQ;
  int skip_lo = nq;
  int skip_hi = nq;
  if (causal) {
    const long long lo = -floor_div(offset, BQ);
    const long long hi =
        floor_div(static_cast<long long>(k0) - offset - BQ, BQ) + 1;
    const long long clo = lo < 0 ? 0 : (lo > nq ? nq : lo);
    const long long chi = hi < 0 ? 0 : (hi > nq ? nq : hi);
    if (clo < chi) {
      skip_lo = static_cast<int>(clo);
      skip_hi = static_cast<int>(chi);
    }
  }
  const int n_visit = nq - (skip_hi - skip_lo);
  auto tile_q0 = [&](int it) {
    return (it < skip_lo ? it : it + skip_hi - skip_lo) * BQ;
  };

  // K and V of the block, split once, by both warpgroups
  stage_kmajor<HD, kBwdRows, kBwdThreads>(sKh, k + b * ks.b + h * ks.h, ks.t,
                                          k0, Sk);
  stage_kmajor<HD, kBwdRows, kBwdThreads>(sVh, v + b * vs.b + h * vs.h, vs.t,
                                          k0, Sk);
  cp_async_commit();
  if (threadIdx.x < 4) mbar_init(bars + 8 * threadIdx.x, 128);
  cp_async_wait<0>();
  split_kmajor<HD, kBwdRows, kBwdThreads>(at(sKh), at(sKl), 1.f);
  split_kmajor<HD, kBwdRows, kBwdThreads>(at(sVh), at(sVl), 1.f);
  fence_proxy_async();
  __syncthreads();

  // the warpgroup index through a shuffle, which ptxas knows to be
  // warp-uniform: with a plain threadIdx test it takes the consumer's
  // path for divergent and serializes its wgmma (twice the time)
  if (__shfl_sync(0xffffffffu, threadIdx.x >> 7, 0) == 1) {
    // the producer: visit it's Q (times scale, in float32, as the plain
    // versions have it) and dO, split, into the K-major tiles once the
    // consumer's S^T and dP^T of visit it - 1 are done, lse and delta
    // into slot it % 2; then transposed, once its products of visit
    // it - 1 are done.  The next visit's rows load in between.
    const int p = threadIdx.x - 128;
    const float* qb = q + b * qs.b + h * qs.h;
    const float* ob = dout + b * ds.b + h * ds.h;
    float4 xq[NC], xo[NC];
    uint4 hq[NC], lq[NC], ho[NC], lo[NC];
    float xl = 0.f, xd = 0.f;
    auto load = [&](int it) {
      const int q0 = tile_q0(it);
      load_chunks<HD, BQ, true>(xq, qb, qs.t, q0, Sq, p);
      load_chunks<HD, BQ, true>(xo, ob, ds.t, q0, Sq, p);
      if (p < BQ && q0 + p < Sq) {
        xl = lse[row + q0 + p];
        xd = delta[row + q0 + p];
      } else {
        xl = xd = 0.f;
      }
    };
    if (n_visit > 0) load(0);
    for (int it = 0; it < n_visit; ++it) {
      if (it > 0) mbar_wait(bars + 8 * kKmEmpty, (it - 1) & 1);
      store_split<HD, BQ, true>(xq, hq, lq, at(sQh), at(sQl), scale, p);
      store_split<HD, BQ, true>(xo, ho, lo, at(sOh), at(sOl), 1.f, p);
      if (p < BQ) {
        sL[(it & 1) * BQ + p] = xl;
        sD[(it & 1) * BQ + p] = xd;
      }
      fence_proxy_async();
      mbar_arrive(bars + 8 * kKmFull);
      if (it + 1 < n_visit) load(it + 1);
      if (it > 0) mbar_wait(bars + 8 * kTEmpty, (it - 1) & 1);
      store_transposed<HD, BQ>(hq, lq, at(sQTh), at(sQTl), p);
      store_transposed<HD, BQ>(ho, lo, at(sOTh), at(sOTl), p);
      fence_proxy_async();
      mbar_arrive(bars + 8 * kTFull);
    }
    return;
  }

  // the consumer warpgroup: the products and P, dS
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int kw = k0 + warp * 16;  // first key of this warp's rows
  float gk[HD / 2];
  float gv[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) {
    gk[i] = 0.f;
    gv[i] = 0.f;
  }
  const uint64_t dKh = sw128_desc(sKh), dKl = sw128_desc(sKl);
  const uint64_t dVh = sw128_desc(sVh), dVl = sw128_desc(sVl);
  const uint64_t dQh = sw128_desc(sQh), dQl = sw128_desc(sQl);
  const uint64_t dOh = sw128_desc(sOh), dOl = sw128_desc(sOl);
  const uint64_t dQTh = sw128_desc(sQTh), dQTl = sw128_desc(sQTl);
  const uint64_t dOTh = sw128_desc(sOTh), dOTl = sw128_desc(sOTl);

  float s[BQ / 2] = {};   // S^T [key][query], this thread's share
  float dp[BQ / 2] = {};  // dP^T
  for (int it = 0; it < n_visit; ++it) {
    const int q0 = tile_q0(it);
    mbar_wait(bars + 8 * kKmFull, it & 1);
    // S^T = K (Q scale)^T and dP^T = V dO^T: 3 products a k8 step, one
    // chain each over hD; a sub-tile of 32 floats is 4 steps of 32 bytes
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 8; ++kk) {
      const uint64_t a = (kk >> 2) * (kBwdRows * 128 >> 4) + 2 * (kk & 3);
      const uint64_t bq = (kk >> 2) * (BQ * 128 >> 4) + 2 * (kk & 3);
      wgmma_tf32_ss(s, dKh + a, dQh + bq, kk > 0);
      wgmma_tf32_ss(dp, dVh + a, dOh + bq, kk > 0);
      wgmma_tf32_ss(s, dKh + a, dQl + bq, 1);
      wgmma_tf32_ss(dp, dVh + a, dOl + bq, 1);
      wgmma_tf32_ss(s, dKl + a, dQh + bq, 1);
      wgmma_tf32_ss(dp, dVl + a, dOh + bq, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) {
      asm volatile("" : "+f"(s[i])::"memory");
      asm volatile("" : "+f"(dp[i])::"memory");
    }
    if (it + 1 < n_visit) mbar_arrive(bars + 8 * kKmEmpty);

    // P^T = exp(S^T - lse), dS^T = P^T (dP^T - delta), split into the A
    // fragments of the two accumulating products
    const float* cL = sL + (it & 1) * BQ;
    const float* cD = sD + (it & 1) * BQ;
    // one test for the warpgroup's 64 keys
    const bool masked = q0 + BQ > Sq || k0 + kBwdRows > Sk ||
                        (causal && k0 + kBwdRows - 1 > q0 + offset);
    uint32_t ph[NJ][4], pl[NJ][4], gh[NJ][4], gl[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * t + (e & 1);  // query of the tile
        float x = s[4 * j + e];
        bool in = true;
        if (masked) {
          const int qi = q0 + c;
          const int kj = kw + g + ((e >> 1) << 3);
          if (causal && kj > qi + offset) x = kNegInf;
          in = qi < Sq && kj < Sk;
        }
        const float p = in ? expf(x - cL[c]) : 0.f;
        s[4 * j + e] = p;
        dp[4 * j + e] = p * (dp[4 * j + e] - cD[c]);
      }
      acc_split(s, j, ph[j], pl[j]);
      acc_split(dp, j, gh[j], gl[j]);
    }
    // dV += P^T dO and dK += dS^T (Q scale): B is dO^T or Q^T
    mbar_wait(bars + 8 * kTFull, it & 1);
    acc_products<NJ, HD, NP>(gv, ph, pl, dOTh, dOTl);
    acc_products<NJ, HD, NP>(gk, gh, gl, dQTh, dQTl);
    if (it + 1 < n_visit) mbar_arrive(bars + 8 * kTEmpty);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kj = kw + g + 8 * r;
    if (kj < Sk) {
      const long long o = ((static_cast<long long>(b) * Sk + kj) * nH + h) * HD;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        *reinterpret_cast<float2*>(dk + o + 8 * j + 2 * t) =
            make_float2(gk[4 * j + 2 * r], gk[4 * j + 2 * r + 1]);
        *reinterpret_cast<float2*>(dv + o + 8 * j + 2 * t) =
            make_float2(gv[4 * j + 2 * r], gv[4 * j + 2 * r + 1]);
      }
    }
  }
}

template <int HD>
constexpr int dq_tf32x3_smem_bytes() {
  // Q and dO hi/lo [64][HD], K and V hi/lo [32][HD], K^T hi/lo [HD][32],
  // the mbarriers, alignment
  return 4 * kBwdRows * HD * 4 + 4 * kDqBN * HD * 4 + 2 * HD * 128 +
         kBarBytes + 1024;
}

template <int HD>
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_attention_bwd_dq_tf32x3_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dq, int Sq, int Sk, int nH, Strides qs, Strides ks,
    Strides vs, Strides ds, float scale, int causal, int offset) {
  constexpr int BN = kDqBN;
  constexpr int NC = BN * HD / 512;      // chunks a producer thread stages
  constexpr int KQ = kBwdRows * HD * 4;  // bytes of a Q or dO tile
  constexpr int KK = BN * HD * 4;        // bytes of a K or V tile
  constexpr int KT = HD * 128;           // bytes of the K^T tile
  extern __shared__ unsigned char fa_smem[];
  const uint32_t base = (smem_u32(fa_smem) + 1023u) & ~1023u;
  unsigned char* const gbase = fa_smem + (base - smem_u32(fa_smem));
  const uint32_t sQh = base, sQl = sQh + KQ, sOh = sQl + KQ,
                 sOl = sOh + KQ;                         // dO
  const uint32_t sKh = sOl + KQ, sKl = sKh + KK, sVh = sKl + KK,
                 sVl = sVh + KK;
  const uint32_t sKTh = sVl + KK, sKTl = sKTh + KT;      // K^T
  const uint32_t bars = sKTl + KT;
  auto at = [&](uint32_t a) { return gbase + (a - base); };

  // the longest query tiles of every head first (see the forward)
  const int heads = gridDim.y * gridDim.z;
  const int lin = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y *
                                            blockIdx.z);
  const int q0 = (gridDim.x - 1 - lin / heads) * kBwdRows;
  const int h = lin % heads % gridDim.y;
  const int b = lin % heads / gridDim.y;
  const long long row = (static_cast<long long>(b) * nH + h) * Sq;

  const int k_end = causal && q0 + offset >= 0
                        ? min(Sk, q0 + kBwdRows + offset) : Sk;
  const int n_tiles = (k_end + BN - 1) / BN;

  // Q (times scale, in float32, as the plain versions have it) and dO of
  // the block, split once, by both warpgroups
  stage_kmajor<HD, kBwdRows, kBwdThreads>(sQh, q + b * qs.b + h * qs.h, qs.t,
                                          q0, Sq);
  stage_kmajor<HD, kBwdRows, kBwdThreads>(sOh, dout + b * ds.b + h * ds.h,
                                          ds.t, q0, Sq);
  cp_async_commit();
  if (threadIdx.x < 4) mbar_init(bars + 8 * threadIdx.x, 128);
  cp_async_wait<0>();
  split_kmajor<HD, kBwdRows, kBwdThreads>(at(sQh), at(sQl), scale);
  split_kmajor<HD, kBwdRows, kBwdThreads>(at(sOh), at(sOl), 1.f);
  fence_proxy_async();
  __syncthreads();

  // the warpgroup index through a shuffle, which ptxas knows to be
  // warp-uniform: with a plain threadIdx test it takes the consumer's
  // path for divergent and serializes its wgmma (twice the time)
  if (__shfl_sync(0xffffffffu, threadIdx.x >> 7, 0) == 1) {
    // the producer: key tile it's K and V, split, into the K-major tiles
    // once the consumer's S and dP of tile it - 1 are done; then K
    // transposed, once its dS K of tile it - 1 is done.  The next tile's
    // rows load in between.
    const int p = threadIdx.x - 128;
    const float* kb = k + b * ks.b + h * ks.h;
    const float* vb = v + b * vs.b + h * vs.h;
    float4 xk[NC], xv[NC];
    uint4 hk[NC], lk[NC], hv[NC], lv[NC];
    auto load = [&](int it) {
      load_chunks<HD, BN, true>(xk, kb, ks.t, it * BN, Sk, p);
      load_chunks<HD, BN, false>(xv, vb, vs.t, it * BN, Sk, p);
    };
    load(0);
    for (int it = 0; it < n_tiles; ++it) {
      if (it > 0) mbar_wait(bars + 8 * kKmEmpty, (it - 1) & 1);
      store_split<HD, BN, true>(xk, hk, lk, at(sKh), at(sKl), 1.f, p);
      store_split<HD, BN, false>(xv, hv, lv, at(sVh), at(sVl), 1.f, p);
      fence_proxy_async();
      mbar_arrive(bars + 8 * kKmFull);
      if (it + 1 < n_tiles) load(it + 1);
      if (it > 0) mbar_wait(bars + 8 * kTEmpty, (it - 1) & 1);
      store_transposed<HD, BN>(hk, lk, at(sKTh), at(sKTl), p);
      fence_proxy_async();
      mbar_arrive(bars + 8 * kTFull);
    }
    return;
  }

  // the consumer warpgroup: the products and dS
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int w0 = q0 + warp * 16;  // this warp's rows
  float lr[2];
  float dr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = w0 + g + 8 * r;
    lr[r] = qi < Sq ? lse[row + qi] : 0.f;
    dr[r] = qi < Sq ? delta[row + qi] : 0.f;
  }
  float gq[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) gq[i] = 0.f;
  // this warpgroup's 64 rows of the Q and dO tiles: its A descriptors
  const uint64_t dQh = sw128_desc(sQh), dQl = sw128_desc(sQl);
  const uint64_t dOh = sw128_desc(sOh), dOl = sw128_desc(sOl);
  const uint64_t dKh = sw128_desc(sKh), dKl = sw128_desc(sKl);
  const uint64_t dVh = sw128_desc(sVh), dVl = sw128_desc(sVl);
  const uint64_t dKTh = sw128_desc(sKTh), dKTl = sw128_desc(sKTl);

  float s[BN / 2] = {};
  float dp[BN / 2] = {};
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * BN;
    mbar_wait(bars + 8 * kKmFull, it & 1);
    // S = (Q scale) K^T and dP = dO V^T: 3 products a k8 step
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 8; ++kk) {
      const uint64_t a = (kk >> 2) * (kBwdRows * 128 >> 4) + 2 * (kk & 3);
      const uint64_t bk = (kk >> 2) * (BN * 128 >> 4) + 2 * (kk & 3);
      wgmma_tf32_ss(s, dQh + a, dKh + bk, kk > 0);
      wgmma_tf32_ss(dp, dOh + a, dVh + bk, kk > 0);
      wgmma_tf32_ss(s, dQh + a, dKl + bk, 1);
      wgmma_tf32_ss(dp, dOh + a, dVl + bk, 1);
      wgmma_tf32_ss(s, dQl + a, dKh + bk, 1);
      wgmma_tf32_ss(dp, dOl + a, dVh + bk, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      asm volatile("" : "+f"(s[i])::"memory");
      asm volatile("" : "+f"(dp[i])::"memory");
    }
    if (it + 1 < n_tiles) mbar_arrive(bars + 8 * kKmEmpty);

    const bool masked =
        k0 + BN > Sk || (causal && k0 + BN - 1 > q0 + offset);
    uint32_t gh[BN / 8][4], gl[BN / 8][4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[4 * j + e];
        bool key = true;
        if (masked) {
          const int qi = w0 + g + ((e >> 1) << 3);
          const int kj = k0 + 8 * j + 2 * t + (e & 1);
          if (causal && kj > qi + offset) x = kNegInf;
          key = kj < Sk;
        }
        const float p = key ? expf(x - lr[e >> 1]) : 0.f;
        dp[4 * j + e] = p * (dp[4 * j + e] - dr[e >> 1]);
      }
      acc_split(dp, j, gh[j], gl[j]);
    }
    // dQ += dS K, K^T from the transposed tile; scale at the end
    mbar_wait(bars + 8 * kTFull, it & 1);
    acc_products<BN / 8, HD, HD>(gq, gh, gl, dKTh, dKTl);
    if (it + 1 < n_tiles) mbar_arrive(bars + 8 * kTEmpty);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = w0 + g + 8 * r;
    if (qi < Sq) {
      float* orow = dq + ((static_cast<long long>(b) * Sq + qi) * nH + h) * HD;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<float2*>(orow + 8 * j + 2 * t) =
            make_float2(__fmul_rn(gq[4 * j + 2 * r], scale),
                        __fmul_rn(gq[4 * j + 2 * r + 1], scale));
    }
  }
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* delta;
  void* o0;      // out / dk / dq
  void* o1;      // lse / dv
  int B, Sq, Sk, nH;
  Strides qs, ks, vs, ds;
  float scale;
  int causal;
  int offset;
  cudaStream_t stream;
};

enum Pass { kFwd = 0, kDkv = 1, kDq = 2 };

// float32: the three kernels of three TF32 products a product
template <int HD>
cudaError_t launch_f32(Pass pass, const Args& a) {
  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  const float* d = static_cast<const float*>(a.dout);
  cudaError_t err = cudaSuccess;
  if (pass == kFwd) {
    constexpr int bytes = fwd_tf32x3_smem_bytes<HD>();
    err = cudaFuncSetAttribute(flash_attention_fwd_tf32x3_kernel<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return err;
    const dim3 grid((a.Sq + kF32BM - 1) / kF32BM, a.nH, a.B);
    flash_attention_fwd_tf32x3_kernel<HD>
        <<<grid, 32 * kF32Warps, bytes, a.stream>>>(
            q, k, v, static_cast<float*>(a.o0), static_cast<float*>(a.o1),
            a.Sq, a.Sk, a.nH, a.qs, a.ks, a.vs, a.scale, a.causal, a.offset);
  } else if (pass == kDkv) {
    constexpr int bytes = dkv_tf32x3_smem_bytes<HD>();
    err = cudaFuncSetAttribute(flash_attention_bwd_dkv_tf32x3_kernel<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return err;
    const dim3 grid((a.Sk + kBwdRows - 1) / kBwdRows, a.nH, a.B);
    flash_attention_bwd_dkv_tf32x3_kernel<HD>
        <<<grid, kBwdThreads, bytes, a.stream>>>(
            q, k, v, d, a.lse, a.delta, static_cast<float*>(a.o0),
            static_cast<float*>(a.o1), a.Sq, a.Sk, a.nH, a.qs, a.ks, a.vs,
            a.ds, a.scale, a.causal, a.offset);
  } else {
    constexpr int bytes = dq_tf32x3_smem_bytes<HD>();
    err = cudaFuncSetAttribute(flash_attention_bwd_dq_tf32x3_kernel<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return err;
    const dim3 grid((a.Sq + kBwdRows - 1) / kBwdRows, a.nH, a.B);
    flash_attention_bwd_dq_tf32x3_kernel<HD>
        <<<grid, kBwdThreads, bytes, a.stream>>>(
            q, k, v, d, a.lse, a.delta, static_cast<float*>(a.o0), a.Sq,
            a.Sk, a.nH, a.qs, a.ks, a.vs, a.ds, a.scale, a.causal, a.offset);
  }
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_tc(Pass pass, const Args& a) {
  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* k = static_cast<const bf16*>(a.k);
  const bf16* v = static_cast<const bf16*>(a.v);
  const bf16* d = static_cast<const bf16*>(a.dout);
  cudaError_t err = cudaSuccess;
  if (pass == kFwd) {
    constexpr int W = kFwdWarps;
    constexpr int bytes = fwd_tc_smem_bytes<HD, W>();
    err = cudaFuncSetAttribute(flash_attention_fwd_tc_kernel<HD, W>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return err;
    const dim3 grid((a.Sq + 16 * W - 1) / (16 * W), a.nH, a.B);
    flash_attention_fwd_tc_kernel<HD, W><<<grid, 32 * W, bytes, a.stream>>>(
        q, k, v, static_cast<bf16*>(a.o0), static_cast<float*>(a.o1), a.Sq,
        a.Sk, a.nH, a.qs, a.ks, a.vs, a.scale, a.causal, a.offset);
  } else if (pass == kDkv) {
    constexpr int W = kDkvWarps;
    constexpr int bytes = dkv_tc_smem_bytes<HD, W>();
    err = cudaFuncSetAttribute(flash_attention_bwd_dkv_tc_kernel<HD, W>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return err;
    const dim3 grid((a.Sk + 16 * W - 1) / (16 * W), a.nH, a.B);
    flash_attention_bwd_dkv_tc_kernel<HD, W>
        <<<grid, 32 * W, bytes, a.stream>>>(
            q, k, v, d, a.lse, a.delta, static_cast<bf16*>(a.o0),
            static_cast<bf16*>(a.o1), a.Sq, a.Sk, a.nH, a.qs, a.ks, a.vs,
            a.ds, a.scale, a.causal, a.offset);
  } else {
    constexpr int W = kDqWarps;
    constexpr int bytes = dq_tc_smem_bytes<HD, W>();
    err = cudaFuncSetAttribute(flash_attention_bwd_dq_tc_kernel<HD, W>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return err;
    const dim3 grid((a.Sq + 16 * W - 1) / (16 * W), a.nH, a.B);
    flash_attention_bwd_dq_tc_kernel<HD, W>
        <<<grid, 32 * W, bytes, a.stream>>>(
            q, k, v, d, a.lse, a.delta, static_cast<bf16*>(a.o0), a.Sq, a.Sk,
            a.nH, a.qs, a.ks, a.vs, a.ds, a.scale, a.causal, a.offset);
  }
  return cudaGetLastError();
}

// float32 as three TF32 products, bfloat16 on mma.sync
template <int HD>
cudaError_t launch_dtype(int dtype, Pass pass, const Args& a) {
  if (dtype == 0) return launch_f32<HD>(pass, a);
  if (dtype == 1) return launch_tc<HD>(pass, a);
  return cudaErrorInvalidValue;
}

template <int HD>
int smem_bytes_hd(int dtype, Pass pass) {
  if (dtype == 0)
    return pass == kFwd   ? fwd_tf32x3_smem_bytes<HD>()
           : pass == kDkv ? dkv_tf32x3_smem_bytes<HD>()
                          : dq_tf32x3_smem_bytes<HD>();
  if (dtype == 1)
    return pass == kFwd   ? fwd_tc_smem_bytes<HD, kFwdWarps>()
           : pass == kDkv ? dkv_tc_smem_bytes<HD, kDkvWarps>()
                          : dq_tc_smem_bytes<HD, kDqWarps>();
  return -1;
}

int run(int dtype, int hD, Pass pass, const Args& a) {
  if (a.B == 0 || a.Sq == 0 || a.Sk == 0 || a.nH == 0) return 0;
  cudaError_t err = cudaErrorInvalidValue;
  switch (hD) {
    case 32:
      err = launch_dtype<32>(dtype, pass, a);
      break;
    case 64:
      err = launch_dtype<64>(dtype, pass, a);
      break;
    case 128:
      err = launch_dtype<128>(dtype, pass, a);
      break;
    default:
      break;
  }
  return static_cast<int>(err);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; hD in {32, 64, 128}.  Strides are in
// elements for the batch, token and head axes (the last axis is
// contiguous).  offset: key j is visible to query i iff j <= i + offset
// (causal only; 0 for plain flash attention).  Each entry launches on
// `stream`, does not synchronise, allocates nothing and returns the
// launch's cudaError_t
// (cudaErrorInvalidValue for a dtype/head-dim pair with no instance).

extern "C" int pt_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* out, void* lse,
    int dtype, int B, int Sq, int Sk, int nH, int hD,
    long long qs_b, long long qs_t, long long qs_h,
    long long ks_b, long long ks_t, long long ks_h,
    long long vs_b, long long vs_t, long long vs_h,
    float scale, int causal, int offset, void* stream) {
  const Args a{q, k, v, nullptr, nullptr, nullptr, out, lse, B, Sq, Sk, nH,
               {qs_b, qs_t, qs_h}, {ks_b, ks_t, ks_h}, {vs_b, vs_t, vs_h},
               {0, 0, 0}, scale, causal, offset,
               static_cast<cudaStream_t>(stream)};
  return run(dtype, hD, kFwd, a);
}

extern "C" int pt_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv,
    int dtype, int B, int Sq, int Sk, int nH, int hD,
    long long qs_b, long long qs_t, long long qs_h,
    long long ks_b, long long ks_t, long long ks_h,
    long long vs_b, long long vs_t, long long vs_h,
    long long ds_b, long long ds_t, long long ds_h,
    float scale, int causal, int offset, void* stream) {
  const Args a{q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(delta), dk, dv, B, Sq, Sk, nH,
               {qs_b, qs_t, qs_h}, {ks_b, ks_t, ks_h}, {vs_b, vs_t, vs_h},
               {ds_b, ds_t, ds_h}, scale, causal, offset,
               static_cast<cudaStream_t>(stream)};
  return run(dtype, hD, kDkv, a);
}

extern "C" int pt_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq,
    int dtype, int B, int Sq, int Sk, int nH, int hD,
    long long qs_b, long long qs_t, long long qs_h,
    long long ks_b, long long ks_t, long long ks_h,
    long long vs_b, long long vs_t, long long vs_h,
    long long ds_b, long long ds_t, long long ds_h,
    float scale, int causal, int offset, void* stream) {
  const Args a{q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(delta), dq, nullptr, B, Sq, Sk, nH,
               {qs_b, qs_t, qs_h}, {ks_b, ks_t, ks_h}, {vs_b, vs_t, vs_h},
               {ds_b, ds_t, ds_h}, scale, causal, offset,
               static_cast<cudaStream_t>(stream)};
  return run(dtype, hD, kDq, a);
}

// The dynamic shared memory (bytes) one block of `pass` (0 forward, 1
// dK/dV, 2 dQ) takes at this dtype and head dim; -1 for a pair with no
// instance.
extern "C" int pt_flash_attention_smem_bytes(int dtype, int hD, int pass) {
  const Pass p = static_cast<Pass>(pass);
  switch (hD) {
    case 32:
      return smem_bytes_hd<32>(dtype, p);
    case 64:
      return smem_bytes_hd<64>(dtype, p);
    case 128:
      return smem_bytes_hd<128>(dtype, p);
    default:
      return -1;
  }
}

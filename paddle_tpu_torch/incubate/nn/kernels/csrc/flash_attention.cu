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
// Float32 runs as three TF32 products a product on the tensor cores in
// the forward; at [2, 1024, 16x128] causal its bound is 0.1283 ms at the
// CUDA cores' 67 TFLOP/s and 0.052 ms as three TF32 products at 495.
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
// kernels, 24 launches of each a step at [2, 1024, 16x128].
// * Forward (flash_attention_fwd_tf32x3_kernel): three TF32 products a
//   product on wgmma.  The tensor cores take no float32 operand and the
//   CUDA cores' float32 rate is a seventh of the TF32 rate, so each
//   operand splits into hi = tf32(x) and lo = tf32(x - hi)
//   (tc_common.cuh tf32_split, tf32x3.py's rule) and each product runs
//   as hi.hi + hi.lo + lo.hi into one float32 accumulator chain (lo.lo,
//   <= 2^-22 of it, dropped): ~22 bits an operand, where one TF32 pass
//   keeps 11 and misses the float32 limits.  wgmma, not mma.sync: with
//   the three products, the bf16 kernel's warp layout on
//   mma.sync.m16n8k8 ran slower than SDPA on the card (PERF.md §6).
// * A block is two warpgroups of 64 query rows; K/V tiles of 32 keys.
//   S = (Q scale) K^T is wgmma m64n32k8 with both operands in shared
//   memory, K-major as Q and K lie in memory (tf32 wgmma takes no
//   transpose): sub-tiles of 32 floats, one 128-byte swizzled row a tile
//   row.  O += P V is m64n(hD)k8 with P from registers and V^T in shared
//   memory, so V is transposed on its way in.
// * The split is done once where the operand is staged: Q (q * scale in
//   float32, as before) once a block and K once a tile, in place (hi)
//   and beside (lo) by the threads whose cp.async copies they are; V is
//   loaded into registers a tile ahead, split and stored transposed (a
//   warp writes one 128-byte row of V^T at a time); P, which each thread
//   owns, in registers.  Q and K hi and lo and two slots of V^T hi and lo
//   take 225 KB at hD 128: one block an SM.  K is single-buffered (its
//   copies fly during the softmax and P V); tile it + 1's V^T is stored
//   into the other slot while tile it's S runs, from registers loaded a
//   tile before.  Blocks run the longest query tiles of every head
//   first: under the causal mask a tile's work grows with its position,
//   and the grid runs in waves.
// * P stays in registers as the A fragment, with no trip through shared
//   memory: step j's A column t is key 8j + 2t and column t + 4 key
//   8j + 2t + 1, which is where the score accumulators hold them, and
//   V^T stores each 8 keys in that order (vt_off).
// * The contract above holds as before: scale folded into Q, masked
//   scores -1e30 and exponentiated, keys past Sk counting nothing,
//   key_end skipping (and a warpgroup whose rows see none of a tile
//   skips it), the run-time offset (offset 0: the same launch as the
//   zero-offset call), lse float32.  expf and IEEE division keep the
//   rest float32.
// * dK/dV and dQ: the CUDA-core kernels of the first port, unchanged;
//   they recompute P from the forward's lse.  One block of 256 threads
//   per (64-row tile, head, batch); tiles of the other operand stream
//   through shared memory as float32 rows of stride hD+1 (odd, so
//   row-strided reads hit distinct banks), loaded with 16-byte vectors
//   from strided [B, S, nH, hD] operands.  Each thread owns a 4x4 score
//   micro-tile (rows ty*4+i, columns tx+16*j) and the same 4 rows of
//   the output; the 16 threads sharing a row are one half-warp.  The
//   scale is folded into a float32 copy of Q, and P and dS stay
//   float32.  The causal mask skips every tile past the diagonal.
//
// Left for later work: wgmma with TMA and warp specialisation (a producer
// warp feeding consumer warpgroups), the fused backward (see above), and
// skipping the ring's fully masked blocks (every row of the block with no
// visible key) outside the kernels.

#include <cstdint>

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "tc_common.cuh"

namespace {

constexpr int kThreads = 256;          // 8 warps
constexpr int kTile = 64;              // rows of a query or key tile
constexpr int kRows = 4;               // tile rows per thread
constexpr int kCols = kTile / 16;      // tile columns per thread
constexpr int kPS = kTile + 1;         // row stride of the P / dS tiles
constexpr float kNegInf = -1e30f;

template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
  __device__ static void store(float* p, float v) { *p = v; }
};

struct Strides {
  long long b, t, h;
};

// Stage rows row0 .. row0+kTile-1 of one (batch, head) slice into
// shared memory as float32 rows of stride HD+1, times `mul`; rows at or
// past n_rows read as zero.
template <typename T, int HD>
__device__ void load_tile(float* dst, const T* base, long long s_tok,
                          int row0, int n_rows, float mul) {
  constexpr int VN = Vec<T>::N;
  constexpr int kS = HD + 1;
  for (int idx = threadIdx.x; idx < kTile * HD / VN; idx += kThreads) {
    const int r = idx / (HD / VN);
    const int d = (idx % (HD / VN)) * VN;
    float t[VN];
    if (row0 + r < n_rows) {
      Vec<T>::load(base + static_cast<long long>(row0 + r) * s_tok + d, t);
    } else {
#pragma unroll
      for (int i = 0; i < VN; ++i) t[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < VN; ++i) dst[r * kS + d + i] = t[i] * mul;
  }
}

// acc[i][j] = sum_d A[ty*4+i][d] * B[tx+16*j][d] over two staged tiles.
template <int HD>
__device__ __forceinline__ void tile_dot(const float* A, const float* B,
                                         float (&acc)[kRows][kCols],
                                         int ty, int tx) {
  constexpr int kS = HD + 1;
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;
  const float* a = A + ty * kRows * kS;
  const float* b = B + tx * kS;
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    float av[kRows];
    float bv[kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i) av[i] = a[i * kS + d];
#pragma unroll
    for (int j = 0; j < kCols; ++j) bv[j] = b[j * 16 * kS + d];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// One past the last key a query tile at q0 must visit: under the causal
// mask, when every row of the tile has a visible key, the last key its
// last row sees; otherwise (or not causal) every key.
__device__ __forceinline__ int key_end(int q0, int Sk, int causal,
                                       int offset) {
  return causal && q0 + offset >= 0 ? min(Sk, q0 + kTile + offset) : Sk;
}

template <int HD>
constexpr int dkv_smem_bytes() {
  return (4 * kTile * (HD + 1) + 2 * kTile * kPS + 2 * kTile) * 4;
}

template <int HD>
constexpr int dq_smem_bytes() {
  return (4 * kTile * (HD + 1) + kTile * kPS) * 4;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
    int Sq, int Sk, int nH, Strides qs, Strides ks, Strides vs, Strides ds,
    float scale, int causal, int offset) {
  constexpr int kS = HD + 1;
  constexpr int kD = HD / 16;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + kTile * kS;
  float* sQ = sV + kTile * kS;
  float* sO = sQ + kTile * kS;   // dO
  float* sP = sO + kTile * kS;   // P^T   [key][query]
  float* sG = sP + kTile * kPS;  // dS^T  [key][query]
  float* sL = sG + kTile * kPS;  // lse of the query tile
  float* sDl = sL + kTile;       // delta of the query tile

  const int k0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int tx = lane & 15;
  const int ty = (threadIdx.x >> 5) * 2 + (lane >> 4);
  const long long row = (static_cast<long long>(b) * nH + h) * Sq;

  load_tile<T, HD>(sK, k + b * ks.b + h * ks.h, ks.t, k0, Sk, 1.f);
  load_tile<T, HD>(sV, v + b * vs.b + h * vs.h, vs.t, k0, Sk, 1.f);
  const T* qb = q + b * qs.b + h * qs.h;
  const T* ob = dout + b * ds.b + h * ds.h;

  float gk[kRows][kD];
  float gv[kRows][kD];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int c = 0; c < kD; ++c) {
      gk[i][c] = 0.f;
      gv[i][c] = 0.f;
    }

  // under the causal mask a query tile whose rows all have a visible key
  // gives this key tile p = 0 unless its last row sees key k0
  for (int q0 = 0; q0 < Sq; q0 += kTile) {
    if (causal && q0 + offset >= 0 && q0 + kTile - 1 + offset < k0) continue;
    __syncthreads();
    load_tile<T, HD>(sQ, qb, qs.t, q0, Sq, scale);
    load_tile<T, HD>(sO, ob, ds.t, q0, Sq, 1.f);
    for (int r = threadIdx.x; r < kTile; r += kThreads) {
      const bool in = q0 + r < Sq;
      sL[r] = in ? lse[row + q0 + r] : 0.f;
      sDl[r] = in ? delta[row + q0 + r] : 0.f;
    }
    __syncthreads();
    float s[kRows][kCols];
    float dp[kRows][kCols];
    tile_dot<HD>(sK, sQ, s, ty, tx);   // S^T[key][query]
    tile_dot<HD>(sV, sO, dp, ty, tx);  // dP^T[key][query]
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int kj = k0 + ty * kRows + i;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = tx + 16 * j;
        const int qi = q0 + c;
        const float sv = !causal || kj <= qi + offset ? s[i][j] : kNegInf;
        const float p = qi < Sq && kj < Sk ? expf(sv - sL[c]) : 0.f;
        sP[(ty * kRows + i) * kPS + c] = p;
        sG[(ty * kRows + i) * kPS + c] = p * (dp[i][j] - sDl[c]);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int qq = 0; qq < kTile; ++qq) {
      float p[kRows];
      float g[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        p[i] = sP[(ty * kRows + i) * kPS + qq];
        g[i] = sG[(ty * kRows + i) * kPS + qq];
      }
#pragma unroll
      for (int c = 0; c < kD; ++c) {
        const float o = sO[qq * kS + tx + 16 * c];
        const float qv = sQ[qq * kS + tx + 16 * c];  // already times scale
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          gv[i][c] = fmaf(p[i], o, gv[i][c]);
          gk[i][c] = fmaf(g[i], qv, gk[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int kj = k0 + ty * kRows + i;
    if (kj < Sk) {
      const long long o = ((static_cast<long long>(b) * Sk + kj) * nH + h) * HD;
#pragma unroll
      for (int c = 0; c < kD; ++c) {
        Vec<T>::store(dk + o + tx + 16 * c, gk[i][c]);
        Vec<T>::store(dv + o + tx + 16 * c, gv[i][c]);
      }
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dq, int Sq, int Sk,
    int nH, Strides qs, Strides ks, Strides vs, Strides ds, float scale,
    int causal, int offset) {
  constexpr int kS = HD + 1;
  constexpr int kD = HD / 16;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sO = sQ + kTile * kS;  // dO
  float* sK = sO + kTile * kS;
  float* sV = sK + kTile * kS;
  float* sG = sV + kTile * kS;  // dS [query][key]

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;  // long tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int tx = lane & 15;
  const int ty = (threadIdx.x >> 5) * 2 + (lane >> 4);
  const long long row = (static_cast<long long>(b) * nH + h) * Sq;

  load_tile<T, HD>(sQ, q + b * qs.b + h * qs.h, qs.t, q0, Sq, scale);
  load_tile<T, HD>(sO, dout + b * ds.b + h * ds.h, ds.t, q0, Sq, 1.f);
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;

  float lr[kRows];
  float dr[kRows];
  float gq[kRows][kD];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qi = q0 + ty * kRows + i;
    lr[i] = qi < Sq ? lse[row + qi] : 0.f;
    dr[i] = qi < Sq ? delta[row + qi] : 0.f;
#pragma unroll
    for (int c = 0; c < kD; ++c) gq[i][c] = 0.f;
  }

  const int k_end = key_end(q0, Sk, causal, offset);
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();
    load_tile<T, HD>(sK, kb, ks.t, k0, Sk, 1.f);
    load_tile<T, HD>(sV, vb, vs.t, k0, Sk, 1.f);
    __syncthreads();
    float s[kRows][kCols];
    float dp[kRows][kCols];
    tile_dot<HD>(sQ, sK, s, ty, tx);
    tile_dot<HD>(sO, sV, dp, ty, tx);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qi = q0 + ty * kRows + i;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kj = k0 + tx + 16 * j;
        const float sv = !causal || kj <= qi + offset ? s[i][j] : kNegInf;
        const float p = qi < Sq && kj < Sk ? expf(sv - lr[i]) : 0.f;
        sG[(ty * kRows + i) * kPS + tx + 16 * j] = p * (dp[i][j] - dr[i]);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kTile; ++kk) {
      float g[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) g[i] = sG[(ty * kRows + i) * kPS + kk];
#pragma unroll
      for (int c = 0; c < kD; ++c) {
        const float kv = sK[kk * kS + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < kRows; ++i) gq[i][c] = fmaf(g[i], kv, gq[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qi = q0 + ty * kRows + i;
    if (qi < Sq) {
      T* o = dq + ((static_cast<long long>(b) * Sq + qi) * nH + h) * HD;
#pragma unroll
      for (int c = 0; c < kD; ++c) Vec<T>::store(o + tx + 16 * c, gq[i][c] * scale);
    }
  }
}

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

// d (64 x 32 float32, one warpgroup) = (scale_d ? d : 0) + A * B^T: A
// 64 x 8 and B 32 x 8 TF32, both K-major in 128-byte-swizzled shared
// memory, named by descriptors
__device__ __forceinline__ void wgmma_tf32_ss_n32(float (&d)[16], uint64_t da,
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

// d (64 x 32 float32, one warpgroup) += A * B^T: A 64 x 8 TF32 in
// registers (a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
// of each warp's 16 rows), B 32 x 8 TF32, K-major in shared memory
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[16],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 64 float32, one warpgroup) += A * B^T: A 64 x 8 TF32 in
// registers (a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
// of each warp's 16 rows), B 64 x 8 TF32, K-major in shared memory
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128 float32, one warpgroup) += A * B^T: A 64 x 8 TF32 in
// registers (a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
// of each warp's 16 rows), B 128 x 8 TF32, K-major in shared memory
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
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
        wgmma_tf32_ss_n32(s, dQh + step, dKh + kstep, kk > 0);
        wgmma_tf32_ss_n32(s, dQh + step, dKl + kstep, 1);
        wgmma_tf32_ss_n32(s, dQl + step, dKh + kstep, 1);
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

template <typename T, int HD>
cudaError_t launch(Pass pass, const Args& a) {
  const dim3 grid_q((a.Sq + kTile - 1) / kTile, a.nH, a.B);
  const dim3 grid_k((a.Sk + kTile - 1) / kTile, a.nH, a.B);
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* d = static_cast<const T*>(a.dout);
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
    constexpr int bytes = dkv_smem_bytes<HD>();
    err = cudaFuncSetAttribute(flash_attention_bwd_dkv_kernel<T, HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return err;
    flash_attention_bwd_dkv_kernel<T, HD>
        <<<grid_k, kThreads, bytes, a.stream>>>(
            q, k, v, d, a.lse, a.delta, static_cast<T*>(a.o0),
            static_cast<T*>(a.o1), a.Sq, a.Sk, a.nH, a.qs, a.ks, a.vs, a.ds,
            a.scale, a.causal, a.offset);
  } else {
    constexpr int bytes = dq_smem_bytes<HD>();
    err = cudaFuncSetAttribute(flash_attention_bwd_dq_kernel<T, HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return err;
    flash_attention_bwd_dq_kernel<T, HD><<<grid_q, kThreads, bytes, a.stream>>>(
        q, k, v, d, a.lse, a.delta, static_cast<T*>(a.o0), a.Sq, a.Sk, a.nH,
        a.qs, a.ks, a.vs, a.ds, a.scale, a.causal, a.offset);
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

// float32 on the CUDA cores, bfloat16 on the tensor cores
template <int HD>
cudaError_t launch_dtype(int dtype, Pass pass, const Args& a) {
  if (dtype == 0) return launch<float, HD>(pass, a);
  if (dtype == 1) return launch_tc<HD>(pass, a);
  return cudaErrorInvalidValue;
}

template <int HD>
int smem_bytes_hd(int dtype, Pass pass) {
  if (dtype == 0)
    return pass == kFwd   ? fwd_tf32x3_smem_bytes<HD>()
           : pass == kDkv ? dkv_smem_bytes<HD>()
                          : dq_smem_bytes<HD>();
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

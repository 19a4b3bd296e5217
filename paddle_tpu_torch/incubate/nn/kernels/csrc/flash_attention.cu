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
// float32: the CUDA-core kernels of the first port, unchanged (the tiny
// reference runs and the float32 checks use them):
// * One block of 256 threads per (64-row tile, head, batch).  Tiles of
//   the other operand stream through shared memory as float32 rows of
//   stride hD+1 (odd, so row-strided reads hit distinct banks), loaded
//   with 16-byte vectors from strided [B, S, nH, hD] operands.
// * Each thread owns a 4x4 score micro-tile (rows ty*4+i, columns
//   tx+16*j) and the same 4 rows of the output; the 16 threads sharing
//   a row are one half-warp, so row max/sum reduce with shuffles and the
//   online-softmax state m, l stays in registers.  The scale is folded
//   into a float32 copy of Q, and P and dS stay float32.
// * The causal mask skips every tile past the diagonal, as above.
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

// reductions over the 16 threads (one half-warp) that share a row
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// One past the last key a query tile at q0 must visit: under the causal
// mask, when every row of the tile has a visible key, the last key its
// last row sees; otherwise (or not causal) every key.
__device__ __forceinline__ int key_end(int q0, int Sk, int causal,
                                       int offset) {
  return causal && q0 + offset >= 0 ? min(Sk, q0 + kTile + offset) : Sk;
}

template <int HD>
constexpr int fwd_smem_bytes() {
  return (3 * kTile * (HD + 1) + kTile * kPS) * 4;
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
flash_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out,
                           float* __restrict__ lse, int Sq, int Sk, int nH,
                           Strides qs, Strides ks, Strides vs, float scale,
                           int causal, int offset) {
  constexpr int kS = HD + 1;
  constexpr int kD = HD / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kTile * kS;
  float* sV = sK + kTile * kS;
  float* sP = sV + kTile * kS;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;  // long tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int tx = lane & 15;
  const int ty = (threadIdx.x >> 5) * 2 + (lane >> 4);

  load_tile<T, HD>(sQ, q + b * qs.b + h * qs.h, qs.t, q0, Sq, scale);
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;

  float m[kRows];
  float l[kRows];
  float acc[kRows][kD];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kD; ++c) acc[i][c] = 0.f;
  }

  const int k_end = key_end(q0, Sk, causal, offset);
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, HD>(sK, kb, ks.t, k0, Sk, 1.f);
    load_tile<T, HD>(sV, vb, vs.t, k0, Sk, 1.f);
    __syncthreads();
    float s[kRows][kCols];
    tile_dot<HD>(sQ, sK, s, ty, tx);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qi = q0 + ty * kRows + i;
      bool in[kCols];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kj = k0 + tx + 16 * j;
        in[j] = kj < Sk;
        s[i][j] = in[j] && (!causal || kj <= qi + offset) ? s[i][j] : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        // masked keys count (p = 1 in a row with no visible key, else 0)
        const float p = in[j] ? expf(s[i][j] - m_new) : 0.f;
        sP[(ty * kRows + i) * kPS + tx + 16 * j] = p;
        sum += p;
      }
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kD; ++c) acc[i][c] *= corr;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kTile; ++kk) {
      float p[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) p[i] = sP[(ty * kRows + i) * kPS + kk];
#pragma unroll
      for (int c = 0; c < kD; ++c) {
        const float vv = sV[kk * kS + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i][c] = fmaf(p[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qi = q0 + ty * kRows + i;
    if (qi < Sq) {
      const float l_safe = l[i] == 0.f ? 1.f : l[i];
      const float inv = 1.f / l_safe;
      T* o = out + ((static_cast<long long>(b) * Sq + qi) * nH + h) * HD;
#pragma unroll
      for (int c = 0; c < kD; ++c) Vec<T>::store(o + tx + 16 * c, acc[i][c] * inv);
      if (tx == 0)
        lse[(static_cast<long long>(b) * nH + h) * Sq + qi] = m[i] + logf(l_safe);
    }
  }
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
    constexpr int bytes = fwd_smem_bytes<HD>();
    err = cudaFuncSetAttribute(flash_attention_fwd_kernel<T, HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return err;
    flash_attention_fwd_kernel<T, HD><<<grid_q, kThreads, bytes, a.stream>>>(
        q, k, v, static_cast<T*>(a.o0), static_cast<float*>(a.o1), a.Sq, a.Sk,
        a.nH, a.qs, a.ks, a.vs, a.scale, a.causal, a.offset);
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
    return pass == kFwd   ? fwd_smem_bytes<HD>()
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

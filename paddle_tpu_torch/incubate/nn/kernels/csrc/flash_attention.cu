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
// operand once.  At training lengths (S = 1024, hD = 128) that is
// hundreds of operations per byte, so the operations bound it: at the
// bf16 tensor-core rate the bound is a few hundredths of a millisecond
// per layer.
//
// The simple design, and what it does about that:
// * One block of 256 threads per (64-row tile, head, batch).  Tiles of
//   the other operand stream through shared memory as float32 rows of
//   stride hD+1 (odd, so row-strided reads hit distinct banks), loaded
//   with 16-byte vectors from strided [B, S, nH, hD] operands: q, k and
//   v arrive as slices of the packed qkv activation without a copy.
// * Each thread owns a 4x4 score micro-tile (rows ty*4+i, columns
//   tx+16*j) and the same 4 rows of the output; the 16 threads sharing
//   a row are one half-warp, so row max/sum reduce with shuffles and the
//   online-softmax state m, l stays in registers.
// * The causal mask skips every tile past the diagonal: the forward and
//   dQ loop over key tiles up to the last one their tile's rows can see,
//   dK/dV over the query tiles that can see their key tile (and the
//   tiles that hold a row with no visible key at all).
// * No atomics: dK/dV blocks own key tiles and dQ blocks own query
//   tiles, so every result is written once and runs are deterministic.
// * Scores and products run on the CUDA cores in float32.
// Left for later work: tensor cores (mma.sync / wgmma), cp.async or TMA
// double buffering, and a fused single-pass backward.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

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

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const __nv_bfloat16* p, float* out) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
  __device__ static void store(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16(v);
  }
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

template <typename T>
cudaError_t launch_hd(int hD, Pass pass, const Args& a) {
  switch (hD) {
    case 32:
      return launch<T, 32>(pass, a);
    case 64:
      return launch<T, 64>(pass, a);
    case 128:
      return launch<T, 128>(pass, a);
    default:
      return cudaErrorInvalidValue;
  }
}

int run(int dtype, int hD, Pass pass, const Args& a) {
  if (a.B == 0 || a.Sq == 0 || a.Sk == 0 || a.nH == 0) return 0;
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) {
    err = launch_hd<float>(hD, pass, a);
  } else if (dtype == 1) {
    err = launch_hd<__nv_bfloat16>(hD, pass, a);
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

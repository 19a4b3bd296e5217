// Fused single-launch b1 decode step for Hopper (sm_90a).
//
// Replaces the TPU kernel paddle_tpu/incubate/nn/kernels/fused_decode.py
// ::_decode_kernel, reached through fused_decode_layers: the whole
// weight-only int8 GPT layer stack for ONE token.  Per layer: LN1 ->
// int8 qkv GEMV -> the new K/V row written at row `pos` of the flat
// [L, T, H] cache (quantized for int8 / fp8 storage) -> attention over
// the history rows < pos plus the new token -> proj GEMV + residual ->
// LN2 -> fc1 GEMV + tanh-GELU -> fc2 GEMV + residual.  Only row 0 of
// the TPU layout's [8, H] hidden state is real; this kernel computes
// row 0 and writes rows 1-7 of h_out as zeros.
//
// What bounds it on the H100: at batch 1 every int8 weight byte is read
// once per token and used for 2 operations, so the weight bytes over
// the HBM rate bound it (gpt3_1p3b: 1.208 GB of int8 layer weights a
// token, ~0.36 ms at 3.35 TB/s), plus the K/V history (196,608 bytes a
// row of position at bf16, about half that plus scales at int8).
//
// Design.  The TPU kernel walks the L layers as a sequential grid and
// carries h in VMEM scratch.  CUDA blocks run in parallel and carry
// nothing, so the layer loop moves INSIDE one cooperative launch (grid
// = the blocks that can be resident at once, at most 2 an SM), and its
// phases are separated by grid-wide barriers (cooperative_groups grid
// sync).  Per layer, 8 phases:
//   P1 every block: LN1 of h into shared memory (rounded to bf16);
//      the warps of the grid split the qkv GEMV into items of 64
//      columns x a slice of K rows and write float32 partial sums.
//   P2 one block per head: the head's q/k/v from the partials
//      (sum * scale + bias), the new K/V row stored, then the history
//      walked in 256-row chunks of online softmax (the TPU kernel's
//      KV_CHUNK: p is rounded to bf16 against each chunk's running max,
//      so the chunking is part of the function), then the new token.
//   P3 every block: the attention output (bf16) -> proj GEMV partials.
//   P4 column-strided: h2 = (h + proj * scale) + bias.
//   P5 every block: LN2 of h2 -> fc1 GEMV partials.
//   P6 column-strided: g = bf16(gelu(fc1 * scale + bias)).
//   P7 every block: g -> fc2 GEMV partials (K = F split over warps).
//   P8 column-strided: h = (h2 + fc2 * scale) + bias.
// Every split-K sum is reduced in a fixed order after the next barrier:
// deterministic, no atomics.  A GEMV thread reads 16 consecutive int8
// columns of one K row per 16-byte load (4 lanes cover 64 columns, 8
// rows per warp instruction), multiplies them by the bf16-rounded input
// (the products are exact in float32) and sums in float32.
//
// Rounding points, kept from _decode_kernel (the plain PyTorch version
// fused_decode_layers_plain keeps them too):
//  1. GEMV inputs rounded to bf16, exact int8 weights, float32 sums;
//     the scale after the sum, then the bias; the GELU output rounded
//     to bf16 before fc2.
//  2. History attention: q * 1/sqrt(hD) in float32, then bf16; each
//     history row dequantized in float32 (int8 data * scale) and
//     rounded to bf16 (a float32 cache too); float32 scores; p rounded
//     to bf16 before P.V against bf16 V.
//  3. The new token is attended unrounded: the float32 row in the
//     model-dtype mode (the cache stores it rounded), q * scale of the
//     stored int8 bytes, the stored fp8 value widened; its score is
//     sum(qs * k) on the unrounded qs.
//  4. int8 rows: s = max(max|x|, 1e-8) / 127 per head, q =
//     clip(rint(x / s), -127, 127) (half to even, IEEE division: no
//     fast math).
//  5. fp8 rows: |x| > 464 (and inf, NaN) is stored as NaN, as
//     kv_quant.quantize_kv does; the rest rounds to nearest even.
//  6. tanhf/expf, not the approximate intrinsics; LN is
//     ((x - mu) * (1 / sqrt(var + eps))) * g + b with the biased
//     variance; separate float32 roundings where JAX has them
//     (__fmul_rn / __fadd_rn keep nvcc from contracting them into FMAs).
//
// Left for later work: tensor-core or wider GEMVs with TMA/cp.async
// staging, split-KV attention across more than one block per head, and
// fewer barriers (192 a token at 24 layers).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 256;          // history rows per online-softmax chunk
constexpr int kTile = 64;            // GEMV columns per warp item
constexpr int kMaxWidth = 16384;     // H and F
constexpr int kMaxHD = 128;
constexpr int kMaxBlocksPerSM = 2;
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

// cache storage modes
constexpr int kF32 = 0;
constexpr int kBF16 = 1;
constexpr int kInt8 = 2;
constexpr int kFP8 = 3;

struct Params {
  const float* h0;         // [8, H], row 0 read
  const int8_t* w[4];      // qkv [L, H, 3H], proj [L, H, H], fc1 [L, H, F], fc2 [L, F, H]
  const float* s[4];       // per-out-channel scales [L, N]
  const void* small[8];    // qkv_b, proj_b, fc1_b, fc2_b, ln1_g, ln1_b, ln2_g, ln2_b
  void* ck;                // [L, T, H]
  void* cv;
  float* ks;               // int8: [L, T, nH]
  float* vs;
  const int* pos;
  float* h_out;            // [8, H]
  float* scratch;
  int L, H, F, nH, T, small_bf16;
  float eps, scale;
};

enum { kQkvB, kProjB, kFc1B, kFc2B, kLn1G, kLn1B, kLn2G, kLn2B };

struct Split {
  int rows;   // K rows per slice (a multiple of 8)
  int nks;    // slices
};

// K split of a [K, N] GEMV so that the grid's warps get about one item
// (64 columns x `rows` K rows) each.
__host__ __device__ inline Split split_k(int K, int N, int warps_total) {
  const int nct = (N + kTile - 1) / kTile;
  int want = (warps_total + nct - 1) / nct;
  const int most = (K + 7) / 8;
  want = want < 1 ? 1 : (want > most ? most : want);
  Split sp;
  sp.rows = ((K + want - 1) / want + 7) / 8 * 8;
  sp.nks = (K + sp.rows - 1) / sp.rows;
  return sp;
}

__host__ __device__ inline long long parts_floats(int H, int F,
                                                  int warps_total) {
  const int shapes[4][2] = {{H, 3 * H}, {H, H}, {H, F}, {F, H}};
  long long most = 0;
  for (int i = 0; i < 4; ++i) {
    const long long n = static_cast<long long>(
        split_k(shapes[i][0], shapes[i][1], warps_total).nks) * shapes[i][1];
    most = n > most ? n : most;
  }
  return most;
}

// scratch: hA [H] (layer carry), hB [H] (after attention), attn [H],
// g [F], then the GEMV partials
__host__ __device__ inline long long scratch_floats(int H, int F,
                                                    int warps_total) {
  return 3LL * H + F + parts_floats(H, F, warps_total);
}

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float ldp(const void* p, long long i, int bf) {
  return bf ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
            : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ float fp8_to_float(unsigned byte) {
  const __half h(__nv_cvt_fp8_to_halfraw(
      static_cast<__nv_fp8_storage_t>(byte), __NV_E4M3));
  return __half2float(h);
}

// kv_quant._to_fp8: NaN keeps its sign, |x| > 464 and infinities become
// NaN (0x7f), the rest clamps to +-448 and rounds to nearest even
__device__ __forceinline__ uint8_t float_to_fp8(float x) {
  if (isnan(x)) return signbit(x) ? 0xff : 0x7f;
  if (fabsf(x) > 464.f) return 0x7f;
  x = fminf(fmaxf(x, -448.f), 448.f);
  return static_cast<uint8_t>(__nv_cvt_float_to_fp8(x, __NV_SATFINITE,
                                                    __NV_E4M3));
}

// 8 consecutive cache values at element `off`, dequantized in float32
// (int8 times its row scale) and rounded to bf16
template <int MODE>
__device__ __forceinline__ void load8(const void* base, long long off,
                                      float sc, float* out) {
  if constexpr (MODE == kF32) {
    const float4* p = reinterpret_cast<const float4*>(
        static_cast<const float*>(base) + off);
    const float4 a = p[0];
    const float4 b = p[1];
    out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
    out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
  } else if constexpr (MODE == kBF16) {
    const uint4 raw = *reinterpret_cast<const uint4*>(
        static_cast<const __nv_bfloat16*>(base) + off);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  } else {
    const uint2 raw = *reinterpret_cast<const uint2*>(
        static_cast<const uint8_t*>(base) + off);
    const unsigned words[2] = {raw.x, raw.y};
#pragma unroll
    for (int w = 0; w < 2; ++w) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const unsigned byte = (words[w] >> (8 * j)) & 0xffu;
        out[4 * w + j] = MODE == kInt8
            ? __fmul_rn(static_cast<float>(static_cast<int8_t>(byte)), sc)
            : fp8_to_float(byte);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = bf16r(out[i]);
}

// Deterministic block reductions: every thread gets the same value.
__device__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  __syncthreads();  // red is free: the previous reduction's readers are done
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) t += red[w];
  return t;
}

__device__ float block_max(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) t = fmaxf(t, red[w]);
  return t;
}

struct AttnSmem {
  float qs[kMaxHD];        // q * scale, float32
  float qb[kMaxHD];        // the same rounded to bf16
  float kraw[kMaxHD];      // the new row as computed (float32)
  float vraw[kMaxHD];
  float kn[kMaxHD];        // the new row as attended
  float vn[kMaxHD];
  float p[kChunk];         // a chunk's scores, then its bf16 p
  float pv[kThreads * 8];  // P.V partials [row group][hD]
  float red[kWarps];
};

// LN of h [H] (float32 in global memory) into xs, rounded to bf16.
__device__ void layer_norm_bf16(const Params& p, const float* h, int gi,
                                int bi, int l, float* xs, float* red) {
  const int H = p.H;
  const long long off = static_cast<long long>(l) * H;
  float s = 0.f;
  for (int i = threadIdx.x; i < H; i += kThreads) {
    const float v = __ldcg(h + i);
    xs[i] = v;
    s += v;
  }
  const float mean = block_sum(s, red) / static_cast<float>(H);
  float q = 0.f;
  for (int i = threadIdx.x; i < H; i += kThreads) {
    const float d = __fsub_rn(xs[i], mean);
    q = __fadd_rn(q, __fmul_rn(d, d));
  }
  const float var = block_sum(q, red) / static_cast<float>(H);
  const float r = 1.0f / sqrtf(__fadd_rn(var, p.eps));
  for (int i = threadIdx.x; i < H; i += kThreads) {
    const float y = __fmul_rn(__fmul_rn(__fsub_rn(xs[i], mean), r),
                              ldp(p.small[gi], off + i, p.small_bf16));
    xs[i] = bf16r(__fadd_rn(y, ldp(p.small[bi], off + i, p.small_bf16)));
  }
  __syncthreads();
}

// Partial sums of xs[0:K] @ W[K, N] (int8) for this block's warp items:
// part[slice][n] over the K rows of each slice.
__device__ void gemv_parts(const int8_t* W, int K, int N, const float* xs,
                           float* part) {
  const int warps_total = gridDim.x * kWarps;
  const Split sp = split_k(K, N, warps_total);
  const int nct = (N + kTile - 1) / kTile;
  const int items = nct * sp.nks;
  const int lane = threadIdx.x & 31;
  const int cgp = lane & 3;   // which 16 columns of the tile
  const int rg = lane >> 2;   // which of 8 rows
  for (int it = blockIdx.x * kWarps + (threadIdx.x >> 5); it < items;
       it += warps_total) {
    const int ct = it % nct;
    const int ks = it / nct;
    const int col = ct * kTile + cgp * 16;
    const int k0 = ks * sp.rows;
    const int k1 = min(K, k0 + sp.rows);
    float acc[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[j] = 0.f;
    if (col < N) {
#pragma unroll 4
      for (int k = k0 + rg; k < k1; k += 8) {
        const int4 raw = __ldcs(reinterpret_cast<const int4*>(
            W + static_cast<long long>(k) * N + col));
        const float x = xs[k];
        const int words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
        for (int w = 0; w < 4; ++w) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            // bf16 x int8 is exact in float32: the FMA rounds once, as
            // a product then a sum would
            acc[4 * w + j] = fmaf(x, static_cast<float>(static_cast<int8_t>(
                (words[w] >> (8 * j)) & 0xff)), acc[4 * w + j]);
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      acc[j] += __shfl_xor_sync(kFull, acc[j], 4);
      acc[j] += __shfl_xor_sync(kFull, acc[j], 8);
      acc[j] += __shfl_xor_sync(kFull, acc[j], 16);
    }
    if (rg == 0 && col < N) {
      float4* dst = reinterpret_cast<float4*>(
          part + static_cast<long long>(ks) * N + col);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        dst[j] = make_float4(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2],
                             acc[4 * j + 3]);
      }
    }
  }
}

// sum over the K slices of column n, in slice order
__device__ __forceinline__ float reduce_parts(const float* part, int nks,
                                              int N, int n) {
  float t = 0.f;
  for (int k = 0; k < nks; ++k)
    t += __ldcg(part + static_cast<long long>(k) * N + n);
  return t;
}

template <int MODE>
__device__ void store_new_row(void* cache, float* scales,
                              long long row_off, long long scale_off,
                              const float* raw, float* attended, int hD,
                              float* red) {
  const int d = threadIdx.x;
  const float x = d < hD ? raw[d] : 0.f;
  if constexpr (MODE == kInt8) {
    const float amax = block_max(fabsf(x), red);
    const float s = fmaxf(amax, 1e-8f) / 127.0f;
    const float q = fminf(fmaxf(rintf(x / s), -127.f), 127.f);
    if (d < hD) {
      static_cast<int8_t*>(cache)[row_off + d] = static_cast<int8_t>(q);
      attended[d] = __fmul_rn(q, s);
    }
    if (d == 0) scales[scale_off] = s;
  } else if constexpr (MODE == kFP8) {
    if (d < hD) {
      const uint8_t b = float_to_fp8(x);
      static_cast<uint8_t*>(cache)[row_off + d] = b;
      attended[d] = fp8_to_float(b);
    }
  } else if constexpr (MODE == kBF16) {
    if (d < hD) {
      static_cast<__nv_bfloat16*>(cache)[row_off + d] =
          __float2bfloat16_rn(x);
      attended[d] = x;
    }
  } else {
    if (d < hD) {
      static_cast<float*>(cache)[row_off + d] = x;
      attended[d] = x;
    }
  }
}

// P2 for head hh of layer l: the new K/V row, then attention over the
// history rows < pos and the new token into attn[hh*hD : (hh+1)*hD].
template <int MODE>
__device__ void attend_head(const Params& p, int l, int hh, int pos,
                            const float* part, float* attn, AttnSmem& sm) {
  const int H = p.H;
  const int hD = H / p.nH;
  const int tid = threadIdx.x;
  const Split sp = split_k(H, 3 * H, gridDim.x * kWarps);
  const long long l3 = static_cast<long long>(l) * 3 * H;
  for (int t = tid; t < 3 * hD; t += kThreads) {
    const int which = t / hD;
    const int d = t % hD;
    const int col = which * H + hh * hD + d;
    const float v = __fadd_rn(
        __fmul_rn(reduce_parts(part, sp.nks, 3 * H, col), p.s[0][l3 + col]),
        ldp(p.small[kQkvB], l3 + col, p.small_bf16));
    float* dst = which == 0 ? sm.qs : (which == 1 ? sm.kraw : sm.vraw);
    dst[d] = v;
  }
  __syncthreads();

  const long long lt = static_cast<long long>(l) * p.T;
  const long long row_new = (lt + pos) * H + hh * hD;
  const long long sc_new = (lt + pos) * p.nH + hh;
  store_new_row<MODE>(p.ck, p.ks, row_new, sc_new, sm.kraw, sm.kn, hD,
                      sm.red);
  store_new_row<MODE>(p.cv, p.vs, row_new, sc_new, sm.vraw, sm.vn, hD,
                      sm.red);
  if (tid < hD) {
    const float q = __fmul_rn(sm.qs[tid], p.scale);
    sm.qs[tid] = q;
    sm.qb[tid] = bf16r(q);
  }
  __syncthreads();

  const int ngrp = hD / 8;                 // 8-value groups of a row
  const int nrg = kThreads / ngrp;         // row groups of the P.V pass
  const int dg = tid % ngrp;
  const int rg = tid / ngrp;
  float m = kNegInf;
  float lsum = 0.f;
  float acc = 0.f;                          // thread d < hD: output d
  for (int c0 = 0; c0 < pos; c0 += kChunk) {
    const int n = min(kChunk, pos - c0);
    float sc = kNegInf;
    if (tid < n) {
      const long long row = lt + c0 + tid;
      const float ksc = MODE == kInt8 ? p.ks[row * p.nH + hh] : 1.f;
      float s = 0.f;
      for (int g = 0; g < ngrp; ++g) {
        float kv[8];
        load8<MODE>(p.ck, row * H + hh * hD + g * 8, ksc, kv);
#pragma unroll
        for (int j = 0; j < 8; ++j) s = fmaf(sm.qb[g * 8 + j], kv[j], s);
      }
      sc = s;
    }
    const float m_new = fmaxf(m, block_max(sc, sm.red));
    const float pr = tid < n ? expf(sc - m_new) : 0.f;
    const float psum = block_sum(pr, sm.red);
    const float corr = expf(m - m_new);
    lsum = __fadd_rn(__fmul_rn(lsum, corr), psum);
    sm.p[tid] = bf16r(pr);
    __syncthreads();
    float pv[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) pv[j] = 0.f;
    for (int r = rg; r < n; r += nrg) {
      const long long row = lt + c0 + r;
      const float vsc = MODE == kInt8 ? p.vs[row * p.nH + hh] : 1.f;
      float vv[8];
      load8<MODE>(p.cv, row * H + hh * hD + dg * 8, vsc, vv);
      const float pr_r = sm.p[r];
#pragma unroll
      for (int j = 0; j < 8; ++j) pv[j] = fmaf(pr_r, vv[j], pv[j]);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) sm.pv[rg * hD + dg * 8 + j] = pv[j];
    __syncthreads();
    if (tid < hD) {
      float t = 0.f;
      for (int g = 0; g < nrg; ++g) t += sm.pv[g * hD + tid];
      acc = __fadd_rn(__fmul_rn(acc, corr), t);
    }
    m = m_new;
    __syncthreads();  // p and pv are rewritten by the next chunk
  }

  // the new token, unrounded
  const float s_n = block_sum(
      tid < hD ? __fmul_rn(sm.qs[tid], sm.kn[tid]) : 0.f, sm.red);
  const float m_new = fmaxf(m, s_n);
  const float p_n = expf(s_n - m_new);
  const float corr = expf(m - m_new);
  lsum = __fadd_rn(__fmul_rn(lsum, corr), p_n);
  if (tid < hD) {
    acc = __fadd_rn(__fmul_rn(acc, corr), __fmul_rn(p_n, sm.vn[tid]));
    attn[hh * hD + tid] = acc / lsum;
  }
  __syncthreads();  // the head loop reuses the shared state
}

__device__ __forceinline__ float gelu_tanh(float x) {
  // jax.nn.gelu(approximate=True):
  // x * (0.5 * (1 + tanh(sqrt(2/pi) * (x + 0.044715 * x^3))))
  const float c = 0.7978845608028654f;
  const float x3 = __fmul_rn(__fmul_rn(x, x), x);
  const float inner = __fmul_rn(c, __fadd_rn(x, __fmul_rn(0.044715f, x3)));
  return __fmul_rn(x, __fmul_rn(0.5f, __fadd_rn(1.0f, tanhf(inner))));
}

template <int MODE>
__global__ void __launch_bounds__(kThreads, kMaxBlocksPerSM)
fused_decode_kernel(const Params p) {
  extern __shared__ float xs[];   // a GEMV input vector, max(H, F)
  __shared__ AttnSmem sm;
  cg::grid_group grid = cg::this_grid();
  const int H = p.H;
  const int F = p.F;
  const int pos = *p.pos;
  const int tid = threadIdx.x;
  const int gtid = blockIdx.x * kThreads + tid;
  const int gstride = gridDim.x * kThreads;
  const int warps_total = gridDim.x * kWarps;
  if (blockIdx.x == 0) {
    for (int i = tid; i < 7 * H; i += kThreads) p.h_out[H + i] = 0.f;
  }
  if (pos < 0 || pos >= p.T) {
    // no write at all; a NaN row 0 tells the caller (uniform exit: no
    // block reaches a barrier)
    if (blockIdx.x == 0) {
      for (int i = tid; i < H; i += kThreads) p.h_out[i] = nanf("");
    }
    return;
  }
  float* hA = p.scratch;
  float* hB = hA + H;
  float* attn = hB + H;
  float* g = attn + H;
  float* part = g + F;
  const Split sp_proj = split_k(H, H, warps_total);
  const Split sp_fc1 = split_k(H, F, warps_total);
  const Split sp_fc2 = split_k(F, H, warps_total);

  for (int l = 0; l < p.L; ++l) {
    const float* hin = l == 0 ? p.h0 : hA;
    const long long lH = static_cast<long long>(l) * H;
    const long long lF = static_cast<long long>(l) * F;
    // P1: LN1 + qkv
    layer_norm_bf16(p, hin, kLn1G, kLn1B, l, xs, sm.red);
    gemv_parts(p.w[0] + lH * 3 * H, H, 3 * H, xs, part);
    grid.sync();
    // P2: the new K/V row and attention, one block per head
    for (int hh = blockIdx.x; hh < p.nH; hh += gridDim.x)
      attend_head<MODE>(p, l, hh, pos, part, attn, sm);
    grid.sync();
    // P3: proj
    for (int i = tid; i < H; i += kThreads) xs[i] = bf16r(__ldcg(attn + i));
    __syncthreads();
    gemv_parts(p.w[1] + lH * H, H, H, xs, part);
    grid.sync();
    // P4: h2 = (h + proj) + proj_b
    for (int n = gtid; n < H; n += gstride) {
      const float proj = __fmul_rn(reduce_parts(part, sp_proj.nks, H, n),
                                   p.s[1][lH + n]);
      hB[n] = __fadd_rn(__fadd_rn(__ldcg(hin + n), proj),
                        ldp(p.small[kProjB], lH + n, p.small_bf16));
    }
    grid.sync();
    // P5: LN2 + fc1
    layer_norm_bf16(p, hB, kLn2G, kLn2B, l, xs, sm.red);
    gemv_parts(p.w[2] + lH * F, H, F, xs, part);
    grid.sync();
    // P6: g = bf16(gelu(fc1 + fc1_b))
    for (int n = gtid; n < F; n += gstride) {
      const float u = __fadd_rn(
          __fmul_rn(reduce_parts(part, sp_fc1.nks, F, n), p.s[2][lF + n]),
          ldp(p.small[kFc1B], lF + n, p.small_bf16));
      g[n] = bf16r(gelu_tanh(u));
    }
    grid.sync();
    // P7: fc2, K = F split over the grid's warps
    for (int i = tid; i < F; i += kThreads) xs[i] = __ldcg(g + i);
    __syncthreads();
    gemv_parts(p.w[3] + lF * H, F, H, xs, part);
    grid.sync();
    // P8: h = (h2 + fc2) + fc2_b
    for (int n = gtid; n < H; n += gstride) {
      const float out = __fadd_rn(
          __fadd_rn(__ldcg(hB + n),
                    __fmul_rn(reduce_parts(part, sp_fc2.nks, H, n),
                              p.s[3][lH + n])),
          ldp(p.small[kFc2B], lH + n, p.small_bf16));
      hA[n] = out;
      if (l == p.L - 1) p.h_out[n] = out;
    }
    if (l + 1 < p.L) grid.sync();
  }
}

const void* kernel_of(int mode) {
  switch (mode) {
    case kF32: return reinterpret_cast<const void*>(fused_decode_kernel<kF32>);
    case kBF16: return reinterpret_cast<const void*>(fused_decode_kernel<kBF16>);
    case kInt8: return reinterpret_cast<const void*>(fused_decode_kernel<kInt8>);
    case kFP8: return reinterpret_cast<const void*>(fused_decode_kernel<kFP8>);
    default: return nullptr;
  }
}

int smem_bytes(int H, int F) {
  return (H > F ? H : F) * static_cast<int>(sizeof(float));
}

bool widths_ok(int H, int F) {
  return H > 0 && F > 0 && H % 16 == 0 && F % 16 == 0 && H <= kMaxWidth
         && F <= kMaxWidth;
}

}  // namespace

// The cooperative grid for these widths on the current device: as many
// blocks as can be resident at once (the occupancy calculator's count
// for every storage mode, at most kMaxBlocksPerSM an SM, times the SM
// count), and the scratch that grid needs (floats).  It also lets every
// instance take the dynamic shared memory of the widest input the
// kernel accepts, so a launch at any planned width needs no attribute
// call of its own.  Returns a CUDA error code (cudaErrorNotSupported
// without cooperative launch).
extern "C" int pt_fused_decode_plan(int H, int F, int* grid,
                                    long long* scratch) {
  if (!widths_ok(H, F)) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  int sms = 0;
  int coop = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  const int smem = smem_bytes(H, F);
  int per_sm = kMaxBlocksPerSM;
  for (int mode = 0; mode < 4; ++mode) {
    e = cudaFuncSetAttribute(kernel_of(mode),
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes(kMaxWidth, kMaxWidth));
    int n = 0;
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, kernel_of(mode), kThreads, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    per_sm = n < per_sm ? n : per_sm;
  }
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  *grid = per_sm * sms;
  *scratch = scratch_floats(H, F, *grid * kWarps);
  return 0;
}

// One token through all L layers in one cooperative launch on `stream`
// (no synchronisation, nothing allocated).  small_bf16: the biases and
// LN params are bfloat16 (else float32).  kv_mode: 0 float32, 1
// bfloat16, 2 int8 (ks/vs scale planes required), 3 float8_e4m3.  grid
// and scratch_floats come from pt_fused_decode_plan, which must have
// run on this device first (it sets the shared memory limit).  Returns
// cudaErrorInvalidValue for arguments outside the kernel's contract,
// the error of a refused cooperative launch, or cudaGetLastError().
extern "C" int pt_fused_decode(
    const void* h0, const void* qkv_q, const void* proj_q, const void* fc1_q,
    const void* fc2_q, const void* qkv_s, const void* proj_s,
    const void* fc1_s, const void* fc2_s, const void* qkv_b,
    const void* proj_b, const void* fc1_b, const void* fc2_b,
    const void* ln1_g, const void* ln1_b, const void* ln2_g,
    const void* ln2_b, void* ck, void* cv, void* ks, void* vs,
    const void* pos, void* h_out, void* scratch, int L, int H, int F, int nH,
    int T, int small_bf16, int kv_mode, float eps, float scale, int grid,
    long long scratch_len, void* stream) {
  if (!widths_ok(H, F) || L < 1 || nH < 1 || H % nH || T < 1 || grid < 1
      || kernel_of(kv_mode) == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int hD = H / nH;
  if (hD % 16 || hD > kMaxHD
      || scratch_len < scratch_floats(H, F, grid * kWarps)
      || (kv_mode == kInt8 && (ks == nullptr || vs == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.h0 = static_cast<const float*>(h0);
  p.w[0] = static_cast<const int8_t*>(qkv_q);
  p.w[1] = static_cast<const int8_t*>(proj_q);
  p.w[2] = static_cast<const int8_t*>(fc1_q);
  p.w[3] = static_cast<const int8_t*>(fc2_q);
  p.s[0] = static_cast<const float*>(qkv_s);
  p.s[1] = static_cast<const float*>(proj_s);
  p.s[2] = static_cast<const float*>(fc1_s);
  p.s[3] = static_cast<const float*>(fc2_s);
  const void* small[8] = {qkv_b, proj_b, fc1_b, fc2_b,
                          ln1_g, ln1_b, ln2_g, ln2_b};
  for (int i = 0; i < 8; ++i) p.small[i] = small[i];
  p.ck = ck;
  p.cv = cv;
  p.ks = static_cast<float*>(ks);
  p.vs = static_cast<float*>(vs);
  p.pos = static_cast<const int*>(pos);
  p.h_out = static_cast<float*>(h_out);
  p.scratch = static_cast<float*>(scratch);
  p.L = L;
  p.H = H;
  p.F = F;
  p.nH = nH;
  p.T = T;
  p.small_bf16 = small_bf16;
  p.eps = eps;
  p.scale = scale;
  void* args[] = {&p};
  cudaError_t e = cudaLaunchCooperativeKernel(
      kernel_of(kv_mode), dim3(grid), dim3(kThreads), args,
      static_cast<size_t>(smem_bytes(H, F)),
      static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

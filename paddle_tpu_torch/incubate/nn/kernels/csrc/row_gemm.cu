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
// operands float32.  K and N are multiples of 8 (16-byte copies).  One
// launch takes at most 64 rows; the wrapper cuts larger M into chunks
// of 64 rows, which changes no row's arithmetic.
//
// What makes a row's bits independent of M:
// * the K order and the split-K count come from (K, N) alone (the
//   wrapper's row_gemm_plan): K walks in stages of 64 in ascending
//   order, a split owns a fixed run of stages, and within a stage the
//   16-deep steps go in order;
// * rows sit in 16-row tiles (row m in tile m / 16, place m % 16) and
//   an mma.sync row never mixes with another row; the float32 instance
//   sums each row in its own register chain;
// * the split partials are summed in split order (0, 1, 2, ...) by the
//   last block of a column tile to arrive, read back through L2; no
//   atomic float adds.
//
// What bounds it on the H100: the weight bytes.  At M <= 64 a weight
// element feeds at most 64 products, far below the ~295 operations a
// byte at which the tensor cores would bind, so the least time is K N
// element bytes over 3.35 TB/s (gpt3_1p3b, bf16: qkv 25.2 MB = 7.5 us,
// fc1/fc2 33.6 MB = 10 us, the head 206 MB = 61.5 us).
//
// Design (a simple first kernel; wgmma and TMA come later):
// * a block of 4 warps owns 64 output columns and one split of K; grid
//   = column tiles x splits, sized by the plan for ~2 blocks an SM;
// * each stage copies a 64 x 64 weight tile and the [rows, 64] slice of
//   x into shared memory with 16-byte cp.async (zero-filled past K, N
//   and M) through a ring of 4 stages, XOR-swizzled as tc_common.cuh's
//   swz<64>;
// * bf16: warp w computes columns 16 w .. 16 w + 15 of every 16-row
//   tile with mma.sync m16n8k16 (ldmatrix for x, ldmatrix.trans for a
//   "kn" weight tile, plain ldmatrix for an "nk" one), float32
//   accumulators;
// * float32: thread (c, r) computes column c for rows r, r + 2, ... with
//   one fmaf chain a row, k ascending;
// * one split writes its rows straight to y; several write float32
//   partials to a scratch buffer, count themselves in a per-tile
//   counter (reset by the last block) and the last one sums them in
//   split order and writes y.

#include "tc_common.cuh"

namespace {

constexpr int kBN = 64;       // output columns a block
constexpr int kBK = 64;       // K rows a stage
constexpr int kStages = 4;    // cp.async ring depth (6 and 8 measured slower)
constexpr int kThreads = 128;
constexpr int kMaxRows = 64;  // rows a launch

template <int MT>
__host__ __device__ constexpr int bf16_stage_elems() {
  return kBK * kBN + MT * 16 * kBK;
}

template <int MT>
__host__ __device__ constexpr int bf16_smem_bytes() {
  return kStages * bf16_stage_elems<MT>() * static_cast<int>(sizeof(bf16));
}

__device__ __forceinline__ void store2(bf16* out, long long i, float a,
                                       float b) {
  *reinterpret_cast<__nv_bfloat162*>(out + i) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ void store2(float* out, long long i, float a,
                                       float b) {
  *reinterpret_cast<float2*>(out + i) = make_float2(a, b);
}

// After a split has written its partials [split][M][N]: count the
// arrival; the last block of the column tile sums the splits in order
// and writes y.  Returns at once in the other blocks.
template <typename OutT>
__device__ __forceinline__ void finish_splits(const float* part,
                                              int* counters, OutT* out,
                                              int M, int N, int n0,
                                              int splits) {
  __shared__ int s_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const int t = atomicAdd(counters + blockIdx.x, 1);
    s_last = (t == splits - 1);
    if (s_last) counters[blockIdx.x] = 0;   // ready for the next launch
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const long long plane = static_cast<long long>(M) * N;
  for (int i = threadIdx.x; i < M * (kBN / 2); i += kThreads) {
    const int m = i / (kBN / 2);
    const int n = n0 + 2 * (i % (kBN / 2));
    if (n >= N) continue;
    const long long at = static_cast<long long>(m) * N + n;
    float2 acc = __ldcg(reinterpret_cast<const float2*>(part + at));
    for (int s = 1; s < splits; ++s) {
      const float2 v =
          __ldcg(reinterpret_cast<const float2*>(part + s * plane + at));
      acc.x += v.x;
      acc.y += v.y;
    }
    store2(out, at, acc.x, acc.y);
  }
}

// ---------------------------------------------------------------------------
// bfloat16 operands on the tensor cores
// ---------------------------------------------------------------------------

template <int MT, bool NK, typename OutT>
__global__ void __launch_bounds__(kThreads)
    row_gemm_bf16_kernel(const bf16* __restrict__ x,
                         const bf16* __restrict__ w, OutT* __restrict__ out,
                         float* __restrict__ part, int* __restrict__ counters,
                         int M, int K, int N, long long ldw, int splits,
                         int split_stages) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n0 = blockIdx.x * kBN;
  const int split = blockIdx.y;
  const int kb = (K + kBK - 1) / kBK;
  const int s0 = split * split_stages;
  const int nst = min(s0 + split_stages, kb) - s0;

  auto load = [&](int st, int buf) {
    bf16* sw = smem + buf * bf16_stage_elems<MT>();
    bf16* sx = sw + kBK * kBN;
    const int k0 = (s0 + st) * kBK;
#pragma unroll
    for (int i = tid; i < MT * 16 * 8; i += kThreads) {
      const int r = i >> 3;
      const int c = i & 7;
      const int k = k0 + c * 8;
      const bool ok = r < M && k < K;
      const bf16* src = x + (ok ? static_cast<long long>(r) * K + k : 0);
      cp_async16(smem_u32(sx + swz<64>(r, c)), src, ok);
    }
#pragma unroll
    for (int i = tid; i < kBK * 8; i += kThreads) {
      const int r = i >> 3;
      const int c = i & 7;
      bool ok;
      long long off;
      if constexpr (NK) {
        // row r = output column n0 + r, chunk c = k0 + 8c
        const int n = n0 + r;
        const int k = k0 + c * 8;
        ok = n < N && k < K;
        off = static_cast<long long>(n) * ldw + k;
      } else {
        // row r = k0 + r, chunk c = output columns n0 + 8c
        const int k = k0 + r;
        const int n = n0 + c * 8;
        ok = k < K && n < N;
        off = static_cast<long long>(k) * ldw + n;
      }
      cp_async16(smem_u32(sw + swz<64>(r, c)), w + (ok ? off : 0), ok);
    }
  };

  float acc[MT][2][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nst) load(st, st);
    cp_async_commit();
  }
  for (int st = 0; st < nst; ++st) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int nxt = st + kStages - 1;
    if (nxt < nst) load(nxt, nxt % kStages);
    cp_async_commit();
    const bf16* sw = smem + (st % kStages) * bf16_stage_elems<MT>();
    const bf16* sx = sw + kBK * kBN;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t b[4];
      if constexpr (NK) {
        ldsm_x4(b, b_addr<64>(sw, warp * 16, kk * 2, lane));
      } else {
        ldsm_x4_t(b, a_addr<64>(sw, kk * 16, warp * 2, lane));
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t a[4];
        ldsm_x4(a, a_addr<64>(sx, mt * 16, kk * 2, lane));
        mma(acc[mt][0], a, b[0], b[1]);
        mma(acc[mt][1], a, b[2], b[3]);
      }
    }
  }
  cp_async_wait<0>();

  // accumulator element e of n8 tile j: row g + 8 (e / 2), column
  // 8 j + 2 t + e % 2 of the warp's 16
  const int g = lane >> 2;
  const int t = lane & 3;
  const bool direct = splits == 1;
  float* mine = part + static_cast<long long>(split) * M * N;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = mt * 16 + g + 8 * h;
        const int n = n0 + warp * 16 + j * 8 + 2 * t;
        if (m >= M || n >= N) continue;
        const long long at = static_cast<long long>(m) * N + n;
        if (direct) {
          store2(out, at, acc[mt][j][2 * h], acc[mt][j][2 * h + 1]);
        } else {
          store2(mine, at, acc[mt][j][2 * h], acc[mt][j][2 * h + 1]);
        }
      }
  if (!direct) finish_splits(part, counters, out, M, N, n0, splits);
}

// ---------------------------------------------------------------------------
// float32 operands on the CUDA cores
// ---------------------------------------------------------------------------

template <int MT, bool NK>
__global__ void __launch_bounds__(kThreads)
    row_gemm_f32_kernel(const float* __restrict__ x,
                        const float* __restrict__ w, float* __restrict__ out,
                        float* __restrict__ part, int* __restrict__ counters,
                        int M, int K, int N, long long ldw, int splits,
                        int split_stages) {
  __shared__ __align__(16) float sw[kBK][kBN];
  __shared__ __align__(16) float sx[MT * 16][kBK];
  const int tid = threadIdx.x;
  const int c = tid & (kBN - 1);      // the column this thread computes
  const int r0 = tid / kBN;           // rows r0, r0 + 2, ...
  const int n0 = blockIdx.x * kBN;
  const int split = blockIdx.y;
  const int kb = (K + kBK - 1) / kBK;
  const int s0 = split * split_stages;
  const int s1 = min(s0 + split_stages, kb);
  constexpr int kRowsPer = MT * 16 / 2;
  float acc[kRowsPer];
#pragma unroll
  for (int i = 0; i < kRowsPer; ++i) acc[i] = 0.f;

  for (int s = s0; s < s1; ++s) {
    const int k0 = s * kBK;
    __syncthreads();   // the previous stage's reads are done
    for (int i = tid; i < kBK * (kBN / 4); i += kThreads) {
      const int r = i / (kBN / 4);
      const int q = (i % (kBN / 4)) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if constexpr (NK) {
        // row r = output column n0 + r, k0 + q .. k0 + q + 3
        const int n = n0 + r;
        const int k = k0 + q;
        if (n < N && k < K) {
          v = *reinterpret_cast<const float4*>(
              w + static_cast<long long>(n) * ldw + k);
        }
        sw[q][r] = v.x;
        sw[q + 1][r] = v.y;
        sw[q + 2][r] = v.z;
        sw[q + 3][r] = v.w;
      } else {
        const int k = k0 + r;
        const int n = n0 + q;
        if (k < K && n < N) {
          v = *reinterpret_cast<const float4*>(
              w + static_cast<long long>(k) * ldw + n);
        }
        *reinterpret_cast<float4*>(&sw[r][q]) = v;
      }
    }
    for (int i = tid; i < MT * 16 * (kBK / 4); i += kThreads) {
      const int m = i / (kBK / 4);
      const int q = (i % (kBK / 4)) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (m < M && k0 + q < K) {
        v = *reinterpret_cast<const float4*>(
            x + static_cast<long long>(m) * K + k0 + q);
      }
      *reinterpret_cast<float4*>(&sx[m][q]) = v;
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < kBK; ++k) {
      const float wv = sw[k][c];
#pragma unroll
      for (int i = 0; i < kRowsPer; ++i) {
        acc[i] = fmaf(sx[r0 + 2 * i][k], wv, acc[i]);
      }
    }
  }

  const int n = n0 + c;
  const bool direct = splits == 1;
  float* dst = direct ? out : part + static_cast<long long>(split) * M * N;
  if (n < N) {
#pragma unroll
    for (int i = 0; i < kRowsPer; ++i) {
      const int m = r0 + 2 * i;
      if (m < M) dst[static_cast<long long>(m) * N + n] = acc[i];
    }
  }
  if (!direct) finish_splits(part, counters, out, M, N, n0, splits);
}

template <int MT, bool NK, typename OutT>
int launch_bf16(const void* x, const void* w, void* out, float* part,
                int* counters, int M, int K, int N, long long ldw,
                int splits, int split_stages, cudaStream_t s) {
  auto kernel = row_gemm_bf16_kernel<MT, NK, OutT>;
  constexpr int smem = bf16_smem_bytes<MT>();
  static bool ready = false;
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready = true;
  }
  const dim3 grid((N + kBN - 1) / kBN, splits);
  kernel<<<grid, kThreads, smem, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<OutT*>(out), part, counters, M, K, N, ldw, splits,
      split_stages);
  return static_cast<int>(cudaGetLastError());
}

template <int MT, bool NK>
int launch_f32(const void* x, const void* w, void* out, float* part,
               int* counters, int M, int K, int N, long long ldw, int splits,
               int split_stages, cudaStream_t s) {
  const dim3 grid((N + kBN - 1) / kBN, splits);
  row_gemm_f32_kernel<MT, NK><<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<float*>(out), part, counters, M, K, N, ldw, splits,
      split_stages);
  return static_cast<int>(cudaGetLastError());
}

template <int MT>
int dispatch(int dtype, int nk, int f32out, const void* x, const void* w,
             void* out, float* part, int* counters, int M, int K, int N,
             long long ldw, int splits, int split_stages, cudaStream_t s) {
  if (dtype == 0) {
    return nk ? launch_f32<MT, true>(x, w, out, part, counters, M, K, N, ldw,
                                     splits, split_stages, s)
              : launch_f32<MT, false>(x, w, out, part, counters, M, K, N,
                                      ldw, splits, split_stages, s);
  }
  if (f32out) {
    return nk ? launch_bf16<MT, true, float>(x, w, out, part, counters, M, K,
                                             N, ldw, splits, split_stages, s)
              : launch_bf16<MT, false, float>(x, w, out, part, counters, M,
                                              K, N, ldw, splits,
                                              split_stages, s);
  }
  return nk ? launch_bf16<MT, true, bf16>(x, w, out, part, counters, M, K, N,
                                          ldw, splits, split_stages, s)
            : launch_bf16<MT, false, bf16>(x, w, out, part, counters, M, K,
                                           N, ldw, splits, split_stages, s);
}

}  // namespace

// y [M, N] = x [M, K] @ w.  dtype 0 float32, 1 bfloat16; nk 1 when w is
// [N, K] (K contiguous), 0 when [K, N] (N contiguous); f32out 1 for a
// float32 y from bfloat16 operands.  part: float32 [splits, M, N]
// scratch (unused at one split); counters: one zeroed int32 a column
// tile, left zeroed.  Returns cudaGetLastError() after the launch.
extern "C" int pt_row_gemm(const void* x, const void* w, void* out,
                           void* part, void* counters, int dtype, int nk,
                           int f32out, int M, int K, int N, long long ldw,
                           int splits, int split_stages, void* stream) {
  if (M == 0 || N == 0) return 0;
  const int kb = (K + kBK - 1) / kBK;
  if (M < 0 || M > kMaxRows || K < 1 || K % 8 || N % 8 || dtype < 0
      || dtype > 1 || splits < 1
      || split_stages < 1 || splits != (kb + split_stages - 1) / split_stages
      || (splits > 1 && (part == nullptr || counters == nullptr))
      || ldw < (nk ? K : N)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  int* cnt = static_cast<int*>(counters);
  const int mt = (M + 15) / 16;
  if (mt == 1) {
    return dispatch<1>(dtype, nk, f32out, x, w, out, p, cnt, M, K, N, ldw,
                       splits, split_stages, s);
  }
  if (mt == 2) {
    return dispatch<2>(dtype, nk, f32out, x, w, out, p, cnt, M, K, N, ldw,
                       splits, split_stages, s);
  }
  return dispatch<4>(dtype, nk, f32out, x, w, out, p, cnt, M, K, N, ldw,
                     splits, split_stages, s);
}

// Dynamic shared memory (bytes) of the bfloat16 instance for a launch of
// M rows.
extern "C" int pt_row_gemm_smem_bytes(int M) {
  const int mt = (M + 15) / 16;
  return mt == 1 ? bf16_smem_bytes<1>()
                 : mt == 2 ? bf16_smem_bytes<2>() : bf16_smem_bytes<4>();
}

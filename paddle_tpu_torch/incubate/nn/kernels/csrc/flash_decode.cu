// Multi-slot flash-decoding attention for Hopper (sm_90a).
//
// Replaces the TPU kernel paddle_tpu/incubate/nn/kernels/flash_decode.py
// ::_flash_decode_kernel (contiguous layout, dense float32/bfloat16
// caches).  Same contract: q [B, W, nH, hD], k/v [B, T, nKV, hD] already
// holding the window's own K/V, pos [B] int32; query j of slot b sees
// cache rows i <= pos[b] + j.  Scores, the online max/sum and the
// accumulator are float32; the output is written in q's dtype.  GQA maps
// query head h to kv head h / (nH / nKV).
//
// What bounds it on the H100: decode (W = 1) reads every visible K/V row
// once and does 4*hD flops per row and head, far below the card's
// flops-per-byte balance, so the K/V bytes over the HBM rate bound it.
// Prefill (W = S, pos = 0) reuses each K/V row for up to S queries: its
// 4*hD flops per visible (query, row) pair grow as S^2 and bound it once
// S passes about a thousand rows at the bf16 tensor-core rate, and at
// every serving length on the float32 CUDA cores this kernel uses.
//
// The simple design, and what it does about that:
// * One block of 128 threads per (query tile of 16, head, slot).  The
//   block walks the KV rows in chunks of 32, staged in shared memory as
//   float32 with 16-byte vector loads, and folds each chunk into
//   per-query online-softmax state kept in registers (the TPU kernel
//   carried m/l/acc across its sequential grid axis in VMEM scratch).
// * The chunk loop stops at the last row any query of the tile can see
//   (never past T), so the work is proportional to the visible rows;
//   the TPU kernel walked every chunk and masked.
// * Query tiling lets one staged K/V chunk serve 16 queries of a prefill
//   tile, so admission at full width does not walk the cache per query.
// * Scores and P.V run on the CUDA cores in float32.
// Left for later work: tensor cores (wgmma) for the score and P.V
// products, TMA/cp.async double buffering of the chunks, and split-KV
// for decode at small B (B*nH blocks do not fill 132 SMs' bandwidth).
//
// Strides are taken in elements for the batch, token and head axes of
// q, k and v (the last axis must be contiguous), so the prefill path's
// q/k/v slices of the packed qkv activation need no copy.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 128;   // 4 warps
constexpr int kQTile = 16;      // queries per block
constexpr int kChunk = 32;      // KV rows per shared-memory chunk (= warp)
constexpr int kRowsPerWarp = kQTile / (kThreads / 32);
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

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ pos,
                    T* __restrict__ out, int W, int T_len, int nH, int nKV,
                    long long qs_b, long long qs_w, long long qs_h,
                    long long ks_b, long long ks_t, long long ks_h,
                    long long vs_b, long long vs_t, long long vs_h,
                    float scale) {
  static_assert(HD % 16 == 0 && HD <= kThreads, "unsupported head dim");
  constexpr int VN = Vec<T>::N;
  constexpr int KP = HD + 4;                   // padded row: no bank conflicts
  constexpr int kAcc = kQTile * HD / kThreads; // P.V outputs per thread
  constexpr int kRowStep = kThreads / HD;

  __shared__ __align__(16) float sQ[kQTile][KP];
  __shared__ __align__(16) float sK[kChunk][KP];
  __shared__ __align__(16) float sV[kChunk][KP];
  __shared__ float sP[kQTile][kChunk + 1];
  __shared__ float sCorr[kQTile];
  __shared__ float sL[kQTile];

  const int q0 = blockIdx.x * kQTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (nH / nKV);
  const int nq = min(kQTile, W - q0);
  const int p = pos[b];
  // last row any query of this tile can see, never past the cache
  const int n_rows = min(p + q0 + nq - 1, T_len - 1) + 1;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const T* qb = q + b * qs_b + h * qs_h;
  const T* kb = k + b * ks_b + g * ks_h;
  const T* vb = v + b * vs_b + g * vs_h;

  for (int idx = tid * VN; idx < kQTile * HD; idx += kThreads * VN) {
    const int r = idx / HD;
    const int d = idx % HD;
    float t[VN];
    if (r < nq) {
      Vec<T>::load(qb + (q0 + r) * qs_w + d, t);
    } else {
#pragma unroll
      for (int i = 0; i < VN; ++i) t[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < VN; ++i) sQ[r][d + i] = t[i] * scale;
  }

  float m_run[kRowsPerWarp];
  float l_run[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m_run[i] = kNegInf;
    l_run[i] = 0.f;
  }
  float acc[kAcc];
#pragma unroll
  for (int a = 0; a < kAcc; ++a) acc[a] = 0.f;
  const int d_pv = tid % HD;
  const int r_pv = tid / HD;

  for (int c0 = 0; c0 < n_rows; c0 += kChunk) {
    __syncthreads();  // the previous chunk's readers are done
    for (int idx = tid * VN; idx < kChunk * HD; idx += kThreads * VN) {
      const int r = idx / HD;
      const int d = idx % HD;
      const int row = c0 + r;
      float tk[VN];
      float tv[VN];
      if (row < n_rows) {
        Vec<T>::load(kb + row * ks_t + d, tk);
        Vec<T>::load(vb + row * vs_t + d, tv);
      } else {
#pragma unroll
        for (int i = 0; i < VN; ++i) {
          tk[i] = 0.f;
          tv[i] = 0.f;
        }
      }
#pragma unroll
      for (int i = 0; i < VN; ++i) {
        sK[r][d + i] = tk[i];
        sV[r][d + i] = tv[i];
      }
    }
    __syncthreads();

    // scores: lane j takes row c0 + j; warp w owns query rows
    // w*kRowsPerWarp .. +kRowsPerWarp-1 (its m/l live in registers)
    const int row = c0 + lane;
    const float4* krow = reinterpret_cast<const float4*>(&sK[lane][0]);
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp * kRowsPerWarp + i;
      if (r < nq) {  // warp-uniform
        const float4* qrow = reinterpret_cast<const float4*>(&sQ[r][0]);
        float s = 0.f;
#pragma unroll
        for (int d4 = 0; d4 < HD / 4; ++d4) {
          const float4 a = qrow[d4];
          const float4 c = krow[d4];
          s += a.x * c.x + a.y * c.y + a.z * c.z + a.w * c.w;
        }
        const bool ok = row < n_rows && row <= p + q0 + r;
        s = ok ? s : kNegInf;
        float mx = s;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_new = fmaxf(m_run[i], mx);
        const float pr = ok ? expf(s - m_new) : 0.f;
        float sum = pr;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, o);
        const float corr = expf(m_run[i] - m_new);
        l_run[i] = l_run[i] * corr + sum;
        m_run[i] = m_new;
        sP[r][lane] = pr;
        if (lane == 0) sCorr[r] = corr;
      }
    }
    __syncthreads();

    // P.V: thread owns head-dim column d_pv of query rows r_pv + a*step
#pragma unroll
    for (int a = 0; a < kAcc; ++a) {
      const int r = r_pv + a * kRowStep;
      if (r < nq) {
        float o = acc[a] * sCorr[r];
#pragma unroll 8
        for (int j = 0; j < kChunk; ++j) o += sP[r][j] * sV[j][d_pv];
        acc[a] = o;
      }
    }
  }

  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp * kRowsPerWarp + i;
      if (r < nq) sL[r] = l_run[i];
    }
  }
  __syncthreads();
#pragma unroll
  for (int a = 0; a < kAcc; ++a) {
    const int r = r_pv + a * kRowStep;
    if (r < nq) {
      const long long o = ((static_cast<long long>(b) * W + q0 + r) * nH + h)
                          * HD + d_pv;
      Vec<T>::store(out + o, acc[a] / fmaxf(sL[r], 1e-30f));
    }
  }
}

template <typename T, int HD>
void launch(const void* q, const void* k, const void* v, const int* pos,
            void* out, int B, int W, int T_len, int nH, int nKV,
            long long qs_b, long long qs_w, long long qs_h,
            long long ks_b, long long ks_t, long long ks_h,
            long long vs_b, long long vs_t, long long vs_h, float scale,
            cudaStream_t stream) {
  const dim3 grid((W + kQTile - 1) / kQTile, nH, B);
  flash_decode_kernel<T, HD><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), pos, static_cast<T*>(out), W, T_len, nH,
      nKV, qs_b, qs_w, qs_h, ks_b, ks_t, ks_h, vs_b, vs_t, vs_h, scale);
}

template <typename T>
bool launch_hd(int hD, const void* q, const void* k, const void* v,
               const int* pos, void* out, int B, int W, int T_len, int nH,
               int nKV, long long qs_b, long long qs_w, long long qs_h,
               long long ks_b, long long ks_t, long long ks_h,
               long long vs_b, long long vs_t, long long vs_h, float scale,
               cudaStream_t stream) {
#define PT_FLASH_DECODE_HD(D)                                               \
  case D:                                                                   \
    launch<T, D>(q, k, v, pos, out, B, W, T_len, nH, nKV, qs_b, qs_w, qs_h, \
                 ks_b, ks_t, ks_h, vs_b, vs_t, vs_h, scale, stream);        \
    return true;
  switch (hD) {
    PT_FLASH_DECODE_HD(16)
    PT_FLASH_DECODE_HD(32)
    PT_FLASH_DECODE_HD(64)
    PT_FLASH_DECODE_HD(128)
    default:
      break;
  }
#undef PT_FLASH_DECODE_HD
  return false;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after
// the launch (cudaErrorInvalidValue for a dtype/head-dim pair that has
// no instance).  Launches on `stream`, does not synchronise, allocates
// nothing.
extern "C" int pt_flash_decode(
    const void* q, const void* k, const void* v, const void* pos, void* out,
    int dtype, int B, int W, int T_len, int nH, int nKV, int hD,
    long long qs_b, long long qs_w, long long qs_h,
    long long ks_b, long long ks_t, long long ks_h,
    long long vs_b, long long vs_t, long long vs_h,
    float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(pos);
  bool ok = false;
  if (dtype == 0) {
    ok = launch_hd<float>(hD, q, k, v, p, out, B, W, T_len, nH, nKV, qs_b,
                          qs_w, qs_h, ks_b, ks_t, ks_h, vs_b, vs_t, vs_h,
                          scale, s);
  } else if (dtype == 1) {
    ok = launch_hd<__nv_bfloat16>(hD, q, k, v, p, out, B, W, T_len, nH, nKV,
                                  qs_b, qs_w, qs_h, ks_b, ks_t, ks_h, vs_b,
                                  vs_t, vs_h, scale, s);
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

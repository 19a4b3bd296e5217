// Multi-slot flash-decoding attention for Hopper (sm_90a).
//
// Replaces the TPU kernel paddle_tpu/incubate/nn/kernels/flash_decode.py
// ::_flash_decode_kernel, reached through _call by both
// flash_decode_attention (contiguous layout) and flash_decode_paged
// (page pool + block tables), with its three storage modes: a cache in
// the model dtype (float32/bfloat16), int8 with a float32 scale per
// (row, kv head), and float8_e4m3 without scales (the `quant` body).
// Same contract: q [B, W, nH, hD], K/V already holding the window's own
// rows, pos [B] int32; query j of slot b sees rows i <= pos[b] + j.
// Scores, the online max/sum and the accumulator are float32; the output
// is written in q's dtype.  GQA maps query head h to kv head h / (nH/nKV).
//
// One body, two template policies, as the TPU kernel shares one body
// between its index maps:
// * the address of a staged K/V row: contiguous is slot*s0 + row*s1;
//   paged reads page = bt[b][row / bs] clamped into [0, nb) (-1 reads
//   page 0; an id past the pool reads its last page, as a gather
//   clamps: no read leaves the pool) and takes page*s0 + (row % bs)*s1,
//   per staged row, so any block size works;
// * the storage type of K/V, separate from q's type: float, bfloat16,
//   int8 (each row's values times its scale while staging into shared
//   memory) or __nv_fp8_e4m3 (converted exactly through half).
// So the paged kernel on an identity table computes, bit for bit, what
// the contiguous kernel computes on the same rows, and a W = 1 window is
// the decode step.
//
// What bounds it on the H100: decode (W = 1) reads every visible K/V row
// once and does 4*hD flops per row and head, far below the card's
// flops-per-byte balance, so the K/V bytes over the HBM rate bound it:
// per row and kv head 2*2*hD bytes at bf16, 2*(hD + 4) at int8 (data and
// scale) and 2*hD at fp8.  Prefill (W = S, pos = 0) reuses each K/V row
// for up to S queries: its 4*hD flops per visible (query, row) pair grow
// as S^2 and bound it once S passes about a thousand rows at the bf16
// tensor-core rate, and at every serving length on the float32 CUDA
// cores this kernel uses.
//
// The simple design, and what it does about that:
// * One block of 128 threads per (query tile of 16, head, slot).  The
//   block walks the KV rows in chunks of 32, staged in shared memory as
//   float32 with 16-byte vector loads (4 float32, 8 bfloat16 or 16
//   int8/fp8 values a thread), and folds each chunk into per-query
//   online-softmax state kept in registers (the TPU kernel carried
//   m/l/acc across its sequential grid axis in VMEM scratch).
// * The chunk loop stops at the last row any query of the tile can see
//   (never past T), so the work is proportional to the visible rows and
//   the unbacked pages past a slot's length are never read; the TPU
//   kernel walked every chunk and masked.
// * Query tiling lets one staged K/V chunk serve 16 queries of a prefill
//   tile, so admission at full width does not walk the cache per query.
// * Scores and P.V run on the CUDA cores in float32.
// Left for later work: tensor cores (wgmma) for the score and P.V
// products, TMA/cp.async double buffering of the chunks, and split-KV
// for decode at small B (B*nH blocks do not fill 132 SMs' bandwidth).
//
// Strides are taken in elements for the slot (or page), row and head
// axes of q, K, V and the int8 scales (the last axis of q, K and V must
// be contiguous), so the prefill path's q/k/v slices of the packed qkv
// activation need no copy.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 128;   // 4 warps
constexpr int kQTile = 16;      // queries per block
constexpr int kChunk = 32;      // KV rows per shared-memory chunk (= warp)
constexpr int kRowsPerWarp = kQTile / (kThreads / 32);
constexpr float kNegInf = -1e30f;

// N values per 16-byte load, widened to float
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

template <>
struct Vec<int8_t> {
  static constexpr int N = 16;
  __device__ static void load(const int8_t* p, float* out) {
    const int4 raw = *reinterpret_cast<const int4*>(p);
    const int words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int w = 0; w < 4; ++w) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // sign-extend byte j of the word
        out[4 * w + j] = static_cast<float>(
            static_cast<int8_t>((words[w] >> (8 * j)) & 0xff));
      }
    }
  }
};

template <>
struct Vec<__nv_fp8_e4m3> {
  static constexpr int N = 16;
  __device__ static void load(const __nv_fp8_e4m3* p, float* out) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const unsigned words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int w = 0; w < 4; ++w) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        // e4m3 -> half is exact (NaN stays NaN), half -> float too
        const __nv_fp8x2_storage_t pair = static_cast<__nv_fp8x2_storage_t>(
            (words[w] >> (16 * j)) & 0xffffu);
        const __half2 h(__nv_cvt_fp8x2_to_halfraw2(pair, __NV_E4M3));
        const float2 f = __half22float2(h);
        out[4 * w + 2 * j] = f.x;
        out[4 * w + 2 * j + 1] = f.y;
      }
    }
  }
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* k_scale;   // int8 only
  const float* v_scale;
  const int* pos;
  const int* bt;          // paged only: [B, mb] page ids, -1 = none
  void* out;
  int W, T_len, nH, nKV, mb, bs, nb;
  long long qs_b, qs_w, qs_h;
  // slot (contiguous) or page (paged), row, head
  long long k0, k1, k2, v0, v1, v2;
  long long ks0, ks1, ks2, vs0, vs1, vs2;
  float scale;
};

// Element offset of row `row` of slot `b` along the slot-or-page and
// row axes whose strides are s0 and s1.
template <bool PAGED>
__device__ __forceinline__ long long row_offset(const Args& a, int b, int row,
                                                long long s0, long long s1) {
  if (PAGED) {
    const int page = min(
        max(a.bt[static_cast<long long>(b) * a.mb + row / a.bs], 0),
        a.nb - 1);
    return static_cast<long long>(page) * s0
           + static_cast<long long>(row % a.bs) * s1;
  }
  return static_cast<long long>(b) * s0 + static_cast<long long>(row) * s1;
}

template <typename TQ, typename TKV, bool PAGED, int HD>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const Args a) {
  static_assert(HD % 16 == 0 && HD <= kThreads, "unsupported head dim");
  constexpr int VQ = Vec<TQ>::N;
  constexpr int VN = Vec<TKV>::N;
  constexpr bool kScaled = std::is_same<TKV, int8_t>::value;
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
  const int g = h / (a.nH / a.nKV);
  const int W = a.W;
  const int nq = min(kQTile, W - q0);
  const int p = a.pos[b];
  // last row any query of this tile can see, never past the cache
  const int n_rows = min(p + q0 + nq - 1, a.T_len - 1) + 1;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const TQ* qb = static_cast<const TQ*>(a.q) + b * a.qs_b + h * a.qs_h;
  const TKV* kb = static_cast<const TKV*>(a.k) + g * a.k2;
  const TKV* vb = static_cast<const TKV*>(a.v) + g * a.v2;
  const float* ksb = kScaled ? a.k_scale + g * a.ks2 : nullptr;
  const float* vsb = kScaled ? a.v_scale + g * a.vs2 : nullptr;

  for (int idx = tid * VQ; idx < kQTile * HD; idx += kThreads * VQ) {
    const int r = idx / HD;
    const int d = idx % HD;
    float t[VQ];
    if (r < nq) {
      Vec<TQ>::load(qb + (q0 + r) * a.qs_w + d, t);
    } else {
#pragma unroll
      for (int i = 0; i < VQ; ++i) t[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < VQ; ++i) sQ[r][d + i] = t[i] * a.scale;
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
  for (int x = 0; x < kAcc; ++x) acc[x] = 0.f;
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
        Vec<TKV>::load(kb + row_offset<PAGED>(a, b, row, a.k0, a.k1) + d, tk);
        Vec<TKV>::load(vb + row_offset<PAGED>(a, b, row, a.v0, a.v1) + d, tv);
        if (kScaled) {
          const float sk = ksb[row_offset<PAGED>(a, b, row, a.ks0, a.ks1)];
          const float sv = vsb[row_offset<PAGED>(a, b, row, a.vs0, a.vs1)];
#pragma unroll
          for (int i = 0; i < VN; ++i) {
            tk[i] *= sk;
            tv[i] *= sv;
          }
        }
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
          const float4 x = qrow[d4];
          const float4 c = krow[d4];
          s += x.x * c.x + x.y * c.y + x.z * c.z + x.w * c.w;
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

    // P.V: thread owns head-dim column d_pv of query rows r_pv + x*step
#pragma unroll
    for (int x = 0; x < kAcc; ++x) {
      const int r = r_pv + x * kRowStep;
      if (r < nq) {
        float o = acc[x] * sCorr[r];
#pragma unroll 8
        for (int j = 0; j < kChunk; ++j) o += sP[r][j] * sV[j][d_pv];
        acc[x] = o;
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
  TQ* out = static_cast<TQ*>(a.out);
#pragma unroll
  for (int x = 0; x < kAcc; ++x) {
    const int r = r_pv + x * kRowStep;
    if (r < nq) {
      const long long o = ((static_cast<long long>(b) * W + q0 + r) * a.nH + h)
                          * HD + d_pv;
      Vec<TQ>::store(out + o, acc[x] / fmaxf(sL[r], 1e-30f));
    }
  }
}

template <typename TQ, typename TKV, bool PAGED>
bool launch_hd(int hD, const Args& a, int B, cudaStream_t stream) {
  const dim3 grid((a.W + kQTile - 1) / kQTile, a.nH, B);
  switch (hD) {
#define PT_FLASH_DECODE_HD(D)                                           \
    case D:                                                             \
      flash_decode_kernel<TQ, TKV, PAGED, D><<<grid, kThreads, 0, stream>>>(a); \
      return true;
    PT_FLASH_DECODE_HD(16)
    PT_FLASH_DECODE_HD(32)
    PT_FLASH_DECODE_HD(64)
    PT_FLASH_DECODE_HD(128)
#undef PT_FLASH_DECODE_HD
    default:
      return false;
  }
}

template <typename TQ, typename TKV>
bool launch_layout(int hD, const Args& a, int B, cudaStream_t stream) {
  return a.bt != nullptr ? launch_hd<TQ, TKV, true>(hD, a, B, stream)
                         : launch_hd<TQ, TKV, false>(hD, a, B, stream);
}

// kv_dtype: the query's own type code, 2 = int8 (+ scales), 3 = fp8 e4m3
template <typename TQ>
bool launch_kv(int q_code, int kv_dtype, int hD, const Args& a, int B,
               cudaStream_t stream) {
  if (kv_dtype == q_code) return launch_layout<TQ, TQ>(hD, a, B, stream);
  if (kv_dtype == 2) {
    if (a.k_scale == nullptr || a.v_scale == nullptr) return false;
    return launch_layout<TQ, int8_t>(hD, a, B, stream);
  }
  if (kv_dtype == 3) return launch_layout<TQ, __nv_fp8_e4m3>(hD, a, B, stream);
  return false;
}

}  // namespace

// q_dtype: 0 = float32, 1 = bfloat16 (q and out).  kv_dtype: the same
// code as q (a cache in the model dtype), 2 = int8 with float32 scales,
// 3 = float8_e4m3.  block_tables == nullptr selects the contiguous
// layout (K/V [B, T, nKV, hD], axis-0 strides step slots); otherwise the
// paged one (K/V pools [nb, bs, nKV, hD], axis-0 strides step pages,
// block_tables [B, mb] contiguous int32, T_len = mb * bs).  Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for a
// combination that has no instance).  Launches on `stream`, does not
// synchronise, allocates nothing.
extern "C" int pt_flash_decode(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* pos, const void* block_tables,
    void* out, int q_dtype, int kv_dtype, int B, int W, int T_len, int nH,
    int nKV, int hD, int mb, int bs, int nb, long long qs_b, long long qs_w,
    long long qs_h, long long k0, long long k1, long long k2, long long v0,
    long long v1, long long v2, long long ks0, long long ks1, long long ks2,
    long long vs0, long long vs1, long long vs2, float scale, void* stream) {
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.k_scale = static_cast<const float*>(k_scale);
  a.v_scale = static_cast<const float*>(v_scale);
  a.pos = static_cast<const int*>(pos);
  a.bt = static_cast<const int*>(block_tables);
  a.out = out;
  a.W = W;
  a.T_len = T_len;
  a.nH = nH;
  a.nKV = nKV;
  a.mb = mb;
  a.bs = bs;
  a.nb = nb;
  a.qs_b = qs_b;
  a.qs_w = qs_w;
  a.qs_h = qs_h;
  a.k0 = k0;
  a.k1 = k1;
  a.k2 = k2;
  a.v0 = v0;
  a.v1 = v1;
  a.v2 = v2;
  a.ks0 = ks0;
  a.ks1 = ks1;
  a.ks2 = ks2;
  a.vs0 = vs0;
  a.vs1 = vs1;
  a.vs2 = vs2;
  a.scale = scale;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.bt != nullptr && (mb < 1 || bs < 1 || nb < 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  bool ok = false;
  if (q_dtype == 0) {
    ok = launch_kv<float>(0, kv_dtype, hD, a, B, s);
  } else if (q_dtype == 1) {
    ok = launch_kv<__nv_bfloat16>(1, kv_dtype, hD, a, B, s);
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

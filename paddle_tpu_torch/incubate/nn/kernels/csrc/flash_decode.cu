// Multi-slot flash-decoding attention for Hopper (sm_90a).
//
// Replaces the TPU kernel paddle_tpu/incubate/nn/kernels/flash_decode.py
// ::_flash_decode_kernel (:67), reached through _call (:160/:203) by both
// flash_decode_attention (:222, contiguous layout) and flash_decode_paged
// (:253, page pool + block tables), with its three storage modes: a cache
// in the model dtype (float32/bfloat16), int8 with a float32 scale per
// (row, kv head), and float8_e4m3 without scales (the `quant` body
// :84-107).  Same contract: q [B, W, nH, hD], K/V already holding the
// window's own rows, pos [B] int32; query j of slot b sees rows
// i <= pos[b] + j, and a row it does not see gets p = 0 exactly (:134).
// Scores, the online max/sum and the accumulator are float32; the output
// is written in q's dtype.  GQA maps query head h to kv head h / (nH/nKV).
//
// Every instance shares two template policies, as the TPU kernel shares
// one body between its index maps:
// * the address of a staged K/V row: contiguous is slot*s0 + row*s1;
//   paged reads page = bt[b][row / bs] clamped into [0, nb) (-1 reads
//   page 0; an id past the pool reads its last page, as a gather
//   clamps: no read leaves the pool) and takes page*s0 + (row % bs)*s1,
//   per staged row, so any block size works;
// * the storage type of K/V, separate from q's type: float, bfloat16,
//   int8 or __nv_fp8_e4m3 (converted exactly through half).
// The wrapper picks the instance and the split plan from shapes and
// dtypes alone (never from pos, never from the layout), so the paged
// kernel on an identity table computes, bit for bit, what the contiguous
// kernel computes on the same rows.
//
// What bounds it on the H100: decode (W = 1) reads every visible K/V row
// once and does 4*hD flops per row and head, far below the card's
// flops-per-byte balance, so the K/V bytes over the HBM rate bound it:
// per row and kv head 2*2*hD bytes at bf16, 2*(hD + 4) at int8 (data and
// scale) and 2*hD at fp8; at B 8, T 1024, 16 heads of 128 that is some
// 7 us.  Prefill (W = S, pos = 0) reuses each K/V row for up to S
// queries: its 4*hD flops per visible (query, row) pair grow as S^2 and
// bound it at the bf16 tensor-core rate once S passes a few hundred rows.
//
// Three instances:
//
// split-KV (flash_decode_split_kernel + flash_decode_merge_kernel), for
// small windows: nH/nKV * W <= 16 queries (decode, verify, GQA groups),
// every dtype and layout.  The work is byte-bound, so the design is
// about bytes in flight:
// * One block of 128 threads per (KV split, kv head, slot) serves all
//   nH/nKV heads x W queries of its kv head from one read of each K/V
//   row.  The splits (the wrapper's decode_plan) cut T into runs of
//   32-row stages so that some 8 blocks an SM exist at B x nKV; a block
//   whose split starts past its slot's last visible row (pos + W - 1)
//   writes an empty partial (acc = 0, l = 0) and exits at once.
// * Rows stream through a double-buffered ring of 32-row stages of
//   cp.async 16-byte copies in their storage type (bf16, int8 + the
//   row's scale, fp8); a paged stage reads its rows' table entries
//   first, all of a pass at once, then copies,
//   chunks XOR-swizzled by row so that eight rows read at one chunk hit
//   distinct banks.  Scores: four threads a row, each a quarter of hD,
//   reduced by shuffles; int8 scores are scale_k[i] * (q . k_i) and P is
//   weighted by scale_v[i] before P.V; fp8 widens exactly.  The online
//   max/sum of a query lives in one warp (a lane a row); P.V gives each
//   thread one head-dim column of every (128 / hD)-th row of the stage,
//   for every query.
// * A single split writes the output; several write float32 partials
//   (unnormalised acc, m, l) to scratch from the wrapper, and the merge
//   combines them in split order: out = sum_s e^{m_s - M} acc_s /
//   max(sum_s e^{m_s - M} l_s, 1e-30), a split with l_s = 0 adding
//   nothing.  No atomics: the result is deterministic.  The work of a
//   block follows its query count: two instances, for at most 4 queries
//   (every decode and verify step of the serving paths) and at most 16,
//   and P.V walks whole groups of four queries up to nq, each group
//   count its own unrolled loop (a 16-wide predicated walk for one
//   decode query was several times slower on the card; a single loop
//   over the groups, each behind a branch, computed wrong sums on the
//   card for queries past the fourth in the float32 hD 32 instance,
//   which neither the group-count form nor a register cap does).
//
// tensor cores (flash_decode_tc_kernel), for prefill windows: more than
// 16 queries a kv head, bf16 q and bf16 K/V (what every prefill path
// passes), hD 32/64/128: the forward of flash_attention.cu's bf16 design
// with the flash_decode mask.  16-row warps, 64-key tiles, XOR-swizzled
// bf16 tiles staged by cp.async in a ring of two, mma.sync m16n8k16 bf16
// -> float32 through ldmatrix, P carried as two bf16 halves (the blocks
// live in tc_common.cuh).  Against that forward: the key offset is read
// on the device from pos[b], a row a query does not see gets p = 0
// (not the fully masked row's p = 1 there: every flash_decode query sees
// row 0), no lse, the q/k/v slices of the packed qkv are read in place,
// and tiles past the tile's last visible row are never loaded.
//
// query tiles on the CUDA cores (flash_decode_kernel, the first port's
// design, unchanged), for what no serving path passes: large windows in
// float32 or over int8/fp8 K/V, and hD 16.  One block of 128 threads per
// (16-query tile, head, slot) walks the visible rows in 32-row float32
// chunks and folds them into per-query online-softmax state.
//
// Left for later work: TMA and wgmma in the prefill instance, a decode
// instance that keeps more than two stages in flight, and CUDA-graph
// capture of the decode step (the plan never reads pos, so it captures).
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

#include "tc_common.cuh"

namespace {

// the query-tile kernel (float32, int8/fp8 K/V at large windows, hD 16)
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
  float* part_acc;        // split-KV partials (several splits only)
  float* part_ml;
  int B, W, T_len, nH, nKV, mb, bs, nb;
  int n_split, split_len; // split-KV plan
  long long qs_b, qs_w, qs_h;
  // slot (contiguous) or page (paged), row, head
  long long k0, k1, k2, v0, v1, v2;
  long long ks0, ks1, ks2, vs0, vs1, vs2;
  float scale;
};

// Row `row` of slot b as (slot or page, row within it), so that K, V
// and the scales, whose strides differ, can share one table lookup.
template <bool PAGED>
__device__ __forceinline__ void row_loc(const Args& a, int b, int row,
                                        long long& s0, long long& s1) {
  if (PAGED) {
    s0 = min(max(a.bt[static_cast<long long>(b) * a.mb + row / a.bs], 0),
             a.nb - 1);
    s1 = row % a.bs;
  } else {
    s0 = b;
    s1 = row;
  }
}

// Element offset of row `row` of slot `b` along the slot-or-page and
// row axes whose strides are s0 and s1.
template <bool PAGED>
__device__ __forceinline__ long long row_offset(const Args& a, int b, int row,
                                                long long s0, long long s1) {
  long long at0, at1;
  row_loc<PAGED>(a, b, row, at0, at1);
  return at0 * s0 + at1 * s1;
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

// ---------------------------------------------------------------------------
// Split-KV decode on the CUDA cores: one block per (KV split, kv head, slot)
// ---------------------------------------------------------------------------

constexpr int kSplitThreads = 128;  // 4 warps
constexpr int kSplitRows = 32;      // KV rows a stage (one per lane)
// ring depth: one stage in flight while one is read (on the card, three
// and four stages in flight were slower at the serving shapes: fewer
// blocks fit an SM)
constexpr int kSplitStages = 2;
constexpr int kMaxQ = 16;           // queries a block: nH/nKV heads x W
constexpr int kFewQ = 4;            // the instance for decode: <= 4

// One K or V value of any storage type, widened to float
__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float widen(int8_t x) {
  return static_cast<float>(x);
}
__device__ __forceinline__ float widen(__nv_fp8_e4m3 x) {
  // e4m3 -> half -> float, exact (NaN stays NaN), as Vec<fp8> widens
  return __half2float(__half(__nv_cvt_fp8_to_halfraw(x.__x, __NV_E4M3)));
}

// Layout of one staged K or V row of TKV: 16-byte chunks, chunk c of row
// r stored at c ^ (r & kSwz) so that eight rows read at one logical chunk
// fall in distinct bank groups; a row's score is split over kParts
// threads of a warp, kCPP chunks each.
template <typename TKV, int HD, int QM>
struct SplitCfg {
  static constexpr int kVN = 16 / static_cast<int>(sizeof(TKV));
  static constexpr int kCPR = HD / kVN;
  static constexpr int kSwz = (kCPR < 8 ? kCPR : 8) - 1;
  static constexpr int kParts = kCPR < 4 ? kCPR : 4;
  static constexpr int kCPP = kCPR / kParts;
  static constexpr int kRowsPerWarp = 32 / kParts;
  static constexpr int kGroups = kSplitThreads / HD;  // P.V row groups
  static constexpr int kStageBytes = kSplitRows * HD * sizeof(TKV);
  static constexpr int kRedBytes = kGroups * QM * HD * 4;
  static constexpr int kKvBytes = 2 * kSplitStages * kStageBytes > kRedBytes
                                      ? 2 * kSplitStages * kStageBytes
                                      : kRedBytes;
  // 16-byte copies of a stage's K (or V) and the passes of the block
  static constexpr int kCopies = kSplitRows * kCPR;
  static constexpr int kPasses = (kCopies + kSplitThreads - 1) / kSplitThreads;
  // K and V stages | scales [stages][2][rows] | q [QM][HD] | s/p
  // [QM][rows] | corr, l, m [QM]
  static constexpr int kSmemBytes =
      kKvBytes + 2 * kSplitStages * kSplitRows * 4 + QM * HD * 4
      + QM * kSplitRows * 4 + 3 * QM * 4;
};

template <typename TKV, int HD>
__device__ __forceinline__ int split_swz(int r, int c) {
  using Cfg = SplitCfg<TKV, HD, kMaxQ>;
  return r * Cfg::kCPR + (c ^ (r & Cfg::kSwz));
}

// Queries of a block: i = head_in_group * W + window index j.  Rows
// [s * split_len, (s + 1) * split_len) of slot b's cache, kv head g; a
// single split writes out, several write unnormalised partials that
// flash_decode_merge_kernel combines.
template <typename TQ, typename TKV, bool PAGED, int HD, int QM>
__global__ void __launch_bounds__(kSplitThreads)
flash_decode_split_kernel(const Args a) {
  using Cfg = SplitCfg<TKV, HD, QM>;
  constexpr bool kScaled = std::is_same<TKV, int8_t>::value;
  constexpr int VQ = Vec<TQ>::N;
  extern __shared__ __align__(16) unsigned char split_smem[];
  unsigned char* sKV = split_smem;                 // [2 stages][K | V]
  float* sScale = reinterpret_cast<float*>(split_smem + Cfg::kKvBytes);
  float* sQ = sScale + 2 * kSplitStages * kSplitRows;  // [QM][HD]
  float* sS = sQ + QM * HD;                        // [QM][kSplitRows]
  float* sCorr = sS + QM * kSplitRows;
  float* sL = sCorr + QM;
  float* sM = sL + QM;

  const int split = blockIdx.x;
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int W = a.W;
  const int rep = a.nH / a.nKV;
  const int nq = rep * W;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int p = a.pos[b];
  // last row any query of the slot sees, never past the cache
  const int n_rows = min(p + W - 1, a.T_len - 1) + 1;
  const int r_begin = split * a.split_len;
  const int r_end = min(r_begin + a.split_len, n_rows);
  const long long row_stride = static_cast<long long>(a.B) * W * a.nH;

  if (r_begin >= n_rows) {
    // nothing of this split is visible: an empty partial (acc = 0,
    // l = 0), which the merge weights by 0
    for (int x = tid; x < nq * HD; x += kSplitThreads) {
      const int i = x / HD;
      const long long o = (static_cast<long long>(b) * W + i % W) * a.nH
                          + g * rep + i / W;
      a.part_acc[(split * row_stride + o) * HD + x % HD] = 0.f;
      if (x % HD == 0) {
        a.part_ml[split * row_stride + o] = kNegInf;
        a.part_ml[(a.n_split + split) * row_stride + o] = 0.f;
      }
    }
    return;
  }

  const TKV* kb = static_cast<const TKV*>(a.k) + g * a.k2;
  const TKV* vb = static_cast<const TKV*>(a.v) + g * a.v2;
  const float* ksb = kScaled ? a.k_scale + g * a.ks2 : nullptr;
  const float* vsb = kScaled ? a.v_scale + g * a.vs2 : nullptr;

  // stage rows r0 .. r0 + kSplitRows - 1 (zeros at or past r_end)
  // stage rows r0 .. r0 + kSplitRows - 1 (zeros at or past r_end) into
  // ring slot st: every row's location first (the paged table reads of a
  // pass in flight together), then the copies
  auto load = [&](int r0, int st) {
    const uint32_t dk = smem_u32(sKV + (2 * st) * Cfg::kStageBytes);
    const uint32_t dv = smem_u32(sKV + (2 * st + 1) * Cfg::kStageBytes);
    long long s0[Cfg::kPasses];
    long long s1[Cfg::kPasses];
#pragma unroll
    for (int it = 0; it < Cfg::kPasses; ++it) {
      const int row = r0 + (tid + it * kSplitThreads) / Cfg::kCPR;
      row_loc<PAGED>(a, b, min(row, r_end - 1), s0[it], s1[it]);
    }
#pragma unroll
    for (int it = 0; it < Cfg::kPasses; ++it) {
      const int idx = tid + it * kSplitThreads;
      const int r = idx / Cfg::kCPR;
      const int c = idx % Cfg::kCPR;
      const bool ok = idx < Cfg::kCopies && r0 + r < r_end;
      if (idx < Cfg::kCopies) {
        const int at = split_swz<TKV, HD>(r, c) * 16;
        cp_async16(dk + at,
                   kb + (ok ? s0[it] * a.k0 + s1[it] * a.k1 : 0)
                       + c * Cfg::kVN,
                   ok);
        cp_async16(dv + at,
                   vb + (ok ? s0[it] * a.v0 + s1[it] * a.v1 : 0)
                       + c * Cfg::kVN,
                   ok);
      }
    }
    if (kScaled && tid < 2 * kSplitRows) {
      const int r = tid % kSplitRows;
      const bool ok = r0 + r < r_end;
      long long p0, p1;
      row_loc<PAGED>(a, b, min(r0 + r, r_end - 1), p0, p1);
      const float* src = tid < kSplitRows ? ksb + p0 * a.ks0 + p1 * a.ks1
                                          : vsb + p0 * a.vs0 + p1 * a.vs1;
      cp_async4(smem_u32(sScale + (2 * st + tid / kSplitRows) * kSplitRows
                         + r),
                ok ? src : (tid < kSplitRows ? ksb : vsb), ok);
    }
  };
  const int n_chunks = (r_end - r_begin + kSplitRows - 1) / kSplitRows;
#pragma unroll
  for (int ch = 0; ch < kSplitStages - 1; ++ch) {
    if (ch < n_chunks) load(r_begin + ch * kSplitRows, ch);
    cp_async_commit();
  }

  const TQ* qb = static_cast<const TQ*>(a.q) + b * a.qs_b;
  for (int idx = tid * VQ; idx < nq * HD; idx += kSplitThreads * VQ) {
    const int i = idx / HD;
    const int d = idx % HD;
    float t[VQ];
    Vec<TQ>::load(qb + (i % W) * a.qs_w + (g * rep + i / W) * a.qs_h + d, t);
#pragma unroll
    for (int e = 0; e < VQ; ++e) sQ[i * HD + d + e] = t[e] * a.scale;
  }
  // P.V reads whole groups of four score rows: the rows past nq are 0
  for (int x = nq * kSplitRows + tid; x < QM * kSplitRows;
       x += kSplitThreads)
    sS[x] = 0.f;

  float m_run[QM / 4];   // query warp + 4 k, kept by warp `warp`
  float l_run[QM / 4];
#pragma unroll
  for (int k = 0; k < QM / 4; ++k) {
    m_run[k] = kNegInf;
    l_run[k] = 0.f;
  }
  float acc[QM];
#pragma unroll
  for (int i = 0; i < QM; ++i) acc[i] = 0.f;
  const int d_pv = tid % HD;
  const int g_pv = tid / HD;
  // the score step: row r_s of the stage, part pt of its chunks
  const int r_s = warp * Cfg::kRowsPerWarp + lane % Cfg::kRowsPerWarp;
  const int pt = lane / Cfg::kRowsPerWarp;

  for (int ch = 0; ch < n_chunks; ++ch) {
    const int st = ch % kSplitStages;
    const int c0 = r_begin + ch * kSplitRows;
    // the slot of chunk ch - 1, free since the barrier that closed it
    if (ch + kSplitStages - 1 < n_chunks)
      load(c0 + (kSplitStages - 1) * kSplitRows,
           (ch + kSplitStages - 1) % kSplitStages);
    cp_async_commit();
    cp_async_wait<kSplitStages - 1>();   // this thread's copies of chunk ch
    __syncthreads();                     // and everyone's
    const TKV* sK =
        reinterpret_cast<const TKV*>(sKV + (2 * st) * Cfg::kStageBytes);
    const TKV* sV =
        reinterpret_cast<const TKV*>(sKV + (2 * st + 1) * Cfg::kStageBytes);
    const float* sSk = sScale + (2 * st) * kSplitRows;
    const float* sSv = sSk + kSplitRows;

    // scores s[i][r] = (scale_k[r]) * (q_i . k_r), q pre-scaled
    if (warp * Cfg::kRowsPerWarp < kSplitRows) {  // warp-uniform
      float kf[Cfg::kCPP * Cfg::kVN];
#pragma unroll
      for (int c = 0; c < Cfg::kCPP; ++c) {
        Vec<TKV>::load(sK + split_swz<TKV, HD>(r_s, pt * Cfg::kCPP + c)
                                * Cfg::kVN,
                       kf + c * Cfg::kVN);
      }
      const float sk = kScaled ? sSk[r_s] : 1.f;
      const float* qp = sQ + pt * Cfg::kCPP * Cfg::kVN;
      for (int i = 0; i < nq; ++i) {
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < Cfg::kCPP * Cfg::kVN; ++e)
          s += qp[i * HD + e] * kf[e];
#pragma unroll
        for (int o = Cfg::kRowsPerWarp; o < 32; o <<= 1)
          s += __shfl_xor_sync(0xffffffffu, s, o);
        if (pt == 0) sS[i * kSplitRows + r_s] = s * sk;
      }
    }
    __syncthreads();

    // online softmax: warp w owns queries w, w + 4, ...; lane = row
#pragma unroll
    for (int k = 0; k < QM / 4; ++k) {
      const int i = warp + 4 * k;
      if (i < nq) {  // warp-uniform
        const int row = c0 + lane;
        const bool ok = row < r_end && row <= p + i % W;
        const float s = ok ? sS[i * kSplitRows + lane] : kNegInf;
        float mx = s;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_new = fmaxf(m_run[k], mx);
        const float pr = ok ? expf(s - m_new) : 0.f;
        float sum = pr;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, o);
        const float corr = expf(m_run[k] - m_new);
        l_run[k] = l_run[k] * corr + sum;
        m_run[k] = m_new;
        // int8: P weighted by the row's V scale before P.V
        sS[i * kSplitRows + lane] = kScaled ? pr * sSv[lane] : pr;
        if (lane == 0) sCorr[i] = corr;
      }
    }
    __syncthreads();

    // P.V: thread owns column d_pv of rows g_pv, g_pv + kGroups, ...,
    // for the queries in whole groups of four up to nq (rows past nq are
    // zero), each group count its own unrolled loop: the work follows
    // nq, not QM
#pragma unroll
    for (int i = 0; i < QM; ++i)
      if (i < nq) acc[i] *= sCorr[i];
    switch ((nq + 3) >> 2) {
#define PT_FD_PV_GROUPS(NG)                                             \
      case NG:                                                         \
        if constexpr (4 * NG <= QM) {                                  \
          for (int r = g_pv; r < kSplitRows; r += Cfg::kGroups) {      \
            const float v = widen(                                     \
                sV[split_swz<TKV, HD>(r, d_pv / Cfg::kVN) * Cfg::kVN   \
                   + d_pv % Cfg::kVN]);                                \
            _Pragma("unroll")                                          \
            for (int i = 0; i < 4 * NG; ++i)                           \
              acc[i] += sS[i * kSplitRows + r] * v;                    \
          }                                                            \
        }                                                              \
        break;
      PT_FD_PV_GROUPS(1)
      PT_FD_PV_GROUPS(2)
      PT_FD_PV_GROUPS(3)
      PT_FD_PV_GROUPS(4)
#undef PT_FD_PV_GROUPS
      default:
        break;
    }
    __syncthreads();  // the stage is read by all before it is refilled
  }

  // the row groups' sums (the stages are free now)
  if (Cfg::kGroups > 1) {
    float* sRed = reinterpret_cast<float*>(sKV);
#pragma unroll
    for (int i = 0; i < QM; ++i)
      if (i < nq) sRed[(g_pv * QM + i) * HD + d_pv] = acc[i];
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < QM / 4; ++k) {
      const int i = warp + 4 * k;
      if (i < nq) {
        sL[i] = l_run[k];
        sM[i] = m_run[k];
      }
    }
  }
  __syncthreads();
  if (g_pv != 0) return;
  if (Cfg::kGroups > 1) {
    const float* sRed = reinterpret_cast<const float*>(sKV);
#pragma unroll
    for (int i = 0; i < QM; ++i) {
      if (i < nq) {
        float x = 0.f;
        for (int gr = 0; gr < Cfg::kGroups; ++gr)
          x += sRed[(gr * QM + i) * HD + d_pv];
        acc[i] = x;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < QM; ++i) {
    if (i < nq) {
      const long long o = (static_cast<long long>(b) * W + i % W) * a.nH
                          + g * rep + i / W;
      if (a.n_split == 1) {
        Vec<TQ>::store(static_cast<TQ*>(a.out) + o * HD + d_pv,
                       acc[i] / fmaxf(sL[i], 1e-30f));
      } else {
        a.part_acc[(split * row_stride + o) * HD + d_pv] = acc[i];
        if (d_pv == 0) {
          a.part_ml[split * row_stride + o] = sM[i];
          a.part_ml[(a.n_split + split) * row_stride + o] = sL[i];
        }
      }
    }
  }
}

constexpr int kMergeWarps = 4;

// out = sum_s e^{m_s - M} acc_s / max(sum_s e^{m_s - M} l_s, 1e-30), in
// split order; a split with l_s = 0 (nothing visible, acc_s = 0) adds
// nothing.  One warp per (slot, query, head) row; the splits' loads are
// independent, so several are in flight at once.
template <typename TQ, int HD>
__global__ void __launch_bounds__(32 * kMergeWarps)
flash_decode_merge_kernel(const Args a) {
  const long long rows = static_cast<long long>(a.B) * a.W * a.nH;
  const long long row = static_cast<long long>(blockIdx.x) * kMergeWarps
                        + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const float* pm = a.part_ml;
  const float* pl = a.part_ml + a.n_split * rows;
  float M = kNegInf;
#pragma unroll 8
  for (int s = 0; s < a.n_split; ++s) M = fmaxf(M, pm[s * rows + row]);
  constexpr int kPer = (HD + 31) / 32;
  float acc[kPer];
#pragma unroll
  for (int e = 0; e < kPer; ++e) acc[e] = 0.f;
  float den = 0.f;
#pragma unroll 8
  for (int s = 0; s < a.n_split; ++s) {
    const float l = pl[s * rows + row];
    const float w = l > 0.f ? expf(pm[s * rows + row] - M) : 0.f;
    den += w * l;
    const float* src = a.part_acc + (s * rows + row) * HD;
#pragma unroll
    for (int e = 0; e < kPer; ++e)
      if (lane + 32 * e < HD) acc[e] += w * src[lane + 32 * e];
  }
  TQ* out = static_cast<TQ*>(a.out) + row * HD;
#pragma unroll
  for (int e = 0; e < kPer; ++e)
    if (lane + 32 * e < HD)
      Vec<TQ>::store(out + lane + 32 * e, acc[e] / fmaxf(den, 1e-30f));
}

// ---------------------------------------------------------------------------
// Prefill on the tensor cores (bf16 q and K/V): flash_attention.cu's
// forward with the flash_decode mask
// ---------------------------------------------------------------------------

constexpr int kTcWarps = 4;   // 16 query rows a warp
constexpr int kTcBN = 64;     // keys a K/V tile

template <int HD>
constexpr int tc_smem_bytes() {
  return (16 * kTcWarps + 4 * kTcBN) * HD * 2;
}

// Stage rows row0 .. row0+ROWS-1 of slot b's cache (kv head base `base`)
// into a swizzled tile with cp.async; rows at or past n_rows are zeros.
template <int HD, int ROWS, bool PAGED>
__device__ __forceinline__ void stage_kv(bf16* dst, const bf16* base,
                                         const Args& a, int b, long long s0,
                                         long long s1, int row0, int n_rows) {
  constexpr int kCPR = HD / 8;
#pragma unroll
  for (int idx = threadIdx.x; idx < ROWS * kCPR; idx += 32 * kTcWarps) {
    const int r = idx / kCPR;
    const int c = idx % kCPR;
    const bool ok = row0 + r < n_rows;
    const bf16* src =
        ok ? base + row_offset<PAGED>(a, b, row0 + r, s0, s1) + c * 8 : base;
    cp_async16(smem_u32(dst + swz<HD>(r, c)), src, ok);
  }
}

template <int HD, bool PAGED>
__global__ void __launch_bounds__(32 * kTcWarps)
flash_decode_tc_kernel(const Args a) {
  constexpr int BM = 16 * kTcWarps;
  constexpr int NT = 32 * kTcWarps;
  constexpr int NJ = kTcBN / 8;  // n8 tiles of a score row
  constexpr int ND = HD / 8;     // n8 tiles of an output row
  extern __shared__ __align__(128) unsigned char tc_smem[];
  bf16* sQ = reinterpret_cast<bf16*>(tc_smem);
  bf16* sK = sQ + BM * HD;          // [2][kTcBN][HD]
  bf16* sV = sK + 2 * kTcBN * HD;   // [2][kTcBN][HD]

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BM;  // long tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int W = a.W;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2;
  const int t = lane & 3;
  const int w0 = q0 + warp * 16;
  const int p = a.pos[b];
  const int kvh = h / (a.nH / a.nKV);
  const bf16* kb = static_cast<const bf16*>(a.k) + kvh * a.k2;
  const bf16* vb = static_cast<const bf16*>(a.v) + kvh * a.v2;
  // keys the tile's queries see: rows <= p + q, below T
  const int k_end = min(a.T_len, p + min(q0 + BM, W));
  const int n_tiles = (k_end + kTcBN - 1) / kTcBN;

  {
    const bf16* qb = static_cast<const bf16*>(a.q) + b * a.qs_b + h * a.qs_h;
    constexpr int kCPR = HD / 8;
#pragma unroll
    for (int idx = threadIdx.x; idx < BM * kCPR; idx += NT) {
      const int r = idx / kCPR;
      const int c = idx % kCPR;
      const bool ok = q0 + r < W;
      cp_async16(smem_u32(sQ + swz<HD>(r, c)),
                 ok ? qb + (q0 + r) * a.qs_w + c * 8 : qb, ok);
    }
  }
  stage_kv<HD, kTcBN, PAGED>(sK, kb, a, b, a.k0, a.k1, 0, k_end);
  stage_kv<HD, kTcBN, PAGED>(sV, vb, a, b, a.v0, a.v1, 0, k_end);
  cp_async_commit();

  float o[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this lane's share of the row sums

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * kTcBN;
    if (it + 1 < n_tiles) {
      const int st = (it + 1) & 1;
      stage_kv<HD, kTcBN, PAGED>(sK + st * kTcBN * HD, kb, a, b, a.k0, a.k1,
                                 k0 + kTcBN, k_end);
      stage_kv<HD, kTcBN, PAGED>(sV + st * kTcBN * HD, vb, a, b, a.v0, a.v1,
                                 k0 + kTcBN, k_end);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* cK = sK + (it & 1) * kTcBN * HD;
    const bf16* cV = sV + (it & 1) * kTcBN * HD;
    // this warp's queries see no key of the tile: p = 0 on all of it
    if (k0 <= w0 + 15 + p) {
      float s[NJ][4];
      qk_tile<HD, NJ>(s, sQ, warp * 16, cK, 0, lane);
      const bool masked = k0 + kTcBN > k_end || k0 + kTcBN - 1 > w0 + p;
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = __fmul_rn(s[j][e], a.scale);
          if (masked) {
            const int qi = w0 + gq + ((e >> 1) << 3);
            const int kj = k0 + j * 8 + 2 * t + (e & 1);
            // not visible to this query: p = 0 exactly, as in the TPU
            // kernel (every query sees row 0, so m is finite)
            if (kj > qi + p || kj >= k_end) x = -INFINITY;
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
          const float pr = __expf(s[j][e] - m[e >> 1]);
          l[e >> 1] += pr;
          s[j][e] = pr;
        }
#pragma unroll
      for (int kc = 0; kc < kTcBN / 16; ++kc) {
        pv_step<HD>(o, s[2 * kc], s[2 * kc + 1], cV, kc * 16, lane);
      }
    }
    __syncthreads();  // the stage is read by all before it is refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = w0 + gq + 8 * r;
    const float lr = fmaxf(quad_sum(l[r]), 1e-30f);
    if (qi < W) {
      bf16* orow = static_cast<bf16*>(a.out)
                   + ((static_cast<long long>(b) * W + qi) * a.nH + h) * HD;
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        const __nv_bfloat162 pr =
            __floats2bfloat162_rn(o[j][2 * r] / lr, o[j][2 * r + 1] / lr);
        *reinterpret_cast<__nv_bfloat162*>(orow + j * 8 + 2 * t) = pr;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

enum Instance { kSimt = 0, kSplit = 1, kTc = 2 };

// the split kernel for at most QM queries a block
template <typename TQ, typename TKV, bool PAGED, int HD, int QM>
cudaError_t launch_split(const Args& a, cudaStream_t s) {
  constexpr int bytes = SplitCfg<TKV, HD, QM>::kSmemBytes;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_decode_split_kernel<TQ, TKV, PAGED, HD, QM>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  flash_decode_split_kernel<TQ, TKV, PAGED, HD, QM>
      <<<dim3(a.n_split, a.nKV, a.B), kSplitThreads, bytes, s>>>(a);
  return cudaGetLastError();
}

template <typename TQ, typename TKV, bool PAGED, int HD>
cudaError_t launch_instance(int instance, const Args& a, cudaStream_t s) {
  if (instance == kSimt) {
    const dim3 grid((a.W + kQTile - 1) / kQTile, a.nH, a.B);
    flash_decode_kernel<TQ, TKV, PAGED, HD><<<grid, kThreads, 0, s>>>(a);
    return cudaGetLastError();
  }
  if (instance == kSplit) {
    const bool few = a.nH / a.nKV * a.W <= kFewQ;
    cudaError_t err = few ? launch_split<TQ, TKV, PAGED, HD, kFewQ>(a, s)
                          : launch_split<TQ, TKV, PAGED, HD, kMaxQ>(a, s);
    if (err != cudaSuccess || a.n_split == 1) return err;
    const long long rows = static_cast<long long>(a.B) * a.W * a.nH;
    flash_decode_merge_kernel<TQ, HD>
        <<<static_cast<unsigned>((rows + kMergeWarps - 1) / kMergeWarps),
           32 * kMergeWarps, 0, s>>>(a);
    return cudaGetLastError();
  }
  if constexpr (std::is_same<TQ, bf16>::value
                && std::is_same<TKV, bf16>::value && HD >= 32) {
    if (instance == kTc) {
      constexpr int bytes = tc_smem_bytes<HD>();
      cudaError_t err = cudaFuncSetAttribute(
          flash_decode_tc_kernel<HD, PAGED>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
      if (err != cudaSuccess) return err;
      const dim3 grid((a.W + 16 * kTcWarps - 1) / (16 * kTcWarps), a.nH,
                      a.B);
      flash_decode_tc_kernel<HD, PAGED>
          <<<grid, 32 * kTcWarps, bytes, s>>>(a);
      return cudaGetLastError();
    }
  }
  return cudaErrorInvalidValue;
}

template <typename TQ, typename TKV, bool PAGED>
cudaError_t launch_hd(int hD, int instance, const Args& a, cudaStream_t s) {
  switch (hD) {
    case 16:
      return launch_instance<TQ, TKV, PAGED, 16>(instance, a, s);
    case 32:
      return launch_instance<TQ, TKV, PAGED, 32>(instance, a, s);
    case 64:
      return launch_instance<TQ, TKV, PAGED, 64>(instance, a, s);
    case 128:
      return launch_instance<TQ, TKV, PAGED, 128>(instance, a, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename TQ, typename TKV>
cudaError_t launch_layout(int hD, int instance, const Args& a,
                          cudaStream_t s) {
  return a.bt != nullptr ? launch_hd<TQ, TKV, true>(hD, instance, a, s)
                         : launch_hd<TQ, TKV, false>(hD, instance, a, s);
}

// kv_dtype: the query's own type code, 2 = int8 (+ scales), 3 = fp8 e4m3
template <typename TQ>
cudaError_t launch_kv(int q_code, int kv_dtype, int hD, int instance,
                      const Args& a, cudaStream_t s) {
  if (kv_dtype == q_code)
    return launch_layout<TQ, TQ>(hD, instance, a, s);
  if (kv_dtype == 2) {
    if (a.k_scale == nullptr || a.v_scale == nullptr)
      return cudaErrorInvalidValue;
    return launch_layout<TQ, int8_t>(hD, instance, a, s);
  }
  if (kv_dtype == 3)
    return launch_layout<TQ, __nv_fp8_e4m3>(hD, instance, a, s);
  return cudaErrorInvalidValue;
}

template <typename TKV, int QM>
int split_smem(int hD) {
  switch (hD) {
    case 16: return SplitCfg<TKV, 16, QM>::kSmemBytes;
    case 32: return SplitCfg<TKV, 32, QM>::kSmemBytes;
    case 64: return SplitCfg<TKV, 64, QM>::kSmemBytes;
    case 128: return SplitCfg<TKV, 128, QM>::kSmemBytes;
    default: return -1;
  }
}

template <typename TQ, typename TKV>
int smem_kv(int instance, int hD, int queries) {
  if (instance == kSimt) return 0;
  if (instance == kSplit) {
    return queries <= kFewQ ? split_smem<TKV, kFewQ>(hD)
                            : split_smem<TKV, kMaxQ>(hD);
  }
  if (instance == kTc && std::is_same<TQ, bf16>::value
      && std::is_same<TKV, bf16>::value) {
    switch (hD) {
      case 32: return tc_smem_bytes<32>();
      case 64: return tc_smem_bytes<64>();
      case 128: return tc_smem_bytes<128>();
      default: return -1;
    }
  }
  return -1;
}

}  // namespace

// instance: 0 = the CUDA-core query-tile kernel, 1 = split-KV (nH/nKV * W
// <= 16 queries a block; n_split splits of split_len rows, a multiple of
// 32; n_split > 1 needs part_acc [n_split, B, W, nH, hD] and part_ml [2,
// n_split, B, W, nH] float32 scratch), 2 = the tensor-core prefill kernel
// (bfloat16 q and K/V, hD 32/64/128).  q_dtype: 0 = float32, 1 =
// bfloat16 (q and out).  kv_dtype: the same code as q (a cache in the
// model dtype), 2 = int8 with float32 scales, 3 = float8_e4m3.
// block_tables == nullptr selects the contiguous layout (K/V [B, T, nKV,
// hD], axis-0 strides step slots); otherwise the paged one (K/V pools
// [nb, bs, nKV, hD], axis-0 strides step pages, block_tables [B, mb]
// contiguous int32, T_len = mb * bs).  Returns cudaGetLastError() after
// the last launch (split: the split kernel, then the merge), or
// cudaErrorInvalidValue for a combination that has no instance.
// Launches on `stream`, does not synchronise, allocates nothing.
extern "C" int pt_flash_decode(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* pos, const void* block_tables,
    void* out, void* part_acc, void* part_ml, int instance, int n_split,
    int split_len, int q_dtype, int kv_dtype, int B, int W, int T_len,
    int nH, int nKV, int hD, int mb, int bs, int nb, long long qs_b,
    long long qs_w, long long qs_h, long long k0, long long k1, long long k2,
    long long v0, long long v1, long long v2, long long ks0, long long ks1,
    long long ks2, long long vs0, long long vs1, long long vs2, float scale,
    void* stream) {
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.k_scale = static_cast<const float*>(k_scale);
  a.v_scale = static_cast<const float*>(v_scale);
  a.pos = static_cast<const int*>(pos);
  a.bt = static_cast<const int*>(block_tables);
  a.out = out;
  a.part_acc = static_cast<float*>(part_acc);
  a.part_ml = static_cast<float*>(part_ml);
  a.B = B;
  a.W = W;
  a.T_len = T_len;
  a.nH = nH;
  a.nKV = nKV;
  a.mb = mb;
  a.bs = bs;
  a.nb = nb;
  a.n_split = n_split;
  a.split_len = split_len;
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
  if (instance == kSplit
      && (nKV < 1 || nH % nKV || (nH / nKV) * W > kMaxQ || n_split < 1
          || split_len < 1 || split_len % kSplitRows
          || static_cast<long long>(n_split) * split_len < T_len
          || (n_split > 1 && (part_acc == nullptr || part_ml == nullptr)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (instance == kSplit && n_split == 1) a.part_ml = nullptr;
  cudaError_t err = cudaErrorInvalidValue;
  if (q_dtype == 0) {
    err = launch_kv<float>(0, kv_dtype, hD, instance, a, s);
  } else if (q_dtype == 1) {
    err = launch_kv<__nv_bfloat16>(1, kv_dtype, hD, instance, a, s);
  }
  return static_cast<int>(err);
}

// The dynamic shared memory (bytes) one block of `instance` takes at
// `queries` (nH/nKV * W) queries a kv head (0 for the query-tile kernel,
// whose shared memory is static), -1 for a combination with no instance.
extern "C" int pt_flash_decode_smem_bytes(int instance, int q_dtype,
                                          int kv_dtype, int hD, int queries) {
  if (q_dtype == 0) {
    if (kv_dtype == 0) return smem_kv<float, float>(instance, hD, queries);
    if (kv_dtype == 2) return smem_kv<float, int8_t>(instance, hD, queries);
    if (kv_dtype == 3)
      return smem_kv<float, __nv_fp8_e4m3>(instance, hD, queries);
  } else if (q_dtype == 1) {
    if (kv_dtype == 1) return smem_kv<bf16, bf16>(instance, hD, queries);
    if (kv_dtype == 2) return smem_kv<bf16, int8_t>(instance, hD, queries);
    if (kv_dtype == 3)
      return smem_kv<bf16, __nv_fp8_e4m3>(instance, hD, queries);
  }
  return -1;
}

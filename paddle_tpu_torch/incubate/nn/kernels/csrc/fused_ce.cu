// Fused vocabulary cross-entropy forward for Hopper (sm_90a).
//
// Replaces the TPU kernel paddle_tpu/incubate/nn/kernels/fused_ce.py
// ::_ce_fwd_kernel.  Same contract: h [N, H], W [V, H] (float32 or
// bfloat16, row-major), labels [N] int32 local ids; per row it writes
// z = logsumexp_v(h . W[v]) and picked = the logit at the label, 0 when
// the label lies outside [0, V).  Both outputs are float32, and the
// [N, V] logits never reach device memory.
//
// What bounds it on the H100: 2*N*V*H operations against reading h and
// W once (N*H + V*H elements), i.e. about N operations per byte of W.
// At the eval shape (N = 8192 tokens, V = 50304, H = 2048) that is some
// 1.7 TFLOP over 0.24 GB, so the operations bound it: about 1.7 ms at
// the bf16 tensor-core rate.
//
// The simple design, and what it does about that:
// * One block of 256 threads owns 64 rows of h and streams W in tiles
//   of 64 vocabulary rows; each tile's 64x64 logits accumulate in
//   float32 registers (a 4x4 micro-tile per thread: rows ty*4+i,
//   vocabulary columns tx+16*j) over H in chunks of 32 staged through
//   shared memory with 16-byte vector loads (the TPU kernel held the
//   whole H contraction in one VMEM tile).
// * After each vocabulary tile the online max, sum-exp and picked logit
//   of a row fold in registers; the 16 threads of a row are one
//   half-warp and reduce with shuffles.  The ragged vocabulary tail is
//   masked to -1e30 and can never be picked.
// * Products run on the CUDA cores in float32.
// Left for later work: tensor cores (mma.sync / wgmma) for the h.W^T
// tiles, keeping the h tile resident across vocabulary tiles, and a
// split over the vocabulary when N/64 blocks do not fill 132 SMs.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 256;        // 8 warps
constexpr int kTileN = 64;           // rows of h per block
constexpr int kTileV = 64;           // vocabulary rows per tile
constexpr int kChunk = 32;           // H elements per shared-memory stage
constexpr int kRows = 4;
constexpr int kCols = kTileV / 16;
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
};

// Stage columns c0 .. c0+kChunk-1 of rows row0 .. row0+63 of a [n, H]
// matrix into dst[64][kChunk+1] as float32; rows at or past n are zero.
template <typename T>
__device__ void load_chunk(float (*dst)[kChunk + 1], const T* src,
                           int row0, int n, int H, int c0) {
  constexpr int VN = Vec<T>::N;
  for (int idx = threadIdx.x; idx < kTileN * kChunk / VN; idx += kThreads) {
    const int r = idx / (kChunk / VN);
    const int d = (idx % (kChunk / VN)) * VN;
    float t[VN];
    if (row0 + r < n) {
      Vec<T>::load(src + static_cast<long long>(row0 + r) * H + c0 + d, t);
    } else {
#pragma unroll
      for (int i = 0; i < VN; ++i) t[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < VN; ++i) dst[r][d + i] = t[i];
  }
}

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_ce_fwd_kernel(const T* __restrict__ h, const T* __restrict__ w,
                    const int* __restrict__ labels, float* __restrict__ z,
                    float* __restrict__ picked, int N, int V, int H) {
  __shared__ float sH[kTileN][kChunk + 1];
  __shared__ float sW[kTileV][kChunk + 1];

  const int n0 = blockIdx.x * kTileN;
  const int lane = threadIdx.x & 31;
  const int tx = lane & 15;
  const int ty = (threadIdx.x >> 5) * 2 + (lane >> 4);

  float m[kRows];
  float sse[kRows];
  float pick[kRows];
  int lbl[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = n0 + ty * kRows + i;
    lbl[i] = row < N ? labels[row] : -1;
    m[i] = kNegInf;
    sse[i] = 0.f;
    pick[i] = 0.f;
  }

  for (int v0 = 0; v0 < V; v0 += kTileV) {
    float acc[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;
    for (int c0 = 0; c0 < H; c0 += kChunk) {
      __syncthreads();  // the previous chunk's readers are done
      load_chunk<T>(sH, h, n0, N, H, c0);
      load_chunk<T>(sW, w, v0, V, H, c0);
      __syncthreads();
#pragma unroll 8
      for (int d = 0; d < kChunk; ++d) {
        float av[kRows];
        float bv[kCols];
#pragma unroll
        for (int i = 0; i < kRows; ++i) av[i] = sH[ty * kRows + i][d];
#pragma unroll
        for (int j = 0; j < kCols; ++j) bv[j] = sW[tx + 16 * j][d];
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int j = 0; j < kCols; ++j)
            acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int vid = v0 + tx + 16 * j;
        const bool ok = vid < V;
        acc[i][j] = ok ? acc[i][j] : kNegInf;
        if (ok && vid == lbl[i]) pick[i] += acc[i][j];
        mx = fmaxf(mx, acc[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        sum += v0 + tx + 16 * j < V ? expf(acc[i][j] - m_new) : 0.f;
      sse[i] = sse[i] * expf(m[i] - m_new) + row_sum(sum);
      m[i] = m_new;
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const float p = row_sum(pick[i]);
    const int row = n0 + ty * kRows + i;
    if (tx == 0 && row < N) {
      z[row] = m[i] + logf(sse[i] == 0.f ? 1.f : sse[i]);
      picked[row] = p;
    }
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  h [N, H] and W [V, H] row-major
// with H a multiple of 32 and 16-byte aligned bases; labels [N] int32;
// z and picked [N] float32.  Launches on `stream`, does not synchronise,
// allocates nothing, returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for an unknown dtype).
extern "C" int pt_fused_ce_fwd(const void* h, const void* w,
                               const void* labels, void* z, void* picked,
                               int dtype, int N, int V, int H, void* stream) {
  if (N == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((N + kTileN - 1) / kTileN);
  const int* lbl = static_cast<const int*>(labels);
  float* zf = static_cast<float*>(z);
  float* pf = static_cast<float*>(picked);
  if (dtype == 0) {
    fused_ce_fwd_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(h), static_cast<const float*>(w), lbl, zf,
        pf, N, V, H);
  } else if (dtype == 1) {
    fused_ce_fwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(h),
        static_cast<const __nv_bfloat16*>(w), lbl, zf, pf, N, V, H);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

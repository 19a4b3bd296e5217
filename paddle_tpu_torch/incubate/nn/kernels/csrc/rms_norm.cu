// RMSNorm over the last axis for Hopper (sm_90a), in two rounding policies.
//
// Replaces the TPU kernel paddle_tpu/incubate/nn/kernels/fused_norm_rope.py
// ::_rms_fwd_kernel, reached through rms_norm_pallas (policy "fused"), and
// carries the XLA function paddle_tpu/models/llama.py::_rms_norm, which is
// no Pallas kernel but every RMSNorm of the LLaMA path (policy "llama").
// x [N, H] with a row stride and a contiguous last axis, w [H], both
// float32 or both bfloat16; out [N, H] contiguous in x's dtype.  "fused"
// also writes rstd [N] float32: the TPU kernel's [N, 128] rstd is a lane
// layout of the TPU, and its wrapper returns column 0.
//
// Rounding points (rms_norm_plain in fused_norm_rope.py keeps them, and a
// faster kernel must keep them too):
//  1. Both policies: ms = (sum over the row of float32(x)^2) / H, a
//     float32 sum in the kernel's own order and an IEEE division, then
//     rstd = rsqrtf(ms + eps) in float32.
//  2. "fused": out = T((float32(x) * rstd) * float32(w)): two float32
//     products, one rounding to T (the Pallas kernel's single rounding).
//  3. "llama": r = T(rstd); y = T(float32(x) * float32(r));
//     out = T(float32(y) * float32(w)): three roundings to T, as XLA
//     computes (x * rsqrt(var + eps).astype(x.dtype)) * g in x's dtype.
//     For T = float32 the two policies are one function.
//  4. __fmul_rn keeps nvcc from contracting a product into a neighbouring
//     add; every conversion to bfloat16 rounds to nearest even.
//
// What bounds it on the H100: bytes.  Each row of x is read once from
// device memory (the second pass finds it in L1/L2), out is written once
// and w, read by every row, stays in L2: about 2 * N * H * elem bytes
// (+ 4N for rstd) over 3.35 TB/s, 10 us at the prefill shape
// [2048, 4096] bf16.  At the decode shape [8, 4096] the work is 0.04 us,
// so the launch costs more than the work.
//
// Design: one block per row.  A thread reads 16 bytes at a time (8 bf16
// or 4 float32 values) where the row is 16-byte aligned, and the tail (H
// not a multiple of the vector width) or a misaligned row element by
// element.  The float32 sum of squares is reduced with warp shuffles,
// then across the block's warps through shared memory; one thread
// computes rstd, and every thread normalises its share of the row in a
// second pass.
// Left for later work: several rows per block at small H, and fusing the
// norm into the GEMM that consumes it (the decode shape is launch-bound).

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <cstdint>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kFused = 0;
constexpr int kLlama = 1;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
struct alignas(16) Vec16 {
  static constexpr int N = 16 / sizeof(T);
  T v[N];
};

// One normalised element under the policy (rounding points 2 and 3).
template <typename T, int kPolicy>
__device__ __forceinline__ T norm_one(float x, float rstd, float rstd_t,
                                      float w) {
  if (kPolicy == kFused) {
    return from_f<T>(__fmul_rn(__fmul_rn(x, rstd), w));
  }
  const float y = to_f(from_f<T>(__fmul_rn(x, rstd_t)));
  return from_f<T>(__fmul_rn(y, w));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, int kPolicy>
__global__ void __launch_bounds__(kMaxThreads)
rms_norm_kernel(const T* __restrict__ x, long long row_stride,
                const T* __restrict__ w, T* __restrict__ out,
                float* __restrict__ rstd_out, int H, float eps) {
  constexpr int V = Vec16<T>::N;
  const long long row = blockIdx.x;
  const T* xr = x + row * row_stride;
  T* orow = out + row * static_cast<long long>(H);
  const int tid = threadIdx.x;

  // pass 1: float32 sum of squares of the row
  const bool x_vec = (reinterpret_cast<uintptr_t>(xr) & 15) == 0;
  const int nx = x_vec ? H / V : 0;
  float ss = 0.f;
  for (int i = tid; i < nx; i += blockDim.x) {
    const Vec16<T> a = reinterpret_cast<const Vec16<T>*>(xr)[i];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float f = to_f(a.v[j]);
      ss = __fmaf_rn(f, f, ss);
    }
  }
  for (int i = nx * V + tid; i < H; i += blockDim.x) {
    const float f = to_f(xr[i]);
    ss = __fmaf_rn(f, f, ss);
  }
  __shared__ float warp_part[kMaxThreads / 32];
  __shared__ float row_rstd;
  ss = warp_sum(ss);
  const int lane = tid & 31, warp = tid >> 5;
  if (lane == 0) warp_part[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float t = lane < (blockDim.x >> 5) ? warp_part[lane] : 0.f;
    t = warp_sum(t);
    if (lane == 0) {
      const float ms = __fdiv_rn(t, static_cast<float>(H));
      const float r = rsqrtf(__fadd_rn(ms, eps));
      row_rstd = r;
      if (kPolicy == kFused) rstd_out[row] = r;
    }
  }
  __syncthreads();
  const float rstd = row_rstd;
  const float rstd_t = to_f(from_f<T>(rstd));   // "llama": rstd in T

  // pass 2: normalise and scale
  const bool all_vec = x_vec
      && (reinterpret_cast<uintptr_t>(orow) & 15) == 0
      && (reinterpret_cast<uintptr_t>(w) & 15) == 0;
  const int nv = all_vec ? H / V : 0;
  for (int i = tid; i < nv; i += blockDim.x) {
    const Vec16<T> a = reinterpret_cast<const Vec16<T>*>(xr)[i];
    const Vec16<T> g = reinterpret_cast<const Vec16<T>*>(w)[i];
    Vec16<T> o;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      o.v[j] = norm_one<T, kPolicy>(to_f(a.v[j]), rstd, rstd_t, to_f(g.v[j]));
    }
    reinterpret_cast<Vec16<T>*>(orow)[i] = o;
  }
  for (int i = nv * V + tid; i < H; i += blockDim.x) {
    orow[i] = norm_one<T, kPolicy>(to_f(xr[i]), rstd, rstd_t, to_f(w[i]));
  }
}

template <typename T>
int launch(const void* x, long long row_stride, const void* w, void* out,
           void* rstd, int policy, int N, int H, float eps,
           cudaStream_t s) {
  constexpr int V = Vec16<T>::N;
  const int per = (H + V - 1) / V;
  int threads = ((per + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > kMaxThreads ? kMaxThreads
                                                        : threads);
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  T* ot = static_cast<T*>(out);
  float* rt = static_cast<float*>(rstd);
  if (policy == kFused) {
    if (rt == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    rms_norm_kernel<T, kFused><<<N, threads, 0, s>>>(xt, row_stride, wt, ot,
                                                     rt, H, eps);
  } else if (policy == kLlama) {
    rms_norm_kernel<T, kLlama><<<N, threads, 0, s>>>(xt, row_stride, wt, ot,
                                                     nullptr, H, eps);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (x, w and out alike); policy: 0 "fused"
// (rstd [N] float32 written), 1 "llama" (rstd unused, may be null).
// row_stride in elements.  Returns the launch's CUDA error code.
extern "C" int pt_rms_norm(const void* x, long long row_stride,
                           const void* w, void* out, void* rstd, int dtype,
                           int policy, int N, int H, float eps,
                           void* stream) {
  if (N <= 0 || H <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float>(x, row_stride, w, out, rstd, policy, N, H, eps, s);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(x, row_stride, w, out, rstd, policy, N, H,
                                 eps, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// RMSNorm over the last axis for Hopper (sm_90a), in two rounding policies:
// the norm alone, the norm with the residual add before it fused in, and
// the backward of either as one pass over the rows.
//
// Replaces the TPU kernel paddle_tpu/incubate/nn/kernels/fused_norm_rope.py
// ::_rms_fwd_kernel, reached through rms_norm_pallas (policy "fused"), and
// carries the XLA function paddle_tpu/models/llama.py::_rms_norm, which is
// no Pallas kernel but every RMSNorm of the LLaMA path (policy "llama"),
// with the residual add that feeds it (h = h + delta in the JAX layer) and
// the gradient JAX's autodiff takes through it.
// Inputs [N, H] with a row stride and a contiguous last axis, w [H], all
// float32 or all bfloat16 (T); outputs [N, H] contiguous in T.  "fused"
// also writes rstd [N] float32: the TPU kernel's [N, 128] rstd is a lane
// layout of the TPU, and its wrapper returns column 0.
//
// Forward rounding points (rms_norm_plain and add_rms_norm_plain in
// fused_norm_rope.py keep them, and a faster kernel must keep them too):
//  0. The fused instance first forms s = T(h + delta): one float32 add
//     rounded to T, as torch's and XLA's T add rounds it; s is written
//     out and normalised below as x.
//  1. Both policies: ms = (sum over the row of float32(x)^2) / H, a
//     float32 sum in the kernel's own order and an IEEE division, then
//     rstd = rsqrtf(ms + eps) in float32.
//  2. "fused": out = T((float32(x) * rstd) * float32(w)): two float32
//     products, one rounding to T (the Pallas kernel's single rounding).
//  3. "llama": r = T(rstd); y = T(float32(x) * float32(r));
//     out = T(float32(y) * float32(w)): three roundings to T, as XLA
//     computes (x * rsqrt(var + eps).astype(x.dtype)) * g in x's dtype.
//     For T = float32 the two policies are one function.
//  4. __fmul_rn / __fadd_rn keep nvcc from contracting a product into a
//     neighbouring add; every conversion to bfloat16 rounds to nearest
//     even.
// The add instance and the plain one share the thread layout and the
// reduction, so for the same plan out is bit for bit the plain instance
// applied to s.
//
// Backward rounding points (rms_norm_bwd_plain: _llama_bwd / _fused_bwd),
// g the cotangent of out, g_s (optional) the cotangent of s:
//  "llama" (rstd recomputed from x as in 1: var = ms + eps, rf = rsqrtf(var),
//     r = T(rf)):
//     gy = T(g * w); the row sum dr = T(sum of float32(T(gy * x))), a
//     float32 sum rounded once to T; dvar = dr * (-0.5 * (rf / var)) and
//     c = dvar / H in float32 (IEEE divisions);
//     dx = T(T(gy * r) + T(c * (2 x)));  dx += g_s as T(dx + g_s);
//     dw = T(sum over rows of float32(T(g * T(x * r)))).
//  "fused" (rstd saved by the forward): xhat = x * rstd, dxhat = g * w and
//     m = (sum of dxhat * xhat) / H in float32;
//     dx = T(rstd * (dxhat - xhat * m));  dx += g_s as T(dx + g_s);
//     dw = T(sum over rows of g * xhat).
//  Only the order of the float32 sums differs from the plain version.
//  dw is summed without atomics: each row slot of each block keeps
//  float32 partials of its columns over the rows it visits, writes them
//  to a [slots, H] scratch, and a second kernel adds the slots in a fixed
//  order, so dw is the same on every run.
//
// What bounds it on the H100: bytes.  Forward: x read once, out written
// once (the fused instance: h and delta read, s and out written); w is
// read once per block.  [2048, 4096] bf16 moves 33.6 MB: 10 us at
// 3.35 TB/s; at the decode shape [8, 4096] the launch costs more than
// the work.  Backward: x, g (and g_s) read, dx written, [8192, 4096] bf16
// 192 MB (256 MB with g_s): 57 (77) us.
//
// Design: a row slot of `group` threads (a multiple of 32) holds one row
// in registers, VPT vectors of NV elements a thread (16-byte vectors
// where every row is 16-byte aligned and H a multiple of the width, else
// single elements), so x crosses device memory once between the sum of
// squares and the normalisation.  A slot takes the fewest vectors a
// thread that keep it within 256 threads (bf16 H 4096: 2 vectors, 256
// threads); a block holds threads / group slots (several rows a block
// when rows are short).  The grid is persistent: at most as many blocks
// as fit on the SMs at once walk the rows, and w is staged once a block
// in shared memory.  The forward stages w while its first row is in
// flight (or, in a separate instance for grids where no slot gets a
// second row, reads it into registers beside the row) and issues the
// loads of its next row before the barrier of the current one; the
// backward keeps its float32 dw partials in registers for the life of
// the block.  A slot of one warp sums with shuffles alone; a wider slot
// adds its warps' sums through shared memory (double-buffered: one
// barrier a row) by the same shuffle tree.  The bfloat16 roundings go
// two at a time through the packed conversion (cvt.rn.bf16x2.f32):
// conversions bound the backward's arithmetic.  The plan (VPT, group,
// threads, grid) comes from the wrapper (fused_norm_rope.rms_plan and
// _plan).  Measured and dropped (PERF.md): a cp.async ring of rows in
// shared memory, one warp a row at 16 vectors a thread.
// Left for later work: fusing the norm into the GEMMs that read it.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kMaxThreads = 512;
constexpr int kFused = 0;
constexpr int kLlama = 1;
constexpr int kInvalid = static_cast<int>(cudaErrorInvalidValue);

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

template <typename T, int NV>
struct alignas(sizeof(T) * NV) Pack {
  T v[NV];
};

// NV float32 values rounded to T (pairs of bfloat16 in one conversion)
template <typename T, int NV>
__device__ __forceinline__ Pack<T, NV> to_pack(const float (&t)[NV]) {
  Pack<T, NV> p;
  if constexpr (std::is_same<T, __nv_bfloat16>::value && NV % 2 == 0) {
#pragma unroll
    for (int j = 0; j < NV; j += 2) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(t[j], t[j + 1]);
      p.v[j] = h.x;
      p.v[j + 1] = h.y;
    }
  } else {
#pragma unroll
    for (int j = 0; j < NV; ++j) p.v[j] = from_f<T>(t[j]);
  }
  return p;
}

// t rounded to T in place (values stay float32)
template <typename T, int NV>
__device__ __forceinline__ void round_to(float (&t)[NV]) {
  const Pack<T, NV> p = to_pack<T, NV>(t);
#pragma unroll
  for (int j = 0; j < NV; ++j) t[j] = to_f(p.v[j]);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;   // every lane holds the same sum (each add commutes)
}

// The sums of K values over each row slot of `group` threads, in every
// thread of the slot.  `parity` alternates between rows so that one
// barrier a row suffices: a warp can only rewrite part[p] after every
// warp has passed the barrier of the row in between.  The warps' sums
// are added by the same shuffle tree as a warp's lanes (lanes past the
// slot's warps hold 0), so a slot of the one-row-a-block layout sums in
// the order of the kernel this one replaced: for the same thread layout
// (H 4096, as llama_7b runs it) the forward is bit for bit that kernel's.
template <int K>
__device__ __forceinline__ void group_sum(
    float (&v)[K], float (&part)[2][kMaxThreads / 32][K], int group,
    int parity) {
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = warp_sum(v[k]);
  if (group == 32) return;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) part[parity][warp][k] = v[k];
  }
  __syncthreads();
  const int nw = group >> 5, first = (threadIdx.x / group) * nw;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    v[k] = warp_sum(lane < nw ? part[parity][first + lane][k] : 0.f);
  }
}

extern __shared__ __align__(16) unsigned char smem_raw[];

// w [H / NV] Packs into shared memory, once a block
template <typename T, int NV>
__device__ __forceinline__ const Pack<T, NV>* stage_w(const T* w, int nvec) {
  using P = Pack<T, NV>;
  P* ws = reinterpret_cast<P*>(smem_raw);
  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    ws[i] = reinterpret_cast<const P*>(w)[i];
  }
  __syncthreads();
  return ws;
}

struct FwdArgs {
  const void* x;
  long long x_stride;
  const void* d;        // delta (the fused instance), else null
  long long d_stride;
  const void* w;
  void* s;              // s = T(x + delta) (the fused instance), else null
  void* out;
  float* rstd;          // "fused" only
  int N, H, group, threads, grid;
  float eps;
  cudaStream_t stream;
};

struct BwdArgs {
  const void* x;
  long long x_stride;
  const void* w;
  const void* g;
  long long g_stride;
  const void* gs;       // cotangent of s (the fused instance), else null
  long long gs_stride;
  const float* rstd;    // "fused": the forward's rstd
  void* dx;
  float* dw_part;       // [grid * threads / group, H] float32 scratch
  void* dw;
  int N, H, group, threads, grid;
  float eps;
  cudaStream_t stream;
};

// 16 vectors a thread take up to 256 threads a block (255 registers).
// kAdd: the fused residual-add instance (delta read, s written).
// kDirect: no row slot gets a second row (the decode rows; the host
// checks), so w goes straight into registers beside the row: staging it
// would cost a trip through shared memory and a barrier that no second
// row repays, and there is no next row to load.  A separate instance, so
// that the persistent one keeps its registers.
template <typename T, int kPolicy, int NV, int VPT, bool kAdd, bool kDirect>
__global__ void __launch_bounds__(VPT >= 16 ? 256 : kMaxThreads)
rms_norm_fwd_kernel(const T* __restrict__ x, long long x_stride,
                    const T* __restrict__ d, long long d_stride,
                    const T* __restrict__ w, T* __restrict__ s_out,
                    T* __restrict__ out, float* __restrict__ rstd_out,
                    int N, int H, int group, float eps) {
  using P = Pack<T, NV>;
  __shared__ float part[2][kMaxThreads / 32][1];
  const int rows = blockDim.x / group;
  const int slot = threadIdx.x / group;
  const int lt = threadIdx.x - slot * group;
  const int nvec = H / NV;
  const long long step = static_cast<long long>(gridDim.x) * rows;
  P xv[VPT], dv[VPT];
  // this slot's vectors of a row into (xv, dv), rows past N none
  auto load = [&](long long row, P (&a)[VPT], P (&b)[VPT]) {
    if (row < N) {
      const P* xr = reinterpret_cast<const P*>(x + row * x_stride);
      const P* dr = reinterpret_cast<const P*>(d + row * d_stride);
#pragma unroll
      for (int k = 0; k < VPT; ++k) {
        const int i = lt + k * group;
        if (i < nvec) {
          a[k] = xr[i];
          if constexpr (kAdd) b[k] = dr[i];
        }
      }
    }
  };
  long long row = static_cast<long long>(blockIdx.x) * rows + slot;
  load(row, xv, dv);      // the first row is in flight while w is staged
  P wv[kDirect ? VPT : 1];
  const P* ws = nullptr;
  if constexpr (kDirect) {
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int i = lt + k * group;
      if (i < nvec) wv[k] = reinterpret_cast<const P*>(w)[i];
    }
  } else {
    ws = stage_w<T, NV>(w, nvec);
  }
  int parity = 0;
  for (; row - slot < N; row += step, parity ^= 1) {
    const bool live = row < N;
    float ss[1] = {0.f};
    if (live) {
      if constexpr (kAdd) {    // rounding point 0
        P* sr = reinterpret_cast<P*>(s_out + row * static_cast<long long>(H));
#pragma unroll
        for (int k = 0; k < VPT; ++k) {
          const int i = lt + k * group;
          if (i < nvec) {
            float t[NV];
#pragma unroll
            for (int j = 0; j < NV; ++j) {
              t[j] = __fadd_rn(to_f(xv[k].v[j]), to_f(dv[k].v[j]));
            }
            xv[k] = to_pack<T, NV>(t);
            sr[i] = xv[k];
          }
        }
      }
#pragma unroll
      for (int k = 0; k < VPT; ++k) {
        if (lt + k * group < nvec) {
#pragma unroll
          for (int j = 0; j < NV; ++j) {
            const float f = to_f(xv[k].v[j]);
            ss[0] = __fmaf_rn(f, f, ss[0]);
          }
        }
      }
    }
    P nx[VPT], nd[VPT];        // the next row's loads fly meanwhile
    if constexpr (!kDirect) load(row + step, nx, nd);
    group_sum<1>(ss, part, group, parity);
    if (live) {
      const float r = rsqrtf(__fadd_rn(__fdiv_rn(ss[0],
                                                  static_cast<float>(H)),
                                       eps));
      if (kPolicy == kFused && lt == 0) rstd_out[row] = r;
      const float r_t = to_f(from_f<T>(r));
      P* orow = reinterpret_cast<P*>(out + row * static_cast<long long>(H));
#pragma unroll
      for (int k = 0; k < VPT; ++k) {
        const int i = lt + k * group;
        if (i < nvec) {
          P wk;
          if constexpr (kDirect) {
            wk = wv[k];
          } else {
            wk = ws[i];
          }
          float t[NV];
          if (kPolicy == kFused) {          // rounding point 2
#pragma unroll
            for (int j = 0; j < NV; ++j) {
              t[j] = __fmul_rn(__fmul_rn(to_f(xv[k].v[j]), r),
                               to_f(wk.v[j]));
            }
          } else {                          // rounding point 3
#pragma unroll
            for (int j = 0; j < NV; ++j) {
              t[j] = __fmul_rn(to_f(xv[k].v[j]), r_t);
            }
            round_to<T, NV>(t);
#pragma unroll
            for (int j = 0; j < NV; ++j) t[j] = __fmul_rn(t[j], to_f(wk.v[j]));
          }
          orow[i] = to_pack<T, NV>(t);
        }
      }
    }
    if constexpr (!kDirect) {
#pragma unroll
      for (int k = 0; k < VPT; ++k) {
        xv[k] = nx[k];
        dv[k] = nd[k];
      }
    }
  }
}

// kResidual: g_s is read and added to dx.
template <typename T, int kPolicy, int NV, int VPT, bool kResidual>
__global__ void __launch_bounds__(kMaxThreads)
rms_norm_bwd_kernel(const T* __restrict__ x, long long x_stride,
                    const T* __restrict__ w,
                    const T* __restrict__ g, long long g_stride,
                    const T* __restrict__ gs, long long gs_stride,
                    const float* __restrict__ rstd_in,
                    T* __restrict__ dx, float* __restrict__ dw_part,
                    int N, int H, int group, float eps) {
  using P = Pack<T, NV>;
  __shared__ float part[2][kMaxThreads / 32][2];
  const int rows = blockDim.x / group;
  const int slot = threadIdx.x / group;
  const int lt = threadIdx.x - slot * group;
  const int nvec = H / NV;
  const float hf = static_cast<float>(H);
  const P* ws = stage_w<T, NV>(w, nvec);
  float acc[VPT][NV];
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
#pragma unroll
    for (int j = 0; j < NV; ++j) acc[k][j] = 0.f;
  }
  const long long step = static_cast<long long>(gridDim.x) * rows;
  int parity = 0;
  for (long long row = static_cast<long long>(blockIdx.x) * rows + slot;
       row - slot < N; row += step, parity ^= 1) {
    const bool live = row < N;
    // gv: g, then ("llama") gy = T(g w), g being read again for dw
    P xv[VPT], gv[VPT], yv[VPT], sv[VPT];
    // llama: (sum x^2, sum T(gy x)); fused: (unused, sum dxhat xhat)
    float v[2] = {0.f, 0.f};
    float r = 0.f;
    if (live) {
      if (kPolicy == kFused) r = rstd_in[row];
      const P* xr = reinterpret_cast<const P*>(x + row * x_stride);
      const P* gr = reinterpret_cast<const P*>(g + row * g_stride);
      const P* sr = reinterpret_cast<const P*>(gs + row * gs_stride);
#pragma unroll
      for (int k = 0; k < VPT; ++k) {
        const int i = lt + k * group;
        if (i < nvec) {
          xv[k] = xr[i];
          gv[k] = gr[i];
          if constexpr (kResidual) sv[k] = sr[i];
        }
      }
#pragma unroll
      for (int k = 0; k < VPT; ++k) {
        const int i = lt + k * group;
        if (i < nvec) {
          const P wv = ws[i];
          float t[NV];
          if (kPolicy == kLlama) {
#pragma unroll
            for (int j = 0; j < NV; ++j) {
              t[j] = __fmul_rn(to_f(gv[k].v[j]), to_f(wv.v[j]));
            }
            yv[k] = to_pack<T, NV>(t);                 // gy
#pragma unroll
            for (int j = 0; j < NV; ++j) {
              const float xf = to_f(xv[k].v[j]);
              v[0] = __fmaf_rn(xf, xf, v[0]);
              t[j] = __fmul_rn(to_f(yv[k].v[j]), xf);
            }
            round_to<T, NV>(t);
#pragma unroll
            for (int j = 0; j < NV; ++j) v[1] = __fadd_rn(v[1], t[j]);
          } else {
#pragma unroll
            for (int j = 0; j < NV; ++j) {
              v[1] = __fadd_rn(v[1], __fmul_rn(
                  __fmul_rn(to_f(gv[k].v[j]), to_f(wv.v[j])),
                  __fmul_rn(to_f(xv[k].v[j]), r)));
            }
          }
        }
      }
    }
    group_sum<2>(v, part, group, parity);
    if (live) {
      P* dxr = reinterpret_cast<P*>(dx + row * static_cast<long long>(H));
      if (kPolicy == kLlama) {
        const float var = __fadd_rn(__fdiv_rn(v[0], hf), eps);
        const float rf = rsqrtf(var);
        const float r_t = to_f(from_f<T>(rf));
        const float dr = to_f(from_f<T>(v[1]));
        const float dvar = __fmul_rn(dr, __fmul_rn(-0.5f,
                                                   __fdiv_rn(rf, var)));
        const float c = __fdiv_rn(dvar, hf);
#pragma unroll
        for (int k = 0; k < VPT; ++k) {
          const int i = lt + k * group;
          if (i < nvec) {
            float a[NV], b[NV];
#pragma unroll
            for (int j = 0; j < NV; ++j) {
              a[j] = __fmul_rn(to_f(yv[k].v[j]), r_t);
              b[j] = __fmul_rn(c, __fmul_rn(2.f, to_f(xv[k].v[j])));
            }
            round_to<T, NV>(a);
            round_to<T, NV>(b);
#pragma unroll
            for (int j = 0; j < NV; ++j) a[j] = __fadd_rn(a[j], b[j]);
            if constexpr (kResidual) {
              round_to<T, NV>(a);
#pragma unroll
              for (int j = 0; j < NV; ++j) {
                a[j] = __fadd_rn(a[j], to_f(sv[k].v[j]));
              }
            }
            dxr[i] = to_pack<T, NV>(a);
            // dw: T(g * T(x * r))
#pragma unroll
            for (int j = 0; j < NV; ++j) {
              b[j] = __fmul_rn(to_f(xv[k].v[j]), r_t);
            }
            round_to<T, NV>(b);
#pragma unroll
            for (int j = 0; j < NV; ++j) {
              b[j] = __fmul_rn(to_f(gv[k].v[j]), b[j]);
            }
            round_to<T, NV>(b);
#pragma unroll
            for (int j = 0; j < NV; ++j) {
              acc[k][j] = __fadd_rn(acc[k][j], b[j]);
            }
          }
        }
      } else {
        const float m = __fdiv_rn(v[1], hf);
#pragma unroll
        for (int k = 0; k < VPT; ++k) {
          const int i = lt + k * group;
          if (i < nvec) {
            const P wv = ws[i];
            float a[NV];
#pragma unroll
            for (int j = 0; j < NV; ++j) {
              const float gf = to_f(gv[k].v[j]);
              const float xhat = __fmul_rn(to_f(xv[k].v[j]), r);
              const float dxhat = __fmul_rn(gf, to_f(wv.v[j]));
              a[j] = __fmul_rn(r, __fsub_rn(dxhat, __fmul_rn(xhat, m)));
              acc[k][j] = __fadd_rn(acc[k][j], __fmul_rn(gf, xhat));
            }
            if constexpr (kResidual) {
              round_to<T, NV>(a);
#pragma unroll
              for (int j = 0; j < NV; ++j) {
                a[j] = __fadd_rn(a[j], to_f(sv[k].v[j]));
              }
            }
            dxr[i] = to_pack<T, NV>(a);
          }
        }
      }
    }
  }
  // this slot's dw partials: row blockIdx.x * rows + slot of the scratch
  float* pr = dw_part + (static_cast<long long>(blockIdx.x) * rows + slot)
      * static_cast<long long>(H);
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int i = lt + k * group;
    if (i < nvec) {
#pragma unroll
      for (int j = 0; j < NV; ++j) pr[i * NV + j] = acc[k][j];
    }
  }
}

// dw[c] = T(sum over the slots' partials of column c), in a fixed order:
// thread (tx, ty) of a 32 x 8 block sums slots ty, ty + 8, ... of column
// blockIdx.x * 32 + tx, and ty = 0 adds the eight sums in order.
template <typename T>
__global__ void __launch_bounds__(256)
rms_norm_dw_kernel(const float* __restrict__ part, int slots, int H,
                   T* __restrict__ dw) {
  __shared__ float sums[8][33];
  const int col = blockIdx.x * 32 + threadIdx.x;
  float t = 0.f;
  if (col < H) {
    for (int p = threadIdx.y; p < slots; p += 8) {
      t += part[static_cast<long long>(p) * H + col];
    }
  }
  sums[threadIdx.y][threadIdx.x] = t;
  __syncthreads();
  if (threadIdx.y == 0 && col < H) {
    float u = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) u += sums[i][threadIdx.x];
    dw[col] = from_f<T>(u);
  }
}

// The bytes of w staged in shared memory, and the attribute that allows
// them past the default (set once per instance and size).
inline int w_bytes(int H, int dtype) {
  return ((H * (dtype == 0 ? 4 : 2) + 15) / 16) * 16;
}

inline int allow_smem(const void* fn, int bytes, int* allowed) {
  if (bytes <= *allowed) return 0;
  const int rc = static_cast<int>(cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
  if (rc == 0) *allowed = bytes;
  return rc;
}

template <typename T, int kPolicy, int NV, int VPT>
struct FwdOp {
  // fn and allow: the persistent instance (w staged), whose occupancy
  // sizes the grid
  template <bool kAdd>
  static const void* fn() {
    return reinterpret_cast<const void*>(
        rms_norm_fwd_kernel<T, kPolicy, NV, VPT, kAdd, false>);
  }
  template <bool kAdd>
  static int allow(int bytes) {
    static int allowed = 0;
    return allow_smem(fn<kAdd>(), bytes, &allowed);
  }
  template <bool kAdd, bool kDirect>
  static int launch(const FwdArgs& a, int smem) {
    if constexpr (!kDirect) {
      const int rc = allow<kAdd>(smem);
      if (rc != 0) return rc;
    }
    rms_norm_fwd_kernel<T, kPolicy, NV, VPT, kAdd, kDirect>
        <<<a.grid, a.threads, kDirect ? 0 : smem, a.stream>>>(
            static_cast<const T*>(a.x), a.x_stride,
            static_cast<const T*>(a.d), a.d_stride,
            static_cast<const T*>(a.w), static_cast<T*>(a.s),
            static_cast<T*>(a.out), a.rstd, a.N, a.H, a.group, a.eps);
    return static_cast<int>(cudaGetLastError());
  }
  // the direct instance where every row slot gets one row at most, for
  // short rows only (VPT <= 4: the wider ones have no registers to spare)
  template <bool kAdd>
  static int pick(const FwdArgs& a, int smem) {
    if constexpr (VPT <= 4) {
      if (static_cast<long long>(a.grid) * (a.threads / a.group) >= a.N) {
        return launch<kAdd, true>(a, smem);
      }
    }
    return launch<kAdd, false>(a, smem);
  }
  static int run(const FwdArgs& a, int smem) {
    return a.d != nullptr ? pick<true>(a, smem) : pick<false>(a, smem);
  }
};

template <typename T, int kPolicy, int NV, int VPT>
struct BwdOp {
  template <bool kResidual>
  static const void* fn() {
    return reinterpret_cast<const void*>(
        rms_norm_bwd_kernel<T, kPolicy, NV, VPT, kResidual>);
  }
  template <bool kResidual>
  static int allow(int bytes) {
    static int allowed = 0;
    return allow_smem(fn<kResidual>(), bytes, &allowed);
  }
  template <bool kResidual>
  static int launch(const BwdArgs& a, int smem) {
    int rc = allow<kResidual>(smem);
    if (rc != 0) return rc;
    rms_norm_bwd_kernel<T, kPolicy, NV, VPT, kResidual>
        <<<a.grid, a.threads, smem, a.stream>>>(
            static_cast<const T*>(a.x), a.x_stride,
            static_cast<const T*>(a.w), static_cast<const T*>(a.g),
            a.g_stride, static_cast<const T*>(a.gs), a.gs_stride, a.rstd,
            static_cast<T*>(a.dx), a.dw_part, a.N, a.H, a.group, a.eps);
    rc = static_cast<int>(cudaGetLastError());
    if (rc != 0) return rc;
    const int slots = a.grid * (a.threads / a.group);
    rms_norm_dw_kernel<T><<<(a.H + 31) / 32, dim3(32, 8), 0, a.stream>>>(
        a.dw_part, slots, a.H, static_cast<T*>(a.dw));
    return static_cast<int>(cudaGetLastError());
  }
  static int run(const BwdArgs& a, int smem) {
    return a.gs != nullptr ? launch<true>(a, smem) : launch<false>(a, smem);
  }
};

// kind: bit 0 the backward, bit 1 the residual instance (the forward's
// fused add, the backward's g_s)
struct OccArgs {
  int kind;
  int threads;
  int* blocks;
};

template <typename T, int kPolicy, int NV, int VPT>
struct OccOp {
  template <class Op, bool kResidual>
  static int query(const OccArgs& a, int smem) {
    const int rc = Op::template allow<kResidual>(smem);
    if (rc != 0) return rc;
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        a.blocks, Op::template fn<kResidual>(), a.threads, smem));
  }
  static int run(const OccArgs& a, int smem) {
    using F = FwdOp<T, kPolicy, NV, VPT>;
    using B = BwdOp<T, kPolicy, NV, VPT>;
    switch (a.kind) {
      case 0: return query<F, false>(a, smem);
      case 2: return query<F, true>(a, smem);
      case 1:
        if constexpr (VPT <= 8) return query<B, false>(a, smem);
        return kInvalid;
      case 3:
        if constexpr (VPT <= 8) return query<B, true>(a, smem);
        return kInvalid;
      default: return kInvalid;
    }
  }
};

template <template <typename, int, int, int> class Op, int kMaxVpt,
          typename T, int kP, int NV, typename A>
int by_vpt(int vpt, const A& a, int smem) {
  switch (vpt) {
    case 1: return Op<T, kP, NV, 1>::run(a, smem);
    case 2: return Op<T, kP, NV, 2>::run(a, smem);
    case 4: return Op<T, kP, NV, 4>::run(a, smem);
    case 8: return Op<T, kP, NV, 8>::run(a, smem);
    case 16:
      if constexpr (kMaxVpt >= 16) return Op<T, kP, NV, 16>::run(a, smem);
      return kInvalid;
    default: return kInvalid;
  }
}

template <template <typename, int, int, int> class Op, int kMaxVpt,
          typename T, int kP, typename A>
int by_width(int wide, int vpt, const A& a, int smem) {
  return wide ? by_vpt<Op, kMaxVpt, T, kP,
                       static_cast<int>(16 / sizeof(T))>(vpt, a, smem)
              : by_vpt<Op, kMaxVpt, T, kP, 1>(vpt, a, smem);
}

template <template <typename, int, int, int> class Op, int kMaxVpt,
          typename T, typename A>
int by_policy(int policy, int wide, int vpt, const A& a, int smem) {
  if (policy == kFused) {
    return by_width<Op, kMaxVpt, T, kFused>(wide, vpt, a, smem);
  }
  if (policy == kLlama) {
    return by_width<Op, kMaxVpt, T, kLlama>(wide, vpt, a, smem);
  }
  return kInvalid;
}

// the forward takes up to 16 vectors a thread, the backward (dw partials
// in registers) up to 8
template <template <typename, int, int, int> class Op, int kMaxVpt,
          typename A>
int dispatch(int dtype, int policy, int wide, int vpt, const A& a,
             int smem) {
  if (dtype == 0) {
    return by_policy<Op, kMaxVpt, float>(policy, wide, vpt, a, smem);
  }
  if (dtype == 1) {
    return by_policy<Op, kMaxVpt, __nv_bfloat16>(policy, wide, vpt, a, smem);
  }
  return kInvalid;
}

bool plan_ok(int H, int wide, int dtype, int vpt, int group, int threads,
             int grid) {
  const int nv = wide ? (dtype == 0 ? 4 : 8) : 1;
  if (group < 32 || group % 32 || threads < group || threads % group
      || threads > (vpt >= 16 ? 256 : kMaxThreads) || grid < 1 || H % nv) {
    return false;
  }
  return static_cast<long long>(group) * vpt * nv >= H;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (every tensor alike); policy: 0 "fused"
// (rstd [N] float32 written), 1 "llama" (rstd unused, may be null).
// delta and s both null: the norm alone; both given: the fused residual
// add (s = T(x + delta) written).  wide: 1 if every row and w are
// 16-byte aligned and H a multiple of 16 bytes (16-byte vectors), else 0.
// vpt (1, 2, 4, 8, 16), group, threads and grid: the plan of
// fused_norm_rope._plan.  Strides in elements.  Returns the launch's CUDA
// error code.
extern "C" int pt_rms_norm_fwd(const void* x, long long x_stride,
                               const void* delta, long long d_stride,
                               const void* w, void* s, void* out, void* rstd,
                               int dtype, int policy, int wide, int vpt,
                               int group, int threads, int grid, int N, int H,
                               float eps, void* stream) {
  if (N <= 0 || H <= 0) return 0;
  if (!plan_ok(H, wide, dtype, vpt, group, threads, grid)
      || (delta == nullptr) != (s == nullptr)
      || (policy == kFused && rstd == nullptr)) {
    return kInvalid;
  }
  const FwdArgs a{x, x_stride, delta, d_stride, w, s, out,
                  static_cast<float*>(rstd), N, H, group, threads, grid, eps,
                  static_cast<cudaStream_t>(stream)};
  return dispatch<FwdOp, 16>(dtype, policy, wide, vpt, a, w_bytes(H, dtype));
}

// The backward of either instance: dx (+ g_s when gs is given) and dw,
// through dw_part, a float32 scratch of grid * (threads / group) rows of
// H.  rstd: "fused" only, the forward's.  Two launches, the second
// adding the partials.
extern "C" int pt_rms_norm_bwd(const void* x, long long x_stride,
                               const void* w, const void* g,
                               long long g_stride, const void* gs,
                               long long gs_stride, const void* rstd,
                               void* dx, void* dw_part, void* dw, int dtype,
                               int policy, int wide, int vpt, int group,
                               int threads, int grid, int N, int H, float eps,
                               void* stream) {
  if (N <= 0 || H <= 0) return 0;
  if (!plan_ok(H, wide, dtype, vpt, group, threads, grid)
      || (policy == kFused && rstd == nullptr)) {
    return kInvalid;
  }
  const BwdArgs a{x, x_stride, w, g, g_stride, gs, gs_stride,
                  static_cast<const float*>(rstd), dx,
                  static_cast<float*>(dw_part), dw, N, H, group, threads,
                  grid, eps, static_cast<cudaStream_t>(stream)};
  return dispatch<BwdOp, 8>(dtype, policy, wide, vpt, a, w_bytes(H, dtype));
}

// Blocks of `threads` threads of one instance that fit on an SM at once,
// with w staged in shared memory, written to *blocks.  kind: bit 0 the
// backward, bit 1 the residual instance (the forward's fused add, the
// backward with g_s).
extern "C" int pt_rms_norm_blocks_per_sm(int kind, int dtype, int policy,
                                         int wide, int vpt, int threads,
                                         int H, int* blocks) {
  const OccArgs a{kind, threads, blocks};
  return dispatch<OccOp, 16>(dtype, policy, wide, vpt, a, w_bytes(H, dtype));
}

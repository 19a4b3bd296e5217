// Tensor-core building blocks for Hopper (sm_90a) shared by the
// hand-written kernels of this directory: flash_attention.cu's bf16
// kernels, flash_decode.cu's prefill instance and fused_ce.cu.
//
// * cp.async 16- and 4-byte copies global -> shared (src-size 0 writes
//   zeros and reads nothing), commit and wait;
// * ldmatrix (plain and .trans) and mma.sync.m16n8k16 with bf16 operands
//   and float32 accumulators;
// * the XOR swizzle of a [rows][HD] bf16 tile (16-byte chunk c of row r
//   at c ^ (r mod 8); hD 32: c ^ (r/2 mod 4)) and the ldmatrix addresses
//   of A and B fragments in it;
// * qk_tile (a 16-row score tile), pv_step (P.V with P as two bf16
//   halves, hi and lo) and the quad reductions over the four lanes that
//   share an accumulator row.
//
// Accumulator element e of n8 tile j sits at row g + 8 (e / 2), column
// 8 j + 2 t + e % 2 (g = lane / 4, t = lane % 4).
//
// Everything here is inline and lives in the including file's anonymous
// namespace; the build key of every kernel library covers this header.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src-size 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c (16x8, float32) += a (16x16, bf16, row) * b (16x8, bf16, col)
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16 (nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragment of a 16x16 product from two 16x8 accumulator tiles
// (columns 0-7 and 8-15), rounded to bf16.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                         const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// Element offset of 16-byte chunk c of row r in a swizzled [rows][HD] bf16
// tile: chunk c of row r sits at c ^ (r mod 8) (hD 32, four chunks a row:
// c ^ (r/2 mod 4)), so the eight rows one ldmatrix reads at one logical
// chunk fall in eight distinct bank groups.
template <int HD>
__device__ __forceinline__ int swz(int r, int c) {
  if constexpr (HD >= 64) {
    return r * HD + ((c ^ (r & 7)) << 3);
  } else {
    return r * HD + ((c ^ ((r >> 1) & 3)) << 3);
  }
}

// ldmatrix addresses.  A operand (16 rows x 16 columns at (r0, chunk c0)),
// or a B operand stored [k][n] read with .trans (16 k rows x two n8
// tiles): lane l reads row r0 + l % 16, chunk c0 + l / 16.
template <int HD>
__device__ __forceinline__ uint32_t a_addr(const bf16* t, int r0, int c0,
                                           int lane) {
  return smem_u32(t + swz<HD>(r0 + (lane & 15), c0 + (lane >> 4)));
}

// B operand stored [n][k] (two n8 tiles at row n0, 16 k at chunk c0):
// lane l reads row n0 + l % 8 + 8 (l / 16), chunk c0 + (l / 8) % 2.
template <int HD>
__device__ __forceinline__ uint32_t b_addr(const bf16* t, int n0, int c0,
                                           int lane) {
  return smem_u32(t + swz<HD>(n0 + (lane & 7) + ((lane >> 4) << 3),
                              c0 + ((lane >> 3) & 1)));
}

// s (16 x 8*NJ) = A (16 rows of sA at r0) * B^T (8*NJ rows of sB at n0),
// contracted over HD.
template <int HD, int NJ>
__device__ __forceinline__ void qk_tile(float (&s)[NJ][4], const bf16* sA,
                                        int r0, const bf16* sB, int n0,
                                        int lane) {
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, a_addr<HD>(sA, r0, kk * 2, lane));
#pragma unroll
    for (int j = 0; j < NJ / 2; ++j) {
      uint32_t b[4];
      ldsm_x4(b, b_addr<HD>(sB, n0 + j * 16, kk * 2, lane));
      mma(s[2 * j], a, b[0], b[1]);
      mma(s[2 * j + 1], a, b[2], b[3]);
    }
  }
}

// What bf16(x) leaves of x: the lo half of a score tile (see the note).
__device__ __forceinline__ float lo_of(float x) {
  return x - __bfloat162float(__float2bfloat16_rn(x));
}

// acc (16 x HD) += (hi + lo of the accumulator tiles c0 | c1: 16 x 16)
//                  * B (16 rows of sB at r0, x HD), B read with .trans:
// two mma for each B fragment, hi then lo.
template <int HD>
__device__ __forceinline__ void pv_step(float (&acc)[HD / 8][4],
                                        const float (&c0)[4],
                                        const float (&c1)[4], const bf16* sB,
                                        int r0, int lane) {
  uint32_t hi[4];
  uint32_t lo[4];
  acc_to_a(hi, c0, c1);
  const float l0[4] = {lo_of(c0[0]), lo_of(c0[1]), lo_of(c0[2]), lo_of(c0[3])};
  const float l1[4] = {lo_of(c1[0]), lo_of(c1[1]), lo_of(c1[2]), lo_of(c1[3])};
  acc_to_a(lo, l0, l1);
#pragma unroll
  for (int dj = 0; dj < HD / 16; ++dj) {
    uint32_t b[4];
    ldsm_x4_t(b, a_addr<HD>(sB, r0, dj * 2, lane));
    mma(acc[2 * dj], hi, b[0], b[1]);
    mma(acc[2 * dj + 1], hi, b[2], b[3]);
    mma(acc[2 * dj], lo, b[0], b[1]);
    mma(acc[2 * dj + 1], lo, b[2], b[3]);
  }
}

// quad (4 lanes sharing an accumulator row) reductions
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

}  // namespace

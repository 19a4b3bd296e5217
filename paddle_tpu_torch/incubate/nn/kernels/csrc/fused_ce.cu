// Fused vocabulary cross-entropy forward for Hopper (sm_90a).
//
// Replaces the TPU kernel paddle_tpu/incubate/nn/kernels/fused_ce.py
// ::_ce_fwd_kernel (:55, launched by fused_ce_fwd :102/:132).  Same
// contract: h [N, H], W [V, H] (float32 or bfloat16, row-major), labels
// [N] int32 local ids; per row it writes z = logsumexp_v(h . W[v]) and
// picked = the logit at the label, 0 when the label lies outside [0, V).
// Both outputs are float32, and the [N, V] logits never reach device
// memory.
//
// What bounds it on the H100: 2*N*V*H operations against reading h and
// W once (N*H + V*H elements), i.e. about N operations per byte of W.
// At the bf16 eval shape (N = 8192 tokens, V = 50304, H = 2048) that is
// some 1.7 TFLOP over 0.24 GB, so the operations bound it: about 1.7 ms
// at the bf16 tensor-core rate.  In float32 at N 2048 (0.42 TFLOP over
// 0.43 GB): 6.298 ms at the CUDA cores' 67 TFLOP/s, 2.557 ms as three
// TF32 products a product at the tensor cores' 495 TFLOP/s (below).
//
// bfloat16 (the bf16 models' eval path): the tensor-core kernel, split
// over the vocabulary.
// * A block of two warpgroups owns 128 rows of h (64 a warpgroup) and
//   one split of the vocabulary, walked in tiles of 256 rows of W.  Each
//   tile's 128 x 256 logits accumulate in float32 registers through
//   wgmma.mma_async m64n256k16 (bf16 operands read from shared memory by
//   descriptor), over H in stages of 64: one 128-byte row of bf16 per
//   tile row, stored in the 128-byte swizzle that wgmma's descriptor
//   names (16-byte chunk c of row r at c ^ (r mod 8), tiles 1024-byte
//   aligned).  wgmma, not mma.sync: it is the only instruction that
//   reaches the card's full tensor-core rate, and both operands are
//   K-major as h and W lie in memory, so no transpose is needed.
// * Stages arrive by cp.async 16-byte copies (zero-filled past V and
//   past H) into a ring of four (192 KB, one block an SM): the copies of
//   stages f + 1 and f + 2 are in flight while wgmma reads stage f, and
//   one group of products may stay in flight across the barrier (the
//   wait of step f is for step f - 1's; ptxas still inserts a wait of
//   its own, warning C7517, so the overlap is partial).  cp.async, not
//   TMA: a tensor map needs the driver API at run time.  The
//   generic-proxy writes are made visible to wgmma with fence.proxy.async
//   before the barrier.  On the card this tile was a little faster than
//   128 x 128 tiles at two blocks an SM.
// * After each vocabulary tile the online max, sum-exp and picked logit
//   of each row fold in registers: a row's 256 logits lie in one quad of
//   lanes (two rows a thread), which reduce with two shuffles.  The
//   ragged vocabulary tail is masked to -1e30 and can never be picked.
// * The grid is (N / 128 row tiles) x (vocabulary splits): at N 8192
//   there are only 64 row tiles for 132 SMs.  The split count is the
//   wrapper's (fused_ce.ce_plan): the fewest splits that minimise waves
//   of 132 blocks times tiles per split, 33 splits of 6 tiles at the
//   eval shape.  Each block writes its split's float32 (max, sum-exp,
//   picked) per row to a scratch buffer the wrapper allocates, and
//   fused_ce_merge_kernel combines the splits in a fixed order:
//   z = M + log(sum_s sse_s exp(m_s - M)) with sse 0 -> 1 as the TPU
//   kernel has it, picked = sum_s pick_s.  No atomics: the result is
//   deterministic.
//
// float32: the default dtype of the models (GPTConfig.dtype and
// LlamaConfig.dtype are torch.float32, as in the JAX package), so every
// no-grad loss of a float32 model on the card reaches this instance at a
// supported shape (chunked_ce.py's _fwd_dispatch; gpt3_1p3b at B 2, S
// 1024: N 2048).  The tensor cores take no float32 operand, and the CUDA
// cores' float32 rate is a seventh of their TF32 rate, so each product
// runs as three TF32 products of split operands on wgmma (the TPU's
// matrix unit, which has no float32 multiplier either, also runs a
// float32 product in reduced-precision passes):
// * x = hi + lo with hi = tf32(x) and lo = tf32(x - hi), rounded to
//   nearest with ties away (cvt.rna.tf32.f32's rounding, done on the
//   integer bits: add 2^12, clear the 13 low bits; tf32x3.py's
//   tf32_split is the same rule in torch, bit for bit on finite input).
//   h.W = hi.hi + hi.lo + lo.hi, each product exact in float32, summed
//   into one float32 accumulator chain a logit; lo.lo (<= 2^-22 of the
//   product) is dropped, so each operand keeps ~22 bits where a single
//   TF32 pass keeps 11 (tests/test_torch_cuda.py's witness: inputs on
//   which one pass leaves the float32 limit, atol 1e-3, and the kernel
//   does not).
// * The bf16 kernel's structure: a block of two warpgroups owns 128 rows
//   of h and one vocabulary split, walked in tiles of 128 rows of W
//   (wgmma m64n128k8 .tf32: K-major operands as h and W lie in memory,
//   which tf32 wgmma requires; 8 K a step, 32 bytes, as bf16's k16), the
//   online fold after each tile, the vocabulary split of ce_plan (33
//   splits of 12 tiles at N 2048: 528 blocks, 4 full waves of 132) and
//   fused_ce_merge_kernel in split order.  No atomics.
// * Staging: a stage holds 32 float32 of H (one 128-byte swizzled row a
//   tile row): raw h (16 KB), W hi and W lo (16 KB each), 48 KB; a ring
//   of four (192 KB) with the copies of stages f + 2 and f + 3 in flight
//   while stage f computes.  W is the B operand, which wgmma reads only
//   from shared memory, so it is split there: each thread rounds the
//   chunks it copied itself, hi in place and lo into the second tile,
//   while the products of the stage before run.  h is A, which tf32
//   wgmma also takes from registers: each warp reads its 16 x 8
//   fragments with ldmatrix (a 32-bit element is two b16 lanes) and
//   splits them in registers, so h's split costs no shared memory or
//   second tile.  The split of W doubles its bytes a stage; the ring is
//   planned against 227 KB for that.
// * Sums: the tensor cores add each step's products into the float32
//   accumulator with truncation, so one chain over all of H (3 H / 8 =
//   768 adds at H 2048) drifts by ~2^-17 of a logit.  Each stage's 12
//   products run as one chain from zero, and the stages' partials are
//   summed in registers with rounding adds: 64 + 64 accumulators a
//   thread, which is what caps the tile at 128 vocabulary rows.
//
// Left for later work: TMA loads from a producer warp with the two
// warpgroups as consumers (warp specialisation), a second accumulator so
// that a tile's epilogue overlaps the next tile's products, and a
// cluster that multicasts the W tile to the blocks of neighbouring row
// tiles.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "tc_common.cuh"

namespace {

constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------------------
// bfloat16: the tensor-core kernel (wgmma), split over the vocabulary
// ---------------------------------------------------------------------------

constexpr int kTcThreads = 256;                // two warpgroups
constexpr int kBM = 128;                       // rows of h a block
constexpr int kBV = 256;                       // vocabulary rows a tile
constexpr int kBK = 64;                        // H a stage: 128 bytes of bf16
constexpr int kStages = 4;                     // ring of stages
constexpr int kAhead = kStages - 2;            // stages loaded ahead
constexpr int kAcc = kBV / 2;                  // accumulators a thread
constexpr int kStageBytes = (kBM + kBV) * kBK * 2;
constexpr int kTcSmemBytes = kStages * kStageBytes + 1024;  // + alignment
constexpr int kMergeThreads = 256;

// d (64 x 256 float32, one warpgroup) = (scale_d ? d : 0) + A * B^T:
// A 64 x 16 and B 256 x 16, both K-major bf16 in 128-byte-swizzled
// shared memory, named by descriptors
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[kAcc],
                                                 uint64_t da, uint64_t db,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma's issue and wait
__device__ __forceinline__ void fence_acc(float (&d)[kAcc]) {
#pragma unroll
  for (int i = 0; i < kAcc; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Stage rows row0 .. row0+ROWS-1, columns k0 .. k0+63 of a row-major
// [n, H] bf16 matrix into a 128-byte-swizzled [ROWS][64] tile at shared
// address dst; rows at or past n and columns at or past H are zeros.
template <int ROWS>
__device__ __forceinline__ void stage_rows(uint32_t dst, const bf16* src,
                                           int row0, int n, int H, int k0) {
  static_assert(ROWS * 8 % kTcThreads == 0, "whole passes of the block");
#pragma unroll
  for (int i = 0; i < ROWS * 8 / kTcThreads; ++i) {
    const int idx = threadIdx.x + i * kTcThreads;
    const int r = idx >> 3;
    const int c = idx & 7;
    const bool ok = row0 + r < n && k0 + c * 8 < H;
    const bf16* p =
        ok ? src + static_cast<long long>(row0 + r) * H + k0 + c * 8 : src;
    cp_async16(dst + swz<kBK>(r, c) * 2, p, ok);
  }
}

// One block: rows n0 .. n0+127 of h against vocabulary tiles vt0 ..
// vt1-1 of split blockIdx.y.  part [3][splits][N] float32 receives the
// split's (max, sum-exp, picked) of each row.
__global__ void __launch_bounds__(kTcThreads, 1)
fused_ce_fwd_tc_kernel(const bf16* __restrict__ h, const bf16* __restrict__ w,
                       const int* __restrict__ labels,
                       float* __restrict__ part, int N, int V, int H,
                       int tiles_per_split) {
  extern __shared__ unsigned char ce_smem[];
  const uint32_t base = (smem_u32(ce_smem) + 1023u) & ~1023u;
  const int n0 = blockIdx.x * kBM;
  const int split = blockIdx.y;
  const int splits = gridDim.y;
  const int vt0 = split * tiles_per_split;
  const int vt1 = min((V + kBV - 1) / kBV, vt0 + tiles_per_split);
  const int nk = (H + kBK - 1) / kBK;
  const int total = (vt1 - vt0) * nk;   // stages this block consumes
  const int wg = threadIdx.x >> 7;
  const int lane = threadIdx.x & 31;
  const int t = lane & 3;
  // this thread's two rows: row0 and row0 + 8
  const int row0 = n0 + wg * 64 + ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);

  auto load = [&](int f) {
    const uint32_t sA = base + (f % kStages) * kStageBytes;
    const int k0 = (f % nk) * kBK;
    stage_rows<kBM>(sA, h, n0, N, H, k0);
    stage_rows<kBV>(sA + kBM * kBK * 2, w, (vt0 + f / nk) * kBV, V, H, k0);
  };
#pragma unroll
  for (int f = 0; f < kAhead; ++f) {
    if (f < total) load(f);
    cp_async_commit();
  }

  float d[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) d[i] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};     // this lane's share of the row sums
  float pick[2] = {0.f, 0.f};
  const int lbl[2] = {labels[row0], labels[row0 + 8]};

  for (int f = 0; f < total; ++f) {
    cp_async_wait<kAhead - 1>();    // this thread's copies of stage f
    fence_proxy_async();
    // everyone's copies of stage f; and every warpgroup is past its wait
    // of step f - 1, so the products of stage f - 2 are done and its
    // slot is free
    __syncthreads();
    if (f + kAhead < total) load(f + kAhead);
    cp_async_commit();
    const int kt = f % nk;
    const uint32_t sA = base + (f % kStages) * kStageBytes;
    const uint64_t da = sw128_desc(sA + wg * 64 * kBK * 2);
    const uint64_t db = sw128_desc(sA + kBM * kBK * 2);
    // no register fence around the in-flight group: touching d while
    // stage f - 1's products write it would make ptxas wait for them
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kBK / 16; ++j) {
      // 16 K values = 32 bytes further along the swizzled rows
      wgmma_m64n256k16(d, da + 2 * j, db + 2 * j, kt > 0 || j > 0);
    }
    wgmma_commit();
    if (kt != nk - 1) {
      wgmma_wait<1>();              // the products of stage f - 1
      continue;
    }
    wgmma_wait<0>();
    fence_acc(d);
    // a finished tile: fold its logits into the rows' online state
    const int v0 = (vt0 + f / nk) * kBV;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kBV / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = v0 + 8 * j + 2 * t + e;
          float x = d[4 * j + 2 * r + e];
          if (col < V) {
            if (col == lbl[r]) pick[r] += x;
          } else {
            x = kNegInf;
          }
          d[4 * j + 2 * r + e] = x;
          mx = fmaxf(mx, x);
        }
      const float m_new = fmaxf(m[r], quad_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kBV / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) sum += __expf(d[4 * j + 2 * r + e] - m_new);
      l[r] = l[r] * __expf(m[r] - m_new) + sum;
      m[r] = m_new;
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lr = quad_sum(l[r]);
    const float pr = quad_sum(pick[r]);
    if (t == 0) {
      const long long row = row0 + 8 * r;
      part[static_cast<long long>(split) * N + row] = m[r];
      part[static_cast<long long>(splits + split) * N + row] = lr;
      part[static_cast<long long>(2 * splits + split) * N + row] = pr;
    }
  }
}

// ---------------------------------------------------------------------------
// float32: three TF32 products a product on wgmma, split over the vocabulary
// ---------------------------------------------------------------------------

constexpr int kFBV = 128;                      // vocabulary rows a tile
constexpr int kFBK = 32;                       // H a stage: 128 bytes of f32
constexpr int kFStages = 4;                    // ring of stages
constexpr int kFAhead = kFStages - 1;          // stages loaded ahead
constexpr int kFAcc = kFBV / 2;                // accumulators a thread
constexpr int kFHBytes = kBM * kFBK * 4;       // raw h of a stage
constexpr int kFWBytes = kFBV * kFBK * 4;      // W hi (and W lo) of a stage
constexpr int kFStageBytes = kFHBytes + 2 * kFWBytes;
constexpr int kF32SmemBytes = kFStages * kFStageBytes + 1024;  // + alignment

// d (64 x 128 float32, one warpgroup) = (scale_d ? d : 0) + A * B^T:
// A 64 x 8 TF32 in registers (this warp's 16 rows: a0 (g, t), a1
// (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)), B 128 x 8 TF32, K-major
// in 128-byte-swizzled shared memory named by its descriptor
__device__ __forceinline__ void wgmma_tf32_m64n128k8(float (&d)[kFAcc],
                                                     const uint32_t (&a)[4],
                                                     uint64_t db,
                                                     int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void fence_acc_f32(float (&d)[kFAcc]) {
#pragma unroll
  for (int i = 0; i < kFAcc; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// keeps the compiler from rewriting an A fragment before the wgmma
// reading it has been waited for
__device__ __forceinline__ void fence_frag(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[j][e])::"memory");
}

// One block: rows n0 .. n0+127 of h against vocabulary tiles vt0 ..
// vt1-1 (128 rows each) of split blockIdx.y; part [3][splits][N] as the
// bf16 kernel's.
__global__ void __launch_bounds__(kTcThreads, 1)
fused_ce_fwd_tf32x3_kernel(const float* __restrict__ h,
                           const float* __restrict__ w,
                           const int* __restrict__ labels,
                           float* __restrict__ part, int N, int V, int H,
                           int tiles_per_split) {
  extern __shared__ unsigned char ce_smem[];
  const uint32_t base = (smem_u32(ce_smem) + 1023u) & ~1023u;
  unsigned char* const gbase = ce_smem + (base - smem_u32(ce_smem));
  const int n0 = blockIdx.x * kBM;
  const int split = blockIdx.y;
  const int splits = gridDim.y;
  const int vt0 = split * tiles_per_split;
  const int vt1 = min((V + kFBV - 1) / kFBV, vt0 + tiles_per_split);
  const int nk = (H + kFBK - 1) / kFBK;
  const int total = (vt1 - vt0) * nk;   // stages this block consumes
  const int wg = threadIdx.x >> 7;
  const int lane = threadIdx.x & 31;
  const int t = lane & 3;
  // this warp's 16 rows of the tile, and this thread's two rows of h
  const int arow = wg * 64 + ((threadIdx.x >> 5) & 3) * 16;
  const int row0 = n0 + arow + (lane >> 2);

  // raw h and W (into the W hi tile) of stage f, 16-byte copies; rows
  // past N or V and columns past H are zeros
  auto load = [&](int f) {
    const uint32_t sH = base + (f % kFStages) * kFStageBytes;
    const int k0 = (f % nk) * kFBK;
    const int v0 = (vt0 + f / nk) * kFBV;
#pragma unroll
    for (int i = 0; i < kBM * 8 / kTcThreads; ++i) {
      const int idx = threadIdx.x + i * kTcThreads;
      const int r = idx >> 3;
      const int c = idx & 7;
      const bool ok = n0 + r < N && k0 + c * 4 < H;
      cp_async16(sH + sw128(r, c),
                 ok ? h + static_cast<long long>(n0 + r) * H + k0 + c * 4 : h,
                 ok);
    }
#pragma unroll
    for (int i = 0; i < kFBV * 8 / kTcThreads; ++i) {
      const int idx = threadIdx.x + i * kTcThreads;
      const int r = idx >> 3;
      const int c = idx & 7;
      const bool ok = v0 + r < V && k0 + c * 4 < H;
      cp_async16(sH + kFHBytes + sw128(r, c),
                 ok ? w + static_cast<long long>(v0 + r) * H + k0 + c * 4 : w,
                 ok);
    }
  };
  // split the W chunks this thread copied for stage f (its own copies
  // are visible to it after its wait): hi in place, lo into the lo tile
  auto split_w = [&](int f) {
    unsigned char* sW = gbase + (f % kFStages) * kFStageBytes + kFHBytes;
#pragma unroll
    for (int i = 0; i < kFBV * 8 / kTcThreads; ++i) {
      const int idx = threadIdx.x + i * kTcThreads;
      const uint32_t off = sw128(idx >> 3, idx & 7);
      const float4 x = *reinterpret_cast<const float4*>(sW + off);
      uint4 hi, lo;
      tf32_split(x.x, hi.x, lo.x);
      tf32_split(x.y, hi.y, lo.y);
      tf32_split(x.z, hi.z, lo.z);
      tf32_split(x.w, hi.w, lo.w);
      *reinterpret_cast<uint4*>(sW + off) = hi;
      *reinterpret_cast<uint4*>(sW + kFWBytes + off) = lo;
    }
  };

#pragma unroll
  for (int f = 0; f < kFAhead; ++f) {
    if (f < total) load(f);
    cp_async_commit();
  }
  cp_async_wait<kFAhead - 1>();
  split_w(0);

  // d: one stage's products (12 wgmma in one chain); acc: the tile's
  // logits, the stages' d summed with rounding FADDs.  The tensor cores
  // add into d with truncation, and a chain over all of H (768 adds at
  // H 2048) drifts by ~2^-17 of a logit; a chain of 12 does not.
  float d[kFAcc];
  float acc[kFAcc];
#pragma unroll
  for (int i = 0; i < kFAcc; ++i) d[i] = acc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};     // this lane's share of the row sums
  float pick[2] = {0.f, 0.f};
  const int lbl[2] = {labels[row0], labels[row0 + 8]};

  for (int f = 0; f < total; ++f) {
    fence_proxy_async();    // this thread's split writes, to wgmma's proxy
    // every split of stage f is done; every warpgroup is past its wait of
    // step f - 1, so the slot of stage f - 1 is free for stage f + 3
    __syncthreads();
    if (f + kFAhead < total) load(f + kFAhead);
    cp_async_commit();
    const int kt = f % nk;
    const uint32_t sH = base + (f % kFStages) * kFStageBytes;
    // this warp's A fragments of the stage's four k8 steps, split
    uint32_t ah[4][4];
    uint32_t al[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t raw[4];
      ldsm_x4(raw, sH + sw128(arow + (lane & 15), 2 * j + (lane >> 4)));
#pragma unroll
      for (int e = 0; e < 4; ++e)
        tf32_split(__uint_as_float(raw[e]), ah[j][e], al[j][e]);
    }
    const uint64_t dhi = sw128_desc(sH + kFHBytes);
    const uint64_t dlo = sw128_desc(sH + kFHBytes + kFWBytes);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // 8 K values = 32 bytes further along the swizzled rows; the three
      // products of a step into the one accumulator chain
      wgmma_tf32_m64n128k8(d, ah[j], dhi + 2 * j, j > 0);
      wgmma_tf32_m64n128k8(d, ah[j], dlo + 2 * j, 1);
      wgmma_tf32_m64n128k8(d, al[j], dhi + 2 * j, 1);
    }
    wgmma_commit();
    // stage f + 1's W, while stage f's products run
    if (f + 1 < total) {
      cp_async_wait<kFAhead - 1>();
      split_w(f + 1);
    }
    wgmma_wait<0>();
    fence_acc_f32(d);
    fence_frag(ah);
    fence_frag(al);
#pragma unroll
    for (int i = 0; i < kFAcc; ++i) acc[i] = kt == 0 ? d[i] : acc[i] + d[i];
    if (kt != nk - 1) continue;
    // a finished tile: fold its logits into the rows' online state
    const int v0 = (vt0 + f / nk) * kFBV;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kFBV / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = v0 + 8 * j + 2 * t + e;
          float x = acc[4 * j + 2 * r + e];
          if (col < V) {
            if (col == lbl[r]) pick[r] += x;
          } else {
            x = kNegInf;
          }
          acc[4 * j + 2 * r + e] = x;
          mx = fmaxf(mx, x);
        }
      const float m_new = fmaxf(m[r], quad_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kFBV / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          sum += __expf(acc[4 * j + 2 * r + e] - m_new);
      l[r] = l[r] * __expf(m[r] - m_new) + sum;
      m[r] = m_new;
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lr = quad_sum(l[r]);
    const float pr = quad_sum(pick[r]);
    if (t == 0) {
      const long long row = row0 + 8 * r;
      part[static_cast<long long>(split) * N + row] = m[r];
      part[static_cast<long long>(splits + split) * N + row] = lr;
      part[static_cast<long long>(2 * splits + split) * N + row] = pr;
    }
  }
}

// z and picked of each row from the splits' partials, in split order.
__global__ void __launch_bounds__(kMergeThreads)
fused_ce_merge_kernel(const float* __restrict__ part, float* __restrict__ z,
                      float* __restrict__ picked, int N, int splits) {
  const int row = blockIdx.x * kMergeThreads + threadIdx.x;
  if (row >= N) return;
  float M = kNegInf;
  for (int s = 0; s < splits; ++s)
    M = fmaxf(M, part[static_cast<long long>(s) * N + row]);
  float sse = 0.f;
  float pk = 0.f;
  for (int s = 0; s < splits; ++s) {
    sse += part[static_cast<long long>(splits + s) * N + row]
           * expf(part[static_cast<long long>(s) * N + row] - M);
    pk += part[static_cast<long long>(2 * splits + s) * N + row];
  }
  z[row] = M + logf(sse == 0.f ? 1.f : sse);
  picked[row] = pk;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  h [N, H] and W [V, H] row-major
// with H a multiple of 32 and 16-byte aligned bases; labels [N] int32;
// z and picked [N] float32; N a multiple of 128.  The vocabulary is cut
// into `splits` runs of `tiles_per_split` tiles (bfloat16: 256 rows,
// float32: 128; splits = ceil(ceil(V / tile) / tiles_per_split)), and
// `partials` is a float32 scratch of 3 * splits * N values.  Launches on
// `stream` the split kernel, then the merge; does not synchronise,
// allocates nothing, returns cudaGetLastError() after the last launch
// (cudaErrorInvalidValue for an unknown dtype or an inconsistent plan).
extern "C" int pt_fused_ce_fwd(const void* h, const void* w,
                               const void* labels, void* z, void* picked,
                               void* partials, int dtype, int N, int V, int H,
                               int splits, int tiles_per_split, void* stream) {
  if (N == 0) return 0;
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tile = dtype == 0 ? kFBV : kBV;
  const int v_tiles = (V + tile - 1) / tile;
  if (N % kBM || tiles_per_split < 1 || partials == nullptr
      || splits != (v_tiles + tiles_per_split - 1) / tiles_per_split) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int* lbl = static_cast<const int*>(labels);
  float* part = static_cast<float*>(partials);
  const dim3 grid(N / kBM, splits);
  cudaError_t err;
  if (dtype == 0) {
    err = cudaFuncSetAttribute(fused_ce_fwd_tf32x3_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kF32SmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    fused_ce_fwd_tf32x3_kernel<<<grid, kTcThreads, kF32SmemBytes, s>>>(
        static_cast<const float*>(h), static_cast<const float*>(w), lbl, part,
        N, V, H, tiles_per_split);
  } else {
    err = cudaFuncSetAttribute(fused_ce_fwd_tc_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kTcSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    fused_ce_fwd_tc_kernel<<<grid, kTcThreads, kTcSmemBytes, s>>>(
        static_cast<const bf16*>(h), static_cast<const bf16*>(w), lbl, part,
        N, V, H, tiles_per_split);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_ce_merge_kernel<<<(N + kMergeThreads - 1) / kMergeThreads,
                          kMergeThreads, 0, s>>>(part, static_cast<float*>(z),
                                                 static_cast<float*>(picked),
                                                 N, splits);
  return static_cast<int>(cudaGetLastError());
}

// The dynamic shared memory (bytes) of one block of the split kernel of
// `dtype` (0 float32, 1 bfloat16).
extern "C" int pt_fused_ce_smem_bytes(int dtype) {
  return dtype == 0 ? kF32SmemBytes : kTcSmemBytes;
}

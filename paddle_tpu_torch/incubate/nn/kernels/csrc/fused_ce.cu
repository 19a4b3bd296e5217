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
// At the eval shape (N = 8192 tokens, V = 50304, H = 2048) that is some
// 1.7 TFLOP over 0.24 GB, so the operations bound it: about 1.7 ms at
// the bf16 tensor-core rate.
//
// bfloat16 (the eval path): the tensor-core kernel, split over the
// vocabulary.
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
// float32 (no path gives the fused head float32 at a supported shape):
// the CUDA-core kernel of the first port, unchanged.
// * One block of 256 threads owns 64 rows of h and streams W in tiles
//   of 64 vocabulary rows; each tile's 64x64 logits accumulate in
//   float32 registers (a 4x4 micro-tile per thread: rows ty*4+i,
//   vocabulary columns tx+16*j) over H in chunks of 32 staged through
//   shared memory with 16-byte vector loads.  The online state folds as
//   above, the 16 threads of a row reducing with shuffles.
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
// float32: the CUDA-core kernel
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;        // 8 warps
constexpr int kTileN = 64;           // rows of h per block
constexpr int kTileV = 64;           // vocabulary rows per tile
constexpr int kChunk = 32;           // H elements per shared-memory stage
constexpr int kRows = 4;
constexpr int kCols = kTileV / 16;

// Stage columns c0 .. c0+kChunk-1 of rows row0 .. row0+63 of a [n, H]
// float32 matrix into dst[64][kChunk+1]; rows at or past n are zero.
__device__ void load_chunk(float (*dst)[kChunk + 1], const float* src,
                           int row0, int n, int H, int c0) {
  for (int idx = threadIdx.x; idx < kTileN * kChunk / 4; idx += kThreads) {
    const int r = idx / (kChunk / 4);
    const int d = (idx % (kChunk / 4)) * 4;
    float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n) {
      t = *reinterpret_cast<const float4*>(
          src + static_cast<long long>(row0 + r) * H + c0 + d);
    }
    dst[r][d] = t.x;
    dst[r][d + 1] = t.y;
    dst[r][d + 2] = t.z;
    dst[r][d + 3] = t.w;
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

__global__ void __launch_bounds__(kThreads)
fused_ce_fwd_kernel(const float* __restrict__ h, const float* __restrict__ w,
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
      load_chunk(sH, h, n0, N, H, c0);
      load_chunk(sW, w, v0, V, H, c0);
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

// wgmma's shared-memory descriptor of a K-major tile in the 128-byte
// swizzle: start address >> 4, leading offset unused (one swizzle row
// spans the 64 K values of a stage), stride 1024 bytes between groups of
// eight rows, layout 1 = 128-byte swizzle
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | (static_cast<uint64_t>(1) << 16)
         | (static_cast<uint64_t>(1024 >> 4) << 32)
         | (static_cast<uint64_t>(1) << 62);
}

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

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N of this warpgroup's wgmma groups are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma's issue and wait
__device__ __forceinline__ void fence_acc(float (&d)[kAcc]) {
#pragma unroll
  for (int i = 0; i < kAcc; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// shared-memory writes of the generic proxy (cp.async) become visible to
// the async proxy that wgmma reads through
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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
// z and picked [N] float32.  bfloat16 only: N a multiple of 128, the
// vocabulary cut into `splits` runs of `tiles_per_split` tiles of 256
// rows (splits = ceil(ceil(V / 256) / tiles_per_split)), and `partials`
// a float32 scratch of 3 * splits * N values.  Launches on `stream`
// (bfloat16: the split kernel, then the merge), does not synchronise,
// allocates nothing, returns cudaGetLastError() after the last launch
// (cudaErrorInvalidValue for an unknown dtype or an inconsistent plan).
extern "C" int pt_fused_ce_fwd(const void* h, const void* w,
                               const void* labels, void* z, void* picked,
                               void* partials, int dtype, int N, int V, int H,
                               int splits, int tiles_per_split, void* stream) {
  if (N == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* lbl = static_cast<const int*>(labels);
  float* zf = static_cast<float*>(z);
  float* pf = static_cast<float*>(picked);
  if (dtype == 0) {
    fused_ce_fwd_kernel<<<(N + kTileN - 1) / kTileN, kThreads, 0, s>>>(
        static_cast<const float*>(h), static_cast<const float*>(w), lbl, zf,
        pf, N, V, H);
    return static_cast<int>(cudaGetLastError());
  }
  const int v_tiles = (V + kBV - 1) / kBV;
  if (dtype != 1 || N % kBM || tiles_per_split < 1 || partials == nullptr
      || splits != (v_tiles + tiles_per_split - 1) / tiles_per_split) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(
      fused_ce_fwd_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kTcSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  float* part = static_cast<float*>(partials);
  fused_ce_fwd_tc_kernel<<<dim3(N / kBM, splits), kTcThreads, kTcSmemBytes,
                           s>>>(static_cast<const bf16*>(h),
                                static_cast<const bf16*>(w), lbl, part, N, V,
                                H, tiles_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_ce_merge_kernel<<<(N + kMergeThreads - 1) / kMergeThreads,
                          kMergeThreads, 0, s>>>(part, zf, pf, N, splits);
  return static_cast<int>(cudaGetLastError());
}

// The dynamic shared memory (bytes) of one block of the bfloat16 kernel.
extern "C" int pt_fused_ce_smem_bytes() { return kTcSmemBytes; }

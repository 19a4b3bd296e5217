// Fused single-launch b1 decode step for Hopper (sm_90a).
//
// Replaces the TPU kernel paddle_tpu/incubate/nn/kernels/fused_decode.py
// ::_decode_kernel (:84), reached through fused_decode_layers (:334 ->
// pallas_call :469): the whole weight-only int8 GPT layer stack for ONE
// token.  Per layer: LN1 -> int8 qkv GEMV -> the new K/V row written at
// row `pos` of the flat [L, T, H] cache (quantized for int8 / fp8
// storage) -> attention over the history rows < pos plus the new token
// -> proj GEMV + residual -> LN2 -> fc1 GEMV + tanh-GELU -> fc2 GEMV +
// residual.  Only row 0 of the TPU layout's [8, H] hidden state is real;
// this kernel computes row 0 and writes rows 1-7 of h_out as zeros.
//
// What bounds it on the H100: at batch 1 every int8 weight byte is read
// once per token and used for 2 operations, so the weight bytes over the
// HBM rate bound it (gpt3_1p3b: 1.208 GB of int8 layer weights a token,
// ~0.36 ms at 3.35 TB/s), plus the K/V history (196,608 bytes a row of
// position at bf16, about half that plus scales at int8).
//
// Design.  The TPU kernel walks the L layers as a sequential grid and
// carries h in VMEM.  Here the layer loop runs inside ONE cooperative
// launch of one 512-thread block per SM; its phases are separated by a
// grid barrier written by hand: a 64-bit arrival count that is never
// reset (release on arrival, acquire while spinning), so the last
// arrival's own add releases the grid, with no reset and no second word
// to publish.  The first design lost ~5x its bound in four
// places; what this one does about each:
//
//  1. Weight bytes in flight across the barriers.  Every GEMV is cut
//     into column tiles of kTW int8 columns, and each tile's K rows into
//     m = grid / tiles equal parts, one a block (gemv_plan; 512-column
//     tiles give every block of the H100's 132 one part of qkv, proj and
//     fc2, and 128 of them one of fc1), so each block knows its whole
//     weight stream for all L layers in advance and finishes exactly one
//     tile a GEMV.  (Runs cut evenly through the column-major rows made
//     the blocks whose run crossed a tile finish two tiles and trail
//     the grid at every barrier.)  The stream goes through a ring of
//     `stages` 32 KB shared-memory stages (kSR rows x kTW bytes, as many
//     as fit beside the GEMV input vector), filled with 16-byte cp.async
//     by warps 1-15, each signalling the stage's mbarrier once its copies
//     land (cp.async.mbarrier.arrive.noinc).  A stage is refilled with
//     the stream's next one as soon as it is consumed, whatever phase
//     comes next, so the next GEMV's first stages are in shared memory
//     while a block waits at a barrier, normalizes or attends.  Warp 0
//     copies nothing: its thread 0 does the block's atomics and barrier
//     arrivals, whose fences would otherwise wait on its copies.
//  2. Six barriers a layer instead of 8 (6 L - 1 a token).  A column
//     tile's sum completes in the LAST of its m blocks to store its part
//     (a self-resetting counter per tile), which sums the m parts in
//     part order (so the result does not depend on which block is last
//     and two launches give the same bits) and applies the epilogue
//     there: qkv = sum * s + b; h2 = (h + proj * s) + b; g =
//     bf16(gelu(fc1 * s + b)); h = (h2 + fc2 * s) + b.  Its scale, bias
//     and residual are loaded when the GEMV starts.  The three
//     column-strided epilogue phases of the first design are gone; LN1
//     and LN2 run in every block on the H floats of h, their parameters
//     loaded into registers a phase ahead (read once a token, they come
//     from HBM, where a demand load queues behind the weight stream).
//     The [L, K, N] weight layout is kept (prefill reads the same
//     tensors).
//  3. Attention across the whole grid.  Work items are (head, row tile)
//     with tiles of 16-256 rows, chosen on the device from pos so the
//     items fill the grid, never crossing a 256-row KV_CHUNK; the new
//     K/V rows go to the blocks after the items' ones.  A warp reads a
//     row group with its lanes across hD, 16 bytes a lane, four row
//     groups before it uses them.  Phase S: each item writes float32
//     scores and its tile maximum; one item per head stores and
//     quantizes the new K/V row.  Phase V: p = bf16(exp(s - M_c)), M_c
//     the running maximum through the row's own chunk (the prefix
//     maximum of the tile maxima: the TPU's rounding point), and each
//     item writes its P.V partial and sum of p.  The proj phase merges,
//     per head and only for the K rows its block needs, the chunks in
//     order with the TPU kernel's running-max recurrence, then the new
//     token.  Every reduction over L2 values issues its loads before it
//     adds them (kAhead), in the same order.
//  4. The int8 -> float conversion.  The first design converted each
//     weight byte with a static_cast: its SASS holds 336-360 I2F.S8 an
//     instance (16 a clock an SM, ~0.3 ms a token on its own).  Here a
//     byte XOR 0x80 is put into the mantissa of 2^23 with __byte_perm
//     and 2^23 + 128 is subtracted: both steps are exact, so the float32
//     products and sums are the same, at one PRMT (and a quarter of a
//     LOP3) and one FADD a byte; no I2F.S8 is left (the I2F.U32.RP that
//     remain are integer divisions).  The int8 K/V history uses the
//     same trick.
// Measured and dropped (PERF.md, section 6): 1-D TMA bulk copies of each
// 512-byte row (their issue keeps warp 0 busy); fewer ring stages (the
// same times); no prefetch across phases (slower); prefetch.global.L2 of
// the attention rows and LN parameters (slower); a tile's parts summed
// 32 loads ahead instead of kAhead (ptxas spills ~400 bytes a thread at
// the 128-register cap: slower).

// Rounding points, kept from _decode_kernel (the plain PyTorch version
// fused_decode_layers_plain keeps them too):
//  1. GEMV inputs rounded to bf16, exact int8 weights, float32 sums;
//     the scale after the sum, then the bias; the GELU output rounded
//     to bf16 before fc2.
//  2. History attention: q * 1/sqrt(hD) in float32, then bf16; each
//     history row dequantized in float32 (int8 data * scale) and
//     rounded to bf16 (a float32 cache too); float32 scores; p rounded
//     to bf16 before P.V against bf16 V, against the running maximum
//     through its 256-row chunk.
//  3. The new token is attended unrounded: the float32 row in the
//     model-dtype mode (the cache stores it rounded), q * scale of the
//     stored int8 bytes, the stored fp8 value widened; its score is
//     sum(qs * k) on the unrounded qs.
//  4. int8 rows: s = max(max|x|, 1e-8) / 127 per head, q =
//     clip(rint(x / s), -127, 127) (half to even, IEEE division: no
//     fast math).
//  5. fp8 rows: |x| > 464 (and inf, NaN) is stored as NaN, as
//     kv_quant.quantize_kv does; the rest rounds to nearest even.
//  6. tanhf/expf, not the approximate intrinsics; LN is
//     ((x - mu) * (1 / sqrt(var + eps))) * g + b with the biased
//     variance; separate float32 roundings where JAX has them
//     (__fmul_rn / __fadd_rn keep nvcc from contracting them into FMAs).
// Only the order of float32 sums differs from the plain version.  No
// float atomics: two launches on the same inputs give the same bits.
//
// The barrier and column-tile counters live in a zeroed int buffer that
// the wrapper keeps per device and shape; a launch leaves the tile
// counters at 0 and the barrier's count a multiple of the grid, so
// launches must not overlap (one stream).
//
// Built with -DFD_PROFILE (chip_fused_ab.py does, for its phase
// profile), the kernel writes 64-bit words into h_out rows 1-7 in place
// of their zeros: block 0's %globaltimer (ns) at the start; for every
// grid barrier block 0's time on reaching it, on leaving it, and the
// latest time any block reached it (its low 8 bits replaced by that
// block's index); block 0's time at the end; its SM cycles in each GEMV
// (qkv, proj, fc1, fc2) summed over the layers: waiting for ring stages,
// computing, refilling them, finishing column tiles (all of it, then
// its parts: the threads' sums, the part stored, the tile counter, the
// epilogue), and before the GEMV (its input: LN, merge, g); then its
// clock64 at the start and the end.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>

#include <cstdint>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 256;              // history rows per online-softmax chunk
constexpr int kTW = 512;                 // int8 columns of a GEMV column tile
constexpr int kCPR = kTW / 16;           // 16-byte chunks of a tile row
constexpr int kRG = kThreads / kCPR;     // rows a pass over a stage covers
constexpr int kSR = 64;                  // weight rows of a ring stage
constexpr int kRowsAhead = 4;            // stage rows a thread loads at once
// warp 0 copies no weights: its atomics and fences (tile counters, grid
// barrier) then wait for no cp.async of its own
constexpr int kCopiers = kThreads - 32;
constexpr int kAhead = 8;                // L2 loads issued before they are summed
constexpr int kStageBytes = kTW * kSR;
constexpr int kMaxStages = 16;
constexpr int kBarBytes = 128;           // the stages' mbarriers
constexpr int kMinTileRows = 16;         // attention items
constexpr int kMaxWidth = 16384;         // H and F
constexpr int kMaxHD = 128;
constexpr int kSmemLimit = 232448;       // 227 KB a block
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kCPR >= 1 && kCPR <= 32 && (kCPR & (kCPR - 1)) == 0, "tile");
static_assert(kMaxStages * 8 <= kBarBytes, "mbarriers");

// cache storage modes
constexpr int kF32 = 0;
constexpr int kBF16 = 1;
constexpr int kInt8 = 2;
constexpr int kFP8 = 3;

// slots of the sync buffer: the barrier's 64-bit arrival count (0-1),
// the barriers of the last launch (2), the column tiles' counters (4 on)
enum { kBarCount = 0, kBarDone = 2, kTileCnt = 4 };

struct Params {
  const float* h0;         // [8, H], row 0 read
  const int8_t* w[4];      // qkv [L, H, 3H], proj [L, H, H], fc1 [L, H, F], fc2 [L, F, H]
  const float* s[4];       // per-out-channel scales [L, N]
  const void* small[8];    // qkv_b, proj_b, fc1_b, fc2_b, ln1_g, ln1_b, ln2_g, ln2_b
  void* ck;                // [L, T, H]
  void* cv;
  float* ks;               // int8: [L, T, nH]
  float* vs;
  const int* pos;
  float* h_out;            // [8, H]
  float* scratch;
  unsigned* sync;
  int L, H, F, nH, T, small_bf16, stages;
  float eps, scale;
};

enum { kQkvB, kProjB, kFc1B, kFc2B, kLn1G, kLn1B, kLn2G, kLn2B };

// ---------------------------------------------------------------------------
// the plan: GEMV ownership, attention items, scratch (mirrored by the
// wrapper's plan functions, which the CPU tests check)
// ---------------------------------------------------------------------------

__host__ __device__ inline int tiles_of(int N) { return (N + kTW - 1) / kTW; }

__host__ __device__ inline long long up4(long long n) {
  return (n + 3) & ~3LL;
}

// A [K, N] GEMV cut over G blocks: column tiles of kTW int8 columns.
// With tiles <= G, the K rows of each tile are cut into m = G / tiles
// equal parts (at most K / 16, so a part has 16 rows or more), one a
// block (block b: part b % m of tile b / m; blocks from tiles * m on
// idle), so every block finishes one tile; with more tiles than blocks,
// block b takes the whole tiles b, b + G, ...
struct GemvPlan {
  int tiles, m;
};

__host__ __device__ inline GemvPlan gemv_plan(int K, int N, int G) {
  GemvPlan g;
  g.tiles = tiles_of(N);
  g.m = g.tiles <= G ? G / g.tiles : 1;
  g.m = g.m < K / 16 ? g.m : (K / 16 > 1 ? K / 16 : 1);
  return g;
}

struct Layout {   // float offsets into the scratch
  long long hA, hB, qkv, g, vn, sn, s, tm, ls, acc, part, total;
  int mt;
};

__host__ __device__ inline Layout layout(int H, int F, int T, int nH,
                                         int G) {
  Layout ly;
  ly.mt = (T + kMinTileRows - 1) / kMinTileRows;
  const int shapes[4][2] = {{H, 3 * H}, {H, H}, {H, F}, {F, H}};
  long long parts = 0;   // [tile][part] slots of the GEMV with the most
  for (int i = 0; i < 4; ++i) {
    const GemvPlan g = gemv_plan(shapes[i][0], shapes[i][1], G);
    const long long n = static_cast<long long>(g.tiles) * g.m;
    parts = n > parts ? n : parts;
  }
  long long o = 0;
  ly.hA = o;   o += up4(H);                        // h (layer carry)
  ly.hB = o;   o += up4(H);                        // h2 (after attention)
  ly.qkv = o;  o += up4(3LL * H);                  // q, k, v
  ly.g = o;    o += up4(F);                        // bf16(gelu)
  ly.vn = o;   o += up4(H);                        // the new V rows as attended
  ly.sn = o;   o += up4(nH);                       // the new token's scores
  ly.s = o;    o += up4(static_cast<long long>(nH) * T);       // scores
  ly.tm = o;   o += up4(static_cast<long long>(nH) * ly.mt);   // tile maxima
  ly.ls = o;   o += up4(static_cast<long long>(nH) * ly.mt);   // tile sums of p
  ly.acc = o;  o += up4(static_cast<long long>(ly.mt) * H);    // tile P.V
  ly.part = o; o += parts * kTW;                               // GEMV parts
  ly.total = o;
  return ly;
}

__host__ __device__ inline int sync_ints(int H, int F) {
  const int a = tiles_of(3 * H);
  const int b = tiles_of(F);
  return kTileCnt + (a > b ? a : b);
}

struct AttnPlan {
  int tr;       // history rows of a tile (a power of 2 in [16, 256])
  int ntiles;   // tiles of each head
};

// the shortest tile whose (head, tile) items fit the grid (256 rows at
// most, so a tile never crosses a KV_CHUNK)
__host__ __device__ inline AttnPlan attn_plan(int pos, int nH, int G) {
  AttnPlan a;
  a.tr = kMinTileRows;
  while (a.tr < kChunk
         && static_cast<long long>(nH) * ((pos + a.tr - 1) / a.tr) > G)
    a.tr *= 2;
  a.ntiles = (pos + a.tr - 1) / a.tr;
  return a;
}

struct Gemv {       // one GEMV and this block's share of it
  const int8_t* w;
  const float* s;
  int K, N, m;       // rows, columns, parts a tile
  int t0, tstep;     // this block's tiles: t0 + i * tstep, i < nseg
  int nseg;
  int k0, k1;        // ... and their K rows
  int part;          // this block's part of each of its tiles
};

struct Cursor {      // a position in this block's weight stream
  int l, g, i, k;    // layer, GEMV, tile of the block's, next K row
};

struct Stage {
  int t, k, n;       // tile, first K row, rows
};

__device__ __forceinline__ void settle(Cursor& c, const Gemv* gv, int L) {
  while (c.l < L && c.i >= gv[c.g].nseg) {
    if (++c.g == 4) {
      c.g = 0;
      ++c.l;
    }
    c.i = 0;
    c.k = gv[c.g].k0;
  }
}

__device__ __forceinline__ Stage stage_at(const Cursor& c, const Gemv& G) {
  Stage st;
  st.t = G.t0 + c.i * G.tstep;
  st.k = c.k;
  st.n = min(kSR, G.k1 - c.k);
  return st;
}

// the cursor past stage st
__device__ __forceinline__ void advance(Cursor& c, const Stage& st,
                                        const Gemv* gv, int L) {
  c.k += st.n;
  if (c.k >= gv[c.g].k1) {
    ++c.i;
    c.k = gv[c.g].k0;
  }
  settle(c, gv, L);
}

// ---------------------------------------------------------------------------
// small helpers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "r"(addr));
  return v;
}

__device__ __forceinline__ float lds32(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr));
  return v;
}

// arrive on the mbarrier once this thread's earlier cp.asyncs land
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  }
}

// atomic add, release of this block's earlier writes (ordered before it
// by __syncthreads) and acquire of what the other arrivals released
__device__ __forceinline__ unsigned atom_add_acq_rel(unsigned* p,
                                                     unsigned v) {
  unsigned old;
  asm volatile("atom.add.acq_rel.gpu.global.u32 %0, [%1], %2;\n"
               : "=r"(old) : "l"(p), "r"(v) : "memory");
  return old;
}

__device__ __forceinline__ unsigned long long ld_acquire64(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];\n" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}

// Every block of the grid arrives before any leaves; writes before it
// are visible after it (read them with __ldcg: L1 is not coherent).
// The arrival count only grows (2^64 arrivals never wrap): this barrier
// is passed once it reaches `target`, the count at the launch's start
// (a multiple of the grid: every launch adds grid x barriers) plus the
// grid times the barriers passed so far, this one included.
__device__ void grid_barrier(unsigned* sync, unsigned long long target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long* count =
        reinterpret_cast<unsigned long long*>(sync + kBarCount);
    asm volatile("red.release.gpu.global.add.u64 [%0], 1;\n" ::"l"(count)
                 : "memory");
    while (ld_acquire64(count) < target) {
    }
  }
  __syncthreads();
}

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float ldp(const void* p, long long i, int bf) {
  return bf ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
            : static_cast<const float*>(p)[i];
}

// byte j of w (XOR 0x80 already applied) as the signed int8 it stores:
// 2^23 + u is exact, and so is subtracting 2^23 + 128
__device__ __forceinline__ float byte_to_float(unsigned wx, int j) {
  return __int_as_float(static_cast<int>(
             __byte_perm(wx, 0x4B000000u, 0x7540u + j))) - 8388736.0f;
}

__device__ __forceinline__ float fp8_to_float(unsigned byte) {
  const __half h(__nv_cvt_fp8_to_halfraw(
      static_cast<__nv_fp8_storage_t>(byte), __NV_E4M3));
  return __half2float(h);
}

// kv_quant._to_fp8: NaN keeps its sign, |x| > 464 and infinities become
// NaN (0x7f), the rest clamps to +-448 and rounds to nearest even
__device__ __forceinline__ uint8_t float_to_fp8(float x) {
  if (isnan(x)) return signbit(x) ? 0xff : 0x7f;
  if (fabsf(x) > 464.f) return 0x7f;
  x = fminf(fmaxf(x, -448.f), 448.f);
  return static_cast<uint8_t>(__nv_cvt_float_to_fp8(x, __NV_SATFINITE,
                                                    __NV_E4M3));
}

template <int MODE>
struct KV {
  static constexpr int kElem = MODE == kF32 ? 4 : (MODE == kBF16 ? 2 : 1);
  static constexpr int kVPL = 16 / kElem;   // values in a lane's 16 bytes
};

// 16 bytes of cache values dequantized in float32 (int8 times its row
// scale) and rounded to bf16
template <int MODE>
__device__ __forceinline__ void dequant16(const uint4 raw, float sc,
                                          float (&out)[KV<MODE>::kVPL]) {
  const unsigned words[4] = {raw.x, raw.y, raw.z, raw.w};
  if constexpr (MODE == kF32) {
#pragma unroll
    for (int i = 0; i < 4; ++i) out[i] = bf16r(__uint_as_float(words[i]));
  } else if constexpr (MODE == kBF16) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      out[2 * i] = __uint_as_float(words[i] << 16);
      out[2 * i + 1] = __uint_as_float(words[i] & 0xffff0000u);
    }
  } else if constexpr (MODE == kInt8) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const unsigned wx = words[i] ^ 0x80808080u;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        out[4 * i + j] = bf16r(__fmul_rn(byte_to_float(wx, j), sc));
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        out[4 * i + j] = bf16r(fp8_to_float((words[i] >> (8 * j)) & 0xffu));
    }
  }
}

// Deterministic block reductions: every thread gets the same value.
__device__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  __syncthreads();  // red is free: the previous reduction's readers are done
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) t += red[w];
  return t;
}

__device__ float block_max(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) t = fmaxf(t, red[w]);
  return t;
}

__device__ __forceinline__ float gelu_tanh(float x) {
  // jax.nn.gelu(approximate=True):
  // x * (0.5 * (1 + tanh(sqrt(2/pi) * (x + 0.044715 * x^3))))
  const float c = 0.7978845608028654f;
  const float x3 = __fmul_rn(__fmul_rn(x, x), x);
  const float inner = __fmul_rn(c, __fadd_rn(x, __fmul_rn(0.044715f, x3)));
  return __fmul_rn(x, __fmul_rn(0.5f, __fadd_rn(1.0f, tanhf(inner))));
}

// Block-uniform state lives in shared memory (thread 0 writes it once):
// with 227 KB of shared memory a block, L1 keeps ~29 KB, so state that
// ptxas puts on a thread's stack (512 copies of it) lives in L2.
struct Smem {
#ifdef FD_PROFILE
  unsigned long long prof[4][8];   // GEMV x (see the note)
#endif
  Layout ly;
  Gemv gv[4];
  float qb[kMaxHD];   // an item's q * scale rounded to bf16
  float red[kWarps];  // block reductions
  int last;           // this block finished a column tile last
  unsigned long long base;   // the barrier count at the start
};

__device__ void smem_setup(const Params& p, Smem& sm) {
  const int G = gridDim.x;
  const int b = blockIdx.x;
  sm.ly = layout(p.H, p.F, p.T, p.nH, G);
  const int shapes[4][2] = {{p.H, 3 * p.H}, {p.H, p.H}, {p.H, p.F},
                            {p.F, p.H}};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    Gemv& g = sm.gv[i];
    g.w = p.w[i];
    g.s = p.s[i];
    g.K = shapes[i][0];
    g.N = shapes[i][1];
    const GemvPlan gp = gemv_plan(g.K, g.N, G);
    g.m = gp.m;
    if (gp.tiles <= G) {
      g.nseg = b < gp.tiles * gp.m;
      g.t0 = b / gp.m;
      g.tstep = 0;
      g.part = b % gp.m;
      g.k0 = g.K * g.part / gp.m;
      g.k1 = g.K * (g.part + 1) / gp.m;
    } else {
      g.nseg = (gp.tiles - b + G - 1) / G;
      g.t0 = b;
      g.tstep = G;
      g.part = 0;
      g.k0 = 0;
      g.k1 = g.K;
    }
  }
}

// ---------------------------------------------------------------------------
// the block's weight stream and GEMVs (every function inlined into the
// kernel, so the cursors stay in registers)
// ---------------------------------------------------------------------------

struct Block {
  const Params& p;
  Smem& sm;
  const Layout& ly;
  const Gemv* gv;
  uint64_t* full;     // the stages' mbarriers
  uint8_t* ring;
  float* xs;          // a GEMV input vector, max(H, F) floats
  float* red;         // kWarps x kTW floats
  Cursor ic;          // next stage to issue
  Cursor cc;          // next stage to consume
  int islot, cslot;   // their ring slots
  unsigned parity;    // the consumed slot's mbarrier phase parity
  int barriers;
  unsigned long long base;   // the barrier count at the start
  long long tphase;   // FD_PROFILE: block 0's clock leaving the last barrier

  __device__ __forceinline__ Block(const Params& pr, uint8_t* dsm, Smem& s,
                                   unsigned long long b)
      : p(pr), sm(s), ly(s.ly), gv(s.gv), islot(0), cslot(0), parity(0),
        barriers(0), base(b), tphase(0) {
    full = reinterpret_cast<uint64_t*>(dsm);
    ring = dsm + kBarBytes;
    xs = reinterpret_cast<float*>(ring + static_cast<long long>(p.stages)
                                             * kStageBytes);
    red = xs + (p.H > p.F ? p.H : p.F);
    ic.l = 0;
    ic.g = 0;
    ic.i = 0;
    ic.k = gv[0].k0;
    settle(ic, gv, p.L);
    cc = ic;
  }

  // the stream's next stage into its ring slot (every thread)
  __device__ __forceinline__ void issue() {
    if (ic.l >= p.L) return;
    const Gemv& G = gv[ic.g];
    const Stage st = stage_at(ic, G);
    const int slot = islot;
    islot = islot + 1 == p.stages ? 0 : islot + 1;
    const int8_t* src = G.w + (static_cast<long long>(ic.l) * G.K + st.k)
                                  * G.N + static_cast<long long>(st.t) * kTW;
    const int cpr = min(kTW, G.N - st.t * kTW) / 16;
    uint8_t* dst = ring + slot * kStageBytes;
    if (threadIdx.x >= 32) {
      for (int i = threadIdx.x - 32; i < st.n * kCPR; i += kCopiers) {
        const int row = i / kCPR;
        const int c = i % kCPR;
        if (c < cpr)
          cp_async16(dst + row * kTW + c * 16,
                     src + static_cast<long long>(row) * G.N + c * 16);
      }
      cp_async_arrive(full + slot);
    }
    advance(ic, st, gv, p.L);
  }

  // FD_PROFILE: add the cycles since t0 to counter k of GEMV gi
  __device__ __forceinline__ long long tick(int gi, int k, long long t0) {
#ifdef FD_PROFILE
    const long long t = clock64();
    if (threadIdx.x == 0 && k >= 0 && k < 7) sm.prof[gi][k] += t - t0;
    if (threadIdx.x == 0 && k == 7) sm.prof[gi][7] += t - tphase;
    return t;
#else
    (void)gi;
    (void)k;
    (void)t0;
    return 0;
#endif
  }

  // FD_PROFILE: block 0's clock into slot i (every block's, as a
  // maximum, with `latest`); returns the clock
  __device__ __forceinline__ unsigned long long stamp(int i,
                                                      bool latest = false,
                                                      unsigned long long
                                                          t = 0) {
#ifdef FD_PROFILE
    if (threadIdx.x == 0 && i < 7 * p.H / 2) {
      unsigned long long* out =
          reinterpret_cast<unsigned long long*>(p.h_out + p.H);
      if (!latest) asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
      if (latest)
        atomicMax(out + i, (t & ~0xffull) | blockIdx.x);
      else if (blockIdx.x == 0)
        out[i] = t;
    }
#else
    (void)i;
    (void)latest;
#endif
    return t;
  }

  __device__ __forceinline__ void barrier() {
    const unsigned long long t = stamp(3 * barriers + 1);
    grid_barrier(p.sync, base + static_cast<unsigned long long>(
                             gridDim.x) * (barriers + 1));
    tphase = tick(0, -1, 0);
    stamp(3 * barriers + 2);
    stamp(3 * barriers + 3, true, t);
    ++barriers;
  }

  // LN of h [H] (float32 in global memory) into xs, rounded to bf16.
  // With H <= kThreads * kLN its parameters were loaded into registers
  // at the start of the GEMV phase before it (load_ln): read once a
  // token, they are never in L2, and an HBM load waits behind the
  // weight stream.  (Held through the attention phases too, they cost
  // the bf16 instance spills.)
  static constexpr int kLN = 4;
  float lng[kLN], lnb[kLN];

  __device__ __forceinline__ void load_ln(int gi, int bi, int l) {
    if (l >= p.L || p.H > kThreads * kLN) return;
    const long long off = static_cast<long long>(l) * p.H;
#pragma unroll
    for (int u = 0; u < kLN; ++u) {
      const int i = threadIdx.x + u * kThreads;
      if (i < p.H) {
        lng[u] = ldp(p.small[gi], off + i, p.small_bf16);
        lnb[u] = ldp(p.small[bi], off + i, p.small_bf16);
      }
    }
  }

  __device__ __forceinline__ void layer_norm(const float* h, int gi,
                                             int bi, int l) {
    const int H = p.H;
    const long long off = static_cast<long long>(l) * H;
    const bool early = H <= kThreads * kLN;
    float s = 0.f;
    if (early) {
      float hv[kLN];
#pragma unroll
      for (int u = 0; u < kLN; ++u) {
        const int i = threadIdx.x + u * kThreads;
        if (i < H) hv[u] = __ldcg(h + i);
      }
#pragma unroll
      for (int u = 0; u < kLN; ++u) {
        const int i = threadIdx.x + u * kThreads;
        if (i < H) {
          xs[i] = hv[u];
          s += hv[u];
        }
      }
    } else {
      for (int i = threadIdx.x; i < H; i += kThreads) {
        const float v = __ldcg(h + i);
        xs[i] = v;
        s += v;
      }
    }
    const float mean = block_sum(s, sm.red) / static_cast<float>(H);
    float q = 0.f;
    for (int i = threadIdx.x; i < H; i += kThreads) {
      const float d = __fsub_rn(xs[i], mean);
      q = __fadd_rn(q, __fmul_rn(d, d));
    }
    const float var = block_sum(q, sm.red) / static_cast<float>(H);
    const float r = 1.0f / sqrtf(__fadd_rn(var, p.eps));
    if (early) {
#pragma unroll
      for (int u = 0; u < kLN; ++u) {
        const int i = threadIdx.x + u * kThreads;
        if (i < H) {
          const float y = __fmul_rn(__fmul_rn(__fsub_rn(xs[i], mean), r),
                                    lng[u]);
          xs[i] = bf16r(__fadd_rn(y, lnb[u]));
        }
      }
    } else {
      for (int i = threadIdx.x; i < H; i += kThreads) {
        const float y = __fmul_rn(__fmul_rn(__fsub_rn(xs[i], mean), r),
                                  ldp(p.small[gi], off + i, p.small_bf16));
        xs[i] = bf16r(__fadd_rn(y, ldp(p.small[bi], off + i,
                                       p.small_bf16)));
      }
    }
    __syncthreads();
  }

  // what column n's epilogue reads besides its sum: the scale, the
  // bias and (proj, fc2) the residual, loaded before the sum completes
  struct Operands {
    float scale, bias, resid;
  };

  __device__ __forceinline__ Operands operands(int gi, int l, int n) {
    const long long i = static_cast<long long>(l) * gv[gi].N + n;
    const int bias[4] = {kQkvB, kProjB, kFc1B, kFc2B};
    Operands o;
    o.scale = p.s[gi][i];
    o.bias = ldp(p.small[bias[gi]], i, p.small_bf16);
    o.resid = 0.f;
    if (gi == 1) o.resid = __ldcg((l == 0 ? p.h0 : p.scratch + ly.hA) + n);
    if (gi == 3) o.resid = __ldcg(p.scratch + ly.hB + n);
    return o;
  }

  // the sum of column n is complete: its epilogue for layer l
  __device__ __forceinline__ void epilogue(int gi, int l, int n, float sum,
                                           const Operands& o) {
    float* sc = p.scratch;
    if (gi == 0) {
      sc[ly.qkv + n] = __fadd_rn(__fmul_rn(sum, o.scale), o.bias);
    } else if (gi == 1) {
      sc[ly.hB + n] = __fadd_rn(
          __fadd_rn(o.resid, __fmul_rn(sum, o.scale)), o.bias);
    } else if (gi == 2) {
      sc[ly.g + n] = bf16r(gelu_tanh(__fadd_rn(__fmul_rn(sum, o.scale),
                                               o.bias)));
    } else {
      const float out = __fadd_rn(
          __fadd_rn(o.resid, __fmul_rn(sum, o.scale)), o.bias);
      sc[ly.hA + n] = out;
      if (l == p.L - 1) p.h_out[n] = out;
    }
  }

  // this block's part of column tile t of GEMV gi: reduce the threads'
  // sums (warps in order) and, alone on the tile, apply the epilogue;
  // else store the part and, if it is the tile's last part to arrive,
  // sum the tile's parts in part order and apply the epilogue
  __device__ __forceinline__ void finish_tile(int gi, int l, int t,
                                              float (&acc)[16],
                                              const Operands& first) {
    const Gemv& G = gv[gi];
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int o = kCPR; o < 32; o <<= 1)
        acc[j] += __shfl_xor_sync(kFull, acc[j], o);
    }
    if (lane < kCPR) {
#pragma unroll
      for (int j = 0; j < 16; ++j) red[warp * kTW + lane * 16 + j] = acc[j];
    }
    long long tf = tick(gi, -1, 0);
    const int tw = min(kTW, G.N - t * kTW);
    const int n = t * kTW + tid;
    Operands o = first;
    if (t != G.t0 && tid < tw) o = operands(gi, l, n);
    __syncthreads();
    float v = 0.f;
    if (tid < tw) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) v += red[w * kTW + tid];
    }
    tf = tick(gi, 4, tf);
    if (G.m == 1) {
      if (tid < tw) epilogue(gi, l, n, v, o);
    } else {
      float* part = p.scratch + ly.part
                    + static_cast<long long>(t) * G.m * kTW + tid;
      if (tid < tw) part[G.part * kTW] = v;
      __syncthreads();
      tf = tick(gi, 5, tf);
      if (tid == 0) {
        unsigned* cnt = p.sync + kTileCnt + t;
        const unsigned old = atom_add_acq_rel(cnt, 1u);
        sm.last = old == static_cast<unsigned>(G.m - 1);
        if (sm.last) atomicExch(cnt, 0u);
      }
      __syncthreads();
      tf = tick(gi, 6, tf);
      if (sm.last && tid < tw) {
        float sum = 0.f;
        for (int j0 = 0; j0 < G.m; j0 += kAhead) {
          float v8[kAhead];
#pragma unroll
          for (int u = 0; u < kAhead; ++u)
            v8[u] = j0 + u < G.m ? __ldcg(part + (j0 + u) * kTW) : 0.f;
#pragma unroll
          for (int u = 0; u < kAhead; ++u)
            if (j0 + u < G.m) sum += v8[u];
        }
        epilogue(gi, l, n, sum, o);
      }
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[j] = 0.f;
  }

  // GEMV gi of layer l over this block's tiles, from the ring, against
  // xs (bf16-rounded floats); every consumed stage is refilled with the
  // stream's next one at once
  __device__ __forceinline__ void gemv(int gi, int l) {
    const Gemv& G = gv[gi];
    const int c = threadIdx.x % kCPR;
    const int rr = threadIdx.x / kCPR;
    const uint32_t ring0 = smem_u32(ring) + c * 16;
    const uint32_t xs0 = smem_u32(xs);
    float acc[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[j] = 0.f;
    // the first tile's epilogue operands, loaded while the GEMV runs
    Operands first;
    if (G.nseg && threadIdx.x < min(kTW, G.N - G.t0 * kTW))
      first = operands(gi, l, G.t0 * kTW + threadIdx.x);
    long long t0 = tick(gi, 7, 0);
    while (cc.l == l && cc.g == gi) {
      const Stage st = stage_at(cc, G);
      const int slot = cslot;
      mbar_wait(full + slot, parity);
      if (++cslot == p.stages) {
        cslot = 0;
        parity ^= 1u;
      }
      t0 = tick(gi, 0, t0);
      if (c < min(kTW, G.N - st.t * kTW) / 16) {
        const uint32_t base = ring0 + slot * kStageBytes;
        const uint32_t xb = xs0 + st.k * 4;
        for (int r0 = rr; r0 < st.n; r0 += kRowsAhead * kRG) {
          uint4 w[kRowsAhead];
          float xv[kRowsAhead];
#pragma unroll
          for (int u = 0; u < kRowsAhead; ++u) {
            const int row = r0 + u * kRG;
            if (row < st.n) {
              w[u] = lds128(base + row * kTW);
              xv[u] = lds32(xb + row * 4);
            }
          }
#pragma unroll
          for (int u = 0; u < kRowsAhead; ++u) {
            if (r0 + u * kRG < st.n) {
              const unsigned words[4] = {
                  w[u].x ^ 0x80808080u, w[u].y ^ 0x80808080u,
                  w[u].z ^ 0x80808080u, w[u].w ^ 0x80808080u};
#pragma unroll
              for (int i = 0; i < 4; ++i) {
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                  // bf16 x int8 is exact in float32: the FMA rounds
                  // once, as a product then a sum would
                  acc[4 * i + j] = fmaf(xv[u], byte_to_float(words[i], j),
                                        acc[4 * i + j]);
                }
              }
            }
          }
        }
      }
      t0 = tick(gi, 1, t0);
      const int i0 = cc.i;
      advance(cc, st, gv, p.L);
      __syncthreads();   // the slot is read: refill it
      issue();
      t0 = tick(gi, 2, t0);
      if (!(cc.l == l && cc.g == gi && cc.i == i0)) {
        finish_tile(gi, l, st.t, acc, first);
        t0 = tick(gi, 3, t0);
      }
    }
  }
};

template <int MODE>
__device__ float store_new(void* cache, float* scales, long long row_off,
                           long long scale_off, float x, int hD,
                           float* red) {
  const int d = threadIdx.x;
  if constexpr (MODE == kInt8) {
    const float amax = block_max(d < hD ? fabsf(x) : 0.f, red);
    const float s = fmaxf(amax, 1e-8f) / 127.0f;
    const float q = fminf(fmaxf(rintf(x / s), -127.f), 127.f);
    if (d < hD) static_cast<int8_t*>(cache)[row_off + d] = static_cast<int8_t>(q);
    if (d == 0) scales[scale_off] = s;
    return __fmul_rn(q, s);
  } else if constexpr (MODE == kFP8) {
    const uint8_t b = float_to_fp8(x);
    if (d < hD) static_cast<uint8_t*>(cache)[row_off + d] = b;
    return fp8_to_float(b);
  } else if constexpr (MODE == kBF16) {
    if (d < hD)
      static_cast<__nv_bfloat16*>(cache)[row_off + d] = __float2bfloat16_rn(x);
    return x;
  } else {
    if (d < hD) static_cast<float*>(cache)[row_off + d] = x;
    return x;
  }
}

// phase S, one per head: the new K/V row stored, the new V as attended
// and the new token's score
template <int MODE>
__device__ __forceinline__ void new_row(Block& bk, int l, int hh, int pos) {
  const Params& p = bk.p;
  const int H = p.H;
  const int hD = H / p.nH;
  const int tid = threadIdx.x;
  const float* qkv = p.scratch + bk.ly.qkv;
  float kraw = 0.f, vraw = 0.f, qs = 0.f;
  if (tid < hD) {
    qs = __fmul_rn(__ldcg(qkv + hh * hD + tid), p.scale);
    kraw = __ldcg(qkv + H + hh * hD + tid);
    vraw = __ldcg(qkv + 2 * H + hh * hD + tid);
  }
  const long long row = static_cast<long long>(l) * p.T + pos;
  const long long row_off = row * H + hh * hD;
  const long long sc_off = row * p.nH + hh;
  const float kn = store_new<MODE>(p.ck, p.ks, row_off, sc_off, kraw, hD,
                                   bk.sm.red);
  const float vn = store_new<MODE>(p.cv, p.vs, row_off, sc_off, vraw, hD,
                                   bk.sm.red);
  const float sn = block_sum(tid < hD ? __fmul_rn(qs, kn) : 0.f, bk.sm.red);
  if (tid < hD) p.scratch[bk.ly.vn + hh * hD + tid] = vn;
  if (tid == 0) p.scratch[bk.ly.sn + hh] = sn;
}

constexpr int kUnroll = 4;   // row groups a warp loads before using them

// phase S, item (head hh, tile j): float32 scores of the history rows
// [j tr, min((j+1) tr, pos)) and the tile's maximum
template <int MODE>
__device__ __forceinline__ void score_item(Block& bk, int l, int hh, int j,
                                           int tr, int pos) {
  using KVM = KV<MODE>;
  constexpr int VPL = KVM::kVPL;
  const Params& p = bk.p;
  const int H = p.H;
  const int hD = H / p.nH;
  const int tid = threadIdx.x;
  if (tid < hD)
    bk.sm.qb[tid] = bf16r(__fmul_rn(
        __ldcg(p.scratch + bk.ly.qkv + hh * hD + tid), p.scale));
  __syncthreads();
  const int lpr = hD * KVM::kElem / 16;    // lanes of a row
  const int rpw = 32 / lpr;                // rows of a warp
  const int lane = tid & 31;
  const int c = lane % lpr;
  const int rsub = lane / lpr;
  float q[VPL];
#pragma unroll
  for (int v = 0; v < VPL; ++v) q[v] = bk.sm.qb[c * VPL + v];
  const int r0 = j * tr;
  const int r1 = min(pos, r0 + tr);
  const long long lt = static_cast<long long>(l) * p.T;
  const uint8_t* ck = static_cast<const uint8_t*>(p.ck);
  float* S = p.scratch + bk.ly.s + static_cast<long long>(hh) * p.T;
  const int step = kWarps * rpw;
  float mx = kNegInf;
  for (int base = r0 + (tid >> 5) * rpw + rsub; base - rsub < r1;
       base += step * kUnroll) {
    uint4 raw[kUnroll];
    float ksc[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = base + u * step;
      ksc[u] = 1.f;
      if (r < r1) {
        const long long row = lt + r;
        raw[u] = *reinterpret_cast<const uint4*>(
            ck + ((row * H + hh * hD) * KVM::kElem + c * 16));
        if constexpr (MODE == kInt8) ksc[u] = p.ks[row * p.nH + hh];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = base + u * step;
      float s = 0.f;
      if (r < r1) {
        float kv[VPL];
        dequant16<MODE>(raw[u], ksc[u], kv);
#pragma unroll
        for (int v = 0; v < VPL; ++v) s = fmaf(q[v], kv[v], s);
      }
      for (int o = lpr >> 1; o > 0; o >>= 1)
        s += __shfl_xor_sync(kFull, s, o);
      if (r < r1) {
        if (c == 0) S[r] = s;
        mx = fmaxf(mx, s);
      }
    }
  }
  mx = block_max(mx, bk.sm.red);
  if (tid == 0) p.scratch[bk.ly.tm + hh * bk.ly.mt + j] = mx;
  __syncthreads();   // qb is rewritten by the next item
}

// phase V, item (hh, j): p = bf16(exp(s - M_c)) against the running
// maximum through the tile's chunk; the tile's P.V (float32, [hD]) and
// sum of the unrounded p
template <int MODE>
__device__ __forceinline__ void pv_item(Block& bk, int l, int hh, int j,
                                        int tr, int pos) {
  using KVM = KV<MODE>;
  constexpr int VPL = KVM::kVPL;
  const Params& p = bk.p;
  const int H = p.H;
  const int hD = H / p.nH;
  const int tid = threadIdx.x;
  const int r0 = j * tr;
  const int r1 = min(pos, r0 + tr);
  const int chunk_end = min(pos, (r0 / kChunk + 1) * kChunk);
  const int jend = (chunk_end + tr - 1) / tr;
  const float* TM = p.scratch + bk.ly.tm + hh * bk.ly.mt;
  float M = kNegInf;
  for (int j0 = 0; j0 < jend; j0 += kAhead) {
    float m8[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u)
      m8[u] = j0 + u < jend ? __ldcg(TM + j0 + u) : kNegInf;
#pragma unroll
    for (int u = 0; u < kAhead; ++u) M = fmaxf(M, m8[u]);
  }
  const int lpr = hD * KVM::kElem / 16;
  const int rpw = 32 / lpr;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int c = lane % lpr;
  const int rsub = lane / lpr;
  const long long lt = static_cast<long long>(l) * p.T;
  const uint8_t* cv = static_cast<const uint8_t*>(p.cv);
  const float* S = p.scratch + bk.ly.s + static_cast<long long>(hh) * p.T;
  const int step = kWarps * rpw;
  float acc[VPL];
#pragma unroll
  for (int v = 0; v < VPL; ++v) acc[v] = 0.f;
  float ls = 0.f;
  for (int base = r0 + warp * rpw + rsub; base - rsub < r1;
       base += step * kUnroll) {
    uint4 raw[kUnroll];
    float vsc[kUnroll];
    float sr[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = base + u * step;
      vsc[u] = 1.f;
      sr[u] = 0.f;
      if (r < r1) {
        const long long row = lt + r;
        raw[u] = *reinterpret_cast<const uint4*>(
            cv + ((row * H + hh * hD) * KVM::kElem + c * 16));
        if constexpr (MODE == kInt8) vsc[u] = p.vs[row * p.nH + hh];
        sr[u] = __ldcg(S + r);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = base + u * step;
      if (r < r1) {
        const float pr = expf(sr[u] - M);
        const float pb = bf16r(pr);
        float vv[VPL];
        dequant16<MODE>(raw[u], vsc[u], vv);
#pragma unroll
        for (int v = 0; v < VPL; ++v) acc[v] = fmaf(pb, vv[v], acc[v]);
        if (c == 0) ls += pr;
      }
    }
  }
#pragma unroll
  for (int v = 0; v < VPL; ++v) {
    for (int o = lpr; o < 32; o <<= 1)
      acc[v] += __shfl_xor_sync(kFull, acc[v], o);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ls += __shfl_xor_sync(kFull, ls, o);
  if (lane < lpr) {
#pragma unroll
    for (int v = 0; v < VPL; ++v) bk.red[warp * hD + c * VPL + v] = acc[v];
  }
  if (lane == 0) bk.sm.red[warp] = ls;
  __syncthreads();
  const long long item = static_cast<long long>(hh) * bk.ly.mt + j;
  if (tid < hD) {
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) a += bk.red[w * hD + tid];
    p.scratch[bk.ly.acc + item * hD + tid] = a;
  }
  if (tid == 0) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t += bk.sm.red[w];
    p.scratch[bk.ly.ls + item] = t;
  }
  __syncthreads();   // red is rewritten by the next item
}

// attention output d of head hh from the items' partials: the chunks in
// order through the TPU kernel's running-max recurrence, then the new
// token; rounded to bf16 into xs (the proj GEMV's input)
__device__ __forceinline__ void merge_one(Block& bk, int hh, int d,
                                          int pos) {
  const Params& p = bk.p;
  const int hD = p.H / p.nH;
  const AttnPlan ap = attn_plan(pos, p.nH, gridDim.x);
  const int per = kChunk / ap.tr;
  const long long base = static_cast<long long>(hh) * bk.ly.mt;
  const float* TM = p.scratch + bk.ly.tm + base;
  const float* LS = p.scratch + bk.ly.ls + base;
  const float* ACC = p.scratch + bk.ly.acc + base * hD + d;
  const float s_n = __ldcg(p.scratch + bk.ly.sn + hh);
  const float vn = __ldcg(p.scratch + bk.ly.vn + hh * hD + d);
  float m = kNegInf;
  float lsum = 0.f;
  float acc = 0.f;
  for (int j0 = 0; j0 < ap.ntiles; j0 += per) {
    const int j1 = min(ap.ntiles, j0 + per);
    float cm = kNegInf, ps = 0.f, pv = 0.f;
    for (int jb = j0; jb < j1; jb += kAhead) {
      float tm[kAhead], ls[kAhead], av[kAhead];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        if (jb + u < j1) {
          tm[u] = __ldcg(TM + jb + u);
          ls[u] = __ldcg(LS + jb + u);
          av[u] = __ldcg(ACC + static_cast<long long>(jb + u) * hD);
        }
      }
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        if (jb + u < j1) {
          cm = fmaxf(cm, tm[u]);
          ps += ls[u];
          pv += av[u];
        }
      }
    }
    const float m_new = fmaxf(m, cm);
    const float corr = expf(m - m_new);
    lsum = __fadd_rn(__fmul_rn(lsum, corr), ps);
    acc = __fadd_rn(__fmul_rn(acc, corr), pv);
    m = m_new;
  }
  const float m_new = fmaxf(m, s_n);
  const float p_n = expf(s_n - m_new);
  const float corr = expf(m - m_new);
  lsum = __fadd_rn(__fmul_rn(lsum, corr), p_n);
  acc = __fadd_rn(__fmul_rn(acc, corr), __fmul_rn(p_n, vn));
  bk.xs[hh * hD + d] = bf16r(acc / lsum);
}

template <int MODE>
__global__ void __launch_bounds__(kThreads, 1)
fused_decode_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(128) uint8_t dsm[];
  __shared__ Smem sm;
  const int H = p.H;
  const int pos = *p.pos;
  const int tid = threadIdx.x;
  const int G = gridDim.x;
  if (blockIdx.x == 0) {
    for (int i = tid; i < 7 * H; i += kThreads) p.h_out[H + i] = 0.f;
  }
  if (pos < 0 || pos >= p.T) {
    // no write at all; a NaN row 0 tells the caller (uniform exit: no
    // block reaches a barrier)
    if (blockIdx.x == 0) {
      for (int i = tid; i < H; i += kThreads) p.h_out[i] = nanf("");
    }
    return;
  }
#ifdef FD_PROFILE
  const long long clock0 = clock64();
  if (tid < 32) sm.prof[tid / 8][tid % 8] = 0;
#endif
  if (tid == 0) {
    smem_setup(p, sm);
    // fewer than a grid of this launch's arrivals can be in already
    const unsigned long long n = ld_acquire64(
        reinterpret_cast<const unsigned long long*>(p.sync + kBarCount));
    sm.base = n - n % G;
    for (int s = 0; s < p.stages; ++s)
      mbar_init(reinterpret_cast<uint64_t*>(dsm) + s, kCopiers);
  }
  __syncthreads();
  Block bk(p, dsm, sm, sm.base);
  bk.tphase = bk.tick(0, -1, 0);
  bk.stamp(0);
  for (int s = 0; s < p.stages; ++s) bk.issue();

  bk.load_ln(kLn1G, kLn1B, 0);
  const int hD = H / p.nH;
  const AttnPlan ap = attn_plan(pos, p.nH, G);
  const int items = p.nH * ap.ntiles;
  float* sc = p.scratch;
  for (int l = 0; l < p.L; ++l) {
    // LN1 + qkv (epilogue: q, k, v)
    bk.layer_norm(l == 0 ? p.h0 : sc + bk.ly.hA, kLn1G, kLn1B, l);
    bk.gemv(0, l);
    bk.barrier();
    // S: scores and tile maxima; the new K/V rows
    for (int i = blockIdx.x; i < items; i += G)
      score_item<MODE>(bk, l, i % p.nH, i / p.nH, ap.tr, pos);
    // the new rows on the blocks after the items' ones
    for (int hh = ((static_cast<int>(blockIdx.x) - items) % G + G) % G;
         hh < p.nH; hh += G)
      new_row<MODE>(bk, l, hh, pos);
    bk.barrier();
    // V: P.V partials
    for (int i = blockIdx.x; i < items; i += G)
      pv_item<MODE>(bk, l, i % p.nH, i / p.nH, ap.tr, pos);
    bk.barrier();
    // merge the heads of this block's proj rows; proj (epilogue: h2)
    bk.load_ln(kLn2G, kLn2B, l);
    if (sm.gv[1].nseg) {
      const int h0 = sm.gv[1].k0 / hD;
      const int n = ((sm.gv[1].k1 - 1) / hD - h0 + 1) * hD;
      for (int i = tid; i < n; i += kThreads)
        merge_one(bk, h0 + i / hD, i % hD, pos);
    }
    __syncthreads();
    bk.gemv(1, l);
    bk.barrier();
    // LN2 + fc1 (epilogue: g)
    bk.layer_norm(sc + bk.ly.hB, kLn2G, kLn2B, l);
    bk.gemv(2, l);
    bk.barrier();
    // fc2 on this block's rows of g (epilogue: h)
    bk.load_ln(kLn1G, kLn1B, l + 1);
    if (sm.gv[3].nseg) {
      for (int k = sm.gv[3].k0 + tid; k < sm.gv[3].k1; k += kThreads)
        bk.xs[k] = __ldcg(sc + sm.ly.g + k);
    }
    __syncthreads();
    bk.gemv(3, l);
    if (l + 1 < p.L) bk.barrier();
  }
  bk.stamp(3 * bk.barriers + 1);
#ifdef FD_PROFILE
  if (blockIdx.x == 0 && tid == 0) {
    unsigned long long* out = reinterpret_cast<unsigned long long*>(
        p.h_out + H) + 3 * bk.barriers + 2;
    for (int i = 0; i < 32; ++i) out[i] = sm.prof[i / 8][i % 8];
    out[32] = clock0;
    out[33] = clock64();
  }
#endif
  if (blockIdx.x == 0 && tid == 0) p.sync[kBarDone] = bk.barriers;
}

const void* kernel_of(int mode) {
  switch (mode) {
    case kF32: return reinterpret_cast<const void*>(fused_decode_kernel<kF32>);
    case kBF16: return reinterpret_cast<const void*>(fused_decode_kernel<kBF16>);
    case kInt8: return reinterpret_cast<const void*>(fused_decode_kernel<kInt8>);
    case kFP8: return reinterpret_cast<const void*>(fused_decode_kernel<kFP8>);
    default: return nullptr;
  }
}

// dynamic shared memory beside the ring: mbarriers, xs, red
int fixed_smem(int H, int F) {
  return kBarBytes + (H > F ? H : F) * 4 + kWarps * kTW * 4;
}

bool widths_ok(int H, int F) {
  return H > 0 && F > 0 && H % 16 == 0 && F % 16 == 0 && H <= kMaxWidth
         && F <= kMaxWidth;
}

}  // namespace

// The cooperative grid for these widths on the current device: one
// block of `threads` an SM, and the ring stages that fit beside the
// rest of the block's shared memory (`smem` dynamic bytes).  It also
// lets every instance take the most dynamic shared memory a block can
// have, so a launch at any planned width needs no attribute call of its
// own.  Returns a CUDA error code (cudaErrorNotSupported without
// cooperative launch).
extern "C" int pt_fused_decode_plan(int H, int F, int* grid, int* threads,
                                    int* stages, int* smem) {
  if (!widths_ok(H, F)) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  int sms = 0;
  int coop = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  int static_smem = 0;
  for (int mode = 0; mode < 4; ++mode) {
    cudaFuncAttributes a;
    e = cudaFuncGetAttributes(&a, kernel_of(mode));
    if (e != cudaSuccess) return static_cast<int>(e);
    static_smem = static_cast<int>(a.sharedSizeBytes) > static_smem
                      ? static_cast<int>(a.sharedSizeBytes) : static_smem;
  }
  const int avail = kSmemLimit - static_smem;
  int ns = (avail - fixed_smem(H, F)) / kStageBytes;
  ns = ns > kMaxStages ? kMaxStages : ns;
  if (ns < 2) return static_cast<int>(cudaErrorInvalidValue);
  const int dyn = fixed_smem(H, F) + ns * kStageBytes;
  for (int mode = 0; mode < 4; ++mode) {
    e = cudaFuncSetAttribute(kernel_of(mode),
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             avail);
    int n = 0;
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, kernel_of(mode), kThreads, dyn);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (n < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  }
  *grid = sms;
  *threads = kThreads;
  *stages = ns;
  *smem = dyn;
  return 0;
}

// The scratch (float32 values) and sync buffer (zeroed int32 values) a
// launch of `grid` blocks needs at these shapes; the GEMV column tile.
extern "C" int pt_fused_decode_scratch(int H, int F, int T, int nH, int grid,
                                       long long* floats, int* ints,
                                       int* tile) {
  if (!widths_ok(H, F) || T < 1 || nH < 1 || grid < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  *floats = layout(H, F, T, nH, grid).total;
  *ints = sync_ints(H, F);
  *tile = kTW;
  return 0;
}

// One token through all L layers in one cooperative launch on `stream`
// (no synchronisation, nothing allocated).  small_bf16: the biases and
// LN params are bfloat16 (else float32).  kv_mode: 0 float32, 1
// bfloat16, 2 int8 (ks/vs scale planes required), 3 float8_e4m3.  grid
// and stages come from pt_fused_decode_plan, which must have run on
// this device first (it sets the shared memory limit); scratch and sync
// are sized by pt_fused_decode_scratch, sync zeroed before its first
// launch (every launch leaves its tile counters at 0, adds grid x
// barriers to the arrival count in slots 0-1 and writes its barriers
// into slot 2).  Returns cudaErrorInvalidValue for arguments
// outside the kernel's contract, the error of a refused cooperative
// launch, or cudaGetLastError().
extern "C" int pt_fused_decode(
    const void* h0, const void* qkv_q, const void* proj_q, const void* fc1_q,
    const void* fc2_q, const void* qkv_s, const void* proj_s,
    const void* fc1_s, const void* fc2_s, const void* qkv_b,
    const void* proj_b, const void* fc1_b, const void* fc2_b,
    const void* ln1_g, const void* ln1_b, const void* ln2_g,
    const void* ln2_b, void* ck, void* cv, void* ks, void* vs,
    const void* pos, void* h_out, void* scratch, void* sync, int L, int H,
    int F, int nH, int T, int small_bf16, int kv_mode, float eps,
    float scale, int grid, int stages, long long scratch_len, int sync_len,
    void* stream) {
  if (!widths_ok(H, F) || L < 1 || nH < 1 || H % nH || T < 1 || grid < 1
      || kernel_of(kv_mode) == nullptr || stages < 2
      || stages > kMaxStages) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int hD = H / nH;
  if (hD % 16 || hD > kMaxHD
      || scratch_len < layout(H, F, T, nH, grid).total
      || sync_len < sync_ints(H, F)
      || fixed_smem(H, F) + stages * kStageBytes > kSmemLimit
      || (kv_mode == kInt8 && (ks == nullptr || vs == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.h0 = static_cast<const float*>(h0);
  p.w[0] = static_cast<const int8_t*>(qkv_q);
  p.w[1] = static_cast<const int8_t*>(proj_q);
  p.w[2] = static_cast<const int8_t*>(fc1_q);
  p.w[3] = static_cast<const int8_t*>(fc2_q);
  p.s[0] = static_cast<const float*>(qkv_s);
  p.s[1] = static_cast<const float*>(proj_s);
  p.s[2] = static_cast<const float*>(fc1_s);
  p.s[3] = static_cast<const float*>(fc2_s);
  const void* small[8] = {qkv_b, proj_b, fc1_b, fc2_b,
                          ln1_g, ln1_b, ln2_g, ln2_b};
  for (int i = 0; i < 8; ++i) p.small[i] = small[i];
  p.ck = ck;
  p.cv = cv;
  p.ks = static_cast<float*>(ks);
  p.vs = static_cast<float*>(vs);
  p.pos = static_cast<const int*>(pos);
  p.h_out = static_cast<float*>(h_out);
  p.scratch = static_cast<float*>(scratch);
  p.sync = static_cast<unsigned*>(sync);
  p.L = L;
  p.H = H;
  p.F = F;
  p.nH = nH;
  p.T = T;
  p.small_bf16 = small_bf16;
  p.stages = stages;
  p.eps = eps;
  p.scale = scale;
  void* args[] = {&p};
  cudaError_t e = cudaLaunchCooperativeKernel(
      kernel_of(kv_mode), dim3(grid), dim3(kThreads), args,
      static_cast<size_t>(fixed_smem(H, F) + stages * kStageBytes),
      static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// Keyed Gumbel-max draw of one token a row, JAX's threefry stream
// (sm_90a).  Wrapper: paddle_tpu_torch/incubate/nn/kernels/sampling.py;
// plain version: sampling.gumbel_argmax_plain (models/prng.py).
//
// Replaces no TPU kernel: the JAX package draws in XLA
// (jax.random.categorical inside paddle_tpu/models/decoding.py
// sample_token :46 and _sample_one :55), with no Pallas kernel.  The
// port adds one because the plain composition is ~150 elementwise
// launches over [rows, V] int64 tensors a draw, and one launch keeps
// the draw on the device and capturable in a CUDA graph.
//
// Function: filtered float32 logits [R, V] -> int32 tokens [R].  Row r
// draws argmax_j(logit_j + g_j), the first index among equal maxima (a
// NaN score counts as the largest, as XLA's and torch's argmax do; -0
// equals +0), g_j = -logf(-logf(u_j)) and u_j the float32 uniform of
// [tiny, 1) that jax.random.uniform builds from bits_j =
// o0 ^ o1, (o0, o1) = threefry2x32(key_r, (hi, lo) of base_r + j).
// Keys: the engines' rule, key_r = fold_in(PRNGKey(seeds[b]), pos[b] +
// w) for row r = b * window + w, base_r = 0 (derived here from device
// seeds and positions: no host sync, no key tensor); or the generate
// rule, one key (two uint32 words in int64) for the whole [R, V] draw,
// base_r = r * V (jax.random.categorical(key, logits[R, V])).
//
// Numerics: threefry is integer arithmetic, bit for bit JAX's; the
// uniform is (bits >> 9 | 0x3F800000) as a float minus 1, plus tiny
// (maxval - minval rounds to 1.0f, so the product is exact), at least
// tiny; logf is CUDA's accurate logf (no __logf, no fast math): like
// XLA:CPU's log it is not correctly rounded, so the noise can differ
// from JAX's and from torch.log by an ulp, which moves a token only at
// a near-tie of two perturbed scores.
//
// Bound: per element 4 bytes read and one trip of the loop, which nvcc
// 12.9 makes 144 instructions: 69 on the ALU alone (20 funnel-shift
// rotates, 25 LOP3, the compares and selects of the logs and the
// pack), 11 integer adds that may sit on the ALU or FMA-heavy pipe,
// 29 IMAD (the adds nvcc moves to FMA-heavy), 33 float32 (two
// polynomial logfs), a load and a branch.  No pipe is full before the
// issue slots are: an SM issues 128 thread instructions a clock, so an
// element takes at least 144 / 128 = 1.125 SM clocks (1.73 us for
// [8, 50304] on 132 SMs at 1.98 GHz, against 0.48 us of bytes).
// chip_smoke.py counts this from the built library's SASS each run
// (sass_loop_issue).  Design: V is cut into chunks of whole
// 256-thread passes so that every row spreads over enough blocks to
// fill the card; each block reduces its chunk to one 64-bit key
// (order-preserving score bits << 32 | ~index) and atomicMax-es it
// into the row's slot; the row's last block (a ticket counter) reads
// the slot, writes the token and zeroes slot and ticket for the next
// launch, so a draw is one launch.  The chunking never changes a
// token: the max of the keys is exact and order-free.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kTiny = 1.17549435e-38f;   // float32 smallest normal

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// threefry2x32, 20 rounds, in place on (x0, x1)
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0;
  x1 += k1;
#define PT_ROUND(r) x0 += x1; x1 = rotl(x1, r) ^ x0;
#define PT_GROUP_A PT_ROUND(13) PT_ROUND(15) PT_ROUND(26) PT_ROUND(6)
#define PT_GROUP_B PT_ROUND(17) PT_ROUND(29) PT_ROUND(16) PT_ROUND(24)
  PT_GROUP_A
  x0 += k1; x1 += k2 + 1u;
  PT_GROUP_B
  x0 += k2; x1 += k0 + 2u;
  PT_GROUP_A
  x0 += k0; x1 += k1 + 3u;
  PT_GROUP_B
  x0 += k1; x1 += k2 + 4u;
  PT_GROUP_A
  x0 += k2; x1 += k0 + 5u;
#undef PT_GROUP_B
#undef PT_GROUP_A
#undef PT_ROUND
}

// jax.random.gumbel's "low" mode from one word of random bits
__device__ __forceinline__ float gumbel_of(uint32_t bits) {
  const float f = __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
  const float u = fmaxf(kTiny, __fadd_rn(f, kTiny));
  return -logf(-logf(u));
}

// order-preserving key of (score, index): larger score first, then the
// smaller index; NaN above everything, -0 as +0
__device__ __forceinline__ unsigned long long pack(float s, uint32_t j) {
  uint32_t b = __float_as_uint(s);
  if (b == 0x80000000u) b = 0u;
  const uint32_t k = (s != s) ? 0xFFFFFFFFu
                              : ((b & 0x80000000u) ? ~b : (b | 0x80000000u));
  return (static_cast<unsigned long long>(k) << 32) | (0xFFFFFFFFu - j);
}

__device__ __forceinline__ unsigned long long umax64(unsigned long long a,
                                                     unsigned long long b) {
  return a > b ? a : b;
}

__global__ void __launch_bounds__(kThreads)
sampling_gumbel_argmax_kernel(const float* __restrict__ logits, int V,
                              int chunk, const int* __restrict__ seeds,
                              const int* __restrict__ pos, int window,
                              const long long* __restrict__ key,
                              int* __restrict__ out,
                              unsigned long long* __restrict__ best,
                              unsigned int* __restrict__ ticket) {
  const int row = blockIdx.y;
  uint32_t k0, k1;
  unsigned long long base;
  if (key != nullptr) {
    k0 = static_cast<uint32_t>(key[0]);
    k1 = static_cast<uint32_t>(key[1]);
    base = static_cast<unsigned long long>(row) * static_cast<unsigned>(V);
  } else {
    // fold_in(PRNGKey(seed), p) = threefry2x32((0, seed), (0, p)), with
    // p = pos + w in int32 as JAX adds it
    const int b = row / window;
    const int w = row - b * window;
    uint32_t x0 = 0u, x1 = static_cast<uint32_t>(pos[b] + w);
    threefry2x32(0u, static_cast<uint32_t>(seeds[b]), x0, x1);
    k0 = x0;
    k1 = x1;
    base = 0ull;
  }
  const int j0 = blockIdx.x * chunk;
  const int j1 = min(V, j0 + chunk);
  const float* lrow = logits + static_cast<size_t>(row) * V;
  unsigned long long mine = 0ull;
  for (int j = j0 + threadIdx.x; j < j1; j += kThreads) {
    const unsigned long long c = base + static_cast<unsigned>(j);
    uint32_t x0 = static_cast<uint32_t>(c >> 32);
    uint32_t x1 = static_cast<uint32_t>(c);
    threefry2x32(k0, k1, x0, x1);
    const float s = __fadd_rn(lrow[j], gumbel_of(x0 ^ x1));
    mine = umax64(mine, pack(s, static_cast<uint32_t>(j)));
  }
  for (int o = 16; o > 0; o >>= 1)
    mine = umax64(mine, __shfl_xor_sync(0xFFFFFFFFu, mine, o));
  __shared__ unsigned long long warp_best[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_best[warp] = mine;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long m = warp_best[0];
    for (int i = 1; i < kThreads / 32; ++i) m = umax64(m, warp_best[i]);
    atomicMax(best + row, m);
    __threadfence();
    if (atomicAdd(ticket + row, 1u) == gridDim.x - 1) {
      // every block's atomicMax precedes its ticket: the slot is final
      const unsigned long long v = atomicExch(best + row, 0ull);
      ticket[row] = 0u;
      out[row] = static_cast<int>(0xFFFFFFFFu - static_cast<uint32_t>(v));
    }
  }
}

}  // namespace

extern "C" {

// One draw: R rows of V filtered float32 logits.  Exactly one of
// (seeds, pos) [R / window] int32 and key [2] int64 is given.  best
// [R] uint64 and ticket [R] uint32 are zero before the launch and zero
// again after it.  Returns cudaGetLastError() of the launch.
int pt_gumbel_argmax(const float* logits, int R, int V, int chunk,
                     const int* seeds, const int* pos, int window,
                     const long long* key, int* out,
                     unsigned long long* best, unsigned int* ticket,
                     cudaStream_t stream) {
  const dim3 grid((V + chunk - 1) / chunk, R);
  sampling_gumbel_argmax_kernel<<<grid, kThreads, 0, stream>>>(
      logits, V, chunk, seeds, pos, window, key, out, best, ticket);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

// The decode route ("gemv") of the norm-GEMMs: out = x_n @ W, or the swiglu
// form out = silu(x_n @ wg) * (x_n @ wi) against w_cat = [wi|wg], with
// x_n = round_to<T>(x * rsqrt(mean(x^2) + eps) * w), at M <= SMALL_M rows.
//
// Replaces, at decode, the Pallas kernels kernels/fused.py::rmsnorm_matmul
// and kernels/fused.py::rmsnorm_swiglu of the JAX package, and their int8
// twins kernels/fused.py::rmsnorm_matmul_q8 and rmsnorm_swiglu_q8, which
// reach the same two call sites with an int8 weight and its f32 column
// scales.
//
// Bound on Hopper: the weight's bytes.  At granite-8b's widths W is 50.3 MB
// for qkv ([4096, 6144]), 402.7 MB for the head ([4096, 49152]) and 234.9
// MB for [wi|wg] ([4096, 28672]) in bf16, half of each in int8: 15.0, 120.2
// and 70.1 us at 3.35 TB/s (7.5, 60.1, 35.1 in int8).  Two launches:
//  1. gemv_rows_kernel<T, MODE>, one block a row: the row and w staged in
//     shared memory by 16-byte loads, the row's inverse RMS (row_inv_rms,
//     the moment's cross-lane stage in MODE: the GEMV is the same in every
//     mode), then x_n at T into the workspace, once a call, rounded as the
//     plain version and norm_rows_kernel round it; it also zeroes the
//     split-K tickets, and lets (2) launch at once (a programmatic
//     dependent), so (2) starts streaming W while (1) runs.  The prologue
//     is the caller's (launch_gemv_dependent): attention_decode.cuh's
//     combine takes its place for the attention's wo.
//  2. bf16 activations: norm_gemv_mma_kernel<WT, SWIGLU>.  Eight f32
//     products a weight are too many for the FMA units at the memory's
//     rate (granite-8b's head: 12.2 M FMAs an SM, 54 us at the f32 peak,
//     and an int8 weight halves the bytes, not the products: the first FMA
//     form of this kernel ran at 18% of the f32 peak, 2-5x the bounds on an
//     H100 80GB HBM3 at 700 W), so
//     the products run on mma.sync.m16n8k16 with W as the 16-row operand
//     (out^T = W^T x_n^T: 16 columns of W a tile against 8 rows of x_n,
//     rows 9-16 in a second mma on the same W fragment).  Each warp owns
//     64 columns of W (a half's: threads 0-127 wi, 128-255 wg for swiglu)
//     and streams its K chunk through its own ring of three TMA boxes of
//     4 KB (32 k rows of bf16 with the 128-byte swizzle, read by
//     ldmatrix.trans; 64 k rows of int8 with the 64-byte swizzle, widened
//     to bf16 in registers exactly, as tc_gemm.cuh widens it), each
//     completing on the warp's mbarrier: 64 KB in flight an SM at one
//     block, no barrier between warps.  x_n's fragments come from the
//     workspace (L2), issued before each stage's wait.  An SM holds two
//     blocks.
//     f32 activations: norm_gemv_kernel<T, WT, SWIGLU>, the f32 FMA form
//     (no f32 tensor-core product keeps an f32 sum's digits): a block of
//     256 threads owns 8 column vectors of W (16 bytes each: 4 f32 columns;
//     8 bytes, 8 columns, of int8) in each half, each thread streaming its
//     vector down every 32nd (swiglu: 16th) k row through a private ring
//     of cp.async stages, every weight widened once and used for 8 rows
//     of x_n staged as f32 [k][8] in shared memory.
//  3. K is reduced in a fixed order with no float atomics: inside a warp
//     (the mma's own sum, or the FMA form's butterfly over the lanes of a
//     column vector), across the FMA form's warps in warp order, and
//     across blocks where the column tiles alone would not fill the card
//     (plan_gemv weighs the waves against the partials' traffic): each
//     block writes f32 partials [splits, M, halves x N], and the last
//     block of a column tile to arrive, counted by an integer ticket after
//     __threadfence, sums them in split order.  The result is the same
//     bits from call to call.
//  4. The epilogue: an int8 weight's column scale multiplies the f32 sum
//     after the product; swiglu stores silu(hg) * hi from the same column
//     of wi and wg; the result is cast to T once.
//  5. A float weight that the int8 twin quantizes per call (the JAX
//     package's rmsnorm_matmul_q8 with w_scale=None, kernels/fused.py:1440:
//     granite-8b's bf16 lm_head under the int8 policy) runs the same
//     kernels on W at x's dtype with QF set, after a third launch before
//     (1): q8_scales_kernel<WT>, pass 1, the channel scales
//     max(amax_k |w| / 127, 1e-8) into the workspace.  The GEMV then forms
//     each weight's q = clamp(rint(w / scale), -127, 127) in registers
//     (gemv_quant) as it streams W, sums x_n . q as the int8 form does (q
//     is exact in bf16), and multiplies the f32 sum by the scale in the
//     epilogue: no int8 copy is written, and the K split is the int8
//     route's (plan_gemv_q), so the result is the int8 route's on the
//     int8 weight quantize_weight gives, bit for bit.  Pass 1 finishes
//     before (1) starts (stream order), and (2) reads the scales after its
//     griddepcontrol.wait, which waits for (1).  A bf16 head wide enough to
//     give every SM a strip (granite-8b's) takes norm_gemv_q.cuh's strip
//     kernel instead: W read from DRAM once.
// On the same card the head runs at 1.3x its bound and [wi|wg] at 1.4x;
// the 50 MB qkv at 2.2x and the int8 forms at 2.4-4.6x, where the
// prologue, the first boxes' latency and the split sums' round trips weigh
// against a few microseconds of bytes (chip_smoke.py phase 3).
// The route (gemv_route): M <= SMALL_M, W read [K, N] (the transposed
// table takes norm_gemv_t.cuh's form), a weight at the activations' type
// or int8, N columns of WT a multiple of 16 bytes (swiglu: F) and W
// 16-byte aligned, as TMA needs; the callers check the types.
#pragma once
#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "norm_gemm.cuh"
#include "tc_gemm.cuh"

namespace uisa {

constexpr int GEMV_THREADS = 256;
constexpr int GEMV_MAX_SPLITS = 32;     // plan_gemv's search
constexpr int GEMV_SPLIT_LOADS = 16;    // partials a thread loads at once

// Whether the decode route takes C[M, N] = x_n[M, K] @ W[K, N] (swiglu: N is
// F and W is [K, 2F]) with a W of type WT read [K, N].
template <typename WT>
inline bool gemv_route(int M, int N, const void* W) {
  return M >= 1 && M <= SMALL_M &&
         ((long long)N * (long long)sizeof(WT)) % 16 == 0 &&
         ((uintptr_t)W & 15) == 0;
}

inline long long gemv_align4(long long n) { return (n + 3) / 4 * 4; }

// ---------------------------------------------------------------------------
// the two forms' geometry
// ---------------------------------------------------------------------------

// The f32 FMA form: 8 column vectors (4 f32 or 8 int8 columns) a half, KR k
// rows a step, rows in groups of 8 (blockIdx.z).
template <typename WT, bool SWIGLU>
struct GemvFma {
  static constexpr int NB = SWIGLU ? 2 : 1;
  static constexpr int VECS = 8, ROWS = 8;
  static constexpr int COLS = std::is_same<WT, float>::value ? 4 : 8;
  static constexpr int LB = COLS * (int)sizeof(WT);      // 16, or 8 (int8)
  static constexpr int KR = GEMV_THREADS / NB / VECS;
  static constexpr int SR = KR;                          // k_chunk's unit
  static constexpr int TILE = VECS * COLS;               // a half's columns
  static constexpr int RING = 32 * 1024;
  static constexpr int STAGES = RING / (GEMV_THREADS * LB);   // 8 or 16
  static constexpr int KCAP = 2048;            // the x_n chunk it stages
  static constexpr int RED = ROWS * COLS + 4;  // a padded scratch row
};

// The tensor-core form: 8 warps of 64 columns (a half's: 4 warps each for
// swiglu), each with a ring of STAGES boxes of SR k rows; 16 rows.
template <typename WT, bool SWIGLU>
struct GemvMma {
  static constexpr int NB = SWIGLU ? 2 : 1;
  static constexpr int WARPS = GEMV_THREADS / 32, WH = WARPS / NB;
  static constexpr int WCOLS = 64, ROWS = 16;
  static constexpr int GROUPS = WCOLS / 16;              // mmas a k16 step
  static constexpr int TILE = WH * WCOLS;                // a half's columns
  static constexpr bool kQ8 = std::is_same<WT, int8_t>::value;
  static constexpr int SR = kQ8 ? 64 : 32;               // k rows a box
  static constexpr int ROW_BYTES = WCOLS * (int)sizeof(WT);  // 128 or 64
  static constexpr int BOX_BYTES = SR * ROW_BYTES;           // 4 KB
  static constexpr int STAGES = 3;
  static constexpr int RING = WARPS * STAGES * BOX_BYTES;    // 96 KB
  static_assert(NB * ROWS * TILE * 4 <= RING, "the sums fit the ring");
};

// The grid and the workspace (f32 words: x_n at T, then the partials and
// the tickets when K is split) of one call.
struct GemvPlan {
  int tiles, splits, k_chunk, groups;
  long long xn_words, part_words, ticket_words;
  long long words() const { return xn_words + part_words + ticket_words; }
};

// The K split: the fewest splits whose blocks fill the card, weighing a
// last partial wave (two blocks an SM) against the partials' traffic (8
// bytes a row a column a split, against K weights a column).
template <typename T, typename WT, bool SWIGLU>
inline GemvPlan plan_gemv(int M, int K, int N, int sms) {
  constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value;
  using F = GemvFma<WT, SWIGLU>;
  using G = GemvMma<WT, SWIGLU>;
  constexpr int NB = SWIGLU ? 2 : 1;
  constexpr int TILE = kMma ? G::TILE : F::TILE;
  constexpr int SR = kMma ? G::SR : F::SR;
  constexpr int ROWS = kMma ? G::ROWS : F::ROWS;
  GemvPlan p;
  p.tiles = (N + TILE - 1) / TILE;
  p.groups = (M + ROWS - 1) / ROWS;
  const long long base = (long long)p.tiles * p.groups, slots = 2LL * sms;
  int least = 1;
  if (!kMma) least = (K + F::KCAP - 1) / F::KCAP;
  int most = K / (2 * SR);                           // two steps a block
  most = most < GEMV_MAX_SPLITS ? most : GEMV_MAX_SPLITS;
  most = most > least ? most : least;
  double best = 1e30;
  int s_best = least;
  for (int s = least; s <= most; ++s) {
    const long long blocks = base * s;
    const double eff =
        blocks <= slots
            ? (blocks >= sms ? 1.0 : (double)blocks / sms)
            : (double)blocks / ((double)((blocks + slots - 1) / slots) * slots);
    const double traffic =
        s > 1 ? 8.0 * M * s / ((double)K * sizeof(WT)) : 0.0;
    const double cost = (1.0 + traffic) / eff;
    if (cost < best - 1e-9) {
      best = cost;
      s_best = s;
    }
  }
  const int per = (K + s_best - 1) / s_best;
  p.k_chunk = (per + SR - 1) / SR * SR;
  p.splits = (K + p.k_chunk - 1) / p.k_chunk;
  p.xn_words = gemv_align4(((long long)M * K * (long long)sizeof(T) + 3) / 4);
  p.part_words =
      p.splits > 1 ? gemv_align4((long long)p.splits * M * NB * N) : 0;
  p.ticket_words = p.splits > 1 ? gemv_align4(base) : 0;
  return p;
}

// The plan of a float W quantized in the stream (QF): the int8 route's K
// split, so the K sums run in its order, over the float form's column
// tiles; the workspace then holds the [N] f32 scales after p.words().
template <typename T>
inline GemvPlan plan_gemv_q(int M, int K, int N, int sms) {
  GemvPlan p = plan_gemv<T, int8_t, false>(M, K, N, sms);
  if constexpr (!std::is_same<T, __nv_bfloat16>::value) {
    constexpr int TILE = GemvFma<float, false>::TILE;
    p.tiles = (N + TILE - 1) / TILE;
    p.ticket_words =
        p.splits > 1 ? gemv_align4((long long)p.tiles * p.groups) : 0;
  }
  return p;
}

// ---------------------------------------------------------------------------
// the quantizer of a float weight (QF)
// ---------------------------------------------------------------------------

// q = clamp(rint(w / s), -127, 127) as an f32 integer, the JAX package's
// quantize_weight element for element (round half to even), with y =
// __frcp_rn(s) computed once a channel.  The quotient is IEEE's RN(w / s),
// not a reciprocal's product: q0 = RN(w y) is within two ulps of w / s;
// one correction q1 = RN(q0 + RN(w - s q0) y) leaves it within one ulp
// (faithful: the residual's rounding is 2^-24 of a term under 2 ulps);
// and by Markstein's theorem (division with an FMA: q faithful, y =
// RN(1/s), then r = w - s q is exact and RN(q + r y) = RN(w / s)) the
// second correction, q2 = RN(q1 + r y), is RN(w / s).  Nothing overflows
// (s >= 1e-8 and |w| <= 127 s, up to the scale's rounding), and where w or
// the quotient underflows, |w / s| < 2^-99 and every step gives q = 0.
// Then the clamp (rint and the clamp commute at the integers +-127), and
// rint as (v + 1.5 2^23) - 1.5 2^23, exact with ties to even for |v| <=
// 2^22.  tests/test_torch_q8_head_numerics.py emulates the steps against
// IEEE division over every finite bf16 and random f32 weights; the card
// tests hold the kernels' results to quantize_weight's int8 route.
__device__ __forceinline__ float gemv_quant(float w, float s, float y) {
  float q = __fmul_rn(w, y);
  q = fmaf(fmaf(-s, q, w), y, q);
  q = fmaf(fmaf(-s, q, w), y, q);
  q = fminf(fmaxf(q, -127.f), 127.f);
  return __fsub_rn(__fadd_rn(q, 12582912.f), 12582912.f);
}

// a bf16 pair (low half: element 0) quantized by one channel's (s, y): q
// is an integer of at most 7 bits, so its f32's high half is its bf16
__device__ __forceinline__ uint32_t gemv_quant_pair(uint32_t v, float s,
                                                    float y) {
  const float lo = gemv_quant(__uint_as_float(v << 16), s, y);
  const float hi = gemv_quant(__uint_as_float(v & 0xffff0000u), s, y);
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// Pass 1 of a float W [K, N] at WT (bf16 or f32), quantized per call: the
// scale of each column, max(amax_k |w| / 127, 1e-8) with amax in f32 and
// IEEE division (the JAX package's quantize_weight).  blockIdx.x owns 8
// column vectors of 16 bytes; its 32 k lanes (thread t: vector t % 8, k
// rows t / 8, + 32, ...) keep the max of |w| as integer bits (a
// non-negative float orders as its bits), eight 16-byte loads in flight a
// thread, then fold through shared memory.  A max is exact in any order,
// so the pass is the same in every mode.  N is a multiple of the vector.
template <typename WT>
__global__ void __launch_bounds__(GEMV_THREADS)
q8_scales_kernel(const WT* __restrict__ W, int K, int N,
                 float* __restrict__ scale) {
  constexpr int E = 16 / (int)sizeof(WT), VECS = 8;
  constexpr int KL = GEMV_THREADS / VECS, LOADS = 8;
  constexpr bool kBf16 = std::is_same<WT, __nv_bfloat16>::value;
  constexpr uint32_t ABS = kBf16 ? 0x7fff7fffu : 0x7fffffffu;
  __shared__ uint32_t red[KL][VECS * E];
  const int v = threadIdx.x % VECS, kl = threadIdx.x / VECS;
  const int c0 = (blockIdx.x * VECS + v) * E;
  uint32_t m[4] = {0u, 0u, 0u, 0u};
  if (c0 < N) {
    const WT* p = W + c0;
    for (int k0 = kl; k0 < K; k0 += LOADS * KL) {
      uint4 u[LOADS];
#pragma unroll
      for (int j = 0; j < LOADS; ++j) {
        const int k = k0 + j * KL;
        u[j] = k < K ? __ldg((const uint4*)(p + (size_t)k * N))
                     : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int j = 0; j < LOADS; ++j) {
        const uint32_t w[4] = {u[j].x & ABS, u[j].y & ABS, u[j].z & ABS,
                               u[j].w & ABS};
#pragma unroll
        for (int i = 0; i < 4; ++i)
          m[i] = kBf16 ? __vmaxu2(m[i], w[i]) : max(m[i], w[i]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (kBf16) {
      red[kl][v * E + 2 * i] = m[i] << 16;
      red[kl][v * E + 2 * i + 1] = m[i] & 0xffff0000u;
    } else {
      red[kl][v * E + i] = m[i];
    }
  }
  __syncthreads();
  const int c = threadIdx.x;
  const int n = blockIdx.x * VECS * E + c;
  if (c < VECS * E && n < N) {
    uint32_t a = 0u;
#pragma unroll 8
    for (int l = 0; l < KL; ++l) a = max(a, red[l][c]);
    scale[n] = fmaxf(__fdiv_rn(__uint_as_float(a), 127.f), 1e-8f);
  }
}

// ---------------------------------------------------------------------------
// the prologue
// ---------------------------------------------------------------------------

// 16 bytes of x_n = round_to<T>(x * s * w) from 16 bytes of x and of w
template <typename T>
__device__ __forceinline__ uint4 gemv_norm16(uint4 x, uint4 w, float s);

template <>
__device__ __forceinline__ uint4 gemv_norm16<float>(uint4 x, uint4 w,
                                                    float s) {
  return make_uint4(
      __float_as_uint(__uint_as_float(x.x) * s * __uint_as_float(w.x)),
      __float_as_uint(__uint_as_float(x.y) * s * __uint_as_float(w.y)),
      __float_as_uint(__uint_as_float(x.z) * s * __uint_as_float(w.z)),
      __float_as_uint(__uint_as_float(x.w) * s * __uint_as_float(w.w)));
}

// a bf16 pair's product, each half rounded to bf16 (low half: element 0)
__device__ __forceinline__ uint32_t gemv_norm_pair(uint32_t x, uint32_t w,
                                                   float s) {
  const float lo = __uint_as_float(x << 16) * s * __uint_as_float(w << 16);
  const float hi = __uint_as_float(x & 0xffff0000u) * s *
                   __uint_as_float(w & 0xffff0000u);
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16(hi)) << 16);
}

template <>
__device__ __forceinline__ uint4 gemv_norm16<__nv_bfloat16>(uint4 x, uint4 w,
                                                            float s) {
  return make_uint4(gemv_norm_pair(x.x, w.x, s), gemv_norm_pair(x.y, w.y, s),
                    gemv_norm_pair(x.z, w.z, s), gemv_norm_pair(x.w, w.w, s));
}

// x_n = round_to<T>(x * inv * w) at T, one block a row (dynamic shared
// memory: the row and w, 2 K x sizeof(T), loaded together); the grid's
// threads first zero `n_tickets` tickets and let the GEMV launch.
template <typename T, int MODE>
__global__ void __launch_bounds__(INV_RMS_THREADS)
gemv_rows_kernel(const T* __restrict__ x, const T* __restrict__ w, int K,
                 float eps, T* __restrict__ xn,
                 unsigned* __restrict__ tickets, int n_tickets) {
  asm volatile("griddepcontrol.launch_dependents;");
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n_tickets;
       i += gridDim.x * blockDim.x)
    tickets[i] = 0u;
  extern __shared__ __align__(16) uint8_t gemv_row_smem[];
  T* srow = (T*)gemv_row_smem;
  T* sw = srow + (K + 7) / 8 * 8;                   // 16-byte aligned
  __shared__ float inv;
  const T* row = x + (size_t)blockIdx.x * K;
  T* out = xn + (size_t)blockIdx.x * K;
  constexpr int VEC = 16 / (int)sizeof(T);
  const bool vec = K % VEC == 0 && ((uintptr_t)row & 15) == 0 &&
                   ((uintptr_t)w & 15) == 0 && ((uintptr_t)out & 15) == 0;
  if (vec) {
#pragma unroll 4
    for (int i = threadIdx.x; i < K / VEC; i += blockDim.x) {
      ((uint4*)srow)[i] = ((const uint4*)row)[i];
      ((uint4*)sw)[i] = ((const uint4*)w)[i];
    }
  } else {
    for (int k = threadIdx.x; k < K; k += blockDim.x) {
      srow[k] = row[k];
      sw[k] = w[k];
    }
  }
  __syncthreads();
  row_inv_rms<T, MODE>(srow, K, eps, [&](float r) { inv = r; });
  __syncthreads();
  const float s = inv;
  if (vec) {
#pragma unroll 4
    for (int i = threadIdx.x; i < K / VEC; i += blockDim.x)
      ((uint4*)out)[i] = gemv_norm16<T>(((const uint4*)srow)[i],
                                        ((const uint4*)sw)[i], s);
  } else {
    for (int k = threadIdx.x; k < K; k += blockDim.x)
      out[k] = from_f<T>(to_f(srow[k]) * s * to_f(sw[k]));
  }
}

// ---------------------------------------------------------------------------
// shared pieces
// ---------------------------------------------------------------------------

template <int BYTES>
__device__ __forceinline__ void gemv_cp_async(void* smem, const void* gmem) {
  const unsigned s = smem_u32(smem);
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(gmem)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
                 "l"(gmem)
                 : "memory");
}

__device__ __forceinline__ void gemv_cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void gemv_cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One thread's column vector at `p`, widened to f32 (the FMA form).
template <typename WT>
__device__ __forceinline__ void gemv_widen(const uint8_t* p, float* w);

template <>
__device__ __forceinline__ void gemv_widen<float>(const uint8_t* p,
                                                  float* w) {
  const float4 v = *(const float4*)p;
  w[0] = v.x;
  w[1] = v.y;
  w[2] = v.z;
  w[3] = v.w;
}

// q ^ 0x80 = q + 128 as the low byte of the float 2^23 gives 2^23 + q + 128;
// subtracting 2^23 + 128 leaves q exactly (tc_gemm.cuh::widen_i8x4)
template <>
__device__ __forceinline__ void gemv_widen<int8_t>(const uint8_t* p,
                                                   float* w) {
  const uint2 v = *(const uint2*)p;
  const uint32_t u[2] = {v.x ^ 0x80808080u, v.y ^ 0x80808080u};
  const float magic = 8388736.f;                     // 2^23 + 128
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    w[4 * i] = __uint_as_float(__byte_perm(u[i], 0x4B000000u, 0x7440)) - magic;
    w[4 * i + 1] =
        __uint_as_float(__byte_perm(u[i], 0x4B000000u, 0x7441)) - magic;
    w[4 * i + 2] =
        __uint_as_float(__byte_perm(u[i], 0x4B000000u, 0x7442)) - magic;
    w[4 * i + 3] =
        __uint_as_float(__byte_perm(u[i], 0x4B000000u, 0x7443)) - magic;
  }
}

// The epilogue of one output: the column scales on the f32 sums (int8, or
// a float W quantized in the stream: QF), then the gate (swiglu), cast to T.
template <typename T, typename WT, bool SWIGLU, bool QF = false>
__device__ __forceinline__ T gemv_store(const float (&s)[SWIGLU ? 2 : 1],
                                        const float* __restrict__ wscale,
                                        int N, int n) {
  constexpr bool kScaled = QF || std::is_same<WT, int8_t>::value;
  float hi = s[0];
  if constexpr (kScaled) hi *= wscale[n];
  if constexpr (SWIGLU) {
    float hg = s[1];
    if constexpr (kScaled) hg *= wscale[N + n];
    return from_f<T>(silu(hg) * hi);
  } else {
    return from_f<T>(hi);
  }
}

// The block's sums `res` ([halves][R][C] f32 in shared memory: rows r0..,
// columns n0.. of each half) to the output, or, with K split (gridDim.y >
// 1), to this split's partials; then the last block of the tile (ticket
// `tile`) sums the splits in split order and stores the output.  The
// partials move in float4s (N is a multiple of 4 on the route, n0 of C),
// and a thread loads GEMV_SPLIT_LOADS of a unit's splits before it adds
// them: the last block's reads are a few round trips to L2, not one for
// each output.
template <typename T, typename WT, bool SWIGLU, int R, int C,
          bool QF = false>
__device__ __forceinline__ void gemv_finish(
    const float* res, int M, int N, int r0, int n0, int tile,
    const float* __restrict__ wscale, T* __restrict__ out,
    float* __restrict__ part, unsigned* __restrict__ tickets, int* last) {
  constexpr int NB = SWIGLU ? 2 : 1;
  constexpr int SL = GEMV_SPLIT_LOADS / NB;
  static_assert(C % 4 == 0, "units of four columns");
  const int tid = threadIdx.x;
  const int rows = min(R, M - r0), units = rows * (min(C, N - n0) / 4);
  const int cols4 = min(C, N - n0) / 4;
  const size_t ldp = (size_t)NB * N;
  // four outputs of the unit (m, c4) from their f32 sums
  auto store4 = [&](int m, int c4, const float4 (&v)[NB]) {
    const int row = r0 + m, n = n0 + 4 * c4;
    T* o = out + (size_t)row * N + n;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float s[NB];
#pragma unroll
      for (int h = 0; h < NB; ++h)
        s[h] = e == 0 ? v[h].x : e == 1 ? v[h].y : e == 2 ? v[h].z : v[h].w;
      o[e] = gemv_store<T, WT, SWIGLU, QF>(s, wscale, N, n + e);
    }
  };
  const bool split = gridDim.y > 1;
  for (int u = tid; u < units; u += GEMV_THREADS) {
    const int m = u / cols4, c4 = u % cols4;
    float4 v[NB];
#pragma unroll
    for (int h = 0; h < NB; ++h)
      v[h] = *(const float4*)(res + (h * R + m) * C + 4 * c4);
    if (!split) {
      store4(m, c4, v);
    } else {
      float* p = part + ((size_t)blockIdx.y * M + r0 + m) * ldp + n0 + 4 * c4;
#pragma unroll
      for (int h = 0; h < NB; ++h) *(float4*)(p + h * N) = v[h];
    }
  }
  if (!split) return;
  __threadfence();
  __syncthreads();
  if (tid == 0) *last = atomicAdd(tickets + tile, 1u) == gridDim.y - 1;
  __syncthreads();
  if (!*last) return;
  __threadfence();
  const int splits = gridDim.y;
  for (int u = tid; u < units; u += GEMV_THREADS) {
    const int m = u / cols4, c4 = u % cols4;
    const float* p0 = part + ((size_t)(r0 + m)) * ldp + n0 + 4 * c4;
    const size_t sstride = (size_t)M * ldp;
    float4 acc[NB];
#pragma unroll
    for (int h = 0; h < NB; ++h) acc[h] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int sp0 = 0; sp0 < splits; sp0 += SL) {
      float4 v[NB][SL];
#pragma unroll
      for (int sp = 0; sp < SL; ++sp)
#pragma unroll
        for (int h = 0; h < NB; ++h)
          v[h][sp] = sp0 + sp < splits
                         ? __ldcg((const float4*)(p0 + (sp0 + sp) * sstride +
                                                  h * N))
                         : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int sp = 0; sp < SL; ++sp)
        if (sp0 + sp < splits)
#pragma unroll
          for (int h = 0; h < NB; ++h) {
            acc[h].x += v[h][sp].x;
            acc[h].y += v[h][sp].y;
            acc[h].z += v[h][sp].z;
            acc[h].w += v[h][sp].w;
          }
    }
    store4(m, c4, acc);
  }
}

// ---------------------------------------------------------------------------
// the f32 FMA form
// ---------------------------------------------------------------------------

// blockIdx = (column tile, K split, group of 8 rows).  x_n is [M, K] at T;
// W is [K, N] (swiglu: [K, 2N], wg from column N on, the scales [2N]).
// QF: W is f32, quantized per weight with pass 1's scales `wscale`.
template <typename T, typename WT, bool SWIGLU, bool QF = false>
__global__ void __launch_bounds__(GEMV_THREADS, 2)
norm_gemv_kernel(const T* __restrict__ xn, const WT* __restrict__ W,
                 const float* __restrict__ wscale, int M, int K, int N,
                 int k_chunk, T* __restrict__ out, float* __restrict__ part,
                 unsigned* __restrict__ tickets) {
  using F = GemvFma<WT, SWIGLU>;
  static_assert(!QF || (std::is_same<WT, float>::value && !SWIGLU),
                "an f32 weight quantized in the stream, no gate");
  constexpr int NB = F::NB, COLS = F::COLS, LB = F::LB, KR = F::KR;
  constexpr int ROWS = F::ROWS, VECS = F::VECS, TILE = F::TILE;
  constexpr int STAGES = F::STAGES, RED = F::RED, ACC = ROWS * COLS;
  constexpr int HALF = GEMV_THREADS / NB, WH = HALF / 32;
  static_assert((STAGES & (STAGES - 1)) == 0, "the ring wraps by a mask");
  static_assert(GEMV_THREADS / 32 * VECS * RED * 4 + NB * ROWS * TILE * 4 <=
                    F::RING,
                "the scratch and the sums fit the ring");
  extern __shared__ __align__(16) uint8_t gemv_smem[];
  float* xs = (float*)(gemv_smem + F::RING);     // [k_chunk][8]
  float* red = (float*)gemv_smem;  // after the loop: [warp][vector][RED]
  float* res = red + GEMV_THREADS / 32 * VECS * RED;   // [NB][8][TILE]
  __shared__ int last;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = tid / HALF, t = tid % HALF;
  const int cv = t % VECS, kr = t / VECS;
  const int n0 = blockIdx.x * TILE, col = n0 + cv * COLS;
  const int kb = blockIdx.y * k_chunk, len = min(K - kb, k_chunk);
  const int r0 = blockIdx.z * ROWS;
  const size_t ldw = (size_t)NB * N;

  // the thread's column vector at k = kb + kr + i * KR, i < steps
  const int steps = col < N && kr < len ? (len - kr + KR - 1) / KR : 0;
  const WT* src = W + (size_t)(kb + kr) * ldw + (size_t)g * N + col;
  const size_t stride = (size_t)KR * ldw;
  uint8_t* ring = gemv_smem + (size_t)tid * LB;    // stage s at s * 256 * LB
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps)
      gemv_cp_async<LB>(ring + s * GEMV_THREADS * LB, src + (size_t)s * stride);
    gemv_cp_commit();
  }
  // x_n's rows r0.. (zero past M), k in [kb, kb + len), as f32 [k][8], once
  // gemv_rows_kernel has written them; eight loads in flight a thread
  asm volatile("griddepcontrol.wait;" ::: "memory");
  for (int i0 = tid; i0 < ROWS * len; i0 += 8 * GEMV_THREADS) {
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = i0 + u * GEMV_THREADS, r = r0 + i / len;
      v[u] = i < ROWS * len && r < M
                 ? to_f(__ldcg(xn + (size_t)r * K + kb + i % len))
                 : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = i0 + u * GEMV_THREADS;
      if (i < ROWS * len) xs[(i % len) * ROWS + i / len] = v[u];
    }
  }
  __syncthreads();
  // QF: the thread's columns' scales and their reciprocals (1 past N)
  float qs[COLS], qy[COLS];
  if constexpr (QF)
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      qs[c] = col + c < N ? __ldcg(wscale + col + c) : 1.f;
      qy[c] = __frcp_rn(qs[c]);
    }

  float acc[ACC];
#pragma unroll
  for (int j = 0; j < ACC; ++j) acc[j] = 0.f;
  const WT* next = src + (size_t)(STAGES - 1) * stride;
  for (int i = 0; i < steps; ++i) {
    if (i + STAGES - 1 < steps)
      gemv_cp_async<LB>(ring + ((i + STAGES - 1) & (STAGES - 1)) *
                                   GEMV_THREADS * LB,
                        next);
    gemv_cp_commit();
    next += stride;
    gemv_cp_wait<STAGES - 1>();
    float wv[COLS];
    gemv_widen<WT>(ring + (i & (STAGES - 1)) * GEMV_THREADS * LB, wv);
    if constexpr (QF)
#pragma unroll
      for (int c = 0; c < COLS; ++c) wv[c] = gemv_quant(wv[c], qs[c], qy[c]);
    const float4* xr = (const float4*)(xs + (kr + i * KR) * ROWS);
    const float4 xa = xr[0], xb = xr[1];
    const float xv[ROWS] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int c = 0; c < COLS; ++c)
        acc[r * COLS + c] = fmaf(xv[r], wv[c], acc[r * COLS + c]);
  }
  gemv_cp_wait<0>();
  __syncthreads();                  // the ring becomes the scratch

  // the warp's k lanes of each column vector (lanes cv, cv + 8, ...), by a
  // butterfly: every lane holds the same sum
#pragma unroll
  for (int j = 0; j < ACC; ++j) {
    float v = acc[j];
#pragma unroll
    for (int m = VECS; m < 32; m <<= 1)
      v += __shfl_xor_sync(0xffffffffu, v, m);
    acc[j] = v;
  }
  if (lane < VECS) {
    float* dst = red + (warp * VECS + lane) * RED;
#pragma unroll
    for (int j = 0; j < ACC; j += 4)
      *(float4*)(dst + j) =
          make_float4(acc[j], acc[j + 1], acc[j + 2], acc[j + 3]);
  }
  __syncthreads();
  // the warps of each half in warp order
  for (int o = tid; o < NB * ROWS * TILE; o += GEMV_THREADS) {
    const int h = o / (ROWS * TILE), m = o / TILE % ROWS, c = o % TILE;
    const int v = c / COLS, j = m * COLS + c % COLS;
    float s = 0.f;
#pragma unroll
    for (int wi = 0; wi < WH; ++wi)
      s += red[((h * WH + wi) * VECS + v) * RED + j];
    res[o] = s;
  }
  __syncthreads();
  gemv_finish<T, WT, SWIGLU, ROWS, TILE, QF>(
      res, M, N, r0, n0, blockIdx.z * gridDim.x + blockIdx.x, wscale, out,
      part, tickets, &last);
}

// ---------------------------------------------------------------------------
// the tensor-core form
// ---------------------------------------------------------------------------

__device__ __forceinline__ void gemv_ldsm_x4_trans(uint32_t (&r)[4],
                                                   uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d[16x8] += a[16x16] @ b[16x8], bf16 in, f32 sums
__device__ __forceinline__ void gemv_mma(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x_n[row][k, k + 1] as a bf16 pair (low: k), zeros past M and K
__device__ __forceinline__ uint32_t gemv_x_pair(
    const __nv_bfloat16* __restrict__ xn, int M, int K, int row, int k) {
  if (row >= M || k >= K) return 0u;
  const unsigned short* p =
      (const unsigned short*)xn + (size_t)row * K + k;
  if ((K & 1) == 0) return __ldcg((const unsigned*)p);
  const uint32_t lo = __ldcg(p);
  return k + 1 < K ? lo | ((uint32_t)__ldcg(p + 1) << 16) : lo;
}

// blockIdx = (column tile, K split).  x_n is [M, K] bf16 (M <= 16); `map`
// reads W [K, N] (swiglu: [K, 2N], wg from column N on, the scales [2N])
// in SR x 64 boxes, bf16 with the 128-byte swizzle, int8 with the 64-byte.
// The mma's 16 rows are W's columns: in the bf16 form column 16 g + i of
// the warp's 64 is row i of its g-th mma; in the int8 form (each lane
// reading 8 bytes of a k row) row i of the g-th mma is column (i % 8) 8 +
// 2 g + i / 8.  QF: W is bf16, each element quantized after its ldmatrix
// with pass 1's scales `wscale` (column 16 g + gid + 8 (j & 1) for the
// fragment's register j).
template <typename WT, bool SWIGLU, bool QF = false>
__global__ void __launch_bounds__(GEMV_THREADS, 2)
norm_gemv_mma_kernel(const __grid_constant__ CUtensorMap map,
                     const __nv_bfloat16* __restrict__ xn,
                     const float* __restrict__ wscale, int M, int K, int N,
                     int k_chunk, __nv_bfloat16* __restrict__ out,
                     float* __restrict__ part,
                     unsigned* __restrict__ tickets) {
  using G = GemvMma<WT, SWIGLU>;
  static_assert(!QF || (std::is_same<WT, __nv_bfloat16>::value && !SWIGLU),
                "a bf16 weight quantized in the stream, no gate");
  constexpr int NB = G::NB, WH = G::WH, SR = G::SR, STAGES = G::STAGES;
  constexpr int TILE = G::TILE, ROWS = G::ROWS, GROUPS = G::GROUPS;
  constexpr int BOX = G::BOX_BYTES, ROWB = G::ROW_BYTES;
  extern __shared__ __align__(16) uint8_t gemv_mma_smem[];
  __shared__ __align__(8) uint64_t full[G::WARPS][STAGES];
  __shared__ int last;
  uint8_t* ring =
      gemv_mma_smem + ((1024 - (smem_u32(gemv_mma_smem) & 1023)) & 1023);
  float* res = (float*)ring;       // after the loop: [NB][16][TILE]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int h = warp / WH, wl = warp % WH;
  const int n0 = blockIdx.x * TILE, wn0 = n0 + wl * G::WCOLS;
  const int kb = blockIdx.y * k_chunk, len = min(K - kb, k_chunk);
  const int nst = (len + SR - 1) / SR;
  const bool active = wn0 < N;                   // the warp has columns
  uint8_t* wring = ring + warp * STAGES * BOX;
  uint64_t* bar = full[warp];

  if (lane == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(&bar[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();
  auto load = [&](int s) {
    mbar_expect_tx(&bar[s % STAGES], BOX);
    tma_load_2d(wring + (s % STAGES) * BOX, &map, &bar[s % STAGES],
                h * N + wn0, kb + s * SR);
  };
  if (active && lane == 0)
    for (int s = 0; s < STAGES && s < nst; ++s) load(s);
  asm volatile("griddepcontrol.wait;" ::: "memory");   // x_n is written

  // QF: the lane's 8 columns' scales and their reciprocals (1 past N)
  float qs[GROUPS][2], qy[GROUPS][2];
  if constexpr (QF)
#pragma unroll
    for (int g = 0; g < GROUPS; ++g)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = wn0 + 16 * g + gid + 8 * j;
        qs[g][j] = c < N ? __ldcg(wscale + c) : 1.f;
        qy[g][j] = __frcp_rn(qs[g][j]);
      }
  const bool rows16 = M > 8;
  float acc[2][GROUPS][4];
#pragma unroll
  for (int rg = 0; rg < 2; ++rg)
#pragma unroll
    for (int g = 0; g < GROUPS; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[rg][g][e] = 0.f;
  // x_n's fragments of stage i's k16 steps (rows gid, gid + 8)
  auto x_frags = [&](int i, uint32_t (&b)[SR / 16][2][2]) {
#pragma unroll
    for (int t = 0; t < SR / 16; ++t) {
      const int k = kb + i * SR + t * 16 + tig * 2;
#pragma unroll
      for (int rg = 0; rg < 2; ++rg) {
        const int row = rg * 8 + gid;
        const bool on = i < nst && (rg == 0 || rows16);
        b[t][rg][0] = on ? gemv_x_pair(xn, M, K, row, k) : 0u;
        b[t][rg][1] = on ? gemv_x_pair(xn, M, K, row, k + 8) : 0u;
      }
    }
  };
  if (active) {
    uint32_t b[SR / 16][2][2], bn[SR / 16][2][2];
    x_frags(0, b);
    for (int i = 0; i < nst; ++i) {
      x_frags(i + 1, bn);              // the next stage's, in flight now
      mbar_wait(&bar[i % STAGES], (i / STAGES) & 1);
      const uint8_t* box = wring + (i % STAGES) * BOX;
#pragma unroll
      for (int t = 0; t < SR / 16; ++t) {
        if constexpr (G::kQ8) {
          // k rows 2 tig, 2 tig + 1, 2 tig + 8, 2 tig + 9 of the step, the
          // lane's 8 bytes of each (16-byte chunk (gid / 2) ^ ((row / 2) %
          // 4): the 64-byte swizzle); byte j of a row is row gid + 8 (j & 1)
          // of mma j / 2
          uint2 q[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = t * 16 + tig * 2 + (e & 1) + (e >> 1) * 8;
            q[e] = *(const uint2*)(box + r * ROWB +
                                   (((gid >> 1) ^ ((r >> 1) & 3)) << 4) +
                                   (gid & 1) * 8);
          }
#pragma unroll
          for (int g = 0; g < GROUPS; ++g) {
            const uint32_t sel = (g & 1) ? 0x7362u : 0x5140u;
            auto word = [&](const uint2& v) { return g < 2 ? v.x : v.y; };
            uint32_t a[4];
            widen_i8x4(__byte_perm(word(q[0]), word(q[1]), sel), a[0], a[1]);
            widen_i8x4(__byte_perm(word(q[2]), word(q[3]), sel), a[2], a[3]);
            gemv_mma(acc[0][g], a, b[t][0][0], b[t][0][1]);
            if (rows16) gemv_mma(acc[1][g], a, b[t][1][0], b[t][1][1]);
          }
        } else {
          // ldmatrix.x4.trans: lanes 8 j .. 8 j + 7 address matrix j's k
          // rows (k + 8 for j >= 2), columns 16 g + 8 (j & 1) (the
          // 128-byte swizzle: 16-byte chunk index ^ row % 8)
          const int mat = lane >> 3;
          const int r = t * 16 + (lane & 7) + (mat >> 1) * 8;
#pragma unroll
          for (int g = 0; g < GROUPS; ++g) {
            const int chunk = 2 * g + (mat & 1);
            uint32_t a[4];
            gemv_ldsm_x4_trans(
                a, smem_u32(box + r * ROWB + ((chunk ^ (r & 7)) << 4)));
            if constexpr (QF)
#pragma unroll
              for (int j = 0; j < 4; ++j)
                a[j] = gemv_quant_pair(a[j], qs[g][j & 1], qy[g][j & 1]);
            gemv_mma(acc[0][g], a, b[t][0][0], b[t][0][1]);
            if (rows16) gemv_mma(acc[1][g], a, b[t][1][0], b[t][1][1]);
          }
        }
      }
      __syncwarp();                  // the warp is done with the slot
      if (lane == 0 && i + STAGES < nst) {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        load(i + STAGES);
      }
#pragma unroll
      for (int t = 0; t < SR / 16; ++t)
#pragma unroll
        for (int rg = 0; rg < 2; ++rg) {
          b[t][rg][0] = bn[t][rg][0];
          b[t][rg][1] = bn[t][rg][1];
        }
    }
  }
  __syncthreads();                   // every ring becomes the sums
  // d[rg][g] = (rows i = gid, gid + 8 of the mma) x (x_n rows 2 tig, 2 tig
  // + 1 of group rg)
#pragma unroll
  for (int rg = 0; rg < 2; ++rg)
#pragma unroll
    for (int g = 0; g < GROUPS; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = rg * 8 + tig * 2 + (e & 1), i = gid + 8 * (e >> 1);
        const int c = wl * G::WCOLS +
                      (G::kQ8 ? (i % 8) * 8 + 2 * g + i / 8 : 16 * g + i);
        res[(h * ROWS + m) * TILE + c] = acc[rg][g][e];
      }
  __syncthreads();
  gemv_finish<__nv_bfloat16, WT, SWIGLU, ROWS, TILE, QF>(
      res, M, N, 0, n0, blockIdx.x, wscale, out, part, tickets, &last);
}

// the map of W, row-major [K, cols] of WT, in the mma form's SR x 64 boxes:
// bf16 with the 128-byte swizzle, int8 with the 64-byte, zeros past the edge
template <typename WT, bool SWIGLU>
inline bool gemv_map(CUtensorMap* map, const void* W, int K, int cols) {
  using G = GemvMma<WT, SWIGLU>;
  const TensorMapEncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)K};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(WT)};
  const cuuint32_t box[2] = {(cuuint32_t)G::WCOLS, (cuuint32_t)G::SR};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map,
                G::kQ8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                2, const_cast<void*>(W), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                G::kQ8 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// ---------------------------------------------------------------------------
// one call
// ---------------------------------------------------------------------------

// The GEMV of T's form over the workspace `ws` (plan_gemv's words: x_n at
// T [M, K], then the split-K partials and tickets), launched as the
// programmatic dependent of the launch before it: its prologue, which
// writes x_n, zeroes the p.ticket_words tickets and lets the GEMV launch
// (gemv_rows_kernel here; attention_decode.cuh's combine for wo).  N is F
// for swiglu (W then [K, 2F], the scales [2F]); `wscale` is given for an
// int8 W, and for a float W quantized in the stream (QF: pass 1's scales).
template <typename T, typename WT, bool SWIGLU, bool QF = false>
cudaError_t launch_gemv_dependent(const GemvPlan& p, const void* W,
                                  const float* wscale, void* out, void* ws,
                                  int M, int K, int N, cudaStream_t st) {
  constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value;
  T* xn = (T*)ws;
  float* part = (float*)ws + p.xn_words;
  unsigned* tickets = (unsigned*)(part + p.part_words);
  cudaError_t err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.tiles, p.splits, p.groups);
  cfg.blockDim = dim3(GEMV_THREADS);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if constexpr (kMma) {
    using G = GemvMma<WT, SWIGLU>;
    CUtensorMap map;
    if (!gemv_map<WT, SWIGLU>(&map, W, K, G::NB * N))
      return cudaErrorInvalidValue;
    cfg.dynamicSmemBytes = 1024 + G::RING;
    err = cudaFuncSetAttribute(norm_gemv_mma_kernel<WT, SWIGLU, QF>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)cfg.dynamicSmemBytes);
    if (err != cudaSuccess) return err;
    err = cudaLaunchKernelEx(&cfg, norm_gemv_mma_kernel<WT, SWIGLU, QF>, map,
                             (const __nv_bfloat16*)xn, wscale, M, K, N,
                             p.k_chunk, (__nv_bfloat16*)out, part, tickets);
  } else {
    using F = GemvFma<WT, SWIGLU>;
    cfg.dynamicSmemBytes =
        F::RING + (size_t)F::ROWS * p.k_chunk * sizeof(float);
    err = cudaFuncSetAttribute(norm_gemv_kernel<T, WT, SWIGLU, QF>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)cfg.dynamicSmemBytes);
    if (err != cudaSuccess) return err;
    err = cudaLaunchKernelEx(&cfg, norm_gemv_kernel<T, WT, SWIGLU, QF>,
                             (const T*)xn, (const WT*)W, wscale, M, K, N,
                             p.k_chunk, (T*)out, part, tickets);
  }
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Pass 1 of a float W [K, N] at WT: the [N] f32 scales into `scale`.
template <typename WT>
cudaError_t launch_q8_scales(const void* W, int K, int N, float* scale,
                             cudaStream_t st) {
  constexpr int COLS = 8 * 16 / (int)sizeof(WT);     // a block's columns
  if (!gemv_route<WT>(1, N, W) || K < 1) return cudaErrorInvalidValue;
  q8_scales_kernel<WT><<<(N + COLS - 1) / COLS, GEMV_THREADS, 0, st>>>(
      (const WT*)W, K, N, scale);
  return cudaGetLastError();
}

// gemv_rows_kernel, then the GEMV of T's form as its programmatic
// dependent, over the workspace `ws` (plan_gemv's words; QF: W at T,
// plan_gemv_q's words, then the [N] scales, which pass 1 writes first).
template <typename T, typename WT, bool SWIGLU, int MODE, bool QF = false>
cudaError_t launch_norm_gemv(const void* x, const void* w, const void* W,
                             const float* wscale, void* out, void* ws, int M,
                             int K, int N, float eps, int sms,
                             cudaStream_t st) {
  if (!gemv_route<WT>(M, N, W) || K < 1 ||
      (wscale != nullptr) != std::is_same<WT, int8_t>::value)
    return cudaErrorInvalidValue;
  const GemvPlan p = QF ? plan_gemv_q<T>(M, K, N, sms)
                        : plan_gemv<T, WT, SWIGLU>(M, K, N, sms);
  T* xn = (T*)ws;
  unsigned* tickets =
      (unsigned*)((float*)ws + p.xn_words + p.part_words);
  cudaError_t err;
  if constexpr (QF) {
    float* scale = (float*)ws + p.words();
    err = launch_q8_scales<WT>(W, K, N, scale, st);
    if (err != cudaSuccess) return err;
    wscale = scale;
  }
  const int row_smem = 2 * ((K + 7) / 8 * 8) * (int)sizeof(T);
  err = cudaFuncSetAttribute(
      gemv_rows_kernel<T, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      row_smem);
  if (err != cudaSuccess) return err;
  gemv_rows_kernel<T, MODE><<<M, INV_RMS_THREADS, row_smem, st>>>(
      (const T*)x, (const T*)w, K, eps, xn, tickets, (int)p.ticket_words);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_gemv_dependent<T, WT, SWIGLU, QF>(p, W, wscale, out, ws, M,
                                                  K, N, st);
}

// The callers' dispatch: T from `dtype`, WT int8 or T from `wdtype`.
template <bool SWIGLU>
inline long long gemv_workspace(int dtype, int wdtype, int M, int K, int N,
                                int sms) {
  using bf16 = __nv_bfloat16;
  const bool q8 = wdtype == kI8;
  if (dtype == kBF16)
    return q8 ? plan_gemv<bf16, int8_t, SWIGLU>(M, K, N, sms).words()
              : plan_gemv<bf16, bf16, SWIGLU>(M, K, N, sms).words();
  return q8 ? plan_gemv<float, int8_t, SWIGLU>(M, K, N, sms).words()
            : plan_gemv<float, float, SWIGLU>(M, K, N, sms).words();
}

template <bool SWIGLU, int MODE>
inline cudaError_t launch_gemv_mode(int dtype, int wdtype, const void* x,
                                    const void* w, const void* W,
                                    const float* wscale, void* out, void* ws,
                                    int M, int K, int N, float eps, int sms,
                                    cudaStream_t st) {
  using bf16 = __nv_bfloat16;
  const bool q8 = wdtype == kI8;
  if (dtype == kBF16)
    return q8 ? launch_norm_gemv<bf16, int8_t, SWIGLU, MODE>(
                    x, w, W, wscale, out, ws, M, K, N, eps, sms, st)
              : launch_norm_gemv<bf16, bf16, SWIGLU, MODE>(
                    x, w, W, wscale, out, ws, M, K, N, eps, sms, st);
  return q8 ? launch_norm_gemv<float, int8_t, SWIGLU, MODE>(
                  x, w, W, wscale, out, ws, M, K, N, eps, sms, st)
            : launch_norm_gemv<float, float, SWIGLU, MODE>(
                  x, w, W, wscale, out, ws, M, K, N, eps, sms, st);
}

template <bool SWIGLU>
inline cudaError_t launch_gemv(int mode, int dtype, int wdtype, const void* x,
                               const void* w, const void* W,
                               const float* wscale, void* out, void* ws,
                               int M, int K, int N, float eps, int sms,
                               cudaStream_t st) {
  if (mode == kAbstract)
    return launch_gemv_mode<SWIGLU, kAbstract>(dtype, wdtype, x, w, W, wscale,
                                               out, ws, M, K, N, eps, sms, st);
  if (mode == kAbstractShuffle)
    return launch_gemv_mode<SWIGLU, kAbstractShuffle>(
        dtype, wdtype, x, w, W, wscale, out, ws, M, K, N, eps, sms, st);
  return launch_gemv_mode<SWIGLU, kNative>(dtype, wdtype, x, w, W, wscale,
                                           out, ws, M, K, N, eps, sms, st);
}

}  // namespace uisa

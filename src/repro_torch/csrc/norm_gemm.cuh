// rmsnorm as a GEMM prologue: out = (x * rsqrt(mean(x^2) + eps) * w) @ W,
// and the swiglu form out = silu(n @ wg) * (n @ wi) against w_cat = [wi|wg].
//
// Replaces the Pallas kernels kernels/fused.py::rmsnorm_matmul and
// kernels/fused.py::rmsnorm_swiglu of the JAX package.
//
// Bound on Hopper: at decode (rows = batch slots, 8) both are bound by the
// weight stream (D x N x 2 bytes in bf16: 50.3 MB for granite-8b's qkv,
// 234.9 MB for its [wi|wg]); at prefill (rows = prompt length) by
// operations.
//
// Design, right and simple first:
//  1. inv_rms_kernel: one block per row writes the f32 inverse RMS
//     ([rows] f32 workspace).  Re-reading a 4096-wide row is cheap next to
//     the weight stream.
//  2. norm_gemm_kernel: a register-tiled f32 FMA GEMM.  Each block stages a
//     BM x BK tile of the *normalized* activation (normalized on load,
//     rounded to the working dtype as the plain version does) and a BK x BN
//     weight tile (two tiles, the same columns of wi and wg, for swiglu) in
//     shared memory; each thread owns a TM x TN (x2) accumulator.  The
//     normalized activation and the hi/hg products never reach device
//     memory.
//  3. With few row tiles (decode) the blocks would not fill the SMs, so
//     plan_norm_gemm splits K into `splits` chunks: each block writes f32
//     partial sums ([splits, rows, N or 2F]) and split_reduce_kernel adds
//     them in a fixed order and applies the epilogue (cast, or the silu
//     gate).  No atomics: results do not depend on block order.  The
//     wrapper asks the library for the workspace size (norm_gemm_workspace)
//     and launches with the SM count; the tile shapes live only here.
// The weight of rmsnorm_matmul may be f32 beside bf16 activations, and may
// be read transposed (TRANS): W is then an [N, K] table with row stride K,
// a tied embedding read in place (granite-moe-3b-a800m's head: 49155 x
// 1536 f32, 302 MB, no per-call copy).  Its tile loads run along K, so
// neighbouring threads read neighbouring addresses of one table row, and
// the shared tile gets one column of padding against bank conflicts.
// The int8 twins (kernels/fused.py::rmsnorm_matmul_q8 and
// rmsnorm_swiglu_q8 of the JAX package) are the same kernel with WT =
// int8_t and an [N] (swiglu: [2F], wi reading [:F], wg [F:]) f32 scale
// operand: the weight tile load becomes Bs = float(q) * scale[n], so the
// product runs in f32 on the dequantized tile and the f32 weight never
// exists in device memory.  At decode they stream half the bytes (qkv:
// 25.2 MB of int8 + 24.6 KB of scales for granite-8b).
// The bf16 prefill of rmsnorm_matmul (M > SMALL_M, a bf16 or int8 W read
// [K, N]) and of rmsnorm_swiglu (a bf16 or int8 w_cat) takes the tensor
// cores instead (rmsnorm_matmul.cu, rmsnorm_swiglu.cu): norm_rows_kernel
// writes the normalized activation once, [M, K] at T, into the workspace,
// and tc_gemm.cuh multiplies it by W (or by wi and wg, the gate in its
// epilogue) with wgmma, an int8 weight's tiles widened to bf16, so the A
// tile is no longer re-normalized by each of the N tiles.  Every other
// form (decode, f32 activations, the f32 or TRANS table) runs the f32 FMA
// kernel below.
//
// The modes (the JAX package's abstract and abstract+shuffle lowerings of
// both kernels, uisa_rmsnorm_matmul_<mode> and uisa_rmsnorm_swiglu_<mode>):
// the row moment is the only cross-lane stage, so MODE is a template
// argument of inv_rms_kernel alone and the GEMM is the same in every mode,
// as in the JAX package.  abstract (kernels/rmsnorm.py::normalize_block's
// abstract branch): each thread's partial sum of squares goes through
// scratch_tree_reduce over the block's 256 threads (8 halving stages, no
// shuffle), and the moment is re-staged through shared memory and reloaded
// before the normalize.  abstract+shuffle: warp_block_reduce (5 butterfly
// stages, one exchange of the 8 warp partials, 3 more).  native: the code
// of the earlier slices, unchanged.  The int8 weight (WT = int8_t) runs
// under every mode on the native int8 tiles.
#pragma once
#include <type_traits>

#include "common.cuh"
#include "lanes.cuh"

namespace uisa {

constexpr int INV_RMS_THREADS = 256;

// The inverse RMS of one row, the block's INV_RMS_THREADS threads over its
// K values, the moment's cross-lane stage in MODE; one thread hands the
// result to `put`.
template <typename T, int MODE, typename Put>
__device__ __forceinline__ void row_inv_rms(const T* __restrict__ row, int K,
                                            float eps, Put put) {
  float ss = 0.f;
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    float v = to_f(row[k]);
    ss += v * v;
  }
  if constexpr (MODE == kAbstract) {
    __shared__ float tree[INV_RMS_THREADS];
    __shared__ float moment;
    const float sum = scratch_tree_reduce<INV_RMS_THREADS>(ss, tree);
    if (threadIdx.x == 0) moment = sum / (float)K;    // the re-stage
    __syncthreads();
    if (threadIdx.x == 0) put(rsqrtf(moment + eps));
  } else if constexpr (MODE == kAbstractShuffle) {
    __shared__ float red[INV_RMS_THREADS / 32];
    const float sum = warp_block_reduce<INV_RMS_THREADS>(ss, red);
    if (threadIdx.x == 0) put(rsqrtf(sum / (float)K + eps));
  } else {
    __shared__ float red[32];
    ss = warp_sum(ss);
    const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
    if (lane == 0) red[wid] = ss;
    __syncthreads();
    if (wid == 0) {
      float t = lane < (int)(blockDim.x >> 5) ? red[lane] : 0.f;
      t = warp_sum(t);
      if (lane == 0) put(rsqrtf(t / (float)K + eps));
    }
  }
}

template <typename T, int MODE = kNative>
__global__ void inv_rms_kernel(const T* __restrict__ x, int K, float eps,
                               float* __restrict__ inv) {
  row_inv_rms<T, MODE>(x + (size_t)blockIdx.x * K, K, eps,
                       [&](float r) { inv[blockIdx.x] = r; });
}

// The tensor-core route's prologue (rmsnorm_matmul.cu): one block per row
// writes the normalized row x_n = round_to<T>(x * inv * w) at T, the
// rounding the plain version and norm_gemm_kernel apply, for tc_gemm.cuh
// to multiply.  MODE picks the moment's cross-lane stage, as above.
template <typename T, int MODE = kNative>
__global__ void norm_rows_kernel(const T* __restrict__ x,
                                 const T* __restrict__ w, int K, float eps,
                                 T* __restrict__ xn) {
  __shared__ float inv;
  const T* row = x + (size_t)blockIdx.x * K;
  row_inv_rms<T, MODE>(row, K, eps, [&](float r) { inv = r; });
  __syncthreads();
  const float s = inv;
  T* out = xn + (size_t)blockIdx.x * K;
  for (int k = threadIdx.x; k < K; k += blockDim.x)
    out[k] = from_f<T>(to_f(row[k]) * s * to_f(w[k]));
}

// blockIdx = (N tile, row tile, K split).  W has leading dimension ldw; for
// swiglu the gate columns sit N columns to the right of the value columns.
// TRANS: W is the [N, K] table, W[n][k] at n * ldw + k.
template <typename T, typename WT, bool TRANS, int BM, int BN, int BK, int TM,
          int TN, bool SWIGLU>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
norm_gemm_kernel(const T* __restrict__ x, const float* __restrict__ inv,
                 const T* __restrict__ w, const WT* __restrict__ W,
                 const float* __restrict__ wscale, int M, int K, int N,
                 int ldw, int k_chunk, T* __restrict__ out,
                 float* __restrict__ part) {
  static_assert(!(TRANS && SWIGLU), "the table read is rmsnorm_matmul's");
  constexpr bool kQ8 = std::is_same<WT, int8_t>::value;
  static_assert(!(TRANS && kQ8), "the int8 weight is read [K, N]");
  constexpr int TX = BN / TN, TY = BM / TM, NT = TX * TY;
  constexpr int NB = SWIGLU ? 2 : 1;
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[NB][BK][BN + (TRANS ? 1 : 0)];
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int kb = blockIdx.z * k_chunk, ke = min(K, kb + k_chunk);
  float acc[NB][TM][TN];
#pragma unroll
  for (int g = 0; g < NB; ++g)
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[g][i][j] = 0.f;

  for (int k0 = kb; k0 < ke; k0 += BK) {
    for (int idx = tid; idx < BM * BK; idx += NT) {
      const int mm = idx / BK, kk = idx % BK, m = m0 + mm, k = k0 + kk;
      float a = 0.f;
      if (m < M && k < ke)
        a = round_to<T>(to_f(x[(size_t)m * K + k]) * inv[m] * to_f(w[k]));
      As[kk][mm] = a;
    }
    if constexpr (TRANS) {
      for (int idx = tid; idx < BK * BN; idx += NT) {
        const int kk = idx % BK, nn = idx / BK, k = k0 + kk, n = n0 + nn;
        Bs[0][kk][nn] = k < ke && n < N ? to_f(W[(size_t)n * ldw + k]) : 0.f;
      }
    } else {
      for (int idx = tid; idx < BK * BN; idx += NT) {
        const int kk = idx / BN, nn = idx % BN, k = k0 + kk, n = n0 + nn;
        const bool ok = k < ke && n < N;
        const WT* src = W + (size_t)k * ldw + n;
        if constexpr (kQ8) {          // dequantize on load: q * scale[n]
          Bs[0][kk][nn] = ok ? to_f(src[0]) * wscale[n] : 0.f;
          if constexpr (SWIGLU)
            Bs[1][kk][nn] = ok ? to_f(src[N]) * wscale[N + n] : 0.f;
        } else {
          Bs[0][kk][nn] = ok ? to_f(src[0]) : 0.f;
          if constexpr (SWIGLU) Bs[1][kk][nn] = ok ? to_f(src[N]) : 0.f;
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty * TM + i];
#pragma unroll
      for (int g = 0; g < NB; ++g)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const float bv = Bs[g][kk][tx + j * TX];
#pragma unroll
          for (int i = 0; i < TM; ++i) acc[g][i][j] += a[i] * bv;
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + j * TX;
      if (n >= N) continue;
      if (part != nullptr) {
        float* p = part + ((size_t)blockIdx.z * M + m) * (NB * N);
        p[n] = acc[0][i][j];
        if constexpr (SWIGLU) p[N + n] = acc[1][i][j];
      } else if constexpr (SWIGLU) {
        out[(size_t)m * N + n] = from_f<T>(silu(acc[1][i][j]) * acc[0][i][j]);
      } else {
        out[(size_t)m * N + n] = from_f<T>(acc[0][i][j]);
      }
    }
  }
}

// out[m, n] = epilogue(sum over splits, in split order)
template <typename T, bool SWIGLU>
__global__ void split_reduce_kernel(const float* __restrict__ part, int splits,
                                    int M, int N, T* __restrict__ out) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)M * N) return;
  const size_t m = i / N, n = i % N;
  const size_t ld = (SWIGLU ? 2 : 1) * (size_t)N;
  float hi = 0.f, hg = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float* p = part + ((size_t)s * M + m) * ld;
    hi += p[n];
    if constexpr (SWIGLU) hg += p[N + n];
  }
  out[i] = from_f<T>(SWIGLU ? silu(hg) * hi : hi);
}

// The two tile shapes: small-M (decode) and the prefill shape.
constexpr int SMALL_M = 16;
struct SmallTile { static constexpr int BM = 16, BN = 64, BK = 32, TM = 2, TN = 4; };
struct LargeTile { static constexpr int BM = 64, BN = 64, BK = 16, TM = 4, TN = 4; };

struct NormGemmPlan {
  int splits, k_chunk;
};

// Split K until about four blocks per SM are in flight, keeping at least
// eight BK steps per split; k_chunk is a multiple of BK.
template <class Tile>
inline NormGemmPlan plan_tiles(int M, int K, int N, int sms) {
  const long long tiles = (long long)((M + Tile::BM - 1) / Tile::BM) *
                          ((N + Tile::BN - 1) / Tile::BN);
  long long s = (4LL * sms + tiles - 1) / tiles;
  s = s < K / (8 * Tile::BK) ? s : K / (8 * Tile::BK);
  s = s > 1 ? s : 1;
  const int per = (int)((K + s - 1) / s);
  const int k_chunk = (per + Tile::BK - 1) / Tile::BK * Tile::BK;
  return {(K + k_chunk - 1) / k_chunk, k_chunk};
}

inline NormGemmPlan plan_norm_gemm(int M, int K, int N, int sms) {
  return M <= SMALL_M ? plan_tiles<SmallTile>(M, K, N, sms)
                      : plan_tiles<LargeTile>(M, K, N, sms);
}

// f32 elements of the split-K workspace `part` (0: no split, no workspace)
template <bool SWIGLU>
inline long long norm_gemm_workspace(int M, int K, int N, int sms) {
  const NormGemmPlan p = plan_norm_gemm(M, K, N, sms);
  return p.splits > 1 ? (long long)p.splits * M * (SWIGLU ? 2 : 1) * N : 0;
}

template <typename T, bool SWIGLU, typename WT, bool TRANS, class Tile>
void launch_tiles(const void* x, const float* inv, const void* w,
                  const void* W, const float* wscale, void* out, float* part,
                  int M, int K, int N, int ldw, NormGemmPlan p,
                  cudaStream_t st) {
  dim3 grid((N + Tile::BN - 1) / Tile::BN, (M + Tile::BM - 1) / Tile::BM,
            p.splits);
  norm_gemm_kernel<T, WT, TRANS, Tile::BM, Tile::BN, Tile::BK, Tile::TM,
                   Tile::TN, SWIGLU>
      <<<grid, (Tile::BM / Tile::TM) * (Tile::BN / Tile::TN), 0, st>>>(
          (const T*)x, inv, (const T*)w, (const WT*)W, wscale, M, K, N, ldw,
          p.k_chunk, (T*)out, p.splits > 1 ? part : nullptr);
}

// `part` holds norm_gemm_workspace<SWIGLU>(M, K, N, sms) floats.  The
// weight is WT (T, f32 beside bf16 activations, or int8 with its f32
// `wscale`); TRANS reads it as the [N, K] table with row stride ldw.  MODE
// picks the moment's cross-lane stage (inv_rms_kernel) and nothing else.
template <typename T, bool SWIGLU, typename WT = T, bool TRANS = false,
          int MODE = kNative>
cudaError_t launch_norm_gemm(const void* x, const void* w, const void* W,
                             const float* wscale, void* out, float* inv,
                             float* part, int M, int K, int N, int ldw,
                             float eps, int sms, cudaStream_t st) {
  if (std::is_same<WT, int8_t>::value && wscale == nullptr)
    return cudaErrorInvalidValue;
  const NormGemmPlan p = plan_norm_gemm(M, K, N, sms);
  inv_rms_kernel<T, MODE><<<M, INV_RMS_THREADS, 0, st>>>((const T*)x, K, eps,
                                                         inv);
  if (M <= SMALL_M)
    launch_tiles<T, SWIGLU, WT, TRANS, SmallTile>(x, inv, w, W, wscale, out,
                                                  part, M, K, N, ldw, p, st);
  else
    launch_tiles<T, SWIGLU, WT, TRANS, LargeTile>(x, inv, w, W, wscale, out,
                                                  part, M, K, N, ldw, p, st);
  if (p.splits > 1) {
    const size_t total = (size_t)M * N;
    split_reduce_kernel<T, SWIGLU><<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
        part, p.splits, M, N, (T*)out);
  }
  return cudaGetLastError();
}

}  // namespace uisa

// The decode GEMV's transposed-table form: out = x_n @ E^T against an f32
// [N, K] table read in place, x_n = round_to<T>(x * rsqrt(mean(x^2) + eps)
// * w), at M <= SMALL_M rows.
//
// Replaces, at decode, kernels/fused.py::rmsnorm_matmul of the JAX package
// on a tied head: the f32 embedding [N, K] read in place as W = E^T
// (granite-moe-3b-a800m: 49155 x 1536, 302 MB, 90.4 us at 3.35 TB/s; the
// FMA norm_gemm_kernel, written for W [K, N], ran it at 2.96x that on an
// H100 80GB HBM3 at 700 W).  Bound on Hopper: the table's bytes; at 8
// rows the work is 4 flops a byte, far under the f32 FMA rate.
//  - The route (gemv_t_route): M <= SMALL_M, x bf16 or f32, K x 4 a
//    multiple of 16 bytes, the table 16-byte aligned.
//  - gemv_rows_kernel<T, MODE> writes x_n at T (the norm, the one stage
//    that differs by mode), then norm_gemv_t_kernel runs as its
//    programmatic dependent: it starts copying the table before x_n is
//    written.
//  - A block owns 256 table rows n (thread t row n0 + t) and a chunk of K;
//    the chunk's table rows stream through a ring of GEMV_T_STAGES tiles of
//    256 rows x 32 k (128 bytes of each row) by 16-byte cp.async (eight a
//    thread a tile, eight threads covering one row's 128 bytes; each copy
//    asks L2 for the 256 bytes around it, so a row's next 128 bytes come
//    from DRAM with this stage's: without it the call ran 2% slower on the
//    card, scripts/gemv_t_variants.py, l2_none), each row's 16-byte
//    chunks swizzled by n % 8, so that eight threads reading one chunk of
//    eight rows hit every bank once.  x_n's chunk sits in shared
//    memory as f32 [ROWS][k], read as float4 broadcasts.
//  - Each thread owns its row's ROWS outputs and sums k in order with f32
//    FMAs of x_n (exact in f32) and the table (no TF32 tensor core: it
//    would round the table).  The K sum needs no cross-lane stage, so the
//    kernel is the same in every mode: the abstract contract has no
//    LANE_SHUFFLE, and a thread that owns its outputs needs none (the
//    other design, the K stage through lanes.cuh in MODE, would make the
//    abstract mode pay a barrier tree for every output).
//  - K splits (plan_gemv_t: the fewest that fill the card at two blocks an
//    SM with x_n's chunk in 12 KB) write f32 partials [splits, M, N]; the
//    last block of a tile to arrive (an integer ticket after
//    __threadfence) adds them in split order.  Bitwise repeatable.
#pragma once
#include "norm_gemv.cuh"

namespace uisa {

constexpr int GEMV_T_ROWS = 256;             // table rows a block
constexpr int GEMV_T_KT = 32;                // k a ring tile
constexpr int GEMV_T_STAGES = 3;
constexpr int GEMV_T_TILE_BYTES = GEMV_T_ROWS * GEMV_T_KT * 4;   // 32 KB
constexpr int GEMV_T_XCAP = 3072;            // x_n floats a block stages

inline bool gemv_t_route(int M, int K, const void* table) {
  return M >= 1 && M <= SMALL_M && K >= 1 && ((long long)K * 4) % 16 == 0 &&
         ((uintptr_t)table & 15) == 0;
}

// The K split of the transposed form: the fewest splits whose blocks fill
// the card (two an SM), weighing a last partial wave against the
// partials' traffic, with x_n's chunk (ROWS x k_chunk f32) within XCAP.
template <typename T>
inline GemvPlan plan_gemv_t(int M, int K, int N, int sms) {
  GemvPlan p;
  const int rows = M <= 8 ? 8 : 16;
  p.tiles = (N + GEMV_T_ROWS - 1) / GEMV_T_ROWS;
  p.groups = 1;
  const long long slots = 2LL * sms;
  const int kcap = GEMV_T_XCAP / rows / GEMV_T_KT * GEMV_T_KT;
  const int least = (K + kcap - 1) / kcap;
  int most = (K + GEMV_T_KT - 1) / GEMV_T_KT;
  most = most < GEMV_MAX_SPLITS ? most : GEMV_MAX_SPLITS;
  most = most > least ? most : least;
  double best = 1e30;
  int s_best = least;
  for (int s = least; s <= most; ++s) {
    const long long blocks = (long long)p.tiles * s;
    const double eff =
        blocks <= slots
            ? (blocks >= sms ? 1.0 : (double)blocks / sms)
            : (double)blocks / ((double)((blocks + slots - 1) / slots) * slots);
    const double traffic = s > 1 ? 8.0 * M * s / ((double)K * 4) : 0.0;
    const double cost = (1.0 + traffic) / eff;
    if (cost < best - 1e-9) {
      best = cost;
      s_best = s;
    }
  }
  const int per = (K + s_best - 1) / s_best;
  p.k_chunk = (per + GEMV_T_KT - 1) / GEMV_T_KT * GEMV_T_KT;
  if (p.k_chunk > kcap) p.k_chunk = kcap;
  p.splits = (K + p.k_chunk - 1) / p.k_chunk;
  p.xn_words = gemv_align4(((long long)M * K * (long long)sizeof(T) + 3) / 4);
  p.part_words = p.splits > 1 ? gemv_align4((long long)p.splits * M * N) : 0;
  p.ticket_words = p.splits > 1 ? gemv_align4(p.tiles) : 0;
  return p;
}

// blockIdx = (tile of 256 table rows, K split).  x_n is [M, K] at T (M <=
// ROWS); E is the [N, K] f32 table.
template <typename T, int ROWS>
__global__ void __launch_bounds__(GEMV_THREADS, 2)
norm_gemv_t_kernel(const T* __restrict__ xn, const float* __restrict__ E,
                   int M, int K, int N, int k_chunk, T* __restrict__ out,
                   float* __restrict__ part, unsigned* __restrict__ tickets) {
  static_assert(GEMV_THREADS == GEMV_T_ROWS, "a thread a table row");
  constexpr int CH = GEMV_T_KT / 4;                 // 16-byte chunks a row
  constexpr int COPIES = GEMV_T_ROWS * CH / GEMV_THREADS;
  extern __shared__ __align__(16) uint8_t gemv_t_smem[];
  float* xs = (float*)(gemv_t_smem + GEMV_T_STAGES * GEMV_T_TILE_BYTES);
  __shared__ int last;
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * GEMV_T_ROWS;
  const int kb = blockIdx.y * k_chunk, len = min(K - kb, k_chunk);
  const int nst = (len + GEMV_T_KT - 1) / GEMV_T_KT;

  // stage s of the ring: rows n0.., k in [kb + 32 s, +32), zeros past N
  // and past the chunk; chunk c of row r lands at chunk c ^ (r % 8)
  auto copy = [&](int s) {
    if (s < nst) {
      uint8_t* tile = gemv_t_smem + (s % GEMV_T_STAGES) * GEMV_T_TILE_BYTES;
#pragma unroll
      for (int j = 0; j < COPIES; ++j) {
        const int i = tid + j * GEMV_THREADS, r = i / CH, c = i % CH;
        const int k = s * GEMV_T_KT + c * 4;
        const bool on = n0 + r < N && k < len;
        const float* src = on ? E + (size_t)(n0 + r) * K + kb + k : E;
        const unsigned dst =
            smem_u32(tile + r * (GEMV_T_KT * 4) + ((c ^ (r & 7)) << 4));
        asm volatile(
            "cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;\n" ::"r"(
                dst),
            "l"(src), "r"(on ? 16 : 0)
            : "memory");
      }
    }
    gemv_cp_commit();
  };
#pragma unroll
  for (int s = 0; s < GEMV_T_STAGES - 1; ++s) copy(s);
  asm volatile("griddepcontrol.wait;" ::: "memory");   // x_n is written
  // x_n's chunk as f32 [ROWS][k_chunk] (zeros past M and the chunk),
  // eight loads in flight a thread
  for (int i0 = tid; i0 < ROWS * k_chunk; i0 += 8 * GEMV_THREADS) {
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = i0 + u * GEMV_THREADS, r = i / k_chunk, k = i % k_chunk;
      v[u] = i < ROWS * k_chunk && r < M && k < len
                 ? to_f(__ldcg(xn + (size_t)r * K + kb + k))
                 : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = i0 + u * GEMV_THREADS;
      if (i < ROWS * k_chunk) xs[i] = v[u];
    }
  }

  float acc[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) acc[r] = 0.f;
  const int sw = tid & 7;
  for (int s = 0; s < nst; ++s) {
    gemv_cp_wait<GEMV_T_STAGES - 2>();
    // stage s's copies (and x_n) are in, and every thread is done with the
    // stage read last, which the next copy refills
    __syncthreads();
    copy(s + GEMV_T_STAGES - 1);
    const uint8_t* row = gemv_t_smem + (s % GEMV_T_STAGES) * GEMV_T_TILE_BYTES +
                         tid * (GEMV_T_KT * 4);
    const int k0 = s * GEMV_T_KT;
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      if (k0 + 4 * c >= len) break;
      const float4 e = *(const float4*)(row + ((c ^ sw) << 4));
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float4 x = *(const float4*)(xs + r * k_chunk + k0 + 4 * c);
        float a = acc[r];
        a = fmaf(x.x, e.x, a);
        a = fmaf(x.y, e.y, a);
        a = fmaf(x.z, e.z, a);
        a = fmaf(x.w, e.w, a);
        acc[r] = a;
      }
    }
  }
  gemv_cp_wait<0>();

  const int n = n0 + tid;
  if (gridDim.y == 1) {
    if (n < N)
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
        if (r < M) out[(size_t)r * N + n] = from_f<T>(acc[r]);
    return;
  }
  if (n < N)
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
      if (r < M) part[((size_t)blockIdx.y * M + r) * N + n] = acc[r];
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(tickets + blockIdx.x, 1u) == gridDim.y - 1;
  __syncthreads();
  if (!last || n >= N) return;
  __threadfence();
  const int splits = gridDim.y;
  for (int r = 0; r < M; ++r) {
    const float* p0 = part + (size_t)r * N + n;
    const size_t stride = (size_t)M * N;
    float sum = 0.f;
    for (int sp0 = 0; sp0 < splits; sp0 += GEMV_SPLIT_LOADS) {
      float v[GEMV_SPLIT_LOADS];
#pragma unroll
      for (int sp = 0; sp < GEMV_SPLIT_LOADS; ++sp)
        v[sp] = sp0 + sp < splits ? __ldcg(p0 + (sp0 + sp) * stride) : 0.f;
#pragma unroll
      for (int sp = 0; sp < GEMV_SPLIT_LOADS; ++sp)
        if (sp0 + sp < splits) sum += v[sp];
    }
    out[(size_t)r * N + n] = from_f<T>(sum);
  }
}

// gemv_rows_kernel, then norm_gemv_t_kernel as its programmatic dependent,
// over the workspace `ws` (plan_gemv_t's words: x_n at T [M, K], the
// partials [splits, M, N] and the tickets).  E is the [N, K] f32 table.
template <typename T, int MODE>
cudaError_t launch_norm_gemv_t(const void* x, const void* w, const float* E,
                               void* out, void* ws, int M, int K, int N,
                               float eps, int sms, cudaStream_t st) {
  if (!gemv_t_route(M, K, E)) return cudaErrorInvalidValue;
  const GemvPlan p = plan_gemv_t<T>(M, K, N, sms);
  T* xn = (T*)ws;
  float* part = (float*)ws + p.xn_words;
  unsigned* tickets = (unsigned*)(part + p.part_words);
  const int row_smem = 2 * ((K + 7) / 8 * 8) * (int)sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      gemv_rows_kernel<T, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      row_smem);
  if (err != cudaSuccess) return err;
  gemv_rows_kernel<T, MODE><<<M, INV_RMS_THREADS, row_smem, st>>>(
      (const T*)x, (const T*)w, K, eps, xn, tickets, (int)p.ticket_words);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.tiles, p.splits, 1);
  cfg.blockDim = dim3(GEMV_THREADS);
  cfg.stream = st;
  cfg.dynamicSmemBytes = GEMV_T_STAGES * GEMV_T_TILE_BYTES +
                         (size_t)(M <= 8 ? 8 : 16) * p.k_chunk * sizeof(float);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  auto run = [&](auto kernel) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)cfg.dynamicSmemBytes);
    if (e != cudaSuccess) return e;
    return cudaLaunchKernelEx(&cfg, kernel, (const T*)xn, E, M, K, N,
                              p.k_chunk, (T*)out, part, tickets);
  };
  err = M <= 8 ? run(norm_gemv_t_kernel<T, 8>) : run(norm_gemv_t_kernel<T, 16>);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

inline long long gemv_t_workspace(int dtype, int M, int K, int N, int sms) {
  return dtype == kBF16 ? plan_gemv_t<__nv_bfloat16>(M, K, N, sms).words()
                        : plan_gemv_t<float>(M, K, N, sms).words();
}

template <int MODE>
inline cudaError_t launch_gemv_t_mode(int dtype, const void* x, const void* w,
                                      const float* E, void* out, void* ws,
                                      int M, int K, int N, float eps, int sms,
                                      cudaStream_t st) {
  if (dtype == kBF16)
    return launch_norm_gemv_t<__nv_bfloat16, MODE>(x, w, E, out, ws, M, K, N,
                                                   eps, sms, st);
  return launch_norm_gemv_t<float, MODE>(x, w, E, out, ws, M, K, N, eps, sms,
                                         st);
}

inline cudaError_t launch_gemv_t(int mode, int dtype, const void* x,
                                 const void* w, const float* E, void* out,
                                 void* ws, int M, int K, int N, float eps,
                                 int sms, cudaStream_t st) {
  if (mode == kAbstract)
    return launch_gemv_t_mode<kAbstract>(dtype, x, w, E, out, ws, M, K, N,
                                         eps, sms, st);
  if (mode == kAbstractShuffle)
    return launch_gemv_t_mode<kAbstractShuffle>(dtype, x, w, E, out, ws, M, K,
                                                N, eps, sms, st);
  return launch_gemv_t_mode<kNative>(dtype, x, w, E, out, ws, M, K, N, eps,
                                     sms, st);
}

}  // namespace uisa

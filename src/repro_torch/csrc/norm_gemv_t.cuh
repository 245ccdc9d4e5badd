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
//  - The int8 twin's tied head (the JAX package's rmsnorm_matmul_q8 with
//    w_scale=None, kernels/fused.py:1440: granite-moe's f32 table
//    quantized per call; its channel is a table row) runs the same kernel
//    with QF set, after a third launch before gemv_rows_kernel:
//    q8_scales_t_kernel, pass 1, each row's scale max(amax_k |e| / 127,
//    1e-8) (the same ring, a max in place of the FMAs, a block's rows over
//    all of K).  The GEMV quantizes each float4 of its row by
//    norm_gemv.cuh::gemv_quant before the FMAs, sums K in order, and
//    multiplies the row's sum by its scale at the end (after the split
//    sum).  No int8 copy is written.  Where its shared memory fits (x_n
//    in f32 beside three strip buffers: K = 1536 at up to 9 rows, so
//    granite-moe's decode and prefill heads), the strip form below takes
//    the call instead (norm_gemv_tq_kernel: the table read from DRAM once,
//    two launches; 15% under the two passes on the card,
//    scripts/q8_head_variants.py).
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

// Stage s of the ring of a block's rows n0.. of the [N, K] table: k in
// [kb + 32 s, +32) of the chunk's `len`, zeros past N and past the chunk;
// chunk c of row r lands at chunk c ^ (r % 8).  Thread `tid` issues
// COPIES 16-byte cp.async, eight threads covering one row's 128 bytes,
// each asking L2 for the 256 bytes around it.
__device__ __forceinline__ void gemv_t_copy(uint8_t* tile, const float* E,
                                            int K, int N, int n0, int kb,
                                            int len, int s, int tid) {
  constexpr int CH = GEMV_T_KT / 4;                 // 16-byte chunks a row
  constexpr int COPIES = GEMV_T_ROWS * CH / GEMV_THREADS;
#pragma unroll
  for (int j = 0; j < COPIES; ++j) {
    const int i = tid + j * GEMV_THREADS, r = i / CH, c = i % CH;
    const int k = s * GEMV_T_KT + c * 4;
    const bool on = n0 + r < N && k < len;
    const float* src = on ? E + (size_t)(n0 + r) * K + kb + k : E;
    const unsigned dst =
        smem_u32(tile + r * (GEMV_T_KT * 4) + ((c ^ (r & 7)) << 4));
    asm volatile(
        "cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;\n" ::"r"(dst),
        "l"(src), "r"(on ? 16 : 0)
        : "memory");
  }
}

// Pass 1 of the quantized table: the scale of each of a block's 256 table
// rows (thread t row n0 + t), max(amax_k |e| / 127, 1e-8) with IEEE
// division (the JAX package's quantize_weight over the channel, a row),
// the whole row streamed through the GEMV's ring.  A thread owns its max,
// so the pass is the same in every mode.
__global__ void __launch_bounds__(GEMV_THREADS, 2)
q8_scales_t_kernel(const float* __restrict__ E, int K, int N,
                   float* __restrict__ scale) {
  constexpr int CH = GEMV_T_KT / 4;
  extern __shared__ __align__(16) uint8_t gemv_t_smem[];
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * GEMV_T_ROWS;
  const int nst = (K + GEMV_T_KT - 1) / GEMV_T_KT;
  auto copy = [&](int s) {
    if (s < nst)
      gemv_t_copy(gemv_t_smem + (s % GEMV_T_STAGES) * GEMV_T_TILE_BYTES, E,
                  K, N, n0, 0, K, s, tid);
    gemv_cp_commit();
  };
#pragma unroll
  for (int s = 0; s < GEMV_T_STAGES - 1; ++s) copy(s);
  uint32_t m = 0u;                  // the max |e| as bits, in any order
  const int sw = tid & 7;
  for (int s = 0; s < nst; ++s) {
    gemv_cp_wait<GEMV_T_STAGES - 2>();
    __syncthreads();
    copy(s + GEMV_T_STAGES - 1);
    const uint8_t* row = gemv_t_smem + (s % GEMV_T_STAGES) * GEMV_T_TILE_BYTES +
                         tid * (GEMV_T_KT * 4);
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const uint4 e = *(const uint4*)(row + ((c ^ sw) << 4));
      m = max(max(max(m, e.x & 0x7fffffffu), max(e.y & 0x7fffffffu,
                                                  e.z & 0x7fffffffu)),
              e.w & 0x7fffffffu);
    }
  }
  gemv_cp_wait<0>();
  const int n = n0 + tid;
  if (n < N) scale[n] = fmaxf(__fdiv_rn(__uint_as_float(m), 127.f), 1e-8f);
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
// ROWS); E is the [N, K] f32 table.  QF: E quantized by pass 1's row
// scales `qscale`.
template <typename T, int ROWS, bool QF = false>
__global__ void __launch_bounds__(GEMV_THREADS, 2)
norm_gemv_t_kernel(const T* __restrict__ xn, const float* __restrict__ E,
                   int M, int K, int N, int k_chunk, T* __restrict__ out,
                   float* __restrict__ part, unsigned* __restrict__ tickets,
                   const float* __restrict__ qscale) {
  static_assert(GEMV_THREADS == GEMV_T_ROWS, "a thread a table row");
  constexpr int CH = GEMV_T_KT / 4;                 // 16-byte chunks a row
  extern __shared__ __align__(16) uint8_t gemv_t_smem[];
  float* xs = (float*)(gemv_t_smem + GEMV_T_STAGES * GEMV_T_TILE_BYTES);
  __shared__ int last;
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * GEMV_T_ROWS;
  const int kb = blockIdx.y * k_chunk, len = min(K - kb, k_chunk);
  const int nst = (len + GEMV_T_KT - 1) / GEMV_T_KT;

  // stage s of the ring (gemv_t_copy)
  auto copy = [&](int s) {
    if (s < nst)
      gemv_t_copy(gemv_t_smem + (s % GEMV_T_STAGES) * GEMV_T_TILE_BYTES, E,
                  K, N, n0, kb, len, s, tid);
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

  // QF: the row's scale and its reciprocal (1 past N)
  float qs = 1.f, qy = 1.f;
  if constexpr (QF) {
    qs = n0 + tid < N ? __ldcg(qscale + n0 + tid) : 1.f;
    qy = __frcp_rn(qs);
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
      float4 e = *(const float4*)(row + ((c ^ sw) << 4));
      if constexpr (QF)
        e = make_float4(gemv_quant(e.x, qs, qy), gemv_quant(e.y, qs, qy),
                        gemv_quant(e.z, qs, qy), gemv_quant(e.w, qs, qy));
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
        if (r < M)
          out[(size_t)r * N + n] = from_f<T>(QF ? acc[r] * qs : acc[r]);
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
    out[(size_t)r * N + n] = from_f<T>(QF ? sum * qs : sum);
  }
}

// Pass 1 of the quantized [N, K] f32 table: the [N] row scales into
// `scale`.
inline cudaError_t launch_q8_scales_t(const float* E, int K, int N,
                                      float* scale, cudaStream_t st) {
  if (!gemv_t_route(1, K, E)) return cudaErrorInvalidValue;
  const int smem = GEMV_T_STAGES * GEMV_T_TILE_BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      q8_scales_t_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  q8_scales_t_kernel<<<(N + GEMV_T_ROWS - 1) / GEMV_T_ROWS, GEMV_THREADS,
                       smem, st>>>(E, K, N, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the strip form of the quantized table: one read from DRAM
// ---------------------------------------------------------------------------

// A persistent block (one an SM) owns a strip of GEMV_TQ_ROWS = 8 table
// rows at a time (contiguous: 48 KB at K = 1536), copied into one of
// GEMV_TQ_BUFS = 3 shared-memory buffers by a bulk copy a row onto the
// buffer's mbarrier, two strips ahead, so the table streams from DRAM once
// and both passes read shared memory.  Its 16 warps take a row two by two,
// warp 2 r + h half h of row r's float4s (lane l over float4s l, l + 32,
// ... of the half):
//  - pass 0: the half's max |e| (integer bits), the row's 64 lane maxima
//    read back by both warps from shared memory (no shuffle: the same
//    kernel in every mode), then the row's scale (IEEE division, as
//    q8_scales_t_kernel) and its reciprocal;
//  - pass 1: each float4 quantized (gemv_quant), then multiplied by the
//    same k of x_n's rows, staged once in shared memory as f32;
//  - each row's 64 lane sums (half 0's lanes, then half 1's, each lane's
//    float4s in order) are added in that order and scaled.
// Three barriers a strip; the last frees its buffer for the strip two ahead.
constexpr int GEMV_TQ_THREADS = 512;
constexpr int GEMV_TQ_ROWS = GEMV_TQ_THREADS / 64, GEMV_TQ_BUFS = 3;
constexpr size_t GEMV_TQ_ROOM = 220 * 1024;   // the shared memory it takes

// the strip form's shared memory (the buffers, the lanes' sums, x_n in
// f32), or 0 where it exceeds GEMV_TQ_ROOM (the two passes then)
inline size_t gemv_tq_smem(int M, int K) {
  const size_t bytes = (size_t)GEMV_TQ_BUFS * GEMV_TQ_ROWS * K * 4 +
                       (size_t)GEMV_TQ_ROWS * M * 64 * 4 + (size_t)M * K * 4;
  return bytes <= GEMV_TQ_ROOM ? bytes : 0;
}

__device__ __forceinline__ void gemv_bulk_load(void* dst, const void* src,
                                               uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

template <typename T>
__global__ void __launch_bounds__(GEMV_TQ_THREADS, 1)
norm_gemv_tq_kernel(const T* __restrict__ xn, const float* __restrict__ E,
                    int M, int K, int N, T* __restrict__ out) {
  constexpr int R = GEMV_TQ_ROWS, NB = GEMV_TQ_BUFS;
  extern __shared__ __align__(16) uint8_t tq_smem[];
  __shared__ __align__(8) uint64_t full[NB];
  const size_t buf_bytes = (size_t)R * K * 4;
  float* sums = (float*)(tq_smem + NB * buf_bytes);   // [R][M][64]
  float* xs = sums + R * M * 64;                      // [M][K]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rw = warp >> 1, half = warp & 1;
  const int strips = (N + R - 1) / R;
  const int mine = (int)blockIdx.x < strips
                       ? (strips - 1 - (int)blockIdx.x) / (int)gridDim.x + 1
                       : 0;
  if (tid == 0) {
    for (int b = 0; b < NB; ++b) mbar_init(&full[b], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // strip iteration `it`'s rows (those before N) into buffer it % NB
  auto load = [&](int it) {
    if (it >= mine) return;
    const int n0 = ((int)blockIdx.x + it * (int)gridDim.x) * R;
    const int rows = min(R, N - n0);
    uint64_t* bar = &full[it % NB];
    uint8_t* buf = tq_smem + (it % NB) * buf_bytes;
    mbar_expect_tx(bar, (uint32_t)(rows * K * 4));
    for (int r = 0; r < rows; ++r)
      gemv_bulk_load(buf + (size_t)r * K * 4, E + (size_t)(n0 + r) * K,
                     (uint32_t)K * 4, bar);
  };
  if (tid == 0)
    for (int it = 0; it < NB - 1; ++it) load(it);
  asm volatile("griddepcontrol.wait;" ::: "memory");   // x_n is written
  for (int i = tid; i < M * K; i += GEMV_TQ_THREADS)
    xs[i] = to_f(__ldcg(xn + i));
  __syncthreads();
  const int kv = K / 4;                       // float4s a row
  const int v0 = half * ((kv + 1) / 2), v1 = half ? kv : (kv + 1) / 2;
  float* row_sums = sums + rw * M * 64;        // [M][64]
  for (int it = 0; it < mine; ++it) {
    if (tid == 0) {                     // the buffer the last strip freed
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      load(it + NB - 1);
    }
    const int n = ((int)blockIdx.x + it * (int)gridDim.x) * R + rw;
    const bool on = n < N;
    const float4* row = (const float4*)(tq_smem + (it % NB) * buf_bytes +
                                        (size_t)rw * K * 4);
    mbar_wait(&full[it % NB], (it / NB) & 1);
    uint32_t m = 0u;
    if (on)
      for (int v = v0 + lane; v < v1; v += 32) {
        const uint4 e = *(const uint4*)(row + v);
        m = max(max(m, max(e.x & 0x7fffffffu, e.y & 0x7fffffffu)),
                max(e.z & 0x7fffffffu, e.w & 0x7fffffffu));
      }
    ((uint32_t*)row_sums)[half * 32 + lane] = m;
    __syncthreads();
    uint32_t a = 0u;
#pragma unroll 8
    for (int l = 0; l < 64; ++l) a = max(a, ((uint32_t*)row_sums)[l]);
    const float s = fmaxf(__fdiv_rn(__uint_as_float(a), 127.f), 1e-8f);
    const float y = __frcp_rn(s);
    float acc[SMALL_M];
#pragma unroll
    for (int r = 0; r < SMALL_M; ++r) acc[r] = 0.f;
    if (on)
#pragma unroll 2
      for (int v = v0 + lane; v < v1; v += 32) {
        float4 e = row[v];
        e = make_float4(gemv_quant(e.x, s, y), gemv_quant(e.y, s, y),
                        gemv_quant(e.z, s, y), gemv_quant(e.w, s, y));
#pragma unroll
        for (int r = 0; r < SMALL_M; ++r) {
          if (r >= M) break;
          const float4 x = *(const float4*)(xs + (size_t)r * K + 4 * v);
          float t = acc[r];
          t = fmaf(x.x, e.x, t);
          t = fmaf(x.y, e.y, t);
          t = fmaf(x.z, e.z, t);
          t = fmaf(x.w, e.w, t);
          acc[r] = t;
        }
      }
    __syncthreads();                    // both halves read the row's maxima
#pragma unroll
    for (int r = 0; r < SMALL_M; ++r)
      if (r < M) row_sums[r * 64 + half * 32 + lane] = acc[r];
    __syncthreads();
    if (on && half == 0 && lane < M) {
      float sum = 0.f;
      for (int l = 0; l < 64; ++l) sum += row_sums[lane * 64 + l];
      out[(size_t)lane * N + n] = from_f<T>(sum * s);
    }
    __syncthreads();                    // the buffer and the sums are free
  }
}

// gemv_rows_kernel, then norm_gemv_tq_kernel as its programmatic dependent,
// a block an SM, over the workspace `ws` (x_n alone).
template <typename T, int MODE>
cudaError_t launch_norm_gemv_tq(const void* x, const void* w, const float* E,
                                void* out, void* ws, int M, int K, int N,
                                float eps, int sms, cudaStream_t st) {
  const size_t smem = gemv_tq_smem(M, K);
  if (!gemv_t_route(M, K, E) || smem == 0) return cudaErrorInvalidValue;
  const int row_smem = 2 * ((K + 7) / 8 * 8) * (int)sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      gemv_rows_kernel<T, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      row_smem);
  if (err != cudaSuccess) return err;
  gemv_rows_kernel<T, MODE><<<M, INV_RMS_THREADS, row_smem, st>>>(
      (const T*)x, (const T*)w, K, eps, (T*)ws, nullptr, 0);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int strips = (N + GEMV_TQ_ROWS - 1) / GEMV_TQ_ROWS;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(strips < sms ? strips : sms);
  cfg.blockDim = dim3(GEMV_TQ_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaFuncSetAttribute(norm_gemv_tq_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&cfg, norm_gemv_tq_kernel<T>, (const T*)ws, E, M,
                           K, N, (T*)out);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// gemv_rows_kernel, then norm_gemv_t_kernel as its programmatic dependent,
// over the workspace `ws` (plan_gemv_t's words: x_n at T [M, K], the
// partials [splits, M, N] and the tickets; QF: then the [N] row scales,
// which pass 1 writes first).  E is the [N, K] f32 table.
template <typename T, int MODE, bool QF = false>
cudaError_t launch_norm_gemv_t(const void* x, const void* w, const float* E,
                               void* out, void* ws, int M, int K, int N,
                               float eps, int sms, cudaStream_t st) {
  if (!gemv_t_route(M, K, E)) return cudaErrorInvalidValue;
  if constexpr (QF)
    if (gemv_tq_smem(M, K) > 0)
      return launch_norm_gemv_tq<T, MODE>(x, w, E, out, ws, M, K, N, eps, sms,
                                          st);
  const GemvPlan p = plan_gemv_t<T>(M, K, N, sms);
  T* xn = (T*)ws;
  float* part = (float*)ws + p.xn_words;
  unsigned* tickets = (unsigned*)(part + p.part_words);
  float* qscale = QF ? (float*)ws + p.words() : nullptr;
  cudaError_t err;
  if constexpr (QF) {
    err = launch_q8_scales_t(E, K, N, qscale, st);
    if (err != cudaSuccess) return err;
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
                              p.k_chunk, (T*)out, part, tickets,
                              (const float*)qscale);
  };
  err = M <= 8 ? run(norm_gemv_t_kernel<T, 8, QF>)
               : run(norm_gemv_t_kernel<T, 16, QF>);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// QF: the strip form's x_n alone where it fits, else the workspace also
// holds the [N] row scales
inline long long gemv_t_workspace(int dtype, int M, int K, int N, int sms,
                                  bool qf) {
  const bool bf = dtype == kBF16;
  if (qf && gemv_tq_smem(M, K) > 0)
    return gemv_align4(((long long)M * K * (bf ? 2 : 4) + 3) / 4);
  return (bf ? plan_gemv_t<__nv_bfloat16>(M, K, N, sms).words()
             : plan_gemv_t<float>(M, K, N, sms).words()) +
         (qf ? gemv_align4(N) : 0);
}

template <int MODE, bool QF>
inline cudaError_t launch_gemv_t_mode(int dtype, const void* x, const void* w,
                                      const float* E, void* out, void* ws,
                                      int M, int K, int N, float eps, int sms,
                                      cudaStream_t st) {
  if (dtype == kBF16)
    return launch_norm_gemv_t<__nv_bfloat16, MODE, QF>(x, w, E, out, ws, M, K,
                                                       N, eps, sms, st);
  return launch_norm_gemv_t<float, MODE, QF>(x, w, E, out, ws, M, K, N, eps,
                                             sms, st);
}

template <bool QF = false>
inline cudaError_t launch_gemv_t(int mode, int dtype, const void* x,
                                 const void* w, const float* E, void* out,
                                 void* ws, int M, int K, int N, float eps,
                                 int sms, cudaStream_t st) {
  if (mode == kAbstract)
    return launch_gemv_t_mode<kAbstract, QF>(dtype, x, w, E, out, ws, M, K, N,
                                             eps, sms, st);
  if (mode == kAbstractShuffle)
    return launch_gemv_t_mode<kAbstractShuffle, QF>(dtype, x, w, E, out, ws, M,
                                                    K, N, eps, sms, st);
  return launch_gemv_t_mode<kNative, QF>(dtype, x, w, E, out, ws, M, K, N, eps,
                                         sms, st);
}

}  // namespace uisa

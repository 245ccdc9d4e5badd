// C = A @ B at f32 accuracy on Hopper's tensor cores (3xTF32): the
// paper's GEMM (Table V, row 1).
//
// Replaces kernels/gemm.py::gemm of the JAX package (the Pallas kernel
// _gemm_kernel, whose jnp.dot runs on the MXU in every mode: the opaque
// queryable matrix op the abstract model permits), in its abstract and
// native modes.
//
// The arithmetic, in both modes.  Each f32 element is split once, where
// it leaves shared memory for an MMA: hi = rna(x) (10 mantissa bits, to
// nearest, ties away from zero), lo = x - hi (exact) truncated to TF32;
// hi + lo keeps x to 2^-21.  An output that an inf, a NaN or an |x| near
// FLT_MAX reaches comes out inf or NaN, and is summed again in plain f32
// (split_tf32, exact_output), so the result is f32's there too.  Each fragment pair then takes
// three TF32 MMAs into one f32 sum, the small terms first: lo.hi, hi.lo,
// hi.hi.  The dropped lo.lo is below 2^-22 of a product, so this is an
// f32 product; 1xTF32 (hi.hi alone) keeps about three decimal digits and
// is another function, which check_gemm's float64 tolerances refuse.  The
// tensor cores add into their accumulator truncating, not rounding: summed
// there over K = 4096 the error grows with K (2.9e-5 relative RMS, past
// the 1e-5 tolerance).  So each K tile's MMAs start from zero and the
// tile's sum is added to the f32 accumulator with a rounding FADD
// (0.3-0.4x SGEMM's error on the same inputs at 4096^3).  bf16 operands
// arrive widened to f32; they are exact in TF32, so their lo is 0.
//
// What bounds it on the H100: operations.  At M = N = K = 4096 the three
// products are 3 x 137.4 GFLOP, 0.83 ms at 495 TFLOP/s (TF32, dense); the
// bytes (three 64 MB matrices) take 0.06 ms.  Beside the MMAs, each tile
// costs the split (two roundings and a subtraction an element) and shared
// memory: at the tensor cores' rate, wgmma's reads of the shared operand
// and the tile's copies, split and fragment reads fill shared memory's
// 128 bytes a cycle.
//
// The TPU's k grid axis with its VMEM accumulator (gemm.py:105-117)
// becomes a K loop inside the block, the accumulator in registers; every
// block owns one output tile, so nothing carries between blocks.  Ragged
// M, N and K are zero-filled by the copies and masked in the stores.
// Operands whose K or N is not a multiple of 4, or whose base is off 16
// bytes, take 4-byte cp.async copies (uisa_gemm_copy_bytes decides).
//
// - abstract (gemm_abstract_kernel): the universal budget.  Square
//   64 x 64 x 64 tiles, the edge from the scratchpad budget alone
//   (kernels/gemm.py::abstract_block_shape), no matrix-unit query; the
//   opaque matrix op is mma.sync (m16n8k8), 4 warps each a 32 x 32
//   quadrant splitting its fragments as it reads them; the operands
//   copied by 16-byte cp.async into two buffers (ASYNC_MEMORY: the next
//   tile's copy runs under this tile's MMAs, as the TPU pipeline
//   double-buffers the JAX kernel's BlockSpecs), rows padded (A by 4
//   floats, B by 8) so a fragment read hits 32 banks.  No TMA, no deeper
//   ring, no tile shaped for the unit.
// - native (gemm_native_kernel): the full feature set.  Tiles aligned to
//   the queried matrix unit (64, 256, 16): 128 x 128 outputs, 32 deep (two
//   of its depths: 128-byte rows).  wgmma takes TF32 from shared memory
//   K-major only, and B is [K, N] row-major, so each warpgroup computes
//   C^T = B^T A^T: B^T's 64 x 8 fragments from registers (split as read),
//   A's tile from shared memory as wgmma's K-major operand (m64n128k8).
//   A ring of four stages filled by TMA (A in 128-byte swizzled boxes, B
//   in rows of 136 floats so the fragment reads miss bank conflicts),
//   completing on an mbarrier a stage.  While a tile's products run, the
//   block splits the next A tile in place (hi) and into a lo tile and
//   reads the next B^T fragments, a quarter after each k8 step's issue;
//   the stores are fenced for wgmma once a tile.  TMA, not cp.async: that
//   fence also waits for a thread's cp.async copies still in flight, which
//   stalls a cp.async ring at every tile.
#include "tc_gemm.cuh"

namespace uisa {

enum GemmMode { kGemmAbstract = 0, kGemmNative = 2 };

constexpr int kAbsEdge = 64, kAbsThreads = 128;
constexpr int kAbsLdA = kAbsEdge + 4, kAbsLdB = kAbsEdge + 8;
constexpr int kAbsStage = kAbsEdge * kAbsLdA + kAbsEdge * kAbsLdB;   // floats
constexpr size_t kAbsSmem = 2 * kAbsStage * sizeof(float);

// native: A [128 m][32 k] as 128-byte rows, 16-byte chunks swizzled by
// m % 8 (wgmma's K-major layout), then B [32 k][128 n] in rows of 136
constexpr int kNatBM = 128, kNatBN = 128, kNatBK = 32, kNatStages = 4;
constexpr int kNatThreads = 256;                 // two warpgroups
constexpr int kNatSplits = kNatBM * kNatBK / 4 / kNatThreads;   // float4s a thread
static_assert(kNatSplits == kNatBK / 8, "a quarter of the split a k8 step");
constexpr int kNatLdB = kNatBN + 8;
constexpr int kNatABytes = kNatBM * kNatBK * 4;  // 16 KB
constexpr int kNatTmaBytes = kNatABytes + kNatBK * kNatLdB * 4;  // a stage's copies
constexpr int kNatStageBytes = (kNatTmaBytes + 1023) / 1024 * 1024;
constexpr int kNatLoAt = kNatStages * kNatStageBytes;   // two lo tiles of A
constexpr int kNatBarAt = kNatLoAt + 2 * kNatABytes;    // a barrier a stage
constexpr size_t kNatSmem = 1024 + kNatBarAt + kNatStages * sizeof(uint64_t);

// x rounded to TF32 (10 mantissa bits), to nearest, ties away from zero:
// cvt.rna.tf32.f32's result for every finite x, in two integer operations
// (ptxas expands the cvt, with a guard for non-finite x, to more)
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo, both TF32: hi rounded, lo = x - hi (exact in f32)
// truncated, so that a NaN in x - hi stays a NaN in lo (rounding would
// carry the all-ones NaN the card makes into the sign bit: lo = -0).  For
// finite |x| < 0x7f7ff000 hi + lo keeps x to 2^-21.  Every other x (hi
// rounded past FLT_MAX to inf, +-inf, NaN) leaves hi inf or lo NaN, so each
// product that reads it, and the output it feeds, is not finite; such
// outputs are summed again in plain f32 (exact_output).
// Subnormal x keep their TF32 bits (1e-39 splits as 9.9871e-40 and 0);
// XLA's CPU, which runs the JAX reference off the TPU, flushes them to 0.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}

// An output of C: the 3xTF32 sum v where it is finite, else row m of A
// times column n of B in plain f32 (sequential FMAs over K), which gives
// f32's value, inf or NaN where an input was inf, NaN or near FLT_MAX.
// A finite v read no such input, so only these outputs pay.
__device__ __noinline__ float exact_output(const float* __restrict__ A,
                                           const float* __restrict__ B,
                                           int N, int K, int m, int n) {
  float acc = 0.f;
  const float* a = A + (long long)m * K;
  for (int k = 0; k < K; ++k) acc = fmaf(a[k], B[(long long)k * N + n], acc);
  return acc;
}

__device__ __forceinline__ float checked(float v, const float* A,
                                         const float* B, int N, int K, int m,
                                         int n) {
  return fabsf(v) <= 3.40282347e38f ? v : exact_output(A, B, N, K, m, n);
}

template <int MT, int NT>
__device__ __forceinline__ void add_tiles(float (&acc)[MT][NT][4],
                                          const float (&p)[MT][NT][4]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] += p[i][j][r];
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One k8 step of a warp's MT x NT grid of m16n8 tiles, 3xTF32.  As points
// at the warp's first row and the step's k in an [m][k] tile (lda), Bs at
// the step's k and the warp's first column in a [k][n] tile (ldb).  Lane
// (g, t) = (lane / 4, lane % 4) holds A rows g, g + 8 at k t, t + 4 and B
// rows t, t + 4 at column g (PTX's m16n8k8 .tf32 fragments).
template <int MT, int NT>
__device__ __forceinline__ void mma_k8_3xtf32(float (&acc)[MT][NT][4],
                                              const float* As, int lda,
                                              const float* Bs, int ldb,
                                              int g, int t) {
  uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    split_tf32(Bs[t * ldb + 8 * j + g], bh[j][0], bl[j][0]);
    split_tf32(Bs[(t + 4) * ldb + 8 * j + g], bh[j][1], bl[j][1]);
  }
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const float* a = As + (16 * i + g) * lda + t;
    uint32_t ah[4], al[4];
    split_tf32(a[0], ah[0], al[0]);
    split_tf32(a[8 * lda], ah[1], al[1]);
    split_tf32(a[4], ah[2], al[2]);
    split_tf32(a[8 * lda + 4], ah[3], al[3]);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      mma_tf32(acc[i][j], al, bh[j]);
      mma_tf32(acc[i][j], ah, bl[j]);
      mma_tf32(acc[i][j], ah, bh[j]);
    }
  }
}

// the warp's accumulators into C (rows from row0, columns from col0), each
// one checked (exact_output)
template <int MT, int NT, typename OutT>
__device__ __forceinline__ void store_tiles(const float (&acc)[MT][NT][4],
                                            const float* A, const float* B,
                                            OutT* __restrict__ C, int M, int N,
                                            int K, int row0, int col0, int g,
                                            int t) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = row0 + 16 * i + 8 * h + g;
      if (m >= M) continue;
      OutT* row = C + (long long)m * N;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = col0 + 8 * j + 2 * t;
        if (n < N)
          row[n] = from_f<OutT>(checked(acc[i][j][2 * h], A, B, N, K, m, n));
        if (n + 1 < N)
          row[n + 1] = from_f<OutT>(
              checked(acc[i][j][2 * h + 1], A, B, N, K, m, n + 1));
      }
    }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(smem)),
               "l"(gmem), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(smem)),
               "l"(gmem), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int PENDING> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING));
}

// One thread's 16-byte copies of an R x W tile (W floats a row, global
// rows `ld` floats apart, from `src`) into rows of LDS floats: with T
// threads, thread t copies the 4 floats at column 4 (t % (W / 4)) of rows
// t / (W / 4) + i T / (W / 4).  Rows from row_lim and columns from col_lim
// on are out of range: their copies read `base` with size 0 (zeros).
template <int R, int W, int T, int LDS>
__device__ __forceinline__ void copy_tile16(float* dst, const float* src,
                                            const float* base, long long ld,
                                            int row_lim, int col_lim) {
  constexpr int kPer = W / 4, kStep = T / kPer;
  const int row = threadIdx.x / kPer, col = (threadIdx.x % kPer) * 4;
  const float* s = src + row * ld + col;
#pragma unroll
  for (int i = 0; i < R / kStep; ++i) {
    const bool ok = row + i * kStep < row_lim && col < col_lim;
    cp_async16(dst + (row + i * kStep) * LDS + col, ok ? s + i * kStep * ld : base, ok);
  }
}

// The same tile by 4-byte copies, one element a thread at a time; SWZ
// stores rows of W floats with 16-byte chunk c at c ^ (row % 8)
template <int R, int W, int T, int LDS, bool SWZ = false>
__device__ __forceinline__ void copy_tile4(float* dst, const float* src,
                                           const float* base, long long ld,
                                           int row_lim, int col_lim) {
#pragma unroll 8
  for (int e = threadIdx.x; e < R * W; e += T) {
    const int row = e / W, col = e % W;
    const bool ok = row < row_lim && col < col_lim;
    const int d = SWZ ? row * W + (((col / 4) ^ (row % 8)) * 4) + col % 4 : row * LDS + col;
    cp_async4(dst + d, ok ? src + row * ld + col : base, ok);
  }
}

template <bool VEC, typename OutT>
__global__ void __launch_bounds__(kAbsThreads)
gemm_abstract_kernel(const float* __restrict__ A, const float* __restrict__ B,
                     OutT* __restrict__ C, int M, int N, int K) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;   // 2 x 2 quadrants
  const int m0 = blockIdx.y * kAbsEdge, n0 = blockIdx.x * kAbsEdge;
  auto load = [&](float* stage, int k0) {
    const float* a = A + (long long)m0 * K + k0;
    const float* b = B + (long long)k0 * N + n0;
    float* bs = stage + kAbsEdge * kAbsLdA;
    if constexpr (VEC) {
      copy_tile16<kAbsEdge, kAbsEdge, kAbsThreads, kAbsLdA>(stage, a, A, K, M - m0, K - k0);
      copy_tile16<kAbsEdge, kAbsEdge, kAbsThreads, kAbsLdB>(bs, b, B, N, K - k0, N - n0);
    } else {
      copy_tile4<kAbsEdge, kAbsEdge, kAbsThreads, kAbsLdA>(stage, a, A, K, M - m0, K - k0);
      copy_tile4<kAbsEdge, kAbsEdge, kAbsThreads, kAbsLdB>(bs, b, B, N, K - k0, N - n0);
    }
  };
  float acc[2][4][4] = {};
  const int tiles = (K + kAbsEdge - 1) / kAbsEdge;
  load(smem, 0);
  cp_async_commit();
  for (int kt = 0; kt < tiles; ++kt) {
    cp_async_wait<0>();         // tile kt has landed
    __syncthreads();            // ... for every thread; tile kt - 1 is done
    if (kt + 1 < tiles) load(smem + ((kt + 1) & 1) * kAbsStage, (kt + 1) * kAbsEdge);
    cp_async_commit();
    const float* As = smem + (kt & 1) * kAbsStage;
    const float* Bs = As + kAbsEdge * kAbsLdA;
    float part[2][4][4] = {};   // the tile's sums, added to acc at its end
#pragma unroll
    for (int kk = 0; kk < kAbsEdge; kk += 8)
      mma_k8_3xtf32<2, 4>(part, As + wm * kAbsLdA + kk, kAbsLdA,
                          Bs + kk * kAbsLdB + wn, kAbsLdB, g, t);
    add_tiles(acc, part);
  }
  store_tiles<2, 4, OutT>(acc, A, B, C, M, N, K, m0 + wm, n0 + wn, g, t);
}

// d[64 x 128] (+)= a[64 x 8] (registers, tf32) @ B[8 x 128] (shared,
// K-major, 128-byte swizzle); scale_d = 0 starts d from zero
__device__ __forceinline__ void wgmma_tf32_m64n128k8(float (&d)[64],
                                                     const uint32_t (&a)[4],
                                                     uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
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

// The B^T fragments of k8 step q of one tile for warpgroup row block nb:
// lane (g, t) of warp w holds B[k][n] at n = nb + 16 w + g (+ 8),
// k = 8 q + t (+ 4), split
__device__ __forceinline__ void native_b_frag(const float* Bs, int nb, int q,
                                              uint32_t (&bh)[4], uint32_t (&bl)[4]) {
  const int w = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const float* b = Bs + (8 * q + lane % 4) * kNatLdB + nb + 16 * w + lane / 4;
  split_tf32(b[0], bh[0], bl[0]);
  split_tf32(b[8], bh[1], bl[1]);
  split_tf32(b[4 * kNatLdB], bh[2], bl[2]);
  split_tf32(b[4 * kNatLdB + 8], bh[3], bl[3]);
}

// Split the i-th quarter of the A tile in place: hi where it lies, lo into
// lo (the same layout).  The caller fences the stores for wgmma
// (fence_split) before the barrier that publishes them.
__device__ __forceinline__ void native_split_a(float* a, float* lo, int i) {
  const int f = threadIdx.x + i * kNatThreads;
  const float4 v = reinterpret_cast<const float4*>(a)[f];
  uint4 h, l;
  split_tf32(v.x, h.x, l.x);
  split_tf32(v.y, h.y, l.y);
  split_tf32(v.z, h.z, l.z);
  split_tf32(v.w, h.w, l.w);
  reinterpret_cast<uint4*>(a)[f] = h;
  reinterpret_cast<uint4*>(lo)[f] = l;
}

// the split's generic stores, ordered before wgmma's reads (async proxy)
__device__ __forceinline__ void fence_split() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <bool VEC, typename OutT>
__global__ void __launch_bounds__(kNatThreads, 1)
gemm_native_kernel(const __grid_constant__ CUtensorMap tmap_a,
                   const __grid_constant__ CUtensorMap tmap_b,
                   const float* __restrict__ A, const float* __restrict__ B,
                   OutT* __restrict__ C, int M, int N, int K) {
  extern __shared__ uint8_t nat_smem_raw[];
  uint8_t* smem = nat_smem_raw + ((1024 - (smem_u32(nat_smem_raw) & 1023)) & 1023);
  float* lo_tiles = reinterpret_cast<float*>(smem + kNatLoAt);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kNatBarAt);
  const int tid = threadIdx.x, wg = tid / 128;
  const int m0 = blockIdx.y * kNatBM, n0 = blockIdx.x * kNatBN;
  const int tiles = (K + kNatBK - 1) / kNatBK;
  auto stage_a = [&](int kt) {
    return reinterpret_cast<float*>(smem + (kt % kNatStages) * kNatStageBytes);
  };
  auto lo_tile = [&](int kt) { return lo_tiles + (kt & 1) * (kNatBM * kNatBK); };
  // tile kt into its stage: TMA (one thread; completes on full[stage]), or
  // 4-byte cp.async by every thread
  auto load = [&](int kt) {
    float* a = stage_a(kt);
    const int k0 = kt * kNatBK;
    if constexpr (VEC) {
      uint64_t* bar = &full[kt % kNatStages];
      mbar_expect_tx(bar, kNatTmaBytes);
      tma_load_2d(a, &tmap_a, bar, k0, m0);
      tma_load_2d(a + kNatBM * kNatBK, &tmap_b, bar, n0, k0);
    } else {
      copy_tile4<kNatBM, kNatBK, kNatThreads, kNatBK, true>(
          a, A + (long long)m0 * K + k0, A, K, M - m0, K - k0);
      copy_tile4<kNatBK, kNatBN, kNatThreads, kNatLdB, false>(
          a + kNatBM * kNatBK, B + (long long)k0 * N + n0, B, N, K - k0, N - n0);
      cp_async_commit();
    }
  };
  // wait until tile kt has landed, for every thread
  auto landed = [&](int kt) {
    if constexpr (VEC) {
      mbar_wait(&full[kt % kNatStages], (kt / kNatStages) & 1);
    } else {
      cp_async_wait<kNatStages - 2>();
      __syncthreads();
    }
  };
  if constexpr (VEC) {
    if (tid == 0) {
      for (int s = 0; s < kNatStages; ++s) mbar_init(&full[s], 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }
  for (int s = 0; s < kNatStages - 1; ++s) {
    if (VEC ? tid == 0 && s < tiles : true) {
      if (s < tiles) load(s);
      else cp_async_commit();   // keeps the group count
    }
  }
  landed(0);
#pragma unroll
  for (int i = 0; i < kNatSplits; ++i) native_split_a(stage_a(0), lo_tile(0), i);
  fence_split();
  __syncthreads();

  float acc[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  uint32_t bh[2][4][4], bl[2][4][4];     // B^T fragments of tiles kt, kt + 1
#pragma unroll
  for (int q = 0; q < 4; ++q)
    native_b_frag(stage_a(0) + kNatBM * kNatBK, wg * 64, q, bh[0][q], bl[0][q]);
  // the copy of tile kt + 3 starts (its stage held kt - 1), then tile kt's
  // products from fragments c; under them, tile kt + 1 is waited for,
  // split and its fragments read into n, a quarter after each step's
  // issue
  auto step = [&](int kt, uint32_t (&ch)[4][4], uint32_t (&cl)[4][4],
                  uint32_t (&nh)[4][4], uint32_t (&nl)[4][4]) {
    const float* a = stage_a(kt);
    const float* lo = lo_tile(kt);
    const int next = kt + kNatStages - 1;
    if (VEC ? tid == 0 && next < tiles : true) {
      if (next < tiles) load(next);
      else cp_async_commit();
    }
    const bool more = kt + 1 < tiles;
    wgmma_fence();
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      // k8 step q: 32 bytes along the swizzled rows; lo.hi, hi.lo, hi.hi
      wgmma_tf32_m64n128k8(part, ch[q], wgmma_desc(lo + 8 * q, 16, 1024), q > 0);
      wgmma_tf32_m64n128k8(part, cl[q], wgmma_desc(a + 8 * q, 16, 1024), 1);
      wgmma_tf32_m64n128k8(part, ch[q], wgmma_desc(a + 8 * q, 16, 1024), 1);
      if (more) {
        if (q == 0) landed(kt + 1);
        native_split_a(stage_a(kt + 1), lo_tile(kt + 1), q);
        native_b_frag(stage_a(kt + 1) + kNatBM * kNatBK, wg * 64, q, nh[q], nl[q]);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_split();
    fence_sums(part);
#pragma unroll
    for (int q = 0; q < 4; ++q)        // the fragments stay put until here
#pragma unroll
      for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(ch[q][r]), "+r"(cl[q][r]));
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += part[i];
    __syncthreads();              // tile kt + 1 split; every product of kt done
  };
  for (int kt = 0; kt < tiles; kt += 2) {
    step(kt, bh[0], bl[0], bh[1], bl[1]);
    if (kt + 1 < tiles) step(kt + 1, bh[1], bl[1], bh[0], bl[0]);
  }

  // sums 4j..4j+3: C^T rows (n) r, r + 8, columns (m) 8j + 2 (lane % 4), + 1
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int n = n0 + wg * 64 + warp * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int m = m0 + 8 * j + 2 * (lane % 4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (m + h >= M) continue;
      OutT* row = C + (long long)(m + h) * N;
      if (n < N)
        row[n] = from_f<OutT>(checked(acc[4 * j + h], A, B, N, K, m + h, n));
      if (n + 8 < N)
        row[n + 8] = from_f<OutT>(
            checked(acc[4 * j + 2 + h], A, B, N, K, m + h, n + 8));
    }
  }
}

// the map of a row-major [rows, cols] f32 matrix read in boxes of
// box_rows x box_cols, zeros past the edge
inline bool tensor_map_f32(CUtensorMap* map, const void* ptr, int rows, int cols,
                           int box_rows, int box_cols, CUtensorMapSwizzle swizzle) {
  const TensorMapEncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(float)};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(ptr), dims,
                strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the bytes a copy moves: 16 where the rows and bases allow, else 4
inline int gemm_copy_bytes(const void* A, const void* B, int N, int K) {
  return K % 4 == 0 && N % 4 == 0 && (uintptr_t)A % 16 == 0 &&
                 (uintptr_t)B % 16 == 0
             ? 16 : 4;
}

template <typename OutT>
cudaError_t launch_gemm(int mode, const float* A, const float* B, OutT* C,
                        int M, int N, int K, cudaStream_t st) {
  const bool vec = gemm_copy_bytes(A, B, N, K) == 16;
  if (mode == kGemmAbstract) {
    const dim3 grid((N + kAbsEdge - 1) / kAbsEdge, (M + kAbsEdge - 1) / kAbsEdge);
    auto kernel = vec ? gemm_abstract_kernel<true, OutT> : gemm_abstract_kernel<false, OutT>;
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kAbsSmem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kAbsThreads, kAbsSmem, st>>>(A, B, C, M, N, K);
  } else {
    const dim3 grid((N + kNatBN - 1) / kNatBN, (M + kNatBM - 1) / kNatBM);
    // A in [128 m][32 k] boxes, 128-byte swizzle; B in [32 k][136 n] boxes,
    // rows of 136 floats (8 past the tile: fragment reads free of bank
    // conflicts)
    CUtensorMap map_a = {}, map_b = {};
    if (vec && (!tensor_map_f32(&map_a, A, M, K, kNatBM, kNatBK, CU_TENSOR_MAP_SWIZZLE_128B) ||
                !tensor_map_f32(&map_b, B, K, N, kNatBK, kNatLdB, CU_TENSOR_MAP_SWIZZLE_NONE)))
      return cudaErrorInvalidValue;
    auto kernel = vec ? gemm_native_kernel<true, OutT> : gemm_native_kernel<false, OutT>;
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kNatSmem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kNatThreads, kNatSmem, st>>>(map_a, map_b, A, B, C, M, N, K);
  }
  return cudaGetLastError();
}

}  // namespace uisa

// mode: 0 abstract, 2 native; out_dtype: 0 f32, 1 bf16.  A [M,K] and B
// [K,N] f32, row-major and contiguous; C [M,N] in out_dtype.  (bm, bn, bk)
// is the tile the caller planned, which must be the compiled one (64, 64,
// 64) or (128, 128, 32), so the Python plan and the kernel cannot drift.
extern "C" int uisa_gemm(int mode, int out_dtype, const void* A, const void* B,
                         void* C, int M, int N, int K, int bm, int bn, int bk,
                         void* stream) {
  using namespace uisa;
  const bool tile_ok =
      mode == kGemmAbstract ? (bm == kAbsEdge && bn == kAbsEdge && bk == kAbsEdge)
      : mode == kGemmNative ? (bm == kNatBM && bn == kNatBN && bk == kNatBK)
                            : false;
  if (!tile_ok || M < 1 || N < 1 || K < 1 || (M + 63) / 64 > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (out_dtype == kBF16)
    return (int)launch_gemm<__nv_bfloat16>(mode, (const float*)A, (const float*)B,
                                           (__nv_bfloat16*)C, M, N, K, st);
  return (int)launch_gemm<float>(mode, (const float*)A, (const float*)B,
                                 (float*)C, M, N, K, st);
}

// How a uisa_gemm launch with these operands copies them: 16 (native by
// TMA, abstract by 16-byte cp.async) when K and N are multiples of 4 and
// both bases 16-byte aligned, else 4 (4-byte cp.async).
extern "C" int uisa_gemm_copy_bytes(const void* A, const void* B, int N, int K) {
  return uisa::gemm_copy_bytes(A, B, N, K);
}

// A tensor-core GEMM for Hopper: C[M, N] = A[M, K] @ B[K, N], A bf16, B
// bf16 or int8 with per-column f32 scales, the sums in f32 registers, C
// written in bf16; or, in its SwiGLU form, C[M, F] = silu(A @ wg) * (A @ wi)
// against B = w_cat = [wi|wg] [K, 2F].  It is the prefill product of three
// kernels, each with its own prologue:
//  - rmsnorm_matmul (rmsnorm_matmul.cu): A is the normalized activation
//    (norm_gemm.cuh::norm_rows_kernel), B the projection;
//  - rmsnorm_swiglu (rmsnorm_swiglu.cu): the same A, B = w_cat, the SwiGLU
//    form, bf16 or int8;
//  - flash_attention_matmul (flash_attention_matmul.cu): A is the attention
//    output O (attention_tc.cuh), B is wo, bf16 or int8.
// With those prologues it replaces, at prefill, kernels/fused.py::
// rmsnorm_matmul, rmsnorm_swiglu and flash_attention_matmul of the JAX
// package, and the int8 twins rmsnorm_swiglu_q8 and
// flash_attention_matmul_q8.
//
// Bound on Hopper: operations.  granite-8b's qkv at 512 rows (x [512,4096]
// @ wqkv [4096,6144]) is 25.8 GFLOP: 26 us at the 989 TFLOP/s bf16
// tensor-core peak against 16 us for its 54 MB at 3.35 TB/s; the wo
// product of a 512-token prompt (17.2 GFLOP) 17 us against 12 us; [wi|wg]
// at 300 rows (70.5 GFLOP) 71 us against 66 us for its 235 MB of bf16
// weight (36 us for int8).  On the f32 FMA units (67 TFLOP/s) the same
// qkv takes at least 0.39 ms, and only wgmma reaches the tensor cores'
// full rate, so the design is what wgmma needs:
//  - one 128 x 128 output tile a block, BK = 64 (one 128-byte swizzle row
//    of bf16).  Two warpgroups each own 64 rows of the tile and issue
//    wgmma.mma_async.m64n128k16 (four a BK step) with both operands in
//    shared memory; the f32 sums stay in registers (64 a thread);
//  - TMA tile loads (cp.async.bulk.tensor, 128-byte swizzle) into a ring of
//    TC_STAGES stages, each completed on its `full` mbarrier.  Each
//    warpgroup releases a stage on its `empty` mbarrier once its products
//    are done, and thread 0 refills it with the tile TC_STAGES steps
//    ahead, so the loads of the next stages overlap this stage's products;
//  - B is the weight as the model stores it, [K, N] row major, the layout
//    the decode kernels read: the descriptor takes it MN-major (wgmma's
//    transposed B, which bf16 allows), two 64-column TMA boxes a stage.
//    The weight is never copied or transposed;
//  - 97 KB of shared memory and 256 threads a block, so two blocks share an
//    SM: at 512 rows the 4 x 48 tiles of wqkv are all in flight at once on
//    the 132 SMs (300 rows: 3 x 48), with no split K and no workspace;
//  - a ragged M reads TMA's zero fill past row M and masks its stores.
// The SwiGLU form (SWIGLU): the two boxes of a stage are 64 columns of wi
// at n0 and the same 64 columns of wg at F + n0 in the one w_cat; each box
// feeds its own wgmma m64n64k16 into its own 32 sums a thread (still 64 in
// all), and the epilogue writes silu(hg) * hi in f32, rounded to bf16 once,
// for a 128 x 64 output tile.  The silu gate never leaves the registers.
// This form keeps one group of products in flight (wgmma.wait_group 1): a
// step issues its products, waits for the step before's, and only then
// releases that step's stage, so the tensor cores are never left without
// work while a warpgroup waits.  It numbers its row tiles first in the
// grid, so the 3-4 row tiles of a prompt that share a column tile of the
// 235 MB [wi|wg] run side by side and read it from HBM once, not once per
// row tile; the int8 forms do the same.
// An int8 B (WT = int8_t, the int8 twins): the stage's two boxes arrive by
// TMA as int8 (4 KB each, unswizzled), and the block's 256 threads widen
// them to bf16 into the swizzled MN-major layout the descriptors read, in
// one of two bf16 buffers that alternate by step; int8 widens to bf16
// exactly (|q| <= 127 fits bf16's 8 significant bits), so the products
// run on the bf16 wgmma as they do for a bf16 weight, and the activations
// are never quantized.  Each step issues its products on the tile widened
// the step before and widens the next stage's tiles while they run.  The
// threads write the buffer through the generic proxy and wgmma reads it
// through the async proxy, so each thread fences
// (fence.proxy.async.shared::cta) and both warpgroups meet at a barrier
// before the products that read it.  The per-column scale multiplies the
// f32 sum in the epilogue (the JAX kernel scales the tile before its dot:
// the two orders differ by f32 rounding).  Three stages of 24 KB and the
// two 16 KB bf16 buffers make 105 KB a block, so two blocks still share an
// SM.  The bf16 form without the gate keeps the loop of its first design
// (wait for each step's products before the next).
// What bounds the design today: at 128 x 128 (or 128 x 64 + 64) tiles
// each step moves 32 KB from L2 for 2.1 MFLOP, 64 operations a byte, so
// the L2's bandwidth, not the tensor cores, sets the rate (PERF.md's rows
// imply 5-7 TB/s of tile loads at 35-45% of the bf16 peak); larger tiles
// or cluster multicast of the shared tile are the next step.
// The route (tc_route): M > 16 (decode rows stay on the FMA kernels),
// K % 64 == 0, N % 8 for bf16 and N % 16 for int8 (TMA's 16-byte strides;
// in the SwiGLU form, F % 8 and F % 16, so that wg's box starts on 16
// bytes too) and a 16-byte aligned B; the callers add bf16 activations.
// The tensor maps are encoded on the host at each launch by
// cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint, so the
// library needs no -lcuda.
#pragma once
#include <cuda.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace uisa {

// GEMMs of at most this many rows are decode GEMMs and stay on the f32 FMA
// kernels (norm_gemm.cuh's SMALL_M; rmsnorm_matmul.cu checks the two agree)
constexpr int TC_DECODE_ROWS = 16;

constexpr int TC_BM = 128, TC_BN = 128, TC_BK = 64, TC_STAGES = 3;
constexpr int TC_THREADS = 256;                   // two consumer warpgroups
constexpr int TC_BOX_N = 64;                      // B's box: 64 columns
constexpr int TC_A_BYTES = TC_BM * TC_BK * 2;     // 16 KB
constexpr int TC_B_BOX_BYTES = TC_BK * TC_BOX_N * 2;

// The shared memory of the form with weight type WT: a ring of TC_STAGES
// stages, each the A tile and B's two boxes as TMA writes them (bf16
// swizzled, or int8 unswizzled), then, for int8, the two bf16 buffers of
// two boxes each that the widened tiles alternate between, then the full /
// empty barriers; all aligned to 1024 bytes (the 128-byte swizzle's
// period).  bf16: 3 x 32 KB; int8: 3 x 24 KB + 2 x 16 KB.
template <typename WT, bool SWIGLU = false>
struct TcSmem {
  static constexpr bool kQ8 = std::is_same<WT, int8_t>::value;
  // the grid's order: row tiles first (blockIdx.x), so the row tiles of
  // one weight column tile run side by side and share its tiles in L2 (a
  // 235 MB [wi|wg] would otherwise stream from HBM once per row tile); bf16
  // without the gate keeps column tiles first, the order its rows were
  // measured in
  static constexpr bool kRowsFirst = kQ8 || SWIGLU;
  static constexpr int kBoxBytes = TC_BK * TC_BOX_N * (int)sizeof(WT);
  static constexpr int kStageBytes = TC_A_BYTES + 2 * kBoxBytes;
  static constexpr int kWideBytes = 2 * TC_B_BOX_BYTES;   // one bf16 B tile
  static constexpr int kWideAt = TC_STAGES * kStageBytes;
  static constexpr int kBarAt = kWideAt + (kQ8 ? 2 * kWideBytes : 0);
  static constexpr size_t kBytes =
      1024 + kBarAt + 2 * TC_STAGES * sizeof(uint64_t);
};

// one box of `map` at (c0 inner, c1 outer) into dst, completing on bar
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"((uint64_t)map), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// A shared-memory matrix descriptor, 128-byte swizzle: start address, the
// leading and stride byte offsets, each in 16-byte units
__device__ __forceinline__ uint64_t wgmma_desc(const void* smem, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((smem_u32(smem) & 0x3FFFF) >> 4) |
         ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// wait until at most one committed group is still running
__device__ __forceinline__ void wgmma_wait_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// d[64x128] += A[64x16] (K-major) @ B[16x128] (MN-major: the last
// immediate, imm-trans-b, is 1); the predicate scale-d = 1 keeps d
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
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
      : "l"(da), "l"(db), "r"(1));
}

// d[64x64] += A[64x16] (K-major) @ B[16x64] (MN-major), the SwiGLU form's
// product of one box: d is 32 consecutive sums of the caller's 64
__device__ __forceinline__ void wgmma_m64n64k16(float* d, uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// keep the compiler from moving reads of the sums across wgmma_wait_all
__device__ __forceinline__ void fence_sums(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Four int8 values (one 32-bit word) as four bf16, two to a word, exactly:
// q ^ 0x80 = q + 128 as the low byte of the float 2^23 gives 2^23 + q +
// 128; subtracting 2^23 + 128 leaves q, and a float of at most 8
// significant bits is its bf16 in its upper half.
__device__ __forceinline__ void widen_i8x4(uint32_t w, uint32_t& lo,
                                          uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  const float magic = 8388736.f;                   // 2^23 + 128
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) - magic;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) - magic;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442)) - magic;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7443)) - magic;
  lo = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  hi = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
}

// The int8 form's step: the block's 256 threads widen the stage's two int8
// boxes ([64 k][64 n], k row at k * 64 bytes) into `wide`, two bf16 boxes
// in the layout TMA gives a bf16 box (k row at k * 128 bytes, 16-byte
// chunks swizzled by k % 8).  Thread t takes the 16 bytes at t * 16 of each
// box (row t / 4, columns 16 (t % 4) ..): a warp reads 512 contiguous
// bytes, and the two rows of a quarter warp write disjoint chunks.
__device__ __forceinline__ void widen_b_tile(const uint8_t* q8, uint8_t* wide,
                                             int tid) {
  const int k = tid / 4, c = 2 * (tid % 4);
#pragma unroll
  for (int box = 0; box < 2; ++box) {
    const uint4 v =
        *(const uint4*)(q8 + box * TC_BK * TC_BOX_N + tid * 16);
    uint4 w0, w1;
    widen_i8x4(v.x, w0.x, w0.y);
    widen_i8x4(v.y, w0.z, w0.w);
    widen_i8x4(v.z, w1.x, w1.y);
    widen_i8x4(v.w, w1.z, w1.w);
    uint8_t* row = wide + box * TC_B_BOX_BYTES + k * 128;
    *(uint4*)(row + ((c ^ (k % 8)) * 16)) = w0;
    *(uint4*)(row + (((c + 1) ^ (k % 8)) * 16)) = w1;
  }
}

// blockIdx = (N tile, M tile).  Shared memory per stage: A [128 rows][64]
// (row r at r * 128 bytes, 16-byte chunks swizzled by r % 8), then B as two
// [64 k][64 n] boxes 8 KB apart (k row at k * 128 bytes, the same swizzle),
// int8 boxes 4 KB apart (unswizzled) widened into a bf16 buffer of that
// layout for WT = int8_t.  `scale` ([N], or [2N] for SWIGLU: wi reads [:N],
// wg [N:]) multiplies the sums for int8 and is unused for bf16.  SWIGLU: N
// is F, B is [K, 2N] and the output tile is 128 x 64.
template <typename WT = __nv_bfloat16, bool SWIGLU = false>
__global__ void __launch_bounds__(TC_THREADS, 2)
tc_gemm_kernel(const __grid_constant__ CUtensorMap tmap_a,
               const __grid_constant__ CUtensorMap tmap_b,
               __nv_bfloat16* __restrict__ C, int M, int N, int K,
               const float* __restrict__ scale) {
  using L = TcSmem<WT, SWIGLU>;
  extern __shared__ uint8_t tc_smem_raw[];
  uint8_t* smem =
      tc_smem_raw + ((1024 - (smem_u32(tc_smem_raw) & 1023)) & 1023);
  uint64_t* full = (uint64_t*)(smem + L::kBarAt);
  uint64_t* empty = full + TC_STAGES;
  const int tid = threadIdx.x, wg = tid / 128;
  const int m0 = (L::kRowsFirst ? blockIdx.x : blockIdx.y) * TC_BM,
            n0 = (L::kRowsFirst ? blockIdx.y : blockIdx.x) *
                 (SWIGLU ? TC_BOX_N : TC_BN);
  const int steps = K / TC_BK;

  if (tid == 0) {
    for (int s = 0; s < TC_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);            // one arrival per warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  auto load = [&](int stage, int step) {
    uint8_t* a = smem + stage * L::kStageBytes;
    uint8_t* b = a + TC_A_BYTES;
    const int k0 = step * TC_BK;
    mbar_expect_tx(&full[stage], L::kStageBytes);
    tma_load_2d(a, &tmap_a, &full[stage], k0, m0);
    tma_load_2d(b, &tmap_b, &full[stage], n0, k0);
    // the second box: the next 64 columns, or, SWIGLU, wg's at F + n0
    tma_load_2d(b + L::kBoxBytes, &tmap_b, &full[stage],
                SWIGLU ? N + n0 : n0 + TC_BOX_N, k0);
  };
  if (tid == 0)
    for (int s = 0; s < TC_STAGES && s < steps; ++s) load(s, s);

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  // one step's products: this warpgroup's 64 rows of A against B's tile
  auto products = [&](const uint8_t* a, const uint8_t* b) {
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TC_BK / 16; ++kk) {
      // A, K-major: 16 k = 32 bytes along the swizzled row, 8-row groups
      // 1024 bytes apart.  B, MN-major: 16 k = 16 rows of 128 bytes; the
      // two 64-column boxes 8 KB apart (leading), 8-k groups 1024 apart.
      if constexpr (SWIGLU) {
        const uint64_t da = wgmma_desc(a + kk * 32, 16, 1024);
        wgmma_m64n64k16(acc, da, wgmma_desc(b + kk * 16 * 128,
                                            TC_B_BOX_BYTES, 1024));
        wgmma_m64n64k16(acc + 32, da,
                        wgmma_desc(b + TC_B_BOX_BYTES + kk * 16 * 128,
                                   TC_B_BOX_BYTES, 1024));
      } else {
        wgmma_m64n128k16(acc, wgmma_desc(a + kk * 32, 16, 1024),
                         wgmma_desc(b + kk * 16 * 128, TC_B_BOX_BYTES, 1024));
      }
    }
    wgmma_commit();
  };
  // both warpgroups are done with the stage of step t: thread 0 refills it
  // with the tile TC_STAGES steps ahead
  auto release = [&](int t) {
    const int s = t % TC_STAGES;
    if (tid % 128 == 0) mbar_arrive(&empty[s]);
    if (tid == 0 && t + TC_STAGES < steps) {
      mbar_wait(&empty[s], (t / TC_STAGES) & 1);
      load(s, t + TC_STAGES);
    }
  };

  if constexpr (L::kQ8) {
    // Each step issues its products on the bf16 tile widened the step
    // before, and widens the next stage's int8 tiles into the other buffer
    // while they run; the barrier that ends a step finds every thread's
    // widened tile fenced and both warpgroups past the products that read
    // the buffer the next step widens into.
    auto widen = [&](int t) {
      const int s = t % TC_STAGES;
      mbar_wait(&full[s], (t / TC_STAGES) & 1);
      widen_b_tile(smem + s * L::kStageBytes + TC_A_BYTES,
                   smem + L::kWideAt + (t & 1) * L::kWideBytes, tid);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    };
    widen(0);
    __syncthreads();
    for (int step = 0; step < steps; ++step) {
      products(smem + (step % TC_STAGES) * L::kStageBytes + wg * 64 * 128,
               smem + L::kWideAt + (step & 1) * L::kWideBytes);
      if (step + 1 < steps) widen(step + 1);
      wgmma_wait_all();
      fence_sums(acc);
      release(step);
      __syncthreads();
    }
  } else if constexpr (SWIGLU) {
    // one group of products stays in flight: a step waits for the step
    // before's, then releases that step's stage
    for (int step = 0; step < steps; ++step) {
      const int s = step % TC_STAGES;
      mbar_wait(&full[s], (step / TC_STAGES) & 1);
      products(smem + s * L::kStageBytes + wg * 64 * 128,
               smem + s * L::kStageBytes + TC_A_BYTES);
      wgmma_wait_one();
      fence_sums(acc);
      if (step > 0) release(step - 1);
      __syncwarp();
    }
    wgmma_wait_all();
    fence_sums(acc);
  } else {
    for (int step = 0; step < steps; ++step) {
      const int s = step % TC_STAGES;
      const uint32_t parity = (step / TC_STAGES) & 1;
      mbar_wait(&full[s], parity);
      const uint8_t* a = smem + s * L::kStageBytes + wg * 64 * 128;
      const uint8_t* b = smem + s * L::kStageBytes + TC_A_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TC_BK / 16; ++kk)
        wgmma_m64n128k16(acc, wgmma_desc(a + kk * 32, 16, 1024),
                         wgmma_desc(b + kk * 16 * 128, TC_B_BOX_BYTES, 1024));
      wgmma_commit();
      wgmma_wait_all();
      fence_sums(acc);
      if (tid % 128 == 0) mbar_arrive(&empty[s]);
      if (tid == 0 && step + TC_STAGES < steps) {
        mbar_wait(&empty[s], parity);       // both warpgroups are done with s
        load(s, step + TC_STAGES);
      }
      __syncwarp();
    }
  }

  // the m64n128 accumulator: sums 4j..4j+3 of a thread are rows r, r + 8,
  // columns 8j + 2 (lane % 4) and the next; SWIGLU: two m64n64
  // accumulators of that layout, hi in sums 0-31 and hg in 32-63
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int r0 = m0 + wg * 64 + warp * 16 + lane / 4;
  if constexpr (SWIGLU) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + j * 8 + (lane % 4) * 2;
      if (n >= N) continue;
      float si0 = 1.f, si1 = 1.f, sg0 = 1.f, sg1 = 1.f;
      if constexpr (L::kQ8) {
        si0 = scale[n];
        si1 = scale[n + 1];
        sg0 = scale[N + n];
        sg1 = scale[N + n + 1];
      }
      const float* hi = acc + 4 * j;
      const float* hg = acc + 32 + 4 * j;
      if (r0 < M)
        *(__nv_bfloat162*)(C + (size_t)r0 * N + n) = __floats2bfloat162_rn(
            silu(hg[0] * sg0) * (hi[0] * si0),
            silu(hg[1] * sg1) * (hi[1] * si1));
      if (r0 + 8 < M)
        *(__nv_bfloat162*)(C + (size_t)(r0 + 8) * N + n) =
            __floats2bfloat162_rn(silu(hg[2] * sg0) * (hi[2] * si0),
                                  silu(hg[3] * sg1) * (hi[3] * si1));
    }
  } else {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int n = n0 + j * 8 + (lane % 4) * 2;
      if (n >= N) continue;
      if constexpr (L::kQ8) {
        const float s0 = scale[n], s1 = scale[n + 1];
        acc[4 * j] *= s0;
        acc[4 * j + 1] *= s1;
        acc[4 * j + 2] *= s0;
        acc[4 * j + 3] *= s1;
      }
      if (r0 < M)
        *(__nv_bfloat162*)(C + (size_t)r0 * N + n) =
            __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
      if (r0 + 8 < M)
        *(__nv_bfloat162*)(C + (size_t)(r0 + 8) * N + n) =
            __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
}

// Whether C[M, N] = A[M, K] @ B[K, N] (SWIGLU: C[M, N] against B [K, 2N])
// takes tc_gemm_kernel with a B of type WT (the callers add that A is bf16
// and B is read [K, N]): TMA needs B 16-byte aligned and its rows in
// multiples of 16 bytes, and the SwiGLU form's wg box, at column N, starts
// on a 16-byte boundary too (an int8 box 8 bytes off one faulted on the
// card), so N columns of WT make a multiple of 16 bytes in both forms.
template <typename WT = __nv_bfloat16, bool SWIGLU = false>
inline bool tc_route(int M, int K, int N, const void* B) {
  return M > TC_DECODE_ROWS && K % TC_BK == 0 &&
         ((long long)N * (long long)sizeof(WT)) % 16 == 0 &&
         ((uintptr_t)B & 15) == 0;
}

using TensorMapEncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, looked up once (nullptr if absent)
inline TensorMapEncodeTiled tensor_map_encoder() {
  static const TensorMapEncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? (TensorMapEncodeTiled)p
               : nullptr;
  }();
  return fn;
}

// the map of a row-major [rows, cols] matrix of E (bf16 or int8) read in
// boxes of box_rows x box_cols, zeros past the edge: bf16 boxes 128 bytes
// wide with the 128-byte swizzle wgmma reads, int8 boxes unswizzled (the
// kernel widens them into that layout)
template <typename E = __nv_bfloat16>
inline bool tensor_map_2d(CUtensorMap* map, const void* ptr, int rows,
                          int cols, int box_rows, int box_cols) {
  constexpr bool kQ8 = std::is_same<E, int8_t>::value;
  const TensorMapEncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(E)};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map,
                kQ8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                    : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                2, const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                kQ8 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// C [M, N] = A [M, K] @ B [K, N] (times `scale` [N] for an int8 B), or, with
// SWIGLU, C [M, N] = silu(A @ B[:, N:]) * (A @ B[:, :N]) against B [K, 2N]
// (`scale` [2N] for int8); A and C bf16, all row major.  The shape must take
// the route (tc_route), A must be 16-byte aligned, and `scale` is given for
// an int8 B alone.
template <typename WT = __nv_bfloat16, bool SWIGLU = false>
inline cudaError_t launch_tc_gemm(const void* A, const void* B, void* C,
                                  int M, int K, int N, cudaStream_t st,
                                  const float* scale = nullptr) {
  using L = TcSmem<WT, SWIGLU>;
  if (!tc_route<WT, SWIGLU>(M, K, N, B) || ((uintptr_t)A & 15) != 0 ||
      (scale != nullptr) != L::kQ8)
    return cudaErrorInvalidValue;
  CUtensorMap map_a, map_b;
  if (!tensor_map_2d(&map_a, A, M, K, TC_BM, TC_BK) ||
      !tensor_map_2d<WT>(&map_b, B, K, SWIGLU ? 2 * N : N, TC_BK, TC_BOX_N))
    return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      tc_gemm_kernel<WT, SWIGLU>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)L::kBytes);
  if (err != cudaSuccess) return err;
  const int bn = SWIGLU ? TC_BOX_N : TC_BN;
  const unsigned m_tiles = (M + TC_BM - 1) / TC_BM, n_tiles = (N + bn - 1) / bn;
  const dim3 grid = L::kRowsFirst ? dim3(m_tiles, n_tiles)
                                  : dim3(n_tiles, m_tiles);
  tc_gemm_kernel<WT, SWIGLU><<<grid, TC_THREADS, L::kBytes, st>>>(
      map_a, map_b, (__nv_bfloat16*)C, M, N, K, scale);
  return cudaGetLastError();
}

}  // namespace uisa

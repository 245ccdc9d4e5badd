// A tensor-core GEMM for Hopper: C[M, N] = A[M, K] @ B[K, N], A and B in
// bf16, the sums in f32 registers, C written in bf16.  It is the prefill
// product of two kernels, each with its own prologue:
//  - rmsnorm_matmul (rmsnorm_matmul.cu): A is the normalized activation
//    (norm_gemm.cuh::norm_rows_kernel), B the projection;
//  - flash_attention_matmul (flash_attention_matmul.cu): A is the attention
//    output O (attention_tc.cuh), B is wo.
// With those prologues it replaces, at prefill, kernels/fused.py::
// rmsnorm_matmul and kernels/fused.py::flash_attention_matmul of the JAX
// package.
//
// Bound on Hopper: operations.  granite-8b's qkv at 512 rows (x [512,4096]
// @ wqkv [4096,6144]) is 25.8 GFLOP: 26 us at the 989 TFLOP/s bf16
// tensor-core peak against 16 us for its 54 MB at 3.35 TB/s; the wo
// product of a 512-token prompt (17.2 GFLOP) 17 us against 12 us.  On the
// f32 FMA units (67 TFLOP/s) the same qkv takes at least 0.39 ms, and only
// wgmma reaches the tensor cores' full rate, so the design is what wgmma
// needs:
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
// The route (tc_route): M > 16 (decode rows stay on the FMA kernels),
// K % 64 == 0, N % 8 == 0 (TMA's 16-byte strides) and a 16-byte aligned B;
// the callers add bf16 operands.
// The tensor maps are encoded on the host at each launch by
// cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint, so the
// library needs no -lcuda.
#pragma once
#include <cuda.h>
#include <stdint.h>

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
constexpr int TC_STAGE_BYTES = TC_A_BYTES + 2 * TC_B_BOX_BYTES;   // 32 KB
// the ring, aligned to 1024 bytes (the 128-byte swizzle's period), and the
// full / empty barriers
constexpr size_t TC_SMEM =
    1024 + TC_STAGES * TC_STAGE_BYTES + 2 * TC_STAGES * sizeof(uint64_t);

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

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

// keep the compiler from moving reads of the sums across wgmma_wait_all
__device__ __forceinline__ void fence_sums(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// blockIdx = (N tile, M tile).  Shared memory per stage: A [128 rows][64]
// (row r at r * 128 bytes, 16-byte chunks swizzled by r % 8), then B as two
// [64 k][64 n] boxes 8 KB apart (k row at k * 128 bytes, the same swizzle).
__global__ void __launch_bounds__(TC_THREADS, 2)
tc_gemm_kernel(const __grid_constant__ CUtensorMap tmap_a,
               const __grid_constant__ CUtensorMap tmap_b,
               __nv_bfloat16* __restrict__ C, int M, int N, int K) {
  extern __shared__ uint8_t tc_smem_raw[];
  uint8_t* smem =
      tc_smem_raw + ((1024 - (smem_u32(tc_smem_raw) & 1023)) & 1023);
  uint64_t* full = (uint64_t*)(smem + TC_STAGES * TC_STAGE_BYTES);
  uint64_t* empty = full + TC_STAGES;
  const int tid = threadIdx.x, wg = tid / 128;
  const int m0 = blockIdx.y * TC_BM, n0 = blockIdx.x * TC_BN;
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
    uint8_t* a = smem + stage * TC_STAGE_BYTES;
    uint8_t* b = a + TC_A_BYTES;
    const int k0 = step * TC_BK;
    mbar_expect_tx(&full[stage], TC_STAGE_BYTES);
    tma_load_2d(a, &tmap_a, &full[stage], k0, m0);
    tma_load_2d(b, &tmap_b, &full[stage], n0, k0);
    tma_load_2d(b + TC_B_BOX_BYTES, &tmap_b, &full[stage], n0 + TC_BOX_N, k0);
  };
  if (tid == 0)
    for (int s = 0; s < TC_STAGES && s < steps; ++s) load(s, s);

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  for (int step = 0; step < steps; ++step) {
    const int s = step % TC_STAGES;
    const uint32_t parity = (step / TC_STAGES) & 1;
    mbar_wait(&full[s], parity);
    const uint8_t* a = smem + s * TC_STAGE_BYTES + wg * 64 * 128;
    const uint8_t* b = smem + s * TC_STAGE_BYTES + TC_A_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TC_BK / 16; ++kk)
      // A, K-major: 16 k = 32 bytes along the swizzled row, 8-row groups
      // 1024 bytes apart.  B, MN-major: 16 k = 16 rows of 128 bytes; the
      // two 64-column boxes 8 KB apart (leading), 8-k groups 1024 apart.
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

  // the m64n128 accumulator: sums 4j..4j+3 of a thread are rows r, r + 8,
  // columns 8j + 2 (lane % 4) and the next
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int r0 = m0 + wg * 64 + warp * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int n = n0 + j * 8 + (lane % 4) * 2;
    if (n >= N) continue;
    if (r0 < M)
      *(__nv_bfloat162*)(C + (size_t)r0 * N + n) =
          __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
    if (r0 + 8 < M)
      *(__nv_bfloat162*)(C + (size_t)(r0 + 8) * N + n) =
          __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// Whether C[M, N] = A[M, K] @ B[K, N] takes tc_gemm_kernel (the callers add
// that A and B are bf16 and B is read [K, N]).
inline bool tc_route(int M, int K, int N, const void* B) {
  return M > TC_DECODE_ROWS && K % TC_BK == 0 && N % 8 == 0 &&
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

// the map of a row-major bf16 [rows, cols] matrix read in boxes of
// box_rows x box_cols (128 bytes wide), 128-byte swizzle, zeros past the edge
inline bool tensor_map_2d(CUtensorMap* map, const void* ptr, int rows,
                          int cols, int box_rows, int box_cols) {
  const TensorMapEncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// C [M, N] = A [M, K] @ B [K, N], all bf16 and row major; the shape must
// take the route (tc_route) and A must be 16-byte aligned.
inline cudaError_t launch_tc_gemm(const void* A, const void* B, void* C,
                                  int M, int K, int N, cudaStream_t st) {
  if (!tc_route(M, K, N, B) || ((uintptr_t)A & 15) != 0)
    return cudaErrorInvalidValue;
  CUtensorMap map_a, map_b;
  if (!tensor_map_2d(&map_a, A, M, K, TC_BM, TC_BK) ||
      !tensor_map_2d(&map_b, B, K, N, TC_BK, TC_BOX_N))
    return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      tc_gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)TC_SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + TC_BN - 1) / TC_BN, (M + TC_BM - 1) / TC_BM);
  tc_gemm_kernel<<<grid, TC_THREADS, TC_SMEM, st>>>(
      map_a, map_b, (__nv_bfloat16*)C, M, N, K);
  return cudaGetLastError();
}

}  // namespace uisa

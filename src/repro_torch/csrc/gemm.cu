// C = A @ B in f32 on the f32 FMA units: the paper's GEMM (Table V, row 1).
//
// Replaces kernels/gemm.py::gemm of the JAX package (the Pallas kernel
// _gemm_kernel), in its abstract and native modes.
//
// What bounds it on the H100: operations.  At M = N = K = 4096, 2 * 4096^3
// = 137.4 GFLOP at 67 TFLOP/s (f32, outside the tensor cores) is 2.05 ms;
// its bytes (three 64 MB matrices) take 0.06 ms.  Both modes compute in
// full f32, as cuBLAS SGEMM (the library row) does: a TF32 wgmma variant
// would keep about three decimal digits and is another function.
//
// The TPU's k grid axis with its VMEM accumulator (gemm.py:105-117)
// becomes a K loop inside the block, the accumulator in registers; every
// block owns one output tile, so nothing carries between blocks.  Ragged
// M, N and K are masked in the loads (zeros) and the stores.
//
// - abstract (gemm_abstract_kernel): square 64 x 64 x 64 tiles, the edge
//   sized from the scratchpad budget alone (kernels/gemm.py::
//   abstract_block_shape: S / 4 shared by three f32 tiles, rounded down
//   to the wave width), no matrix-unit query.  256 threads, each a 4 x 4
//   block of outputs strided by 16 rows and columns; plain element loads
//   into shared memory, a barrier, 64 k steps, a barrier.
// - native (gemm_native_kernel): tiles aligned to the queried matrix unit
//   (64, 256, 16) and shaped for reuse: 128 x 128 outputs, 16 deep.  256
//   threads, each an 8 x 8 register block (rows ty + 16 i, columns
//   4 tx..4 tx+3 and 64 + 4 tx..); the A and B tiles are copied into
//   shared memory with cp.async, double-buffered, so the next tile's copy
//   runs under this tile's FMAs.  16-byte copies where the rows allow
//   (K and N multiples of 4, 16-byte aligned bases), 4-byte copies
//   otherwise; out-of-range elements are zero-filled by the copy.
#include "common.cuh"

namespace uisa {

constexpr int kGemmThreads = 256;
constexpr int kAbsEdge = 64;
constexpr int kNatBM = 128, kNatBN = 128, kNatBK = 16;
enum GemmMode { kGemmAbstract = 0, kGemmNative = 2 };

template <typename OutT>
__global__ void __launch_bounds__(kGemmThreads)
gemm_abstract_kernel(const float* __restrict__ A, const float* __restrict__ B,
                     OutT* __restrict__ C, int M, int N, int K) {
  __shared__ float As[kAbsEdge][kAbsEdge + 1];   // [m][k]
  __shared__ float Bs[kAbsEdge][kAbsEdge + 1];   // [k][n]
  const int t = threadIdx.x, tx = t % 16, ty = t / 16;
  const int m0 = blockIdx.y * kAbsEdge, n0 = blockIdx.x * kAbsEdge;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += kAbsEdge) {
#pragma unroll 4
    for (int e = t; e < kAbsEdge * kAbsEdge; e += kGemmThreads) {
      const int r = e / kAbsEdge, c = e % kAbsEdge;
      As[r][c] = (m0 + r < M && k0 + c < K) ? A[(long long)(m0 + r) * K + k0 + c] : 0.f;
      Bs[r][c] = (k0 + r < K && n0 + c < N) ? B[(long long)(k0 + r) * N + n0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kAbsEdge; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[ty + 16 * i][k];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N) C[(long long)m * N + n] = from_f<OutT>(acc[i][j]);
    }
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// copy the k0 slice of A [128 x 16] and B [16 x 128] into one stage;
// out-of-range elements read from the base address with size 0 (zeros)
template <bool VEC>
__device__ __forceinline__ void native_load(const float* A, const float* B,
                                            float (*As)[kNatBK],
                                            float (*Bs)[kNatBN], int M, int N,
                                            int K, int m0, int n0, int k0) {
  const int t = threadIdx.x;
  if (VEC) {
#pragma unroll
    for (int f = t; f < kNatBM * kNatBK / 4; f += kGemmThreads) {
      const int r = f / (kNatBK / 4), kq = (f % (kNatBK / 4)) * 4;
      const bool ok = m0 + r < M && k0 + kq < K;
      cp_async16(&As[r][kq], ok ? A + (long long)(m0 + r) * K + k0 + kq : A, ok);
    }
#pragma unroll
    for (int f = t; f < kNatBK * kNatBN / 4; f += kGemmThreads) {
      const int r = f / (kNatBN / 4), nq = (f % (kNatBN / 4)) * 4;
      const bool ok = k0 + r < K && n0 + nq < N;
      cp_async16(&Bs[r][nq], ok ? B + (long long)(k0 + r) * N + n0 + nq : B, ok);
    }
  } else {
#pragma unroll
    for (int e = t; e < kNatBM * kNatBK; e += kGemmThreads) {
      const int r = e / kNatBK, kk = e % kNatBK;
      const bool ok = m0 + r < M && k0 + kk < K;
      cp_async4(&As[r][kk], ok ? A + (long long)(m0 + r) * K + k0 + kk : A, ok);
    }
#pragma unroll
    for (int e = t; e < kNatBK * kNatBN; e += kGemmThreads) {
      const int r = e / kNatBN, c = e % kNatBN;
      const bool ok = k0 + r < K && n0 + c < N;
      cp_async4(&Bs[r][c], ok ? B + (long long)(k0 + r) * N + n0 + c : B, ok);
    }
  }
}

template <bool VEC, typename OutT>
__global__ void __launch_bounds__(kGemmThreads)
gemm_native_kernel(const float* __restrict__ A, const float* __restrict__ B,
                   OutT* __restrict__ C, int M, int N, int K) {
  __shared__ __align__(16) float As[2][kNatBM][kNatBK];   // [m][k]
  __shared__ __align__(16) float Bs[2][kNatBK][kNatBN];   // [k][n]
  const int t = threadIdx.x, tx = t % 16, ty = t / 16;
  const int m0 = blockIdx.y * kNatBM, n0 = blockIdx.x * kNatBN;
  float acc[8][8] = {};
  const int tiles = (K + kNatBK - 1) / kNatBK;
  native_load<VEC>(A, B, As[0], Bs[0], M, N, K, m0, n0, 0);
  cp_async_commit();
  for (int kt = 0; kt < tiles; ++kt) {
    const int s = kt & 1;
    if (kt + 1 < tiles)
      native_load<VEC>(A, B, As[s ^ 1], Bs[s ^ 1], M, N, K, m0, n0,
                       (kt + 1) * kNatBK);
    cp_async_commit();          // possibly empty: keeps the group count
    cp_async_wait_one();        // tile kt has landed
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kNatBK; ++k) {
      float a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = As[s][ty + 16 * i][k];
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[s][k][4 * tx]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[s][k][64 + 4 * tx]);
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();            // the next copy overwrites this stage
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + 64 * h + 4 * tx;
      OutT* row = C + (long long)m * N;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (n + j < N) row[n + j] = from_f<OutT>(acc[i][4 * h + j]);
    }
  }
}

template <typename OutT>
cudaError_t launch_gemm(int mode, const float* A, const float* B, OutT* C,
                        int M, int N, int K, cudaStream_t st) {
  const dim3 block(kGemmThreads);
  if (mode == kGemmAbstract) {
    const dim3 grid((N + kAbsEdge - 1) / kAbsEdge, (M + kAbsEdge - 1) / kAbsEdge);
    gemm_abstract_kernel<OutT><<<grid, block, 0, st>>>(A, B, C, M, N, K);
  } else {
    const dim3 grid((N + kNatBN - 1) / kNatBN, (M + kNatBM - 1) / kNatBM);
    const bool vec = K % 4 == 0 && N % 4 == 0 && (uintptr_t)A % 16 == 0 &&
                     (uintptr_t)B % 16 == 0;
    if (vec)
      gemm_native_kernel<true, OutT><<<grid, block, 0, st>>>(A, B, C, M, N, K);
    else
      gemm_native_kernel<false, OutT><<<grid, block, 0, st>>>(A, B, C, M, N, K);
  }
  return cudaGetLastError();
}

}  // namespace uisa

// mode: 0 abstract, 2 native; out_dtype: 0 f32, 1 bf16.  A [M,K] and B
// [K,N] f32, row-major and contiguous; C [M,N] in out_dtype.  (bm, bn, bk)
// is the tile the caller planned, which must be the compiled one (64, 64,
// 64) or (128, 128, 16), so the Python plan and the kernel cannot drift.
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

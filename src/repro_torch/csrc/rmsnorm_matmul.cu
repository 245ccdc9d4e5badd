// C entry point of the rmsnorm -> matmul kernel (see norm_gemm.cuh for the
// design note).  Replaces kernels/fused.py::rmsnorm_matmul of the JAX
// package.  x [M,K], w [K], W [K,N] -> out [M,N]; inv [M] and part
// [splits,M,N] are f32 workspaces the wrapper allocates, part sized by
// uisa_rmsnorm_matmul_workspace.  Returns cudaGetLastError() after the
// launches.
#include "norm_gemm.cuh"

// f32 elements the split-K workspace `part` needs on a card with `sms` SMs
extern "C" long long uisa_rmsnorm_matmul_workspace(int M, int K, int N, int sms) {
  return uisa::norm_gemm_workspace<false>(M, K, N, sms);
}

extern "C" int uisa_rmsnorm_matmul(int dtype, const void* x, const void* w,
                                   const void* W, void* out, void* inv,
                                   void* part, int M, int K, int N, float eps,
                                   int sms, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == uisa::kBF16)
    return (int)uisa::launch_norm_gemm<__nv_bfloat16, false>(
        x, w, W, out, (float*)inv, (float*)part, M, K, N, N, eps, sms,
        st);
  return (int)uisa::launch_norm_gemm<float, false>(
      x, w, W, out, (float*)inv, (float*)part, M, K, N, N, eps, sms,
      st);
}

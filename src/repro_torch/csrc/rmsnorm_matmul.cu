// C entry point of the rmsnorm -> matmul kernel (see norm_gemm.cuh for the
// design note).  Replaces kernels/fused.py::rmsnorm_matmul of the JAX
// package.  x [M,K], w [K], W [K,N] (or, with trans, the [N,K] table) ->
// out [M,N]; inv [M] and part [splits,M,N] are f32 workspaces the wrapper
// allocates, part sized by uisa_rmsnorm_matmul_workspace.  W is at the
// activations' dtype, or f32 (wdtype 0) beside either: the JAX kernel
// reads an f32 weight block as f32 (kernels/fused.py:269-291).  Returns
// cudaGetLastError() after the launches.
#include "norm_gemm.cuh"

// f32 elements the split-K workspace `part` needs on a card with `sms` SMs
extern "C" long long uisa_rmsnorm_matmul_workspace(int M, int K, int N, int sms) {
  return uisa::norm_gemm_workspace<false>(M, K, N, sms);
}

template <typename T, typename WT>
static cudaError_t launch(int trans, const void* x, const void* w,
                          const void* W, void* out, float* inv, float* part,
                          int M, int K, int N, float eps, int sms,
                          cudaStream_t st) {
  if (trans)
    return uisa::launch_norm_gemm<T, false, WT, true>(
        x, w, W, out, inv, part, M, K, N, K, eps, sms, st);
  return uisa::launch_norm_gemm<T, false, WT, false>(
      x, w, W, out, inv, part, M, K, N, N, eps, sms, st);
}

extern "C" int uisa_rmsnorm_matmul(int dtype, int wdtype, int trans,
                                   const void* x, const void* w,
                                   const void* W, void* out, void* inv,
                                   void* part, int M, int K, int N, float eps,
                                   int sms, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  float* fi = (float*)inv;
  float* fp = (float*)part;
  if (dtype == uisa::kBF16 && wdtype == uisa::kBF16 && !trans)
    return (int)launch<__nv_bfloat16, __nv_bfloat16>(0, x, w, W, out, fi, fp,
                                                     M, K, N, eps, sms, st);
  if (dtype == uisa::kBF16 && wdtype == uisa::kF32)
    return (int)launch<__nv_bfloat16, float>(trans, x, w, W, out, fi, fp, M,
                                             K, N, eps, sms, st);
  if (dtype == uisa::kF32 && wdtype == uisa::kF32)
    return (int)launch<float, float>(trans, x, w, W, out, fi, fp, M, K, N,
                                     eps, sms, st);
  return (int)cudaErrorInvalidValue;
}

// C entry point of the rmsnorm -> swiglu kernel (see norm_gemm.cuh for the
// design note).  Replaces kernels/fused.py::rmsnorm_swiglu of the JAX
// package.  x [M,K], w [K], w_cat [K,2F] = [wi|wg] -> out [M,F] =
// silu(n @ wg) * (n @ wi).  Each block owns the same column tile of wi and
// wg, so the gate runs in its epilogue (or in the split reduction when K
// is split).  inv [M] and part [splits,M,2F] are f32 workspaces, part
// sized by uisa_rmsnorm_swiglu_workspace.
#include "norm_gemm.cuh"

// f32 elements the split-K workspace `part` needs on a card with `sms` SMs
extern "C" long long uisa_rmsnorm_swiglu_workspace(int M, int K, int F, int sms) {
  return uisa::norm_gemm_workspace<true>(M, K, F, sms);
}

extern "C" int uisa_rmsnorm_swiglu(int dtype, const void* x, const void* w,
                                   const void* w_cat, void* out, void* inv,
                                   void* part, int M, int K, int F, float eps,
                                   int sms, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == uisa::kBF16)
    return (int)uisa::launch_norm_gemm<__nv_bfloat16, true>(
        x, w, w_cat, out, (float*)inv, (float*)part, M, K, F, 2 * F, eps, sms,
        st);
  return (int)uisa::launch_norm_gemm<float, true>(
      x, w, w_cat, out, (float*)inv, (float*)part, M, K, F, 2 * F, eps, sms,
      st);
}

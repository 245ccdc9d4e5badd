// C entry point of the rmsnorm -> swiglu kernel (see norm_gemm.cuh for the
// design note).  Replaces kernels/fused.py::rmsnorm_swiglu of the JAX
// package, and, with an int8 w_cat (wdtype 2) and its [2F] f32 scales
// `wscale` (wi reads [:F], wg [F:]), its int8 twin
// kernels/fused.py::rmsnorm_swiglu_q8.  x [M,K], w [K], w_cat [K,2F] =
// [wi|wg] -> out [M,F] = silu(n @ wg) * (n @ wi).  Each block owns the
// same column tile of wi and wg, so the gate runs in its epilogue (or in
// the split reduction when K is split).  inv [M] and part [splits,M,2F]
// are f32 workspaces, part sized by uisa_rmsnorm_swiglu_workspace.  `mode`
// (kernels/_launch.py::MODE_CODES) selects the abstract or abstract+shuffle
// lowering, for a w_cat at the activations' dtype or int8.
#include "norm_gemm.cuh"

// f32 elements the split-K workspace `part` needs on a card with `sms` SMs
extern "C" long long uisa_rmsnorm_swiglu_workspace(int M, int K, int F, int sms) {
  return uisa::norm_gemm_workspace<true>(M, K, F, sms);
}

// Routed on the mode and the weight's type together: an int8 w_cat never
// reaches a WT = T form.  The int8 forms under abstract / abstract+shuffle
// come last, after every form the earlier kernels were compiled with.
template <typename T>
static cudaError_t launch(int mode, int wdtype, const void* x, const void* w,
                          const void* w_cat, const float* wscale, void* out,
                          float* inv, float* part, int M, int K, int F,
                          float eps, int sms, cudaStream_t st) {
  if (wdtype != uisa::kI8) {
    if (mode == uisa::kAbstract)
      return uisa::launch_norm_gemm<T, true, T, false, uisa::kAbstract>(
          x, w, w_cat, nullptr, out, inv, part, M, K, F, 2 * F, eps, sms, st);
    if (mode == uisa::kAbstractShuffle)
      return uisa::launch_norm_gemm<T, true, T, false, uisa::kAbstractShuffle>(
          x, w, w_cat, nullptr, out, inv, part, M, K, F, 2 * F, eps, sms, st);
  }
  if (mode == uisa::kNative) {
    if (wdtype == uisa::kI8)
      return uisa::launch_norm_gemm<T, true, int8_t>(
          x, w, w_cat, wscale, out, inv, part, M, K, F, 2 * F, eps, sms, st);
    return uisa::launch_norm_gemm<T, true>(x, w, w_cat, nullptr, out, inv,
                                           part, M, K, F, 2 * F, eps, sms, st);
  }
  if (mode == uisa::kAbstract)
    return uisa::launch_norm_gemm<T, true, int8_t, false, uisa::kAbstract>(
        x, w, w_cat, wscale, out, inv, part, M, K, F, 2 * F, eps, sms, st);
  return uisa::launch_norm_gemm<T, true, int8_t, false,
                                uisa::kAbstractShuffle>(
      x, w, w_cat, wscale, out, inv, part, M, K, F, 2 * F, eps, sms, st);
}

extern "C" int uisa_rmsnorm_swiglu(int mode, int dtype, int wdtype,
                                   const void* x, const void* w,
                                   const void* w_cat, const void* wscale,
                                   void* out, void* inv, void* part, int M,
                                   int K, int F, float eps, int sms,
                                   void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const float* ws = (const float*)wscale;
  if (wdtype != dtype && wdtype != uisa::kI8)
    return (int)cudaErrorInvalidValue;
  if ((mode != uisa::kNative && mode != uisa::kAbstract &&
       mode != uisa::kAbstractShuffle) ||
      (wdtype != uisa::kI8 && wscale != nullptr))
    return (int)cudaErrorInvalidValue;
  if (dtype == uisa::kBF16)
    return (int)launch<__nv_bfloat16>(mode, wdtype, x, w, w_cat, ws, out,
                                      (float*)inv, (float*)part, M, K, F,
                                      eps, sms, st);
  return (int)launch<float>(mode, wdtype, x, w, w_cat, ws, out, (float*)inv,
                            (float*)part, M, K, F, eps, sms, st);
}

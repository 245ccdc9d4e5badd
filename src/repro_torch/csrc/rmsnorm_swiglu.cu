// C entry point of the rmsnorm -> swiglu kernel (see norm_gemm.cuh for the
// design note).  Replaces kernels/fused.py::rmsnorm_swiglu of the JAX
// package, and, with an int8 w_cat (wdtype 2) and its [2F] f32 scales
// `wscale` (wi reads [:F], wg [F:]), its int8 twin
// kernels/fused.py::rmsnorm_swiglu_q8.  x [M,K], w [K], w_cat [K,2F] =
// [wi|wg] -> out [M,F] = silu(n @ wg) * (n @ wi).  inv and part are
// workspaces the wrapper allocates, part sized by
// uisa_rmsnorm_swiglu_workspace.  `trans` is always 0 (w_cat is read [K,
// 2F]); the entries take it so that they take rmsnorm_matmul's arguments.
// `mode` (kernels/_launch.py::MODE_CODES) selects the abstract or
// abstract+shuffle lowering (only the moment's cross-lane stage changes),
// for a w_cat at the activations' dtype or int8.  Returns
// cudaGetLastError() after the launches; *route is set to the route taken
// (1 tc, 2 gemv, 0 fma).
//
// Three routes, decided here alone (tc_path, gemv_path):
//  - "tc": bf16 x with a bf16 or int8 w_cat at a prefill shape that
//    tc_gemm.cuh's SwiGLU form takes (M > SMALL_M = 16, K % 64 == 0, F % 8
//    == 0 for bf16 and F % 16 == 0 for int8, w_cat 16-byte aligned), in
//    every mode.  norm_rows_kernel writes the normalized x into part as bf16
//    [M, K] (rounded as the plain version rounds it), then the wgmma GEMM
//    multiplies it by the wi and wg boxes of one output tile in each stage,
//    into two sets of sums, and applies the column scales (int8) and the
//    silu gate in its epilogue.  Bound on Hopper: operations (granite-8b at
//    300 rows: 70.5 GFLOP, 71 us at the bf16 tensor-core peak, against 66
//    us for the bf16 weight's 235 MB and 36 us for int8), so the products
//    run on wgmma, the normalized row is computed once and not by every
//    column tile, and no split K or partials are needed: 224 x 3 output
//    tiles of 128 x 64 fill the SMs.
//  - "gemv": the decode rows (M <= SMALL_M) with a w_cat at the
//    activations' dtype (bf16 or f32) or int8, F columns a multiple of 16
//    bytes, w_cat 16-byte aligned, in every mode: gemv_rows_kernel writes
//    the normalized x into part, then the GEMV (bf16: norm_gemv_mma_kernel;
//    f32: norm_gemv_kernel) streams wi's and wg's columns (threads 0-127
//    and 128-255 of a block, the same column tile), reduces K in a fixed
//    order and applies the scales and the gate once the sums are whole.
//    Bound on Hopper: the weight's bytes (granite-8b's [wi|wg] 234.9 MB,
//    70 us; half in int8);
//  - "fma": every other call (prefill rows of f32, shapes the routes
//    refuse) runs inv_rms_kernel and the f32 FMA norm_gemm_kernel, each
//    block owning the same column tile of wi and wg so the gate runs in its
//    epilogue (or in the split reduction when K is split: part [splits, M,
//    2F]).
// No route falls back on another.
#include "norm_gemm.cuh"
#include "norm_gemv.cuh"
#include "tc_gemm.cuh"

static_assert(uisa::TC_DECODE_ROWS == uisa::SMALL_M,
              "the decode rows of both routes agree");

static bool tc_path(int dtype, int wdtype, int trans, const void* w_cat,
                    int M, int K, int F) {
  if (dtype != uisa::kBF16 || trans) return false;
  if (wdtype == uisa::kBF16)
    return uisa::tc_route<__nv_bfloat16, true>(M, K, F, w_cat);
  return wdtype == uisa::kI8 && uisa::tc_route<int8_t, true>(M, K, F, w_cat);
}

// a w_cat at the activations' dtype or int8, at a decode shape
static bool gemv_path(int dtype, int wdtype, int trans, const void* w_cat,
                      int M, int F) {
  if (trans) return false;
  if (wdtype == uisa::kI8) return uisa::gemv_route<int8_t>(M, F, w_cat);
  if (wdtype != dtype) return false;
  if (dtype == uisa::kBF16)
    return uisa::gemv_route<__nv_bfloat16>(M, F, w_cat);
  return dtype == uisa::kF32 && uisa::gemv_route<float>(M, F, w_cat);
}

// f32 elements of `part` on a card with `sms` SMs: the bf16 [M, K]
// normalized activation on the tc route; on the gemv route the normalized
// activation, then the split-K partials and tickets (norm_gemv.cuh::
// plan_gemv); else the split-K partials (0: no split).  *route is set to
// the route the launch with these arguments takes (1 tc, 2 gemv, 0 fma).
extern "C" long long uisa_rmsnorm_swiglu_workspace(int dtype, int wdtype,
                                                   int trans,
                                                   const void* w_cat, int M,
                                                   int K, int F, int sms,
                                                   int* route) {
  const bool tc = tc_path(dtype, wdtype, trans, w_cat, M, K, F);
  const bool gemv = !tc && gemv_path(dtype, wdtype, trans, w_cat, M, F);
  *route = tc ? 1 : gemv ? 2 : 0;
  if (tc) return ((long long)M * K + 1) / 2;
  if (gemv) return uisa::gemv_workspace<true>(dtype, wdtype, M, K, F, sms);
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

// the tc route: x_n = norm(x) into `xn` (bf16 [M, K]), then out =
// silu(x_n @ wg) * (x_n @ wi), the columns scaled by wscale for int8
template <int MODE>
static cudaError_t launch_tc(int wdtype, const void* x, const void* w,
                             const void* w_cat, const float* wscale,
                             void* out, void* xn, int M, int K, int F,
                             float eps, cudaStream_t st) {
  using bf16 = __nv_bfloat16;
  uisa::norm_rows_kernel<bf16, MODE><<<M, uisa::INV_RMS_THREADS, 0, st>>>(
      (const bf16*)x, (const bf16*)w, K, eps, (bf16*)xn);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (wdtype == uisa::kI8)
    return uisa::launch_tc_gemm<int8_t, true>(xn, w_cat, out, M, K, F, st,
                                              wscale);
  return uisa::launch_tc_gemm<bf16, true>(xn, w_cat, out, M, K, F, st);
}

extern "C" int uisa_rmsnorm_swiglu(int mode, int dtype, int wdtype, int trans,
                                   const void* x, const void* w,
                                   const void* w_cat, const void* wscale,
                                   void* out, void* inv, void* part, int M,
                                   int K, int F, float eps, int sms,
                                   void* stream, int* route) {
  cudaStream_t st = (cudaStream_t)stream;
  const float* ws = (const float*)wscale;
  if ((wdtype != dtype && wdtype != uisa::kI8) || trans)
    return (int)cudaErrorInvalidValue;
  if ((mode != uisa::kNative && mode != uisa::kAbstract &&
       mode != uisa::kAbstractShuffle) ||
      (wscale != nullptr) != (wdtype == uisa::kI8))
    return (int)cudaErrorInvalidValue;
  const bool tc = tc_path(dtype, wdtype, trans, w_cat, M, K, F);
  const bool gemv = !tc && gemv_path(dtype, wdtype, trans, w_cat, M, F);
  *route = tc ? 1 : gemv ? 2 : 0;
  if (gemv)
    return (int)uisa::launch_gemv<true>(mode, dtype, wdtype, x, w, w_cat, ws,
                                        out, part, M, K, F, eps, sms, st);
  if (!tc) {
    if (dtype == uisa::kBF16)
      return (int)launch<__nv_bfloat16>(mode, wdtype, x, w, w_cat, ws, out,
                                        (float*)inv, (float*)part, M, K, F,
                                        eps, sms, st);
    return (int)launch<float>(mode, wdtype, x, w, w_cat, ws, out, (float*)inv,
                              (float*)part, M, K, F, eps, sms, st);
  }
  if (mode == uisa::kAbstract)
    return (int)launch_tc<uisa::kAbstract>(wdtype, x, w, w_cat, ws, out, part,
                                           M, K, F, eps, st);
  if (mode == uisa::kAbstractShuffle)
    return (int)launch_tc<uisa::kAbstractShuffle>(wdtype, x, w, w_cat, ws,
                                                  out, part, M, K, F, eps,
                                                  st);
  return (int)launch_tc<uisa::kNative>(wdtype, x, w, w_cat, ws, out, part, M,
                                       K, F, eps, st);
}

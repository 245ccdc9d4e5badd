// C entry point of the rmsnorm -> matmul kernel (see norm_gemm.cuh for the
// design note).  Replaces kernels/fused.py::rmsnorm_matmul of the JAX
// package, and, with an int8 weight (wdtype 2) and its [N] f32 scales
// `wscale`, its int8 twin kernels/fused.py::rmsnorm_matmul_q8.  x [M,K],
// w [K], W [K,N] (or, with trans, the [N,K] table) -> out [M,N]; inv [M]
// and part are workspaces the wrapper allocates, part sized by
// uisa_rmsnorm_matmul_workspace.  W is at the activations' dtype,
// f32 (wdtype 0) beside either: the JAX kernel reads an f32 weight block
// as f32 (kernels/fused.py:269-291), or int8 read [K, N], or (wdtype 3,
// kQ8F) a float weight that the int8 twin quantizes per call (its
// w_scale=None call: kernels/fused.py:1440), at the activations' dtype read
// [K, N] or the f32 [N, K] table, on the gemv route alone.  Returns
// cudaGetLastError() after the launches; *route is set to the route taken
// (1 tc, 2 gemv, 0 fma).  `mode` (kernels/_launch.py::
// MODE_CODES) selects the abstract or abstract+shuffle lowering of the
// same kernel (only the moment's cross-lane stage changes) for every
// weight: at the activations' dtype, f32 read [K, N] or as the transposed
// table, or int8.
//
// Three routes, decided here alone (tc_path, gemv_path), in every mode:
//  - "tc": bf16 x with W read [K, N], bf16 or int8, at a prefill shape that
//    tc_gemm.cuh takes (M > SMALL_M = 16, K % 64 == 0, N % 8 == 0 for bf16
//    and N % 16 == 0 for int8, W 16-byte aligned) runs norm_rows_kernel,
//    which writes the normalized x into part as bf16 [M, K], then the
//    wgmma GEMM, which widens an int8 W's tiles to bf16 in shared memory
//    and multiplies each column's f32 sum by its scale in the epilogue.
//    Bound on Hopper: operations (granite-8b's qkv at 512 rows: 25.8
//    GFLOP, 26 us at the bf16 peak, against 25.2 MB of int8 weight, 7.5
//    us), so the products run on wgmma and the row is normalized once,
//    not once per column tile;
//  - "gemv": the decode rows (M <= SMALL_M) with W read [K, N] at the
//    activations' dtype (bf16 or f32) or int8, N columns a multiple of 16
//    bytes, W 16-byte aligned, or with the f32 [N, K] table read in place
//    (K x 4 a multiple of 16 bytes, the table 16-byte aligned: the tied
//    head: norm_gemv_t.cuh), run norm_gemv.cuh: gemv_rows_kernel writes
//    the normalized x into part at the activations' dtype [M, K], then
//    the GEMV (bf16: norm_gemv_mma_kernel, W streamed by TMA into
//    mma.sync; f32: norm_gemv_kernel's FMAs; the table:
//    norm_gemv_t_kernel's FMAs, each thread owning a table row's outputs)
//    reduces K in a fixed order,
//    part also holding its split-K partials and tickets.  kQ8F: the GEMV
//    quantizes each weight in registers (norm_gemv.cuh's item 5), after a
//    pass before the normalized rows writes the [N] f32 scales into part;
//    a bf16 W wide enough for a strip of 64 columns an SM (granite-8b's
//    head) takes norm_gemv_q.cuh's strip kernel instead, and the table
//    beside at most 8 rows norm_gemv_t.cuh's (norm_gemv_tq_kernel): each
//    block walks whole channels, scales and products, two launches, W
//    read from DRAM about once.  Bound on
//    Hopper: the weight's bytes (granite-8b's qkv 50.3 MB, 15 us; its head
//    402.7 MB, 120 us; half in int8), so W is read once and x_n is
//    computed once a call;
//  - "fma": every other call (prefill rows of f32, an f32 weight beside
//    bf16 activations, the f32 transposed table past the decode rows,
//    shapes the routes refuse) runs inv_rms_kernel and the f32 FMA
//    norm_gemm_kernel, part holding its split-K partials.
// No route falls back on another; a kQ8F weight that the gemv route refuses
// is refused (the wrapper quantizes it first, then takes these routes).
// uisa_q8_scales is pass 1 alone: the scales quantize_weight gives.
#include "norm_gemm.cuh"
#include "norm_gemv.cuh"
#include "norm_gemv_q.cuh"
#include "norm_gemv_t.cuh"
#include "tc_gemm.cuh"

static_assert(uisa::TC_DECODE_ROWS == uisa::SMALL_M,
              "the decode rows of both routes agree");

static bool tc_path(int dtype, int wdtype, int trans, const void* W, int M,
                    int K, int N) {
  if (dtype != uisa::kBF16 || trans || wdtype == uisa::kQ8F) return false;
  if (wdtype == uisa::kBF16) return uisa::tc_route(M, K, N, W);
  return wdtype == uisa::kI8 && uisa::tc_route<int8_t>(M, K, N, W);
}

// W read [K, N] at the activations' dtype or int8, or the f32 [N, K]
// table (trans), at a decode shape; kQ8F: W at the activations' dtype, or
// the table, quantized in the stream
static bool gemv_path(int dtype, int wdtype, int trans, const void* W, int M,
                      int K, int N) {
  if (wdtype == uisa::kQ8F)
    return gemv_path(dtype, trans ? uisa::kF32 : dtype, trans, W, M, K, N);
  if (trans)
    return wdtype == uisa::kF32 &&
           (dtype == uisa::kBF16 || dtype == uisa::kF32) &&
           uisa::gemv_t_route(M, K, W);
  if (wdtype == uisa::kI8) return uisa::gemv_route<int8_t>(M, N, W);
  if (wdtype != dtype) return false;
  if (dtype == uisa::kBF16) return uisa::gemv_route<__nv_bfloat16>(M, N, W);
  return dtype == uisa::kF32 && uisa::gemv_route<float>(M, N, W);
}

// f32 elements of `part` on a card with `sms` SMs: the bf16 [M, K]
// normalized activation on the tc route; on the gemv route the normalized
// activation, then the split-K partials and tickets (norm_gemv.cuh::
// plan_gemv); else the split-K partials (0: no split).  *route is set to
// the route the launch with these arguments takes (1 tc, 2 gemv, 0 fma).
extern "C" long long uisa_rmsnorm_matmul_workspace(int dtype, int wdtype,
                                                   int trans, const void* W,
                                                   int M, int K, int N,
                                                   int sms, int* route) {
  const bool tc = tc_path(dtype, wdtype, trans, W, M, K, N);
  const bool gemv = !tc && gemv_path(dtype, wdtype, trans, W, M, K, N);
  *route = tc ? 1 : gemv ? 2 : 0;
  if (tc) return ((long long)M * K + 1) / 2;
  if (gemv && trans)
    return uisa::gemv_t_workspace(dtype, M, K, N, sms, wdtype == uisa::kQ8F);
  if (gemv)
    return wdtype == uisa::kQ8F
               ? uisa::gemv_q_workspace(dtype, M, K, N, sms)
               : uisa::gemv_workspace<false>(dtype, wdtype, M, K, N, sms);
  return uisa::norm_gemm_workspace<false>(M, K, N, sms);
}

// Pass 1 alone: the [N] f32 scales of a float W quantized per call (the
// JAX package's quantize_weight), W bf16 or f32 (wdtype) read [K, N] with N
// x its size a multiple of 16 bytes, or the f32 [N, K] table (trans) with K
// x 4 a multiple of 16 bytes; W 16-byte aligned.
extern "C" int uisa_q8_scales(int wdtype, int trans, const void* W, int K,
                              int N, void* scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  float* s = (float*)scale;
  if (trans)
    return wdtype == uisa::kF32
               ? (int)uisa::launch_q8_scales_t((const float*)W, K, N, s, st)
               : (int)cudaErrorInvalidValue;
  if (wdtype == uisa::kBF16)
    return (int)uisa::launch_q8_scales<__nv_bfloat16>(W, K, N, s, st);
  if (wdtype == uisa::kF32)
    return (int)uisa::launch_q8_scales<float>(W, K, N, s, st);
  return (int)cudaErrorInvalidValue;
}

// the tc route: x_n = norm(x) into `xn` (bf16 [M, K]), then out = x_n @ W,
// or x_n @ (W * wscale) for an int8 W
template <int MODE>
static cudaError_t launch_tc(const void* x, const void* w, const void* W,
                             const float* wscale, void* out, void* xn, int M,
                             int K, int N, float eps, cudaStream_t st) {
  using bf16 = __nv_bfloat16;
  uisa::norm_rows_kernel<bf16, MODE><<<M, uisa::INV_RMS_THREADS, 0, st>>>(
      (const bf16*)x, (const bf16*)w, K, eps, (bf16*)xn);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (wscale != nullptr)
    return uisa::launch_tc_gemm<int8_t>(xn, W, out, M, K, N, st, wscale);
  return uisa::launch_tc_gemm(xn, W, out, M, K, N, st);
}

template <typename T, typename WT, int MODE = uisa::kNative>
static cudaError_t launch(int trans, const void* x, const void* w,
                          const void* W, const float* wscale, void* out,
                          float* inv, float* part, int M, int K, int N,
                          float eps, int sms, cudaStream_t st) {
  if constexpr (!std::is_same<WT, int8_t>::value) {
    if (trans)
      return uisa::launch_norm_gemm<T, false, WT, true, MODE>(
          x, w, W, nullptr, out, inv, part, M, K, N, K, eps, sms, st);
  }
  return uisa::launch_norm_gemm<T, false, WT, false, MODE>(
      x, w, W, wscale, out, inv, part, M, K, N, N, eps, sms, st);
}

// The abstract and abstract+shuffle modes: the weight at the activations'
// dtype [K, N], f32 beside either, [K, N] or the [N, K] table (the tied
// head), or int8 [K, N] with its scales.
template <typename T, typename WT>
static cudaError_t launch_mode(int mode, int trans, const void* x,
                               const void* w, const void* W,
                               const float* wscale, void* out, float* inv,
                               float* part, int M, int K, int N, float eps,
                               int sms, cudaStream_t st) {
  if (mode == uisa::kAbstract)
    return launch<T, WT, uisa::kAbstract>(trans, x, w, W, wscale, out, inv,
                                          part, M, K, N, eps, sms, st);
  return launch<T, WT, uisa::kAbstractShuffle>(trans, x, w, W, wscale, out,
                                               inv, part, M, K, N, eps, sms,
                                               st);
}

extern "C" int uisa_rmsnorm_matmul(int mode, int dtype, int wdtype, int trans,
                                   const void* x, const void* w,
                                   const void* W, const void* wscale,
                                   void* out, void* inv, void* part, int M,
                                   int K, int N, float eps, int sms,
                                   void* stream, int* route) {
  cudaStream_t st = (cudaStream_t)stream;
  float* fi = (float*)inv;
  float* fp = (float*)part;
  const float* ws = (const float*)wscale;
  if ((mode != uisa::kNative && mode != uisa::kAbstract &&
       mode != uisa::kAbstractShuffle) ||
      (wscale != nullptr) != (wdtype == uisa::kI8))
    return (int)cudaErrorInvalidValue;
  const bool tc = tc_path(dtype, wdtype, trans, W, M, K, N);
  const bool gemv = !tc && gemv_path(dtype, wdtype, trans, W, M, K, N);
  *route = tc ? 1 : gemv ? 2 : 0;
  if (wdtype == uisa::kQ8F) {
    if (!gemv) return (int)cudaErrorInvalidValue;
    return trans ? (int)uisa::launch_gemv_t<true>(mode, dtype, x, w,
                                                  (const float*)W, out, part,
                                                  M, K, N, eps, sms, st)
                 : (int)uisa::launch_gemv_q(mode, dtype, x, w, W, out, part,
                                            M, K, N, eps, sms, st);
  }
  if (gemv && trans)
    return (int)uisa::launch_gemv_t(mode, dtype, x, w, (const float*)W, out,
                                    part, M, K, N, eps, sms, st);
  if (gemv)
    return (int)uisa::launch_gemv<false>(mode, dtype, wdtype, x, w, W, ws,
                                         out, part, M, K, N, eps, sms, st);
  if (tc) {
    if (mode == uisa::kAbstract)
      return (int)launch_tc<uisa::kAbstract>(x, w, W, ws, out, part, M, K, N,
                                             eps, st);
    if (mode == uisa::kAbstractShuffle)
      return (int)launch_tc<uisa::kAbstractShuffle>(x, w, W, ws, out, part, M,
                                                    K, N, eps, st);
    return (int)launch_tc<uisa::kNative>(x, w, W, ws, out, part, M, K, N,
                                         eps, st);
  }
  if (wdtype == uisa::kI8) {
    if (trans) return (int)cudaErrorInvalidValue;
  } else if (mode != uisa::kNative) {
    if (dtype == uisa::kBF16 && wdtype == uisa::kBF16 && !trans)
      return (int)launch_mode<__nv_bfloat16, __nv_bfloat16>(
          mode, 0, x, w, W, nullptr, out, fi, fp, M, K, N, eps, sms, st);
    if (dtype == uisa::kBF16 && wdtype == uisa::kF32)
      return (int)launch_mode<__nv_bfloat16, float>(
          mode, trans, x, w, W, nullptr, out, fi, fp, M, K, N, eps, sms, st);
    if (dtype == uisa::kF32 && wdtype == uisa::kF32)
      return (int)launch_mode<float, float>(mode, trans, x, w, W, nullptr,
                                            out, fi, fp, M, K, N, eps, sms,
                                            st);
    return (int)cudaErrorInvalidValue;
  }
  if (mode == uisa::kNative) {
    if (wdtype == uisa::kI8) {
      if (dtype == uisa::kBF16)
        return (int)launch<__nv_bfloat16, int8_t>(0, x, w, W, ws, out, fi,
                                                  fp, M, K, N, eps, sms, st);
      return (int)launch<float, int8_t>(0, x, w, W, ws, out, fi, fp, M, K, N,
                                        eps, sms, st);
    }
    if (dtype == uisa::kBF16 && wdtype == uisa::kBF16 && !trans)
      return (int)launch<__nv_bfloat16, __nv_bfloat16>(0, x, w, W, nullptr,
                                                       out, fi, fp, M, K, N,
                                                       eps, sms, st);
    if (dtype == uisa::kBF16 && wdtype == uisa::kF32)
      return (int)launch<__nv_bfloat16, float>(trans, x, w, W, nullptr, out,
                                               fi, fp, M, K, N, eps, sms, st);
    if (dtype == uisa::kF32 && wdtype == uisa::kF32)
      return (int)launch<float, float>(trans, x, w, W, nullptr, out, fi, fp,
                                       M, K, N, eps, sms, st);
    return (int)cudaErrorInvalidValue;
  }
  // the int8 weight under abstract / abstract+shuffle: the native int8
  // tiles behind the mode's moment (instantiated last, after every form
  // above, so the earlier kernels compile as they did)
  if (dtype == uisa::kBF16)
    return (int)launch_mode<__nv_bfloat16, int8_t>(mode, 0, x, w, W, ws, out,
                                                   fi, fp, M, K, N, eps, sms,
                                                   st);
  return (int)launch_mode<float, int8_t>(mode, 0, x, w, W, ws, out, fi, fp, M,
                                         K, N, eps, sms, st);
}

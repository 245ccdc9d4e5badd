// C entry point of the attention -> wo kernel, dense form (see
// attention_core.cuh for the design note).  Replaces
// kernels/fused.py::flash_attention_matmul of the JAX package, both its
// causal prefill shape (pos == nullptr, mask c <= i + kv_offset) and its
// decode shape (per-slot frontier pos [B]), and, with an int8 wo and its
// [N] f32 scales `wscale`, the same shapes of its int8 twin
// kernels/fused.py::flash_attention_matmul_q8.
// q [B,H,Sq,D], k/v [B,Hkv,Skv,D], wo [H*D,N] -> out [B,Sq,N]; part is the
// workspace, sized by uisa_flash_attention_matmul_workspace.  `mode`
// (kernels/_launch.py::MODE_CODES) selects the abstract or abstract+shuffle
// lowering, with wo at the working dtype or int8.  *route is set to the
// route taken (1 tc, 0 fma).  Returns cudaGetLastError().
//
// Two routes, decided here alone (tc_path): the causal shape in bf16 with a
// bf16 or int8 wo, D of 64 or 128, q, k and v 16-byte aligned (the core
// loads them with 16-byte cp.async), whose O @ wo product tc_gemm.cuh takes
// (B * Sq > 16 rows, H * D % 64 == 0, N % 8 == 0 for bf16 and N % 16 == 0
// for int8, wo 16-byte aligned), runs attention_tc.cuh's core, which stores
// O bf16 [B, Sq, H*D] in part, then the wgmma GEMM, which widens an int8
// wo's tiles to bf16 in shared memory and scales its columns in the
// epilogue (the "tc" route, every mode).  Bound on Hopper: operations (at
// 512 tokens and 32/8 heads of 128, 19.3 GFLOP against 27.3 MB with an
// int8 wo: 19.5 us against 8.1 us), so the wo product, 89% of them, runs
// on wgmma whatever wo's type.  Every other call (the `pos` shape, f32, other
// head widths) runs attn_group_kernel, part holding its f32 partials [Hkv,
// B, Sq, N], and group_sum_kernel (the "fma" route).  Neither route falls
// back on the other.
#include "attention_core.cuh"
#include "attention_tc.cuh"
#include "tc_gemm.cuh"

static bool tc_path(int dtype, bool wq8, bool pos, const void* q,
                    const void* k, const void* v, const void* wo, int B,
                    int H, int Sq, int D, int N) {
  if (dtype != uisa::kBF16 || pos || (D != 64 && D != 128) ||
      (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) & 15) != 0)
    return false;
  return wq8 ? uisa::tc_route<int8_t>(B * Sq, H * D, N, wo)
             : uisa::tc_route(B * Sq, H * D, N, wo);
}

// f32 elements of `part`: O, bf16 [B, Sq, H*D], on the tc route, else the
// f32 partials [Hkv, B, Sq, N].  *route is set to the route the launch with
// these arguments takes (1 tc, 0 fma).
extern "C" long long uisa_flash_attention_matmul_workspace(
    int dtype, int wq8, int pos, const void* q, const void* k, const void* v,
    const void* wo, int B, int H, int Hkv, int Sq, int D, int N, int* route) {
  const bool tc = tc_path(dtype, wq8, pos, q, k, v, wo, B, H, Sq, D, N);
  *route = tc ? 1 : 0;
  if (tc) return ((long long)B * Sq * H * D + 1) / 2;
  return (long long)Hkv * B * Sq * N;
}

// the tc route: O into `part` (attn_tc_kernel of MODE), then out = O @ wo,
// or O @ (wo * wscale) for an int8 wo (qs.w)
template <int MODE>
static cudaError_t launch_tc(uisa::AttnArgs a, void* out, cudaStream_t st,
                             const uisa::QuantScales& qs) {
  if ((a.H / a.Hkv) * a.bq > uisa::ATT_ROWS) return cudaErrorInvalidValue;
  a.o = a.part;
  const cudaError_t err = a.D == 128 ? uisa::launch_attn_tc<128, MODE>(a, st)
                                     : uisa::launch_attn_tc<64, MODE>(a, st);
  if (err != cudaSuccess) return err;
  if (qs.w != nullptr)
    return uisa::launch_tc_gemm<int8_t>(a.part, a.wo, out, a.B * a.Sq,
                                        a.H * a.D, a.N, st, qs.w);
  return uisa::launch_tc_gemm(a.part, a.wo, out, a.B * a.Sq, a.H * a.D, a.N,
                              st);
}

template <typename T>
static cudaError_t launch(int mode, const uisa::AttnArgs& a, void* out,
                          cudaStream_t st, const uisa::QuantScales& qs) {
  if (mode == uisa::kAbstract)
    return uisa::launch_attention_matmul<T, false, T, T, uisa::kAbstract>(
        a, out, st);
  if (mode == uisa::kAbstractShuffle)
    return uisa::launch_attention_matmul<T, false, T, T,
                                         uisa::kAbstractShuffle>(a, out, st);
  if (qs.w != nullptr)
    return uisa::launch_attention_matmul<T, false, T, int8_t>(a, out, st, qs);
  return uisa::launch_attention_matmul<T, false>(a, out, st);
}

// The int8 wo under abstract / abstract+shuffle, instantiated after every
// form above so that those kernels compile as they did.
template <typename T>
static cudaError_t launch_q8_mode(int mode, const uisa::AttnArgs& a,
                                  void* out, cudaStream_t st,
                                  const uisa::QuantScales& qs) {
  if (mode == uisa::kAbstract)
    return uisa::launch_attention_matmul<T, false, T, int8_t,
                                         uisa::kAbstract>(a, out, st, qs);
  return uisa::launch_attention_matmul<T, false, T, int8_t,
                                       uisa::kAbstractShuffle>(a, out, st, qs);
}

extern "C" int uisa_flash_attention_matmul(
    int mode, int dtype, const void* q, const void* k, const void* v,
    const void* wo, const void* wscale, const void* pos, void* out,
    void* part, int B, int H, int Hkv, int Sq, int Skv, int D, int N,
    int kv_offset, int bq, int nsplit, float scale, void* stream,
    int* route) {
  if (mode != uisa::kNative && mode != uisa::kAbstract &&
      mode != uisa::kAbstractShuffle)
    return (int)cudaErrorInvalidValue;
  uisa::AttnArgs a{q, k, v, wo, nullptr, (const int*)pos, (float*)part,
                   B, H, Hkv, Sq, Skv, D, N, kv_offset, bq, nsplit,
                   0, 1, 0, scale};
  const uisa::QuantScales qs{(const float*)wscale};
  cudaStream_t st = (cudaStream_t)stream;
  const bool tc = tc_path(dtype, qs.w != nullptr, pos != nullptr, q, k, v,
                          wo, B, H, Sq, D, N);
  *route = tc ? 1 : 0;
  if (tc) {
    if (mode == uisa::kAbstract)
      return (int)launch_tc<uisa::kAbstract>(a, out, st, qs);
    if (mode == uisa::kAbstractShuffle)
      return (int)launch_tc<uisa::kAbstractShuffle>(a, out, st, qs);
    return (int)launch_tc<uisa::kNative>(a, out, st, qs);
  }
  if (mode == uisa::kNative || qs.w == nullptr) {
    if (dtype == uisa::kBF16)
      return (int)launch<__nv_bfloat16>(mode, a, out, st, qs);
    return (int)launch<float>(mode, a, out, st, qs);
  }
  if (dtype == uisa::kBF16)
    return (int)launch_q8_mode<__nv_bfloat16>(mode, a, out, st, qs);
  return (int)launch_q8_mode<float>(mode, a, out, st, qs);
}

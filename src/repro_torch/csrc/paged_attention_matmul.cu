// C entry point of the attention -> wo kernel, paged decode form (see
// attention_core.cuh for the design note).  Replaces
// kernels/fused.py::_paged_attention_matmul of the JAX package, and its
// int8 form under kernels/fused.py::flash_attention_matmul_q8: an int8 wo
// with [N] f32 scales `wscale`, beside k/v pools at the working dtype or
// int8 pools with f32 per-token scale pools `kscale`/`vscale` [P,Hkv,ps,1].
// q [B,H,Sq,D], page pools k/v [P,Hkv,ps,D], tables [B,maxp] int32 (entries
// clamped to P-1 in the kernel), pos [B] int32, wo [H*D,N] -> out
// [B,Sq,N]; part [Hkv,B,Sq,N] is the f32 workspace.  `mode`
// (kernels/_launch.py::MODE_CODES) selects the abstract or abstract+shuffle
// lowering, over pools and wo at the working dtype, or the int8 forms.
#include "attention_core.cuh"

template <typename T>
static cudaError_t launch(int mode, const uisa::AttnArgs& a, void* out,
                          cudaStream_t st, const uisa::QuantScales& qs) {
  if (mode == uisa::kAbstract)
    return uisa::launch_attention_matmul<T, true, T, T, uisa::kAbstract>(
        a, out, st);
  if (mode == uisa::kAbstractShuffle)
    return uisa::launch_attention_matmul<T, true, T, T,
                                         uisa::kAbstractShuffle>(a, out, st);
  if (qs.k != nullptr) {
    if (qs.w == nullptr) return cudaErrorInvalidValue;
    return uisa::launch_attention_matmul<T, true, int8_t, int8_t>(a, out, st,
                                                                  qs);
  }
  if (qs.w != nullptr)
    return uisa::launch_attention_matmul<T, true, T, int8_t>(a, out, st, qs);
  return uisa::launch_attention_matmul<T, true>(a, out, st);
}

// The int8 forms under abstract / abstract+shuffle (int8 wo, beside int8
// pools or pools at the working dtype), instantiated after every form
// above so that those kernels compile as they did.
template <typename T, int MODE>
static cudaError_t launch_q8(const uisa::AttnArgs& a, void* out,
                             cudaStream_t st, const uisa::QuantScales& qs) {
  if (qs.w == nullptr) return cudaErrorInvalidValue;
  if (qs.k != nullptr)
    return uisa::launch_attention_matmul<T, true, int8_t, int8_t, MODE>(
        a, out, st, qs);
  return uisa::launch_attention_matmul<T, true, T, int8_t, MODE>(a, out, st,
                                                                 qs);
}

template <typename T>
static cudaError_t launch_q8_mode(int mode, const uisa::AttnArgs& a,
                                  void* out, cudaStream_t st,
                                  const uisa::QuantScales& qs) {
  if (mode == uisa::kAbstract)
    return launch_q8<T, uisa::kAbstract>(a, out, st, qs);
  return launch_q8<T, uisa::kAbstractShuffle>(a, out, st, qs);
}

extern "C" int uisa_paged_attention_matmul(
    int mode, int dtype, const void* q, const void* k_pages,
    const void* v_pages, const void* kscale, const void* vscale,
    const void* wo, const void* wscale, const void* tables, const void* pos,
    void* out, void* part, int B, int H, int Hkv, int Sq, int P, int ps,
    int maxp, int D, int N, int bq, int nsplit, float scale, void* stream) {
  if (mode != uisa::kNative && mode != uisa::kAbstract &&
      mode != uisa::kAbstractShuffle)
    return (int)cudaErrorInvalidValue;
  uisa::AttnArgs a{q, k_pages, v_pages, wo, (const int*)tables,
                   (const int*)pos, (float*)part, B, H, Hkv, Sq, maxp * ps,
                   D, N, 0, bq, nsplit, maxp, ps, P, scale};
  const uisa::QuantScales qs{(const float*)wscale, (const float*)kscale,
                             (const float*)vscale};
  cudaStream_t st = (cudaStream_t)stream;
  if (mode == uisa::kNative ||
      (qs.w == nullptr && qs.k == nullptr && qs.v == nullptr)) {
    if (dtype == uisa::kBF16)
      return (int)launch<__nv_bfloat16>(mode, a, out, st, qs);
    return (int)launch<float>(mode, a, out, st, qs);
  }
  if (dtype == uisa::kBF16)
    return (int)launch_q8_mode<__nv_bfloat16>(mode, a, out, st, qs);
  return (int)launch_q8_mode<float>(mode, a, out, st, qs);
}

// C entry point of the attention -> wo kernel, dense form (see
// attention_core.cuh for the design note).  Replaces
// kernels/fused.py::flash_attention_matmul of the JAX package, both its
// causal prefill shape (pos == nullptr, mask c <= i + kv_offset) and its
// decode shape (per-slot frontier pos [B]), and, with an int8 wo and its
// [N] f32 scales `wscale`, the same shapes of its int8 twin
// kernels/fused.py::flash_attention_matmul_q8.
// q [B,H,Sq,D], k/v [B,Hkv,Skv,D], wo [H*D,N] -> out [B,Sq,N]; part
// [Hkv,B,Sq,N] is the f32 workspace.  `mode` (kernels/_launch.py::
// MODE_CODES) selects the abstract or abstract+shuffle lowering, with wo at
// the working dtype or int8.  Returns cudaGetLastError().
#include "attention_core.cuh"

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
    int kv_offset, int bq, int nsplit, float scale, void* stream) {
  if (mode != uisa::kNative && mode != uisa::kAbstract &&
      mode != uisa::kAbstractShuffle)
    return (int)cudaErrorInvalidValue;
  uisa::AttnArgs a{q, k, v, wo, nullptr, (const int*)pos, (float*)part,
                   B, H, Hkv, Sq, Skv, D, N, kv_offset, bq, nsplit,
                   0, 1, 0, scale};
  const uisa::QuantScales qs{(const float*)wscale};
  cudaStream_t st = (cudaStream_t)stream;
  if (mode == uisa::kNative || qs.w == nullptr) {
    if (dtype == uisa::kBF16)
      return (int)launch<__nv_bfloat16>(mode, a, out, st, qs);
    return (int)launch<float>(mode, a, out, st, qs);
  }
  if (dtype == uisa::kBF16)
    return (int)launch_q8_mode<__nv_bfloat16>(mode, a, out, st, qs);
  return (int)launch_q8_mode<float>(mode, a, out, st, qs);
}

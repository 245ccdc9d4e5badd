// C entry point of the attention -> wo kernel, dense form (see
// attention_core.cuh for the design note).  Replaces
// kernels/fused.py::flash_attention_matmul of the JAX package, both its
// causal prefill shape (pos == nullptr, mask c <= i + kv_offset) and its
// decode shape (per-slot frontier pos [B]).
// q [B,H,Sq,D], k/v [B,Hkv,Skv,D], wo [H*D,N] -> out [B,Sq,N]; part
// [Hkv,B,Sq,N] is the f32 workspace.  Returns cudaGetLastError().
#include "attention_core.cuh"

extern "C" int uisa_flash_attention_matmul(
    int dtype, const void* q, const void* k, const void* v, const void* wo,
    const void* pos, void* out, void* part, int B, int H, int Hkv, int Sq,
    int Skv, int D, int N, int kv_offset, int bq, int nsplit, float scale,
    void* stream) {
  uisa::AttnArgs a{q, k, v, wo, nullptr, (const int*)pos, (float*)part,
                   B, H, Hkv, Sq, Skv, D, N, kv_offset, bq, nsplit,
                   0, 1, 0, scale};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == uisa::kBF16)
    return (int)uisa::launch_attention_matmul<__nv_bfloat16, false>(a, out, st);
  return (int)uisa::launch_attention_matmul<float, false>(a, out, st);
}

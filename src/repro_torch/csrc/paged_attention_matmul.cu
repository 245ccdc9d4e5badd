// C entry point of the attention -> wo kernel, paged decode form (see
// attention_core.cuh for the design note).  Replaces
// kernels/fused.py::_paged_attention_matmul of the JAX package.
// q [B,H,Sq,D], page pools k/v [P,Hkv,ps,D], tables [B,maxp] int32 (entries
// clamped to P-1 in the kernel), pos [B] int32, wo [H*D,N] -> out
// [B,Sq,N]; part [Hkv,B,Sq,N] is the f32 workspace.
#include "attention_core.cuh"

extern "C" int uisa_paged_attention_matmul(
    int dtype, const void* q, const void* k_pages, const void* v_pages,
    const void* wo, const void* tables, const void* pos, void* out,
    void* part, int B, int H, int Hkv, int Sq, int P, int ps, int maxp,
    int D, int N, int bq, int nsplit, float scale, void* stream) {
  uisa::AttnArgs a{q, k_pages, v_pages, wo, (const int*)tables,
                   (const int*)pos, (float*)part, B, H, Hkv, Sq, maxp * ps,
                   D, N, 0, bq, nsplit, maxp, ps, P, scale};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == uisa::kBF16)
    return (int)uisa::launch_attention_matmul<__nv_bfloat16, true>(a, out, st);
  return (int)uisa::launch_attention_matmul<float, true>(a, out, st);
}

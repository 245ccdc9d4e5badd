// C entry point of the flash attention kernel: the online-softmax loop of
// attention_core.cuh with an epilogue that stores O (see there for the
// design note).  Replaces kernels/attention.py::flash_attention of the JAX
// package (its _flash_kernel).
//
// Bound on Hopper: for a 512-token causal prefill at 24 heads over 8 kv
// heads of 64, the operations (4 x 24 x 131,328 x 64 = 0.81 GFLOP: 0.8 us
// at the bf16 tensor-core peak) and the bytes (q, k, v read once, O
// written once: 4.2 MB, 1.25 us) are both small; this first version runs on
// the f32 FMA units (67 TFLOP/s, 12 us for the same operations) and each
// block re-reads the k/v tiles of its group up to the diagonal.  One block
// per (query tile, kv group, batch) folds the group's G query heads into
// its 64 rows (G = 3: 21 queries x 3 heads), so a k/v tile is read once per
// group, not once per head: GQA needs no repeat.  Causal: tiles wholly
// past the diagonal of the block's last query are skipped.  Non-causal
// calls pass kv_offset = Skv; keys past Skv weigh nothing either way.
// q [B,H,Sq,D], k/v [B,Hkv,Skv,D] -> o [B,H,Sq,D].  `mode`
// (kernels/_launch.py::MODE_CODES) selects the abstract or abstract+shuffle
// lowering: the online softmax's row max and row sum through shared memory
// alone or through warp shuffles, and every key tile visited (no causal
// skip), as in the JAX package.  At granite-moe's group of 3 a block's
// 64 rows hold 63 live (head, query) rows; the abstract tree runs over the
// live rows only, and a partial query tile's dead rows (zero queries,
// finite scores) are never stored.  Returns cudaGetLastError().
#include "attention_core.cuh"

template <typename T>
static cudaError_t launch(int mode, const uisa::AttnArgs& a,
                          cudaStream_t st) {
  if (mode == uisa::kAbstract)
    return uisa::launch_flash_attention<T, uisa::kAbstract>(a, st);
  if (mode == uisa::kAbstractShuffle)
    return uisa::launch_flash_attention<T, uisa::kAbstractShuffle>(a, st);
  return uisa::launch_flash_attention<T>(a, st);
}

extern "C" int uisa_flash_attention(int mode, int dtype, const void* q,
                                    const void* k, const void* v, void* o,
                                    int B, int H, int Hkv, int Sq, int Skv,
                                    int D, int kv_offset, int bq, float scale,
                                    void* stream) {
  uisa::AttnArgs a{q, k, v, nullptr, nullptr, nullptr, nullptr,
                   B, H, Hkv, Sq, Skv, D, 0, kv_offset, bq, 1,
                   0, 1, 0, scale, o};
  cudaStream_t st = (cudaStream_t)stream;
  if (mode < uisa::kAbstract || mode > uisa::kNative)
    return (int)cudaErrorInvalidValue;
  if (dtype == uisa::kBF16)
    return (int)launch<__nv_bfloat16>(mode, a, st);
  return (int)launch<float>(mode, a, st);
}

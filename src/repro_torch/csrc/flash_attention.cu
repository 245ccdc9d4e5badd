// C entry point of the flash attention kernel.  Replaces
// kernels/attention.py::flash_attention of the JAX package (its
// _flash_kernel).  q [B,H,Sq,D], k/v [B,Hkv,Skv,D] -> o [B,H,Sq,D].  `mode`
// (kernels/_launch.py::MODE_CODES) selects the abstract or abstract+shuffle
// lowering: the online softmax's row max and row sum through shared memory
// alone or through warp shuffles, and every key tile visited (no causal
// skip), as in the JAX package.  Non-causal calls pass kv_offset = Skv;
// keys past Skv weigh nothing either way.  *route is set to the route
// taken (1 tc, 0 fma).  Returns cudaGetLastError().
//
// Bound on Hopper: for a 512-token causal prefill at 24 heads over 8 kv
// heads of 64, the operations (4 x 24 x 131,328 x 64 = 0.81 GFLOP: 0.8 us
// at the bf16 tensor-core peak) and the bytes (q, k, v read once, O
// written once: 4.2 MB, 1.25 us) are both small, so the kernel is held by
// how its blocks fill the card and by the rate of its inner loop.  One
// block per (query tile, kv group, batch) folds the group's G query heads
// into its 64 rows (G = 3: 21 queries x 3 heads), so a k/v tile is read
// once per group, not once per head: GQA needs no repeat.  Causal: tiles
// wholly past the diagonal of the block's last query are skipped (native).
//
// Two routes, decided here alone (tc_path):
//  - "tc": bf16 q, k, v with D of 64 or 128, q, k, v and o 16-byte aligned
//    (the core loads rows with 16-byte cp.async) and the group's rows
//    within a block ((H / Hkv) x bq <= 64), in every mode:
//    attention_tc.cuh's mma.sync core (P rounded to bf16 before P V, the
//    register softmax) with its [B, H, Sq, D] epilogue.  The modes change
//    the quad reduce and the key walk only, as on flash_attention_matmul's
//    tc route;
//  - "fma": every other call (f32, other head widths, an operand off 16
//    bytes) runs the online-softmax loop of attention_core.cuh on the f32
//    FMA units with an epilogue that stores O (STORE_O; see there for the
//    design note).  At granite-moe's group of 3 a block's 64 rows hold 63
//    live (head, query) rows; the abstract tree runs over the live rows
//    only, and a partial query tile's dead rows (zero queries, finite
//    scores) are never stored.
// Neither route falls back on the other.
#include "attention_core.cuh"
#include "attention_tc.cuh"

static bool tc_path(int dtype, const void* q, const void* k, const void* v,
                    const void* o, int H, int Hkv, int D, int bq) {
  const uintptr_t addr =
      (uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o;
  return dtype == uisa::kBF16 && (D == 64 || D == 128) && (addr & 15) == 0 &&
         (H / Hkv) * bq <= uisa::ATT_ROWS;
}

template <typename T>
static cudaError_t launch(int mode, const uisa::AttnArgs& a,
                          cudaStream_t st) {
  if (mode == uisa::kAbstract)
    return uisa::launch_flash_attention<T, uisa::kAbstract>(a, st);
  if (mode == uisa::kAbstractShuffle)
    return uisa::launch_flash_attention<T, uisa::kAbstractShuffle>(a, st);
  return uisa::launch_flash_attention<T>(a, st);
}

// the tc route: attn_tc_kernel of MODE, O stored [B, H, Sq, D]
template <int MODE>
static cudaError_t launch_tc(const uisa::AttnArgs& a, cudaStream_t st) {
  return a.D == 128 ? uisa::launch_attn_tc<128, MODE, true>(a, st)
                    : uisa::launch_attn_tc<64, MODE, true>(a, st);
}

extern "C" int uisa_flash_attention(int mode, int dtype, const void* q,
                                    const void* k, const void* v, void* o,
                                    int B, int H, int Hkv, int Sq, int Skv,
                                    int D, int kv_offset, int bq, float scale,
                                    void* stream, int* route) {
  uisa::AttnArgs a{q, k, v, nullptr, nullptr, nullptr, nullptr,
                   B, H, Hkv, Sq, Skv, D, 0, kv_offset, bq, 1,
                   0, 1, 0, scale, o};
  cudaStream_t st = (cudaStream_t)stream;
  if (mode < uisa::kAbstract || mode > uisa::kNative)
    return (int)cudaErrorInvalidValue;
  const bool tc = tc_path(dtype, q, k, v, o, H, Hkv, D, bq);
  *route = tc ? 1 : 0;
  if (!tc) {
    if (dtype == uisa::kBF16)
      return (int)launch<__nv_bfloat16>(mode, a, st);
    return (int)launch<float>(mode, a, st);
  }
  if (mode == uisa::kAbstract)
    return (int)launch_tc<uisa::kAbstract>(a, st);
  if (mode == uisa::kAbstractShuffle)
    return (int)launch_tc<uisa::kAbstractShuffle>(a, st);
  return (int)launch_tc<uisa::kNative>(a, st);
}

// C entry point of the attention -> wo kernel, dense form (see
// attention_core.cuh for the design note).  Replaces
// kernels/fused.py::flash_attention_matmul of the JAX package, both its
// causal prefill shape (pos == nullptr, mask c <= i + kv_offset) and its
// decode shape (per-slot frontier pos [B]), and, with an int8 wo and its
// [N] f32 scales `wscale`, the same shapes of its int8 twin
// kernels/fused.py::flash_attention_matmul_q8.
// q [B,H,Sq,D], k/v [B,Hkv,Skv,D], wo [H*D,N] -> out [B,Sq,N]; part is the
// workspace, sized by uisa_flash_attention_matmul_workspace; `sms` is the
// card's SM count.  `mode` (kernels/_launch.py::MODE_CODES) selects the
// abstract or abstract+shuffle lowering, with wo at the working dtype or
// int8.  *route is set to the route taken (1 tc, 3 decode, 0 fma).
// Returns cudaGetLastError().
//
// Three routes, decided here alone (tc_path, decode_path): the causal shape
// in bf16 with a bf16 or int8 wo, D of 64 or 128, q, k and v 16-byte
// aligned (the core loads them with 16-byte cp.async), whose O @ wo
// product tc_gemm.cuh takes
// (B * Sq > 16 rows, H * D % 64 == 0, N % 8 == 0 for bf16 and N % 16 == 0
// for int8, wo 16-byte aligned), runs attention_tc.cuh's core, which stores
// O bf16 [B, Sq, H*D] in part, then the wgmma GEMM, which widens an int8
// wo's tiles to bf16 in shared memory and scales its columns in the
// epilogue (the "tc" route, every mode).  Bound on Hopper: operations (at
// 512 tokens and 32/8 heads of 128, 19.3 GFLOP against 27.3 MB with an
// int8 wo: 19.5 us against 8.1 us), so the wo product, 89% of them, runs
// on wgmma whatever wo's type.  The `pos` shape with one query a slot, in
// bf16 or f32, whose wo the decode GEMV takes (attention_decode.cuh's
// decode_route: at most 16 slots, D <= 128 with 16-byte rows, G <= 16,
// N columns of wo a multiple of 16 bytes, wo, q, k and v 16-byte aligned),
// runs attention_decode.cuh: the keys split across blocks, a combine that
// writes O into part, then wo on norm_gemv.cuh's GEMV (the "decode" route,
// every mode; part holds x_n = O, the GEMV's partials and tickets, then
// the splits' partials).  Bound on Hopper: bytes (at 8 slots of a 576-key
// cache and 32/8 heads of 128, 11 MB of visible keys and values beside
// 33.5 MB of wo), so each K/V row is read once a (slot, group) and wo once
// a call.  Every other call (f32 or other head widths at prefill, shapes
// the routes refuse) runs attn_group_kernel, part holding its f32 partials
// [Hkv, B, Sq, N], and group_sum_kernel (the "fma" route).  No route falls
// back on another.
#include "attention_core.cuh"
#include "attention_decode.cuh"
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

// the `pos` shape at one query a slot, on a wo the decode GEMV takes
static bool decode_path(int dtype, bool wq8, bool pos, const void* q,
                        const void* k, const void* v, const void* wo, int B,
                        int H, int Hkv, int Sq, int D, int N) {
  return pos && Sq == 1 &&
         uisa::decode_route(dtype, wq8, dtype == uisa::kBF16 ? 2 : 4, q, k,
                            v, wo, B, H, Hkv, D, N);
}

// f32 elements of `part` on a card with `sms` SMs: O, bf16 [B, Sq, H*D], on
// the tc route; on the decode route x_n = O, the GEMV's partials and
// tickets, then the key splits' partials (attention_decode.cuh::
// decode_workspace); else the f32 partials [Hkv, B, Sq, N].  *route is set
// to the route the launch with these arguments takes (1 tc, 3 decode, 0
// fma).
extern "C" long long uisa_flash_attention_matmul_workspace(
    int dtype, int wq8, int pos, const void* q, const void* k, const void* v,
    const void* wo, int B, int H, int Hkv, int Sq, int Skv, int D, int N,
    int sms, int* route) {
  const bool tc = tc_path(dtype, wq8, pos, q, k, v, wo, B, H, Sq, D, N);
  const bool dec =
      !tc && decode_path(dtype, wq8, pos, q, k, v, wo, B, H, Hkv, Sq, D, N);
  *route = tc ? 1 : dec ? 3 : 0;
  if (tc) return ((long long)B * Sq * H * D + 1) / 2;
  if (dec)
    return uisa::decode_workspace(dtype, wq8, B, H, Hkv, D, N, Skv,
                                  uisa::DEC_KT, sms);
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

// The decode route, instantiated after every form above so that those
// kernels compile as they did: T from `dtype`, wo at T or int8.
template <int MODE>
static cudaError_t launch_decode_mode(int dtype, const uisa::DecodeArgs& a,
                                      const void* wo, const float* wscale,
                                      void* out, void* ws, int N, int sms,
                                      cudaStream_t st) {
  using bf16 = __nv_bfloat16;
  constexpr int U = uisa::DEC_KT;
  if (dtype == uisa::kBF16)
    return wscale != nullptr
               ? uisa::launch_attention_decode<bf16, false, bf16, int8_t,
                                               MODE>(a, wo, wscale, out, ws,
                                                     N, U, sms, st)
               : uisa::launch_attention_decode<bf16, false, bf16, bf16, MODE>(
                     a, wo, wscale, out, ws, N, U, sms, st);
  return wscale != nullptr
             ? uisa::launch_attention_decode<float, false, float, int8_t,
                                             MODE>(a, wo, wscale, out, ws, N,
                                                   U, sms, st)
             : uisa::launch_attention_decode<float, false, float, float, MODE>(
                   a, wo, wscale, out, ws, N, U, sms, st);
}

static cudaError_t launch_decode(int mode, int dtype,
                                 const uisa::DecodeArgs& a, const void* wo,
                                 const float* wscale, void* out, void* ws,
                                 int N, int sms, cudaStream_t st) {
  if (mode == uisa::kAbstract)
    return launch_decode_mode<uisa::kAbstract>(dtype, a, wo, wscale, out, ws,
                                               N, sms, st);
  if (mode == uisa::kAbstractShuffle)
    return launch_decode_mode<uisa::kAbstractShuffle>(dtype, a, wo, wscale,
                                                      out, ws, N, sms, st);
  return launch_decode_mode<uisa::kNative>(dtype, a, wo, wscale, out, ws, N,
                                           sms, st);
}

extern "C" int uisa_flash_attention_matmul(
    int mode, int dtype, const void* q, const void* k, const void* v,
    const void* wo, const void* wscale, const void* pos, void* out,
    void* part, int B, int H, int Hkv, int Sq, int Skv, int D, int N,
    int kv_offset, int bq, int nsplit, float scale, int sms, void* stream,
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
  const bool dec = !tc && decode_path(dtype, qs.w != nullptr, pos != nullptr,
                                      q, k, v, wo, B, H, Hkv, Sq, D, N);
  *route = tc ? 1 : dec ? 3 : 0;
  if (dec) {
    uisa::DecodeArgs da{};
    da.q = q;
    da.k = k;
    da.v = v;
    da.pos = (const int*)pos;
    da.B = B;
    da.H = H;
    da.Hkv = Hkv;
    da.Skv = Skv;
    da.D = D;
    da.scale = scale;
    return (int)launch_decode(mode, dtype, da, wo, qs.w, out, part, N, sms,
                              st);
  }
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

// C entry point of the attention -> wo kernel, paged decode form (see
// attention_core.cuh for the design note).  Replaces
// kernels/fused.py::_paged_attention_matmul of the JAX package, and its
// int8 form under kernels/fused.py::flash_attention_matmul_q8: an int8 wo
// with [N] f32 scales `wscale`, beside k/v pools at the working dtype or
// int8 pools with f32 per-token scale pools `kscale`/`vscale` [P,Hkv,ps,1].
// q [B,H,Sq,D], page pools k/v [P,Hkv,ps,D], tables [B,maxp] int32 (entries
// clamped to P-1 in the kernel), pos [B] int32, wo [H*D,N] -> out
// [B,Sq,N]; part is the f32 workspace, sized by
// uisa_paged_attention_matmul_workspace; `sms` is the card's SM count.
// `mode` (kernels/_launch.py::MODE_CODES) selects the abstract or
// abstract+shuffle lowering, over pools and wo at the working dtype, or the
// int8 forms.  *route is set to the route taken (3 decode, 0 fma).
//
// Two routes, decided here alone (decode_path): one query a slot, in bf16
// or f32, whose wo the decode GEMV takes (attention_decode.cuh's
// decode_route: at most 16 slots, D <= 128 with K/V rows a multiple of 16
// bytes, G <= 16, N columns of wo a multiple of 16 bytes, wo, q and the
// pools 16-byte aligned) runs attention_decode.cuh: the keys split across
// blocks in whole pages, each page's table entry loaded once, a combine
// that writes O into part, then wo on norm_gemv.cuh's GEMV (the "decode"
// route, every mode and int8 form; part holds x_n = O, the GEMV's partials
// and tickets, then the splits' partials).  Bound on Hopper: bytes (at 8
// slots, 32/8 heads of 128 and frontiers of 128-544 keys, 11 MB of visible
// keys and values beside 33.5 MB of wo, 16.8 int8), so each K/V row is read
// once a (slot, group) and wo once a call.  Every other call runs
// attn_group_kernel, part holding its f32 partials [Hkv, B, Sq, N], and
// group_sum_kernel (the "fma" route).  Neither route falls back on the
// other.  A slot with pos < 0 sees no key on either route and gets 0, as
// the JAX kernel's skip_dead gives it.
#include "attention_core.cuh"
#include "attention_decode.cuh"

static bool decode_path(int dtype, bool wq8, bool kv8, const void* q,
                        const void* k, const void* v, const void* wo, int B,
                        int H, int Hkv, int Sq, int D, int N) {
  return Sq == 1 && uisa::decode_route(dtype, wq8,
                                       kv8 ? 1 : dtype == uisa::kBF16 ? 2 : 4,
                                       q, k, v, wo, B, H, Hkv, D, N);
}

// f32 elements of `part` on a card with `sms` SMs: on the decode route x_n
// = O, the GEMV's partials and tickets, then the key splits' partials
// (attention_decode.cuh::decode_workspace); else the f32 partials [Hkv, B,
// Sq, N].  *route is set to the route the launch with these arguments
// takes (3 decode, 0 fma).
extern "C" long long uisa_paged_attention_matmul_workspace(
    int dtype, int wq8, int kv8, const void* q, const void* k_pages,
    const void* v_pages, const void* wo, int B, int H, int Hkv, int Sq,
    int ps, int maxp, int D, int N, int sms, int* route) {
  const bool dec = decode_path(dtype, wq8, kv8, q, k_pages, v_pages, wo, B,
                               H, Hkv, Sq, D, N);
  *route = dec ? 3 : 0;
  if (!dec) return (long long)Hkv * B * Sq * N;
  return uisa::decode_workspace(dtype, wq8, B, H, Hkv, D, N, maxp * ps, ps,
                                sms);
}

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

// The decode route, instantiated after every form above so that those
// kernels compile as they did: T from `dtype`; pools and wo at T, wo int8
// beside pools at T, or both int8.
template <typename T, int MODE>
static cudaError_t launch_decode_t(const uisa::DecodeArgs& a,
                                   const void* wo, const float* wscale,
                                   void* out, void* ws, int N, int sms,
                                   cudaStream_t st) {
  if (a.ksc != nullptr) {
    if (wscale == nullptr) return cudaErrorInvalidValue;
    return uisa::launch_attention_decode<T, true, int8_t, int8_t, MODE>(
        a, wo, wscale, out, ws, N, a.ps, sms, st);
  }
  if (wscale != nullptr)
    return uisa::launch_attention_decode<T, true, T, int8_t, MODE>(
        a, wo, wscale, out, ws, N, a.ps, sms, st);
  return uisa::launch_attention_decode<T, true, T, T, MODE>(
      a, wo, wscale, out, ws, N, a.ps, sms, st);
}

template <int MODE>
static cudaError_t launch_decode_mode(int dtype, const uisa::DecodeArgs& a,
                                      const void* wo, const float* wscale,
                                      void* out, void* ws, int N, int sms,
                                      cudaStream_t st) {
  if (dtype == uisa::kBF16)
    return launch_decode_t<__nv_bfloat16, MODE>(a, wo, wscale, out, ws, N,
                                                sms, st);
  return launch_decode_t<float, MODE>(a, wo, wscale, out, ws, N, sms, st);
}

extern "C" int uisa_paged_attention_matmul(
    int mode, int dtype, const void* q, const void* k_pages,
    const void* v_pages, const void* kscale, const void* vscale,
    const void* wo, const void* wscale, const void* tables, const void* pos,
    void* out, void* part, int B, int H, int Hkv, int Sq, int P, int ps,
    int maxp, int D, int N, int bq, int nsplit, float scale, int sms,
    void* stream, int* route) {
  if (mode != uisa::kNative && mode != uisa::kAbstract &&
      mode != uisa::kAbstractShuffle)
    return (int)cudaErrorInvalidValue;
  const bool dec = decode_path(dtype, wscale != nullptr, kscale != nullptr, q,
                               k_pages, v_pages, wo, B, H, Hkv, Sq, D, N);
  *route = dec ? 3 : 0;
  if (dec) {
    if ((kscale == nullptr) != (vscale == nullptr))
      return (int)cudaErrorInvalidValue;
    uisa::DecodeArgs da{};
    da.q = q;
    da.k = k_pages;
    da.v = v_pages;
    da.ksc = (const float*)kscale;
    da.vsc = (const float*)vscale;
    da.tables = (const int*)tables;
    da.pos = (const int*)pos;
    da.B = B;
    da.H = H;
    da.Hkv = Hkv;
    da.Skv = maxp * ps;
    da.D = D;
    da.ps = ps;
    da.maxp = maxp;
    da.P = P;
    da.scale = scale;
    cudaStream_t st = (cudaStream_t)stream;
    const float* ws = (const float*)wscale;
    if (mode == uisa::kAbstract)
      return (int)launch_decode_mode<uisa::kAbstract>(dtype, da, wo, ws, out,
                                                      part, N, sms, st);
    if (mode == uisa::kAbstractShuffle)
      return (int)launch_decode_mode<uisa::kAbstractShuffle>(
          dtype, da, wo, ws, out, part, N, sms, st);
    return (int)launch_decode_mode<uisa::kNative>(dtype, da, wo, ws, out,
                                                  part, N, sms, st);
  }
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

template <int MODE>
static int decode_resident_mode(int dtype, int G, int D, int pages) {
  using bf16 = __nv_bfloat16;
  return dtype == uisa::kBF16
             ? uisa::decode_resident<bf16, true, bf16, MODE>(G, D, pages)
             : uisa::decode_resident<float, true, float, MODE>(G, D, pages);
}

// Blocks of the paged decode route's split kernel (mode, dtype, pools at
// the dtype) resident on one SM of the current device at G heads a group,
// head_dim D and keys a split `chunk` over pages of `ps`, or -1 on an
// error or a shape the route refuses.
extern "C" int uisa_paged_attention_decode_resident(int mode, int dtype,
                                                    int G, int D, int chunk,
                                                    int ps) {
  if (G < 1 || G > uisa::DEC_GMAX || D < 2 || D > uisa::DEC_DMAX ||
      ps < 1 || chunk < ps || (dtype != uisa::kBF16 && dtype != uisa::kF32))
    return -1;
  const int pages = chunk / ps + 1;
  if (mode == uisa::kAbstract)
    return decode_resident_mode<uisa::kAbstract>(dtype, G, D, pages);
  if (mode == uisa::kAbstractShuffle)
    return decode_resident_mode<uisa::kAbstractShuffle>(dtype, G, D, pages);
  if (mode == uisa::kNative)
    return decode_resident_mode<uisa::kNative>(dtype, G, D, pages);
  return -1;
}

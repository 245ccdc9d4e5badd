// The decode route ("decode") of the attention + wo kernels: the `pos` shape
// of flash_attention_matmul (one query a slot, keys c <= pos[b] of a dense
// cache [B, Hkv, Skv, D]) and the paged shape (the same over page pools
// [P, Hkv, ps, D] through block_tables [B, maxp]), with wo at the working
// dtype or int8 with [N] f32 scales, and, paged, pools at the working dtype
// or int8 with f32 per-token scale pools [P, Hkv, ps, 1].
//
// Replaces, at decode, kernels/fused.py::flash_attention_matmul (its `pos`
// shape, _flash_matmul_kernel with has_pos) and
// kernels/fused.py::_paged_attention_matmul of the JAX package, and their
// int8 forms under kernels/fused.py::flash_attention_matmul_q8.
//
// Bound on Hopper: bytes.  At granite-8b's widths (8 slots, 32/8 heads of
// 128, a 576-key cache, wo [4096, 4096]) the visible keys and values are
// about 11 MB and wo 33.5 MB (16.8 int8): 79% of the bytes are wo's, so wo
// is read once a call, not once a slot.  Three launches:
//  1. decode_split_kernel<T, PAGED, KVT, MODE, GM>, one block a (key split s,
//     kv group g, slot b): the G = H/Hkv query heads of the group share each
//     K/V row, read once, by 16-byte cp.async loads into a ring of two 64-key
//     tiles (row stride padded by 16 bytes: a warp's 16-byte reads of 32 rows
//     hit every bank once a wavefront); the first tiles are in flight before q
//     is staged.  The ring keeps two tiles even where a split walks one: three
//     blocks an SM in bf16 at D 128 and G <= 8, which ran the split kernel in
//     12-13 us against 14-18 with a one-tile ring and five
//     (scripts/decode_breakdown.py, H100 80GB HBM3, 700 W); two at G 12 and 16
//     (q in f32, GM 16's scores).  A thread owns whole (head, key) scores over
//     D and whole (head, d) pairs of P.V, so no cross-lane stage appears but
//     the softmax's row max and row sum, through MODE as attn_group_kernel
//     does them: native warp_max / warp_sum, abstract+shuffle lane_tree_reduce
//     (one warp a head), abstract a halving tree in shared memory, no shuffle.
//     GM bounds G at compile time, a warp a head of the bound: a group of at
//     most DEC_GNARROW = 8 heads runs the GM 8 kernels (256 threads), a wider
//     one, up to DEC_GMAX = 16 (mistral-large-123b's 96/8 heads), the GM 16
//     kernels (512 threads: at mistral-large's paged decode 5% faster than 256
//     threads with warp w taking heads w and w + 8, and no slower than plans
//     of fewer splits or q staged at T, scripts/decode_variants.py).  Each
//     head's sums run in the same order under either bound.  The key walk is
//     attn_group_kernel's: the dense shape under the abstract modes walks
//     every key (masked past the frontier), native stops at the frontier, the
//     paged shape stops at it in every mode (the JAX package's skip_dead: a
//     paged slot with pos < 0 sees nothing and returns 0).  A paged split
//     covers whole pages and loads each page's table entry once (clamped to
//     P - 1).  Int8 keys and values are widened and multiplied by their
//     per-token scales in f32, never rounded, as the plain version does.  Each
//     split writes (m, l, acc[G][D]) in f32; a split past the slot's walk
//     writes nothing and exits.  The split count comes from the shapes alone
//     (plan_decode: about four blocks an SM), never from pos.
//  2. decode_combine_kernel<T, PAGED, MODE, GM>, one block a (g, b),
//     launched as the programmatic dependent (PDL) of (1): the splits the
//     slot's walk reaches, in split order, no float atomics: O = sum e_s
//     acc_s / sum e_s l_s with e_s = exp(m_s - max m) (l == 0 -> 1), rounded
//     to T as the plain version rounds the attention output, into x_n [B,
//     H*D] of the GEMV's workspace.  A second launch, not a last-block
//     ticket: the workspace comes from the caching allocator uninitialized,
//     and nothing runs before (1) that could zero a ticket, while (2) is
//     the launch the GEMV needs before it anyway.  It zeroes the GEMV's
//     split tickets and lets (3) launch at once, taking gemv_rows_kernel's
//     place as the GEMV's prologue.
//  3. out = x_n @ wo on the norm-GEMMs' decode GEMV (norm_gemv.cuh, its
//     kernels unchanged): M = B rows, K = H*D, wo streamed once (bf16:
//     norm_gemv_mma_kernel, f32: norm_gemv_kernel; int8 wo widened in
//     registers, its column scale on the sum), K reduced in a fixed order.
// The result is the same bits from call to call.
//
// The route (decode_route): the `pos` or paged shape with one query a slot,
// B <= SMALL_M slots, head_dim D <= 128 with rows of K/V a multiple of 16
// bytes, G <= DEC_GMAX = 16 heads a group, T bf16 or f32, wo that gemv_route
// takes (N columns a multiple of 16 bytes, 16-byte aligned), and q, k and v
// (or the pools) 16-byte aligned; the callers check it.
#pragma once
#include <stdint.h>

#include <type_traits>

#include "attention_core.cuh"
#include "norm_gemv.cuh"

namespace uisa {

constexpr int DEC_KT = 64;           // keys a tile
constexpr int DEC_GNARROW = 8;       // the narrow kernels' group bound
constexpr int DEC_GMAX = 16;         // query heads of a kv group
constexpr int DEC_DMAX = 128;
constexpr int DEC_STAGES = 2;        // tiles a block holds
constexpr int DEC_MAX_SPLITS = 64;
constexpr int DEC_SPLITS_PER_SM = 4;
static_assert(DEC_KT == 64, "the softmax holds two scores a lane");

// Threads a block of the kernels of group bound GM: a warp a head.
template <int GM>
__host__ __device__ constexpr int dec_threads() {
  return 32 * GM;
}

// The kernels' group bound GM for G heads a group.
inline int decode_gm(int G) {
  return G <= DEC_GNARROW ? DEC_GNARROW : DEC_GMAX;
}

struct DecodeArgs {
  const void* q;                 // [B, H, 1, D] at T
  const void* k;                 // dense [B, Hkv, Skv, D] / [P, Hkv, ps, D]
  const void* v;
  const float* ksc;              // KVT int8: [P, Hkv, ps, 1]
  const float* vsc;
  const int* tables;             // paged: [B, maxp]
  const int* pos;                // [B]
  float* part;                   // [B, Hkv, splits][G][D + 2]: m, l, acc
  void* xn;                      // O at T, [B, H*D]
  unsigned* tickets;             // the GEMV's, zeroed by the combine
  int n_tickets;
  int B, H, Hkv, Skv, D, ps, maxp, P;
  int splits, chunk;             // a split's keys: whole tiles, or pages
  float scale;
};

// Whether the decode route takes the call: the callers add the shape (a
// `pos` frontier, one query a slot).
inline bool decode_route(int dtype, bool wq8, int kv_bytes, const void* q,
                         const void* k, const void* v, const void* wo, int B,
                         int H, int Hkv, int D, int N) {
  if ((dtype != kBF16 && dtype != kF32) || B < 1 || B > SMALL_M ||
      Hkv < 1 || H % Hkv != 0 || H / Hkv > DEC_GMAX || D < 2 ||
      D > DEC_DMAX || (D * kv_bytes) % 16 != 0 ||
      (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) & 15) != 0)
    return false;
  if (wq8) return gemv_route<int8_t>(B, N, wo);
  return dtype == kBF16 ? gemv_route<__nv_bfloat16>(B, N, wo)
                        : gemv_route<float>(B, N, wo);
}

// The key splits: keys in units of `unit` (a tile, or a page), about
// DEC_SPLITS_PER_SM blocks an SM over the (slot, group) pairs.
struct DecodePlan {
  int splits, chunk;
  long long part_words;
};

inline DecodePlan plan_decode(int B, int Hkv, int G, int D, int keys,
                              int unit, int sms) {
  const int units = (keys + unit - 1) / unit;
  const long long base = (long long)B * Hkv;
  long long s = (DEC_SPLITS_PER_SM * (long long)sms + base - 1) / base;
  s = s < units ? s : units;
  s = s < DEC_MAX_SPLITS ? s : DEC_MAX_SPLITS;
  s = s > 1 ? s : 1;
  const int per = (int)((units + s - 1) / s);
  DecodePlan p;
  p.chunk = per * unit;
  p.splits = (units + per - 1) / per;
  p.part_words = gemv_align4(base * p.splits * G * (D + 2));
  return p;
}

// the keys a slot's walk visits: [0, end)
template <bool PAGED, int MODE>
__device__ __forceinline__ int decode_walk_end(int p, int Skv) {
  if constexpr (PAGED) return p < 0 ? 0 : min(Skv, p + 1);
  if constexpr (MODE != kNative) return Skv;
  return p < 0 ? Skv : min(Skv, p + 1);
}

__device__ __forceinline__ void dec_cp16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void dec_cp4(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem)
               : "memory");
}

// 16 bytes of K as f32 elements
template <typename KVT>
__device__ __forceinline__ void dec_unpack16(uint4 u, float* f) {
  if constexpr (std::is_same<KVT, float>::value) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  } else if constexpr (std::is_same<KVT, __nv_bfloat16>::value) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  } else {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        f[4 * i + j] = (float)(int8_t)((w[i] >> (8 * j)) & 0xffu);
  }
}

// two consecutive elements of V as f32
template <typename KVT>
__device__ __forceinline__ float2 dec_pair(const uint8_t* p) {
  if constexpr (std::is_same<KVT, float>::value) {
    return *(const float2*)p;
  } else if constexpr (std::is_same<KVT, __nv_bfloat16>::value) {
    const uint32_t w = *(const uint32_t*)p;
    return make_float2(__uint_as_float(w << 16),
                       __uint_as_float(w & 0xffff0000u));
  } else {
    const char2 c = *(const char2*)p;
    return make_float2((float)c.x, (float)c.y);
  }
}

// Dynamic shared memory of the split kernel: the K/V ring, q as f32 [G][D],
// the split's page entries.
inline size_t decode_smem_bytes(int kv_bytes, int G, int D, int pages) {
  const size_t row = (size_t)D * kv_bytes + 16;
  return DEC_STAGES * 2 * DEC_KT * row + (size_t)G * D * sizeof(float) +
         (size_t)pages * sizeof(int);
}

template <typename T, bool PAGED, typename KVT, int MODE, int GM>
__global__ void __launch_bounds__(32 * GM)
decode_split_kernel(DecodeArgs a) {
  constexpr bool kKV8 = std::is_same<KVT, int8_t>::value;
  constexpr int EPC = 16 / (int)sizeof(KVT);     // elements a 16-byte chunk
  constexpr int NT = dec_threads<GM>();
  // (head, d pair) units a thread owns in P.V
  constexpr int UNITS = (GM * DEC_DMAX / 2 + NT - 1) / NT;
  extern __shared__ __align__(16) uint8_t dec_smem[];
  __shared__ float Ps[GM][DEC_KT + 1];
  __shared__ float m_s[GM], l_s[GM], c_s[GM];
  __shared__ float tree[MODE == kAbstract ? GM : 1][DEC_KT / 2];
  __shared__ float mnew[GM];
  __shared__ float scl[DEC_STAGES][2][kKV8 ? DEC_KT : 1];
  asm volatile("griddepcontrol.launch_dependents;");

  const int tid = threadIdx.x;
  const int s = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int G = a.H / a.Hkv, D = a.D;
  const int p = a.pos[b];
  const int k0 = s * a.chunk;
  const int k1 = min(k0 + a.chunk, decode_walk_end<PAGED, MODE>(p, a.Skv));
  if (k0 >= k1) return;                      // past the walk: no partial

  const int RB = D * (int)sizeof(KVT), RBP = RB + 16, CH = RB / 16;
  uint8_t* ring = dec_smem;                  // [stage][K, V][KT][RBP]
  float* qs = (float*)(ring + DEC_STAGES * 2 * DEC_KT * RBP);   // [G][D]
  int* pg = (int*)(qs + G * D);              // the split's page entries
  const int pfirst = PAGED ? k0 / a.ps : 0;
  if constexpr (PAGED) {
    const int np = (k1 - 1) / a.ps - pfirst + 1;
    for (int i = tid; i < np; i += NT)
      pg[i] = max(min(a.tables[(size_t)b * a.maxp + pfirst + i], a.P - 1), 0);
    __syncthreads();                         // the page entries
  }

  // element offset of key c's row (its scale: the offset / D)
  auto row_of = [&](int c) -> size_t {
    if constexpr (PAGED)
      return (((size_t)pg[c / a.ps - pfirst] * a.Hkv + g) * a.ps +
              c % a.ps) * D;
    else
      return (((size_t)b * a.Hkv + g) * a.Skv + c) * D;
  };
  const uint8_t* kbase = (const uint8_t*)a.k;
  const uint8_t* vbase = (const uint8_t*)a.v;
  // tile c0's rows into stage st; rows past k1 are zeros
  auto load = [&](int c0, int st) {
    const int nk = min(DEC_KT, k1 - c0);
    uint8_t* kt = ring + (size_t)st * 2 * DEC_KT * RBP;
    for (int i = tid; i < 2 * DEC_KT * CH; i += NT) {
      const int which = i / (DEC_KT * CH), r = i / CH % DEC_KT, j = i % CH;
      uint8_t* dst = kt + ((size_t)which * DEC_KT + r) * RBP + j * 16;
      if (r < nk)
        dec_cp16(dst, (which ? vbase : kbase) +
                          row_of(c0 + r) * sizeof(KVT) + j * 16);
      else
        *(uint4*)dst = make_uint4(0u, 0u, 0u, 0u);
    }
    if constexpr (kKV8) {
      for (int i = tid; i < 2 * DEC_KT; i += NT) {
        const int which = i / DEC_KT, r = i % DEC_KT;
        if (r < nk)
          dec_cp4(&scl[st][which][r],
                  (which ? a.vsc : a.ksc) + row_of(c0 + r) / D);
        else
          scl[st][which][r] = 0.f;
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  // the first tiles in flight, then q and the softmax state beside them
  const int ntiles = (k1 - k0 + DEC_KT - 1) / DEC_KT;
  load(k0, 0);
  if (ntiles > 1) load(k0 + DEC_KT, 1);
  const T* q = (const T*)a.q + ((size_t)b * a.H + g * G) * D;
  for (int i = tid; i < G * D; i += NT) qs[i] = to_f(q[i]);
  if (tid < G) {
    m_s[tid] = ATT_NEG_INF;
    l_s[tid] = 0.f;
  }
  const int units = G * D / 2;
  float acc[UNITS][2];
#pragma unroll
  for (int u = 0; u < UNITS; ++u) acc[u][0] = acc[u][1] = 0.f;
  const int w = tid / 32, lane = tid % 32;
  for (int t = 0; t < ntiles; ++t) {
    const int st = t % DEC_STAGES, c0 = k0 + t * DEC_KT;
    const int nk = min(DEC_KT, k1 - c0);
    if (t + 1 < ntiles)
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    else
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();                         // the tile, q, the state
    const uint8_t* kt = ring + (size_t)st * 2 * DEC_KT * RBP;
    const uint8_t* vt = kt + (size_t)DEC_KT * RBP;

    // scores: a thread a (head, key), the dot over D in order
    for (int i = tid; i < G * DEC_KT; i += NT) {
      const int hg = i / DEC_KT, r = i % DEC_KT;
      float sc = -INFINITY;                  // past the walk: no weight
      if (r < nk) {
        const float* qr = qs + hg * D;
        const uint8_t* kr = kt + (size_t)r * RBP;
        float ks = 1.f;
        if constexpr (kKV8) ks = scl[st][0][r];
        float dot = 0.f;
        for (int j = 0; j < CH; ++j) {
          float kf[EPC];
          dec_unpack16<KVT>(*(const uint4*)(kr + j * 16), kf);
#pragma unroll
          for (int e = 0; e < EPC; ++e) {
            float kv = kf[e];
            if constexpr (kKV8) kv *= ks;   // dequantized, never rounded
            dot = fmaf(qr[j * EPC + e], kv, dot);
          }
        }
        sc = dot * a.scale;
        if (c0 + r > p) sc = ATT_NEG_INF;   // masked (dense walks only)
      }
      Ps[hg][r] = sc;
    }
    __syncthreads();

    // the online softmax's row max and row sum, one row a head, in MODE
    if constexpr (MODE == kAbstract) {
      constexpr int HALF = DEC_KT / 2;
      for (int i = tid; i < G * HALF; i += NT) {
        const int r = i / HALF, c = i % HALF;
        tree[r][c] = fmaxf(Ps[r][c], Ps[r][c + HALF]);
      }
      __syncthreads();
      for (int wd = HALF / 2; wd >= 1; wd >>= 1) {
        for (int i = tid; i < G * wd; i += NT) {
          const int r = i / wd, c = i % wd;
          const float mx = fmaxf(tree[r][c], tree[r][c + wd]);
          if (wd > 1)
            tree[r][c] = mx;
          else
            mnew[r] = fmaxf(m_s[r], mx);
        }
        __syncthreads();
      }
      for (int i = tid; i < G * HALF; i += NT) {
        const int r = i / HALF, c = i % HALF;
        const float p0 = expf(Ps[r][c] - mnew[r]);
        const float p1 = expf(Ps[r][c + HALF] - mnew[r]);
        Ps[r][c] = p0;
        Ps[r][c + HALF] = p1;
        tree[r][c] = p0 + p1;
      }
      __syncthreads();
      for (int wd = HALF / 2; wd >= 1; wd >>= 1) {
        for (int i = tid; i < G * wd; i += NT) {
          const int r = i / wd, c = i % wd;
          const float sum = tree[r][c] + tree[r][c + wd];
          if (wd > 1) {
            tree[r][c] = sum;
          } else {
            const float corr = expf(m_s[r] - mnew[r]);
            l_s[r] = l_s[r] * corr + sum;
            m_s[r] = mnew[r];
            c_s[r] = corr;
          }
        }
        if (wd > 1) __syncthreads();
      }
    } else if (w < G) {
      const float s0 = Ps[w][lane], s1 = Ps[w][lane + 32];
      float mx = fmaxf(s0, s1);
      if constexpr (MODE == kAbstractShuffle)
        mx = lane_tree_reduce<32>(mx, Max());
      else
        mx = warp_max(mx);
      const float m_old = m_s[w];
      const float m_new = fmaxf(m_old, mx);
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      Ps[w][lane] = p0;
      Ps[w][lane + 32] = p1;
      float sum = p0 + p1;
      if constexpr (MODE == kAbstractShuffle)
        sum = lane_tree_reduce<32>(sum);
      else
        sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        l_s[w] = l_s[w] * corr + sum;
        m_s[w] = m_new;
        c_s[w] = corr;
      }
    }
    __syncthreads();

    // P.V: a thread a (head, d pair), keys in order
#pragma unroll
    for (int ui = 0; ui < UNITS; ++ui) {
      const int u = tid + ui * NT;
      if (u < units) {
        const int hg = u / (D / 2), d = 2 * (u % (D / 2));
        const float corr = c_s[hg];
        float a0 = acc[ui][0] * corr, a1 = acc[ui][1] * corr;
        const uint8_t* vp = vt + (size_t)d * sizeof(KVT);
        for (int r = 0; r < nk; ++r) {
          const float pr = Ps[hg][r];
          float2 vv = dec_pair<KVT>(vp + (size_t)r * RBP);
          if constexpr (kKV8) {
            const float vs = scl[st][1][r];
            vv.x *= vs;
            vv.y *= vs;
          }
          a0 = fmaf(pr, vv.x, a0);
          a1 = fmaf(pr, vv.y, a1);
        }
        acc[ui][0] = a0;
        acc[ui][1] = a1;
      }
    }
    __syncthreads();                         // the stage is free
    if (t + DEC_STAGES < ntiles) load(k0 + (t + DEC_STAGES) * DEC_KT, st);
  }

  float* pp = a.part + (((size_t)b * a.Hkv + g) * a.splits + s) * G * (D + 2);
  if (tid < G) {
    pp[tid] = m_s[tid];
    pp[G + tid] = l_s[tid];
  }
#pragma unroll
  for (int ui = 0; ui < UNITS; ++ui) {
    const int u = tid + ui * NT;
    if (u < units) {
      const int hg = u / (D / 2), d = 2 * (u % (D / 2));
      *(float2*)(pp + 2 * G + hg * D + d) = make_float2(acc[ui][0],
                                                        acc[ui][1]);
    }
  }
}

// O of one (g, b) from its splits, in split order, into x_n; the GEMV's
// tickets zeroed, the GEMV let launch.  The splits' m and l come in at
// once (one round trip), each head's weights exp(m_s - max m) and its sum
// l follow in shared memory, then each output's acc loads, eight in
// flight.
template <typename T, bool PAGED, int MODE, int GM>
__global__ void __launch_bounds__(32 * GM)
decode_combine_kernel(DecodeArgs a) {
  constexpr int NT = dec_threads<GM>();
  __shared__ float es[DEC_MAX_SPLITS][GM], ls[DEC_MAX_SPLITS][GM];
  __shared__ float Ls[GM];
  asm volatile("griddepcontrol.launch_dependents;");
  const int nthreads = gridDim.x * gridDim.y * NT;
  for (int i = (blockIdx.y * gridDim.x + blockIdx.x) * NT +
               threadIdx.x;
       i < a.n_tickets; i += nthreads)
    a.tickets[i] = 0u;
  asm volatile("griddepcontrol.wait;" ::: "memory");   // the partials
  const int g = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int G = a.H / a.Hkv, D = a.D;
  const int end = decode_walk_end<PAGED, MODE>(a.pos[b], a.Skv);
  const int live = min(a.splits, (end + a.chunk - 1) / a.chunk);
  const size_t sstride = (size_t)G * (D + 2);
  const float* pp = a.part + ((size_t)b * a.Hkv + g) * a.splits * sstride;
  for (int i = tid; i < live * G; i += NT) {
    const int s = i / G, hg = i % G;
    es[s][hg] = __ldcg(pp + s * sstride + hg);            // m, for now
    ls[s][hg] = __ldcg(pp + s * sstride + G + hg);
  }
  __syncthreads();
  if (tid < G) {
    float M = -INFINITY;
    for (int s = 0; s < live; ++s) M = fmaxf(M, es[s][tid]);
    float L = 0.f;
    for (int s = 0; s < live; ++s) {
      const float e = expf(es[s][tid] - M);
      es[s][tid] = e;
      L += e * ls[s][tid];
    }
    Ls[tid] = L == 0.f ? 1.f : L;
  }
  __syncthreads();
  T* xn = (T*)a.xn + (size_t)b * a.H * D + (size_t)g * G * D;
  for (int o = tid; o < G * D; o += NT) {
    const int hg = o / D;
    const float* src = pp + 2 * G + o;
    float A = 0.f;
#pragma unroll 8
    for (int s = 0; s < live; ++s)
      A = fmaf(es[s][hg], __ldcg(src + s * sstride), A);
    xn[o] = from_f<T>(A / Ls[hg]);
  }
}

// f32 words of the workspace: the GEMV's (x_n at T, its partials and
// tickets), then the splits' partials; T from `dtype`, wo int8 or at T.
inline long long decode_workspace(int dtype, bool wq8, int B, int H, int Hkv,
                                  int D, int N, int keys, int unit, int sms) {
  return gemv_workspace<false>(dtype, wq8 ? kI8 : dtype, B, H * D, N, sms) +
         plan_decode(B, Hkv, H / Hkv, D, keys, unit, sms).part_words;
}

// Launches (1) and (2) of the kernels of group bound GM.
template <typename T, bool PAGED, typename KVT, int MODE, int GM>
cudaError_t launch_decode_attention(const DecodeArgs& a, size_t smem,
                                    cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      decode_split_kernel<T, PAGED, KVT, MODE, GM>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  decode_split_kernel<T, PAGED, KVT, MODE, GM>
      <<<dim3(a.splits, a.Hkv, a.B), dec_threads<GM>(), smem, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.Hkv, a.B);
  cfg.blockDim = dim3(dec_threads<GM>());
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, decode_combine_kernel<T, PAGED, MODE, GM>,
                            a);
}

// The three launches over the workspace `ws` (decode_workspace's words).
// `a` holds the attention operands and shapes; `keys` and `unit` are Skv
// and DEC_KT (dense) or maxp * ps and ps (paged).
template <typename T, bool PAGED, typename KVT, typename WT, int MODE>
cudaError_t launch_attention_decode(DecodeArgs a, const void* wo,
                                    const float* wscale, void* out, void* ws,
                                    int N, int unit, int sms,
                                    cudaStream_t st) {
  constexpr bool kKV8 = std::is_same<KVT, int8_t>::value;
  if ((std::is_same<WT, int8_t>::value != (wscale != nullptr)) ||
      (kKV8 && (a.ksc == nullptr || a.vsc == nullptr)))
    return cudaErrorInvalidValue;
  const int G = a.H / a.Hkv, K = a.H * a.D;
  const GemvPlan gp = plan_gemv<T, WT, false>(a.B, K, N, sms);
  const DecodePlan dp = plan_decode(a.B, a.Hkv, G, a.D, a.Skv, unit, sms);
  a.splits = dp.splits;
  a.chunk = dp.chunk;
  a.xn = ws;
  a.tickets = (unsigned*)((float*)ws + gp.xn_words + gp.part_words);
  a.n_tickets = (int)gp.ticket_words;
  a.part = (float*)ws + gp.words();
  const int pages = PAGED ? dp.chunk / a.ps + 1 : 0;
  const size_t smem = decode_smem_bytes((int)sizeof(KVT), G, a.D, pages);
  const cudaError_t err =
      decode_gm(G) == DEC_GNARROW
          ? launch_decode_attention<T, PAGED, KVT, MODE, DEC_GNARROW>(a, smem,
                                                                       st)
          : launch_decode_attention<T, PAGED, KVT, MODE, DEC_GMAX>(a, smem,
                                                                    st);
  if (err != cudaSuccess) return err;
  return launch_gemv_dependent<T, WT, false>(gp, wo, wscale, out, ws, a.B, K,
                                             N, st);
}

template <typename T, bool PAGED, typename KVT, int MODE, int GM>
cudaError_t split_resident(size_t smem, int* blocks) {
  auto kernel = decode_split_kernel<T, PAGED, KVT, MODE, GM>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kernel, dec_threads<GM>(), smem);
}

// Blocks of the split kernel resident on one SM of the current device at
// G heads a group, head_dim D and `pages` page entries (paged: a split's
// pages + 1; dense 0), or -1 on an error.
template <typename T, bool PAGED, typename KVT, int MODE>
int decode_resident(int G, int D, int pages) {
  const size_t smem = decode_smem_bytes((int)sizeof(KVT), G, D, pages);
  int blocks = -1;
  const cudaError_t err =
      decode_gm(G) == DEC_GNARROW
          ? split_resident<T, PAGED, KVT, MODE, DEC_GNARROW>(smem, &blocks)
          : split_resident<T, PAGED, KVT, MODE, DEC_GMAX>(smem, &blocks);
  return err == cudaSuccess ? blocks : -1;
}

}  // namespace uisa

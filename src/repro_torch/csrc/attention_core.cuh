// Attention with the output projection fused behind it:
//   out[b, s, :] = sum_h softmax(q_h k_h^T / sqrt(D)) v_h . wo[h*D:(h+1)*D, :]
// Replaces kernels/fused.py::flash_attention_matmul (its body
// _flash_matmul_kernel over kernels/attention.py::_flash_kernel) and
// kernels/fused.py::_paged_attention_matmul of the JAX package.  With
// STORE_O the same online-softmax loop ends in an epilogue that stores O
// itself, [B, H, Sq, D] at the working dtype: plain flash attention,
// kernels/attention.py::flash_attention (flash_attention.cu), in every
// mode below.
//
// Masks, as in the JAX package: causal (key c visible to query i when
// c <= i + kv_offset) or by a per-slot frontier pos[b] (keys c <= pos[b]),
// masked scores set to -1e30, a row with no visible key divides by l = 1.
// A dense slot with pos < 0 sees every key masked: the online softmax then
// averages all Skv keys, as the plain version's softmax over -1e30 does.
// A paged slot with pos < 0 visits no page, so its O, and its output, is
// 0 (the JAX kernel's skip_dead), in every mode.
// Keys past Skv (tile padding) get -inf and weigh nothing.
//
// The cross-head sum is the trap: the TPU kernel carries it across a
// *sequential* head axis in one [bq, N] f32 scratch.  Hopper blocks run in
// no order, so this port takes per-kv-group f32 partials summed in a
// second pass in a fixed group order (group_sum_kernel), with no atomics:
//   - one block per (query tile x N share, kv group g, batch b) folds the
//     G = H/Hkv query heads of the group into its rows (row = head-in-group,
//     query), so each key/value tile, dense or paged, is read once per group;
//   - online softmax over 64-key tiles in shared memory (f32), the
//     attention output O stays in shared memory, rounded to the working
//     dtype as the plain version rounds it;
//   - the block multiplies O by the group's wo rows and writes an f32
//     partial [Hkv, B, Sq, N] (workspace Hkv*B*Sq*N*4 bytes: 1 MiB at
//     granite-8b decode with 8 slots, 64 MiB for one 512-token prefill);
//   - group_sum_kernel adds the Hkv partials in group order and casts.
// The [B, Sq, H, D] attention output never exists in device memory; the
// price is the f32 partial, N/(G*D) = 8x its size at granite-8b widths.
//
// Paged (PAGED = true): k/v are page pools [P, Hkv, ps, D]; each block loads
// its own block_tables[b, c / ps] entries, clamped to P - 1, and stops at
// the slot's frontier, so dead and sentinel pages are never read.  Any page
// size works: key addresses are resolved per key.
//
// The int8 twins (kernels/fused.py::flash_attention_matmul_q8 of the JAX
// package, its body _flash_matmul_kernel with quant_w / quant_kv, and
// kernels/attention.py::_flash_kernel:155-158) are template arguments of
// the same loop: WT = int8_t reads wo as int8 times its [N] f32 scale in
// project_group; KVT = int8_t (paged only) reads k/v page pools as int8
// with f32 per-token scale pools [P, Hkv, ps, 1], whose entry is resolved
// through the same clamped table entry as the row's, and each key or
// value element is dequantized into the f32 shared tile on load.  The
// dense shapes take k/v at the working dtype (the dense int8 cache is
// dequantized up front, as in the JAX package).
//
// The modes (the JAX package's abstract and abstract+shuffle lowerings,
// uisa_flash_attention_matmul_<mode>, uisa_paged_attention_matmul_<mode>
// and, with STORE_O, uisa_flash_attention_<mode>)
// are the template argument MODE of the same loop.  Two things change with
// it, as in the JAX package (kernels/attention.py::_row_reduce and the
// `skip` flag of kernels/fused.py::_flash_matmul_kernel):
//   - the online softmax's row max and row sum.  native and
//     abstract+shuffle: one warp per 8 rows, a 32-lane butterfly over the
//     64 scores of a row (warp_max / warp_sum, or lane_tree_reduce with
//     Max and Add).  abstract: no shuffle at all; every row of the block
//     at once through a halving tree in shared memory (its own [ROWS][KV/2]
//     f32 tile, 8 KB, so the exponentiated Ps tile survives for P.V):
//     6 stages for the max, 6 for the sum, one __syncthreads each;
//   - the key walk: the abstract modes visit every key block of the causal
//     and the dense `pos` shapes (masked, as now); native stops at the
//     diagonal or the frontier.  The paged shape stops at the slot's
//     frontier in every mode (skip_dead in the JAX package).
// The int8 forms (KVT, WT) combine with every MODE: the mode touches the
// softmax and the walk, the int8 forms only the loads of k, v and wo.
//
// Bound on Hopper: decode reads the kv of every slot once and the wo
// weights (33.6 MB at granite-8b, 16.8 MB int8) - bytes; prefill is
// operations.  This kernel uses the f32 FMA units, and each (slot, group)
// block re-reads its wo rows (from L2 when they fit).  The bf16 causal
// prefill of flash_attention_matmul (D 64 or 128, a bf16 or int8 wo) takes
// the tensor cores instead: attention_tc.cuh's core, then tc_gemm.cuh's O @
// wo (the route is decided in flash_attention_matmul.cu); so does plain
// bf16 flash attention at D 64 or 128, the same core storing O [B, H, Sq,
// D] (flash_attention.cu).  The decode shapes (`pos` and paged, one query
// a slot, bf16 or f32) take attention_decode.cuh instead: the keys split
// across blocks, each K/V row read once a (slot, group), then wo read once
// a call on norm_gemv.cuh's GEMV (the "decode" route, decided in
// flash_attention_matmul.cu and paged_attention_matmul.cu; at most 16
// query heads a kv group).  f32 prefill, other head widths and the shapes
// those routes refuse (a decode group of 17 or more heads among them) run
// this kernel.
#pragma once
#include <type_traits>

#include "common.cuh"
#include "lanes.cuh"

namespace uisa {

struct Max {
  __device__ __forceinline__ float operator()(float a, float b) const {
    return fmaxf(a, b);
  }
};

constexpr int ATT_ROWS = 64;     // (query head in group, query) rows per block
constexpr int ATT_KV = 64;       // keys per tile
constexpr int ATT_DMAX = 128;    // largest head_dim
constexpr int ATT_THREADS = 256;
constexpr float ATT_NEG_INF = -1e30f;

struct AttnArgs {
  const void* q;      // [B, H, Sq, D]
  const void* k;      // dense [B, Hkv, Skv, D] / paged [P, Hkv, ps, D]
  const void* v;
  const void* wo;     // [H*D, N]
  const int* tables;  // paged: [B, maxp]
  const int* pos;     // [B] frontier, or nullptr for causal
  float* part;        // [Hkv, B, Sq, N]
  int B, H, Hkv, Sq, Skv, D, N, kv_offset, bq, nsplit, maxp, ps, P;
  float scale;
  void* o;            // STORE_O: [B, H, Sq, D]
};

// The int8 forms' f32 scales, a kernel argument of their own: the bf16/f32
// instantiations never read it, and their code is that of the bf16 kernel.
struct QuantScales {
  const float* w = nullptr;  // WT = int8: [N]
  const float* k = nullptr;  // KVT = int8: [P, Hkv, ps, 1]
  const float* v = nullptr;
};

// dynamic shared memory; KV8 adds the tile's per-key k and v scales, the
// abstract mode its reduction tile [ROWS][KV/2] and the rows' new maxima
inline size_t attn_smem_bytes(bool kv8 = false, bool tree = false) {
  return sizeof(float) * (ATT_ROWS * (ATT_DMAX + 1) + ATT_KV * (ATT_DMAX + 1) +
                          ATT_KV * ATT_DMAX + ATT_ROWS * (ATT_KV + 1) +
                          3 * ATT_ROWS + (kv8 ? 2 * ATT_KV : 0) +
                          (tree ? ATT_ROWS * (ATT_KV / 2) + ATT_ROWS : 0)) +
         sizeof(long long) * ATT_KV;
}

// partial[g, b, q0 + i, n] = sum over the group's heads and D of O * wo,
// RQ query rows at a time (RQ = 1 at decode, 16 at prefill)
template <typename WT, int RQ>
__device__ void project_group(const AttnArgs& a, const float* wscale,
                              const float* Os, int g, int b, int q0, int nq,
                              int nb, int ne) {
  const int G = a.H / a.Hkv;
  const WT* wo = (const WT*)a.wo;
  for (int n = nb + threadIdx.x; n < ne; n += ATT_THREADS) {
    for (int rq0 = 0; rq0 < nq; rq0 += RQ) {
      float o[RQ];
#pragma unroll
      for (int i = 0; i < RQ; ++i) o[i] = 0.f;
      for (int hg = 0; hg < G; ++hg) {
        const WT* wcol = wo + (size_t)(g * G + hg) * a.D * a.N + n;
        const float* orow = Os + (hg * a.bq + rq0) * (ATT_DMAX + 1);
        for (int d = 0; d < a.D; ++d) {
          float wv;
          if constexpr (std::is_same<WT, int8_t>::value)
            wv = to_f(wcol[(size_t)d * a.N]) * wscale[n];   // dequantize
          else
            wv = to_f(wcol[(size_t)d * a.N]);
#pragma unroll
          for (int i = 0; i < RQ; ++i) o[i] += orow[i * (ATT_DMAX + 1) + d] * wv;
        }
      }
#pragma unroll
      for (int i = 0; i < RQ; ++i)
        if (rq0 + i < nq)
          a.part[(((size_t)g * a.B + b) * a.Sq + q0 + rq0 + i) * a.N + n] = o[i];
    }
  }
}

template <typename T, bool PAGED, bool STORE_O = false, typename KVT = T,
          typename WT = T, int MODE = kNative>
__global__ void __launch_bounds__(ATT_THREADS)
attn_group_kernel(AttnArgs a, QuantScales qs) {
  constexpr bool kKV8 = std::is_same<KVT, int8_t>::value;
  static_assert(PAGED || !kKV8, "int8 k/v are read from page pools only");
  extern __shared__ float smem[];
  float* Qs = smem;                              // [ROWS][DMAX+1], later O
  float* Ks = Qs + ATT_ROWS * (ATT_DMAX + 1);    // [KV][DMAX+1]
  float* Vs = Ks + ATT_KV * (ATT_DMAX + 1);      // [KV][DMAX]
  float* Ps = Vs + ATT_KV * ATT_DMAX;            // [ROWS][KV+1]
  float* m_s = Ps + ATT_ROWS * (ATT_KV + 1);
  float* l_s = m_s + ATT_ROWS;
  float* c_s = l_s + ATT_ROWS;
  long long* koff = (long long*)(c_s + ATT_ROWS);
  float* ksc = (float*)(koff + ATT_KV);          // KV8: [KV] k scales
  float* vsc = ksc + ATT_KV;                     // KV8: [KV] v scales
  float* tree = ksc + (kKV8 ? 2 * ATT_KV : 0);   // abstract: [ROWS][KV/2]
  float* mnew = tree + ATT_ROWS * (ATT_KV / 2);  // abstract: [ROWS]

  const T* q = (const T*)a.q;
  const KVT* k = (const KVT*)a.k;
  const KVT* v = (const KVT*)a.v;
  const int tid = threadIdx.x;
  const int qt = blockIdx.x / a.nsplit, ns = blockIdx.x % a.nsplit;
  const int g = blockIdx.y, b = blockIdx.z;
  const int G = a.H / a.Hkv, D = a.D;
  const int q0 = qt * a.bq;
  const int nq = min(a.bq, a.Sq - q0);
  const int R = G * a.bq;                        // rows in use

  for (int idx = tid; idx < ATT_ROWS * D; idx += ATT_THREADS) {
    const int r = idx / D, d = idx % D;
    float val = 0.f;
    if (r < R && (r % a.bq) < nq) {
      const int h = g * G + r / a.bq, qi = q0 + r % a.bq;
      val = to_f(q[(((size_t)b * a.H + h) * a.Sq + qi) * D + d]);
    }
    Qs[r * (ATT_DMAX + 1) + d] = val;
  }
  for (int r = tid; r < ATT_ROWS; r += ATT_THREADS) {
    m_s[r] = ATT_NEG_INF;
    l_s[r] = 0.f;
    c_s[r] = 1.f;
  }
  const int p = a.pos != nullptr ? a.pos[b] : 0;
  int kv_end;
  if constexpr (MODE != kNative && !PAGED) {
    kv_end = a.Skv;          // the abstract modes walk every key block
  } else {
    if (a.pos != nullptr)
      kv_end = p < 0 ? (PAGED ? 0 : a.Skv) : min(a.Skv, p + 1);
    else
      kv_end = max(0, min(a.Skv, q0 + nq + a.kv_offset));
  }

  const int sy = tid / 16, sx = tid % 16;   // scores: rows sy*4+i, keys sx+16j
  const int py = tid / 32, px = tid % 32;   // P.V: rows py*8+i, dims px+32j
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  __syncthreads();

  for (int kv0 = 0; kv0 < kv_end; kv0 += ATT_KV) {
    if (tid < ATT_KV) {
      const int c = kv0 + tid;
      long long off = -1;
      if (c < kv_end) {
        if constexpr (PAGED) {
          int page = a.tables[(size_t)b * a.maxp + c / a.ps];
          page = max(min(page, a.P - 1), 0);
          off = (((long long)page * a.Hkv + g) * a.ps + c % a.ps) * D;
          if constexpr (kKV8) {     // the row's scales, same table entry
            ksc[tid] = qs.k[off / D];
            vsc[tid] = qs.v[off / D];
          }
        } else {
          off = (((long long)b * a.Hkv + g) * a.Skv + c) * D;
        }
      }
      koff[tid] = off;
    }
    __syncthreads();
    for (int idx = tid; idx < ATT_KV * D; idx += ATT_THREADS) {
      const int c = idx / D, d = idx % D;
      const long long off = koff[c];
      float kk = 0.f, vv = 0.f;
      if (off >= 0) {
        kk = to_f(k[off + d]);
        vv = to_f(v[off + d]);
        if constexpr (kKV8) {       // dequantize into the f32 tile
          kk *= ksc[c];
          vv *= vsc[c];
        }
      }
      Ks[c * (ATT_DMAX + 1) + d] = kk;
      Vs[c * ATT_DMAX + d] = vv;
    }
    __syncthreads();

    if (sy * 4 < R) {
      float s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
      for (int d = 0; d < D; ++d) {
        float qa[4], kb[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) qa[i] = Qs[(sy * 4 + i) * (ATT_DMAX + 1) + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) kb[j] = Ks[(sx + 16 * j) * (ATT_DMAX + 1) + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] += qa[i] * kb[j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = sy * 4 + i;
        const int qi = q0 + r % a.bq;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = sx + 16 * j, cg = kv0 + c;
          float val = s[i][j] * a.scale;
          if (cg >= a.Skv)
            val = -INFINITY;
          else if (a.pos != nullptr ? cg > p : cg > qi + a.kv_offset)
            val = ATT_NEG_INF;
          Ps[r * (ATT_KV + 1) + c] = val;
        }
      }
    }
    __syncthreads();

    if constexpr (MODE == kAbstract) {
      // online softmax without shuffles: the row max, then the row sum,
      // each a 6-stage halving tree in shared memory over every row
      constexpr int HALF = ATT_KV / 2;
      for (int idx = tid; idx < R * HALF; idx += ATT_THREADS) {
        const int r = idx / HALF, c = idx % HALF;
        const float* row = Ps + r * (ATT_KV + 1);
        tree[r * HALF + c] = fmaxf(row[c], row[c + HALF]);
      }
      __syncthreads();
      for (int w = HALF / 2; w >= 1; w >>= 1) {
        for (int idx = tid; idx < R * w; idx += ATT_THREADS) {
          const int r = idx / w, c = idx % w;
          float* t = tree + r * HALF;
          const float mx = fmaxf(t[c], t[c + w]);
          if (w > 1)
            t[c] = mx;
          else
            mnew[r] = fmaxf(m_s[r], mx);
        }
        __syncthreads();
      }
      for (int idx = tid; idx < R * HALF; idx += ATT_THREADS) {
        const int r = idx / HALF, c = idx % HALF;
        float* row = Ps + r * (ATT_KV + 1);
        const float m_new = mnew[r];
        const float p0 = expf(row[c] - m_new), p1 = expf(row[c + HALF] - m_new);
        row[c] = p0;
        row[c + HALF] = p1;
        tree[r * HALF + c] = p0 + p1;
      }
      __syncthreads();
      for (int w = HALF / 2; w >= 1; w >>= 1) {
        for (int idx = tid; idx < R * w; idx += ATT_THREADS) {
          const int r = idx / w, c = idx % w;
          float* t = tree + r * HALF;
          const float sum = t[c] + t[c + w];
          if (w > 1) {
            t[c] = sum;
          } else {
            const float corr = expf(m_s[r] - mnew[r]);
            l_s[r] = l_s[r] * corr + sum;
            m_s[r] = mnew[r];
            c_s[r] = corr;
          }
        }
        if (w > 1) __syncthreads();
      }
    } else if constexpr (MODE == kAbstractShuffle) {
      // online softmax: one warp per 8 rows, the lane trees of lanes.cuh
      const int w = tid / 32, lane = tid % 32;
      for (int r = w * 8; r < w * 8 + 8 && r < R; ++r) {
        float* row = Ps + r * (ATT_KV + 1);
        const float s0 = row[lane], s1 = row[lane + 32];
        const float mx = lane_tree_reduce<32>(fmaxf(s0, s1), Max());
        const float m_old = m_s[r];
        const float m_new = fmaxf(m_old, mx);
        const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
        row[lane] = p0;
        row[lane + 32] = p1;
        const float sum = lane_tree_reduce<32>(p0 + p1);
        if (lane == 0) {
          const float corr = expf(m_old - m_new);
          l_s[r] = l_s[r] * corr + sum;
          m_s[r] = m_new;
          c_s[r] = corr;
        }
      }
    } else {  // online softmax: one warp per 8 rows
      const int w = tid / 32, lane = tid % 32;
      for (int r = w * 8; r < w * 8 + 8 && r < R; ++r) {
        float* row = Ps + r * (ATT_KV + 1);
        const float s0 = row[lane], s1 = row[lane + 32];
        const float mx = warp_max(fmaxf(s0, s1));
        const float m_old = m_s[r];
        const float m_new = fmaxf(m_old, mx);
        const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
        row[lane] = p0;
        row[lane + 32] = p1;
        const float sum = warp_sum(p0 + p1);
        if (lane == 0) {
          const float corr = expf(m_old - m_new);
          l_s[r] = l_s[r] * corr + sum;
          m_s[r] = m_new;
          c_s[r] = corr;
        }
      }
    }
    __syncthreads();

    if (py * 8 < R) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float corr = c_s[py * 8 + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] *= corr;
      }
      for (int c = 0; c < ATT_KV; ++c) {
        float vv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int d = px + 32 * j;
          vv[j] = d < D ? Vs[c * ATT_DMAX + d] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float pr = Ps[(py * 8 + i) * (ATT_KV + 1) + c];
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] += pr * vv[j];
        }
      }
    }
    __syncthreads();
  }

  if constexpr (STORE_O) {
    // O = acc / l (l == 0 -> 1) straight to [B, H, Sq, D]
    if (py * 8 < R) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = py * 8 + i;
        if (r >= R || r % a.bq >= nq) continue;
        float l = l_s[r];
        l = l == 0.f ? 1.f : l;
        T* orow = (T*)a.o + (((size_t)b * a.H + g * G + r / a.bq) * a.Sq +
                             q0 + r % a.bq) * D;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int d = px + 32 * j;
          if (d < D) orow[d] = from_f<T>(acc[i][j] / l);
        }
      }
    }
    return;
  }

  // O = acc / l (l == 0 -> 1), rounded to the working dtype, into Qs
  if (py * 8 < R) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = py * 8 + i;
      if (r >= R) continue;
      float l = l_s[r];
      l = l == 0.f ? 1.f : l;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int d = px + 32 * j;
        if (d < D) Qs[r * (ATT_DMAX + 1) + d] = round_to<T>(acc[i][j] / l);
      }
    }
  }
  __syncthreads();

  const int n_per = (a.N + a.nsplit - 1) / a.nsplit;
  const int nb = ns * n_per, ne = min(a.N, nb + n_per);
  if (a.bq == 1)
    project_group<WT, 1>(a, qs.w, Qs, g, b, q0, nq, nb, ne);
  else
    project_group<WT, 16>(a, qs.w, Qs, g, b, q0, nq, nb, ne);
}

// out[b, s, n] = sum over kv groups, in group order, of the partials
template <typename T>
__global__ void group_sum_kernel(const float* __restrict__ part, int Hkv,
                                 size_t bsn, T* __restrict__ out) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= bsn) return;
  float s = 0.f;
  for (int g = 0; g < Hkv; ++g) s += part[(size_t)g * bsn + i];
  out[i] = from_f<T>(s);
}

template <typename T, bool PAGED, typename KVT = T, typename WT = T,
          int MODE = kNative>
cudaError_t launch_attention_matmul(const AttnArgs& a, void* out,
                                    cudaStream_t st,
                                    const QuantScales& qs = QuantScales()) {
  constexpr bool kv8 = std::is_same<KVT, int8_t>::value;
  if ((std::is_same<WT, int8_t>::value && qs.w == nullptr) ||
      (kv8 && (qs.k == nullptr || qs.v == nullptr)))
    return cudaErrorInvalidValue;
  const size_t smem = attn_smem_bytes(kv8, MODE == kAbstract);
  cudaError_t err = cudaFuncSetAttribute(
      attn_group_kernel<T, PAGED, false, KVT, WT, MODE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(((a.Sq + a.bq - 1) / a.bq) * a.nsplit, a.Hkv, a.B);
  attn_group_kernel<T, PAGED, false, KVT, WT, MODE>
      <<<grid, ATT_THREADS, smem, st>>>(a, qs);
  const size_t bsn = (size_t)a.B * a.Sq * a.N;
  group_sum_kernel<T><<<(unsigned)((bsn + 255) / 256), 256, 0, st>>>(
      a.part, a.Hkv, bsn, (T*)out);
  return cudaGetLastError();
}

// flash_attention: one block per (query tile, kv group, batch), O stored by
// the epilogue; no partials, no second pass.  MODE as in the attention +
// wo kernels: the softmax's cross-lane stages and the key walk (every key
// block outside native), the abstract tree's tile in shared memory.
template <typename T, int MODE = kNative>
cudaError_t launch_flash_attention(const AttnArgs& a, cudaStream_t st) {
  const size_t smem = attn_smem_bytes(false, MODE == kAbstract);
  cudaError_t err = cudaFuncSetAttribute(
      attn_group_kernel<T, false, true, T, T, MODE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.Sq + a.bq - 1) / a.bq, a.Hkv, a.B);
  attn_group_kernel<T, false, true, T, T, MODE>
      <<<grid, ATT_THREADS, smem, st>>>(a, QuantScales());
  return cudaGetLastError();
}

}  // namespace uisa

// Prefill attention on tensor cores: O = softmax(q k^T / sqrt(D)) v in
// bf16, for D of 64 or 128.  Two callers, told apart by the kernel's O
// layout (HEAD_MAJOR):
//  - the bf16 prefill path of flash_attention_matmul
//    (flash_attention_matmul.cu) stores O as [B, Sq, H*D], the A operand
//    of tc_gemm.cuh's out = O @ wo (bf16 or int8 wo).  Together they
//    replace kernels/fused.py::flash_attention_matmul of the JAX package
//    (its body _flash_matmul_kernel over kernels/attention.py::
//    _flash_kernel) at its causal shape;
//  - plain flash attention (flash_attention.cu) stores O as [B, H, Sq, D]
//    (HEAD_MAJOR), replacing kernels/attention.py::flash_attention of the
//    JAX package (its _flash_kernel), causal or not (a non-causal call
//    arrives with kv_offset = Skv).
// Only the epilogue's row address differs between the two.  The `pos` and
// paged shapes, f32 and other head widths keep attention_core.cuh's
// kernel.
//
// Bound on Hopper: operations.  At 512 tokens and 32/8 heads of 128 the
// attention is 2.2 of the row's 19.3 GFLOP (11%); the wo product is the
// rest, on wgmma in tc_gemm.  For the attention part mma.sync.m16n8k16
// (bf16 in, f32 sums) is enough here; wgmma for it is later work.  Plain
// flash attention at granite-moe's 512 tokens (24/8 heads of 64) is bound
// by neither: 0.81 GFLOP (0.8 us at the bf16 peak) and 4.2 MB (1.25 us);
// its 25 query tiles x 8 groups make 200 blocks of 4 warps on 132 SMs,
// and the causal walk gives the last tiles 8 key tiles to the first's 1.
//
// Design (FlashAttention-2's register softmax):
//  - one block of 4 warps per (query tile, kv group, batch).  The group's
//    G = H / Hkv query heads fold into the block's 64 rows (row = head in
//    group x bq + query; bq = 64 / G: 16 at G = 4, 21 at G = 3), as in
//    attention_core.cuh, so each K/V tile is read once per group and query
//    tile, never once per head;
//  - each warp owns 16 rows.  Its Q fragments stay in registers (ldmatrix
//    once); S = Q K^T and O += P V are mma.sync; the online softmax runs on
//    the S accumulators in registers, where each row's 64 scores of a tile
//    sit in the 4 lanes of an mma quad; P is rounded to bf16 and packed
//    from the S registers straight into the A fragments of P V (the
//    accumulator layout of m16n8 is the A layout of k16 two tiles at a
//    time);
//  - K and V tiles of 64 keys stay bf16 in shared memory, each row's
//    16-byte chunks swizzled by row % 8 so that ldmatrix (.trans for V) is
//    free of bank conflicts, loaded with cp.async and double-buffered: the
//    next tile loads while this one is computed;
//  - masks as attention_core.cuh: keys past the diagonal (c > i +
//    kv_offset) score -1e30, keys past Skv -inf over zero-filled K and V
//    rows (P = 0 must not meet garbage V), the running max starts at
//    -1e30 so no -inf - -inf arises, and a row with no visible key
//    divides by l = 1;
//  - the epilogue stores O = acc / l rounded to bf16, the rounding the
//    plain version applies before wo: no f32 partials, no group sum, no
//    atomics, and tc_gemm's product is deterministic.  The workspace is
//    B x Sq x H x D bf16 (4 MB at 512 tokens, against 64 MiB of f32
//    partials on attention_core.cuh's route).
//  - The sum l adds the f32 probabilities; P V reads them rounded to bf16,
//    which attention_core.cuh's f32 tiles never did (the f32 forms and the
//    plain versions keep their arithmetic).
//
// MODE, as in the JAX package (attention.py::_row_reduce, and the `skip`
// flag of fused.py::_flash_matmul_kernel): the products and the wo GEMM
// are the same in every mode; only two things change:
//  - the row max and row sum over the 4 lanes of a quad: native by two
//    __shfl_xor_sync; abstract+shuffle by lanes.cuh::lane_tree_reduce<4>;
//    abstract with no shuffle, the lanes' partials staged through shared
//    memory in a halving tree, one barrier per stage
//    (lanes.cuh::row_scratch_tree_reduce<4>);
//  - the key walk: native stops at the diagonal, the abstract modes visit
//    every key tile (masked).
#pragma once
#include "attention_core.cuh"
#include "mma_sync.cuh"
#include "tc_gemm.cuh"

namespace uisa {

constexpr int TCA_THREADS = 128;     // 4 warps x 16 rows = ATT_ROWS

// Q [ROWS][D], K and V [2][KV][D] bf16; the abstract trees' scratch: row max
// and row sum for the rows g and g + 8 of each quad, [4][THREADS] f32
template <int D>
constexpr size_t attn_tc_smem() {
  return sizeof(__nv_bfloat16) * (ATT_ROWS * D + 4 * ATT_KV * D) +
         sizeof(float) * 4 * TCA_THREADS;
}

// a row's reduction over the 4 lanes of its quad, in MODE's cross-lane
// stage; `scratch` ([THREADS] f32) serves the abstract tree, which every
// thread of the block must enter
template <int MODE, typename Op>
__device__ __forceinline__ float quad_reduce(float v, float* scratch, Op op) {
  if constexpr (MODE == kAbstract) {
    return row_scratch_tree_reduce<4>(v, scratch, op);
  } else if constexpr (MODE == kAbstractShuffle) {
    return lane_tree_reduce<4>(v, op);
  } else {
    v = op(v, __shfl_xor_sync(kFullMask, v, 1));
    return op(v, __shfl_xor_sync(kFullMask, v, 2));
  }
}

// HEAD_MAJOR: O [B, H, Sq, D]; else [B, Sq, H*D] (the default, whose code
// is the kernel's before it had this argument)
template <int D, int MODE, bool HEAD_MAJOR = false>
__global__ void __launch_bounds__(TCA_THREADS)
attn_tc_kernel(AttnArgs a) {
  using bf16 = __nv_bfloat16;
  constexpr int CH = D / 8;                  // 16-byte chunks a row
  extern __shared__ __align__(16) uint8_t tca_smem[];
  bf16* Qs = (bf16*)tca_smem;                // [ROWS][D]
  bf16* Ks = Qs + ATT_ROWS * D;              // [2][KV][D]
  bf16* Vs = Ks + 2 * ATT_KV * D;            // [2][KV][D]
  float* tree = (float*)(Vs + 2 * ATT_KV * D);

  const bf16* q = (const bf16*)a.q;
  const bf16* k = (const bf16*)a.k;
  const bf16* v = (const bf16*)a.v;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int qr = lane / 4, qc = lane % 4;    // the lane's quad row, column
  const int g = blockIdx.y, b = blockIdx.z;
  const int G = a.H / a.Hkv, q0 = blockIdx.x * a.bq;
  const int nq = min(a.bq, a.Sq - q0), R = G * a.bq;

  // the block's rows (head in group, query) of q; dead rows are zeros
  for (int idx = tid; idx < ATT_ROWS * CH; idx += TCA_THREADS) {
    const int r = idx / CH, c = idx % CH;
    const bool ok = r < R && r % a.bq < nq;
    const bf16* src = q;
    if (ok)
      src = q + (((size_t)b * a.H + g * G + r / a.bq) * a.Sq + q0 +
                 r % a.bq) * D + c * 8;
    cp_async16(Qs + swz<D>(r, c * 8), src, ok);
  }
  cp_async_commit();

  int kv_end = a.Skv;                        // the abstract modes: every key
  if constexpr (MODE == kNative)
    kv_end = max(0, min(a.Skv, q0 + nq + a.kv_offset));
  const int tiles = (kv_end + ATT_KV - 1) / ATT_KV;
  const size_t kv_rows = ((size_t)b * a.Hkv + g) * a.Skv;
  auto load_kv = [&](int t, int buf) {
    const int kv0 = t * ATT_KV;
    for (int idx = tid; idx < ATT_KV * CH; idx += TCA_THREADS) {
      const int r = idx / CH, c = idx % CH;
      const bool ok = kv0 + r < a.Skv;
      const size_t off = ok ? (kv_rows + kv0 + r) * D + c * 8 : 0;
      cp_async16(Ks + buf * ATT_KV * D + swz<D>(r, c * 8), k + off, ok);
      cp_async16(Vs + buf * ATT_KV * D + swz<D>(r, c * 8), v + off, ok);
    }
    cp_async_commit();
  };
  if (tiles > 0) load_kv(0, 0);
  cp_async_wait<0>();
  __syncthreads();

  // ldmatrix.x4 lane addresses: matrix lane / 8, its row lane % 8
  const int mat = lane >> 3, mrow = lane & 7;
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldsm_x4(qf[kk], Qs + swz<D>(warp * 16 + mrow + (mat & 1) * 8,
                                kk * 16 + (mat >> 1) * 8));

  int qi[2];                                 // rows r and r + 8 of the quad
#pragma unroll
  for (int i = 0; i < 2; ++i) qi[i] = q0 + (warp * 16 + qr + 8 * i) % a.bq;
  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m_run[2] = {ATT_NEG_INF, ATT_NEG_INF}, l_run[2] = {0.f, 0.f};

  for (int t = 0; t < tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < tiles) {
      load_kv(t + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Kt = Ks + buf * ATT_KV * D;
    const bf16* Vt = Vs + buf * ATT_KV * D;

    // S = Q K^T: keys 16 jp .. 16 jp + 15 are two n8 tiles
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t kb[4];
        ldsm_x4(kb, Kt + swz<D>(16 * jp + mrow + (mat >> 1) * 8,
                                kk * 16 + (mat & 1) * 8));
        mma_bf16(s[2 * jp], qf[kk], kb[0], kb[1]);
        mma_bf16(s[2 * jp + 1], qf[kk], kb[2], kb[3]);
      }

    // scale and mask; s[j][e] is row qr + 8 (e / 2), key 8 j + 2 qc + e % 2
    const int kv0 = t * ATT_KV;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = kv0 + 8 * j + 2 * qc + (e & 1);
        float val = s[j][e] * a.scale;
        if (c >= a.Skv)
          val = -INFINITY;
        else if (c > qi[e >> 1] + a.kv_offset)
          val = ATT_NEG_INF;
        s[j][e] = val;
        mx[e >> 1] = fmaxf(mx[e >> 1], val);
      }
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(
          m_run[i], quad_reduce<MODE>(mx[i], tree + i * TCA_THREADS, Max()));
      corr[i] = __expf(m_run[i] - m_new);
      m_run[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = __expf(s[j][e] - m_run[e >> 1]);
        sum[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i)
      l_run[i] = l_run[i] * corr[i] +
                 quad_reduce<MODE>(sum[i], tree + (2 + i) * TCA_THREADS, Add());
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] *= corr[e >> 1];

    // O += P V: P's k16 step kk is the S tiles 2 kk, 2 kk + 1, in bf16
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int jp = 0; jp < D / 16; ++jp) {
        uint32_t vb[4];
        ldsm_x4_trans(vb, Vt + swz<D>(16 * kk + mrow + (mat & 1) * 8,
                                      (2 * jp + (mat >> 1)) * 8));
        mma_bf16(o[2 * jp], pa, vb[0], vb[1]);
        mma_bf16(o[2 * jp + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();     // the next iteration's prefetch refills this buffer
  }

  // O = acc / l (l == 0 -> 1) in bf16 to [B, Sq, H*D] or [B, H, Sq, D]
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * 16 + qr + 8 * i;
    if (r >= R || r % a.bq >= nq) continue;
    const float l = l_run[i] == 0.f ? 1.f : l_run[i];
    bf16* orow =
        (bf16*)a.o +
        (HEAD_MAJOR
             ? (((size_t)b * a.H + g * G + r / a.bq) * a.Sq + qi[i]) * D
             : (((size_t)b * a.Sq + qi[i]) * a.H + g * G + r / a.bq) * D);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *(__nv_bfloat162*)(orow + 8 * j + 2 * qc) =
          __floats2bfloat162_rn(o[j][2 * i] / l, o[j][2 * i + 1] / l);
  }
}

template <int D, int MODE, bool HEAD_MAJOR = false>
cudaError_t launch_attn_tc(const AttnArgs& a, cudaStream_t st) {
  constexpr size_t smem = attn_tc_smem<D>();
  const cudaError_t err = cudaFuncSetAttribute(
      attn_tc_kernel<D, MODE, HEAD_MAJOR>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sq + a.bq - 1) / a.bq, a.Hkv, a.B);
  attn_tc_kernel<D, MODE, HEAD_MAJOR><<<grid, TCA_THREADS, smem, st>>>(a);
  return cudaGetLastError();
}

}  // namespace uisa

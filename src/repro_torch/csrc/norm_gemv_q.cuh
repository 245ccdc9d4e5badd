// The strip form of the decode GEMV for a bf16 W [K, N] that the int8 twin
// quantizes per call (norm_gemv.cuh's item 5: granite-8b's bf16 lm_head
// under the int8 policy, [4096, 49152]), and the dispatch of every float W
// quantized in the stream read [K, N].
//
// Replaces, at decode, the JAX package's kernels/fused.py::rmsnorm_matmul_q8
// with w_scale=None (kernels/fused.py:1440: quantize_weight inside the
// jitted op, then the int8 kernel).  Bound on Hopper: the bf16 weight's
// bytes, once (402.7 MB, 120.2 us at 3.35 TB/s).  The two passes of
// norm_gemv.cuh (q8_scales_kernel, then the GEMV quantizing in its stream)
// read W from DRAM twice; here a block walks a column strip twice, the
// second time mostly from L2.  Included by rmsnorm_matmul.cu
// alone, so the other libraries' kernels compile as before.
#pragma once
#include "norm_gemv.cuh"

namespace uisa {

// ---------------------------------------------------------------------------
// the strip form of a bf16 W quantized in the stream: one read from DRAM
// ---------------------------------------------------------------------------

// A persistent block (one an SM) owns a strip of 64 columns of W [K, N]
// (one TMA box wide, norm_gemv_mma_kernel's box) over all of K at a time,
// its 8 warps a K chunk each (k_warp rows, a multiple of SR), and walks the
// strip twice through each warp's ring:
//  - pass 0 keeps each lane's two columns' max |w| (integer bits, two bf16
//    halves), folded over the warps into the strip's 64 scales and their
//    reciprocals in shared memory (IEEE division, as q8_scales_kernel);
//  - pass 1 walks each chunk's boxes backwards (the boxes pass 0 read last
//    come first, while L2 still holds them), quantizes each fragment by
//    gemv_quant_pair and runs norm_gemv_mma_kernel's products;
//  - the warps' f32 sums are added in warp order and scaled.
// The strips of one wave hold 512 KB of W each (granite-8b's head: 67 MB
// against the 50 MB L2), so much of pass 1 comes from L2 and W streams
// from DRAM about once.  Loads run ahead across the passes and the strips
// (a warp's job j: strip j / 2 nst, pass j / nst % 2, box j % nst).  x_n is
// read after griddepcontrol.wait, so the first strip's pass 0 overlaps
// gemv_rows_kernel.  No cross-lane stage: the same kernel in every mode.
constexpr int QSTRIP_COLS = GemvMma<__nv_bfloat16, false>::WCOLS;

__global__ void __launch_bounds__(GEMV_THREADS, 1)
norm_gemv_qstrip_kernel(const __grid_constant__ CUtensorMap map,
                        const __nv_bfloat16* __restrict__ xn, int M, int K,
                        int N, int k_warp, __nv_bfloat16* __restrict__ out) {
  using G = GemvMma<__nv_bfloat16, false>;
  constexpr int SR = G::SR, STAGES = G::STAGES, BOX = G::BOX_BYTES;
  constexpr int ROWB = G::ROW_BYTES, GROUPS = G::GROUPS, WARPS = G::WARPS;
  constexpr int C = QSTRIP_COLS, ROWS = G::ROWS;
  extern __shared__ __align__(16) uint8_t qstrip_smem[];
  __shared__ __align__(8) uint64_t full[WARPS][STAGES];
  __shared__ uint32_t red[WARPS][32];
  __shared__ float sc[C], rc[C];
  uint8_t* ring =
      qstrip_smem + ((1024 - (smem_u32(qstrip_smem) & 1023)) & 1023);
  float* res = (float*)(ring + WARPS * STAGES * BOX);   // [WARPS][ROWS][C]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int kb = warp * k_warp, len = max(0, min(K - kb, k_warp));
  const int nst = (len + SR - 1) / SR;
  const int strips = (N + C - 1) / C;
  const int mine = (int)blockIdx.x < strips
                       ? (strips - 1 - (int)blockIdx.x) / (int)gridDim.x + 1
                       : 0;
  const int jobs = 2 * nst * mine;
  uint8_t* wring = ring + warp * STAGES * BOX;
  uint64_t* bar = full[warp];
  if (lane == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(&bar[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();
  // job j's box: pass 0 walks the chunk forwards, pass 1 backwards
  auto box_k = [&](int j) {
    const int i = j % nst;
    return kb + ((j / nst) % 2 ? nst - 1 - i : i) * SR;
  };
  auto load = [&](int j) {
    mbar_expect_tx(&bar[j % STAGES], BOX);
    tma_load_2d(wring + (j % STAGES) * BOX, &map, &bar[j % STAGES],
                ((int)blockIdx.x + j / (2 * nst) * (int)gridDim.x) * C,
                box_k(j));
  };
  if (lane == 0)
    for (int s = 0; s < STAGES && s < jobs; ++s) load(s);
  auto next = [&](int j) {            // the warp is done with job j's slot
    __syncwarp();
    if (lane == 0 && j + STAGES < jobs) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      load(j + STAGES);
    }
  };
  // x_n's fragments of job j's box (rows gid, gid + 8), zeros past M and K
  const bool rows16 = M > 8;
  auto x_frags = [&](int j, bool on, uint32_t (&b)[SR / 16][2][2]) {
    const int k0 = on ? box_k(j) : 0;
#pragma unroll
    for (int t = 0; t < SR / 16; ++t) {
      const int k = k0 + t * 16 + tig * 2;
#pragma unroll
      for (int rg = 0; rg < 2; ++rg) {
        const bool use = on && (rg == 0 || rows16);
        b[t][rg][0] = use ? gemv_x_pair(xn, M, K, rg * 8 + gid, k) : 0u;
        b[t][rg][1] = use ? gemv_x_pair(xn, M, K, rg * 8 + gid, k + 8) : 0u;
      }
    }
  };

  int j = 0;
  for (int it = 0; it < mine; ++it) {
    const int n0 = ((int)blockIdx.x + it * (int)gridDim.x) * C;
    // pass 0: lane l keeps columns 2 l, 2 l + 1 (chunk l / 4 of a 128-byte
    // row, at chunk ^ row % 8: one bank a lane)
    uint32_t m = 0u;
    for (int i = 0; i < nst; ++i, ++j) {
      mbar_wait(&bar[j % STAGES], (j / STAGES) & 1);
      const uint8_t* box = wring + (j % STAGES) * BOX + (lane & 3) * 4;
#pragma unroll 8
      for (int r = 0; r < SR; ++r)
        m = __vmaxu2(m, *(const uint32_t*)(box + r * ROWB +
                                           (((lane >> 2) ^ (r & 7)) << 4)) &
                            0x7fff7fffu);
      next(j);
    }
    red[warp][lane] = m;
    __syncthreads();
    if (tid < C) {
      uint32_t a = 0u;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) a = __vmaxu2(a, red[w][tid >> 1]);
      a = tid & 1 ? a & 0xffff0000u : a << 16;
      const float s = fmaxf(__fdiv_rn(__uint_as_float(a), 127.f), 1e-8f);
      sc[tid] = s;
      rc[tid] = __frcp_rn(s);
    }
    asm volatile("griddepcontrol.wait;" ::: "memory");   // x_n is written
    __syncthreads();
    float qs[GROUPS][2], qy[GROUPS][2];
#pragma unroll
    for (int g = 0; g < GROUPS; ++g)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        qs[g][h] = sc[16 * g + gid + 8 * h];
        qy[g][h] = rc[16 * g + gid + 8 * h];
      }
    float acc[2][GROUPS][4];
#pragma unroll
    for (int rg = 0; rg < 2; ++rg)
#pragma unroll
      for (int g = 0; g < GROUPS; ++g)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[rg][g][e] = 0.f;
    // pass 1: the products, as norm_gemv_mma_kernel's bf16 form
    uint32_t b[SR / 16][2][2], bn[SR / 16][2][2];
    x_frags(j, nst > 0, b);
    for (int i = 0; i < nst; ++i, ++j) {
      x_frags(j + 1, i + 1 < nst, bn);     // the next box's, in flight now
      mbar_wait(&bar[j % STAGES], (j / STAGES) & 1);
      const uint8_t* box = wring + (j % STAGES) * BOX;
      const int mat = lane >> 3;
#pragma unroll
      for (int t = 0; t < SR / 16; ++t) {
        const int r = t * 16 + (lane & 7) + (mat >> 1) * 8;
#pragma unroll
        for (int g = 0; g < GROUPS; ++g) {
          const int chunk = 2 * g + (mat & 1);
          uint32_t a[4];
          gemv_ldsm_x4_trans(
              a, smem_u32(box + r * ROWB + ((chunk ^ (r & 7)) << 4)));
#pragma unroll
          for (int q = 0; q < 4; ++q)
            a[q] = gemv_quant_pair(a[q], qs[g][q & 1], qy[g][q & 1]);
          gemv_mma(acc[0][g], a, b[t][0][0], b[t][0][1]);
          if (rows16) gemv_mma(acc[1][g], a, b[t][1][0], b[t][1][1]);
        }
      }
      next(j);
#pragma unroll
      for (int t = 0; t < SR / 16; ++t)
#pragma unroll
        for (int rg = 0; rg < 2; ++rg) {
          b[t][rg][0] = bn[t][rg][0];
          b[t][rg][1] = bn[t][rg][1];
        }
    }
    // d[rg][g] = (W columns 16 g + gid, + 8) x (x_n rows 2 tig, 2 tig + 1
    // of group rg)
#pragma unroll
    for (int rg = 0; rg < 2; ++rg)
#pragma unroll
      for (int g = 0; g < GROUPS; ++g)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          res[(warp * ROWS + rg * 8 + tig * 2 + (e & 1)) * C + 16 * g + gid +
              8 * (e >> 1)] = acc[rg][g][e];
    __syncthreads();
    for (int o = tid; o < M * C; o += GEMV_THREADS) {
      const int row = o / C, c = o % C;
      if (n0 + c >= N) continue;
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) s += res[(w * ROWS + row) * C + c];
      out[(size_t)row * N + n0 + c] = __float2bfloat16(s * sc[c]);
    }
    __syncthreads();                  // res, sc and red serve the next strip
  }
}

// Whether a bf16 W [K, N] quantized in the stream takes the strip kernel:
// a strip for every SM at least (granite-8b's head: 768 strips); a
// narrower head takes the two passes (q8_scales_kernel, then
// norm_gemv_mma_kernel, whose K split fills the card).
inline bool qstrip_route(int N, int sms) {
  return (N + QSTRIP_COLS - 1) / QSTRIP_COLS >= sms;
}

// gemv_rows_kernel, then norm_gemv_qstrip_kernel as its programmatic
// dependent, a block an SM, over the workspace `ws` (x_n alone).
template <int MODE>
cudaError_t launch_norm_gemv_qstrip(const void* x, const void* w,
                                    const void* W, void* out, void* ws, int M,
                                    int K, int N, float eps, int sms,
                                    cudaStream_t st) {
  using bf16 = __nv_bfloat16;
  using G = GemvMma<bf16, false>;
  if (!gemv_route<bf16>(M, N, W) || K < 1 || !qstrip_route(N, sms))
    return cudaErrorInvalidValue;
  CUtensorMap map;
  if (!gemv_map<bf16, false>(&map, W, K, N)) return cudaErrorInvalidValue;
  const int row_smem = 2 * ((K + 7) / 8 * 8) * (int)sizeof(bf16);
  cudaError_t err = cudaFuncSetAttribute(
      gemv_rows_kernel<bf16, MODE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, row_smem);
  if (err != cudaSuccess) return err;
  gemv_rows_kernel<bf16, MODE><<<M, INV_RMS_THREADS, row_smem, st>>>(
      (const bf16*)x, (const bf16*)w, K, eps, (bf16*)ws, nullptr, 0);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int per = (K + G::WARPS - 1) / G::WARPS;
  const int k_warp = (per + G::SR - 1) / G::SR * G::SR;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(sms);
  cfg.blockDim = dim3(GEMV_THREADS);
  cfg.dynamicSmemBytes =
      1024 + G::RING + (size_t)G::WARPS * G::ROWS * QSTRIP_COLS * 4;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaFuncSetAttribute(norm_gemv_qstrip_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)cfg.dynamicSmemBytes);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&cfg, norm_gemv_qstrip_kernel, map,
                           (const bf16*)ws, M, K, N, k_warp, (bf16*)out);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The float W quantized in the stream (QF), at the activations' dtype: its
// workspace (the strip kernel: x_n alone; else plan_gemv_q's words, then
// the [N] scales) and its launch.
inline long long gemv_q_workspace(int dtype, int M, int K, int N, int sms) {
  if (dtype == kBF16 && qstrip_route(N, sms))
    return gemv_align4(((long long)M * K * 2 + 3) / 4);
  const GemvPlan p = dtype == kBF16
                         ? plan_gemv_q<__nv_bfloat16>(M, K, N, sms)
                         : plan_gemv_q<float>(M, K, N, sms);
  return p.words() + gemv_align4(N);
}

template <int MODE>
inline cudaError_t launch_gemv_q_mode(int dtype, const void* x, const void* w,
                                      const void* W, void* out, void* ws,
                                      int M, int K, int N, float eps, int sms,
                                      cudaStream_t st) {
  using bf16 = __nv_bfloat16;
  if (dtype == kBF16 && qstrip_route(N, sms))
    return launch_norm_gemv_qstrip<MODE>(x, w, W, out, ws, M, K, N, eps, sms,
                                         st);
  if (dtype == kBF16)
    return launch_norm_gemv<bf16, bf16, false, MODE, true>(
        x, w, W, nullptr, out, ws, M, K, N, eps, sms, st);
  return launch_norm_gemv<float, float, false, MODE, true>(
      x, w, W, nullptr, out, ws, M, K, N, eps, sms, st);
}

inline cudaError_t launch_gemv_q(int mode, int dtype, const void* x,
                                 const void* w, const void* W, void* out,
                                 void* ws, int M, int K, int N, float eps,
                                 int sms, cudaStream_t st) {
  if (mode == kAbstract)
    return launch_gemv_q_mode<kAbstract>(dtype, x, w, W, out, ws, M, K, N,
                                         eps, sms, st);
  if (mode == kAbstractShuffle)
    return launch_gemv_q_mode<kAbstractShuffle>(dtype, x, w, W, out, ws, M,
                                                K, N, eps, sms, st);
  return launch_gemv_q_mode<kNative>(dtype, x, w, W, out, ws, M, K, N, eps,
                                     sms, st);
}

}  // namespace uisa

// The chunked Mamba2 SSD scan in one kernel, on one of two routes that the
// C entry decides (scan_tc_route) and reports through its last argument
// (kernels/_launch.py::ROUTES): "tc", ssd_scan_tc.cu's kernel on the
// tensor cores, for bf16 x, B and C with N and P multiples of 16 and every
// row base and stride 16-byte aligned (mamba2's prefill, the model's
// slices of its projection); "fma", the kernel below, for everything else
// (f32, widths off the 16-grid, unaligned operands).  Neither falls back on
// the other.  The notes below are the fma kernel's.
//
// Replaces kernels/ssd.py::fused_ssd_scan of the JAX package (the Pallas
// kernel _ssd_scan_kernel and its _prefix_sum).  Per (batch, head), with the
// sequence cut into chunks of Q positions and a carried [N,P] f32 state h:
//
//   ld     = inclusive cumsum over the chunk of dt*A            (<= 0)
//   y[t]   = sum_{s<=t} exp(ld_t - ld_s) (C_t . B_s) dt_s x_s   (intra-chunk)
//          + exp(ld_t) C_t . h                                  (carried state)
//   h     <- exp(ld_last) h + sum_s B_s (dt_s exp(ld_last - ld_s)) x_s^T
//
// What bounds it on the H100: at prefill (B=1, L=512, H=80, P=64, N=128,
// Q=256) the function moves about 13.5 MB (4 us at 3.35 TB/s) and needs
// about 1.7 GFLOP of causal products (C.B^T once per group), so bytes
// bound it.  This first kernel runs its products on the f32 FMA units and
// recomputes C.B^T per head, so FMA issue and shared-memory reads inside
// 80 blocks bound it instead, far above the bound (PERF.md has its times).
//
// Design:
// - Carry order.  The TPU carries h across a sequential grid axis; blocks on
//   Hopper run in no order, so one block per (batch, head) loops over the
//   chunks itself and keeps h in shared memory (N*P*4 = 32 KB).  At B=1 that
//   is 80 blocks on 132 SMs; splitting P over two blocks would fill more SMs
//   at the price of computing C.B^T twice, and is left for later.
// - The [Q,Q] score tile (256 KB in f32 at Q=256) does not fit: target rows
//   and source rows go in tiles of 64; a 64x64 weight tile lives in shared
//   memory, C, B and x tiles are staged per tile.  About 139 KB of dynamic
//   shared memory at N=128, P=64 (cudaFuncSetAttribute raises the limit).
// - The prefix scan ld = cumsum(dt*A) is the scan's one cross-lane stage,
//   and the only code that changes with MODE (kernels/_launch.py::
//   MODE_CODES), as in the JAX package's _prefix_sum:
//   native: a warp inclusive scan with __shfl_up_sync plus the per-warp
//     totals through shared memory: 256 threads cover Q <= 256;
//   abstract: lanes.cuh::scratch_inclusive_scan over the block's 256
//     threads, the Hillis-Steele stages through shared memory (the wsv row
//     is the scratch, so the shared memory does not grow): 8 stores and
//     reloads, 16 barriers a chunk;
//   abstract+shuffle: no shared-memory round trip inside the scan.  A warp
//     spans 32 positions and the chunk 256, so one warp scans the whole
//     chunk: lane l holds positions 8l..8l+7 and sums them serially in
//     registers, lanes.cuh::lane_inclusive_scan (5 __shfl_sync stages)
//     scans the 32 lane totals, and a shuffle up by one lane hands each
//     lane the total before it.  The other seven warps wait at the barrier
//     that publishes ld, which native has too.
// - Masking happens before exp: above the diagonal ld_t - ld_s is positive
//   and can overflow, so those weights are set to 0 without calling exp.
// - y reads h before this chunk's update; the update follows a barrier.
// - Positions past the chunk or past L load as x = B = C = dt = 0 (the JAX
//   kernel's zero padding): a zero dt kills their contribution and leaves
//   ld flat, and nothing past L is written to y.  Tiles wholly past L are
//   skipped.
// - The optional initial state seeds h (zeros without it); the final h is
//   written once, in f32.
//
// Every product accumulates in f32; y is rounded once to the input dtype.
#include "common.cuh"
#include "lanes.cuh"
#include "ssd_scan.cuh"

namespace uisa {

constexpr int kTile = 64;        // target / source rows per tile
constexpr int kTileStr = kTile + 4;  // row stride of the transposed tiles

__host__ __device__ inline int round4(int v) { return (v + 3) & ~3; }

// floats of dynamic shared memory for (N, P)
__host__ __device__ inline int scan_smem_floats(int N, int P) {
  const int ns = round4(N), ps = round4(P);
  return ns * ps                  // h [N][P]
         + ns * kTileStr          // C tile, transposed [N][t]
         + ns * kTileStr + 8      // B tile: [N][s] or [s][N]
         + kTile * ps             // x tile [s][P]
         + kTile * kTileStr       // weight tile, transposed [s][t]
         + 3 * kScanQMax          // dt, ld, wS
         + 8;                     // per-warp scan totals
}

// rows [r0, r0 + 64) of a chunk starting at position `base` of an operand
// with row stride `sl`: `width` contiguous values per row into shared
// memory (transposed or not), zeros past the chunk (q) or past L
template <typename T, bool kTransposed>
__device__ void load_tile(float* dst, int dst_str, const T* src, long long sl,
                          int base, int r0, int q, int L, int width) {
  for (int e = threadIdx.x; e < kTile * width; e += kScanThreads) {
    const int r = e / width, c = e - r * width;
    const int t = r0 + r;
    float v = 0.f;
    if (t < q && base + t < L) v = to_f(src[(long long)(base + t) * sl + c]);
    if (kTransposed) dst[c * dst_str + r] = v;
    else dst[r * dst_str + c] = v;
  }
}

template <typename T, int MODE>
__global__ void __launch_bounds__(kScanThreads)
ssd_scan_kernel(ScanArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int N = a.N, P = a.P, Q = a.Q, L = a.L;
  const int ns = round4(N), ps = round4(P);
  float* hs = smem;                         // [ns][ps]
  float* ct = hs + ns * ps;                 // [ns][kTileStr]
  float* bt = ct + ns * kTileStr;           // [ns][kTileStr] or [64][ns]
  float* xs = bt + ns * kTileStr + 8;       // [64][ps]
  float* ws = xs + kTile * ps;              // [64][kTileStr]
  float* dts = ws + kTile * kTileStr;       // [QMax]
  float* ld = dts + kScanQMax;              // [QMax]
  float* wsv = ld + kScanQMax;              // [QMax]
  float* wtot = wsv + kScanQMax;            // [8]

  const int h = blockIdx.x, b = blockIdx.y;
  const int g = h / (a.H / a.G);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ty = tid >> 4, tx = tid & 15;
  const float Ah = a.A[h];

  const T* x = (const T*)a.x + b * a.sxb + (long long)h * P;
  const T* Bm = (const T*)a.Bm + b * a.sbb + (long long)g * N;
  const T* Cm = (const T*)a.Cm + b * a.scb + (long long)g * N;
  const float* dt = a.dt + (long long)b * L * a.H + h;
  T* y = (T*)a.y + (long long)b * L * a.H * P + (long long)h * P;
  const long long sy = (long long)a.H * P;

  // seed the carried state
  const long long hoff = ((long long)b * a.H + h) * N * P;
  for (int e = tid; e < ns * ps; e += kScanThreads) {
    const int n = e / ps, p = e - n * ps;
    hs[e] = (a.h0 != nullptr && n < N && p < P) ? a.h0[hoff + n * P + p] : 0.f;
  }

  const int n_chunks = (L + Q - 1) / Q;
  const int p0 = tx * 4;                    // this thread's 4 columns of P
  const bool p_ok = p0 < ps;

  for (int c = 0; c < n_chunks; ++c) {
    const int base = c * Q;
    // tiles wholly past L hold only padding: they add nothing, so skip them
    const int n_tiles = (min(Q, L - base) + kTile - 1) / kTile;
    // ---- ld = inclusive cumsum of dt*A over the chunk ----
    if constexpr (MODE == kAbstract) {
      const int t = tid;
      const float d = (t < Q && base + t < L) ? dt[(long long)(base + t) * a.H] : 0.f;
      dts[t] = d;
      // __fmul_rn: dt*A rounds before the sums, as in the plain version
      ld[t] = scratch_inclusive_scan<kScanThreads>(__fmul_rn(d, Ah), wsv);
      __syncthreads();
      const float total = ld[Q - 1];
      wsv[t] = d * expf(total - ld[t]);
    } else if constexpr (MODE == kAbstractShuffle) {
      constexpr int kPer = kScanQMax / 32;  // positions per lane
      if (warp == 0) {
        float v[kPer];
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          const int t = lane * kPer + i;
          const float d = (t < Q && base + t < L) ? dt[(long long)(base + t) * a.H] : 0.f;
          dts[t] = d;
          const float dA = __fmul_rn(d, Ah);
          v[i] = i == 0 ? dA : v[i - 1] + dA;
        }
        const float incl = lane_inclusive_scan<32>(v[kPer - 1]);
        const float up = lane_shuffle_up<32>(incl, 1);
        const float before = lane == 0 ? 0.f : up;
#pragma unroll
        for (int i = 0; i < kPer; ++i) ld[lane * kPer + i] = before + v[i];
      }
      __syncthreads();
      const float total = ld[Q - 1];
      wsv[tid] = dts[tid] * expf(total - ld[tid]);
    } else {
      const int t = tid;
      const float d = (t < Q && base + t < L) ? dt[(long long)(base + t) * a.H] : 0.f;
      dts[t] = d;
      float v = d * Ah;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v += u;
      }
      if (lane == 31) wtot[warp] = v;
      __syncthreads();
      float off = 0.f;
      for (int w = 0; w < warp; ++w) off += wtot[w];
      ld[t] = v + off;
      __syncthreads();
      const float total = ld[Q - 1];
      wsv[t] = d * expf(total - ld[t]);
    }
    const float total = ld[Q - 1];

    // ---- y: per target tile, the carried state, then the source tiles ----
    for (int ti = 0; ti < n_tiles; ++ti) {
      const int t0 = ti * kTile;
      load_tile<T, true>(ct, kTileStr, Cm, a.scl, base, t0, Q, L, N);
      __syncthreads();
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      if (p_ok) {
        for (int n = 0; n < N; ++n) {
          const float4 c4 = *reinterpret_cast<const float4*>(&ct[n * kTileStr + ty * 4]);
          const float4 h4 = *reinterpret_cast<const float4*>(&hs[n * ps + p0]);
          const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
          const float hv[4] = {h4.x, h4.y, h4.z, h4.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] += cv[i] * hv[j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = t0 + ty * 4 + i;
          const float e = expf(ld[min(t, kScanQMax - 1)]);
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] *= e;
        }
      }
      for (int sj = 0; sj <= ti; ++sj) {
        const int s0 = sj * kTile;
        load_tile<T, true>(bt, kTileStr, Bm, a.sbl, base, s0, Q, L, N);
        load_tile<T, false>(xs, ps, x, a.sxl, base, s0, Q, L, P);
        __syncthreads();
        // scores C_t . B_s for t = ty*4+i, s = tx*4+j
        float sc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
        for (int n = 0; n < N; ++n) {
          const float4 c4 = *reinterpret_cast<const float4*>(&ct[n * kTileStr + ty * 4]);
          const float4 b4 = *reinterpret_cast<const float4*>(&bt[n * kTileStr + tx * 4]);
          const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
          const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) sc[i][j] += cv[i] * bv[j];
        }
        // decay, causal mask (before exp) and dt: the weight tile
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int s = s0 + tx * 4 + j;
          float w[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int t = t0 + ty * 4 + i;
            w[i] = (s <= t && t < Q)
                       ? expf(ld[t] - ld[s]) * sc[i][j] * dts[s]
                       : 0.f;
          }
          *reinterpret_cast<float4*>(&ws[(tx * 4 + j) * kTileStr + ty * 4]) =
              make_float4(w[0], w[1], w[2], w[3]);
        }
        __syncthreads();
        if (p_ok) {
          for (int s = 0; s < kTile; ++s) {
            const float4 w4 = *reinterpret_cast<const float4*>(&ws[s * kTileStr + ty * 4]);
            const float4 x4 = *reinterpret_cast<const float4*>(&xs[s * ps + p0]);
            const float wv[4] = {w4.x, w4.y, w4.z, w4.w};
            const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j) acc[i][j] += wv[i] * xv[j];
          }
        }
        __syncthreads();
      }
      if (p_ok) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = t0 + ty * 4 + i;
          if (t >= Q || base + t >= L) continue;
          T* yr = y + (long long)(base + t) * sy;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (p0 + j < P) yr[p0 + j] = from_f<T>(acc[i][j]);
        }
      }
    }

    // ---- h <- exp(total) h + sum_s B_s wS_s x_s^T (after every y read) ----
    float u[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) u[i][j] = 0.f;
    const int n0 = ty * 8;                  // this thread's 8 rows of N
    const bool n_ok = n0 < N && p_ok;
    for (int sj = 0; sj < n_tiles; ++sj) {
      const int s0 = sj * kTile;
      load_tile<T, false>(bt, ns, Bm, a.sbl, base, s0, Q, L, N);
      load_tile<T, false>(xs, ps, x, a.sxl, base, s0, Q, L, P);
      __syncthreads();
      if (n_ok) {
        for (int s = 0; s < kTile; ++s) {
          const float wsc = wsv[min(s0 + s, kScanQMax - 1)];
          const float4 x4 = *reinterpret_cast<const float4*>(&xs[s * ps + p0]);
          const float xv[4] = {x4.x * wsc, x4.y * wsc, x4.z * wsc, x4.w * wsc};
          const float4 ba = *reinterpret_cast<const float4*>(&bt[s * ns + n0]);
          const float4 bb = *reinterpret_cast<const float4*>(&bt[s * ns + n0 + 4]);
          const float bv[8] = {ba.x, ba.y, ba.z, ba.w, bb.x, bb.y, bb.z, bb.w};
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) u[i][j] += bv[i] * xv[j];
        }
      }
      __syncthreads();
    }
    if (n_ok) {
      const float decay = expf(total);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (n0 + i >= N) break;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          hs[(n0 + i) * ps + p0 + j] = decay * hs[(n0 + i) * ps + p0 + j] + u[i][j];
      }
    }
    __syncthreads();
  }

  for (int e = tid; e < N * P; e += kScanThreads) {
    const int n = e / P, p = e - n * P;
    a.hf[hoff + e] = hs[n * ps + p];
  }
}

template <typename T, int MODE>
cudaError_t launch_ssd_scan(const ScanArgs& a, int batch, cudaStream_t st) {
  const size_t bytes = (size_t)scan_smem_floats(a.N, a.P) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  ssd_scan_kernel<T, MODE><<<dim3(a.H, batch), kScanThreads, bytes, st>>>(a);
  return cudaGetLastError();
}

// native is instantiated first: with the bf16 kernel placed after the
// modes' kernels, the compiler scheduled its code otherwise than before the
// modes existed (scripts/sass_diff.py); first, it compiles as it did
template <typename T>
cudaError_t launch_ssd_scan(int mode, const ScanArgs& a, int batch,
                            cudaStream_t st) {
  if (mode == kNative) return launch_ssd_scan<T, kNative>(a, batch, st);
  if (mode == kAbstract) return launch_ssd_scan<T, kAbstract>(a, batch, st);
  return launch_ssd_scan<T, kAbstractShuffle>(a, batch, st);
}

}  // namespace uisa

// mode: kernels/_launch.py::MODE_CODES.  dtype: 0 f32, 1 bf16 (x, B, C and
// y); dt, A, h0 and hf are f32.  Shapes are checked by the Python wrapper:
// N <= 128, P <= 64, Q <= 256, G | H.  *route: 1 tc, 0 fma.
extern "C" int uisa_ssd_scan(int mode, int dtype, const void* x, const void* dt,
                             const void* A, const void* Bm, const void* Cm,
                             const void* h0, void* y, void* hf, int batch,
                             int L, int H, int G, int N, int P, int Q,
                             long long sxb, long long sxl, long long sbb,
                             long long sbl, long long scb, long long scl,
                             void* stream, int* route) {
  if (N > uisa::kScanNMax || P > uisa::kScanPMax || Q > uisa::kScanQMax ||
      Q < 1 || G < 1 || H % G != 0 || mode < uisa::kAbstract ||
      mode > uisa::kNative)
    return (int)cudaErrorInvalidValue;
  uisa::ScanArgs a{x, (const float*)dt, (const float*)A, Bm, Cm,
                   (const float*)h0, y, (float*)hf, L, H, G, N, P, Q,
                   sxb, sxl, sbb, sbl, scb, scl};
  cudaStream_t st = (cudaStream_t)stream;
  const bool tc = uisa::scan_tc_route(dtype, a);
  *route = tc ? 1 : 0;
  if (!tc) {
    if (dtype == uisa::kBF16)
      return (int)uisa::launch_ssd_scan<__nv_bfloat16>(mode, a, batch, st);
    return (int)uisa::launch_ssd_scan<float>(mode, a, batch, st);
  }
  return (int)uisa::launch_ssd_scan_tc(mode, a, batch, st);
}

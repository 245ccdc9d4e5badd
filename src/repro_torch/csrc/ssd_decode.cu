// The one-token Mamba2 SSD recurrence, batched over the serve batch.
//
// Replaces kernels/ssd.py::fused_ssd_decode of the JAX package (the Pallas
// kernel _ssd_decode_kernel).  Per (slot b, head h) with its [N,P] f32
// state:
//
//   h' = exp(dt*A) h + (dt B) x^T        y[p] = sum_n C[n] h'[n,p]
//
// What bounds it on the H100: the state.  At 8 slots x 80 heads x 128 x 64
// it is 21.0 MB read and 21.0 MB written per launch, 12.5 us at 3.35 TB/s;
// everything else is under 1% of the bytes and the arithmetic is a few
// operations per state element.
//
// Design: one block per (slot, head), 640 blocks at 8 slots.  Each of its
// 256 threads owns four adjacent columns of P (float4 loads along P, so a
// warp reads two whole 256-byte rows) and every 16th row of N; it reads
// each state element once, writes h' once, and keeps its share of the
// readout in registers.  The readout's sum over N then goes through shared
// memory in a fixed order (no atomics), so y does not depend on scheduling.
// The state may be updated in place (state_out == state): every element is
// read and written by the same thread.  The recurrence and the readout are
// in f32; y is rounded once to the input dtype.
//
// The readout y = C.h' is the kernel's one cross-lane stage, and the only
// code that changes with MODE (kernels/_launch.py::MODE_CODES), as in the
// JAX package's _ssd_decode_kernel; the recurrence is the same in every
// mode:
// - native: the fixed-order sum of 16 per-thread partials per column above;
// - abstract: native's thread map; every product C[n] h'[n,p] goes to an
//   [N][P] f32 tile in dynamic shared memory (32 KB at 128 x 64), which
//   log2(N) barrier-separated halving stages sum over N (the JAX scratch
//   tree, its `(n, p)` scratch);
// - abstract+shuffle: N in lanes.  Groups of W = min(N, 32) lanes; lane l
//   of a group owns rows n = l + W k and the group a span of 4-column
//   quads of P, so each thread still reads and writes each of its state
//   elements once (the update in place holds).  A lane folds its rows'
//   products in registers, then lanes.cuh::lane_tree_reduce<W> sums over
//   the group (5 __shfl_xor_sync stages at W = 32; the reduced configs'
//   N = 16 run 16-lane groups, two to a warp).  Each lane reads 32 bytes
//   from each of N/W rows 256 bytes apart (at P = 64), where native's warp
//   reads two whole rows: a warp's load touches 32 rows, and the state
//   stream loses its coalescing (PERF.md has what that costs).
// Outside native N must be a power of two (checked by the wrapper).
#include "common.cuh"
#include "lanes.cuh"

namespace uisa {

constexpr int kDecThreads = 256;
constexpr int kDecCols = 16;             // threads across P (4 columns each)
constexpr int kDecRows = kDecThreads / kDecCols;
constexpr int kDecNMax = 128;
constexpr int kDecPMax = 64;

// abstract+shuffle's readout for W-lane groups (see the note above).  src
// and dst are this (slot, head)'s [N,P] state; every lane of the block
// must call it (the trees shuffle across whole warps).  A group owns `per`
// adjacent column quads (2 at W = 32, P = 64), and a lane loads all of
// them from a row before it updates any: 32 contiguous bytes, a whole
// sector (a pass per quad would read half sectors).
template <int W, typename T>
__device__ __forceinline__ void decode_in_lanes(const float* src, float* dst,
                                                const float* bd,
                                                const float* cs, const T* xr,
                                                float da, T* yr, int N,
                                                int P) {
  constexpr int kGroups = kDecThreads / W;
  constexpr int kSpan = (kDecPMax / 4 + kGroups - 1) / kGroups;  // max per
  const int l = threadIdx.x & (W - 1), grp = threadIdx.x / W;
  const int quads = P / 4, row4 = P / 4;
  const int per = (quads + kGroups - 1) / kGroups;  // quads per group
  const int q0 = grp * per;
  const int nq = max(0, min(per, quads - q0));      // this group's quads
  const float4* src4 = reinterpret_cast<const float4*>(src);
  float4* dst4 = reinterpret_cast<float4*>(dst);
  float xv[kSpan][4], acc[kSpan][4];
#pragma unroll
  for (int j = 0; j < kSpan; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      xv[j][c] = j < nq ? to_f(xr[(q0 + j) * 4 + c]) : 0.f;
      acc[j][c] = 0.f;
    }
  for (int n = l; n < N; n += W) {
    float4 s[kSpan];
#pragma unroll
    for (int j = 0; j < kSpan; ++j)
      if (j < nq) s[j] = src4[n * row4 + q0 + j];
#pragma unroll
    for (int j = 0; j < kSpan; ++j) {
      if (j >= nq) break;
      s[j].x = da * s[j].x + bd[n] * xv[j][0];
      s[j].y = da * s[j].y + bd[n] * xv[j][1];
      s[j].z = da * s[j].z + bd[n] * xv[j][2];
      s[j].w = da * s[j].w + bd[n] * xv[j][3];
      dst4[n * row4 + q0 + j] = s[j];
      // __fmul_rn: each product rounds before the fold, as in the plain
      // version
      acc[j][0] += __fmul_rn(cs[n], s[j].x);
      acc[j][1] += __fmul_rn(cs[n], s[j].y);
      acc[j][2] += __fmul_rn(cs[n], s[j].z);
      acc[j][3] += __fmul_rn(cs[n], s[j].w);
    }
  }
#pragma unroll
  for (int j = 0; j < kSpan; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[j][c] = lane_tree_reduce<W>(acc[j][c]);
  if (l == 0) {
#pragma unroll
    for (int j = 0; j < kSpan; ++j) {
      if (j >= nq) break;
#pragma unroll
      for (int c = 0; c < 4; ++c) yr[(q0 + j) * 4 + c] = from_f<T>(acc[j][c]);
    }
  }
}

template <typename T, int MODE>
__global__ void __launch_bounds__(kDecThreads)
ssd_decode_kernel(const float* state, float* state_out, const T* x,
                  const float* dt, const float* A, const T* Bm, const T* Cm,
                  T* y, int H, int G, int N, int P, long long sxb,
                  long long sbb, long long scb) {
  __shared__ float bd[kDecNMax];          // dt * B
  __shared__ float cs[kDecNMax];
  __shared__ __align__(16) float red[kDecRows][kDecPMax];

  const int h = blockIdx.x, b = blockIdx.y;
  const int g = h / (H / G);
  const int tid = threadIdx.x;
  const float dtv = dt[(long long)b * H + h];
  const float da = expf(dtv * A[h]);
  for (int n = tid; n < N; n += kDecThreads) {
    bd[n] = dtv * to_f(Bm[b * sbb + (long long)g * N + n]);
    cs[n] = to_f(Cm[b * scb + (long long)g * N + n]);
  }
  __syncthreads();

  if constexpr (MODE == kAbstractShuffle) {
    const long long off = ((long long)b * H + h) * N * P;
    const T* xr = x + b * sxb + (long long)h * P;
    T* yr = y + ((long long)b * H + h) * P;
    if (N >= 32)
      decode_in_lanes<32>(state + off, state_out + off, bd, cs, xr, da, yr, N, P);
    else if (N == 16)
      decode_in_lanes<16>(state + off, state_out + off, bd, cs, xr, da, yr, N, P);
    else if (N == 8)
      decode_in_lanes<8>(state + off, state_out + off, bd, cs, xr, da, yr, N, P);
    else if (N == 4)
      decode_in_lanes<4>(state + off, state_out + off, bd, cs, xr, da, yr, N, P);
    else if (N == 2)
      decode_in_lanes<2>(state + off, state_out + off, bd, cs, xr, da, yr, N, P);
    else
      decode_in_lanes<1>(state + off, state_out + off, bd, cs, xr, da, yr, N, P);
    return;
  }

  const int p0 = (tid % kDecCols) * 4, r = tid / kDecCols;
  if constexpr (MODE == kAbstract) {
    extern __shared__ __align__(16) float tree[];  // [N][P]
    if (p0 < P) {
      const T* xr = x + b * sxb + (long long)h * P + p0;
      const float xv[4] = {to_f(xr[0]), to_f(xr[1]), to_f(xr[2]), to_f(xr[3])};
      const long long off = ((long long)b * H + h) * N * P + p0;
      const float4* src = reinterpret_cast<const float4*>(state + off);
      float4* dst = reinterpret_cast<float4*>(state_out + off);
      const int row4 = P / 4;
      for (int n = r; n < N; n += kDecRows) {
        float4 s = src[n * row4];
        s.x = da * s.x + bd[n] * xv[0];
        s.y = da * s.y + bd[n] * xv[1];
        s.z = da * s.z + bd[n] * xv[2];
        s.w = da * s.w + bd[n] * xv[3];
        dst[n * row4] = s;
        *reinterpret_cast<float4*>(&tree[n * P + p0]) =
            make_float4(cs[n] * s.x, cs[n] * s.y, cs[n] * s.z, cs[n] * s.w);
      }
    }
    // the halving tree over N, one barrier a stage
    for (int w = N / 2; w >= 1; w >>= 1) {
      __syncthreads();
      for (int e = tid; e < w * P; e += kDecThreads) tree[e] += tree[e + w * P];
    }
    __syncthreads();
    if (tid < P) y[((long long)b * H + h) * P + tid] = from_f<T>(tree[tid]);
  } else {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    if (p0 < P) {
      const T* xr = x + b * sxb + (long long)h * P + p0;
      const float xv[4] = {to_f(xr[0]), to_f(xr[1]), to_f(xr[2]), to_f(xr[3])};
      const long long off = ((long long)b * H + h) * N * P + p0;
      const float4* src = reinterpret_cast<const float4*>(state + off);
      float4* dst = reinterpret_cast<float4*>(state_out + off);
      const int row4 = P / 4;               // float4 per state row
#pragma unroll 4
      for (int n = r; n < N; n += kDecRows) {
        float4 s = src[n * row4];
        s.x = da * s.x + bd[n] * xv[0];
        s.y = da * s.y + bd[n] * xv[1];
        s.z = da * s.z + bd[n] * xv[2];
        s.w = da * s.w + bd[n] * xv[3];
        dst[n * row4] = s;
        acc[0] += cs[n] * s.x;
        acc[1] += cs[n] * s.y;
        acc[2] += cs[n] * s.z;
        acc[3] += cs[n] * s.w;
      }
      *reinterpret_cast<float4*>(&red[r][p0]) =
          make_float4(acc[0], acc[1], acc[2], acc[3]);
    }
    __syncthreads();
    if (tid < P) {
      float sum = 0.f;
      for (int k = 0; k < kDecRows; ++k) sum += red[k][tid];
      y[((long long)b * H + h) * P + tid] = from_f<T>(sum);
    }
  }
}

template <typename T>
cudaError_t launch_ssd_decode(int mode, const float* state, float* state_out,
                              const T* x, const float* dt, const float* A,
                              const T* Bm, const T* Cm, T* y, int batch,
                              int H, int G, int N, int P, long long sxb,
                              long long sbb, long long scb, cudaStream_t st) {
  const dim3 grid(H, batch);
  if (mode == kAbstract)
    ssd_decode_kernel<T, kAbstract>
        <<<grid, kDecThreads, (size_t)N * P * sizeof(float), st>>>(
            state, state_out, x, dt, A, Bm, Cm, y, H, G, N, P, sxb, sbb, scb);
  else if (mode == kAbstractShuffle)
    ssd_decode_kernel<T, kAbstractShuffle><<<grid, kDecThreads, 0, st>>>(
        state, state_out, x, dt, A, Bm, Cm, y, H, G, N, P, sxb, sbb, scb);
  else
    ssd_decode_kernel<T, kNative><<<grid, kDecThreads, 0, st>>>(
        state, state_out, x, dt, A, Bm, Cm, y, H, G, N, P, sxb, sbb, scb);
  return cudaGetLastError();
}

}  // namespace uisa

// mode: kernels/_launch.py::MODE_CODES.  dtype: 0 f32, 1 bf16 (x, B, C and
// y); state, state_out, dt and A are f32, the state [B,H,N,P] contiguous.
// x [B,H,P] has batch stride sxb, B and C [B,G,N] batch strides sbb and
// scb.  N <= 128 (a power of two outside native), P <= 64 and a multiple
// of 4.
extern "C" int uisa_ssd_decode(int mode, int dtype, const void* state,
                               void* state_out, const void* x, const void* dt,
                               const void* A, const void* Bm, const void* Cm,
                               void* y, int batch, int H, int G, int N, int P,
                               long long sxb, long long sbb, long long scb,
                               void* stream) {
  if (N > uisa::kDecNMax || P > uisa::kDecPMax || P % 4 != 0 || G < 1 ||
      H % G != 0 || mode < uisa::kAbstract || mode > uisa::kNative ||
      (mode != uisa::kNative && (N < 1 || (N & (N - 1)) != 0)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == uisa::kBF16)
    return (int)uisa::launch_ssd_decode<__nv_bfloat16>(
        mode, (const float*)state, (float*)state_out,
        (const __nv_bfloat16*)x, (const float*)dt, (const float*)A,
        (const __nv_bfloat16*)Bm, (const __nv_bfloat16*)Cm,
        (__nv_bfloat16*)y, batch, H, G, N, P, sxb, sbb, scb, st);
  return (int)uisa::launch_ssd_decode<float>(
      mode, (const float*)state, (float*)state_out, (const float*)x,
      (const float*)dt, (const float*)A, (const float*)Bm, (const float*)Cm,
      (float*)y, batch, H, G, N, P, sxb, sbb, scb, st);
}

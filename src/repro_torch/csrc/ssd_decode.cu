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
#include "common.cuh"

namespace uisa {

constexpr int kDecThreads = 256;
constexpr int kDecCols = 16;             // threads across P (4 columns each)
constexpr int kDecRows = kDecThreads / kDecCols;
constexpr int kDecNMax = 128;
constexpr int kDecPMax = 64;

template <typename T>
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

  const int p0 = (tid % kDecCols) * 4, r = tid / kDecCols;
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

}  // namespace uisa

// dtype: 0 f32, 1 bf16 (x, B, C and y); state, state_out, dt and A are f32,
// the state [B,H,N,P] contiguous.  x [B,H,P] has batch stride sxb, B and C
// [B,G,N] batch strides sbb and scb.  N <= 128, P <= 64 and a multiple of 4.
extern "C" int uisa_ssd_decode(int dtype, const void* state, void* state_out,
                               const void* x, const void* dt, const void* A,
                               const void* Bm, const void* Cm, void* y,
                               int batch, int H, int G, int N, int P,
                               long long sxb, long long sbb, long long scb,
                               void* stream) {
  if (N > uisa::kDecNMax || P > uisa::kDecPMax || P % 4 != 0 || G < 1 ||
      H % G != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid(H, batch);
  if (dtype == uisa::kBF16)
    uisa::ssd_decode_kernel<__nv_bfloat16><<<grid, uisa::kDecThreads, 0, st>>>(
        (const float*)state, (float*)state_out, (const __nv_bfloat16*)x,
        (const float*)dt, (const float*)A, (const __nv_bfloat16*)Bm,
        (const __nv_bfloat16*)Cm, (__nv_bfloat16*)y, H, G, N, P, sxb, sbb, scb);
  else
    uisa::ssd_decode_kernel<float><<<grid, uisa::kDecThreads, 0, st>>>(
        (const float*)state, (float*)state_out, (const float*)x,
        (const float*)dt, (const float*)A, (const float*)Bm, (const float*)Cm,
        (float*)y, H, G, N, P, sxb, sbb, scb);
  return (int)cudaGetLastError();
}

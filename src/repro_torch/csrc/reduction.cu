// Sum of all elements with f32 accumulation: the paper's reduction (Table
// V, row 2), the kernel behind §VII.C's shuffle finding.
//
// Replaces kernels/reduction.py::reduce_sum of the JAX package (the Pallas
// kernel _reduction_kernel), in its three kernel modes.
//
// What bounds it on the H100: bytes.  2^24 f32 values are 67.1 MB, 20.0 us
// at 3.35 TB/s; the adds are one per element.
//
// Design.  One block of 256 threads per tile of ``tile`` elements
// (default 65,536: the JAX plan's cap of 512 rows x 128 lanes), so one
// block tree is amortised over the whole tile.  Every mode shares the
// loading stage of the abstract kernel's contract, and the three differ
// only where the paper's pair differs:
//
// - loading (abstract, abstract+shuffle): thread t folds elements
//   base + t, base + t + 256, ... of its block's tile into one f32
//   register, in order, with plain element loads;
// - loading (native): the same fold over 16-byte vectors (4 f32, 8 bf16
//   or 4 int32 per load), four independent vector loads in flight per
//   thread, the elements of a vector added in order.  Both additions are
//   Hopper's, not the abstract model's.  A base address off 16 bytes
//   takes the scalar loop;
// - the block's cross-lane stage: ``abstract`` runs scratch_tree_reduce
//   (8 barrier-separated shared-memory stages over 256 threads, no
//   shuffle); ``abstract+shuffle`` and ``native`` run warp_block_reduce
//   (5 warp shuffles, one shared exchange of the 8 warp partials, 3 more
//   shuffles).  Both are in lanes.cuh.
//
// The TPU adds every grid step's partial into one scalar in grid order
// (reduction.py:90).  Hopper's blocks run in no order, so each block
// writes its partial and a second pass of the same kernel (one block, the
// same mode) sums the partials in a fixed order.  No float atomics: the
// sum does not depend on the order the blocks ran in.
#include "common.cuh"
#include "lanes.cuh"

namespace uisa {

constexpr int kRedThreads = 256;
constexpr int kRedUnroll = 4;            // native: vector loads in flight
enum RedMode { kRedAbstract = 0, kRedShuffle = 1, kRedNative = 2 };
enum RedDType { kRedF32 = 0, kRedBF16 = 1, kRedI32 = 2 };

__device__ __forceinline__ float elem_f(float x) { return x; }
__device__ __forceinline__ float elem_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float elem_f(int x) { return (float)x; }

// the elements of one 16-byte vector, added in order
template <typename T> __device__ __forceinline__ float vec_sum(uint4 v) {
  const T* e = reinterpret_cast<const T*>(&v);
  float s = elem_f(e[0]);
#pragma unroll
  for (int i = 1; i < (int)(16 / sizeof(T)); ++i) s += elem_f(e[i]);
  return s;
}

template <typename T>
__device__ __forceinline__ float fold_scalar(const T* __restrict__ x,
                                             long long base, long long end) {
  float acc = 0.f;
  for (long long i = base + threadIdx.x; i < end; i += kRedThreads)
    acc += elem_f(x[i]);
  return acc;
}

template <typename T>
__device__ __forceinline__ float fold_vector(const T* __restrict__ x,
                                             long long base, long long end) {
  constexpr int kVec = 16 / sizeof(T);
  const uint4* xv = reinterpret_cast<const uint4*>(x + base);
  const long long nv = (end - base) / kVec;
  float acc = 0.f;
  long long i = threadIdx.x;
  for (; i + (kRedUnroll - 1) * kRedThreads < nv; i += kRedUnroll * kRedThreads) {
    uint4 v[kRedUnroll];
#pragma unroll
    for (int u = 0; u < kRedUnroll; ++u) v[u] = __ldg(xv + i + u * kRedThreads);
#pragma unroll
    for (int u = 0; u < kRedUnroll; ++u) acc += vec_sum<T>(v[u]);
  }
  for (; i < nv; i += kRedThreads) acc += vec_sum<T>(__ldg(xv + i));
  const long long j = base + nv * kVec + threadIdx.x;   // < kVec tail elements
  if (j < end) acc += elem_f(x[j]);
  return acc;
}

template <int MODE, typename T>
__global__ void __launch_bounds__(kRedThreads)
reduce_sum_kernel(const T* __restrict__ x, long long n, long long tile,
                  int vector_ok, float* __restrict__ out) {
  __shared__ float scratch[kRedThreads];
  const long long base = (long long)blockIdx.x * tile;
  const long long end = base + tile < n ? base + tile : n;
  float acc;
  if (MODE == kRedNative && vector_ok)
    acc = fold_vector(x, base, end);
  else
    acc = fold_scalar(x, base, end);
  const float s = MODE == kRedAbstract
                      ? scratch_tree_reduce<kRedThreads>(acc, scratch)
                      : warp_block_reduce<kRedThreads>(acc, scratch);
  if (threadIdx.x == 0) out[blockIdx.x] = s;
}

template <int MODE, typename T>
cudaError_t launch_reduce(const T* x, long long n, long long tile,
                          float* partials, float* out, cudaStream_t st) {
  const long long blocks = (n + tile - 1) / tile;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int vec_ok = ((uintptr_t)x % 16) == 0;
  float* first = blocks == 1 ? out : partials;
  reduce_sum_kernel<MODE, T><<<(unsigned)blocks, kRedThreads, 0, st>>>(
      x, n, tile, vec_ok, first);
  if (blocks > 1) {
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    // second pass: one block folds the partials in a fixed order
    reduce_sum_kernel<MODE, float><<<1, kRedThreads, 0, st>>>(
        partials, blocks, blocks, ((uintptr_t)partials % 16) == 0, out);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_mode(int mode, const void* x, long long n, long long tile,
                          float* partials, float* out, cudaStream_t st) {
  const T* xt = (const T*)x;
  switch (mode) {
    case kRedAbstract: return launch_reduce<kRedAbstract>(xt, n, tile, partials, out, st);
    case kRedShuffle: return launch_reduce<kRedShuffle>(xt, n, tile, partials, out, st);
    case kRedNative: return launch_reduce<kRedNative>(xt, n, tile, partials, out, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace uisa

// mode: 0 abstract, 1 abstract+shuffle, 2 native; dtype: 0 f32, 1 bf16,
// 2 int32.  x holds n contiguous elements; tile (elements per block) is a
// positive multiple of 8, so every block starts on a 16-byte vector of any
// dtype; partials holds ceil(n / tile) f32 values (unused when that is
// 1); out receives the f32 sum.
extern "C" int uisa_reduce_sum(int mode, int dtype, const void* x, long long n,
                               long long tile, void* partials, void* out,
                               void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (tile <= 0 || tile % 8 != 0 || n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaMemsetAsync(out, 0, sizeof(float), st);
  float* p = (float*)partials;
  float* o = (float*)out;
  switch (dtype) {
    case uisa::kRedF32: return (int)uisa::dispatch_mode<float>(mode, x, n, tile, p, o, st);
    case uisa::kRedBF16:
      return (int)uisa::dispatch_mode<__nv_bfloat16>(mode, x, n, tile, p, o, st);
    case uisa::kRedI32: return (int)uisa::dispatch_mode<int>(mode, x, n, tile, p, o, st);
  }
  return (int)cudaErrorInvalidValue;
}

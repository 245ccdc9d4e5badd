// int32 counts of values clipped into [0, bins): the paper's histogram
// (Table V, row 3), its atomic-contention benchmark.
//
// Replaces kernels/histogram.py::histogram of the JAX package (the Pallas
// kernel _histogram_kernel), in its abstract, abstract+shuffle and native
// modes.
//
// What bounds it on the H100: bytes.  2^24 int32 values are 67.1 MB, 20.0
// us at 3.35 TB/s; the counts are 1 KB.  Under contention (many values in
// one bin) the shared-memory atomics can bound it instead.
//
// Design.  The TPU has no atomics, so every JAX mode privatises and
// reduces.  Hopper has them, which restores the paper's own CUDA pair
// (histogram.py:3-6).  One block of 256 threads per tile of ``tile``
// values (default 65,536, as the reduction):
//
// - abstract: one histogram per block in shared memory, every value an
//   atomicAdd into it (ATOMIC_RMW is in the abstract contract), plain
//   element loads;
// - abstract+shuffle: no shared atomics.  Each lane keeps private counts,
//   one 16-bit column per lane of a [bins][32] table per warp in shared
//   memory (128 KiB at 256 bins, so the larger dynamic shared memory is
//   opted into), incremented by plain stores: no lane ever touches
//   another's column.  At the end of the tile each bin's 32 lane counts
//   are summed by lanes.cuh::lane_tree_reduce (5 __shfl_xor_sync stages),
//   the warps' sums added in a fixed order.  This is the JAX mode's
//   structure (histogram.py:98-105): per-row privates merged by the rotate
//   tree.  A lane sees at most tile / 256 values (256 of a 65,536 tile),
//   so 16 bits cannot overflow; the entry point refuses larger tiles.
//   Plain element loads, as the abstract mode's;
// - native: one histogram per warp in shared memory (8 per block), so only
//   the 32 lanes of a warp contend for a bin, merged at the end of the
//   block; 16-byte loads (4 values), four in flight per thread.
//
// Values are clipped into range, as histogram.py:129 does, not dropped;
// the ragged tail of the last tile is masked in the kernel (no sentinel
// padding).  Each block adds its non-zero bins into the output with int32
// atomicAdd, exact in any order, so the counts do not depend on the order
// the blocks ran in.  The TPU's in-order accumulation into o_ref
// (histogram.py:115) has no other counterpart.
#include "common.cuh"
#include "lanes.cuh"

namespace uisa {

constexpr int kHistThreads = 256;
constexpr int kHistWarps = kHistThreads / 32;
constexpr int kHistUnroll = 4;
enum HistMode { kHistAbstract = 0, kHistShuffle = 1, kHistNative = 2 };
// the most values one lane of the shuffle mode may count (16-bit counts)
constexpr long long kLaneCountMax = 65535;

__device__ __forceinline__ int clip_bin(int v, int bins) {
  return min(max(v, 0), bins - 1);
}

template <int MODE>
__global__ void __launch_bounds__(kHistThreads)
histogram_kernel(const int* __restrict__ v, long long n, long long tile,
                 int bins, int vector_ok, int* __restrict__ out) {
  extern __shared__ int hist[];           // copies x bins
  constexpr int kCopies = MODE == kHistNative ? kHistWarps : 1;
  for (int i = threadIdx.x; i < kCopies * bins; i += kHistThreads) hist[i] = 0;
  __syncthreads();
  int* mine = hist + (kCopies > 1 ? (threadIdx.x >> 5) * bins : 0);
  const long long base = (long long)blockIdx.x * tile;
  const long long end = base + tile < n ? base + tile : n;
  if (MODE == kHistNative && vector_ok) {
    const int4* vv = reinterpret_cast<const int4*>(v + base);
    const long long nv = (end - base) / 4;
    long long i = threadIdx.x;
    for (; i + (kHistUnroll - 1) * kHistThreads < nv;
         i += kHistUnroll * kHistThreads) {
      int4 q[kHistUnroll];
#pragma unroll
      for (int u = 0; u < kHistUnroll; ++u) q[u] = __ldg(vv + i + u * kHistThreads);
#pragma unroll
      for (int u = 0; u < kHistUnroll; ++u) {
        atomicAdd(&mine[clip_bin(q[u].x, bins)], 1);
        atomicAdd(&mine[clip_bin(q[u].y, bins)], 1);
        atomicAdd(&mine[clip_bin(q[u].z, bins)], 1);
        atomicAdd(&mine[clip_bin(q[u].w, bins)], 1);
      }
    }
    for (; i < nv; i += kHistThreads) {
      const int4 q = __ldg(vv + i);
      atomicAdd(&mine[clip_bin(q.x, bins)], 1);
      atomicAdd(&mine[clip_bin(q.y, bins)], 1);
      atomicAdd(&mine[clip_bin(q.z, bins)], 1);
      atomicAdd(&mine[clip_bin(q.w, bins)], 1);
    }
    const long long j = base + nv * 4 + threadIdx.x;   // < 4 tail values
    if (j < end) atomicAdd(&mine[clip_bin(v[j], bins)], 1);
  } else {
    for (long long i = base + threadIdx.x; i < end; i += kHistThreads)
      atomicAdd(&mine[clip_bin(v[i], bins)], 1);
  }
  __syncthreads();
  for (int b = threadIdx.x; b < bins; b += kHistThreads) {
    int c = 0;
#pragma unroll
    for (int k = 0; k < kCopies; ++k) c += hist[k * bins + b];
    if (c) atomicAdd(&out[b], c);
  }
}

// abstract+shuffle: per-lane 16-bit columns, merged by the lane tree
__global__ void __launch_bounds__(kHistThreads)
histogram_shuffle_kernel(const int* __restrict__ v, long long n,
                         long long tile, int bins, int* __restrict__ out) {
  extern __shared__ unsigned short cols[];  // [warps][bins][32] lane counts
  int* warp_sum = (int*)(cols + (size_t)kHistWarps * bins * 32);  // [warps][bins]
  unsigned* words = (unsigned*)cols;
  for (int i = threadIdx.x; i < kHistWarps * bins * 16; i += kHistThreads)
    words[i] = 0u;
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned short* table = cols + (size_t)warp * bins * 32;
  const long long base = (long long)blockIdx.x * tile;
  const long long end = base + tile < n ? base + tile : n;
  for (long long i = base + threadIdx.x; i < end; i += kHistThreads)
    ++table[clip_bin(v[i], bins) * 32 + lane];     // this lane's column
  __syncwarp();
  for (int b = 0; b < bins; ++b) {
    const int c = lane_tree_reduce<32>((int)table[b * 32 + lane]);
    if (lane == 0) warp_sum[warp * bins + b] = c;
  }
  __syncthreads();
  for (int b = threadIdx.x; b < bins; b += kHistThreads) {
    int c = 0;
#pragma unroll
    for (int k = 0; k < kHistWarps; ++k) c += warp_sum[k * bins + b];
    if (c) atomicAdd(&out[b], c);
  }
}

// shared memory per bin: the 16-bit lane columns and the warp sums
constexpr size_t kShuffleBytesPerBin =
    kHistWarps * (32 * sizeof(unsigned short) + sizeof(int));

inline cudaError_t launch_histogram_shuffle(const int* v, long long n,
                                            long long tile, int bins,
                                            int* out, cudaStream_t st) {
  const long long blocks = (n + tile - 1) / tile;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const size_t smem = (size_t)bins * kShuffleBytesPerBin;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        histogram_shuffle_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  histogram_shuffle_kernel<<<(unsigned)blocks, kHistThreads, smem, st>>>(
      v, n, tile, bins, out);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t launch_histogram(const int* v, long long n, long long tile,
                             int bins, int* out, cudaStream_t st) {
  const long long blocks = (n + tile - 1) / tile;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int copies = MODE == kHistNative ? kHistWarps : 1;
  const size_t smem = (size_t)copies * bins * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        histogram_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  histogram_kernel<MODE><<<(unsigned)blocks, kHistThreads, smem, st>>>(
      v, n, tile, bins, ((uintptr_t)v % 16) == 0, out);
  return cudaGetLastError();
}

// The most bins a mode takes: its private copies fit the 227 KB (232,448
// bytes) of shared memory a block may have.
inline int max_bins(int mode) {
  if (mode == kHistShuffle) return (int)(232448 / kShuffleBytesPerBin);
  const int copies = mode == kHistNative ? kHistWarps : 1;
  return (int)(232448 / (copies * sizeof(int)));
}

}  // namespace uisa

// mode: 0 abstract, 1 abstract+shuffle, 2 native.  v holds n contiguous
// int32 values; tile (values per block) is a positive multiple of 4, at
// most 256 x 65,535 under abstract+shuffle (16-bit lane counts); out
// receives bins int32 counts (zeroed here first).
extern "C" int uisa_histogram(int mode, const void* v, long long n,
                              long long tile, int bins, void* out,
                              void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (tile <= 0 || tile % 4 != 0 || n < 0 || bins < 1 ||
      bins > uisa::max_bins(mode) ||
      (mode == uisa::kHistShuffle &&
       tile > uisa::kHistThreads * uisa::kLaneCountMax))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(out, 0, (size_t)bins * sizeof(int), st);
  if (err != cudaSuccess || n == 0) return (int)err;
  const int* vi = (const int*)v;
  int* o = (int*)out;
  switch (mode) {
    case uisa::kHistAbstract:
      return (int)uisa::launch_histogram<uisa::kHistAbstract>(vi, n, tile, bins, o, st);
    case uisa::kHistShuffle:
      return (int)uisa::launch_histogram_shuffle(vi, n, tile, bins, o, st);
    case uisa::kHistNative:
      return (int)uisa::launch_histogram<uisa::kHistNative>(vi, n, tile, bins, o, st);
  }
  return (int)cudaErrorInvalidValue;
}

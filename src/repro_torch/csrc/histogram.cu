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
// (histogram.py:3-6).  Every mode walks the values the same way: a
// persistent grid of 256-thread blocks (uisa_histogram_grid: the blocks
// resident on the card, cudaOccupancyMaxActiveBlocksPerMultiprocessor x
// SMs, at most kHistBlocksPerSM an SM, or the tiles where there are
// fewer), block b taking tiles b, b + grid, ... of kHistTile = 4,096
// values.  A thread issues its 16 loads of a tile (values u * 256 + t,
// u < 16) before it counts any of them, and those of its next tile before
// it counts the current one's: 32-96 KB an SM in flight against the ~18
// KB the card needs (3.35 TB/s x ~0.7 us over 132 SMs).  Only the last
// tile can be ragged, so only it checks each value's index.
// Element loads are asm volatile ld.global.cs (evict-first; the compiler
// keeps each where it is written).  A block's private counts are merged
// once, after its last tile, into the output by int32 atomicAdd, exact in
// any order, so the counts do not depend on the order the blocks ran in.
//
// - abstract: one histogram per block in shared memory, every value an
//   atomicAdd into it (ATOMIC_RMW is in the abstract contract), element
//   loads;
// - abstract+shuffle: no shared atomics.  Each lane keeps private 8-bit
//   counts in its warp's table of [bins][32] bytes (8 KB at 256 bins):
//   word k of lane l holds lane l's counts of bins 4k .. 4k + 3, a byte
//   each, so a lane touches only its own words (all in bank l) and counts
//   a value by a plain add.  Before any count can pass 255, every
//   kFlushTiles = 15 tiles (240 values a lane), the warp flushes: each
//   word's even and odd bytes go through lanes.cuh::lane_tree_reduce as
//   two pairs of 16-bit counts (at most 32 x 240 = 7,680 each: no carry),
//   5 __shfl_xor_sync stages for two bins, into 32-bit per-warp sums in
//   shared memory, and the table is zeroed.  At the end the warps' sums
//   are added in a fixed order.  This is the JAX mode's structure
//   (histogram.py:93-101): per-row privates merged by the rotate tree.
//   Element loads, as the abstract mode's;
// - native: one histogram per warp in shared memory (8 per block), so only
//   the 32 lanes of a warp contend for a bin, merged at the end of the
//   block; where the base is 16-byte aligned, 16-byte loads (4 values),
//   four a thread in flight, else element loads.
//
// Values are clipped into range, as histogram.py:129 does, not dropped;
// the ragged tail of the last tile is masked in the kernel (no sentinel
// padding).  The TPU's in-order accumulation into o_ref (histogram.py:115)
// has no other counterpart.
#include "common.cuh"
#include "lanes.cuh"

namespace uisa {

constexpr int kHistThreads = 256;
constexpr int kHistWarps = kHistThreads / 32;
constexpr int kHistLoads = 16;          // values a thread loads, then counts
constexpr int kHistTile = kHistThreads * kHistLoads;
// tiles between abstract+shuffle's flushes: 8-bit lane counts stay <= 255
constexpr int kFlushTiles = 255 / kHistLoads;
enum HistMode { kHistAbstract = 0, kHistShuffle = 1, kHistNative = 2 };

__device__ __forceinline__ int clip_bin(int v, int bins) {
  return min(max(v, 0), bins - 1);
}

// One int32 value, evict-first, where `on` (0 elsewhere); asm volatile, so
// the load starts where it is written, ahead of the counts.
__device__ __forceinline__ void load_cs(int& v, const int* p, bool on) {
  asm volatile(
      "{\n .reg .pred q;\n setp.ne.b32 q, %2, 0;\n mov.b32 %0, 0;\n"
      " @q ld.global.cs.b32 %0, [%1];\n}\n"
      : "=r"(v) : "l"(p), "r"((int)on));
}

// Four int32 values of a 16-byte vector, the same way.
__device__ __forceinline__ void load_cs(int4& v, const int4* p, bool on) {
  asm volatile(
      "{\n .reg .pred q;\n setp.ne.b32 q, %5, 0;\n mov.b32 %0, 0;\n"
      " mov.b32 %1, 0;\n mov.b32 %2, 0;\n mov.b32 %3, 0;\n"
      " @q ld.global.cs.v4.b32 {%0, %1, %2, %3}, [%4];\n}\n"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p), "r"((int)on));
}

// The walk over n elements of E (int, or int4: four values) in tiles of
// kHistTile values: block b takes tiles b, b + grid, ...; in each, this
// thread's elements u * 256 + threadIdx.x, all loaded before any is
// counted, and the next tile's loaded before these are counted (count(e)
// for each, after() at the end of each tile).
template <typename E, typename F, typename G>
__device__ __forceinline__ void walk_tiles(const E* __restrict__ v,
                                           long long n, F&& count,
                                           G&& after) {
  constexpr int kLoads = kHistLoads * sizeof(int) / sizeof(E);
  constexpr long long kTile = (long long)kLoads * kHistThreads;
  const long long tiles = (n + kTile - 1) / kTile;
  E q[kLoads], ahead[kLoads];
  auto load = [&](long long t, E (&r)[kLoads]) {
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const long long i = t * kTile + u * kHistThreads + threadIdx.x;
      load_cs(r[u], v + (i < n ? i : 0), i < n);
    }
  };
  load(blockIdx.x, ahead);
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
#pragma unroll
    for (int u = 0; u < kLoads; ++u) q[u] = ahead[u];
    load(t + gridDim.x, ahead);
    if ((t + 1) * kTile <= n) {
#pragma unroll
      for (int u = 0; u < kLoads; ++u) count(q[u]);
    } else {
#pragma unroll
      for (int u = 0; u < kLoads; ++u)
        if (t * kTile + u * kHistThreads + threadIdx.x < n) count(q[u]);
    }
    after();
  }
}

// abstract and native: shared-memory histograms updated by atomicAdd
template <int MODE>
__global__ void __launch_bounds__(kHistThreads)
histogram_kernel(const int* __restrict__ v, long long n, int bins,
                 int vector_ok, int* __restrict__ out) {
  extern __shared__ int hist[];           // copies x bins
  constexpr int kCopies = MODE == kHistNative ? kHistWarps : 1;
  for (int i = threadIdx.x; i < kCopies * bins; i += kHistThreads) hist[i] = 0;
  __syncthreads();
  int* mine = hist + (kCopies > 1 ? (threadIdx.x >> 5) * bins : 0);
  auto count = [&](int x) { atomicAdd(&mine[clip_bin(x, bins)], 1); };
  if (MODE == kHistNative && vector_ok) {
    // a tile is 1,024 vectors: vector u * 256 + threadIdx.x, u < 4
    const long long nv = n / 4;
    walk_tiles(reinterpret_cast<const int4*>(v), nv, [&](const int4& q) {
      count(q.x);
      count(q.y);
      count(q.z);
      count(q.w);
    }, [] {});
    // the < 4 values past the last vector: block 0's first threads
    if (blockIdx.x == 0 && threadIdx.x < n - nv * 4)
      count(v[nv * 4 + threadIdx.x]);
  } else {
    walk_tiles(v, n, count, [] {});
  }
  __syncthreads();
  for (int b = threadIdx.x; b < bins; b += kHistThreads) {
    int c = 0;
#pragma unroll
    for (int k = 0; k < kCopies; ++k) c += hist[k * bins + b];
    if (c) atomicAdd(&out[b], c);
  }
}

// abstract+shuffle's flush: each bin's 32 lane counts (8 bits) summed by
// the lane tree, two 16-bit counts a word, into the warp's 32-bit sums
// (`sums`, bins rounded up to 4); the lane's `words` table words zeroed.
// Lane j of a round of 32 words keeps word j's sums and adds them as one
// 16-byte update.  Every lane of the warp calls it.
__device__ __forceinline__ void flush_lanes(unsigned* table, int* sums,
                                            int words, int lane) {
  for (int k0 = 0; k0 < words; k0 += 32) {
    const int kn = min(32, words - k0);
    unsigned ev = 0u, od = 0u;
    for (int j = 0; j < kn; ++j) {
      unsigned* w = &table[(k0 + j) * 32 + lane];
      const unsigned c = *w;
      *w = 0u;
      // bins 4k and 4k + 2 (low and high half), then 4k + 1 and 4k + 3
      const unsigned e = lane_tree_reduce<32>(c & 0x00ff00ffu);
      const unsigned o = lane_tree_reduce<32>((c >> 8) & 0x00ff00ffu);
      if (lane == j) {
        ev = e;
        od = o;
      }
    }
    if (lane < kn) {
      int4* s = reinterpret_cast<int4*>(sums + 4 * (k0 + lane));
      int4 a = *s;
      a.x += (int)(ev & 0xffffu);
      a.y += (int)(od & 0xffffu);
      a.z += (int)(ev >> 16);
      a.w += (int)(od >> 16);
      *s = a;
    }
  }
}

// abstract+shuffle: per-lane 8-bit counts flushed through the lane tree
__global__ void __launch_bounds__(kHistThreads)
histogram_shuffle_kernel(const int* __restrict__ v, long long n, int bins,
                         int* __restrict__ out) {
  extern __shared__ __align__(16) unsigned lane_words[];
  const int words = (bins + 3) / 4;       // a lane's words, 4 bins each
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned* table = lane_words + warp * words * 32;    // [words][32]
  int* all_sums = reinterpret_cast<int*>(lane_words + kHistWarps * words * 32);
  int* sums = all_sums + warp * words * 4;             // [warps][words * 4]
  for (int i = lane; i < words * 32; i += 32) table[i] = 0u;
  for (int i = lane; i < words * 4; i += 32) sums[i] = 0;
  __syncwarp();
  int since = 0;                          // tiles since the last flush
  walk_tiles(v, n, [&](int x) {
    const int b = clip_bin(x, bins);
    table[(b >> 2) * 32 + lane] += 1u << ((b & 3) * 8);
  }, [&] {
    if (++since == kFlushTiles) {
      flush_lanes(table, sums, words, lane);
      since = 0;
    }
  });
  flush_lanes(table, sums, words, lane);
  __syncthreads();
  for (int b = threadIdx.x; b < bins; b += kHistThreads) {
    int c = 0;
#pragma unroll
    for (int k = 0; k < kHistWarps; ++k) c += all_sums[k * words * 4 + b];
    if (c) atomicAdd(&out[b], c);
  }
}

// Shared memory of a block: abstract one int32 histogram, native one a
// warp, abstract+shuffle a warp's [words][32] table of lane words and its
// int32 sums of 4 x words bins.
inline size_t hist_smem(int mode, int bins) {
  if (mode == kHistShuffle)
    return (size_t)((bins + 3) / 4) * kHistWarps * (32 + 4) * sizeof(int);
  return (size_t)(mode == kHistNative ? kHistWarps : 1) * bins * sizeof(int);
}

// The most bins a mode takes: its private counts fit the 227 KB (232,448
// bytes) of shared memory a block may have.
inline int max_bins(int mode) {
  if (mode == kHistShuffle)
    return (int)(232448 / hist_smem(kHistShuffle, 4)) * 4;
  return (int)(232448 / hist_smem(mode, 1));
}

inline const void* hist_kernel(int mode) {
  if (mode == kHistAbstract) return (const void*)histogram_kernel<kHistAbstract>;
  if (mode == kHistShuffle) return (const void*)histogram_shuffle_kernel;
  return (const void*)histogram_kernel<kHistNative>;
}

// The most blocks an SM the walk takes, by mode (0: as many as fit):
// abstract and native read fastest with few blocks an SM, 3 and 2 (fewer
// streams of tiles at a time), abstract+shuffle, whose lanes count by
// plain adds, with every block that fits (scripts/histogram_variants.py:
// no_cap, cap2, cap3).
constexpr int kHistBlocksPerSM[3] = {3, 0, 2};

constexpr int kDevices = 16;
// (bins, resident blocks) of the last grid asked by (mode, device); a
// namespace-scope array (internal linkage), so two builds of this library
// loaded in one process never share it
static int g_resident[3][kDevices][2];

// The persistent grid: the blocks of `mode` at `bins` resident on the
// current device (at most kHistBlocksPerSM an SM), or the tiles where
// there are fewer.  Opts the kernel
// into its shared memory past 48 KB first.
cudaError_t hist_grid(int mode, long long n, int bins, int* grid) {
  const void* kernel = hist_kernel(mode);
  const size_t smem = hist_smem(mode, bins);
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
  }
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int* cached = dev < kDevices ? g_resident[mode][dev] : nullptr;
  int resident = cached != nullptr && cached[0] == bins ? cached[1] : 0;
  if (resident == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          kHistThreads, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    const int cap = kHistBlocksPerSM[mode];
    if (cap > 0 && per_sm > cap) per_sm = cap;
    resident = per_sm * sms;
    if (cached != nullptr) {
      cached[0] = bins;
      cached[1] = resident;
    }
  }
  const long long tiles = (n + kHistTile - 1) / kHistTile;
  *grid = (int)(tiles < resident ? tiles : resident);
  return cudaSuccess;
}

bool hist_args_ok(int mode, long long n, int bins) {
  return n >= 0 && mode >= kHistAbstract && mode <= kHistNative &&
         bins >= 1 && bins <= max_bins(mode);
}

}  // namespace uisa

// mode: 0 abstract, 1 abstract+shuffle, 2 native.  v holds n contiguous
// int32 values; out receives bins int32 counts (zeroed here first).
extern "C" int uisa_histogram(int mode, const void* v, long long n, int bins,
                              void* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (!uisa::hist_args_ok(mode, n, bins)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(out, 0, (size_t)bins * sizeof(int), st);
  if (err != cudaSuccess || n == 0) return (int)err;
  int grid = 0;
  err = uisa::hist_grid(mode, n, bins, &grid);
  if (err != cudaSuccess) return (int)err;
  const int* vi = (const int*)v;
  int* o = (int*)out;
  const size_t smem = uisa::hist_smem(mode, bins);
  switch (mode) {
    case uisa::kHistAbstract:
      uisa::histogram_kernel<uisa::kHistAbstract>
          <<<grid, uisa::kHistThreads, smem, st>>>(vi, n, bins, 0, o);
      break;
    case uisa::kHistShuffle:
      uisa::histogram_shuffle_kernel<<<grid, uisa::kHistThreads, smem, st>>>(
          vi, n, bins, o);
      break;
    default:
      uisa::histogram_kernel<uisa::kHistNative>
          <<<grid, uisa::kHistThreads, smem, st>>>(
              vi, n, bins, ((uintptr_t)v % 16) == 0, o);
  }
  return (int)cudaGetLastError();
}

// The grid of the launch uisa_histogram(mode, v, n, bins, ...) makes on the
// current device (its persistent blocks), or -1 on an error.
extern "C" long long uisa_histogram_grid(int mode, long long n, int bins) {
  if (!uisa::hist_args_ok(mode, n, bins) || n == 0) return -1;
  int grid = -1;
  return uisa::hist_grid(mode, n, bins, &grid) == cudaSuccess ? grid : -1;
}

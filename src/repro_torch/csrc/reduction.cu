// Sum of all elements with f32 accumulation: the paper's reduction (Table
// V, row 2), the kernel behind §VII.C's shuffle finding.
//
// Replaces kernels/reduction.py::reduce_sum of the JAX package (the Pallas
// kernel _reduction_kernel), in its three kernel modes.
//
// What bounds it on the H100: bytes.  2^24 f32 values are 67.1 MB, 20.0 us
// at 3.35 TB/s; the adds are one per element.
//
// Every mode folds each thread's elements of a tile into one f32 register
// (thread t: base + t, base + t + 256, ..., in order), then runs the block's
// cross-lane stage: ``abstract`` scratch_tree_reduce (8 barrier-separated
// shared-memory stages over 256 threads, no shuffle); ``abstract+shuffle``
// and ``native`` warp_block_reduce (5 warp shuffles, one shared exchange
// of the 8 warp partials, 3 more shuffles).  Both are in lanes.cuh.  Each
// tile's f32 partial then joins a second pass: one block of 256 threads,
// thread t folding partials t, t + 256, ... in order, then the same
// cross-lane stage.  The TPU adds every grid step's partial into one
// scalar in grid order (reduction.py:90); Hopper's blocks run in no order,
// so the partials are summed in this fixed order instead, with no float
// atomics: the sum does not depend on the order the blocks ran in.
//
// Two routes, decided in uisa_reduce_sum alone and reported through its
// last argument:
//
// - "tile" (any tile but 512; the default 65,536, the JAX plan's cap of 512
//   rows x 128 lanes): one block of 256 threads a tile, so one block tree
//   is amortised over the whole tile, then a second launch of the same
//   kernel (one block, the same mode) over the partials.  Loads: one
//   element a load in the abstract modes; native folds 16-byte vectors (4
//   f32, 8 bf16 or 4 int32 a load, the elements of a vector added in
//   order), four in flight a thread, and a base off 16 bytes takes the
//   scalar loop.  Native's per-thread order is a vector's, not t, t + 256:
//   it equals the plain version within f32 rounding, not bitwise.
// - "persistent" (tile 512, 2 elements a thread: the classic kernel, one
//   tree per 512 elements, 32,768 trees at 2^24).  A block a tile retires
//   after one load round trip and its tree, and nothing overlaps a block's
//   loads with its own tree (at 2^24: 32,768 blocks in 31 waves; a trace
//   of that launch, scripts/reduction_trace.py, puts 87-90% of the call in
//   that first pass).  So the first pass is persistent: as many blocks as
//   are resident (cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs,
//   asked once a device) walk the tiles, block b tiles b, b + grid, ...,
//   each thread holding its two elements of the next kAhead tiles in
//   registers, so a tile's loads start two trees before its own (four or
//   six ran slower: ahead_4, ahead_6).  Every mode keeps thread t's
//   elements t and t + 256 of each tile, so the kernel equals the plain
//   version bitwise.  The loads are scalar, asm volatile (the compiler
//   keeps each where it is written) and evict-first (ld.global.cs: the
//   input passes through L2 once; plain loads timed the same).
//   Consecutive trees alternate between two scratch buffers (a tree reads
//   its scratch after its last barrier; the next tree's first barrier
//   would not order that read).  The second pass is a launch of its own,
//   a programmatic dependent of the first (it launches as the first pass
//   starts and waits at griddepcontrol.wait; an ordinary launch was about
//   a microsecond slower on the card: scripts/reduction_variants.py,
//   second_launch_plain), whose one block stages all the partials in
//   shared memory by cp.async at once and folds them (fold_partials;
//   fold_in_rounds and fold_registers were slower).
//   Native is abstract+shuffle's kernel at this tile: what its contract
//   adds ran no faster on the card, 16-byte cp.async loads into a shared
//   ring (native_vector) or the ticket ATOMIC_RMW allows, the last block
//   to finish folding the partials inside the first launch (native_ticket:
//   from registers, as shared memory for the fold would cut the blocks a
//   first-pass SM holds).
#include <type_traits>

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

// ---------------------------------------------------------------------------
// the persistent route (tile 512)
// ---------------------------------------------------------------------------

constexpr int kSmallTile = 2 * kRedThreads;  // 2 elements a thread
constexpr int kAhead = 2;                    // tiles in flight a thread
constexpr int kFoldStage = 16384;            // second pass: partials a half
constexpr int kFoldBytes = 2 * kFoldStage * 4;   // its two halves, 128 KB
static_assert(kAhead % 2 == 0, "trees alternate two scratch buffers");


// One element of x, evict-first (ld.global.cs), or 0 where `on` is false,
// as its raw bits; an asm volatile load keeps its place in the program,
// so it starts where it is written, kAhead trees before its use.
template <typename T> struct Elem;
template <> struct Elem<float> {
  using R = uint32_t;
  static __device__ __forceinline__ R load(const float* p, bool on) {
    R v;
    asm volatile(
        "{\n .reg .pred q;\n setp.ne.b32 q, %2, 0;\n mov.b32 %0, 0;\n"
        " @q ld.global.cs.b32 %0, [%1];\n}\n"
        : "=r"(v) : "l"(p), "r"((int)on));
    return v;
  }
  static __device__ __forceinline__ float f(R v) { return __uint_as_float(v); }
};
template <> struct Elem<int> {
  using R = uint32_t;
  static __device__ __forceinline__ R load(const int* p, bool on) {
    return Elem<float>::load((const float*)p, on);
  }
  static __device__ __forceinline__ float f(R v) { return (float)(int)v; }
};
template <> struct Elem<__nv_bfloat16> {
  using R = unsigned short;
  static __device__ __forceinline__ R load(const __nv_bfloat16* p, bool on) {
    R v;
    asm volatile(
        "{\n .reg .pred q;\n setp.ne.b32 q, %2, 0;\n mov.b16 %0, 0;\n"
        " @q ld.global.cs.b16 %0, [%1];\n}\n"
        : "=h"(v) : "l"(p), "r"((int)on));
    return v;
  }
  static __device__ __forceinline__ float f(R v) {
    return __uint_as_float((uint32_t)v << 16);
  }
};

template <int MODE>
__device__ __forceinline__ float block_tree(float v, float* scratch) {
  return MODE == kRedAbstract ? scratch_tree_reduce<kRedThreads>(v, scratch)
                              : warp_block_reduce<kRedThreads>(v, scratch);
}

__device__ __forceinline__ void red_cp_async(float* smem, const float* gmem,
                                             int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(bytes)
               : "memory");
}

// The second pass over `count` partials (16-byte aligned): thread t folds
// t, t + 256, ... in order, then the block's tree.  The partials reach
// shared memory in rounds of kFoldStage (all of them at once at 2^24), each
// round's 16-byte cp.async copies all in flight and the next round's
// started before this one is folded (two halves of `stage`, kFoldBytes).
// Returns the sum to every thread.
template <int MODE>
__device__ __forceinline__ float fold_partials(const float* __restrict__ p,
                                               long long count, float* stage,
                                               float* scratch) {
  const int tid = threadIdx.x;
  const long long rounds = (count + kFoldStage - 1) / kFoldStage;
  auto copy = [&](long long r) {
    if (r < rounds) {
      const long long base = r * kFoldStage;
      const long long len = min((long long)kFoldStage, count - base);
      float* half = stage + (r & 1) * kFoldStage;
      for (int c = tid; c < (len + 3) / 4; c += kRedThreads) {
        const long long left = (len - 4LL * c) * 4;
        red_cp_async(half + 4 * c, p + base + 4 * c,
                     left >= 16 ? 16 : (int)left);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  float acc = 0.f;
  copy(0);
  for (long long r = 0; r < rounds; ++r) {
    copy(r + 1);
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();                 // round r is in
    const long long base = r * kFoldStage;
    const int len = (int)min((long long)kFoldStage, count - base);
    const float* half = stage + (r & 1) * kFoldStage;
    // thread t's first index of the round: i = t + 256 k >= base
    int j = (int)(((tid - base) % kRedThreads + kRedThreads) % kRedThreads);
    for (; j < len; j += kRedThreads) acc += half[j];
    __syncthreads();                 // the half is free for round r + 2
  }
  return block_tree<MODE>(acc, scratch);
}

// The persistent first pass: block b walks tiles b, b + grid, ...;
// thread t keeps its two elements of each of the next kAhead tiles in
// registers (loads marked evict-first), adds the current tile's two to 0
// and runs the tree, thread 0 storing the tile's partial.  The second
// pass is reduce_partials_kernel.  A single tile's tree goes to `out`
// directly.
template <int MODE, typename T>
__global__ void __launch_bounds__(kRedThreads)
reduce_tiles_kernel(const T* __restrict__ x, long long n, long long tiles,
                    float* __restrict__ part, float* __restrict__ out) {
  using E = Elem<T>;
  __shared__ float scratch[2][kRedThreads];
  asm volatile("griddepcontrol.launch_dependents;");
  float* dst = tiles == 1 ? out : part;
  const long long step = gridDim.x;
  typename E::R v[kAhead][2];
  auto load = [&](long long tile, typename E::R (&r)[2]) {
    const long long i = tile * kSmallTile + threadIdx.x;
    const bool on0 = tile < tiles && i < n;
    const bool on1 = tile < tiles && i + kRedThreads < n;
    r[0] = E::load(x + (on0 ? i : 0), on0);
    r[1] = E::load(x + (on1 ? i + kRedThreads : 0), on1);
  };
#pragma unroll
  for (int j = 0; j < kAhead; ++j) load(blockIdx.x + j * step, v[j]);
  for (long long t0 = blockIdx.x; t0 < tiles; t0 += kAhead * step) {
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      const long long tile = t0 + j * step;
      if (tile >= tiles) break;
      float acc = 0.f;
      acc += E::f(v[j][0]);
      acc += E::f(v[j][1]);
      load(tile + kAhead * step, v[j]);
      const float s = block_tree<MODE>(acc, scratch[j & 1]);
      if (threadIdx.x == 0) dst[tile] = s;
    }
  }
}

// The second pass, a programmatic dependent of the first.
template <int MODE>
__global__ void __launch_bounds__(kRedThreads)
reduce_partials_kernel(const float* __restrict__ part, long long count,
                       float* __restrict__ out) {
  __shared__ float scratch[kRedThreads];
  extern __shared__ __align__(16) float red_stage[];     // kFoldBytes
  asm volatile("griddepcontrol.wait;" ::: "memory");   // the partials
  const float s = fold_partials<MODE>(part, count, red_stage, scratch);
  if (threadIdx.x == 0) *out = s;
}

// The first pass's grid: as many blocks as are resident on the current
// device (asked once a device), or the tiles where there are fewer.
template <typename T> constexpr int dtype_index() {
  return std::is_same<T, float>::value ? 0
         : std::is_same<T, int>::value ? 1 : 2;
}

constexpr int kDevices = 16;
// resident blocks by (mode, dtype, device), 0 where not asked yet; a
// namespace-scope array (internal linkage), so two builds of this library
// loaded in one process never share it
static int g_resident[3][3][kDevices];

template <int MODE, typename T>
cudaError_t persistent_grid(long long tiles, int* grid) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int* cached = dev < kDevices ? &g_resident[MODE][dtype_index<T>()][dev]
                               : nullptr;
  int resident = cached != nullptr ? *cached : 0;
  if (resident == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, reduce_tiles_kernel<MODE, T>, kRedThreads, 0);
    if (err != cudaSuccess) return err;
    resident = per_sm * sms;
    if (cached != nullptr) *cached = resident;
  }
  *grid = (int)(tiles < resident ? tiles : resident);
  return cudaSuccess;
}

template <int MODE, typename T>
cudaError_t launch_persistent(const T* x, long long n, float* partials,
                              float* out, cudaStream_t st) {
  const long long tiles = (n + kSmallTile - 1) / kSmallTile;
  int grid = 0;
  cudaError_t err = persistent_grid<MODE, T>(tiles, &grid);
  if (err != cudaSuccess) return err;
  reduce_tiles_kernel<MODE, T><<<grid, kRedThreads, 0, st>>>(
      x, n, tiles, partials, out);
  err = cudaGetLastError();
  if (err != cudaSuccess || tiles == 1) return err;
  err = cudaFuncSetAttribute(reduce_partials_kernel<MODE>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kFoldBytes);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1);
  cfg.blockDim = dim3(kRedThreads);
  cfg.dynamicSmemBytes = kFoldBytes;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, reduce_partials_kernel<MODE>,
                           (const float*)partials, tiles, out);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int MODE, typename T>
cudaError_t route_persistent(const T* x, long long n, float* partials,
                             float* out, cudaStream_t st, int* grid) {
  if (grid != nullptr)
    return persistent_grid<MODE, T>((n + kSmallTile - 1) / kSmallTile, grid);
  return launch_persistent<MODE, T>(x, n, partials, out, st);
}

// The route of a launch: 4 persistent (tile 512), 5 tile.
inline int reduce_route(long long tile) { return tile == kSmallTile ? 4 : 5; }

// The launch of (mode, T): with `grid`, only the persistent route's first
// pass grid is computed into it.
template <typename T>
cudaError_t dispatch_mode(int mode, const void* x, long long n, long long tile,
                          float* partials, float* out, cudaStream_t st,
                          int* grid = nullptr) {
  const T* xt = (const T*)x;
  if (reduce_route(tile) == 4) {
    switch (mode) {
      case kRedAbstract:
        return route_persistent<kRedAbstract>(xt, n, partials, out, st, grid);
      case kRedShuffle:
        return route_persistent<kRedShuffle>(xt, n, partials, out, st, grid);
      case kRedNative:
        return route_persistent<kRedNative>(xt, n, partials, out, st, grid);
    }
    return cudaErrorInvalidValue;
  }
  if (grid != nullptr) {
    *grid = (int)((n + tile - 1) / tile);
    return cudaSuccess;
  }
  switch (mode) {
    case kRedAbstract: return launch_reduce<kRedAbstract>(xt, n, tile, partials, out, st);
    case kRedShuffle: return launch_reduce<kRedShuffle>(xt, n, tile, partials, out, st);
    case kRedNative: return launch_reduce<kRedNative>(xt, n, tile, partials, out, st);
  }
  return cudaErrorInvalidValue;
}

template <typename... Args>
cudaError_t dispatch_dtype(int dtype, Args... args) {
  switch (dtype) {
    case kRedF32: return dispatch_mode<float>(args...);
    case kRedBF16: return dispatch_mode<__nv_bfloat16>(args...);
    case kRedI32: return dispatch_mode<int>(args...);
  }
  return cudaErrorInvalidValue;
}

}  // namespace uisa

// mode: 0 abstract, 1 abstract+shuffle, 2 native; dtype: 0 f32, 1 bf16,
// 2 int32.  x holds n contiguous elements; tile (elements per block) is a
// positive multiple of 8, so every block starts on a 16-byte vector of any
// dtype; partials holds ceil(n / tile) f32 values (unused when that is
// 1); out receives the f32 sum; *route is set to the route taken (4
// persistent, 5 tile).
extern "C" int uisa_reduce_sum(int mode, int dtype, const void* x, long long n,
                               long long tile, void* partials, void* out,
                               void* stream, int* route) {
  cudaStream_t st = (cudaStream_t)stream;
  if (tile <= 0 || tile % 8 != 0 || n < 0) return (int)cudaErrorInvalidValue;
  *route = uisa::reduce_route(tile);
  if (n == 0) return (int)cudaMemsetAsync(out, 0, sizeof(float), st);
  return (int)uisa::dispatch_dtype(dtype, mode, x, n, tile, (float*)partials,
                                   (float*)out, st);
}

// The first pass's grid of the launch uisa_reduce_sum(mode, dtype, x, n,
// tile, ...) makes on the current device (the persistent route's resident
// blocks; the tile route's tiles), or -1 on an error; *route as there.
extern "C" long long uisa_reduce_sum_grid(int mode, int dtype, const void* x,
                                          long long n, long long tile,
                                          int* route) {
  if (tile <= 0 || tile % 8 != 0 || n <= 0) return -1;
  *route = uisa::reduce_route(tile);
  int grid = -1;
  if (uisa::dispatch_dtype(dtype, mode, x, n, tile, (float*)nullptr,
                           (float*)nullptr, (cudaStream_t)0, &grid) !=
      cudaSuccess)
    return -1;
  return grid;
}

// The lane primitives of the UISA model as device functions for Hopper.
//
// Replaces core/shuffle.py of the JAX package (lane_shuffle_down/up/xor,
// lane_tree_reduce, scratch_tree_reduce; no pallas_call there: they run
// inside the TPU kernels).  The plain tensor versions are in the port's
// core/shuffle.py.
//
// On the TPU the "wave" is the 128-lane vreg and a shuffle is a lane
// rotation (pltpu.roll).  On Hopper it is a warp of 32 threads and a
// shuffle is __shfl_*_sync, so every stage count changes: a warp tree is
// log2(32) = 5 shuffles, a block tree through shared memory is
// log2(blockDim) barrier-separated stages.  The width is a template
// parameter (a power of two, at most 32 for the shuffles), never assumed.
//
// - lane_shuffle_down/up: the rotate flavour of the JAX package (lane i
//   receives lane (i +/- delta) mod W), through __shfl_sync, so the device
//   and plain versions agree lane for lane.  (__shfl_down_sync itself
//   does not wrap.)
// - lane_shuffle_xor: __shfl_xor_sync.
// - lane_tree_reduce: the xor butterfly; every lane ends with the full
//   reduction, as after the JAX rotate tree (the order of the adds
//   differs, the result is the same allreduce).
// - scratch_tree_reduce: primitive 11 left out.  Every thread stores its
//   value to shared memory and each halving stage reads two halves and
//   stores one, with one __syncthreads per stage; the barriers and the
//   shared-memory round trips are what the paper's abstract NVIDIA
//   reduction paid for (§VII.C).
// - row_scratch_tree_reduce: the same tree, one per W-thread group of the
//   block (a row per warp in the row norms): each group halves its own W
//   values, the barriers stay block-wide.
// - warp_block_reduce: the abstract+shuffle block stage: a warp butterfly,
//   one shared-memory exchange of the per-warp partials, a final
//   butterfly in the first warp.
// - lane_inclusive_scan: the Hillis-Steele inclusive scan over each W-lane
//   group in registers: log2(W) stages, each a lane_shuffle_up by a doubling
//   offset added where the lane index is >= the offset (the JAX package's
//   _prefix_sum, abstract+shuffle branch).
// - scratch_inclusive_scan: the same scan over a block of N threads without
//   a shuffle: each of its log2(N) stages stores every value to shared
//   memory, waits at a barrier, reloads the value `offset` threads back and
//   adds it, and waits again before the next store (the abstract branch:
//   two __syncthreads a stage).
#pragma once
#include <cuda_runtime.h>

namespace uisa {

constexpr unsigned kFullMask = 0xffffffffu;

struct Add {
  template <typename T> __device__ __forceinline__ T operator()(T a, T b) const {
    return a + b;
  }
};

template <int W = 32, typename T>
__device__ __forceinline__ T lane_shuffle_down(T v, int delta) {
  static_assert(W > 0 && W <= 32 && (W & (W - 1)) == 0, "W: power of two <= 32");
  const int lane = threadIdx.x & (W - 1);
  return __shfl_sync(kFullMask, v, (lane + delta) & (W - 1), W);
}

template <int W = 32, typename T>
__device__ __forceinline__ T lane_shuffle_up(T v, int delta) {
  static_assert(W > 0 && W <= 32 && (W & (W - 1)) == 0, "W: power of two <= 32");
  const int lane = threadIdx.x & (W - 1);
  return __shfl_sync(kFullMask, v, (lane - delta) & (W - 1), W);
}

template <int W = 32, typename T>
__device__ __forceinline__ T lane_shuffle_xor(T v, int mask) {
  static_assert(W > 0 && W <= 32 && (W & (W - 1)) == 0, "W: power of two <= 32");
  return __shfl_xor_sync(kFullMask, v, mask, W);
}

// log2(W) butterfly stages; every lane of each W-wide group ends with the
// group's reduction.  Every lane of the warp must call it.
template <int W = 32, typename T, typename Op = Add>
__device__ __forceinline__ T lane_tree_reduce(T v, Op op = Op()) {
#pragma unroll
  for (int o = W / 2; o > 0; o >>= 1) v = op(v, lane_shuffle_xor<W>(v, o));
  return v;
}

// The shuffle-free tree over a block of N threads (a power of two, the
// block's size): log2(N) halving stages through ``scratch`` (N values of
// shared memory), one __syncthreads per stage.  Returns the reduction to
// every thread.  ``scratch`` may be reused once every thread has returned.
template <int N, typename T, typename Op = Add>
__device__ __forceinline__ T scratch_tree_reduce(T v, T* scratch, Op op = Op()) {
  static_assert(N > 0 && (N & (N - 1)) == 0, "N: power of two");
  const int t = threadIdx.x;
  scratch[t] = v;
#pragma unroll
  for (int w = N / 2; w >= 1; w >>= 1) {
    __syncthreads();
    if (t < w) scratch[t] = op(scratch[t], scratch[t + w]);
  }
  __syncthreads();
  return scratch[0];
}

// scratch_tree_reduce per W-thread group (W a power of two dividing the
// block's size): log2(W) halving stages through ``scratch`` (blockDim.x
// values of shared memory), one __syncthreads per stage, so every thread
// of the block must call it.  Returns each group's reduction to the
// group's threads.  ``scratch`` may be reused once every thread has
// returned.
template <int W, typename T, typename Op = Add>
__device__ __forceinline__ T row_scratch_tree_reduce(T v, T* scratch,
                                                     Op op = Op()) {
  static_assert(W > 0 && (W & (W - 1)) == 0, "W: power of two");
  const int t = threadIdx.x, i = t & (W - 1);
  scratch[t] = v;
#pragma unroll
  for (int w = W / 2; w >= 1; w >>= 1) {
    __syncthreads();
    if (i < w) scratch[t] = op(scratch[t], scratch[t + w]);
  }
  __syncthreads();
  return scratch[t - i];
}

// The shuffle block stage over a block of N threads (a multiple of 32,
// at most 1024): 5 butterfly stages in every warp, the N/32 warp partials
// through ``scratch`` (N/32 values of shared memory, one __syncthreads),
// then log2(N/32) butterfly stages in every warp over those partials.
// Returns the reduction to every thread.
template <int N, typename T, typename Op = Add>
__device__ __forceinline__ T warp_block_reduce(T v, T* scratch, Op op = Op()) {
  static_assert(N % 32 == 0 && N <= 1024, "N: a multiple of 32, <= 1024");
  constexpr int kWarps = N / 32;
  static_assert((kWarps & (kWarps - 1)) == 0, "N/32: power of two");
  v = lane_tree_reduce<32>(v, op);
  if constexpr (kWarps == 1) {
    return v;
  } else {
    const int t = threadIdx.x;
    if ((t & 31) == 0) scratch[t >> 5] = v;
    __syncthreads();
    v = scratch[t & (kWarps - 1)];
    return lane_tree_reduce<kWarps>(v, op);
  }
}

// Inclusive scan over each W-lane group (W a power of two <= 32): after
// log2(W) stages lane i holds op(v_0, ..., v_i) of its group, entirely in
// registers.  Every lane of the warp must call it.
template <int W = 32, typename T, typename Op = Add>
__device__ __forceinline__ T lane_inclusive_scan(T v, Op op = Op()) {
  const int lane = threadIdx.x & (W - 1);
#pragma unroll
  for (int o = 1; o < W; o <<= 1) {
    const T u = lane_shuffle_up<W>(v, o);
    if (lane >= o) v = op(v, u);
  }
  return v;
}

// The shuffle-free inclusive scan over a block of N threads (a power of
// two, the block's size): log2(N) stages through ``scratch`` (N values of
// shared memory), each a store, a __syncthreads, the reload of the value
// `offset` threads back and a second __syncthreads before the next store.
// Returns thread t's op(v_0, ..., v_t); ``scratch`` may be reused at once.
template <int N, typename T, typename Op = Add>
__device__ __forceinline__ T scratch_inclusive_scan(T v, T* scratch,
                                                    Op op = Op()) {
  static_assert(N > 0 && (N & (N - 1)) == 0, "N: power of two");
  const int t = threadIdx.x;
#pragma unroll
  for (int o = 1; o < N; o <<= 1) {
    scratch[t] = v;
    __syncthreads();
    if (t >= o) v = op(v, scratch[t - o]);
    __syncthreads();
  }
  return v;
}

}  // namespace uisa

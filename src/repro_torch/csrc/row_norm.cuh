// Row-wise RMSNorm, optionally with the residual add as its load stage:
//   s = x (+ r)                      in f32 (stored at T when adding)
//   out = s * rsqrt(mean(s^2) + eps) * w   in f32, stored at T.
// Shared by rmsnorm.cu and add_rmsnorm.cu.
//
// Replaces the row code of the JAX package's kernels/rmsnorm.py
// (_rmsnorm_kernel over normalize_block) and kernels/fused.py
// (_add_rmsnorm_kernel).  The moment of add_rmsnorm is taken from the f32
// sum, not from the rounded s, as _add_rmsnorm_kernel takes it.
//
// Bound on Hopper: bytes.  A row is read once from device memory (x, and
// r when adding), the weight row once per block (then from L1/L2), and the
// outputs written once: 2 x 512 x 1536 x 2 bytes = 3.1 MB for rmsnorm over
// a 512-token prefill at d_model 1536 (0.94 us at 3.35 TB/s).  At decode
// (8 rows) the kernel is bound by its launch, not by either.
//
// Design, right and simple first: one warp per row, four rows per 128-
// thread block (a 512-row prefill is 128 blocks).  Pass 1 loads the row
// (16-byte vectors where every base is 16-byte aligned and D is a multiple
// of the vector; scalar loads otherwise), adds the residual, stores s and
// sums the squares in f32 over the true D; the warp's partial sums finish
// in the fixed-order xor butterfly of lanes.cuh (lane_tree_reduce), so
// the result does not depend on scheduling.  Pass 2 re-reads the row (from
// L1/L2: one warp's row is 3-6 KB at d_model 1536) and writes the norm.
//
// The modes (the JAX package's abstract and abstract+shuffle lowerings of
// both kernels, kernels/rmsnorm.py::normalize_block, which
// _add_rmsnorm_kernel shares): the moment's cross-lane stage is the only
// one, so MODE is a template argument of row_norm_kernel, native's text
// verbatim behind `if constexpr`.  Both other modes load one element at a
// time, as the JAX lowerings fold the row to lanes with plain loads; the
// 16-byte vectors stay native's.
//   - abstract+shuffle: the native loop with element loads: each lane's
//     partial sum of squares, then the xor butterfly (lane_tree_reduce).
//   - abstract (row_norm_abstract): no shuffle.  The partial sums go
//     through a halving tree in shared memory per row
//     (row_scratch_tree_reduce: 5 stages, one block-wide __syncthreads
//     each), and the moment is re-staged through shared memory before the
//     normalize pass, as the JAX kernel re-stages it.  A block-wide
//     barrier needs every warp, so no warp leaves early: a row past M
//     carries zeros through the tree and stores nothing.
#pragma once
#include "common.cuh"
#include "lanes.cuh"

namespace uisa {

constexpr int kNormWarps = 4;   // rows per block, one warp each

// V consecutive elements of T as f32 (V * sizeof(T) == 16: one vector load)
template <typename T, int V>
__device__ __forceinline__ void load_f(const T* __restrict__ p, float* f) {
  if constexpr (V == 1) {
    f[0] = to_f(p[0]);
  } else {
    static_assert(V * sizeof(T) == 16, "one 16-byte vector");
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int i = 0; i < V; ++i) f[i] = to_f(e[i]);
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_f(T* __restrict__ p, const float* f) {
  if constexpr (V == 1) {
    p[0] = from_f<T>(f[0]);
  } else {
    uint4 u;
    T* e = reinterpret_cast<T*>(&u);
#pragma unroll
    for (int i = 0; i < V; ++i) e[i] = from_f<T>(f[i]);
    *reinterpret_cast<uint4*>(p) = u;
  }
}

// s = x (+ r) for V elements at row offset i
template <typename T, int V, bool ADD>
__device__ __forceinline__ void load_sum(const T* __restrict__ x,
                                         const T* __restrict__ r, size_t i,
                                         float* s) {
  load_f<T, V>(x + i, s);
  if constexpr (ADD) {
    float t[V];
    load_f<T, V>(r + i, t);
#pragma unroll
    for (int j = 0; j < V; ++j) s[j] += t[j];
  }
}

// abstract: the moment through a shared-memory tree per row, re-staged
// through shared memory; every warp reaches every barrier
template <typename T, bool ADD>
__device__ __forceinline__ void row_norm_abstract(
    const T* __restrict__ x, const T* __restrict__ r, const T* __restrict__ w,
    T* __restrict__ out, T* __restrict__ sum_out, int M, int D, float eps) {
  __shared__ float tree[kNormWarps * 32];
  __shared__ float moment[kNormWarps];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int row = blockIdx.x * kNormWarps + wid;
  const bool live = row < M;            // a dead row carries zeros
  const size_t base = (size_t)row * D;
  float ss = 0.f;
  if (live) {
    for (int i = lane; i < D; i += 32) {
      float s;
      load_sum<T, 1, ADD>(x, r, base + i, &s);
      if constexpr (ADD) store_f<T, 1>(sum_out + base + i, &s);
      ss += s * s;
    }
  }
  const float sum = row_scratch_tree_reduce<32>(ss, tree);
  if (lane == 0) moment[wid] = sum / (float)D;      // the re-stage
  __syncthreads();
  if (!live) return;
  const float inv = rsqrtf(moment[wid] + eps);
  for (int i = lane; i < D; i += 32) {
    float s, wv;
    load_sum<T, 1, ADD>(x, r, base + i, &s);
    load_f<T, 1>(w + i, &wv);
    s = s * inv * wv;
    store_f<T, 1>(out + base + i, &s);
  }
}

template <typename T, bool ADD, bool VEC, int MODE = kNative>
__global__ void __launch_bounds__(kNormWarps * 32)
row_norm_kernel(const T* __restrict__ x, const T* __restrict__ r,
                const T* __restrict__ w, T* __restrict__ out,
                T* __restrict__ sum_out, int M, int D, float eps) {
  static_assert(MODE == kNative || !VEC, "the modes load elements");
  if constexpr (MODE == kAbstract) {
    row_norm_abstract<T, ADD>(x, r, w, out, sum_out, M, D, eps);
    return;
  }
  // native, and abstract+shuffle as its element-load form (VEC false)
  constexpr int V = VEC ? 16 / (int)sizeof(T) : 1;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kNormWarps + (threadIdx.x >> 5);
  if (row >= M) return;                 // the whole warp leaves together
  const size_t base = (size_t)row * D;
  float ss = 0.f;
  for (int i = lane * V; i < D; i += 32 * V) {
    float s[V];
    load_sum<T, V, ADD>(x, r, base + i, s);
    if constexpr (ADD) store_f<T, V>(sum_out + base + i, s);
#pragma unroll
    for (int j = 0; j < V; ++j) ss += s[j] * s[j];
  }
  ss = lane_tree_reduce<32>(ss);
  const float inv = rsqrtf(ss / (float)D + eps);
  for (int i = lane * V; i < D; i += 32 * V) {
    float s[V], wv[V];
    load_sum<T, V, ADD>(x, r, base + i, s);
    load_f<T, V>(w + i, wv);
#pragma unroll
    for (int j = 0; j < V; ++j) s[j] = s[j] * inv * wv[j];
    store_f<T, V>(out + base + i, s);
  }
}

inline bool aligned16(const void* p) {
  return p == nullptr || ((uintptr_t)p & 15) == 0;
}

// r and sum_out are nullptr unless ADD.  MODE picks the moment's
// cross-lane stage; outside native the loads are element loads.  Returns
// cudaGetLastError().
template <typename T, bool ADD, int MODE = kNative>
cudaError_t launch_row_norm(const void* x, const void* r, const void* w,
                            void* out, void* sum_out, int M, int D, float eps,
                            cudaStream_t st) {
  const dim3 grid((M + kNormWarps - 1) / kNormWarps);
  if constexpr (MODE != kNative) {
    row_norm_kernel<T, ADD, false, MODE><<<grid, kNormWarps * 32, 0, st>>>(
        (const T*)x, (const T*)r, (const T*)w, (T*)out, (T*)sum_out, M, D,
        eps);
    return cudaGetLastError();
  }
  const bool vec = D % (16 / (int)sizeof(T)) == 0 && aligned16(x) &&
                   aligned16(r) && aligned16(w) && aligned16(out) &&
                   aligned16(sum_out);
  if (vec)
    row_norm_kernel<T, ADD, true><<<grid, kNormWarps * 32, 0, st>>>(
        (const T*)x, (const T*)r, (const T*)w, (T*)out, (T*)sum_out, M, D,
        eps);
  else
    row_norm_kernel<T, ADD, false><<<grid, kNormWarps * 32, 0, st>>>(
        (const T*)x, (const T*)r, (const T*)w, (T*)out, (T*)sum_out, M, D,
        eps);
  return cudaGetLastError();
}

}  // namespace uisa

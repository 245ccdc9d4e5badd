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
// Bound on Hopper: bytes.  Each byte of x (and r), and of w, is read once,
// each output byte written once: 2 x 512 x 5120 x 2 bytes = 10.5 MB for
// rmsnorm over a 512-token prefill at mamba2's d_inner (3.1 us at 3.35
// TB/s); 8 rows of 1536 move 50 KB (0.015 us).  At decode the floor is the
// launch and one memory round trip: on CUDA events with L2 flushed (the
// median of five readings of chip_smoke.py::time_ms) an empty kernel reads
// 4.7-5.0 us, a kernel that only loads w (D elements, 16-byte loads)
// 5.3-5.7 us; on the device (torch.profiler) 0.9 and 1.25-1.45 us (H100
// 80GB HBM3, 700 W; scripts/row_norm_variants.py).  A decode row comes
// close to that floor, and a prefill row close to its bytes, only if a
// row costs one memory round trip: here 6.0-6.6 us at decode (2.0-2.3 us
// on the device), and 512 x 5120 in 4.6 us of device time (1.5x its
// bytes).
//
// Design (the one-pass routes, `vector` and `element`): the row is held in
// registers.  A row is cut into 16-byte slots (8 bf16 or 4 f32 elements);
// a row takes T threads (a multiple of 32, at most kRowMaxThreads) and
// each thread holds NV slots (1, 2, 4 or 8: the fewest that fit), slot
// t + k*T for k < NV (row_plan).  Every load of a thread's share (x, r, and
// w, which does not depend on the moment) goes out before its first
// arithmetic, into packed 16-byte registers; the sum of squares, the sum's
// store, the normalize and the output's store then work from those
// registers, so nothing is read twice.  Each thread folds its slots in
// order (k, then the slot's elements, by FMA); each warp runs the xor
// butterfly (lanes.cuh::lane_tree_reduce); the warps' partials go through
// shared memory behind one barrier, and every thread sums its row's
// partials in warp order, so the moment does not depend on scheduling and
// every thread holds the same one.  At a prefill of rows of two slots a
// thread or more, w is loaded after the moment (row_plan).  Rows narrower
// than 4 warps are packed into a block of at least 128 threads; every row
// wider is a block of its own (a 512-row prefill is 512 blocks, one wave).
// `vector` loads each
// slot as one 16-byte load (native, D a multiple of the slot and every
// operand 16-byte aligned); `element` loads the same slot an element at a
// time (a width off the slot, e.g. 1539, an unaligned base, and every
// mode but native), with the same split and the same fold: both give the
// same bits.  A row wider than the registers hold (more than
// kRowMaxThreads x kRowMaxSlots slots: bf16 past 32768, f32 past 16384)
// takes the `loop` route, the two-pass schedule below.  The C entry
// decides the route and reports it; neither route falls back on the other.
//
// The modes (the JAX package's abstract and abstract+shuffle lowerings of
// both kernels, kernels/rmsnorm.py::normalize_block, which
// _add_rmsnorm_kernel shares) take the same schedule and the same split,
// and differ from native only where the JAX lowerings do: element loads,
// and the moment's cross-lane stage.
//   - abstract+shuffle: the butterfly and warp order above: its moment is
//     native's, bit for bit.
//   - abstract: no shuffle.  The threads' partial sums go through a
//     halving tree in shared memory over the row's T threads, padded with
//     zeros to a power of two P (log2 P stages, one block-wide barrier
//     each), and the moment is re-staged through shared memory before the
//     normalize, as the JAX kernel re-stages it.
//
// The loop route (the former schedule, kept for the widest rows): one
// warp per row, four rows per 128-thread block.  Pass 1 loads the row (16-
// byte vectors where every base is 16-byte aligned and D is a multiple of
// the vector; scalar loads otherwise), adds the residual, stores s and sums
// the squares in f32 over the true D; the warp's partial sums finish in
// the xor butterfly.  Pass 2 re-reads the row (from L1/L2) and w, and
// writes the norm.  Its modes: element loads; abstract through a halving
// tree in shared memory per row (row_scratch_tree_reduce: 5 stages) and the
// moment re-staged; a block-wide barrier needs every warp, so no warp
// leaves early: a row past M carries zeros through the tree.
#pragma once
#include "common.cuh"
#include "lanes.cuh"

namespace uisa {

constexpr int kNormWarps = 4;   // loop route: rows per block, one warp each
constexpr int kRowMaxThreads = 512;  // one-pass routes: threads a row, max
constexpr int kRowMaxSlots = 8;      // 16-byte slots a thread, max
constexpr int kRowPackThreads = 128; // narrower rows are packed to this
constexpr int kRowLateW = 128;  // past this many rows, w may load late
// threads a block, at most: a row, or packed rows (<= 192 threads, and
// their abstract trees, <= 2 x 128)
constexpr int kRowMaxBlock =
    kRowMaxThreads > 2 * kRowPackThreads ? kRowMaxThreads
                                         : 2 * kRowPackThreads;

// the routes the C entries report (kernels/_launch.py::ROUTES)
enum RowNormRoute { kRowVector = 6, kRowElement = 7, kRowLoop = 8 };

struct RowPlan {
  int route;    // kRowVector, kRowElement or kRowLoop
  int slots;    // NV: 16-byte slots a thread (one-pass routes)
  int threads;  // T: threads a row
  int rows;     // R: rows a block
  bool late_w;  // w loaded after the moment, not with x
};

// The split of a row of D elements of `elem_bytes` bytes
// (kernels/fused.py::row_norm_plan mirrors the split): the fewest slots a
// thread, as a power of two, with at most kRowMaxThreads threads a row.
// The split depends on D alone, so a row's result does not depend on the
// batch.  Where more than kRowLateW rows give each thread two slots or
// more, w is loaded after the moment: every block reads the same w, an L2
// hit by then, and the x loads alone keep enough bytes in flight (512 x
// 5120: 0.7 us less in one call; at decode w loaded late costs 0.2-0.3 us,
// and with one slot a thread it gains nothing; scripts/
// row_norm_variants.py, w_with_x and w_after_moment).
inline RowPlan row_plan(int M, int D, int elem_bytes, bool vec) {
  const int g = 16 / elem_bytes;
  const int nslot = (D + g - 1) / g;
  for (int nv = 1; nv <= kRowMaxSlots; nv *= 2) {
    if (nv * kRowMaxThreads < nslot) continue;
    const int per = nslot > nv ? (nslot + nv - 1) / nv : 1;
    const int threads = (per + 31) / 32 * 32;
    const int rows = threads >= kRowPackThreads
                         ? 1
                         : (kRowPackThreads + threads - 1) / threads;
    return {vec ? kRowVector : kRowElement, nv, threads, rows,
            M > kRowLateW && nv > 1};
  }
  return {kRowLoop, 0, 32, kNormWarps, false};
}

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

// ---------------------------------------------------------------------------
// The one-pass routes: the row held in registers
// ---------------------------------------------------------------------------

// One 16-byte slot (G elements of T) at p, of which `left` (>= 1) lie in
// the row: one vector load, or an element load each, the rest zero.
template <typename T, bool VEC>
__device__ __forceinline__ uint4 load_slot(const T* __restrict__ p,
                                           int left) {
  if constexpr (VEC) {
    return *reinterpret_cast<const uint4*>(p);
  } else {
    constexpr int G = 16 / (int)sizeof(T);
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    T* e = reinterpret_cast<T*>(&u);
#pragma unroll
    for (int i = 0; i < G; ++i)
      if (i < left) e[i] = p[i];
    return u;
  }
}

template <typename T>
__device__ __forceinline__ void slot_f(const uint4& u, float* f) {
  const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int i = 0; i < 16 / (int)sizeof(T); ++i) f[i] = to_f(e[i]);
}

template <typename T, bool VEC>
__device__ __forceinline__ void store_slot(T* __restrict__ p, const float* f,
                                           int left) {
  constexpr int G = 16 / (int)sizeof(T);
  if constexpr (VEC) {
    store_f<T, G>(p, f);
  } else {
#pragma unroll
    for (int i = 0; i < G; ++i)
      if (i < left) p[i] = from_f<T>(f[i]);
  }
}

// s = x (+ r) in f32 from a slot's registers
template <typename T, bool ADD>
__device__ __forceinline__ void slot_sum(const uint4& xv, const uint4& rv,
                                         float* s) {
  slot_f<T>(xv, s);
  if constexpr (ADD) {
    constexpr int G = 16 / (int)sizeof(T);
    float t[G];
    slot_f<T>(rv, t);
#pragma unroll
    for (int i = 0; i < G; ++i) s[i] += t[i];
  }
}

// A block holds blockDim.x / row_threads rows, row_threads a multiple of
// 32; NV slots a thread (row_plan).  Native's text is shared by
// abstract+shuffle (VEC false); abstract swaps the cross-lane stage.
template <typename T, bool ADD, bool VEC, int NV, int MODE>
__global__ void __launch_bounds__(kRowMaxBlock)
row_norm_held_kernel(const T* __restrict__ x, const T* __restrict__ r,
                     const T* __restrict__ w, T* __restrict__ out,
                     T* __restrict__ sum_out, int M, int D, float eps,
                     int row_threads, bool late_w) {
  static_assert(MODE == kNative || !VEC, "the modes load elements");
  constexpr int G = 16 / (int)sizeof(T);
  // abstract: the rows' trees (R x P); else the warps' partials
  __shared__ float part[kRowMaxBlock];
  __shared__ float moment[kRowPackThreads / 32];
  const int nt = row_threads;
  const int rb = threadIdx.x / nt;          // the block's row
  const int t = threadIdx.x - rb * nt;      // the thread in its row
  const int row = blockIdx.x * (blockDim.x / nt) + rb;
  const bool live = row < M;                // a dead row carries zeros
  const size_t base = (size_t)row * D;

  // every load of the share before any arithmetic (w's too, unless late)
  uint4 xv[NV], rv[NV], wv[NV];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int e0 = (t + k * nt) * G;
    xv[k] = rv[k] = wv[k] = make_uint4(0u, 0u, 0u, 0u);
    if (live && e0 < D) {
      xv[k] = load_slot<T, VEC>(x + base + e0, D - e0);
      if constexpr (ADD) rv[k] = load_slot<T, VEC>(r + base + e0, D - e0);
      if (!late_w) wv[k] = load_slot<T, VEC>(w + e0, D - e0);
    }
  }

  // the thread's fold, in slot order; the sum stored from the registers
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    float s[G];
    slot_sum<T, ADD>(xv[k], rv[k], s);
    const int e0 = (t + k * nt) * G;
    if constexpr (ADD) {
      if (live && e0 < D) store_slot<T, VEC>(sum_out + base + e0, s, D - e0);
    }
#pragma unroll
    for (int i = 0; i < G; ++i) ss = fmaf(s[i], s[i], ss);
  }

  float inv;
  if constexpr (MODE == kAbstract) {
    int p = 32;
    while (p < nt) p <<= 1;                 // nt <= p < 2 nt
    float* tree = part + rb * p;
    tree[t] = ss;
    if (t + nt < p) tree[t + nt] = 0.f;
    for (int h = p >> 1; h >= 1; h >>= 1) {
      __syncthreads();
      if (t < h) tree[t] += tree[t + h];
    }
    __syncthreads();
    if (t == 0) moment[rb] = tree[0] / (float)D;   // the re-stage
    __syncthreads();
    inv = rsqrtf(moment[rb] + eps);
  } else {
    ss = lane_tree_reduce<32>(ss);
    const int wpr = nt >> 5;
    if (wpr > 1) {                          // uniform over the block
      if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = ss;
      __syncthreads();
      ss = 0.f;
      for (int i = 0; i < wpr; ++i) ss += part[rb * wpr + i];
    }
    inv = rsqrtf(ss / (float)D + eps);
  }
  if (!live) return;
  if (late_w) {
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int e0 = (t + k * nt) * G;
      if (e0 < D) wv[k] = load_slot<T, VEC>(w + e0, D - e0);
    }
  }

#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int e0 = (t + k * nt) * G;
    if (e0 < D) {
      float s[G], wf[G];
      slot_sum<T, ADD>(xv[k], rv[k], s);
      slot_f<T>(wv[k], wf);
#pragma unroll
      for (int i = 0; i < G; ++i) s[i] = s[i] * inv * wf[i];
      store_slot<T, VEC>(out + base + e0, s, D - e0);
    }
  }
}

template <typename T, bool ADD, bool VEC, int MODE>
cudaError_t launch_row_norm_held(const RowPlan& p, const void* x,
                                 const void* r, const void* w, void* out,
                                 void* sum_out, int M, int D, float eps,
                                 cudaStream_t st) {
  const dim3 grid((M + p.rows - 1) / p.rows), block(p.threads * p.rows);
  const T *xt = (const T*)x, *rt = (const T*)r, *wt = (const T*)w;
  T *ot = (T*)out, *st_ = (T*)sum_out;
  switch (p.slots) {
    case 1:
      row_norm_held_kernel<T, ADD, VEC, 1, MODE><<<grid, block, 0, st>>>(
          xt, rt, wt, ot, st_, M, D, eps, p.threads, p.late_w);
      break;
    case 2:
      row_norm_held_kernel<T, ADD, VEC, 2, MODE><<<grid, block, 0, st>>>(
          xt, rt, wt, ot, st_, M, D, eps, p.threads, p.late_w);
      break;
    case 4:
      row_norm_held_kernel<T, ADD, VEC, 4, MODE><<<grid, block, 0, st>>>(
          xt, rt, wt, ot, st_, M, D, eps, p.threads, p.late_w);
      break;
    default:
      row_norm_held_kernel<T, ADD, VEC, 8, MODE><<<grid, block, 0, st>>>(
          xt, rt, wt, ot, st_, M, D, eps, p.threads, p.late_w);
  }
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The loop route: one warp a row, two passes
// ---------------------------------------------------------------------------

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
// cross-lane stage; outside native the loads are element loads.  Writes
// the route taken to *route; returns cudaGetLastError().
template <typename T, bool ADD, int MODE = kNative>
cudaError_t launch_row_norm(const void* x, const void* r, const void* w,
                            void* out, void* sum_out, int M, int D, float eps,
                            cudaStream_t st, int* route) {
  const bool vec = MODE == kNative && D % (16 / (int)sizeof(T)) == 0 &&
                   aligned16(x) && aligned16(r) && aligned16(w) &&
                   aligned16(out) && aligned16(sum_out);
  const RowPlan p = row_plan(M, D, (int)sizeof(T), vec);
  *route = p.route;
  if (p.route != kRowLoop) {
    if constexpr (MODE == kNative) {
      if (vec)
        return launch_row_norm_held<T, ADD, true, MODE>(p, x, r, w, out,
                                                        sum_out, M, D, eps,
                                                        st);
    }
    return launch_row_norm_held<T, ADD, false, MODE>(p, x, r, w, out,
                                                     sum_out, M, D, eps, st);
  }
  const dim3 grid((M + kNormWarps - 1) / kNormWarps);
  if constexpr (MODE != kNative) {
    row_norm_kernel<T, ADD, false, MODE><<<grid, kNormWarps * 32, 0, st>>>(
        (const T*)x, (const T*)r, (const T*)w, (T*)out, (T*)sum_out, M, D,
        eps);
    return cudaGetLastError();
  }
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

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
// Design: a (slot, head)'s columns split over blocks of 32 columns, two at
// P = 64 (1,280 blocks at 8 slots), every mode moving the state the same
// way; only the readout differs by mode (each column's readout is its
// own, so the split changes no sum).
// - Staging.  Warp 0 copies the block's [N, 32] f32 tile into shared
//   memory with one bulk copy a row (cp.async.bulk, 128 bytes each), all
//   completing on one mbarrier that expects the tile's bytes: the whole
//   tile is in flight at once, 16 KB a block, and the SM's threads spend
//   no instruction on the addresses.  Staged rows sit 32 + 4 floats apart,
//   so both thread maps below read 16 bytes a lane without bank conflicts
//   in each 8-lane phase (native's lanes along a row; the N-in-lanes map's
//   lanes on rows l, l + 1, ..., whose starts fall 4 banks apart).
// - Update and readout in shared memory, in the mode's thread map.
// - Writing h' back: coalesced 16-byte stores from native's map (each of
//   the 128 threads owns four adjacent columns and every 16th row of N, so
//   a warp writes four whole 128-byte row segments), the same in every
//   mode.  The state may be updated in place (state_out == state): a block
//   has read its whole tile before any thread passes the mbarrier, and
//   blocks own disjoint tiles.
// - Occupancy: 18 KB of shared memory a block at N = 128 (the tile, B, C
//   and native's partials) and at most 48 registers a thread
//   (kDecMinBlocks), so 10 blocks an SM (uisa_ssd_decode_resident): the
//   1,280 blocks of 8 slots run in one wave on 132 SMs.  Whole rows in one
//   block of 256 threads (5 an SM), or the tile in two mbarrier groups
//   with native updating the first while the second lands, ran no faster
//   (scripts/ssd_decode_variants.py: whole_p, halves).
// The recurrence and the readout are in f32; y is rounded once to the
// input dtype.
//
// The readout y = C.h' is the kernel's one cross-lane stage, and the only
// code that changes with MODE (kernels/_launch.py::MODE_CODES), as in the
// JAX package's _ssd_decode_kernel; the recurrence is the same in every
// mode, and every sum keeps the order of the unstaged kernel before this
// design (y and h' equal its bit for bit: scripts/ssd_decode_variants.py
// --parent):
// - native: each thread's 16-row partials folded in row order, then the
//   16 partials of a column summed in a fixed order through shared memory
//   (no atomics), so y does not depend on scheduling;
// - abstract: native's thread map; the halving tree over N (the JAX
//   scratch tree, its `(n, p)` scratch) in the room the staged tile leaves
//   once h' has gone to state_out.  Its stages of width 16 and more add
//   two rows of one thread (rows r + 16 k), which that thread adds in
//   registers, in the tree's order, writing the one partial left over its
//   row r; the log2(min(N, 16)) stages below cross threads through shared
//   memory, one barrier a stage;
// - abstract+shuffle: N in lanes.  Groups of W = min(N, 32) lanes; lane l
//   of a group owns rows n = l + W k and the group a span of 4-column
//   quads of P.  A lane folds its rows' products in registers, then
//   lanes.cuh::lane_tree_reduce<W> sums over the group (5 __shfl_xor_sync
//   stages at W = 32; the reduced configs' N = 16 run 16-lane groups, two
//   to a warp).  h' goes back into the staged tile, and from there to
//   state_out in native's map after a barrier.
// Outside native N must be a power of two (checked by the wrapper).
#include "common.cuh"
#include "lanes.cuh"

namespace uisa {

constexpr int kDecCols = 8;              // threads across a block's columns
constexpr int kDecRows = 16;             // threads down N
constexpr int kDecThreads = kDecCols * kDecRows;
// blocks an SM the registers must leave room for: 8 slots x 80 heads x
// 64 columns in one wave on 132 SMs (1,280 blocks of 32 columns)
constexpr int kDecMinBlocks = 1280 / kDecThreads;
constexpr int kDecNMax = 128;
constexpr int kDecPMax = 64;
// a block's columns (4 a thread): a (slot, head) whose P is wider takes
// ceil(P / kDecBlockP) blocks, each staging and updating its columns
constexpr int kDecBlockP = 4 * kDecCols;
constexpr int kDecPad = 4;               // floats after each staged row

// the blocks of one (slot, head), and a block's staged tile in bytes: N
// rows of its columns and kDecPad floats
inline int decode_splits(int P) { return (P + kDecBlockP - 1) / kDecBlockP; }
inline size_t decode_tile_bytes(int N, int P) {
  return (size_t)N * ((P < kDecBlockP ? P : kDecBlockP) + kDecPad) *
         sizeof(float);
}

// one bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from global to shared memory, completing on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// abstract+shuffle's update and readout for W-lane groups (see the note
// above) on the staged tile of the block's pw columns (rows `ld` floats
// apart), h' written back over it.  Every lane of the block must call it
// (the trees shuffle across whole warps).  A group owns `per` adjacent
// column quads (2 at W = 32 and 32 columns), and a lane reads all of them
// from a row before it updates any.
template <int W, typename T>
__device__ __forceinline__ void decode_in_lanes(float* tile, int ld,
                                                const float* bd,
                                                const float* cs, const T* xr,
                                                float da, T* yr, int N,
                                                int pw) {
  constexpr int kGroups = kDecThreads / W;
  constexpr int kSpan = (kDecCols + kGroups - 1) / kGroups;  // max per
  const int l = threadIdx.x & (W - 1), grp = threadIdx.x / W;
  const int quads = pw / 4;
  const int per = (quads + kGroups - 1) / kGroups;  // quads per group
  const int q0 = grp * per;
  const int nq = max(0, min(per, quads - q0));      // this group's quads
  float xv[kSpan][4], acc[kSpan][4];
#pragma unroll
  for (int j = 0; j < kSpan; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      xv[j][c] = j < nq ? to_f(xr[(q0 + j) * 4 + c]) : 0.f;
      acc[j][c] = 0.f;
    }
  for (int n = l; n < N; n += W) {
    float4* row = reinterpret_cast<float4*>(tile + n * ld) + q0;
    float4 s[kSpan];
#pragma unroll
    for (int j = 0; j < kSpan; ++j)
      if (j < nq) s[j] = row[j];
#pragma unroll
    for (int j = 0; j < kSpan; ++j) {
      if (j >= nq) break;
      s[j].x = da * s[j].x + bd[n] * xv[j][0];
      s[j].y = da * s[j].y + bd[n] * xv[j][1];
      s[j].z = da * s[j].z + bd[n] * xv[j][2];
      s[j].w = da * s[j].w + bd[n] * xv[j][3];
      row[j] = s[j];
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

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// abstract's update on native's map at N = KR x kDecRows (KR > 1), with
// the tree's stages of width w >= kDecRows done in registers: both rows of
// each of those additions are this thread's (rows r + kDecRows k), so the
// thread adds them, in the tree's order, and writes the one partial left
// over its row r of the tile.  The stages below kDecRows stay in shared
// memory.  Products round before the adds (__fmul_rn), as the tile stored
// them.
template <int KR>
__device__ __forceinline__ void abstract_fold_rows(float* tile, int ld,
                                                   float4* dst, int row4,
                                                   const float* bd,
                                                   const float* cs,
                                                   const float (&xv)[4],
                                                   float da, int r, int p0) {
  constexpr int kHalf = KR / 2;
  auto row = [&](int n) {                 // h' of row n out, its products
    float4 s = *reinterpret_cast<const float4*>(&tile[n * ld + p0]);
    s.x = da * s.x + bd[n] * xv[0];
    s.y = da * s.y + bd[n] * xv[1];
    s.z = da * s.z + bd[n] * xv[2];
    s.w = da * s.w + bd[n] * xv[3];
    dst[n * row4] = s;
    return make_float4(__fmul_rn(cs[n], s.x), __fmul_rn(cs[n], s.y),
                       __fmul_rn(cs[n], s.z), __fmul_rn(cs[n], s.w));
  };
  float4 a[kHalf];
#pragma unroll
  for (int k = 0; k < kHalf; ++k)
    a[k] = add4(row(r + k * kDecRows), row(r + (k + kHalf) * kDecRows));
#pragma unroll
  for (int w = kHalf / 2; w >= 1; w /= 2)
#pragma unroll
    for (int k = 0; k < w; ++k) a[k] = add4(a[k], a[k + w]);
  *reinterpret_cast<float4*>(&tile[r * ld + p0]) = a[0];
}

template <typename T, int MODE>
__global__ void __launch_bounds__(kDecThreads, kDecMinBlocks)
ssd_decode_kernel(const float* state, float* state_out, const T* x,
                  const float* dt, const float* A, const T* Bm, const T* Cm,
                  T* y, int H, int G, int N, int P, long long sxb,
                  long long sbb, long long scb) {
  __shared__ float bd[kDecNMax];          // dt * B
  __shared__ float cs[kDecNMax];
  __shared__ __align__(16) float red[kDecRows][kDecBlockP];
  __shared__ uint64_t full;               // the tile's bulk copies
  extern __shared__ __align__(128) float tile[];  // [N][pw + kDecPad]

  const int h = blockIdx.x, b = blockIdx.y;
  const int g = h / (H / G);
  const int tid = threadIdx.x;
  const int c0 = blockIdx.z * kDecBlockP;   // the block's first column
  const int pw = min(P - c0, kDecBlockP);   // and its columns
  const int ld = pw + kDecPad;
  const long long off = ((long long)b * H + h) * N * P + c0;
  if (tid < 32) {                         // warp 0 stages the tile
    if (tid == 0) {
      mbar_init(&full, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      mbar_expect_tx(&full, (uint32_t)(N * pw * sizeof(float)));
    }
    __syncwarp();
    for (int n = tid; n < N; n += 32)
      bulk_load(tile + n * ld, state + off + (long long)n * P,
                (uint32_t)(pw * sizeof(float)), &full);
  }
  const float dtv = dt[(long long)b * H + h];
  const float da = expf(dtv * A[h]);
  for (int n = tid; n < N; n += kDecThreads) {
    bd[n] = dtv * to_f(Bm[b * sbb + (long long)g * N + n]);
    cs[n] = to_f(Cm[b * scb + (long long)g * N + n]);
  }
  __syncthreads();                        // B, C and the mbarrier's init
  mbar_wait(&full, 0);

  // native's map: four adjacent columns and every 16th row a thread
  const int p0 = (tid % kDecCols) * 4, r = tid / kDecCols;
  const int row4 = P / 4;                 // float4 per state row
  float4* dst = reinterpret_cast<float4*>(state_out + off + p0);
  T* yr = y + ((long long)b * H + h) * P + c0;
  if constexpr (MODE == kAbstractShuffle) {
    const T* xr = x + b * sxb + (long long)h * P + c0;
    if (N >= 32)
      decode_in_lanes<32>(tile, ld, bd, cs, xr, da, yr, N, pw);
    else if (N == 16)
      decode_in_lanes<16>(tile, ld, bd, cs, xr, da, yr, N, pw);
    else if (N == 8)
      decode_in_lanes<8>(tile, ld, bd, cs, xr, da, yr, N, pw);
    else if (N == 4)
      decode_in_lanes<4>(tile, ld, bd, cs, xr, da, yr, N, pw);
    else if (N == 2)
      decode_in_lanes<2>(tile, ld, bd, cs, xr, da, yr, N, pw);
    else
      decode_in_lanes<1>(tile, ld, bd, cs, xr, da, yr, N, pw);
    __syncthreads();                      // h' is in the tile
    if (p0 < pw)
      for (int n = r; n < N; n += kDecRows)
        dst[n * row4] = *reinterpret_cast<const float4*>(&tile[n * ld + p0]);
  } else if constexpr (MODE == kAbstract) {
    if (p0 < pw) {
      const T* xr = x + b * sxb + (long long)h * P + c0 + p0;
      const float xv[4] = {to_f(xr[0]), to_f(xr[1]), to_f(xr[2]), to_f(xr[3])};
      if (N == 8 * kDecRows)
        abstract_fold_rows<8>(tile, ld, dst, row4, bd, cs, xv, da, r, p0);
      else if (N == 4 * kDecRows)
        abstract_fold_rows<4>(tile, ld, dst, row4, bd, cs, xv, da, r, p0);
      else if (N == 2 * kDecRows)
        abstract_fold_rows<2>(tile, ld, dst, row4, bd, cs, xv, da, r, p0);
      else if (r < N) {                   // one row a thread at most
        float4* t = reinterpret_cast<float4*>(&tile[r * ld + p0]);
        float4 s = *t;
        s.x = da * s.x + bd[r] * xv[0];
        s.y = da * s.y + bd[r] * xv[1];
        s.z = da * s.z + bd[r] * xv[2];
        s.w = da * s.w + bd[r] * xv[3];
        dst[r * row4] = s;
        *t = make_float4(cs[r] * s.x, cs[r] * s.y, cs[r] * s.z, cs[r] * s.w);
      }
    }
    // the tree's stages over the rows left, one barrier a stage, a float4
    // an addition
    for (int w = min(N, kDecRows) / 2; w >= 1; w >>= 1) {
      __syncthreads();
      for (int e = tid; e < w * (pw / 4); e += kDecThreads) {
        const int n = e / (pw / 4), c = (e - n * (pw / 4)) * 4;
        float4* a = reinterpret_cast<float4*>(&tile[n * ld + c]);
        const float4 o = *reinterpret_cast<const float4*>(&tile[(n + w) * ld + c]);
        float4 s = *a;
        s.x += o.x;
        s.y += o.y;
        s.z += o.z;
        s.w += o.w;
        *a = s;
      }
    }
    __syncthreads();
    if (tid < pw) yr[tid] = from_f<T>(tile[tid]);
  } else {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    if (p0 < pw) {
      const T* xr = x + b * sxb + (long long)h * P + c0 + p0;
      const float xv[4] = {to_f(xr[0]), to_f(xr[1]), to_f(xr[2]), to_f(xr[3])};
#pragma unroll 4
      for (int n = r; n < N; n += kDecRows) {
        float4 s = *reinterpret_cast<const float4*>(&tile[n * ld + p0]);
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
    if (tid < pw) {
      float sum = 0.f;
      for (int k = 0; k < kDecRows; ++k) sum += red[k][tid];
      yr[tid] = from_f<T>(sum);
    }
  }
}

template <typename T, int MODE>
cudaError_t resident_blocks(int N, int P, int* blocks) {
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, ssd_decode_kernel<T, MODE>, kDecThreads,
      decode_tile_bytes(N, P));
}

template <typename T>
cudaError_t launch_ssd_decode(int mode, const float* state, float* state_out,
                              const T* x, const float* dt, const float* A,
                              const T* Bm, const T* Cm, T* y, int batch,
                              int H, int G, int N, int P, long long sxb,
                              long long sbb, long long scb, cudaStream_t st) {
  const dim3 grid(H, batch, decode_splits(P));
  const size_t smem = decode_tile_bytes(N, P);
  if (mode == kAbstract)
    ssd_decode_kernel<T, kAbstract><<<grid, kDecThreads, smem, st>>>(
        state, state_out, x, dt, A, Bm, Cm, y, H, G, N, P, sxb, sbb, scb);
  else if (mode == kAbstractShuffle)
    ssd_decode_kernel<T, kAbstractShuffle><<<grid, kDecThreads, smem, st>>>(
        state, state_out, x, dt, A, Bm, Cm, y, H, G, N, P, sxb, sbb, scb);
  else
    ssd_decode_kernel<T, kNative><<<grid, kDecThreads, smem, st>>>(
        state, state_out, x, dt, A, Bm, Cm, y, H, G, N, P, sxb, sbb, scb);
  return cudaGetLastError();
}

}  // namespace uisa

// mode: kernels/_launch.py::MODE_CODES.  dtype: 0 f32, 1 bf16 (x, B, C and
// y); state, state_out, dt and A are f32, the state [B,H,N,P] contiguous
// and 16-byte aligned (the bulk copies).
// x [B,H,P] has batch stride sxb, B and C [B,G,N] batch strides sbb and
// scb.  N <= 128 (a power of two outside native), P <= 64 and a multiple
// of 4.
static bool decode_args_ok(int mode, int G, int H, int N, int P) {
  return N <= uisa::kDecNMax && P <= uisa::kDecPMax && P % 4 == 0 &&
         G >= 1 && H % G == 0 && mode >= uisa::kAbstract &&
         mode <= uisa::kNative &&
         (mode == uisa::kNative || (N >= 1 && (N & (N - 1)) == 0));
}

extern "C" int uisa_ssd_decode(int mode, int dtype, const void* state,
                               void* state_out, const void* x, const void* dt,
                               const void* A, const void* Bm, const void* Cm,
                               void* y, int batch, int H, int G, int N, int P,
                               long long sxb, long long sbb, long long scb,
                               void* stream) {
  if (!decode_args_ok(mode, G, H, N, P)) return (int)cudaErrorInvalidValue;
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

// The blocks of (mode, dtype) at state width N x P resident on one SM of
// the current device, or -1 on an error.
extern "C" int uisa_ssd_decode_resident(int mode, int dtype, int N, int P) {
  if (!decode_args_ok(mode, 1, 1, N, P)) return -1;
  const bool bf = dtype == uisa::kBF16;
  int blocks = -1;
  cudaError_t err;
  if (mode == uisa::kAbstract)
    err = bf ? uisa::resident_blocks<__nv_bfloat16, uisa::kAbstract>(N, P, &blocks)
             : uisa::resident_blocks<float, uisa::kAbstract>(N, P, &blocks);
  else if (mode == uisa::kAbstractShuffle)
    err = bf ? uisa::resident_blocks<__nv_bfloat16, uisa::kAbstractShuffle>(N, P, &blocks)
             : uisa::resident_blocks<float, uisa::kAbstractShuffle>(N, P, &blocks);
  else
    err = bf ? uisa::resident_blocks<__nv_bfloat16, uisa::kNative>(N, P, &blocks)
             : uisa::resident_blocks<float, uisa::kNative>(N, P, &blocks);
  return err == cudaSuccess ? blocks : -1;
}

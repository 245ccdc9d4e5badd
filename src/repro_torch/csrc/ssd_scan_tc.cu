// The chunked Mamba2 SSD scan on Hopper's tensor cores: the "tc" route of
// ssd_scan.cu, for bf16 x, B and C with N and P multiples of 16 and every
// row base and stride 16-byte aligned (scan_tc_route), linked into
// libssd_scan beside ssd_scan.cu, whose C entry calls launch_ssd_scan_tc.
//
// Replaces kernels/ssd.py::fused_ssd_scan of the JAX package (its Pallas
// kernel _ssd_scan_kernel, :238-286, called at :341), as the fma kernel of
// ssd_scan.cu does; it computes the same function:
//
//   y[t] = sum_{s<=t} exp(ld_t - ld_s) (C_t . B_s) dt_s x_s + exp(ld_t) C_t . h
//   h   <- exp(ld_last) h + sum_s B_s (dt_s exp(ld_last - ld_s)) x_s^T
//
// Bound on the H100: at prefill (B=1, L=512, 80 heads x 64, N=128, Q=256)
// the function moves about 13.5 MB (0.0040 ms at 3.35 TB/s); its products,
// C.B^T once a group, w.x, C.h and the update, with the second product of
// each split below, are 3.4 GFLOP, 0.0034 ms at 989 TFLOP/s: bytes bound
// it.  One block carries a head's state through its chunks in order, so at
// B=1 the card runs 80 blocks on 132 SMs and neither bound is in reach: a
// block's chain of loads and products over its chunks is the floor.
//
// Design (wgmma m64n64k16, bf16 in, f32 sums in registers):
// - one block of two warpgroups a (batch, head) loops over the chunks; a
//   chunk's x [Q][P], B and C [Q][N] arrive once each, in bf16, by 16-byte
//   cp.async into the layout wgmma reads (64-column panels of 128-byte
//   rows, 16-byte chunks swizzled by row % 8), zeros past R to the end of
//   the last 64-row tile and past N (the JAX kernel's padding: a zero dt
//   keeps those positions out of ld, w and wS); 196 KB of shared memory at
//   Q=256 with h's two tiles, one block an SM;
// - the prefix sum is scan_prefix<MODE>, the fma kernel's statements: ld,
//   dt and the update's weights wS are the same bits on both routes and in
//   every mode;
// - y, by 64-row target tiles (one warpgroup takes tiles nrt-1 and nrt-4,
//   the other nrt-2 and nrt-3: the causal walk balanced): C.h (A = C and
//   B = h's bf16 hi and lo tiles, both in shared memory, two products)
//   scaled by exp(ld_t); then per 64-position source tile up to the
//   diagonal S = C.B^T, and from its accumulators, branch-free, w =
//   exp(ld_t - ld_s) S dt_s with the exponent clamped to <= 0 before exp
//   (above the diagonal ld_t - ld_s is never exponentiated) and the causal
//   mask as a select; w goes straight into register A fragments of w.x (the
//   accumulator layout of m64n64 is the A layout of k16, two n8 tiles at a
//   time), split hi + lo when kTcScanWSplit (else rounded to bf16, as
//   attention_tc.cuh rounds P); B = x from shared memory (MN-major);
// - the state [N, P] f32 lives in registers as the update's accumulator
//   (a warpgroup 64 rows of N), seeded from h0 and written once, at the
//   end.  The update's f32 operand B_s wS_s (read by ldmatrix.trans from
//   B's tile) is split into bf16 hi + lo register fragments, two products
//   into one f32 accumulator, so the state keeps f32 accuracy (B wS rounded
//   to bf16 alone misses the card test's 1e-4 on the state,
//   tests/test_torch_ssd_numerics.py); after the update the warpgroups
//   write h's hi and lo tiles for the next chunk's C.h;
// - each thread fences its cp.async and shared-memory writes to the async
//   proxy (fence.proxy.async) before the barrier after which wgmma reads
//   them.  Every group of products has a fixed count and no branch, no
//   instruction but wgmma writes the sums of a group in flight, and each
//   group is waited for before its sums are read: so ptxas keeps the
//   products of a group in flight together (a branch between them, or a
//   register write to their sums, made it wait after each product);
// - what stays slow (scripts/ssd_scan_variants.py "phases", PERF.md): a
//   chunk's loads and prefix sum are not overlapped with the products
//   (about a fifth of the time at L=512), and m64n64 tiles with both
//   operands in shared memory leave the tensor cores short of their rate.
#include "common.cuh"
#include "lanes.cuh"
#include "mma_sync.cuh"
#include "ssd_scan.cuh"
#include "tc_gemm.cuh"

namespace uisa {

// ld = the inclusive cumsum of dt*A over the chunk at `base` into ld[t], dt
// into dts[t] and the state update's weights dt_t exp(ld_last - ld_t) into
// wsv[t], t < kScanQMax (zeros past the chunk or past L), in MODE's
// cross-lane stage, for the tc kernel: the statements of ssd_scan.cu's
// inline prefix sum (which keeps its copy, so that the fma kernel compiles
// as it did), so ld is the same bits on both routes (a card test holds the
// chunks' totals bit for bit).  Every thread of the block enters; the last
// writes (wsv) are published by the caller's next barrier.
template <int MODE>
__device__ __forceinline__ void scan_prefix(const float* dt, int H, int base,
                                            int Q, int L, float Ah, float* dts,
                                            float* ld, float* wsv,
                                            float* wtot) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if constexpr (MODE == kAbstract) {
    const int t = tid;
    const float d = (t < Q && base + t < L) ? dt[(long long)(base + t) * H] : 0.f;
    dts[t] = d;
    // __fmul_rn: dt*A rounds before the sums, as in the plain version
    ld[t] = scratch_inclusive_scan<kScanThreads>(__fmul_rn(d, Ah), wsv);
    __syncthreads();
    const float total = ld[Q - 1];
    wsv[t] = d * expf(total - ld[t]);
  } else if constexpr (MODE == kAbstractShuffle) {
    constexpr int kPer = kScanQMax / 32;  // positions per lane
    if (warp == 0) {
      float v[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int t = lane * kPer + i;
        const float d = (t < Q && base + t < L) ? dt[(long long)(base + t) * H] : 0.f;
        dts[t] = d;
        const float dA = __fmul_rn(d, Ah);
        v[i] = i == 0 ? dA : v[i - 1] + dA;
      }
      const float incl = lane_inclusive_scan<32>(v[kPer - 1]);
      const float up = lane_shuffle_up<32>(incl, 1);
      const float before = lane == 0 ? 0.f : up;
#pragma unroll
      for (int i = 0; i < kPer; ++i) ld[lane * kPer + i] = before + v[i];
    }
    __syncthreads();
    const float total = ld[Q - 1];
    wsv[tid] = dts[tid] * expf(total - ld[tid]);
  } else {
    const int t = tid;
    const float d = (t < Q && base + t < L) ? dt[(long long)(base + t) * H] : 0.f;
    dts[t] = d;
    float v = d * Ah;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += u;
    }
    if (lane == 31) wtot[warp] = v;
    __syncthreads();
    float off = 0.f;
    for (int w = 0; w < warp; ++w) off += wtot[w];
    ld[t] = v + off;
    __syncthreads();
    const float total = ld[Q - 1];
    wsv[t] = d * expf(total - ld[t]);
  }
}

constexpr int kTcScanN = 128;   // columns of the C and B tiles (two panels)
constexpr int kTcScanP = 64;    // columns of the x and h tiles (one panel)
// the choices scripts/ssd_scan_variants.py measures by editing these:
// P cut over this many blocks, each computing C.B^T (2: 160 blocks at B=1,
// 1.8x slower); w.x with w split into bf16 hi + lo (two products) or w
// rounded to bf16 (7% faster at L=512, y about 2e-3 of its max off);
// timing only ("phases"), thread 0 of each warpgroup writes the SM clock
// at the phases of its first 4 chunks into hf in place of the state
constexpr int kTcScanPSplit = 1;
constexpr bool kTcScanWSplit = true;
constexpr bool kTcScanMarks = false;

// byte offsets of the tiles in dynamic shared memory (1024-byte aligned:
// the 128-byte swizzle's period)
struct TcScanSmem {
  static constexpr int kPanel = kScanQMax * 64 * 2;            // [Q][64] bf16
  static constexpr int kC = 0;                                 // 2 panels
  static constexpr int kB = kC + 2 * kPanel;                   // 2 panels
  static constexpr int kX = kB + 2 * kPanel;                   // [Q][P]
  static constexpr int kHhi = kX + kPanel;                     // [N][P]
  static constexpr int kHlo = kHhi + kTcScanN * kTcScanP * 2;  // [N][P]
  static constexpr int kDt = kHlo + kTcScanN * kTcScanP * 2;   // [Q] f32
  static constexpr int kLd = kDt + kScanQMax * 4;
  static constexpr int kWs = kLd + kScanQMax * 4;
  static constexpr int kTot = kWs + kScanQMax * 4;             // [8] f32
  static constexpr int kBytes = 1024 + kTot + 8 * 4;           // + alignment
};

// element offset of (row, col) in a tile of 64-column panels [Q][64], col
// a multiple of 8: panel col / 64, then the swizzled 128-byte row
__device__ __forceinline__ int pan(int row, int col) {
  return (col >> 6) * (kScanQMax * 64) + swz<64>(row, col & 63);
}

// (v0, v1) as two bf16 pairs: hi = v rounded, lo = v - hi rounded
__device__ __forceinline__ void split_bf16(float v0, float v1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(v0 - hf.x, v1 - hf.y);
}

// exp(x) as ex2.approx of x log2(e), results below 2^-126 flushed to zero
__device__ __forceinline__ float exp_ftz(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x * 1.4426950408889634f));
  return r;
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// keep the compiler from moving accesses to a warpgroup's sums across the
// asynchronous products
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define UISA_WGMMA_D32                                                    \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),        \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),    \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),    \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),    \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),    \
      "+f"(d[31])
#define UISA_WGMMA_D32_LIST                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "   \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, " \
  "%29, %30, %31}"

// d[64x64] = A[64x16] (shared memory, K-major) @ B[16x64] (shared
// memory; TRANS_B 1: MN-major, 0: K-major) + d, or without d where
// keep_d is 0 (the first step of a sum: no instruction but wgmma writes
// the sums, so the products of a group are never serialized)
template <int TRANS_B>
__device__ __forceinline__ void wgmma_ss64(float (&d)[32], uint64_t da,
                                           uint64_t db, int keep_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " UISA_WGMMA_D32_LIST
      ", %32, %33, p, 1, 1, 0, %35;\n}\n"
      : UISA_WGMMA_D32
      : "l"(da), "l"(db), "r"(keep_d), "n"(TRANS_B));
}

// d[64x64] += A[64x16] (registers: warp w of the warpgroup holds rows
// 16w..16w+15 as mma.m16n8k16's A fragment) @ B[16x64] (MN-major)
__device__ __forceinline__ void wgmma_rs64(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " UISA_WGMMA_D32_LIST
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : UISA_WGMMA_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
#undef UISA_WGMMA_D32
#undef UISA_WGMMA_D32_LIST

template <int MODE>
__global__ void __launch_bounds__(kScanThreads, 1)
ssd_scan_tc_kernel(ScanArgs a) {
  using bf16 = __nv_bfloat16;
  extern __shared__ uint8_t tcs_raw[];
  uint8_t* tcs_smem = tcs_raw + ((1024 - (smem_u32(tcs_raw) & 1023)) & 1023);
  bf16* Cs = (bf16*)(tcs_smem + TcScanSmem::kC);
  bf16* Bs = (bf16*)(tcs_smem + TcScanSmem::kB);
  bf16* Xs = (bf16*)(tcs_smem + TcScanSmem::kX);
  bf16* Hhi = (bf16*)(tcs_smem + TcScanSmem::kHhi);
  bf16* Hlo = (bf16*)(tcs_smem + TcScanSmem::kHlo);
  float* dts = (float*)(tcs_smem + TcScanSmem::kDt);
  float* ld = (float*)(tcs_smem + TcScanSmem::kLd);
  float* wsv = (float*)(tcs_smem + TcScanSmem::kWs);
  float* wtot = (float*)(tcs_smem + TcScanSmem::kTot);

  const int N = a.N, P = a.P, Q = a.Q, L = a.L;
  const int Pb = P / kTcScanPSplit;          // this block's columns of P
  const int h = blockIdx.x / kTcScanPSplit;
  const int pb0 = blockIdx.x % kTcScanPSplit * Pb;
  const int b = blockIdx.y, g = h / (a.H / a.G);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, wq = warp & 3;   // warpgroup, its warp
  const int qr = lane >> 2, qc = lane & 3;   // the lane's quad row, column
  const int mat = lane >> 3, mrow = lane & 7;  // its ldmatrix matrix, row
  const float Ah = a.A[h];

  const bf16* x = (const bf16*)a.x + b * a.sxb + (long long)h * P + pb0;
  const bf16* Bm = (const bf16*)a.Bm + b * a.sbb + (long long)g * N;
  const bf16* Cm = (const bf16*)a.Cm + b * a.scb + (long long)g * N;
  const float* dt = a.dt + (long long)b * L * a.H + h;
  bf16* y = (bf16*)a.y + (long long)b * L * a.H * P + (long long)h * P + pb0;
  const long long sy = (long long)a.H * P;

  // descriptors: a K-major tile of 64-column panels at row r0, k16 step kk
  // (32 bytes along the row); an MN-major [k][64] tile at row k0
  auto desc_k = [](const bf16* tile, int r0, int kk) {
    return wgmma_desc(tile + pan(r0, kk * 16), 16, 1024);
  };
  auto desc_mn = [](const bf16* tile, int k0) {
    return wgmma_desc(tile + k0 * 64, TcScanSmem::kPanel, 1024);
  };

  // the carried state: this warpgroup's rows n0 + 16 wq + qr (+ 8) of N,
  // columns 8j + 2qc (+ 1) of the block's P, as m64n64 sums
  const int n0 = wg * 64;
  const bool owns_rows = n0 < N;
  const int nr = n0 + 16 * wq + qr;
  const long long hoff = ((long long)b * a.H + h) * N * P + pb0;
  float hacc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int n = nr + 8 * ((i >> 1) & 1), p = 8 * (i >> 2) + 2 * qc + (i & 1);
    hacc[i] = (a.h0 != nullptr && n < N && p < Pb)
                  ? a.h0[hoff + (long long)n * P + p]
                  : 0.f;
  }
  // h's hi and lo tiles for C.h, from the sums
  auto store_h = [&]() {
    if (!owns_rows) return;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int off = swz<64>(nr + 8 * i, 8 * j) + 2 * qc;
        uint32_t hi, lo;
        split_bf16(hacc[4 * j + 2 * i], hacc[4 * j + 2 * i + 1], hi, lo);
        *reinterpret_cast<uint32_t*>(Hhi + off) = hi;
        *reinterpret_cast<uint32_t*>(Hlo + off) = lo;
      }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  };
  // h's tiles start at zero: rows past N stay zero (C's columns past N
  // are zero too, and 0 x a stale NaN would not be)
  for (int e = tid; e < 2 * kTcScanN * kTcScanP / 8; e += kScanThreads)
    reinterpret_cast<uint4*>(Hhi)[e] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  bool has_state = a.h0 != nullptr;
  if (has_state) store_h();

  const long long t_start = clock64();
  auto mark = [&](int c, int k) {
    if (kTcScanMarks && (tid & 127) == 0 && c < 4)
      a.hf[hoff - pb0 + wg * 32 + c * 8 + k] = (float)(clock64() - t_start);
  };
  const int n_chunks = (L + Q - 1) / Q;
  for (int c = 0; c < n_chunks; ++c) {
    mark(c, 0);
    const int base = c * Q;
    const int R = min(Q, L - base);          // rows of this chunk
    const int nrb = (R + 15) / 16;           // its row blocks of 16
    const int nrt = (R + 63) / 64;           // its row tiles of 64
    // ---- the chunk's C, B and x, once each: zeros past R to the end of
    // the last 64-row tile (a zero weight times a stale x could be NaN) and
    // past N to 128 columns, so that every group of products has the same
    // k16 steps and no branch ----
    for (int e = tid; e < nrt * 64 * (kTcScanN / 8); e += kScanThreads) {
      const int r = e / (kTcScanN / 8), cc = e % (kTcScanN / 8);
      const bool ok = r < R && cc * 8 < N;
      const long long t = base + r;
      cp_async16(Cs + pan(r, cc * 8), ok ? Cm + t * a.scl + cc * 8 : Cm, ok);
      cp_async16(Bs + pan(r, cc * 8), ok ? Bm + t * a.sbl + cc * 8 : Bm, ok);
    }
    for (int e = tid; e < nrt * 64 * (kTcScanP / 8); e += kScanThreads) {
      const int r = e / (kTcScanP / 8), cc = e % (kTcScanP / 8);
      if (cc >= Pb / 8) continue;
      const bool ok = r < R;
      cp_async16(Xs + swz<64>(r, cc * 8),
                 ok ? x + (long long)(base + r) * a.sxl + cc * 8 : x, ok);
    }
    cp_async_commit();
    scan_prefix<MODE>(dt, a.H, base, Q, L, Ah, dts, ld, wsv, wtot);
    cp_async_wait<0>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    mark(c, 1);
    const float total = ld[Q - 1];

    // ---- y, by 64-row target tiles ----
#pragma unroll 1
    for (int pass = 0; pass < 2; ++pass) {
      const int T = pass == 0 ? nrt - 1 - wg : nrt - 4 + wg;
      if (T < 0) continue;
      const int t0 = T * 64;
      const int tr[2] = {t0 + 16 * wq + qr, t0 + 16 * wq + qr + 8};
      const float ldt[2] = {ld[tr[0]], ld[tr[1]]};
      float yacc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) yacc[i] = 0.f;
      // the carried state: C.h with h as hi + lo, times exp(ld_t)
      if (has_state) {
        fence_acc(yacc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kTcScanN / 16; ++kk) {
          wgmma_ss64<1>(yacc, desc_k(Cs, t0, kk), desc_mn(Hhi, kk * 16));
          wgmma_ss64<1>(yacc, desc_k(Cs, t0, kk), desc_mn(Hlo, kk * 16));
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_acc(yacc);
        const float et[2] = {expf(ldt[0]), expf(ldt[1])};
#pragma unroll
        for (int i = 0; i < 32; ++i) yacc[i] *= et[(i >> 1) & 1];
      }
      // the chunk: source tiles 0..T, each S = C.B^T, then w, then w.x
#pragma unroll 1
      for (int S = 0; S <= T; ++S) {
        const int s0 = S * 64;
        float sacc[32];
        fence_acc(sacc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kTcScanN / 16; ++kk)   // the first drops sacc
          wgmma_ss64<0>(sacc, desc_k(Cs, t0, kk), desc_k(Bs, s0, kk), kk > 0);
        wgmma_commit();
        wgmma_wait_all();
        fence_acc(sacc);
        // w = exp(ld_t - ld_s) S dt_s for s <= t, else 0, for sacc[v]: row
        // tr[(v >> 1) & 1], source s0 + 8 (v >> 2) + 2qc + (v & 1).
        // Branch-free: the exponent is clamped to <= 0 first (above the
        // diagonal ld_t - ld_s > 0 is never exponentiated), then the mask
        // selects.  The scores are read, never written: no instruction but
        // wgmma defines its sums, so ptxas never serializes the products
        auto weight = [&](int v) {
          const int src = s0 + 8 * (v >> 2) + 2 * qc + (v & 1);
          const int r = (v >> 1) & 1;
          const float w = __fmul_rn(
              exp_ftz(fminf(ldt[r] - ld[src], 0.f)) * sacc[v], dts[src]);
          return src <= tr[r] ? w : 0.f;
        };
        // y += w.x: k16 step kk is the n8 tiles 2kk, 2kk + 1 of w
        uint32_t wa[4][4], wl[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            // a0, a1: rows tr[0], tr[1] at sources 2qc, 2qc + 1; a2, a3: + 8
            const int v = 4 * (2 * kk + (i >> 1)) + 2 * (i & 1);
            if constexpr (kTcScanWSplit)
              split_bf16(weight(v), weight(v + 1), wa[kk][i], wl[kk][i]);
            else
              wa[kk][i] = pack_bf16(weight(v), weight(v + 1));
          }
        fence_acc(yacc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs64(yacc, wa[kk], desc_mn(Xs, s0 + 16 * kk));
        if constexpr (kTcScanWSplit) {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_rs64(yacc, wl[kk], desc_mn(Xs, s0 + 16 * kk));
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_acc(yacc);
      }
      // y rows past the chunk or past L are not written
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (tr[i] >= R) continue;
        bf16* yr = y + (long long)(base + tr[i]) * sy;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (8 * j < Pb)
            *reinterpret_cast<__nv_bfloat162*>(yr + 8 * j + 2 * qc) =
                __floats2bfloat162_rn(yacc[4 * j + 2 * i],
                                      yacc[4 * j + 2 * i + 1]);
      }
    }

    mark(c, 2);
    // ---- h <- exp(total) h + (B wS)^T x, B wS as hi + lo ----
    if (owns_rows) {
      const float decay = expf(total);
#pragma unroll
      for (int i = 0; i < 32; ++i) hacc[i] *= decay;
      // A = (B wS)^T: this warp's 16 rows of N, positions 16 kk ..; B read
      // transposed; four k16 steps a group of products (steps past nrb
      // read zeros: B, x and wS are zero there, within the last tile)
#pragma unroll 1
      for (int k0 = 0; k0 < nrb; k0 += 4) {
        uint32_t ahi[4][4], alo[4][4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int kk = k0 + q;
          uint32_t bt[4];
          ldsm_x4_trans(bt, Bs + pan(kk * 16 + mrow + (mat >> 1) * 8,
                                     n0 + 16 * wq + (mat & 1) * 8));
          const int k = kk * 16 + 2 * qc;
          const float2 w01 = *reinterpret_cast<const float2*>(wsv + k);
          const float2 w89 = *reinterpret_cast<const float2*>(wsv + k + 8);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float2 bv = unpack_bf16(bt[i]);
            const float2 w = i < 2 ? w01 : w89;
            split_bf16(__fmul_rn(bv.x, w.x), __fmul_rn(bv.y, w.y), ahi[q][i],
                       alo[q][i]);
          }
        }
        fence_acc(hacc);
        wgmma_fence();
#pragma unroll
        for (int q = 0; q < 4; ++q)
          wgmma_rs64(hacc, ahi[q], desc_mn(Xs, (k0 + q) * 16));
#pragma unroll
        for (int q = 0; q < 4; ++q)
          wgmma_rs64(hacc, alo[q], desc_mn(Xs, (k0 + q) * 16));
        wgmma_commit();
        wgmma_wait_all();
        fence_acc(hacc);
      }
    }
    mark(c, 3);
    __syncthreads();   // every read of this chunk's tiles and of h is done
    mark(c, 4);
    if (c + 1 < n_chunks) store_h();
    has_state = true;
  }

  if (owns_rows && !kTcScanMarks) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (8 * j >= Pb) break;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int n = nr + 8 * i;
        if (n < N)
          *reinterpret_cast<float2*>(a.hf + hoff + (long long)n * P + 8 * j +
                                     2 * qc) =
              make_float2(hacc[4 * j + 2 * i], hacc[4 * j + 2 * i + 1]);
      }
    }
  }
}

// the tc route's predicate: bf16 operands, N and P on the 16-grid (P split
// over kTcScanPSplit blocks), x, B and C and every row stride 16-byte
// aligned (kernels/ssd.py::scan_route mirrors it)
bool scan_tc_route(int dtype, const ScanArgs& a) {
  auto aligned = [](const void* p) { return ((uintptr_t)p & 15) == 0; };
  return dtype == kBF16 && a.N % 16 == 0 && a.P % (16 * kTcScanPSplit) == 0 &&
         aligned(a.x) && aligned(a.Bm) && aligned(a.Cm) && a.sxb % 8 == 0 &&
         a.sxl % 8 == 0 && a.sbb % 8 == 0 && a.sbl % 8 == 0 &&
         a.scb % 8 == 0 && a.scl % 8 == 0;
}

template <int MODE>
cudaError_t launch_ssd_scan_tc(const ScanArgs& a, int batch, cudaStream_t st) {
  constexpr int bytes = TcScanSmem::kBytes;
  const cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_tc_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  ssd_scan_tc_kernel<MODE>
      <<<dim3(a.H * kTcScanPSplit, batch), kScanThreads, bytes, st>>>(a);
  return cudaGetLastError();
}

cudaError_t launch_ssd_scan_tc(int mode, const ScanArgs& a, int batch,
                               cudaStream_t st) {
  if (mode == kNative) return launch_ssd_scan_tc<kNative>(a, batch, st);
  if (mode == kAbstract) return launch_ssd_scan_tc<kAbstract>(a, batch, st);
  return launch_ssd_scan_tc<kAbstractShuffle>(a, batch, st);
}

}  // namespace uisa

// What ssd_scan.cu's fma kernel and ssd_scan_tc.cu's tc kernel share: the
// launch arguments, the shapes the C entry takes, and the tc route's entry
// points.  The tc kernel is its own translation unit, linked into the same
// library, so that the fma kernels compile as they did before it existed.
#pragma once
#include <cuda_runtime.h>

namespace uisa {

constexpr int kScanThreads = 256;
constexpr int kScanQMax = 256;   // positions per chunk
constexpr int kScanNMax = 128;   // state width
constexpr int kScanPMax = 64;    // head width

struct ScanArgs {
  const void* x;       // [B,L,H,P], strides sxb, sxl; [H,P] contiguous
  const float* dt;     // [B,L,H] contiguous
  const float* A;      // [H]
  const void* Bm;      // [B,L,G,N], strides sbb, sbl; [G,N] contiguous
  const void* Cm;      // [B,L,G,N], strides scb, scl
  const float* h0;     // [B,H,N,P] or null (zeros)
  void* y;             // [B,L,H,P] contiguous
  float* hf;           // [B,H,N,P]
  int L, H, G, N, P, Q;
  long long sxb, sxl, sbb, sbl, scb, scl;
};

// the tc route's predicate and launch (ssd_scan_tc.cu); mode:
// kernels/_launch.py::MODE_CODES
bool scan_tc_route(int dtype, const ScanArgs& a);
cudaError_t launch_ssd_scan_tc(int mode, const ScanArgs& a, int batch,
                               cudaStream_t st);

}  // namespace uisa

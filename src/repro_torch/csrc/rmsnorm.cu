// C entry point of the rmsnorm kernel (see row_norm.cuh for the design
// note and the bound).  Replaces kernels/rmsnorm.py::rmsnorm of the JAX
// package.  x [M,D], w [D] -> out [M,D] = x * rsqrt(mean(x^2) + eps) * w,
// f32 inside, stored at the working dtype.  Returns cudaGetLastError().
#include "row_norm.cuh"

extern "C" int uisa_rmsnorm(int dtype, const void* x, const void* w,
                            void* out, int M, int D, float eps,
                            void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == uisa::kBF16)
    return (int)uisa::launch_row_norm<__nv_bfloat16, false>(
        x, nullptr, w, out, nullptr, M, D, eps, st);
  return (int)uisa::launch_row_norm<float, false>(x, nullptr, w, out, nullptr,
                                                  M, D, eps, st);
}

// C entry point of the rmsnorm kernel (see row_norm.cuh for the design
// note and the bound).  Replaces kernels/rmsnorm.py::rmsnorm of the JAX
// package.  x [M,D], w [D] -> out [M,D] = x * rsqrt(mean(x^2) + eps) * w,
// f32 inside, stored at the working dtype.  `mode`
// (kernels/_launch.py::MODE_CODES) selects the abstract or abstract+shuffle
// lowering of the same kernel.  Writes the route taken to *route
// (row_norm.cuh::RowNormRoute); returns cudaGetLastError().
#include "row_norm.cuh"

template <typename T>
static cudaError_t launch(int mode, const void* x, const void* w, void* out,
                          int M, int D, float eps, cudaStream_t st,
                          int* route) {
  if (mode == uisa::kAbstract)
    return uisa::launch_row_norm<T, false, uisa::kAbstract>(
        x, nullptr, w, out, nullptr, M, D, eps, st, route);
  if (mode == uisa::kAbstractShuffle)
    return uisa::launch_row_norm<T, false, uisa::kAbstractShuffle>(
        x, nullptr, w, out, nullptr, M, D, eps, st, route);
  return uisa::launch_row_norm<T, false>(x, nullptr, w, out, nullptr, M, D,
                                         eps, st, route);
}

extern "C" int uisa_rmsnorm(int mode, int dtype, const void* x,
                            const void* w, void* out, int M, int D, float eps,
                            void* stream, int* route) {
  cudaStream_t st = (cudaStream_t)stream;
  if (mode < uisa::kAbstract || mode > uisa::kNative)
    return (int)cudaErrorInvalidValue;
  if (dtype == uisa::kBF16)
    return (int)launch<__nv_bfloat16>(mode, x, w, out, M, D, eps, st, route);
  return (int)launch<float>(mode, x, w, out, M, D, eps, st, route);
}

// C entry point of the add_rmsnorm kernel (see row_norm.cuh for the design
// note and the bound).  Replaces kernels/fused.py::add_rmsnorm of the JAX
// package.  x, r [M,D], w [D] -> sum [M,D] = x + r (added in f32, rounded
// once, the same in every mode) and out [M,D] = the norm of the f32 sum
// times w.  `mode` (kernels/_launch.py::MODE_CODES) selects the abstract or
// abstract+shuffle lowering of the same kernel.  Writes the route taken to
// *route (row_norm.cuh::RowNormRoute); returns cudaGetLastError().
#include "row_norm.cuh"

template <typename T>
static cudaError_t launch(int mode, const void* x, const void* r,
                          const void* w, void* out, void* sum, int M, int D,
                          float eps, cudaStream_t st, int* route) {
  if (mode == uisa::kAbstract)
    return uisa::launch_row_norm<T, true, uisa::kAbstract>(
        x, r, w, out, sum, M, D, eps, st, route);
  if (mode == uisa::kAbstractShuffle)
    return uisa::launch_row_norm<T, true, uisa::kAbstractShuffle>(
        x, r, w, out, sum, M, D, eps, st, route);
  return uisa::launch_row_norm<T, true>(x, r, w, out, sum, M, D, eps, st,
                                        route);
}

extern "C" int uisa_add_rmsnorm(int mode, int dtype, const void* x,
                                const void* r, const void* w, void* out,
                                void* sum, int M, int D, float eps,
                                void* stream, int* route) {
  cudaStream_t st = (cudaStream_t)stream;
  if (mode < uisa::kAbstract || mode > uisa::kNative)
    return (int)cudaErrorInvalidValue;
  if (dtype == uisa::kBF16)
    return (int)launch<__nv_bfloat16>(mode, x, r, w, out, sum, M, D, eps,
                                      st, route);
  return (int)launch<float>(mode, x, r, w, out, sum, M, D, eps, st, route);
}

// C entry point of the add_rmsnorm kernel (see row_norm.cuh for the design
// note and the bound).  Replaces kernels/fused.py::add_rmsnorm of the JAX
// package.  x, r [M,D], w [D] -> sum [M,D] = x + r (added in f32, rounded
// once) and out [M,D] = the norm of the f32 sum times w.  Returns
// cudaGetLastError().
#include "row_norm.cuh"

extern "C" int uisa_add_rmsnorm(int dtype, const void* x, const void* r,
                                const void* w, void* out, void* sum, int M,
                                int D, float eps, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == uisa::kBF16)
    return (int)uisa::launch_row_norm<__nv_bfloat16, true>(x, r, w, out, sum,
                                                           M, D, eps, st);
  return (int)uisa::launch_row_norm<float, true>(x, r, w, out, sum, M, D, eps,
                                                 st);
}

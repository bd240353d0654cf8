// K2: the variable-coefficient 7-point operator of the Galerkin coarse
// levels, A x = d*x - sum_f c_f x_nbr, from per-face conductances.
//
// Replaces openimpala_tpu/ops/stencil_pallas.py::fused_conductance_pallas
// (body _cond_kernel).  cx[i,j,k] is the conductance between cells i and
// i+1 (mod X) along X, likewise cy, cz; every read wraps, because a clamped
// axis carries zero wrap conductances.  free = d > 0.  Modes:
//   matvec : out = free ? Ax : 0
//   sweep  : out = x + (free ? omega/d : 0) * (r - Ax)
// The subtraction order is the plain form's (ConductanceLevel roll form):
// d*x, then per axis the +1 face and the -1 face.
//
// Design: one thread per cell, 32 along Z by 8 along Y, one X plane per
// grid row; neighbours through L1/L2.

#include "common.cuh"

namespace {

using oit::BY;
using oit::BZ;
using oit::ceil_div;

enum Mode { MATVEC = 0, SWEEP = 1 };

template <typename T, int MODE>
__global__ void __launch_bounds__(BZ* BY)
    k2_cells(const T* __restrict__ x, const T* __restrict__ r,
             const T* __restrict__ cx, const T* __restrict__ cy,
             const T* __restrict__ cz, const T* __restrict__ diag,
             T* __restrict__ out, int64_t X, int64_t Y, int64_t Z, T omega) {
  const int64_t k = static_cast<int64_t>(blockIdx.x) * BZ + threadIdx.x;
  const int64_t j = static_cast<int64_t>(blockIdx.y) * BY + threadIdx.y;
  const int64_t i = blockIdx.z;
  if (k >= Z || j >= Y) return;
  const int64_t YZ = Y * Z;
  const int64_t ip = i + 1 == X ? 0 : i + 1, im = i == 0 ? X - 1 : i - 1;
  const int64_t jp = j + 1 == Y ? 0 : j + 1, jm = j == 0 ? Y - 1 : j - 1;
  const int64_t kp = k + 1 == Z ? 0 : k + 1, km = k == 0 ? Z - 1 : k - 1;
  const int64_t c = i * YZ + j * Z + k;
  const int64_t cxp = ip * YZ + j * Z + k, cxm = im * YZ + j * Z + k;
  const int64_t cyp = i * YZ + jp * Z + k, cym = i * YZ + jm * Z + k;
  const int64_t czp = i * YZ + j * Z + kp, czm = i * YZ + j * Z + km;
  const T xc = x[c];
  const T d = diag[c];
  T ax = d * xc;
  ax = ax - cx[c] * x[cxp];
  ax = ax - cx[cxm] * x[cxm];
  ax = ax - cy[c] * x[cyp];
  ax = ax - cy[cym] * x[cym];
  ax = ax - cz[c] * x[czp];
  ax = ax - cz[czm] * x[czm];
  const bool free = d > T(0);
  if (MODE == MATVEC) {
    out[c] = free ? ax : T(0);
  } else {
    const T inv_d = free ? omega / d : T(0);
    out[c] = xc + inv_d * (r[c] - ax);
  }
}

template <typename T>
int launch(int mode, const void* x, const void* r, const void* cx,
           const void* cy, const void* cz, const void* diag, void* out,
           int64_t X, int64_t Y, int64_t Z, double omega, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 block(BZ, BY);
  const dim3 grid(static_cast<unsigned>(ceil_div(Z, BZ)),
                  static_cast<unsigned>(ceil_div(Y, BY)),
                  static_cast<unsigned>(X));
  const T* xp = static_cast<const T*>(x);
  const T* rp = static_cast<const T*>(r);
  const T* cxp = static_cast<const T*>(cx);
  const T* cyp = static_cast<const T*>(cy);
  const T* czp = static_cast<const T*>(cz);
  const T* dp = static_cast<const T*>(diag);
  T* op = static_cast<T*>(out);
  const T tom = static_cast<T>(omega);
  if (mode == MATVEC) {
    k2_cells<T, MATVEC><<<grid, block, 0, s>>>(xp, rp, cxp, cyp, czp, dp, op,
                                               X, Y, Z, tom);
  } else if (mode == SWEEP) {
    k2_cells<T, SWEEP><<<grid, block, 0, s>>>(xp, rp, cxp, cyp, czp, dp, op,
                                              X, Y, Z, tom);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int k2_launch_f32(int mode, const void* x, const void* r, const void* cx,
                  const void* cy, const void* cz, const void* diag, void* out,
                  long long X, long long Y, long long Z, double omega,
                  void* stream) {
  return launch<float>(mode, x, r, cx, cy, cz, diag, out, X, Y, Z, omega,
                       stream);
}

int k2_launch_f64(int mode, const void* x, const void* r, const void* cx,
                  const void* cy, const void* cz, const void* diag, void* out,
                  long long X, long long Y, long long Z, double omega,
                  void* stream) {
  return launch<double>(mode, x, r, cx, cy, cz, diag, out, X, Y, Z, omega,
                        stream);
}

const char* k2_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

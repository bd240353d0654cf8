// K2: the variable-coefficient 7-point operator of the Galerkin coarse
// levels, A x = d*x - sum_f c_f x_nbr, from per-face conductances.
//
// Replaces openimpala_tpu/ops/stencil_pallas.py::fused_conductance_pallas
// (body _cond_kernel).  cx[i,j,k] is the conductance between cells i and
// i+1 (mod X) along X, likewise cy, cz; every read wraps, because a clamped
// axis carries zero wrap conductances.  free = d > 0.  Modes:
//   matvec     : out = free ? Ax : 0
//   sweep      : out = x + (free ? omega/d : 0) * (r - Ax)
//   cheby      : one step of the Chebyshev iteration on D^-1 A, with
//                inv_d = free ? 1/d : 0 and the host's scalars c1, c2:
//                  res  -= free ? A d : 0           (in place)
//                  d_new = c1*d + c2*(inv_d*res)    (d is not overwritten:
//                                                    the neighbours read it)
//                  x    += d_new                    (in place)
//   cheby_init : the step from x = 0, which needs no operator:
//                  res = r, d_new = (inv_d*r)*c0, x = 0 + d_new
// The subtraction order of A x is the plain form's (ConductanceLevel roll
// form): d*x, then per axis the +1 face and the -1 face; every mode takes
// it from k2_ax, so the cheby step's A d is the matvec's to the bit.
//
// The two cheby modes replace no Pallas kernel: they fuse the loop body of
// openimpala_tpu/solve/preconditioners.py::_smooth_cheby (:657; the JAX
// package runs it around fused_conductance_pallas) into one pass, so a
// coarsest-level solve of n steps is n launches instead of 7n.  Each
// rounding of that body is kept: 1/d is an IEEE division (no fast math,
// what torch.reciprocal gives), and the update's products and sums use the
// _rn intrinsics, which nvcc never contracts into an FMA, as PyTorch's
// separate elementwise kernels round each one.
//
// Bound: all modes move bytes.  Compulsory traffic per cell (float32;
// double in float64): matvec 24 B, sweep 28, cheby 40 (reads d, cx, cy,
// cz, diag, res, x; writes res, d_new, x), cheby_init 20 (reads r, diag;
// writes res, d_new, x).
//
// Design: one thread per cell, 32 along Z by 8 along Y, one X plane per
// grid row; neighbours through L1/L2.  Consecutive blocks walk a plane
// before the next, so the planes i-1, i and i+1 of d and cx meet in L2 and
// each field is fetched from device memory about once.

#include "common.cuh"

namespace {

using oit::BY;
using oit::BZ;
using oit::ceil_div;

enum Mode { MATVEC = 0, SWEEP = 1, CHEBY = 2, CHEBY_INIT = 3 };

// Flat indices of a cell and its six neighbours, every axis wrapped.
struct Cell {
  int64_t c, xp, xm, yp, ym, zp, zm;
};

__device__ __forceinline__ Cell cell_at(int64_t i, int64_t j, int64_t k,
                                        int64_t X, int64_t Y, int64_t Z) {
  const int64_t YZ = Y * Z;
  const int64_t ip = i + 1 == X ? 0 : i + 1, im = i == 0 ? X - 1 : i - 1;
  const int64_t jp = j + 1 == Y ? 0 : j + 1, jm = j == 0 ? Y - 1 : j - 1;
  const int64_t kp = k + 1 == Z ? 0 : k + 1, km = k == 0 ? Z - 1 : k - 1;
  const int64_t row = i * YZ + j * Z;
  return {row + k,           ip * YZ + j * Z + k, im * YZ + j * Z + k,
          i * YZ + jp * Z + k, i * YZ + jm * Z + k, row + kp,
          row + km};
}

// A x at one cell, in the plain form's order.
template <typename T>
__device__ __forceinline__ T k2_ax(const T* __restrict__ x,
                                   const T* __restrict__ cx,
                                   const T* __restrict__ cy,
                                   const T* __restrict__ cz, T d, T xc,
                                   const Cell& n) {
  T ax = d * xc;
  ax = ax - cx[n.c] * x[n.xp];
  ax = ax - cx[n.xm] * x[n.xm];
  ax = ax - cy[n.c] * x[n.yp];
  ax = ax - cy[n.ym] * x[n.ym];
  ax = ax - cz[n.c] * x[n.zp];
  ax = ax - cz[n.zm] * x[n.zm];
  return ax;
}

// Single roundings that nvcc never contracts into an FMA.
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}

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
  const Cell n = cell_at(i, j, k, X, Y, Z);
  const T xc = x[n.c];
  const T d = diag[n.c];
  const T ax = k2_ax(x, cx, cy, cz, d, xc, n);
  const bool free = d > T(0);
  if (MODE == MATVEC) {
    out[n.c] = free ? ax : T(0);
  } else {
    const T inv_d = free ? omega / d : T(0);
    out[n.c] = xc + inv_d * (r[n.c] - ax);
  }
}

// The cheby modes (an overload of the same template: the symbol stays
// k2_cells).  In cheby_init, d is r.
template <typename T, int MODE>
__global__ void __launch_bounds__(BZ* BY)
    k2_cells(const T* __restrict__ d, T* __restrict__ res, T* __restrict__ x,
             const T* __restrict__ cx, const T* __restrict__ cy,
             const T* __restrict__ cz, const T* __restrict__ diag,
             T* __restrict__ d_new, int64_t X, int64_t Y, int64_t Z, T c1,
             T c2) {
  const int64_t k = static_cast<int64_t>(blockIdx.x) * BZ + threadIdx.x;
  const int64_t j = static_cast<int64_t>(blockIdx.y) * BY + threadIdx.y;
  const int64_t i = blockIdx.z;
  if (k >= Z || j >= Y) return;
  const Cell n = cell_at(i, j, k, X, Y, Z);
  const T dd = diag[n.c];
  const bool free = dd > T(0);
  const T inv_d = free ? T(1) / dd : T(0);
  const T dc = d[n.c];
  if (MODE == CHEBY_INIT) {
    const T dn = mul_rn(mul_rn(inv_d, dc), c1);
    res[n.c] = dc;
    d_new[n.c] = dn;
    x[n.c] = add_rn(T(0), dn);
  } else {
    const T ax = k2_ax(d, cx, cy, cz, dd, dc, n);
    const T rs = sub_rn(res[n.c], free ? ax : T(0));
    const T dn = add_rn(mul_rn(c1, dc), mul_rn(c2, mul_rn(inv_d, rs)));
    res[n.c] = rs;
    d_new[n.c] = dn;
    x[n.c] = add_rn(x[n.c], dn);
  }
}

dim3 grid_of(int64_t X, int64_t Y, int64_t Z) {
  return dim3(static_cast<unsigned>(ceil_div(Z, BZ)),
              static_cast<unsigned>(ceil_div(Y, BY)),
              static_cast<unsigned>(X));
}

template <typename T>
int launch(int mode, const void* x, const void* r, const void* cx,
           const void* cy, const void* cz, const void* diag, void* out,
           int64_t X, int64_t Y, int64_t Z, double omega, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 block(BZ, BY);
  const dim3 grid = grid_of(X, Y, Z);
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

// c1 and c2 are values of T (the host's recurrence runs in the working
// dtype), so the casts are exact.
template <typename T>
int launch_cheby(int init, const void* d, void* res, void* x, const void* cx,
                 const void* cy, const void* cz, const void* diag,
                 void* d_new, int64_t X, int64_t Y, int64_t Z, double c1,
                 double c2, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 block(BZ, BY);
  const dim3 grid = grid_of(X, Y, Z);
  const T* dp = static_cast<const T*>(d);
  T* resp = static_cast<T*>(res);
  T* xp = static_cast<T*>(x);
  const T* cxp = static_cast<const T*>(cx);
  const T* cyp = static_cast<const T*>(cy);
  const T* czp = static_cast<const T*>(cz);
  const T* diagp = static_cast<const T*>(diag);
  T* np = static_cast<T*>(d_new);
  const T a = static_cast<T>(c1), b = static_cast<T>(c2);
  if (init) {
    k2_cells<T, CHEBY_INIT><<<grid, block, 0, s>>>(
        dp, resp, xp, cxp, cyp, czp, diagp, np, X, Y, Z, a, b);
  } else {
    k2_cells<T, CHEBY><<<grid, block, 0, s>>>(dp, resp, xp, cxp, cyp, czp,
                                              diagp, np, X, Y, Z, a, b);
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

int k2_cheby_f32(int init, const void* d, void* res, void* x, const void* cx,
                 const void* cy, const void* cz, const void* diag,
                 void* d_new, long long X, long long Y, long long Z,
                 double c1, double c2, void* stream) {
  return launch_cheby<float>(init, d, res, x, cx, cy, cz, diag, d_new, X, Y,
                             Z, c1, c2, stream);
}

int k2_cheby_f64(int init, const void* d, void* res, void* x, const void* cx,
                 const void* cy, const void* cz, const void* diag,
                 void* d_new, long long X, long long Y, long long Z,
                 double c1, double c2, void* stream) {
  return launch_cheby<double>(init, d, res, x, cx, cy, cz, diag, d_new, X, Y,
                              Z, c1, c2, stream);
}

const char* k2_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

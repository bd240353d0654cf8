// K3: the variable-coefficient offset stencil of the smoothed-aggregation
// coarse levels,  (A x)(i) = sum_t c_t(i) * x(i + o_t),  27 to 125 taps.
//
// Replaces openimpala_tpu/ops/offset_pallas.py::offset_stencil_pallas (body
// _offset_kernel).  The coefficients are packed as one (X, T, Y, Z) array,
// bfloat16 or the type of x; a launch uses the leading n_taps taps of each
// X plane's block (the nearest-neighbour prefix of the filtered smoother),
// the X stride staying T*Y*Z.  Every read of x wraps, by a true modulus on
// each axis, so any extent >= 1 and any |o| (also >= the extent) is right.
// With d the coefficient of tap diag_tap (the (0,0,0) offset), the modes
// compute
//   apply : out = A x
//   resid : out = d > 0 ? r - A x : 0
//   sweep : out = x + (d > 0 ? omega / d : 0) * (r - A x)
// The sum runs in x's type in tap order t = 0 .. n_taps-1, so it differs
// from the plain form (a sum of rolled multiplies) by FMA contraction only.
//
// Bound: bytes.  Per cell the function must move n_taps coefficients, x
// once, out once (and r for resid and sweep) for 2*n_taps flops, about a
// quarter of a flop per byte with float32 coefficients.
//
// Design: one thread per cell, 32 along Z by 8 along Y, one X plane per
// grid row.  At a fixed tap the 32 threads of a warp read 32 consecutive
// coefficients, so the coefficient stream (the bulk of the traffic) is
// coalesced and read exactly once; the shifted reads of x are re-reads that
// L1/L2 serve.  The offsets are run-time data (the build prunes taps by the
// geometry): up to 125 int8 triples passed by value in the kernel's
// parameters, read through the constant cache at a warp-uniform index.
// There is no padded copy of x, no per-plane window and no shared memory.

#include "common.cuh"

namespace {

using oit::BY;
using oit::BZ;
using oit::ceil_div;

constexpr int MAX_TAPS = 125;

enum Mode { APPLY = 0, RESID = 1, SWEEP = 2 };

struct Taps {
  int8_t o[MAX_TAPS][3];
};

// (i + o) mod n, in [0, n), for any o.
__device__ __forceinline__ int wrap(int i, int o, int n) {
  int j = i + o;
  if (j < 0 || j >= n) {
    j %= n;
    if (j < 0) j += n;
  }
  return j;
}

// A coefficient in x's type: a bf16 is the top half of a float.
template <typename T>
__device__ __forceinline__ T widen(uint16_t bits) {
  return static_cast<T>(__uint_as_float(static_cast<uint32_t>(bits) << 16));
}
template <typename T>
__device__ __forceinline__ T widen(T v) {
  return v;
}

template <typename T, typename C, int MODE>
__global__ void __launch_bounds__(BZ* BY)
    k3_cells(const T* __restrict__ x, const T* __restrict__ r,
             const C* __restrict__ packed, T* __restrict__ out, int X, int Y,
             int Z, int T_all, int n_taps, int diag_tap, Taps taps, T omega) {
  const int k = blockIdx.x * BZ + threadIdx.x;
  const int j = blockIdx.y * BY + threadIdx.y;
  const int i = blockIdx.z;
  if (k >= Z || j >= Y) return;
  const int64_t YZ = static_cast<int64_t>(Y) * Z;
  const int64_t col = static_cast<int64_t>(j) * Z + k;
  const int64_t cell = i * YZ + col;
  const C* __restrict__ c = packed + static_cast<int64_t>(i) * T_all * YZ + col;
  T acc = T(0);
#pragma unroll 4
  for (int t = 0; t < n_taps; ++t) {
    const int ii = wrap(i, taps.o[t][0], X);
    const int jj = wrap(j, taps.o[t][1], Y);
    const int kk = wrap(k, taps.o[t][2], Z);
    acc = acc + widen<T>(c[t * YZ]) * x[ii * YZ + static_cast<int64_t>(jj) * Z + kk];
  }
  if (MODE == APPLY) {
    out[cell] = acc;
    return;
  }
  const T d = widen<T>(c[diag_tap * YZ]);
  if (MODE == RESID) {
    out[cell] = d > T(0) ? r[cell] - acc : T(0);
  } else {
    const T inv_d = d > T(0) ? omega / d : T(0);
    out[cell] = x[cell] + inv_d * (r[cell] - acc);
  }
}

template <typename T, typename C>
int launch(int mode, const void* x, const void* r, const void* packed,
           void* out, int X, int Y, int Z, int T_all, int n_taps, int diag_tap,
           const Taps& taps, double omega, cudaStream_t s) {
  const dim3 block(BZ, BY);
  const dim3 grid(static_cast<unsigned>(ceil_div(Z, BZ)),
                  static_cast<unsigned>(ceil_div(Y, BY)),
                  static_cast<unsigned>(X));
  const T* xp = static_cast<const T*>(x);
  const T* rp = static_cast<const T*>(r);
  const C* cp = static_cast<const C*>(packed);
  T* op = static_cast<T*>(out);
  const T tom = static_cast<T>(omega);
  if (mode == APPLY) {
    k3_cells<T, C, APPLY><<<grid, block, 0, s>>>(xp, rp, cp, op, X, Y, Z, T_all,
                                                 n_taps, diag_tap, taps, tom);
  } else if (mode == RESID) {
    k3_cells<T, C, RESID><<<grid, block, 0, s>>>(xp, rp, cp, op, X, Y, Z, T_all,
                                                 n_taps, diag_tap, taps, tom);
  } else if (mode == SWEEP) {
    k3_cells<T, C, SWEEP><<<grid, block, 0, s>>>(xp, rp, cp, op, X, Y, Z, T_all,
                                                 n_taps, diag_tap, taps, tom);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x_f64: x, r, out are double (else float).  coeff_bf16: packed holds raw
// bfloat16 (else the type of x).  offsets: 3 * n_taps int8 on the host,
// (dx, dy, dz) per tap.  diag_tap: index of the (0,0,0) tap, read by resid
// and sweep only.
int k3_launch(int mode, int x_f64, int coeff_bf16, const void* x,
              const void* r, const void* packed, void* out, long long X,
              long long Y, long long Z, int T_all, int n_taps, int diag_tap,
              const signed char* offsets, double omega, void* stream) {
  if (n_taps < 1 || n_taps > T_all || n_taps > MAX_TAPS || X < 1 || Y < 1 ||
      Z < 1 || X > 65535 || Y > 2147483647LL || Z > 2147483647LL ||
      (mode != APPLY && (diag_tap < 0 || diag_tap >= n_taps)))
    return static_cast<int>(cudaErrorInvalidValue);
  Taps taps;
  for (int t = 0; t < n_taps; ++t)
    for (int a = 0; a < 3; ++a) taps.o[t][a] = offsets[3 * t + a];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int iX = static_cast<int>(X), iY = static_cast<int>(Y),
            iZ = static_cast<int>(Z);
  if (x_f64) {
    if (coeff_bf16)
      return launch<double, uint16_t>(mode, x, r, packed, out, iX, iY, iZ,
                                      T_all, n_taps, diag_tap, taps, omega, s);
    return launch<double, double>(mode, x, r, packed, out, iX, iY, iZ, T_all,
                                  n_taps, diag_tap, taps, omega, s);
  }
  if (coeff_bf16)
    return launch<float, uint16_t>(mode, x, r, packed, out, iX, iY, iZ, T_all,
                                   n_taps, diag_tap, taps, omega, s);
  return launch<float, float>(mode, x, r, packed, out, iX, iY, iZ, T_all,
                              n_taps, diag_tap, taps, omega, s);
}

const char* k3_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

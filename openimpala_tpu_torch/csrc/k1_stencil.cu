// K1: the fused masked 7-point stencil engine on the packed bf16 geometry.
//
// Replaces openimpala_tpu/ops/stencil_pallas.py::fused_stencil_pallas
// (body _fused_kernel_v3).  Per cell, with d and free decoded in-register
// from the bf16 code (isotropic: d = max(c,0)*w0; anisotropic: c = cx*16 +
// cy*4 + cz unpacked, d = w0*cx + w1*cy + w2*cz; free = c > 0) and
//   Ax = d*x - (w0*(x[i-1]+x[i+1]) + w1*(x[j-1]+x[j+1]) + w2*(x[k-1]+x[k+1]))
// where a neighbour outside a clamped axis reads 0 and a periodic axis
// wraps, the modes compute
//   matvec   : out = free ? Ax : 0            (+ optional <x, out>)
//   resid    : out = free ? r - Ax : 0
//   sweep    : out = x + (free && d>0 ? omega/d : 0) * (r - Ax)
//   restrict : out = blocksum_2x2x2(free ? r - Ax : 0)   (X/2, Y/2, Z/2)
//
// Design: one thread per output cell.  matvec/resid/sweep threads walk
// XT consecutive X planes of one (y, z) column, keeping x[i-1], x[i],
// x[i+1] in registers; Y and Z neighbours come through L1/L2.  restrict
// gives one thread per coarse cell, summing its 8 fine residuals in the
// plain form's order (Z pairs, then Y, then X).  The fused dot is summed in
// double, per thread, then per block by a fixed tree, then over blocks by a
// second one-block kernel: no float atomics, so it is the same bits on
// every run.

#include "common.cuh"

namespace {

using oit::BY;
using oit::BZ;
using oit::ceil_div;
using oit::neighbour;

constexpr int XT = 8;  // X planes walked by each matvec/resid/sweep thread

enum Mode { MATVEC = 0, RESID = 1, SWEEP = 2, RESTRICT = 3 };

struct Geom {
  int64_t X, Y, Z;
  int px, py, pz;  // periodic flags per axis
  int aniso;       // per-axis packing (anisotropic spacing)
};

__device__ __forceinline__ float tfloor(float v) { return floorf(v); }
__device__ __forceinline__ double tfloor(double v) { return floor(v); }

// (diag, free) from the raw bf16 bits: a bf16 is the top half of a float.
template <typename T>
__device__ __forceinline__ T decode(uint16_t bits, int aniso, T w0, T w1,
                                    T w2, bool& free) {
  const float cf = __uint_as_float(static_cast<uint32_t>(bits) << 16);
  free = cf > 0.0f;
  const T c = static_cast<T>(fmaxf(cf, 0.0f));
  if (!aniso) return c * w0;
  const T cx = tfloor(c * T(0.0625));
  const T rem = c - cx * T(16);
  const T cy = tfloor(rem * T(0.25));
  const T cz = rem - cy * T(4);
  return w0 * cx + w1 * cy + w2 * cz;
}

template <typename T, int MODE, bool DOT>
__global__ void __launch_bounds__(BZ* BY)
    k1_planes(const T* __restrict__ x, const T* __restrict__ r,
              const uint16_t* __restrict__ code, T* __restrict__ out,
              double* __restrict__ partials, Geom g, T w0, T w1, T w2,
              T omega) {
  const int64_t k = static_cast<int64_t>(blockIdx.x) * BZ + threadIdx.x;
  const int64_t j = static_cast<int64_t>(blockIdx.y) * BY + threadIdx.y;
  const int64_t i0 = static_cast<int64_t>(blockIdx.z) * XT;
  double acc = 0.0;
  if (k < g.Z && j < g.Y) {
    const int64_t YZ = g.Y * g.Z;
    const int64_t col = j * g.Z + k;
    const int64_t jm = neighbour(j, -1, g.Y, g.py);
    const int64_t jp = neighbour(j, 1, g.Y, g.py);
    const int64_t km = neighbour(k, -1, g.Z, g.pz);
    const int64_t kp = neighbour(k, 1, g.Z, g.pz);
    const int64_t i_end = i0 + XT < g.X ? i0 + XT : g.X;
    const int64_t im = neighbour(i0, -1, g.X, g.px);
    T xlo = im >= 0 ? x[im * YZ + col] : T(0);
    T xm = x[i0 * YZ + col];
    for (int64_t i = i0; i < i_end; ++i) {
      const int64_t ip = neighbour(i, 1, g.X, g.px);
      const T xhi = ip >= 0 ? x[ip * YZ + col] : T(0);
      const int64_t plane = i * YZ;
      const T ylo = jm >= 0 ? x[plane + jm * g.Z + k] : T(0);
      const T yhi = jp >= 0 ? x[plane + jp * g.Z + k] : T(0);
      const T zlo = km >= 0 ? x[plane + j * g.Z + km] : T(0);
      const T zhi = kp >= 0 ? x[plane + j * g.Z + kp] : T(0);
      const int64_t c = plane + col;
      bool free;
      const T d = decode<T>(code[c], g.aniso, w0, w1, w2, free);
      const T ax =
          d * xm - (w0 * (xlo + xhi) + w1 * (ylo + yhi) + w2 * (zlo + zhi));
      T o;
      if (MODE == MATVEC) {
        o = free ? ax : T(0);
      } else if (MODE == RESID) {
        o = free ? r[c] - ax : T(0);
      } else {
        const T inv_d = (free && d > T(0)) ? omega / d : T(0);
        o = xm + inv_d * (r[c] - ax);
      }
      out[c] = o;
      if (DOT) acc += static_cast<double>(o) * static_cast<double>(xm);
      xlo = xm;
      xm = xhi;
    }
  }
  if (DOT) {
    const double s = oit::block_sum(acc);
    if (threadIdx.x == 0 && threadIdx.y == 0)
      partials[(static_cast<int64_t>(blockIdx.z) * gridDim.y + blockIdx.y) *
                   gridDim.x +
               blockIdx.x] = s;
  }
}

// free ? r - Ax : 0 at fine cell (i, j, k).
template <typename T>
__device__ __forceinline__ T resid_at(const T* __restrict__ x,
                                      const T* __restrict__ r,
                                      const uint16_t* __restrict__ code,
                                      const Geom& g, int64_t i, int64_t j,
                                      int64_t k, T w0, T w1, T w2) {
  const int64_t YZ = g.Y * g.Z;
  const int64_t c = i * YZ + j * g.Z + k;
  bool free;
  const T d = decode<T>(code[c], g.aniso, w0, w1, w2, free);
  if (!free) return T(0);
  const int64_t im = neighbour(i, -1, g.X, g.px), ip = neighbour(i, 1, g.X, g.px);
  const int64_t jm = neighbour(j, -1, g.Y, g.py), jp = neighbour(j, 1, g.Y, g.py);
  const int64_t km = neighbour(k, -1, g.Z, g.pz), kp = neighbour(k, 1, g.Z, g.pz);
  const T xlo = im >= 0 ? x[im * YZ + j * g.Z + k] : T(0);
  const T xhi = ip >= 0 ? x[ip * YZ + j * g.Z + k] : T(0);
  const T ylo = jm >= 0 ? x[i * YZ + jm * g.Z + k] : T(0);
  const T yhi = jp >= 0 ? x[i * YZ + jp * g.Z + k] : T(0);
  const T zlo = km >= 0 ? x[i * YZ + j * g.Z + km] : T(0);
  const T zhi = kp >= 0 ? x[i * YZ + j * g.Z + kp] : T(0);
  const T ax =
      d * x[c] - (w0 * (xlo + xhi) + w1 * (ylo + yhi) + w2 * (zlo + zhi));
  return r[c] - ax;
}

template <typename T>
__global__ void __launch_bounds__(BZ* BY)
    k1_restrict(const T* __restrict__ x, const T* __restrict__ r,
                const uint16_t* __restrict__ code, T* __restrict__ out, Geom g,
                T w0, T w1, T w2) {
  const int64_t Zc = g.Z / 2, Yc = g.Y / 2;
  const int64_t kc = static_cast<int64_t>(blockIdx.x) * BZ + threadIdx.x;
  const int64_t jc = static_cast<int64_t>(blockIdx.y) * BY + threadIdx.y;
  const int64_t ic = blockIdx.z;
  if (kc >= Zc || jc >= Yc) return;
  const int64_t i = 2 * ic, j = 2 * jc, k = 2 * kc;
#define R_(a, b, c) resid_at<T>(x, r, code, g, i + (a), j + (b), k + (c), w0, w1, w2)
  const T s = ((R_(0, 0, 0) + R_(0, 0, 1)) + (R_(0, 1, 0) + R_(0, 1, 1))) +
              ((R_(1, 0, 0) + R_(1, 0, 1)) + (R_(1, 1, 0) + R_(1, 1, 1)));
#undef R_
  out[(ic * Yc + jc) * Zc + kc] = s;
}

dim3 planes_grid(int64_t X, int64_t Y, int64_t Z) {
  return dim3(static_cast<unsigned>(ceil_div(Z, BZ)),
              static_cast<unsigned>(ceil_div(Y, BY)),
              static_cast<unsigned>(ceil_div(X, XT)));
}

template <typename T>
int launch(int mode, int with_dot, const void* x, const void* r,
           const void* code, void* out, void* partials, void* dot, int64_t X,
           int64_t Y, int64_t Z, int px, int py, int pz, int aniso, double w0,
           double w1, double w2, double omega, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Geom g{X, Y, Z, px, py, pz, aniso};
  const T tw0 = static_cast<T>(w0), tw1 = static_cast<T>(w1),
          tw2 = static_cast<T>(w2), tom = static_cast<T>(omega);
  const T* xp = static_cast<const T*>(x);
  const T* rp = static_cast<const T*>(r);
  const uint16_t* cp = static_cast<const uint16_t*>(code);
  T* op = static_cast<T*>(out);
  double* pp = static_cast<double*>(partials);
  const dim3 block(BZ, BY);
  if (mode == RESTRICT) {
    const dim3 grid(static_cast<unsigned>(ceil_div(Z / 2, BZ)),
                    static_cast<unsigned>(ceil_div(Y / 2, BY)),
                    static_cast<unsigned>(X / 2));
    k1_restrict<T><<<grid, block, 0, s>>>(xp, rp, cp, op, g, tw0, tw1, tw2);
    return static_cast<int>(cudaGetLastError());
  }
  const dim3 grid = planes_grid(X, Y, Z);
  if (mode == MATVEC && with_dot) {
    k1_planes<T, MATVEC, true>
        <<<grid, block, 0, s>>>(xp, rp, cp, op, pp, g, tw0, tw1, tw2, tom);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    const int64_t n = static_cast<int64_t>(grid.x) * grid.y * grid.z;
    oit::reduce_partials<T><<<1, 1024, 0, s>>>(pp, n, static_cast<T*>(dot));
  } else if (mode == MATVEC) {
    k1_planes<T, MATVEC, false>
        <<<grid, block, 0, s>>>(xp, rp, cp, op, pp, g, tw0, tw1, tw2, tom);
  } else if (mode == RESID) {
    k1_planes<T, RESID, false>
        <<<grid, block, 0, s>>>(xp, rp, cp, op, pp, g, tw0, tw1, tw2, tom);
  } else if (mode == SWEEP) {
    k1_planes<T, SWEEP, false>
        <<<grid, block, 0, s>>>(xp, rp, cp, op, pp, g, tw0, tw1, tw2, tom);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Number of per-block partial sums the fused dot writes for an X*Y*Z volume.
long long k1_num_partials(long long X, long long Y, long long Z) {
  const dim3 g = planes_grid(X, Y, Z);
  return static_cast<long long>(g.x) * g.y * g.z;
}

int k1_launch_f32(int mode, int with_dot, const void* x, const void* r,
                  const void* code, void* out, void* partials, void* dot,
                  long long X, long long Y, long long Z, int px, int py,
                  int pz, int aniso, double w0, double w1, double w2,
                  double omega, void* stream) {
  return launch<float>(mode, with_dot, x, r, code, out, partials, dot, X, Y, Z,
                       px, py, pz, aniso, w0, w1, w2, omega, stream);
}

int k1_launch_f64(int mode, int with_dot, const void* x, const void* r,
                  const void* code, void* out, void* partials, void* dot,
                  long long X, long long Y, long long Z, int px, int py,
                  int pz, int aniso, double w0, double w1, double w2,
                  double omega, void* stream) {
  return launch<double>(mode, with_dot, x, r, code, out, partials, dot, X, Y,
                        Z, px, py, pz, aniso, w0, w1, w2, omega, stream);
}

const char* k1_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

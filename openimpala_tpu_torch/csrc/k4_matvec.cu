// K4: the masked 7-point matvec from explicit (diag, free) arrays, over an
// optional batch of volumes, with an optional fused <x, Ax> per lane.
//
// Replaces openimpala_tpu/ops/stencil_pallas.py::stencil_matvec_pallas
// (body _matvec_kernel).  Per cell of lane b
//   Ax  = d*x - (w0*(x[i-1]+x[i+1]) + w1*(x[j-1]+x[j+1]) + w2*(x[k-1]+x[k+1]))
//   out = free ? Ax : 0
// where a neighbour outside a clamped axis reads 0 and a periodic axis
// wraps inside its own lane: a neighbour index is formed within the lane's
// (X, Y, Z) extent and the lane's base offset is added afterwards, so it
// never reaches lane b-1 or b+1.  d comes in one of three forms chosen by
// the launcher: one scalar for all lanes (diag[0]), one scalar per lane
// (diag[b]), or a full array like x.  free is one byte per cell (int8 or
// bool), non-zero meaning free.
//
// Bound on an H100: bytes.  13 B per cell in float32 with a full diag (x 4,
// diag 4, free 1, out 4), 9 B with a scalar diag, 25 B / 17 B in float64,
// for about 10 flops.
//
// Design: one thread per output cell of a plane; each thread walks XT
// consecutive X planes of one (y, z) column of one lane, keeping x[i-1],
// x[i], x[i+1] in registers; Y and Z neighbours come through L1/L2.  The
// batch rides in gridDim.z (lane = blockIdx.z / blocks-per-lane).  The dot
// is summed in double per thread, then per block by a fixed tree, then per
// lane by a second kernel with one block per lane: no float atomics, so it
// is the same bits on every run.

#include "common.cuh"

namespace {

using oit::BY;
using oit::BZ;
using oit::ceil_div;
using oit::neighbour;

constexpr int XT = 8;  // X planes walked by each thread

enum DiagMode { DIAG_SCALAR = 0, DIAG_LANE = 1, DIAG_FULL = 2 };

struct Geom {
  int64_t X, Y, Z;
  int px, py, pz;  // periodic flags per axis
  int nxt;         // blocks along X per lane: ceil(X / XT)
};

template <typename T, int DM, bool DOT>
__global__ void __launch_bounds__(BZ* BY)
    k4_planes(const T* __restrict__ x, const T* __restrict__ diag,
              const uint8_t* __restrict__ free, T* __restrict__ out,
              double* __restrict__ partials, Geom g, T w0, T w1, T w2) {
  const int64_t k = static_cast<int64_t>(blockIdx.x) * BZ + threadIdx.x;
  const int64_t j = static_cast<int64_t>(blockIdx.y) * BY + threadIdx.y;
  const int64_t lane = blockIdx.z / g.nxt;
  const int64_t i0 = static_cast<int64_t>(blockIdx.z % g.nxt) * XT;
  double acc = 0.0;
  if (k < g.Z && j < g.Y) {
    const int64_t YZ = g.Y * g.Z;
    const int64_t base = lane * g.X * YZ;
    const T* xl = x + base;  // this lane's volume
    const T dsc = DM == DIAG_SCALAR ? diag[0]
                  : DM == DIAG_LANE ? diag[lane]
                                    : T(0);
    const int64_t col = j * g.Z + k;
    const int64_t jm = neighbour(j, -1, g.Y, g.py);
    const int64_t jp = neighbour(j, 1, g.Y, g.py);
    const int64_t km = neighbour(k, -1, g.Z, g.pz);
    const int64_t kp = neighbour(k, 1, g.Z, g.pz);
    const int64_t i_end = i0 + XT < g.X ? i0 + XT : g.X;
    const int64_t im = neighbour(i0, -1, g.X, g.px);
    T xlo = im >= 0 ? xl[im * YZ + col] : T(0);
    T xm = xl[i0 * YZ + col];
    for (int64_t i = i0; i < i_end; ++i) {
      const int64_t ip = neighbour(i, 1, g.X, g.px);
      const T xhi = ip >= 0 ? xl[ip * YZ + col] : T(0);
      const int64_t plane = i * YZ;
      const T ylo = jm >= 0 ? xl[plane + jm * g.Z + k] : T(0);
      const T yhi = jp >= 0 ? xl[plane + jp * g.Z + k] : T(0);
      const T zlo = km >= 0 ? xl[plane + j * g.Z + km] : T(0);
      const T zhi = kp >= 0 ? xl[plane + j * g.Z + kp] : T(0);
      const int64_t c = base + plane + col;
      const T d = DM == DIAG_FULL ? diag[c] : dsc;
      const T ax =
          d * xm - (w0 * (xlo + xhi) + w1 * (ylo + yhi) + w2 * (zlo + zhi));
      const T o = free[c] != 0 ? ax : T(0);
      out[c] = o;
      if (DOT) acc += static_cast<double>(o) * static_cast<double>(xm);
      xlo = xm;
      xm = xhi;
    }
  }
  if (DOT) {
    const double s = oit::block_sum(acc);
    // lane-major: the partials of one lane are contiguous
    if (threadIdx.x == 0 && threadIdx.y == 0)
      partials[(static_cast<int64_t>(blockIdx.z) * gridDim.y + blockIdx.y) *
                   gridDim.x +
               blockIdx.x] = s;
  }
}

dim3 lanes_grid(int64_t B, int64_t X, int64_t Y, int64_t Z) {
  return dim3(static_cast<unsigned>(ceil_div(Z, BZ)),
              static_cast<unsigned>(ceil_div(Y, BY)),
              static_cast<unsigned>(B * ceil_div(X, XT)));
}

template <typename T, int DM>
int launch_dm(int with_dot, const T* x, const T* diag, const uint8_t* free,
              T* out, double* partials, T* dot, int64_t B, const Geom& g,
              T w0, T w1, T w2, cudaStream_t s) {
  const dim3 grid = lanes_grid(B, g.X, g.Y, g.Z);
  const dim3 block(BZ, BY);
  if (!with_dot) {
    k4_planes<T, DM, false>
        <<<grid, block, 0, s>>>(x, diag, free, out, partials, g, w0, w1, w2);
    return static_cast<int>(cudaGetLastError());
  }
  k4_planes<T, DM, true>
      <<<grid, block, 0, s>>>(x, diag, free, out, partials, g, w0, w1, w2);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t n = static_cast<int64_t>(grid.x) * grid.y * g.nxt;
  oit::reduce_partials<T>
      <<<static_cast<unsigned>(B), 1024, 0, s>>>(partials, n, dot);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(int diag_mode, int with_dot, const void* x, const void* diag,
           const void* free, void* out, void* partials, void* dot, int64_t B,
           int64_t X, int64_t Y, int64_t Z, int px, int py, int pz, double w0,
           double w1, double w2, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Geom g{X, Y, Z, px, py, pz, static_cast<int>(ceil_div(X, XT))};
  const T tw0 = static_cast<T>(w0), tw1 = static_cast<T>(w1),
          tw2 = static_cast<T>(w2);
  const T* xp = static_cast<const T*>(x);
  const T* dp = static_cast<const T*>(diag);
  const uint8_t* fp = static_cast<const uint8_t*>(free);
  T* op = static_cast<T*>(out);
  double* pp = static_cast<double*>(partials);
  T* tp = static_cast<T*>(dot);
  switch (diag_mode) {
    case DIAG_SCALAR:
      return launch_dm<T, DIAG_SCALAR>(with_dot, xp, dp, fp, op, pp, tp, B, g,
                                       tw0, tw1, tw2, s);
    case DIAG_LANE:
      return launch_dm<T, DIAG_LANE>(with_dot, xp, dp, fp, op, pp, tp, B, g,
                                     tw0, tw1, tw2, s);
    case DIAG_FULL:
      return launch_dm<T, DIAG_FULL>(with_dot, xp, dp, fp, op, pp, tp, B, g,
                                     tw0, tw1, tw2, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Number of per-block partial sums the fused dot writes for B volumes of
// X*Y*Z cells (lane-major, the same count for every lane).
long long k4_num_partials(long long B, long long X, long long Y,
                          long long Z) {
  const dim3 g = lanes_grid(B, X, Y, Z);
  return static_cast<long long>(g.x) * g.y * g.z;
}

int k4_launch(int f64, int diag_mode, int with_dot, const void* x,
              const void* diag, const void* free, void* out, void* partials,
              void* dot, long long B, long long X, long long Y, long long Z,
              int px, int py, int pz, double w0, double w1, double w2,
              void* stream) {
  if (f64)
    return launch<double>(diag_mode, with_dot, x, diag, free, out, partials,
                          dot, B, X, Y, Z, px, py, pz, w0, w1, w2, stream);
  return launch<float>(diag_mode, with_dot, x, diag, free, out, partials, dot,
                       B, X, Y, Z, px, py, pz, w0, w1, w2, stream);
}

const char* k4_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

// K5: the masked 7-point matvec from explicit full (diag, free) arrays as
// one streaming pass down X.
//
// Replaces openimpala_tpu/ops/stencil_pallas.py::stencil_matvec_pallas_v2
// (body _matvec_kernel_v2): the same function as K4,
//   out = free ? d*x - (w0*(x[i-1]+x[i+1]) + w1*(x[j-1]+x[j+1])
//                       + w2*(x[k-1]+x[k+1])) : 0,
// no dot, no batch, diag always a full array; a neighbour outside a
// clamped axis reads 0, a periodic axis wraps.
//
// Bound on an H100: bytes, 13 B per cell in float32 (x 4, diag 4, free 1,
// out 4), 25 B in float64, for about 10 flops.
//
// Design, made for this card and not carried over from the TPU kernel's
// rings of planes and DMA semaphores: a block owns a (TY, TZ) tile of the
// (Y, Z) plane and walks down X.  Each thread holds x[i-1], x[i], x[i+1]
// of its own column in registers, so the X neighbours cost no second read.
// The tile of the current plane lives in shared memory with a one-cell
// halo, so the Y and Z neighbours are read there and every plane of x is
// fetched from global memory once per tile (plus the halo).  The next
// plane's tile is written into the other of two buffers from the registers
// that already hold it, which leaves one __syncthreads() per plane.  A
// walk covers a run of xseg planes (the whole of X for a large volume; a
// small one is cut into runs so that the card still fills); periodic X is
// handled at the two ends of the walk by the neighbour index alone.

#include "common.cuh"

namespace {

using oit::ceil_div;
using oit::neighbour;

constexpr int TZ = 32;  // tile along Z (the contiguous axis): one warp
constexpr int TY = 8;   // tile along Y
constexpr int SZ = TZ + 2, SY = TY + 2;  // tile plus halo
constexpr int NHALO = 2 * TZ + 2 * TY;   // halo cells without the corners
constexpr int MIN_RUN = 16;              // shortest run of planes per walk
constexpr int64_t TARGET_BLOCKS = 2048;  // about two waves of 132 SMs x 8

struct Geom {
  int64_t X, Y, Z;
  int px, py, pz;
};

// x at plane i and the logical in-plane position (j, k), where j may be
// -1 or Y (and k -1 or Z): the neighbour across the plane's edge, wrapped
// on a periodic axis and 0 on a clamped one.  Positions further out belong
// to no cell of the volume and read 0.
template <typename T>
__device__ __forceinline__ T fetch(const T* __restrict__ x, const Geom& g,
                                   int64_t i, int64_t j, int64_t k) {
  if (j == -1) j = g.py ? g.Y - 1 : -1;
  else if (j == g.Y) j = g.py ? 0 : -1;
  else if (j > g.Y) j = -1;
  if (k == -1) k = g.pz ? g.Z - 1 : -1;
  else if (k == g.Z) k = g.pz ? 0 : -1;
  else if (k > g.Z) k = -1;
  if (j < 0 || k < 0) return T(0);
  return x[(i * g.Y + j) * g.Z + k];
}

template <typename T>
__global__ void __launch_bounds__(TZ* TY)
    k5_stream(const T* __restrict__ x, const T* __restrict__ diag,
              const uint8_t* __restrict__ free, T* __restrict__ out, Geom g,
              int64_t xseg, T w0, T w1, T w2) {
  __shared__ T tile[2][SY * SZ];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int t = ty * TZ + tx;
  const int64_t k0 = static_cast<int64_t>(blockIdx.x) * TZ;
  const int64_t j0 = static_cast<int64_t>(blockIdx.y) * TY;
  const int64_t k = k0 + tx, j = j0 + ty;
  const bool valid = k < g.Z && j < g.Y;
  const int64_t i0 = static_cast<int64_t>(blockIdx.z) * xseg;
  const int64_t i_end = i0 + xseg < g.X ? i0 + xseg : g.X;

  // the first NHALO threads each also carry one halo cell (hj, hk), in
  // tile coordinates: the rows above and below, then the two side columns
  const bool has_halo = t < NHALO;
  int hj = 0, hk = 0;
  if (t < TZ) {
    hj = -1, hk = t;
  } else if (t < 2 * TZ) {
    hj = TY, hk = t - TZ;
  } else if (t < 2 * TZ + TY) {
    hj = t - 2 * TZ, hk = -1;
  } else if (has_halo) {
    hj = t - 2 * TZ - TY, hk = TZ;
  }
  const int own = (ty + 1) * SZ + tx + 1;
  const int hidx = (hj + 1) * SZ + hk + 1;

  const int64_t im = neighbour(i0, -1, g.X, g.px);
  T xlo = im >= 0 ? fetch(x, g, im, j, k) : T(0);
  T xm = fetch(x, g, i0, j, k);
  tile[0][own] = xm;
  if (has_halo) tile[0][hidx] = fetch(x, g, i0, j0 + hj, k0 + hk);
  int buf = 0;
  for (int64_t i = i0; i < i_end; ++i) {
    __syncthreads();  // tile[buf] holds plane i
    const int64_t ip = neighbour(i, 1, g.X, g.px);
    const T xhi = ip >= 0 ? fetch(x, g, ip, j, k) : T(0);
    const bool more = i + 1 < i_end;  // then ip == i + 1
    T hnext = T(0);
    if (more && has_halo) hnext = fetch(x, g, i + 1, j0 + hj, k0 + hk);
    if (valid) {
      const T* p = tile[buf];
      const T ylo = p[own - SZ], yhi = p[own + SZ];
      const T zlo = p[own - 1], zhi = p[own + 1];
      const int64_t c = (i * g.Y + j) * g.Z + k;
      const T ax = diag[c] * xm -
                   (w0 * (xlo + xhi) + w1 * (ylo + yhi) + w2 * (zlo + zhi));
      out[c] = free[c] != 0 ? ax : T(0);
    }
    if (more) {
      // plane i + 1 into the other buffer, which was last read at plane
      // i - 1, before this iteration's barrier
      tile[buf ^ 1][own] = xhi;
      if (has_halo) tile[buf ^ 1][hidx] = hnext;
    }
    xlo = xm;
    xm = xhi;
    buf ^= 1;
  }
}

// Planes per walk: the whole of X when the (Y, Z) tiles alone fill the
// card, else runs of at least MIN_RUN planes.
int64_t run_length(int64_t X, int64_t Y, int64_t Z) {
  const int64_t tiles = ceil_div(Z, TZ) * ceil_div(Y, TY);
  int64_t runs = ceil_div(TARGET_BLOCKS, tiles);
  const int64_t most = X / MIN_RUN > 1 ? X / MIN_RUN : 1;
  if (runs > most) runs = most;
  return ceil_div(X, runs);
}

template <typename T>
int launch(const void* x, const void* diag, const void* free, void* out,
           int64_t X, int64_t Y, int64_t Z, int px, int py, int pz, double w0,
           double w1, double w2, void* stream) {
  const Geom g{X, Y, Z, px, py, pz};
  const int64_t xseg = run_length(X, Y, Z);
  const dim3 grid(static_cast<unsigned>(ceil_div(Z, TZ)),
                  static_cast<unsigned>(ceil_div(Y, TY)),
                  static_cast<unsigned>(ceil_div(X, xseg)));
  k5_stream<T><<<grid, dim3(TZ, TY), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(diag),
      static_cast<const uint8_t*>(free), static_cast<T*>(out), g, xseg,
      static_cast<T>(w0), static_cast<T>(w1), static_cast<T>(w2));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int k5_launch(int f64, const void* x, const void* diag, const void* free,
              void* out, long long X, long long Y, long long Z, int px,
              int py, int pz, double w0, double w1, double w2, void* stream) {
  if (f64)
    return launch<double>(x, diag, free, out, X, Y, Z, px, py, pz, w0, w1, w2,
                          stream);
  return launch<float>(x, diag, free, out, X, Y, Z, px, py, pz, w0, w1, w2,
                       stream);
}

const char* k5_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

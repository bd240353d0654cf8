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
// Bound on an H100: bytes (10 B per cell for matvec, 14 for resid and
// sweep, 10.5 for restrict in float32, for 10 to 14 flops).  Two routes,
// chosen by the launcher from the shape alone (ops/stencil_cuda.py::
// k1_route); both evaluate the same expressions in the same order.
//
// The stream route (k1_stream) serves every volume whose rows are whole
// 16-byte vectors and at least one tile wide.  A block owns a tile of the
// (Y, Z) plane, NW*R rows by 32 vectors (16 x 128 cells in float32), and
// streams down a run of X planes chosen by the launcher (all of X where
// the grid still fills the card), so the X halo is two planes a run.
//   * x goes through shared memory only: one elected thread of a producer
//     warp asks the Tensor Memory Accelerator for the tile of each plane
//     with its one-cell halo (cp.async.bulk.tensor on a 3-D tensor map,
//     which zero-fills outside the volume: that is the clamped boundary)
//     into a ring of STAGES buffers, each with a "full" mbarrier the copy
//     completes on and an "empty" mbarrier the consumer warps release it
//     through.  There is no block-wide barrier in the plane loop: a warp
//     waits only for the plane it is about to read.
//   * a consumer thread owns R rows of one 16-byte vector (4 float32 or 2
//     float64 cells); x[i-1], x[i], x[i+1] of its cells rotate through
//     registers, the rows above and below come from the tile as one
//     16-byte shared load each, the Z neighbours from the neighbouring
//     lanes by shuffle (the tile's halo column for the edge lanes).
//   * r and code are used once: each is one streaming 16-byte (8-byte)
//     load per vector straight to registers, issued one plane ahead; out
//     is one streaming 16-byte store.
//   * on a periodic axis the plane index wraps in the producer, and the
//     threads at a Y or Z seam read the wrapped row or cell of the current
//     plane from global memory.
//   * restrict runs in the same pass: a thread's two rows and its vector
//     give the Z pairs and the Y pair with no exchange, the X pair is the
//     previous plane's partial in registers; sums in the plain form's
//     order (Z pairs, then Y, then X).
// The general route (k1_planes, k1_restrict) serves every other extent
// down to 1: one thread per output cell, each walking XT planes of one
// column with x[i-1], x[i], x[i+1] in registers and the Y and Z
// neighbours through L1/L2; restrict gives one thread per coarse cell.
//
// The fused dot is summed in double, per thread, then per block in a fixed
// order, then over blocks by a second one-block kernel: no float atomics,
// so it is the same bits on every run.

#include <cstring>

#include <cuda.h>

#include "common.cuh"

// Compile-time knobs (scripts/tune_k1.py builds variants with -D...).
#ifndef K1_STAGES
#define K1_STAGES 4  // planes of the x tile in the shared-memory ring
#endif
// Blocks per multiprocessor that ptxas must leave registers for when a
// thread owns two rows (R = 2), which needs 90 to 120 registers: held to
// 112, two blocks fit; left alone, some modes get one block and lose up to
// 30 %; held to 72 for three blocks, it spills and loses more.  One row
// needs about 70 and fits three blocks as it is.
#ifndef K1_MINB2
#define K1_MINB2 2
#endif

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
      // r before the code is decoded: placed after it, the load waits for
      // the code's, and resid and sweep take 14 % longer
      const T rv = MODE == MATVEC ? T(0) : r[c];
      bool free;
      const T d = decode<T>(code[c], g.aniso, w0, w1, w2, free);
      const T ax =
          d * xm - (w0 * (xlo + xhi) + w1 * (ylo + yhi) + w2 * (zlo + zhi));
      T o;
      if (MODE == MATVEC) {
        o = free ? ax : T(0);
      } else if (MODE == RESID) {
        o = free ? rv - ax : T(0);
      } else {
        const T inv_d = (free && d > T(0)) ? omega / d : T(0);
        o = xm + inv_d * (rv - ax);
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

// ---------------------------------------------------------------------------
// The stream route.
// ---------------------------------------------------------------------------

constexpr int NW = 8;      // consumer warps of a block, each R rows of a tile
constexpr int STAGES = K1_STAGES;
constexpr int STREAM_THREADS = (NW + 1) * 32;  // and one producer warp
// polls of one mbarrier wait before the kernel traps: a copy that never
// lands becomes a launch error, not a hung card
constexpr int64_t SPIN_LIMIT = int64_t(1) << 24;

// The tile of one plane in shared memory: ROWS rows (the tile's and one
// above and below) of ROW cells (the tile's 32 vectors and one vector on
// each side, which keeps the interior 16-byte aligned).
template <typename T, int R>
struct Tile {
  static constexpr int V = 16 / sizeof(T);  // cells of one 16-byte vector
  static constexpr int TZ = 32 * V;
  static constexpr int ROW = TZ + 2 * V;
  static constexpr int TY = NW * R;
  static constexpr int ROWS = TY + 2;
  static constexpr int BYTES = ROWS * ROW * static_cast<int>(sizeof(T));
  static constexpr int STRIDE = (BYTES + 127) / 128 * 128;  // TMA: 128 B
  static constexpr int SMEM = STAGES * STRIDE + 128;
};

struct SGeom {
  int X, Y, Z;
  int px, py, pz;
  int aniso;
  int run;  // X planes of one block
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (int64_t spin = 0;; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spin > SPIN_LIMIT) __trap();
  }
}

// One box of the 3-D tensor map at (z, y, x) into shared memory; the copy
// completes on the mbarrier.  Cells outside the volume arrive as zeros.
__device__ __forceinline__ void tma_load_plane(uint32_t dst,
                                               const CUtensorMap* map,
                                               uint32_t bar, int z, int y,
                                               int x) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(z), "r"(y), "r"(x)
      : "memory");
}

// 16-byte vectors of cells and the codes that go with them.
__device__ __forceinline__ void load_shared(const float* p, float (&a)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  a[0] = v.x, a[1] = v.y, a[2] = v.z, a[3] = v.w;
}
__device__ __forceinline__ void load_shared(const double* p, double (&a)[2]) {
  const double2 v = *reinterpret_cast<const double2*>(p);
  a[0] = v.x, a[1] = v.y;
}
__device__ __forceinline__ void load_cached(const float* p, float (&a)[4]) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  a[0] = v.x, a[1] = v.y, a[2] = v.z, a[3] = v.w;
}
__device__ __forceinline__ void load_cached(const double* p, double (&a)[2]) {
  const double2 v = __ldg(reinterpret_cast<const double2*>(p));
  a[0] = v.x, a[1] = v.y;
}
__device__ __forceinline__ void load_stream(const float* p, float (&a)[4]) {
  const float4 v = __ldcs(reinterpret_cast<const float4*>(p));
  a[0] = v.x, a[1] = v.y, a[2] = v.z, a[3] = v.w;
}
__device__ __forceinline__ void load_stream(const double* p, double (&a)[2]) {
  const double2 v = __ldcs(reinterpret_cast<const double2*>(p));
  a[0] = v.x, a[1] = v.y;
}
__device__ __forceinline__ void store_stream(float* p, const float (&a)[4]) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(a[0], a[1], a[2], a[3]));
}
__device__ __forceinline__ void store_stream(double* p, const double (&a)[2]) {
  __stcs(reinterpret_cast<double2*>(p), make_double2(a[0], a[1]));
}
// the coarse cells of one fine vector: two float32 or one float64
__device__ __forceinline__ void store_stream(float* p, const float (&a)[2]) {
  __stcs(reinterpret_cast<float2*>(p), make_float2(a[0], a[1]));
}
__device__ __forceinline__ void store_stream(double* p, const double (&a)[1]) {
  __stcs(p, a[0]);
}
// the raw bf16 codes of one vector of cells, kept packed in registers
__device__ __forceinline__ uint2 load_codes(const uint16_t* p, float) {
  return __ldcs(reinterpret_cast<const uint2*>(p));
}
__device__ __forceinline__ uint2 load_codes(const uint16_t* p, double) {
  return make_uint2(__ldcs(reinterpret_cast<const unsigned int*>(p)), 0u);
}
__device__ __forceinline__ uint16_t code_of(const uint2& c, int cell) {
  const unsigned int word = cell < 2 ? c.x : c.y;
  return static_cast<uint16_t>(cell & 1 ? word >> 16 : word & 0xffffu);
}

template <typename T, int MODE, bool DOT, int R>
__global__ void __launch_bounds__(STREAM_THREADS, R == 1 ? 1 : K1_MINB2)
    k1_stream(const __grid_constant__ CUtensorMap xmap,
              const T* __restrict__ x, const T* __restrict__ r,
              const uint16_t* __restrict__ code, T* __restrict__ out,
              double* __restrict__ partials, SGeom g, T w0, T w1, T w2,
              T omega) {
  using L = Tile<T, R>;
  constexpr int V = L::V;
  static_assert(MODE != RESTRICT || R == 2, "restrict pairs two rows");
  static_assert(STAGES >= 3 && (STAGES & (STAGES - 1)) == 0, "ring size");
  extern __shared__ unsigned char dyn_smem[];
  __shared__ uint64_t bars[2 * STAGES];
  __shared__ double warp_sums[NW];
  // the ring, 128-byte aligned as the bulk copy wants it
  const uint32_t ring = (smem_u32(dyn_smem) + 127u) & ~127u;
  const unsigned char* ring_ptr = dyn_smem + (ring - smem_u32(dyn_smem));
  const uint32_t full0 = smem_u32(bars), empty0 = full0 + 8u * STAGES;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k0 = blockIdx.x * L::TZ, j0 = blockIdx.y * L::TY;
  const int i0 = blockIdx.z * g.run;
  const int i_end = i0 + g.run < g.X ? i0 + g.run : g.X;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8u * s, 1);
      mbar_init(empty0 + 8u * s, NW);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  double acc = 0.0;
  if (warp == NW) {
    // producer: planes i0-1 .. i_end of this tile, STAGES in flight
    if (lane == 0) {
      const int nplanes = i_end - i0 + 2;
      for (int p = 0; p < nplanes; ++p) {
        const int s = p % STAGES, use = p / STAGES;
        if (use > 0) mbar_wait(empty0 + 8u * s, (use - 1) & 1);
        int xi = i0 - 1 + p;  // outside a clamped X the copy brings zeros
        if (g.px) xi = xi < 0 ? xi + g.X : xi >= g.X ? xi - g.X : xi;
        mbar_expect_tx(full0 + 8u * s, L::BYTES);
        tma_load_plane(ring + s * L::STRIDE, &xmap, full0 + 8u * s, k0 - V,
                       j0 - 1, xi);
      }
    }
  } else {
    const int kk = k0 + lane * V;     // first cell of this thread's vector
    const int jb = j0 + warp * R;     // first of its rows
    const int col = V + lane * V;     // the vector's column in a tile row
    const int trow = warp * R + 1;    // tile row of row jb
    const size_t YZ = static_cast<size_t>(g.Y) * g.Z;
    bool in[R];
    size_t off[R];  // offset of the vector in a plane, per row
#pragma unroll
    for (int q = 0; q < R; ++q) {
      in[q] = kk < g.Z && jb + q < g.Y;
      off[q] = static_cast<size_t>(jb + q) * g.Z + kk;
    }
    const bool zlo_seam = g.pz && kk == 0;
    const bool zhi_seam = g.pz && kk + V == g.Z;
    auto tile = [&](int s) {
      return reinterpret_cast<const T*>(ring_ptr + s * L::STRIDE);
    };
    auto release = [&](int s) {
      // The warp's reads of stage s are generic-proxy loads; the next copy
      // into it is an async-proxy write.  Without this fence the copy may
      // land before a read is performed (reads delayed behind the r and
      // code loads of the next plane): one warp's row of one plane then
      // comes out wrong, once in a few hundred periodic launches while
      // device memory is mapped or unmapped meanwhile.
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8u * s);
    };
    // r and code of one plane, straight to registers
    auto fetch = [&](int i, T(&rr)[R][V], uint2(&cc)[R]) {
#pragma unroll
      for (int q = 0; q < R; ++q) {
        cc[q] = make_uint2(0u, 0u);
#pragma unroll
        for (int c = 0; c < V; ++c) rr[q][c] = T(0);
        if (in[q]) {
          const size_t at = static_cast<size_t>(i) * YZ + off[q];
          cc[q] = load_codes(code + at, T(0));
          if (MODE != MATVEC) load_stream(r + at, rr[q]);
        }
      }
    };

    T xlo[R][V], xm[R][V], xhi[R][V], rc[R][V], rn[R][V];
    uint2 cc[R], cn[R];
    T keep[V / 2];  // restrict: the even plane's partial sums
#pragma unroll
    for (int h = 0; h < V / 2; ++h) keep[h] = T(0);
    fetch(i0, rc, cc);
    mbar_wait(full0, 0);
#pragma unroll
    for (int q = 0; q < R; ++q)
      load_shared(tile(0) + (trow + q) * L::ROW + col, xlo[q]);
    release(0);
    mbar_wait(full0 + 8u, 0);
#pragma unroll
    for (int q = 0; q < R; ++q)
      load_shared(tile(1) + (trow + q) * L::ROW + col, xm[q]);

#pragma unroll 1
    for (int i = i0; i < i_end; ++i) {
      const int p = i - i0 + 1, pn = p + 1;  // ring positions of i, i+1
      const int s = p % STAGES, sn = pn % STAGES;
      if (i + 1 < i_end) fetch(i + 1, rn, cn);
      mbar_wait(full0 + 8u * sn, (pn / STAGES) & 1);
      const T* tc = tile(s);
      const T* tn = tile(sn);
      T ybelow[V], yabove[V], zl[R], zh[R];
#pragma unroll
      for (int q = 0; q < R; ++q)
        load_shared(tn + (trow + q) * L::ROW + col, xhi[q]);
      load_shared(tc + (trow - 1) * L::ROW + col, ybelow);
      load_shared(tc + (trow + R) * L::ROW + col, yabove);
#pragma unroll
      for (int q = 0; q < R; ++q) {
        zl[q] = __shfl_up_sync(0xffffffffu, xm[q][V - 1], 1);
        zh[q] = __shfl_down_sync(0xffffffffu, xm[q][0], 1);
        if (lane == 0) zl[q] = tc[(trow + q) * L::ROW + col - 1];
        if (lane == 31) zh[q] = tc[(trow + q) * L::ROW + col + V];
      }
      release(s);  // plane i's tile is read; i+1's goes next time round
      const size_t plane = static_cast<size_t>(i) * YZ;
      T o[R][V];
#pragma unroll
      for (int q = 0; q < R; ++q) {
        T ylo[V], yhi[V];
#pragma unroll
        for (int c = 0; c < V; ++c) {
          ylo[c] = q == 0 ? ybelow[c] : xm[q > 0 ? q - 1 : 0][c];
          yhi[c] = q == R - 1 ? yabove[c] : xm[q < R - 1 ? q + 1 : 0][c];
        }
        if (in[q]) {  // the seams of the periodic axes, from global memory
          if (g.py && jb + q == 0)
            load_cached(x + plane + static_cast<size_t>(g.Y - 1) * g.Z + kk,
                        ylo);
          if (g.py && jb + q == g.Y - 1) load_cached(x + plane + kk, yhi);
          if (zlo_seam) zl[q] = __ldg(x + plane + off[q] + (g.Z - 1));
          if (zhi_seam) zh[q] = __ldg(x + plane + off[q] - kk);
        }
#pragma unroll
        for (int c = 0; c < V; ++c) {
          const T zlo = c == 0 ? zl[q] : xm[q][c > 0 ? c - 1 : 0];
          const T zhi = c == V - 1 ? zh[q] : xm[q][c < V - 1 ? c + 1 : 0];
          bool free;
          const T d =
              decode<T>(code_of(cc[q], c), g.aniso, w0, w1, w2, free);
          const T xc = xm[q][c];
          const T ax = d * xc - (w0 * (xlo[q][c] + xhi[q][c]) +
                                 w1 * (ylo[c] + yhi[c]) + w2 * (zlo + zhi));
          if (MODE == MATVEC) {
            o[q][c] = free ? ax : T(0);
          } else if (MODE == RESID || MODE == RESTRICT) {
            o[q][c] = free ? rc[q][c] - ax : T(0);
          } else {
            const T inv_d = (free && d > T(0)) ? omega / d : T(0);
            o[q][c] = xc + inv_d * (rc[q][c] - ax);
          }
          if (DOT)
            acc += static_cast<double>(o[q][c]) * static_cast<double>(xc);
        }
        if (MODE != RESTRICT && in[q]) store_stream(out + plane + off[q], o[q]);
      }
      if (MODE == RESTRICT) {
        T zp[V / 2];  // Z pairs, then the Y pair
#pragma unroll
        for (int h = 0; h < V / 2; ++h)
          zp[h] = (o[0][2 * h] + o[0][2 * h + 1]) +
                  (o[R - 1][2 * h] + o[R - 1][2 * h + 1]);
        if (i & 1) {  // then the X pair
#pragma unroll
          for (int h = 0; h < V / 2; ++h) zp[h] = keep[h] + zp[h];
          if (in[0])
            store_stream(out + (static_cast<size_t>(i >> 1) * (g.Y >> 1) +
                                (jb >> 1)) * (g.Z >> 1) + (kk >> 1),
                         zp);
        } else {
#pragma unroll
          for (int h = 0; h < V / 2; ++h) keep[h] = zp[h];
        }
      }
#pragma unroll
      for (int q = 0; q < R; ++q) {
        cc[q] = cn[q];
#pragma unroll
        for (int c = 0; c < V; ++c) {
          xlo[q][c] = xm[q][c];
          xm[q][c] = xhi[q][c];
          rc[q][c] = rn[q][c];
        }
      }
    }
  }
  if (DOT) {
    // lanes by a fixed butterfly, then the warps in order
#pragma unroll
    for (int h = 16; h > 0; h >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, h);
    if (lane == 0 && warp < NW) warp_sums[warp] = acc;
    __syncthreads();
    if (threadIdx.x == 0) {
      double s = 0.0;
      for (int wi = 0; wi < NW; ++wi) s += warp_sums[wi];
      partials[(static_cast<int64_t>(blockIdx.z) * gridDim.y + blockIdx.y) *
                   gridDim.x +
               blockIdx.x] = s;
    }
  }
}

template <typename T, int R>
dim3 stream_grid(int64_t X, int64_t Y, int64_t Z, int64_t run) {
  using L = Tile<T, R>;
  return dim3(static_cast<unsigned>(ceil_div(Z, L::TZ)),
              static_cast<unsigned>(ceil_div(Y, L::TY)),
              static_cast<unsigned>(ceil_div(X, run)));
}

template <typename T, int MODE, bool DOT, int R>
cudaError_t launch_stream_as(const CUtensorMap& map, const T* x, const T* r,
                             const uint16_t* code, T* out, double* partials,
                             const SGeom& g, T w0, T w1, T w2, T omega,
                             cudaStream_t s) {
  using L = Tile<T, R>;
  auto* kernel = k1_stream<T, MODE, DOT, R>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (attr != cudaSuccess) return attr;
  kernel<<<stream_grid<T, R>(g.X, g.Y, g.Z, g.run), STREAM_THREADS, L::SMEM,
           s>>>(map, x, r, code, out, partials, g, w0, w1, w2, omega);
  return cudaGetLastError();
}

template <typename T, int R>
int launch_stream(int mode, int with_dot, const void* map, const void* x,
                  const void* r, const void* code, void* out, void* partials,
                  int64_t partials_cap, void* dot, int64_t X, int64_t Y,
                  int64_t Z, int px, int py, int pz, int aniso, double w0,
                  double w1, double w2, double omega, int64_t run,
                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const SGeom g{static_cast<int>(X), static_cast<int>(Y),
                static_cast<int>(Z), px,  py, pz, aniso,
                static_cast<int>(run)};
  CUtensorMap m;
  memcpy(&m, map, sizeof(m));
  const T tw0 = static_cast<T>(w0), tw1 = static_cast<T>(w1),
          tw2 = static_cast<T>(w2), tom = static_cast<T>(omega);
  const T* xp = static_cast<const T*>(x);
  const T* rp = static_cast<const T*>(r);
  const uint16_t* cp = static_cast<const uint16_t*>(code);
  T* op = static_cast<T*>(out);
  double* pp = static_cast<double*>(partials);
#define STREAM_(MODE_, DOT_)                                                 \
  launch_stream_as<T, MODE_, DOT_, R>(m, xp, rp, cp, op, pp, g, tw0, tw1, tw2, \
                                      tom, s)
  cudaError_t e;
  if (mode == MATVEC && with_dot) {
    const dim3 grid = stream_grid<T, R>(X, Y, Z, run);
    const int64_t n = static_cast<int64_t>(grid.x) * grid.y * grid.z;
    if (n > partials_cap) return static_cast<int>(cudaErrorInvalidValue);
    e = STREAM_(MATVEC, true);
    if (e != cudaSuccess) return static_cast<int>(e);
    oit::reduce_partials<T><<<1, 1024, 0, s>>>(pp, n, static_cast<T*>(dot));
    e = cudaGetLastError();
  } else if (mode == MATVEC) {
    e = STREAM_(MATVEC, false);
  } else if (mode == RESID) {
    e = STREAM_(RESID, false);
  } else if (mode == SWEEP) {
    e = STREAM_(SWEEP, false);
  } else if (mode == RESTRICT) {
    if (R != 2 || (X | Y | Z | run) & 1)
      return static_cast<int>(cudaErrorInvalidValue);
    e = launch_stream_as<T, RESTRICT, false, 2>(m, xp, rp, cp, op, pp, g, tw0,
                                                tw1, tw2, tom, s);
  } else {
    e = cudaErrorInvalidValue;
  }
#undef STREAM_
  return static_cast<int>(e);
}

// cuTensorMapEncodeTiled, through the runtime: the library links no -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                  cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The map of an (X, Y, Z) volume whose box is one plane's tile with its
// halo: ROW cells along Z, ROWS along Y, one plane.
template <typename T, int R>
int encode_map(void* map, const void* x, int64_t X, int64_t Y, int64_t Z) {
  using L = Tile<T, R>;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return -1;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(Z),
                              static_cast<cuuint64_t>(Y),
                              static_cast<cuuint64_t>(X)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(Z) * sizeof(T),
                                 static_cast<cuuint64_t>(Y) * Z * sizeof(T)};
  const cuuint32_t box[3] = {L::ROW, L::ROWS, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  CUtensorMap m;
  const CUresult res = fn(
      &m,
      sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                     : CU_TENSOR_MAP_DATA_TYPE_FLOAT64,
      3, const_cast<void*>(x), dims, strides, box, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return static_cast<int>(res);
  memcpy(map, &m, sizeof(m));
  return 0;
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

// The stream route.  `map` is the 128-byte tensor map k1_encode_map wrote
// for this x, dtype and rows per thread; `run` the X planes of one block
// (even for restrict); `partials_cap` the doubles `partials` can hold.
int k1_launch_stream(int f64, int rows, int mode, int with_dot,
                     const void* map, const void* x, const void* r,
                     const void* code, void* out, void* partials,
                     long long partials_cap, void* dot, long long X,
                     long long Y, long long Z, int px, int py, int pz,
                     int aniso, double w0, double w1, double w2, double omega,
                     long long run, void* stream) {
  if (run < 1 || (rows != 1 && rows != 2))
    return static_cast<int>(cudaErrorInvalidValue);
#define ARGS_                                                               \
  mode, with_dot, map, x, r, code, out, partials, partials_cap, dot, X, Y, Z, \
      px, py, pz, aniso, w0, w1, w2, omega, run, stream
  if (f64)
    return rows == 2 ? launch_stream<double, 2>(ARGS_)
                     : launch_stream<double, 1>(ARGS_);
  return rows == 2 ? launch_stream<float, 2>(ARGS_)
                   : launch_stream<float, 1>(ARGS_);
#undef ARGS_
}

// Writes the tensor map of x for the stream route into `map` (128 bytes).
// Returns 0, a CUresult, or -1 where the CUDA library has no encoder.
int k1_encode_map(void* map, int f64, int rows, const void* x, long long X,
                  long long Y, long long Z) {
  if (f64)
    return rows == 2 ? encode_map<double, 2>(map, x, X, Y, Z)
                     : encode_map<double, 1>(map, x, X, Y, Z);
  return rows == 2 ? encode_map<float, 2>(map, x, X, Y, Z)
                   : encode_map<float, 1>(map, x, X, Y, Z);
}

const char* k1_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

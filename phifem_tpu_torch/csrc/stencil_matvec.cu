// P1 cell-stencil matvec on the (ny+1) x (nx+1) vertex lattice, for Hopper.
//
// Replaces phifem_tpu/ops/pallas_stencil.py:stencil_matvec_pallas (both of
// its bodies: the masked _make_kernel and the maskless _make_kernel_full).
// For output vertex (r, c):
//
//   y[r,c] += sum_o sum_i [cell (r-dy_i, c-dx_i) is a real cell]
//                  * M_o[r-dy_i, c-dx_i]                 (masked variant only)
//                  * sum_j A_o[i,j] * x[r-dy_i+dy_j, c-dx_i+dx_j]
//
// with (dx_k, dy_k) the lattice offsets of a cell's local nodes (triangles:
// 2 orientations x 3 nodes, quads: 1 x 4; phifem_tpu_torch/ops/stencil.py).
//
// Bound: device-memory bandwidth.  Per vertex the kernel must read x once,
// the masks once (masked variant) and y once, and write y once: 12 B in f32,
// 24 B in f64 (plus 2 x 4 or 2 x 8 B of masks on triangles), against ~36
// flops.  The first version (one thread per output, each of its six cell
// terms under its own bounds check) stayed below half of that bound in
// float32: 18 predicated 4-byte loads of x per output that the compiler could
// neither merge nor hoist, so the same instruction stream moved 2.2 TB/s in
// float64 and 1.4 TB/s in float32 (H100, 3201 x 3201).  It was bound by
// instructions and load slots per byte, not by device memory.
//
// Design.
//  * blockIdx decides, for a whole CTA, whether its tile touches a lattice
//    edge.  Interior tiles run a body with no bounds check at all: its loads
//    are unconditional, so they merge to the 7 (9) distinct points and are
//    all issued before the first sum.  That alone is most of the gain (one
//    row per thread: 0.053 ms in float32 against 0.087 ms).  Edge tiles (8%
//    of them at 3201 x 3201) keep the checked body, which never reads outside
//    the lattice: there is no padded copy of x.  The maskless variant reads
//    no mask.
//  * A thread owns one lattice column and a vertical run of consecutive rows
//    (8 in float32, 2 in float64).  It loads the (rows+2) x 3 window of x
//    around its run, the (rows+1) x 2 window of each orientation's masks and
//    its y values into registers once, up front, and every output of the run
//    reads them from there: 3.75 loads of x per output in float32 instead of
//    18, and the index arithmetic paid once per run (another 3-12%).
//  * threadIdx.x runs along a lattice row, so every load and store of a warp
//    is 32 consecutive elements, a whole 128-byte (256-byte) request whatever
//    the alignment of the row; the run is vertical for that reason.  A
//    horizontal run with 16-byte accesses to y was built and measured: it
//    needs a per-row column shift to align y (a lattice row of odd length,
//    3,201 on the main path, is not 16-byte aligned), which rules out reuse
//    across rows, and its x loads stride by 16 bytes between lanes.  It came
//    out level in float32 and 5-15% slower in float64.
//  * No shared-memory tile and no TMA.  The neighbours' columns and the halo
//    rows that a CTA's warps share come from L1 in full-line requests, and
//    once the checks were gone the tile sizes tried (32 to 512 columns, 1 to
//    16 rows per thread) all came within 10% of each other: what is left is
//    the memory system, not the load path.  A TMA tensor map (global strides
//    must be multiples of 16 bytes) or cp.async.bulk would need a padded copy
//    of x, and the bound counts x once.
//  * A CTA is kBX x kBY = 128 x 2 threads and covers 128 columns x 16 (f32)
//    or 4 (f64) rows: 5,226 / 20,826 CTAs at 3201 x 3201, 40 / 158 per SM.
//    ptxas reports 64 registers per thread for the float32 bodies (107 for
//    masked triangles) and 47-64 for float64, so 4 CTAs (2 for masked f32
//    triangles) of 256 threads are resident on each of the 132 SMs, each
//    thread with 20-60 independent loads in flight; wider, taller or smaller
//    tiles were no faster.
//  * The loops over orientation and local nodes are unrolled at compile time
//    (templates on the scalar type, on masked/maskless and on triangle/quad);
//    the element matrices (at most 18 numbers) arrive by value in the launch,
//    so no thread reads them from device memory.  y is updated IN PLACE
//    (y += A x, each y read once and written once by its own thread), which
//    is what StencilCellBatch.matvec_into needs.
//
// The order of the sums is that of the first version, bit for bit: per
// output s = sum_j A[i,j] x_j over j ascending (a chain of FMAs from 0), the
// mask multiply, acc += s over (o, i) ascending skipping cells outside the
// lattice, then one y += acc.  The 18 (16) element-matrix entries are NOT
// collapsed into a 7- (9-) point vertex stencil: that is another rounding,
// and every solver iteration count of the port depends on this one.
//
// Plain C interface, loaded with ctypes (phifem_tpu_torch/ops/cuda_stencil.py):
// phifem_stencil_matvec returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>

// The tile shape; phifem_tpu_torch/ops/cuda_stencil.py mirrors it (BLOCK,
// ROWS) and refuses a library built for another (phifem_stencil_constants).
#ifndef PHIFEM_STENCIL_BX
#define PHIFEM_STENCIL_BX 128
#endif
#ifndef PHIFEM_STENCIL_BY
#define PHIFEM_STENCIL_BY 2
#endif
#ifndef PHIFEM_STENCIL_ROWS_F32
#define PHIFEM_STENCIL_ROWS_F32 8
#endif
#ifndef PHIFEM_STENCIL_ROWS_F64
#define PHIFEM_STENCIL_ROWS_F64 2
#endif

namespace {

constexpr int kMaxEntries = 18;  // 2 orientations x 3 x 3 (quads use 16)
constexpr int kBX = PHIFEM_STENCIL_BX;  // threads of a CTA along a lattice row
constexpr int kBY = PHIFEM_STENCIL_BY;  // thread rows of a CTA

// consecutive lattice rows one thread computes
template <typename T>
__host__ __device__ constexpr int rows_per_thread() {
  return sizeof(T) == 4 ? PHIFEM_STENCIL_ROWS_F32 : PHIFEM_STENCIL_ROWS_F64;
}

template <typename T>
struct Mats {
  T a[kMaxEntries];
};

// Local node i of orientation o sits at lattice offset (odx, ody) from the
// cell's (v00) corner.  Triangles: lower (0,0),(1,0),(1,1); upper (0,0),
// (1,1),(0,1).  Quads: (0,0),(1,0),(0,1),(1,1).
template <bool TRI>
__host__ __device__ constexpr int odx(int o, int i) {
  return TRI ? (o == 0 ? (i >= 1 ? 1 : 0) : (i == 1 ? 1 : 0)) : (i & 1);
}

template <bool TRI>
__host__ __device__ constexpr int ody(int o, int i) {
  return TRI ? (o == 0 ? (i == 2 ? 1 : 0) : (i >= 1 ? 1 : 0)) : (i >> 1);
}

// The run of rows r0 .. r0+R-1 of column c.  CHECKED: the tile may reach
// past a lattice edge, so every access is held to the lattice and every cell
// to the real cells; else the caller guarantees 1 <= r0, r0+R <= ny and
// 1 <= c <= nx-1, and nothing is checked.
template <typename T, bool TRI, bool MASKED, bool CHECKED>
__device__ __forceinline__ void stencil_run(const T* __restrict__ x,
                                            T* __restrict__ y,
                                            const T* __restrict__ masks,
                                            const Mats<T>& m, int nx, int ny,
                                            int r0, int c) {
  constexpr int NO = TRI ? 2 : 1;
  constexpr int NL = TRI ? 3 : 4;
  constexpr int R = rows_per_thread<T>();
  if (CHECKED && (c > nx || r0 > ny)) return;
  const int C = nx + 1;

  // xw[k][d] = x[r0-1+k, c-1+d]; entries no output of the run uses (two
  // corners on triangles) are never loaded
  T xw[R + 2][3];
#pragma unroll
  for (int k = 0; k < R + 2; ++k) {
    const int rr = r0 - 1 + k;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const int cc = c - 1 + d;
      const bool in = !CHECKED || (rr >= 0 && rr <= ny && cc >= 0 && cc <= nx);
      xw[k][d] = in ? x[rr * C + cc] : T(0);
    }
  }
  // mw[o][k][d] = M_o[r0-1+k, c-1+d] (cells)
  T mw[NO][R + 1][2];
  if constexpr (MASKED) {
#pragma unroll
    for (int o = 0; o < NO; ++o) {
#pragma unroll
      for (int k = 0; k < R + 1; ++k) {
        const int cr = r0 - 1 + k;
#pragma unroll
        for (int d = 0; d < 2; ++d) {
          const int cc = c - 1 + d;
          const bool in = !CHECKED || (cr >= 0 && cr < ny && cc >= 0 && cc < nx);
          mw[o][k][d] = in ? masks[(o * ny + cr) * nx + cc] : T(0);
        }
      }
    }
  }
  T yv[R];
#pragma unroll
  for (int q = 0; q < R; ++q) {
    yv[q] = (!CHECKED || r0 + q <= ny) ? y[(r0 + q) * C + c] : T(0);
  }

#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int r = r0 + q;
    if (CHECKED && r > ny) continue;
    T acc = T(0);
#pragma unroll
    for (int o = 0; o < NO; ++o) {
#pragma unroll
      for (int i = 0; i < NL; ++i) {
        // the cell whose node i is (r, c), and its place in the windows
        const int kr = q + 1 - ody<TRI>(o, i);
        const int kc = 1 - odx<TRI>(o, i);
        if (CHECKED) {
          const int cr = r - ody<TRI>(o, i);
          const int cc = c - odx<TRI>(o, i);
          if (cr < 0 || cr >= ny || cc < 0 || cc >= nx) continue;
        }
        T s = T(0);
#pragma unroll
        for (int j = 0; j < NL; ++j) {
          s += m.a[(o * NL + i) * NL + j] *
               xw[kr + ody<TRI>(o, j)][kc + odx<TRI>(o, j)];
        }
        if constexpr (MASKED) s *= mw[o][kr][kc];
        acc += s;
      }
    }
    y[r * C + c] = yv[q] + acc;
  }
}

template <typename T, bool TRI, bool MASKED>
__global__ void __launch_bounds__(kBX * kBY)
stencil_matvec_kernel(const T* __restrict__ x, T* __restrict__ y,
                      const T* __restrict__ masks, const Mats<T> m, int nx,
                      int ny) {
  constexpr int R = rows_per_thread<T>();
  const int c_lo = blockIdx.x * kBX;
  const int r_lo = blockIdx.y * (kBY * R);
  const int c = c_lo + threadIdx.x;
  const int r0 = r_lo + threadIdx.y * R;
  // the tile's outputs all lie in rows 1 .. ny-1 and columns 1 .. nx-1
  const bool interior =
      c_lo >= 1 && c_lo + kBX <= nx && r_lo >= 1 && r_lo + kBY * R <= ny;
  if (interior) {
    stencil_run<T, TRI, MASKED, false>(x, y, masks, m, nx, ny, r0, c);
  } else {
    stencil_run<T, TRI, MASKED, true>(x, y, masks, m, nx, ny, r0, c);
  }
}

template <typename T, bool TRI>
void launch(const T* x, T* y, const T* masks, const double* mats, int nx,
            int ny, cudaStream_t stream) {
  constexpr int NO = TRI ? 2 : 1;
  constexpr int NL = TRI ? 3 : 4;
  constexpr int TR = kBY * rows_per_thread<T>();
  Mats<T> m;
  for (int k = 0; k < kMaxEntries; ++k) {
    m.a[k] = k < NO * NL * NL ? static_cast<T>(mats[k]) : T(0);
  }
  const dim3 block(kBX, kBY);
  const dim3 grid((nx + kBX) / kBX, (ny + TR) / TR);
  if (masks != nullptr) {
    stencil_matvec_kernel<T, TRI, true>
        <<<grid, block, 0, stream>>>(x, y, masks, m, nx, ny);
  } else {
    stencil_matvec_kernel<T, TRI, false>
        <<<grid, block, 0, stream>>>(x, y, nullptr, m, nx, ny);
  }
}

template <typename T>
void dispatch(const void* x, void* y, const void* masks, const double* mats,
              int nx, int ny, int tri, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  const T* mt = static_cast<const T*>(masks);
  if (tri) {
    launch<T, true>(xt, yt, mt, mats, nx, ny, stream);
  } else {
    launch<T, false>(xt, yt, mt, mats, nx, ny, stream);
  }
}

}  // namespace

extern "C" {

// y[(ny+1)*(nx+1)] += A x.  x, y, masks: device pointers (masks may be NULL:
// the term covers every cell; else (norient, ny, nx) in the same type as x).
// mats: HOST pointer to norient*nloc*nloc doubles (row-major A_o[i][j]).
// is_double selects double (1) or float (0).  Returns cudaGetLastError().
int phifem_stencil_matvec(const void* x, void* y, const void* masks,
                          const double* mats, int nx, int ny, int tri,
                          int is_double, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_double) {
    dispatch<double>(x, y, masks, mats, nx, ny, tri, s);
  } else {
    dispatch<float>(x, y, masks, mats, nx, ny, tri, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// out[0..3] = kBX, kBY, rows per thread in float32, in float64
void phifem_stencil_constants(int* out) {
  out[0] = kBX;
  out[1] = kBY;
  out[2] = rows_per_thread<float>();
  out[3] = rows_per_thread<double>();
}

const char* phifem_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

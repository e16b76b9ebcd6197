// 27-point lattice sweep on a padded 3D vertex lattice, for Hopper.
//
// Replaces the XLA-fused shifted-slice loops of phifem_tpu/ops/lattice3.py
// (not a Pallas kernel): _conv_interior3 (:130) inside Lattice3MG._smooth
// (:261), the residual of Lattice3MG._cycle (:271) and the matvec of
// lattice3_cg (:580).  On the padded (D+2) x (R+2) x (C+2) array of a
// D x R x C vertex lattice (logical node (d, r, c) at [1+d, 1+r, 1+c]; the
// logical interior is [2:D, 2:R, 2:C]), with a constant stencil of at most 27
// terms (oz, oy, ox, w), (A x)[p] = sum_t w_t x[p + (oz_t-1, oy_t-1, ox_t-1)],
// and m the optional logical (D, R, C) mask, one launch computes, out of
// place, over the whole padded array:
//
//   mode 0 (matvec):   out = A x                 on the interior, 0 elsewhere
//   mode 1 (residual): out = (b - A x) [* m]     on the interior, 0 elsewhere
//   mode 2 (Jacobi):   out = x + (s (b - A x)) [* m] on the interior, x elsewhere
//
// with s = omega / w_center.  Jacobi reads the old x around every node, so it
// cannot update x in place: the caller swaps buffers.
//
// Bound: device-memory bandwidth.  Per node it must read x once (b and m in
// modes 1-2) and write out once: 8-16 B in float32, 16-32 B in float64,
// against 2 x 27 flops.  Without FMA contraction those are 54 instructions
// per node, which in float32 take about 0.7 of the byte bound's time in
// matvec mode (the mode with the fewest bytes): there the instruction stream,
// not the bytes, is what is left.  The first version (one thread per padded
// node in a grid-stride loop) reached 21-58% of the bound: every output paid
// a 64-bit division for its coordinates, a runtime-length term loop with a
// double-to-T conversion of each weight, and 27 separate loads through L1.
//
// Design.
//  * A CTA of BX x BY threads owns a block of BX RX columns, BY rows and RZ
//    planes of the padded array: a grid over (x, y, z) blocks, so no output
//    divides anything, and all indices are 32-bit (the wrapper refuses arrays
//    of 2^31 elements or more).  A thread owns RX consecutive columns
//    (x fastest) and a run of RZ planes; the shapes are per value type.
//  * The block with a one-node halo, (RZ + 2) x (BY + 2) x (BX RX + 2)
//    values, is read from device memory at clamped coordinates by whole
//    rows (thread row ty takes block rows ty, ty + BY, ..., lane tx columns
//    tx, tx + BX, ...: coalesced, and the row's address is worked out once),
//    all of a thread's loads in flight before the first store, into shared
//    memory; b and the mask of the thread's outputs are loaded before the
//    barrier too.  Copying element by element with cp.async instead, to
//    overlap the next block's loads with this block's sums, was slower at
//    4-byte elements.  No TMA: the padded rows (131 or 259 values) give
//    global strides that are no multiple of 16 bytes.  A clamped value only
//    ever meets a shell output.
//  * Each thread then reads its window, (RZ + 2) x 3 x (RX + 2) values, from
//    shared memory into registers (two aligned pair loads a row when RX = 2)
//    and sums its RZ x RX outputs as independent chains: each value of x is
//    read from device memory about once, and each neighbour from a register.
//  * The stencil arrives by value, its weights (and s) already rounded to the
//    value type on the host, at their canonical positions (oz, oy, ox) with a
//    bit mask of the terms present; the term loop is unrolled over the 27
//    positions in ascending order, which is the order of ops/lattice3.py:
//    _terms3 (the wrapper refuses any other).  Absent terms are skipped by a
//    branch that is uniform over the launch.
//  * The padded shell (two nodes thick) is written by the same threads: zero,
//    or x in Jacobi mode.
//  * The shipped shapes (ops/cuda_lattice3.py TILE, from
//    scripts/tune_torch_stencil3.py on an H100): float32 32 x 4 threads, one
//    column and 8 planes each; float64 16 x 8 threads, two columns and 2
//    planes each.  A CTA that marched over several runs with the next run's
//    loads in flight was no faster, nor were 16-plane runs (more registers),
//    nor a store path without bounds checks for threads whose outputs are
//    all interior.
//    Float64 reaches a larger share of its
//    bound than float32 because the same 54 instructions per node meet twice
//    the bytes.
//
// The sums are those of the plain PyTorch version (ops/cuda_lattice3.py:
// lattice3_sweep_ref, on ops/lattice3.py:_conv_interior3) bit for bit: the
// terms in the order given, acc = w_0 x_0, acc = acc + w_t x_t, every product
// and sum rounded on its own (no FMA contraction: __fmul_rn / __fadd_rn).
// acc starts at -0, and -0 + v == v for every v, so the first term's product
// is taken as it is.  Rounding a double to float on the host gives the bits
// of PyTorch's scalar multiply, which rounds the Python scalar the same way.
//
// Plain C interface, loaded with ctypes (phifem_tpu_torch/ops/cuda_lattice3.py):
// phifem_lattice3_sweep returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>

// The tile shape; phifem_tpu_torch/ops/cuda_lattice3.py (TILE) passes it as
// -D defines, so the CPU test of the tiling and the kernel share it.
#ifndef PHIFEM_L3_BX_F32
#define PHIFEM_L3_BX_F32 32
#endif
#ifndef PHIFEM_L3_BY_F32
#define PHIFEM_L3_BY_F32 4
#endif
#ifndef PHIFEM_L3_RX_F32
#define PHIFEM_L3_RX_F32 1
#endif
#ifndef PHIFEM_L3_RZ_F32
#define PHIFEM_L3_RZ_F32 8
#endif
#ifndef PHIFEM_L3_BX_F64
#define PHIFEM_L3_BX_F64 16
#endif
#ifndef PHIFEM_L3_BY_F64
#define PHIFEM_L3_BY_F64 8
#endif
#ifndef PHIFEM_L3_RX_F64
#define PHIFEM_L3_RX_F64 2
#endif
#ifndef PHIFEM_L3_RZ_F64
#define PHIFEM_L3_RZ_F64 2
#endif

namespace {

constexpr int kMaxTerms = 27;
// a CTA of bx x by threads; a thread owns rx consecutive columns and a run of
// rz planes
template <typename T> struct Shape;
template <> struct Shape<float> {
  static constexpr int bx = PHIFEM_L3_BX_F32, by = PHIFEM_L3_BY_F32, rx = PHIFEM_L3_RX_F32,
                       rz = PHIFEM_L3_RZ_F32;
};
template <> struct Shape<double> {
  static constexpr int bx = PHIFEM_L3_BX_F64, by = PHIFEM_L3_BY_F64, rx = PHIFEM_L3_RX_F64,
                       rz = PHIFEM_L3_RZ_F64;
};

template <typename T>
struct Stencil {
  T w[kMaxTerms];    // weight at canonical position (oz * 3 + oy) * 3 + ox
  T s;               // the Jacobi factor
  unsigned present;  // bit p set: position p is a term
};

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }

template <typename T> struct Pair;
template <> struct Pair<float> { using type = float2; };
template <> struct Pair<double> { using type = double2; };

template <typename T, int MODE, bool MASKED>
__global__ void __launch_bounds__(Shape<T>::bx * Shape<T>::by)
lattice3_sweep_kernel(const T* __restrict__ x, const T* __restrict__ b,
                      const T* __restrict__ mask, T* __restrict__ out,
                      const Stencil<T> st, int D, int R, int C) {
  constexpr int BX = Shape<T>::bx, BY = Shape<T>::by, RX = Shape<T>::rx, RZ = Shape<T>::rz;
  constexpr int SX = BX * RX + 2, SY = BY + 2;  // the block with a one-node halo
  constexpr int NS = (RZ + 2) * SY * SX;
  static_assert(RX == 1 || RX == 2, "a thread owns one or two columns");
  __shared__ __align__(16) T blk[NS];
  const int PC = C + 2, PR = R + 2, PD = D + 2;
  const int PLANE = PR * PC;
  const int x0 = blockIdx.x * BX * RX, y0 = blockIdx.y * BY, z0 = blockIdx.z * RZ;
  const int px0 = x0 + threadIdx.x * RX, py = y0 + threadIdx.y;
  const bool live = px0 < PC && py < PR;

  // the block of x at clamped coordinates (a clamped value only ever meets a
  // shell output), by whole rows: thread row ty takes block rows ty, ty + BY,
  // ..., lane tx columns tx, tx + BX, ...; every load issued before the
  // first store
  {
    constexpr int NROW = (RZ + 2) * SY, RPT = (NROW + BY - 1) / BY, CPL = (SX + BX - 1) / BX;
    int gx[CPL];
#pragma unroll
    for (int e = 0; e < CPL; ++e) gx[e] = min(max(x0 - 1 + (int)threadIdx.x + e * BX, 0), PC - 1);
    T v[RPT][CPL];
#pragma unroll
    for (int m = 0; m < RPT; ++m) {
      const int rr = min((int)threadIdx.y + m * BY, NROW - 1);
      const int a = rr / SY, r = rr - a * SY;
      const int g = min(max(z0 - 1 + a, 0), PD - 1) * PLANE + min(max(y0 - 1 + r, 0), PR - 1) * PC;
#pragma unroll
      for (int e = 0; e < CPL; ++e) v[m][e] = x[g + gx[e]];
    }
#pragma unroll
    for (int m = 0; m < RPT; ++m) {
      const int rr = threadIdx.y + m * BY;
#pragma unroll
      for (int e = 0; e < CPL; ++e) {
        const int c = threadIdx.x + e * BX;
        if (rr < NROW && c < SX) blk[rr * SX + c] = v[m][e];
      }
    }
  }
  T bv[RZ][RX], mv[RZ][RX];
  if (MODE != 0 && live) {  // in flight across the barrier
#pragma unroll
    for (int k = 0; k < RZ; ++k) {
#pragma unroll
      for (int e = 0; e < RX; ++e) {
        const int pz = min(z0 + k, PD - 1), px = min(px0 + e, PC - 1);
        bv[k][e] = b[pz * PLANE + py * PC + px];
        if (MASKED) {
          const int mz = min(max(pz - 1, 0), D - 1), my = min(max(py - 1, 0), R - 1),
                    mx = min(max(px - 1, 0), C - 1);
          mv[k][e] = mask[(mz * R + my) * C + mx];
        }
      }
    }
  }
  __syncthreads();
  if (!live) return;

  // the thread's window: planes z0-1 .. z0+RZ, rows py-1 .. py+1, columns
  // px0-1 .. px0+RX; with two columns, two aligned pair loads per row
  T win[RZ + 2][3][RX + 2];
#pragma unroll
  for (int a = 0; a < RZ + 2; ++a) {
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const T* row = blk + (a * SY + threadIdx.y + r) * SX + threadIdx.x * RX;
      if constexpr (RX == 2) {
        using V = typename Pair<T>::type;
        const V lo = reinterpret_cast<const V*>(row)[0], hi = reinterpret_cast<const V*>(row)[1];
        win[a][r][0] = lo.x;
        win[a][r][1] = lo.y;
        win[a][r][2] = hi.x;
        win[a][r][3] = hi.y;
      } else {
#pragma unroll
        for (int c = 0; c < 3; ++c) win[a][r][c] = row[c];
      }
    }
  }
  T acc[RZ][RX];
#pragma unroll
  for (int k = 0; k < RZ; ++k)
#pragma unroll
    for (int e = 0; e < RX; ++e) acc[k][e] = T(-0.0);
#pragma unroll
  for (int p = 0; p < kMaxTerms; ++p) {
    if (st.present & (1u << p)) {
#pragma unroll
      for (int k = 0; k < RZ; ++k)
#pragma unroll
        for (int e = 0; e < RX; ++e)
          acc[k][e] = add_rn(acc[k][e], mul_rn(st.w[p], win[k + p / 9][(p / 3) % 3][e + p % 3]));
    }
  }
  const bool rowin = py >= 2 && py <= R - 1;
#pragma unroll
  for (int k = 0; k < RZ; ++k) {
    const int pz = z0 + k;
    if (pz >= PD) break;
#pragma unroll
    for (int e = 0; e < RX; ++e) {
      const int px = px0 + e;
      if (px >= PC) break;
      const int idx = pz * PLANE + py * PC + px;
      const T xc = win[k + 1][1][e + 1];
      if (!rowin || px < 2 || px > C - 1 || pz < 2 || pz > D - 1) {
        out[idx] = MODE == 2 ? xc : T(0);
        continue;
      }
      if (MODE == 0) {
        out[idx] = acc[k][e];
        continue;
      }
      T res = sub_rn(bv[k][e], acc[k][e]);
      if (MODE == 2) res = mul_rn(st.s, res);
      if (MASKED) res = mul_rn(res, mv[k][e]);
      out[idx] = MODE == 2 ? add_rn(xc, res) : res;
    }
  }
}

template <typename T, int MODE>
void launch_mode(const T* x, const T* b, const T* mask, T* out, const Stencil<T>& st,
                 int D, int R, int C, cudaStream_t stream) {
  using S = Shape<T>;
  const dim3 block(S::bx, S::by);
  const dim3 grid((C + 2 + S::bx * S::rx - 1) / (S::bx * S::rx), (R + 2 + S::by - 1) / S::by,
                  (D + 2 + S::rz - 1) / S::rz);
  if (mask != nullptr) {
    lattice3_sweep_kernel<T, MODE, true><<<grid, block, 0, stream>>>(x, b, mask, out, st, D, R, C);
  } else {
    lattice3_sweep_kernel<T, MODE, false><<<grid, block, 0, stream>>>(x, b, nullptr, out, st, D, R, C);
  }
}

template <typename T>
void dispatch(const void* x, const void* b, const void* mask, void* out, const int* offs,
              const double* w, int nterms, double scale, int D, int R, int C, int mode,
              cudaStream_t stream) {
  Stencil<T> st;
  st.present = 0;
  for (int p = 0; p < kMaxTerms; ++p) st.w[p] = T(0);
  for (int t = 0; t < nterms; ++t) {
    const int p = (offs[3 * t] * 3 + offs[3 * t + 1]) * 3 + offs[3 * t + 2];
    st.w[p] = static_cast<T>(w[t]);  // rounded once, as PyTorch rounds a Python scalar
    st.present |= 1u << p;
  }
  st.s = static_cast<T>(scale);
  const T* xt = static_cast<const T*>(x);
  const T* bt = static_cast<const T*>(b);
  const T* mt = static_cast<const T*>(mask);
  T* ot = static_cast<T*>(out);
  if (mode == 0) {
    launch_mode<T, 0>(xt, bt, nullptr, ot, st, D, R, C, stream);
  } else if (mode == 1) {
    launch_mode<T, 1>(xt, bt, mt, ot, st, D, R, C, stream);
  } else {
    launch_mode<T, 2>(xt, bt, mt, ot, st, D, R, C, stream);
  }
}


// ------------------------------------------------- 3-channel block sweep
// The block form of the sweep, for the channels-first (3, D+2, R+2, C+2)
// arrays of a 3-vector field (the S5-3D elasticity bulks): the stencil is a
// 3 x 3 block W_t at each of up to 27 positions, and per interior node
//
//   (A x)[i] = sum_t sum_j W_t[i][j] x[j][p + o_t]
//
// the XLA-fused _conv_interior3_block of phifem_tpu/ops/lattice3.py (:381)
// inside Lattice3BlockMG._smooth (:464) and _cycle (:480).  Modes as above,
// with the block Jacobi update x + (omega Dinv (b - A x)) [* m], Dinv the
// interior centre block's 3 x 3 inverse, the mask shared by the channels.
//
// Bound: bytes (x, b and out, 3 channels, and the mask: 24-28 B per node in
// float32 in matvec / masked Jacobi mode), against 2 x 243 operations per
// interior node.  Every product and sum is an instruction of its own (no
// FMA, for the bits), so those 486 instructions take at least 0.0297 ms
// (float32) / 0.0586 ms (float64) at 3 x 129^3 on an H100 (the "no-FMA
// floor"): more than the matvec's byte bound, about the masked Jacobi
// sweep's in float64.
//
// Design: K2's (above) with three channels (the Findings of PERF.md say
// what else was tried).
//  * A CTA of BX x BY threads owns a tile of the logical interior, BX
//    columns by BY rows by RZ planes (padded coordinates from 2: no thread
//    of an interior tile sits in the shell, and a tile grid of the
//    interior's 127 nodes wastes one column where the padded array's 131
//    would waste a warp).  The CTAs on the array's faces also own the
//    two-node shell beyond their tile, written by whole rows: zero, or x in
//    Jacobi mode.  The shapes are per value type (ops/cuda_lattice3.py
//    BLOCK_TILE, from scripts/tune_torch_stencil3.py on an H100).
//  * The tile's three channels with a one-node halo, 3 x (RZ + 2) x
//    (BY + 2) x (BX + 2) values, are read once from device memory at
//    clamped coordinates (a clamped value only meets an output outside the
//    interior) by whole coalesced rows, one channel's loads in flight at a
//    time, into shared memory.  No TMA: the padded rows (131 values) are no
//    multiple of 16 bytes.
//  * A thread owns one column and a run of RZ planes and streams the run's
//    RZ + 2 planes in ascending z through a one-plane register window of 3
//    channels x 3 rows x 3 columns: plane z0 - 1 + a gives node k its
//    terms at oz = a - k.  Positions ascend with oz slowest, so every node's
//    sums take their terms in the plain version's order.  About
//    27 (RZ + 2) / RZ shared loads of x per node.  With ROLL the plane loop
//    is a loop holding three nodes' sums (nodes a, a - 1, a - 2, rotated
//    after each plane); without, it is unrolled over the run.
//  * The blocks arrive by value (2 KB of parameters in float64), rounded to
//    the value type on the host, at their canonical positions with the bit
//    mask of the terms present.  The compiler feeds each weight to its
//    multiplies through a uniform register loaded by a ULDC (one per pair
//    of float32 weights, one per float64 weight).  When
//    all 27 positions are present (every S5-3D stencil) the FULL
//    instantiation has no branch per term; otherwise absent terms are
//    skipped by a branch that is uniform over the launch.
// Per term and output channel the part ((W[i][0] x0 + W[i][1] x1) +
// W[i][2] x2) is added to the channel's sum, which starts at -0; every
// product and sum is rounded on its own.  That is the order of the plain
// version (ops/cuda_lattice3.py: lattice3_block_sweep_ref) bit for bit.
#ifndef PHIFEM_L3B_BX
#define PHIFEM_L3B_BX 32
#endif
#ifndef PHIFEM_L3B_BY_F32
#define PHIFEM_L3B_BY_F32 4
#endif
#ifndef PHIFEM_L3B_RZ_F32
#define PHIFEM_L3B_RZ_F32 8
#endif
#ifndef PHIFEM_L3B_ROLL_F32
#define PHIFEM_L3B_ROLL_F32 1
#endif
#ifndef PHIFEM_L3B_BY_F64
#define PHIFEM_L3B_BY_F64 8
#endif
#ifndef PHIFEM_L3B_RZ_F64
#define PHIFEM_L3B_RZ_F64 2
#endif
#ifndef PHIFEM_L3B_ROLL_F64
#define PHIFEM_L3B_ROLL_F64 0
#endif
constexpr int kVSZ = 3, kBXB = PHIFEM_L3B_BX;
// a CTA of BX x by threads; a thread owns one column and a run of rz planes
// of the interior; roll: the run's plane loop is a loop
template <typename T> struct BlockShape;
template <> struct BlockShape<float> {
  static constexpr int by = PHIFEM_L3B_BY_F32, rz = PHIFEM_L3B_RZ_F32, roll = PHIFEM_L3B_ROLL_F32;
};
template <> struct BlockShape<double> {
  static constexpr int by = PHIFEM_L3B_BY_F64, rz = PHIFEM_L3B_RZ_F64, roll = PHIFEM_L3B_ROLL_F64;
};

template <typename T>
struct BlockStencil {
  T w[kMaxTerms][kVSZ * kVSZ];  // the block at canonical position p, row-major
  T dinv[kVSZ * kVSZ];          // the Jacobi centre-block inverse, row-major
  T omega;
  unsigned present;
};

template <typename T, int MODE, bool MASKED, bool FULL>
__global__ void __launch_bounds__(kBXB * BlockShape<T>::by)
lattice3_block_kernel(const T* __restrict__ x, const T* __restrict__ b,
                      const T* __restrict__ mask, T* __restrict__ out,
                      const BlockStencil<T> st, int D, int R, int C) {
  using S = BlockShape<T>;
  constexpr int BX = kBXB, BY = S::by, RZ = S::rz;
  constexpr int SX = BX + 2, SY = BY + 2, NP = RZ + 2;  // the tile with a one-node halo
  constexpr int NROW = NP * SY;                         // rows of one channel's block
  static_assert(kVSZ * NROW * SX * sizeof(T) <= 48 * 1024, "the block must fit static shared memory");
  __shared__ __align__(16) T blk[kVSZ * NROW * SX];
  const int PC = C + 2, PR = R + 2, PD = D + 2;
  const int PLANE = PR * PC, CH = PD * PLANE;
  const int tx = threadIdx.x, ty = threadIdx.y;
  // the tile's first interior node; the interior is [2, D-1] x [2, R-1] x [2, C-1]
  const int x0 = 2 + blockIdx.x * BX, y0 = 2 + blockIdx.y * BY, z0 = 2 + blockIdx.z * RZ;

  // 1. the three channels' blocks at clamped coordinates, by whole rows:
  //    thread row ty takes block rows ty, ty + BY, ..., lane tx columns tx,
  //    tx + BX, ...; one channel's loads issued before its first store
  {
    constexpr int RPT = (NROW + BY - 1) / BY, CPL = (SX + BX - 1) / BX;
    int gx[CPL];
#pragma unroll
    for (int e = 0; e < CPL; ++e) gx[e] = min(max(x0 - 1 + tx + e * BX, 0), PC - 1);
#pragma unroll
    for (int c = 0; c < kVSZ; ++c) {
      T v[RPT][CPL];
#pragma unroll
      for (int m = 0; m < RPT; ++m) {
        const int rr = min(ty + m * BY, NROW - 1);
        const int a = rr / SY, r = rr - a * SY;
        const int g = c * CH + min(max(z0 - 1 + a, 0), PD - 1) * PLANE + min(max(y0 - 1 + r, 0), PR - 1) * PC;
#pragma unroll
        for (int e = 0; e < CPL; ++e) v[m][e] = x[g + gx[e]];
      }
#pragma unroll
      for (int m = 0; m < RPT; ++m) {
        const int rr = ty + m * BY;
#pragma unroll
        for (int e = 0; e < CPL; ++e) {
          const int col = tx + e * BX;
          if (rr < NROW && col < SX) blk[(c * NROW + rr) * SX + col] = v[m][e];
        }
      }
    }
  }
  __syncthreads();

  // 2. the thread's run: planes z0 - 1 .. z0 + RZ in ascending z through a
  //    one-plane window; plane a gives node k the terms at oz = a - k
  const int px = x0 + tx, py = y0 + ty;
  const bool live = py <= R - 1 && px <= C - 1;
  // node k's outputs from its sums v
  auto finish = [&](int k, const T (&v)[kVSZ]) {
    const int pz = z0 + k;
    if (pz > D - 1) return;
    const int idx = pz * PLANE + py * PC + px;
    if (MODE == 0) {
#pragma unroll
      for (int c = 0; c < kVSZ; ++c) out[c * CH + idx] = v[c];
      return;
    }
    T m = T(1);
    if (MASKED) m = mask[((pz - 1) * R + (py - 1)) * C + (px - 1)];
    T res[kVSZ];
#pragma unroll
    for (int c = 0; c < kVSZ; ++c) res[c] = sub_rn(b[c * CH + idx], v[c]);
    if (MODE == 1) {
#pragma unroll
      for (int c = 0; c < kVSZ; ++c) out[c * CH + idx] = MASKED ? mul_rn(res[c], m) : res[c];
      return;
    }
#pragma unroll
    for (int i = 0; i < kVSZ; ++i) {
      T d = mul_rn(st.dinv[i * kVSZ], res[0]);
#pragma unroll
      for (int j = 1; j < kVSZ; ++j) d = add_rn(d, mul_rn(st.dinv[i * kVSZ + j], res[j]));
      T upd = mul_rn(st.omega, d);
      if (MASKED) upd = mul_rn(upd, m);
      out[i * CH + idx] = add_rn(blk[((i * NP + k + 1) * SY + ty + 1) * SX + tx + 1], upd);
    }
  };
  // plane a of the window: 3 channels x 3 rows x 3 columns
  auto window = [&](int a, T (&w)[kVSZ][3][3]) {
#pragma unroll
    for (int c = 0; c < kVSZ; ++c)
#pragma unroll
      for (int r = 0; r < 3; ++r)
#pragma unroll
        for (int q = 0; q < 3; ++q) w[c][r][q] = blk[((c * NP + a) * SY + ty + r) * SX + tx + q];
  };
  // the terms at oz of one plane's window added to the sums v
  auto terms = [&](int oz, const T (&w)[kVSZ][3][3], T (&v)[kVSZ]) {
#pragma unroll
    for (int q = 0; q < 9; ++q) {
      const int p = oz * 9 + q, oy = q / 3, ox = q % 3;
      if (!FULL && !(st.present & (1u << p))) continue;
#pragma unroll
      for (int i = 0; i < kVSZ; ++i) {
        T part = mul_rn(st.w[p][i * kVSZ], w[0][oy][ox]);
#pragma unroll
        for (int j = 1; j < kVSZ; ++j) part = add_rn(part, mul_rn(st.w[p][i * kVSZ + j], w[j][oy][ox]));
        v[i] = add_rn(v[i], part);
      }
    }
  };
  if (live && S::roll) {
    // three nodes' sums in flight: slot s holds node a - s
    T sl[3][kVSZ];
#pragma unroll
    for (int s = 0; s < 3; ++s)
#pragma unroll
      for (int i = 0; i < kVSZ; ++i) sl[s][i] = T(-0.0);
#pragma unroll 1
    for (int a = 0; a < NP; ++a) {
      if (z0 - 1 + a > D) break;  // beyond the last interior node's planes (uniform over the CTA)
      T w[kVSZ][3][3];
      window(a, w);
#pragma unroll
      for (int oz = 0; oz < 3; ++oz) terms(oz, w, sl[oz]);
      if (a >= 2) finish(a - 2, sl[2]);
#pragma unroll
      for (int i = 0; i < kVSZ; ++i) {
        sl[2][i] = sl[1][i];
        sl[1][i] = sl[0][i];
        sl[0][i] = T(-0.0);
      }
    }
  } else if (live) {
    T acc[RZ][kVSZ];
#pragma unroll
    for (int k = 0; k < RZ; ++k)
#pragma unroll
      for (int i = 0; i < kVSZ; ++i) acc[k][i] = T(-0.0);
#pragma unroll
    for (int a = 0; a < NP; ++a) {
      if (z0 - 1 + a > D) break;  // beyond the last interior node's planes (uniform over the CTA)
      T w[kVSZ][3][3];
      window(a, w);
#pragma unroll
      for (int oz = 0; oz < 3; ++oz) {
        const int k = a - oz;
        if (k < 0 || k >= RZ || z0 + k > D - 1) continue;
        terms(oz, w, acc[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < RZ; ++k) finish(k, acc[k]);
  }

  // 3. the shell the CTA owns: a CTA on a face of the tile grid extends its
  //    tile to the array's edge (two nodes, or more where the interior is
  //    short of a tile); written by rows, zero or x
  const int ix1 = min(x0 + BX, C), iy1 = min(y0 + BY, R), iz1 = min(z0 + RZ, D);
  const int ex0 = blockIdx.x == 0 ? 0 : x0, ex1 = blockIdx.x + 1 == gridDim.x ? PC : x0 + BX;
  const int ey0 = blockIdx.y == 0 ? 0 : y0, ey1 = blockIdx.y + 1 == gridDim.y ? PR : y0 + BY;
  const int ez0 = blockIdx.z == 0 ? 0 : z0, ez1 = blockIdx.z + 1 == gridDim.z ? PD : z0 + RZ;
  if (ex0 < x0 || ex1 > ix1 || ey0 < y0 || ey1 > iy1 || ez0 < z0 || ez1 > iz1) {
    const int nyr = ey1 - ey0, nrow = nyr * (ez1 - ez0), ncol = ex1 - ex0;
    for (int rr = ty; rr < nrow; rr += BY) {
      const int z = ez0 + rr / nyr, yy = ey0 + rr % nyr;
      const bool inner = z >= z0 && z < iz1 && yy >= y0 && yy < iy1;
      for (int q = tx; q < ncol; q += BX) {
        const int xx = ex0 + q;
        if (inner && xx >= x0 && xx < ix1) continue;
        const int idx = (z * PR + yy) * PC + xx;
#pragma unroll
        for (int c = 0; c < kVSZ; ++c) out[c * CH + idx] = MODE == 2 ? x[c * CH + idx] : T(0);
      }
    }
  }
}

// CTAs along one axis: tiles of the interior's n - 2 nodes, at least one
inline int block_tiles(int n, int t) { return n - 2 > t ? (n - 2 + t - 1) / t : 1; }

template <typename T, int MODE>
void launch_block_mode(const T* x, const T* b, const T* mask, T* out, const BlockStencil<T>& st,
                       int D, int R, int C, cudaStream_t stream) {
  using S = BlockShape<T>;
  const dim3 block(kBXB, S::by);
  const dim3 grid(block_tiles(C, kBXB), block_tiles(R, S::by), block_tiles(D, S::rz));
  // every position present (S5-3D's stencils): no branch per term
  const bool full = st.present == (1u << kMaxTerms) - 1u;
  if (mask != nullptr) {
    if (full) {
      lattice3_block_kernel<T, MODE, true, true><<<grid, block, 0, stream>>>(x, b, mask, out, st, D, R, C);
    } else {
      lattice3_block_kernel<T, MODE, true, false><<<grid, block, 0, stream>>>(x, b, mask, out, st, D, R, C);
    }
  } else if (full) {
    lattice3_block_kernel<T, MODE, false, true><<<grid, block, 0, stream>>>(x, b, nullptr, out, st, D, R, C);
  } else {
    lattice3_block_kernel<T, MODE, false, false><<<grid, block, 0, stream>>>(x, b, nullptr, out, st, D, R, C);
  }
}

template <typename T>
void dispatch_block(const void* x, const void* b, const void* mask, void* out, const int* offs,
                    const double* w, int nterms, const double* dinv, double omega, int D, int R, int C,
                    int mode, cudaStream_t stream) {
  BlockStencil<T> st;
  st.present = 0;
  for (int p = 0; p < kMaxTerms; ++p)
    for (int e = 0; e < kVSZ * kVSZ; ++e) st.w[p][e] = T(0);
  for (int t = 0; t < nterms; ++t) {
    const int p = (offs[3 * t] * 3 + offs[3 * t + 1]) * 3 + offs[3 * t + 2];
    for (int e = 0; e < kVSZ * kVSZ; ++e) st.w[p][e] = static_cast<T>(w[t * kVSZ * kVSZ + e]);
    st.present |= 1u << p;
  }
  for (int e = 0; e < kVSZ * kVSZ; ++e) st.dinv[e] = dinv ? static_cast<T>(dinv[e]) : T(0);
  st.omega = static_cast<T>(omega);
  const T* xt = static_cast<const T*>(x);
  const T* bt = static_cast<const T*>(b);
  const T* mt = static_cast<const T*>(mask);
  T* ot = static_cast<T*>(out);
  if (mode == 0) {
    launch_block_mode<T, 0>(xt, bt, nullptr, ot, st, D, R, C, stream);
  } else if (mode == 1) {
    launch_block_mode<T, 1>(xt, bt, mt, ot, st, D, R, C, stream);
  } else {
    launch_block_mode<T, 2>(xt, bt, mt, ot, st, D, R, C, stream);
  }
}

// the term list's checks, shared by both entry points: 1 to 27 terms at
// offsets in {0, 1, 2}, strictly ascending in (oz, oy, ox)
bool terms_ok(const int* offs, int nterms) {
  if (nterms < 1 || nterms > kMaxTerms) return false;
  int last = -1;
  for (int t = 0; t < nterms; ++t) {
    const int oz = offs[3 * t], oy = offs[3 * t + 1], ox = offs[3 * t + 2];
    if (oz < 0 || oz > 2 || oy < 0 || oy > 2 || ox < 0 || ox > 2) return false;
    const int p = (oz * 3 + oy) * 3 + ox;
    if (p <= last) return false;
    last = p;
  }
  return true;
}

}  // namespace

extern "C" {

// out = sweep(x) on the padded (D+2, R+2, C+2) arrays x, b, out (device
// pointers; b unused in mode 0) with the optional logical (D, R, C) mask
// (device pointer or NULL; ignored in mode 0).  offs: HOST pointer to
// nterms * 3 ints (oz, oy, ox in {0, 1, 2}), strictly ascending in
// (oz, oy, ox); w: HOST pointer to nterms doubles.  Returns
// cudaGetLastError() (cudaErrorInvalidValue for a bad mode, term count, term
// order or an array of 2^31 elements or more).
int phifem_lattice3_sweep(const void* x, const void* b, const void* mask, void* out,
                          int D, int R, int C, const int* offs, const double* w,
                          int nterms, double scale, int mode, int is_double,
                          void* stream) {
  if (nterms < 1 || nterms > kMaxTerms || mode < 0 || mode > 2 ||
      (long long)(D + 2) * (R + 2) * (C + 2) >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int last = -1;
  for (int t = 0; t < nterms; ++t) {
    const int oz = offs[3 * t], oy = offs[3 * t + 1], ox = offs[3 * t + 2];
    if (oz < 0 || oz > 2 || oy < 0 || oy > 2 || ox < 0 || ox > 2) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const int p = (oz * 3 + oy) * 3 + ox;
    if (p <= last) return static_cast<int>(cudaErrorInvalidValue);
    last = p;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_double) {
    dispatch<double>(x, b, mask, out, offs, w, nterms, scale, D, R, C, mode, s);
  } else {
    dispatch<float>(x, b, mask, out, offs, w, nterms, scale, D, R, C, mode, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// The tile shapes this library was built with: BX, BY, RX, RZ for float32,
// then for float64.
void phifem_lattice3_constants(int* out) {
  const int v[] = {Shape<float>::bx, Shape<float>::by, Shape<float>::rx, Shape<float>::rz,
                   Shape<double>::bx, Shape<double>::by, Shape<double>::rx, Shape<double>::rz};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
}

// The 3-channel block sweep (see lattice3_block_kernel) on channels-first
// padded (3, D+2, R+2, C+2) arrays x, b, out (device pointers; b unused in
// mode 0) with the optional logical (D, R, C) mask.  offs: HOST pointer to
// nterms * 3 ints, strictly ascending in (oz, oy, ox); w: HOST pointer to
// nterms * 9 doubles (each term's block, row-major); dinv: HOST pointer to 9
// doubles (mode 2) or NULL.  Returns cudaGetLastError().
int phifem_lattice3_block_sweep(const void* x, const void* b, const void* mask, void* out,
                                int D, int R, int C, const int* offs, const double* w,
                                int nterms, const double* dinv, double omega, int mode,
                                int is_double, void* stream) {
  if (!terms_ok(offs, nterms) || mode < 0 || mode > 2 || (mode == 2 && dinv == nullptr) ||
      3LL * (D + 2) * (R + 2) * (C + 2) >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_double) {
    dispatch_block<double>(x, b, mask, out, offs, w, nterms, dinv, omega, D, R, C, mode, s);
  } else {
    dispatch_block<float>(x, b, mask, out, offs, w, nterms, dinv, omega, D, R, C, mode, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// The block kernel's tile shapes: BX, then BY, RZ, ROLL for float32 and for
// float64.
void phifem_lattice3_block_constants(int* out) {
  const int v[] = {kBXB, BlockShape<float>::by,  BlockShape<float>::rz,  BlockShape<float>::roll,
                   BlockShape<double>::by, BlockShape<double>::rz, BlockShape<double>::roll};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
}

const char* phifem_lattice3_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

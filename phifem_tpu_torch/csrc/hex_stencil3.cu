// Masked hex-cell stencil on the degree-d node lattice of a 3D hex grid, for
// Hopper.
//
// Replaces the XLA-fused shifted-slice loop of
// phifem_tpu/models/weak_dirichlet3.py:_masked_stencil_apply (:273; its twin
// is neumann3.py:446), not a Pallas kernel: the 3D counterpart of the masked
// P1 cell stencil (csrc/stencil_matvec.cu), lifted from P1 triangles to Q_d
// hexahedra, d = 1, 2, 3.  On the (d nz + 1, d ny + 1, d nx + 1) node lattice
// (x fastest), with nloc = (d+1)^3 local nodes per cell at offsets
// (ox, oy, oz) in {0..d}^3 (local index i = (oz (d+1) + oy) (d+1) + ox), it
// computes, out of place,
//
//   y[n] = sum_{cells c containing n, i ascending} mask[c] * sum_j A[i(n,c), j] x[node(c, j)]
//
// with i(n, c) the local index of node n in cell c.
//
// Bound: at d = 1 device-memory bandwidth (read x and the cell mask once,
// write y once: 24 B per node in float64 against 128 flops per active cell);
// at d = 2, 3 the float64 arithmetic of the active cells comes close to it
// (nloc^2 products and sums per cell: 4,096 at d = 3).  Without FMA each
// product and each sum is an instruction of its own, so the float64 pipe
// needs twice the time that 34 TFLOP/s suggests.
//
// The first version gave a thread one node: for each of up to 8 incident
// cells it read the cell's mask and all nloc values of x from global memory
// and a row of A from shared memory, so per cell nloc^2 loads where nloc
// would do, and warps walked every node of the (mostly inactive) sphere mask.
// It reached 27% / 15% / 6% of the bound at d = 1 / 2 / 3.
//
// Design, d = 1 (hex1_stencil3_kernel): a streaming kernel.  A CTA of
// BX1 x BY1 threads owns a column of nodes and marches along z over ZCH1
// blocks of RZ1 nodes.  A (64 values), the planes of x its block needs (one-
// node halo, clamped coordinates) and the cell masks around them (0 outside
// the grid) sit in shared memory, the planes in rings, so each plane of x and
// of masks is fetched once per CTA; the next block's new planes are copied
// with cp.async while this block is summed.  A thread keeps its
// (RZ1 + 2) x 3 x 3 window of x in registers and adds, per node, its cells in
// ascending local index i (cell = node - offset_i), skipping cells whose mask
// is 0; one load of A[i][j] serves the run.
//
// Design, d = 2, 3 (hex_stencil3_kernel): a CTA owns a tile of TC^3 cells and
// the nodes those cells own (a node belongs to the tile whose cells' lattice
// range [d t0, d (t0 + TC)) holds its coordinate on every axis, plus the
// lattice's far edge planes).
//  1. It reads the masks of its cells and of a one-cell halo on the low side
//     into shared memory and lists the active ones, full cells first, halo
//     cells after (warp ballots).  A tile with no active cell writes zeros
//     and reads no x.
//  2. It stages A transposed (rows padded against bank conflicts) and the x
//     nodes of those cells in shared memory, once, with coalesced loads along
//     the lattice rows.  No TMA: rows of d n + 1 values are no 16-byte
//     strides.
//  3. A thread takes a block of RB = d + 1 consecutive rows of A (one line
//     of local nodes along x) by KC cells and keeps RB x KC row dots
//     s = sum_j A[r, j] x_c[j] in registers, ascending
//     j, each product and sum rounded on its own: one load of A[r][j] serves
//     KC cells and one load of x_c[j] (a broadcast among the threads of the
//     same cells) serves RB rows.  Only rows of nodes the tile owns are kept
//     (a halo cell gives the shared face, edge or corner nodes), as
//     mask[c] * s in a slot (cell, r) in shared memory.  Shared memory beyond
//     48 KB is taken with the dynamic opt-in.
//  4. Each owned node adds its slots in ascending local index, the order of
//     the first version and of the JAX package's slice loop, from 0,
//     skipping cells whose mask is 0, and writes y once.
// Every (cell, row) is computed by exactly one tile.  What still holds it
// back: a halo cell whose owned rows are spread over every row block costs a
// full cell; the phases of a tile run one after another, and at d = 3 the
// tile's shared memory (131 KB) leaves one CTA per SM to hide them.  A CTA
// that walked a stack of tiles along z with the next tile's x and masks in
// flight (cp.async) was slower: it fetched x for the tiles without an
// active cell too.
//
// The tilings come from -D defines that phifem_tpu_torch/ops/cuda_hex3.py
// (TILE) passes, so the CPU test of the tilings and the kernels share them;
// the shipped ones are the best of scripts/tune_torch_stencil3.py on an H100.
//
// The sums are those of the plain PyTorch version (ops/cuda_hex3.py:
// hex_stencil3_ref) bit for bit, up to the sign of a zero: every product and
// sum is rounded on its own (__dmul_rn / __dadd_rn, no FMA contraction).
//
// Plain C interface, loaded with ctypes (phifem_tpu_torch/ops/cuda_hex3.py):
// phifem_hex_stencil3 returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>

// The tilings; phifem_tpu_torch/ops/cuda_hex3.py (TILE) passes them as -D
// defines, so the CPU test of the tilings and the kernels share them.
// d = 1: a CTA of BX1 x BY1 threads, each a node column and a run of RZ1 nodes
#ifndef PHIFEM_HEX3_BX1
#define PHIFEM_HEX3_BX1 16
#endif
#ifndef PHIFEM_HEX3_BY1
#define PHIFEM_HEX3_BY1 8
#endif
#ifndef PHIFEM_HEX3_RZ1_F32
#define PHIFEM_HEX3_RZ1_F32 4
#endif
#ifndef PHIFEM_HEX3_RZ1_F64
#define PHIFEM_HEX3_RZ1_F64 2
#endif
#ifndef PHIFEM_HEX3_ZCH1
#define PHIFEM_HEX3_ZCH1 4
#endif
#ifndef PHIFEM_HEX3_MB1
#define PHIFEM_HEX3_MB1 4
#endif
// d = 2, 3: TC^3 cells per CTA of NT threads (MB CTAs per SM bound the
// registers), each thread a block of rows x KC cells
#ifndef PHIFEM_HEX3_TC2
#define PHIFEM_HEX3_TC2 4
#endif
#ifndef PHIFEM_HEX3_TC3
#define PHIFEM_HEX3_TC3 4
#endif
#ifndef PHIFEM_HEX3_NT2
#define PHIFEM_HEX3_NT2 128
#endif
#ifndef PHIFEM_HEX3_NT3
#define PHIFEM_HEX3_NT3 512
#endif
#ifndef PHIFEM_HEX3_KC
#define PHIFEM_HEX3_KC 4
#endif
#ifndef PHIFEM_HEX3_MB2
#define PHIFEM_HEX3_MB2 2
#endif
#ifndef PHIFEM_HEX3_MB3
#define PHIFEM_HEX3_MB3 1
#endif

namespace {

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

template <typename T> struct Pair;
template <> struct Pair<float> { using type = float2; };
template <> struct Pair<double> { using type = double2; };

// one element from device memory into shared memory without passing through
// registers (cp.async), so a block's loads stay in flight while the previous
// block is summed
template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src) {
#ifdef __CUDA_ARCH__
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (sizeof(T) == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src));
  }
#else
  *dst = *src;
#endif
}
__device__ __forceinline__ void copy_commit() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::);
#endif
}
template <int N>
__device__ __forceinline__ void copy_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
#endif
}

// ------------------------------------------------------------------ d = 1
constexpr int kBX1 = PHIFEM_HEX3_BX1, kBY1 = PHIFEM_HEX3_BY1;
template <typename T> struct Run1;
template <> struct Run1<float> { static constexpr int nodes = PHIFEM_HEX3_RZ1_F32, chunks = PHIFEM_HEX3_ZCH1; };
template <> struct Run1<double> { static constexpr int nodes = PHIFEM_HEX3_RZ1_F64, chunks = PHIFEM_HEX3_ZCH1; };

// shared memory of the degree-1 kernel: A, a ring of 2 RZ + 2 planes of x
// (the CTA's columns with a one-node halo) and a ring of 2 RZ + 1 planes of
// cell masks (a one-cell low halo): a block of RZ nodes reads planes
// z0-1 .. z0+RZ of x and cell planes z0-1 .. z0+RZ-1, and the next block's
// new planes land in the slots of none of them
template <typename T>
struct Block1 {
  static constexpr int RZ = Run1<T>::nodes, ZCH = Run1<T>::chunks;
  static constexpr int SX = kBX1 + 2, SY = kBY1 + 2, PX = SY * SX, RINGX = 2 * RZ + 2;
  static constexpr int MX = kBX1 + 1, MY = kBY1 + 1, PM = MY * MX, RINGM = 2 * RZ + 1;
  static constexpr size_t bytes = (size_t)(64 + RINGX * PX + RINGM * PM) * sizeof(T);
};

template <typename T>
__global__ void __launch_bounds__(kBX1 * kBY1, PHIFEM_HEX3_MB1)
hex1_stencil3_kernel(const T* __restrict__ x, T* __restrict__ y,
                     const T* __restrict__ mask, const T* __restrict__ A,
                     int nx, int ny, int nz) {
  using K = Block1<T>;
  constexpr int RZ = K::RZ, ZCH = K::ZCH;
  constexpr int NT = kBX1 * kBY1;
  constexpr int SX = K::SX, PX = K::PX, RINGX = K::RINGX, MX = K::MX, PM = K::PM, RINGM = K::RINGM;
  static_assert(NT >= 64, "a thread per entry of A");
  extern __shared__ __align__(16) unsigned char smem[];
  T* const sa = reinterpret_cast<T*>(smem);
  T* const xr = sa + 64;
  T* const mr = xr + RINGX * PX;
  const int C = nx + 1, R = ny + 1, D = nz + 1;
  const int x0 = blockIdx.x * kBX1, y0 = blockIdx.y * kBY1;
  const int tid = threadIdx.y * kBX1 + threadIdx.x;
  // planes [q0, q1) of x (clamped coordinates) and cell planes [c0, c1) of
  // the masks (0 outside the grid, written directly) into their ring slots
  auto fetch = [&](int q0, int q1, int c0, int c1) {
    for (int k = tid; k < (q1 - q0) * PX; k += NT) {
      const int q = q0 + k / PX, r = (k % PX) / SX, c = k % SX;
      const int gz = min(max(q, 0), D - 1), gy = min(max(y0 - 1 + r, 0), R - 1), gx = min(max(x0 - 1 + c, 0), C - 1);
      copy_async(xr + ((q + RINGX) % RINGX) * PX + k % PX, x + (gz * R + gy) * C + gx);
    }
    for (int k = tid; k < (c1 - c0) * PM; k += NT) {
      const int cz = c0 + k / PM, cy = y0 - 1 + (k % PM) / MX, cx = x0 - 1 + k % MX;
      T* dst = mr + ((cz + RINGM) % RINGM) * PM + k % PM;
      if (cz >= 0 && cz < nz && cy >= 0 && cy < ny && cx >= 0 && cx < nx) {
        copy_async(dst, mask + (cz * ny + cy) * nx + cx);
      } else {
        *dst = T(0);
      }
    }
    copy_commit();
  };
  if (tid < 64) copy_async(sa + tid, A + tid);
  const int px = x0 + threadIdx.x, py = y0 + threadIdx.y;
  const bool live = px < C && py < R;
  const int zfirst = blockIdx.z * ZCH * RZ;
  fetch(zfirst - 1, zfirst + RZ + 1, zfirst - 1, zfirst + RZ);  // A travels in the first group
  for (int ch = 0; ch < ZCH; ++ch) {
    const int z0 = zfirst + ch * RZ;
    if (z0 >= D) break;  // uniform over the CTA
    if (ch + 1 < ZCH && z0 + RZ < D) {
      // the next block's new planes, in flight while this block is summed
      fetch(z0 + RZ + 1, z0 + 2 * RZ + 1, z0 + RZ, z0 + 2 * RZ);
      copy_wait<1>();
    } else {
      copy_wait<0>();
    }
    __syncthreads();
    if (live) {
      // the masks of the cells around the run: cell (z0-1+a, y-1+b, x-1+c)
      // at ring plane (z0-1+a); a run that no active cell touches writes zeros
      const T* mcol = mr + threadIdx.y * MX + threadIdx.x;
      auto mk = [&](int a, int b, int c) -> T { return mcol[((z0 - 1 + a + RINGM) % RINGM) * PM + b * MX + c]; };
      bool any = false;
#pragma unroll
      for (int a = 0; a < RZ + 1; ++a)
#pragma unroll
        for (int b = 0; b < 2; ++b)
#pragma unroll
          for (int c = 0; c < 2; ++c) any = any || mk(a, b, c) != T(0);
      T acc[RZ];
#pragma unroll
      for (int k = 0; k < RZ; ++k) acc[k] = T(0);
      if (any) {
        T win[RZ + 2][3][3];
#pragma unroll
        for (int a = 0; a < RZ + 2; ++a) {
          const T* pl = xr + ((z0 - 1 + a + RINGX) % RINGX) * PX + threadIdx.y * SX + threadIdx.x;
#pragma unroll
          for (int r = 0; r < 3; ++r)
#pragma unroll
            for (int c = 0; c < 3; ++c) win[a][r][c] = pl[r * SX + c];
        }
        // the node's cells in ascending local index i = (oz 2 + oy) 2 + ox:
        // the cell (z - oz, y - oy, x - ox), whose node j sits at window
        // offset (1 - o + o_j) on each axis; one load of A[i][j] serves the run
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int oz = i >> 2, oy = (i >> 1) & 1, ox = i & 1;
          T s[RZ];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int jz = j >> 2, jy = (j >> 1) & 1, jx = j & 1;
            const T aij = sa[i * 8 + j];
#pragma unroll
            for (int k = 0; k < RZ; ++k) {
              const T t = mul_rn(aij, win[k + 1 - oz + jz][1 - oy + jy][1 - ox + jx]);
              s[k] = j == 0 ? t : add_rn(s[k], t);
            }
          }
#pragma unroll
          for (int k = 0; k < RZ; ++k) {
            const T m = mk(k + 1 - oz, 1 - oy, 1 - ox);
            if (m != T(0)) acc[k] = add_rn(acc[k], mul_rn(m, s[k]));
          }
        }
      }
#pragma unroll
      for (int k = 0; k < RZ; ++k) {
        if (z0 + k < D) y[((z0 + k) * R + py) * C + px] = acc[k];
      }
    }
    __syncthreads();  // the next fetch refills slots this block read
  }
}

// ------------------------------------------------------------- d = 2, 3
template <int DEG> struct Tile;
template <> struct Tile<2> {
  static constexpr int cells = PHIFEM_HEX3_TC2, threads = PHIFEM_HEX3_NT2, min_ctas = PHIFEM_HEX3_MB2, rows = 3;
};
template <> struct Tile<3> {
  static constexpr int cells = PHIFEM_HEX3_TC3, threads = PHIFEM_HEX3_NT3, min_ctas = PHIFEM_HEX3_MB3, rows = 4;
};
constexpr int kKC = PHIFEM_HEX3_KC;

template <typename T, int DEG>
struct Layout {
  static constexpr int P = DEG + 1;
  static constexpr int NLOC = P * P * P;
  static constexpr int TC = Tile<DEG>::cells;
  static constexpr int NT = Tile<DEG>::threads;
  static constexpr int RB = Tile<DEG>::rows;   // rows of A a thread takes at once
  static constexpr int NRB = NLOC / RB;
  static constexpr int HC = TC + 1;            // cells per side with the low halo
  static constexpr int NCELL = HC * HC * HC;
  static constexpr int HN = DEG * HC + 1;      // staged x nodes per side
  static constexpr int NX = HN * HN * HN;
  static constexpr int ON = DEG * TC + 1;      // owned nodes per side, at most
  static constexpr int ATS = NLOC % 2 == 0 ? NLOC + 2 : NLOC + 1;  // A^T's row stride: fewer bank conflicts
  static_assert(RB == P, "a row block is one line of local nodes along x");
  static_assert(RB != 4 || (NCELL * NLOC) % 4 == 0, "A^T's rows are 16-byte aligned for pair loads");
  // shared memory: slots [NCELL][NLOC], A^T [NLOC][ATS], x [NX], masks
  // [NCELL] in T; the list in int
  static constexpr size_t bytes =
      (size_t)(NCELL * NLOC + NLOC * ATS + NX + NCELL) * sizeof(T) + NCELL * sizeof(int);
};

// nodes of the tile along one axis: [0, owned) relative to d t0
template <int DEG, int TC>
__device__ __forceinline__ int owned_nodes(int t0, int ncell) {
  return t0 + TC >= ncell ? DEG * (ncell - t0) + 1 : DEG * TC;
}

// The cells (halo-indexed: cell t0 - 1 + q) along one axis that contain the
// owned node v (relative to d t0), in ascending local offset: cell q[0] at
// offset o[0] if has[0], then cell q[1] = c at offset d if has[1].
template <int DEG, int TC>
struct AxisCells {
  int q[2], o[2];
  bool has[2];
  __device__ __forceinline__ explicit AxisCells(int v) {
    const int c = v / DEG, r = v - c * DEG;
    q[0] = c + 1;
    o[0] = r;
    has[0] = r != 0 || c < TC;  // at the lattice's far edge the cell above has mask 0
    q[1] = c;                   // the cell below (the halo cell when c == 0)
    o[1] = DEG;
    has[1] = r == 0;
  }
};

template <typename T, int DEG>
__global__ void __launch_bounds__(Tile<DEG>::threads, Tile<DEG>::min_ctas)
hex_stencil3_kernel(const T* __restrict__ x, T* __restrict__ y,
                    const T* __restrict__ mask, const T* __restrict__ A,
                    int nx, int ny, int nz) {
  using L = Layout<T, DEG>;
  constexpr int P = L::P, NLOC = L::NLOC, TC = L::TC, NT = L::NT, HC = L::HC, NCELL = L::NCELL;
  constexpr int HN = L::HN, ON = L::ON, RB = L::RB, NRB = L::NRB, ATS = L::ATS;
  extern __shared__ __align__(16) unsigned char smem[];
  T* slot = reinterpret_cast<T*>(smem);  // [cell][row] = mask * row dot
  T* at = slot + NCELL * NLOC;           // A transposed: at[j * ATS + i] = A[i][j]
  T* xs = at + NLOC * ATS;
  T* ms = xs + L::NX;
  int* list = reinterpret_cast<int*>(ms + NCELL);  // full cells from the front, halo cells from the back
  __shared__ int nfull, nhalo;

  const int C = DEG * nx + 1, R = DEG * ny + 1, D = DEG * nz + 1;
  const int tid = threadIdx.x, lane = tid & 31;
  const int t0x = blockIdx.x * TC, t0y = blockIdx.y * TC, t0z = blockIdx.z * TC;
  const int onx = owned_nodes<DEG, TC>(t0x, nx), ony = owned_nodes<DEG, TC>(t0y, ny),
            onz = owned_nodes<DEG, TC>(t0z, nz);
  const int base = (DEG * t0z * R + DEG * t0y) * C + DEG * t0x;  // owned node (0, 0, 0)
  if (tid == 0) nfull = nhalo = 0;

  // 1. masks of the tile and its low halo (0 outside the grid), all loads in
  //    flight together; the active list
  {
    constexpr int NML = (NCELL + NT - 1) / NT;
    T m[NML];
#pragma unroll
    for (int i = 0; i < NML; ++i) {
      const int k = tid + i * NT;
      const int qz = k / (HC * HC), qy = (k / HC) % HC, qx = k % HC;
      const int cz = t0z - 1 + qz, cy = t0y - 1 + qy, cx = t0x - 1 + qx;
      const bool in = k < NCELL && cz >= 0 && cz < nz && cy >= 0 && cy < ny && cx >= 0 && cx < nx;
      m[i] = in ? mask[(cz * ny + cy) * nx + cx] : T(0);
    }
    __syncthreads();  // nfull / nhalo are zero
#pragma unroll
    for (int i = 0; i < NML; ++i) {
      const int k = tid + i * NT;
      if (k < NCELL) ms[k] = m[i];
      const bool halo = k / (HC * HC) == 0 || (k / HC) % HC == 0 || k % HC == 0;
      const unsigned full_w = __ballot_sync(0xffffffffu, m[i] != T(0) && !halo);
      const unsigned halo_w = __ballot_sync(0xffffffffu, m[i] != T(0) && halo);
      int fb = 0, hb = 0;
      if (lane == 0) {
        if (full_w) fb = atomicAdd(&nfull, __popc(full_w));
        if (halo_w) hb = atomicAdd(&nhalo, __popc(halo_w));
      }
      fb = __shfl_sync(0xffffffffu, fb, 0);
      hb = __shfl_sync(0xffffffffu, hb, 0);
      const unsigned below = (1u << lane) - 1u;
      if (m[i] != T(0)) {
        if (halo) list[NCELL - 1 - (hb + __popc(halo_w & below))] = k;
        else list[fb + __popc(full_w & below)] = k;
      }
    }
  }
  __syncthreads();
  const int nf = nfull, na = nfull + nhalo;
  if (na == 0) {  // no active cell: zeros, and no x is read
    for (int k = tid; k < ON * ON * ON; k += NT) {
      const int lz = k / (ON * ON), ly = (k / ON) % ON, lx = k % ON;
      if (lz < onz && ly < ony && lx < onx) y[base + (lz * R + ly) * C + lx] = T(0);
    }
    return;
  }

  // 2. A (transposed) and x at the nodes of the cells, [d (t0 - 1), d (t0 + TC)]
  //    on each axis (0 outside the lattice), every load of a thread issued
  //    before the first store
  {
    constexpr int NA = NLOC * NLOC, NALL = NA + L::NX;
    constexpr int ITEMS = (NALL + NT - 1) / NT;
    constexpr int BATCH = ITEMS < 32 ? ITEMS : 32;  // loads of a thread in flight at a time
    const int gz0 = DEG * (t0z - 1), gy0 = DEG * (t0y - 1), gx0 = DEG * (t0x - 1);
#pragma unroll 1
    for (int i0 = 0; i0 < ITEMS; i0 += BATCH) {
    T v[BATCH];
#pragma unroll
    for (int i = 0; i < BATCH; ++i) {
      const int k = tid + (i0 + i) * NT;
      if (k < NA) {
        v[i] = A[k];
      } else {
        const int kx = k - NA;
        const int lz = kx / (HN * HN), ly = (kx / HN) % HN, lx = kx % HN;
        const int gz = gz0 + lz, gy = gy0 + ly, gx = gx0 + lx;
        const bool in = kx < L::NX && gz >= 0 && gz < D && gy >= 0 && gy < R && gx >= 0 && gx < C;
        v[i] = in ? x[(gz * R + gy) * C + gx] : T(0);
      }
    }
#pragma unroll
    for (int i = 0; i < BATCH; ++i) {
      const int k = tid + (i0 + i) * NT;
      if (k < NA) at[(k % NLOC) * ATS + k / NLOC] = v[i];
      else if (k < NALL) xs[k - NA] = v[i];
    }
    }
  }
  __syncthreads();

  // 3. row dots: a thread takes RB consecutive rows of A and KC cells (full
  //    cells first, then halo cells), RB x KC independent sums in registers,
  //    each over ascending j; consecutive threads take consecutive row blocks
  //    of the same cells, so the x loads are broadcasts
  const int ncb = (na + kKC - 1) / kKC;
  for (int item = tid; item < NRB * ncb; item += NT) {
    const int i0 = (item % NRB) * RB, cb = item / NRB;
    int cell[kKC];
    const T* xc[kKC];
    bool keep[RB][kKC];
    bool any = false;
    // the row block's offsets: oz, oy shared, ox = r (RB = d + 1 rows)
    const int boz = i0 / (P * P), boy = (i0 / P) % P;
#pragma unroll
    for (int k = 0; k < kKC; ++k) {
      const int p = min(cb * kKC + k, na - 1);
      cell[k] = list[p < nf ? p : NCELL - 1 - (p - nf)];
      const int qz = cell[k] / (HC * HC), qy = (cell[k] / HC) % HC, qx = cell[k] % HC;
      xc[k] = xs + ((DEG * qz) * HN + DEG * qy) * HN + DEG * qx;
      // the row's node relative to d t0, v = d (q - 1) + o, owned by this tile?
      const int vz = DEG * (qz - 1) + boz, vy = DEG * (qy - 1) + boy, vx0 = DEG * (qx - 1);
      const bool zy = cb * kKC + k < na && vz >= 0 && vz < onz && vy >= 0 && vy < ony;
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        keep[r][k] = zy && vx0 + r >= 0 && vx0 + r < onx;
        any = any || keep[r][k];
      }
    }
    if (!any) continue;  // a halo cell's rows that the tile does not own
    T s[RB][kKC];
#pragma unroll 1
    for (int jz = 0; jz < P; ++jz) {
#pragma unroll
      for (int jy = 0; jy < P; ++jy) {
#pragma unroll
        for (int jx = 0; jx < P; ++jx) {
          const int j = (jz * P + jy) * P + jx;
          T av[RB], xv[kKC];
          if constexpr (RB == 4) {  // i0 is a multiple of 4 and NLOC even: two aligned pair loads
            using V = typename Pair<T>::type;
            const V lo = reinterpret_cast<const V*>(at + j * ATS + i0)[0];
            const V hi = reinterpret_cast<const V*>(at + j * ATS + i0)[1];
            av[0] = lo.x;
            av[1] = lo.y;
            av[2] = hi.x;
            av[3] = hi.y;
          } else {
#pragma unroll
            for (int r = 0; r < RB; ++r) av[r] = at[j * ATS + i0 + r];
          }
#pragma unroll
          for (int k = 0; k < kKC; ++k) xv[k] = xc[k][(jz * HN + jy) * HN + jx];
#pragma unroll
          for (int r = 0; r < RB; ++r) {
#pragma unroll
            for (int k = 0; k < kKC; ++k) {
              const T t = mul_rn(av[r], xv[k]);
              s[r][k] = jz == 0 && jy == 0 && jx == 0 ? t : add_rn(s[r][k], t);
            }
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < RB; ++r)
#pragma unroll
      for (int k = 0; k < kKC; ++k)
        if (keep[r][k]) slot[cell[k] * NLOC + i0 + r] = mul_rn(ms[cell[k]], s[r][k]);
  }
  __syncthreads();

  // 4. each owned node: its slots in ascending local index, from 0
  for (int k = tid; k < ON * ON * ON; k += NT) {
    const int lz = k / (ON * ON), ly = (k / ON) % ON, lx = k % ON;
    if (lz >= onz || ly >= ony || lx >= onx) continue;
    const AxisCells<DEG, TC> az(lz), ay(ly), ax(lx);
    T acc = T(0);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
#pragma unroll
      for (int v = 0; v < 2; ++v) {
#pragma unroll
        for (int w = 0; w < 2; ++w) {
          if (!(az.has[u] && ay.has[v] && ax.has[w])) continue;
          const int c = (az.q[u] * HC + ay.q[v]) * HC + ax.q[w];
          const T m = ms[c];
          if (m == T(0)) continue;
          acc = add_rn(acc, slot[c * NLOC + (az.o[u] * P + ay.o[v]) * P + ax.o[w]]);
        }
      }
    }
    y[base + (lz * R + ly) * C + lx] = acc;
  }
}

template <typename T>
int launch1(const void* x, void* y, const void* mask, const void* A, int nx, int ny, int nz,
            cudaStream_t stream) {
  using K = Block1<T>;
  static unsigned long long opted_in = 0;  // the shared-memory opt-in beyond 48 KB, once per device
  if (K::bytes > 48 * 1024) {
    int dev = 0;
    cudaGetDevice(&dev);
    if (dev >= 64 || !(opted_in >> dev & 1ULL)) {
      const cudaError_t e = cudaFuncSetAttribute(hex1_stencil3_kernel<T>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)K::bytes);
      if (e != cudaSuccess) return static_cast<int>(e);
      if (dev < 64) opted_in |= 1ULL << dev;
    }
  }
  const int zrun = K::RZ * K::ZCH;
  const dim3 block(kBX1, kBY1);
  const dim3 grid((nx + 1 + kBX1 - 1) / kBX1, (ny + 1 + kBY1 - 1) / kBY1, (nz + 1 + zrun - 1) / zrun);
  hex1_stencil3_kernel<T><<<grid, block, K::bytes, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), static_cast<const T*>(mask),
      static_cast<const T*>(A), nx, ny, nz);
  return 0;
}

template <typename T, int DEG>
int launch(const void* x, void* y, const void* mask, const void* A, int nx, int ny, int nz,
           cudaStream_t stream) {
  using L = Layout<T, DEG>;
  static unsigned long long opted_in = 0;  // the shared-memory opt-in, once per device
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 64 || !(opted_in >> dev & 1ULL)) {
    const cudaError_t e = cudaFuncSetAttribute(hex_stencil3_kernel<T, DEG>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < 64) opted_in |= 1ULL << dev;
  }
  const dim3 grid((nx + L::TC - 1) / L::TC, (ny + L::TC - 1) / L::TC, (nz + L::TC - 1) / L::TC);
  hex_stencil3_kernel<T, DEG><<<grid, L::NT, L::bytes, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), static_cast<const T*>(mask),
      static_cast<const T*>(A), nx, ny, nz);
  return 0;
}

template <typename T>
int dispatch(const void* x, void* y, const void* mask, const void* A, int nx, int ny,
             int nz, int degree, cudaStream_t stream) {
  switch (degree) {
    case 1: return launch1<T>(x, y, mask, A, nx, ny, nz, stream);
    case 2: return launch<T, 2>(x, y, mask, A, nx, ny, nz, stream);
    case 3: return launch<T, 3>(x, y, mask, A, nx, ny, nz, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}


// ----------------------------------------------- 3-channel blocks, d = 1
// The block form of the degree-1 stencil, for the (24, 24) channel-major cell
// matrix K of a 3-vector Q1 field (local dof 8 c + i, channels first):
//
//   y[c, n] = sum_{cells containing n, i ascending} mask * sum_{c', j} K[8c+i, 8c'+j] x[c', node(cell, j)]
//
// the XLA-fused _masked_block_stencil_apply of
// phifem_tpu/models/interface_elasticity3.py (:122), run once per side in
// every S5-3D matvec.  Bound: the arithmetic where most cells are active
// (2 x 576 operations per active cell against 56 B per node in float64: x
// and y, 3 channels, and the cell mask), the bytes on the sparse side.
// Every product and sum is an instruction of its own (no FMA, for the
// bits), so the arithmetic takes at least twice what the data sheet's rate
// says (the "no-FMA floor").
//
// Design (the Findings of PERF.md say what else was tried):
//  * K lives in the constant bank: the entry point copies it (device to
//    device, 4.6 KB in float64) into a __constant__ array on the launch's
//    stream just before the launch.  The array is one per process and
//    device, so launches must stay on one stream, where each copy waits for
//    the launch before it: two streams launching this kernel at once would
//    race for the array (ops/cuda_hex3.py: hex_block_stencil3 refuses a
//    second stream).  Each product takes its K operand through a uniform
//    register that a ULDC fills from the constant cache, one ULDC per
//    float64 value.
//  * A CTA of BX x BY threads owns a column of nodes and a run of RZ planes,
//    for all three output channels or, in float64 (SPLIT), for one: the
//    output channel is the slowest part of blockIdx.z, so a CTA reads only
//    its 192 rows' entries of K (1.5 KB) and the CTAs resident on an SM
//    mostly share them; all 576 (4.6 KB in float64) are more than the
//    constant cache keeps close.
//  * The CTA first reads the cell masks around its nodes ((RZ + 1) x
//    (BY + 1) x (BX + 1), 0 outside the grid; every load of a thread in
//    flight before the first store) into shared memory; if none is active
//    (__syncthreads_or) it writes zeros and reads no x.  Otherwise it copies
//    the three channels' planes of x its nodes need (one-node halo, clamped
//    coordinates: a clamped value only meets a cell outside the grid, whose
//    mask is 0) into shared memory with cp.async, all in flight at once.
//  * A thread walks its run node by node.  For each input channel c' in
//    turn it loads the node's 3 x 3 x 3 window of x[c'] from shared memory
//    into registers and adds, for every cell i around the node (cell =
//    node - offset_i), its products K[8c+i, 8c'+j] x[c', j] to the row sums
//    s[c][i] held in registers: each s sums in ascending (c', j), from its
//    first product.  Every cell is summed, active or not, and each output
//    channel then adds m_i s[c][i] over the active cells in ascending i,
//    from 0.  A node with no active cell writes zeros.  81 shared loads of
//    x per node.
// Every product and sum is rounded on its own: the order of the plain
// version (ops/cuda_hex3.py: hex_block_stencil3_ref) bit for bit, up to the
// sign of a zero.  The tiling (ops/cuda_hex3.py BLOCK_TILE) is the best of
// scripts/tune_torch_stencil3.py on an H100.
#ifndef PHIFEM_HEX3B_BX
#define PHIFEM_HEX3B_BX 16
#endif
#ifndef PHIFEM_HEX3B_BY
#define PHIFEM_HEX3B_BY 8
#endif
#ifndef PHIFEM_HEX3B_RZ
#define PHIFEM_HEX3B_RZ 4
#endif
#ifndef PHIFEM_HEX3B_SPLIT_F32
#define PHIFEM_HEX3B_SPLIT_F32 0
#endif
#ifndef PHIFEM_HEX3B_SPLIT_F64
#define PHIFEM_HEX3B_SPLIT_F64 1
#endif
// a CTA of BX x BY threads, each a node column and a run of RZ nodes along
// z; split: one output channel per CTA
constexpr int kVSZ = 3, kNK = 64 * kVSZ * kVSZ, kBXB = PHIFEM_HEX3B_BX, kBYB = PHIFEM_HEX3B_BY,
              kRZB = PHIFEM_HEX3B_RZ;
template <typename T> struct Split;
template <> struct Split<float> { static constexpr bool value = PHIFEM_HEX3B_SPLIT_F32; };
template <> struct Split<double> { static constexpr bool value = PHIFEM_HEX3B_SPLIT_F64; };
template <int V> struct IntC { static constexpr int value = V; };

// the cell matrix of the current launch, row-major
__constant__ float kKf[kNK];
__constant__ double kKd[kNK];
template <typename T> __device__ __forceinline__ T kval(int e);
template <> __device__ __forceinline__ float kval<float>(int e) { return kKf[e]; }
template <> __device__ __forceinline__ double kval<double>(int e) { return kKd[e]; }

template <typename T>
__global__ void __launch_bounds__(kBXB * kBYB)
hexblock_stencil3_kernel(const T* __restrict__ x, T* __restrict__ y,
                         const T* __restrict__ mask, int nx, int ny, int nz) {
  constexpr bool SPLIT = Split<T>::value;
  constexpr int BX = kBXB, BY = kBYB, RZ = kRZB, NT = BX * BY;
  constexpr int SX = BX + 2, SY = BY + 2, PX = SY * SX, NPX = RZ + 2;
  constexpr int MX = BX + 1, MY = BY + 1, PM = MY * MX, NPM = RZ + 1;
  constexpr int CW = SPLIT ? 1 : kVSZ;  // output channels per CTA
  static_assert((kVSZ * NPX * PX + NPM * PM) * sizeof(T) <= 48 * 1024, "the block must fit static shared memory");
  __shared__ __align__(16) T sx[kVSZ * NPX * PX];
  __shared__ __align__(16) T sm[NPM * PM];
  const int C = nx + 1, R = ny + 1, D = nz + 1;
  const long long N = (long long)D * R * C;
  // with split, the CTA's output channel ci is the slowest part of blockIdx.z
  const int nbz = (D + RZ - 1) / RZ, ci = SPLIT ? blockIdx.z / nbz : 0, z0 = (blockIdx.z - ci * nbz) * RZ;
  const int x0 = blockIdx.x * BX, y0 = blockIdx.y * BY;
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * BX + tx;
  const int px = x0 + tx, py = y0 + ty;
  const bool live = px < C && py < R;

  // 1. the cell masks around the CTA's nodes, 0 outside the grid, every
  //    load of a thread in flight before the first store
  bool found = false;
  {
    constexpr int NML = (NPM * PM + NT - 1) / NT;
    T mv[NML];
#pragma unroll
    for (int u = 0; u < NML; ++u) {
      const int k = tid + u * NT;
      const int cz = z0 - 1 + k / PM, cy = y0 - 1 + (k % PM) / MX, cx = x0 - 1 + k % MX;
      mv[u] = (k < NPM * PM && cz >= 0 && cz < nz && cy >= 0 && cy < ny && cx >= 0 && cx < nx)
                  ? mask[((long long)cz * ny + cy) * nx + cx] : T(0);
    }
#pragma unroll
    for (int u = 0; u < NML; ++u) {
      const int k = tid + u * NT;
      if (k < NPM * PM) sm[k] = mv[u];
      found = found || mv[u] != T(0);
    }
  }
  if (!__syncthreads_or(found)) {  // no active cell: zeros, and no x is read
    if (live) {
#pragma unroll
      for (int k = 0; k < RZ; ++k) {
        if (z0 + k >= D) break;
#pragma unroll
        for (int c = ci; c < ci + CW; ++c) y[c * N + ((long long)(z0 + k) * R + py) * C + px] = T(0);
      }
    }
    return;
  }

  // 2. the three channels' planes z0 - 1 .. z0 + RZ of x, clamped, by cp.async
  for (int k = tid; k < kVSZ * NPX * PX; k += NT) {
    const int c = k / (NPX * PX), a = (k / PX) % NPX, r = (k % PX) / SX, q = k % SX;
    const int gz = min(max(z0 - 1 + a, 0), D - 1), gy = min(max(y0 - 1 + r, 0), R - 1),
              gx = min(max(x0 - 1 + q, 0), C - 1);
    copy_async(sx + k, x + c * N + ((long long)gz * R + gy) * C + gx);
  }
  copy_commit();
  copy_wait<0>();
  __syncthreads();
  if (!live) return;

  // 3. the run, node by node, for output channels C0 .. C0 + NC - 1
  auto run = [&](auto c0, auto nc) {
    constexpr int C0 = decltype(c0)::value, NC = decltype(nc)::value;
#pragma unroll 1
    for (int k = 0; k < RZ; ++k) {
      const int pz = z0 + k;
      if (pz >= D) break;
      // the mask of the node's cell i, (pz - oz, py - oy, px - ox)
      T m[8];
      bool any = false;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int oz = i >> 2, oy = (i >> 1) & 1, ox = i & 1;
        m[i] = sm[(k + 1 - oz) * PM + (ty + 1 - oy) * MX + tx + 1 - ox];
        any = any || m[i] != T(0);
      }
      T acc[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[c] = T(0);
      if (any) {
        T s[NC][8];
#pragma unroll
        for (int cj = 0; cj < kVSZ; ++cj) {
          // x[c'] at the node + (dz, dy, dx) - 1, d in {0, 1, 2}^3
          T w[27];
          const T* base = sx + (cj * NPX + k) * PX + ty * SX + tx;
#pragma unroll
          for (int d = 0; d < 27; ++d) w[d] = base[(d / 9) * PX + ((d / 3) % 3) * SX + d % 3];
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int oz = i >> 2, oy = (i >> 1) & 1, ox = i & 1;
#pragma unroll
            for (int c = 0; c < NC; ++c) {
#pragma unroll
              for (int j = 0; j < 8; ++j) {
                // the cell's node j sits at window offset 1 - o + o_j on each axis
                const int jz = j >> 2, jy = (j >> 1) & 1, jx = j & 1;
                const T t = mul_rn(kval<T>((8 * (C0 + c) + i) * 8 * kVSZ + 8 * cj + j),
                                   w[((1 - oz + jz) * 3 + 1 - oy + jy) * 3 + 1 - ox + jx]);
                s[c][i] = (cj == 0 && j == 0) ? t : add_rn(s[c][i], t);
              }
            }
          }
        }
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
          for (int i = 0; i < 8; ++i)
            if (m[i] != T(0)) acc[c] = add_rn(acc[c], mul_rn(m[i], s[c][i]));
      }
#pragma unroll
      for (int c = 0; c < NC; ++c) y[(C0 + c) * N + ((long long)pz * R + py) * C + px] = acc[c];
    }
  };
  if constexpr (SPLIT) {
    if (ci == 0) {
      run(IntC<0>(), IntC<1>());
    } else if (ci == 1) {
      run(IntC<1>(), IntC<1>());
    } else {
      run(IntC<2>(), IntC<1>());
    }
  } else {
    run(IntC<0>(), IntC<kVSZ>());
  }
}

template <typename T>
int launch_block(const void* x, void* y, const void* mask, const void* K, int nx, int ny, int nz,
                 cudaStream_t stream) {
  cudaError_t e;
  if constexpr (sizeof(T) == 8) {
    e = cudaMemcpyToSymbolAsync(kKd, K, sizeof(kKd), 0, cudaMemcpyDeviceToDevice, stream);
  } else {
    e = cudaMemcpyToSymbolAsync(kKf, K, sizeof(kKf), 0, cudaMemcpyDeviceToDevice, stream);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 block(kBXB, kBYB);
  const dim3 grid((nx + 1 + kBXB - 1) / kBXB, (ny + 1 + kBYB - 1) / kBYB,
                  (nz + 1 + kRZB - 1) / kRZB * (Split<T>::value ? kVSZ : 1));
  hexblock_stencil3_kernel<T><<<grid, block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), static_cast<const T*>(mask), nx, ny, nz);
  return 0;
}

}  // namespace

extern "C" {

// y = A_masked x on the degree-d node lattice.  x, y: device pointers to
// (d nz + 1) (d ny + 1) (d nx + 1) values; mask: device pointer to nz ny nx
// cell values; A: device pointer to nloc x nloc values (row-major), all in
// the same type.  Returns cudaGetLastError() (cudaErrorInvalidValue for a
// degree other than 1, 2, 3).
int phifem_hex_stencil3(const void* x, void* y, const void* mask, const void* A, int nx,
                        int ny, int nz, int degree, int is_double, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bad = is_double ? dispatch<double>(x, y, mask, A, nx, ny, nz, degree, s)
                            : dispatch<float>(x, y, mask, A, nx, ny, nz, degree, s);
  if (bad) return bad;
  return static_cast<int>(cudaGetLastError());
}

// The tilings this library was built with: BX1, BY1, RZ1 (f32), RZ1 (f64),
// ZCH1, TC2, TC3, NT2, NT3, KC, MB2, MB3, MB1.
void phifem_hex3_constants(int* out) {
  const int v[] = {kBX1, kBY1, Run1<float>::nodes, Run1<double>::nodes, Run1<double>::chunks, Tile<2>::cells,
                   Tile<3>::cells, Tile<2>::threads, Tile<3>::threads, kKC, Tile<2>::min_ctas, Tile<3>::min_ctas,
                   PHIFEM_HEX3_MB1};
  for (int i = 0; i < 13; ++i) out[i] = v[i];
}

// y = K_masked x for a 3-channel Q1 field (see hexblock_stencil3_kernel):
// x, y: device pointers to 3 (nz + 1) (ny + 1) (nx + 1) values, channels
// first; mask: nz ny nx cell values; K: device pointer to the (24, 24)
// channel-major cell matrix (row-major), all in the same type; K is copied
// into the constant bank on the stream before the launch.  Returns the
// copy's error or cudaGetLastError().
int phifem_hex_block_stencil3(const void* x, void* y, const void* mask, const void* K, int nx,
                              int ny, int nz, int is_double, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bad = is_double ? launch_block<double>(x, y, mask, K, nx, ny, nz, s)
                            : launch_block<float>(x, y, mask, K, nx, ny, nz, s);
  if (bad) return bad;
  return static_cast<int>(cudaGetLastError());
}

// The block kernel's tiling: BX, BY, RZ, SPLIT for float32, SPLIT for
// float64.
void phifem_hexblock_constants(int* out) {
  const int v[] = {kBXB, kBYB, kRZB, Split<float>::value, Split<double>::value};
  for (int i = 0; i < 5; ++i) out[i] = v[i];
}

const char* phifem_hex3_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

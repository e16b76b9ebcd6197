// The interface band solve's loops, for Hopper: the restricted additive
// Schwarz (RAS) block apply, the band matrix's sliced-ELL product, ordered
// dot products and the fused updates of the fixed-sweep BiCGStab on the cut
// band.
//
// Replaces the XLA-fused loops of phifem_tpu/mg.py (not a Pallas kernel):
// band_ras (:389-398), the block apply of VCycle._band_correct_flat (:359),
// band_mv (:383-387, (vals * vpad[cols]).sum(axis=1) over the row-major
// padded ELL table), and the body of _band_bicgstab (:85-139): its dots and
// its vector updates.  Used by phifem_tpu_torch/ops/cuda_band.py for every
// Schwarz band: 2D lattice, mg_preconditioner, AMG, p-MG's high-degree band,
// and the 3D schemes' lattice_core.make_interface_apply.
//
// All values are float64 (the band tables are, whatever the cycle's dtype),
// and every product, quotient and sum is rounded on its own (__dmul_rn,
// __ddiv_rn, __dadd_rn, __dsub_rn: no FMA contraction), in the order the
// plain versions in cuda_band.py take, so each kernel equals its plain
// version bit for bit.  The only atomic is the dot kernel's arrival counter,
// which elects the CTA that runs the second stage and never orders a sum;
// no state is kept between launches but the solve's scalar slots and that
// counter (back to 0 at the end of every launch), which the caller owns.
//
// 1. band_ras_kernel<mode, chunk>: the RAS apply as an ELL product of width
//    K over the m band DoFs.  Row i of the table (cuda_band.ras_table) is
//    the one row of a block inverse that corrects DoF i, its slot l the
//    value inv[b, k, l] and the column ids[b, l] (block b = s / K, row k =
//    s % K of its owner slot s), stored slot-major (slot l of DoF i at l m +
//    i), so the owner / ids indirection is resolved once on the host and
//    a warp's loads of one slot are 32 consecutive values.  A pad id m
//    inside a block stays a slot that reads 0; a DoF with no owner has K
//    slots of value 0 and column m.  The sum is the plain one: acc = -0,
//    then acc = acc + v x in ascending l, each product and add rounded on
//    its own (-0 + p0 = p0 bit for bit, and an unowned DoF ends at +0).
//    Modes: y = acc, y = om acc, y = c + om acc (the RAS-Richardson inner
//    solve), and the two BiCGStab steps folded into the launch that reads
//    their vector:
//      P: the value gathered at a column c is the new p[c] = r[c] + beta
//         (p[c] - omega v[c]) (sweep 0: r[c]), computed from r, the old p
//         and v, which the launch only reads; each thread writes its own
//         row's new p to the other of two p buffers, and y = ph; before it,
//         the best-iterate select of the previous sweep (sweep 0: the best
//         residual set to r.r);
//      S: the value gathered is s[c] = r[c] - alpha v[c], alpha = rho_new /
//         (rhat.v); each thread writes s[i] and y = sh, thread 0 alpha.
//    Bound: device memory; chip_smoke.py counts the owned rows, their
//    blocks' ids once a block, x, owner and y.  This layout reads m K (8 + 4)
//    bytes of table, an int32 column per slot.  Design: one thread a row,
//    like band_ell_kernel: a chunk of 8 slots' columns and values loaded,
//    then their gathers, and the next chunk's loads issued before this
//    chunk is summed, so the loads are in flight together and not one
//    latency after another; the chunk is a template argument, so the loops
//    over a chunk unroll.  (Chunks of 16 on K > 8 took more registers, 149
//    in RAS+P, and were slower on the K = 16 and 27 bands on an H100:
//    RAS+P 0.029 / 0.020-0.024 ms a launch against 0.022 / 0.013.)
// 2. band_ell_kernel: y = A x or b - A x on the band matrix as a sliced ELL
//    table: the rows sorted by length (longest first) within windows of a
//    few slices, stored row p being row perm[p], then slices of kSlice = 32
//    stored rows, each padded only to its own longest row and stored
//    slot-major inside the slice (slot k of stored row 32 s + r at off[s] +
//    32 k + r), with each stored row's length len[p] (its nonzeros, the host
//    table's trailing pads dropped).  Bound: device memory, each nonzero's
//    value and int32 column once (12 bytes), x (the L2 holds it), y and b.
//    Design: one thread a row, so lane r of a warp reads row r of its slice
//    and a warp's loads of one slot are 32 consecutive values (a 256-byte
//    and a 128-byte run); a thread stops at its own length, so no padded
//    slot is read, and the sort leaves a slice's lanes little to wait for on
//    its longest row.  A thread takes a chunk of slots a step (8, or 16 on
//    tables wider than kWideRow): their columns and values are loaded, then
//    their gathers of x, and the next step's columns and values are issued
//    before this step's products are summed, so two steps' loads are in
//    flight.  The table is read once a launch, evict-first, which leaves the
//    caches to x.  The sum is the plain version's: acc = -0, then acc = acc +
//    v x in ascending slot order, each product and add rounded on its own;
//    the padded host table's trailing pads each added 0 x 0 = +0, which
//    changes acc only from -0 to +0, so a row shorter than the host table's
//    width ends with one acc + 0 and the result is the padded sum bit for
//    bit.  No shuffles, no shared memory, no atomics.  (The AMG cycle's ELL
//    kernel, csrc/amg_ell.cu, reads every padded slot of a slot-major (w, m)
//    table, the lanes of one row m values apart: 3-5x slower on these rows.)
// 3. band_dots_kernel: up to three dot products in one launch.  The sum is a
//    fixed tree: the products are cut into chunks of kChunk = 1024 values
//    (the last padded with +0), each chunk summed by halving (v[j] + v[j + h]
//    for h = 512, 256, ..., 1) in one CTA, and the chunk sums summed again
//    the same way until one value is left.  Every CTA writes its chunk sums
//    to the caller's scratch, then a __threadfence and an atomic add on the
//    scratch's arrival counter; the CTA that arrives last sums the chunk
//    sums by the same tree, in index order, writes the results and sets the
//    counter back to 0.  Which CTA that is changes nothing in the order of
//    any sum, so the result repeats from run to run.  The tree is part of
//    the function: the plain version repeats it.  Results go to device
//    memory (no host read).  Bound: latency (a band's 2 m values are a few
//    hundred kB), so the design spends one launch a call.
// 4. band_update_kernel<mode>: the BiCGStab steps no RAS launch takes, each
//    CTA computing the step's coefficient once from the dot results in the
//    scalar slots (thread 0, through shared memory), with the same guard
//    |d| > 1e-300 ? d : 1e-300 and order of operations as the plain version:
//      XR:  omega = (t.s) / (t.t), x = (x + alpha ph) + omega sh,
//           r' = s - omega t, rho = rho_new;
//      SEL: xb = x where rr is finite and below the best so far.
//    A thread takes two values by 16-byte loads and stores (the vectors
//    are 16-byte aligned: the wrapper checks).  Bound: device memory.
//    The scalar a launch writes (CTA 0) is never one that launch reads; the
//    best residual alternates between two slots by sweep.
//
// An inner BiCGStab sweep is 8 launches: RAS+P, ELL, dots, RAS+S, ELL,
// dots, XR, dots; one SEL after the last sweep.
//
// Plain C interface, loaded with ctypes (phifem_tpu_torch/ops/cuda_band.py):
// each entry point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

// Build constants, overridden by -D defines only in a tuning script's
// variants (scripts/tune_torch_band.py): the slots one thread of the ELL
// kernel loads a step on a table of width up to kWideRow (CHUNK) and wider
// (WIDE_CHUNK), and the ELL kernel's CTA size; the same for the RAS kernel
// (one chunk whatever K).
#ifndef PHIFEM_BAND_RAS_CHUNK
#define PHIFEM_BAND_RAS_CHUNK 8
#endif
#ifndef PHIFEM_BAND_RAS_THREADS
#define PHIFEM_BAND_RAS_THREADS 128
#endif
#ifndef PHIFEM_BAND_ELL_CHUNK
#define PHIFEM_BAND_ELL_CHUNK 8
#endif
#ifndef PHIFEM_BAND_ELL_WIDE_CHUNK
#define PHIFEM_BAND_ELL_WIDE_CHUNK 16
#endif
#ifndef PHIFEM_BAND_ELL_THREADS
#define PHIFEM_BAND_ELL_THREADS 128
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kRasThreads = PHIFEM_BAND_RAS_THREADS;  // the RAS kernel's CTA
constexpr int kPerThread = 4;
constexpr int kChunk = kThreads * kPerThread;  // values summed by one CTA
constexpr int kSlice = 32;                     // rows of an ELL slice: one warp
constexpr int kEllThreads = PHIFEM_BAND_ELL_THREADS;  // the ELL kernel's CTA: whole slices
constexpr int kWideRow = 32;  // host table widths past this take the wide chunk
static_assert(kEllThreads % kSlice == 0, "an ELL CTA holds whole slices");

// the solve's scalar slots (cuda_band.py: SLOTS)
enum Slot { RR = 0, RHO_NEW, RV, TS, TT, RHO, ALPHA, OMEGA, RRB0, RRB1, NSLOTS };
// RAS modes (cuda_band.py: RAS_*) and update modes (cuda_band.py: XR, SEL)
enum RasMode { RAS_APPLY = 0, RAS_SCALE = 1, RAS_ADD = 2, RAS_P = 3, RAS_S = 4 };
enum UpdateMode { MODE_XR = 2, MODE_SEL = 3 };

__device__ __forceinline__ double x_at(const double* __restrict__ x, int c, int n_x) {
  // the pad id n_x (and anything outside [0, n_x)) reads as zero
  return static_cast<unsigned>(c) < static_cast<unsigned>(n_x) ? __ldg(x + c) : 0.0;
}

__device__ __forceinline__ double safe(double d) { return fabs(d) > 1e-300 ? d : 1e-300; }

// the best-iterate select after sweep j: reads the best residual of slot
// RRB0 + j % 2, writes the new one to the other slot (thread 0 of CTA 0)
__device__ __forceinline__ bool select_best(double* sc, int j, bool writer) {
  const double rr = sc[RR];
  const double rrb = sc[RRB0 + (j & 1)];
  const bool better = isfinite(rr) && rr < rrb;
  if (writer) sc[RRB0 + ((j + 1) & 1)] = better ? rr : rrb;
  return better;
}

// The RAS launch's arguments (see phifem_band_ras).
struct RasArgs {
  const int* cols;     // (K, m) slot-major
  const double* vals;  // (K, m)
  const double* x;     // the vector applied; r in modes P and S
  const double* p;     // P: the old p
  const double* v;     // P, S
  const double* c;     // ADD (may be y)
  double* y;           // the RAS result
  double* w;           // P: the new p; S: s
  double* sc;          // P, S: the solve's scalar slots
  const double* xit;   // P: the iterate x (select)
  double* xb;          // P: the best iterate (select)
  int m, K, sweep;
  double om;
};

// The vector the RAS apply gathers, at column col (the pad id m, or
// anything outside [0, m), reads 0): x itself, or in modes P and S the
// step's new p or s, from vectors the launch only reads.  c0, c1: beta
// and omega (P, past sweep 0), alpha (S).
template <int MODE>
__device__ __forceinline__ double ras_in(const RasArgs& a, int col, double c0, double c1, bool first) {
  if (static_cast<unsigned>(col) >= static_cast<unsigned>(a.m)) return 0.0;
  if constexpr (MODE == RAS_P) {
    const double r = __ldg(a.x + col);
    return first ? r : __dadd_rn(r, __dmul_rn(c0, __dsub_rn(__ldg(a.p + col), __dmul_rn(c1, __ldg(a.v + col)))));
  } else if constexpr (MODE == RAS_S) {
    return __dsub_rn(__ldg(a.x + col), __dmul_rn(c0, __ldg(a.v + col)));
  } else {
    return __ldg(a.x + col);
  }
}

template <int MODE, int CH>
__global__ void __launch_bounds__(kRasThreads) band_ras_kernel(const RasArgs a) {
  const int i = blockIdx.x * kRasThreads + threadIdx.x;
  const int m = a.m, K = a.K;
  if (i >= m) return;
  const int* __restrict__ col = a.cols + i;
  const double* __restrict__ val = a.vals + i;
  int cc[CH];
  double vv[CH];
#pragma unroll
  for (int j = 0; j < CH; ++j) {
    const bool on = j < K;
    cc[j] = on ? __ldg(col + static_cast<long long>(j) * m) : m;
    vv[j] = on ? __ldg(val + static_cast<long long>(j) * m) : 0.0;
  }
  // the step's coefficients, as the plain update computes them
  double c0 = 0.0, c1 = 0.0;
  const bool first = MODE == RAS_P && a.sweep == 0;
  if constexpr (MODE == RAS_P) {
    if (!first) {
      c1 = a.sc[OMEGA];
      c0 = __dmul_rn(__ddiv_rn(a.sc[RHO_NEW], safe(a.sc[RHO])), __ddiv_rn(a.sc[ALPHA], safe(c1)));
    }
  } else if constexpr (MODE == RAS_S) {
    c0 = __ddiv_rn(a.sc[RHO_NEW], safe(a.sc[RV]));
  }
  double acc = -0.0;
  for (int k0 = 0; k0 < K; k0 += CH) {
    double xv[CH], pv[CH];
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      xv[j] = ras_in<MODE>(a, cc[j], c0, c1, first);
      pv[j] = vv[j];
    }
    // the next chunk's columns and values fly while this one is summed
    const int k1 = k0 + CH;
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      const bool on = k1 + j < K;
      cc[j] = on ? __ldg(col + static_cast<long long>(k1 + j) * m) : m;
      vv[j] = on ? __ldg(val + static_cast<long long>(k1 + j) * m) : 0.0;
    }
    // slots past K add -0, which changes no value
#pragma unroll
    for (int j = 0; j < CH; ++j) acc = __dadd_rn(acc, k0 + j < K ? __dmul_rn(pv[j], xv[j]) : -0.0);
  }
  if constexpr (MODE == RAS_APPLY) {
    a.y[i] = acc;
  } else if constexpr (MODE == RAS_SCALE) {
    a.y[i] = __dmul_rn(a.om, acc);
  } else if constexpr (MODE == RAS_ADD) {
    a.y[i] = __dadd_rn(a.c[i], __dmul_rn(a.om, acc));  // c may be y: read before the write
  } else {
    a.y[i] = acc;
    a.w[i] = ras_in<MODE>(a, i, c0, c1, first);  // this row's new p, or s
    if constexpr (MODE == RAS_P) {
      if (first) {
        if (i == 0) a.sc[RRB0] = a.sc[RR];
      } else if (select_best(a.sc, a.sweep - 1, i == 0)) {
        a.xb[i] = a.xit[i];
      }
    } else if (i == 0) {
      a.sc[ALPHA] = c0;
    }
  }
}

// Stored row p of the sliced ELL table (see the top of this file), row
// perm[p] of the matrix, kEllChunk slots a step; RESIDUAL: y = b - A x,
// else y = A x.  width: the host table's padded width.  The table's
// columns and values are read once a launch: loaded evict-first (__ldcs),
// so that they leave the caches to x.
template <bool RESIDUAL, int kEllChunk>
__global__ void __launch_bounds__(kEllThreads) band_ell_kernel(const int* __restrict__ cols,
                                                               const double* __restrict__ vals,
                                                               const long long* __restrict__ off,
                                                               const int* __restrict__ len,
                                                               const int* __restrict__ perm,
                                                               const double* __restrict__ x,
                                                               const double* __restrict__ b,
                                                               double* __restrict__ y, int m, int width) {
  const int p = blockIdx.x * kEllThreads + threadIdx.x;
  if (p >= m) return;
  const int n = __ldg(len + p);
  const int i = __ldg(perm + p);  // the row written, loaded with the row's length
  const long long base = __ldg(off + p / kSlice) + p % kSlice;
  const int* __restrict__ c = cols + base;
  const double* __restrict__ v = vals + base;
  int cc[kEllChunk];
  double vv[kEllChunk];
#pragma unroll
  for (int j = 0; j < kEllChunk; ++j) {
    const bool on = j < n;
    cc[j] = on ? __ldcs(c + j * kSlice) : m;
    vv[j] = on ? __ldcs(v + j * kSlice) : 0.0;
  }
  double acc = -0.0;
  for (int k0 = 0; k0 < n; k0 += kEllChunk) {
    double xv[kEllChunk], pv[kEllChunk];
#pragma unroll
    for (int j = 0; j < kEllChunk; ++j) {
      xv[j] = x_at(x, cc[j], m);
      pv[j] = vv[j];
    }
    // the next step's columns and values fly while this step is summed
    const int k1 = k0 + kEllChunk;
#pragma unroll
    for (int j = 0; j < kEllChunk; ++j) {
      const bool on = k1 + j < n;
      cc[j] = on ? __ldcs(c + (k1 + j) * kSlice) : m;
      vv[j] = on ? __ldcs(v + (k1 + j) * kSlice) : 0.0;
    }
    // slots past the row add -0, which changes no value
#pragma unroll
    for (int j = 0; j < kEllChunk; ++j) acc = __dadd_rn(acc, k0 + j < n ? __dmul_rn(pv[j], xv[j]) : -0.0);
  }
  if (n < width) acc = __dadd_rn(acc, 0.0);  // the host table's trailing pads: 0 x 0 = +0
  y[i] = RESIDUAL ? __dsub_rn(__ldg(b + i), acc) : acc;
}

// The halving tree over one chunk: thread t holds positions t + 256 e (e =
// 0..3) of each of the NP rows in v; the row sums end in thread 0's s.
// Starts with a barrier, so part may be reused chunk after chunk.
template <int NP>
__device__ __forceinline__ void chunk_sum(const double (&v)[NP][kPerThread], double (*part)[kThreads],
                                          double (&s)[NP]) {
  const int t = threadIdx.x;
  __syncthreads();
#pragma unroll
  for (int q = 0; q < NP; ++q) {
    // h = 512: positions t + 256 e and t + 256 (e + 2); h = 256: t and t + 256
    part[q][t] = __dadd_rn(__dadd_rn(v[q][0], v[q][2]), __dadd_rn(v[q][1], v[q][3]));
  }
  __syncthreads();
  for (int h = kThreads / 2; h >= 32; h >>= 1) {
    if (t < h) {
#pragma unroll
      for (int q = 0; q < NP; ++q) part[q][t] = __dadd_rn(part[q][t], part[q][t + h]);
    }
    __syncthreads();
  }
  if (t < 32) {
#pragma unroll
    for (int q = 0; q < NP; ++q) {
      double u = part[q][t];
#pragma unroll
      for (int h = 16; h >= 1; h >>= 1) u = __dadd_rn(u, __shfl_down_sync(0xffffffffu, u, h));
      s[q] = u;
    }
  }
}

// One launch of nc = ceil(n / kChunk) CTAs.  CTA k sums chunk k of each row
// of products a_q b_q; with nc > 1 it writes them to work (a counter word,
// then row q's chunk sums at work[1 + q nc + k]) and the last CTA to arrive
// sums them by the same tree, chunk after chunk, until one value a row is
// left (region A: the chunk sums, region B: NP ceil(nc / kChunk) values;
// further stages go back and forth between them).
template <int NP>
__global__ void __launch_bounds__(kThreads) band_dots_kernel(const double* __restrict__ a0,
                                                             const double* __restrict__ b0,
                                                             const double* __restrict__ a1,
                                                             const double* __restrict__ b1,
                                                             const double* __restrict__ a2,
                                                             const double* __restrict__ b2, int n,
                                                             double* work, double* __restrict__ out) {
  __shared__ double part[NP][kThreads];
  __shared__ bool last;
  const double* a[3] = {a0, a1, a2};
  const double* b[3] = {b0, b1, b2};
  const int t = threadIdx.x;
  const int nc = gridDim.x;
  double v[NP][kPerThread];
  double s[NP];
  const long long base = static_cast<long long>(blockIdx.x) * kChunk + t;
#pragma unroll
  for (int q = 0; q < NP; ++q) {
#pragma unroll
    for (int e = 0; e < kPerThread; ++e) {
      const long long j = base + e * kThreads;  // chunk position t + 256 e
      v[q][e] = j < n ? __dmul_rn(__ldg(a[q] + j), __ldg(b[q] + j)) : 0.0;
    }
  }
  chunk_sum<NP>(v, part, s);
  if (nc == 1) {
    if (t == 0) {
#pragma unroll
      for (int q = 0; q < NP; ++q) out[q] = s[q];
    }
    return;
  }
  unsigned int* count = reinterpret_cast<unsigned int*>(work);
  double* src = work + 1;
  double* dst = src + static_cast<long long>(NP) * nc;
  if (t == 0) {
#pragma unroll
    for (int q = 0; q < NP; ++q) src[static_cast<long long>(q) * nc + blockIdx.x] = s[q];
    __threadfence();  // the chunk sums reach the L2 before the arrival
    last = atomicAdd(count, 1u) == static_cast<unsigned int>(nc - 1);
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  int len = nc;
  while (true) {
    const int nc2 = (len + kChunk - 1) / kChunk;
    for (int k = 0; k < nc2; ++k) {
#pragma unroll
      for (int q = 0; q < NP; ++q) {
#pragma unroll
        for (int e = 0; e < kPerThread; ++e) {
          const int j = k * kChunk + t + e * kThreads;
          // L2 reads: other CTAs wrote these values
          v[q][e] = j < len ? __ldcg(src + static_cast<long long>(q) * len + j) : 0.0;
        }
      }
      chunk_sum<NP>(v, part, s);
      if (t == 0) {
#pragma unroll
        for (int q = 0; q < NP; ++q) {
          if (nc2 == 1) {
            out[q] = s[q];
          } else {
            dst[static_cast<long long>(q) * nc2 + k] = s[q];
          }
        }
      }
    }
    if (nc2 == 1) break;
    __syncthreads();  // thread 0's sums are visible to the whole CTA
    double* tmp = src;
    src = dst;
    dst = tmp;
    len = nc2;
  }
  if (t == 0) *count = 0u;
}

template <int NP>
void launch_dots(const double* const* a, const double* const* b, int n, double* work, double* out,
                 cudaStream_t st) {
  const int nc = (n + kChunk - 1) / kChunk;
  band_dots_kernel<NP><<<nc, kThreads, 0, st>>>(a[0], b[0], a[1], b[1], a[2], b[2], n, work, out);
}

// XR or SEL over n values, two a thread by 16-byte loads and stores (the
// last thread of an odd n takes one); the coefficients once a CTA.
template <int MODE>
__global__ void __launch_bounds__(kThreads) band_update_kernel(int sweep, int n, double* sc, double* x,
                                                               const double* ph, const double* sh,
                                                               const double* s, const double* t,
                                                               double* rout, double* xb) {
  __shared__ double coef[2];
  __shared__ bool better;
  if (threadIdx.x == 0) {
    const bool writer = blockIdx.x == 0;
    if constexpr (MODE == MODE_XR) {
      const double omega = __ddiv_rn(sc[TS], safe(sc[TT]));
      coef[0] = sc[ALPHA];
      coef[1] = omega;
      if (writer) {
        sc[OMEGA] = omega;
        sc[RHO] = sc[RHO_NEW];
      }
    } else {
      better = select_best(sc, sweep, writer);
    }
  }
  __syncthreads();
  const long long i = 2LL * (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x);
  if (i >= n) return;
  const bool pair = i + 1 < n;
  if constexpr (MODE == MODE_XR) {
    const double alpha = coef[0], omega = coef[1];
    if (pair) {
      double2 xv = *reinterpret_cast<const double2*>(x + i);
      const double2 pv = *reinterpret_cast<const double2*>(ph + i);
      const double2 hv = *reinterpret_cast<const double2*>(sh + i);
      const double2 sv = *reinterpret_cast<const double2*>(s + i);
      const double2 tv = *reinterpret_cast<const double2*>(t + i);
      xv.x = __dadd_rn(__dadd_rn(xv.x, __dmul_rn(alpha, pv.x)), __dmul_rn(omega, hv.x));
      xv.y = __dadd_rn(__dadd_rn(xv.y, __dmul_rn(alpha, pv.y)), __dmul_rn(omega, hv.y));
      *reinterpret_cast<double2*>(x + i) = xv;
      *reinterpret_cast<double2*>(rout + i) =
          make_double2(__dsub_rn(sv.x, __dmul_rn(omega, tv.x)), __dsub_rn(sv.y, __dmul_rn(omega, tv.y)));
    } else {
      x[i] = __dadd_rn(__dadd_rn(x[i], __dmul_rn(alpha, ph[i])), __dmul_rn(omega, sh[i]));
      rout[i] = __dsub_rn(s[i], __dmul_rn(omega, t[i]));
    }
  } else if (better) {
    if (pair) {
      *reinterpret_cast<double2*>(xb + i) = *reinterpret_cast<const double2*>(x + i);
    } else {
      xb[i] = x[i];
    }
  }
}

dim3 grid_of(long long n, int per_cta) { return dim3(static_cast<unsigned>((n + per_cta - 1) / per_cta)); }

template <int MODE>
void launch_ras(const RasArgs& a, cudaStream_t st) {
  band_ras_kernel<MODE, PHIFEM_BAND_RAS_CHUNK><<<grid_of(a.m, kRasThreads), kRasThreads, 0, st>>>(a);
}

}  // namespace

extern "C" {

// The RAS apply on m band DoFs (device pointers): cols (K, m) int32 and
// vals (K, m) float64 the slot-major table (cuda_band.ras_table), x, c, y
// (m,) float64.  Modes 0-2: y = acc, om acc, c + om acc (c may be y).
// Mode 3 (P) at sweep: x is r, p the old p, v, w the new p (another buffer
// than p), y = ph, sc the NSLOTS scalar slots, xit and xb the iterate and
// the best iterate; mode 4 (S): x is r, v, w = s, y = sh, sc.  Pointers a
// mode does not use may be NULL.  Returns cudaGetLastError()
// (cudaErrorInvalidValue for a bad mode, m, K or sweep, a NULL pointer the
// mode needs, or K m of 2^31 or more).
int phifem_band_ras(const void* cols, const void* vals, const void* x, const void* p, const void* v, const void* c,
                    void* y, void* w, void* sc, const void* xit, void* xb, int m, int K, int sweep, double om,
                    int mode, void* stream) {
  const bool fused = mode == RAS_P || mode == RAS_S;
  if (mode < RAS_APPLY || mode > RAS_S || m < 1 || K < 1 || sweep < 0 || static_cast<long long>(K) * m >= (1LL << 31) ||
      cols == nullptr || vals == nullptr || x == nullptr || y == nullptr || (mode == RAS_ADD && c == nullptr) ||
      (fused && (v == nullptr || w == nullptr || sc == nullptr)) ||
      (mode == RAS_P && (p == nullptr || xit == nullptr || xb == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const RasArgs a{static_cast<const int*>(cols), static_cast<const double*>(vals), static_cast<const double*>(x),
                  static_cast<const double*>(p), static_cast<const double*>(v), static_cast<const double*>(c),
                  static_cast<double*>(y), static_cast<double*>(w), static_cast<double*>(sc),
                  static_cast<const double*>(xit), static_cast<double*>(xb), m, K, sweep, om};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case RAS_APPLY: launch_ras<RAS_APPLY>(a, st); break;
    case RAS_SCALE: launch_ras<RAS_SCALE>(a, st); break;
    case RAS_ADD: launch_ras<RAS_ADD>(a, st); break;
    case RAS_P: launch_ras<RAS_P>(a, st); break;
    default: launch_ras<RAS_S>(a, st); break;
  }
  return static_cast<int>(cudaGetLastError());
}

// y = A x (mode 0) or b - A x (mode 1) on the band matrix of m rows as the
// sliced ELL table (device pointers): cols int32 and vals float64 of the
// stored slots, off (ceil(m / 32) + 1,) int64 slice offsets, len (m,) int32
// stored row lengths, perm (m,) int32 the row of each stored row, x, b and
// y (m,) float64 (b NULL in mode 0); width is the host table's padded
// width.  Returns cudaGetLastError() (cudaErrorInvalidValue for a bad mode,
// m or width).
int phifem_band_ell(const void* cols, const void* vals, const void* off, const void* len, const void* perm,
                    const void* x, const void* b, void* y, int m, int width, int mode, void* stream) {
  if (mode < 0 || mode > 1 || m < 1 || width < 1 || (mode == 1 && b == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>((m + kEllThreads - 1) / kEllThreads));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* c = static_cast<const int*>(cols);
  const double* v = static_cast<const double*>(vals);
  const long long* o = static_cast<const long long*>(off);
  const int* l = static_cast<const int*>(len);
  const int* pm = static_cast<const int*>(perm);
  const double* xx = static_cast<const double*>(x);
  const double* bb = static_cast<const double*>(b);
  double* yy = static_cast<double*>(y);
  constexpr int kNarrow = PHIFEM_BAND_ELL_CHUNK, kWide = PHIFEM_BAND_ELL_WIDE_CHUNK;
  if (mode == 1 && width > kWideRow) {
    band_ell_kernel<true, kWide><<<grid, kEllThreads, 0, st>>>(c, v, o, l, pm, xx, bb, yy, m, width);
  } else if (mode == 1) {
    band_ell_kernel<true, kNarrow><<<grid, kEllThreads, 0, st>>>(c, v, o, l, pm, xx, bb, yy, m, width);
  } else if (width > kWideRow) {
    band_ell_kernel<false, kWide><<<grid, kEllThreads, 0, st>>>(c, v, o, l, pm, xx, bb, yy, m, width);
  } else {
    band_ell_kernel<false, kNarrow><<<grid, kEllThreads, 0, st>>>(c, v, o, l, pm, xx, bb, yy, m, width);
  }
  return static_cast<int>(cudaGetLastError());
}

// out[q] = a_q . b_q for the np (1-3) pairs of float64 vectors of n values,
// by the fixed tree, in one launch; work holds 1 + np (nc + ceil(nc /
// kChunk)) values, nc = ceil(n / kChunk), its first word the arrival
// counter, 0 when the scratch is made and again after every launch (unused
// when nc = 1).
int phifem_band_dots(const void* a0, const void* b0, const void* a1, const void* b1, const void* a2,
                     const void* b2, int np, int n, void* work, void* out, void* stream) {
  if (np < 1 || np > 3 || n < 1 || out == nullptr || (n > kChunk && work == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const double* a[3] = {static_cast<const double*>(a0), static_cast<const double*>(a1),
                        static_cast<const double*>(a2)};
  const double* b[3] = {static_cast<const double*>(b0), static_cast<const double*>(b1),
                        static_cast<const double*>(b2)};
  double* w = static_cast<double*>(work);
  double* o = static_cast<double*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (np == 1) {
    launch_dots<1>(a, b, n, w, o, st);
  } else if (np == 2) {
    launch_dots<2>(a, b, n, w, o, st);
  } else {
    launch_dots<3>(a, b, n, w, o, st);
  }
  return static_cast<int>(cudaGetLastError());
}

// One BiCGStab step outside the RAS launches over n values (device
// pointers, 16-byte aligned): mode 2 (XR) x, ph, sh, s, t, rout; mode 3
// (SEL) at sweep x and xb; sc the NSLOTS scalar slots.  Pointers the mode
// does not use may be NULL.  Returns cudaGetLastError()
// (cudaErrorInvalidValue for a bad mode, n or sweep, a NULL pointer the
// mode needs, or a vector not 16-byte aligned).
int phifem_band_update(int mode, int sweep, int n, void* sc, void* x, const void* ph, const void* sh, const void* s,
                       const void* t, void* rout, void* xb, void* stream) {
  const void* need[6] = {x, ph, sh, s, t, rout};
  const int nneed = mode == MODE_XR ? 6 : 1;
  bool bad = (mode != MODE_XR && mode != MODE_SEL) || n < 1 || sweep < 0 || sc == nullptr ||
             (mode == MODE_SEL && (x == nullptr || xb == nullptr));
  for (int k = 0; k < nneed && !bad; ++k) bad = need[k] == nullptr || reinterpret_cast<uintptr_t>(need[k]) % 16 != 0;
  if (bad || (mode == MODE_SEL && reinterpret_cast<uintptr_t>(xb) % 16 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid = grid_of((static_cast<long long>(n) + 1) / 2, kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  double* scd = static_cast<double*>(sc);
  double* xd = static_cast<double*>(x);
  const double* phd = static_cast<const double*>(ph);
  const double* shd = static_cast<const double*>(sh);
  const double* sd = static_cast<const double*>(s);
  const double* td = static_cast<const double*>(t);
  double* rd = static_cast<double*>(rout);
  double* xbd = static_cast<double*>(xb);
  if (mode == MODE_XR) {
    band_update_kernel<MODE_XR><<<grid, kThreads, 0, st>>>(sweep, n, scd, xd, phd, shd, sd, td, rd, xbd);
  } else {
    band_update_kernel<MODE_SEL><<<grid, kThreads, 0, st>>>(sweep, n, scd, xd, phd, shd, sd, td, rd, xbd);
  }
  return static_cast<int>(cudaGetLastError());
}

// The build's constants, which the wrapper checks: threads per CTA, values
// per dot chunk, scalar slots, rows per ELL slice.
int phifem_band_threads() { return kThreads; }
int phifem_band_chunk() { return kChunk; }
int phifem_band_slots() { return NSLOTS; }
int phifem_band_slice() { return kSlice; }

const char* phifem_band_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"

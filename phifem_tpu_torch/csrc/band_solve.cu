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
// 1. band_ras_kernel: one thread per band DoF i.  Its owner slot s = owner[i]
//    names the block b = s / K and the row k = s % K of the one block entry
//    that corrects it (s = nb K: none, y = 0), and
//        acc = sum over l = 0..K-1 of inv[b, k, l] x[ids[b, l]]
//    in ascending l (a pad id m reads 0).  So the kernel reads one row of K
//    values per DoF, not the (nb, K, K) table of every block entry.  Modes:
//    y = acc, y = om acc, y = c + om acc (the RAS-Richardson inner solve).
//    Bound: device memory, K (8 + 4) bytes per DoF plus x, owner and y.
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
// 4. band_update_kernel: the BiCGStab updates, one mode per launch, each
//    thread computing the step's coefficient from the dot results in the
//    scalar slots with the same guard |d| > 1e-300 ? d : 1e-300 and the same
//    order of operations as the plain version:
//      P:   p = r + beta (p - omega v), beta = (rho_new / rho)(alpha / omega),
//           after the best-iterate select of the previous sweep (sweep 0:
//           p = r and the best residual set to r.r);
//      S:   alpha = rho_new / (rhat.v), s = r - alpha v;
//      XR:  omega = (t.s) / (t.t), x = (x + alpha ph) + omega sh,
//           r' = s - omega t, rho = rho_new;
//      SEL: xb = x where rr is finite and below the best so far.
//    The scalar a launch writes (thread 0) is never one that launch reads;
//    the best residual alternates between two slots by sweep.
//
// Plain C interface, loaded with ctypes (phifem_tpu_torch/ops/cuda_band.py):
// each entry point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>

#include <cmath>

// Build constants, overridden by -D defines only in a tuning script's
// variants (scripts/tune_torch_band.py): the slots one thread of the ELL
// kernel loads a step on a table of width up to kWideRow (CHUNK) and wider
// (WIDE_CHUNK), and the ELL kernel's CTA size.
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
constexpr int kPerThread = 4;
constexpr int kChunk = kThreads * kPerThread;  // values summed by one CTA
constexpr int kSlice = 32;                     // rows of an ELL slice: one warp
constexpr int kEllThreads = PHIFEM_BAND_ELL_THREADS;  // the ELL kernel's CTA: whole slices
constexpr int kWideRow = 32;  // host table widths past this take the wide chunk
static_assert(kEllThreads % kSlice == 0, "an ELL CTA holds whole slices");

// the solve's scalar slots (cuda_band.py: SLOTS)
enum Slot { RR = 0, RHO_NEW, RV, TS, TT, RHO, ALPHA, OMEGA, RRB0, RRB1, NSLOTS };
enum UpdateMode { MODE_P = 0, MODE_S = 1, MODE_XR = 2, MODE_SEL = 3 };

__device__ __forceinline__ double x_at(const double* __restrict__ x, int c, int n_x) {
  // the pad id n_x (and anything outside [0, n_x)) reads as zero
  return static_cast<unsigned>(c) < static_cast<unsigned>(n_x) ? __ldg(x + c) : 0.0;
}

__global__ void __launch_bounds__(kThreads) band_ras_kernel(const double* __restrict__ inv,
                                                             const int* __restrict__ ids,
                                                             const int* __restrict__ owner,
                                                             const double* __restrict__ x, const double* c,
                                                             double* y, int m, int K, int nslots, double om,
                                                             int mode) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= m) return;
  const int s = __ldg(owner + i);
  double acc = 0.0;
  if (static_cast<unsigned>(s) < static_cast<unsigned>(nslots)) {
    const double* row = inv + static_cast<long long>(s) * K;
    const int* blk = ids + static_cast<long long>(s / K) * K;
    acc = __dmul_rn(__ldg(row), x_at(x, __ldg(blk), m));
    for (int l = 1; l < K; ++l) acc = __dadd_rn(acc, __dmul_rn(__ldg(row + l), x_at(x, __ldg(blk + l), m)));
  }
  if (mode == 0) {
    y[i] = acc;
  } else if (mode == 1) {
    y[i] = __dmul_rn(om, acc);
  } else {
    y[i] = __dadd_rn(c[i], __dmul_rn(om, acc));  // c may be y: read before the write
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

__device__ __forceinline__ double safe(double d) { return fabs(d) > 1e-300 ? d : 1e-300; }

// the best-iterate select after sweep j: reads the best residual of slot
// RRB0 + j % 2, writes the new one to the other slot
__device__ __forceinline__ void select_best(double* sc, int j, int i, int n, const double* x, double* xb) {
  const double rr = sc[RR];
  const double rrb = sc[RRB0 + (j & 1)];
  const bool better = isfinite(rr) && rr < rrb;
  if (i == 0) sc[RRB0 + ((j + 1) & 1)] = better ? rr : rrb;
  if (better && i < n) xb[i] = x[i];
}

__global__ void __launch_bounds__(kThreads) band_update_kernel(int mode, int sweep, int n, double* sc,
                                                               const double* r, double* p, const double* v,
                                                               double* s, const double* t, double* x,
                                                               const double* ph, const double* sh, double* xb,
                                                               double* rout) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (mode == MODE_P) {
    if (sweep == 0) {
      if (i == 0) sc[RRB0] = sc[RR];
      if (i < n) p[i] = r[i];
      return;
    }
    select_best(sc, sweep - 1, i, n, x, xb);
    const double omega = sc[OMEGA];
    const double beta = __dmul_rn(__ddiv_rn(sc[RHO_NEW], safe(sc[RHO])), __ddiv_rn(sc[ALPHA], safe(omega)));
    if (i < n) p[i] = __dadd_rn(r[i], __dmul_rn(beta, __dsub_rn(p[i], __dmul_rn(omega, v[i]))));
  } else if (mode == MODE_S) {
    const double alpha = __ddiv_rn(sc[RHO_NEW], safe(sc[RV]));
    if (i == 0) sc[ALPHA] = alpha;
    if (i < n) s[i] = __dsub_rn(r[i], __dmul_rn(alpha, v[i]));
  } else if (mode == MODE_XR) {
    const double alpha = sc[ALPHA];
    const double omega = __ddiv_rn(sc[TS], safe(sc[TT]));
    if (i == 0) {
      sc[OMEGA] = omega;
      sc[RHO] = sc[RHO_NEW];
    }
    if (i < n) {
      x[i] = __dadd_rn(__dadd_rn(x[i], __dmul_rn(alpha, ph[i])), __dmul_rn(omega, sh[i]));
      rout[i] = __dsub_rn(s[i], __dmul_rn(omega, t[i]));
    }
  } else {
    select_best(sc, sweep, i, n, x, xb);
  }
}

dim3 grid_of(int n) { return dim3(static_cast<unsigned>((n + kThreads - 1) / kThreads)); }

}  // namespace

extern "C" {

// y = RAS(x) on m band DoFs (device pointers): inv (nb, K, K) float64, ids
// (nb, K) int32 padded with m, owner (m,) int32 (nb K: no owner), x and y (m,)
// float64; mode 0: y = acc, 1: y = om acc, 2: y = c + om acc (c may be y).
// Returns cudaGetLastError() (cudaErrorInvalidValue for a bad mode, m, nb or
// K, or nb K K of 2^31 or more).
int phifem_band_ras(const void* inv, const void* ids, const void* owner, const void* x, const void* c, void* y,
                    int m, int nb, int K, double om, int mode, void* stream) {
  if (mode < 0 || mode > 2 || m < 1 || nb < 1 || K < 1 || (mode == 2 && c == nullptr) ||
      static_cast<long long>(nb) * K * K >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  band_ras_kernel<<<grid_of(m), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(inv), static_cast<const int*>(ids), static_cast<const int*>(owner),
      static_cast<const double*>(x), static_cast<const double*>(c), static_cast<double*>(y), m, K, nb * K, om, mode);
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

// One BiCGStab update (mode 0-3, see the top of this file) over n values;
// sc holds the NSLOTS scalar slots; pointers a mode does not use may be NULL.
int phifem_band_update(int mode, int sweep, int n, void* sc, const void* r, void* p, const void* v, void* s,
                       const void* t, void* x, const void* ph, const void* sh, void* xb, void* rout, void* stream) {
  if (mode < 0 || mode > 3 || n < 1 || sweep < 0 || sc == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  band_update_kernel<<<grid_of(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      mode, sweep, n, static_cast<double*>(sc), static_cast<const double*>(r), static_cast<double*>(p),
      static_cast<const double*>(v), static_cast<double*>(s), static_cast<const double*>(t),
      static_cast<double*>(x), static_cast<const double*>(ph), static_cast<const double*>(sh),
      static_cast<double*>(xb), static_cast<double*>(rout));
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

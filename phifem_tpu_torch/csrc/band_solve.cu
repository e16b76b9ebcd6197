// The interface band solve's loops, for Hopper: the restricted additive
// Schwarz (RAS) block apply, ordered dot products and the fused updates of
// the fixed-sweep BiCGStab on the cut band.
//
// Replaces the XLA-fused loops of phifem_tpu/mg.py (not a Pallas kernel):
// band_ras (:389-398), the block apply of VCycle._band_correct_flat (:359),
// and the body of _band_bicgstab (:85-139): its dots and its vector updates.
// The band's ELL product (band_mv, :383-387) runs the AMG cycle's ELL kernel
// (csrc/amg_ell.cu) on a slot-major copy of the band matrix.  Used by
// phifem_tpu_torch/ops/cuda_band.py for every Schwarz band: 2D lattice,
// mg_preconditioner, AMG, p-MG's high-degree band, and the 3D schemes'
// lattice_core.make_interface_apply.
//
// All values are float64 (the band tables are, whatever the cycle's dtype),
// and every product, quotient and sum is rounded on its own (__dmul_rn,
// __ddiv_rn, __dadd_rn, __dsub_rn: no FMA contraction), in the order the
// plain versions in cuda_band.py take, so each kernel equals its plain
// version bit for bit.  No atomics and no state kept between launches but
// the solve's scalar slots, which the caller owns.
//
// 1. band_ras_kernel: one thread per band DoF i.  Its owner slot s = owner[i]
//    names the block b = s / K and the row k = s % K of the one block entry
//    that corrects it (s = nb K: none, y = 0), and
//        acc = sum over l = 0..K-1 of inv[b, k, l] x[ids[b, l]]
//    in ascending l (a pad id m reads 0).  So the kernel reads one row of K
//    values per DoF, not the (nb, K, K) table of every block entry.  Modes:
//    y = acc, y = om acc, y = c + om acc (the RAS-Richardson inner solve).
//    Bound: device memory, K (8 + 4) bytes per DoF plus x, owner and y.
// 2. band_dots_kernel: up to three dot products in one pass.  The sum is a
//    fixed tree: the products are cut into chunks of kChunk = 1024 values
//    (the last padded with +0), each chunk summed by halving (v[j] + v[j + h]
//    for h = 512, 256, ..., 1) in one CTA, and the chunk sums summed again
//    the same way by a further launch until one value is left (two launches
//    up to 2^20 values).  The tree is part of the function: the plain
//    version repeats it.  Results go to device memory (no host read).
// 3. band_update_kernel: the BiCGStab updates, one mode per launch, each
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
// each entry point returns cudaGetLastError() after its launches.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;
constexpr int kChunk = kThreads * kPerThread;  // values summed by one CTA

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

// One CTA sums its chunk of kChunk values of each of the NP rows by the
// halving tree; PRODUCTS: value j of row q is a_q[j] b_q[j], else a_q[j] (a
// stage over the chunk sums).  CTA k writes row q's sum to out[q stride + k].
template <int NP, bool PRODUCTS>
__global__ void __launch_bounds__(kThreads) band_dots_kernel(const double* __restrict__ a0,
                                                             const double* __restrict__ b0,
                                                             const double* __restrict__ a1,
                                                             const double* __restrict__ b1,
                                                             const double* __restrict__ a2,
                                                             const double* __restrict__ b2, int n,
                                                             double* __restrict__ out, int stride) {
  __shared__ double part[NP][kThreads];
  const double* a[3] = {a0, a1, a2};
  const double* b[3] = {b0, b1, b2};
  const int t = threadIdx.x;
  const long long base = static_cast<long long>(blockIdx.x) * kChunk + t;
#pragma unroll
  for (int q = 0; q < NP; ++q) {
    double v[kPerThread];
#pragma unroll
    for (int e = 0; e < kPerThread; ++e) {
      const long long j = base + e * kThreads;  // chunk position t + 256 e
      if (j < n) {
        v[e] = PRODUCTS ? __dmul_rn(__ldg(a[q] + j), __ldg(b[q] + j)) : __ldg(a[q] + j);
      } else {
        v[e] = 0.0;
      }
    }
    // h = 512: positions t + 256 e and t + 256 (e + 2); h = 256: t and t + 256
    part[q][t] = __dadd_rn(__dadd_rn(v[0], v[2]), __dadd_rn(v[1], v[3]));
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
      if (t == 0) out[static_cast<long long>(q) * stride + blockIdx.x] = u;
    }
  }
}

template <int NP>
void launch_dots(const double* const* a, const double* const* b, int n, double* work, double* out,
                 cudaStream_t st) {
  int nc = (n + kChunk - 1) / kChunk;
  if (nc == 1) {
    band_dots_kernel<NP, true><<<1, kThreads, 0, st>>>(a[0], b[0], a[1], b[1], a[2], b[2], n, out, 1);
    return;
  }
  band_dots_kernel<NP, true><<<nc, kThreads, 0, st>>>(a[0], b[0], a[1], b[1], a[2], b[2], n, work, nc);
  // the chunk sums, row q at src + q nc, go back and forth between the two
  // regions of work until one value a row is left
  double* src = work;
  double* dst = work + static_cast<long long>(NP) * nc;
  while (nc > 1) {
    const int nc2 = (nc + kChunk - 1) / kChunk;
    double* to = nc2 == 1 ? out : dst;
    const int stride = nc2 == 1 ? 1 : nc2;
    band_dots_kernel<NP, false><<<nc2, kThreads, 0, st>>>(src, nullptr, src + nc, nullptr, src + 2LL * nc, nullptr,
                                                           nc, to, stride);
    double* tmp = src;
    src = dst;
    dst = tmp;
    nc = nc2;
  }
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

// out[q] = a_q . b_q for the np (1-3) pairs of float64 vectors of n values,
// by the fixed tree; work holds np (nc + ceil(nc / kChunk)) values, nc =
// ceil(n / kChunk) (unused when nc = 1).
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
// per dot chunk, scalar slots.
int phifem_band_threads() { return kThreads; }
int phifem_band_chunk() { return kChunk; }
int phifem_band_slots() { return NSLOTS; }

const char* phifem_band_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"

// ELL sweep of the smoothed-aggregation AMG V-cycle, for Hopper.
//
// Replaces the XLA-fused ELL loops of phifem_tpu/amg.py (not a Pallas
// kernel): AMG._mv (:149) and AMG._ell_apply (:153), which apply a level's
// operator, its restriction R = P^T and its prolongation P, and the
// damped-Jacobi sweep AMG._smooth (:157), all inside AMG._cycle (:163).
//
// An ELL matrix of n rows and width w is stored slot-major: cols and vals are
// (w, n) arrays, slot k of row i at [k n + i]; a padded slot has column n_x
// (the length of x) and value 0.  With (A x)_i = sum over k of vals[k, i]
// x[cols[k, i]], x[n_x] read as 0, one launch writes y (n values):
//
//   mode 0 (apply):        y = A x
//   mode 1 (residual):     y = b - A x
//   mode 2 (Jacobi):       y = x + d (b - A x)      (square A, n_x = n)
//   mode 3 (prolong-add):  y = b + A x              (b the base vector: the
//                                                    cycle's x + P e_c)
//
// where d is the level's inverse diagonal already scaled by the damping
// weight omega (rounded to the value type and multiplied once per level, as
// the JAX package's om * inv_diag).  The pad column is handled by a
// predicate on the index: no padded copy of x is made.
//
// Bound: device-memory bandwidth on the fine levels (each nonzero's value
// and int32 column once, x, y and by mode b and d: 4-8 bytes per flop), and
// the launch itself on the coarse ones, whose tables are a few hundred kB
// and stay in the 50 MB L2.  The kernel also reads the padded slots, which
// the ELL format adds (a few on a level's operator, a fifth of its R).
//
// Design.
// * Lane groups: row i is served by L consecutive lanes of a warp (L in
//   1, 2, 4, ..., 32, chosen per table by the caller: ops/cuda_amg.py
//   lanes_for).  Lane j of the group takes slots j, j + L, j + 2L, ...  A
//   narrow fine level runs L = 1, one thread per row; a wide coarse table
//   such as R of 742 rows x 111 slots runs L = 32, so its launch has 23,744
//   threads and not 742.  The slot-major layout keeps the loads coalesced:
//   a warp reads L runs of 32 / L consecutive rows.
// * Loads in flight: a lane takes its slots in chunks of CHUNK (8 in
//   float32, 4 in float64; half that at L = 32).  A chunk's column and value
//   loads are all issued, then all its gathers of x, before the first
//   product is used, so a chunk costs two round trips to memory whatever its
//   width; the usual float32 table (w <= CHUNK L) is one chunk.  Groups of
//   up to 4 lanes (the fine levels' tables) are compiled for 8 CTAs of 256
//   threads per SM, 32 registers a thread, so a launch of ~250k lanes is
//   resident at once; the wide coarse groups keep their registers for
//   their loads in flight.
// * Bits: every lane rounds its own products (__fmul_rn); the group then
//   adds them in ascending slot order, each add rounded on its own, every
//   lane of the group taking slot j + mL from lane j by __shfl_sync.  The
//   chain starts from -0 (x + -0 = x for every x, zeros included), so it is
//   the plain version's acc = p_0, acc = acc + p_k exactly; slots past the
//   width inside a lane's last step contribute -0, which changes nothing.
//   Padded slots multiply 0 x 0 = +0 as the plain version's read of its
//   zero pad does.  No FMA contraction (__fadd_rn / __fsub_rn / __fmul_rn
//   and the double forms), no atomics, no shared memory, no state kept
//   between launches; the first lane of the group writes the row.
// * Tried and dropped: staging the whole of x in each CTA's shared memory by
//   one bulk asynchronous copy (cp.async.bulk on an mbarrier) while the
//   table loads fly, on the coarse levels where x fits.  It was slower on
//   every table of the S1-U n=800 hierarchy (PERF.md §6, the ELL kernel).
//
// Plain C interface, loaded with ctypes (phifem_tpu_torch/ops/cuda_amg.py):
// phifem_amg_ell_sweep returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>

#include <cstdint>

// Build constants, overridden by -D defines only in a tuning script's
// variants (scripts/tune_torch_amg.py): the float32 slots a lane holds in
// flight per chunk (half of it in float64, and half again at 32 lanes), the
// CTAs per SM the register budget of rows of up to 4 lanes is made for (8:
// 32 registers a thread, so the launch of a fine level or of its R, ~170k
// to ~250k lanes, is resident in one wave).
#ifndef PHIFEM_AMG_CHUNK
#define PHIFEM_AMG_CHUNK 8
#endif
#ifndef PHIFEM_AMG_MIN_BLOCKS
#define PHIFEM_AMG_MIN_BLOCKS 8
#endif

namespace {

constexpr int kThreads = 256;

// slots a lane takes per chunk: at most 128 slots of a row per chunk in
// float32 (64 in float64, whose registers are twice as wide)
__host__ __device__ constexpr int chunk_of(int lanes, bool is_double) {
  return PHIFEM_AMG_CHUNK / (lanes == 32 ? 2 : 1) / (is_double ? 2 : 1);
}

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }

template <typename T>
__device__ __forceinline__ T x_at(const T* __restrict__ x, int c, int n_x) {
  // the pad column n_x (and anything outside [0, n_x)) reads as zero
  return static_cast<unsigned>(c) < static_cast<unsigned>(n_x) ? __ldg(x + c) : T(0);
}

template <typename T, int MODE, int L>
__global__ void __launch_bounds__(kThreads, L <= 4 ? PHIFEM_AMG_MIN_BLOCKS : 1) amg_ell_kernel(
    const int* __restrict__ cols, const T* __restrict__ vals, const T* __restrict__ x,
    const T* __restrict__ b, const T* __restrict__ d, T* __restrict__ y, int n, int width, int n_x) {
  constexpr int C = chunk_of(L, sizeof(T) == 8);
  const int t = blockIdx.x * kThreads + threadIdx.x;
  const int i = t / L;  // the row (L is a power of two: a shift)
  const int j = t % L;  // the lane in the row's group
  // every lane stays to the end: the group's lanes meet in __shfl_sync,
  // and a whole group lies past n or none of it does
  const bool live = i < n;
  T acc = T(-0.0);
  for (int k0 = 0; k0 < width; k0 += C * L) {
    int c[C];
    T v[C];
#pragma unroll
    for (int m = 0; m < C; ++m) {
      const int k = k0 + m * L + j;
      const bool on = live && k < width;
      c[m] = on ? __ldg(cols + k * n + i) : n_x;
      v[m] = on ? __ldg(vals + k * n + i) : T(0);
    }
    T p[C];
#pragma unroll
    for (int m = 0; m < C; ++m) {
      const T xv = x_at(x, c[m], n_x);
      p[m] = k0 + m * L + j < width ? mul_rn(v[m], xv) : T(-0.0);
    }
#pragma unroll
    for (int m = 0; m < C; ++m) {
      if (k0 + m * L >= width) break;  // the same for the whole warp
      if constexpr (L == 1) {
        acc = add_rn(acc, p[m]);
      } else {
        T q[L];
#pragma unroll
        for (int s = 0; s < L; ++s) q[s] = __shfl_sync(0xffffffffu, p[m], s, L);
#pragma unroll
        for (int s = 0; s < L; ++s) acc = add_rn(acc, q[s]);
      }
    }
  }
  if (!live || j != 0) return;
  if constexpr (MODE == 0) {
    y[i] = acc;
  } else if constexpr (MODE == 1) {
    y[i] = sub_rn(__ldg(b + i), acc);
  } else if constexpr (MODE == 2) {
    y[i] = add_rn(__ldg(x + i), mul_rn(__ldg(d + i), sub_rn(__ldg(b + i), acc)));
  } else {
    y[i] = add_rn(__ldg(b + i), acc);
  }
}

template <typename T, int MODE, int L>
void launch_lanes(const void* cols, const void* vals, const void* x, const void* b, const void* d, void* y, int n,
                  int width, int n_x, cudaStream_t s) {
  const long long threads = static_cast<long long>(n) * L;
  const dim3 grid(static_cast<unsigned>((threads + kThreads - 1) / kThreads)), block(kThreads);
  const int* c = static_cast<const int*>(cols);
  const T* v = static_cast<const T*>(vals);
  const T* xx = static_cast<const T*>(x);
  const T* bb = static_cast<const T*>(b);
  const T* dd = static_cast<const T*>(d);
  T* yy = static_cast<T*>(y);
  amg_ell_kernel<T, MODE, L><<<grid, block, 0, s>>>(c, v, xx, bb, dd, yy, n, width, n_x);
}

template <typename T, int MODE>
void launch_mode(const void* cols, const void* vals, const void* x, const void* b, const void* d, void* y, int n,
                 int width, int n_x, int lanes, cudaStream_t s) {
  switch (lanes) {
    case 1: launch_lanes<T, MODE, 1>(cols, vals, x, b, d, y, n, width, n_x, s); break;
    case 2: launch_lanes<T, MODE, 2>(cols, vals, x, b, d, y, n, width, n_x, s); break;
    case 4: launch_lanes<T, MODE, 4>(cols, vals, x, b, d, y, n, width, n_x, s); break;
    case 8: launch_lanes<T, MODE, 8>(cols, vals, x, b, d, y, n, width, n_x, s); break;
    case 16: launch_lanes<T, MODE, 16>(cols, vals, x, b, d, y, n, width, n_x, s); break;
    default: launch_lanes<T, MODE, 32>(cols, vals, x, b, d, y, n, width, n_x, s); break;
  }
}

template <typename T>
void launch(const void* cols, const void* vals, const void* x, const void* b, const void* d, void* y, int n,
            int width, int n_x, int mode, int lanes, cudaStream_t s) {
  switch (mode) {
    case 0: launch_mode<T, 0>(cols, vals, x, b, d, y, n, width, n_x, lanes, s); break;
    case 1: launch_mode<T, 1>(cols, vals, x, b, d, y, n, width, n_x, lanes, s); break;
    case 2: launch_mode<T, 2>(cols, vals, x, b, d, y, n, width, n_x, lanes, s); break;
    default: launch_mode<T, 3>(cols, vals, x, b, d, y, n, width, n_x, lanes, s); break;
  }
}

}  // namespace

extern "C" {

// y = sweep(x) for the slot-major ELL matrix (cols, vals) of n rows and width
// slots (device pointers: int32 and the value type), x (n_x values), b (n
// values, modes 1-3) and d (n values, mode 2; NULL otherwise), y (n values),
// each row served by `lanes` lanes.  Returns cudaGetLastError()
// (cudaErrorInvalidValue for a bad mode or lane count, a width below 1, n
// below 1, a Jacobi sweep with n_x != n, or a table of 2^31 slots or lanes
// or more).
int phifem_amg_ell_sweep(const void* cols, const void* vals, const void* x, const void* b, const void* d,
                         void* y, int n, int width, int n_x, int mode, int lanes, int is_double, void* stream) {
  const bool pow2 = lanes >= 1 && lanes <= 32 && (lanes & (lanes - 1)) == 0;
  if (mode < 0 || mode > 3 || !pow2 || width < 1 || n < 1 || n_x < 0 || (mode == 2 && n_x != n) ||
      static_cast<long long>(n) * width >= (1LL << 31) || static_cast<long long>(n) * lanes >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_double) {
    launch<double>(cols, vals, x, b, d, y, n, width, n_x, mode, lanes, s);
  } else {
    launch<float>(cols, vals, x, b, d, y, n, width, n_x, mode, lanes, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// The block size and the slots a lane takes per chunk at `lanes` lanes per
// row and the value type, as this library was built.
int phifem_amg_ell_threads() { return kThreads; }
int phifem_amg_ell_chunk(int lanes, int is_double) { return chunk_of(lanes, is_double != 0); }

const char* phifem_amg_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"

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
//   mode 0 (apply):    y = A x
//   mode 1 (residual): y = b - A x
//   mode 2 (Jacobi):   y = x + d (b - A x)      (square A, n_x = n)
//
// where d is the level's inverse diagonal already scaled by the damping
// weight omega (rounded to the value type and multiplied once per level, as
// the JAX package's om * inv_diag).  The pad column is handled by a
// predicate on the index: no padded copy of x is made.
//
// Bound: device-memory bandwidth.  The function needs each nonzero's value
// and int32 column once, x, b and d (modes 1-2) and y, for 2 flops per
// nonzero: about 4-8 bytes per flop.  The kernel also reads the padded
// slots, which the ELL format adds (a few on a level's operator, a fifth of
// the slots of its R).
//
// Design: one thread per row, rows in consecutive threads.  The slot-major
// layout makes the w loads of vals and cols coalesced across a warp, and
// the loads of x go through the read-only path (__ldg); a row's slots are
// read in ascending k.  Levels are a few hundred thousand rows wide at most,
// so a launch fills the card with threads.  No shared memory, no atomics, no
// state kept between launches.
//
// The sums are those of the plain PyTorch version (ops/cuda_amg.py:
// amg_ell_sweep_ref) bit for bit: acc = vals[0] x[c0], then
// acc = acc + vals[k] x[ck] for k = 1 .. w-1, every product, sum and
// difference rounded on its own (__fmul_rn / __fadd_rn / __fsub_rn and the
// double forms: no FMA contraction), padded slots included (their product is
// 0 x 0 = +0, as the plain version's read of its zero pad).
//
// Plain C interface, loaded with ctypes (phifem_tpu_torch/ops/cuda_amg.py):
// phifem_amg_ell_sweep returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

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

template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads) amg_ell_kernel(
    const int* __restrict__ cols, const T* __restrict__ vals, const T* __restrict__ x,
    const T* __restrict__ b, const T* __restrict__ d, T* __restrict__ y, int n, int width, int n_x) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const size_t stride = static_cast<size_t>(n);
  size_t at = static_cast<size_t>(i);
  T acc = mul_rn(__ldg(vals + at), x_at(x, __ldg(cols + at), n_x));
  for (int k = 1; k < width; ++k) {
    at += stride;
    acc = add_rn(acc, mul_rn(__ldg(vals + at), x_at(x, __ldg(cols + at), n_x)));
  }
  if (MODE == 0) {
    y[i] = acc;
  } else if (MODE == 1) {
    y[i] = sub_rn(__ldg(b + i), acc);
  } else {
    y[i] = add_rn(__ldg(x + i), mul_rn(__ldg(d + i), sub_rn(__ldg(b + i), acc)));
  }
}

template <typename T>
void launch(const void* cols, const void* vals, const void* x, const void* b, const void* d, void* y, int n,
            int width, int n_x, int mode, cudaStream_t s) {
  const dim3 grid((n + kThreads - 1) / kThreads), block(kThreads);
  const int* c = static_cast<const int*>(cols);
  const T* v = static_cast<const T*>(vals);
  const T* xx = static_cast<const T*>(x);
  const T* bb = static_cast<const T*>(b);
  const T* dd = static_cast<const T*>(d);
  T* yy = static_cast<T*>(y);
  if (mode == 0) {
    amg_ell_kernel<T, 0><<<grid, block, 0, s>>>(c, v, xx, bb, dd, yy, n, width, n_x);
  } else if (mode == 1) {
    amg_ell_kernel<T, 1><<<grid, block, 0, s>>>(c, v, xx, bb, dd, yy, n, width, n_x);
  } else {
    amg_ell_kernel<T, 2><<<grid, block, 0, s>>>(c, v, xx, bb, dd, yy, n, width, n_x);
  }
}

}  // namespace

extern "C" {

// y = sweep(x) for the slot-major ELL matrix (cols, vals) of n rows and width
// slots (device pointers: int32 and the value type), x (n_x values), b and d
// (n values, modes 1-2; NULL otherwise), y (n values).  Returns
// cudaGetLastError() (cudaErrorInvalidValue for a bad mode, a width below 1,
// n below 1, a Jacobi sweep with n_x != n or a table of 2^31 slots or more).
int phifem_amg_ell_sweep(const void* cols, const void* vals, const void* x, const void* b, const void* d,
                         void* y, int n, int width, int n_x, int mode, int is_double, void* stream) {
  if (mode < 0 || mode > 2 || width < 1 || n < 1 || n_x < 0 || (mode == 2 && n_x != n) ||
      static_cast<long long>(n) * width >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_double) {
    launch<double>(cols, vals, x, b, d, y, n, width, n_x, mode, s);
  } else {
    launch<float>(cols, vals, x, b, d, y, n, width, n_x, mode, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// The block size this library was built with.
int phifem_amg_ell_threads() { return kThreads; }

const char* phifem_amg_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"

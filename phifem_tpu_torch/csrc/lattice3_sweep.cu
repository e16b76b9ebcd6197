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
// against 2 x 27 flops.
//
// Design (a simple kernel first): one thread per padded node, x fastest, a
// grid-stride loop over the flattened array.  The 27 neighbours of a warp's
// 32 consecutive nodes are 27 shifted runs of 32 consecutive values, which L1
// and L2 serve; there is no shared-memory tile.  The stencil (offsets and
// weights, 27 x 12 bytes) arrives by value in the launch.
//
// The sums are those of the plain PyTorch version (ops/cuda_lattice3.py:
// lattice3_sweep_ref, on ops/lattice3.py:_conv_interior3) bit for bit: the
// terms in the order given, acc = w_0 x_0, acc = acc + w_t x_t, every product
// and sum rounded on its own (no FMA contraction: __fmul_rn / __fadd_rn), the
// weights and s rounded to the value type first, as PyTorch does with a
// Python scalar.
//
// Plain C interface, loaded with ctypes (phifem_tpu_torch/ops/cuda_lattice3.py):
// phifem_lattice3_sweep returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxTerms = 27;
constexpr int kThreads = 256;

struct Terms {
  long long off[kMaxTerms];  // linear offsets in the padded array
  double w[kMaxTerms];
  int n;
};

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }

template <typename T, int MODE, bool MASKED>
__global__ void __launch_bounds__(kThreads)
lattice3_sweep_kernel(const T* __restrict__ x, const T* __restrict__ b,
                      const T* __restrict__ mask, T* __restrict__ out,
                      const Terms terms, int D, int R, int C, double scale) {
  const long long PC = C + 2, PR = R + 2;
  const long long plane = PR * PC;
  const long long total = (long long)(D + 2) * plane;
  const T s = static_cast<T>(scale);
  for (long long p = blockIdx.x * (long long)blockDim.x + threadIdx.x; p < total;
       p += (long long)gridDim.x * blockDim.x) {
    const int pd = static_cast<int>(p / plane);
    const long long rem = p - pd * plane;
    const int pr = static_cast<int>(rem / PC);
    const int pc = static_cast<int>(rem - pr * PC);
    const bool interior = pd >= 2 && pd <= D - 1 && pr >= 2 && pr <= R - 1 &&
                          pc >= 2 && pc <= C - 1;
    if (!interior) {
      out[p] = MODE == 2 ? x[p] : T(0);
      continue;
    }
    T acc = mul_rn(static_cast<T>(terms.w[0]), x[p + terms.off[0]]);
    for (int t = 1; t < terms.n; ++t) {
      acc = add_rn(acc, mul_rn(static_cast<T>(terms.w[t]), x[p + terms.off[t]]));
    }
    if (MODE == 0) {
      out[p] = acc;
      continue;
    }
    T r = sub_rn(b[p], acc);
    if (MODE == 2) r = mul_rn(s, r);
    if (MASKED) {
      const long long m = ((long long)(pd - 1) * R + (pr - 1)) * C + (pc - 1);
      r = mul_rn(r, mask[m]);
    }
    out[p] = MODE == 2 ? add_rn(x[p], r) : r;
  }
}

template <typename T, int MODE>
void launch_mode(const T* x, const T* b, const T* mask, T* out, const Terms& terms,
                 int D, int R, int C, double scale, cudaStream_t stream) {
  const long long total = (long long)(D + 2) * (R + 2) * (C + 2);
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 132 * 32) blocks = 132 * 32;  // grid-stride beyond 32 CTAs per SM
  if (mask != nullptr) {
    lattice3_sweep_kernel<T, MODE, true><<<(int)blocks, kThreads, 0, stream>>>(
        x, b, mask, out, terms, D, R, C, scale);
  } else {
    lattice3_sweep_kernel<T, MODE, false><<<(int)blocks, kThreads, 0, stream>>>(
        x, b, nullptr, out, terms, D, R, C, scale);
  }
}

template <typename T>
void dispatch(const void* x, const void* b, const void* mask, void* out,
              const Terms& terms, int D, int R, int C, double scale, int mode,
              cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const T* bt = static_cast<const T*>(b);
  const T* mt = static_cast<const T*>(mask);
  T* ot = static_cast<T*>(out);
  if (mode == 0) {
    launch_mode<T, 0>(xt, bt, nullptr, ot, terms, D, R, C, scale, stream);
  } else if (mode == 1) {
    launch_mode<T, 1>(xt, bt, mt, ot, terms, D, R, C, scale, stream);
  } else {
    launch_mode<T, 2>(xt, bt, mt, ot, terms, D, R, C, scale, stream);
  }
}

}  // namespace

extern "C" {

// out = sweep(x) on the padded (D+2, R+2, C+2) arrays x, b, out (device
// pointers; b unused in mode 0) with the optional logical (D, R, C) mask
// (device pointer or NULL; ignored in mode 0).  offs: HOST pointer to
// nterms * 3 ints (oz, oy, ox in {0, 1, 2}); w: HOST pointer to nterms
// doubles.  Returns cudaGetLastError() (cudaErrorInvalidValue for a bad
// mode or term count).
int phifem_lattice3_sweep(const void* x, const void* b, const void* mask, void* out,
                          int D, int R, int C, const int* offs, const double* w,
                          int nterms, double scale, int mode, int is_double,
                          void* stream) {
  if (nterms < 1 || nterms > kMaxTerms || mode < 0 || mode > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Terms terms;
  const long long PC = C + 2, PR = R + 2;
  for (int t = 0; t < kMaxTerms; ++t) {
    if (t < nterms) {
      terms.off[t] = (offs[3 * t] - 1) * PR * PC + (offs[3 * t + 1] - 1) * PC + (offs[3 * t + 2] - 1);
      terms.w[t] = w[t];
    } else {
      terms.off[t] = 0;
      terms.w[t] = 0.0;
    }
  }
  terms.n = nterms;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_double) {
    dispatch<double>(x, b, mask, out, terms, D, R, C, scale, mode, s);
  } else {
    dispatch<float>(x, b, mask, out, terms, D, R, C, scale, mode, s);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* phifem_lattice3_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

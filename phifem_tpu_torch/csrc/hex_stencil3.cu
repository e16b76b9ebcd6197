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
// write y once: 24 B per node in float64 against 128 flops); at d = 2, 3 the
// arithmetic comes close to it (nloc^2 multiply-adds per cell: 4,096 at d = 3,
// about 34 flops per byte of x in float64).
//
// Design (a simple kernel first): one thread per output node, a grid-stride
// loop over the flattened lattice, no atomics.  A thread finds its incident
// cells per axis in closed form (a coordinate v with v mod d != 0 lies in one
// cell at offset v mod d; a multiple of d in up to two, offsets 0 and d) and
// walks them in ascending local index i, the order in which the JAX package's
// slice loop adds them; each row dot runs in ascending j.  A is staged in
// shared memory once per CTA (64 x 64 doubles = 32 KB at d = 3, too large for
// kernel parameters); the grid is capped so that few CTAs load it.  The mask
// travels as the cell tensor in the value type, as in 2D; a cell whose mask is
// 0 is skipped.
//
// The sums are those of the plain PyTorch version (ops/cuda_hex3.py:
// hex_stencil3_ref) bit for bit, up to the sign of a zero: every product and
// sum is rounded on its own (__dmul_rn / __dadd_rn, no FMA contraction).
//
// Plain C interface, loaded with ctypes (phifem_tpu_torch/ops/cuda_hex3.py):
// phifem_hex_stencil3 returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

// the cells (index, local offset) along one axis that contain coordinate v,
// in ascending offset; returns their number (1 or 2, 0 never for a valid v)
template <int DEG>
__device__ __forceinline__ int axis_cells(int v, int ncell, int* c, int* o) {
  const int q = v / DEG, r = v - q * DEG;
  if (r != 0) {
    c[0] = q;
    o[0] = r;
    return 1;
  }
  int n = 0;
  if (q < ncell) {
    c[n] = q;
    o[n] = 0;
    ++n;
  }
  if (q >= 1) {
    c[n] = q - 1;
    o[n] = DEG;
    ++n;
  }
  return n;
}

template <typename T, int DEG>
__global__ void __launch_bounds__(kThreads)
hex_stencil3_kernel(const T* __restrict__ x, T* __restrict__ y,
                    const T* __restrict__ mask, const T* __restrict__ A,
                    int nx, int ny, int nz) {
  constexpr int P = DEG + 1;
  constexpr int NLOC = P * P * P;
  __shared__ T sA[NLOC * NLOC];
  for (int k = threadIdx.x; k < NLOC * NLOC; k += blockDim.x) sA[k] = A[k];
  __syncthreads();

  const int C = DEG * nx + 1, R = DEG * ny + 1, D = DEG * nz + 1;
  const int plane = R * C;
  const int total = D * plane;
  for (int p = blockIdx.x * blockDim.x + threadIdx.x; p < total; p += gridDim.x * blockDim.x) {
    const int z = p / plane;
    const int rem = p - z * plane;
    const int yy = rem / C;
    const int xx = rem - yy * C;
    int cz[2], oz[2], cy[2], oy[2], cx[2], ox[2];
    const int nzc = axis_cells<DEG>(z, nz, cz, oz);
    const int nyc = axis_cells<DEG>(yy, ny, cy, oy);
    const int nxc = axis_cells<DEG>(xx, nx, cx, ox);
    T acc = T(0);
    for (int a = 0; a < nzc; ++a) {
      for (int b = 0; b < nyc; ++b) {
        for (int c = 0; c < nxc; ++c) {
          const T m = mask[(cz[a] * ny + cy[b]) * nx + cx[c]];
          if (m == T(0)) continue;
          const int i = (oz[a] * P + oy[b]) * P + ox[c];
          const T* row = sA + i * NLOC;
          const T* xc = x + (DEG * cz[a] * R + DEG * cy[b]) * C + DEG * cx[c];
          T s = T(0);
#pragma unroll
          for (int jz = 0; jz < P; ++jz) {
#pragma unroll
            for (int jy = 0; jy < P; ++jy) {
#pragma unroll
              for (int jx = 0; jx < P; ++jx) {
                const int j = (jz * P + jy) * P + jx;
                const T t = mul_rn(row[j], xc[(jz * R + jy) * C + jx]);
                s = j == 0 ? t : add_rn(s, t);
              }
            }
          }
          acc = add_rn(acc, mul_rn(m, s));
        }
      }
    }
    y[p] = acc;
  }
}

template <typename T, int DEG>
void launch(const void* x, void* y, const void* mask, const void* A, int nx, int ny,
            int nz, cudaStream_t stream) {
  const long long total = (long long)(DEG * nz + 1) * (DEG * ny + 1) * (DEG * nx + 1);
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 132 * 8) blocks = 132 * 8;  // grid-stride: A is staged by few CTAs
  hex_stencil3_kernel<T, DEG><<<(int)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), static_cast<const T*>(mask),
      static_cast<const T*>(A), nx, ny, nz);
}

template <typename T>
int dispatch(const void* x, void* y, const void* mask, const void* A, int nx, int ny,
             int nz, int degree, cudaStream_t stream) {
  switch (degree) {
    case 1: launch<T, 1>(x, y, mask, A, nx, ny, nz, stream); return 0;
    case 2: launch<T, 2>(x, y, mask, A, nx, ny, nz, stream); return 0;
    case 3: launch<T, 3>(x, y, mask, A, nx, ny, nz, stream); return 0;
    default: return 1;
  }
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
  if (bad) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

const char* phifem_hex3_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

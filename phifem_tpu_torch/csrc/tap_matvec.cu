// Tap-form lattice operator matvec, for Hopper.
//
// Replaces the per-tap loop of phifem_tpu/ops/taps.py:TapOperator.make_matvec
// (taps.py:305-320), which XLA fuses into shifted-slice arithmetic; it is not
// a Pallas kernel.  Over all taps t = (bi, bj, dr, dc):
//
//   y[bi][r, c, ki] = sum_t sum_kj W_t[r, c, ki, kj] * x[bj][r + dr, c + dc, kj]
//
// where a source point outside block bj's own (R_j, C_j) lattice reads zero.
// Block lattices differ in shape (a P1 vertex lattice is (ny+1, nx+1), a DG0
// cell lattice (ny, nx)), so validity is tested against the SOURCE block's
// shape; nothing is clamped and there is no padded copy of x.
//
// Layout.  W is the JAX package's flat buffer: tap t's (R_i, C_i, vi, vj)
// plane row-major from woff_t (64-bit: S1 at n=3200 holds 348M weights).  A
// block is addressed inside its field's tensor as
//   field[(r * C + c) * stride + sub + k],
// stride = nblocks * vsz and sub = o * vsz, so the two orientation blocks of a
// triangle DG0 field (cells interleave 2 * block + o) are read and written in
// place, without decomposing the field into contiguous copies.
//
// Design.  One thread per output (target block, r, c, ki), threads numbered
// along the flat output of each block, so neighbouring threads read
// neighbouring W entries and neighbouring x points.  Each thread loops over
// the taps of its target block, read from a small device table (bj, dr, dc,
// woff) sorted by target block; the per-block descriptors (pointers, shapes,
// strides, tap range, first output) arrive by value in the launch.  Each
// output is written once, so y needs no zeroing and no atomics: the result
// is deterministic.  f32 and f64.
//
// Bound: device-memory bandwidth, by W.  Each weight is read once per matvec
// (8 B in f64, 4 B in f32; S1 n=3200: 2.8 GB in f64), against 2 flops; x is
// read once from DRAM and the other taps' reads of it hit L2; y is written
// once.  Nearly all of W is zero outside the cut band: a band-restricted W is
// the way to fewer bytes, later work.
//
// Plain C interface, loaded with ctypes (phifem_tpu_torch/ops/cuda_taps.py):
// phifem_tap_matvec returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxBlocks = 16;
constexpr int kDescFields = 10;  // per block, see phifem_tap_matvec

struct Blk {
  const void* x;
  void* y;
  long long out_begin;  // first flat output of this block
  int R, C, vsz, stride, sub, tap_begin, tap_end;
};

struct Params {
  Blk blk[kMaxBlocks];
  int nblocks;
};

template <typename T>
__global__ void __launch_bounds__(256)
tap_matvec_kernel(const Params p, const long long* __restrict__ taps,
                  const T* __restrict__ W, long long total) {
  const long long gid = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (gid >= total) return;
  int b = 0;
  while (b + 1 < p.nblocks && gid >= p.blk[b + 1].out_begin) ++b;
  const Blk& B = p.blk[b];
  const long long local = gid - B.out_begin;  // (r * C + c) * vsz + ki
  const int ki = static_cast<int>(local % B.vsz);
  const long long rc = local / B.vsz;
  const int c = static_cast<int>(rc % B.C);
  const int r = static_cast<int>(rc / B.C);
  T acc = T(0);
  for (int t = B.tap_begin; t < B.tap_end; ++t) {
    const long long* row = taps + 4 * t;  // bj, dr, dc, woff
    const Blk& S = p.blk[row[0]];
    const int rr = r + static_cast<int>(row[1]);
    const int cc = c + static_cast<int>(row[2]);
    if (rr < 0 || rr >= S.R || cc < 0 || cc >= S.C) continue;
    const T* xs = static_cast<const T*>(S.x) +
                  (static_cast<long long>(rr) * S.C + cc) * S.stride + S.sub;
    const T* w = W + row[3] + local * S.vsz;  // ((r*C + c)*vi + ki)*vj
    for (int kj = 0; kj < S.vsz; ++kj) acc += w[kj] * xs[kj];
  }
  static_cast<T*>(B.y)[rc * B.stride + B.sub + ki] = acc;
}

}  // namespace

extern "C" {

// blocks: HOST pointer to nblocks * 10 int64 per block:
//   x ptr, y ptr, R, C, vsz, stride, sub, tap_begin, tap_end, out_begin
// (x, y: device pointers into the fields' tensors).  taps: DEVICE pointer to
// (ntaps, 4) int64 rows (bj, dr, dc, woff), sorted by target block.  W: device
// pointer in the type of x.  total: the number of outputs (sum R*C*vsz).
// is_double selects double (1) or float (0).  Returns cudaGetLastError(), or
// cudaErrorInvalidValue when nblocks exceeds kMaxBlocks.
int phifem_tap_matvec(const long long* blocks, int nblocks, const long long* taps,
                      const void* W, long long total, int is_double, void* stream) {
  if (nblocks < 1 || nblocks > kMaxBlocks) return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.nblocks = nblocks;
  for (int b = 0; b < nblocks; ++b) {
    const long long* d = blocks + kDescFields * b;
    p.blk[b].x = reinterpret_cast<const void*>(d[0]);
    p.blk[b].y = reinterpret_cast<void*>(d[1]);
    p.blk[b].R = static_cast<int>(d[2]);
    p.blk[b].C = static_cast<int>(d[3]);
    p.blk[b].vsz = static_cast<int>(d[4]);
    p.blk[b].stride = static_cast<int>(d[5]);
    p.blk[b].sub = static_cast<int>(d[6]);
    p.blk[b].tap_begin = static_cast<int>(d[7]);
    p.blk[b].tap_end = static_cast<int>(d[8]);
    p.blk[b].out_begin = d[9];
  }
  if (total <= 0) return static_cast<int>(cudaGetLastError());
  const int threads = 256;
  const unsigned int grid = static_cast<unsigned int>((total + threads - 1) / threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_double) {
    tap_matvec_kernel<double><<<grid, threads, 0, s>>>(
        p, taps, static_cast<const double*>(W), total);
  } else {
    tap_matvec_kernel<float><<<grid, threads, 0, s>>>(
        p, taps, static_cast<const float*>(W), total);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* phifem_tap_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

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
// shape; nothing is clamped and there is no padded copy of x in device memory.
//
// Layout.  W is the JAX package's flat buffer: tap t's (R_i, C_i, vi, vj)
// plane row-major from woff_t (64-bit: S1 at n=3200 holds 348M weights).  A
// block is addressed inside its field's tensor as
//   field[(r * C + c) * stride + sub + k],
// stride = nblocks * vsz and sub = o * vsz, so the two orientation blocks of a
// triangle DG0 field (cells interleave 2 * block + o) are read and written in
// place, without decomposing the field into contiguous copies.
//
// Bound.  W is dense, but nearly all of it is zero by construction: only the
// weights of the cut band's entities can be nonzero (TapOperator.support; S1
// at n=3200 516,606 of 348M).  The least work is to read those weights, x
// once, and to write y once: at S1 n=3200 332 MB in f64 (4 MB of weights,
// 164 MB each of x and y), 0.099 ms at 3.35 TB/s.  The kernel reads x only in
// the windows of the active tiles, but it reads whole tile rows of W there
// (~65 MB in f64 at S1 n=3200), and it writes all of y.
//
// Design.  Each block lattice is cut into output tiles of kTileR x kTileC
// lattice points, numbered block by block, row-major.  A host-built CSR table
// (phifem_tpu_torch/ops/cuda_taps.py:tile_table) lists, per tile, the taps
// with at least one supported weight there, in the order of the tap table
// (sorted by target block, stable in t).  The launch has two kinds of CTA,
// the first kind first:
//
// * One CTA per tile with an active tap (1,959 of 81,002 at S1 n=3200).  It
//   stages the tile's tap rows in shared memory and, with the same loads in
//   flight, the x window of the tile plus a halo of `pad` points of every
//   source block its target reads, zero outside the source's own shape (the
//   bounds check of each read moves here).  Warp w then takes row w, one
//   lattice point a thread, and walks only the active taps, Unroll at a time
//   (16 where every block is scalar, 4 with 2-channel blocks, 2 with 3- or
//   4-channel blocks, so that the Unroll x MaxCh x MaxCh weights in flight
//   stay at 16 or 32 values): their weights are loaded into registers first
//   (independent loads in flight), then summed.  A warp reads a tap's W row
//   segment as 32 consecutive points.  S5's five blocks of 2 / 2 / 4 / 4 / 2
//   channels make an x window of (8 + 4) x (32 + 4) points x 14 channels,
//   48.4 KB in f64: above 32 KB the launch opts in to more dynamic shared
//   memory.
//   cp.async.bulk / TMA is not used: it wants 16-byte-aligned source
//   addresses, and a tile row of a tap plane starts at an arbitrary element.
// * One CTA per work item of zero runs: the host lists, per field tensor, the
//   maximal runs of elements that no active tile covers (cuda_taps.py:
//   zero_runs), cut at 8192 elements and packed into items of about 8192
//   elements.  A CTA stages its runs and writes each with 16-byte stores of
//   all its threads, peeling the unaligned head and tail; this reads nothing
//   else, and it covers the interleaved DG0 blocks too.  (Zeroing tile by
//   tile, warp by warp, would spend more time on each tile's index
//   arithmetic than on its stores.)
//
// Every output has one writer, no atomics.  Each output sums its tile's
// active taps in ascending order with the same acc += w * x chain as a walk
// over every tap of its target block: a skipped tap's weights are exact
// zeros there, and a zero x from the window adds an exact zero, so the result
// is the same bit for bit (up to the sign of zero).  f32 and f64.
//
// Plain C interface, loaded with ctypes (phifem_tpu_torch/ops/cuda_taps.py):
// phifem_tap_matvec returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxBlocks = 16;
constexpr int kMaxCh = 4;  // channels per block lattice (2D tensor P1)
constexpr int kDescFields = 11;  // per block, see phifem_tap_matvec
constexpr int kTileR = 8;  // lattice rows per tile: one warp each
constexpr int kTileC = 32;  // lattice columns per tile: one lane each
constexpr int kThreads = kTileR * kTileC;
constexpr int kStage = kThreads;  // tap rows (or zero runs) staged in shared memory at once

struct Blk {
  const void* x;
  void* y;
  long long tile_base;  // first tile of this block
  int R, C, vsz, stride, sub;
  int ntc;  // tiles per row of tiles
  int src_mask;  // source blocks read by this block's taps (bit per block)
  int win_off;  // offset of this block's x window in shared memory, or -1
};

struct Params {
  Blk blk[kMaxBlocks];
  int nblocks;
  int pad;
};

// Zeros y[0:n] by the whole CTA: 16-byte stores, the unaligned head and
// tail element by element.
template <typename T>
__device__ __forceinline__ void zero_cta(T* y, int n) {
  constexpr int kPer = 16 / static_cast<int>(sizeof(T));
  int head = static_cast<int>(((16 - (reinterpret_cast<uintptr_t>(y) & 15)) & 15) / sizeof(T));
  if (head > n) head = n;
  if (static_cast<int>(threadIdx.x) < head) y[threadIdx.x] = T(0);
  T* body = y + head;
  const int m = n - head;
  const int nvec = m / kPer;
  float4* v = reinterpret_cast<float4*>(body);
  for (int i = threadIdx.x; i < nvec; i += kThreads) v[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int e = nvec * kPer + threadIdx.x; e < m; e += kThreads) body[e] = T(0);
}

// CTAs [0, nactive) own one active tile each (act[blockIdx.x]); CTA
// nactive + w zeros the runs work_ptr[w] .. work_ptr[w + 1] of `runs`.
template <typename T, int MaxCh, int Unroll>
__global__ void __launch_bounds__(kThreads)
tap_matvec_kernel(const Params p, const long long* __restrict__ taps,
                  const int* __restrict__ tile_ptr, const int* __restrict__ tile_taps,
                  const int* __restrict__ act, int nactive, const long long* __restrict__ runs,
                  const int* __restrict__ work_ptr, const T* __restrict__ W) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* win = reinterpret_cast<T*>(smem_raw);
  __shared__ long long s_woff[kStage];  // per staged tap: W offset (per run: start),
  __shared__ int s_delta[kStage];  // its x window offset less the point's (block),
  __shared__ int s_vj[kStage];  // its source channels (length)
  const int ty = threadIdx.x >> 5, tx = threadIdx.x & 31;

  if (static_cast<int>(blockIdx.x) >= nactive) {  // zeros, nothing read but the runs
    const int w = blockIdx.x - nactive;
    const int j0 = work_ptr[w], nj = work_ptr[w + 1] - j0;
    if (static_cast<int>(threadIdx.x) < nj) {
      const long long* run = runs + 3 * (j0 + threadIdx.x);  // block, start, length
      s_delta[threadIdx.x] = static_cast<int>(run[0]);
      s_woff[threadIdx.x] = run[1];
      s_vj[threadIdx.x] = static_cast<int>(run[2]);
    }
    __syncthreads();
    for (int j = 0; j < nj; ++j)
      zero_cta(static_cast<T*>(p.blk[s_delta[j]].y) + s_woff[j], s_vj[j]);
    return;
  }

  const long long tile = act[blockIdx.x];
  int b = 0;
  while (b + 1 < p.nblocks && tile >= p.blk[b + 1].tile_base) ++b;
  const Blk& B = p.blk[b];
  const int lt = static_cast<int>(tile - B.tile_base);
  const int r0 = (lt / B.ntc) * kTileR, c0 = (lt % B.ntc) * kTileC;
  const int r = r0 + ty, c = c0 + tx;
  const int beg = tile_ptr[tile], end = tile_ptr[tile + 1];
  const int pad = p.pad;
  const int WC = kTileC + 2 * pad;
  const int npts = (kTileR + 2 * pad) * WC;
  const bool inside = r < B.R && c < B.C;
  const int vi = MaxCh == 1 ? 1 : B.vsz;
  const long long pt = static_cast<long long>(r) * B.C + c;  // lattice point
  const int wq = (ty + pad) * WC + (tx + pad);  // its window point
  T acc[MaxCh];
#pragma unroll
  for (int ki = 0; ki < MaxCh; ++ki) acc[ki] = T(0);

  for (int k0 = beg; k0 < end; k0 += kStage) {
    const int m = min(kStage, end - k0);
    if (k0 > beg) __syncthreads();  // the previous stage is read
    // the stage's tap rows, and (first stage) the x windows of every source
    // block this block reads: rows r0-pad .. r0+kTileR-1+pad, columns
    // c0-pad .. c0+kTileC-1+pad, zero outside; all loads in flight together
    if (static_cast<int>(threadIdx.x) < m) {
      const long long* row = taps + 4 * tile_taps[k0 + threadIdx.x];  // bj, dr, dc, woff
      const int bj = static_cast<int>(row[0]);
      const int vj = MaxCh == 1 ? 1 : p.blk[bj].vsz;
      s_woff[threadIdx.x] = row[3];
      s_delta[threadIdx.x] = p.blk[bj].win_off + (static_cast<int>(row[1]) * WC + static_cast<int>(row[2])) * vj;
      s_vj[threadIdx.x] = vj;
    }
    if (k0 == beg) {
      for (int s = 0; s < p.nblocks; ++s) {
        if (!((B.src_mask >> s) & 1)) continue;
        const Blk& S = p.blk[s];
        const T* xs = static_cast<const T*>(S.x);
        T* ws = win + S.win_off;
        for (int q = threadIdx.x; q < npts * S.vsz; q += kThreads) {
          const int pq = q / S.vsz, k = q - pq * S.vsz;
          const int rr = r0 - pad + pq / WC, cc = c0 - pad + pq % WC;
          T v = T(0);
          if (rr >= 0 && rr < S.R && cc >= 0 && cc < S.C)
            v = xs[(static_cast<long long>(rr) * S.C + cc) * S.stride + S.sub + k];
          ws[q] = v;
        }
      }
    }
    __syncthreads();
    if (!inside) continue;
    for (int k = 0; k < m; k += Unroll) {
      T wv[Unroll][MaxCh][MaxCh];
      const T* xv[Unroll];
      int vj[Unroll];
#pragma unroll
      for (int u = 0; u < Unroll; ++u) {
        vj[u] = 0;
        if (k + u < m) {
          vj[u] = s_vj[k + u];
          const T* w = W + s_woff[k + u] + pt * (vi * vj[u]);  // ((r*C + c)*vi + ki)*vj + kj
#pragma unroll
          for (int ki = 0; ki < MaxCh; ++ki)
#pragma unroll
            for (int kj = 0; kj < MaxCh; ++kj)
              if (ki < vi && kj < vj[u]) wv[u][ki][kj] = __ldg(w + ki * vj[u] + kj);
          xv[u] = win + wq * vj[u] + s_delta[k + u];
        }
      }
#pragma unroll
      for (int u = 0; u < Unroll; ++u) {
#pragma unroll
        for (int ki = 0; ki < MaxCh; ++ki) {
#pragma unroll
          for (int kj = 0; kj < MaxCh; ++kj) {
            if (ki < vi && kj < vj[u]) acc[ki] += wv[u][ki][kj] * xv[u][kj];
          }
        }
      }
    }
  }
  if (!inside) return;
  T* yp = static_cast<T*>(B.y) + pt * B.stride + B.sub;
#pragma unroll
  for (int ki = 0; ki < MaxCh; ++ki)
    if (ki < vi) yp[ki] = acc[ki];
}

template <typename T, int MaxCh, int Unroll>
cudaError_t launch(const Params& p, const long long* taps, const int* tile_ptr,
                   const int* tile_taps, const int* act, int nactive, const long long* runs,
                   const int* work_ptr, int nwork, const void* W, int win_elems, cudaStream_t s) {
  const size_t smem = static_cast<size_t>(win_elems) * sizeof(T);
  if (smem > 32 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(tap_matvec_kernel<T, MaxCh, Unroll>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const unsigned int grid = static_cast<unsigned int>(nactive + nwork);
  tap_matvec_kernel<T, MaxCh, Unroll><<<grid, kThreads, smem, s>>>(
      p, taps, tile_ptr, tile_taps, act, nactive, runs, work_ptr, static_cast<const T*>(W));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_any(const Params& p, int maxch, const long long* taps, const int* tile_ptr,
                       const int* tile_taps, const int* act, int nactive, const long long* runs,
                       const int* work_ptr, int nwork, const void* W, int win_elems,
                       cudaStream_t s) {
  // each instantiation gives an output the same acc += w * x chain (taps
  // ascending, kj ascending within a tap), so a 2-channel operator sums the
  // same way whichever of the last two it would run
  if (maxch == 1)
    return launch<T, 1, 16>(p, taps, tile_ptr, tile_taps, act, nactive, runs, work_ptr, nwork, W,
                            win_elems, s);
  if (maxch == 2)
    return launch<T, 2, 4>(p, taps, tile_ptr, tile_taps, act, nactive, runs, work_ptr, nwork, W,
                           win_elems, s);
  return launch<T, kMaxCh, 2>(p, taps, tile_ptr, tile_taps, act, nactive, runs, work_ptr, nwork,
                              W, win_elems, s);
}

}  // namespace

extern "C" {

// blocks: HOST pointer to nblocks * 11 int64 per block:
//   x ptr, y ptr, R, C, vsz, stride, sub, tile_base, ntc, src_mask, win_off
// (x, y: device pointers into the fields' tensors).  W: device pointer in
// the type of x; is_double selects double (1) or float (0); stream: the
// CUDA stream of the launch.  The arguments after these depend on the
// operator alone, so the wrapper keeps them from call to call.  taps: DEVICE
// pointer to (ntaps, 4) int64 rows (bj, dr, dc, woff), sorted by target block.
// tile_ptr (ntiles + 1) and tile_taps: DEVICE int32 CSR of each tile's active
// rows of taps, ascending; act: DEVICE int32 ids of the nactive tiles with an
// active tap, ascending.  runs: DEVICE (nruns, 3) int64 (block, start, length)
// runs of the fields' tensors outside the active tiles, the tensor being
// block's y; work_ptr: DEVICE int32 (nwork + 1), at most kStage runs per
// work item.  win_elems: elements of shared memory for the x windows (sum
// over source blocks of (kTileR + 2 pad) (kTileC + 2 pad) vsz).  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for arguments the kernel does
// not take.
int phifem_tap_matvec(const long long* blocks, const void* W, int is_double, void* stream,
                      int nblocks, int pad, const long long* taps, const int* tile_ptr,
                      const int* tile_taps, const int* act, int nactive, const long long* runs,
                      const int* work_ptr, int nwork, int win_elems) {
  if (nblocks < 1 || nblocks > kMaxBlocks || pad < 0 || nactive < 0 || nwork < 0 ||
      static_cast<long long>(nactive) + nwork > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.nblocks = nblocks;
  p.pad = pad;
  for (int b = 0; b < nblocks; ++b) {
    const long long* d = blocks + kDescFields * b;
    p.blk[b].x = reinterpret_cast<const void*>(d[0]);
    p.blk[b].y = reinterpret_cast<void*>(d[1]);
    p.blk[b].R = static_cast<int>(d[2]);
    p.blk[b].C = static_cast<int>(d[3]);
    p.blk[b].vsz = static_cast<int>(d[4]);
    p.blk[b].stride = static_cast<int>(d[5]);
    p.blk[b].sub = static_cast<int>(d[6]);
    p.blk[b].tile_base = d[7];
    p.blk[b].ntc = static_cast<int>(d[8]);
    p.blk[b].src_mask = static_cast<int>(d[9]);
    p.blk[b].win_off = static_cast<int>(d[10]);
    if (p.blk[b].vsz < 1 || p.blk[b].vsz > kMaxCh) return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nactive + nwork == 0) return static_cast<int>(cudaGetLastError());
  int maxch = 1;
  for (int b = 0; b < nblocks; ++b) maxch = p.blk[b].vsz > maxch ? p.blk[b].vsz : maxch;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      is_double ? launch_any<double>(p, maxch, taps, tile_ptr, tile_taps, act, nactive, runs,
                                     work_ptr, nwork, W, win_elems, s)
                : launch_any<float>(p, maxch, taps, tile_ptr, tile_taps, act, nactive, runs,
                                    work_ptr, nwork, W, win_elems, s);
  return static_cast<int>(e);
}

// The kernel's compile-time shape, which the wrapper's tables must share:
// kTileR, kTileC, kStage, kMaxCh, kMaxBlocks, kDescFields.
void phifem_tap_constants(int* out) {
  const int c[6] = {kTileR, kTileC, kStage, kMaxCh, kMaxBlocks, kDescFields};
  for (int i = 0; i < 6; ++i) out[i] = c[i];
}

const char* phifem_tap_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

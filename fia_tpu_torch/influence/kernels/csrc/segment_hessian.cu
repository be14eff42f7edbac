// Segment Gauss-Newton sums for the flat influence path, for Hopper (sm_90a).
//
// Replaces the reference's XLA segment reduction
// fia_tpu/influence/engine.py:_flat_fn -> accum (body_onehot / body_scatter,
// lines 920-965): not a Pallas kernel there, a hand kernel here.
//
// What it computes. The flat axis holds every query's related rows, query
// t owning the contiguous rows [off[t], off[t+1]) (the prelude's layout;
// off is the counts' cumsum, clamped to the flat pad). For each segment t:
//   HH[t] = sum_{s in t} (wv_s g_s) g_s^T      (d x d, fp32)
//   sabe[t] = sum_{s in t} abe_s
// with g (S, d) the rows' block gradients. The caller forms the damped
// block Hessian (2/n_t)(HH + sabe C) + diag(rdiag + lambda) from these.
//
// Why a kernel. Every entry is summed over the segment's own rows only, in
// row order, one rounding per multiply and per add (__fmul_rn / __fadd_rn:
// no contraction into an FMA), so the result depends on nothing but the
// query's rows: not on T, the flat pad S, or where the segment starts.
// That makes the flat path's Hessian the same bits under any batch split,
// which the one-hot contraction it replaces (a cuBLAS product whose shape
// follows the batch) is not. It is also the plain scatter form's arithmetic
// (acc + (g_i w) g_j, row by row), so with wv in {0, 1} the two agree bit
// for bit wherever the scatter form adds in row order (on the CPU).
//
// Bound on an H100. Useful work is one multiply-add a row for each of the
// d(d+1)/2 distinct entries of the symmetric block, S d(d+1) flops, against
// reading g once (4 S d bytes) and writing HH once (4 T d^2 bytes). At
// ML-1M shape, k = 16, T = 1024 (348,499 rows): MF (d = 34) 0.41 GFLOP and
// 52 MB, NCF (d = 64) 1.45 GFLOP and 106 MB, both bound by bytes at
// ~0.02-0.03 ms. At RQ2's NCF k = 256 (64 queries, 15,804 rows,
// d = 1,024) 16.6 GFLOP against 333 MB: bound by operations at ~0.25 ms
// (bytes 0.10 ms).
//
// Design. The grid is (segment, tile pair): a 64 x 64 output tile (i0, j0)
// with i0 <= j0, so only tiles on or above the diagonal are computed; an
// off-diagonal tile is written to both halves. d is padded to the tile with
// zeros that are never written (MF d = 2k + 2, NCF d = 4k: one tile at
// k = 16, 9 x 9 at MF k = 256, 16 x 16 at NCF k = 256). A block walks its
// segment's rows in order, 32 at a time: its 256 threads stage w * g rows
// for the tile's row slice and g rows for its column slice in shared memory
// (16 KB), then each thread adds the 32 rows' products into its 4 x 4
// register sub-tile (rows ty + 16a, columns tx + 16b: the row-slice reads
// broadcast, the column-slice reads hit 16 banks). Thread 0 of tile pair 0
// sums abe the same way. No atomics; each output entry has one writer.
// The cost is the longest segment's walk (one block a tile, serial in its
// rows); a fixed partition of long segments by position relative to their
// start, summed in a fixed order, would keep the bits and shorten that
// tail, and is left for later.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;      // output tile edge
constexpr int kRows = 32;      // rows staged at a time
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 entries each
constexpr int kSub = 4;
constexpr int kSide = kTile / kSub;  // 16

__global__ void __launch_bounds__(kThreads)
segment_hessian_kernel(const float* __restrict__ g,
                       const float* __restrict__ wv,
                       const float* __restrict__ abe,
                       const int64_t* __restrict__ off,
                       float* __restrict__ HH, float* __restrict__ sabe,
                       int64_t S, int d, int n_tiles) {
  const int64_t seg = blockIdx.x;
  // tile pair -> (ti, tj), ti <= tj, row-major over the upper triangle
  int p = blockIdx.y, ti = 0, rem = n_tiles;
  while (p >= rem) {
    p -= rem;
    ++ti;
    --rem;
  }
  const int tj = ti + p;
  const int i0 = ti * kTile, j0 = tj * kTile;
  int64_t r1 = off[seg + 1];
  r1 = r1 < S ? r1 : S;
  int64_t r0 = off[seg];
  r0 = r0 < r1 ? r0 : r1;

  __shared__ float As[kRows][kTile];  // wv_s * g_s[i0 + c]
  __shared__ float Bs[kRows][kTile];  // g_s[j0 + c]
  __shared__ float abe_s[kRows];
  const int tx = threadIdx.x % kSide, ty = threadIdx.x / kSide;
  const bool sums_abe = blockIdx.y == 0 && threadIdx.x == 0;
  float acc[kSub][kSub];
#pragma unroll
  for (int a = 0; a < kSub; ++a)
#pragma unroll
    for (int b = 0; b < kSub; ++b) acc[a][b] = 0.f;
  float sa = 0.f;

  for (int64_t base = r0; base < r1; base += kRows) {
    const int n = static_cast<int>(r1 - base < kRows ? r1 - base : kRows);
    for (int idx = threadIdx.x; idx < kRows * kTile; idx += kThreads) {
      const int r = idx / kTile, c = idx % kTile;
      float av = 0.f, bv = 0.f;
      if (r < n) {
        const float* row = g + (base + r) * static_cast<int64_t>(d);
        if (i0 + c < d) av = __fmul_rn(row[i0 + c], wv[base + r]);
        if (j0 + c < d) bv = row[j0 + c];
      }
      As[r][c] = av;
      Bs[r][c] = bv;
    }
    if (threadIdx.x < kRows)
      abe_s[threadIdx.x] = threadIdx.x < n ? abe[base + threadIdx.x] : 0.f;
    __syncthreads();
    for (int r = 0; r < n; ++r) {
      float av[kSub], bv[kSub];
#pragma unroll
      for (int a = 0; a < kSub; ++a) av[a] = As[r][ty + kSide * a];
#pragma unroll
      for (int b = 0; b < kSub; ++b) bv[b] = Bs[r][tx + kSide * b];
#pragma unroll
      for (int a = 0; a < kSub; ++a)
#pragma unroll
        for (int b = 0; b < kSub; ++b)
          acc[a][b] = __fadd_rn(acc[a][b], __fmul_rn(av[a], bv[b]));
    }
    if (sums_abe)
      for (int r = 0; r < n; ++r) sa = __fadd_rn(sa, abe_s[r]);
    __syncthreads();
  }

  float* out = HH + seg * static_cast<int64_t>(d) * d;
#pragma unroll
  for (int a = 0; a < kSub; ++a) {
    const int i = i0 + ty + kSide * a;
#pragma unroll
    for (int b = 0; b < kSub; ++b) {
      const int j = j0 + tx + kSide * b;
      if (i < d && j < d) {
        out[static_cast<int64_t>(i) * d + j] = acc[a][b];
        if (ti != tj) out[static_cast<int64_t>(j) * d + i] = acc[a][b];
      }
    }
  }
  if (sums_abe) sabe[seg] = sa;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success). The
// caller checks device, dtype, shape and contiguity and allocates HH (T, d,
// d) and sabe (T,); every entry of both is written. off holds T + 1 row
// offsets; rows past S are never read. T == 0 launches nothing.
extern "C" int fia_segment_hessian(const void* g, const void* wv,
                                   const void* abe, const void* off, void* HH,
                                   void* sabe, long long S, int T, int d,
                                   void* stream) {
  if (T <= 0 || d <= 0) return 0;
  const int n_tiles = (d + kTile - 1) / kTile;
  const int pairs = n_tiles * (n_tiles + 1) / 2;
  if (pairs > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid(static_cast<unsigned>(T), static_cast<unsigned>(pairs));
  segment_hessian_kernel<<<grid, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const float*>(wv),
      static_cast<const float*>(abe), static_cast<const int64_t*>(off),
      static_cast<float*>(HH), static_cast<float*>(sabe),
      static_cast<int64_t>(S), d, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

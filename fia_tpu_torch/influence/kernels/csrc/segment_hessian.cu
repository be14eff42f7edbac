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
// The summation order, and why it keeps the bits. A segment's rows are cut
// into pieces of P rows counted from the segment's own start: piece q is
// rows [off[t] + qP, off[t] + (q+1)P). P is the wrapper's piece_rows(d), a
// function of the block size alone. Each piece sums its rows in row order,
// one rounding per multiply and per add (__fmul_rn / __fadd_rn: no
// contraction into an FMA); the segment's result is ((p0 + p1) + p2) + ...,
// the piece partials added in piece order. Nothing in that order depends on
// T, the flat pad S, or where the segment starts, so the flat path's
// Hessian is the same bits under any batch split. The plain version with
// piece = P (kernels/segment.py) does the same operations in the same
// order; entry (i, j), i <= j, is sum (wv g_i) g_j and (j, i) its mirror,
// as the plain version mirrors its upper triangle, so the two agree bit for
// bit under any weights (the sampled rung's n/m too).
//
// No tensor cores: the product is float32 with TF32 off (the port keeps
// float32 throughout), and the order above needs a separate rounding for
// each multiply and each add, which neither TF32 nor an MMA's internal
// accumulation gives.
//
// Bound on an H100. Useful work is one multiply and one add a row for each
// of the d(d+1)/2 distinct entries of the symmetric block, S d(d+1) flops,
// against reading g once (4 S d bytes) and writing HH once (4 T d^2 bytes).
// At ML-1M shape, k = 16, T = 1024 (348,499 rows): MF (d = 34) 0.41 GFLOP
// and 52 MB, NCF (d = 64) 1.45 GFLOP and 106 MB, both bound by bytes at
// ~0.016 / 0.032 ms. What holds this design above that, as far as event
// times can tell (no hardware counters were read): instruction issue. A
// product is two instructions (no FMA); a thread's 16 products a row come
// with two float4 reads of shared memory and four multiplies by wv; and a
// diagonal tile's 4 x 4 sub-blocks leave lanes idle (45 threads of 64 at
// d = 34, 136 of 160 at d = 64). Wider 4 x 8 sub-blocks, with a third
// fewer shared-memory reads a product, were not faster on the card, so
// those reads are not the wall alone. At RQ2's NCF k = 256 (64 queries,
// 15,804 rows, d = 1,024) 16.6 GFLOP against 333 MB: bound by operations.
//
// Design. Two launches.
//  1. segment_pieces_kernel, grid (piece slot, tile pair). Block x < T is
//     piece 0 of segment x; block x >= T is slot j = x - T + 1, which holds
//     piece q = j - floor(off[t] / P) of the segment t whose start is the
//     last one below jP (found by a block-wide search over off with
//     __syncthreads_count, two steps at T <= 65,536; no host read, so the
//     call can be captured in a CUDA graph). A segment's later pieces land
//     on distinct slots below ceil(S / P), so the grid's x extent is
//     T + ceil(S / P) - 1 and a slot where no piece starts exits. A long
//     segment is walked by ceil(rows / P) blocks at once, where one block
//     walked it all before. The output tile: for d <= 64 the whole block,
//     4 ceil(d / 4) wide (36 at MF's d = 34, where a 64-wide tile spent 72%
//     of its products on padding); above, 64 x 64 tiles, those on or above
//     the diagonal. A thread owns a 4 x 4 sub-block; on a diagonal tile
//     only the sub-blocks on or above the diagonal have a thread (45 of 81
//     at d = 34). The walk stages 32 rows at a time with cp.async (16-, 8-
//     or 4-byte copies as the rows' alignment allows: MF's rows start on 8
//     bytes) into a double-buffered ring, so the next stage's copy is in
//     flight while the current one is multiplied; wv and abe come in beside
//     the rows, once a row; each row's 4 + 4 operands are two float4 reads
//     of shared memory. A thread with no sub-block sums abe. Piece 0 writes
//     HH[t] (both halves); a later piece writes its upper triangle to a
//     scratch slot of at most ceil(S / P) - 1.
//  2. segment_combine_kernel, grid (segment, upper 32 x 32 tile of HH): for
//     a segment of more than one piece, each upper entry adds the slots'
//     partials onto HH in piece order, eight loads in flight at a time, and
//     writes the entry and, through shared memory, its mirror, both as
//     whole rows. A fixed order in a second pass: no atomics, each output
//     entry has one writer, two launches give the same bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;      // tile edge above d = 64
constexpr int kRows = 32;      // rows staged at a time
constexpr int kMaxThreads = 256;
constexpr int kCombineThreads = 256;
constexpr int kCT = 32;           // combine tile edge
constexpr int kCombineLoads = 8;  // partials a combine thread loads at once
constexpr int kCombineMaxY = 16;  // combine blocks a segment, at most

template <int VEC>
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (VEC == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src)
                 : "memory");
  } else if constexpr (VEC == 2) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
                 "l"(src)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(src)
                 : "memory");
  }
}

__device__ __forceinline__ void commit_group() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// all but the most recent group have landed
__device__ __forceinline__ void wait_prior_group() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ int64_t clamped(const int64_t* off, int64_t i,
                                           int64_t S) {
  const int64_t v = off[i];
  return v < S ? v : S;
}

// rows [r0, r1) of segment t: off clamped to S, as the prelude lays them out
__device__ __forceinline__ void segment_rows(const int64_t* off, int64_t t,
                                             int64_t S, int64_t* r0,
                                             int64_t* r1) {
  *r1 = clamped(off, t + 1, S);
  const int64_t a = clamped(off, t, S);
  *r0 = a < *r1 ? a : *r1;
}

// Copies n rows x (w / VEC) VEC-float pieces of columns [c0, c0 + w) of g,
// starting at row `base`, into `dst` (row stride tw floats).
template <int VEC>
__device__ __forceinline__ void stage_slice(float* dst, const float* g,
                                            int64_t base, int n, int d,
                                            int c0, int w, int tw, int tid,
                                            int nt) {
  const int nv = w / VEC;
  if (nv <= 0) return;
  const int dr = nt / nv, dc = nt - (nt / nv) * nv;
  int r = tid / nv, c = tid - r * nv;
  const float* src = g + base * static_cast<int64_t>(d) + c0;
  while (r < n) {
    copy_async<VEC>(dst + r * tw + c * VEC,
                    src + static_cast<int64_t>(r) * d + c * VEC);
    r += dr;
    c += dc;
    if (c >= nv) {
      c -= nv;
      ++r;
    }
  }
}

template <int VEC>
__global__ void __launch_bounds__(kMaxThreads)
segment_pieces_kernel(const float* __restrict__ g,
                      const float* __restrict__ wv,
                      const float* __restrict__ abe,
                      const int64_t* __restrict__ off,
                      float* __restrict__ HH, float* __restrict__ sabe,
                      float* __restrict__ part, float* __restrict__ part_abe,
                      int64_t S, int T, int d, int64_t P, int tw,
                      int n_tiles) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x, nt = blockDim.x;

  // -- the block's segment and piece --------------------------------------
  int64_t seg, slot = 0;
  if (blockIdx.x < static_cast<unsigned>(T)) {
    seg = blockIdx.x;
  } else {
    slot = static_cast<int64_t>(blockIdx.x) - T + 1;
    const int64_t x = slot * P;
    if (clamped(off, 0, S) >= x) return;
    // the last t in [0, T) with off[t] < x: invariant off[lo] < x and the
    // answer below hi; each step samples nt candidates in (lo, hi)
    int64_t lo = 0, hi = T;
    while (hi - lo > 1) {
      const int64_t span = hi - lo - 1;
      const bool each = span <= nt;
      const int64_t n = each ? span : nt;
      const int64_t m = lo + 1 + (each ? tid : tid * span / nt);
      const int c = __syncthreads_count(tid < n && clamped(off, m, S) < x);
      if (c == 0) {
        hi = lo + 1;
      } else {
        const int64_t below = lo + 1 + (each ? c - 1 : (c - 1) * span / nt);
        hi = c < n ? lo + 1 + (each ? c : c * span / nt) : hi;
        lo = below;
      }
    }
    seg = lo;
  }
  int64_t s0, s1;
  segment_rows(off, seg, S, &s0, &s1);
  const int64_t q = slot == 0 ? 0 : slot - s0 / P;
  const int64_t p0 = s0 + q * P;
  if (slot != 0 && p0 >= s1) return;  // no piece starts in this slot
  const int64_t p1 = p0 + P < s1 ? p0 + P : s1;

  // -- the tile pair and this thread's 4 x 4 sub-block: on a diagonal tile
  // the sub-blocks (a, b), b >= a, on an off-diagonal one every one -------
  int p = blockIdx.y, ti = 0, rem = n_tiles;
  while (p >= rem) {
    p -= rem;
    ++ti;
    --rem;
  }
  const int tj = ti + p;
  const bool diag = ti == tj;
  const int i0 = ti * tw, j0 = tj * tw;
  const int wi = d - i0 < tw ? d - i0 : tw;  // the tile's rows and columns
  const int wj = d - j0 < tw ? d - j0 : tw;
  const int ra = (wi + 3) / 4, cb = (wj + 3) / 4;
  int a = -1, b = -1;
  if (diag) {
    int r = tid;
    for (int x = 0; x < ra; ++x) {
      if (r < ra - x) {
        a = x;
        b = x + r;
        break;
      }
      r -= ra - x;
    }
  } else if (tid < ra * cb) {
    a = tid / cb;
    b = tid - a * cb;
  }
  const bool active = a >= 0;
  // the launch gives pair 0 (diagonal) more threads than sub-blocks, so its
  // last thread is free to sum abe
  const bool sums_abe = blockIdx.y == 0 && tid == nt - 1;

  // -- shared memory: [stage][slice][row][tw], then wv and abe [stage][row]
  const int nsl = n_tiles > 1 ? 2 : 1;
  const int slice = kRows * tw;
  float* w_s = smem + 2 * nsl * slice;
  float* abe_s = w_s + 2 * kRows;

  auto issue = [&](int64_t base, int n, int st) {
    float* bi = smem + st * nsl * slice;
    stage_slice<VEC>(bi, g, base, n, d, i0, wi, tw, tid, nt);
    if (!diag) stage_slice<VEC>(bi + slice, g, base, n, d, j0, wj, tw, tid, nt);
    if (tid < n) {
      copy_async<1>(w_s + st * kRows + tid, wv + base + tid);
      copy_async<1>(abe_s + st * kRows + tid, abe + base + tid);
    }
    commit_group();
  };

  float acc[4][4];
#pragma unroll
  for (int x = 0; x < 4; ++x)
#pragma unroll
    for (int y = 0; y < 4; ++y) acc[x][y] = 0.f;
  float sa = 0.f;

  const int64_t rows = p1 - p0;
  const int stages = static_cast<int>((rows + kRows - 1) / kRows);
  if (stages > 0) issue(p0, rows < kRows ? static_cast<int>(rows) : kRows, 0);
  for (int k = 0; k < stages; ++k) {
    const int64_t next = p0 + static_cast<int64_t>(k + 1) * kRows;
    if (k + 1 < stages)
      issue(next, p1 - next < kRows ? static_cast<int>(p1 - next) : kRows,
            (k + 1) & 1);
    else
      commit_group();  // an empty group: the wait below still means stage k
    wait_prior_group();
    __syncthreads();
    const int64_t here = p0 + static_cast<int64_t>(k) * kRows;
    const int n = p1 - here < kRows ? static_cast<int>(p1 - here) : kRows;
    const int st = k & 1;
    const float* bi = smem + st * nsl * slice;
    const float* bj = diag ? bi : bi + slice;
    const float* ws = w_s + st * kRows;
    if (active) {
      const float* ai = bi + 4 * a;
      const float* aj = bj + 4 * b;
#pragma unroll 4
      for (int r = 0; r < n; ++r) {
        const float w = ws[r];
        const float4 u = *reinterpret_cast<const float4*>(ai + r * tw);
        const float4 v = *reinterpret_cast<const float4*>(aj + r * tw);
        const float av[4] = {__fmul_rn(u.x, w), __fmul_rn(u.y, w),
                             __fmul_rn(u.z, w), __fmul_rn(u.w, w)};
        const float bv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int x = 0; x < 4; ++x)
#pragma unroll
          for (int y = 0; y < 4; ++y)
            acc[x][y] = __fadd_rn(acc[x][y], __fmul_rn(av[x], bv[y]));
      }
    } else if (sums_abe) {
      const float* as = abe_s + st * kRows;
      for (int r = 0; r < n; ++r) sa = __fadd_rn(sa, as[r]);
    }
    __syncthreads();
  }

  // -- write: piece 0 to HH (entry and mirror), a later piece to its slot
  const int64_t dd = static_cast<int64_t>(d) * d;
  float* out = slot == 0 ? HH + seg * dd : part + (slot - 1) * dd;
  if (active) {
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int i = i0 + 4 * a + x;
#pragma unroll
      for (int y = 0; y < 4; ++y) {
        const int j = j0 + 4 * b + y;
        if (i < d && j < d && i <= j) {
          out[static_cast<int64_t>(i) * d + j] = acc[x][y];
          if (slot == 0 && i != j) out[static_cast<int64_t>(j) * d + i] = acc[x][y];
        }
      }
    }
  }
  if (sums_abe) {
    if (slot == 0)
      sabe[seg] = sa;
    else
      part_abe[slot - 1] = sa;
  }
}

// Grid (segment, upper 32 x 32 tile of HH, strided): a segment of more than
// one piece adds its later pieces' partials onto piece 0's entries in piece
// order, a batch of loads in flight at a time, and writes each upper entry
// and, through shared memory, its mirror, both as whole rows.
__global__ void __launch_bounds__(kCombineThreads)
segment_combine_kernel(const int64_t* __restrict__ off,
                       float* __restrict__ HH, float* __restrict__ sabe,
                       const float* __restrict__ part,
                       const float* __restrict__ part_abe, int64_t S, int d,
                       int64_t P, int n_ct) {
  const int64_t seg = blockIdx.x;
  int64_t r0, r1;
  segment_rows(off, seg, S, &r0, &r1);
  const int64_t pieces = (r1 - r0 + P - 1) / P;
  if (pieces <= 1) return;
  const int64_t later = pieces - 1;
  const int64_t dd = static_cast<int64_t>(d) * d;
  // piece q >= 1 sits in slot r0 / P + q, scratch row slot - 1
  const float* first = part + (r0 / P) * dd;
  float* out = HH + seg * dd;
  __shared__ float tile[kCT][kCT + 1];
  const int tx = threadIdx.x % kCT, ty = threadIdx.x / kCT;
  constexpr int kPer = kCT * kCT / kCombineThreads;  // entries a thread
  constexpr int kStep = kCombineThreads / kCT;       // its rows' spacing
  const int pairs = n_ct * (n_ct + 1) / 2;
  for (int pr = blockIdx.y; pr < pairs; pr += gridDim.y) {
    int p = pr, I = 0, rem = n_ct;
    while (p >= rem) {
      p -= rem;
      ++I;
      --rem;
    }
    const int J = I + p;
    const int j = J * kCT + tx;
    float v[kPer];
    int64_t e[kPer];
    bool ok[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int i = I * kCT + ty + kStep * k;
      ok[k] = i < d && j < d && i <= j;
      e[k] = static_cast<int64_t>(i) * d + j;
      v[k] = ok[k] ? out[e[k]] : 0.f;
    }
    int64_t q = 0;
    for (; q + kCombineLoads <= later; q += kCombineLoads) {
      float x[kPer][kCombineLoads];
#pragma unroll
      for (int k = 0; k < kPer; ++k)
#pragma unroll
        for (int u = 0; u < kCombineLoads; ++u)
          x[k][u] = ok[k] ? first[(q + u) * dd + e[k]] : 0.f;
#pragma unroll
      for (int k = 0; k < kPer; ++k)
#pragma unroll
        for (int u = 0; u < kCombineLoads; ++u) v[k] = __fadd_rn(v[k], x[k][u]);
    }
    for (; q < later; ++q) {
#pragma unroll
      for (int k = 0; k < kPer; ++k)
        if (ok[k]) v[k] = __fadd_rn(v[k], first[q * dd + e[k]]);
    }
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      if (ok[k]) out[e[k]] = v[k];
      tile[ty + kStep * k][tx] = v[k];
    }
    __syncthreads();
    // the mirror: entry (i, jj) with i = I*32 + tx, jj = J*32 + ty + ...,
    // i < jj, written to (jj, i)
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int i = I * kCT + tx, jj = J * kCT + ty + kStep * k;
      if (i < d && jj < d && i < jj)
        out[static_cast<int64_t>(jj) * d + i] = tile[tx][ty + kStep * k];
    }
    __syncthreads();
  }
  if (blockIdx.y == 0 && threadIdx.x == 0) {
    float v = sabe[seg];
    const float* pa = part_abe + r0 / P;
    for (int64_t k = 0; k < later; ++k) v = __fadd_rn(v, pa[k]);
    sabe[seg] = v;
  }
}

template <int VEC>
cudaError_t launch_pieces(dim3 grid, int threads, size_t smem,
                          cudaStream_t stream, const float* g, const float* wv,
                          const float* abe, const int64_t* off, float* HH,
                          float* sabe, float* part, float* part_abe, int64_t S,
                          int T, int d, int64_t P, int tw, int n_tiles) {
  segment_pieces_kernel<VEC><<<grid, threads, smem, stream>>>(
      g, wv, abe, off, HH, sabe, part, part_abe, S, T, d, P, tw, n_tiles);
  return cudaGetLastError();
}

cudaError_t launch_all(const float* g, const float* wv, const float* abe,
                       const int64_t* off, float* HH, float* sabe, float* part,
                       float* part_abe, int64_t S, int T, int d, int64_t P,
                       cudaStream_t st) {
  // the tile: the whole block, 4 ceil(d / 4) wide, up to d = 64; above,
  // 64 x 64 tiles on and above the diagonal
  const int tw = d <= kTile ? 4 * ((d + 3) / 4) : kTile;
  const int n_tiles = (d + tw - 1) / tw;
  const long long pairs = static_cast<long long>(n_tiles) * (n_tiles + 1) / 2;
  if (pairs > 65535) return cudaErrorInvalidConfiguration;
  // threads: the most sub-blocks of any tile, and a spare in pair 0 (a
  // diagonal tile, sb (sb + 1) / 2 of them, never a multiple of 32 for
  // sb <= 16), whose spare sums abe
  const int sb = tw / 4;
  const int threads =
      n_tiles > 1 ? sb * sb : (sb * (sb + 1) / 2 / 32 + 1) * 32;
  const long long slots = (S + P - 1) / P;
  const long long gx = static_cast<long long>(T) + (slots > 1 ? slots - 1 : 0);
  if (gx > 2147483647LL) return cudaErrorInvalidConfiguration;
  const size_t smem =
      (2 * (n_tiles > 1 ? 2 : 1) * kRows * tw + 4 * kRows) * sizeof(float);
  const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(pairs));
  // the widest copy the rows' alignment allows (MF's rows start on 8 bytes)
  const uintptr_t at = reinterpret_cast<uintptr_t>(g);
  cudaError_t err;
  if (d % 4 == 0 && at % 16 == 0)
    err = launch_pieces<4>(grid, threads, smem, st, g, wv, abe, off, HH, sabe,
                           part, part_abe, S, T, d, P, tw, n_tiles);
  else if (d % 2 == 0 && at % 8 == 0)
    err = launch_pieces<2>(grid, threads, smem, st, g, wv, abe, off, HH, sabe,
                           part, part_abe, S, T, d, P, tw, n_tiles);
  else
    err = launch_pieces<1>(grid, threads, smem, st, g, wv, abe, off, HH, sabe,
                           part, part_abe, S, T, d, P, tw, n_tiles);
  if (err != cudaSuccess) return err;
  const int n_ct = (d + kCT - 1) / kCT;
  const long long cpairs = static_cast<long long>(n_ct) * (n_ct + 1) / 2;
  const dim3 cgrid(static_cast<unsigned>(T),
                   static_cast<unsigned>(cpairs < kCombineMaxY ? cpairs
                                                               : kCombineMaxY));
  segment_combine_kernel<<<cgrid, kCombineThreads, 0, st>>>(
      off, HH, sabe, part, part_abe, S, d, P, n_ct);
  return cudaGetLastError();
}

}  // namespace

// Launches both passes on `stream` and returns cudaGetLastError() (0 on
// success). The caller checks device, dtype, shape and contiguity and
// allocates HH (T, d, d), sabe (T,), and the scratch part (max(0,
// ceil(S / piece) - 1), d, d) and part_abe (same count,); every entry of HH
// and sabe is written. off holds T + 1 row offsets; rows past S are never
// read. T == 0 launches nothing.
extern "C" int fia_segment_hessian(const void* g, const void* wv,
                                   const void* abe, const void* off, void* HH,
                                   void* sabe, void* part, void* part_abe,
                                   long long S, int T, int d, long long piece,
                                   void* stream) {
  if (T <= 0 || d <= 0) return 0;
  if (piece <= 0 || S < 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_all(
      static_cast<const float*>(g), static_cast<const float*>(wv),
      static_cast<const float*>(abe), static_cast<const int64_t*>(off),
      static_cast<float*>(HH), static_cast<float*>(sabe),
      static_cast<float*>(part), static_cast<float*>(part_abe), S, T, d, piece,
      static_cast<cudaStream_t>(stream)));
}

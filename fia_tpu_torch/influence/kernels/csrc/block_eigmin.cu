// The smallest eigenvalue of each of T symmetric d x d blocks, for Hopper
// (sm_90a).
//
// Replaces a library call of the reference: jnp.linalg.eigvalsh(H)[:, 0],
// fia_tpu/influence/engine.py:2504-2506, the sampled certificate's lambda_min.
//
// What it computes (the plain version, kernels/eigmin.py:
// block_eigmin_reference, does the same operations in the same order, so the
// kernel is held to it bit for bit). Block t of H (T, d, d) is read from its
// lower triangle only (eigvalsh's UPLO "L"; the engine's H is not
// bit-symmetric); a block holding a non-finite entry there gives NaN.
//  1. Householder tridiagonalisation (LAPACK's ssytd2, lower): for
//     j = 0 .. n - 3, x = A[j+1:, j], alpha = x_0, s = sum_{k>=j+2} x_k^2;
//     s = 0: beta = alpha, tau = 0, v = e_1; else beta = -copysign(sqrt(
//     alpha^2 + s), alpha), tau = (beta - alpha) / beta, v_k = x_k / (alpha -
//     beta), v_0 = 1. Then p = tau A v on the trailing block, w = p +
//     ((-tau / 2) p.v) v, and every trailing lower entry becomes
//     (a_ic - v_i w_c) - w_i v_c. beta is T's off-diagonal b_j.
//  2. Sturm multisection for T's smallest eigenvalue: the count at x is the
//     number of pivots <= 0 of q_i = (a_i - x) - b_{i-1}^2 / q_{i-1}, a pivot
//     below pivmin = FLT_MIN max(1, max b^2) in magnitude taken as -pivmin
//     (LAPACK's sstebz). Over the ordered bit patterns of float32, from T's
//     Gershgorin interval widened by bnorm n 2^-21 + 4 pivmin, each of
//     kRounds = 5 rounds evaluates the count at kPoints = 128 evenly spread
//     points, a thread each, and keeps the cell where the count first reaches
//     1; after the last (129^5 > 2^32) the bracket is one float wide and
//     lambda_min is its upper end (kernels/eigmin.py: STURM_POINTS, ROUNDS).
//     A diagonal block returns its smallest diagonal entry exactly.
// Every sum (a norm, a dot, a row of A v) follows one tree: lane l of 32 adds
// the terms whose absolute index is = l (mod 32) in ascending order from +0,
// then a xor butterfly (16, 8, 4, 2, 1) combines the lanes; a row of A v
// keeps two such lane sums (the entries left of the diagonal, and those on
// and below it) and adds them before the butterfly. Every multiply, add,
// divide and square root rounds on its own (__fmul_rn, __fadd_rn, __fsub_rn,
// __fdiv_rn, __fsqrt_rn: no contraction into an FMA). Nothing depends on the
// other blocks or on how many CTAs hold a block, so a block's lambda_min is
// the same bits alone and in any batch. No step waits on the host: the
// sampled program is captured in one CUDA graph.
//
// Bound on an H100. Reading the lower triangles once, 4 T d (d + 1) / 2
// bytes, against one tridiagonalisation's 4 d^3 / 3 flops a block: at the
// main path's T = 1024, d = 34 / 64 that is 2.4 / 8.5 MB (0.73 / 2.5 us at
// 3.35 TB/s) against 54 / 358 MFLOP (0.80 / 5.3 us at 67 TFLOP/s): the flops
// bound it. The earlier design, a parallel cyclic Jacobi with a fixed sweep
// count, did some 40 times those flops in n - 1 barrier-ended steps a sweep
// (0.587 / 2.595 ms at T = 1024, and 1.1 / 8.7 s for two blocks at d = 514 /
// 1,024 from a device-memory scratch of T n^2 floats, on an H100 80GB HBM3
// at 700 W; PERF.md keeps them). What this design does about it: n - 2
// Householder steps in shared memory, then a multisection of a few rounds.
//  - d <= 238: one CTA a block (128 threads at d <= 64, 256 to 128, 512
//    above) holding both triangles of A (n x (n + 1) floats: an odd row
//    stride, so a warp walking a row or a column meets every bank once) and
//    three n-vectors in dynamic shared memory: at d <= 64 a batch of 1,024
//    blocks is resident at once. Lane l holds columns l + 32 k, so each walk
//    is ceil(d / 32) straight-line steps; a warp eight rows of A v at once
//    (the butterfly's first three stages exchange half a warp's rows each,
//    so eight rows take 9 shuffles, not 40); a warp two rows of the update,
//    the r-th and the r-th from last (each entry written with its mirror),
//    while warp 0 updates the next column and forms its reflector: two
//    barriers a step.
//  - above (d = 256, 258, 512, 514, 1,024): one thread-block cluster a
//    block, of the fewest CTAs whose shared memory holds the packed lower
//    triangle (2 at d = 256 / 258, 3 at 512 / 514, 11 at 1,024: the 32
//    lanes' columns split into groups of at most three), 1,024 threads each.
//    CTA r owns the columns c whose residue c mod 32 lies in its group, so
//    each lane's sums of a row of A v over the entries left of the diagonal
//    stay in one CTA; the CTAs exchange those lane sums, v, p and the lane
//    sums of p.v through distributed shared memory, with a cluster barrier
//    between phases. No device-memory scratch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <initializer_list>
#include <math.h>
#include <stdint.h>

#include <mutex>

namespace cg = cooperative_groups;

namespace {

constexpr int kLanes = 32;
constexpr unsigned kFull = 0xffffffffu;
// dynamic shared memory a CTA may take on an H100 (227 KB, less 1 KB for the
// static arrays)
constexpr int kSmemBytes = 232448 - 1024;
constexpr int kMaxCluster = 16;
constexpr int kClusterThreads = 1024;
constexpr int kMaxThreads = 512;   // a one-CTA block
constexpr int kRows = 8;           // rows of A v a warp sums at once
constexpr float kFltMin = 1.17549435e-38f;
constexpr float kWiden = 4.76837158203125e-07f;  // 2^-21
constexpr int kPoints = 128;  // Sturm points a round, one a thread
constexpr int kRounds = 5;    // the least r with (kPoints + 1)^r >= 2^32
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fc00000); }

// the xor butterfly of the warp's 32 lane sums (every lane gets the sum)
__device__ __forceinline__ float butterfly(float x) {
#pragma unroll
  for (int k = 16; k >= 1; k >>= 1)
    x = __fadd_rn(x, __shfl_xor_sync(kFull, x, k));
  return x;
}

// The first stage of the butterfly over 2H rows at once (k = 16, 8, 4 for H
// = 4, 2, 1): each lane keeps half its rows, by bit k of its lane, and adds
// its partner's sums of them: lane l's sum of each kept row is then the one
// the butterfly gives it, at a fraction of the shuffles.
template <int H>
__device__ __forceinline__ void transpose_stage(float* u, int lane, int k) {
  const bool upper = (lane & k) != 0;
#pragma unroll
  for (int r = 0; r < H; ++r) {
    const float mine = upper ? u[r + H] : u[r];
    const float other = upper ? u[r] : u[r + H];
    u[r] = __fadd_rn(mine, __shfl_xor_sync(kFull, other, k));
  }
}

// the first index >= k0 that is = l (mod 32)
__device__ __forceinline__ int first_ge(int k0, int l) {
  return k0 + ((l - k0) & (kLanes - 1));
}

// floats of the packed columns = l (mod 32) of an n x n lower triangle
__host__ __device__ __forceinline__ int residue_size(int n, int l) {
  if (l >= n) return 0;
  const int cols = (n - l + kLanes - 1) / kLanes;
  return cols * (n - l) - 16 * cols * (cols - 1);
}

// ordered int keys of float32 (a monotone map; -0 just below +0)
__device__ __forceinline__ long long fkey(float x) {
  const int b = __float_as_int(x);
  return static_cast<long long>(b ^ ((b >> 31) & 0x7fffffff));
}
__device__ __forceinline__ float keyf(long long k) {
  int b = static_cast<int>(k);
  b ^= (b >> 31) & 0x7fffffff;
  return __int_as_float(b);
}

// p in the shared memory of the cluster's CTA `rank`
template <typename P>
__device__ __forceinline__ P* at_rank(P* p, int rank) {
  return cg::this_cluster().map_shared_rank(p, rank);
}

// Is the Sturm count of T (diagonal a, off-diagonal b) at x at least 1?
__device__ __forceinline__ bool count_hits(const float* a, const float* b,
                                           int n, float x, float pivmin) {
  float q = __fsub_rn(a[0], x);
  if (fabsf(q) < pivmin) q = -pivmin;
  if (q <= 0.f) return true;
  for (int i = 1; i < n; ++i) {
    const float e2 = __fmul_rn(b[i - 1], b[i - 1]);
    q = __fsub_rn(__fsub_rn(a[i], x), __fdiv_rn(e2, q));
    if (fabsf(q) < pivmin) q = -pivmin;
    if (q <= 0.f) return true;
  }
  return false;
}

// The Householder reflector of column j, by one warp: x[k] = A[k][j] for
// k > j (x[j + 1] = alpha). Writes v[j + 1 ..] (v may be x) and returns tau
// and beta through lane 0's *tau_out, *beta_out.
__device__ __forceinline__ void reflector(const float* x, int j, int n,
                                          float* v, float* tau_out,
                                          float* beta_out) {
  const int lane = threadIdx.x & (kLanes - 1);
  float acc = 0.f;
  for (int k = first_ge(j + 2, lane); k < n; k += kLanes)
    acc = __fadd_rn(acc, __fmul_rn(x[k], x[k]));
  const float s = butterfly(acc);
  const float alpha = x[j + 1];
  float beta = alpha, tau = 0.f, den = 1.f;
  if (s != 0.f) {
    const float r = __fsqrt_rn(__fadd_rn(__fmul_rn(alpha, alpha), s));
    beta = -copysignf(r, alpha);
    tau = __fdiv_rn(__fsub_rn(beta, alpha), beta);
    den = __fsub_rn(alpha, beta);
  }
  for (int k = j + 2 + lane; k < n; k += kLanes)
    v[k] = s == 0.f ? 0.f : __fdiv_rn(x[k], den);
  __syncwarp();  // v may be x: every lane has read alpha
  if (lane == 0) {
    v[j + 1] = 1.f;
    *tau_out = tau;
    *beta_out = beta;
  }
}

// Stage 2, by every thread of one CTA: lambda_min of T (diagonal a,
// off-diagonal b, in shared memory) into *out, NaN where T or its bracket
// is not finite.
__device__ void sturm_stage(const float* a, const float* b, int n,
                            float* out) {
  __shared__ float s_red[3][kLanes];
  __shared__ unsigned s_hits[kLanes];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & (kLanes - 1), warp = tid >> 5, nw = nt >> 5;
  // Gershgorin interval, max b^2, and whether T is finite (min and max are
  // exact in any order)
  float gl = INFINITY, gu = -INFINITY, e2max = 1.f;
  int fin = 1;
  for (int i = tid; i < n; i += nt) {
    const float bl = i > 0 ? fabsf(b[i - 1]) : 0.f;
    const float br = i + 1 < n ? fabsf(b[i]) : 0.f;
    const float rad = __fadd_rn(bl, br);
    gl = fminf(gl, __fsub_rn(a[i], rad));
    gu = fmaxf(gu, __fadd_rn(a[i], rad));
    fin &= isfinite(a[i]);
    if (i + 1 < n) {
      fin &= isfinite(b[i]);
      e2max = fmaxf(e2max, __fmul_rn(b[i], b[i]));
    }
  }
#pragma unroll
  for (int k = 16; k >= 1; k >>= 1) {
    gl = fminf(gl, __shfl_xor_sync(kFull, gl, k));
    gu = fmaxf(gu, __shfl_xor_sync(kFull, gu, k));
    e2max = fmaxf(e2max, __shfl_xor_sync(kFull, e2max, k));
  }
  if (lane == 0) {
    s_red[0][warp] = gl;
    s_red[1][warp] = gu;
    s_red[2][warp] = e2max;
  }
  fin = __syncthreads_and(fin);
  gl = s_red[0][0];
  gu = s_red[1][0];
  e2max = s_red[2][0];
  for (int w = 1; w < nw; ++w) {
    gl = fminf(gl, s_red[0][w]);
    gu = fmaxf(gu, s_red[1][w]);
    e2max = fmaxf(e2max, s_red[2][w]);
  }
  const float pivmin = __fmul_rn(e2max, kFltMin);
  const float bnorm = fmaxf(fabsf(gl), fabsf(gu));
  const float wid =
      __fmul_rn(bnorm, __fmul_rn(static_cast<float>(n), kWiden));
  const float pm4 = __fmul_rn(pivmin, 4.f);
  const float lo = __fsub_rn(__fsub_rn(gl, wid), pm4);
  const float hi = __fadd_rn(__fadd_rn(gu, wid), pm4);
  if (!fin || !isfinite(lo) || !isfinite(hi)) {
    if (tid == 0) *out = nan_f();
    return;
  }
  long long klo = fkey(lo), khi = fkey(hi);
  constexpr int pw = kPoints / kLanes;
  for (int rd = 0; rd < kRounds; ++rd) {
    const long long span = khi - klo;
    auto point = [&](int k) {
      return klo + (static_cast<long long>(k + 1) * span) / (kPoints + 1);
    };
    const bool hit = tid < kPoints && count_hits(a, b, n, keyf(point(tid)),
                                                 pivmin);
    const unsigned ball = __ballot_sync(kFull, hit);
    if (lane == 0 && warp < pw) s_hits[warp] = ball;
    __syncthreads();
    int first = -1;
    for (int w = 0; w < pw && first < 0; ++w)
      if (s_hits[w]) first = w * kLanes + __ffs(s_hits[w]) - 1;
    __syncthreads();  // s_hits is rewritten next round
    if (first < 0) {
      klo = point(kPoints - 1);
    } else {
      const long long nhi = point(first);
      if (first > 0) klo = point(first - 1);
      khi = nhi;
    }
  }
  if (tid == 0) *out = keyf(khi);
}

// One CTA a matrix (d <= 238): A, both triangles (n x (n + 1) floats, an odd
// row stride, so a warp's walk along a row or a column meets every bank
// once), then v of this step and the next (2n), p (n) and a pad of 32, in
// dynamic shared memory. Lane l holds the columns l + 32 k, k < K = ceil(n /
// 32): every walk over a row is K straight-line steps (a term out of range
// adds +0, which leaves a sum's bits alone), so a warp's rows overlap. A warp
// kRows rows of A v at once. The update walks two rows of the trailing
// triangle a warp, the r-th and the r-th from last (m + 1 entries together,
// so its lanes stay busy as the triangle shrinks), writing each entry and
// its mirror; meanwhile warp 0 updates the next column (the others skip it)
// and forms its reflector, so a step ends at two barriers.
template <int K>
__global__ void __launch_bounds__(kMaxThreads)
eigmin_cta_kernel(const float* __restrict__ H, float* __restrict__ lam,
                  int n) {
  extern __shared__ float4 smem4[];
  const int ld = n + 1;
  float* const A = reinterpret_cast<float*>(smem4);
  float* const vbuf = A + n * ld;
  float* const pb = vbuf + 2 * n;
  __shared__ float s_tau[2];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & (kLanes - 1), warp = tid >> 5, nw = nt >> 5;
  const int64_t mat = blockIdx.x;

  // A from H's lower triangle, mirrored; any non-finite entry?
  const float* Hb = H + mat * static_cast<int64_t>(n) * n;
  int bad = 0;
  for (int i = warp; i < n; i += nw)
    for (int c = lane; c <= i; c += kLanes) {
      const float x = Hb[static_cast<int64_t>(i) * n + c];
      bad |= !isfinite(x);
      A[i * ld + c] = x;
      A[c * ld + i] = x;
    }
  if (__syncthreads_or(bad)) {
    if (tid == 0) lam[mat] = nan_f();
    return;
  }

  // -- 1. Householder tridiagonalisation ---------------------------------
  if (n >= 3 && warp == 0) {  // the reflector of column 0 (row 0)
    float tau, beta;
    reflector(A, 0, n, vbuf, &tau, &beta);
    if (lane == 0) {
      s_tau[0] = tau;
      A[ld] = beta;  // T's b_0
    }
  }
  __syncthreads();
  float beta_next = 0.f;  // warp 0's lane 0: the next column's beta
  for (int j = 0; j + 2 < n; ++j) {
    const float* const vb = vbuf + (j & 1) * n;
    float* const vn = vbuf + ((j + 1) & 1) * n;
    const float tau = s_tau[j & 1];
    if (j > 0 && tid == 0) A[(j + 1) * ld + j] = beta_next;  // T's b_j
    // the first of lane l's columns in the trailing block, and its v there
    const int k0 = (j + 1) >> 5;
    float vk[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int c = lane + kLanes * k;
      vk[k] = k >= k0 && c > j && c < n ? vb[c] : 0.f;
    }
    // p = tau A v, kRows rows a warp at once: lane l's sums left of and
    // from the diagonal, then the butterfly, its stages 16, 8 and 4 over
    // the rows together (lane l then holds row l >> 2), 2 and 1 as usual
    for (int i0 = j + 1 + warp * kRows; i0 < n; i0 += nw * kRows) {
      float u[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int i = min(i0 + r, n - 1);  // a row past n is not written
        const float* row = A + i * ld;
        float left = 0.f, right = 0.f;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          if (k < k0) continue;
          const int c = lane + kLanes * k;
          const float t = c > j && c < n ? __fmul_rn(row[c], vk[k]) : 0.f;
          if (c < i)
            left = __fadd_rn(left, t);
          else
            right = __fadd_rn(right, t);
        }
        u[r] = __fadd_rn(left, right);
      }
      transpose_stage<4>(u, lane, 16);
      transpose_stage<2>(u, lane, 8);
      transpose_stage<1>(u, lane, 4);
      float y = __fadd_rn(u[0], __shfl_xor_sync(kFull, u[0], 2));
      y = __fadd_rn(y, __shfl_xor_sync(kFull, y, 1));
      const int i = i0 + (lane >> 2);
      if ((lane & 3) == 0 && i < n) pb[i] = __fmul_rn(tau, y);
    }
    __syncthreads();
    float kl = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (k < k0) continue;
      const int i = lane + kLanes * k;
      kl = __fadd_rn(kl, i > j && i < n ? __fmul_rn(pb[i], vb[i]) : 0.f);
    }
    const float coef = __fmul_rn(__fmul_rn(tau, -0.5f), butterfly(kl));
    const int m = n - j - 1;
    const bool ahead = j + 3 < n;  // a next column to reflect
    if (ahead && warp == 0) {
      // warp 0 updates column j + 1 (the others skip it), then forms its
      // reflector from the new column (into v of the next step)
      const float vc = vb[j + 1];
      const float wc = __fadd_rn(pb[j + 1], __fmul_rn(coef, vc));
      for (int i = j + 1 + lane; i < n; i += kLanes) {
        const float vi = vb[i];
        const float wi = __fadd_rn(pb[i], __fmul_rn(coef, vi));
        const float x =
            __fsub_rn(__fsub_rn(A[i * ld + j + 1], __fmul_rn(vi, wc)),
                      __fmul_rn(wi, vc));
        A[i * ld + j + 1] = x;
        A[(j + 1) * ld + i] = x;
        if (i > j + 1) vn[i] = x;
      }
      __syncwarp();
      float tau1, beta1;
      reflector(vn, j + 1, n, vn, &tau1, &beta1);
      if (lane == 0) {
        s_tau[(j + 1) & 1] = tau1;
        beta_next = beta1;
      }
    }
    // the rank-2 update of the trailing lower triangle, each entry and its
    // mirror: its rows r and m - 1 - r (counted from j + 1) make one walk of
    // m + 1 entries, a warp a pair (not warp 0, nor column j + 1, while warp
    // 0 looks ahead)
    const int w0 = ahead ? 1 : 0;
    for (int pr = warp - w0; pr >= 0 && pr < (m + 1) / 2; pr += nw - w0) {
      const int r2 = m - 1 - pr;
      const int len = pr == r2 ? pr + 1 : m + 1;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int q = lane + kLanes * k;
        const bool near = q <= pr;
        if (q < len && !(ahead && q == (near ? 0 : pr + 1))) {
          const int i = j + 1 + (near ? pr : r2);
          const int c = j + 1 + (near ? q : q - pr - 1);
          const float vi = vb[i], vc = vb[c];
          const float wi = __fadd_rn(pb[i], __fmul_rn(coef, vi));
          const float wc = __fadd_rn(pb[c], __fmul_rn(coef, vc));
          const float x =
              __fsub_rn(__fsub_rn(A[i * ld + c], __fmul_rn(vi, wc)),
                        __fmul_rn(wi, vc));
          A[i * ld + c] = x;
          A[c * ld + i] = x;
        }
      }
    }
    __syncthreads();
  }

  // -- 2. Sturm multisection on T's diagonal and off-diagonal (over v, p) --
  for (int i = tid; i < n; i += nt) {
    vbuf[i] = A[i * ld + i];
    if (i + 1 < n) pb[i] = A[(i + 1) * ld + i];
  }
  __syncthreads();
  sturm_stage(vbuf, pb, n, lam + mat);
}

// One cluster of R CTAs a matrix (d > 238), blockIdx.x / R the matrix.
// Dynamic shared memory of every CTA: its columns' packed entries (cap
// floats), v (n), p of its rows (n), p of every row (n), its lanes' sums
// left of the diagonal of every row (smax x n) and its lanes' sums of p.v
// (32).
__global__ void __launch_bounds__(kClusterThreads, 1)
eigmin_cluster_kernel(const float* __restrict__ H, float* __restrict__ lam,
                      int n, int R, int cap, int smax) {
  extern __shared__ float4 smem4[];
  float* const Lc = reinterpret_cast<float*>(smem4);
  float* const vb = Lc + cap;
  float* const pb = vb + n;
  float* const pf = pb + n;
  float* const rb = pf + n;
  float* const kb = rb + smax * n;
  __shared__ int s_owner[kLanes], s_base[kLanes], s_slot[kLanes];
  __shared__ float s_tau;
  __shared__ int s_bad;
  cg::cluster_group cluster = cg::this_cluster();

  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & (kLanes - 1), warp = tid >> 5, nw = nt >> 5;
  const int rank = static_cast<int>(cluster.block_rank());
  const int64_t mat = blockIdx.x / R;
  const int lo_res = (kLanes * rank) / R, hi_res = (kLanes * (rank + 1)) / R;
  const int nres = hi_res - lo_res;

  // which CTA holds the columns of each residue, and where
  if (tid < kLanes) {
    int owner = 0;
    for (int r = 1; r < R; ++r)
      if ((kLanes * r) / R <= tid) owner = r;
    const int first = (kLanes * owner) / R;
    int base = 0;
    for (int l = first; l < tid; ++l) base += residue_size(n, l);
    s_owner[tid] = owner;
    s_base[tid] = base;
    s_slot[tid] = tid - first;
  }
  __syncthreads();
  // column c's entry at row i >= c is Lc[colptr(c) + i - c] in its owner
  auto colptr = [&](int c) {
    const int l = c & (kLanes - 1), t = c >> 5;
    return s_base[l] + t * (n - l) - 16 * t * (t - 1);
  };

  // this CTA's columns of the lower triangle, packed; any non-finite entry?
  const float* Hb = H + mat * static_cast<int64_t>(n) * n;
  int bad = 0;
  if (lane >= lo_res && lane < hi_res) {
    for (int i = warp; i < n; i += nw)
      for (int c = lane; c <= i; c += kLanes) {
        const float x = Hb[static_cast<int64_t>(i) * n + c];
        bad |= !isfinite(x);
        Lc[colptr(c) + i - c] = x;
      }
  }
  bad = __syncthreads_or(bad);
  if (tid == 0) s_bad = bad;
  cluster.sync();  // every CTA of the cluster loaded
  bad = 0;
  for (int r = 0; r < R; ++r) bad |= *at_rank(&s_bad, r);
  if (bad) {
    cluster.sync();  // no CTA leaves while another reads its flag
    if (rank == 0 && tid == 0) lam[mat] = nan_f();
    return;
  }

  // -- 1. Householder tridiagonalisation ---------------------------------
  for (int j = 0; j + 2 < n; ++j) {
    const int m = n - j - 1;
    const int oj = s_owner[j & (kLanes - 1)];
    // the reflector of column j, by its owner's warp 0
    if (rank == oj && warp == 0) {
      float* col = Lc + colptr(j) - j;  // col[k] = A[k][j]
      float tau, beta;
      reflector(col, j, n, vb, &tau, &beta);
      __syncwarp();
      if (lane == 0) {
        s_tau = tau;
        col[j + 1] = beta;  // T's b_j
      }
    }
    cluster.sync();  // v and tau ready in the owner
    if (rank != oj) {
      const float* src = at_rank(vb, oj);
      for (int k = j + 1 + tid; k < n; k += nt) vb[k] = src[k];
      if (tid == 0) s_tau = *at_rank(&s_tau, oj);
      __syncthreads();
    }
    const float tau = s_tau;

    // the lane sums left of the diagonal of this CTA's lanes, every row
    for (int idx = tid; idx < nres * m; idx += nt) {
      const int sl = idx / m, i = j + 1 + (idx - sl * m);
      const int l = lo_res + sl;
      float r = 0.f;
      for (int c = first_ge(j + 1, l); c < i; c += kLanes)
        r = __fadd_rn(r, __fmul_rn(Lc[colptr(c) + i - c], vb[c]));
      rb[sl * n + i] = r;
    }
    cluster.sync();  // every CTA's left sums ready
    // p = tau A v, a warp a row of this CTA's residues: lane l's sum from
    // the diagonal here, its sum left of it from l's owner
    const int b0 = (j + 1) >> 5, nb = ((n + kLanes - 1) >> 5) - b0;
    for (int q = warp; q < nb * nres; q += nw) {
      const int i = ((b0 + q / nres) << 5) + lo_res + q % nres;
      if (i <= j || i >= n) continue;
      const float* coli = Lc + colptr(i) - i;  // coli[c] = A[c][i]
      const float r = at_rank(rb, s_owner[lane])[s_slot[lane] * n + i];
      float s = 0.f;
      for (int c = first_ge(i, lane); c < n; c += kLanes)
        s = __fadd_rn(s, __fmul_rn(coli[c], vb[c]));
      const float y = butterfly(__fadd_rn(r, s));
      if (lane == 0) pb[i] = __fmul_rn(tau, y);
    }
    __syncthreads();
    // lane l's sum of p.v over the rows = l (mod 32), by l's owner
    if (warp == 0 && lane < nres) {
      float kl = 0.f;
      for (int i = first_ge(j + 1, lo_res + lane); i < n; i += kLanes)
        kl = __fadd_rn(kl, __fmul_rn(pb[i], vb[i]));
      kb[lane] = kl;
    }
    cluster.sync();  // every CTA's p and p.v sums ready
    for (int i = j + 1 + tid; i < n; i += nt)
      pf[i] = at_rank(pb, s_owner[i & (kLanes - 1)])[i];
    const float kl = at_rank(kb, s_owner[lane])[s_slot[lane]];
    __syncthreads();
    const float coef = __fmul_rn(__fmul_rn(tau, -0.5f), butterfly(kl));
    // the rank-2 update of this CTA's trailing columns, a warp a column
    for (int q = warp; q < nb * nres; q += nw) {
      const int c = ((b0 + q / nres) << 5) + lo_res + q % nres;
      if (c <= j || c >= n) continue;
      const float vc = vb[c];
      const float wc = __fadd_rn(pf[c], __fmul_rn(coef, vc));
      float* col = Lc + colptr(c) - c;  // col[i] = A[i][c]
      for (int i = c + lane; i < n; i += kLanes) {
        const float vi = vb[i];
        const float wi = __fadd_rn(pf[i], __fmul_rn(coef, vi));
        col[i] = __fsub_rn(__fsub_rn(col[i], __fmul_rn(vi, wc)),
                           __fmul_rn(wi, vc));
      }
    }
    __syncthreads();
  }

  // -- T's diagonal a and off-diagonal b into CTA 0 (over v and p) --------
  cluster.sync();  // every update done, every remote read of p done
  if (rank == 0) {
    for (int i = tid; i < n; i += nt) {
      const float* src = at_rank(Lc, s_owner[i & (kLanes - 1)]) + colptr(i);
      vb[i] = src[0];
      if (i + 1 < n) pb[i] = src[1];
    }
  }
  cluster.sync();  // no CTA leaves while CTA 0 reads it
  if (rank != 0) return;

  // -- 2. Sturm multisection ----------------------------------------------
  sturm_stage(vb, pb, n, lam + mat);
}

using CtaKernel = void (*)(const float*, float*, int);

// How a block of width n is laid out: R CTAs (1: one CTA holding both
// triangles; more: a cluster holding the packed lower triangle), the floats
// of the largest CTA's columns, the most residues a CTA owns, the threads a
// CTA and its dynamic shared memory. False when no cluster of at most
// kMaxCluster CTAs holds it.
struct Plan {
  int R, cap, smax, threads;
  size_t bytes;
};

bool plan_for(int n, Plan* plan) {
  const size_t one =
      (static_cast<size_t>(n) * (n + 1) + 3 * n + kLanes) * sizeof(float);
  if (one <= static_cast<size_t>(kSmemBytes)) {
    *plan = {1, n * (n + 1), 0, n <= 64 ? 128 : n <= 128 ? 256 : kMaxThreads,
             one};
    return true;
  }
  for (int R = 2; R <= kMaxCluster; ++R) {
    int cap = 0, smax = 0;
    for (int r = 0; r < R; ++r) {
      const int first = (kLanes * r) / R, end = (kLanes * (r + 1)) / R;
      int size = 0;
      for (int l = first; l < end; ++l) size += residue_size(n, l);
      cap = size > cap ? size : cap;
      smax = end - first > smax ? end - first : smax;
    }
    const size_t floats = static_cast<size_t>(cap) +
                          static_cast<size_t>(n) * (3 + smax) + kLanes;
    if (floats * sizeof(float) <= static_cast<size_t>(kSmemBytes)) {
      *plan = {R, cap, smax, kClusterThreads, floats * sizeof(float)};
      return true;
    }
  }
  return false;
}

// The launch configuration of a cluster plan on `stream`.
struct ClusterLaunch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  ClusterLaunch(const Plan& plan, int T, cudaStream_t stream) : cfg{}, attr{} {
    cfg.gridDim = dim3(static_cast<unsigned>(T) * plan.R);
    cfg.blockDim = dim3(plan.threads);
    cfg.dynamicSmemBytes = plan.bytes;
    cfg.stream = stream;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = plan.R;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
  }
};

// What a process has set up on each device: the attributes of the one-CTA
// kernels (more than 48 KB of dynamic shared memory) and of the cluster
// kernel (kSmemBytes, clusters above 8 CTAs), both set per device and
// context, and whether each cluster size can be placed there (0 not yet
// probed, 1 yes, -1 no). Guarded by g_mutex.
struct DeviceSetup {
  bool cta_attributes = false;
  bool cluster_attributes = false;
  int placeable[kMaxCluster + 1] = {};
};
std::mutex g_mutex;
DeviceSetup g_setup[kMaxDevices];

// The current device's setup, or nullptr (with *err set) when it cannot
// be told. The caller holds g_mutex.
DeviceSetup* current_setup(cudaError_t* err) {
  int dev = 0;
  *err = cudaGetDevice(&dev);
  if (*err != cudaSuccess) return nullptr;
  if (dev < 0 || dev >= kMaxDevices) {
    *err = cudaErrorInvalidDevice;
    return nullptr;
  }
  return &g_setup[dev];
}

// Lets the one-CTA kernels of more than 48 KB take kSmemBytes, once a
// device. The caller holds g_mutex.
cudaError_t cta_attributes(DeviceSetup* setup) {
  if (setup->cta_attributes) return cudaSuccess;
  for (CtaKernel kernel :
       {&eigmin_cta_kernel<4>, &eigmin_cta_kernel<5>, &eigmin_cta_kernel<6>,
        &eigmin_cta_kernel<7>, &eigmin_cta_kernel<8>}) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (e != cudaSuccess) return e;
  }
  setup->cta_attributes = true;
  return cudaSuccess;
}

// Lets the cluster kernel take kSmemBytes and clusters above 8 CTAs, once a
// device. The caller holds g_mutex.
cudaError_t cluster_attributes(DeviceSetup* setup) {
  if (setup->cluster_attributes) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      eigmin_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(eigmin_cluster_kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  setup->cluster_attributes = e == cudaSuccess;
  return e;
}

}  // namespace

// The CTAs a block of width d takes: 1, or the cluster size; -1 when none
// holds it.
extern "C" int fia_block_eigmin_cluster(int d) {
  Plan plan;
  if (d <= 0 || !plan_for(d, &plan)) return -1;
  return plan.R;
}

// How many clusters of width d's size the current device holds at once (0
// when it cannot place one; -1 at a width of one CTA a block, or on an
// error).
extern "C" int fia_block_eigmin_resident_clusters(int d) {
  Plan plan;
  if (d <= 0 || !plan_for(d, &plan) || plan.R == 1) return -1;
  std::lock_guard<std::mutex> lock(g_mutex);
  cudaError_t e;
  DeviceSetup* setup = current_setup(&e);
  if (setup == nullptr || cluster_attributes(setup) != cudaSuccess) return -1;
  ClusterLaunch launch(plan, 64, nullptr);
  int clusters = 0;
  if (cudaOccupancyMaxActiveClusters(&clusters, eigmin_cluster_kernel,
                                     &launch.cfg) != cudaSuccess)
    return -1;
  return clusters;
}

// Launches the kernel on `stream` (on the current device) and returns
// cudaGetLastError() (0 on success). H is (T, d, d) float32, read from its
// lower triangles; lam (T,) float32, every entry written. 1 <= d <= 1024.
// T == 0 launches nothing. A cluster size the device cannot place returns
// cudaErrorLaunchOutOfResources (probed once a size and device, at a width's
// first call there, which runs eagerly before any capture).
extern "C" int fia_block_eigmin(const void* H, void* lam, int T, int d,
                                void* stream) {
  if (T <= 0) return 0;
  Plan plan;
  if (d <= 0 || d > 1024 || !plan_for(d, &plan) || plan.threads < kPoints)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* h = static_cast<const float*>(H);
  float* out = static_cast<float*>(lam);
  if (plan.R == 1) {
    if (plan.bytes > 48 * 1024) {
      std::lock_guard<std::mutex> lock(g_mutex);
      cudaError_t e;
      DeviceSetup* setup = current_setup(&e);
      if (setup == nullptr) return static_cast<int>(e);
      e = cta_attributes(setup);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    static const CtaKernel kernels[] = {
        &eigmin_cta_kernel<1>, &eigmin_cta_kernel<2>, &eigmin_cta_kernel<3>,
        &eigmin_cta_kernel<4>, &eigmin_cta_kernel<5>, &eigmin_cta_kernel<6>,
        &eigmin_cta_kernel<7>, &eigmin_cta_kernel<8>};
    const CtaKernel kernel = kernels[(d + kLanes - 1) / kLanes - 1];
    kernel<<<T, plan.threads, plan.bytes, st>>>(h, out, d);
    return static_cast<int>(cudaGetLastError());
  }
  ClusterLaunch launch(plan, T, st);
  {
    std::lock_guard<std::mutex> lock(g_mutex);
    cudaError_t e;
    DeviceSetup* setup = current_setup(&e);
    if (setup == nullptr) return static_cast<int>(e);
    e = cluster_attributes(setup);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (setup->placeable[plan.R] == 0) {
      int clusters = 0;
      e = cudaOccupancyMaxActiveClusters(&clusters, eigmin_cluster_kernel,
                                         &launch.cfg);
      if (e != cudaSuccess) return static_cast<int>(e);
      setup->placeable[plan.R] = clusters > 0 ? 1 : -1;
    }
    if (setup->placeable[plan.R] < 0)
      return static_cast<int>(cudaErrorLaunchOutOfResources);
  }
  const cudaError_t e = cudaLaunchKernelEx(&launch.cfg, eigmin_cluster_kernel,
                                           h, out, d, plan.R, plan.cap,
                                           plan.smax);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

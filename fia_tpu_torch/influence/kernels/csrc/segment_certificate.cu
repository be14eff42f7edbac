// The sampled rung's per-query certificate sums, for Hopper (sm_90a).
//
// Replaces the reference's XLA segment reductions of the certificate,
// fia_tpu/influence/sampled.py:103-124 (segment_sample_std) and
// fia_tpu/influence/engine.py:2492-2522 (gx, h, gnorm, the two segment
// maxima): not a Pallas kernel there, a hand kernel here.
//
// What it computes. The flat axis holds every query's related rows, query t
// owning rows [off[t], off[t+1]) (off clamped to the flat pad S). For each
// row s of segment t:
//   gx_s = g_s . ihvp_t
//   h_s  = (wv_s g_s) gx_s + abe_s Cx_t          (d values)
//   mask_s = (ws_s > 0)
// and for each segment:
//   mu_t    = sum_s mask_s h_s / max(m_t, 1)
//   ss_t    = sum_s || (h_s - mu_t) mask_s ||^2
//   sigma_t = sqrt(ss_t / max(m_t - 1, 1))
//   gmax_t  = max(0, max_s wv_s 2 |e_s| sqrt(g_s . g_s))
//   wmax_t  = max(0, max_s wv_s)
// A non-finite h on any row, sampled or not, makes mu_t and so sigma_t NaN,
// as the reference's multiply by the 0/1 mask does; a NaN in the maxima
// propagates as the reference's max does; an empty segment gives 0; rows
// past the last segment belong to none.
//
// Design. Two launches, no atomics: each output and scratch entry has one
// writer.
//  1. cert_pieces_kernel, one block a piece slot. A segment's rows are cut
//     into pieces of P rows counted from its own start (P = the wrapper's
//     CERT_PIECE_ROWS, a constant); piece q of segment t sits in slot
//     floor(off[t] / P) + t + q, so the pieces of every segment make one flat
//     list of work items, below floor(S / P) + T + 1. A block finds its
//     segment by a block-wide search over off (__syncthreads_count, two or
//     three steps at T <= 65,536; no host read, so the call can be captured
//     in a CUDA graph); a slot where no piece starts exits. The longest
//     related set (85,904 rows at ML-1M shape) spreads over 336 blocks on
//     all 132 SMs, where one segment's 64 warps walked it before. A row has
//     G lanes (G = 8 at d <= 64, several rows a warp; 32 above), each lane
//     its columns lane, lane + G, ...; a row's dots g . ihvp and g . g are
//     each lane's columns in column order, then a log2(G)-step xor butterfly
//     within the row's lanes (every lane ends with the same bits). The 128
//     threads make 128 / G row groups; group k walks the piece's rows k,
//     k + 128 / G, ... in order, and the groups' column sums are added in
//     group order. The block writes the piece's sum of mask h (d values),
//     its sampled count c_q, its maxima, and M2_q, the sum over its sampled
//     rows of || h - S_q / c_q ||^2: a second walk over the piece's sampled
//     rows only, which are still in L1/L2.
//  2. cert_combine_kernel, one block a segment: mu = (sum of the pieces'
//     sums in piece order) / max(m, 1), each column's pieces cut into fixed
//     chunks summed in order, then the chunks in order; then
//       ss = sum_q (M2_q + c_q || S_q / c_q - mu ||^2)
//     over the pieces with c_q > 0, in piece order (each piece's term a
//     column-order dot), which is sum over sampled rows of ||h - mu||^2
//     exactly in real arithmetic; NaN if any entry of mu is not finite.
//     sigma = sqrt(ss / max(m - 1, 1)); the maxima over the pieces (exact in
//     any order).
// Every multiply and add rounds on its own (__fmul_rn / __fadd_rn: no
// contraction into an FMA). The order of every sum depends only on the
// segment's own rows (pieces from its start, rows and groups within a
// piece, chunks a function of its piece count), never on T, S or where the
// segment sits, so a query's bound is the same bits in any batch. The plain
// version (kernels/certificate.py) takes the reference's two-pass order:
// kernel against plain is a tolerance comparison.
//
// Bound on an H100. Each input read once: g (S d floats) and the four row
// vectors over the rows inside segments, ihvp and Cx (T d), off and m;
// three (T,) outputs. At ML-1M shape, k = 16, T = 1024 (348,499 rows, d =
// 34 / 64): 53 / 95 MB, 16 / 28 us at 3.35 TB/s; about 10 S d flops, far
// below the float32 rate: bound by bytes. The first walk reads each row once,
// coalesced, with ceil(d / 8) loads a lane and a three-step butterfly a row
// at d <= 64 (the earlier, warp-a-row design spent a 32-lane row step and
// two five-step butterflies on every row, and one segment's 64 warps on its
// 671 pieces).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxD = 1024;
constexpr int kStats = 4;  // a slot's scalars: M2, sampled count, gmax, wmax

__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fc00000); }

// max that propagates NaN, as the reference's jnp max does
__device__ __forceinline__ float nanmax(float a, float b) {
  return (a != a || b != b) ? nan_f() : fmaxf(a, b);
}

// rows [r0, r1) of segment t: off clamped to S
__device__ __forceinline__ void segment_rows(const int64_t* off, int64_t t,
                                             int64_t S, int64_t* r0,
                                             int64_t* r1) {
  int64_t b = off[t + 1];
  b = b < S ? b : S;
  int64_t a = off[t];
  a = a < S ? a : S;
  *r0 = a < b ? a : b;
  *r1 = b;
}

// slot of segment t's piece 0
__device__ __forceinline__ int64_t first_slot(const int64_t* off, int64_t t,
                                              int64_t S, int64_t P) {
  int64_t a = off[t];
  a = a < S ? a : S;
  return a / P + t;
}

// sum over the G lanes of a row group (every lane the same bits)
template <int G>
__device__ __forceinline__ float group_sum(float v, unsigned mask) {
#pragma unroll
  for (int k = G / 2; k >= 1; k >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(mask, v, k));
  return v;
}

template <int G, int NC>
__global__ void __launch_bounds__(kThreads)
cert_pieces_kernel(const float* __restrict__ g, const float* __restrict__ ihvp,
                   const float* __restrict__ cx, const float* __restrict__ wv,
                   const float* __restrict__ ws, const float* __restrict__ abe,
                   const float* __restrict__ e, const int64_t* __restrict__ off,
                   float* __restrict__ part, float* __restrict__ part_s,
                   int64_t S, int T, int d, int64_t P) {
  constexpr int NG = kThreads / G;  // row groups
  constexpr int kRedD = G == 8 ? 64 : kMaxD;  // the widest d of this G
  __shared__ float red[NG * kRedD];
  __shared__ float mean[kMaxD];
  __shared__ float gred[3][NG];
  const int tid = threadIdx.x;
  const int64_t j = blockIdx.x;

  // -- the slot's segment: the last t with first_slot(t) <= j --------------
  int64_t lo = -1, hi = T;
  while (hi - lo > 1) {
    const int64_t span = hi - lo - 1;
    const bool each = span <= kThreads;
    const int64_t n = each ? span : kThreads;
    const int64_t m = lo + 1 + (each ? tid : tid * span / kThreads);
    const int c = __syncthreads_count(tid < n && first_slot(off, m, S, P) <= j);
    if (c == 0) {
      hi = lo + 1;
    } else {
      const int64_t k = c - 1;
      const int64_t below = lo + 1 + (each ? k : k * span / kThreads);
      if (c < n) hi = lo + 1 + (each ? c : c * span / kThreads);
      lo = below;
    }
  }
  if (lo < 0) return;
  const int64_t t = lo;
  int64_t r0, r1;
  segment_rows(off, t, S, &r0, &r1);
  const int64_t q = j - first_slot(off, t, S, P);
  const int64_t p0 = r0 + q * P;
  if (p0 >= r1) return;  // no piece starts in this slot
  const int64_t p1 = p0 + P < r1 ? p0 + P : r1;

  const int grp = tid / G, sub = tid % G;
  const unsigned mask =
      G == 32 ? 0xffffffffu : (((1u << G) - 1u) << ((tid & 31) / G * G));
  float x[NC], c[NC], acc[NC];
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    const int col = sub + G * k;
    x[k] = col < d ? ihvp[t * d + col] : 0.f;
    c[k] = col < d ? cx[t * d + col] : 0.f;
    acc[k] = 0.f;
  }

  // -- walk 1: every row, in order within the group ------------------------
  float gm = 0.f, wm = 0.f;
  for (int64_t r = p0 + grp; r < p1; r += NG) {
    const float* gr = g + r * d;
    float gv[NC], px = 0.f, pg = 0.f;
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      const int col = sub + G * k;
      gv[k] = col < d ? gr[col] : 0.f;
      if (col < d) {
        px = __fadd_rn(px, __fmul_rn(gv[k], x[k]));
        pg = __fadd_rn(pg, __fmul_rn(gv[k], gv[k]));
      }
    }
    const float gx = group_sum<G>(px, mask), gg = group_sum<G>(pg, mask);
    const float w = wv[r], ab = abe[r];
    const float msk = ws[r] > 0.f ? 1.f : 0.f;
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      if (sub + G * k < d) {
        const float h = __fadd_rn(__fmul_rn(__fmul_rn(w, gv[k]), gx),
                                  __fmul_rn(ab, c[k]));
        acc[k] = __fadd_rn(acc[k], __fmul_rn(h, msk));
      }
    }
    gm = nanmax(gm, __fmul_rn(__fmul_rn(__fmul_rn(w, 2.f), fabsf(e[r])),
                              __fsqrt_rn(gg)));
    wm = nanmax(wm, w);
  }
  // the sampled count (integers: exact in any order)
  int cnt = 0;
  for (int64_t r0c = p0; r0c < p1; r0c += kThreads) {
    const int64_t r = r0c + tid;
    cnt += __syncthreads_count(r < p1 && ws[r] > 0.f);
  }
  // the groups' column sums in group order: S_q; its mean S_q / c_q
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    const int col = sub + G * k;
    if (col < d) red[grp * d + col] = acc[k];
  }
  if (sub == 0) {
    gred[0][grp] = gm;
    gred[1][grp] = wm;
  }
  __syncthreads();
  float* pq = part + j * d;
  const float cf = static_cast<float>(cnt);
  for (int col = tid; col < d; col += kThreads) {
    float s = red[col];
    for (int k = 1; k < NG; ++k) s = __fadd_rn(s, red[k * d + col]);
    pq[col] = s;
    mean[col] = cnt > 0 ? __fdiv_rn(s, cf) : 0.f;
  }
  __syncthreads();

  // -- walk 2: the sampled rows only, M2_q about the piece's mean ----------
  float m2 = 0.f;
  if (cnt > 0) {
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      const int col = sub + G * k;
      acc[k] = col < d ? mean[col] : 0.f;
    }
    for (int64_t r = p0 + grp; r < p1; r += NG) {
      if (!(ws[r] > 0.f)) continue;  // the same in every lane of the group
      const float* gr = g + r * d;
      float gv[NC], px = 0.f;
#pragma unroll
      for (int k = 0; k < NC; ++k) {
        const int col = sub + G * k;
        gv[k] = col < d ? gr[col] : 0.f;
        if (col < d) px = __fadd_rn(px, __fmul_rn(gv[k], x[k]));
      }
      const float gx = group_sum<G>(px, mask);
      const float w = wv[r], ab = abe[r];
      float psq = 0.f;
#pragma unroll
      for (int k = 0; k < NC; ++k) {
        if (sub + G * k < d) {
          const float h = __fadd_rn(__fmul_rn(__fmul_rn(w, gv[k]), gx),
                                    __fmul_rn(ab, c[k]));
          const float dv = __fsub_rn(h, acc[k]);
          psq = __fadd_rn(psq, __fmul_rn(dv, dv));
        }
      }
      m2 = __fadd_rn(m2, group_sum<G>(psq, mask));
    }
  }
  if (sub == 0) gred[2][grp] = m2;
  __syncthreads();
  if (tid == 0) {
    float a = gred[2][0], b = gred[0][0], w = gred[1][0];
    for (int k = 1; k < NG; ++k) {
      a = __fadd_rn(a, gred[2][k]);
      b = nanmax(b, gred[0][k]);
      w = nanmax(w, gred[1][k]);
    }
    float* st = part_s + j * kStats;
    st[0] = a;
    st[1] = cf;
    st[2] = b;
    st[3] = w;
  }
}

__global__ void __launch_bounds__(kThreads)
cert_combine_kernel(const int64_t* __restrict__ off,
                    const int* __restrict__ m, const float* __restrict__ part,
                    const float* __restrict__ part_s,
                    float* __restrict__ sigma, float* __restrict__ gmax,
                    float* __restrict__ wmax, int64_t S, int d, int64_t P) {
  __shared__ float mu[kMaxD];
  __shared__ float chunk[kThreads];
  __shared__ float mx[2][kThreads];
  const int tid = threadIdx.x;
  const int64_t t = blockIdx.x;
  int64_t r0, r1;
  segment_rows(off, t, S, &r0, &r1);
  const int64_t np = (r1 - r0 + P - 1) / P;
  const int64_t base = first_slot(off, t, S, P);
  const float* ps = part_s + base * kStats;

  // the maxima over the pieces (exact in any order)
  float a = 0.f, b = 0.f;
  for (int64_t q = tid; q < np; q += kThreads) {
    a = nanmax(a, ps[q * kStats + 2]);
    b = nanmax(b, ps[q * kStats + 3]);
  }
  mx[0][tid] = a;
  mx[1][tid] = b;

  // mu: each column's pieces in R fixed chunks of L, each in piece order,
  // then the chunks in order
  const int dc = d < kThreads ? d : kThreads;
  const int R = kThreads / dc;
  const int64_t L = (np + R - 1) / R;
  const float cnt = fmaxf(static_cast<float>(m[t]), 1.f);
  for (int col0 = 0; col0 < d; col0 += dc) {
    const int col = col0 + tid % dc, k = tid / dc;
    float s = 0.f;
    if (k < R && col < d) {
      const int64_t q1 = (k + 1) * L < np ? (k + 1) * L : np;
      for (int64_t q = k * L; q < q1; ++q)
        s = __fadd_rn(s, part[(base + q) * d + col]);
    }
    __syncthreads();
    if (k < R) chunk[tid] = s;
    __syncthreads();
    if (k == 0 && col < d) {
      float v = chunk[tid];
      for (int u = 1; u < R; ++u) v = __fadd_rn(v, chunk[u * dc + tid]);
      mu[col] = __fdiv_rn(v, cnt);
    }
  }
  __syncthreads();
  bool fin = true;
  for (int col = tid; col < d; col += kThreads) fin = fin && isfinite(mu[col]);
  const bool finite = __syncthreads_and(fin);

  // ss: the pieces' terms M2_q + c_q || S_q / c_q - mu ||^2 in chunks of
  // pieces, each chunk in piece order, then the chunks in order
  const int64_t L2 = (np + kThreads - 1) / kThreads;
  float part_ss = 0.f;
  {
    const int64_t q0 = tid * L2;
    const int64_t q1 = q0 + L2 < np ? q0 + L2 : np;
    for (int64_t q = q0; q < q1; ++q) {
      const float c = ps[q * kStats + 1];
      if (!(c > 0.f)) continue;
      const float* sq = part + (base + q) * d;
      float dist = 0.f;
      for (int col = 0; col < d; ++col) {
        const float dv = __fsub_rn(__fdiv_rn(sq[col], c), mu[col]);
        dist = __fadd_rn(dist, __fmul_rn(dv, dv));
      }
      part_ss = __fadd_rn(part_ss, __fadd_rn(ps[q * kStats], __fmul_rn(c, dist)));
    }
  }
  chunk[tid] = part_ss;
  __syncthreads();
  if (tid == 0) {
    float ss = chunk[0];
    float ga = mx[0][0], wa = mx[1][0];
    for (int k = 1; k < kThreads; ++k) {
      ss = __fadd_rn(ss, chunk[k]);
      ga = nanmax(ga, mx[0][k]);
      wa = nanmax(wa, mx[1][k]);
    }
    const float dof = fmaxf(__fsub_rn(static_cast<float>(m[t]), 1.f), 1.f);
    sigma[t] = finite ? __fsqrt_rn(__fdiv_rn(ss, dof)) : nan_f();
    gmax[t] = ga;
    wmax[t] = wa;
  }
}

template <int G, int NC>
cudaError_t launch(const float* g, const float* ihvp, const float* cx,
                   const float* wv, const float* ws, const float* abe,
                   const float* e, const int64_t* off, const int* m,
                   float* sigma, float* gmax, float* wmax, float* part,
                   float* part_s, int64_t S, int T, int d, int64_t P,
                   cudaStream_t st) {
  const long long slots = S / P + T + 1;
  if (slots > 2147483647LL) return cudaErrorInvalidConfiguration;
  cert_pieces_kernel<G, NC><<<static_cast<unsigned>(slots), kThreads, 0, st>>>(
      g, ihvp, cx, wv, ws, abe, e, off, part, part_s, S, T, d, P);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cert_combine_kernel<<<static_cast<unsigned>(T), kThreads, 0, st>>>(
      off, m, part, part_s, sigma, gmax, wmax, S, d, P);
  return cudaGetLastError();
}

}  // namespace

// Launches the two passes on `stream` and returns cudaGetLastError() (0 on
// success). The caller checks device, dtype, shape and contiguity and
// allocates sigma, gmax, wmax (T,) and the scratch part (slots, d) and
// part_s (slots, 4), slots = floor(S / piece) + T + 1; every output entry
// is written. g is (S, d); ihvp, cx (T, d); wv, ws, abe, e (S,); off
// (T + 1,) int64; m (T,) int32. d <= 1024. T == 0 launches nothing.
extern "C" int fia_segment_certificate(
    const void* g, const void* ihvp, const void* cx, const void* wv,
    const void* ws, const void* abe, const void* e, const void* off,
    const void* m, void* sigma, void* gmax, void* wmax, void* part,
    void* part_s, long long S, int T, int d, long long piece, void* stream) {
  if (T <= 0) return 0;
  if (piece <= 0 || S < 0 || d <= 0 || d > kMaxD)
    return static_cast<int>(cudaErrorInvalidValue);
#define FIA_CERT_ARGS                                                        \
  static_cast<const float*>(g), static_cast<const float*>(ihvp),             \
      static_cast<const float*>(cx), static_cast<const float*>(wv),          \
      static_cast<const float*>(ws), static_cast<const float*>(abe),         \
      static_cast<const float*>(e), static_cast<const int64_t*>(off),        \
      static_cast<const int*>(m), static_cast<float*>(sigma),                \
      static_cast<float*>(gmax), static_cast<float*>(wmax),                  \
      static_cast<float*>(part), static_cast<float*>(part_s), S, T, d,       \
      piece, static_cast<cudaStream_t>(stream)
  cudaError_t err;
  if (d <= 8)
    err = launch<8, 1>(FIA_CERT_ARGS);
  else if (d <= 16)
    err = launch<8, 2>(FIA_CERT_ARGS);
  else if (d <= 32)
    err = launch<8, 4>(FIA_CERT_ARGS);
  else if (d <= 40)
    err = launch<8, 5>(FIA_CERT_ARGS);
  else if (d <= 64)
    err = launch<8, 8>(FIA_CERT_ARGS);
  else if (d <= 128)
    err = launch<32, 4>(FIA_CERT_ARGS);
  else if (d <= 256)
    err = launch<32, 8>(FIA_CERT_ARGS);
  else if (d <= 512)
    err = launch<32, 16>(FIA_CERT_ARGS);
  else
    err = launch<32, 32>(FIA_CERT_ARGS);
#undef FIA_CERT_ARGS
  return static_cast<int>(err);
}

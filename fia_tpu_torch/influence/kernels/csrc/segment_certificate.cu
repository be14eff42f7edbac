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
// propagates as the reference's max does.
//
// The order, and why a query's bits do not follow its batch. A segment's
// rows are cut into pieces of P rows counted from the segment's own start
// (P = the wrapper's CERT_PIECE_ROWS, a constant). One warp walks a piece
// in row order. A row's dots are each lane's columns (lane, lane + 32, ...)
// summed in column order, then a xor butterfly over the warp, which leaves
// every lane the same bits; each column's partial adds the rows in row
// order. Piece partials go to a scratch slot each and are added in piece
// order. Every multiply and add rounds on its own (__fmul_rn / __fadd_rn:
// no contraction into an FMA). Nothing of that order depends on T, S or
// where the segment sits on the flat axis. No atomics: each output and
// scratch entry has one writer.
//
// Design. Three launches.
//  1. cert_sums_kernel, grid (segment, 8): the 64 warps of a segment take
//     its pieces in turn (piece q to warp q mod 64); a warp holds ihvp_t
//     and Cx_t for its columns in registers, walks the piece's rows (each
//     row read once, coalesced), and writes the piece's sum of mask h and
//     its maxima to slot floor(off[t] / P) + t + q.
//  2. cert_dev_kernel, same grid: each warp adds the segment's partials in
//     piece order into mu for its columns; warp 0 of block 0 writes gmax
//     and wmax. When mu is finite the unsampled rows add exact zeros to ss,
//     so a warp walks only the sampled rows of its pieces (a ballot over 32
//     rows' ws at a time, the set rows in row order): the pass reads g for
//     m_t rows, not n_t. A non-finite mu writes NaN partials.
//  3. cert_sigma_kernel, a thread a segment: ss in piece order, sigma.
//
// Bound on an H100. Each input read once: g (S d floats), the five (S,)
// row vectors, ihvp and Cx (T d), off and m; three (T,) outputs. At ML-1M
// shape, k = 16, T = 1024 (about 348,000 rows, d = 34 / 64): 53 / 95 MB,
// 16 / 28 us at 3.35 TB/s; about 6 S d flops, far below the float32 rate:
// bound by bytes. What holds it above that: each row is one warp-wide step
// with two five-step butterflies (gx and g.g) and only one or two columns a
// lane at d <= 64, so the walk issues many instructions a byte.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kYBlocks = 8;  // blocks a segment: 64 warps share its pieces
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fc00000); }

// max that propagates NaN, as the reference's jnp max does
__device__ __forceinline__ float nanmax(float a, float b) {
  return (a != a || b != b) ? nan_f() : fmaxf(a, b);
}

// xor butterfly: lane L adds its partner's value to its own at each step;
// float addition commutes exactly, so every lane ends with the same bits
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int k = 16; k >= 1; k >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(kFull, v, k));
  return v;
}

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

// the lane's columns of row `r` of g, and its partials of g . x and g . g
template <int NC>
__device__ __forceinline__ void row_dots(const float* __restrict__ g,
                                         int64_t r, int d, int lane,
                                         const float (&x)[NC], float (&gv)[NC],
                                         float* gx, float* gg) {
  const float* gr = g + r * d;
  float px = 0.f, pg = 0.f;
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    const int c = lane + 32 * k;
    gv[k] = c < d ? gr[c] : 0.f;
    if (c < d) {
      px = __fadd_rn(px, __fmul_rn(gv[k], x[k]));
      pg = __fadd_rn(pg, __fmul_rn(gv[k], gv[k]));
    }
  }
  *gx = px;
  *gg = pg;
}

template <int NC>
__device__ __forceinline__ void query_cols(const float* __restrict__ a,
                                           int64_t t, int d, int lane,
                                           float (&out)[NC]) {
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    const int c = lane + 32 * k;
    out[k] = c < d ? a[t * d + c] : 0.f;
  }
}

template <int NC>
__global__ void __launch_bounds__(kThreads)
cert_sums_kernel(const float* __restrict__ g, const float* __restrict__ ihvp,
                 const float* __restrict__ cx, const float* __restrict__ wv,
                 const float* __restrict__ ws, const float* __restrict__ abe,
                 const float* __restrict__ e, const int64_t* __restrict__ off,
                 float* __restrict__ part, float* __restrict__ part_gm,
                 float* __restrict__ part_wm, int64_t S, int d, int64_t P) {
  const int64_t t = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int64_t r0, r1;
  segment_rows(off, t, S, &r0, &r1);
  const int64_t np = (r1 - r0 + P - 1) / P;
  int64_t q = static_cast<int64_t>(blockIdx.y) * kWarps + warp;
  if (q >= np) return;  // the whole warp: q is the same in every lane
  const int64_t stride = static_cast<int64_t>(gridDim.y) * kWarps;
  const int64_t base = r0 / P + t;
  float x[NC], c[NC];
  query_cols<NC>(ihvp, t, d, lane, x);
  query_cols<NC>(cx, t, d, lane, c);
  for (; q < np; q += stride) {
    const int64_t p0 = r0 + q * P;
    const int64_t p1 = p0 + P < r1 ? p0 + P : r1;
    float acc[NC];
#pragma unroll
    for (int k = 0; k < NC; ++k) acc[k] = 0.f;
    float gm = 0.f, wm = 0.f;
    for (int64_t r = p0; r < p1; ++r) {
      float gv[NC], px, pg;
      row_dots<NC>(g, r, d, lane, x, gv, &px, &pg);
      const float gx = warp_sum(px), gg = warp_sum(pg);
      const float w = wv[r], ab = abe[r];
      const float mask = ws[r] > 0.f ? 1.f : 0.f;
#pragma unroll
      for (int k = 0; k < NC; ++k) {
        if (lane + 32 * k < d) {
          const float h = __fadd_rn(__fmul_rn(__fmul_rn(w, gv[k]), gx),
                                    __fmul_rn(ab, c[k]));
          acc[k] = __fadd_rn(acc[k], __fmul_rn(h, mask));
        }
      }
      gm = nanmax(gm, __fmul_rn(__fmul_rn(__fmul_rn(w, 2.f), fabsf(e[r])),
                                __fsqrt_rn(gg)));
      wm = nanmax(wm, w);
    }
    const int64_t slot = base + q;
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      const int col = lane + 32 * k;
      if (col < d) part[slot * d + col] = acc[k];
    }
    if (lane == 0) {
      part_gm[slot] = gm;
      part_wm[slot] = wm;
    }
  }
}

template <int NC>
__global__ void __launch_bounds__(kThreads)
cert_dev_kernel(const float* __restrict__ g, const float* __restrict__ ihvp,
                const float* __restrict__ cx, const float* __restrict__ wv,
                const float* __restrict__ ws, const float* __restrict__ abe,
                const int64_t* __restrict__ off, const int* __restrict__ m,
                const float* __restrict__ part,
                const float* __restrict__ part_gm,
                const float* __restrict__ part_wm, float* __restrict__ part_ss,
                float* __restrict__ gmax, float* __restrict__ wmax, int64_t S,
                int d, int64_t P) {
  const int64_t t = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int64_t r0, r1;
  segment_rows(off, t, S, &r0, &r1);
  const int64_t np = (r1 - r0 + P - 1) / P;
  const int64_t base = r0 / P + t;
  if (blockIdx.y == 0 && warp == 0) {
    // max is exact in any order: lanes take pieces in turn
    float a = 0.f, b = 0.f;
    for (int64_t q = lane; q < np; q += 32) {
      a = nanmax(a, part_gm[base + q]);
      b = nanmax(b, part_wm[base + q]);
    }
#pragma unroll
    for (int k = 16; k >= 1; k >>= 1) {
      a = nanmax(a, __shfl_xor_sync(kFull, a, k));
      b = nanmax(b, __shfl_xor_sync(kFull, b, k));
    }
    if (lane == 0) {
      gmax[t] = a;
      wmax[t] = b;
    }
  }
  int64_t q = static_cast<int64_t>(blockIdx.y) * kWarps + warp;
  if (q >= np) return;
  const int64_t stride = static_cast<int64_t>(gridDim.y) * kWarps;
  const float cnt = fmaxf(static_cast<float>(m[t]), 1.f);
  float mu[NC], x[NC], c[NC];
  bool finite = true;
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    const int col = lane + 32 * k;
    float s = 0.f;
    if (col < d) {
      for (int64_t j = 0; j < np; ++j)
        s = __fadd_rn(s, part[(base + j) * d + col]);
      s = __fdiv_rn(s, cnt);
      finite = finite && isfinite(s);
    }
    mu[k] = s;
  }
  finite = __all_sync(kFull, finite);
  query_cols<NC>(ihvp, t, d, lane, x);
  query_cols<NC>(cx, t, d, lane, c);
  for (; q < np; q += stride) {
    const int64_t p0 = r0 + q * P;
    const int64_t p1 = p0 + P < r1 ? p0 + P : r1;
    float acc = finite ? 0.f : nan_f();
    for (int64_t c0 = p0; finite && c0 < p1; c0 += 32) {
      const int64_t r = c0 + lane;
      unsigned bits = __ballot_sync(kFull, r < p1 && ws[r] > 0.f);
      while (bits) {  // the sampled rows of these 32, in row order
        const int64_t rr = c0 + (__ffs(bits) - 1);
        bits &= bits - 1;
        float gv[NC], px, pg;
        row_dots<NC>(g, rr, d, lane, x, gv, &px, &pg);
        const float gx = warp_sum(px);
        const float w = wv[rr], ab = abe[rr];
        float psq = 0.f;
#pragma unroll
        for (int k = 0; k < NC; ++k) {
          if (lane + 32 * k < d) {
            const float h = __fadd_rn(__fmul_rn(__fmul_rn(w, gv[k]), gx),
                                      __fmul_rn(ab, c[k]));
            const float dv = __fsub_rn(h, mu[k]);  // times mask 1: exact
            psq = __fadd_rn(psq, __fmul_rn(dv, dv));
          }
        }
        acc = __fadd_rn(acc, warp_sum(psq));
      }
    }
    if (lane == 0) part_ss[base + q] = acc;
  }
}

__global__ void cert_sigma_kernel(const int64_t* __restrict__ off,
                                  const int* __restrict__ m,
                                  const float* __restrict__ part_ss,
                                  float* __restrict__ sigma, int64_t S, int T,
                                  int64_t P) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= T) return;
  int64_t r0, r1;
  segment_rows(off, t, S, &r0, &r1);
  const int64_t np = (r1 - r0 + P - 1) / P;
  const int64_t base = r0 / P + t;
  float ss = 0.f;
  for (int64_t q = 0; q < np; ++q) ss = __fadd_rn(ss, part_ss[base + q]);
  const float dof = fmaxf(__fsub_rn(static_cast<float>(m[t]), 1.f), 1.f);
  sigma[t] = __fsqrt_rn(__fdiv_rn(ss, dof));
}

template <int NC>
cudaError_t launch(const float* g, const float* ihvp, const float* cx,
                   const float* wv, const float* ws, const float* abe,
                   const float* e, const int64_t* off, const int* m,
                   float* sigma, float* gmax, float* wmax, float* part,
                   float* part_gm, float* part_wm, float* part_ss, int64_t S,
                   int T, int d, int64_t P, cudaStream_t st) {
  const dim3 grid(static_cast<unsigned>(T), kYBlocks);
  cert_sums_kernel<NC><<<grid, kThreads, 0, st>>>(
      g, ihvp, cx, wv, ws, abe, e, off, part, part_gm, part_wm, S, d, P);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cert_dev_kernel<NC><<<grid, kThreads, 0, st>>>(
      g, ihvp, cx, wv, ws, abe, off, m, part, part_gm, part_wm, part_ss, gmax,
      wmax, S, d, P);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cert_sigma_kernel<<<(T + 255) / 256, 256, 0, st>>>(off, m, part_ss, sigma,
                                                     S, T, P);
  return cudaGetLastError();
}

}  // namespace

// Launches the three passes on `stream` and returns cudaGetLastError() (0 on
// success). The caller checks device, dtype, shape and contiguity and
// allocates sigma, gmax, wmax (T,) and the scratch part (slots, d), part_gm,
// part_wm, part_ss (slots,), slots = floor(S / piece) + T + 1; every output
// entry is written. g is (S, d); ihvp, cx (T, d); wv, ws, abe, e (S,); off
// (T + 1,) int64; m (T,) int32. d <= 1024. T == 0 launches nothing.
extern "C" int fia_segment_certificate(
    const void* g, const void* ihvp, const void* cx, const void* wv,
    const void* ws, const void* abe, const void* e, const void* off,
    const void* m, void* sigma, void* gmax, void* wmax, void* part,
    void* part_gm, void* part_wm, void* part_ss, long long S, int T, int d,
    long long piece, void* stream) {
  if (T <= 0) return 0;
  if (piece <= 0 || S < 0 || d <= 0 || d > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nc = (d + 31) / 32;
#define FIA_CERT_ARGS                                                        \
  static_cast<const float*>(g), static_cast<const float*>(ihvp),             \
      static_cast<const float*>(cx), static_cast<const float*>(wv),          \
      static_cast<const float*>(ws), static_cast<const float*>(abe),         \
      static_cast<const float*>(e), static_cast<const int64_t*>(off),        \
      static_cast<const int*>(m), static_cast<float*>(sigma),                \
      static_cast<float*>(gmax), static_cast<float*>(wmax),                  \
      static_cast<float*>(part), static_cast<float*>(part_gm),               \
      static_cast<float*>(part_wm), static_cast<float*>(part_ss), S, T, d,   \
      piece, static_cast<cudaStream_t>(stream)
  cudaError_t err;
  if (nc <= 1)
    err = launch<1>(FIA_CERT_ARGS);
  else if (nc <= 2)
    err = launch<2>(FIA_CERT_ARGS);
  else if (nc <= 4)
    err = launch<4>(FIA_CERT_ARGS);
  else if (nc <= 8)
    err = launch<8>(FIA_CERT_ARGS);
  else if (nc <= 16)
    err = launch<16>(FIA_CERT_ARGS);
  else
    err = launch<32>(FIA_CERT_ARGS);
#undef FIA_CERT_ARGS
  return static_cast<int>(err);
}

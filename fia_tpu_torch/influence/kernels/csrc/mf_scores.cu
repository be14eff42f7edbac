// MF fused influence-score kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel fia_tpu/influence/kernels/mf.py:_kernel (driven
// by fused_scores there, through kernels/common.py:run_tiled).
//
// What it computes. For flat related row s, owned by query t = t_s, with
// the query's augmented row B[t] = [x (d) | reg_dot | n_t], x its iHVP,
// d = 2k + 2, and (u_t, i_t) = tx[t]:
//   a_s  = [user_s == u_t],  b_s = [item_s == i_t]
//   gdot = a_s (Q[item_s] . x[0:k] + x[2k]) + b_s (P[user_s] . x[k:2k] + x[2k+1])
//   out_s = wv_s (2 e_s gdot + reg_dot) / n_t
// g_s = [a Q[item]; b P[user]; a; b] is the row's closed-form block
// gradient; it is never formed, and neither is the (S, 2k) row gather
// the TPU kernel streams: each row reads its two table rows itself.
//
// Bound on an H100. The tables (P, Q) and B are small at the shapes the
// flat path runs (ML-1M, k = 16: P 6040x16, Q 3706x16, B <= 1024x36, all
// fp32, under 1 MB together), so after first touch they live in the 50 MB
// L2. Device-memory traffic is then ~24 bytes a row (user/item ids, t, e,
// wv in; the score out): at S ~ 1e5..5e5 rows that is 2.4..12 MB, a few
// microseconds at 3.35 TB/s, and ~4k + 10 flops a row is far below the
// fp32 rate. The kernel is bound by bytes, and at these sizes its launch
// latency is of the same order as the bound.
//
// What the design does about it. Four lanes cooperate on one row: each
// lane loads 16-byte float4 slices of Q[item], P[user] and the two halves
// of x, so a row's table reads are coalesced 64-byte runs at k = 16, and
// the partial dots meet in two warp shuffles. The per-row scalars are
// read once per lane from the same cache line. No shared memory, no
// atomics, no inter-block communication: every row is independent, and
// the order of every sum is fixed, so results are deterministic. B rows
// are fetched by index (the TPU kernel's one-hot MXU fetch is a TPU
// trick). k is a runtime argument; the float4 path needs k % 4 == 0 and
// 16-byte aligned tables, else a scalar path runs.
//
// The divide by n_t stays a divide (not a reciprocal multiply) so the
// epilogue is the same arithmetic as the plain version; a row with
// wv = 0 scores exactly 0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 4;             // lanes per row
constexpr int kThreads = 256;         // threads per block
constexpr int kRowsPerBlock = kThreads / kLanes;

template <bool kVec4>
__global__ void __launch_bounds__(kThreads)
mf_fused_scores_kernel(const int32_t* __restrict__ rel_x,   // (S, 2)
                       const int32_t* __restrict__ seg,     // (S,)
                       const float* __restrict__ e,         // (S,)
                       const float* __restrict__ wv,        // (S,)
                       const int32_t* __restrict__ tx,      // (T, 2)
                       const float* __restrict__ P,         // (U, k)
                       const float* __restrict__ Q,         // (I, k)
                       const float* __restrict__ B,         // (T, 2k + 4)
                       float* __restrict__ out,             // (S,)
                       int64_t S, int k) {
  const int64_t s = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock +
                    threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  // Rows past S still take part in the shuffles below (every lane of the
  // warp must), reading row S - 1, and store nothing.
  const bool live = s < S;
  const int64_t r = live ? s : S - 1;

  const int t = seg[r];
  const int user = rel_x[2 * r];
  const int item = rel_x[2 * r + 1];
  const int d = 2 * k + 2;
  const float* x = B + static_cast<int64_t>(t) * (d + 2);
  const float* q = Q + static_cast<int64_t>(item) * k;
  const float* p = P + static_cast<int64_t>(user) * k;

  float dq = 0.0f;  // Q[item] . x[0:k]
  float dp = 0.0f;  // P[user] . x[k:2k]
  if (kVec4) {
    const float4* q4 = reinterpret_cast<const float4*>(q);
    const float4* p4 = reinterpret_cast<const float4*>(p);
    const float4* xq4 = reinterpret_cast<const float4*>(x);
    const float4* xp4 = reinterpret_cast<const float4*>(x + k);
    for (int j = lane; j < k / 4; j += kLanes) {
      const float4 a = __ldg(q4 + j), xa = __ldg(xq4 + j);
      const float4 b = __ldg(p4 + j), xb = __ldg(xp4 + j);
      dq += a.x * xa.x + a.y * xa.y + a.z * xa.z + a.w * xa.w;
      dp += b.x * xb.x + b.y * xb.y + b.z * xb.z + b.w * xb.w;
    }
  } else {
    for (int j = lane; j < k; j += kLanes) {
      dq += __ldg(q + j) * __ldg(x + j);
      dp += __ldg(p + j) * __ldg(x + k + j);
    }
  }
#pragma unroll
  for (int off = kLanes / 2; off > 0; off /= 2) {
    dq += __shfl_xor_sync(0xffffffffu, dq, off, kLanes);
    dp += __shfl_xor_sync(0xffffffffu, dp, off, kLanes);
  }

  if (live && lane == 0) {
    const float a = (user == tx[2 * t]) ? 1.0f : 0.0f;
    const float b = (item == tx[2 * t + 1]) ? 1.0f : 0.0f;
    const float gdot = a * (dq + x[2 * k]) + b * (dp + x[2 * k + 1]);
    out[s] = wv[s] * (2.0f * e[s] * gdot + x[d]) / x[d + 1];
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success). The
// caller checks device, dtype, shape and contiguity and allocates `out`;
// S == 0 launches nothing.
extern "C" int fia_mf_fused_scores(const void* rel_x, const void* seg,
                                   const void* e, const void* wv,
                                   const void* tx, const void* P,
                                   const void* Q, const void* B, void* out,
                                   long long S, int k, int vec4,
                                   void* stream) {
  if (S <= 0) return 0;
  const dim3 block(kThreads);
  const dim3 grid(static_cast<unsigned>((S + kRowsPerBlock - 1) / kRowsPerBlock));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FIA_MF_ARGS                                                        \
  static_cast<const int32_t*>(rel_x), static_cast<const int32_t*>(seg),   \
      static_cast<const float*>(e), static_cast<const float*>(wv),        \
      static_cast<const int32_t*>(tx), static_cast<const float*>(P),      \
      static_cast<const float*>(Q), static_cast<const float*>(B),         \
      static_cast<float*>(out), static_cast<int64_t>(S), k
  if (vec4) {
    mf_fused_scores_kernel<true><<<grid, block, 0, st>>>(FIA_MF_ARGS);
  } else {
    mf_fused_scores_kernel<false><<<grid, block, 0, st>>>(FIA_MF_ARGS);
  }
#undef FIA_MF_ARGS
  return static_cast<int>(cudaGetLastError());
}

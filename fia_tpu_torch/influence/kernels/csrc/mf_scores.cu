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
// fp32 rate. The kernel is bound by bytes; at these sizes its launch
// latency is of the same order as the bound. What held the first design
// back was latency, not bytes: a row made three dependent round trips to
// memory (its ids; the gathers; then tx, e, wv and B's scalars), and
// ~5 waves of blocks each paid all three. This one still pays, each grid
// step, the round trip of its gathers from L2, behind the stream of ids
// from device memory.
//
// What the design does about it. A warp takes 32 consecutive rows a grid
// step; lane l owns row l's ids and epilogue (so the id loads and the
// score stores are coalesced), and each group of four lanes shares the
// dots of its four rows. The ids (seg, rel_x, e, wv) come in two buffers,
// each loaded a whole step before it is read and written by the load
// itself (a register copy between buffers would wait for the load). A step
// then reads tx and B's scalars for its rows and gathers, for each row,
// only the side its gdot reads: Q[item] . x[0:k] when a = 1, else
// P[user] . x[k:2k] when b = 1 (the other term is multiplied by 0; a row
// with a = b = 1 reads both, a row with neither reads none). That halves
// the gathered bytes. The gathers are float4, a row's 64 bytes read by its
// four lanes together; the four lanes' partial dots meet in a transposing
// shuffle reduction that leaves each lane its own row's sum (3 shuffles).
// The grid is one wave of resident blocks (occupancy queried once per
// device and path, so a CUDA-graph capture makes no query), walking rows
// with a grid stride; 128-thread blocks, five to an SM, ran fastest on an
// H100. No shared memory, no atomics, and the order of every sum is fixed,
// so results are deterministic. B rows are fetched by index (the TPU
// kernel's one-hot MXU fetch is a TPU trick). k is a runtime argument; the
// float4 path needs k % 4 == 0 and 16-byte aligned tables, else a scalar
// path runs.
//
// The divide by n_t stays a divide (not a reciprocal multiply) so the
// epilogue is the same arithmetic as the plain version; a row with
// wv = 0 scores exactly 0.
//
// ptxas (CUDA 12.9, sm_90a, -O3), as chip_smoke.py's build phase prints
// it on an H100: 96 registers a thread for both the float4 and the scalar
// instantiation, no spills.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 4;     // lanes, and rows, of a group
constexpr int kThreads = 128;
// Resident blocks an SM is asked to hold: caps registers at 65,536 /
// (5 * 128) = 102 a thread (ptxas takes 96). More blocks need fewer
// registers than the double-buffered ids and the four rows' gathers hold,
// and spill; fewer leave too few rows' loads in flight.
constexpr int kMinBlocks = 5;
constexpr int kWarpsPerBlock = kThreads / 32;

// One row's ids. A row past S reads row S - 1 and stores nothing.
struct RowIds {
  int t, user, item;
  float e, w;
};

__device__ __forceinline__ RowIds load_row(const int32_t* __restrict__ rel_x,
                                           const int32_t* __restrict__ seg,
                                           const float* __restrict__ e,
                                           const float* __restrict__ wv,
                                           int64_t s, int64_t S) {
  const int64_t r = s < S ? s : S - 1;
  RowIds q;
  q.t = __ldg(seg + r);
  q.user = __ldg(rel_x + 2 * r);
  q.item = __ldg(rel_x + 2 * r + 1);
  q.e = __ldg(e + r);
  q.w = __ldg(wv + r);
  return q;
}

// v[i] is this lane's part of row i of its group; returns the sum over the
// group's four lanes of v[sub], sub = this lane's place in the group. The
// order of the sums is fixed by lane positions.
__device__ __forceinline__ float group_sum(const float (&v)[kLanes], int sub) {
  const bool hi = sub & 2, lo = sub & 1;
  float a0 = hi ? v[2] : v[0], a1 = hi ? v[3] : v[1];
  a0 += __shfl_xor_sync(0xffffffffu, hi ? v[0] : v[2], 2);
  a1 += __shfl_xor_sync(0xffffffffu, hi ? v[1] : v[3], 2);
  return (lo ? a1 : a0) + __shfl_xor_sync(0xffffffffu, lo ? a0 : a1, 1);
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// Scores the warp's 32 rows base .. base + 31 (lane l owns row base + l,
// whose ids are `cur`); the group's four lanes share its rows' dots.
template <bool kVec4>
__device__ __forceinline__ void score_step(
    const RowIds& cur, int64_t base, const int32_t* __restrict__ tx,
    const float* __restrict__ P, const float* __restrict__ Q,
    const float* __restrict__ B, float* __restrict__ out, int64_t S, int k) {
  constexpr unsigned kAll = 0xffffffffu;
  const int lane = threadIdx.x % 32;
  const int first = lane & ~(kLanes - 1);  // the group's first lane
  const int sub = lane % kLanes;
  const int d = 2 * k + 2;

  // the owned row: its indicators and B scalars
  const bool a = cur.user == __ldg(tx + 2 * cur.t);
  const bool b = cur.item == __ldg(tx + 2 * cur.t + 1);
  const float* xo = B + static_cast<int64_t>(cur.t) * (d + 2);
  const float xa = __ldg(xo + 2 * k), xb = __ldg(xo + 2 * k + 1);
  const float reg = __ldg(xo + d), n_t = __ldg(xo + d + 1);
  // the side a row's gdot reads: Q[item] . x[0:k] when a, else
  // P[user] . x[k:2k] when b (the other term is multiplied by 0)
  const int id = a ? cur.item : cur.user;
  const int flags = (a ? 1 : 0) | (b ? 2 : 0);

  // the group's rows' gathers, all issued before any is used
  const float* tp[kLanes];
  const float* xp[kLanes];
  bool need[kLanes];
#pragma unroll
  for (int i = 0; i < kLanes; ++i) {
    const int t_i = __shfl_sync(kAll, cur.t, first + i);
    const int id_i = __shfl_sync(kAll, id, first + i);
    const int f_i = __shfl_sync(kAll, flags, first + i);
    need[i] = f_i != 0;
    tp[i] = ((f_i & 1) ? Q : P) + static_cast<int64_t>(id_i) * k;
    xp[i] = B + static_cast<int64_t>(t_i) * (d + 2) + ((f_i & 1) ? 0 : k);
  }
  float dd[kLanes];
#pragma unroll
  for (int i = 0; i < kLanes; ++i) dd[i] = 0.0f;
  if (kVec4) {
#pragma unroll 1
    for (int j = sub; j < k / 4; j += kLanes) {
      float4 tv[kLanes], xv[kLanes];
#pragma unroll
      for (int i = 0; i < kLanes; ++i) {
        tv[i] = xv[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (need[i]) {
          tv[i] = __ldg(reinterpret_cast<const float4*>(tp[i]) + j);
          xv[i] = __ldg(reinterpret_cast<const float4*>(xp[i]) + j);
        }
      }
#pragma unroll
      for (int i = 0; i < kLanes; ++i) dd[i] += dot4(tv[i], xv[i]);
    }
  } else {
#pragma unroll 1
    for (int j = sub; j < k; j += kLanes) {
      float tv[kLanes], xv[kLanes];
#pragma unroll
      for (int i = 0; i < kLanes; ++i) {
        tv[i] = xv[i] = 0.0f;
        if (need[i]) {
          tv[i] = __ldg(tp[i] + j);
          xv[i] = __ldg(xp[i] + j);
        }
      }
#pragma unroll
      for (int i = 0; i < kLanes; ++i) dd[i] += tv[i] * xv[i];
    }
  }
  const float sd = group_sum(dd, sub);

  // a row that is its query's own pair (a = b = 1) reads both sides: the
  // P[user] . x[k:2k] term too
  float sp = 0.0f;
  if (__any_sync(kAll, a && b)) {
    float dp[kLanes];
#pragma unroll
    for (int i = 0; i < kLanes; ++i) {
      const int t_i = __shfl_sync(kAll, cur.t, first + i);
      const int user_i = __shfl_sync(kAll, cur.user, first + i);
      const int f_i = __shfl_sync(kAll, flags, first + i);
      const float* p = P + static_cast<int64_t>(user_i) * k;
      const float* x = B + static_cast<int64_t>(t_i) * (d + 2) + k;
      dp[i] = 0.0f;
      if (f_i == 3) {
        for (int j = sub; j < k; j += kLanes)
          dp[i] += __ldg(p + j) * __ldg(x + j);
      }
    }
    sp = group_sum(dp, sub);
  }

  const int64_t s = base + lane;
  if (s < S) {
    // gdot = a (dq + x[2k]) + b (dp + x[2k+1]), with a, b in {0, 1}
    float gdot = 0.0f;
    if (a && b) {
      gdot = (sd + xa) + (sp + xb);
    } else if (a) {
      gdot = sd + xa;
    } else if (b) {
      gdot = sd + xb;
    }
    out[s] = cur.w * (2.0f * cur.e * gdot + reg) / n_t;
  }
}

template <bool kVec4>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
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
  const int lane = threadIdx.x % 32;
  const int64_t step = static_cast<int64_t>(gridDim.x) * kWarpsPerBlock * 32;
  int64_t base = (static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock +
                  threadIdx.x / 32) * 32;
  // Two buffers of ids, each loaded a whole step before it is read. Each
  // load writes the buffer it fills directly: a copy from one buffer to
  // the other would wait for the load to land.
  RowIds ia = load_row(rel_x, seg, e, wv, base + lane, S);
  for (; base < S; base += 2 * step) {  // warp-uniform: the shuffles need all
    const RowIds ib = load_row(rel_x, seg, e, wv, base + step + lane, S);
    score_step<kVec4>(ia, base, tx, P, Q, B, out, S, k);
    if (base + step >= S) break;
    ia = load_row(rel_x, seg, e, wv, base + 2 * step + lane, S);
    score_step<kVec4>(ib, base + step, tx, P, Q, B, out, S, k);
  }
}

// Blocks of the kernel the card holds at once, per (device, path); kept
// so that a repeated call (as inside a CUDA graph capture) makes no
// attribute or occupancy query.
struct Geometry {
  int dev = -1;
  long long resident[2] = {0, 0};  // [scalar, vec4]
  int err = 0;
};

Geometry geometry(int dev) {
  Geometry g;
  g.dev = dev;
  int sms = 0, per_sm = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, &mf_fused_scores_kernel<false>, kThreads, 0);
  g.resident[0] = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, &mf_fused_scores_kernel<true>, kThreads, 0);
  g.resident[1] = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  g.err = static_cast<int>(cudaGetLastError());
  return g;
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
  static Geometry cached;
  if (S <= 0) return 0;
  int dev = 0;
  cudaGetDevice(&dev);
  if (cached.dev != dev) cached = geometry(dev);
  if (cached.err != 0) return cached.err;
  const long long rows_per_block = static_cast<long long>(kThreads);
  const long long blocks = (S + rows_per_block - 1) / rows_per_block;
  const long long resident = cached.resident[vec4 ? 1 : 0];
  const dim3 grid(static_cast<unsigned>(blocks < resident ? blocks : resident));
  const dim3 block(kThreads);
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

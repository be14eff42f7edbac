// NCF fused influence-score kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel fia_tpu/influence/kernels/ncf.py:_kernel (driven
// by fused_scores there, through kernels/common.py:run_tiled).
//
// What it computes. For flat related row s, owned by query t = t_s, with
// (u_t, i_t) = tx[t], a = [user_s == u_t], b = [item_s == i_t], the query's
// augmented row B[t] = [x (d) | reg_dot | n_t], d = 4k, k2 = k / 2, and
// pm, qm, pg, qg the rows P_mlp[user_s], Q_mlp[item_s], P_gmf[user_s],
// Q_gmf[item_s]:
//   z1   = [pm | qm] W1 + b1                       (k)
//   z2   = relu(z1) W2 + b2                        (k2)
//   dz2  = [z2 > 0] * W3[:k2, 0]                   (W3's h2 rows first,
//   dz1  = [z1 > 0] * (dz2 W2^T)                    then its GMF rows w3g)
//   dhin = dz1 W1^T                                (2k)
//   gdot = a (dhin[:k] . x[:k]  + (qg * w3g) . x[2k:3k])
//        + b (dhin[k:] . x[k:2k] + (pg * w3g) . x[3k:4k])
//   out_s = wv_s (2 e_s gdot + reg_dot) / n_t
// i.e. the row's closed-form block gradient (one MLP backward) dotted with
// the query's iHVP. Neither the gradient nor the (S, 4k) row gather the TPU
// kernel streams is ever formed in device memory: each row gathers its four
// embedding rows itself and reads B[t] by index (the TPU kernel's one-hot
// MXU fetch is a TPU trick).
//
// Bound on an H100. Form every product that depends on the query alone
// once per query (its own rows times W1, W1's halves times x, w3g * x).
// A row matching one query id then needs k^2 FMAs for the other half of
// [pm | qm] W1, k*k2 each for z2 and dz2 W2^T, and 2k for its two dots:
// about 2k^2 + 4k FMAs, 1,093 flops at k = 16 with the epilogue. At the
// flat path's ML-1M shape (k = 16, T = 1024, ~348k rows) that is ~0.38
// GFLOP, ~5.7 us at the 67 TFLOP/s fp32 rate outside the tensor cores
// (TF32 is off by policy), while the bytes are ~24 a row plus ~1.5 MB of
// tables, weights and B, ~3 us at 3.35 TB/s. So unlike MF this kernel is
// bound by operations. chip_smoke.py:ncf_bound_ms counts this from the
// run's rows.
//
// What the design does about it. One warp per row, its lanes striding over
// hidden units, so every width k works with no per-thread arrays sized by k.
// The MLP weights (W1, b1, W2, b2, W3) are staged once per block in shared
// memory with odd row strides, so both the forward (lanes along a row of
// W1/W2) and the backward (lanes down a column) read them without bank
// conflicts; the weights' reads leave device memory after the first block.
// Above kStageMax bytes (W1 alone is 8k^2 bytes: 512 KB at k = 256) the
// weights are read from global memory (L2/L1) instead. Each warp keeps its
// row's [pm|qm], z1, dz2 and dz1 in a per-warp shared-memory scratch; a warp
// shuffle reduction forms gdot. Rows with wv = 0 write 0 and rows matching
// neither query id write the reg_dot term, both without the MLP work, so the
// work done is what the data needs. Every FMA here takes a shared-memory
// operand and at k = 16 half the lanes idle in z1 and dz1, so the design is
// bound by the rate of shared-memory loads, well above the operations bound.
// It also does twice the bound's work: each row forms all of [pm | qm] W1
// and dhin's k-long dots (about 2,130 flops at k = 16). Hoisting the
// per-query products and register blocking over several rows a warp are
// the next steps. Every sum's order is fixed, so results are deterministic.
//
// The relu masks are strict ([z > 0], relu'(0) = 0, as the reference's
// jax.nn.relu gradient); the divide by n_t stays a divide, as in the plain
// version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;                  // rows in flight per block
constexpr int kThreads = kWarps * 32;      // threads per block
constexpr size_t kStageMax = 96 * 1024;    // staged-weights path, bytes

// floats of the per-warp scratch: [pm|qm] (2k), z1 (k), dz2 (k2), dz1 (k)
__host__ __device__ inline int scratch_floats(int k, int k2) {
  return 4 * k + k2;
}

// floats of the staged weights, W1 and W2 at odd row strides
__host__ __device__ inline int staged_floats(int k, int k2) {
  return 2 * k * (k | 1) + k * (k2 | 1) + k + k2 + (k2 + k);
}

template <bool kStage>
__global__ void __launch_bounds__(kThreads)
ncf_fused_scores_kernel(const int32_t* __restrict__ rel_x,   // (S, 2)
                        const int32_t* __restrict__ seg,     // (S,)
                        const float* __restrict__ e,         // (S,)
                        const float* __restrict__ wv,        // (S,)
                        const int32_t* __restrict__ tx,      // (T, 2)
                        const float* __restrict__ Pm,        // (U, k)
                        const float* __restrict__ Qm,        // (I, k)
                        const float* __restrict__ Pg,        // (U, k)
                        const float* __restrict__ Qg,        // (I, k)
                        const float* __restrict__ W1g,       // (2k, k)
                        const float* __restrict__ b1g,       // (k,)
                        const float* __restrict__ W2g,       // (k, k2)
                        const float* __restrict__ b2g,       // (k2,)
                        const float* __restrict__ W3g,       // (k2 + k, 1)
                        const float* __restrict__ B,         // (T, 4k + 2)
                        float* __restrict__ out,             // (S,)
                        int64_t S, int k, int k2) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;

  const float *W1, *b1, *W2, *b2, *W3;
  int ld1, ld2;  // row strides of W1, W2 as read
  float* scratch;
  if (kStage) {
    ld1 = k | 1;
    ld2 = k2 | 1;
    float* sW1 = smem;
    float* sW2 = sW1 + 2 * k * ld1;
    float* sb1 = sW2 + k * ld2;
    float* sb2 = sb1 + k;
    float* sW3 = sb2 + k2;
    for (int n = threadIdx.x; n < 2 * k * k; n += kThreads)
      sW1[(n / k) * ld1 + n % k] = W1g[n];
    for (int n = threadIdx.x; n < k * k2; n += kThreads)
      sW2[(n / k2) * ld2 + n % k2] = W2g[n];
    for (int n = threadIdx.x; n < k; n += kThreads) sb1[n] = b1g[n];
    for (int n = threadIdx.x; n < k2; n += kThreads) sb2[n] = b2g[n];
    for (int n = threadIdx.x; n < k2 + k; n += kThreads) sW3[n] = W3g[n];
    __syncthreads();
    W1 = sW1; b1 = sb1; W2 = sW2; b2 = sb2; W3 = sW3;
    scratch = sW3 + k2 + k;
  } else {
    ld1 = k;
    ld2 = k2;
    W1 = W1g; b1 = b1g; W2 = W2g; b2 = b2g; W3 = W3g;
    scratch = smem;
  }
  float* hin = scratch + warp * scratch_floats(k, k2);  // [pm | qm]
  float* z1 = hin + 2 * k;
  float* dz2 = z1 + k;
  float* dz1 = dz2 + k2;
  const int d = 4 * k;

  const int64_t step = static_cast<int64_t>(gridDim.x) * kWarps;
  for (int64_t s = static_cast<int64_t>(blockIdx.x) * kWarps + warp; s < S;
       s += step) {
    // every branch below depends on the row only: warp-uniform
    const float w = wv[s];
    if (w == 0.0f) {  // masked: the plain version's wv * (...) is 0
      if (lane == 0) out[s] = 0.0f;
      continue;
    }
    const int t = seg[s];
    const int user = rel_x[2 * s];
    const int item = rel_x[2 * s + 1];
    const float a = (user == tx[2 * t]) ? 1.0f : 0.0f;
    const float b = (item == tx[2 * t + 1]) ? 1.0f : 0.0f;
    const float* x = B + static_cast<int64_t>(t) * (d + 2);
    float part = 0.0f;  // this lane's share of gdot

    if (a != 0.0f || b != 0.0f) {  // else g_s = 0 and gdot = 0
      const float* pm = Pm + static_cast<int64_t>(user) * k;
      const float* qm = Qm + static_cast<int64_t>(item) * k;
      const float* pg = Pg + static_cast<int64_t>(user) * k;
      const float* qg = Qg + static_cast<int64_t>(item) * k;
      for (int j = lane; j < k; j += 32) {
        hin[j] = pm[j];
        hin[k + j] = qm[j];
      }
      __syncwarp();
      // forward: z1 = hin W1 + b1 (kept pre-activation: it sets the mask)
      for (int j = lane; j < k; j += 32) {
        float acc = b1[j];
        for (int m = 0; m < 2 * k; ++m) acc = fmaf(hin[m], W1[m * ld1 + j], acc);
        z1[j] = acc;
      }
      __syncwarp();
      // z2 = relu(z1) W2 + b2, and at once dz2 = [z2 > 0] w3h
      for (int j = lane; j < k2; j += 32) {
        float acc = b2[j];
        for (int m = 0; m < k; ++m)
          acc = fmaf(fmaxf(z1[m], 0.0f), W2[m * ld2 + j], acc);
        dz2[j] = acc > 0.0f ? W3[j] : 0.0f;
      }
      __syncwarp();
      // dz1 = [z1 > 0] (dz2 W2^T)
      for (int j = lane; j < k; j += 32) {
        float acc = 0.0f;
        if (z1[j] > 0.0f) {
          for (int m = 0; m < k2; ++m) acc = fmaf(dz2[m], W2[j * ld2 + m], acc);
        }
        dz1[j] = acc;
      }
      __syncwarp();
      // dhin = dz1 W1^T, each entry dotted with its x entry at once; the
      // half whose indicator is 0 contributes exactly 0 and is skipped
      for (int m = lane; m < 2 * k; m += 32) {
        const float c = m < k ? a : b;
        if (c != 0.0f) {
          float dh = 0.0f;
          for (int j = 0; j < k; ++j) dh = fmaf(dz1[j], W1[m * ld1 + j], dh);
          part = fmaf(dh, x[m], part);
        }
      }
      // the GMF terms: a (qg * w3g) . x[2k:3k] + b (pg * w3g) . x[3k:4k]
      for (int j = lane; j < k; j += 32) {
        const float w3g = W3[k2 + j];
        if (a != 0.0f) part = fmaf(qg[j] * w3g, x[2 * k + j], part);
        if (b != 0.0f) part = fmaf(pg[j] * w3g, x[3 * k + j], part);
      }
      __syncwarp();  // the scratch is rewritten by the warp's next row
    }
#pragma unroll
    for (int off = 16; off > 0; off /= 2)
      part += __shfl_xor_sync(0xffffffffu, part, off);
    if (lane == 0) out[s] = w * (2.0f * e[s] * part + x[d]) / x[d + 1];
  }
}

// The launch geometry of one (device, k): the staged or the global-weights
// path, its dynamic shared memory, and the blocks the card holds at once.
struct Geometry {
  int dev = -1, k = -1, k2 = -1;
  bool stage = false;
  size_t smem = 0;
  long long resident = 0;
  int err = 0;
};

Geometry geometry(int dev, int k, int k2) {
  Geometry g;
  g.dev = dev;
  g.k = k;
  g.k2 = k2;
  const size_t scratch = sizeof(float) * kWarps * scratch_floats(k, k2);
  const size_t staged = sizeof(float) * staged_floats(k, k2) + scratch;
  g.stage = staged <= kStageMax;
  g.smem = g.stage ? staged : scratch;
  int sms = 0, per_sm = 0, smem_max = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  if (g.smem > static_cast<size_t>(smem_max)) {
    g.err = static_cast<int>(cudaErrorInvalidValue);
    return g;
  }
  const void* fn = g.stage
      ? reinterpret_cast<const void*>(&ncf_fused_scores_kernel<true>)
      : reinterpret_cast<const void*>(&ncf_fused_scores_kernel<false>);
  if (g.smem > 48 * 1024) {
    cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(g.smem));
  }
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads,
                                                g.smem);
  g.resident = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  g.err = static_cast<int>(cudaGetLastError());
  return g;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue when k is too wide for the per-warp scratch. The
// caller checks device, dtype, shape and contiguity and allocates `out`;
// S == 0 launches nothing. Each block walks rows with a grid stride, and
// the grid is sized to the blocks the card holds at once, so the staged
// weights are loaded once per resident block. The geometry of the last
// (device, k) is kept, so a repeated call (as inside a CUDA graph
// capture) makes no attribute or occupancy query.
extern "C" int fia_ncf_fused_scores(
    const void* rel_x, const void* seg, const void* e, const void* wv,
    const void* tx, const void* P_mlp, const void* Q_mlp, const void* P_gmf,
    const void* Q_gmf, const void* W1, const void* b1, const void* W2,
    const void* b2, const void* W3, const void* B, void* out, long long S,
    int k, int k2, void* stream) {
  static Geometry cached;
  if (S <= 0) return 0;
  if (k < 2 || k2 != k / 2) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaGetDevice(&dev);
  if (cached.dev != dev || cached.k != k || cached.k2 != k2) {
    cached = geometry(dev, k, k2);
  }
  if (cached.err != 0) return cached.err;
  const long long rows_blocks = (S + kWarps - 1) / kWarps;
  const dim3 grid(static_cast<unsigned>(
      rows_blocks < cached.resident ? rows_blocks : cached.resident));
  const dim3 block(kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FIA_NCF_ARGS                                                         \
  static_cast<const int32_t*>(rel_x), static_cast<const int32_t*>(seg),     \
      static_cast<const float*>(e), static_cast<const float*>(wv),          \
      static_cast<const int32_t*>(tx), static_cast<const float*>(P_mlp),    \
      static_cast<const float*>(Q_mlp), static_cast<const float*>(P_gmf),   \
      static_cast<const float*>(Q_gmf), static_cast<const float*>(W1),      \
      static_cast<const float*>(b1), static_cast<const float*>(W2),         \
      static_cast<const float*>(b2), static_cast<const float*>(W3),         \
      static_cast<const float*>(B), static_cast<float*>(out),               \
      static_cast<int64_t>(S), k, k2
  if (cached.stage) {
    ncf_fused_scores_kernel<true><<<grid, block, cached.smem, st>>>(
        FIA_NCF_ARGS);
  } else {
    ncf_fused_scores_kernel<false><<<grid, block, cached.smem, st>>>(
        FIA_NCF_ARGS);
  }
#undef FIA_NCF_ARGS
  return static_cast<int>(cudaGetLastError());
}

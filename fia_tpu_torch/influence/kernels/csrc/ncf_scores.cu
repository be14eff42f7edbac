// NCF fused influence-score kernels for Hopper (sm_90a).
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
// kernel streams is ever formed in device memory.
//
// Bound on an H100. Every product that depends on the query alone is
// formed once per query: cU = Pm[u_t] W1[:k], cI = Qm[i_t] W1[k:],
// rU = W1[:k] x[:k] (rU[j] = sum_m W1[m, j] x[m]), rI = W1[k:] x[k:2k],
// gU = w3g * x[2k:3k], gI = w3g * x[3k:4k]. Since dhin[:k] . x[:k] =
// dz1 . rU (and so for the item half), a row with a = 1 (its user is the
// query's) needs z1 = b1 + cU + qm W1[k:], a row with only b = 1 needs
// z1 = b1 + cI + pm W1[:k]; then z2, dz2 and dz1 as above and
// gdot = a (dz1 . rU + qg . gU) + b (dz1 . rI + pg . gI). That is about
// 2k^2 + 4k FMAs a row, 1,093 flops at k = 16 with the epilogue. At the
// flat path's ML-1M shape (k = 16, T = 1024, ~348k rows) that is ~0.38
// GFLOP, ~5.7 us at the 67 TFLOP/s fp32 rate outside the tensor cores
// (TF32 is off by policy), while the bytes are ~24 a row plus ~1.5 MB of
// tables, weights and B, ~3 us at 3.35 TB/s. So the kernel is bound by
// operations: fp32 FMA issue. chip_smoke.py:ncf_bound_ms counts this from
// the run's rows.
//
// What holds it back on an H100, as measured. The previous design (one
// warp a row, lanes over hidden units, every FMA fed by a shared-memory
// load, all per-query products formed per row) ran at 1.6% of the bound.
// This one reaches ~17% (chip_smoke.py, k = 16, T = 1024). Most of its
// issue slots go to instructions other than the FMAs (address arithmetic,
// the partition, masks, the gathers): it is bound by instruction issue,
// not by bytes, and not by shared memory (R = 4 rows a lane share twice
// as many weight loads as R = 2 and were not faster).
//
// What the design does about it. Two kernels on one stream, one C entry.
//  1. ncf_query_products_kernel writes Z (T, 6k) = [cU|rU|gU|cI|rI|gI],
//     one thread an entry, lanes along j so W1's columns are read
//     coalesced (~4k^2 FMAs a query: 1 MFLOP at T = 1024, k = 16).
//  2. ncf_rows_kernel<K, R, minBlocks>, for the widths the RQ2 sweep runs
//     (k = 8, 16, 32, 64, so the loops unroll and a row's arrays stay in
//     registers): R rows a lane, each row's z1, z2 and its z1 > 0 mask in
//     registers; no __syncwarp phases in the arithmetic. The MLP weights
//     are staged once a block in shared memory and read as warp-uniform
//     float4 broadcasts, each feeding 4 R FMAs. A shared-memory load
//     delivers one word a lane whatever the address, so a weight word must
//     feed several rows' FMAs: R rows of a lane share every W1 load, which
//     needs them to take one W1 half. So a warp partitions its tile of
//     32 R rows (ballots, a per-warp list in shared memory) into the rows
//     that take W1's item half (a = 1, or no id matched) and those that
//     take its user half (b = 1 only); a lane takes R consecutive entries,
//     and at most one lane of a tile holds rows of both halves, whose
//     minority rows it forms alone. A row reads its query's c, r and g
//     triple from Z (a segment's rows share it, so it stays in L1); its
//     gathers are prefetched to L1 as soon as the partition names them,
//     and the next tile's ids are loaded while this tile computes.
//  3. Any other k (or tables not 16-byte aligned) runs
//     ncf_rows_general_kernel: one warp a row, lanes over hidden units,
//     with the same hoisting, the weights staged in shared memory up to
//     kStageMax bytes (W1 alone is 8k^2 bytes: 512 KB at k = 256) and
//     read from L2 above it.
// A row with wv = 0 writes 0; a row matching neither query id writes its
// reg_dot term (gdot = 0). A row with a = b = 1 takes the a path (its
// qm W1[k:] is cI) and adds the b terms. Every sum's order is fixed and
// there are no atomics, so two launches give the same bits. The relu
// masks are strict ([z > 0], relu'(0) = 0, as the reference's jax.nn.relu
// gradient); the divide by n_t stays a divide, as in the plain version.
// The tensor cores are not used: TF32 is ruled out by the float32 policy.
//
// ptxas (CUDA 12.9, sm_90a, -O3), registers a thread and spills, as
// chip_smoke.py's build phase prints them on an H100: rows<8, 4, 3> 168,
// rows<16, 2, 4> 115, rows<32, 2, 3> 158, rows<64, 1, 3> 168, the general
// path 64 (weights staged) and 40 (from L2), the query products 32; no
// spills.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowThreads = 128;         // threads of a register-blocked block
constexpr int kPrepThreads = 256;        // threads of a query-products block
constexpr int kWarps = 8;                // rows in flight per general block
constexpr int kGenThreads = kWarps * 32;
constexpr size_t kStageMax = 96 * 1024;  // general path's staged weights

// The operands, as the C entry receives them.
struct Operands {
  const int32_t* rel_x;  // (S, 2)
  const int32_t* seg;    // (S,)
  const float* e;        // (S,)
  const float* wv;       // (S,)
  const int32_t* tx;     // (T, 2)
  const float* Pm;       // (U, k)
  const float* Qm;       // (I, k)
  const float* Pg;       // (U, k)
  const float* Qg;       // (I, k)
  const float* W1;       // (2k, k)
  const float* b1;       // (k,)
  const float* W2;       // (k, k2)
  const float* b2;       // (k2,)
  const float* W3;       // (k2 + k, 1)
  const float* B;        // (T, 4k + 2)
  float* Z;              // (T, 6k) scratch: the query products
  float* out;            // (S,)
  int64_t S;
  int T, k, k2;
};

// ---- 1. the query products --------------------------------------------

__global__ void __launch_bounds__(kPrepThreads)
ncf_query_products_kernel(const Operands op) {
  const int k = op.k;
  const int64_t n_out = static_cast<int64_t>(op.T) * 6 * k;
  const int64_t step = static_cast<int64_t>(gridDim.x) * kPrepThreads;
  for (int64_t n = static_cast<int64_t>(blockIdx.x) * kPrepThreads +
                   threadIdx.x;
       n < n_out; n += step) {
    const int t = static_cast<int>(n / (6 * k));
    const int rem = static_cast<int>(n - static_cast<int64_t>(t) * 6 * k);
    const int half = rem / (3 * k);             // 0: user's, 1: item's
    const int part = (rem - half * 3 * k) / k;  // 0: c, 1: r, 2: g
    const int j = rem % k;
    const float* x = op.B + static_cast<int64_t>(t) * (4 * k + 2);
    float acc;
    if (part == 2) {  // g = w3g * x[(2 + half) k:]
      acc = __ldg(op.W3 + op.k2 + j) * __ldg(x + (2 + half) * k + j);
    } else {
      // c = (Pm[u_t] | Qm[i_t]) W1-half, r = W1-half^T-dotted with x-half
      const float* v;
      if (part == 1) {
        v = x + half * k;
      } else {
        const int id = __ldg(op.tx + 2 * t + half);
        v = (half ? op.Qm : op.Pm) + static_cast<int64_t>(id) * k;
      }
      const float* w = op.W1 + static_cast<int64_t>(half) * k * k + j;
      acc = 0.0f;
#pragma unroll 16
      for (int m = 0; m < k; ++m)
        acc = fmaf(__ldg(v + m), __ldg(w + static_cast<int64_t>(m) * k), acc);
    }
    op.Z[n] = acc;
  }
}

// ---- 2. rows, register-blocked, k a template parameter -----------------

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Starts moving the bytes [p, p + n) toward this SM's L1, without waiting.
__device__ __forceinline__ void prefetch_l1(const float* p, int n) {
  for (int i = 0; i < n; i += 32)
    asm volatile("prefetch.global.L1 [%0];" ::"l"(p + i));
}

__device__ __forceinline__ float4 zero4() {
  return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// One row's ids. A row past S reads row S - 1 and stores nothing.
struct RowIds {
  int t, user, item;
  float e, w;
};

__device__ __forceinline__ RowIds load_row(const Operands& op, int64_t s) {
  const int64_t r = s < op.S ? s : op.S - 1;
  RowIds q;
  q.t = __ldg(op.seg + r);
  q.user = __ldg(op.rel_x + 2 * r);
  q.item = __ldg(op.rel_x + 2 * r + 1);
  q.e = __ldg(op.e + r);
  q.w = __ldg(op.wv + r);
  return q;
}

// A warp's tile of rows in partition order: the rows whose z1 takes W1's
// item half (a = 1, or no id matched) first, then those that take its user
// half (b = 1 only), each part in row order.
template <int kTile>
struct TileRows {
  int off[kTile];    // the row's offset in the tile
  int t[kTile];
  int user[kTile];
  int item[kTile];
  int flags[kTile];  // bit 0: a, bit 1: b
  float e[kTile];
  float w[kTile];
};

// Offset of W1's item half (rows k..2k) in shared memory: 4 floats past
// k * k, so that lanes reading the two halves at once hit other banks.
template <int K>
__host__ __device__ constexpr int item_half() {
  return K * K + 4;
}

// A row's z1 > 0 bits: 32 bits where they fit (cheaper shifts).
template <bool kWide> struct MaskWord { using type = uint32_t; };
template <> struct MaskWord<true> { using type = uint64_t; };

template <int K, int R, int kMinBlocks>
__global__ void __launch_bounds__(kRowThreads, kMinBlocks)
ncf_rows_kernel(const Operands op) {
  using Mask = typename MaskWord<(K > 32)>::type;
  constexpr int K2 = K / 2;
  constexpr int kTile = 32 * R;  // rows of a warp's tile
  constexpr int kWarpsPerBlock = kRowThreads / 32;
  static_assert(K % 8 == 0 && K <= 64,
                "float4 paths need k and k2 multiples of 4; masks 64 bits");
  __shared__ __align__(16) float sW1[2 * K * K + 4];
  __shared__ __align__(16) float sW2[K * K2];
  __shared__ __align__(16) float sb1[K];
  __shared__ __align__(16) float sb2[K2];
  __shared__ __align__(16) float sw3h[K2];
  __shared__ TileRows<kTile> tiles[kWarpsPerBlock];
  for (int n = threadIdx.x; n < K * K; n += kRowThreads) {
    sW1[n] = __ldg(op.W1 + n);
    sW1[item_half<K>() + n] = __ldg(op.W1 + K * K + n);
  }
  for (int n = threadIdx.x; n < K * K2; n += kRowThreads)
    sW2[n] = __ldg(op.W2 + n);
  for (int n = threadIdx.x; n < K; n += kRowThreads) sb1[n] = __ldg(op.b1 + n);
  for (int n = threadIdx.x; n < K2; n += kRowThreads) {
    sb2[n] = __ldg(op.b2 + n);
    sw3h[n] = __ldg(op.W3 + n);
  }
  __syncthreads();

  constexpr unsigned kAll = 0xffffffffu;
  const int lane = threadIdx.x % 32;
  const unsigned below = (1u << lane) - 1u;
  TileRows<kTile>& rows = tiles[threadIdx.x / 32];
  const int64_t step = static_cast<int64_t>(gridDim.x) * kWarpsPerBlock * kTile;
  int64_t base = (static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock +
                  threadIdx.x / 32) * kTile;
  // slot r of lane l is row base + 32 r + l, so the id loads are coalesced;
  // the next tile's ids are loaded while this tile computes
  RowIds q[R];
#pragma unroll
  for (int r = 0; r < R; ++r) q[r] = load_row(op, base + 32 * r + lane);
  for (; base < op.S; base += step) {  // warp-uniform
    // 1. the tile's rows, partitioned by the W1 half they take
    {
      int flags[R];
      unsigned user_half[R];
      int n_item = 0;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const bool a = q[r].user == __ldg(op.tx + 2 * q[r].t);
        const bool b = q[r].item == __ldg(op.tx + 2 * q[r].t + 1);
        flags[r] = (a ? 1 : 0) | (b ? 2 : 0);
        user_half[r] = __ballot_sync(kAll, b && !a);
        n_item += 32 - __popc(user_half[r]);
      }
      int next_item = 0, next_user = n_item;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int pos = ((user_half[r] >> lane) & 1u)
            ? next_user + __popc(user_half[r] & below)
            : next_item + __popc(~user_half[r] & below);
        rows.off[pos] = 32 * r + lane;
        rows.t[pos] = q[r].t;
        rows.user[pos] = q[r].user;
        rows.item[pos] = q[r].item;
        rows.flags[pos] = flags[r];
        rows.e[pos] = q[r].e;
        rows.w[pos] = q[r].w;
        next_user += __popc(user_half[r]);
        next_item += 32 - __popc(user_half[r]);
      }
      __syncwarp();
#pragma unroll
      for (int r = 0; r < R; ++r)
        q[r] = load_row(op, base + step + 32 * r + lane);
    }

    // 2. this lane's rows: entries R lane .. R lane + R - 1. All but at
    //    most one lane of the warp take one W1 half for all their rows.
    bool uh[R], act[R], both[R];
    int t[R];
    const float* hp[R];  // the row's own MLP half-row the query lacks
    const float* zq[R];  // its c | r | g triple in Z
    bool any = false;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int n = R * lane + j;
      const int f = rows.flags[n];
      const bool a = f & 1, b = f & 2;
      t[j] = rows.t[n];
      uh[j] = b && !a;
      both[j] = a && b;
      act[j] = rows.w[n] != 0.0f && (a || b);
      hp[j] = uh[j] ? op.Pm + static_cast<int64_t>(rows.user[n]) * K
                    : op.Qm + static_cast<int64_t>(rows.item[n]) * K;
      zq[j] = op.Z + static_cast<int64_t>(t[j]) * 6 * K + (uh[j] ? 3 * K : 0);
      any = any || act[j];
      // the row's gathers, all in flight before the first is used
      prefetch_l1(hp[j], K);
      prefetch_l1(zq[j], 3 * K);
      prefetch_l1(uh[j] ? op.Pg + static_cast<int64_t>(rows.user[n]) * K
                        : op.Qg + static_cast<int64_t>(rows.item[n]) * K, K);
    }
    float gd[R];
#pragma unroll
    for (int j = 0; j < R; ++j) gd[j] = 0.0f;

    if (any) {
      // z1 = (b1 + c) + h W1-half, m ascending. The lane's first row picks
      // the half; every row that shares it shares each W1 load.
      float z1[R][K];
#pragma unroll
      for (int j = 0; j < R; ++j) {
#pragma unroll
        for (int i = 0; i < K; i += 4) {
          const float4 c = ldg4(zq[j] + i);
          z1[j][i] = sb1[i] + c.x;
          z1[j][i + 1] = sb1[i + 1] + c.y;
          z1[j][i + 2] = sb1[i + 2] + c.z;
          z1[j][i + 3] = sb1[i + 3] + c.w;
        }
      }
      const bool uh0 = uh[0];
      const float* W1p = sW1 + (uh0 ? 0 : item_half<K>());
#pragma unroll 2
      for (int m = 0; m < K; m += 4) {
        float h[R][4];
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const float4 v = uh[j] == uh0 ? ldg4(hp[j] + m) : zero4();
          h[j][0] = v.x; h[j][1] = v.y; h[j][2] = v.z; h[j][3] = v.w;
        }
#pragma unroll
        for (int mm = 0; mm < 4; ++mm) {
#pragma unroll
          for (int i = 0; i < K; i += 4) {
            const float4 w = lds4(W1p + (m + mm) * K + i);
#pragma unroll
            for (int j = 0; j < R; ++j) {
              z1[j][i] = fmaf(h[j][mm], w.x, z1[j][i]);
              z1[j][i + 1] = fmaf(h[j][mm], w.y, z1[j][i + 1]);
              z1[j][i + 2] = fmaf(h[j][mm], w.z, z1[j][i + 2]);
              z1[j][i + 3] = fmaf(h[j][mm], w.w, z1[j][i + 3]);
            }
          }
        }
      }
      // the lane whose rows straddle the partition: its other rows, alone
#pragma unroll
      for (int j = 1; j < R; ++j) {
        if (uh[j] != uh0) {
          const float* W1o = sW1 + (uh[j] ? 0 : item_half<K>());
#pragma unroll 1
          for (int m = 0; m < K; m += 4) {
            const float4 v = ldg4(hp[j] + m);
            const float h[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
            for (int mm = 0; mm < 4; ++mm) {
#pragma unroll
              for (int i = 0; i < K; i += 4) {
                const float4 w = lds4(W1o + (m + mm) * K + i);
                z1[j][i] = fmaf(h[mm], w.x, z1[j][i]);
                z1[j][i + 1] = fmaf(h[mm], w.y, z1[j][i + 1]);
                z1[j][i + 2] = fmaf(h[mm], w.z, z1[j][i + 2]);
                z1[j][i + 3] = fmaf(h[mm], w.w, z1[j][i + 3]);
              }
            }
          }
        }
      }
      // z2 = b2 + relu(z1) W2 (m ascending); z1 is kept only as its sign
      float z2[R][K2];
      Mask pos[R];
#pragma unroll
      for (int j = 0; j < R; ++j) {
        pos[j] = 0u;
#pragma unroll
        for (int i = 0; i < K2; ++i) z2[j][i] = sb2[i];
      }
#pragma unroll
      for (int m = 0; m < K; ++m) {
        float v[R];
#pragma unroll
        for (int j = 0; j < R; ++j) {
          v[j] = fmaxf(z1[j][m], 0.0f);
          pos[j] |= static_cast<Mask>(z1[j][m] > 0.0f) << m;
        }
#pragma unroll
        for (int i = 0; i < K2; i += 4) {
          const float4 w = lds4(sW2 + m * K2 + i);
#pragma unroll
          for (int j = 0; j < R; ++j) {
            z2[j][i] = fmaf(v[j], w.x, z2[j][i]);
            z2[j][i + 1] = fmaf(v[j], w.y, z2[j][i + 1]);
            z2[j][i + 2] = fmaf(v[j], w.z, z2[j][i + 2]);
            z2[j][i + 3] = fmaf(v[j], w.w, z2[j][i + 3]);
          }
        }
      }
      // dz2 = [z2 > 0] w3h, in place
#pragma unroll
      for (int j = 0; j < R; ++j) {
#pragma unroll
        for (int i = 0; i < K2; ++i) z2[j][i] = z2[j][i] > 0.0f ? sw3h[i] : 0.0f;
      }
      // dz1[i] = [z1 > 0] (dz2 . W2[i, :]), dotted with r (+ rI when
      // a = b = 1) as it is formed, i ascending
#pragma unroll 1
      for (int i = 0; i < K; i += 4) {
        float rv[R][4];
#pragma unroll
        for (int j = 0; j < R; ++j) {
          float4 r4 = ldg4(zq[j] + K + i);
          if (both[j]) {
            const float4 x4 = ldg4(op.Z + static_cast<int64_t>(t[j]) * 6 * K +
                                   4 * K + i);
            r4.x += x4.x; r4.y += x4.y; r4.z += x4.z; r4.w += x4.w;
          }
          rv[j][0] = r4.x; rv[j][1] = r4.y; rv[j][2] = r4.z; rv[j][3] = r4.w;
        }
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
          float acc[R];
#pragma unroll
          for (int j = 0; j < R; ++j) acc[j] = 0.0f;
#pragma unroll
          for (int m = 0; m < K2; m += 4) {
            const float4 w = lds4(sW2 + (i + ii) * K2 + m);
#pragma unroll
            for (int j = 0; j < R; ++j) {
              acc[j] = fmaf(z2[j][m], w.x, acc[j]);
              acc[j] = fmaf(z2[j][m + 1], w.y, acc[j]);
              acc[j] = fmaf(z2[j][m + 2], w.z, acc[j]);
              acc[j] = fmaf(z2[j][m + 3], w.w, acc[j]);
            }
          }
#pragma unroll
          for (int j = 0; j < R; ++j) {
            const float dz1 = (pos[j] >> (i + ii)) & 1u ? acc[j] : 0.0f;
            gd[j] = fmaf(dz1, rv[j][ii], gd[j]);
          }
        }
      }
      // the GMF terms: (qg or pg) . (gU or gI), + pg . gI when a = b = 1
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int n = R * lane + j;
        const float* gp = uh[j] ? op.Pg + static_cast<int64_t>(rows.user[n]) * K
                                : op.Qg + static_cast<int64_t>(rows.item[n]) * K;
#pragma unroll
        for (int i = 0; i < K; i += 4) {
          const float4 g = ldg4(gp + i), x = ldg4(zq[j] + 2 * K + i);
          gd[j] = fmaf(g.x, x.x, gd[j]);
          gd[j] = fmaf(g.y, x.y, gd[j]);
          gd[j] = fmaf(g.z, x.z, gd[j]);
          gd[j] = fmaf(g.w, x.w, gd[j]);
        }
        if (both[j]) {
          const float* pg = op.Pg + static_cast<int64_t>(rows.user[n]) * K;
          const float* gi = op.Z + static_cast<int64_t>(t[j]) * 6 * K + 5 * K;
#pragma unroll
          for (int i = 0; i < K; i += 4) {
            const float4 g = ldg4(pg + i), x = ldg4(gi + i);
            gd[j] = fmaf(g.x, x.x, gd[j]);
            gd[j] = fmaf(g.y, x.y, gd[j]);
            gd[j] = fmaf(g.z, x.z, gd[j]);
            gd[j] = fmaf(g.w, x.w, gd[j]);
          }
        }
        if (!act[j]) gd[j] = 0.0f;  // neither id matches: g_s = 0
      }
    }

    // 3. the epilogue, each row to its own place
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int n = R * lane + j;
      const int64_t s = base + rows.off[n];
      if (s < op.S) {
        const float w = rows.w[n];
        float v = 0.0f;  // masked: the plain version's wv * (...) is 0
        if (w != 0.0f) {
          const float* x = op.B + static_cast<int64_t>(t[j]) * (4 * K + 2);
          v = w * (2.0f * rows.e[n] * gd[j] + __ldg(x + 4 * K)) /
              __ldg(x + 4 * K + 1);
        }
        op.out[s] = v;
      }
    }
    __syncwarp();  // the tile's fields are rewritten by the next step
  }
}

// ---- 3. rows, general width: one warp a row ----------------------------

// floats of the per-warp scratch: h (k), z1 (k), dz2 (k2)
__host__ __device__ inline int scratch_floats(int k, int k2) {
  return 2 * k + k2;
}

// floats of the staged weights: W1, W2 at an odd row stride, b1, b2, w3h
__host__ __device__ inline int staged_floats(int k, int k2) {
  return 2 * k * k + k * (k2 | 1) + k + 2 * k2;
}

template <bool kStage>
__global__ void __launch_bounds__(kGenThreads)
ncf_rows_general_kernel(const Operands op) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int k = op.k, k2 = op.k2;

  const float *W1, *b1, *W2, *b2, *w3h;
  int ld2;  // row stride of W2 as read (odd when staged: W2 is read down
            // its columns too)
  float* scratch;
  if (kStage) {
    ld2 = k2 | 1;
    float* sW1 = smem;
    float* sW2 = sW1 + 2 * k * k;
    float* sb1 = sW2 + k * ld2;
    float* sb2 = sb1 + k;
    float* sw3 = sb2 + k2;
    for (int n = threadIdx.x; n < 2 * k * k; n += kGenThreads)
      sW1[n] = op.W1[n];
    for (int n = threadIdx.x; n < k * k2; n += kGenThreads)
      sW2[(n / k2) * ld2 + n % k2] = op.W2[n];
    for (int n = threadIdx.x; n < k; n += kGenThreads) sb1[n] = op.b1[n];
    for (int n = threadIdx.x; n < k2; n += kGenThreads) {
      sb2[n] = op.b2[n];
      sw3[n] = op.W3[n];
    }
    __syncthreads();
    W1 = sW1; b1 = sb1; W2 = sW2; b2 = sb2; w3h = sw3;
    scratch = sw3 + k2;
  } else {
    ld2 = k2;
    W1 = op.W1; b1 = op.b1; W2 = op.W2; b2 = op.b2; w3h = op.W3;
    scratch = smem;
  }
  float* h = scratch + warp * scratch_floats(k, k2);
  float* z1 = h + k;
  float* dz2 = z1 + k;
  const int d = 4 * k;

  const int64_t step = static_cast<int64_t>(gridDim.x) * kWarps;
  for (int64_t s = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
       s < op.S; s += step) {
    // every branch below depends on the row only: warp-uniform
    const float w = op.wv[s];
    if (w == 0.0f) {  // masked: the plain version's wv * (...) is 0
      if (lane == 0) op.out[s] = 0.0f;
      continue;
    }
    const int t = op.seg[s];
    const int user = op.rel_x[2 * s];
    const int item = op.rel_x[2 * s + 1];
    const bool a = user == op.tx[2 * t];
    const bool b = item == op.tx[2 * t + 1];
    const float* x = op.B + static_cast<int64_t>(t) * (d + 2);
    float part = 0.0f;  // this lane's share of gdot

    if (a || b) {  // else g_s = 0 and gdot = 0
      const bool bonly = b && !a;
      const bool both = a && b;
      const float* hrow = bonly ? op.Pm + static_cast<int64_t>(user) * k
                                : op.Qm + static_cast<int64_t>(item) * k;
      const float* grow = bonly ? op.Pg + static_cast<int64_t>(user) * k
                                : op.Qg + static_cast<int64_t>(item) * k;
      const float* zt = op.Z + static_cast<int64_t>(t) * 6 * k;
      const float* zq = zt + (bonly ? 3 * k : 0);
      const float* W1h = W1 + (bonly ? 0 : k * k);
      for (int j = lane; j < k; j += 32) h[j] = hrow[j];
      __syncwarp();
      // z1 = (b1 + c) + h W1-half (kept pre-activation: it sets the mask)
      for (int j = lane; j < k; j += 32) {
        float acc = b1[j] + zq[j];
        for (int m = 0; m < k; ++m) acc = fmaf(h[m], W1h[m * k + j], acc);
        z1[j] = acc;
      }
      __syncwarp();
      // z2 = relu(z1) W2 + b2, and at once dz2 = [z2 > 0] w3h
      for (int j = lane; j < k2; j += 32) {
        float acc = b2[j];
        for (int m = 0; m < k; ++m)
          acc = fmaf(fmaxf(z1[m], 0.0f), W2[m * ld2 + j], acc);
        dz2[j] = acc > 0.0f ? w3h[j] : 0.0f;
      }
      __syncwarp();
      // dz1 = [z1 > 0] (dz2 W2^T), dotted with r (+ rI when a = b = 1) as
      // it is formed; then the GMF terms
      for (int j = lane; j < k; j += 32) {
        float acc = 0.0f;
        if (z1[j] > 0.0f) {
          for (int m = 0; m < k2; ++m) acc = fmaf(dz2[m], W2[j * ld2 + m], acc);
        }
        float r = zq[k + j];
        if (both) r += zt[4 * k + j];
        part = fmaf(acc, r, part);
        part = fmaf(grow[j], zq[2 * k + j], part);
        if (both)
          part = fmaf(op.Pg[static_cast<int64_t>(user) * k + j], zt[5 * k + j],
                      part);
      }
      __syncwarp();  // the scratch is rewritten by the warp's next row
    }
#pragma unroll
    for (int off = 16; off > 0; off /= 2)
      part += __shfl_xor_sync(0xffffffffu, part, off);
    if (lane == 0) op.out[s] = w * (2.0f * op.e[s] * part + x[d]) / x[d + 1];
  }
}

// ---- launch geometry -------------------------------------------------

// k -> the register-blocked instantiation, or null for the general path.
// R is the rows a lane takes; the minimum of resident blocks caps the
// registers ptxas may take (65,536 an SM over 128 threads a block: 4
// blocks -> 128 a thread, 3 -> 168). At k = 16, R = 2 with 4 blocks ran
// faster on an H100 than R = 4 with 3 (fewer warps to hide latency) and
// than R = 1 (twice the shared-memory loads a row).
using RowsFn = void (*)(const Operands);

RowsFn rows_fn(int k, int* rows_per_thread) {
  switch (k) {
    case 8: *rows_per_thread = 4; return &ncf_rows_kernel<8, 4, 3>;
    case 16: *rows_per_thread = 2; return &ncf_rows_kernel<16, 2, 4>;
    case 32: *rows_per_thread = 2; return &ncf_rows_kernel<32, 2, 3>;
    case 64: *rows_per_thread = 1; return &ncf_rows_kernel<64, 1, 3>;
    default: *rows_per_thread = 0; return nullptr;
  }
}

// The launch geometry of one (device, k, path): the row kernel, its
// rows a block, its dynamic shared memory, and the blocks of it (and of
// the query-products kernel) the card holds at once.
struct Geometry {
  int dev = -1, k = -1, k2 = -1;
  bool aligned = false;       // the tables and Z are 16-byte aligned
  const void* fn = nullptr;   // the row kernel
  int threads = 0;
  long long rows_per_block = 0;
  bool stage = false;         // general path: weights in shared memory
  size_t smem = 0;
  long long resident = 0, prep_resident = 0;
  int err = 0;
};

Geometry geometry(int dev, int k, int k2, bool aligned) {
  Geometry g;
  g.dev = dev;
  g.k = k;
  g.k2 = k2;
  g.aligned = aligned;
  int sms = 0, per_sm = 0, smem_max = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  int R = 0;
  RowsFn fn = aligned ? rows_fn(k, &R) : nullptr;
  if (fn != nullptr) {
    g.fn = reinterpret_cast<const void*>(fn);
    g.threads = kRowThreads;
    g.rows_per_block = static_cast<long long>(kRowThreads) * R;
    g.smem = 0;  // static shared memory only
  } else {
    const size_t scratch = sizeof(float) * kWarps * scratch_floats(k, k2);
    const size_t staged = sizeof(float) * staged_floats(k, k2) + scratch;
    g.stage = staged <= kStageMax;
    g.smem = g.stage ? staged : scratch;
    if (g.smem > static_cast<size_t>(smem_max)) {
      g.err = static_cast<int>(cudaErrorInvalidValue);
      return g;
    }
    g.fn = g.stage
        ? reinterpret_cast<const void*>(&ncf_rows_general_kernel<true>)
        : reinterpret_cast<const void*>(&ncf_rows_general_kernel<false>);
    g.threads = kGenThreads;
    g.rows_per_block = kWarps;
    if (g.smem > 48 * 1024) {
      cudaFuncSetAttribute(g.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(g.smem));
    }
  }
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, g.fn, g.threads,
                                                g.smem);
  g.resident = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, reinterpret_cast<const void*>(&ncf_query_products_kernel),
      kPrepThreads, 0);
  g.prep_resident = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  g.err = static_cast<int>(cudaGetLastError());
  return g;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// Launches on `stream` the query-products kernel and then the row kernel,
// and returns cudaGetLastError() (0 on success), or cudaErrorInvalidValue
// when T < 1, k2 != k / 2 or k is too wide for the general path's
// scratch. The caller checks device, dtype, shape and contiguity and
// allocates `out` (S,) and `scratch` (T, 6k) float32; S == 0 launches
// nothing. Each row kernel block walks rows with a grid stride, and the
// grid is sized to the blocks the card holds at once, so the staged
// weights are loaded once per resident block. The geometry of the last
// (device, k, path) is kept, so a repeated call (as inside a CUDA graph
// capture) makes no attribute or occupancy query.
extern "C" int fia_ncf_fused_scores(
    const void* rel_x, const void* seg, const void* e, const void* wv,
    const void* tx, const void* P_mlp, const void* Q_mlp, const void* P_gmf,
    const void* Q_gmf, const void* W1, const void* b1, const void* W2,
    const void* b2, const void* W3, const void* B, void* out, void* scratch,
    long long S, int T, int k, int k2, void* stream) {
  static Geometry cached;
  if (S <= 0) return 0;
  if (T < 1 || k < 2 || k2 != k / 2)
    return static_cast<int>(cudaErrorInvalidValue);
  // the register-blocked path reads table rows and Z as float4
  const bool aligned = aligned16(P_mlp) && aligned16(Q_mlp) &&
                       aligned16(P_gmf) && aligned16(Q_gmf) &&
                       aligned16(scratch);
  int dev = 0;
  cudaGetDevice(&dev);
  if (cached.dev != dev || cached.k != k || cached.k2 != k2 ||
      cached.aligned != aligned) {
    cached = geometry(dev, k, k2, aligned);
  }
  if (cached.err != 0) return cached.err;
  Operands op;
  op.rel_x = static_cast<const int32_t*>(rel_x);
  op.seg = static_cast<const int32_t*>(seg);
  op.e = static_cast<const float*>(e);
  op.wv = static_cast<const float*>(wv);
  op.tx = static_cast<const int32_t*>(tx);
  op.Pm = static_cast<const float*>(P_mlp);
  op.Qm = static_cast<const float*>(Q_mlp);
  op.Pg = static_cast<const float*>(P_gmf);
  op.Qg = static_cast<const float*>(Q_gmf);
  op.W1 = static_cast<const float*>(W1);
  op.b1 = static_cast<const float*>(b1);
  op.W2 = static_cast<const float*>(W2);
  op.b2 = static_cast<const float*>(b2);
  op.W3 = static_cast<const float*>(W3);
  op.B = static_cast<const float*>(B);
  op.Z = static_cast<float*>(scratch);
  op.out = static_cast<float*>(out);
  op.S = static_cast<int64_t>(S);
  op.T = T;
  op.k = k;
  op.k2 = k2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);

  const long long prep_blocks =
      (static_cast<long long>(T) * 6 * k + kPrepThreads - 1) / kPrepThreads;
  const dim3 prep_grid(static_cast<unsigned>(
      prep_blocks < cached.prep_resident ? prep_blocks : cached.prep_resident));
  ncf_query_products_kernel<<<prep_grid, kPrepThreads, 0, st>>>(op);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const long long row_blocks =
      (S + cached.rows_per_block - 1) / cached.rows_per_block;
  const dim3 grid(static_cast<unsigned>(
      row_blocks < cached.resident ? row_blocks : cached.resident));
  void* args[] = {&op};
  err = cudaLaunchKernel(cached.fn, grid, dim3(cached.threads), args,
                         cached.smem, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

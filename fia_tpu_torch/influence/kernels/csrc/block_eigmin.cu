// The smallest eigenvalue of each of T symmetric d x d blocks, for Hopper
// (sm_90a).
//
// Replaces a library call of the reference: jnp.linalg.eigvalsh(H)[:, 0],
// fia_tpu/influence/engine.py:2504-2506, the sampled certificate's lambda_min
// (the port called torch.linalg.eigvalsh there, in pieces of 64: cuSOLVER's
// syevj path one matrix at a time above d = 32, with an info check that
// waits on the host each call).
//
// What it computes. Block t of H (T, d, d) is read from its lower triangle
// only (eigvalsh's UPLO "L"; the engine's H is not bit-symmetric), mirrored
// into an exactly symmetric A, and padded to an even n = d + (d mod 2) with
// a zero row and column. Then sweeps(d) sweeps of the parallel cyclic Jacobi
// algorithm (the wrapper's kernels/eigmin.py:sweeps, a fixed count): a sweep
// is n - 1 steps of the round-robin ordering, step r pairing (n - 1, r) and
// ((r + a) mod (n - 1), (r - a) mod (n - 1)) for a = 1 .. n/2 - 1. Each pair
// (p, q) takes the rotation zeroing a_pq (Golub and Van Loan's sym.schur2:
// theta = (a_qq - a_pp) / 2 a_pq, t = sign(theta) / (|theta| +
// sqrt(theta^2 + 1)), c = 1 / sqrt(t^2 + 1), s = t c; t = 0 where a_pq = 0),
// and the step applies the n/2 rotations at once: the 2 x 2 block of pair
// a's rows and pair b's columns becomes R_a^T X R_b (columns first, then
// rows) for a > b and is mirrored to (b, a); pair a's own block becomes
// diag(a_pp - t a_pq, a_qq + t a_pq). lambda_min is the smallest of the
// first d diagonal entries, NaN if any is NaN. Every multiply, add, divide
// and square root rounds on its own (__fmul_rn, __fadd_rn, __fdiv_rn,
// __fsqrt_rn: no contraction into an FMA), in the order of the plain version
// block_eigmin_reference, and nothing depends on the other blocks: a block's
// lambda_min is the same bits alone and in any batch. No step waits on the
// host, so the sampled program is captured in one CUDA graph.
//
// Bound on an H100. Reading H's lower triangles once, 4 T d (d + 1) / 2
// bytes, against one tridiagonalisation's 4 d^3 / 3 flops a block: at the
// main path's T = 1024, d = 34 / 64 that is 2.4 / 8.5 MB (0.73 / 2.5 us at
// 3.35 TB/s) and 54 / 358 MFLOP (0.80 / 5.3 us at 67 TFLOP/s), so the flops
// bound it at both widths. Jacobi does far more arithmetic: about
// 6 n^3 flops a sweep, 10 sweeps at d <= 64, some 40 times a
// tridiagonalisation, and its n - 1 steps a sweep each end at a barrier, so
// it is bound by instruction issue and by the barriers, not by bytes. What
// the design does about it: one block a matrix, the matrix in shared memory
// (d <= 238; 64 x 65 floats = 16.6 KB at d = 64, where 256-thread blocks
// put every block of a 1,024-block batch on the card at once); each thread
// rotates about two 2 x 2 blocks of the lower triangle a step, and the
// mirror is written, not computed.
// Above 238 the matrix stays in a device-memory scratch, one block of 1,024
// threads a matrix: slow (the matrix is rewritten through L2 every step),
// but it runs to d = 1,024.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;     // the device-memory path
constexpr int kSmemThreads = 256;     // at most, the shared-memory path
// dynamic shared memory a block may take on an H100 (227 KB, less 1 KB for
// the static array and the system's share)
constexpr int kSmemBytes = 232448 - 1024;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fc00000); }

// min that propagates NaN, as torch.amin does
__device__ __forceinline__ float nanmin(float a, float b) {
  return (a != a || b != b) ? nan_f() : fminf(a, b);
}

// the (a, b), a >= b, of lower pair-block k: k = a (a + 1) / 2 + b
__device__ __forceinline__ void pair_block(int k, int* a, int* b) {
  int x = static_cast<int>((sqrtf(8.f * static_cast<float>(k) + 1.f) - 1.f) *
                           0.5f);
  while (x * (x + 1) / 2 > k) --x;
  while ((x + 1) * (x + 2) / 2 <= k) ++x;
  *a = x;
  *b = k - x * (x + 1) / 2;
}

// the rotation of pair (p, q): t, c, s from a_pp, a_qq, a_pq
__device__ __forceinline__ void rotation(float app, float aqq, float apq,
                                         float* t, float* c, float* s) {
  const float theta = __fdiv_rn(__fsub_rn(aqq, app), __fmul_rn(2.f, apq));
  const float sign = theta >= 0.f ? 1.f : -1.f;
  float tt = __fdiv_rn(
      sign, __fadd_rn(fabsf(theta),
                      __fsqrt_rn(__fadd_rn(__fmul_rn(theta, theta), 1.f))));
  if (apq == 0.f) tt = 0.f;
  const float cc =
      __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(__fmul_rn(tt, tt), 1.f)));
  *t = tt;
  *c = cc;
  *s = __fmul_rn(cc, tt);
}

// Lower pair-block (a, b) of step: rotate and write it and its mirror.
// A has row stride ld; P, Q, C, S, Tt are the step's pairs and rotations.
__device__ __forceinline__ void update_block(float* A, int ld, int a, int b,
                                             const int* P, const int* Q,
                                             const float* C, const float* S,
                                             const float* Tt) {
  const int pa = P[a], qa = Q[a];
  if (a == b) {
    const float app = A[pa * ld + pa], aqq = A[qa * ld + qa];
    const float ta = __fmul_rn(Tt[a], A[pa * ld + qa]);
    A[pa * ld + pa] = __fsub_rn(app, ta);
    A[qa * ld + qa] = __fadd_rn(aqq, ta);
    A[pa * ld + qa] = 0.f;
    A[qa * ld + pa] = 0.f;
    return;
  }
  const int pb = P[b], qb = Q[b];
  const float ca = C[a], sa = S[a], cb = C[b], sb = S[b];
  const float x11 = A[pa * ld + pb], x12 = A[pa * ld + qb];
  const float x21 = A[qa * ld + pb], x22 = A[qa * ld + qb];
  // columns by pair b's rotation, then rows by pair a's
  const float y11 = __fsub_rn(__fmul_rn(cb, x11), __fmul_rn(sb, x12));
  const float y12 = __fadd_rn(__fmul_rn(sb, x11), __fmul_rn(cb, x12));
  const float y21 = __fsub_rn(__fmul_rn(cb, x21), __fmul_rn(sb, x22));
  const float y22 = __fadd_rn(__fmul_rn(sb, x21), __fmul_rn(cb, x22));
  const float z11 = __fsub_rn(__fmul_rn(ca, y11), __fmul_rn(sa, y21));
  const float z21 = __fadd_rn(__fmul_rn(sa, y11), __fmul_rn(ca, y21));
  const float z12 = __fsub_rn(__fmul_rn(ca, y12), __fmul_rn(sa, y22));
  const float z22 = __fadd_rn(__fmul_rn(sa, y12), __fmul_rn(ca, y22));
  A[pa * ld + pb] = z11;
  A[pb * ld + pa] = z11;
  A[pa * ld + qb] = z12;
  A[qb * ld + pa] = z12;
  A[qa * ld + pb] = z21;
  A[pb * ld + qa] = z21;
  A[qa * ld + qb] = z22;
  A[qb * ld + qa] = z22;
}

// One block a matrix. SMEM: A (n x ld floats) in dynamic shared memory;
// else in `scratch` (T x n x n floats), rewritten through L2 every step.
template <bool SMEM>
__global__ void __launch_bounds__(kMaxThreads)
block_eigmin_kernel(const float* __restrict__ H, float* __restrict__ lam,
                    float* scratch, int d, int sweeps) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int64_t blk = blockIdx.x;
  const int n = d + (d & 1), h = n / 2;
  const int ld = SMEM ? n + 1 : n;
  float* A = SMEM ? smem : scratch + blk * static_cast<int64_t>(n) * n;
  float* rot = SMEM ? smem + n * ld : smem;  // C, S, Tt: h floats each
  float* C = rot;
  float* S = C + h;
  float* Tt = S + h;
  int* P = reinterpret_cast<int*>(Tt + h);
  int* Q = P + h;
  __shared__ float red[32];

  // A from H's lower triangle, mirrored; the pad row and column zero
  const float* Hb = H + blk * static_cast<int64_t>(d) * d;
  for (int idx = tid; idx < n * n; idx += nt) {
    const int i = idx / n, j = idx - (idx / n) * n;
    float v = 0.f;
    if (i < d && j < d) v = i >= j ? Hb[i * d + j] : Hb[j * d + i];
    A[i * ld + j] = v;
  }

  const int nb = h * (h + 1) / 2;  // lower pair-blocks
  __syncthreads();

  for (int sw = 0; sw < sweeps; ++sw) {
    for (int r = 0; r < n - 1; ++r) {
      // the step's pairs and their rotations, a thread a pair
      for (int a = tid; a < h; a += nt) {
        const int p = a == 0 ? n - 1 : (r + a) % (n - 1);
        const int q = a == 0 ? r : (r - a + n - 1) % (n - 1);
        float t, c, s;
        rotation(A[p * ld + p], A[q * ld + q], A[p * ld + q], &t, &c, &s);
        P[a] = p;
        Q[a] = q;
        C[a] = c;
        S[a] = s;
        Tt[a] = t;
      }
      __syncthreads();
      for (int k = tid; k < nb; k += nt) {
        int a, b;
        pair_block(k, &a, &b);
        update_block(A, ld, a, b, P, Q, C, S, Tt);
      }
      __syncthreads();
    }
  }

  // lambda_min: the smallest of the first d diagonal entries, NaN if any is
  // (a min is exact in any order)
  float m = INFINITY;
  for (int i = tid; i < d; i += nt) m = nanmin(m, A[i * ld + i]);
#pragma unroll
  for (int k = 16; k >= 1; k >>= 1) m = nanmin(m, __shfl_xor_sync(kFull, m, k));
  if ((tid & 31) == 0) red[tid >> 5] = m;
  __syncthreads();
  if (tid < 32) {
    m = tid < (nt + 31) / 32 ? red[tid] : INFINITY;
#pragma unroll
    for (int k = 16; k >= 1; k >>= 1)
      m = nanmin(m, __shfl_xor_sync(kFull, m, k));
    if (tid == 0) lam[blk] = m;
  }
}

size_t smem_bytes(int d, bool in_smem) {
  const int n = d + (d & 1), h = n / 2;
  const size_t rot = static_cast<size_t>(h) * (3 * sizeof(float) +
                                               2 * sizeof(int));
  return in_smem ? static_cast<size_t>(n) * (n + 1) * sizeof(float) + rot
                 : rot;
}

}  // namespace

// The largest d the shared-memory path takes (the wrapper allocates the
// device-memory scratch above it).
extern "C" int fia_block_eigmin_smem_max_d() {
  int d = 2;
  while (smem_bytes(d + 2, true) <= static_cast<size_t>(kSmemBytes)) d += 2;
  return d;
}

// Launches the kernel on `stream` and returns cudaGetLastError() (0 on
// success). H is (T, d, d) float32, read from its lower triangles; lam (T,)
// float32, every entry written; scratch (T, n, n) float32 with n = d + (d mod
// 2) where d > fia_block_eigmin_smem_max_d(), else unused (may be null).
// 1 <= d <= 1024, sweeps >= 0. T == 0 launches nothing.
extern "C" int fia_block_eigmin(const void* H, void* lam, void* scratch, int T,
                                int d, int sweeps, void* stream) {
  if (T <= 0) return 0;
  if (d <= 0 || d > 1024 || sweeps < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool in_smem = d <= fia_block_eigmin_smem_max_d();
  if (!in_smem && scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = smem_bytes(d, in_smem);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n = d + (d & 1), h = n / 2;
  if (in_smem) {
    static bool attr = false;  // once a process: set before any capture
    if (bytes > 48 * 1024 && !attr) {
      const cudaError_t e = cudaFuncSetAttribute(
          block_eigmin_kernel<true>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
      if (e != cudaSuccess) return static_cast<int>(e);
      attr = true;
    }
    // about two lower pair-blocks a thread, at most kSmemThreads threads
    const int nb = h * (h + 1) / 2;
    int threads = ((nb + 1) / 2 + 31) / 32 * 32;
    threads = threads > kSmemThreads ? kSmemThreads : threads;
    block_eigmin_kernel<true><<<T, threads, bytes, st>>>(
        static_cast<const float*>(H), static_cast<float*>(lam), nullptr, d,
        sweeps);
  } else {
    block_eigmin_kernel<false><<<T, kMaxThreads, bytes, st>>>(
        static_cast<const float*>(H), static_cast<float*>(lam),
        static_cast<float*>(scratch), d, sweeps);
  }
  return static_cast<int>(cudaGetLastError());
}

"""The smallest eigenvalue of each of T symmetric d × d blocks: the CUDA
kernel's wrapper and its plain PyTorch version (the port of the
reference's ``jnp.linalg.eigvalsh(H)[:, 0]``,
``fia_tpu/influence/engine.py:2504-2506``, the sampled certificate's
λ_min; the kernel is ``csrc/block_eigmin.cu``).

The method, the same operations in the same order on both sides:

1. **Householder tridiagonalisation** (LAPACK's ``ssytd2``, lower). The
   block is read from its lower triangle only (``eigvalsh``'s
   ``UPLO="L"``: the engine's H is not bit-symmetric). For j = 0 … n − 3,
   with x = A[j+1:, j] and α = x₀:

   - s = Σ_{k ≥ j+2} x_k²; if s = 0 then β = α, τ = 0, v = e₁; else
     β = −copysign(√(α² + s), α), τ = (β − α) / β, v₀ = 1 and
     v_k = x_k / (α − β); β is T's off-diagonal entry b_j;
   - p = τ · A v over the trailing block, w = p + ((−½ τ) · pᵀv) v;
   - each lower entry of the trailing block becomes
     (a_ic − v_i w_c) − w_i v_c.

   T's diagonal is then A's, and b_{n−2} = a_{n−1,n−2}.
2. **Sturm multisection** for the smallest eigenvalue of T. The count at
   x is the number of pivots ≤ 0 of q_0 = a_0 − x,
   q_i = (a_i − x) − b²_{i−1} / q_{i−1}, a pivot with |q| < pivmin taken
   as −pivmin (LAPACK's ``sstebz``; pivmin = FLT_MIN · max(1, max b²)).
   The search runs over the ordered bit patterns of float32 (a monotone
   map of the floats onto the integers), from T's Gershgorin interval
   widened by bnorm · n · 2⁻²¹ + 4 pivmin: each of :data:`ROUNDS` rounds
   evaluates the count at :data:`STURM_POINTS` points spread evenly over
   the bracket and keeps the cell where the count first reaches 1. After
   the last round the bracket is one float wide,
   and λ_min is its upper end: the smallest float whose count is ≥ 1. A
   diagonal block returns its smallest diagonal entry exactly.

Every sum (a norm, a dot, a row of A v) follows one tree: lane ℓ of 32
sums the terms whose absolute index is ≡ ℓ (mod 32), in ascending order,
then a xor butterfly (16, 8, 4, 2, 1) combines the lanes. A row of A v
keeps two such lane sums, the entries left of the diagonal and those on
and below it, and adds them before the butterfly. Every multiply, add,
divide and square root rounds on its own, and nothing depends on the
other blocks of the batch or on the kernel's launch shape: a block's
λ_min is the same bits alone and in any batch, on either side, so on the
card the kernel is held to this plain version bit for bit, and to
float64 ``eigvalsh`` at a bar of c · d · eps · ‖H‖_F. A block holding a
non-finite entry in its lower triangle gives NaN.

A fixed number of rounds, not a convergence test, so no step waits on
the host and the whole program can be captured in a CUDA graph.
"""

from __future__ import annotations

import ctypes
import sys

import torch

from fia_tpu_torch.influence.kernels import common

#: launches of the CUDA kernel by :func:`block_eigmin` in this process
#: (one a call), and launches recorded into CUDA graphs
#: (:func:`common.count_launch`)
launches = 0
captured = 0
LAUNCHES_PER_CALL = 1

#: the largest block the kernel takes (NCF at k = 256)
MAX_D = 1024
#: lanes of every sum's tree
LANES = 32
#: the Gershgorin interval is widened by bnorm · n · 2⁻²¹ (LAPACK's
#: 2.1 · n · eps · bnorm, rounded up to a power of two)
WIDEN = 2.0 ** -21
FLT_MIN = float(torch.finfo(torch.float32).tiny)
#: points of the bracket each multisection round evaluates, one a thread
#: of the kernel (every CTA has at least 128), at every width; the kernel's
#: kPoints
STURM_POINTS = 128
#: rounds that bring any float32 bracket to one float: the least r with
#: (P + 1)^r ≥ 2³² (each round keeps one of P + 1 cells); the kernel's
#: kRounds
ROUNDS = 5

_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p]


def _tree(x: torch.Tensor) -> torch.Tensor:
    """(...,) the xor butterfly of 32 lane sums (..., 32): the lanes 16
    apart first, then 8, 4, 2, 1 (``__shfl_xor_sync``'s order)."""
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def _lane_sums(terms: torch.Tensor, k0: int) -> torch.Tensor:
    """(..., 32) lane sums of ``terms`` (..., m), term k at absolute
    index k0 + k: lane ℓ adds the terms ≡ ℓ (mod 32) in ascending order,
    from +0. The pads are +0, which leave every sum's bits alone (a sum
    started at +0 is never −0)."""
    m = terms.shape[-1]
    front = k0 % LANES
    back = -(front + m) % LANES
    x = torch.nn.functional.pad(terms, (front, back))
    x = x.reshape(*terms.shape[:-1], -1, LANES)
    acc = torch.zeros_like(x[..., 0, :])
    for t in range(x.shape[-2]):
        acc = acc + x[..., t, :]
    return acc


def _symmetric(H: torch.Tensor) -> torch.Tensor:
    """(T, n, n) exactly symmetric: H's lower triangle mirrored (an exact
    copy of each entry)."""
    n = H.shape[-1]
    lower = torch.ones(n, n, dtype=torch.bool, device=H.device).tril()
    return torch.where(lower, H, H.transpose(-2, -1)).contiguous()


def tridiagonal_reference(H: torch.Tensor):
    """Step 1 of the plain version: ``(a, b, ok)``, T's diagonal (T, n),
    its off-diagonal (T, n − 1), and whether the block's lower triangle
    is finite (T,)."""
    T, n = H.shape[0], H.shape[-1]
    dev = H.device
    lower = torch.ones(n, n, dtype=torch.bool, device=dev).tril()
    ok = torch.where(lower, torch.isfinite(H), True).reshape(T, -1).all(1)
    A = _symmetric(H)
    b = []
    for j in range(n - 2):
        m = n - j - 1
        x = A[:, j + 1:, j]
        alpha = x[:, 0]
        s = _tree(_lane_sums(x[:, 1:] * x[:, 1:], j + 2))
        flat = s == 0
        r = torch.sqrt(alpha * alpha + s)
        beta = torch.where(flat, alpha, -torch.copysign(r, alpha))
        tau = torch.where(flat, torch.zeros_like(s), (beta - alpha) / beta)
        den = alpha - beta
        rest = torch.where(flat[:, None], torch.zeros_like(x[:, 1:]),
                           x[:, 1:] / den[:, None])
        v = torch.cat([torch.ones_like(alpha)[:, None], rest], dim=1)
        b.append(beta)
        At = A[:, j + 1:, j + 1:]
        prod = At * v[:, None, :]
        left = torch.ones(m, m, dtype=torch.bool, device=dev).tril(-1)
        zero = torch.zeros_like(prod)
        u = (_lane_sums(torch.where(left, prod, zero), j + 1)
             + _lane_sums(torch.where(left, zero, prod), j + 1))
        p = tau[:, None] * _tree(u)
        K = _tree(_lane_sums(p * v, j + 1))
        coef = (tau * -0.5) * K
        w = p + coef[:, None] * v
        new = (At - v[:, :, None] * w[:, None, :]) - w[:, :, None] * v[:, None, :]
        low = torch.ones(m, m, dtype=torch.bool, device=dev).tril()
        A[:, j + 1:, j + 1:] = torch.where(low, new, new.transpose(1, 2))
    a = torch.diagonal(A, dim1=1, dim2=2).clone()
    if n >= 2:
        b.append(A[:, n - 1, n - 2])
    b = torch.stack(b, dim=1) if b else H.new_zeros((T, 0))
    return a, b, ok


def _pivmin(b: torch.Tensor) -> torch.Tensor:
    """(T, 1) LAPACK's pivmin: FLT_MIN · max(1, max b²)."""
    e2 = b * b
    top = b.new_ones((b.shape[0], 1))
    if b.shape[1]:
        top = torch.maximum(top, e2.amax(1, keepdim=True))
    return top * FLT_MIN


def sturm_count(a: torch.Tensor, b: torch.Tensor,
                x: torch.Tensor) -> torch.Tensor:
    """(T, P) int64: the number of eigenvalues of each tridiagonal T
    (``a`` (T, n), ``b`` (T, n − 1)) at or below each point ``x`` (T, P),
    counted as the kernel counts them."""
    pivmin = _pivmin(b)
    e2 = b * b
    q = a[:, :1] - x
    q = torch.where(q.abs() < pivmin, -pivmin, q)
    cnt = (q <= 0).to(torch.int64)
    for i in range(1, a.shape[1]):
        q = (a[:, i:i + 1] - x) - e2[:, i - 1:i] / q
        q = torch.where(q.abs() < pivmin, -pivmin, q)
        cnt = cnt + (q <= 0).to(torch.int64)
    return cnt


def float_key(x: torch.Tensor) -> torch.Tensor:
    """int64 keys of float32 ``x``, in the floats' order (−0 just below
    +0)."""
    bits = x.contiguous().view(torch.int32)
    return (bits ^ ((bits >> 31) & 0x7FFFFFFF)).to(torch.int64)


def key_float(k: torch.Tensor) -> torch.Tensor:
    """The float32 of each int64 key (:func:`float_key`'s inverse)."""
    k32 = k.to(torch.int32)
    return (k32 ^ ((k32 >> 31) & 0x7FFFFFFF)).view(torch.float32)


def gershgorin_bracket(a: torch.Tensor, b: torch.Tensor):
    """``(lo, hi)`` (T,): T's Gershgorin interval widened by
    bnorm · n · 2⁻²¹ and by 4 pivmin at each end."""
    T, n = a.shape
    ab = b.abs()
    z = a.new_zeros((T, 1))
    rad = torch.cat([z, ab], dim=1) + torch.cat([ab, z], dim=1)
    gl = (a - rad).amin(1)
    gu = (a + rad).amax(1)
    bnorm = torch.maximum(gl.abs(), gu.abs())
    wid = bnorm * (n * WIDEN)
    pm4 = _pivmin(b)[:, 0] * 4.0
    return (gl - wid) - pm4, (gu + wid) + pm4


def smallest_eigenvalue(a: torch.Tensor, b: torch.Tensor, ok: torch.Tensor,
                        points: int, n_rounds: int) -> torch.Tensor:
    """Step 2 of the plain version: (T,) the smallest eigenvalue of each
    tridiagonal T by ``n_rounds`` rounds of a ``points``-point Sturm
    multisection; NaN where ``ok`` is false or T is not finite."""
    lo, hi = gershgorin_bracket(a, b)
    good = (ok & torch.isfinite(a).all(1) & torch.isfinite(b).all(1)
            & torch.isfinite(lo) & torch.isfinite(hi))
    zero = torch.zeros_like(lo, dtype=torch.int64)
    klo = torch.where(good, float_key(lo), zero)
    khi = torch.where(good, float_key(hi), zero)
    k1 = torch.arange(1, points + 1, device=a.device, dtype=torch.int64)
    for _ in range(n_rounds):
        span = khi - klo
        pts = klo[:, None] + torch.div(k1[None] * span[:, None], points + 1,
                                       rounding_mode="floor")
        hit = sturm_count(a, b, key_float(pts)) >= 1
        first = torch.argmax(hit.to(torch.int32), dim=1, keepdim=True)
        anyhit = hit.any(1)
        below = pts.gather(1, (first - 1).clamp(min=0))[:, 0]
        klo = torch.where(anyhit, torch.where(first[:, 0] > 0, below, klo),
                          pts[:, -1])
        khi = torch.where(anyhit, pts.gather(1, first)[:, 0], khi)
    return torch.where(good, key_float(khi),
                       torch.full_like(lo, float("nan")))


def block_eigmin_reference(H: torch.Tensor,
                           n_rounds: int | None = None) -> torch.Tensor:
    """The plain version: (T,) λ_min of each (d, d) block of ``H`` (T, d,
    d) float32, from its lower triangle, by Householder
    tridiagonalisation and :data:`ROUNDS` rounds of Sturm multisection
    (or ``n_rounds``). Elementwise operations, gathers and
    index arithmetic only, so a block's bits follow neither its batch nor
    the device."""
    if H.shape[0] == 0:
        return H.new_zeros((0,))
    a, b, ok = tridiagonal_reference(H)
    R = ROUNDS if n_rounds is None else int(n_rounds)
    return smallest_eigenvalue(a, b, ok, STURM_POINTS, R)


def cluster_size(d: int) -> int:
    """CTAs a block of width d takes on the card: 1 up to the widest
    block whose two triangles one CTA's shared memory holds (238), else
    the fewest whose shared memory holds the packed lower triangle (2 at
    d = 256, 3 at 512, 11 at 1,024). Asks the built kernel library."""
    fn = common.load_function("block_eigmin", "fia_block_eigmin_cluster",
                              [ctypes.c_int])
    return int(fn(int(d)))


def resident_clusters(d: int) -> int:
    """How many clusters of width d's size the card holds at once (0 when
    it cannot place one, -1 at a width of one CTA a block). Asks the
    built kernel library."""
    fn = common.load_function("block_eigmin",
                              "fia_block_eigmin_resident_clusters",
                              [ctypes.c_int])
    return int(fn(int(d)))


def block_eigmin(H: torch.Tensor) -> torch.Tensor:
    """(T,) λ_min of each block of ``H`` (T, d, d) float32, read from its
    lower triangle. A CUDA tensor launches the kernel on the current
    stream (or raises); a CPU tensor takes the plain version."""
    if H.device.type == "cpu":
        return block_eigmin_reference(H)
    if H.device.type != "cuda":
        raise ValueError(f"unsupported device {H.device}")
    if H.dtype != torch.float32:
        raise TypeError(f"H must be torch.float32, got {H.dtype}")
    if H.dim() != 3 or H.shape[1] != H.shape[2]:
        raise ValueError(f"H must have shape (T, d, d), got {tuple(H.shape)}")
    if not H.is_contiguous():
        raise ValueError("H must be contiguous")
    T, d = H.shape[0], H.shape[-1]
    if not 1 <= d <= MAX_D:
        raise ValueError(f"block size {d} outside the kernel's 1..{MAX_D}")
    lam = torch.empty((T,), dtype=torch.float32, device=H.device)
    if T == 0:
        return lam
    fn = common.load_function("block_eigmin", "fia_block_eigmin", _ARGTYPES)
    with torch.cuda.device(H.device):
        stream = torch.cuda.current_stream(H.device).cuda_stream
        rc = fn(H.data_ptr(), lam.data_ptr(), T, d, stream)
    if rc != 0:
        raise RuntimeError(f"block_eigmin kernel launch failed: cudaError "
                           f"{rc}")
    common.count_launch(sys.modules[__name__])
    return lam

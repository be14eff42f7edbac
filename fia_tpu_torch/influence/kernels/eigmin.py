"""The smallest eigenvalue of each of T symmetric d × d blocks: the CUDA
kernel's wrapper and its plain PyTorch version (the port of the
reference's ``jnp.linalg.eigvalsh(H)[:, 0]``,
``fia_tpu/influence/engine.py:2504-2506``, the sampled certificate's
λ_min; the kernel is ``csrc/block_eigmin.cu``).

The method is the parallel cyclic Jacobi eigenvalue algorithm, the same
rotations in the same order on both sides:

- the block is read from its lower triangle only (``eigvalsh``'s
  ``UPLO="L"``: the engine's H is not bit-symmetric) and padded to an
  even n = d + (d mod 2) with a zero row and column;
- a sweep is n − 1 steps of the round-robin (circle) ordering: at step r
  the n/2 disjoint pairs are (n − 1, r) and ((r + a) mod (n − 1),
  (r − a) mod (n − 1)) for a = 1 … n/2 − 1, so every pair of indices
  meets once a sweep;
- each pair (p, q) takes the rotation that zeroes its off-diagonal entry
  (Golub and Van Loan's ``sym.schur2``: τ = (a_qq − a_pp) / 2a_pq,
  t = sign(τ) / (|τ| + √(τ² + 1)), c = 1 / √(t² + 1), s = t c; t = 0
  where a_pq = 0), and the step applies all n/2 rotations at once: the
  2 × 2 block of pair a's rows and pair b's columns becomes
  R_aᵀ X R_b (columns first, then rows), for a > b, mirrored to (b, a);
  pair a's own block becomes diag(a_pp − t a_pq, a_qq + t a_pq);
- after :func:`sweeps` ``(d)`` sweeps, a fixed count, λ_min is the
  smallest of the first d diagonal entries (NaN if any is NaN).

Every multiply, add, divide and square root rounds on its own, in a
fixed order, and nothing depends on the other blocks of the batch: a
block's λ_min is the same bits alone and in any batch, on either side.
The kernel does the same operations in the same order, so on the card
it is held to the plain version bit for bit, and to float64
``eigvalsh`` at a bar of c · d · eps · ‖H‖_F.

A fixed sweep count, not a convergence test, so no step waits on the
host and the whole program can be captured in a CUDA graph.
"""

from __future__ import annotations

import ctypes
import math
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
#: sweeps at the smallest blocks; one more for each doubling of d
#: beyond BASE_D (see :func:`sweeps`)
BASE_SWEEPS, BASE_D = 8, 16

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_void_p]


def sweeps(d: int) -> int:
    """Jacobi sweeps for a d × d block: BASE_SWEEPS up to BASE_D, one
    more for each doubling beyond (cyclic Jacobi converges
    quadratically once the off-diagonal mass is small, and the sweeps it
    takes to get there grow about as log d)."""
    d = max(int(d), 1)
    return BASE_SWEEPS + max(0, math.ceil(math.log2(d / BASE_D)))


def padded_size(d: int) -> int:
    """n: d rounded up to even (an odd block gets a zero row and column,
    which no rotation moves)."""
    return d + (d % 2)


def round_robin(n: int) -> torch.Tensor:
    """(n − 1, n/2, 2) int64: the pairs (p, q) of each step of a sweep."""
    h = n // 2
    r = torch.arange(n - 1)[:, None]
    a = torch.arange(h)[None, :]
    p = torch.where(a == 0, n - 1, (r + a) % (n - 1))
    q = torch.where(a == 0, r.expand(-1, h), (r - a) % (n - 1))
    return torch.stack([p, q], dim=-1)


def _symmetric(H: torch.Tensor, n: int) -> torch.Tensor:
    """(T, n, n) exactly symmetric: H's lower triangle mirrored (an exact
    copy of each entry), padded with zero rows and columns."""
    d = H.shape[-1]
    lower = torch.ones(d, d, dtype=torch.bool, device=H.device).tril()
    A = torch.where(lower, H, H.transpose(-2, -1))
    if n > d:
        A = torch.nn.functional.pad(A, (0, n - d, 0, n - d))
    return A.contiguous()


def _rotation(app, aqq, apq):
    """``(t, c, s)`` of the rotations zeroing a_pq (elementwise)."""
    theta = (aqq - app) / (2.0 * apq)
    sign = torch.where(theta >= 0, 1.0, -1.0).to(app.dtype)
    t = sign / (torch.abs(theta) + torch.sqrt(theta * theta + 1.0))
    t = torch.where(apq == 0, torch.zeros_like(t), t)
    c = 1.0 / torch.sqrt(t * t + 1.0)
    return t, c, c * t


def block_eigmin_reference(H: torch.Tensor,
                           n_sweeps: int | None = None) -> torch.Tensor:
    """The plain version: (T,) λ_min of each (d, d) block of ``H`` (T, d,
    d), from its lower triangle, by :func:`sweeps` ``(d)`` cyclic Jacobi
    sweeps (or ``n_sweeps``). Elementwise operations, gathers and
    scatters only, so a block's bits follow neither its batch nor the
    device."""
    T, d = H.shape[0], H.shape[-1]
    if T == 0:
        return H.new_zeros((0,))
    n = padded_size(d)
    A = _symmetric(H, n)
    pairs = round_robin(n).to(H.device)
    h = n // 2
    lower = (torch.arange(h)[:, None] > torch.arange(h)[None, :]).to(
        H.device)
    eye = torch.eye(h, dtype=torch.bool, device=H.device)
    n_sweeps = sweeps(d) if n_sweeps is None else int(n_sweeps)
    for _ in range(n_sweeps):
        for r in range(n - 1):
            P, Q = pairs[r, :, 0], pairs[r, :, 1]
            app, aqq, apq = A[:, P, P], A[:, Q, Q], A[:, P, Q]
            t, c, s = _rotation(app, aqq, apq)
            x11 = A[:, P[:, None], P[None, :]]
            x12 = A[:, P[:, None], Q[None, :]]
            x21 = A[:, Q[:, None], P[None, :]]
            x22 = A[:, Q[:, None], Q[None, :]]
            cb, sb = c[:, None, :], s[:, None, :]
            ca, sa = c[:, :, None], s[:, :, None]
            # columns by pair b's rotation, then rows by pair a's
            y11 = cb * x11 - sb * x12
            y12 = sb * x11 + cb * x12
            y21 = cb * x21 - sb * x22
            y22 = sb * x21 + cb * x22
            z11 = ca * y11 - sa * y21
            z21 = sa * y11 + ca * y21
            z12 = ca * y12 - sa * y22
            z22 = sa * y12 + ca * y22
            # blocks a > b as computed, a < b their mirrors, a == b the
            # pair's own diagonalised block
            ta = t * apq
            zero = torch.zeros_like(z11)
            pp = torch.where(lower, z11, z11.transpose(1, 2))
            pq = torch.where(lower, z12, z21.transpose(1, 2))
            qp = torch.where(lower, z21, z12.transpose(1, 2))
            qq = torch.where(lower, z22, z22.transpose(1, 2))
            pp = torch.where(eye, torch.diag_embed(app - ta), pp)
            qq = torch.where(eye, torch.diag_embed(aqq + ta), qq)
            pq = torch.where(eye, zero, pq)
            qp = torch.where(eye, zero, qp)
            A[:, P[:, None], P[None, :]] = pp
            A[:, P[:, None], Q[None, :]] = pq
            A[:, Q[:, None], P[None, :]] = qp
            A[:, Q[:, None], Q[None, :]] = qq
    return torch.amin(torch.diagonal(A, dim1=1, dim2=2)[:, :d], dim=1)


def _smem_max_d() -> int:
    """The largest d the kernel holds in shared memory (above it the
    wrapper allocates a device-memory scratch)."""
    fn = common.load_function("block_eigmin", "fia_block_eigmin_smem_max_d",
                              [])
    return int(fn())


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
    scratch = None
    if d > _smem_max_d():
        n = padded_size(d)
        scratch = torch.empty((T, n, n), dtype=torch.float32,
                              device=H.device)
    with torch.cuda.device(H.device):
        stream = torch.cuda.current_stream(H.device).cuda_stream
        rc = fn(H.data_ptr(), lam.data_ptr(),
                None if scratch is None else scratch.data_ptr(), T, d,
                sweeps(d), stream)
    if rc != 0:
        raise RuntimeError(f"block_eigmin kernel launch failed: cudaError "
                           f"{rc}")
    common.count_launch(sys.modules[__name__])
    return lam

"""Hessian spectrum tools (port of ``fia_tpu/influence/spectral.py``):
power iteration for the dominant eigenvalue, a shifted second pass for
the other extreme, and the spectrum-derived LiSSA tuning.

Every function takes a matrix-free symmetric operator ``hvp`` over the
last axis and runs one power iteration per lane of ``batch_shape``: the
engine tunes T block Hessians at once, ``hvp`` mapping (T, d) to (T, d).
The start vector is drawn once from ``generator`` (default: a CPU
generator seeded 0), normalised, moved to ``device`` and shared by every
lane and both passes, as the reference's single ``PRNGKey(0)`` is under
its vmap. It cannot equal the reference's ``jax.random`` draw, so
results agree with the reference at tolerance, not bit for bit.
"""

from __future__ import annotations

from typing import Callable

import torch

Operator = Callable[[torch.Tensor], torch.Tensor]


def _start(dim: int, generator, batch_shape, device) -> torch.Tensor:
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    v0 = torch.randn(dim, generator=generator, dtype=torch.float32,
                     device=generator.device)
    v0 = (v0 / torch.linalg.norm(v0)).to(device)
    return v0.expand(*batch_shape, dim).clone()


def _power(hvp: Operator, v: torch.Tensor, num_iters: int):
    for _ in range(num_iters):
        w = hvp(v)
        v = w / torch.clamp(torch.linalg.norm(w, dim=-1, keepdim=True),
                            min=1e-30)
    return torch.sum(v * hvp(v), dim=-1), v


def power_iteration(hvp: Operator, dim: int, num_iters: int = 100,
                    generator: torch.Generator | None = None,
                    batch_shape: tuple = (), device=None):
    """(eigval, eigvec) of the dominant (largest-magnitude) eigenpair:
    shapes ``batch_shape`` and ``batch_shape + (dim,)``."""
    return _power(hvp, _start(dim, generator, batch_shape, device),
                  num_iters)


def extreme_eigvals(hvp: Operator, dim: int, num_iters: int = 100,
                    generator: torch.Generator | None = None,
                    batch_shape: tuple = (), device=None):
    """(largest, smallest) eigenvalues of the symmetric operator. The
    first pass finds the dominant-magnitude one λ_d (the most negative,
    for an indefinite block); a second on H − λ_d I gives the other end.
    The pair is ordered by value, not by pass."""
    v0 = _start(dim, generator, batch_shape, device)
    lam_dom, _ = _power(hvp, v0, num_iters)
    shift = lam_dom.unsqueeze(-1)
    lam_shift, _ = _power(lambda v: hvp(v) - shift * v, v0, num_iters)
    other = lam_shift + lam_dom
    return torch.maximum(lam_dom, other), torch.minimum(lam_dom, other)


def block_hessian_eigvals(H: torch.Tensor) -> torch.Tensor:
    """Exact spectrum of materialised (tiny) block Hessians."""
    return torch.linalg.eigvalsh(H)


def lissa_tuning(hvp: Operator, dim: int, scale_floor: float = 0.0,
                 num_iters: int = 100, shift_margin: float = 1.5,
                 scale_margin: float = 1.2,
                 generator: torch.Generator | None = None,
                 batch_shape: tuple = (), device=None):
    """Spectrum-derived ``(scale, shift)`` for the LiSSA recursion.

    It converges iff every eigenvalue of H/scale lies in (0, 2), and a
    negative λ_min (an indefinite block, reachable away from an optimum
    through the e·C cross term) diverges at any scale, so it is shifted
    out first. With both extremes from :func:`extreme_eigvals`:

        shift = shift_margin · max(−λ_min, 0)   (PD blocks: 0)
        scale = max(scale_floor, scale_margin · (λ_max + shift))

    and the recursion on H + shift·I converges to (H + shift·I)⁻¹ v. The
    margins are wide because Rayleigh quotients approach the extremes
    from inside the spectrum.
    """
    lam_max, lam_min = extreme_eigvals(hvp, dim, num_iters, generator,
                                       batch_shape, device)
    shift = shift_margin * torch.clamp(-lam_min, min=0.0)
    scale = torch.clamp(scale_margin * (lam_max + shift), min=scale_floor)
    return scale, shift

"""Inverse-HVP solvers (port of ``fia_tpu/influence/solvers.py``).

Every solver is batched over the leading axes of ``v`` (T queries, each
a (d,) right-hand side): ``hvp`` maps (..., d) to (..., d), row by row.

The reference runs the iterative solvers as ``lax.while_loop``s under
``vmap``, whose batching rule keeps iterating until every lane's
condition is false and freezes each lane whose own condition is already
false (the lane keeps its old carry). PyTorch has no such loop, so
:func:`solve_cg` and :func:`solve_schulz` carry that freeze explicitly: a
per-lane ``active`` mask, the step computed for every lane and kept only
where the lane is active. The loop runs until no lane is active (the host
reads ``active.any()`` once an iteration, at most ``maxiter`` waits on
the device) or ``maxiter``; a lane that converges early ends with the
values it would have alone. Both return ``(x, iterations)``.
"""

from __future__ import annotations

from typing import Callable

import torch

Operator = Callable[[torch.Tensor], torch.Tensor]


def solve_direct(H: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Solve H x = v by LU with partial pivoting; batched over leading
    dims ((T, d, d), (T, d) -> (T, d)).

    LU rather than Cholesky: at a well-trained optimum the damped block
    Hessian is PD, but away from it the MSE Hessian's second-order term
    can make H indefinite (Cholesky would silently produce NaNs).
    ``solve_ex`` skips the singularity check, which would wait on the
    device; a singular block yields non-finite values, as in the
    reference.
    """
    return torch.linalg.solve_ex(H, v, check_errors=False)[0]


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b, dim=-1)


def relative_residual(hvp: Operator, v: torch.Tensor, x: torch.Tensor
                      ) -> torch.Tensor:
    """‖Hx − v‖ / ‖v‖ per lane: one extra HVP."""
    r = hvp(x) - v
    return torch.linalg.norm(r, dim=-1) / torch.clamp(
        torch.linalg.norm(v, dim=-1), min=1e-30)


def solve_cg(hvp: Operator, v: torch.Tensor, maxiter: int = 100,
             tol: float = 1e-10, x0: torch.Tensor | None = None):
    """Conjugate gradients on H x = v with a matrix-free hvp.

    A lane runs while ‖r‖² > tol · max(‖v‖², tiny) (and the loop has run
    fewer than ``maxiter`` times). Inside the step a lane that meets
    negative curvature (pᵀHp ≤ 0, H not PD away from an optimum) keeps
    its x, Newton-CG style, and stops. Returns ``(x, iterations)``.
    """
    x = torch.zeros_like(v) if x0 is None else x0
    r = v - hvp(x)
    p = r
    rs = _dot(r, r)
    threshold = tol * torch.clamp(_dot(v, v), min=1e-30)
    it = 0
    while it < maxiter:
        active = rs > threshold
        if not bool(active.any()):
            break
        hp = hvp(p)
        denom = _dot(p, hp)
        stop = (rs <= threshold) | (denom <= 0.0)
        alpha = torch.where(stop, 0.0, rs / torch.where(denom != 0.0, denom,
                                                        1.0))
        x_n = x + alpha[..., None] * p
        r_n = r - alpha[..., None] * hp
        rs_n = torch.where(stop, rs, _dot(r_n, r_n))
        beta = torch.where(stop, 0.0, rs_n / torch.where(rs != 0.0, rs, 1.0))
        p_n = torch.where(stop[..., None], p, r_n + beta[..., None] * p)
        # a negative-curvature lane leaves the loop: its rs goes to 0
        rs_n = torch.where((denom <= 0.0) & (rs > threshold),
                           torch.zeros_like(rs_n), rs_n)
        a = active[..., None]
        x = torch.where(a, x_n, x)
        r = torch.where(a, r_n, r)
        p = torch.where(a, p_n, p)
        rs = torch.where(active, rs_n, rs)
        it += 1
    return x, it


def solve_schulz(H: torch.Tensor, v: torch.Tensor, maxiter: int = 128,
                 tol: float = 1e-6):
    """Hyperpower (Newton–Schulz) solve: X ← X(2I − HX), x = Xv, from
    X₀ = Hᵀ/(‖H‖₁‖H‖∞), which has ‖I − HX₀‖ < 1 for any nonsingular H
    (HyperINF, arXiv:2410.05090). Matmul only, in full float32.

    A lane runs while the RMS of I − HX exceeds ``tol``, its latest
    residual is finite and below twice its best, and the loop has run
    fewer than ``maxiter`` times: a plateau does not stop it (slow modes
    take ≈ 2·log₂ κ + 6 steps), but divergence beyond float32's reach
    (κ ≳ 1/eps) or a NaN does, and the lane returns its best iterate,
    never NaN. Returns ``(x, iterations)``.
    """
    d = H.shape[-1]
    eye = torch.eye(d, dtype=H.dtype, device=H.device)
    norm1 = torch.amax(torch.sum(torch.abs(H), dim=-2), dim=-1)
    norminf = torch.amax(torch.sum(torch.abs(H), dim=-1), dim=-1)
    X0 = H.transpose(-2, -1) / torch.clamp(norm1 * norminf,
                                           min=1e-30)[..., None, None]

    def resid(X):
        R = eye - H @ X
        return torch.sqrt(torch.mean(torch.square(R), dim=(-2, -1)))

    X_cur = X_best = X0
    r_best = r_cur = resid(X0)
    it = 0
    while it < maxiter:
        ok = torch.isfinite(r_cur) & (r_cur < 2.0 * r_best)
        active = (r_best > tol) & ok
        if not bool(active.any()):
            break
        X_new = X_cur @ (2.0 * eye - H @ X_cur)
        r_new = resid(X_new)
        better = active & torch.isfinite(r_new) & (r_new < r_best)
        a = active[..., None, None]
        X_best = torch.where(better[..., None, None], X_new, X_best)
        r_best = torch.where(better, r_new, r_best)
        X_cur = torch.where(a, X_new, X_cur)
        r_cur = torch.where(active, r_new, r_cur)
        it += 1
    return (X_best @ v[..., None])[..., 0], it


def _per_lane(s, v: torch.Tensor) -> torch.Tensor:
    """A scale (a number, or one per lane) shaped to broadcast over v."""
    s = torch.as_tensor(s, dtype=v.dtype, device=v.device)
    return s[..., None] if s.ndim else s


def solve_lissa(hvp: Operator, v: torch.Tensor, scale=10.0,
                damping: float = 0.0, recursion_depth: int = 1000,
                num_samples: int = 1,
                sample_hvp: Callable[[int, torch.Tensor], torch.Tensor]
                | None = None,
                auto_scale: bool = True) -> torch.Tensor:
    """LiSSA inverse-HVP estimate: ``recursion_depth`` steps of
    cur ← v + (1 − damping)·cur − H(cur)/scale from cur = v, the result
    cur/scale, averaged over ``num_samples`` recursions. A fixed-depth
    loop: no lane stops early.

    ``sample_hvp(j, x)``, when given, is the HVP on the j-th stochastic
    minibatch (sample i draws j = i·depth + step, so repetitions differ);
    otherwise ``hvp`` is used every step. ``scale`` is a number or one
    per lane.

    The recursion converges only when λ_max(H) < 2·scale. ``auto_scale``
    estimates λ_max per lane by a 32-step power iteration on the
    deterministic ``hvp`` from v/‖v‖, and lifts the scale to
    margin·λ_max (1.05; 1.5 with ``sample_hvp``) only where the given one
    would diverge; the fixed point (H/scale)⁻¹v/scale = H⁻¹v does not
    depend on the scale.
    """
    scale = torch.as_tensor(scale, dtype=v.dtype, device=v.device)
    if auto_scale:
        nv = torch.linalg.norm(v, dim=-1, keepdim=True)
        w = torch.where(nv > 0, v / torch.clamp(nv, min=1e-30),
                        torch.ones_like(v) / v.shape[-1] ** 0.5)
        lam = torch.zeros(v.shape[:-1], dtype=v.dtype, device=v.device)
        for _ in range(32):
            hw = hvp(w)
            lam = torch.linalg.norm(hw, dim=-1)
            w = hw / torch.clamp(lam, min=1e-30)[..., None]
        margin = 1.05 if sample_hvp is None else 1.5
        scale = torch.maximum(scale, margin * lam)
    s = _per_lane(scale, v)
    acc = torch.zeros_like(v)
    for i in range(num_samples):
        cur = v
        for j in range(recursion_depth):
            hv = (sample_hvp(i * recursion_depth + j, cur)
                  if sample_hvp is not None else hvp(cur))
            cur = v + (1.0 - damping) * cur - hv / s
        acc = acc + cur / s
    return acc / num_samples

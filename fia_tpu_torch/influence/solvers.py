"""Inverse-HVP solvers (port of ``fia_tpu/influence/solvers.py:35-42``;
the iterative solvers come in a later slice)."""

from __future__ import annotations

import torch


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

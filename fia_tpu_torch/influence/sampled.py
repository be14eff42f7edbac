"""Subsampled block-Hessian estimation with a concentration certificate
(port of ``fia_tpu/influence/sampled.py``).

The ``sampled`` solver rung sits between the ``precomputed`` bank and
``lissa`` on the degradation ladder (``reliability/policy.py``): the
block Hessian of a query is accumulated over a fixed-size subsample of
its related rows, each sampled row at the Horvitz–Thompson weight n/m,
and the answer carries a per-query bound on its score error. The score
pass still covers every related row. At ``m == n`` the weights are all
1 and the program is bitwise the exact flat program, with a bound of 0.

Certificate. With the per-row Hessian action on the solved vector x,
``h_s(x) = wv_s g_s (g_s·x) + ab_s e_s (C x)``, the sampled Hessian's
defect is a mean-of-samples deviation whose scale is the sample standard
deviation σ̂ of h_s over the sampled rows (the kernel
``kernels/certificate.py``):

    ‖ΔH x‖ ≲ 2 z σ̂ fpc / √m,   fpc = √((n − m)/(n − 1)),

pushed through the inverse by λ_min(H) (:func:`ihvp_error_bound`) and
through the fused score form into a per-row score bound
(:func:`score_error_bound`).

The sampling is host-side and the reference's verbatim
(:func:`sample_weights`: numpy Philox keyed on the (u, i) pair), so a
query draws the same rows in both packages, in any batch.
"""

from __future__ import annotations

import numpy as np
import torch

# Confidence multiplier for the one-sided deviation estimate (~3 sigma).
CONFIDENCE_Z = 3.0

# Philox key-domain separator so the sampler's stream can never collide
# with data-generation or training streams keyed on small integers.
SAMPLE_DOMAIN = 0x5AE1

# Default per-query Hessian sample cap (rows). Queries with fewer
# related rows than the cap are exact (err_bound == 0).
DEFAULT_CAP = 64


def sample_weights(
    pairs: np.ndarray,
    counts: np.ndarray,
    s_pad: int,
    cap: int,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """Per-dispatch Hessian sample-weight vector, host-side.

    ``pairs`` is the (T, 2) int query array, ``counts`` the (T,)
    related-row counts in flat-row order (query t's rows occupy the
    contiguous span ``[offset_t, offset_t + n_t)`` of the concatenated
    postings, the layout ``_flat_prelude`` builds on the device).
    Returns ``(ws, m)``: ``ws`` is the (s_pad,) float32 weight vector —
    ``n_t / m_t`` at sampled positions, 0 elsewhere (including every pad
    row) — and ``m`` the (T,) int32 sample sizes.
    """
    total = int(np.sum(counts))
    if total > s_pad:
        raise ValueError(f"flat rows {total} exceed s_pad {s_pad}")
    ws = np.zeros(s_pad, np.float32)
    m = np.zeros(len(counts), np.int32)
    off = 0
    for t, n in enumerate(int(c) for c in counts):
        mt = min(n, int(cap))
        m[t] = mt
        if mt >= n:
            ws[off:off + n] = 1.0
        elif mt > 0:
            u, i = int(pairs[t][0]), int(pairs[t][1])
            # 2x64-bit Philox key: (domain ‖ seed, u ‖ i)
            gen = np.random.Generator(np.random.Philox(
                key=np.array(
                    [(SAMPLE_DOMAIN << 32) ^ (seed & 0xFFFFFFFF),
                     ((u & 0xFFFFFFFF) << 32) | (i & 0xFFFFFFFF)],
                    dtype=np.uint64)))
            idx = gen.choice(n, size=mt, replace=False)
            ws[off + idx] = np.float32(n) / np.float32(mt)
        off += n
    return ws, m


def ihvp_error_bound(sigma: torch.Tensor, m: torch.Tensor, n: torch.Tensor,
                     lam) -> torch.Tensor:
    """``‖x_m − x‖`` bound per query from the sample deviation:
    ``2 z σ̂ fpc / (√m · λ)``. The 2 is the Hessian's ``2/n`` loss
    convention, ``lam`` lower-bounds ``λ_min(H)`` (a damping floor or a
    per-query measured spectrum), and the finite-population correction
    zeroes the bound at ``m == n``."""
    mf = torch.clamp(m.to(sigma.dtype), min=1.0)
    nf = torch.clamp(n.to(sigma.dtype), min=1.0)
    fpc = torch.sqrt(torch.clamp(nf - mf, min=0.0)
                     / torch.clamp(nf - 1.0, min=1.0))
    return 2.0 * CONFIDENCE_Z * sigma * fpc / (torch.sqrt(mf) * lam)


def score_error_bound(gmax: torch.Tensor, wmax: torch.Tensor,
                      regnorm: torch.Tensor, err_ihvp: torch.Tensor,
                      n: torch.Tensor) -> torch.Tensor:
    """Per-query bound on ``max_s |score_s − score_s^exact|``, from the
    fused score form ``wv (2 e (g·x) + reg_dot) / n``: ``gmax`` is the
    segment max of ``wv_s · 2|e_s| · ‖g_s‖``, ``wmax`` that of ``wv_s``,
    ``regnorm = ‖rdiag ⊙ θ_t‖`` (the ``reg_dot`` term's Lipschitz
    constant in x)."""
    nf = torch.clamp(n.to(err_ihvp.dtype), min=1.0)
    return (gmax + wmax * regnorm) * err_ihvp / nf

"""Fidelity metrics (copy of ``fia_tpu/eval/metrics.py``): Pearson
(reference RQ1.py:165) and Spearman, NaN-masked.

Thin finite-masking wrappers over scipy.stats — the reference itself
scores RQ1 with ``scipy.stats.pearsonr`` (RQ1.py:165), so delegating
keeps the metric definitions identical by construction.
"""

from __future__ import annotations

import numpy as np
from scipy import stats


def _masked(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    mask = np.isfinite(a) & np.isfinite(b)
    return a[mask], b[mask]


def pearson(a, b) -> float:
    a, b = _masked(a, b)
    if len(a) < 2 or np.ptp(a) == 0 or np.ptp(b) == 0:
        return float("nan")
    r, _ = stats.pearsonr(a, b)  # tuple unpack works on all scipy versions
    return float(r)


def spearman(a, b) -> float:
    a, b = _masked(a, b)
    if len(a) < 2 or np.ptp(a) == 0 or np.ptp(b) == 0:
        return float("nan")
    rho, _ = stats.spearmanr(a, b)
    return float(rho)

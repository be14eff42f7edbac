"""The non-finite payload class of the failure taxonomy (copy of
``fia_tpu/reliability/taxonomy.py:219-233``).

A diverged LiSSA recursion returns a "successful" buffer full of NaNs:
no exception reaches the host, so the class is read off the fetched
host arrays, and recovery is the solver ladder
(:mod:`fia_tpu_torch.reliability.policy`).
"""

from __future__ import annotations

import numpy as np

NAN = "nan"


def classify_payload(*arrays) -> str | None:
    """``NAN`` when any array holds a non-finite value, else ``None``;
    ``None`` entries are skipped (lazy result fields)."""
    for a in arrays:
        if a is None:
            continue
        a = np.asarray(a)
        if a.dtype.kind == "f" and not np.isfinite(a).all():
            return NAN
    return None

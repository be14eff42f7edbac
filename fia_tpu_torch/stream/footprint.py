"""Touched-block footprint of a streaming update or removal (port of
``fia_tpu/stream/footprint.py``, plain numpy, unchanged).

A delta batch (appended interactions, or removed/reweighted rows)
directly perturbs the users ΔU and items ΔI it names. Two distinct
sets follow from that, and they are NOT the same set:

- **moved rows** (``user_touched`` / ``item_touched``) — the parameter
  rows the fine-tune is allowed to change. u moves if u ∈ ΔU or u has
  an interaction with a ΔI item (its embedding re-optimizes against
  that item's moved Q row); symmetrically for items. The projection in
  ``stream.update`` pins every row OUTSIDE this set to its pre-update
  bytes, which is what keeps the moved set from cascading further.
- **read-reached blocks** (``user_read`` / ``item_read``) — the blocks
  whose solve READS a moved row. The (u, i) block Hessian gathers the
  P/Q rows of every counterparty in the pair's related set
  (``factor.dep_crcs`` documents the exact read set), so a block whose
  own u/i rows are pinned still computes differently when any
  counterparty row moved: ``user_read[u]`` iff u moved or any of u's
  interactions names a moved item (and symmetrically). One extra
  adjacency hop past the moved set — and exactly one, because the
  projection froze the moved set.

``touched(u, i)`` — the predicate surgical cache invalidation keys on
— answers from the READ masks: everything outside it provably computes
bit-identically under the projected params, so untouched cache entries
re-key to the new fingerprint without recompute. The projection itself
keys on the MOVED masks. (Conflating the two was a real stale-bytes
bug: a block outside the moved set but inside the read set served
pre-update scores after a removal — caught by the reference's
``bench.py unlearn`` byte-level probe on an unstructured interaction
graph; the community-structured churn bench could never see it because
there the two closures coincide.)

The masks are computed over the OLD train set: a delta row names only
ΔU users and ΔI items, both already first-order touched, so it adds no
reach beyond what the old adjacency gives.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Footprint:
    """Boolean touch masks over the user/item id spaces."""

    user_touched: np.ndarray  # (num_users,) bool — moved rows (projection)
    item_touched: np.ndarray  # (num_items,) bool
    delta_users: np.ndarray  # unique user ids named by the update
    delta_items: np.ndarray  # unique item ids named by the update
    # read-reach masks (invalidation); None falls back to the moved
    # masks — correct only when the caller guarantees the closures
    # coincide (e.g. hand-built fixtures)
    user_read: np.ndarray | None = None
    item_read: np.ndarray | None = None

    def touched(self, user: int, item: int) -> bool:
        """Whether the (user, item) block's SOLVE reads any moved row —
        the predicate cache invalidation must key on."""
        ur = self.user_read if self.user_read is not None else self.user_touched
        ir = self.item_read if self.item_read is not None else self.item_touched
        return bool(ur[int(user)]) or bool(ir[int(item)])

    def touched_pairs(self, pairs: np.ndarray) -> np.ndarray:
        """(N,) bool mask for an (N, 2) array of (user, item) pairs."""
        ur = self.user_read if self.user_read is not None else self.user_touched
        ir = self.item_read if self.item_read is not None else self.item_touched
        p = np.asarray(pairs, np.int64)
        return ur[p[:, 0]] | ir[p[:, 1]]

    @property
    def num_touched_users(self) -> int:
        return int(np.count_nonzero(self.user_touched))

    @property
    def num_touched_items(self) -> int:
        return int(np.count_nonzero(self.item_touched))


def compute_footprint(train_x, new_x, num_users: int,
                      num_items: int) -> Footprint:
    """The footprint of applying delta rows ``new_x`` against ``train_x``.

    ``train_x``: (N, 2) old interaction ids; ``new_x``: (M, 2) delta
    ids (appended interactions, or the rows being removed/reweighted —
    the reach analysis is identical). Pure vectorized numpy — scatter
    passes and bincounts, no index structure required.
    """
    x = np.asarray(train_x, np.int64).reshape(-1, 2)
    nx = np.asarray(new_x, np.int64).reshape(-1, 2)
    du = np.unique(nx[:, 0])
    di = np.unique(nx[:, 1])

    in_du = np.zeros(int(num_users), bool)
    in_du[du] = True
    in_di = np.zeros(int(num_items), bool)
    in_di[di] = True

    def _neighbors(endpoint_mask, src_col, dst_col, size):
        """Ids in ``dst_col`` sharing a row with a masked ``src_col`` id."""
        rows = endpoint_mask[x[:, src_col]]
        return np.bincount(x[rows, dst_col], minlength=size) > 0

    # moved rows: Δ plus one hop through the old adjacency (a user
    # re-optimizes against a ΔI item's moved Q row, and vice versa)
    user_moved = in_du | _neighbors(in_di, 1, 0, int(num_users))
    item_moved = in_di | _neighbors(in_du, 0, 1, int(num_items))

    # read reach: one further hop — a pinned user still serves changed
    # bytes when any counterparty item row it gathers has moved
    user_read = user_moved | _neighbors(item_moved, 1, 0, int(num_users))
    item_read = item_moved | _neighbors(user_moved, 0, 1, int(num_items))

    return Footprint(
        user_touched=user_moved,
        item_touched=item_moved,
        delta_users=du,
        delta_items=di,
        user_read=user_read,
        item_read=item_read,
    )

"""CSR-style inverted index over (user, item) interactions (port of
``fia_tpu/data/index.py``). The CSR arrays come from the native
counting-sort CSR code (:mod:`fia_tpu_torch.data.native`) where its
library is available, and from a stable argsort otherwise: the same
arrays either way.

The FIA related set of a test pair (u*, i*) — every training row whose
user is u* or whose item is i* — is two CSR row lookups. The postings
are uploaded to the device once, and the engine gathers related rows
there. ``related`` and single-query ``related_padded`` are memoized as
the reference's are (bounded LRUs of read-only arrays): a serving stream
revisits its hot pairs.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np

from fia_tpu_torch.data.native import build_csr


def bucketed_pad(max_count: int, bucket: int, pad_to: int | None = None) -> int:
    """Pad length for ragged related sets, or ``pad_to`` verbatim after
    validating it fits.

    Rounds ``max_count`` up to a multiple of ``bucket``; past 16×bucket
    the granule grows geometrically (m/8, i.e. ~12.5% steps), so the
    number of distinct pad lengths is logarithmic, at ≤12.5% padding
    waste."""
    if pad_to is not None:
        if max_count > pad_to:
            raise ValueError(
                f"pad_to={pad_to} smaller than max related count {max_count}"
            )
        return int(pad_to)
    m = max(int(max_count), 1)
    granule = max(bucket, 1 << max(0, m.bit_length() - 4))
    return max(bucket, -(-m // granule) * granule)


class InteractionIndex:
    def __init__(self, x: np.ndarray, num_users: int | None = None,
                 num_items: int | None = None):
        x = np.asarray(x)
        self.num_users = int(num_users if num_users is not None else x[:, 0].max() + 1)
        self.num_items = int(num_items if num_items is not None else x[:, 1].max() + 1)
        self._u_indptr, self._u_rows = build_csr(x[:, 0], self.num_users)
        self._i_indptr, self._i_rows = build_csr(x[:, 1], self.num_items)
        # related() memo (bounded LRU; the entries are write-protected,
        # since several callers hold them) and the single-query
        # related_padded memo, keyed by pair + resolved pad
        self._related_memo: OrderedDict[tuple, np.ndarray] = OrderedDict()
        self._related_memo_cap = 4096
        self.memo_hits = 0
        self.memo_misses = 0
        self._padded_memo: OrderedDict[tuple, tuple] = OrderedDict()
        self._padded_memo_cap = 1024

    def rows_of_user(self, u: int) -> np.ndarray:
        return self._u_rows[self._u_indptr[u] : self._u_indptr[u + 1]]

    def rows_of_item(self, i: int) -> np.ndarray:
        return self._i_rows[self._i_indptr[i] : self._i_indptr[i + 1]]

    def related(self, u: int, i: int) -> np.ndarray:
        """Training rows sharing user u or item i: user rows first, then
        item rows, so a row matching both (the (u, i) interaction itself)
        appears twice — the reference's ordering. Memoized: a read-only
        array."""
        key = (int(u), int(i))
        memo = self._related_memo
        hit = memo.get(key)
        if hit is not None:
            memo.move_to_end(key)
            self.memo_hits += 1
            return hit
        self.memo_misses += 1
        out = np.concatenate([self.rows_of_user(u), self.rows_of_item(i)])
        out.setflags(write=False)
        memo[key] = out
        if len(memo) > self._related_memo_cap:
            memo.popitem(last=False)
        return out

    def related_count(self, u: int, i: int) -> int:
        return int(
            self._u_indptr[u + 1] - self._u_indptr[u]
            + self._i_indptr[i + 1] - self._i_indptr[i]
        )

    def user_degrees(self) -> np.ndarray:
        """Interaction count per user id, (num_users,) int64."""
        return np.diff(self._u_indptr)

    def item_degrees(self) -> np.ndarray:
        """Interaction count per item id, (num_items,) int64."""
        return np.diff(self._i_indptr)

    def max_related_count(self) -> int:
        """Upper bound on any query's related-set size: the heaviest user
        degree plus the heaviest item degree (``pad_policy="dataset"``
        pads every batch to it)."""
        return int(
            np.diff(self._u_indptr).max(initial=0)
            + np.diff(self._i_indptr).max(initial=0)
        )

    def counts_batch(self, test_points: np.ndarray) -> np.ndarray:
        """Related-set sizes for a (T, 2) batch — O(T) indptr diffs."""
        test_points = np.asarray(test_points)
        u = test_points[:, 0]
        i = test_points[:, 1]
        return (
            self._u_indptr[u + 1] - self._u_indptr[u]
            + self._i_indptr[i + 1] - self._i_indptr[i]
        ).astype(np.int32)

    def postings(self):
        """The raw CSR arrays (u_indptr, u_rows, i_indptr, i_rows)."""
        return self._u_indptr, self._u_rows, self._i_indptr, self._i_rows

    def related_padded(self, test_points: np.ndarray, pad_to: int | None = None,
                       bucket: int = 128):
        """Batched related sets as rectangular arrays.

        Returns:
          idx:   (T, P) int32 — related train-row ids, padded with 0.
          mask:  (T, P) bool  — True on real entries.
          count: (T,)   int32 — true related-set sizes.
        """
        test_points = np.asarray(test_points)
        if len(test_points) == 1:
            u, i = (int(v) for v in test_points[0])
            key = (u, i, bucketed_pad(self.related_count(u, i), bucket,
                                      pad_to))
            hit = self._padded_memo.get(key)
            if hit is not None:
                self._padded_memo.move_to_end(key)
                self.memo_hits += 1
                return hit
        lists = [self.related(int(u), int(i)) for u, i in test_points]
        counts = np.array([len(l) for l in lists], dtype=np.int32)
        pad_to = bucketed_pad(counts.max() if counts.size else 1, bucket, pad_to)
        idx = np.zeros((len(lists), pad_to), dtype=np.int32)
        mask = np.zeros((len(lists), pad_to), dtype=bool)
        for t, l in enumerate(lists):
            idx[t, : len(l)] = l
            mask[t, : len(l)] = True
        for a in (idx, mask, counts):
            a.setflags(write=False)
        if len(test_points) == 1:
            self._padded_memo[key] = (idx, mask, counts)
            if len(self._padded_memo) > self._padded_memo_cap:
                self._padded_memo.popitem(last=False)
        return idx, mask, counts

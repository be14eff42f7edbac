"""In-memory explicit-rating dataset (numpy copy of
``fia_tpu/data/dataset.py``: the same arrays, shape protocol, host-side
minibatching with the same ``numpy.random.default_rng`` draws, mutation
helpers and module-level utilities).

Capability parity with the original FIA code's ``DataSet`` (epoch-shuffled
minibatching over a stable base array, mutation helpers): the host-side
object is numpy-backed for IO and mutation; batch *schedules* are whole-
epoch index permutations, so a training loop takes exact-shape batches
without host round trips.
"""

from __future__ import annotations

import numpy as np


class RatingDataset:
    """(user, item) -> rating triples.

    Attributes:
      x: int32 array (N, 2) of (user_id, item_id).
      y: float32 array (N,) of ratings.
    """

    def __init__(self, x: np.ndarray, y: np.ndarray):
        x = np.asarray(x)
        if x.ndim > 2:
            x = x.reshape(x.shape[0], -1)
        self.x = np.ascontiguousarray(x, dtype=np.int32)
        self.y = np.ascontiguousarray(np.asarray(y).reshape(-1), dtype=np.float32)
        if self.x.shape[0] != self.y.shape[0]:
            raise ValueError(
                f"x and y disagree on N: {self.x.shape[0]} vs {self.y.shape[0]}"
            )
        self._order = np.arange(self.num_examples)
        self._cursor = 0
        self._epochs_completed = 0
        self._rng = np.random.default_rng(0)

    # -- basic protocol ----------------------------------------------------
    @property
    def num_examples(self) -> int:
        return self.x.shape[0]

    @property
    def num_users(self) -> int:
        return int(self.x[:, 0].max()) + 1 if self.num_examples else 0

    @property
    def num_items(self) -> int:
        return int(self.x[:, 1].max()) + 1 if self.num_examples else 0

    # labels alias for parity with the reference DataSet API
    @property
    def labels(self) -> np.ndarray:
        return self.y

    def __len__(self) -> int:
        return self.num_examples

    def __repr__(self) -> str:
        return (
            f"RatingDataset(N={self.num_examples}, users={self.num_users}, "
            f"items={self.num_items})"
        )

    # -- host-side minibatching (reference dataset.py:44-70 semantics) -----
    def reset_batch(self, seed: int = 0) -> None:
        """Reset the epoch cursor and the shuffle stream."""
        self._cursor = 0
        self._epochs_completed = 0
        self._order = np.arange(self.num_examples)
        self._rng = np.random.default_rng(seed)

    def next_batch(self, batch_size: int) -> tuple[np.ndarray, np.ndarray]:
        """Sequential minibatch; reshuffles on epoch wrap and truncates a
        ragged tail (reference ``dataset.py:49-70``)."""
        if batch_size > self.num_examples:
            raise ValueError("batch_size larger than the dataset")
        if self._cursor + batch_size > self.num_examples:
            self._epochs_completed += 1
            self._rng.shuffle(self._order)
            self._cursor = 0
        sel = self._order[self._cursor : self._cursor + batch_size]
        self._cursor += batch_size
        return self.x[sel], self.y[sel]

    def epoch_schedule(self, batch_size: int, seed: int) -> np.ndarray:
        """A full epoch of batch indices, shape (num_batches, batch_size).

        The ragged tail is dropped, matching the reference's tail
        truncation. This is the host-side companion of the device trainer:
        the returned index matrix is walked on the device.
        """
        order = np.random.default_rng(seed).permutation(self.num_examples)
        nb = self.num_examples // batch_size
        return order[: nb * batch_size].reshape(nb, batch_size)

    # -- mutation helpers (reference dataset.py:35-47, 73-90) --------------
    def append_one_case(self, x_row: np.ndarray, y_val: float) -> None:
        self.x = np.concatenate(
            [self.x, np.asarray(x_row, dtype=np.int32).reshape(1, -1)], axis=0
        )
        self.y = np.concatenate(
            [self.y, np.asarray([y_val], dtype=np.float32)], axis=0
        )
        self.reset_batch()

    def without(self, indices) -> "RatingDataset":
        """A copy with the given row indices removed (leave-one-out)."""
        keep = np.ones(self.num_examples, dtype=bool)
        keep[np.asarray(indices)] = False
        return RatingDataset(self.x[keep], self.y[keep])

    def subset(self, indices) -> "RatingDataset":
        idx = np.asarray(indices)
        return RatingDataset(self.x[idx], self.y[idx])


# -- module-level utilities (reference dataset.py:73-103) -------------------
def filter_dataset(
    x: np.ndarray, y: np.ndarray, pos_class, neg_class
) -> tuple[np.ndarray, np.ndarray]:
    """Restrict (x, y) to two label classes and relabel them ±1.

    Capability parity with the reference's module-level ``filter_dataset``
    (``src/influence/dataset.py:73-90``): rows whose label is neither
    ``pos_class`` nor ``neg_class`` are dropped; surviving labels map to
    +1 (pos) / -1 (neg). Unused by the rating workload (ratings are
    regression targets) but part of the dataset module's public surface.
    """
    x = np.asarray(x)
    y = np.asarray(y).astype(int)
    if x.shape[0] != y.shape[0] or y.ndim != 1:
        raise ValueError("x and y must align on N and y must be 1-D")
    pos = y == pos_class
    neg = y == neg_class
    keep = pos | neg
    out_y = np.where(pos, 1, -1)[keep]
    return x[keep], out_y


def find_distances(
    target: np.ndarray, x: np.ndarray, theta: np.ndarray | None = None
) -> np.ndarray:
    """Per-row distance from ``target``: L2, or |projection onto theta|.

    Parity with the reference's ``find_distances``
    (``src/influence/dataset.py:93-105``).
    """
    x = np.asarray(x)
    if x.ndim != 2:
        raise ValueError(f"x must be 2-D, got ndim={x.ndim}")
    target = np.asarray(target).reshape(-1)
    if x.shape[1] != target.shape[0]:
        raise ValueError(
            f"feature dims differ: x has {x.shape[1]}, target {target.shape[0]}"
        )
    diff = x - target
    if theta is None:
        return np.linalg.norm(diff, axis=1)
    return np.abs(diff @ np.asarray(theta).reshape(-1))

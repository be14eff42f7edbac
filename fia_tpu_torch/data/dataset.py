"""In-memory explicit-rating dataset (numpy copy of
``fia_tpu/data/dataset.py``'s ``RatingDataset`` core: the arrays and
their shape protocol; the minibatch helpers come with the trainer)."""

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

    @property
    def num_examples(self) -> int:
        return self.x.shape[0]

    def __len__(self) -> int:
        return self.num_examples

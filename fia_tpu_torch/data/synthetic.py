"""Synthetic explicit-rating generators (numpy copy of the parts of
``fia_tpu/data/synthetic.py`` the flat query path needs; the arrays are
byte-equal to the reference's for the same seed).

Ratings are sampled from a planted low-rank MF model plus noise,
quantised to the 1-5 star scale; users and items follow Zipf-ish
popularity marginals, so related-set sizes carry real-data skew.
"""

from __future__ import annotations

import numpy as np

from fia_tpu_torch.data.dataset import RatingDataset


def synthesize_ratings(
    num_users: int,
    num_items: int,
    num_rows: int,
    seed: int = 0,
    rank: int = 8,
    noise: float = 0.4,
    ensure_cover: np.ndarray | None = None,
) -> RatingDataset:
    """Sample ``num_rows`` (user, item, rating) triples.

    ``ensure_cover`` is an optional (M, 2) array of (u, i) pairs each of
    whose users and items is guaranteed at least one training row.
    """
    rng = np.random.default_rng(seed)

    def _zipf_choice(n, size):
        w = 1.0 / np.arange(1, n + 1) ** 0.8
        w /= w.sum()
        perm = rng.permutation(n)  # decouple popularity from id order
        return perm[rng.choice(n, size=size, p=w)]

    users = _zipf_choice(num_users, num_rows)
    items = _zipf_choice(num_items, num_rows)

    if ensure_cover is not None and len(ensure_cover):
        cover = np.asarray(ensure_cover)
        cu = np.unique(cover[:, 0])
        ci = np.unique(cover[:, 1])
        need = len(cu) + len(ci)
        if need > num_rows:
            raise ValueError("num_rows too small to cover the given pairs")
        users[: len(cu)] = cu
        items[: len(cu)] = rng.integers(0, num_items, size=len(cu))
        users[len(cu) : need] = rng.integers(0, num_users, size=len(ci))
        items[len(cu) : need] = ci

    ratings = _planted_ratings(users, items, num_users, num_items, rng,
                               rank=rank, noise=noise)

    x = np.stack([users, items], axis=1).astype(np.int32)
    return RatingDataset(x, ratings)


def _planted_ratings(users, items, num_users, num_items, rng,
                     rank: int = 8, noise: float = 0.4) -> np.ndarray:
    """Ratings from a planted MF model (r = clip(round(mu + b_u + b_i +
    p_u.q_i + eps), 1, 5))."""
    num_rows = len(users)
    p = rng.normal(0, 1.0 / np.sqrt(rank), size=(num_users, rank))
    q = rng.normal(0, 1.0 / np.sqrt(rank), size=(num_items, rank))
    bu = rng.normal(0, 0.3, size=num_users)
    bi = rng.normal(0, 0.3, size=num_items)
    scores = (
        3.5
        + bu[users]
        + bi[items]
        + np.einsum("nk,nk->n", p[users], q[items])
        + rng.normal(0, noise, size=num_rows)
    )
    return np.clip(np.rint(scores), 1.0, 5.0).astype(np.float32)


def sample_heldout_pairs(
    train_x: np.ndarray,
    num_users: int,
    num_items: int,
    n: int,
    seed: int = 17,
) -> np.ndarray:
    """Sample ``n`` distinct (u, i) pairs absent from the training set —
    the benchmark query protocol (test pairs disjoint from train).
    Membership is tested against packed ``u * num_items + i`` codes."""
    rng = np.random.default_rng(seed)
    codes = np.sort(
        np.asarray(train_x[:, 0], np.int64) * num_items
        + np.asarray(train_x[:, 1], np.int64)
    )
    picked: set[int] = set()
    pts: list[tuple[int, int]] = []
    while len(pts) < n:
        u, i = int(rng.integers(0, num_users)), int(rng.integers(0, num_items))
        c = u * num_items + i
        if c in picked:
            continue
        j = np.searchsorted(codes, c)
        if j == len(codes) or codes[j] != c:
            picked.add(c)
            pts.append((u, i))
    return np.asarray(pts, dtype=np.int32)


def synthetic_splits(
    num_users: int,
    num_items: int,
    num_train: int,
    num_test: int,
    seed: int = 0,
    **kw,
) -> dict[str, RatingDataset]:
    """Train/validation/test splits from one planted model, with the
    valid/test pairs disjoint from the training pairs."""
    margin = 4
    while True:
        full = synthesize_ratings(
            num_users, num_items, num_train + margin * num_test, seed=seed, **kw
        )
        train_x, train_y = full.x[:num_train], full.y[:num_train]
        codes = np.sort(
            np.asarray(train_x[:, 0], np.int64) * num_items
            + np.asarray(train_x[:, 1], np.int64)
        )
        rest_x, rest_y = full.x[num_train:], full.y[num_train:]
        rc = np.asarray(rest_x[:, 0], np.int64) * num_items + np.asarray(
            rest_x[:, 1], np.int64
        )
        if codes.size:
            j = np.clip(np.searchsorted(codes, rc), 0, len(codes) - 1)
            heldout = codes[j] != rc
        else:
            heldout = np.ones(len(rc), bool)
        if heldout.sum() >= 2 * num_test:
            rest_x, rest_y = rest_x[heldout], rest_y[heldout]
            break
        margin *= 2  # extremely dense configs: draw more candidates

    train = RatingDataset(train_x, train_y)
    valid = RatingDataset(rest_x[:num_test], rest_y[:num_test])
    test = RatingDataset(
        rest_x[num_test : 2 * num_test], rest_y[num_test : 2 * num_test]
    )
    return {"train": train, "validation": valid, "test": test}

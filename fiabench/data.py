"""Ratings and query traffic, made from seeds.

``synthesize_ratings`` is a frozen copy of the program's generator
(``fia_tpu_torch/data/synthetic.py``), kept here so that a change to the
program cannot change what the benchmark feeds it. ``job_pool`` is the one general traffic generator: it reads a
traffic file's parameters and draws its pool of jobs, vectorised, from
the file's own seed, so that every run holds the same jobs; ``JobOrder``
hands them to the window in an order drawn from the run's seed.
"""

from __future__ import annotations

import numpy as np


def synthesize_ratings(num_users: int, num_items: int, num_rows: int,
                       seed: int = 0, rank: int = 8, noise: float = 0.4):
    """``(x, y)``: ``num_rows`` (user, item) int32 pairs with Zipf-ish
    popularity marginals and float32 1-5 star ratings from a planted
    rank-``rank`` MF model plus noise."""
    rng = np.random.default_rng(seed)

    def zipf_choice(n, size):
        w = 1.0 / np.arange(1, n + 1) ** 0.8
        w /= w.sum()
        perm = rng.permutation(n)  # decouple popularity from id order
        return perm[rng.choice(n, size=size, p=w)]

    users = zipf_choice(num_users, num_rows)
    items = zipf_choice(num_items, num_rows)
    p = rng.normal(0, 1.0 / np.sqrt(rank), size=(num_users, rank))
    q = rng.normal(0, 1.0 / np.sqrt(rank), size=(num_items, rank))
    bu = rng.normal(0, 0.3, size=num_users)
    bi = rng.normal(0, 0.3, size=num_items)
    scores = (3.5 + bu[users] + bi[items]
              + np.einsum("nk,nk->n", p[users], q[items])
              + rng.normal(0, noise, size=num_rows))
    y = np.clip(np.rint(scores), 1.0, 5.0).astype(np.float32)
    x = np.stack([users, items], axis=1).astype(np.int32)
    return x, y


class Ratings:
    """The training rows of one configuration and what the traffic and
    the roofline arithmetic read of them: each user's and item's degree
    and the sorted pair codes. Built by the benchmark, not the program."""

    def __init__(self, x: np.ndarray, y: np.ndarray, num_users: int,
                 num_items: int):
        self.x, self.y = x, y
        self.num_users, self.num_items = int(num_users), int(num_items)
        self.user_deg = np.bincount(x[:, 0], minlength=num_users)
        self.item_deg = np.bincount(x[:, 1], minlength=num_items)
        self.codes = np.sort(self.code(x[:, 0], x[:, 1]))

    def code(self, u, i) -> np.ndarray:
        return (np.asarray(u, np.int64) * self.num_items
                + np.asarray(i, np.int64))

    def pair_rows(self, u, i) -> np.ndarray:
        """How many training rows equal each pair (u, i)."""
        c = self.code(u, i)
        return (np.searchsorted(self.codes, c, side="right")
                - np.searchsorted(self.codes, c, side="left"))


def load_ratings(cfg: dict) -> Ratings:
    """The configuration's training rows: its counts, its data seed."""
    U, I = cfg["num_users"], cfg["num_items"]
    x, y = synthesize_ratings(U, I, cfg["num_rows"], seed=cfg["data_seed"])
    return Ratings(x, y, U, I)


#: how a traffic file's ``item`` draws each pair's item
ITEM_DRAWS = ("uniform", "train_degree")


def job_pool(ratings: Ratings, traffic: dict) -> list:
    """``traffic["pool_jobs"]`` jobs, each ``traffic["job_queries"]``
    distinct (user, item) pairs as an int32 (Q, 2) array, drawn from
    ``traffic["pool_seed"]``. Users are uniform; items uniform or in
    proportion to their training degree (``traffic["item"]``); with
    ``traffic["heldout"]`` a pair already in the training set is left
    out. Each job takes the first usable pairs of its own row of draws,
    all drawn at once."""
    if traffic["item"] not in ITEM_DRAWS:
        raise ValueError(f"unknown item draw {traffic['item']!r}")
    rng = np.random.default_rng([int(traffic["pool_seed"]), 0x6a6f6273])
    n_jobs, q = int(traffic["pool_jobs"]), int(traffic["job_queries"])
    U, I = ratings.num_users, ratings.num_items
    p_item = None
    if traffic["item"] == "train_degree":
        p_item = ratings.item_deg / ratings.item_deg.sum()

    def draw(rows: int, cols: int) -> np.ndarray:
        u = rng.integers(0, U, size=(rows, cols))
        i = (rng.integers(0, I, size=(rows, cols)) if p_item is None
             else rng.choice(I, size=(rows, cols), p=p_item))
        return ratings.code(u, i)

    def usable(codes: np.ndarray) -> np.ndarray:
        """First occurrences in each row, not in the training set where
        the traffic asks for held-out pairs."""
        srt = np.sort(codes, axis=1)
        rows = np.flatnonzero((srt[:, 1:] == srt[:, :-1]).any(axis=1))
        ok = np.ones(codes.shape, bool)
        if rows.size:  # mark every occurrence after the first
            sub = codes[rows]
            order = np.argsort(sub, axis=1, kind="stable")
            srt = np.take_along_axis(sub, order, axis=1)
            later = np.zeros(sub.shape, bool)
            later[:, 1:] = srt[:, 1:] == srt[:, :-1]
            dup = np.zeros(sub.shape, bool)
            np.put_along_axis(dup, order, later, axis=1)
            ok[rows] = ~dup
        if traffic["heldout"]:
            ok &= ratings.pair_rows(codes // I, codes % I) == 0
        return ok

    cols = q + q // 4 + 64
    jobs = np.empty((n_jobs, q), np.int64)
    todo = np.arange(n_jobs)
    while todo.size:
        codes = draw(todo.size, cols)
        ok = usable(codes)
        full = ok.sum(axis=1) >= q
        first = np.argsort(~ok, axis=1, kind="stable")[:, :q]
        jobs[todo[full]] = np.take_along_axis(codes, first, axis=1)[full]
        todo = todo[~full]
        cols *= 2
    pairs = np.stack([jobs // I, jobs % I], axis=2).astype(np.int32)
    return list(pairs)


class JobOrder:
    """Which pool job the window's ``j``-th job is: the pool over and over,
    each pass in its own order drawn from the run's seed. Every seed so
    runs the same jobs, and so the same sizes and geometries, in another
    order."""

    def __init__(self, n_pool: int, seed: int):
        self.n, self.seed = int(n_pool), int(seed)
        self._pass, self._perm = -1, None

    def __getitem__(self, j: int) -> int:
        p, k = divmod(int(j), self.n)
        if p != self._pass:
            rng = np.random.default_rng([self.seed, 0x6f72, p])
            self._pass, self._perm = p, rng.permutation(self.n)
        return int(self._perm[k])

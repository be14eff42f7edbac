"""The frozen generators reproduce the program's and the sizing the
benchmark's cells were chosen by; the job stream is seeded and keeps to
its traffic file."""

import numpy as np
import pytest

from fiabench import data


def sample_heldout_pairs(train_x: np.ndarray, num_users: int,
                         num_items: int, n: int, seed: int = 17):
    """A frozen copy of the program's ``sample_heldout_pairs``: ``n``
    distinct (u, i) pairs absent from the training set, drawn one at a
    time. The benchmark's traffic does not use it; the sizing the cells
    were chosen by does."""
    rng = np.random.default_rng(seed)
    codes = np.sort(np.asarray(train_x[:, 0], np.int64) * num_items
                    + np.asarray(train_x[:, 1], np.int64))
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


def related_counts(r: data.Ratings, pairs: np.ndarray) -> np.ndarray:
    """Rows sharing the user plus rows sharing the item, a pair."""
    return r.user_deg[pairs[:, 0]] + r.item_deg[pairs[:, 1]]


@pytest.fixture(scope="module")
def ml1m():
    x, y = data.synthesize_ratings(6040, 3706, 975460, seed=0)
    return data.Ratings(x, y, 6040, 3706)


def test_frozen_copies_match_the_program():
    from fia_tpu_torch.data import synthetic

    ds = synthetic.synthesize_ratings(50, 30, 900, seed=5)
    x, y = data.synthesize_ratings(50, 30, 900, seed=5)
    assert np.array_equal(ds.x, x) and np.array_equal(ds.y, y)
    assert np.array_equal(
        synthetic.sample_heldout_pairs(x, 50, 30, 40, seed=3),
        sample_heldout_pairs(x, 50, 30, 40, seed=3))


def test_ml1m_sizing(ml1m):
    assert ml1m.user_deg.max() == 40362 and ml1m.item_deg.max() == 45542
    pairs = sample_heldout_pairs(ml1m.x, 6040, 3706, 1024, seed=17)
    assert int(related_counts(ml1m, pairs).sum()) == 348499


def test_pair_rows_counts_each_pairs_training_rows(ml1m):
    rng = np.random.default_rng(0)
    u, i = rng.integers(0, 6040, 5000), rng.integers(0, 3706, 5000)
    u[:100], i[:100] = ml1m.x[:100, 0], ml1m.x[:100, 1]
    got = ml1m.pair_rows(u, i)
    x = ml1m.x.astype(np.int64)
    want = [int(((x[:, 0] == a) & (x[:, 1] == b)).sum())
            for a, b in zip(u[:200], i[:200])]
    assert got[:200].tolist() == want and (got[:100] >= 1).all()
    codes, n = np.unique(ml1m.codes, return_counts=True)
    assert np.array_equal(
        ml1m.pair_rows(codes // 3706, codes % 3706), n)


@pytest.mark.parametrize("name", ["uniform4k", "popular2k"])
def test_job_pool(ml1m, spec, name):
    tr = dict(spec.traffic(name), pool_jobs=6)
    a = data.job_pool(ml1m, tr)
    b = data.job_pool(ml1m, tr)
    c = data.job_pool(ml1m, dict(tr, pool_seed=tr["pool_seed"] + 1))
    assert len(a) == 6 and all(np.array_equal(p, q) for p, q in zip(a, b))
    assert not np.array_equal(a[0], c[0])
    for job in a:
        assert job.shape == (tr["job_queries"], 2) and job.dtype == np.int32
        assert len(np.unique(ml1m.code(job[:, 0], job[:, 1]))) == len(job)
        held = ml1m.pair_rows(job[:, 0], job[:, 1]) == 0
        assert held.all() if tr["heldout"] else not held.all()


def test_popular_items_follow_training_degree(ml1m, spec):
    jobs = data.job_pool(ml1m, dict(spec.traffic("popular2k"), pool_jobs=4))
    uniform = data.job_pool(ml1m, dict(spec.traffic("uniform4k"),
                                       pool_jobs=2))
    per_query = [related_counts(ml1m, np.concatenate(j)).mean()
                 for j in (jobs, uniform)]
    # ~13x the rows a query: the row layers' regime
    assert per_query[0] / per_query[1] > 8


def test_job_order_runs_the_pool_in_seeded_passes():
    a, b, c = (data.JobOrder(5, s) for s in (2 ** 31 + 1, 2 ** 31 + 1, 9))
    first = [a[j] for j in range(15)]
    assert first == [b[j] for j in range(15)]
    assert first != [c[j] for j in range(15)]
    for p in range(3):  # every pass holds each job once
        assert sorted(first[5 * p: 5 * p + 5]) == list(range(5))

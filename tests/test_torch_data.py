"""The port's data layer against the reference's: the same seeds give
byte-equal arrays (values, dtypes and shapes)."""

import numpy as np
import pytest
import torch

from fia_tpu.data import index as ref_index
from fia_tpu.data import synthetic as ref_syn
from fia_tpu_torch.data import index as port_index
from fia_tpu_torch.data import synthetic as port_syn

torch.set_num_threads(2)


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("seed", [0, 5])
def test_synthesize_ratings(seed):
    ref = ref_syn.synthesize_ratings(50, 30, 1500, seed=seed)
    got = port_syn.synthesize_ratings(50, 30, 1500, seed=seed)
    _same(got.x, ref.x)
    _same(got.y, ref.y)


def test_synthesize_ratings_ensure_cover():
    cover = np.asarray([[1, 2], [7, 29], [49, 0]])
    ref = ref_syn.synthesize_ratings(50, 30, 800, seed=2, ensure_cover=cover)
    got = port_syn.synthesize_ratings(50, 30, 800, seed=2, ensure_cover=cover)
    _same(got.x, ref.x)
    _same(got.y, ref.y)


def test_synthetic_splits():
    ref = ref_syn.synthetic_splits(60, 40, 2000, 50, seed=3)
    got = port_syn.synthetic_splits(60, 40, 2000, 50, seed=3)
    assert set(got) == set(ref)
    for name in ref:
        _same(got[name].x, ref[name].x)
        _same(got[name].y, ref[name].y)


@pytest.mark.parametrize("n,seed", [(50, 17), (300, 4)])
def test_sample_heldout_pairs(n, seed):
    train = ref_syn.synthesize_ratings(60, 40, 2000, seed=1)
    ref = ref_syn.sample_heldout_pairs(train.x, 60, 40, n, seed=seed)
    got = port_syn.sample_heldout_pairs(train.x, 60, 40, n, seed=seed)
    _same(got, ref)


@pytest.fixture(scope="module")
def indexes():
    train = ref_syn.synthesize_ratings(60, 40, 2000, seed=3)
    # one unseen user and item: the count-0 query
    return (ref_index.InteractionIndex(train.x, 61, 41),
            port_index.InteractionIndex(train.x, 61, 41))


def test_postings(indexes):
    ref, got = indexes
    for a, b in zip(got.postings(), ref.postings()):
        _same(a, b)


def test_counts_batch_and_related(indexes):
    ref, got = indexes
    rng = np.random.default_rng(0)
    pts = np.stack([rng.integers(0, 61, 40), rng.integers(0, 41, 40)], axis=1)
    pts = np.concatenate([pts, [[60, 40]]])
    _same(got.counts_batch(pts), ref.counts_batch(pts))
    assert got.counts_batch(pts)[-1] == 0
    for u, i in pts:
        _same(got.related(u, i), ref.related(u, i))


@pytest.mark.parametrize("pad_to", [None, 512])
def test_related_padded(indexes, pad_to):
    ref, got = indexes
    pts = np.asarray([[0, 0], [5, 7], [60, 40]])
    for a, b in zip(got.related_padded(pts, pad_to=pad_to),
                    ref.related_padded(pts, pad_to=pad_to)):
        _same(a, b)


@pytest.mark.parametrize("m,bucket,pad_to", [
    (0, 64, None), (1, 64, None), (64, 64, None), (65, 64, None),
    (1500, 64, None), (434_321, 2048, None), (2047, 2048, None),
    (100, 128, 256),
])
def test_bucketed_pad(m, bucket, pad_to):
    assert (port_index.bucketed_pad(m, bucket, pad_to)
            == ref_index.bucketed_pad(m, bucket, pad_to))


def test_bucketed_pad_rejects_short_pad_to():
    with pytest.raises(ValueError):
        port_index.bucketed_pad(300, 128, 256)


def test_degree_methods(indexes):
    """related_count, user_degrees, item_degrees, max_related_count."""
    ref, got = indexes
    _same(got.user_degrees(), ref.user_degrees())
    _same(got.item_degrees(), ref.item_degrees())
    assert got.max_related_count() == ref.max_related_count()
    assert got.max_related_count() == int(got.user_degrees().max()
                                          + got.item_degrees().max())
    for u, i in ((0, 0), (5, 7), (60, 40), (59, 3)):
        assert got.related_count(u, i) == ref.related_count(u, i)
        assert got.related_count(u, i) == len(got.related(u, i))
    empty = port_index.InteractionIndex(np.zeros((0, 2), np.int32), 3, 2)
    assert empty.max_related_count() == 0

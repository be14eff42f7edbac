"""The port's data layer against the reference's: the same seeds give
byte-equal arrays (values, dtypes and shapes)."""

import numpy as np
import pytest
import torch

from fia_tpu.data import index as ref_index
from fia_tpu.data import loaders as ref_loaders
from fia_tpu.data import synthetic as ref_syn
from fia_tpu_torch.data import index as port_index
from fia_tpu_torch.data import loaders as port_loaders
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


# -- the calibrated stream, the scale tiers and the TSV loaders -------------
def _same_splits(got, ref):
    assert set(got) == set(ref)
    for name in ref:
        _same(got[name].x, ref[name].x)
        _same(got[name].y, ref[name].y)
        assert getattr(got[name], "synth_tag", "") == getattr(
            ref[name], "synth_tag", "")


@pytest.mark.parametrize("seed", [0, 3])
def test_calibrated_splits(seed):
    _same_splits(port_syn.calibrated_splits(80, 50, 3000, 40, seed=seed),
                 ref_syn.calibrated_splits(80, 50, 3000, 40, seed=seed))


@pytest.mark.parametrize("head_fit", [False, True])
def test_synthesize_calibrated_with_heldout(head_fit):
    """The cal2 and cal3 streams, fit to a heldout split: every heldout
    item covered, pairs unique and disjoint from it, arrays byte-equal."""
    held = ref_syn.synthesize_ratings(100, 80, 400, seed=9).x
    kw = dict(heldout_x=held, seed=4, min_degree=8, head_fit=head_fit)
    got = port_syn.synthesize_calibrated(100, 80, 2000, **kw)
    ref = ref_syn.synthesize_calibrated(100, 80, 2000, **kw)
    _same(got.x, ref.x)
    _same(got.y, ref.y)


def test_synthesize_scale_and_tiers():
    assert port_syn.SCALE_TIERS == ref_syn.SCALE_TIERS
    got = port_syn.synthesize_scale(5000, 800, 20_000, seed=2)
    ref = ref_syn.synthesize_scale(5000, 800, 20_000, seed=2)
    _same(got.x, ref.x)
    _same(got.y, ref.y)


def _write_split(ds, path):
    ref_loaders.save_tsv(ds, str(path))


@pytest.mark.parametrize("name", ["movielens", "yelp"])
@pytest.mark.parametrize("with_train", [True, False])
def test_load_dataset_over_tsv_files(tmp_path, monkeypatch, name, with_train):
    """Rating files the test writes itself (the real ones are not in the
    repository), with the train file present or synthesized; the dataset
    specs are shrunk to the files' scale on both sides alike."""
    spec = dict(prefix="t", n_train=900, n_valid=60, n_test=60,
                num_users=50, num_items=40)
    monkeypatch.setitem(ref_loaders._SPECS, name, spec)
    monkeypatch.setitem(port_loaders._SPECS, name, spec)
    full = ref_syn.synthesize_ratings(50, 40, 1100, seed=6)
    parts = {"train": (0, 950), "valid": (950, 1020), "test": (1020, 1100)}
    for short, (lo, hi) in parts.items():
        if short == "train" and not with_train:
            continue
        _write_split(ref_syn.RatingDataset(full.x[lo:hi], full.y[lo:hi]),
                     tmp_path / f"t.{short}.rating")
    for cal in ({"calibrate": False}, {"calibrate": True, "cal_rev": "cal3"}):
        got = port_loaders.load_dataset(name, str(tmp_path), synth_seed=1, **cal)
        ref = ref_loaders.load_dataset(name, str(tmp_path), synth_seed=1, **cal)
        _same_splits(got, ref)
        assert got["validation"].num_examples == 60  # the spec's slice
        if with_train:
            assert got["train"].num_examples == 900
            break
    if not with_train:
        with pytest.raises(FileNotFoundError):
            port_loaders.load_dataset(name, str(tmp_path),
                                      synthesize_train=False)
    with pytest.raises(ValueError, match="unknown dataset"):
        port_loaders.load_dataset("netflix", str(tmp_path))


def test_save_tsv_writes_the_references_bytes(tmp_path):
    ds = ref_syn.synthesize_ratings(30, 20, 200, seed=1)
    port_loaders.save_tsv(port_syn.RatingDataset(ds.x, ds.y),
                          str(tmp_path / "a.rating"))
    ref_loaders.save_tsv(ds, str(tmp_path / "b.rating"))
    assert (tmp_path / "a.rating").read_bytes() == (
        tmp_path / "b.rating").read_bytes()
    got = port_loaders.parse_tsv(str(tmp_path / "a.rating"), max_rows=150)
    _same(got[0], ds.x[:150, 0])
    _same(got[1], ds.x[:150, 1])
    _same(got[2], ds.y[:150])

"""The port's dataset (``fia_tpu_torch/data/dataset.py``) and event log
(``fia_tpu_torch/utils/logging.py``) on the CPU.

Restates ``tests/test_dataset.py`` (all twenty: ``TestRatingDataset``,
``TestModuleUtils``, ``TestInteractionIndex``, ``TestSynthetic``) and
``tests/test_aux.py::TestEventLog`` (all three) port against port. Against
the reference, on the same numpy inputs: the minibatch draws
(``next_batch`` across epoch wraps, ``epoch_schedule``) are the same bytes
for the same seed, and the mutation helpers, ``filter_dataset``,
``find_distances``, ``num_users`` / ``num_items`` and ``__repr__`` give
the reference's values.
"""

import numpy as np
import pytest
import torch

from fia_tpu.data import dataset as ref_dataset
from fia_tpu_torch.data.dataset import (
    RatingDataset,
    filter_dataset,
    find_distances,
)
from fia_tpu_torch.data.index import InteractionIndex
from fia_tpu_torch.data.synthetic import synthesize_ratings
from fia_tpu_torch.utils.logging import EventLog, read_events

torch.set_num_threads(2)


def _xy(n=100, users=10, items=8, seed=0):
    rng = np.random.default_rng(seed)
    x = np.stack(
        [rng.integers(0, users, n), rng.integers(0, items, n)], axis=1
    ).astype(np.int32)
    y = rng.integers(1, 6, n).astype(np.float32)
    return x, y


def _ds(n=100, users=10, items=8, seed=0):
    return RatingDataset(*_xy(n, users, items, seed))


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


class TestRatingDataset:
    def test_shapes_and_casts(self):
        ds = _ds()
        assert ds.x.dtype == np.int32 and ds.y.dtype == np.float32
        assert ds.num_examples == 100

    def test_next_batch_covers_epoch(self):
        ds = _ds(n=90)
        seen = []
        for _ in range(9):
            bx, _ = ds.next_batch(10)
            seen.append(bx)
        # first epoch is unshuffled: concatenation equals the base array
        assert np.array_equal(np.concatenate(seen), ds.x)

    def test_next_batch_reshuffles_on_wrap(self):
        ds = _ds(n=90)
        for _ in range(9):
            ds.next_batch(10)
        bx, _ = ds.next_batch(10)
        assert bx.shape == (10, 2)

    def test_tail_truncation(self):
        # batch that doesn't divide N: wrap happens early, tail dropped
        ds = _ds(n=95)
        for _ in range(20):
            bx, by = ds.next_batch(10)
            assert bx.shape == (10, 2) and by.shape == (10,)

    def test_epoch_schedule_exact(self):
        ds = _ds(n=95)
        sched = ds.epoch_schedule(10, seed=1)
        assert sched.shape == (9, 10)
        assert len(np.unique(sched)) == 90

    def test_append_and_without(self):
        ds = _ds(n=20)
        ds.append_one_case(np.array([3, 4]), 5.0)
        assert ds.num_examples == 21
        assert ds.x[-1].tolist() == [3, 4]
        ds2 = ds.without([0, 1])
        assert ds2.num_examples == 19

    def test_mismatched_lengths_raise(self):
        with pytest.raises(ValueError):
            RatingDataset(np.zeros((3, 2)), np.zeros(4))


class TestModuleUtils:
    """Parity with the reference's module-level dataset utilities."""

    def test_filter_dataset_relabels_and_drops(self):
        x = np.arange(12).reshape(6, 2)
        y = np.array([0, 1, 2, 1, 0, 3])
        fx, fy = filter_dataset(x, y, pos_class=1, neg_class=0)
        np.testing.assert_array_equal(fx, x[[0, 1, 3, 4]])
        np.testing.assert_array_equal(fy, [-1, 1, 1, -1])

    def test_filter_dataset_validates(self):
        with pytest.raises(ValueError):
            filter_dataset(np.zeros((3, 2)), np.zeros(4), 1, 0)

    def test_find_distances_l2(self):
        x = np.array([[0.0, 0.0], [3.0, 4.0]])
        d = find_distances(np.array([0.0, 0.0]), x)
        np.testing.assert_allclose(d, [0.0, 5.0])

    def test_find_distances_projection(self):
        x = np.array([[1.0, 1.0], [2.0, -1.0]])
        target = np.array([0.0, 0.0])
        theta = np.array([1.0, 0.0])
        np.testing.assert_allclose(find_distances(target, x, theta),
                                   [1.0, 2.0])

    def test_find_distances_validates(self):
        with pytest.raises(ValueError):
            find_distances(np.zeros(3), np.zeros((2, 2)))
        with pytest.raises(ValueError):
            find_distances(np.zeros(2), np.zeros((2, 2, 2)))


class TestInteractionIndex:
    def test_related_matches_bruteforce(self):
        ds = _ds(n=300, users=12, items=9, seed=2)
        idx = InteractionIndex(ds.x)
        for u, i in [(0, 0), (3, 5), (11, 8)]:
            got = np.sort(idx.related(u, i))
            want = np.sort(np.concatenate([np.where(ds.x[:, 0] == u)[0],
                                           np.where(ds.x[:, 1] == i)[0]]))
            assert np.array_equal(got, want)

    def test_duplicate_row_kept(self):
        # a row matching user AND item appears twice (reference semantics)
        x = np.array([[1, 1], [1, 2], [2, 1]], dtype=np.int32)
        idx = InteractionIndex(x, num_users=3, num_items=3)
        rel = idx.related(1, 1)
        assert (rel == 0).sum() == 2

    def test_counts_batch_and_ceiling(self):
        ds = _ds(n=300, users=12, items=9, seed=2)
        idx = InteractionIndex(ds.x)
        pts = np.array([[0, 0], [3, 5], [11, 8]])
        got = idx.counts_batch(pts)
        want = [idx.related_count(u, i) for u, i in pts]
        assert np.array_equal(got, want)
        ceiling = idx.max_related_count()
        all_pts = np.array([[u, i] for u in range(12) for i in range(9)])
        assert ceiling >= idx.counts_batch(all_pts).max()

    def test_postings_roundtrip(self):
        ds = _ds(n=300, users=12, items=9, seed=2)
        idx = InteractionIndex(ds.x)
        uoff, urows, ioff, irows = idx.postings()
        # the device gather layout (user rows then item rows) must
        # reproduce related() exactly for every pair
        for u, i in [(0, 0), (3, 5), (11, 8)]:
            rebuilt = np.concatenate(
                [urows[uoff[u]:uoff[u + 1]], irows[ioff[i]:ioff[i + 1]]])
            assert np.array_equal(rebuilt, idx.related(u, i))

    def test_bucketed_pad(self):
        from fia_tpu_torch.data.index import bucketed_pad

        # explicit pad_to: validated passthrough
        assert bucketed_pad(10, 16, pad_to=64) == 64
        with pytest.raises(ValueError):
            bucketed_pad(100, 16, pad_to=64)
        for bucket in (16, 128, 512):
            pads = {bucketed_pad(m, bucket) for m in range(1, 100_000)}
            for m in range(1, 100_000, 977):
                p = bucketed_pad(m, bucket)
                assert p >= m and p % bucket == 0
                assert p <= max(bucket, int(m * 1.125) + bucket)
            # the geometric granule keeps the number of distinct pads
            # (program-cache entries) logarithmic in the count range
            assert len(pads) < 120

    def test_related_padded(self):
        ds = _ds(n=300, users=12, items=9, seed=2)
        idx = InteractionIndex(ds.x)
        pts = np.array([[0, 0], [3, 5]])
        ridx, mask, counts = idx.related_padded(pts, bucket=16)
        assert ridx.shape == mask.shape
        assert ridx.shape[1] % 16 == 0
        for t, (u, i) in enumerate(pts):
            assert counts[t] == idx.related_count(u, i)
            assert np.array_equal(ridx[t, : counts[t]], idx.related(u, i))
            assert mask[t, : counts[t]].all() and not mask[t, counts[t]:].any()


class TestSynthetic:
    def test_cover(self):
        cover = np.array([[7, 3], [9, 1]])
        ds = synthesize_ratings(10, 5, 200, seed=0, ensure_cover=cover)
        assert ds.num_examples == 200
        assert (ds.y >= 1).all() and (ds.y <= 5).all()
        for u in cover[:, 0]:
            assert (ds.x[:, 0] == u).any()
        for i in cover[:, 1]:
            assert (ds.x[:, 1] == i).any()

    def test_deterministic(self):
        a = synthesize_ratings(10, 5, 100, seed=4)
        b = synthesize_ratings(10, 5, 100, seed=4)
        assert np.array_equal(a.x, b.x) and np.array_equal(a.y, b.y)


class TestAgainstReference:
    """The same numpy inputs through both packages' datasets."""

    @pytest.mark.parametrize("n,batch,seed", [(90, 10, 0), (95, 10, 3),
                                              (37, 8, 11)])
    def test_next_batch_draws_equal_reference_bytes(self, n, batch, seed):
        x, y = _xy(n=n)
        port, ref = RatingDataset(x, y), ref_dataset.RatingDataset(x, y)
        port.reset_batch(seed)
        ref.reset_batch(seed)
        # four epochs: every wrap reshuffles from the seeded stream
        for _ in range(4 * (n // batch) + 3):
            for a, b in zip(port.next_batch(batch), ref.next_batch(batch)):
                _same(a, b)

    @pytest.mark.parametrize("seed", [0, 1, 7])
    def test_epoch_schedule_equals_reference_bytes(self, seed):
        x, y = _xy(n=95)
        _same(RatingDataset(x, y).epoch_schedule(10, seed),
              ref_dataset.RatingDataset(x, y).epoch_schedule(10, seed))

    def test_surface_equals_reference(self):
        """ROADMAP C.6's example and the mutation helpers."""
        port = RatingDataset([[0, 1], [2, 0]], [1.0, 2.0])
        ref = ref_dataset.RatingDataset([[0, 1], [2, 0]], [1.0, 2.0])
        assert (port.num_users, port.num_items) == (3, 2)
        assert (port.num_users, port.num_items, repr(port)) == (
            ref.num_users, ref.num_items, repr(ref))
        _same(port.labels, ref.labels)
        empty = RatingDataset(np.zeros((0, 2)), np.zeros(0))
        assert (empty.num_users, empty.num_items) == (0, 0)
        x, y = _xy(n=30)
        port, ref = RatingDataset(x, y), ref_dataset.RatingDataset(x, y)
        for ds in (port, ref):
            ds.next_batch(7)
            ds.append_one_case(np.array([9, 7]), 4.0)
        _same(port.x, ref.x)
        _same(port.y, ref.y)
        for a, b in zip(port.next_batch(7), ref.next_batch(7)):
            _same(a, b)  # append resets the cursor in both
        for got, want in ((port.without([0, 5, 29]), ref.without([0, 5, 29])),
                          (port.subset([3, 1, 3]), ref.subset([3, 1, 3]))):
            _same(got.x, want.x)
            _same(got.y, want.y)

    def test_module_utils_equal_reference(self):
        rng = np.random.default_rng(5)
        x = rng.normal(size=(40, 3))
        y = rng.integers(0, 4, 40)
        for a, b in zip(filter_dataset(x, y, 2, 0),
                        ref_dataset.filter_dataset(x, y, 2, 0)):
            _same(a, b)
        target, theta = rng.normal(size=3), rng.normal(size=3)
        _same(find_distances(target, x), ref_dataset.find_distances(target, x))
        _same(find_distances(target, x, theta),
              ref_dataset.find_distances(target, x, theta))


class TestEventLog:
    def test_roundtrip(self, tmp_path):
        p = str(tmp_path / "log" / "events.jsonl")
        with EventLog(p) as log:
            log.log("train_epoch", epoch=1, loss=0.5)
            log.log("query", n=4)
        ev = read_events(p)
        assert [e["event"] for e in ev] == ["train_epoch", "query"]
        assert ev[0]["loss"] == 0.5

    def test_disabled_is_noop(self):
        log = EventLog(None)
        log.log("x", a=1)  # must not raise
        log.close()

    def test_trainer_emits_events(self, tiny_splits, tmp_path):
        from fia_tpu_torch.models import MF
        from fia_tpu_torch.train.trainer import Trainer, TrainConfig

        train = tiny_splits["train"]
        model = MF(train.num_users, train.num_items, 4, 1e-3)
        params = model.init_params(torch.Generator().manual_seed(0))
        p = str(tmp_path / "ev.jsonl")
        with EventLog(p) as log:
            tr = Trainer(model, TrainConfig(batch_size=500, num_steps=8,
                                            log_every=1), event_log=log,
                         device="cpu")
            tr.fit(tr.init_state(params), train.x, train.y)
        ev = read_events(p)
        assert any(e["event"] == "train_epoch" for e in ev)

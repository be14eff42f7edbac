"""The port's experiments against the reference's, on the same numpy
data and the same trained params (the reference's, carried across):

- ``eval.metrics``: equal to the reference's on the same arrays.
- ``eval.rq1.test_retraining`` at ``batch_size`` = n (one batch an
  epoch, so every step's loss covers every row and the result does not
  depend on the schedule's draws), MF and NCF, damping 1e-3 as the
  engine tests (a float32 LU solve is only as exact as the block's
  conditioning, ROADMAP Queue C): the same removed rows exactly; the
  predicted diffs at rtol 2e-5 / atol 1e-6 for ``maxinf`` (measured
  7.5e-6 relative at most) and at rtol 2e-5 / atol 2e-6 for ``random``,
  whose picks include small scores that carry the solve's normwise
  error (measured 1.4e-6 absolute, 6.5e-6 of the largest |prediction|);
  the retrained predictions, actual diffs and bias at atol 5e-6
  (measured 1.2e-6 at most: five float32 ulps at a rating of 3.5 after
  30 steps whose full-batch losses sum the rows in another order).
- ``InfluenceEngine.query_many``: bitwise equal to ``query_batch`` on
  each batch (CPU), equal to the reference's ``query_many`` at the
  flat bar of ``test_torch_engine.py``'s ``tiny_splits`` cases (counts
  and related rows exact, per-query Spearman > 1 - 1e-9, scores at
  rtol 2e-5 / atol 1e-6 for NCF and rtol 1e-4 for MF, whose blocks there
  reach cond ≈ 1.1e3, so each float32 LU solve is within about
  cond·eps ≈ 1.3e-4 of exact and two of them within 2.6e-4, ROADMAP
  Queue C; measured by the bar's own measure, (|a - b| - atol) / |b|,
  4.0e-5 for MF and 7.5e-6 for NCF), resumed from its journal with no
  batch recomputed, stopped cleanly at a deadline.
- ``eval.rq2.time_influence_queries``: the same fields and counts.
"""

import jax
import numpy as np
import pytest
import torch

from fia_tpu.data.dataset import RatingDataset as RefDataset
from fia_tpu.eval import metrics as ref_metrics
from fia_tpu.eval import rq1 as ref_rq1
from fia_tpu.eval import rq2 as ref_rq2
from fia_tpu.influence.engine import InfluenceEngine as RefEngine
from fia_tpu.models import MF as RefMF
from fia_tpu.models import NCF as RefNCF
from fia_tpu.train.trainer import Trainer as RefTrainer
from fia_tpu.train.trainer import TrainConfig as RefConfig
from fia_tpu_torch.data.dataset import RatingDataset
from fia_tpu_torch.eval import metrics
from fia_tpu_torch.eval import rq1, rq2
from fia_tpu_torch.influence.engine import InfluenceEngine
from fia_tpu_torch.models import MF, NCF, params_from_numpy
from fia_tpu_torch.reliability import policy as rpolicy
from fia_tpu_torch.reliability import taxonomy
from fia_tpu_torch.reliability.journal import Journal

torch.set_num_threads(2)

FAMILIES = {"mf": (MF, RefMF), "ncf": (NCF, RefNCF)}
DAMPING = 1e-3
RTOL, ATOL = 2e-5, 1e-6
RANDOM_ATOL = 2e-6
RETRAIN_ATOL = 5e-6
MANY_RTOL = {"mf": 1e-4, "ncf": RTOL}
RHO_ONE = 1.0 - 1e-9


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def trained(request, tiny_splits):
    """Both engines on params the reference trained for 300 steps."""
    Port, Ref = FAMILIES[request.param]
    tr, te = tiny_splits["train"], tiny_splits["test"]
    ref_model = Ref(60, 40, 8, 1e-3)
    t = RefTrainer(ref_model, RefConfig(batch_size=200, num_steps=300,
                                        learning_rate=1e-2))
    st = t.fit(t.init_state(ref_model.init_params(jax.random.PRNGKey(0))),
               tr.x, tr.y)
    arrays = jax.tree_util.tree_map(np.asarray, st.params)
    model = Port(60, 40, 8, 1e-3)
    port = InfluenceEngine(model, params_from_numpy(model, arrays, "cpu"),
                           RatingDataset(tr.x, tr.y), damping=DAMPING,
                           device="cpu")
    ref = RefEngine(ref_model, arrays, RefDataset(tr.x, tr.y), damping=DAMPING)
    return port, ref, tr, te, request.param


def test_metrics_match_reference():
    rng = np.random.default_rng(4)
    a, b = rng.standard_normal(40), rng.standard_normal(40)
    a[3], b[9] = np.nan, np.inf
    b = a + 0.3 * b
    for fn in ("pearson", "spearman"):
        assert getattr(metrics, fn)(a, b) == getattr(ref_metrics, fn)(a, b)
        assert np.isnan(getattr(metrics, fn)(a[:1], b[:1]))
        assert np.isnan(getattr(metrics, fn)(np.ones(5), b[:5]))


@pytest.mark.parametrize("remove_type", ["maxinf", "random"])
def test_retraining_matches_reference(trained, remove_type):
    port, ref, tr, te, _ = trained
    kw = dict(num_to_remove=6, num_steps=30, batch_size=tr.num_examples,
              learning_rate=1e-2, retrain_times=2, remove_type=remove_type,
              lane_chunk=4, verbose=False)
    want = ref_rq1.test_retraining(ref, tr, te, 5, **kw)
    got = rq1.test_retraining(port, RatingDataset(tr.x, tr.y),
                              RatingDataset(te.x, te.y), 5, **kw)
    np.testing.assert_array_equal(got.indices_to_remove, want.indices_to_remove)
    np.testing.assert_array_equal(got.removed_train_rows,
                                  want.removed_train_rows)
    atol = ATOL if remove_type == "maxinf" else RANDOM_ATOL
    np.testing.assert_allclose(got.predicted_y_diffs, want.predicted_y_diffs,
                               rtol=RTOL, atol=atol)
    np.testing.assert_allclose(got.y0, want.y0, rtol=1e-6)
    assert got.per_repeat_y.shape == want.per_repeat_y.shape == (7, 2)
    assert np.isfinite(got.per_repeat_y).all()
    np.testing.assert_allclose(got.per_repeat_y, want.per_repeat_y, rtol=0,
                               atol=RETRAIN_ATOL)
    np.testing.assert_allclose(got.actual_y_diffs, want.actual_y_diffs, rtol=0,
                               atol=RETRAIN_ATOL)
    np.testing.assert_allclose(got.bias_retrain, want.bias_retrain, rtol=0,
                               atol=RETRAIN_ATOL)


def test_retraining_lane_chunk_does_not_change_lanes(trained):
    port, _, tr, te, _ = trained
    kw = dict(num_to_remove=3, num_steps=12, batch_size=500,
              learning_rate=1e-2, retrain_times=2, verbose=False)
    a = rq1.test_retraining(port, tr, te, 7, lane_chunk=3, **kw)
    b = rq1.test_retraining(port, tr, te, 7, lane_chunk=8, **kw)
    assert a.per_repeat_y.tobytes() == b.per_repeat_y.tobytes()
    with pytest.raises(ValueError, match="remove_type"):
        rq1.test_retraining(port, tr, te, 7, remove_type="nope", **kw)


def _same_result(a, b):
    assert np.array_equal(a.counts, b.counts)
    for attr in ("_packed", "ihvp", "test_grad"):
        assert getattr(a, attr).tobytes() == getattr(b, attr).tobytes(), attr
    assert np.array_equal(a._test_points, b._test_points) and a._pad == b._pad


def test_query_many_equals_query_batch(trained):
    port, _, _, te, _ = trained
    pts = te.x[:37]
    res = port.query_many(pts, batch_queries=8, window=2)
    assert len(res) == 5
    for k, r in enumerate(res):
        _same_result(r, port.query_batch(pts[8 * k: 8 * k + 8]))


def test_query_many_matches_reference(trained):
    port, ref, _, te, family = trained
    pts = te.x[:37]
    got = port.query_many(pts, batch_queries=16)
    want = ref.query_many(pts, batch_queries=16)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert np.array_equal(g.counts, w.counts)
        for t in range(len(g.counts)):
            assert np.array_equal(g.related_of(t), w.related_of(t))
            a, b = g.scores_of(t), w.scores_of(t)
            np.testing.assert_allclose(a, b, rtol=MANY_RTOL[family], atol=ATOL)
            if len(a) > 1 and np.ptp(a) > 0:
                assert metrics.spearman(a, b) > RHO_ONE
    fp = port.journal_fingerprint(pts, batch_queries=16, tag="x")
    assert fp == ref.journal_fingerprint(pts, batch_queries=16, tag="x") | {
        "model": fp["model"]}


def test_query_many_resumes_from_its_journal_and_stops_at_a_deadline(
        trained, tmp_path):
    port, _, _, te, _ = trained
    pts = te.x[:20]
    whole = port.query_many(pts, batch_queries=6)
    jpath = str(tmp_path / "q.jsonl")
    fp = port.journal_fingerprint(pts, batch_queries=6)
    clock = rpolicy.VirtualClock()
    deadline = rpolicy.Deadline(1.0, clock=clock)
    dispatched = []
    dispatch = port._dispatch_flat

    def spy(points, pad_to):
        dispatched.append(len(points))
        clock.advance(0.6)
        return dispatch(points, pad_to)

    port._dispatch_flat = spy
    try:
        with Journal.open(jpath, fp) as j:
            with pytest.raises(taxonomy.DeadlineExpired):
                port.query_many(pts, batch_queries=6, window=1, journal=j,
                                deadline=deadline)
            assert sorted(j.entries) == ["batch:0", "batch:1"]
        dispatched.clear()
        with Journal.open(jpath, fp, resume=True) as j:
            again = port.query_many(pts, batch_queries=6, journal=j)
        assert dispatched == [6, 2]  # batches 2 and 3 only
    finally:
        del port._dispatch_flat
    for a, b in zip(again, whole):
        _same_result(a, b)
        for t in range(len(a.counts)):
            assert np.array_equal(a.related_of(t), b.related_of(t))


def test_query_many_falls_back_to_query_batch(trained):
    port, _, tr, te, _ = trained
    padded = InfluenceEngine(port.model, port.params, RatingDataset(tr.x, tr.y),
                             damping=DAMPING, impl="padded", device="cpu")
    pts = te.x[:9]
    res = padded.query_many(pts, batch_queries=4)
    for k, r in enumerate(res):
        _same_result(r, padded.query_batch(pts[4 * k: 4 * k + 4]))


def test_time_influence_queries_matches_reference(trained):
    port, ref, _, te, family = trained
    pts = te.x[:12]
    for bq in (None, 5):
        got = rq2.time_influence_queries(port, pts, repeats=2, batch_queries=bq)
        want = ref_rq2.time_influence_queries(ref, pts, repeats=1,
                                              batch_queries=bq)
        assert (got.num_queries, got.num_scores) == (want.num_queries,
                                                     want.num_scores)
        assert sorted(got.json()) == sorted(want.json())
        assert len(got.times_s) == 2 and got.total_time_s == min(got.times_s)
        assert got.compile_time_s > 0 and got.per_query_ms > 0
        assert got.scores_per_sec == pytest.approx(
            got.num_scores / got.total_time_s)
    with pytest.raises(ValueError, match="batch_queries"):
        rq2.time_influence_queries(port, pts, batch_queries=-1)


def test_retraining_signature_is_the_references():
    """``test_retraining`` takes the reference's parameters, in its order
    and with its defaults, ``mesh`` before ``event_log`` (ROADMAP Queue
    C.5: the port lacked ``mesh``)."""
    import inspect

    port = inspect.signature(rq1.test_retraining).parameters
    ref = inspect.signature(ref_rq1.test_retraining).parameters
    assert list(port) == list(ref)
    for name, p in ref.items():
        assert port[name].default == p.default, name

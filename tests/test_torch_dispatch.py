"""The port's flat dispatch path, port against port on the CPU (a
restatement of ``tests/test_dispatch.py``):

- any batch split of ``query_many`` gives, for every query, the same
  bits as one full dispatch (scores, iHVP, test vector), MF and NCF;
- ``precompile_flat`` arms programs for ``flat_geometry``'s
  ``(t_pad, s_pad)`` geometries (the reference's, on the same points),
  idempotently, and a warmed engine builds nothing more: the
  ``fia_tpu_torch.utils.compilemon`` count of program builds does not
  move over ``query_batch`` and ``query_many`` at two geometries.

On the card a build is a CUDA-graph capture; ``chip_smoke.py`` holds the
same contracts there (its any-split and graph phases). The one test here
that needs the card skips itself without one.
"""

import contextlib
import gc

import jax
import numpy as np
import pytest
import torch

from fia_tpu.data.dataset import RatingDataset as RefDataset
from fia_tpu.influence.engine import InfluenceEngine as RefEngine
from fia_tpu.models import MF as RefMF
from fia_tpu_torch.data.dataset import RatingDataset
from fia_tpu_torch.influence.engine import InfluenceEngine, capturing
from fia_tpu_torch.models import MF, NCF
from fia_tpu_torch.utils import compilemon

torch.set_num_threads(2)

U, I, K = 30, 20, 4
WD, DAMP = 1e-2, 1e-3
FAMILIES = {"mf": MF, "ncf": NCF}


def _setup(family, seed=0, n=400):
    rng = np.random.default_rng(seed)
    x = np.stack([rng.integers(0, U, n), rng.integers(0, I, n)],
                 axis=1).astype(np.int32)
    y = rng.integers(1, 6, n).astype(np.float32)
    model = FAMILIES[family](U, I, K, WD)
    params = model.init_params(torch.Generator().manual_seed(seed))
    return model, params, RatingDataset(x, y)


def _engine(model, params, train, **kw):
    return InfluenceEngine(model, params, train, damping=DAMP, device="cpu",
                           **kw)


def _unique_points(train, n):
    uniq = np.unique(train.x, axis=0)
    assert len(uniq) >= n
    return uniq[:n].astype(np.int64)


def _flatten(results):
    """query_many batches -> per-query (scores, ihvp, test_grad)."""
    return [(res.scores_of(t), res.ihvp[t], res.test_grad[t])
            for res in results for t in range(len(res.counts))]


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_any_split_bit_identical_to_one_dispatch(family):
    model, params, train = _setup(family)
    pts = _unique_points(train, 23)
    eng = _engine(model, params, train)
    full = _flatten(eng.query_many(pts, batch_queries=len(pts)))
    for bq in (5, 8, 16, 23):  # 5 and 8 leave ragged finals
        parts = _flatten(eng.query_many(pts, batch_queries=bq))
        assert len(parts) == len(full)
        for t, (got, want) in enumerate(zip(parts, full)):
            for g, w in zip(got, want):
                assert g.tobytes() == w.tobytes(), (bq, t)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_query_batch_matches_query_many(family):
    model, params, train = _setup(family, seed=3)
    pts = _unique_points(train, 9)
    eng = _engine(model, params, train)
    res = eng.query_batch(pts)
    many = _flatten(eng.query_many(pts, batch_queries=4))
    for t in range(len(pts)):
        assert res.scores_of(t).tobytes() == many[t][0].tobytes()
        assert res.ihvp[t].tobytes() == many[t][1].tobytes()
        assert res.test_grad[t].tobytes() == many[t][2].tobytes()


@pytest.mark.parametrize("n", [1, 7, 64])
def test_flat_geometry_matches_reference(n):
    model, params, train = _setup("mf", seed=1)
    pts = _unique_points(train, n)
    eng = _engine(model, params, train)
    ref_model = RefMF(U, I, K, WD)
    ref = RefEngine(ref_model, ref_model.init_params(jax.random.PRNGKey(0)),
                    RefDataset(train.x, train.y), damping=DAMP)
    assert eng.flat_geometry(pts) == ref.flat_geometry(pts)
    assert eng.flat_geometry(pts[0]) == ref.flat_geometry(pts[0])


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_precompiled_dispatch_bit_identical(family):
    model, params, train = _setup(family, seed=1)
    pts = _unique_points(train, 7)
    want = _engine(model, params, train).query_batch(pts)
    eng = _engine(model, params, train)
    info = eng.precompile_flat([eng.flat_geometry(pts)])
    assert info["compiled"] == [list(eng.flat_geometry(pts))]
    got = eng.query_batch(pts)
    assert got._packed.tobytes() == want._packed.tobytes()
    assert got.ihvp.tobytes() == want.ihvp.tobytes()


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_precompile_is_idempotent_and_reports_cached(family):
    model, params, train = _setup(family, seed=4)
    pts = _unique_points(train, 5)
    eng = _engine(model, params, train)
    geom = eng.flat_geometry(pts)
    first = eng.precompile_flat([geom])
    again = eng.precompile_flat([geom])
    assert list(geom) in first["compiled"] and not first["cached"]
    assert list(geom) in again["cached"] and not again["compiled"]
    assert again["seconds"] >= 0.0
    assert eng.compiled_geometries() == {"aot": [list(geom)], "jit": []}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_precompiled_dispatch_builds_nothing(family):
    model, params, train = _setup(family, seed=2)
    pts = _unique_points(train, 7)
    eng = _engine(model, params, train)
    before = compilemon.count()
    eng.precompile_flat([eng.flat_geometry(pts)])
    assert compilemon.count() == before + 1
    eng.query_batch(pts)
    eng.query_batch(pts)
    assert compilemon.count() == before + 1
    assert eng.compiled_geometries()["jit"] == []


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_steady_state_builds_nothing(family):
    """Warm once, then a stream mixing two geometries through both entry
    points: the 64-query batch lands in a larger row bucket than its
    8-query pieces, and the build count must not move."""
    model, params, train = _setup(family, seed=5)
    pts = _unique_points(train, 64)
    eng = _engine(model, params, train)
    big, small = eng.flat_geometry(pts), eng.flat_geometry(pts[:8])
    assert big[1] > small[1]  # distinct row buckets
    eng.precompile_flat([big, small])
    eng.query_batch(pts)
    eng.query_many(pts, batch_queries=8)
    before = compilemon.count()
    eng.query_batch(pts)
    eng.query_many(pts, batch_queries=8)
    eng.query_many(pts, batch_queries=16)  # same buckets, another split
    assert compilemon.count() == before


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_first_dispatch_builds_once_as_jit(family):
    model, params, train = _setup(family, seed=6)
    pts = _unique_points(train, 7)
    eng = _engine(model, params, train)
    before = compilemon.count()
    eng.query_batch(pts)
    eng.query_batch(pts)
    assert compilemon.count() == before + 1
    got = eng.compiled_geometries()
    assert got["aot"] == [] and len(got["jit"]) == 1
    assert str(tuple(eng.flat_geometry(pts)))[1:-1] in got["jit"][0]


def test_precompile_is_a_noop_when_the_flat_path_is_ineligible():
    model, params, train = _setup("mf", seed=7)
    pts = _unique_points(train, 5)
    eng = _engine(model, params, train, solver="cg")
    before = compilemon.count()
    assert eng.precompile_flat([eng.flat_geometry(pts)]) == {
        "compiled": [], "cached": [], "seconds": 0.0}
    assert compilemon.count() == before


def test_new_params_build_a_new_program():
    """A program is keyed on the tensors it reads: params replaced by new
    tensors are not served by the old program."""
    model, params, train = _setup("mf", seed=8)
    pts = _unique_points(train, 5)
    eng = _engine(model, params, train)
    first = eng.query_batch(pts)
    eng.params = {k: v * 2.0 for k, v in eng.params.items()}
    before = compilemon.count()
    second = eng.query_batch(pts)
    assert compilemon.count() == before + 1
    assert second._packed.tobytes() != first._packed.tobytes()


@pytest.mark.cuda
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_graph_replay_equals_eager_program_on_the_card(family):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flat program is captured as a "
                    "CUDA graph only there")
    model, params, train = _setup(family)
    pts = _unique_points(train, 23)
    eng = InfluenceEngine(model, params, train, damping=DAMP)
    counts, tx, s_pad = eng._flat_inputs(pts)
    eager = eng._flat_fn(s_pad)(eng.params, eng.train_x, eng.train_y,
                                eng._postings, tx)
    res = eng.query_batch(pts)
    assert res._packed.tobytes() == eager[0][: int(counts.sum())].cpu(
        ).numpy().tobytes()
    assert res.ihvp.tobytes() == eager[1][: len(pts)].cpu().numpy().tobytes()
    full = _flatten(eng.query_many(pts, batch_queries=len(pts)))
    for bq in (5, 8, 16):
        parts = _flatten(eng.query_many(pts, batch_queries=bq))
        for got, want in zip(parts, full):
            for g, w in zip(got, want):
                assert g.tobytes() == w.tobytes()


@pytest.mark.parametrize("was_enabled", [True, False])
def test_capture_pauses_the_collector(monkeypatch, was_enabled):
    """A graph capture runs with Python's cyclic collector off (a dead
    graph freed mid-capture invalidates it) and leaves the collector as
    it found it, on an error too. The capture itself is stood in for:
    it needs the card."""
    seen = []

    @contextlib.contextmanager
    def graph(g):
        seen.append(gc.isenabled())
        yield

    monkeypatch.setattr(torch.cuda, "graph", graph)
    before = gc.isenabled()
    (gc.enable if was_enabled else gc.disable)()
    try:
        with capturing(object()):
            seen.append(gc.isenabled())
        assert gc.isenabled() == was_enabled
        with pytest.raises(RuntimeError):
            with capturing(object()):
                raise RuntimeError("a failed capture")
        assert gc.isenabled() == was_enabled
    finally:
        (gc.enable if before else gc.disable)()
    assert seen == [False, False, False]

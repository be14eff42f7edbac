"""The port's flat dispatch over a ``data`` mesh (``fia_tpu_torch.
parallel.mesh``) on the CPU, restating ``tests/test_mesh_dispatch.py``
over 1, 2, 4 and 8 virtual slots.

Each query shard runs the single-device flat program on its slot's
device (docs/design.md §15), so every slot count must give the
single-device engine's results BIT for bit: ``query_batch``,
``query_many`` with a ragged final batch, bank hits, ``block_hessians``
and serving. Built programs are keyed by the mesh fingerprint, slots
that share a device share one program a geometry, and a warmed mesh
engine builds nothing in steady state. The reference's scratch-donation
test has no counterpart: a captured graph copies its inputs into static
buffers, and nothing is donated.

Against the reference's mesh engine (conftest's 8 virtual CPU devices,
the reference's params carried over): the flat bars of
``test_torch_engine.py`` (rtol 2e-5 / atol 1e-6; ``tiny_splits`` at its
Queue C bars, ``TOLS``).
"""

import jax
import numpy as np
import pytest
import torch

from fia_tpu.data.dataset import RatingDataset as RefDataset
from fia_tpu.influence.engine import InfluenceEngine as RefEngine
from fia_tpu.models import MF as RefMF
from fia_tpu.models import NCF as RefNCF
from fia_tpu.parallel.mesh import make_mesh as ref_make_mesh
from fia_tpu_torch import obs
from fia_tpu_torch.data.dataset import RatingDataset
from fia_tpu_torch.influence import factor as fbank
from fia_tpu_torch.influence.engine import InfluenceEngine
from fia_tpu_torch.models import MF, NCF, params_from_numpy
from fia_tpu_torch.parallel import mesh as pmesh
from fia_tpu_torch.utils import compilemon

torch.set_num_threads(2)

DEVICE_COUNTS = (1, 2, 4, 8)
FAMILIES = {"mf": (MF, RefMF), "ncf": (NCF, RefNCF)}
ATOL = 1e-6
# (score rtol, iHVP rtol) of each (family, input): test_torch_engine.py's
TOLS = {("mf", "kernels"): (2e-5, 2e-5), ("mf", "tiny"): (1e-4, 1e-4),
        ("ncf", "kernels"): (2e-5, 2e-5), ("ncf", "tiny"): (2e-5, 5e-4)}


@pytest.fixture(autouse=True, scope="module")
def slots():
    with pmesh.virtual_devices(8):
        yield


def mesh(n):
    return pmesh.make_mesh(n, device="cpu")


def _setup(seed=0, n=400, users=20, items=16, k=4, family="mf"):
    rng = np.random.default_rng(seed)
    x = np.stack([rng.integers(0, users, n), rng.integers(0, items, n)],
                 axis=1).astype(np.int32)
    y = rng.integers(1, 6, n).astype(np.float32)
    model = FAMILIES[family][0](users, items, k, 1e-3)
    params = model.init_params(torch.Generator().manual_seed(seed))
    return model, params, RatingDataset(x, y)


def _points(train, t, seed=7):
    rng = np.random.default_rng(seed)
    return np.asarray(train.x)[rng.choice(len(train.x), size=t,
                                          replace=False)]


def _engine(model, params, train, **kw):
    return InfluenceEngine(model, params, train, damping=1e-3, impl="flat",
                           device="cpu", **kw)


def _same(got, base, n):
    assert np.array_equal(got.counts, base.counts)
    assert np.array_equal(got.ihvp, base.ihvp)
    assert np.array_equal(got.test_grad, base.test_grad)
    for t in range(n):
        assert np.array_equal(got.scores_of(t), base.scores_of(t))


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def problem(request):
    model, params, train = _setup(family=request.param)
    return model, params, train, _engine(model, params, train)


class TestMeshEquivalence:
    @pytest.mark.parametrize("ndev", DEVICE_COUNTS)
    def test_query_batch_bit_identical(self, problem, ndev):
        model, params, train, single = problem
        pts = _points(train, 13)  # 13 % ndev != 0 for every ndev > 1
        eng = _engine(model, params, train, mesh=mesh(ndev))
        _same(eng.query_batch(pts), single.query_batch(pts), len(pts))

    @pytest.mark.parametrize("ndev", DEVICE_COUNTS)
    def test_query_many_ragged_final_batch(self, problem, ndev):
        """23 queries in batches of 5: the final 3-query batch is both
        ragged and smaller than the slot count at 4 and 8 (empty shards
        padded with the batch's last pair)."""
        model, params, train, single = problem
        pts = _points(train, 23, seed=11)
        eng = _engine(model, params, train, mesh=mesh(ndev))
        base = single.query_many(pts, batch_queries=5)
        got = eng.query_many(pts, batch_queries=5)
        assert len(got) == len(base)
        for rb, rg in zip(base, got):
            _same(rg, rb, len(rb.counts))

    @pytest.mark.parametrize("ndev", DEVICE_COUNTS)
    def test_block_hessians_bit_identical(self, problem, ndev):
        model, params, train, single = problem
        pts = _points(train, 11, seed=4)
        eng = _engine(model, params, train, mesh=mesh(ndev))
        assert np.array_equal(eng.block_hessians(pts, batch_queries=6),
                              single.block_hessians(pts, batch_queries=6))

    @staticmethod
    def _bank_engines(model, params, train, tmp_path, ndev):
        builder = InfluenceEngine(model, params, train, damping=1e-3,
                                  cache_dir=str(tmp_path), model_name="m",
                                  device="cpu")
        pairs = fbank.select_hot_pairs(builder.index, max_entries=12,
                                       top_users=4, top_items=4)
        bank = fbank.build_bank(builder, pairs, batch_queries=12)
        fbank.publish_bank(bank, builder.factor_bank_path(),
                           fbank.bank_fingerprint("m", model.block_size,
                                                  1e-3,
                                                  *builder._train_host))

        def prec(**kw):
            return InfluenceEngine(model, params, train, damping=1e-3,
                                   solver="precomputed", lissa_depth=50,
                                   cache_dir=str(tmp_path), model_name="m",
                                   device="cpu", **kw)

        return prec(), prec(mesh=mesh(ndev)), np.asarray(bank.pairs,
                                                          np.int64)

    @pytest.mark.parametrize("ndev", DEVICE_COUNTS)
    def test_bank_hits_bit_identical(self, problem, ndev, tmp_path):
        """The bank's factors on every physical device, the hit program
        query-sharded like the flat dispatch: a batch of hits the
        single-device precomputed engine's bits."""
        model, params, train, _ = problem
        single, eng, pairs = self._bank_engines(model, params, train,
                                                tmp_path, ndev)
        hits = pairs[:7]
        _same(eng.query_batch(hits), single.query_batch(hits), len(hits))
        assert eng.bank_stats()["hits"] == single.bank_stats()["hits"] == 7
        assert list(eng._bank_replicas) == [eng.device]  # one device

    def test_bank_mixed_batch_hits_bit_identical(self, problem, tmp_path):
        """A mixed batch on a 2-slot mesh: its hits the single-device
        engine's bits. Its misses differ by design: the miss delegate's
        sampled rung is single-device, so on a mesh it escalates one
        rung (LiSSA, here at depth 50) and is held at a loose bar."""
        model, params, train, _ = problem
        single, eng, pairs = self._bank_engines(model, params, train,
                                                tmp_path, 2)
        mixed = np.concatenate([pairs[:3], _points(train, 2, seed=2)])
        got, want = eng.query_batch(mixed), single.query_batch(mixed)
        assert np.array_equal(got.counts, want.counts)
        assert np.array_equal(got.ihvp[:3], want.ihvp[:3])
        for t in range(3):
            assert np.array_equal(got.scores_of(t), want.scores_of(t))
        assert eng._miss_delegate().sampled_stats()["escalations"] == {
            "ineligible": 2}
        assert np.isfinite(got.ihvp).all()


class TestMeshCompileDiscipline:
    def test_aot_key_carries_mesh_fingerprint(self, problem):
        model, params, train, single = problem
        m4 = mesh(4)
        eng = _engine(model, params, train, mesh=m4)
        assert single._aot_key(64, 2048)[-1] is None
        assert eng._aot_key(64, 2048)[-1] == pmesh.mesh_fingerprint(m4)
        # distinct meshes never collide on a program
        eng2 = _engine(model, params, train, mesh=mesh(2))
        assert eng._aot_key(64, 2048) != eng2._aot_key(64, 2048)
        assert eng._aot_key(64, 2048) != single._aot_key(64, 2048)
        assert eng._flat_key(64, 2048)[-1] == pmesh.mesh_fingerprint(m4)

    def test_zero_steady_state_builds_on_mesh(self, problem):
        model, params, train, _ = problem
        eng = _engine(model, params, train, mesh=mesh(4))
        pts = _points(train, 10, seed=3)
        geom = eng.flat_geometry(pts)
        aot = eng.precompile_flat([geom])
        assert list(geom) in aot["compiled"]
        assert eng.precompile_flat([geom])["cached"] == [list(geom)]
        eng.query_batch(pts)  # warm the host packing path
        c0 = compilemon.count()
        hits = obs.REGISTRY.counter("engine.aot_hits").value
        eng.query_batch(pts)
        # one AOT hit a dispatch, whatever its shard count (the reference's
        # counter)
        assert obs.REGISTRY.counter("engine.aot_hits").value == hits + 1
        eng.query_many(pts, batch_queries=len(pts))
        assert compilemon.count() - c0 == 0
        assert eng.compiled_geometries() == {"aot": [list(geom)], "jit": []}

    @pytest.mark.parametrize("ndev", (2, 8))
    def test_one_program_per_device_geometry(self, problem, ndev):
        """Virtual slots share one device: one replica of the state and
        one program a geometry, whatever the slot count."""
        model, params, train, _ = problem
        eng = _engine(model, params, train, mesh=mesh(ndev))
        pts = _points(train, 16, seed=9)
        c0 = compilemon.count()
        eng.query_batch(pts)
        assert compilemon.count() - c0 == 1 and len(eng._programs) == 1
        assert list(eng._replicas) == eng._devices() == [eng.device]
        assert eng.flat_geometry(pts)[0] == eng._query_pad(-(-16 // ndev))


class TestMeshServing:
    def _requests(self, train, n=40):
        from fia_tpu_torch.serve import Request

        rng = np.random.default_rng(19)
        pool = np.asarray(train.x)[rng.choice(len(train.x), size=12,
                                              replace=False)]
        return [Request(user=int(u), item=int(i), id=f"q{j}")
                for j, (u, i) in enumerate(pool[rng.integers(len(pool),
                                                             size=n)])]

    @pytest.mark.parametrize("ndev", (2, 4, 8))
    def test_serve_mesh_bit_identical_zero_recompiles(self, problem, ndev):
        from fia_tpu_torch.serve import InfluenceService, ServeConfig

        model, params, train, _ = problem
        reqs = self._requests(train)
        warm_pts = np.asarray(train.x[:16], np.int64)

        def run(m):
            eng = _engine(model, params, train, mesh=m)
            svc = InfluenceService(engine=eng, config=ServeConfig(
                max_batch=8, mesh=m, disk_cache=False))
            info = svc.warmup(warm_pts)
            assert info["all_planned_compiled"]
            svc.run(list(reqs), drain_every=8)  # warm pass
            c0 = compilemon.count()
            resp = svc.run(list(reqs), drain_every=8)
            return resp, compilemon.count() - c0

        base, _ = run(None)
        got, steady = run(mesh(ndev))
        assert steady == 0
        by_id = {r.id: r for r in base}
        assert all(r.ok for r in got)
        for r in got:
            assert np.array_equal(r.scores, by_id[r.id].scores)

    def test_serve_config_mesh_must_match_engine(self, problem):
        from fia_tpu_torch.serve import InfluenceService, ServeConfig
        from fia_tpu_torch.serve.service import _resolve_mesh

        model, params, train, single = problem
        assert _resolve_mesh(None) is None
        assert _resolve_mesh(0) is None
        assert _resolve_mesh(1) is None
        m = _resolve_mesh(2, "cpu")
        assert pmesh.mesh_fingerprint(m) == pmesh.mesh_fingerprint(mesh(2))
        with pytest.raises(ValueError, match="mesh"):
            InfluenceService(engine=single,
                             config=ServeConfig(mesh=2, disk_cache=False))


class TestMeshRebuild:
    def test_rebuild_mesh_rehomes_engine_and_delegates(self, problem):
        """``rebuild_mesh``: the counter, the site, every program and
        armed geometry dropped, the delegates on the new mesh, and the
        results unchanged."""
        from fia_tpu_torch import obs
        from fia_tpu_torch.reliability import inject

        model, params, train, single = problem
        eng = _engine(model, params, train, mesh=mesh(4))
        sib = eng.approx_sibling()
        pts = _points(train, 9, seed=6)
        eng.precompile_flat([eng.flat_geometry(pts)])
        before = obs.REGISTRY.counter("engine.mesh_rebuilds").value
        small = pmesh.surviving_mesh(eng.mesh)
        with inject.active() as inj:
            eng.rebuild_mesh(small)
        assert inj.counts["mesh.rebuild"] == 1
        assert obs.REGISTRY.counter("engine.mesh_rebuilds").value == \
            before + 1
        assert eng._programs == {} and eng._aot == set()
        assert eng.mesh is small and sib.mesh is small
        assert sib.train_x is eng.train_x and sib._postings is eng._postings
        _same(eng.query_batch(pts), single.query_batch(pts), len(pts))
        eng.rebuild_mesh(None)
        assert eng.mesh is None and sib.mesh is None
        _same(eng.query_batch(pts), single.query_batch(pts), len(pts))

    def test_mesh_engine_escalates_the_sampled_rung(self, problem):
        """As the reference: the sampled program is single-device, so a
        mesh engine's sampled queries escalate one rung (``ineligible``);
        the CPU rung does not apply to a mesh engine."""
        model, params, train, _ = problem
        eng = InfluenceEngine(model, params, train, damping=1e-3,
                              solver="sampled", lissa_depth=50,
                              mesh=mesh(2), device="cpu")
        pts = _points(train, 4, seed=8)
        res = eng.query_batch(pts)
        assert eng.sampled_stats()["escalations"] == {"ineligible": 4}
        assert np.isfinite(res.ihvp).all()
        flat = _engine(model, params, train, mesh=mesh(2), cpu_fallback=True)
        assert flat._query_on_cpu(pts, None) is None


# -- port against the JAX package --------------------------------------------
def _kernels_setup():
    U, I = 24, 18
    rng = np.random.default_rng(0)
    x = np.stack([rng.integers(0, U - 1, 400), rng.integers(0, I - 1, 400)],
                 axis=1).astype(np.int32)
    y = rng.integers(1, 6, 400).astype(np.float32)
    pts = x[np.random.default_rng(7).choice(400, size=11, replace=False)]
    pts = np.concatenate([pts.astype(np.int64), [[U - 1, I - 1]]])
    return (U, I, 4), x, y, pts


@pytest.mark.parametrize("ndev", (2, 8))
@pytest.mark.parametrize("case", sorted(TOLS), ids=lambda p: "-".join(p))
def test_mesh_query_matches_reference_mesh(case, ndev, tiny_splits):
    family, setup = case
    if setup == "kernels":
        (U, I, k), x, y, pts = _kernels_setup()
    else:
        tr = tiny_splits["train"]
        (U, I, k), x, y = (60, 40, 8), tr.x, tr.y
        pts = tiny_splits["test"].x[:37].astype(np.int64)
    Port, Ref = FAMILIES[family]
    ref_model = Ref(U, I, k, 1e-3)
    arrays = jax.tree_util.tree_map(
        np.asarray, ref_model.init_params(jax.random.PRNGKey(0)))
    model = Port(U, I, k, 1e-3)
    port = InfluenceEngine(model, params_from_numpy(model, arrays, "cpu"),
                           RatingDataset(x, y), damping=1e-3, mesh=mesh(ndev),
                           device="cpu")
    ref = RefEngine(ref_model, arrays, RefDataset(x, y), damping=1e-3,
                    mesh=ref_make_mesh(ndev))
    rtol, ihvp_rtol = TOLS[case]
    for got, want in ((port.query_batch(pts), ref.query_batch(pts)),
                      *zip(port.query_many(pts, batch_queries=5),
                           ref.query_many(pts, batch_queries=5))):
        assert np.array_equal(got.counts, want.counts)
        for t in range(len(got.counts)):
            assert np.array_equal(got.related_of(t), want.related_of(t))
            np.testing.assert_allclose(got.scores_of(t), want.scores_of(t),
                                       rtol=rtol, atol=ATOL)
        np.testing.assert_allclose(got.ihvp, want.ihvp, rtol=ihvp_rtol,
                                   atol=ATOL)
        np.testing.assert_allclose(got.test_grad, want.test_grad, rtol=2e-5,
                                   atol=ATOL)
    assert port.flat_geometry(pts) == ref.flat_geometry(pts)


def test_captures_run_on_each_devices_own_stream(monkeypatch):
    """A mesh shard's program is captured on a stream of its own device:
    ``torch.cuda.graph``'s default capture stream is one for the
    process, made on the device current at the time, so a second card's
    capture needs its own (streams stood in for: they need a card)."""
    import contextlib

    from fia_tpu_torch.influence import engine as E

    made, used = [], []
    monkeypatch.setattr(E, "_CAPTURE_STREAMS", {})
    monkeypatch.setattr(torch.cuda, "Stream",
                        lambda index: made.append(index) or object())
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    a = E._device_stream(E._CAPTURE_STREAMS, "cuda:1")
    assert E._device_stream(E._CAPTURE_STREAMS, torch.device("cuda", 1)) is a
    assert E._device_stream(E._CAPTURE_STREAMS, "cuda") is not a
    assert made == [1, 0]

    @contextlib.contextmanager
    def graph(g, stream=None):
        used.append(stream)
        yield

    monkeypatch.setattr(torch.cuda, "graph", graph)
    with E.capturing(object(), a):
        pass
    assert used == [a]

"""The port's device mesh on the CPU (``fia_tpu_torch.parallel``),
restating ``tests/test_parallel.py`` over 8 virtual slots, at the
reference's bars, plus ``mesh.py``'s own cases.

- ``TestMesh``: the virtual slots, ``make_mesh``, ``shard_along`` and
  ``replicate`` (one copy a physical device).
- ``TestShardedInfluence``: the padded program on a mesh within the
  reference's rtol 1e-4 / atol 1e-5 of the flat path, the flat mesh path
  bitwise the single-device one.
- ``TestShardedTables``: row-sharded tables on the 2-D ``('data',
  'model')`` mesh, flat and padded: the flat path bitwise the
  single-device engine, the padded one bitwise the replicated padded
  mesh engine and within the reference's rtol 1e-4 / atol 1e-5 of the
  single-device scores; the tables' layout.
- ``TestMeshTraining``: data-parallel ``Trainer.fit``, lane-sharded
  ``loo_retrain_many`` and ``test_retraining`` on a mesh within the
  reference's bars of single-device (rtol 2e-4 / atol 1e-5; RQ1's
  predicted diffs 1e-4 / 1e-6, actual diffs 2e-3 / 2e-5), and two mesh
  runs bitwise equal.
- ``TestShardedFullHVP``: the full engine's row-sharded influence within
  rtol 1e-3 / atol 1e-6 of single-device; against the reference's mesh
  engine on the same data (the reference's params carried over) the HVP
  at rtol 1e-5 and the CG influence at ``test_torch_full.py``'s
  port-against-reference bar, rtol 5e-3.
- ``TestMeshModule``: the fingerprint, ``surviving_mesh`` over virtual
  hosts, ``live_device_ids`` patched, the CUDA default, ``init_pod_mesh``
  (across processes: ``test_torch_distributed.py``) and the scoped
  virtual-slot count.
"""

import jax
import numpy as np
import pytest
import torch

from fia_tpu.data.dataset import RatingDataset as RefDataset
from fia_tpu.influence.full import FullInfluenceEngine as RefFull
from fia_tpu.models import MF as RefMF
from fia_tpu.parallel.mesh import make_mesh as ref_make_mesh
from fia_tpu_torch.data.dataset import RatingDataset
from fia_tpu_torch.influence.engine import InfluenceEngine
from fia_tpu_torch.influence.full import FullInfluenceEngine
from fia_tpu_torch.models import MF, params_from_numpy
from fia_tpu_torch.parallel import mesh as pmesh
from fia_tpu_torch.parallel.mesh import make_mesh, replicate, shard_along

torch.set_num_threads(2)


@pytest.fixture(autouse=True, scope="module")
def slots():
    with pmesh.virtual_devices(8):
        yield


def mesh(n):
    return make_mesh(n, device="cpu")


def _data(seed=0, n=400, users=20, items=16):
    rng = np.random.default_rng(seed)
    x = np.stack([rng.integers(0, users, n), rng.integers(0, items, n)],
                 axis=1).astype(np.int32)
    y = rng.integers(1, 6, n).astype(np.float32)
    return x, y


def _setup(seed=0, n=400, users=20, items=16, k=4):
    x, y = _data(seed, n, users, items)
    model = MF(users, items, k, 1e-3)
    params = model.init_params(torch.Generator().manual_seed(seed))
    return model, params, RatingDataset(x, y)


def _close_params(a: dict, b: dict, rtol: float, atol: float) -> None:
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].shape == b[k].shape
        np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), rtol=rtol,
                                   atol=atol, err_msg=k)


class TestMesh:
    def test_eight_devices(self):
        assert pmesh.live_device_ids() == frozenset(range(8))

    def test_make_mesh(self):
        m = mesh(8)
        assert m.devices.size == 8 and m.axis_names == ("data",)
        assert [s.id for s in m.devices.flat] == list(range(8))
        assert all(s.device == torch.device("cpu") for s in m.devices.flat)

    def test_shard_and_replicate(self):
        m = mesh(8)
        x = torch.arange(64.0).reshape(16, 4)
        xs = shard_along(m, x)
        assert len(xs) == 8 and all(p.shape == (2, 4) for p in xs)
        assert torch.equal(torch.cat(xs), x)
        xr = replicate(m, {"x": x})
        # one copy a physical device: every virtual slot shares it
        assert all(r["x"] is xr[0]["x"] for r in xr)
        assert torch.equal(xr[0]["x"], x)
        ragged = shard_along(m, torch.arange(13.0))
        assert [len(p) for p in ragged] == [2] * 6 + [1, 0]


class TestShardedInfluence:
    def test_sharded_query_matches_single_device(self):
        model, params, train = _setup()
        pts = np.array([[3, 5], [0, 1], [7, 2], [11, 9], [1, 1]])
        single = InfluenceEngine(model, params, train, damping=1e-3,
                                 device="cpu")
        base = single.query_batch(pts)
        sharded = InfluenceEngine(model, params, train, damping=1e-3,
                                  mesh=mesh(8), device="cpu")
        got = sharded.query_batch(pts, pad_to=base.scores.shape[1])
        for t in range(len(pts)):
            np.testing.assert_allclose(got.scores_of(t), base.scores_of(t),
                                       rtol=1e-4, atol=1e-6)

    def test_uneven_batch_padding(self):
        """T not divisible by the mesh size still returns T results."""
        model, params, train = _setup()
        eng = InfluenceEngine(model, params, train, damping=1e-3,
                              mesh=mesh(8), impl="padded", device="cpu")
        pts = np.array([[3, 5], [0, 1], [7, 2]])  # 3 % 8 != 0
        res = eng.query_batch(pts)
        assert res.scores.shape[0] == 3
        assert res.ihvp.shape == (3, model.block_size)

    def test_flat_on_mesh_matches_padded(self):
        """The flat path on a mesh shards the query axis, so it is BIT
        identical to the single-device flat path; the padded mesh path
        agrees within the reference's 1e-5 pin (its solve runs at the
        shard's own batch, not the flat path's pieces)."""
        model, params, train = _setup()
        pts = np.array([[3, 5], [0, 1], [7, 2], [11, 9], [1, 1]])
        flat = InfluenceEngine(model, params, train, damping=1e-3,
                               mesh=mesh(8), impl="flat", device="cpu")
        padded = InfluenceEngine(model, params, train, damping=1e-3,
                                 mesh=mesh(8), impl="padded", device="cpu")
        single = InfluenceEngine(model, params, train, damping=1e-3,
                                 impl="flat", device="cpu")
        a = flat.query_batch(pts)
        b = padded.query_batch(pts)
        c = single.query_batch(pts)
        assert np.array_equal(a.counts, b.counts)
        for t in range(len(pts)):
            np.testing.assert_allclose(a.scores_of(t), b.scores_of(t),
                                       rtol=1e-4, atol=1e-5)
            assert np.array_equal(a.scores_of(t), c.scores_of(t))
        np.testing.assert_allclose(a.ihvp, b.ihvp, rtol=1e-4, atol=1e-5)
        assert np.array_equal(a.ihvp, c.ihvp)

    @pytest.mark.parametrize("solver", ["cg", "schulz"])
    def test_iterative_solvers_on_mesh(self, solver):
        """The padded program's iterative solvers shard like the direct
        one: within 1e-5 of the single-device padded engine, the loop
        count the largest shard's."""
        model, params, train = _setup()
        pts = np.array([[3, 5], [0, 1], [7, 2], [11, 9], [1, 1]])
        kw = dict(damping=1e-3, solver=solver, device="cpu")
        a = InfluenceEngine(model, params, train, mesh=mesh(4),
                            **kw).query_batch(pts)
        b = InfluenceEngine(model, params, train, **kw).query_batch(pts)
        np.testing.assert_allclose(a.ihvp, b.ihvp, rtol=1e-4, atol=1e-5)
        assert a.iterations is not None and a.iterations > 0


class TestShardedTables:
    @pytest.mark.parametrize("impl", ["flat", "padded"])
    def test_table_sharded_query_matches(self, impl):
        """2-D ('data','model') mesh with row-sharded embedding tables
        reproduces the single-device scores on both query programs: the
        flat one bitwise; the padded one bitwise the replicated padded
        engine on the same mesh, and within the reference's bar of the
        single-device (flat) scores."""
        from fia_tpu_torch.parallel.sharded import make_2d_mesh

        model, params, train = _setup()
        pts = np.array([[3, 5], [0, 1], [7, 2], [11, 9]])
        want = InfluenceEngine(model, params, train, damping=1e-3,
                               device="cpu").query_batch(pts)
        mesh2 = make_2d_mesh(8, model_parallel=2, device="cpu")
        eng = InfluenceEngine(model, params, train, damping=1e-3,
                              mesh=mesh2, shard_tables=True, impl=impl,
                              device="cpu")
        got = eng.query_batch(pts, pad_to=want.scores.shape[1])
        for t in range(len(pts)):
            np.testing.assert_allclose(got.scores_of(t), want.scores_of(t),
                                       rtol=1e-4, atol=1e-5)
            if impl == "flat":
                assert np.array_equal(got.scores_of(t), want.scores_of(t))
        if impl == "padded":
            rep = InfluenceEngine(model, params, train, damping=1e-3,
                                  mesh=mesh2, impl=impl, device="cpu")
            assert got._packed.tobytes() == rep.query_batch(
                pts)._packed.tobytes()

    def test_shard_model_params_layout(self):
        from fia_tpu_torch.parallel.sharded import (make_2d_mesh,
                                                    shard_model_params)

        model, params, train = _setup()
        sp = shard_model_params(make_2d_mesh(8, model_parallel=2,
                                             device="cpu"), params, model)
        assert sp["P"].axis == "model" and sp["P"].shape == (20, 4)
        assert sp["bg"].axis is None
        assert all(x is sp["bg"].shards[0] for x in sp["bg"].shards)


class TestMeshTraining:
    """Data-parallel training and lane-sharded retraining on the mesh
    against the single-device path (the same schedule, float
    reassociation only)."""

    def test_fit_on_mesh_matches_single_device(self):
        from fia_tpu_torch.train.trainer import Trainer, TrainConfig

        model, params, train = _setup(n=400)
        # batch 50 does not divide 8 slots: zero-weight padding
        cfg = TrainConfig(batch_size=50, num_steps=40, learning_rate=1e-2)
        t1 = Trainer(model, cfg, device="cpu")
        s1 = t1.fit(t1.init_state(params), train.x, train.y)
        runs = []
        for _ in range(2):
            t2 = Trainer(model, cfg, mesh=mesh(8), device="cpu")
            runs.append(t2.fit(t2.init_state(params), train.x, train.y))
        _close_params(s1.params, runs[0].params, 2e-4, 1e-5)
        _close_params(runs[0].params, runs[1].params, 0.0, 0.0)
        assert t2.last_losses.shape == (40,)

    def test_loo_retrain_mesh_matches_lane_for_lane(self):
        from fia_tpu_torch.train.trainer import loo_retrain_many

        model, params, train = _setup(n=400)
        removed = np.array([5, 9, 123, -1, 77])  # 5 % 8 != 0: lane padding
        kw = dict(num_steps=30, batch_size=50, learning_rate=1e-2,
                  seeds=np.arange(5, dtype=np.uint32), device="cpu")
        base = loo_retrain_many(model, params, train.x, train.y, removed,
                                **kw)
        got = loo_retrain_many(model, params, train.x, train.y, removed,
                               mesh=mesh(8), **kw)
        again = loo_retrain_many(model, params, train.x, train.y, removed,
                                 mesh=mesh(8), **kw)
        _close_params(base, got, 2e-4, 1e-5)  # padding lanes stripped
        _close_params(got, again, 0.0, 0.0)

    @pytest.fixture
    def ref_setup(self):
        """An MF pair on the same numpy data, the reference's params
        carried over to the port."""
        import jax.numpy as jnp

        from fia_tpu.train import trainer as ref_trainer
        from fia_tpu_torch.train import trainer as T

        x, y = _data(n=400)
        ref_model = RefMF(20, 16, 4, 1e-3)
        arrays = jax.tree_util.tree_map(
            np.asarray, ref_model.init_params(jax.random.PRNGKey(0)))
        model = MF(20, 16, 4, 1e-3)
        return (x, y, ref_model, arrays, model,
                params_from_numpy(model, arrays, "cpu"), ref_trainer, T, jnp)

    def test_fit_on_mesh_matches_reference_mesh(self, ref_setup, monkeypatch):
        """The port's data-parallel ``fit`` on 8 slots against the
        reference's on its 8-device mesh, the reference's fit schedule
        handed to the port (``test_torch_train.py``'s ``_fit_perm``):
        within the reference's mesh bar, rtol 2e-4 / atol 2e-5 (its
        mesh-against-single-device rtol 2e-4, widened in atol to the
        port-against-reference 2e-5 of ``test_torch_train.py``)."""
        x, y, ref_model, arrays, model, params, ref_trainer, T, _ = ref_setup
        cfg = dict(batch_size=50, num_steps=40, learning_rate=1e-2, seed=3)
        ref = ref_trainer.Trainer(ref_model, ref_trainer.TrainConfig(**cfg),
                                  mesh=ref_make_mesh(8))
        rs = ref.fit(ref.init_state(arrays), x, y)

        def fit_perm(seed, epoch, n):
            key = jax.random.fold_in(jax.random.PRNGKey(seed), epoch)
            return torch.from_numpy(np.array(jax.random.permutation(key, n)))

        monkeypatch.setattr(T, "epoch_permutation", fit_perm)
        tr = T.Trainer(model, T.TrainConfig(**cfg), mesh=mesh(8),
                       device="cpu")
        ps = tr.fit(tr.init_state(params), x, y)
        for k in arrays:
            np.testing.assert_allclose(ps.params[k].numpy(),
                                       np.asarray(rs.params[k]), rtol=2e-4,
                                       atol=2e-5, err_msg=k)
        assert ps.step == rs.step

    def test_loo_retrain_mesh_matches_reference_mesh(self, ref_setup,
                                                     monkeypatch):
        """The port's lane-sharded ``loo_retrain_many`` on 8 slots (5
        lanes, padded with copies of the last) against the reference's on
        its 8-device mesh (padded with no-op -1 lanes), each lane's
        schedule the reference's: lane for lane at the same bar."""
        x, y, ref_model, arrays, model, params, ref_trainer, T, _ = ref_setup
        removed = np.array([5, 9, 123, -1, 77])
        seeds = np.arange(5, dtype=np.uint32)
        steps, batch = 30, 50
        want = ref_trainer.loo_retrain_many(ref_model, arrays, x, y, removed,
                                            steps, batch, 1e-2, seeds=seeds,
                                            mesh=ref_make_mesh(8))
        n_epochs = -(-steps // (len(x) // batch))

        def loo_perm(seed, epoch, n):
            keys = jax.random.split(jax.random.PRNGKey(np.uint32(seed)),
                                    n_epochs)
            return torch.from_numpy(np.array(
                jax.random.permutation(keys[epoch], n)))

        monkeypatch.setattr(T, "epoch_permutation", loo_perm)
        got = T.loo_retrain_many(model, params, x, y, removed, steps, batch,
                                 1e-2, seeds=seeds, mesh=mesh(8),
                                 device="cpu")
        for k in arrays:
            assert got[k].shape == np.shape(want[k]) == (5, *np.shape(
                arrays[k]))
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=2e-4, atol=2e-5, err_msg=k)

    def test_rq1_retraining_on_mesh_matches(self, tiny_splits):
        """``test_retraining(..., mesh=...)`` equals the single-device run
        on the 8-slot mesh."""
        from fia_tpu_torch.eval.rq1 import test_retraining
        from fia_tpu_torch.train.trainer import Trainer, TrainConfig

        train = RatingDataset(tiny_splits["train"].x, tiny_splits["train"].y)
        test = RatingDataset(tiny_splits["test"].x, tiny_splits["test"].y)
        users = int(max(train.x[:, 0].max(), test.x[:, 0].max())) + 1
        items = int(max(train.x[:, 1].max(), test.x[:, 1].max())) + 1
        model = MF(users, items, 4, 1e-3)
        tr = Trainer(model, TrainConfig(batch_size=100, num_steps=300,
                                        learning_rate=1e-2), device="cpu")
        state = tr.fit(tr.init_state(model.init_params(
            torch.Generator().manual_seed(0))), train.x, train.y)
        kw = dict(num_to_remove=4, num_steps=60, batch_size=100,
                  learning_rate=1e-2, retrain_times=2, verbose=False)
        base_eng = InfluenceEngine(model, state.params, train, damping=1e-3,
                                   device="cpu")
        base = test_retraining(base_eng, train, test, 0, **kw)
        m = mesh(8)
        mesh_eng = InfluenceEngine(model, state.params, train, damping=1e-3,
                                   mesh=m, device="cpu")
        got = test_retraining(mesh_eng, train, test, 0, mesh=m, **kw)
        np.testing.assert_allclose(got.predicted_y_diffs,
                                   base.predicted_y_diffs, rtol=1e-4,
                                   atol=1e-6)
        np.testing.assert_allclose(got.actual_y_diffs, base.actual_y_diffs,
                                   rtol=2e-3, atol=2e-5)
        assert np.isclose(got.bias_retrain, base.bias_retrain, rtol=2e-3,
                          atol=2e-5)


class TestShardedFullHVP:
    def test_full_engine_sharded_matches(self):
        model, params, train = _setup(n=400)
        base = FullInfluenceEngine(model, params, train, damping=1e-2,
                                   solver="cg", device="cpu")
        shrd = FullInfluenceEngine(model, params, train, damping=1e-2,
                                   solver="cg", mesh=mesh(8), device="cpu")
        tx, ty = train.x[:3], train.y[:3]
        a = base.get_influence_on_test_loss(tx, ty)
        b = shrd.get_influence_on_test_loss(tx, ty)
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-6)

    def test_full_engine_sharded_chunked_hvp_matches(self):
        """Each slot's rows in chunks of hvp_batch / 8 must equal the
        single-device full-batch path."""
        model, params, train = _setup(n=400)
        base = FullInfluenceEngine(model, params, train, damping=1e-2,
                                   solver="cg", device="cpu")
        shrd = FullInfluenceEngine(model, params, train, damping=1e-2,
                                   solver="cg", mesh=mesh(8), hvp_batch=100,
                                   device="cpu")
        assert shrd.hvp_batch % 8 == 0  # rounded to a slot multiple
        tx, ty = train.x[:3], train.y[:3]
        a = base.get_influence_on_test_loss(tx, ty)
        b = shrd.get_influence_on_test_loss(tx, ty)
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-6)

    def test_trailing_rows_dropped(self):
        """``n % ndata`` trailing rows are dropped, as the reference
        does: the influence is over the kept rows, equal to a
        single-device engine over those rows."""
        model, params, train = _setup(n=403)
        shrd = FullInfluenceEngine(model, params, train, damping=1e-2,
                                   solver="cg", mesh=mesh(4), device="cpu")
        assert shrd.num_train == 400
        kept = FullInfluenceEngine(model, params,
                                   RatingDataset(train.x[:400],
                                                 train.y[:400]),
                                   damping=1e-2, solver="cg", device="cpu")
        tx, ty = train.x[:3], train.y[:3]
        np.testing.assert_allclose(shrd.get_influence_on_test_loss(tx, ty),
                                   kept.get_influence_on_test_loss(tx, ty),
                                   rtol=1e-3, atol=1e-6)

    @pytest.mark.parametrize("hvp_batch", [0, 100])
    def test_matches_reference_mesh_engine(self, hvp_batch):
        """Port against the JAX package, both over 8-slot meshes, the
        reference's params carried over: the sharded HVP itself at
        test_torch_full.py's HVP bar (rtol 1e-5 / atol 1e-6), and the CG
        influence at its port-against-reference bar (rtol 5e-3 / atol
        1e-6, both CGs at cg_tol 1e-12: they stop at the same float32
        residual floor, not at the same iterate)."""
        x, y = _data(n=403)
        ref_model = RefMF(20, 16, 4, 1e-3)
        arrays = jax.tree_util.tree_map(
            np.asarray, ref_model.init_params(jax.random.PRNGKey(0)))
        model = MF(20, 16, 4, 1e-3)
        port = FullInfluenceEngine(model,
                                   params_from_numpy(model, arrays, "cpu"),
                                   RatingDataset(x, y), damping=1e-2,
                                   solver="cg", cg_tol=1e-12, mesh=mesh(8),
                                   hvp_batch=hvp_batch, device="cpu")
        ref = RefFull(ref_model, arrays, RefDataset(x, y), damping=1e-2,
                      solver="cg", cg_tol=1e-12, mesh=ref_make_mesh(8),
                      hvp_batch=hvp_batch)
        assert port.num_train == ref.num_train == 400
        assert port.hvp_batch == ref.hvp_batch
        v = np.random.default_rng(1).standard_normal(
            port.num_params).astype(np.float32)
        np.testing.assert_allclose(
            port._hvp(torch.as_tensor(v)).numpy(),
            np.asarray(ref._hvp(jax.numpy.asarray(v))), rtol=1e-5,
            atol=1e-6)
        np.testing.assert_allclose(
            port.get_influence_on_test_loss(x[:3], y[:3]),
            np.asarray(ref.get_influence_on_test_loss(x[:3], y[:3])),
            rtol=5e-3, atol=1e-6)


class TestMeshModule:
    def test_fingerprint(self):
        a, b = mesh(4), mesh(4)
        assert pmesh.mesh_fingerprint(None) is None
        assert pmesh.mesh_fingerprint(a) == pmesh.mesh_fingerprint(b) == (
            ("data",), (4,), (0, 1, 2, 3), (0, 0, 0, 0))
        assert pmesh.mesh_fingerprint(a) != pmesh.mesh_fingerprint(mesh(2))
        with pmesh.virtual_hosts({2: 1, 3: 1}):
            fp = pmesh.mesh_fingerprint(a)
            assert fp[-1] == (0, 0, 1, 1)
            assert pmesh.mesh_hosts(a) == (0, 1)
        assert pmesh.mesh_fingerprint(a)[-1] == (0, 0, 0, 0)

    def test_surviving_mesh_over_hosts(self, monkeypatch):
        m = mesh(8)
        with pmesh.virtual_hosts({i: i // 2 for i in range(8)}):
            new = pmesh.surviving_mesh(m, lost_hosts=[1])
            assert [s.id for s in new.devices.flat] == [0, 1, 4, 5, 6, 7]
            new = pmesh.surviving_mesh(m, unnamed="host")
            assert [s.id for s in new.devices.flat] == [0, 1, 2, 3, 4, 5]
            monkeypatch.setattr(pmesh, "live_device_ids",
                                lambda: frozenset(range(8)) - {2, 3, 5})
            assert pmesh.lost_host_ids(m) == (1,)
            assert pmesh.lost_device_ids(m) == (2, 3, 5)
        # a 2-D mesh keeps whole trailing groups
        two = make_mesh(8, axis_names=("data", "model"), shape=(4, 2),
                        device="cpu")
        new = pmesh.surviving_mesh(two, lost_ids=[3])
        assert new.shape == {"data": 3, "model": 2}
        assert [s.id for s in new.devices.flat] == [0, 1, 2, 4, 5, 6]

    def test_live_device_ids_patched(self, monkeypatch):
        m = mesh(4)
        assert pmesh.lost_device_ids(m) == ()
        monkeypatch.setattr(torch.cuda, "device_count",
                            lambda: (_ for _ in ()).throw(RuntimeError()))
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        assert pmesh.live_device_ids() == frozenset()
        assert pmesh.lost_device_ids(m) == (0, 1, 2, 3)

    def test_cuda_default_and_visible_count(self, monkeypatch):
        with pytest.raises(ValueError, match="virtual"):
            make_mesh(9, device="cpu")
        with pmesh.virtual_devices(2):
            assert mesh(2).devices.size == 2
            with pytest.raises(ValueError, match="only 2"):
                mesh(3)
        assert pmesh.live_device_ids() == frozenset(range(8))
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh(2)
        with pytest.raises(RuntimeError, match="CUDA"):
            InfluenceEngine(*_setup(), mesh=None)

    def test_init_pod_mesh(self):
        """In one process, ``make_mesh`` over the local slots; a process
        count without a coordinator cannot join a group and raises (the
        mesh across processes: ``test_torch_distributed.py``)."""
        assert pmesh.mesh_fingerprint(pmesh.init_pod_mesh(device="cpu")) \
            == pmesh.mesh_fingerprint(mesh(8))
        with pytest.raises(ValueError, match="together"):
            pmesh.init_pod_mesh(device="cpu", num_processes=2)

    def test_mesh_device_must_match(self):
        model, params, train = _setup()
        eng = InfluenceEngine(model, params, train, mesh=mesh(2))
        assert eng.device == torch.device("cpu")
        with pytest.raises(ValueError, match="does not match"):
            pmesh.mesh_device(mesh(2), "cuda")
        with pytest.raises(ValueError, match="'data' axis"):
            InfluenceEngine(model, params, train, device="cpu",
                            mesh=make_mesh(2, axis_names=("model",),
                                           device="cpu"))

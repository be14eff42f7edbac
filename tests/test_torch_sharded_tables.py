"""Row-sharded embedding tables in the port (``fia_tpu_torch.parallel.
sharded``, ``InfluenceEngine(shard_tables=True)``) on the CPU, restating
``tests/test_sharded_tables.py`` over 8 virtual slots.

The contract: a ``shard_tables=True`` engine on a 2-D ``('data',
'model')`` mesh returns scores, iHVPs and test vectors BIT identical
(``torch.equal`` / ``np.array_equal``) to the single-device engine's,
for the flat path and bank hits, and its padded path the replicated
padded engine's bits, while each slot holds only
``padded_rows(n, m) / m`` rows of each table; device-loss recovery
re-places *sharded* tables and never silently re-replicates them while
the survivors fill a ``model`` group.

Port-only cases: the id remap keeps id equality (random ids with
duplicates), and the score stage still runs with sharded tables (the
reference rejects ``kernel='pallas'`` with ``shard_tables``; the port
keeps ``kernel='cuda'``, ROADMAP Queue C). Against the JAX package: the
gather bitwise the reference's, and the sharded flat query at
``test_torch_engine.py``'s bars (rtol 2e-5 / atol 1e-6) of the
reference's sharded engine.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fia_tpu.data.dataset import RatingDataset as RefDataset
from fia_tpu.influence.engine import InfluenceEngine as RefEngine
from fia_tpu.models import MF as RefMF
from fia_tpu.models import NCF as RefNCF
from fia_tpu.parallel import sharded as ref_sharded
from fia_tpu_torch.data.dataset import RatingDataset
from fia_tpu_torch.influence import factor as fbank
from fia_tpu_torch.influence.engine import InfluenceEngine
from fia_tpu_torch.models import MF, NCF, params_from_numpy
from fia_tpu_torch.parallel import mesh as pmesh
from fia_tpu_torch.parallel.sharded import (
    TABLE_PARAMS,
    TABLE_ROW_AXES,
    Placed,
    gather_table_rows,
    make_2d_mesh,
    padded_rows,
    per_device_table_bytes,
    remap,
    shard_model_params,
    sorted_keys,
    table_names,
)
from fia_tpu_torch.utils import compilemon

torch.set_num_threads(2)

FAMILIES = {"mf": (MF, RefMF), "ncf": (NCF, RefNCF)}


@pytest.fixture(autouse=True, scope="module")
def slots():
    with pmesh.virtual_devices(8):
        yield


def mesh2(n=8, mp=2):
    return make_2d_mesh(n, model_parallel=mp, device="cpu")


def _setup(cls=MF, seed=0, n=600, users=23, items=17, k=4):
    rng = np.random.default_rng(seed)
    x = np.stack([rng.integers(0, users, n), rng.integers(0, items, n)],
                 axis=1).astype(np.int32)
    y = rng.integers(1, 6, n).astype(np.float32)
    model = cls(users, items, k, 1e-3)
    params = model.init_params(torch.Generator().manual_seed(seed))
    return model, params, RatingDataset(x, y)


def _engine(model, params, train, **kw):
    kw.setdefault("impl", "flat")
    return InfluenceEngine(model, params, train, damping=1e-3, device="cpu",
                           **kw)


def _bitwise(got, base):
    for t in range(len(base.counts)):
        assert np.array_equal(got.scores_of(t), base.scores_of(t))
    assert np.array_equal(got.counts, base.counts)
    assert np.array_equal(got.ihvp, base.ihvp)
    assert np.array_equal(got.test_grad, base.test_grad)


PTS = np.array([[3, 5], [0, 1], [7, 2], [11, 9], [1, 1], [22, 16], [4, 4]])


class TestMake2dMesh:
    def test_shape_and_axes(self):
        mesh = mesh2(8, 2)
        assert mesh.axis_names == ("data", "model")
        assert mesh.shape["data"] == 4 and mesh.shape["model"] == 2
        assert [s.id for s in mesh.devices.flat] == list(range(8))

    @pytest.mark.parametrize("mp", [3, 5, 7])
    def test_non_divisible_raises(self, mp):
        with pytest.raises(ValueError, match="does not divide"):
            mesh2(8, mp)

    def test_model_parallel_exceeding_devices_raises(self):
        with pytest.raises(ValueError):
            mesh2(4, 8)


class TestShardModelParams:
    @pytest.mark.parametrize("cls", [MF, NCF])
    def test_every_table_row_sharded(self, cls):
        """Each TABLE_PARAMS entry is split along dim 0 over 'model';
        everything else is one replica a physical device."""
        model, params, _ = _setup(cls)
        mesh = mesh2(8, 2)
        placed = shard_model_params(mesh, params, model)
        names = set(TABLE_PARAMS[cls.__name__])
        assert names == set(table_names(model))
        for k, v in placed.items():
            assert isinstance(v, Placed)
            if k in names:
                assert v.axis == "model", k
                assert v.shards[0].shape[0] < v.shape[0], k
                # slot (r, c) holds shard c: the rows [c rl, (c+1) rl)
                for s, sh in zip(mesh.devices.flat, v.shards):
                    c = int(s.id) % 2
                    assert torch.equal(sh, torch.cat(
                        [params[k], params[k].new_zeros(
                            (v.shape[0] - params[k].shape[0],
                             *params[k].shape[1:]))])[
                        c * v.rows_local:(c + 1) * v.rows_local])
            else:
                assert v.axis is None, k
                assert all(sh is v.shards[0] for sh in v.shards)
                assert torch.equal(v.shards[0], params[k])

    def test_non_divisible_rows_padded_to_divisible(self):
        model, params, _ = _setup(users=23, items=17)  # neither % 4 == 0
        placed = shard_model_params(mesh2(8, 4), params, model)
        for name in table_names(model):
            v = placed[name]
            assert v.shape[0] == padded_rows(params[name].shape[0], 4)
            assert v.shape[0] % 4 == 0 and v.axis == "model"
            assert all(sh.shape[0] == v.shape[0] // 4 for sh in v.shards)

    def test_pad_rows_appends_exact_zeros(self):
        model, params, _ = _setup(users=23, items=17)
        placed = shard_model_params(mesh2(8, 4), params, model,
                                    pad_rows=True)
        for name in table_names(model):
            orig = params[name]
            got = torch.cat(placed[name].row_shards())
            assert got.shape[0] == padded_rows(orig.shape[0], 4)
            assert torch.equal(got[: orig.shape[0]], orig)
            assert not torch.any(got[orig.shape[0]:])
        with pytest.raises(ValueError, match="pad_rows"):
            shard_model_params(mesh2(8, 4), params, model, pad_rows=False)

    def test_per_device_table_bytes_shrink(self):
        model, params, _ = _setup(users=64, items=32)
        full = sum(params[n].numel() * 4 for n in table_names(model))
        placed = shard_model_params(mesh2(8, 4), params, model)
        assert per_device_table_bytes(placed, model) == full // 4
        assert per_device_table_bytes(params, model) == full


class TestGatherTableRows:
    @pytest.mark.parametrize("cls", [MF, NCF])
    @pytest.mark.parametrize("mp", [2, 4])
    def test_bitwise_vs_direct_indexing(self, cls, mp):
        model, params, _ = _setup(cls, users=24, items=16)
        mesh = mesh2(8, mp)
        placed = shard_model_params(mesh, params, model)
        ndata = int(mesh.shape["data"])
        rng = np.random.default_rng(3)
        uids = [torch.as_tensor(rng.integers(0, 24, 5), dtype=torch.int32)
                for _ in range(ndata)]
        iids = [torch.as_tensor(rng.integers(0, 16, 5), dtype=torch.int32)
                for _ in range(ndata)]
        rows = gather_table_rows(mesh, model, placed, uids, iids)
        for r in range(ndata):
            for name, rax in zip(table_names(model),
                                 TABLE_ROW_AXES[cls.__name__]):
                ids = uids[r] if rax == "user" else iids[r]
                assert torch.equal(rows[r][name], params[name][ids.long()])

    def test_matches_reference_gather(self):
        """The same ids through the reference's shard_map gather on its
        8 virtual devices: the same bytes."""
        ref_model = RefMF(24, 16, 4, 1e-3)
        arrays = jax.tree_util.tree_map(
            np.asarray, ref_model.init_params(jax.random.PRNGKey(0)))
        model = MF(24, 16, 4, 1e-3)
        params = params_from_numpy(model, arrays, "cpu")
        ref_mesh = ref_sharded.make_2d_mesh(8, model_parallel=2)
        want = ref_sharded.gather_table_rows(
            ref_mesh, ref_model,
            ref_sharded.shard_model_params(ref_mesh, arrays, ref_model),
            *(jnp.asarray(np.random.default_rng(s).integers(
                0, n, (4, 6)).astype(np.int32)) for s, n in ((1, 24),
                                                             (2, 16))))
        ids = [np.random.default_rng(s).integers(0, n, (4, 6)).astype(
            np.int32) for s, n in ((1, 24), (2, 16))]
        mesh = mesh2(8, 2)
        got = gather_table_rows(
            mesh, model, shard_model_params(mesh, params, model),
            *([torch.as_tensor(a[r]) for r in range(4)] for a in ids))
        for name in table_names(model):
            for r in range(4):
                assert got[r][name].numpy().tobytes() == np.asarray(
                    want[name])[r].tobytes()


class TestRemap:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_remap_keeps_id_equality(self, seed):
        """Random ids with many duplicates: two ids are equal exactly
        when their remapped positions are, and the local table read at
        the remapped position is the table's row at the id."""
        rng = np.random.default_rng(seed)
        ids = torch.as_tensor(rng.integers(0, 40, 300), dtype=torch.int32)
        other = torch.as_tensor(rng.integers(0, 40, 80), dtype=torch.int32)
        keys, _ = sorted_keys(torch.cat([ids, other]), other)
        a, b = remap(keys, ids), remap(keys, other)
        assert a.dtype == torch.int32 and int(a.max()) < keys.shape[0]
        assert torch.equal(ids[:, None] == other[None, :],
                           a[:, None] == b[None, :])
        assert torch.equal(ids[:, None] == ids[None, :],
                           a[:, None] == a[None, :])
        table = torch.randn(40, 3)
        local = table[keys.long()]
        assert torch.equal(local[a.long()], table[ids.long()])
        assert torch.equal(remap(keys, ids.long()),
                           a.long())  # the id dtype is kept


class TestShardedEngine:
    @pytest.mark.parametrize("cls", [MF, NCF], ids=["mf", "ncf"])
    @pytest.mark.parametrize("mp", [2, 4, 8])
    def test_flat_query_bitwise_vs_replicated(self, mp, cls):
        model, params, train = _setup(cls)
        base = _engine(model, params, train).query_batch(PTS)
        eng = _engine(model, params, train, mesh=mesh2(8, mp),
                      shard_tables=True)
        assert eng._flat_eligible() and eng._sharded_now()
        _bitwise(eng.query_batch(PTS, pad_to=base.scores.shape[1]), base)
        many = eng.query_many(PTS, batch_queries=3)
        for k, res in enumerate(many):
            want = _engine(model, params, train).query_batch(
                PTS[3 * k: 3 * k + 3])
            _bitwise(res, want)

    def test_tables_resident_sharded(self):
        model, params, train = _setup()
        eng = _engine(model, params, train, mesh=mesh2(8, 4),
                      shard_tables=True)
        full = sum(params[n].numel() * 4 for n in table_names(model))
        assert per_device_table_bytes(eng.params, model) < full
        for name in table_names(model):
            v = eng.params[name]
            rl = padded_rows(params[name].shape[0], 4) // 4
            assert all(sh.shape[0] == rl for sh in v.shards)
        # the host copies and the fingerprint do not see the pad rows
        rep = _engine(model, params, train)
        assert all(eng._params_host[k].shape == rep._params_host[k].shape
                   for k in params)
        assert eng._fingerprint_matches(rep._params_fingerprint())

    def test_shard_tables_requires_model_axis(self):
        model, params, train = _setup()
        with pytest.raises(ValueError, match="model"):
            _engine(model, params, train,
                    mesh=pmesh.make_mesh(8, device="cpu"), shard_tables=True)
        with pytest.raises(ValueError, match="model"):
            _engine(model, params, train, shard_tables=True)

    def test_shard_tables_keeps_the_score_kernel(self, monkeypatch):
        """Divergence from the reference, which rejects ``kernel=
        'pallas'`` with ``shard_tables``: the port's sharded program
        scores through the model family's score entry (the CUDA kernel
        on the card, its plain version here), fed shard-local tables of
        s_pad + t_pad rows."""
        from fia_tpu_torch.influence import kernels as K

        seen = []
        real = K.fused_scores

        def spy(model, variant, params, *args):
            seen.append((variant, tuple(params["P"].shape)))
            return real(model, variant, params, *args)

        monkeypatch.setattr(K, "fused_scores", spy)
        model, params, train = _setup()
        eng = _engine(model, params, train, mesh=mesh2(8, 2),
                      shard_tables=True, kernel="auto")
        eng.query_batch(PTS)
        t_pad, s_pad = eng.flat_geometry(PTS)
        assert seen and all(v == "torch" and p == (s_pad + t_pad, 4)
                            for v, p in seen)

    def test_aot_zero_steady_state_compiles(self):
        model, params, train = _setup()
        eng = _engine(model, params, train, mesh=mesh2(8, 2),
                      shard_tables=True)
        geom = eng.flat_geometry(PTS)
        aot = eng.precompile_flat([geom])
        assert list(geom) in aot["compiled"]
        assert eng._aot_key(*geom)[-2] is True  # the placement is keyed
        eng.query_batch(PTS)
        c0 = compilemon.count()
        eng.query_batch(PTS)
        assert compilemon.count() - c0 == 0

    @pytest.mark.parametrize("cls", [MF, NCF], ids=["mf", "ncf"])
    def test_padded_and_hessians_bitwise_vs_replicated(self, cls):
        """The padded program gathers its per-query rows through the same
        collective and remap: the replicated padded mesh engine's bits;
        ``block_hessians`` the single-device engine's."""
        model, params, train = _setup(cls)
        kw = dict(impl="padded", mesh=mesh2(8, 2))
        got = _engine(model, params, train, shard_tables=True, **kw)
        want = _engine(model, params, train, **kw)
        a, b = got.query_batch(PTS), want.query_batch(PTS)
        assert a._packed.tobytes() == b._packed.tobytes()
        assert a.ihvp.tobytes() == b.ihvp.tobytes()
        assert a.test_grad.tobytes() == b.test_grad.tobytes()
        assert np.array_equal(
            _engine(model, params, train, mesh=mesh2(8, 4),
                    shard_tables=True).block_hessians(PTS),
            _engine(model, params, train).block_hessians(PTS))

    @pytest.mark.parametrize("family", sorted(FAMILIES))
    def test_matches_reference_sharded_engine(self, family):
        """The port's sharded engine against the reference's on its 8
        virtual devices, the reference's params carried over, at
        test_torch_engine.py's flat bars on its input (rtol 2e-5 / atol
        1e-6; the last query's user and item have no rows of their
        own)."""
        Port, Ref = FAMILIES[family]
        U, I = 24, 18
        rng = np.random.default_rng(0)
        x = np.stack([rng.integers(0, U - 1, 400),
                      rng.integers(0, I - 1, 400)], axis=1).astype(np.int32)
        y = rng.integers(1, 6, 400).astype(np.float32)
        pts = np.concatenate([x[np.random.default_rng(7).choice(
            400, size=11, replace=False)].astype(np.int64), [[U - 1, I - 1]]])
        model_r = Ref(U, I, 4, 1e-3)
        arrays = jax.tree_util.tree_map(
            np.asarray, model_r.init_params(jax.random.PRNGKey(0)))
        model = Port(U, I, 4, 1e-3)
        port = _engine(model, params_from_numpy(model, arrays, "cpu"),
                       RatingDataset(x, y), mesh=mesh2(8, 2),
                       shard_tables=True)
        ref = RefEngine(model_r, arrays, RefDataset(x, y), damping=1e-3,
                        impl="flat",
                        mesh=ref_sharded.make_2d_mesh(8, model_parallel=2),
                        shard_tables=True)
        got, want = port.query_batch(pts), ref.query_batch(pts)
        assert np.array_equal(got.counts, want.counts)
        for t in range(len(pts)):
            np.testing.assert_allclose(got.scores_of(t), want.scores_of(t),
                                       rtol=2e-5, atol=1e-6)
        np.testing.assert_allclose(got.ihvp, want.ihvp, rtol=2e-5,
                                   atol=1e-6)


class TestShardedRecovery:
    def test_surviving_mesh_preserves_model_axis(self):
        m = pmesh.surviving_mesh(mesh2(8, 2))  # 7 survivors: 3 groups of 2
        assert tuple(int(m.shape[a]) for a in m.axis_names) == (3, 2)

    def test_surviving_mesh_collapses_below_one_group(self):
        m = pmesh.surviving_mesh(mesh2(2, 2))  # 1 survivor < mp
        assert tuple(int(m.shape[a]) for a in m.axis_names) == (1, 1)

    def test_surviving_mesh_1d_unchanged(self):
        m = pmesh.surviving_mesh(pmesh.make_mesh(8, device="cpu"))
        assert tuple(int(m.shape[a]) for a in m.axis_names) == (7,)

    def test_rebuild_preserves_sharded_placement(self):
        """Device loss on a shard_tables engine re-places *sharded*
        tables on the shrunk mesh, bitwise the single-device engine."""
        model, params, train = _setup()
        base = _engine(model, params, train).query_batch(PTS)
        mesh = mesh2(8, 2)
        eng = _engine(model, params, train, mesh=mesh, shard_tables=True)
        eng.query_batch(PTS)
        eng.rebuild_mesh(pmesh.surviving_mesh(mesh))
        assert eng._sharded_now()
        assert isinstance(eng.params["P"], Placed)
        full = sum(params[n].numel() * 4 for n in table_names(model))
        assert per_device_table_bytes(eng.params, model) < full
        _bitwise(eng.query_batch(PTS, pad_to=base.scores.shape[1]), base)

    def test_rebuild_to_trivial_model_axis_degrades_replicated(self):
        model, params, train = _setup()
        base = _engine(model, params, train).query_batch(PTS)
        eng = _engine(model, params, train, mesh=mesh2(2, 2),
                      shard_tables=True)
        eng.rebuild_mesh(pmesh.surviving_mesh(eng.mesh))  # -> (1, 1)
        assert not eng._sharded_now()
        assert isinstance(eng.params["P"], torch.Tensor)
        _bitwise(eng.query_batch(PTS, pad_to=base.scores.shape[1]), base)


    def test_service_shrink_keeps_tables_sharded(self):
        """A service on a (4, 2) sharded mesh: an injected device loss at
        batch 1 shrinks it to (3, 2), the tables stay row-sharded, and
        every answer is the single-device service's bits."""
        from fia_tpu_torch.reliability import inject, taxonomy
        from fia_tpu_torch.serve import (InfluenceService, Request,
                                         ServeConfig)

        model, params, train = _setup()
        pts = np.unique(train.x, axis=0)[:8].astype(np.int64)

        def run(eng, **cfg):
            svc = InfluenceService(engine=eng, config=ServeConfig(
                max_batch=3, max_queue=64, disk_cache=False, **cfg))
            return svc, svc.run([Request(int(u), int(i), id=f"q{n}")
                                 for n, (u, i) in enumerate(pts)])

        _, want = run(_engine(model, params, train))
        mesh = mesh2(8, 2)
        with inject.active(inject.Fault("serve.dispatch", at=1,
                                        kind=taxonomy.DEVICE_LOST),
                           strict=True, validate=True):
            svc, got = run(_engine(model, params, train, mesh=mesh,
                                   shard_tables=True), mesh=mesh)
        assert all(r.ok for r in got)
        for a, b in zip(got, want):
            assert np.asarray(a.scores).tobytes() == np.asarray(
                b.scores).tobytes()
        assert svc.mesh.shape == {"data": 3, "model": 2}
        eng = svc._peek_engine()
        assert eng._sharded_now() and isinstance(eng.params["P"], Placed)
        assert svc.rollup()["device_loss_recoveries"] == 1


class TestShardedBank:
    def test_bank_hits_bitwise_vs_replicated(self, tmp_path):
        model, params, train = _setup(users=30, items=20)

        def eng_of(**kw):
            return InfluenceEngine(
                model, params, train, damping=1e-3, cache_dir=str(tmp_path),
                model_name="tshard", lissa_depth=30, device="cpu", **kw)

        builder = eng_of(solver="direct")
        pairs = fbank.select_hot_pairs(builder.index, max_entries=16,
                                       top_users=5, top_items=5)
        bank = fbank.build_bank(builder, pairs, batch_queries=16)
        fp = fbank.bank_fingerprint("tshard", model.block_size, 1e-3,
                                    *builder._train_host)
        fbank.publish_bank(bank, builder.factor_bank_path(), fp)

        ref = eng_of(solver="precomputed")
        ref.ensure_factor_bank()
        pts = np.asarray(bank.pairs[:8], np.int64)
        base = ref.query_batch(pts)
        assert ref.bank_stats()["hits"] == len(pts)

        eng = eng_of(solver="precomputed", mesh=mesh2(8, 2),
                     shard_tables=True)
        assert eng.ensure_factor_bank() == len(bank)
        got = eng.query_batch(pts, pad_to=base.scores.shape[1])
        assert eng.bank_stats()["hits"] == len(pts)
        _bitwise(got, base)
        # a miss goes to the delegate, which inherits the placement
        miss = eng._miss_delegate()
        assert miss._sharded_now() and miss.mesh is eng.mesh


    @pytest.mark.parametrize("cls", [MF, NCF], ids=["mf", "ncf"])
    def test_autodiff_bank_on_sharded_mesh(self, tmp_path, cls):
        """``hessian_mode='autodiff'`` materialises its block Hessians
        through the shard-local tables: on a (4, 2) sharded mesh they are
        the single-device engine's bits, the bank built from them loads,
        and its hits are the replicated mesh engine's."""
        model, params, train = _setup(cls, users=30, items=20)

        def eng_of(**kw):
            return InfluenceEngine(
                model, params, train, damping=1e-3, cache_dir=str(tmp_path),
                model_name="tauto", hessian_mode="autodiff", lissa_depth=30,
                device="cpu", **kw)

        one = eng_of(solver="direct")
        pairs = fbank.select_hot_pairs(one.index, max_entries=16,
                                       top_users=5, top_items=5)
        sharded = eng_of(solver="direct", mesh=mesh2(8, 2), shard_tables=True)
        assert np.array_equal(sharded.block_hessians(pairs, batch_queries=5),
                              one.block_hessians(pairs, batch_queries=5))
        bank = fbank.build_bank(sharded, pairs, batch_queries=16)
        fp = fbank.bank_fingerprint("tauto", model.block_size, 1e-3,
                                    *one._train_host)
        fbank.publish_bank(bank, one.factor_bank_path(), fp)

        ref = eng_of(solver="precomputed", mesh=mesh2(8, 2))
        eng = eng_of(solver="precomputed", mesh=mesh2(8, 2),
                     shard_tables=True)
        assert eng.ensure_factor_bank() == ref.ensure_factor_bank() \
            == len(bank)
        pts = np.asarray(bank.pairs[:8], np.int64)
        base = ref.query_batch(pts)
        got = eng.query_batch(pts, pad_to=base.scores.shape[1])
        assert eng.bank_stats()["hits"] == ref.bank_stats()["hits"]
        _bitwise(got, base)


class TestScaleGenerator:
    def test_deterministic_and_in_range(self):
        from fia_tpu_torch.data.synthetic import SCALE_TIERS, synthesize_scale

        assert set(SCALE_TIERS) == {"100k", "1m", "5m", "10m"}
        a = synthesize_scale(1000, 200, 5000, seed=3)
        b = synthesize_scale(1000, 200, 5000, seed=3)
        np.testing.assert_array_equal(a.x, b.x)
        np.testing.assert_array_equal(a.y, b.y)
        assert a.x[:, 0].max() < 1000 and a.x[:, 1].max() < 200
        assert a.y.min() >= 1.0 and a.y.max() <= 5.0

    def test_item_popularity_skewed(self):
        from fia_tpu_torch.data.synthetic import synthesize_scale

        d = synthesize_scale(1000, 200, 20000, seed=0)
        counts = np.bincount(d.x[:, 1], minlength=200)
        top = np.sort(counts)[::-1]
        assert top[:10].sum() > 0.15 * counts.sum()

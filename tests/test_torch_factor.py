"""The port's factor bank (``influence/factor.py``, the engine's
``precomputed`` rung) on the CPU.

Restates ``tests/test_factor.py`` port against port, on its setup (MF,
U = 30, I = 20, k = 4, 600 rows, the reference's params carried across):
the ladder's ``resolve_solver`` semantics; bank hits at Spearman ≥ 0.999
against the direct solve; misses, a mixed batch's misses and a torn bank
bitwise the bank-less ``sampled`` engine; the whole ladder walked under
injected NaN payloads; a refresh dropping exactly the touched entries; a
stale entry never served. Against the reference: ``factorize`` (kinds
equal, factors at a stated rtol), ``dep_crcs`` byte for byte, and a bank
published by either package loading and serving in the other.
"""

import os

import jax
import numpy as np
import pytest
import torch

from fia_tpu.data.dataset import RatingDataset as RefDataset
from fia_tpu.influence import factor as ref_fbank
from fia_tpu.influence.engine import InfluenceEngine as RefEngine
from fia_tpu.models import MF as RefMF
from fia_tpu.models import NCF as RefNCF
from fia_tpu_torch.data.dataset import RatingDataset
from fia_tpu_torch.eval.metrics import spearman
from fia_tpu_torch.influence import factor as fbank
from fia_tpu_torch.influence.engine import InfluenceEngine
from fia_tpu_torch.influence.full import FullInfluenceEngine
from fia_tpu_torch.models import MF, NCF, params_from_numpy
from fia_tpu_torch.reliability import inject
from fia_tpu_torch.reliability import policy as rpolicy
from fia_tpu_torch.reliability import sites

torch.set_num_threads(2)

U, I, K = 30, 20, 4
WD, DAMP = 1e-2, 1e-3
NAME = "tfac"
DEPTH = 30  # keeps the tiny random-init blocks inside LiSSA's horizon
# factorize against the reference's on the same Hessians: a float32
# Cholesky (or eigh) of blocks at cond <= ~1e3 in two libraries
FACTOR_RTOL, FACTOR_ATOL = 1e-4, 1e-5


def _setup(seed=0, n=600, cls=MF, ref_cls=RefMF):
    rng = np.random.default_rng(seed)
    x = np.stack([rng.integers(0, U, n), rng.integers(0, I, n)],
                 axis=1).astype(np.int32)
    y = rng.integers(1, 6, n).astype(np.float32)
    ref_model = ref_cls(U, I, K, WD)
    arrays = jax.tree_util.tree_map(
        np.asarray, ref_model.init_params(jax.random.PRNGKey(seed)))
    model = cls(U, I, K, WD)
    return model, params_from_numpy(model, arrays, "cpu"), x, y, ref_model, \
        arrays


def _engine(model, params, x, y, tmp_path=None, solver="precomputed"):
    return InfluenceEngine(
        model, params, RatingDataset(x, y), damping=DAMP, solver=solver,
        cache_dir=str(tmp_path) if tmp_path is not None else None,
        model_name=NAME, lissa_depth=DEPTH, device="cpu",
    )


def _publish(tmp_path, model, params, x, y, entries=24):
    builder = _engine(model, params, x, y, tmp_path, solver="direct")
    pairs = fbank.select_hot_pairs(builder.index, max_entries=entries,
                                   top_users=6, top_items=6)
    bank = fbank.build_bank(builder, pairs, batch_queries=entries)
    fp = fbank.bank_fingerprint(NAME, model.block_size, DAMP,
                                *builder._train_host)
    path = builder.factor_bank_path()
    fbank.publish_bank(bank, path, fp)
    return builder, bank, path


def _miss_pairs(x, bank, k=3):
    banked = {tuple(p) for p in bank.pairs.tolist()}
    out = [(int(u), int(i)) for u, i in zip(x[:, 0], x[:, 1])
           if (int(u), int(i)) not in banked]
    assert len(out) >= k
    return np.asarray(out[:k], np.int64)


@pytest.fixture()
def setup():
    return _setup()


class TestResolveSolver:
    def test_unknown_name_bottoms_out_at_most_robust(self):
        assert rpolicy.resolve_solver("frobnicate") == "direct"
        assert (rpolicy.resolve_solver("frobnicate",
                                       supported=rpolicy.FULL_SOLVERS)
                == "cg")

    def test_none_resolves_to_default(self):
        assert rpolicy.resolve_solver(None, default="lissa") == "lissa"

    def test_precomputed_on_full_engine_degrades_to_lissa(self):
        assert (rpolicy.resolve_solver("precomputed",
                                       supported=rpolicy.FULL_SOLVERS)
                == "lissa")

    def test_full_engine_ctor_rejects_precomputed(self, setup):
        model, params, x, y, *_ = setup
        with pytest.raises(ValueError, match="precomputed"):
            FullInfluenceEngine(model, params, RatingDataset(x, y),
                                damping=DAMP, solver="precomputed",
                                device="cpu")


class TestFactorBankServing:
    def test_hit_path_spearman_vs_direct(self, tmp_path, setup):
        model, params, x, y, *_ = setup
        _, bank, _ = _publish(tmp_path, model, params, x, y)
        eng = _engine(model, params, x, y, tmp_path)
        assert eng.ensure_factor_bank() == len(bank)
        pts = np.asarray(bank.pairs[:16], np.int64)
        res = eng.query_batch(pts)
        st = eng.bank_stats()
        assert st["hits"] == len(pts) and st["misses"] == 0
        res_ref = _engine(model, params, x, y, solver="direct").query_batch(pts)
        assert np.array_equal(res.related_idx[res.related_mask],
                              res_ref.related_idx[res_ref.related_mask])
        for t in range(len(pts)):
            a, b = res.scores_of(t), res_ref.scores_of(t)
            if len(a) > 1 and (np.std(a) > 0 or np.std(b) > 0):
                assert spearman(a, b) >= 0.999

    def test_hit_alone_equals_hit_in_batch(self, tmp_path, setup):
        model, params, x, y, *_ = setup
        _, bank, _ = _publish(tmp_path, model, params, x, y)
        eng = _engine(model, params, x, y, tmp_path)
        pts = np.asarray(bank.pairs[:9], np.int64)
        res = eng.query_batch(pts)
        for t in range(len(pts)):
            solo = eng.query_batch(pts[t:t + 1])
            assert solo.scores_of(0).tobytes() == res.scores_of(t).tobytes()

    def test_miss_falls_through_bitwise(self, tmp_path, setup):
        model, params, x, y, *_ = setup
        _, bank, _ = _publish(tmp_path, model, params, x, y)
        eng = _engine(model, params, x, y, tmp_path)
        eng.ensure_factor_bank()
        miss = _miss_pairs(x, bank)
        res = eng.query_batch(miss)
        st = eng.bank_stats()
        assert st["misses"] == len(miss) and st["hits"] == 0
        # the miss rung is the ladder's next engine verbatim: sampled
        res_ref = _engine(model, params, x, y,
                          solver="sampled").query_batch(miss)
        for t in range(len(miss)):
            assert np.array_equal(res.scores_of(t), res_ref.scores_of(t))
        assert np.array_equal(res.ihvp, res_ref.ihvp)

    def test_mixed_batch_partitions_and_merges(self, tmp_path, setup):
        model, params, x, y, *_ = setup
        _, bank, _ = _publish(tmp_path, model, params, x, y)
        eng = _engine(model, params, x, y, tmp_path)
        eng.ensure_factor_bank()
        hit = np.asarray(bank.pairs[:3], np.int64)
        miss = _miss_pairs(x, bank)
        mixed = np.concatenate([miss[:1], hit[:2], miss[1:], hit[2:]])
        res = eng.query_batch(mixed)
        st = eng.bank_stats()
        assert st["hits"] == 3 and st["misses"] == 3
        hit_pos = [t for t, p in enumerate(mixed.tolist())
                   if eng.bank_contains(*p)]
        miss_pos = [t for t in range(len(mixed)) if t not in hit_pos]
        assert len(hit_pos) == 3 and len(miss_pos) == 3
        bank_eng = _engine(model, params, x, y, tmp_path)
        bank_eng.ensure_factor_bank()
        res_hit = bank_eng.query_batch(mixed[hit_pos])
        assert bank_eng.bank_stats()["hits"] == len(hit_pos)
        res_miss = _engine(model, params, x, y,
                           solver="sampled").query_batch(mixed[miss_pos])
        for k, t in enumerate(hit_pos):
            assert np.array_equal(res.scores_of(t), res_hit.scores_of(k))
        for k, t in enumerate(miss_pos):
            assert np.array_equal(res.scores_of(t), res_miss.scores_of(k))
        assert res.approx and res.err_bound is not None
        assert np.all(res.err_bound[hit_pos] == 0.0)

    def test_fallback_chain_precomputed_to_direct(self, tmp_path, setup):
        """Injected NaN payloads at every rung walk the whole ladder
        precomputed -> sampled -> lissa -> cg -> direct, ending finite."""
        model, params, x, y, *_ = setup
        _, bank, _ = _publish(tmp_path, model, params, x, y)
        eng = _engine(model, params, x, y, tmp_path)
        eng.ensure_factor_bank()
        pts = np.asarray(bank.pairs[:4], np.int64)
        walked = []
        real_next = rpolicy.next_solver

        def spy(current, *a, **kw):
            nxt = real_next(current, *a, **kw)
            walked.append((current, nxt))
            return nxt

        faults = [inject.Fault(site=sites.ENGINE_SOLVE, at=k, kind="nan")
                  for k in range(4)]
        with inject.active(*faults):
            try:
                rpolicy.next_solver = spy
                res = eng.query_batch(pts, pad_to=128)
            finally:
                rpolicy.next_solver = real_next
        assert eng.solver == "direct"
        assert [w[0] for w in walked] == ["precomputed", "sampled", "lissa",
                                          "cg"]
        assert np.isfinite(res.ihvp).all()
        res_ref = _engine(model, params, x, y,
                          solver="direct").query_batch(pts, pad_to=128)
        for t in range(len(pts)):
            assert np.array_equal(res.scores_of(t), res_ref.scores_of(t))

    def test_torn_bank_quarantines_and_falls_through(self, tmp_path, setup):
        model, params, x, y, *_ = setup
        _, bank, path = _publish(tmp_path, model, params, x, y)
        with open(path, "r+b") as fh:
            fh.seek(max(os.path.getsize(path) // 2, 1))
            fh.write(b"\xde\xad\xbe\xef")
        eng = _engine(model, params, x, y, tmp_path)
        assert eng.ensure_factor_bank() == 0
        assert os.path.exists(path + ".corrupt")
        pts = np.asarray(bank.pairs[:3], np.int64)
        res = eng.query_batch(pts)
        res_ref = _engine(model, params, x, y,
                          solver="sampled").query_batch(pts)
        for t in range(len(pts)):
            assert np.array_equal(res.scores_of(t), res_ref.scores_of(t))

    def test_unload_resets(self, tmp_path, setup):
        model, params, x, y, *_ = setup
        _, bank, _ = _publish(tmp_path, model, params, x, y)
        eng = _engine(model, params, x, y, tmp_path)
        eng.query_batch(np.asarray(bank.pairs[:2], np.int64))
        assert eng.bank_stats()["hits"] == 2
        eng.unload_factor_bank()
        assert eng.bank_stats() == {"entries": 0, "hits": 0, "misses": 0,
                                    "dropped_stale": 0}
        assert eng.ensure_factor_bank() == len(bank)


class TestSurgicalInvalidation:
    @staticmethod
    def _perturbed(params, u0):
        new = {k: v.clone() for k, v in params.items()}
        new["P"][u0] += 0.125
        return new

    @staticmethod
    def _stale_mask(bank, index, x, u0):
        return np.asarray([
            int(u) == u0
            or u0 in x[np.asarray(index.rows_of_item(int(i))), 0]
            for u, i in bank.pairs.tolist()
        ])

    def test_refresh_drops_only_touched_entries(self, tmp_path, setup):
        model, params, x, y, *_ = setup
        builder, bank, path = _publish(tmp_path, model, params, x, y)
        u0 = int(bank.pairs[0, 0])
        stale = self._stale_mask(bank, builder.index, x, u0)
        touched = int(stale.sum())
        assert 0 < touched < len(bank)
        new_params = self._perturbed(params, u0)
        out = fbank.refresh_bank(model, new_params, *builder._train_host,
                                 builder.index, DAMP, path, NAME)
        assert out == {"kept": len(bank) - touched, "dropped": touched}
        eng = _engine(model, new_params, x, y, tmp_path)
        assert eng.ensure_factor_bank() == out["kept"]
        assert eng.bank_stats()["dropped_stale"] == 0
        assert not eng.bank_contains(u0, int(bank.pairs[0, 1]))
        kept = np.asarray(bank.pairs[~stale][:6], np.int64)
        res = eng.query_batch(kept)
        assert eng.bank_stats()["hits"] == len(kept)
        res_ref = _engine(model, new_params, x, y,
                          solver="direct").query_batch(kept)
        for t in range(len(kept)):
            a, b = res.scores_of(t), res_ref.scores_of(t)
            if len(a) > 1 and (np.std(a) > 0 or np.std(b) > 0):
                assert spearman(a, b) >= 0.999

    def test_stale_bank_never_served_without_refresh(self, tmp_path, setup):
        model, params, x, y, *_ = setup
        builder, bank, _ = _publish(tmp_path, model, params, x, y)
        u0 = int(bank.pairs[0, 0])
        touched = int(self._stale_mask(bank, builder.index, x, u0).sum())
        assert 0 < touched < len(bank)
        new_params = self._perturbed(params, u0)
        eng = _engine(model, new_params, x, y, tmp_path)
        assert eng.ensure_factor_bank() == len(bank) - touched
        assert eng.bank_stats()["dropped_stale"] == touched
        assert not eng.bank_contains(u0, int(bank.pairs[0, 1]))
        pts = np.asarray([bank.pairs[0]], np.int64)
        res = eng.query_batch(pts)
        assert eng.bank_stats()["misses"] == 1
        ladder = _engine(model, new_params, x, y, solver="sampled")
        assert np.array_equal(res.scores_of(0),
                              ladder.query_batch(pts).scores_of(0))


# -- against the reference -------------------------------------------------
@pytest.mark.parametrize("family", ["mf", "ncf"])
def test_dep_crcs_equal_reference(family):
    cls, ref_cls = (MF, RefMF) if family == "mf" else (NCF, RefNCF)
    model, params, x, y, ref_model, arrays = _setup(cls=cls, ref_cls=ref_cls)
    eng = _engine(model, params, x, y, solver="direct")
    pairs = fbank.select_hot_pairs(eng.index, 40, 8, 8)
    want_pairs = ref_fbank.select_hot_pairs(eng.index, 40, 8, 8)
    assert np.array_equal(pairs, want_pairs)
    got = fbank.dep_crcs(model, params, x, y, eng.index, pairs, DAMP)
    want = ref_fbank.dep_crcs(ref_model, arrays, x, y, eng.index, pairs, DAMP)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


def test_keystr_names_nested():
    tree = {"b": np.zeros(2), "a": {"y": np.ones(1), "x": np.zeros(3)}}
    got = [n for n, _ in fbank._leaves_with_paths(tree)]
    want = [jax.tree_util.keystr(p)
            for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]
    assert got == want == ["['a']['x']", "['a']['y']", "['b']"]


@pytest.mark.parametrize("polish", [False, True])
def test_factorize_matches_reference(polish):
    rng = np.random.default_rng(3)
    d = 10
    A = rng.standard_normal((6, d, d)).astype(np.float32)
    H = np.einsum("nij,nkj->nik", A, A) + 0.1 * np.eye(d, dtype=np.float32)
    # an indefinite block and a singular one take the eigh fallback
    H[4] = np.diag(np.linspace(-2.0, 3.0, d)).astype(np.float32)
    H[5] = np.zeros((d, d), np.float32)
    H[5, 0, 0] = 1.0
    kind, fac = fbank.factorize(H, schulz_polish=polish)
    rkind, rfac = ref_fbank.factorize(H, schulz_polish=polish)
    assert np.array_equal(kind, rkind)
    assert kind.tolist() == [0, 0, 0, 0, 1, 1]
    np.testing.assert_allclose(fac, rfac, rtol=FACTOR_RTOL,
                               atol=FACTOR_ATOL * np.abs(rfac).max())


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_bank_loads_across_packages(tmp_path, writer):
    model, params, x, y, ref_model, arrays = _setup()
    port = _engine(model, params, x, y, tmp_path)
    ref = RefEngine(ref_model, arrays, RefDataset(x, y), damping=DAMP,
                    solver="precomputed", cache_dir=str(tmp_path),
                    model_name=NAME, lissa_depth=DEPTH)
    pairs = fbank.select_hot_pairs(port.index, 24, 6, 6)
    if writer == "reference":
        bank = ref_fbank.build_bank(ref, pairs, batch_queries=24)
        ref_fbank.publish_bank(bank, ref.factor_bank_path(),
                               ref_fbank.bank_fingerprint(
                                   NAME, K * 2 + 2, DAMP, x, y))
        reader = port
    else:
        bank = fbank.build_bank(port, pairs, batch_queries=24)
        fbank.publish_bank(bank, port.factor_bank_path(),
                           fbank.bank_fingerprint(NAME, K * 2 + 2, DAMP, x, y))
        reader = ref
    assert reader.ensure_factor_bank() == len(pairs)
    assert reader.bank_stats()["dropped_stale"] == 0
    pts = np.asarray(pairs[:8], np.int64)
    res = reader.query_batch(pts)
    assert reader.bank_stats()["hits"] == len(pts)
    direct = _engine(model, params, x, y, solver="direct").query_batch(pts)
    for t in range(len(pts)):
        a, b = res.scores_of(t), direct.scores_of(t)
        if len(a) > 1 and (np.std(a) > 0 or np.std(b) > 0):
            assert spearman(a, b) >= 0.999

"""The fused row-feature table (``InfluenceEngine(row_features="on")``)
and the models' row hooks, against the reference's (``fia_tpu``).

Restates ``tests/test_influence.py::test_row_feature_table_is_inert``
port against port, MF and NCF: the engine with the table answers the
bits of the engine without it (counts, iHVPs, test vectors, scores),
on the direct path, the sampled rung (the same sample weights), a bank
hit, after ``FIAModel.apply_updates`` / ``apply_removal`` (the table is
rebuilt from the new params) and after ``_reset_device_state``. The
port's ``on`` is held to the reference's ``on`` at rtol 2e-5 / atol
1e-6; each hook (``build_row_features``, ``grads_from_row_features``,
``grads_from_rows``) to the reference's on the same params, ids exactly
and the rest at rtol 1e-5 / atol 1e-6; and the table's gate to the
reference's ``_want_row_features`` on the same attributes, ML-1M's and
ML-20M's sizes included.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fia_tpu.data.dataset import RatingDataset as RefDataset
from fia_tpu.influence.engine import InfluenceEngine as RefEngine
from fia_tpu.models import MF as RefMF
from fia_tpu.models import NCF as RefNCF
from fia_tpu_torch.api import FIAModel
from fia_tpu_torch.data.dataset import RatingDataset
from fia_tpu_torch.influence import factor as fbank
from fia_tpu_torch.influence.engine import InfluenceEngine
from fia_tpu_torch.models import MF, NCF, params_from_numpy
from fia_tpu_torch.parallel.sharded import TABLE_PARAMS

torch.set_num_threads(2)

U, I, K, N = 30, 24, 8, 900
DAMP = 1e-3
RTOL, ATOL = 2e-5, 1e-6
HOOK_RTOL = 1e-5
FAMILIES = {"mf": (MF, RefMF), "ncf": (NCF, RefNCF)}


def _data(seed=0):
    rng = np.random.default_rng(seed)
    x = np.stack([rng.integers(0, U, N), rng.integers(0, I, N)],
                 axis=1).astype(np.int32)
    y = rng.integers(1, 6, N).astype(np.float32)
    return x, y


def _setup(family, seed=0):
    cls, ref_cls = FAMILIES[family]
    x, y = _data(seed)
    ref_model = ref_cls(U, I, K, 1e-3)
    arrays = jax.tree_util.tree_map(
        np.asarray, ref_model.init_params(jax.random.PRNGKey(seed)))
    model = cls(U, I, K, 1e-3)
    return model, params_from_numpy(model, arrays, "cpu"), x, y, \
        ref_model, arrays


def _points(x):
    # held-out-like pairs and two train pairs (rows with a = b = 1)
    return np.concatenate([np.array([[3, 5], [0, 1], [7, 2], [29, 23]]),
                           x[:2]]).astype(np.int64)


def _engines(model, params, x, y, **kw):
    train = RatingDataset(x, y)
    on = InfluenceEngine(model, params, train, damping=DAMP,
                         row_features="on", device="cpu", **kw)
    off = InfluenceEngine(model, params, train, damping=DAMP,
                          row_features="off", device="cpu", **kw)
    assert on._rowfeat is not None and off._rowfeat is None
    return on, off


def _same(a, b, sampled: bool = False) -> None:
    assert np.array_equal(a.counts, b.counts)
    assert a._packed.tobytes() == b._packed.tobytes()
    assert a.ihvp.tobytes() == b.ihvp.tobytes()
    assert a.test_grad.tobytes() == b.test_grad.tobytes()
    if sampled:
        assert a.err_bound.tobytes() == b.err_bound.tobytes()


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_row_feature_table_is_inert(family):
    """``on`` is bitwise ``off`` (a query pair present in train too: the
    a·b cross-term rows), and within rtol 2e-5 of the reference's
    ``on``."""
    model, params, x, y, ref_model, arrays = _setup(family)
    pts = _points(x)
    on, off = _engines(model, params, x, y)
    assert on._rowfeat.shape == (N, model.row_feature_dim)
    r_on, r_off = on.query_batch(pts), off.query_batch(pts)
    _same(r_on, r_off)
    ref = RefEngine(ref_model, arrays, RefDataset(x, y), damping=DAMP,
                    impl="flat", row_features="on")
    assert ref._rowfeat is not None
    want = ref.query_batch(pts)
    assert np.array_equal(r_on.counts, want.counts)
    np.testing.assert_allclose(r_on.ihvp, want.ihvp, rtol=RTOL, atol=ATOL)
    for t in range(len(pts)):
        assert np.array_equal(r_on.related_of(t), want.related_of(t))
        np.testing.assert_allclose(r_on.scores_of(t), want.scores_of(t),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_hooks_match_reference(family):
    model, params, x, y, ref_model, arrays = _setup(family)
    assert model.row_feature_dim == ref_model.row_feature_dim
    tx, ty = torch.as_tensor(x), torch.as_tensor(y)
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    feat = model.build_row_features(params, tx, ty).numpy()
    want = np.asarray(ref_model.build_row_features(arrays, jx, jy))
    assert feat.shape == want.shape == (N, model.row_feature_dim)
    np.testing.assert_array_equal(feat[:, -2:], want[:, -2:])  # the ids
    np.testing.assert_allclose(feat[:, :-2], want[:, :-2], rtol=HOOK_RTOL,
                               atol=ATOL)
    # per-row query ids (the flat layout) and a scalar query pair
    qu = np.roll(x[:, 0], 3)
    qi = x[:, 1].copy()
    for u, i in ((torch.as_tensor(qu), torch.as_tensor(qi)),
                 (torch.tensor(x[0, 0]), torch.tensor(x[0, 1]))):
        got = model.grads_from_row_features(torch.as_tensor(want.copy()), u,
                                            i)
        ref = ref_model.grads_from_row_features(
            jnp.asarray(want), jnp.asarray(u.numpy()), jnp.asarray(i.numpy()))
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       rtol=HOOK_RTOL, atol=ATOL)
        # the table's arithmetic is the closed-form hook's: the same bits
        g, e, ma, mb = model.grads_from_row_features(torch.as_tensor(feat),
                                                     u, i)
        # the score kernels take each operand as a flat array
        assert all(x.is_contiguous() for x in (g, e, ma, mb))
        assert torch.equal(g, model.block_row_grads(params, u, i, tx))
        assert torch.equal(e, model.row_predict(params, tx) - ty)
    names = TABLE_PARAMS[type(model).__name__]
    axes = [0 if n in ("P", "bu", "P_mlp", "P_gmf") else 1 for n in names]
    rows = {n: params[n][tx[:, a].long()] for n, a in zip(names, axes)}
    u, i = torch.as_tensor(qu), torch.as_tensor(qi)
    g, e = model.grads_from_rows(params, rows, tx, ty, u, i)
    assert torch.equal(g, model.block_row_grads(params, u, i, tx))
    assert torch.equal(e, model.row_predict(params, tx) - ty)
    rg, re = ref_model.grads_from_rows(
        arrays, {n: np.asarray(r) for n, r in rows.items()}, jx, jy,
        jnp.asarray(qu), jnp.asarray(qi))
    np.testing.assert_allclose(g.numpy(), np.asarray(rg), rtol=HOOK_RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(e.numpy(), np.asarray(re), rtol=HOOK_RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_table_built_in_steps_holds_the_same_bits(family, monkeypatch):
    """A table built in steps of 2^21 rows (here: steps of 7) holds the
    bits of one built whole."""
    model, params, x, y, *_ = _setup(family)
    on, _ = _engines(model, params, x, y)
    whole = on._rowfeat.clone()
    calls = []
    build = model.build_row_features

    def spy(p, bx, by):
        calls.append(len(bx))
        return build(p, bx, by)

    monkeypatch.setattr(model, "build_row_features", spy)
    feat = on._build_row_features(on.params, on.train_x, on.train_y)
    assert calls == [N] and torch.equal(feat, whole)
    parts = [spy(on.params, on.train_x[s: s + 7], on.train_y[s: s + 7])
             for s in range(0, N, 7)]
    assert torch.equal(torch.cat(parts), whole)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_sampled_rung_on_equals_off(family):
    model, params, x, y, *_ = _setup(family)
    on, off = _engines(model, params, x, y, solver="sampled", sampled_cap=8)
    pts = _points(x)
    _same(on.query_batch(pts), off.query_batch(pts), sampled=True)
    assert on.sampled_stats()["queries"] == len(pts)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_bank_hit_on_equals_off(family, tmp_path):
    model, params, x, y, *_ = _setup(family)
    train = RatingDataset(x, y)
    builder = InfluenceEngine(model, params, train, damping=DAMP,
                              cache_dir=str(tmp_path), model_name="rf",
                              device="cpu")
    pairs = fbank.select_hot_pairs(builder.index, max_entries=8,
                                   top_users=4, top_items=4)
    bank = fbank.build_bank(builder, pairs, batch_queries=8)
    fbank.publish_bank(bank, builder.factor_bank_path(), fbank.bank_fingerprint(
        "rf", model.block_size, DAMP, *builder._train_host))
    got = {}
    for rf in ("on", "off"):
        eng = InfluenceEngine(model, params, train, damping=DAMP,
                              solver="precomputed", cache_dir=str(tmp_path),
                              model_name="rf", row_features=rf,
                              device="cpu")
        assert eng.ensure_factor_bank() == len(bank)
        pts = np.concatenate([np.asarray(bank.pairs[:4], np.int64),
                              _points(x)[:2]])
        got[rf] = eng.query_batch(pts)
        assert eng.bank_stats()["hits"] == 4
        # the miss delegate shares the table
        assert (eng._miss_delegate()._rowfeat is eng._rowfeat)
    _same(got["on"], got["off"])


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_reset_rebuilds_the_table(family):
    model, params, x, y, *_ = _setup(family)
    on, off = _engines(model, params, x, y)
    pts = _points(x)
    before = on.query_batch(pts)
    old = on._rowfeat
    on._reset_device_state(max_wait_s=1.0)
    assert on._rowfeat is not old and torch.equal(on._rowfeat, old)
    _same(on.query_batch(pts), before)
    _same(on.query_batch(pts), off.query_batch(pts))


def _fia(x, y, tmp_path):
    m = FIAModel("MF", U, I, K, 1e-3, batch_size=100,
                 data_sets={"train": RatingDataset(x, y)},
                 initial_learning_rate=1e-2, damping=DAMP,
                 train_dir=str(tmp_path), model_name="rf-stream",
                 seed=0, device="cpu")
    m.train(30, save_checkpoints=False, verbose=False)
    return m


def test_updates_and_removals_rebuild_the_table(tmp_path):
    """Every path that replaces the params builds a new engine, whose
    table is built from the new params: ``on`` stays bitwise ``off``."""
    x, y = _data(1)
    m = _fia(x, y, tmp_path)
    pts = _points(x)
    first = m.engine(row_features="on").query_batch(pts)
    _same(first, m.engine(row_features="off").query_batch(pts))
    assert m.apply_updates(np.array([[3, 5], [0, 1]]),
                           np.array([5.0, 1.0], np.float32),
                           steps=20).committed
    on = m.engine(row_features="on")
    upd = on.query_batch(pts)
    _same(upd, m.engine(row_features="off").query_batch(pts))
    assert upd._packed.tobytes() != first._packed.tobytes()
    assert m.apply_removal(np.array([0, 5, 9]), steps=20).committed
    rem = m.engine(row_features="on").query_batch(pts)
    _same(rem, m.engine(row_features="off").query_batch(pts))
    assert rem._packed.tobytes() != upd._packed.tobytes()


def _gate_stub(n, users, items, dim, option, shard=False,
               hooks=True):
    model = types.SimpleNamespace(
        build_row_features=(lambda *a: None) if hooks else None,
        num_users=users, num_items=items, row_feature_dim=dim)
    return types.SimpleNamespace(model=model, row_features=option,
                                 _shard_tables=shard,
                                 _train_host=(range(n), range(n)))


@pytest.mark.parametrize("case", [
    dict(n=975_460, users=6040, items=3706, dim=2 * 16 + 3, option="on"),
    dict(n=975_460, users=6040, items=3706, dim=4 * 16 + 3, option="on"),
    dict(n=20_000_263, users=138_493, items=26_744, dim=35, option="on"),
    dict(n=20_000_263, users=138_493, items=26_744, dim=67, option="on"),
    dict(n=4_194_304, users=10, items=10, dim=128, option="on"),
    dict(n=4_194_305, users=10, items=10, dim=128, option="on"),
    dict(n=4_194_304, users=10, items=10, dim=129, option="on"),
    dict(n=1000, users=1 << 24, items=10, dim=35, option="on"),
    dict(n=1000, users=(1 << 24) - 1, items=10, dim=35, option="on"),
    dict(n=1000, users=10, items=10, dim=35, option="auto"),
    dict(n=1000, users=10, items=10, dim=35, option="off"),
    dict(n=1000, users=10, items=10, dim=35, option="on", shard=True),
    dict(n=1000, users=10, items=10, dim=35, option="on", hooks=False),
])
def test_gate_is_the_references(case):
    got = InfluenceEngine._want_row_features(_gate_stub(**case))
    want = RefEngine._want_row_features(_gate_stub(**case))
    assert got == want
    if case["n"] == 975_460:
        assert got  # ML-1M: on (0.50 GB at the padded width)
    if case["n"] == 20_000_263:
        assert not got  # ML-20M: off (10.2 GB at the padded width)

"""The port's flat influence query (``query_batch(device="cpu")``)
against the reference's ``InfluenceEngine.query_batch``, on the same
numpy data and the reference's params carried across.

Both models, MF and NCF, on two inputs each: the reference's kernel-test
setup (tests/test_kernels.py:44-54, k = 4) and ``tiny_splits`` (k = 8).
Counts and related rows are exactly equal; scores meet rtol 2e-5 /
atol 1e-6 (rtol 1e-4 for MF on ``tiny_splits``, see ``TINY_RTOL``) with
per-query Spearman > 1 − 1e-9; iHVPs (see ``NCF_TINY_IHVP_RTOL``) and
test vectors are allclose. The reference runs its default XLA analytic
score stage and its Pallas kernel in interpret mode. Each ``stage``
prefix of the flat program matches the reference's
``_flat_fn(s_pad, stage=...)``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fia_tpu.data.dataset import RatingDataset as RefDataset
from fia_tpu.eval.metrics import spearman
from fia_tpu.influence.engine import InfluenceEngine as RefEngine
from fia_tpu.models import MF as RefMF
from fia_tpu.models import NCF as RefNCF
from fia_tpu_torch.data.dataset import RatingDataset
from fia_tpu_torch.influence.engine import STAGES, InfluenceEngine
from fia_tpu_torch.models import MF, NCF, params_from_numpy

torch.set_num_threads(2)

RTOL, ATOL = 2e-5, 1e-6
RHO_ONE = 1.0 - 1e-9
# tiny_splits: the block Hessians reach cond(H) ≈ 1.1e3 (measured), so a
# float32 LU solve carries ~cond·eps ≈ 7e-5 relative error whichever
# implementation runs it. Measured there: port vs reference iHVP 5.3e-5
# relative (scores 2.4e-5), port vs a float64 solve of the same H
# 3.6e-5, reference vs float64 2.0e-5; the Hessians agree to 1.2e-7.
# The iHVP and score bar of that case is therefore rtol 1e-4.
TINY_RTOL = 1e-4
# NCF on tiny_splits: the block Hessians are well conditioned
# (cond(H) <= 28, measured) and agree to 8.7e-8, but the iHVP's entries
# span about three decades (max |ihvp| ≈ 30). A float32 LU solve's error
# is normwise, ≈ cond·eps·‖x‖ (measured: port vs reference 6.2e-7 of
# max |ihvp|), so the smallest entries carry up to 2.8e-4 relative error
# port vs reference; against a float64 solve of the same H the reference
# is 2.0e-4 off and the port 7.4e-5. That case's iHVP bar is therefore
# rtol 5e-4; its scores, dominated by the large entries, meet RTOL.
NCF_TINY_IHVP_RTOL = 5e-4
FAMILIES = {"mf": (MF, RefMF), "ncf": (NCF, RefNCF)}
# (score rtol, iHVP rtol) of each (family, input)
TOLS = {("mf", "kernels"): (RTOL, RTOL), ("mf", "tiny"): (TINY_RTOL, TINY_RTOL),
        ("ncf", "kernels"): (RTOL, RTOL),
        ("ncf", "tiny"): (RTOL, NCF_TINY_IHVP_RTOL)}


def _kernels_setup():
    """tests/test_kernels.py:44-54 (MF): U=24, I=18, k=4, 400 rows; the
    last user/item id is unseen, so (U-1, I-1) is a count-0 query."""
    U, I = 24, 18
    rng = np.random.default_rng(0)
    x = np.stack([rng.integers(0, U - 1, 400), rng.integers(0, I - 1, 400)],
                 axis=1).astype(np.int32)
    y = rng.integers(1, 6, 400).astype(np.float32)
    pts = x[np.random.default_rng(7).choice(400, size=11, replace=False)]
    pts = np.concatenate([pts.astype(np.int64), [[U - 1, I - 1]]])
    return (U, I, 4), x, y, pts


def _tiny_setup(tiny_splits):
    tr = tiny_splits["train"]
    return (60, 40, 8), tr.x, tr.y, tiny_splits["test"].x[:37].astype(np.int64)


@pytest.fixture(scope="module", params=sorted(TOLS),
                ids=lambda p: "-".join(p))
def case(request):
    family, setup = request.param
    if setup == "kernels":
        shape, x, y, pts = _kernels_setup()
    else:
        shape, x, y, pts = _tiny_setup(request.getfixturevalue("tiny_splits"))
    U, I, k = shape
    Port, Ref = FAMILIES[family]
    ref_model = Ref(U, I, k, 1e-3)
    arrays = jax.tree_util.tree_map(
        np.asarray, ref_model.init_params(jax.random.PRNGKey(0)))
    model = Port(U, I, k, 1e-3)
    port = InfluenceEngine(model, params_from_numpy(model, arrays, "cpu"),
                           RatingDataset(x, y), damping=1e-3, device="cpu")
    ref = RefEngine(ref_model, arrays, RefDataset(x, y), damping=1e-3)
    return port, ref, ref_model, arrays, x, y, pts, TOLS[request.param]


def _assert_query_parity(res, ref, pts, tols):
    rtol, ihvp_rtol = tols
    assert np.array_equal(res.counts, ref.counts)
    for t in range(len(pts)):
        assert np.array_equal(res.related_of(t), ref.related_of(t))
        a, b = res.scores_of(t), ref.scores_of(t)
        np.testing.assert_allclose(a, b, rtol=rtol, atol=ATOL)
        if len(a) > 1 and (np.std(a) > 0 or np.std(b) > 0):
            assert spearman(a, b) > RHO_ONE
    np.testing.assert_allclose(res.ihvp, ref.ihvp, rtol=ihvp_rtol, atol=ATOL)
    np.testing.assert_allclose(res.test_grad, ref.test_grad, rtol=RTOL,
                               atol=ATOL)


def test_query_batch_matches_reference(case):
    port, ref, _, _, _, _, pts, tols = case
    assert len(pts) % port.query_bucket != 0  # the query axis is padded
    res = port.query_batch(pts)
    _assert_query_parity(res, ref.query_batch(pts), pts, tols)
    assert res.ihvp.shape == (len(pts), port.model.block_size)


def test_query_batch_matches_reference_pallas(case):
    port, _, ref_model, arrays, x, y, pts, tols = case
    ref = RefEngine(ref_model, arrays, RefDataset(x, y), damping=1e-3,
                    kernel="pallas")
    _assert_query_parity(port.query_batch(pts), ref.query_batch(pts), pts,
                         tols)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_count_zero_query(family):
    shape, x, y, pts = _kernels_setup()
    U, I, k = shape
    model = FAMILIES[family][0](U, I, k, 1e-3)
    params = model.init_params(torch.Generator().manual_seed(0))
    res = InfluenceEngine(model, params, RatingDataset(x, y), damping=1e-3,
                          device="cpu").query_batch(pts)
    assert res.counts[-1] == 0 and len(res.scores_of(len(pts) - 1)) == 0
    assert np.isfinite(res.ihvp).all()


def test_padded_views_match_reference(case):
    port, ref, _, _, _, _, pts, (rtol, _) = case
    res, want = port.query_batch(pts), ref.query_batch(pts)
    assert np.array_equal(res.related_idx, want.related_idx)
    assert np.array_equal(res.related_mask, want.related_mask)
    np.testing.assert_allclose(res.scores, want.scores, rtol=rtol, atol=ATOL)


def test_single_pair(case):
    port, ref, _, _, _, _, pts, tols = case
    res, want = port.query_batch(pts[0]), ref.query_batch(pts[0])
    _assert_query_parity(res, want, pts[:1], tols)


@pytest.mark.parametrize("stage", STAGES + ("operands",))
def test_stage_prefixes_match_reference(case, stage):
    port, ref, _, _, _, _, pts, (rtol, ihvp_rtol) = case
    counts, tx, s_pad = port._flat_inputs(pts)
    T = len(pts)
    got = port._flat_fn(s_pad, stage)(
        port.params, port.train_x, port.train_y, port._postings, tx)
    if stage == "operands":
        # the reference has no such prefix: its score stage's inputs are
        # the grads prefix's rows and the solve prefix's iHVP
        tx_, t, rel_x, e, wv, B = got
        assert torch.equal(tx_, tx) and t.shape == wv.shape == (s_pad,)
        assert B.shape == (tx.shape[0], port.model.block_size + 2)
        want_ihvp = np.asarray(ref._flat_fn(s_pad, "solve")(
            ref.params, ref.train_x, ref.train_y, ref._postings,
            jnp.asarray(tx.numpy()), ref._rowfeat)[0])
        np.testing.assert_allclose(B[:T, :-2].numpy(), want_ihvp[:T],
                                   rtol=ihvp_rtol, atol=ATOL)
        np.testing.assert_array_equal(
            B[:T, -1].numpy(), np.maximum(port.index.counts_batch(pts), 1))
        total = int(counts.sum())  # the real rows come first, all valid
        assert float(wv[:total].sum()) == total
        return
    want = ref._flat_fn(s_pad, stage)(
        ref.params, ref.train_x, ref.train_y, ref._postings,
        jnp.asarray(tx.numpy()), ref._rowfeat)
    # tolerance by output: grads and Hessians meet the bar in every case;
    # the solve sets the iHVP's and the scores' (see TOLS)
    tol = {"grads": (RTOL, RTOL), "hessian": (RTOL,),
           "solve": (ihvp_rtol, RTOL),
           "scores": (rtol, ihvp_rtol, RTOL)}[stage]
    if stage == "hessian":
        got, want = (got,), (want,)
    for a, b, rt in zip(got, want, tol):
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape
        if a.shape[0] != s_pad:  # per-query outputs: the real queries
            a, b = a[:T], b[:T]
        np.testing.assert_allclose(a, b, rtol=rt, atol=ATOL)


# These options once raised NotImplementedError (row_features='on' was
# ROADMAP Queue A.6b); the name stays. Each engine now constructs and
# resolves the fused row-feature table exactly as the reference's does
# with the same arguments: on, save with row-sharded tables ("shard_tables"
# stands for a (1, 2) ('data', 'model') mesh of each package).
@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("kw", [
    {"solver": "precomputed", "row_features": "on"},
    {"solver": "sampled", "row_features": "on"},
    {"solver": "cg", "row_features": "on"},
    {"shard_tables": True, "row_features": "on"}, {"row_features": "on"},
    {"impl": "padded", "row_features": "on"},
    {"cache_dir": "unused", "row_features": "on"},
])
def test_unported_options_raise(kw, family):
    from fia_tpu.parallel import sharded as ref_sharded
    from fia_tpu_torch.parallel import mesh as pmesh
    from fia_tpu_torch.parallel.sharded import make_2d_mesh

    shape, x, y, _ = _kernels_setup()
    cls, ref_cls = FAMILIES[family]
    ref_model = ref_cls(*shape, 1e-3)
    arrays = jax.tree_util.tree_map(
        np.asarray, ref_model.init_params(jax.random.PRNGKey(0)))
    model = cls(*shape, 1e-3)
    params = params_from_numpy(model, arrays, "cpu")
    with pmesh.virtual_devices(2):
        port_kw, ref_kw = dict(kw), dict(kw)
        if kw.get("shard_tables"):
            port_kw["mesh"] = make_2d_mesh(2, model_parallel=2, device="cpu")
            ref_kw["mesh"] = ref_sharded.make_2d_mesh(2, model_parallel=2)
        eng = InfluenceEngine(model, params, RatingDataset(x, y),
                              device="cpu", **port_kw)
    ref = RefEngine(ref_model, arrays, RefDataset(x, y), **ref_kw)
    assert (eng._rowfeat is not None) == (ref._rowfeat is not None)
    assert (eng._rowfeat is None) == bool(kw.get("shard_tables"))
    if eng._rowfeat is not None:
        assert tuple(eng._rowfeat.shape) == tuple(ref._rowfeat.shape)
        np.testing.assert_array_equal(eng._rowfeat[:, -2:].numpy(),
                                      np.asarray(ref._rowfeat)[:, -2:])


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("kw", [
    {"solver": "precomputed"}, {"solver": "sampled"},
    {"cache_dir": "unused"},
    {"solver": "sampled", "sampled_cap": 8, "sampled_tol": 0.5},
    {"cpu_fallback": False}, {"cpu_fallback": True, "mesh": None},
    {"mesh": 2},
])
def test_ported_rungs_construct(kw, family):
    """An int ``mesh`` stands for a real ``make_mesh(n, device="cpu")``
    over virtual slots."""
    from fia_tpu_torch.parallel import mesh as pmesh

    shape, x, y, _ = _kernels_setup()
    model = FAMILIES[family][0](*shape, 1e-3)
    params = model.init_params(torch.Generator().manual_seed(0))
    with pmesh.virtual_devices(2):
        if isinstance(kw.get("mesh"), int):
            kw = dict(kw, mesh=pmesh.make_mesh(kw["mesh"], device="cpu"))
        eng = InfluenceEngine(model, params, RatingDataset(x, y),
                              device="cpu", **kw)
    assert eng.mesh is kw.get("mesh")
    assert eng.solver == kw.get("solver", "direct")
    assert eng.sampled_cap == kw.get("sampled_cap", 64)
    assert eng.sampled_tol == kw.get("sampled_tol", float("inf"))
    assert eng.cpu_fallback == kw.get("cpu_fallback", False)


#: defaults the port sets apart from the reference's, each with its
#: reason: the CPU rung would answer a batch on the CPU while the tensors
#: lie on the card, so the port leaves it to a caller who asks for it
DEFAULT_DIVERGENCES = {"cpu_fallback": (True, False)}


def test_signature_is_the_references():
    """The constructor takes the reference's parameters, in its order
    and with its defaults (save those in ``DEFAULT_DIVERGENCES``); the
    port's own ``device`` comes last."""
    import inspect

    port = inspect.signature(InfluenceEngine.__init__).parameters
    ref = inspect.signature(RefEngine.__init__).parameters
    assert list(port)[-1] == "device"
    assert [p for p in port if p != "device"] == list(ref)
    for name, p in ref.items():
        want = DEFAULT_DIVERGENCES.get(name)
        if want is None:
            assert port[name].default == p.default, name
        else:
            assert (p.default, port[name].default) == want, name


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("kw", [{"solver": "bogus"}, {"impl": "bogus"},
                                {"kernel": "bogus"}, {"kernel": "cuda"}])
def test_bad_options_raise(kw, family):
    shape, x, y, _ = _kernels_setup()
    model = FAMILIES[family][0](*shape, 1e-3)
    params = model.init_params(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError):
        InfluenceEngine(model, params, RatingDataset(x, y), device="cpu", **kw)


def test_sibling_drops_methods_bound_to_the_parent():
    """A method set on an engine instance (patched, or restored by
    assignment as ``serve_multitenant``'s scripted fault does) is bound
    to that engine: its ``sampled`` sibling still answers on its own
    rung, stamped approximate, as the reference's fresh sibling does
    (ROADMAP C.8)."""
    rng = np.random.default_rng(7)
    x = np.stack([rng.integers(0, 30, 400), rng.integers(0, 20, 400)],
                 axis=1).astype(np.int32)
    y = rng.integers(1, 6, 400).astype(np.float32)
    model = MF(30, 20, 4, 1e-2)
    params = model.init_params(torch.Generator().manual_seed(0))
    pts = np.asarray([[1, 2], [3, 4]], np.int64)
    eng = InfluenceEngine(model, params, RatingDataset(x, y), damping=1e-3,
                          device="cpu")
    want = InfluenceEngine(model, params, RatingDataset(x, y), damping=1e-3,
                           solver="sampled", device="cpu").query_batch(pts)
    eng.query_batch = eng.query_batch  # an instance attribute, bound
    got = eng.approx_sibling().query_batch(pts)
    assert got.approx and want.approx
    np.testing.assert_array_equal(got.scores, want.scores)
    np.testing.assert_array_equal(got.err_bound, want.err_bound)
    assert "query_batch" not in vars(eng.approx_sibling())

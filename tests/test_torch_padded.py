"""The port's padded per-query influence program
(``query_batch(device="cpu")`` with cg, lissa, schulz, ``impl="padded"``,
``hessian_mode="autodiff"``, ``group_queries``, ``pad_policy="dataset"``)
against the reference's ``InfluenceEngine``, on the same numpy data with
the reference's params carried across.

MF and NCF on the two inputs of tests/test_torch_engine.py: the kernel
tests' setup ("kernels", k = 4), whose queries are all training pairs
(the e·C cross term is live) plus a count-0 query, and ``tiny_splits``
("tiny", k = 8), whose queries are held out. Counts and related rows are
exactly equal; scores meet rtol 2e-5 / atol 1e-6 with per-query
Spearman ≥ 1 − 1e-9 unless ``TOLS`` states the case's measured condition
and its bar; test vectors meet rtol 2e-5.
"""

import jax
import numpy as np
import pytest
import torch

from fia_tpu.data.dataset import RatingDataset as RefDataset
from fia_tpu.eval.metrics import spearman
from fia_tpu.influence.engine import InfluenceEngine as RefEngine
from fia_tpu.models import MF as RefMF
from fia_tpu.models import NCF as RefNCF
from fia_tpu_torch.data.dataset import RatingDataset
from fia_tpu_torch.influence import spectral
from fia_tpu_torch.influence.engine import InfluenceEngine
from fia_tpu_torch.models import MF, NCF, params_from_numpy

torch.set_num_threads(2)

RTOL, ATOL = 2e-5, 1e-6
RHO_ONE = 1.0 - 1e-9
DAMPING = 1e-3
# The kernel setup's queries are training pairs: at damping 0 its blocks
# reach λ_min = -1.04 (MF) and -0.27 (NCF), measured. CG and LiSSA need a
# PD system, so there they run at damping 1.5 (cond ≤ 9).
PD_DAMPING = 1.5
DEPTH = 200  # LiSSA depth: converged to 1e-4 on the PD kernel blocks
FAMILIES = {"mf": (MF, RefMF), "ncf": (NCF, RefNCF)}
CASES = {
    "direct": {"impl": "padded"},
    "direct-autodiff": {"impl": "padded", "hessian_mode": "autodiff"},
    "cg": {"solver": "cg"},
    "schulz": {"solver": "schulz"},
    "lissa-spectral": {"solver": "lissa", "lissa_depth": DEPTH},
    "lissa-static": {"solver": "lissa", "lissa_tune": "static",
                     "lissa_depth": DEPTH},
    # a pad bucket that puts the queries in two pad groups: a dense result
    "group": {"group_queries": True, "pad_bucket": 32},
    "dataset": {"pad_policy": "dataset"},
}
# Each input runs the four solvers ("dataset" is the padded direct solve
# on "tiny"); the other cases run on one input each, which keeps the
# file's reference compiles (~2 s each) in bounds.
# The spectral LiSSA runs where the blocks are PD at the engine's own
# damping: there its tuning's shift is 0 and the scale is the floor, on
# both sides, whatever start vector each power iteration draws.
SETUP_CASES = {
    "kernels": ("direct", "direct-autodiff", "cg", "schulz", "lissa-static",
                "group"),
    "tiny": ("cg", "schulz", "lissa-spectral", "dataset"),
}
PD_CASES = ("cg", "lissa-static")
# (score rtol, iHVP rtol) where a case misses RTOL: the condition of its
# damped blocks and the error measured, port against reference.
# - A float32 solve carries ~cond·eps relative error whichever side runs
#   it: MF on "tiny" has cond(H) up to 1.1e3 (measured; scores 1.8e-5 /
#   4.7e-5 off, iHVPs 3.0e-5 / 1.5e-5, direct / schulz), NCF on
#   "kernels" cond up to 150 (iHVPs 2.5e-5 / 2.6e-5, autodiff Hessian /
#   schulz): rtol 1e-4, test_torch_engine.py's TINY_RTOL.
# - NCF on "tiny" (cond ≤ 28): the error is normwise and the iHVP spans
#   three decades, so its smallest entries carry up to 1.3e-4 relative
#   (measured); test_torch_engine.py's NCF_TINY_IHVP_RTOL, 5e-4. Scores
#   meet RTOL.
# - CG stops at ‖r‖ ≤ 1e-5·‖v‖ (tol 1e-10 on ‖r‖²), which leaves each
#   side's x up to cond·1e-5 from the exact solve, so two float32 runs
#   that round their HVPs differently stop at different points: measured
#   scores 7.6e-4 (MF) / 3.1e-4 (NCF) and iHVPs 2.1e-4 / 2.3e-4 apart on
#   "tiny". rtol 1e-3, the loosest bar allowed; at that error two
#   near-equal scores can swap, so the rank bar is Spearman ≥ 0.999, the
#   reference's own bar for an iterative solve against direct
#   (tests/test_kernels.py:370); measured 0.99976 (NCF).
TINY_RTOL, NCF_TINY_IHVP_RTOL, CG_RTOL, CG_RHO = 1e-4, 5e-4, 1e-3, 0.999
TOLS = {  # (score rtol, iHVP rtol, Spearman bar)
    ("mf", "tiny", "dataset"): (TINY_RTOL, TINY_RTOL, RHO_ONE),
    ("mf", "tiny", "schulz"): (TINY_RTOL, TINY_RTOL, RHO_ONE),
    ("ncf", "kernels", "direct-autodiff"): (RTOL, TINY_RTOL, RHO_ONE),
    ("ncf", "kernels", "schulz"): (RTOL, TINY_RTOL, RHO_ONE),
    ("ncf", "tiny", "dataset"): (RTOL, NCF_TINY_IHVP_RTOL, RHO_ONE),
    ("ncf", "tiny", "schulz"): (RTOL, NCF_TINY_IHVP_RTOL, RHO_ONE),
    ("mf", "tiny", "cg"): (CG_RTOL, CG_RTOL, CG_RHO),
    ("ncf", "tiny", "cg"): (CG_RTOL, CG_RTOL, CG_RHO),
}


def _kernels_setup():
    """tests/test_kernels.py:44-54: U=24, I=18, k=4, 400 rows, 11 queries
    drawn from the training pairs, and (U-1, I-1), unseen: count 0."""
    U, I = 24, 18
    rng = np.random.default_rng(0)
    x = np.stack([rng.integers(0, U - 1, 400), rng.integers(0, I - 1, 400)],
                 axis=1).astype(np.int32)
    y = rng.integers(1, 6, 400).astype(np.float32)
    pts = x[np.random.default_rng(7).choice(400, size=11, replace=False)]
    pts = np.concatenate([pts.astype(np.int64), [[U - 1, I - 1]]])
    return (U, I, 4), x, y, pts


def _build(family, name, tiny_splits):
    if name == "kernels":
        shape, x, y, pts = _kernels_setup()
    else:
        tiny = tiny_splits
        shape, x, y = (60, 40, 8), tiny["train"].x, tiny["train"].y
        pts = tiny["test"].x[:37].astype(np.int64)
    Port, Ref = FAMILIES[family]
    ref_model = Ref(*shape, 1e-3)
    arrays = jax.tree_util.tree_map(
        np.asarray, ref_model.init_params(jax.random.PRNGKey(0)))
    return family, name, Port(*shape, 1e-3), ref_model, arrays, x, y, pts


@pytest.fixture(scope="module")
def setups(tiny_splits):
    return {(f, n): _build(f, n, tiny_splits) for f in FAMILIES
            for n in SETUP_CASES}


def _engines(setup, **kw):
    _, _, model, ref_model, arrays, x, y, _ = setup
    port = InfluenceEngine(model, params_from_numpy(model, arrays, "cpu"),
                           RatingDataset(x, y), device="cpu", **kw)
    return port, RefEngine(ref_model, arrays, RefDataset(x, y), **kw)


def _assert_parity(res, want, pts, rtol, ihvp_rtol, rho=RHO_ONE):
    assert np.array_equal(res.counts, want.counts)
    for t in range(len(pts)):
        assert np.array_equal(res.related_of(t), want.related_of(t))
        a, b = res.scores_of(t), want.scores_of(t)
        np.testing.assert_allclose(a, b, rtol=rtol, atol=ATOL)
        if len(a) > 1 and (np.std(a) > 0 or np.std(b) > 0):
            assert spearman(a, b) >= rho
    np.testing.assert_allclose(res.ihvp, want.ihvp, rtol=ihvp_rtol, atol=ATOL)
    np.testing.assert_allclose(res.test_grad, want.test_grad, rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("name,case", [(n, c) for n, cs in SETUP_CASES.items()
                                       for c in cs])
def test_padded_matches_reference(setups, family, name, case):
    setup = setups[family, name]
    pts = setup[-1]
    kw = dict(CASES[case], damping=DAMPING)
    if name == "kernels" and case in PD_CASES:
        kw["damping"] = PD_DAMPING
    port, ref = _engines(setup, **kw)
    res = port.query_batch(pts)
    want = ref.query_batch(pts)
    assert port.solver == ref.solver == CASES[case].get("solver", "direct")
    rtol, ihvp_rtol, rho = TOLS.get((family, name, case),
                                    (RTOL, RTOL, RHO_ONE))
    _assert_parity(res, want, pts, rtol, ihvp_rtol, rho)
    assert np.isfinite(res.ihvp).all()
    if name == "kernels":  # the count-0 query
        assert res.counts[-1] == 0 and len(res.scores_of(len(pts) - 1)) == 0
    if case == "group":
        assert res._packed is None and len(np.unique(res.counts)) > 1
    if case in ("group", "dataset"):  # the (T, P) views, pad included
        assert res.scores.shape == want.scores.shape
        assert np.array_equal(res.related_idx, want.related_idx)
        assert np.array_equal(res.related_mask, want.related_mask)
        np.testing.assert_allclose(res.scores, want.scores, rtol=rtol,
                                   atol=ATOL)


def _indefinite_block():
    """tests/test_kernels.py:283-300: a real indefinite MF block, one
    training row equal to the query pair with a large residual, so the
    e·C cross term puts ±2|e| eigenvalues on the embedding subspace.
    Its shifted spectrum contracts by ≥ 1/6 a LiSSA step, so 300 steps
    converge, and the static recursion overflows within them."""
    ref_model = RefMF(4, 4, 4, 1e-4)
    arrays = jax.tree_util.tree_map(
        np.asarray, ref_model.init_params(jax.random.PRNGKey(1)))
    x = np.asarray([[0, 0], [1, 1], [2, 2]], np.int32)
    y = np.asarray([5.0, 3.0, 3.0], np.float32)
    model = MF(4, 4, 4, 1e-4)
    return model, ref_model, arrays, x, y


def _ladder_engines(model, ref_model, arrays, x, y, **kw):
    port = InfluenceEngine(model, params_from_numpy(model, arrays, "cpu"),
                           RatingDataset(x, y), damping=DAMPING,
                           device="cpu", **kw)
    return port, RefEngine(ref_model, arrays, RefDataset(x, y),
                           damping=DAMPING, **kw)


def test_static_lissa_escalates_and_spectral_keeps_the_rung(capsys):
    """On the indefinite block the static recursion diverges: its payload
    goes non-finite and the ladder moves it to cg, as the reference's
    does, with the same answer. The spectral tuning shifts the block PD
    and keeps the lissa rung: its iHVP solves (H + shift·I) x = v."""
    model, ref_model, arrays, x, y = _indefinite_block()
    pts = np.asarray([[0, 0]], np.int64)
    static, ref = _ladder_engines(model, ref_model, arrays, x, y,
                                  solver="lissa", lissa_tune="static",
                                  lissa_depth=300)
    res, want = static.query_batch(pts), ref.query_batch(pts)
    assert static.solver == ref.solver == "cg"
    _assert_parity(res, want, pts, RTOL, RTOL)
    assert "escalating solver to 'cg'" in capsys.readouterr().err

    spec = _ladder_engines(model, ref_model, arrays, x, y, solver="lissa",
                           lissa_depth=300)[0]
    res = spec.query_batch(pts)
    assert spec.solver == "lissa"
    assert np.isfinite(res.ihvp).all() and np.isfinite(res.scores_of(0)).all()
    # the same tuning on the materialised block, in float64
    params = spec.params
    H = (model.block_hessian(params, 0, 0, torch.as_tensor(x[:1]),
                             torch.as_tensor(y[:1]), torch.ones(1))
         + DAMPING * torch.eye(model.block_size))
    assert float(torch.linalg.eigvalsh(H.double())[0]) < 0  # indefinite
    scale, shift = spectral.lissa_tuning(
        lambda v: v @ H.T, model.block_size, scale_floor=10.0,
        batch_shape=(1,))
    want = np.linalg.solve(
        H.double().numpy() + float(shift) * np.eye(model.block_size),
        res.test_grad[0].astype(np.float64))
    np.testing.assert_allclose(res.ihvp[0], want, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("solver,rungs", [
    ("lissa", ["cg", "direct"]), ("schulz", ["direct"]),
])
def test_nan_ladder_walks_as_the_reference(capsys, solver, rungs):
    """A NaN rating makes every solve's payload non-finite: both engines
    walk the same rungs to the bottom (direct) and say so on stderr."""
    model, ref_model, arrays, x, y = _indefinite_block()
    y = y.copy()
    y[0] = np.nan  # the query pair's own row
    pts = np.asarray([[0, 0], [1, 1]], np.int64)
    port, ref = _ladder_engines(model, ref_model, arrays, x, y,
                                solver=solver, lissa_depth=50)
    capsys.readouterr()
    res = port.query_batch(pts)
    got = [ln for ln in capsys.readouterr().err.splitlines()
           if ln.startswith("[reliability]")]
    ref.query_batch(pts)
    want = [ln for ln in capsys.readouterr().err.splitlines()
            if ln.startswith("[reliability]")]
    assert port.solver == ref.solver == "direct"
    assert got == want
    assert [f"escalating solver to {r!r}" in ln
            for ln, r in zip(got, rungs)] == [True] * len(rungs)
    assert "no fallback rung left" in got[-1]
    assert not np.isfinite(res.ihvp).all()


def test_get_influence_on_test_loss(setups):
    _, _, model, ref_model, arrays, x, y, pts = setups["mf", "kernels"]
    port, ref = _engines(setups["mf", "kernels"], damping=PD_DAMPING,
                         solver="cg")
    test_ds = RatingDataset(pts[:3], np.zeros(3, np.float32))
    got = port.get_influence_on_test_loss([2], test_ds)
    np.testing.assert_array_equal(got, port.query_batch(pts[2]).scores_of(0))
    np.testing.assert_allclose(
        got, ref.get_influence_on_test_loss([2], RefDataset(pts[:3],
                                            np.zeros(3, np.float32))),
        rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(port.related_indices(pts[2]),
                                  ref.related_indices(pts[2]))
    with pytest.raises(ValueError, match="one test index"):
        port.get_influence_on_test_loss([0, 1], test_ds)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_two_calls_give_the_same_bytes(setups, family):
    setup = setups[family, "tiny"]
    for kw in ({"solver": "cg"}, {"solver": "schulz"}, {"impl": "padded"}):
        port, _ = _engines(setup, damping=DAMPING, **kw)
        a, b = port.query_batch(setup[-1]), port.query_batch(setup[-1])
        assert a._packed.tobytes() == b._packed.tobytes()
        assert a.ihvp.tobytes() == b.ihvp.tobytes()


class _NoHessianMF(MF):
    block_hessian = None


@pytest.mark.parametrize("kw,err", [
    ({"lissa_tune": "bogus"}, ValueError),
    ({"hessian_mode": "bogus"}, ValueError),
    ({"pad_policy": "bogus"}, ValueError),
    ({"solver": "bogus"}, ValueError),
    # the two rungs construct (test_torch_engine.py::
    # test_ported_rungs_construct), with row_features='on' too since
    # ROADMAP Queue A.6b; an unknown row_features value still raises
    ({"solver": "precomputed", "row_features": "bogus"}, ValueError),
    ({"solver": "sampled", "row_features": "bogus"}, ValueError),
])
def test_constructor_errors(kw, err):
    _, x, y, _ = _kernels_setup()
    model = MF(24, 18, 4, 1e-3)
    params = model.init_params(torch.Generator().manual_seed(0))
    with pytest.raises(err, match="unknown"):
        InfluenceEngine(model, params, RatingDataset(x, y), device="cpu",
                        **kw)


def test_analytic_hessian_needs_the_hook_and_flat_needs_direct():
    _, x, y, pts = _kernels_setup()
    model = _NoHessianMF(24, 18, 4, 1e-3)
    params = model.init_params(torch.Generator().manual_seed(0))
    train = RatingDataset(x, y)
    with pytest.raises(ValueError, match="block_hessian"):
        InfluenceEngine(model, params, train, device="cpu",
                        hessian_mode="analytic")
    # 'auto' falls back to the autodiff Hessian without the hook
    eng = InfluenceEngine(model, params, train, device="cpu", impl="padded")
    assert not eng._analytic_hessian
    assert np.isfinite(eng.query_batch(pts).ihvp).all()
    for kw in ({"solver": "cg"}, {"group_queries": True},
               {"pad_policy": "dataset"}, {"hessian_mode": "autodiff"}):
        eng = InfluenceEngine(model, params, train, device="cpu",
                              impl="flat", **kw)
        with pytest.raises(ValueError, match="impl='flat' requires"):
            eng.query_batch(pts)


def test_ladder_pieces_match_reference():
    """The copied ladder and payload check against the reference's."""
    from fia_tpu.reliability import policy as ref_policy
    from fia_tpu.reliability import taxonomy as ref_taxonomy
    from fia_tpu_torch.reliability import policy, taxonomy

    assert policy.QUERY_SOLVER_FALLBACK == ref_policy.QUERY_SOLVER_FALLBACK
    assert policy.BLOCK_SOLVERS == ref_policy.BLOCK_SOLVERS
    for name in policy.BLOCK_SOLVERS + ("bogus", None):
        if name is not None:
            assert policy.next_solver(name) == ref_policy.next_solver(name)
        for supported in (policy.BLOCK_SOLVERS, ("lissa", "cg"), ("cg",)):
            assert (policy.resolve_solver(name, supported=supported)
                    == ref_policy.resolve_solver(name, supported=supported))
    for arrays in ((np.ones(3), None), (np.ones(2), np.array([1.0, np.nan])),
                   (np.array([np.inf]),), (np.arange(3),)):
        assert (taxonomy.classify_payload(*arrays)
                == ref_taxonomy.classify_payload(*arrays))
    assert taxonomy.NAN == ref_taxonomy.NAN

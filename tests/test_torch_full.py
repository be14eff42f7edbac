"""The port's full-parameter engine (``influence/full.py``) on the CPU.

Restates ``tests/test_full_influence.py`` port against port (MF, U = 8,
I = 6, k = 3, 150 rows: 57 parameters): the materialised full Hessian
against the matrix-free HVP; CG against a dense float64 solve; LiSSA
against CG; prediction influence; the chunked HVP against the full-batch
one. Against the reference: the port's CG influence against the
reference's CG on the reference's params carried across, and the HVP
itself.
"""

import jax
import numpy as np
import pytest
import torch

from fia_tpu.data.dataset import RatingDataset as RefDataset
from fia_tpu.influence.full import FullInfluenceEngine as RefFull
from fia_tpu.models import MF as RefMF
from fia_tpu_torch.data.dataset import RatingDataset
from fia_tpu_torch.influence import hvp as HV
from fia_tpu_torch.influence.full import FullInfluenceEngine
from fia_tpu_torch.models import MF, params_from_numpy
from fia_tpu_torch.reliability import inject, sites

torch.set_num_threads(2)

U, I, K = 8, 6, 3
# the reference's bars (tests/test_full_influence.py); port against the
# reference's CG at cg_tol 1e-12: both stop at the same float32 residual
# floor, so the scores meet the dense-solve bar of the reference's own test
REF_RTOL, REF_ATOL = 5e-3, 1e-6


def _setup(seed=0, n=150):
    rng = np.random.default_rng(seed)
    x = np.stack([rng.integers(0, U, n), rng.integers(0, I, n)],
                 axis=1).astype(np.int32)
    y = rng.integers(1, 6, n).astype(np.float32)
    ref_model = RefMF(U, I, K, 1e-2)
    arrays = jax.tree_util.tree_map(
        np.asarray, ref_model.init_params(jax.random.PRNGKey(seed)))
    model = MF(U, I, K, 1e-2)
    return model, params_from_numpy(model, arrays, "cpu"), RatingDataset(x, y), \
        ref_model, arrays


def _full(model, params, train, **kw):
    return FullInfluenceEngine(model, params, train, device="cpu", **kw)


def _pd_damping(model, params, train) -> float:
    """Damping that makes the damped full Hessian PD (CG stops at
    negative curvature, and a dense solve agrees only on PD systems)."""
    H = HV.materialize_full_hessian(model, params, torch.as_tensor(train.x),
                                    torch.as_tensor(train.y))
    eigmin = float(torch.linalg.eigvalsh(H.double())[0])
    return max(0.0, -eigmin) + 0.1


def _dense_solution(model, params, train, test_x, test_y, damp):
    flat0, unravel = HV.ravel_params(params)
    x, y = torch.as_tensor(train.x), torch.as_tensor(train.y)
    H = HV.materialize_full_hessian(model, params, x, y).double()
    H = H + damp * torch.eye(H.shape[0], dtype=torch.float64)
    v = torch.func.grad(lambda f: model.loss_no_reg(
        unravel(f), torch.as_tensor(test_x), torch.as_tensor(test_y)))(flat0)
    ihvp = torch.linalg.solve(H, v.double()).float()
    g = torch.func.vmap(lambda xj, yj: torch.func.grad(
        lambda f: model.loss(unravel(f), xj[None], yj[None]))(flat0))(x, y)
    return (g @ ihvp).numpy() / train.num_examples


@pytest.fixture(scope="module")
def setup():
    return _setup()


class TestFullHessian:
    def test_materialized_full_hessian_matches_hvp_and_is_symmetric(
            self, setup):
        model, params, train, *_ = setup
        x, y = torch.as_tensor(train.x), torch.as_tensor(train.y)
        damp = 1e-2
        H = HV.materialize_full_hessian(model, params, x, y, damping=damp)
        flat0, unravel = HV.ravel_params(params)
        D = flat0.shape[0]
        assert H.shape == (D, D)
        np.testing.assert_allclose(H, H.T, atol=1e-5)
        hvp = HV.make_full_hvp(model, params, x, y, damping=damp)
        v_flat = torch.as_tensor(
            np.random.default_rng(0).standard_normal(D), dtype=torch.float32)
        hv_flat, _ = HV.ravel_params(hvp(unravel(v_flat)))
        np.testing.assert_allclose(H @ v_flat, hv_flat, rtol=1e-4, atol=1e-5)
        # the engine's HVP is the same operator
        eng = _full(model, params, train, damping=damp)
        np.testing.assert_allclose(eng._hvp(v_flat), hv_flat, rtol=1e-4,
                                   atol=1e-5)


class TestFullEngine:
    def test_cg_matches_dense(self, setup):
        model, params, train, *_ = setup
        damp = _pd_damping(model, params, train)
        tx, ty = train.x[:2], train.y[:2]
        want = _dense_solution(model, params, train, tx, ty, damp)
        eng = _full(model, params, train, damping=damp, solver="cg",
                    cg_tol=1e-12, cg_maxiter=300)
        got = eng.get_influence_on_test_loss(tx, ty)
        np.testing.assert_allclose(got, want, rtol=5e-3, atol=1e-6)
        assert 0 < eng.last_iterations <= 300

    def test_lissa_approximates_cg(self, setup):
        model, params, train, *_ = setup
        damp = _pd_damping(model, params, train)
        tx, ty = train.x[:2], train.y[:2]
        want = _full(model, params, train, damping=damp, solver="cg",
                     cg_tol=1e-12, cg_maxiter=300
                     ).get_influence_on_test_loss(tx, ty)
        got = _full(model, params, train, damping=damp, solver="lissa",
                    lissa_scale=25.0, lissa_depth=4000
                    ).get_influence_on_test_loss(tx, ty)
        assert np.corrcoef(got, want)[0, 1] > 0.99

    def test_minibatch_lissa_seeded(self, setup):
        """LiSSA on 64-row minibatches from an explicit generator: the
        same seed gives the same bits, and the estimate tracks CG (damping
        raised by 1 so that 150 steps converge: (1 - 1/25)^150 ≈ 2e-3)."""
        model, params, train, *_ = setup
        damp = _pd_damping(model, params, train) + 1.0
        tx, ty = train.x[:2], train.y[:2]
        want = _full(model, params, train, damping=damp, solver="cg",
                     cg_tol=1e-12, cg_maxiter=300
                     ).get_influence_on_test_loss(tx, ty)
        li = _full(model, params, train, damping=damp, solver="lissa",
                   lissa_scale=25.0, lissa_depth=150, lissa_batch=64,
                   lissa_samples=2)
        a = li.get_influence_on_test_loss(tx, ty, seed=3)
        b = li.get_influence_on_test_loss(tx, ty, seed=3)
        assert a.tobytes() == b.tobytes()
        assert np.corrcoef(a, want)[0, 1] > 0.9

    def test_prediction_influence_runs(self, setup):
        model, params, train, *_ = setup
        eng = _full(model, params, train, damping=0.1, solver="cg")
        out, rr = eng.get_influence_on_test_prediction(train.x[:1],
                                                       return_residual=True)
        assert out.shape == (train.num_examples,)
        assert np.isfinite(out).all() and np.isfinite(rr)

    def test_chunked_hvp_matches_full_batch(self, setup):
        model, params, train, *_ = setup
        damp = _pd_damping(model, params, train)
        tx, ty = train.x[:2], train.y[:2]
        full = _full(model, params, train, damping=damp, solver="cg",
                     cg_tol=1e-12, cg_maxiter=300)
        chunked = _full(model, params, train, damping=damp, solver="cg",
                        cg_tol=1e-12, cg_maxiter=300, hvp_batch=64)
        v = full.test_loss_grad(tx, ty)
        np.testing.assert_allclose(chunked._hvp(v), full._hvp(v), rtol=1e-4,
                                   atol=1e-6)
        np.testing.assert_allclose(
            chunked.get_influence_on_test_loss(tx, ty),
            full.get_influence_on_test_loss(tx, ty), rtol=1e-3, atol=1e-6)

    def test_residual_guard_escalates_lissa_to_cg(self, setup):
        model, params, train, *_ = setup
        damp = _pd_damping(model, params, train)
        eng = _full(model, params, train, damping=damp, solver="lissa",
                    lissa_depth=3, residual_guard=1e-3)
        v = eng.test_loss_grad(train.x[:2], train.y[:2])
        x = eng.get_inverse_hvp(v)
        assert eng.solver == "cg"
        assert eng.relative_residual(v, x) <= 1e-3

    def test_nan_payload_escalates(self, setup):
        model, params, train, *_ = setup
        eng = _full(model, params, train, damping=1.0, solver="lissa",
                    lissa_depth=5)
        v = eng.test_loss_grad(train.x[:2], train.y[:2])
        with inject.active(inject.Fault(site=sites.FULL_SOLVE, at=0,
                                        kind="nan")):
            x = eng.get_inverse_hvp(v)
        assert eng.solver == "cg" and torch.isfinite(x).all()

    def test_precompile_then_cached(self, setup):
        model, params, train, *_ = setup
        eng = _full(model, params, train, damping=0.1)
        first = eng.precompile()
        assert first["compiled"] == ["test_loss_grad", "pred_grad", "solve",
                                     "score_all"] and not first["cached"]
        assert eng.precompile()["cached"] == first["compiled"]

    def test_rejects_mesh(self, setup):
        """A mesh is ported (``test_torch_parallel.py``): over 3 virtual
        slots the 150 train rows shard 50 a slot, ``hvp_batch`` rounds up
        to a slot multiple, and the influence meets the chunked bar
        against the meshless engine."""
        from fia_tpu_torch.parallel import mesh as pmesh

        model, params, train, *_ = setup
        with pmesh.virtual_devices(3):
            eng = _full(model, params, train, damping=0.1, hvp_batch=40,
                        mesh=pmesh.make_mesh(3, device="cpu"))
        assert eng.num_train == 150 and eng.hvp_batch == 42
        full = _full(model, params, train, damping=0.1)
        tx, ty = train.x[:2], train.y[:2]
        np.testing.assert_allclose(eng.get_influence_on_test_loss(tx, ty),
                                   full.get_influence_on_test_loss(tx, ty),
                                   rtol=1e-3, atol=1e-6)


class TestAgainstReference:
    def test_hvp_matches_reference(self, setup):
        model, params, train, ref_model, arrays = setup
        ref = RefFull(ref_model, arrays, RefDataset(train.x, train.y),
                      damping=0.1)
        eng = _full(model, params, train, damping=0.1)
        v = np.random.default_rng(1).standard_normal(eng.num_params)
        v = v.astype(np.float32)
        np.testing.assert_allclose(
            eng._hvp(torch.as_tensor(v)).numpy(),
            np.asarray(ref._hvp(jax.numpy.asarray(v))), rtol=1e-5, atol=1e-6)

    def test_cg_influence_matches_reference(self, setup):
        model, params, train, ref_model, arrays = setup
        damp = _pd_damping(model, params, train)
        tx, ty = train.x[:2], train.y[:2]
        ref = RefFull(ref_model, arrays, RefDataset(train.x, train.y),
                      damping=damp, solver="cg", cg_tol=1e-12,
                      cg_maxiter=300)
        eng = _full(model, params, train, damping=damp, solver="cg",
                    cg_tol=1e-12, cg_maxiter=300)
        np.testing.assert_allclose(
            eng.get_influence_on_test_loss(tx, ty),
            np.asarray(ref.get_influence_on_test_loss(tx, ty)),
            rtol=REF_RTOL, atol=REF_ATOL)
        np.testing.assert_allclose(
            eng.get_influence_on_test_prediction(train.x[:1]),
            np.asarray(ref.get_influence_on_test_prediction(train.x[:1])),
            rtol=REF_RTOL, atol=REF_ATOL)

"""The port's ``hvp``, ``spectral`` and ``solvers`` modules against the
reference's, function by function, on the same numpy inputs (MF and NCF
params carried across from the reference's init).

The port's solvers are batched over a leading axis where the reference's
run under ``vmap``; each batched solve is compared with the reference's
vmapped one, and each lane that stops early with the same lane solved
without the others (a batch of its own copies, so every product takes
the same kernel: bitwise, since the explicit freeze keeps its old
values, as the reference's batched ``while_loop`` does).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fia_tpu.data.index import InteractionIndex as RefIndex
from fia_tpu.influence import hvp as ref_hvp
from fia_tpu.influence import solvers as ref_solvers
from fia_tpu.influence import spectral as ref_spectral
from fia_tpu.models import MF as RefMF
from fia_tpu.models import NCF as RefNCF
from fia_tpu_torch.influence import hvp, solvers, spectral
from fia_tpu_torch.models import MF, NCF, params_from_numpy

torch.set_num_threads(2)

U, I, K, WD, DAMP = 15, 12, 4, 1e-2, 1e-3
# HVPs and Hessians: forward-over-reverse products in two frameworks
# accumulate in other orders; a few float32 ulps at these magnitudes
RTOL, ATOL = 1e-5, 1e-6
FAMILIES = {"mf": (MF, RefMF), "ncf": (NCF, RefNCF)}


def t(a):
    return torch.as_tensor(np.asarray(a))


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def block(request):
    """The related rows of (3, 5) in tests/test_influence.py's setup, a
    row equal to the pair itself (the e·C cross term), 8 masked pad rows
    and fractional weights."""
    Port, Ref = FAMILIES[request.param]
    rng = np.random.default_rng(0)
    n = 300
    x = np.stack([rng.integers(0, U, n), rng.integers(0, I, n)],
                 axis=1).astype(np.int32)
    y = rng.integers(1, 6, n).astype(np.float32)
    u, i = 3, 5
    x = np.vstack([x, [[u, i]]]).astype(np.int32)
    y = np.append(y, 2.0).astype(np.float32)
    idx = RefIndex(x).related(u, i)
    rel_x = np.vstack([x[idx], x[:8]])
    rel_y = np.append(y[idx], y[:8]).astype(np.float32)
    w = np.append(np.ones(len(idx)), np.zeros(8)).astype(np.float32)
    w *= np.random.default_rng(1).uniform(0.3, 1.0, w.shape).astype(np.float32)
    ref = Ref(U, I, K, WD)
    arrays = jax.tree_util.tree_map(
        np.asarray, ref.init_params(jax.random.PRNGKey(0)))
    port = Port(U, I, K, WD)
    return (port, params_from_numpy(port, arrays, "cpu"), ref,
            jax.tree_util.tree_map(jnp.asarray, arrays), u, i, rel_x, rel_y, w)


def test_block_hvp_matches_reference(block):
    port, pp, ref, rp, u, i, rel_x, rel_y, w = block
    d = port.block_size
    fn = hvp.make_block_hvp(port, pp, u, i, t(rel_x), t(rel_y), t(w), DAMP)
    want_fn = jax.jit(ref_hvp.make_block_hvp(ref, rp, u, i, rel_x, rel_y, w,
                                             DAMP))
    rng = np.random.default_rng(2)
    for v in (np.ones(d, np.float32), rng.standard_normal(d).astype(np.float32)):
        np.testing.assert_allclose(fn(t(v)).numpy(), want_fn(jnp.asarray(v)),
                                   rtol=RTOL, atol=ATOL)


def test_materialized_block_hessian(block):
    """The autodiff Hessian against the reference's, and against the
    closed form (the bar of tests/test_influence.py:69-101)."""
    port, pp, ref, rp, u, i, rel_x, rel_y, w = block
    H = hvp.materialize_block_hessian(port, pp, u, i, t(rel_x), t(rel_y),
                                      t(w), DAMP)
    want = jax.jit(lambda: ref_hvp.materialize_block_hessian(
        ref, rp, u, i, rel_x, rel_y, w, DAMP))()
    np.testing.assert_allclose(H.numpy(), want, rtol=RTOL, atol=ATOL)
    ana = port.block_hessian(pp, u, i, t(rel_x), t(rel_y), t(w))
    np.testing.assert_allclose(
        ana.numpy() + DAMP * np.eye(port.block_size), H.numpy(),
        rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("linearize", [False, True])
def test_batched_block_hvp_is_per_query(block, linearize):
    """T queries at once: each row through its own block's HVP."""
    port, pp, _, _, _, _, rel_x, rel_y, w = block
    us, is_ = torch.tensor([3, 0, 7]), torch.tensor([5, 2, 5])
    X = torch.stack([t(rel_x)] * 3)
    Y, W = torch.stack([t(rel_y)] * 3), torch.stack([t(w)] * 3)
    V = torch.randn(3, port.block_size, generator=torch.Generator()
                    .manual_seed(3))
    got = hvp.make_batched_block_hvp(port, pp, us, is_, X, Y, W, DAMP,
                                     linearize=linearize)(V)
    for q in range(3):
        one = hvp.make_block_hvp(port, pp, int(us[q]), int(is_[q]), X[q],
                                 Y[q], W[q], DAMP)(V[q])
        np.testing.assert_allclose(got[q].numpy(), one.numpy(), rtol=RTOL,
                                   atol=ATOL)


def test_full_hessian_and_hvp_entry_for_entry():
    """Full-parameter Hessian in ravel_pytree's order (sorted keys),
    entry for entry, and the full HVP on a random direction."""
    rng = np.random.default_rng(4)
    x = np.stack([rng.integers(0, 5, 40), rng.integers(0, 4, 40)],
                 axis=1).astype(np.int32)
    y = rng.integers(1, 6, 40).astype(np.float32)
    w = (rng.uniform(size=40) > 0.2).astype(np.float32)
    for Port, Ref in FAMILIES.values():
        ref = Ref(5, 4, 2, WD)
        arrays = jax.tree_util.tree_map(
            np.asarray, ref.init_params(jax.random.PRNGKey(1)))
        rp = jax.tree_util.tree_map(jnp.asarray, arrays)
        port = Port(5, 4, 2, WD)
        pp = params_from_numpy(port, arrays, "cpu")
        H = hvp.materialize_full_hessian(port, pp, t(x), t(y), t(w), DAMP)
        want = jax.jit(lambda: ref_hvp.materialize_full_hessian(
            ref, rp, x, y, w, DAMP))()
        assert H.shape == want.shape
        np.testing.assert_allclose(H.numpy(), want, rtol=RTOL, atol=ATOL)
        v = {k: rng.standard_normal(a.shape).astype(np.float32)
             for k, a in arrays.items()}
        got = hvp.make_full_hvp(port, pp, t(x), t(y), t(w), DAMP)(
            {k: t(a) for k, a in v.items()})
        exp = jax.jit(ref_hvp.make_full_hvp(ref, rp, x, y, w, DAMP))(
            {k: jnp.asarray(a) for k, a in v.items()})
        for k in arrays:
            np.testing.assert_allclose(got[k].numpy(), exp[k], rtol=RTOL,
                                       atol=ATOL)
        flat, unravel = hvp.ravel_params(pp)
        assert all(torch.equal(unravel(flat)[k], pp[k]) for k in pp)


def _spd(eigs, seed):
    """Symmetric (d, d) float32 with the given spectrum."""
    d = len(eigs)
    q, _ = np.linalg.qr(np.random.default_rng(seed).standard_normal((d, d)))
    return (q * np.asarray(eigs)) @ q.T


# clear gaps at both passes: the dominant magnitude ≥ 2.6x the next, and
# in the shifted pass (H − λ_dom·I) ≥ 1.14x the next
SPECTRA = [
    np.array([6.0, 3.0, 2.0, 1.5, 1.2, 0.1]),
    np.array([-3.0, -1.0, 0.2, 0.5, 1.0, 8.0]),  # indefinite
    np.array([0.01, 0.5, 0.8, 1.0, 1.2, 4.0]),
]
SPEC_RTOL = 1e-4  # 100 power steps from two start vectors


def _ops():
    Hs = np.stack([_spd(e, s) for s, e in enumerate(SPECTRA)]
                  ).astype(np.float32)
    return Hs, torch.as_tensor(Hs)


def test_power_iteration_and_extremes():
    Hs, Ht = _ops()
    op = lambda v: torch.einsum("tij,tj->ti", Ht, v)  # noqa: E731
    lam, vec = spectral.power_iteration(op, 6, batch_shape=(3,))
    hi, lo = spectral.extreme_eigvals(op, 6, batch_shape=(3,))
    for q, e in enumerate(SPECTRA):
        H = jnp.asarray(Hs[q])
        r_lam, _ = ref_spectral.power_iteration(lambda v: H @ v, 6)
        r_hi, r_lo = ref_spectral.extreme_eigvals(lambda v: H @ v, 6)
        dom = e[np.argmax(np.abs(e))]
        np.testing.assert_allclose(float(lam[q]), float(r_lam),
                                   rtol=SPEC_RTOL)
        np.testing.assert_allclose(float(lam[q]), dom, rtol=SPEC_RTOL)
        np.testing.assert_allclose(abs(float(vec[q] @ Ht[q] @ vec[q])),
                                   abs(dom), rtol=SPEC_RTOL)
        np.testing.assert_allclose([float(hi[q]), float(lo[q])],
                                   [float(r_hi), float(r_lo)],
                                   rtol=SPEC_RTOL, atol=1e-4)
        np.testing.assert_allclose([float(hi[q]), float(lo[q])],
                                   [e.max(), e.min()], rtol=SPEC_RTOL,
                                   atol=1e-4)
    np.testing.assert_allclose(spectral.block_hessian_eigvals(Ht).numpy(),
                               np.sort(np.stack(SPECTRA)), rtol=1e-5,
                               atol=1e-5)


def test_lissa_tuning_matches_reference():
    Hs, Ht = _ops()
    op = lambda v: torch.einsum("tij,tj->ti", Ht, v)  # noqa: E731
    scale, shift = spectral.lissa_tuning(op, 6, scale_floor=10.0,
                                         batch_shape=(3,))
    for q in range(3):
        H = jnp.asarray(Hs[q])
        r_scale, r_shift = ref_spectral.lissa_tuning(lambda v: H @ v, 6,
                                                     scale_floor=10.0)
        np.testing.assert_allclose([float(scale[q]), float(shift[q])],
                                   [float(r_scale), float(r_shift)],
                                   rtol=SPEC_RTOL, atol=1e-4)
    assert float(shift[1]) == pytest.approx(4.5, rel=SPEC_RTOL)  # 1.5·3
    assert float(shift[0]) == float(shift[2]) == 0.0
    # a caller's generator sets the start vector; both ends still found
    g = torch.Generator().manual_seed(5)
    s2, _ = spectral.lissa_tuning(op, 6, scale_floor=0.0, generator=g,
                                  batch_shape=(3,))
    np.testing.assert_allclose(s2.numpy(), 1.2 * np.array([6.0, 12.5, 4.0]),
                               rtol=SPEC_RTOL)


def _cg_lanes():
    """Lanes: well conditioned (stops early), ill conditioned (runs
    long), identity (one step), and indefinite (negative curvature)."""
    spectra = [np.linspace(1.0, 2.0, 8), np.geomspace(1e-3, 1.0, 8),
               np.ones(8), np.array([-2.0, -1.0, 1, 2, 3, 4, 5, 6])]
    Hs = np.stack([_spd(e, 10 + s) for s, e in enumerate(spectra)]
                  ).astype(np.float32)
    vs = np.random.default_rng(11).standard_normal((4, 8)).astype(np.float32)
    return Hs, vs


def test_cg_batched_lanes():
    Hs, vs = _cg_lanes()
    Ht = torch.as_tensor(Hs)

    def op(H):
        return lambda v: torch.einsum("tij,tj->ti", H, v)

    x, iters = solvers.solve_cg(op(Ht), t(vs), maxiter=100, tol=1e-10)
    want = jax.vmap(lambda H, v: ref_solvers.solve_cg(
        lambda w: H @ w, v, maxiter=100, tol=1e-10))(jnp.asarray(Hs),
                                                     jnp.asarray(vs))
    # lane 1 has κ = 1e3: two float32 CG runs part by ~κ·eps (1.2e-4
    # measured)
    np.testing.assert_allclose(x.numpy(), want, rtol=1e-3, atol=1e-5)
    assert 0 < iters <= 100
    for q in range(4):  # each lane as if alone: a batch of its copies
        alone, n = solvers.solve_cg(op(Ht[[q] * 4]), t(vs[[q] * 4]),
                                    maxiter=100, tol=1e-10)
        assert torch.equal(alone[0], x[q]) and n <= iters
    # the early lanes converged; the indefinite lane stopped finite
    res = solvers.relative_residual(op(Ht), t(vs), x)
    assert float(res[0]) < 1e-4 and float(res[2]) < 1e-4
    assert torch.isfinite(x).all()
    np.testing.assert_allclose(
        res.numpy(),
        [float(ref_solvers.relative_residual(lambda w: jnp.asarray(H) @ w,
                                             jnp.asarray(v), jnp.asarray(xx)))
         for H, v, xx in zip(Hs, vs, x.numpy())], rtol=1e-4, atol=1e-6)


def test_schulz_batched_lanes():
    """A well-conditioned, an ill-conditioned (κ ~ 5e4) and a
    beyond-float32 (κ ~ 5e7) lane (tests/test_influence.py:202-238)."""
    rng = np.random.default_rng(1)
    d = 34
    A = rng.normal(size=(d, 3))
    B = rng.normal(size=(d, d))
    Hs = np.stack([B @ B.T / d + 0.5 * np.eye(d), A @ A.T + 1e-3 * np.eye(d),
                   A @ A.T + 1e-6 * np.eye(d)]).astype(np.float32)
    vs = rng.normal(size=(3, d)).astype(np.float32)
    x, iters = solvers.solve_schulz(t(Hs), t(vs))
    want = jax.vmap(ref_solvers.solve_schulz)(jnp.asarray(Hs),
                                              jnp.asarray(vs))
    assert torch.isfinite(x).all()
    np.testing.assert_allclose(x[0].numpy(), np.linalg.solve(Hs[0], vs[0]),
                               rtol=1e-3, atol=1e-4)
    res = np.linalg.norm(Hs[1] @ x[1].numpy() - vs[1]) / np.linalg.norm(vs[1])
    assert res < 1e-2
    # the reference's: lane 0 at the bar; lane 1 (κ ~ 5e4) to the same
    # residual bar, since at κ·eps ~ 3e-3 two float32 iterations part
    # (5% on single entries, measured); the κ ~ 5e7 lane finite on both
    want = np.asarray(want)
    np.testing.assert_allclose(x[0].numpy(), want[0], rtol=1e-4, atol=1e-5)
    assert np.linalg.norm(Hs[1] @ want[1] - vs[1]) / np.linalg.norm(vs[1]) \
        < 1e-2
    assert np.isfinite(want).all()
    for q in range(3):  # each lane as if alone: a batch of its copies
        alone, n = solvers.solve_schulz(t(Hs[[q] * 3]), t(vs[[q] * 3]))
        assert torch.equal(alone[0], x[q]) and n <= iters
    # unbatched (d, d) input: a (d, d) product rounds as the batched one
    # may not, so at the bar
    single, _ = solvers.solve_schulz(t(Hs[0]), t(vs[0]))
    assert single.shape == (d,)
    np.testing.assert_allclose(single.numpy(), x[0].numpy(), rtol=1e-4,
                               atol=1e-5)


def test_lissa_auto_scale_rescues_a_divergent_scale():
    d = 6
    Hs = np.stack([np.diag(np.linspace(0.5, 3.0, d)),
                   np.diag(np.linspace(0.5, 12.0, d))]).astype(np.float32)
    vs = np.ones((2, d), np.float32)
    Ht = torch.as_tensor(Hs)
    op = lambda v: torch.einsum("tij,tj->ti", Ht, v)  # noqa: E731
    # scale 2 diverges on both lanes (λ_max > 2·scale on lane 1) unguarded
    raw = solvers.solve_lissa(op, t(vs), scale=2.0, recursion_depth=300,
                              auto_scale=False)
    assert not torch.isfinite(raw).all()
    got = solvers.solve_lissa(op, t(vs), scale=2.0, recursion_depth=300)
    for q in range(2):
        H = jnp.asarray(Hs[q])
        want = ref_solvers.solve_lissa(lambda w: H @ w, jnp.asarray(vs[q]),
                                       scale=2.0, recursion_depth=300)
        np.testing.assert_allclose(got[q].numpy(), want, rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(Hs[q] @ got[q].numpy(), vs[q], rtol=1e-3,
                                   atol=1e-3)
    # a per-lane scale, as the spectral tuning gives
    per = solvers.solve_lissa(op, t(vs), scale=torch.tensor([4.0, 15.0]),
                              recursion_depth=300, auto_scale=False)
    for q, s in enumerate((4.0, 15.0)):
        H = jnp.asarray(Hs[q])
        want = ref_solvers.solve_lissa(lambda w: H @ w, jnp.asarray(vs[q]),
                                       scale=s, recursion_depth=300,
                                       auto_scale=False)
        np.testing.assert_allclose(per[q].numpy(), want, rtol=1e-5,
                                   atol=1e-6)


def test_lissa_sample_hvp_num_samples():
    """num_samples > 1 over index-dependent HVPs (sample i draws indices
    i·depth + step), against the reference."""
    d, depth = 6, 50
    H = np.diag(np.linspace(0.5, 3.0, d)).astype(np.float32)
    v = np.ones(d, np.float32)
    Ht, Hj = torch.as_tensor(H), jnp.asarray(H)
    got = solvers.solve_lissa(
        lambda w: w @ Ht.T, t(v)[None], scale=10.0, recursion_depth=depth,
        num_samples=3,
        sample_hvp=lambda j, w: (w @ Ht.T) * (1.0 + 0.01 * np.cos(j)))
    want = ref_solvers.solve_lissa(
        lambda w: Hj @ w, jnp.asarray(v), scale=10.0, recursion_depth=depth,
        num_samples=3,
        sample_hvp=lambda j, w: Hj @ w * (1.0 + 0.01 * jnp.cos(
            jnp.float32(j))))
    np.testing.assert_allclose(got[0].numpy(), want, rtol=1e-5, atol=1e-6)
    one = solvers.solve_lissa(
        lambda w: w @ Ht.T, t(v)[None], scale=10.0, recursion_depth=depth,
        sample_hvp=lambda j, w: (w @ Ht.T) * (1.0 + 0.01 * np.cos(j)))
    assert not torch.allclose(one, got)  # the samples differ


def test_solve_direct_matches_reference():
    Hs, vs = _cg_lanes()
    got = solvers.solve_direct(t(Hs), t(vs))
    want = jax.vmap(ref_solvers.solve_direct)(jnp.asarray(Hs),
                                              jnp.asarray(vs))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)

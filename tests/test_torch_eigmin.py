"""λ_min of the sampled certificate's block Hessians
(``fia_tpu_torch/influence/kernels/eigmin.py``, the plain version of
``csrc/block_eigmin.cu``) against the reference's
``jnp.linalg.eigvalsh(H)[:, 0]`` (``fia_tpu/influence/engine.py:2504``).

Blocks come from the flat program on ``tiny_splits`` (the reference's
Hessian stage, and the port's sampled-mode Hessian stage at cap 8, for
MF and NCF) and from numpy seeds (diagonal, repeated eigenvalues,
indefinite, λ_min at a damping floor, random, d = 1 … 130). The bar is
c · d · eps · ‖H‖_F per block (eps the float32 unit roundoff) with
c = ``C_BAR``: both sides are float32 eigensolvers whose error is that
order (the plain Jacobi measured within 0.1 d eps ‖H‖_F of float64 on
these kinds at d = 8 … 256, so c = 1 leaves a tenfold margin). The plain
version is also held to float64 at the same bar, reads the lower
triangle only, propagates NaN per block, and gives a block the same bits
alone and in any batch. The CUDA kernel does the same operations in the
same order; ``chip_smoke.py`` holds it to this plain version on the card.
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
from fia_tpu_torch.data.dataset import RatingDataset
from fia_tpu_torch.influence.engine import InfluenceEngine
from fia_tpu_torch.influence.kernels import eigmin
from fia_tpu_torch.models import MF, NCF, params_from_numpy

torch.set_num_threads(2)

EPS = float(np.finfo(np.float32).eps)
C_BAR = 1.0
FAMILIES = {"mf": (MF, RefMF), "ncf": (NCF, RefNCF)}
SHAPE = (60, 40, 8)  # tiny_splits' users and items; k = 8: d = 18 / 32
DAMP = 1e-3


def _bar(H: np.ndarray) -> np.ndarray:
    d = H.shape[-1]
    return C_BAR * d * EPS * np.linalg.norm(
        H.reshape(len(H), -1).astype(np.float64), axis=1)


def _lower_mirrored(H: np.ndarray) -> np.ndarray:
    L = np.tril(H)
    return L + np.swapaxes(np.tril(H, -1), -1, -2)


def _hold(H: np.ndarray) -> np.ndarray:
    """The plain λ_min of ``H`` against the reference's float32
    eigvalsh and float64 eigvalsh (both of the lower triangle, mirrored),
    at the bar; returns the plain λ_min."""
    got = eigmin.block_eigmin_reference(torch.from_numpy(H)).numpy()
    Hs = _lower_mirrored(H)
    want = np.asarray(jnp.linalg.eigvalsh(jnp.asarray(Hs))[:, 0])
    exact = np.linalg.eigvalsh(Hs.astype(np.float64))[:, 0]
    bar = _bar(H)
    assert got.dtype == np.float32 and got.shape == (len(H),)
    assert np.all(np.abs(got - want) <= bar), np.max(np.abs(got - want) / bar)
    assert np.all(np.abs(got - exact) <= bar), np.max(np.abs(got - exact)
                                                      / bar)
    return got


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def engines(request, tiny_splits):
    Port, Ref = FAMILIES[request.param]
    x, y = tiny_splits["train"].x, tiny_splits["train"].y
    ref_model = Ref(*SHAPE, 1e-3)
    arrays = jax.tree_util.tree_map(
        np.asarray, ref_model.init_params(jax.random.PRNGKey(0)))
    model = Port(*SHAPE, 1e-3)
    port = InfluenceEngine(model, params_from_numpy(model, arrays, "cpu"),
                           RatingDataset(x, y), damping=DAMP, device="cpu",
                           solver="sampled", sampled_cap=8)
    ref = RefEngine(ref_model, arrays, RefDataset(x, y), damping=DAMP)
    pts = tiny_splits["test"].x[:20].astype(np.int64)
    return port, ref, pts


def test_reference_hessians(engines):
    """The reference's flat Hessian stage (the sampled rung's H at a cap
    above every count)."""
    port, ref, pts = engines
    counts, tx, s_pad = port._flat_inputs(pts)
    H = np.asarray(ref._flat_fn(s_pad, "hessian")(
        ref.params, ref.train_x, ref.train_y, ref._postings,
        jnp.asarray(tx.numpy()), ref._rowfeat))[: len(pts)]
    assert H.shape[1:] == (port.model.block_size,) * 2
    _hold(np.array(H))


def test_sampled_hessians(engines):
    """The port's sampled program's H at cap 8 (Horvitz–Thompson
    weights n/m on the sampled rows)."""
    port, _, pts = engines
    counts, tx, ws, m, s_pad = port._sampled_inputs(pts)
    assert np.any(counts > port.sampled_cap)
    H = port._flat_fn(s_pad, "hessian", mode="sampled")(
        port.params, port.train_x, port.train_y, port._postings, tx, ws,
        m).numpy()[: len(pts)]
    lam = _hold(H)
    # the blocks are damped positive definite: λ_min above the floor
    assert np.all(lam > 0.0)


def _synthetic(kind: str, d: int, T: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    Qm = np.linalg.qr(rng.standard_normal((T, d, d)))[0]
    if kind == "diagonal":
        return np.stack([np.diag(rng.standard_normal(d)) for _ in range(T)]
                        ).astype(np.float32)
    if kind == "repeated":
        lam = np.repeat([1.0, 2.0, 5.0], -(-d // 3))[:d]
    elif kind == "damping_floor":
        lam = np.concatenate([[1e-6], rng.uniform(0.5, 2.0, d - 1)])
    elif kind == "indefinite":
        W = rng.standard_normal((T, d, d))
        return ((W + np.swapaxes(W, 1, 2)) / 2).astype(np.float32)
    else:  # random: a damped Gauss-Newton sum of 64 rows
        G = rng.standard_normal((T, 64, d)) * 0.3
        return (np.einsum("tsi,tsj->tij", G, G) * (2 / 64)
                + 1e-6 * np.eye(d)).astype(np.float32)
    return ((Qm * lam[None, None, :]) @ np.swapaxes(Qm, 1, 2)).astype(
        np.float32)


KINDS = ("diagonal", "repeated", "indefinite", "damping_floor", "random")


@pytest.mark.parametrize("d", [18, 130])
@pytest.mark.parametrize("kind", KINDS)
def test_synthetic_blocks(kind, d):
    H = _synthetic(kind, d, 3, seed=d)
    lam = _hold(H)
    if kind == "diagonal":  # no rotation moves a diagonal block
        np.testing.assert_array_equal(lam, np.diagonal(H, 0, 1, 2).min(1))
    if kind == "indefinite":
        assert np.all(lam < 0.0)


@pytest.mark.parametrize("d", [1, 2, 7, 34, 64])
def test_random_blocks_at_widths(d):
    _hold(_synthetic("indefinite", d, 4, seed=d))


def test_bits_follow_the_block_alone():
    """A block's λ_min is the same bits alone, in a batch of 9 and in
    that batch reversed."""
    H = np.concatenate([_synthetic(k, 18, 2, seed=3) for k in KINDS[1:]]
                       + [_synthetic("diagonal", 18, 1, seed=4)])
    whole = eigmin.block_eigmin_reference(torch.from_numpy(H)).numpy()
    rev = eigmin.block_eigmin_reference(torch.from_numpy(
        np.ascontiguousarray(H[::-1]))).numpy()[::-1]
    assert whole.tobytes() == np.ascontiguousarray(rev).tobytes()
    for j in range(len(H)):
        alone = eigmin.block_eigmin_reference(
            torch.from_numpy(H[j: j + 1])).numpy()
        assert alone.tobytes() == whole[j: j + 1].tobytes(), j


def test_reads_the_lower_triangle_only():
    H = _synthetic("random", 18, 3, seed=5)
    noisy = H.copy()
    iu = np.triu_indices(18, 1)
    noisy[:, iu[0], iu[1]] = np.float32(np.nan)
    a = eigmin.block_eigmin_reference(torch.from_numpy(H)).numpy()
    b = eigmin.block_eigmin_reference(torch.from_numpy(noisy)).numpy()
    assert a.tobytes() == b.tobytes()


def test_nan_stays_in_its_block():
    H = _synthetic("random", 18, 3, seed=6)
    H[1, 5, 2] = np.float32(np.nan)
    lam = eigmin.block_eigmin_reference(torch.from_numpy(H)).numpy()
    assert np.isnan(lam[1]) and np.all(np.isfinite(lam[[0, 2]]))


@pytest.mark.parametrize("n", [2, 4, 18, 34, 130])
def test_round_robin_meets_every_pair_once(n):
    pairs = eigmin.round_robin(n).numpy()
    assert pairs.shape == (n - 1, n // 2, 2)
    for step in pairs:  # each step is a perfect matching of 0..n-1
        assert sorted(step.reshape(-1).tolist()) == list(range(n))
    met = {tuple(sorted(p)) for p in pairs.reshape(-1, 2).tolist()}
    assert len(met) == n * (n - 1) // 2


@pytest.mark.parametrize("d", [34, 64])
def test_fixed_sweeps_keep_a_margin(d):
    """Three sweeps fewer than :func:`eigmin.sweeps` already meet the
    bar on the slowest kinds measured (random Wishart and graded
    spectra), so the fixed count has room to spare."""
    rng = np.random.default_rng(d)
    W = rng.standard_normal((3, d, d))
    H = np.concatenate([
        (W @ np.swapaxes(W, 1, 2) / d),
        _synthetic("random", d, 2, seed=d + 1),
    ]).astype(np.float32)
    got = eigmin.block_eigmin_reference(
        torch.from_numpy(H), n_sweeps=eigmin.sweeps(d) - 3).numpy()
    exact = np.linalg.eigvalsh(H.astype(np.float64))[:, 0]
    assert np.all(np.abs(got - exact) <= _bar(H))


def test_sweeps_grow_with_the_block():
    assert [eigmin.sweeps(d) for d in (1, 16, 17, 34, 64, 130, 1024)] == [
        8, 8, 9, 10, 10, 12, 14]


def test_cpu_tensors_take_the_plain_version():
    H = torch.from_numpy(_synthetic("random", 18, 2, seed=7))
    before = eigmin.launches
    got = eigmin.block_eigmin(H)
    assert eigmin.launches == before
    assert got.numpy().tobytes() == eigmin.block_eigmin_reference(
        H).numpy().tobytes()
    assert eigmin.block_eigmin(H[:0]).shape == (0,)


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the block_eigmin kernel has no CPU "
                    "mode (chip_smoke.py holds it on the card)")
    H = torch.from_numpy(_synthetic("random", 34, 8, seed=8))
    got = eigmin.block_eigmin(H.cuda()).cpu().numpy()
    want = eigmin.block_eigmin_reference(H).numpy()
    assert np.all(np.abs(got - want) <= _bar(H.numpy()))

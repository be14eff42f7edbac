"""λ_min of the sampled certificate's block Hessians
(``fia_tpu_torch/influence/kernels/eigmin.py``, the plain version of
``csrc/block_eigmin.cu``) against the reference's
``jnp.linalg.eigvalsh(H)[:, 0]`` (``fia_tpu/influence/engine.py:2504``).

Blocks come from the flat program on ``tiny_splits`` (the reference's
Hessian stage, and the port's sampled-mode Hessian stage at cap 8, for
MF and NCF) and from numpy seeds (diagonal, repeated eigenvalues,
indefinite, λ_min at a damping floor, random, d = 1 … 514). The bar is
c · d · eps · ‖H‖_F per block (eps = 2⁻²³, float32's machine epsilon)
with c = ``C_BAR``: both sides are float32 eigensolvers whose error is
that order, and grows against d · eps ‖H‖_F as d falls: at d = 3 one
Householder step's cancellation in w = p − (τ/2)(pᵀv)v costs a few
eps ‖H‖, above c = 0.25's 0.75 eps ‖H‖_F, and float32 ``eigvalsh``
misses that bar too (``chip_smoke.py`` 8g prints c at d = 2 … 12 for
both). So the bar at c = 1 is held here at d = 1, 2, 7 and from 18 up,
and ``chip_smoke.py``'s c = 0.25 (``C_CHIP``) from d = 12 up
(:func:`test_chip_bar_holds_from_width_12`). The plain version is also
held to float64 at the same bar, reads the lower triangle only,
propagates NaN per block, and gives a block the same bits alone and in
any batch; its tridiagonal T keeps H's spectrum, its Sturm count
brackets the result to one float, one multisection round fewer still
meets the bar, and a diagonal block returns its smallest entry exactly.
The CUDA kernel does the same operations in the same order;
``chip_smoke.py`` holds it to this plain version bit for bit on the
card.
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
C_CHIP = 0.25  # chip_smoke.py's EIG_C
FAMILIES = {"mf": (MF, RefMF), "ncf": (NCF, RefNCF)}
SHAPE = (60, 40, 8)  # tiny_splits' users and items; k = 8: d = 18 / 32
DAMP = 1e-3


def _bar(H: np.ndarray, c: float = C_BAR) -> np.ndarray:
    d = H.shape[-1]
    return c * d * EPS * np.linalg.norm(
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


def _tridiagonal64(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(T, n, n) float64 tridiagonal matrices from T's diagonal and
    off-diagonal."""
    n = a.shape[1]
    M = np.zeros((len(a), n, n))
    idx = np.arange(n)
    M[:, idx, idx] = a
    M[:, idx[1:], idx[:-1]] = b
    M[:, idx[:-1], idx[1:]] = b
    return M


@pytest.mark.parametrize("d", [18, 34, 64, 130])
def test_tridiagonal_has_the_blocks_spectrum(d):
    """The Householder stage keeps H's spectrum: every eigenvalue of the
    plain version's T (float64 ``eigvalsh`` of T) within the bar of H's
    (float64 ``eigvalsh`` of H's lower triangle, mirrored)."""
    H = np.concatenate([_synthetic("random", d, 2, seed=d),
                        _synthetic("indefinite", d, 2, seed=d + 1)])
    a, b, ok = eigmin.tridiagonal_reference(torch.from_numpy(H))
    assert a.shape == (4, d) and b.shape == (4, d - 1) and bool(ok.all())
    got = np.linalg.eigvalsh(_tridiagonal64(a.double().numpy(),
                                            b.double().numpy()))
    want = np.linalg.eigvalsh(_lower_mirrored(H).astype(np.float64))
    assert np.all(np.abs(got - want) <= _bar(H)[:, None]), np.max(
        np.abs(got - want) / _bar(H)[:, None])


@pytest.mark.parametrize("kind", ["random", "indefinite", "repeated"])
def test_sturm_count_brackets_the_result(kind):
    """λ_min is the smallest float whose Sturm count is ≥ 1: the count is
    ≥ 1 at the returned value and 0 at the next float below it."""
    H = _synthetic(kind, 34, 3, seed=11)
    a, b, _ = eigmin.tridiagonal_reference(torch.from_numpy(H))
    lam = eigmin.block_eigmin_reference(torch.from_numpy(H))
    below = torch.from_numpy(np.nextafter(lam.numpy(), np.float32(-np.inf)))
    at = eigmin.sturm_count(a, b, lam[:, None])[:, 0]
    under = eigmin.sturm_count(a, b, below[:, None])[:, 0]
    assert bool((at >= 1).all()) and bool((under == 0).all()), (at, under)


@pytest.mark.parametrize("d", [34, 64])
def test_one_round_fewer_meets_the_bar(d):
    """One multisection round fewer than :data:`eigmin.ROUNDS` still
    meets the bar on the slowest kinds (random Wishart and graded
    spectra), so the fixed count has room to spare; the full count
    brings the bracket to one float."""
    rng = np.random.default_rng(d)
    W = rng.standard_normal((3, d, d))
    H = np.concatenate([
        (W @ np.swapaxes(W, 1, 2) / d),
        _synthetic("random", d, 2, seed=d + 1),
    ]).astype(np.float32)
    R, P = eigmin.ROUNDS, eigmin.STURM_POINTS
    assert (P + 1) ** R >= 2 ** 32 > (P + 1) ** (R - 1)
    got = eigmin.block_eigmin_reference(torch.from_numpy(H),
                                        n_rounds=R - 1).numpy()
    exact = np.linalg.eigvalsh(H.astype(np.float64))[:, 0]
    assert np.all(np.abs(got - exact) <= _bar(H))


@pytest.mark.parametrize("d", [12, 16])
@pytest.mark.parametrize("kind", ["random", "indefinite", "damping_floor",
                                  "repeated"])
def test_chip_bar_holds_from_width_12(kind, d):
    """From d = 12 up, 500 blocks of each kind meet ``chip_smoke.py``'s
    float64 bar (c = 0.25); below d = 12 the bar is out of this method's
    reach (the module's docstring), and the card reports c there beside
    float32 ``eigvalsh``'s."""
    H = _synthetic(kind, d, 500, seed=40 + d)
    exact = np.linalg.eigvalsh(_lower_mirrored(H).astype(np.float64))[:, 0]
    got = eigmin.block_eigmin_reference(torch.from_numpy(H)).numpy()
    bar = _bar(H, C_CHIP)
    assert np.all(np.abs(got - exact) <= bar), np.max(np.abs(got - exact)
                                                      / bar * C_CHIP)


@pytest.mark.parametrize("d", [1, 34, 130])
def test_diagonal_block_is_its_smallest_entry(d):
    """A diagonal block (T's off-diagonal exactly 0) returns its smallest
    diagonal entry bit for bit, ties and signs included."""
    H = _synthetic("diagonal", d, 3, seed=12 + d)
    H[1] = np.diag(np.full(d, -0.75, np.float32))
    lam = eigmin.block_eigmin_reference(torch.from_numpy(H)).numpy()
    assert lam.tobytes() == np.diagonal(H, 0, 1, 2).min(1).tobytes()


@pytest.mark.parametrize("d,T", [(258, 2), (514, 1)])
def test_wide_blocks_against_float64(d, T):
    """The widths above one CTA's shared memory on the card (RQ2's MF
    k = 128 and 256) against float64 at the bar."""
    H = _synthetic("random", d, T, seed=d)
    exact = np.linalg.eigvalsh(_lower_mirrored(H).astype(np.float64))[:, 0]
    got = eigmin.block_eigmin_reference(torch.from_numpy(H)).numpy()
    assert np.all(np.abs(got - exact) <= _bar(H))


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
    want = eigmin.block_eigmin_reference(H.cuda()).cpu().numpy()
    assert got.tobytes() == want.tobytes()

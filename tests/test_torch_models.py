"""The port's MF and NCF hooks and test vector against the reference's,
on the reference's own params carried across as numpy (rtol 1e-6, the
bar of tests/test_kernels.py:135-136)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fia_tpu.influence import grads as ref_grads
from fia_tpu.models import MF as RefMF
from fia_tpu.models import NCF as RefNCF
from fia_tpu_torch.influence import grads as port_grads
from fia_tpu_torch.models import MF, NCF, params_from_numpy

torch.set_num_threads(2)

U, I, K_EMB, WD = 24, 18, 4, 1e-3
RTOL, ATOL = 1e-6, 1e-7
FAMILIES = {"mf": (MF, RefMF), "ncf": (NCF, RefNCF)}
# per family: an embedding table, a zero-initialised bias, the block size
TABLE = {"mf": "P", "ncf": "P_mlp"}
BIAS = {"mf": "bu", "ncf": "b1"}
BLOCK = {"mf": 2 * K_EMB + 2, "ncf": 4 * K_EMB}


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def pair(request):
    Port, Ref = FAMILIES[request.param]
    ref = Ref(U, I, K_EMB, WD)
    arrays = dict(jax.tree_util.tree_map(
        np.asarray, ref.init_params(jax.random.PRNGKey(0))
    ))
    # non-zero biases, so the bias terms are exercised too
    rng = np.random.default_rng(1)
    if request.param == "mf":
        arrays["bu"] = rng.standard_normal(U).astype(np.float32)
        arrays["bi"] = rng.standard_normal(I).astype(np.float32)
        arrays["bg"] = np.float32(0.3)
    else:
        for name in ("b1", "b2", "b3"):
            shape = arrays[name].shape
            arrays[name] = 0.1 * rng.standard_normal(shape).astype(np.float32)
    port = Port(U, I, K_EMB, WD)
    ref_params = jax.tree_util.tree_map(jnp.asarray, arrays)
    return ref, ref_params, port, params_from_numpy(port, arrays, "cpu")


def _x(n=50, seed=2):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, U, n), rng.integers(0, I, n)],
                    axis=1).astype(np.int32)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


def test_predict(pair):
    ref, rp, port, pp = pair
    x = _x()
    _close(port.predict(pp, torch.as_tensor(x)), ref.predict(rp, x))


def test_block_and_flatten(pair):
    ref, rp, port, pp = pair
    blk = port.extract_block(pp, 3, 5)
    rblk = ref.extract_block(rp, 3, 5)
    for k in ref.block_keys:
        _close(blk[k], rblk[k])
    flat = port.flatten_block(blk)
    _close(flat, ref.flatten_block(rblk))
    back = port.unflatten_block(flat, blk)
    assert all(torch.equal(back[k], blk[k]) for k in port.block_keys)
    assert port.block_size == ref.block_size
    assert port.block_size == BLOCK[port.kernel_family]


def test_block_predict(pair):
    ref, rp, port, pp = pair
    x = _x()
    x[:10, 0] = 3
    x[5:15, 1] = 5
    rng = np.random.default_rng(3)
    vec = rng.standard_normal(port.block_size).astype(np.float32)
    blk = port.unflatten_block(torch.as_tensor(vec),
                               port.extract_block(pp, 3, 5))
    rblk = ref.unflatten_block(jnp.asarray(vec), ref.extract_block(rp, 3, 5))
    _close(port.block_predict(pp, blk, 3, 5, torch.as_tensor(x)),
           ref.block_predict(rp, rblk, 3, 5, x))


@pytest.mark.parametrize("per_row", [False, True])
def test_block_row_grads(pair, per_row):
    ref, rp, port, pp = pair
    x = _x(64)
    if per_row:  # the flat engine's layout: per-row owning-query ids
        u, i = _x(64, seed=9).T
        x[::2, 0] = u[::2]
        x[1::3, 1] = i[1::3]
        got = port.block_row_grads(pp, torch.as_tensor(u), torch.as_tensor(i),
                                   torch.as_tensor(x))
    else:
        u, i = 3, 5
        x[:20, 0] = u
        x[10:30, 1] = i
        got = port.block_row_grads(pp, u, i, torch.as_tensor(x))
    _close(got, ref.block_row_grads(rp, u, i, x))


def test_gauss_newton_constants(pair):
    ref, rp, port, pp = pair
    _close(port.block_cross_const(pp), ref.block_cross_const(rp))
    _close(port.block_reg_diag(pp), ref.block_reg_diag(rp))
    _close(port.reg_loss(pp), ref.reg_loss(rp))


@pytest.mark.parametrize("u,i", [(3, 5), (0, 0), (23, 17)])
def test_block_prediction_grad(pair, u, i):
    ref, rp, port, pp = pair
    xq = np.asarray([[u, i]], np.int32)
    _close(port_grads.block_prediction_grad(port, pp, u, i,
                                            torch.as_tensor(xq)),
           ref_grads.block_prediction_grad(ref, rp, u, i, xq))


def test_block_prediction_grad_batched(pair):
    """The engine's form: vmap over (u, i, x) gives the per-query
    vectors."""
    ref, rp, port, pp = pair
    tx = _x(7, seed=4)
    got = torch.func.vmap(
        lambda uu, ii, xj: port_grads.block_prediction_grad(
            port, pp, uu, ii, xj[None, :])
    )(torch.as_tensor(tx[:, 0]), torch.as_tensor(tx[:, 1]),
      torch.as_tensor(tx))
    want = np.stack([
        np.asarray(ref_grads.block_prediction_grad(ref, rp, int(u), int(i),
                                                   tx[j:j + 1]))
        for j, (u, i) in enumerate(tx)
    ])
    _close(got, want)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_init_params_seeded(family):
    port = FAMILIES[family][0](U, I, K_EMB, WD)
    a = port.init_params(torch.Generator().manual_seed(0))
    b = port.init_params(torch.Generator().manual_seed(0))
    c = port.init_params(torch.Generator().manual_seed(1))
    assert {k: tuple(v.shape) for k, v in a.items()} == port.param_shapes()
    assert all(torch.equal(a[k], b[k]) for k in a)
    table, bias = TABLE[family], BIAS[family]
    assert not torch.equal(a[table], c[table])
    # truncated at 2 sigma, sigma = 1/sqrt(k)
    assert float(a[table].abs().max()) <= 2.0 / np.sqrt(K_EMB) + 1e-6
    assert float(a[bias].abs().max()) == 0.0


def test_ncf_init_params_stddevs():
    """Weights at 1/sqrt(fan_in), the seven draws distinct."""
    p = NCF(U, I, K_EMB, WD).init_params(torch.Generator().manual_seed(0))
    k, k2 = K_EMB, K_EMB // 2
    for name, fan_in in (("W1", 2 * k), ("W2", k), ("W3", k2 + k)):
        assert float(p[name].abs().max()) <= 2.0 / np.sqrt(fan_in) + 1e-6
    assert not torch.equal(p["P_mlp"], p["P_gmf"])
    assert all(float(p[b].abs().max()) == 0.0 for b in ("b1", "b2", "b3"))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_params_from_numpy_validates(family):
    port = FAMILIES[family][0](U, I, K_EMB, WD)
    good = {k: np.zeros(s, np.float32) for k, s in port.param_shapes().items()}
    assert set(params_from_numpy(port, good, "cpu")) == set(good)
    with pytest.raises(ValueError, match="names"):
        params_from_numpy(port, {**good, "extra": np.zeros(1)}, "cpu")
    bad = TABLE[family]
    with pytest.raises(ValueError, match="shape"):
        params_from_numpy(port, {**good, bad: np.zeros((U, K_EMB + 1))}, "cpu")


def test_ncf_param_shapes_match_reference():
    """The reference's own params carry across: every name and shape,
    b3 (1,) included."""
    ref = RefNCF(U, I, K_EMB, WD)
    arrays = jax.tree_util.tree_map(
        np.asarray, ref.init_params(jax.random.PRNGKey(0)))
    port = NCF(U, I, K_EMB, WD)
    assert {k: a.shape for k, a in arrays.items()} == port.param_shapes()
    assert port.param_shapes()["b3"] == (1,)
    with pytest.raises(ValueError, match="shape"):
        params_from_numpy(port, {**arrays, "W2": np.zeros((K_EMB, K_EMB))},
                          "cpu")


def test_ncf_own_grads_match_autograd():
    """The closed-form own-row backward equals torch.autograd of the
    row sum (each r̂_j touches only row j's rows)."""
    port = NCF(U, I, K_EMB, WD)
    pp = port.init_params(torch.Generator().manual_seed(2))
    pp["b1"] = 0.1 * torch.randn(K_EMB, generator=torch.Generator().manual_seed(3))
    xu, xi = (torch.as_tensor(c) for c in _x(64).T)
    rows = [pp[n][ix].clone().requires_grad_(True) for n, ix in
            (("P_mlp", xu), ("Q_mlp", xi), ("P_gmf", xu), ("Q_gmf", xi))]
    total = torch.sum(port._head(pp, *rows))
    want = torch.autograd.grad(total, rows)
    for got, w in zip(port.own_grads(pp, xu, xi), want):
        _close(got, w)


def _rows(pair, n=40):
    """Rows (x, y, w) with some sharing user 3 / item 5, one equal to the
    pair (3, 5) itself, and fractional weights with two masked rows."""
    x = _x(n, seed=5)
    x[:8, 0] = 3
    x[6:14, 1] = 5
    rng = np.random.default_rng(6)
    y = rng.integers(1, 6, n).astype(np.float32)
    w = rng.uniform(0.3, 1.0, n).astype(np.float32)
    w[-2:] = 0.0
    return x, y, w


def test_losses(pair):
    ref, rp, port, pp = pair
    x, y, w = _rows(pair)
    tx, ty, tw = (torch.as_tensor(a) for a in (x, y, w))
    _close(port.indiv_loss(pp, tx, ty), ref.indiv_loss(rp, x, y))
    _close(port.loss(pp, tx, ty), ref.loss(rp, x, y))
    _close(port.loss(pp, tx, ty, tw), ref.loss(rp, x, y, w))
    _close(port.loss_no_reg(pp, tx, ty, tw), ref.loss_no_reg(rp, x, y, w))
    _close(port.mae(pp, tx, ty), ref.mae(rp, x, y))


def test_block_reg_and_block_loss(pair):
    """The scatter-free block_reg equals the reference's and the generic
    (substitute-then-regularise) form; block_loss the reference's."""
    ref, rp, port, pp = pair
    x, y, w = _rows(pair)
    rng = np.random.default_rng(7)
    vec = rng.standard_normal(port.block_size).astype(np.float32)
    blk = port.unflatten_block(torch.as_tensor(vec),
                               port.extract_block(pp, 3, 5))
    rblk = ref.unflatten_block(jnp.asarray(vec), ref.extract_block(rp, 3, 5))
    got = port.block_reg(pp, blk, 3, 5)
    _close(got, ref.block_reg(rp, rblk, 3, 5))
    generic = type(port).__mro__[1].block_reg(port, pp, blk, 3, 5)
    np.testing.assert_allclose(float(got), float(generic), rtol=1e-5)
    _close(port.block_loss(pp, blk, 3, 5, torch.as_tensor(x),
                           torch.as_tensor(y), torch.as_tensor(w)),
           ref.block_loss(rp, rblk, 3, 5, x, y, w))
    # the generic block_predict (substitute, then predict) agrees too
    base_predict = type(port).__mro__[1].block_predict
    _close(base_predict(port, pp, blk, 3, 5, torch.as_tensor(x)),
           port.block_predict(pp, blk, 3, 5, torch.as_tensor(x)))


def test_block_hessian(pair):
    """The closed-form block Hessian against the reference's, on rows
    with the cross term live and masked rows."""
    ref, rp, port, pp = pair
    x, y, w = _rows(pair)
    got = port.block_hessian(pp, 3, 5, torch.as_tensor(x), torch.as_tensor(y),
                             torch.as_tensor(w))
    want = ref.block_hessian(rp, 3, 5, x, y, w)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    assert torch.allclose(got, got.T)


def test_gradient_helpers(pair):
    """block_loss_grad, per_example_block_loss_grads (each row with the
    full regulariser), autodiff_row_grads (scalar and per-row ids) and
    per_example_block_prediction_grads against the reference's."""
    ref, rp, port, pp = pair
    x, y, w = _rows(pair)
    tx, ty, tw = (torch.as_tensor(a) for a in (x, y, w))
    _close(port_grads.block_loss_grad(port, pp, 3, 5, tx, ty, tw),
           ref_grads.block_loss_grad(ref, rp, 3, 5, x, y, w))
    _close(port_grads.per_example_block_loss_grads(port, pp, 3, 5, tx, ty),
           ref_grads.per_example_block_loss_grads(ref, rp, 3, 5, x, y))
    _close(port_grads.autodiff_row_grads(port, pp, 3, 5, tx),
           ref_grads.autodiff_row_grads(ref, rp, 3, 5, x))
    u, i = _x(len(x), seed=8).T
    _close(port_grads.autodiff_row_grads(port, pp, torch.as_tensor(u),
                                         torch.as_tensor(i), tx),
           ref_grads.autodiff_row_grads(ref, rp, u, i, x))
    _close(port_grads.per_example_block_prediction_grads(port, pp, 3, 5, tx),
           ref_grads.per_example_block_prediction_grads(ref, rp, 3, 5, x))

"""The MF and NCF score kernels' plain versions against the reference's
score kernels, on the operand setup of tests/test_kernels.py
(S ∈ {37, 64}, a fully masked segment, rows matching neither query id).

The reference runs its Pallas kernel in interpret mode and its XLA
analytic twin; the port's plain version must match both at the bar
rtol 2e-5, atol 1e-6, and score masked rows exactly 0. The CUDA kernel
itself runs only on the card (``python3 chip_smoke.py`` holds it against
this plain version there)."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from fia_tpu.influence import kernels as RK
from fia_tpu.models import MF as RefMF
from fia_tpu.models import NCF as RefNCF
from fia_tpu_torch.influence import kernels as K
from fia_tpu_torch.influence.kernels import common
from fia_tpu_torch.influence.kernels import mf as kmf
from fia_tpu_torch.influence.kernels import ncf as kncf
from fia_tpu_torch.models import MF, NCF, params_from_numpy

torch.set_num_threads(2)

U, I, K_EMB, WD = 24, 18, 4, 1e-3
RTOL, ATOL = 2e-5, 1e-6
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILIES = {"mf": (MF, RefMF, kmf), "ncf": (NCF, RefNCF, kncf)}


def _operands(s, family="mf", seed=3):
    """tests/test_kernels.py:144-166."""
    ref = FAMILIES[family][1](U, I, K_EMB, WD)
    arrays = jax.tree_util.tree_map(
        np.asarray, ref.init_params(jax.random.PRNGKey(seed)))
    rng_train = np.random.default_rng(seed)
    train_x = np.stack([rng_train.integers(0, U - 1, 400),
                        rng_train.integers(0, I - 1, 400)],
                       axis=1).astype(np.int32)
    rng = np.random.default_rng(s)
    T = 5
    q = np.stack([rng.integers(0, U - 1, T), rng.integers(0, I - 1, T)],
                 axis=1).astype(np.int32)
    t = np.sort(rng.integers(0, T, s)).astype(np.int32)
    ut, it = q[t, 0], q[t, 1]
    rel_x = train_x[rng.integers(0, len(train_x), s)].copy()
    rel_x[: s // 2, 0] = ut[: s // 2]
    rel_x[s // 3 : s // 2, 1] = it[s // 3 : s // 2]
    e = rng.standard_normal(s).astype(np.float32)
    wv = (rng.random(s) < 0.8).astype(np.float32)
    wv[t == 0] = 0.0  # segment 0: all rows masked
    d = ref.block_size
    ihvp = rng.standard_normal((T, d)).astype(np.float32)
    reg_dot = rng.standard_normal(T).astype(np.float32)
    n_t = np.maximum(np.bincount(t, minlength=T), 1).astype(np.float32)
    return ref, arrays, (q, t, ut, it, rel_x, e, wv, ihvp, reg_dot, n_t)


def _port_args(arrays, ops, family="mf"):
    """The port's model, params and the kernel wrapper's operands
    ``(rel_x, t, e, wv, tx, *tables, B)``."""
    q, t, _, _, rel_x, e, wv, ihvp, reg_dot, n_t = ops
    model = FAMILIES[family][0](U, I, K_EMB, WD)
    params = params_from_numpy(model, arrays, "cpu")
    B = common.query_matrix(*(torch.as_tensor(a) for a in (ihvp, reg_dot, n_t)))
    return model, params, (
        torch.as_tensor(rel_x), torch.as_tensor(t), torch.as_tensor(e),
        torch.as_tensor(wv), torch.as_tensor(q),
        *model.kernel_operands(params), B)


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("variant", ["pallas", "xla_analytic"])
@pytest.mark.parametrize("s", [37, 64])
def test_plain_version_matches_reference(variant, s, family):
    ref, arrays, ops = _operands(s, family)
    q, t, ut, it, rel_x, e, wv, ihvp, reg_dot, n_t = ops
    rp = jax.tree_util.tree_map(jax.numpy.asarray, arrays)
    want = np.asarray(RK.fused_scores(ref, variant, rp, ut, it, t, rel_x, e,
                                      wv, ihvp, reg_dot, n_t))
    _, _, args = _port_args(arrays, ops, family)
    got = FAMILIES[family][2].fused_scores_reference(*args).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert (got[wv == 0.0] == 0.0).all()  # masked rows score exactly 0


def test_ncf_plain_version_in_float64():
    """The plain version keeps the operands' dtype: in float64 it agrees
    with float32 at the bar (the on-card reference of wide k)."""
    _, arrays, ops = _operands(64, "ncf")
    _, _, args = _port_args(arrays, ops, "ncf")
    wide = [a.double() if a.is_floating_point() else a for a in args]
    got = kncf.fused_scores_reference(*wide)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(
        kncf.fused_scores_reference(*args).numpy(), got.numpy(),
        rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_wrapper_and_dispatch_on_cpu_take_the_plain_version(family):
    _, arrays, ops = _operands(37, family)
    model, params, args = _port_args(arrays, ops, family)
    mod = FAMILIES[family][2]
    want = mod.fused_scores_reference(*args)
    before = mod.launches
    assert torch.equal(mod.fused_scores(*args), want)
    rel_x, t, e, wv, tx, B = (*args[:5], args[-1])
    assert torch.equal(
        K.fused_scores(model, "torch", params, tx, t, rel_x, e, wv, B), want)
    assert mod.launches == before  # no kernel launched on the CPU


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_cuda_variant_on_cpu_raises(family):
    _, arrays, ops = _operands(37, family)
    model, params, args = _port_args(arrays, ops, family)
    rel_x, t, e, wv, tx, B = (*args[:5], args[-1])
    with pytest.raises(ValueError, match="cuda"):
        K.fused_scores(model, "cuda", params, tx, t, rel_x, e, wv, B)
    with pytest.raises(ValueError, match="CUDA device"):
        K.resolve_variant("cuda", model, "cpu")


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("requested,want", [("auto", "torch"),
                                            ("torch", "torch")])
def test_resolve_variant_on_cpu(requested, want, family):
    model = FAMILIES[family][0](U, I, K_EMB, WD)
    assert K.resolve_variant(requested, model, "cpu") == want


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_resolve_variant_on_a_cuda_device_is_the_kernel(family):
    """Both families resolve to their CUDA kernel on a CUDA device (no
    card needed to resolve)."""
    model = FAMILIES[family][0](U, I, K_EMB, WD)
    assert K.supports_cuda(model)
    assert K.resolve_variant("auto", model, "cuda") == "cuda"
    assert K.resolve_variant("cuda", model, "cuda") == "cuda"


def test_resolve_variant_rejects_unknown_and_unported():
    with pytest.raises(ValueError, match="unknown"):
        K.resolve_variant("pallas", MF(U, I, K_EMB, WD), "cpu")

    class NoKernel:
        kernel_family = None

    with pytest.raises(NotImplementedError, match="no score kernel"):
        K.resolve_variant("auto", NoKernel(), "cuda")
    with pytest.raises(NotImplementedError, match="no score kernel"):
        K.fused_scores(NoKernel(), "torch", {}, None, None, None, None, None,
                       None)


_BAD = {
    "long": (lambda x: x.long(), TypeError),
    "double": (lambda x: x.double(), TypeError),
    "short": (lambda x: x[:-1], ValueError),
    "narrow": (lambda x: x[:, :-1], ValueError),
    "strided": (lambda x: x.t().contiguous().t(), ValueError),
    "elsewhere": (lambda x: x.to("meta"), ValueError),
}


@pytest.mark.parametrize("family,field,bad", [
    ("mf", "t", "long"), ("mf", "e", "double"), ("mf", "wv", "short"),
    ("mf", "B", "narrow"), ("mf", "P", "strided"),
    ("ncf", "rel_x", "long"), ("ncf", "t", "long"), ("ncf", "e", "double"),
    ("ncf", "wv", "short"), ("ncf", "tx", "narrow"), ("ncf", "B", "narrow"),
    ("ncf", "P_mlp", "strided"), ("ncf", "Q_gmf", "double"),
    ("ncf", "W1", "narrow"), ("ncf", "b1", "short"), ("ncf", "W2", "narrow"),
    ("ncf", "b2", "double"), ("ncf", "W3", "short"), ("ncf", "Q_mlp",
                                                     "elsewhere"),
])
def test_operand_checks(family, field, bad):
    _, arrays, ops = _operands(64, family)
    _, _, args = _port_args(arrays, ops, family)
    names = {"mf": ("rel_x", "t", "e", "wv", "tx", "P", "Q", "B"),
             "ncf": kncf._NAMES}[family]
    args = list(args)
    j = names.index(field)
    fn, err = _BAD[bad]
    args[j] = fn(args[j])
    with pytest.raises(err):
        FAMILIES[family][2]._check(*args)


@pytest.mark.parametrize("name", ["mf_scores", "ncf_scores"])
def test_library_path_keyed_by_source(name):
    p = common.library_path(name)
    assert p.startswith(common.BUILD_DIR) and p.endswith(".so")
    assert p == common.library_path(name)
    assert name in os.path.basename(p)
    other = ({"mf_scores", "ncf_scores"} - {name}).pop()
    assert common.library_path(other) != p


def test_no_nvcc_raises(monkeypatch):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setenv("PATH", "")
    monkeypatch.setattr(common, "NVCC_DIRS", ())
    with pytest.raises(RuntimeError, match="nvcc not found"):
        common.find_nvcc()


def test_modules_import_without_nvcc():
    env = {k: v for k, v in os.environ.items() if k != "CUDA_HOME"}
    env["PATH"] = os.path.dirname(sys.executable)
    code = ("import fia_tpu_torch.influence.kernels.mf, "
            "fia_tpu_torch.influence.kernels.ncf, fia_tpu_torch.models.ncf, "
            "fia_tpu_torch.influence.engine")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                   check=True, timeout=120)

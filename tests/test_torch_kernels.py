"""The MF score kernel's plain version against the reference's score
kernels, on the operand setup of tests/test_kernels.py (S ∈ {37, 64},
a fully masked segment, rows matching neither query id).

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
from fia_tpu_torch.influence import kernels as K
from fia_tpu_torch.influence.kernels import common
from fia_tpu_torch.influence.kernels import mf as kmf
from fia_tpu_torch.models import MF, params_from_numpy

torch.set_num_threads(2)

U, I, K_EMB, WD = 24, 18, 4, 1e-3
RTOL, ATOL = 2e-5, 1e-6
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _operands(s, seed=3):
    """tests/test_kernels.py:144-166, the MF case."""
    ref = RefMF(U, I, K_EMB, WD)
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


def _port_args(arrays, ops):
    q, t, _, _, rel_x, e, wv, ihvp, reg_dot, n_t = ops
    params = params_from_numpy(MF(U, I, K_EMB, WD), arrays, "cpu")
    B = common.query_matrix(*(torch.as_tensor(a) for a in (ihvp, reg_dot, n_t)))
    return params, (torch.as_tensor(rel_x), torch.as_tensor(t),
                    torch.as_tensor(e), torch.as_tensor(wv),
                    torch.as_tensor(q), params["P"], params["Q"], B)


@pytest.mark.parametrize("variant", ["pallas", "xla_analytic"])
@pytest.mark.parametrize("s", [37, 64])
def test_plain_version_matches_reference(variant, s):
    ref, arrays, ops = _operands(s)
    q, t, ut, it, rel_x, e, wv, ihvp, reg_dot, n_t = ops
    rp = jax.tree_util.tree_map(jax.numpy.asarray, arrays)
    want = np.asarray(RK.fused_scores(ref, variant, rp, ut, it, t, rel_x, e,
                                      wv, ihvp, reg_dot, n_t))
    _, args = _port_args(arrays, ops)
    got = kmf.fused_scores_reference(*args).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert (got[wv == 0.0] == 0.0).all()  # masked rows score exactly 0


def test_wrapper_and_dispatch_on_cpu_take_the_plain_version():
    _, arrays, ops = _operands(37)
    params, args = _port_args(arrays, ops)
    want = kmf.fused_scores_reference(*args)
    before = kmf.launches
    assert torch.equal(kmf.fused_scores(*args), want)
    rel_x, t, e, wv, tx, _, _, B = args
    model = MF(U, I, K_EMB, WD)
    assert torch.equal(
        K.fused_scores(model, "torch", params, tx, t, rel_x, e, wv, B), want)
    assert kmf.launches == before  # no kernel launched on the CPU


def test_cuda_variant_on_cpu_raises():
    _, arrays, ops = _operands(37)
    params, args = _port_args(arrays, ops)
    rel_x, t, e, wv, tx, _, _, B = args
    model = MF(U, I, K_EMB, WD)
    with pytest.raises(ValueError, match="cuda"):
        K.fused_scores(model, "cuda", params, tx, t, rel_x, e, wv, B)
    with pytest.raises(ValueError, match="CUDA device"):
        K.resolve_variant("cuda", model, "cpu")


@pytest.mark.parametrize("requested,want", [("auto", "torch"),
                                            ("torch", "torch")])
def test_resolve_variant_on_cpu(requested, want):
    assert K.resolve_variant(requested, MF(U, I, K_EMB, WD), "cpu") == want


def test_resolve_variant_rejects_unknown_and_unported():
    with pytest.raises(ValueError, match="unknown"):
        K.resolve_variant("pallas", MF(U, I, K_EMB, WD), "cpu")

    class NoKernel:
        kernel_family = None

    with pytest.raises(NotImplementedError, match="B.2"):
        K.resolve_variant("auto", NoKernel(), "cuda")


@pytest.mark.parametrize("field,bad,err", [
    ("t", lambda x: x.long(), TypeError),
    ("e", lambda x: x.double(), TypeError),
    ("wv", lambda x: x[:-1], ValueError),
    ("B", lambda x: x[:, :-1], ValueError),
    ("P", lambda x: x.t().contiguous().t(), ValueError),
])
def test_operand_checks(field, bad, err):
    _, arrays, ops = _operands(64)
    _, args = _port_args(arrays, ops)
    names = ("rel_x", "t", "e", "wv", "tx", "P", "Q", "B")
    args = list(args)
    j = names.index(field)
    args[j] = bad(args[j])
    with pytest.raises(err):
        kmf._check(*args)


def test_library_path_keyed_by_source():
    p = common.library_path("mf_scores")
    assert p.startswith(common.BUILD_DIR) and p.endswith(".so")
    assert p == common.library_path("mf_scores")
    assert "mf_scores" in p


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
            "fia_tpu_torch.influence.engine")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                   check=True, timeout=120)

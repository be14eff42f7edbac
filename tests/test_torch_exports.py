"""The port's package surface against the reference's (ROADMAP C.6).

Every name a reference package ``__init__`` exports imports from its port
twin (the re-exports are lazy: importing a package loads no more than
before), save the Pallas-only ``supports_pallas`` and
``_PALLAS_FAMILIES`` and the names the port dropped (``DROPPED``);
every reference package has its twin (``NOT_YET`` is empty). The full-parameter gradient
helpers of ``influence/grads.py`` and the models' ``adversarial_loss``
hook are held to the reference's on the same params (MF and NCF).
"""

import ast
import importlib
import importlib.util
import os

import jax
import numpy as np
import pytest
import torch

from fia_tpu.influence import grads as ref_grads
from fia_tpu.models import MF as RefMF
from fia_tpu.models import NCF as RefNCF
from fia_tpu_torch.influence import grads
from fia_tpu_torch.models import MF, NCF, params_from_numpy

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PALLAS_ONLY = {"supports_pallas", "_PALLAS_FAMILIES"}
# reference exports the port removed, each with why nothing needs it
DROPPED = {
    ("fia_tpu.utils", "Timer"): "no port module called it; the engine's "
    "obs spans time its steps and mirror into a torch profiler's trace",
}
# reference packages whose port is a later Queue A item (none is left)
NOT_YET: dict[str, str] = {}


def _exports(path: str) -> list[str]:
    """The names a reference ``__init__`` binds: its imports from the
    package, and its own functions, classes and assignments."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = []
    for node in tree.body:
        if isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module.split(".")[0] == "fia_tpu":
            names += [a.asname or a.name for a in node.names]
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.append(node.name)
        elif isinstance(node, ast.Assign):
            names += [t.id for t in node.targets if isinstance(t, ast.Name)]
    return names


def _reference_exports() -> list[tuple[str, str]]:
    out = []
    for root, _, files in sorted(os.walk(os.path.join(REPO, "fia_tpu"))):
        if "__init__.py" not in files:
            continue
        pkg = os.path.relpath(root, REPO).replace(os.sep, ".")
        if pkg in NOT_YET:
            continue
        out += [(pkg, n) for n in _exports(os.path.join(root, "__init__.py"))
                if n not in PALLAS_ONLY and (pkg, n) not in DROPPED]
    return out


EXPORTS = _reference_exports()


def test_every_reference_package_is_covered():
    pkgs = {p for p, _ in EXPORTS}
    assert {"fia_tpu", "fia_tpu.data", "fia_tpu.influence", "fia_tpu.models",
            "fia_tpu.train", "fia_tpu.eval", "fia_tpu.parallel",
            "fia_tpu.reliability", "fia_tpu.utils",
            "fia_tpu.influence.kernels", "fia_tpu.chaos",
            "fia_tpu.analysis", "fia_tpu.backends"} <= pkgs
    # the packages left out are exactly those no port module exists for
    for pkg in NOT_YET:
        twin = "fia_tpu_torch" + pkg[len("fia_tpu"):]
        assert importlib.util.find_spec(twin) is None, twin


@pytest.mark.parametrize("pkg,name", EXPORTS,
                         ids=[f"{p}:{n}" for p, n in EXPORTS])
def test_reference_export_imports_from_the_port(pkg, name):
    twin = importlib.import_module("fia_tpu_torch" + pkg[len("fia_tpu"):])
    got = getattr(twin, name)
    assert got is not None
    ref = getattr(importlib.import_module(pkg), name)
    # a module re-export is the twin's module of the same name
    if isinstance(ref, type(os)):
        assert isinstance(got, type(os))
        assert got.__name__.rsplit(".", 1)[-1] == ref.__name__.rsplit(
            ".", 1)[-1]


@pytest.mark.parametrize("pkg,name", sorted(DROPPED),
                         ids=[f"{p}:{n}" for p, n in sorted(DROPPED)])
def test_dropped_export_is_gone_from_the_port(pkg, name):
    """A name the port dropped is exported by the reference and by no
    port package."""
    assert name in _exports(os.path.join(REPO, *pkg.split("."),
                                         "__init__.py"))
    twin = importlib.import_module("fia_tpu_torch" + pkg[len("fia_tpu"):])
    assert not hasattr(twin, name)


def test_models_registry():
    from fia_tpu_torch.models import MODELS

    assert MODELS == {"MF": MF, "NCF": NCF}


FAMILIES = {"mf": (MF, RefMF), "ncf": (NCF, RefNCF)}


def _setup(family):
    port_cls, ref_cls = FAMILIES[family]
    ref = ref_cls(12, 9, 3, 1e-2)
    arrays = jax.tree_util.tree_map(
        np.asarray, ref.init_params(jax.random.PRNGKey(1)))
    port = port_cls(12, 9, 3, 1e-2)
    rng = np.random.default_rng(2)
    x = np.stack([rng.integers(0, 12, 30), rng.integers(0, 9, 30)],
                 1).astype(np.int32)
    y = rng.integers(1, 6, 30).astype(np.float32)
    w = (rng.random(30) > 0.3).astype(np.float32)
    return ref, arrays, port, params_from_numpy(port, arrays, "cpu"), x, y, w


def _close(got: dict, want) -> None:
    want = jax.tree_util.tree_map(np.asarray, want)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-5,
                                   atol=1e-7, err_msg=k)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_full_loss_grads_match_reference(family):
    ref, arrays, port, params, x, y, w = _setup(family)
    tx, ty, tw = map(torch.as_tensor, (x, y, w))
    _close(grads.full_loss_grad(port, params, tx, ty),
           ref_grads.full_loss_grad(ref, arrays, x, y))
    _close(grads.full_loss_grad(port, params, tx, ty, tw),
           ref_grads.full_loss_grad(ref, arrays, x, y, w))
    _close(grads.full_loss_no_reg_grad(port, params, tx, ty, tw),
           ref_grads.full_loss_no_reg_grad(ref, arrays, x, y, w))
    per = grads.per_example_full_loss_grads(port, params, x[:7], y[:7])
    _close(per, ref_grads.per_example_full_loss_grads(ref, arrays, x[:7],
                                                      y[:7]))
    # row j is the gradient of row j's loss fed alone
    one = grads.full_loss_grad(port, params, tx[3:4], ty[3:4])
    for k in one:
        torch.testing.assert_close(per[k][3], one[k], rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_adversarial_loss_hook(family):
    ref, arrays, port, params, x, y, _ = _setup(family)
    assert port.adversarial_loss(params, x, y) == (None, None)
    assert ref.adversarial_loss(arrays, x, y) == (None, None)

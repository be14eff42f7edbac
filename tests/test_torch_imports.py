"""The port stands alone: importing every module of ``fia_tpu_torch``
and ``chip_smoke`` loads no JAX and nothing of the ``fia_tpu`` package,
and the entry points default to CUDA, raising without it."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import fia_tpu_torch
from fia_tpu_torch.data.dataset import RatingDataset
from fia_tpu_torch.device import resolve_device
from fia_tpu_torch.influence.engine import InfluenceEngine
from fia_tpu_torch.models import MF, NCF

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.dirname(os.path.abspath(fia_tpu_torch.__file__))
FORBIDDEN = ("jax", "jaxlib", "fia_tpu")
NCF_MODULES = ("fia_tpu_torch.models.ncf", "fia_tpu_torch.influence.kernels.ncf")
# the padded program's modules
PADDED_MODULES = ("fia_tpu_torch.influence.hvp",
                  "fia_tpu_torch.influence.spectral",
                  "fia_tpu_torch.influence.solvers",
                  "fia_tpu_torch.reliability.policy",
                  "fia_tpu_torch.reliability.taxonomy")
# the training and experiment path
TRAIN_MODULES = ("fia_tpu_torch.train.trainer",
                 "fia_tpu_torch.train.checkpoint",
                 "fia_tpu_torch.eval.metrics",
                 "fia_tpu_torch.eval.rq1",
                 "fia_tpu_torch.eval.rq2",
                 "fia_tpu_torch.data.loaders",
                 "fia_tpu_torch.cli.common",
                 "fia_tpu_torch.cli.rq1",
                 "fia_tpu_torch.cli.rq2",
                 "fia_tpu_torch.reliability.artifacts",
                 "fia_tpu_torch.reliability.inject",
                 "fia_tpu_torch.reliability.journal",
                 "fia_tpu_torch.reliability.sites",
                 "fia_tpu_torch.obs.diag",
                 "fia_tpu_torch.utils.io",
                 "fia_tpu_torch.utils.logging")
# the split-invariant flat path: the segment-Hessian kernel's wrapper and
# the program-build counter
DISPATCH_MODULES = ("fia_tpu_torch.influence.kernels.segment",
                    "fia_tpu_torch.utils.compilemon")
# the rest of the solver ladder and the facade: the sampled rung and its
# certificate kernel's wrapper, the factor bank, the full-parameter
# engine, FIAModel and the bank builder
LADDER_MODULES = ("fia_tpu_torch.influence.sampled",
                  "fia_tpu_torch.influence.kernels.certificate",
                  "fia_tpu_torch.influence.factor",
                  "fia_tpu_torch.influence.full",
                  "fia_tpu_torch.api",
                  "fia_tpu_torch.cli.factor")
# the observability spine and the recovery ladders' utilities
OBS_MODULES = ("fia_tpu_torch.obs",
               "fia_tpu_torch.obs.registry",
               "fia_tpu_torch.obs.trace",
               "fia_tpu_torch.obs.events",
               "fia_tpu_torch.obs.export",
               "fia_tpu_torch.utils.timing",
               "fia_tpu_torch.utils.memlimits")
# the serving layer and its entry points
SERVE_MODULES = ("fia_tpu_torch.serve",
                 "fia_tpu_torch.serve.request",
                 "fia_tpu_torch.serve.admission",
                 "fia_tpu_torch.serve.scheduler",
                 "fia_tpu_torch.serve.health",
                 "fia_tpu_torch.serve.cache",
                 "fia_tpu_torch.serve.metrics",
                 "fia_tpu_torch.serve.service",
                 "fia_tpu_torch.cli.serve")
# streaming updates, the audit subsystem and their driver
STREAM_MODULES = ("fia_tpu_torch.stream",
                  "fia_tpu_torch.stream.footprint",
                  "fia_tpu_torch.stream.update",
                  "fia_tpu_torch.audit",
                  "fia_tpu_torch.audit.reverse",
                  "fia_tpu_torch.audit.plan",
                  "fia_tpu_torch.audit.verify",
                  "fia_tpu_torch.cli.debug_data")
# the device mesh, row-sharded tables and the multi-process runtime
PARALLEL_MODULES = ("fia_tpu_torch.parallel",
                    "fia_tpu_torch.parallel.mesh",
                    "fia_tpu_torch.parallel.sharded",
                    "fia_tpu_torch.parallel.distributed")
# host roles and sharded checkpoints
HOST_MODULES = ("fia_tpu_torch.serve.hostshard",
                "fia_tpu_torch.train.checkpoint_orbax")
# the chaos engine and the observability CLI
CHAOS_MODULES = ("fia_tpu_torch.chaos",
                 "fia_tpu_torch.chaos.schedule",
                 "fia_tpu_torch.chaos.shrink",
                 "fia_tpu_torch.chaos.oracles",
                 "fia_tpu_torch.chaos.scenarios",
                 "fia_tpu_torch.chaos.runner",
                 "fia_tpu_torch.cli.chaos",
                 "fia_tpu_torch.cli.obs")
# the native data path, the CPU reference engines and the lint engine
LAST_MODULES = ("fia_tpu_torch.data.native",
                "fia_tpu_torch.backends",
                "fia_tpu_torch.backends.torch_ref",
                "fia_tpu_torch.analysis",
                "fia_tpu_torch.analysis.core",
                "fia_tpu_torch.analysis.visitor",
                "fia_tpu_torch.analysis.reporters",
                "fia_tpu_torch.analysis.config",
                "fia_tpu_torch.analysis.callgraph",
                "fia_tpu_torch.analysis.dataflow",
                "fia_tpu_torch.analysis.rules_io",
                "fia_tpu_torch.analysis.rules_trace",
                "fia_tpu_torch.analysis.rules_sites",
                "fia_tpu_torch.analysis.rules_schema",
                "fia_tpu_torch.analysis.rules_obs",
                "fia_tpu_torch.analysis.rules_determinism",
                "fia_tpu_torch.analysis.lint")
# the ML-20M stress driver
STRESS_MODULES = ("fia_tpu_torch.cli.stress",)
ALONE_MODULES = (NCF_MODULES + PADDED_MODULES + TRAIN_MODULES
                 + DISPATCH_MODULES + LADDER_MODULES + OBS_MODULES
                 + SERVE_MODULES + STREAM_MODULES + PARALLEL_MODULES
                 + HOST_MODULES + CHAOS_MODULES + LAST_MODULES
                 + STRESS_MODULES)


def _forbidden(name: str) -> bool:
    """Exact package names: ``fia_tpu_torch`` shares the prefix."""
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _port_sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in sorted(files)
                if f.endswith(".py")]
    return sorted(out)


def _module_names():
    names = []
    for path in _port_sources():
        rel = os.path.relpath(path, REPO)[: -len(".py")]
        parts = rel.split(os.sep)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        names.append(".".join(parts))
    return names


def test_forbidden_matches_exact_names():
    assert _forbidden("jax") and _forbidden("fia_tpu.models")
    assert not _forbidden("fia_tpu_torch") and not _forbidden("jaxtyping")


def test_importing_the_port_loads_no_jax_and_no_fia_tpu():
    names = _module_names()
    assert "fia_tpu_torch.influence.engine" in names and "chip_smoke" in names
    assert set(NCF_MODULES) <= set(names)
    assert set(PADDED_MODULES) <= set(names)
    assert set(TRAIN_MODULES) <= set(names)
    assert set(DISPATCH_MODULES) <= set(names)
    assert set(LADDER_MODULES) <= set(names)
    assert set(OBS_MODULES) <= set(names)
    assert set(SERVE_MODULES) <= set(names)
    assert set(STREAM_MODULES) <= set(names)
    assert set(PARALLEL_MODULES) <= set(names)
    assert set(HOST_MODULES) <= set(names)
    assert set(CHAOS_MODULES) <= set(names)
    assert set(LAST_MODULES) <= set(names)
    assert set(STRESS_MODULES) <= set(names)
    code = (
        "import importlib, json, sys\n"
        f"for m in {names!r}:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True,
                         timeout=120)
    loaded = __import__("json").loads(out.stdout.strip().splitlines()[-1])
    assert set(names) <= set(loaded)
    assert [m for m in loaded if _forbidden(m)] == []


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_import_statement_names_jax_or_fia_tpu(path):
    """Also catches imports inside functions, which an import test never
    runs."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods = [node.module]
        else:
            continue
        assert not [m for m in mods if _forbidden(m)], (path, node.lineno)


# One interpreter imports every module of ALONE_MODULES in turn, each from
# a clean slate: every fia_tpu_torch entry is dropped from sys.modules
# first, so each module's import runs its whole chain again, as it would
# alone. torch's import is paid once.
ALONE_CODE = """
import importlib, json, sys
out = {}
for m in sys.argv[1:]:
    for k in [k for k in sys.modules if k.split(".")[0] == "fia_tpu_torch"]:
        del sys.modules[k]
    before = set(sys.modules)
    importlib.import_module(m)
    new = sorted(set(sys.modules) - before)
    common = importlib.import_module("fia_tpu_torch.influence.kernels.common")
    out[m] = {"new": new, "loaded": sorted(sys.modules),
              "libs": len(common._LOADED)}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def imported_alone():
    """Each module's record: the entries its import added to
    ``sys.modules``, all of ``sys.modules`` after it, and the kernel
    libraries a fresh ``common`` holds — with no nvcc to be found."""
    env = {k: v for k, v in os.environ.items() if k != "CUDA_HOME"}
    env["PATH"] = os.path.dirname(sys.executable)
    out = subprocess.run([sys.executable, "-c", ALONE_CODE, *ALONE_MODULES],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         check=True, timeout=300)
    return __import__("json").loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("module", ALONE_MODULES)
def test_ncf_modules_import_alone_without_nvcc(module, imported_alone):
    """Imported on its own (every fia_tpu_torch module dropped first),
    with no nvcc to be found: no JAX, nothing of fia_tpu, and no kernel
    library built or loaded."""
    rec = imported_alone[module]
    assert module in rec["new"] and module in rec["loaded"]
    assert rec["libs"] == 0
    assert [m for m in rec["new"] if _forbidden(m)] == []
    assert [m for m in rec["loaded"] if _forbidden(m)] == []


@pytest.mark.parametrize("Model", [MF, NCF], ids=["mf", "ncf"])
def test_default_device_is_cuda_and_raises_without_it(monkeypatch, Model):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    model = Model(4, 3, 2, 1e-3)
    params = model.init_params(torch.Generator().manual_seed(0))
    train = RatingDataset(np.asarray([[0, 0], [1, 2], [3, 1]]),
                          np.asarray([1.0, 2.0, 3.0]))
    with pytest.raises(RuntimeError, match="CUDA"):
        InfluenceEngine(model, params, train)
    eng = InfluenceEngine(model, params, train, device="cpu")
    assert eng.device.type == "cpu"
    assert eng.active_kernel_variant() == "torch"


def test_device_sets_the_fp32_policy(monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    assert resolve_device("cpu") == torch.device("cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_trainer_and_drivers_default_to_cuda(monkeypatch):
    """The training and experiment entry points run on the card unless
    asked for the CPU, and raise without one."""
    from fia_tpu_torch.cli import common
    from fia_tpu_torch.train.trainer import Trainer, TrainConfig, \
        loo_retrain_many

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = MF(4, 3, 2, 1e-3)
    params = model.init_params(torch.Generator().manual_seed(0))
    x, y = np.asarray([[0, 0], [1, 2], [3, 1]]), np.ones(3, np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(model, TrainConfig(1, 1))
    with pytest.raises(RuntimeError, match="CUDA"):
        loo_retrain_many(model, params, x, y, [0], 1, 1)
    args = common.base_parser("t").parse_args([])
    assert args.backend is None
    with pytest.raises(RuntimeError, match="CUDA"):
        common.apply_backend(args)
    args = common.base_parser("t").parse_args(["--backend", "cpu"])
    assert common.apply_backend(args).type == "cpu"
    assert Trainer(model, TrainConfig(1, 1), device="cpu").device.type == "cpu"


def test_ladder_entry_points_default_to_cuda(monkeypatch):
    """The full-parameter engine and the facade run on the card unless
    asked for the CPU, and raise without one; so do the new rungs."""
    from fia_tpu_torch.api import FIAModel
    from fia_tpu_torch.influence.full import FullInfluenceEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = MF(4, 3, 2, 1e-3)
    params = model.init_params(torch.Generator().manual_seed(0))
    train = RatingDataset(np.asarray([[0, 0], [1, 2], [3, 1]]),
                          np.asarray([1.0, 2.0, 3.0]))
    with pytest.raises(RuntimeError, match="CUDA"):
        FullInfluenceEngine(model, params, train)
    assert FullInfluenceEngine(model, params, train,
                               device="cpu").device.type == "cpu"
    for solver in ("precomputed", "sampled"):
        with pytest.raises(RuntimeError, match="CUDA"):
            InfluenceEngine(model, params, train, solver=solver)
    kw = dict(model="MF", num_users=4, num_items=3, embedding_size=2,
              weight_decay=1e-3, batch_size=1,
              data_sets={"train": train, "test": train})
    with pytest.raises(RuntimeError, match="CUDA"):
        FIAModel(**kw)
    assert FIAModel(**kw, device="cpu").device.type == "cpu"


def test_serving_entry_points_default_to_cuda(monkeypatch, tmp_path):
    """FIAModel.serve, a service over a default-device engine and the
    serve driver run on the card unless asked for the CPU, and raise
    without one."""
    from fia_tpu_torch.api import FIAModel
    from fia_tpu_torch.cli import serve as cli_serve
    from fia_tpu_torch.serve import InfluenceService, Request, ServeConfig

    model = MF(4, 3, 2, 1e-3)
    params = model.init_params(torch.Generator().manual_seed(0))
    train = RatingDataset(np.asarray([[0, 0], [1, 2], [3, 1]]),
                          np.asarray([1.0, 2.0, 3.0]))
    kw = dict(model="MF", num_users=4, num_items=3, embedding_size=2,
              weight_decay=1e-3, batch_size=1,
              data_sets={"train": train, "test": train}, train_dir="")
    on_cpu = FIAModel(**kw, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        FIAModel(**kw).serve()
    with pytest.raises(RuntimeError, match="CUDA"):
        InfluenceService(
            engine_provider=lambda: InfluenceEngine(model, params, train))
    with pytest.raises(RuntimeError, match="CUDA"):
        cli_serve.main(["--dataset", "synthetic", "--warmup", "2",
                        "--train_dir", str(tmp_path)])
    svc = on_cpu.serve(config=ServeConfig(disk_cache=False))
    assert svc._peek_engine().device.type == "cpu"
    assert svc.run([Request(0, 0)])[0].ok


def test_chip_smoke_refuses_without_cuda(monkeypatch):
    """No result and a non-zero exit when there is no CUDA device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    assert chip_smoke.main() != 0


def test_audit_selection_defaults_to_cuda(monkeypatch):
    """The sweep's segmented selection runs on the card unless asked for
    the CPU, and raises without one (``reverse_topk`` passes the model's
    device)."""
    from fia_tpu_torch.audit.reverse import _segmented_topk_negative

    acc = np.array([0.0, -1.0, 0.0, -1.0], np.float32)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        _segmented_topk_negative(acc, 2)
    ids, vals = _segmented_topk_negative(acc, 3, segment=2, device="cpu")
    assert ids.tolist() == [1, 3, 0] and vals.tolist() == [-1.0, -1.0, 0.0]

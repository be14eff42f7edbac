"""The port's ML-20M stress driver (``python -m fia_tpu_torch.cli.stress``)
against the reference's ``scripts/stress.py``.

Restates ``tests/test_e2e.py:152-164``'s two smoke tests (``--model_parallel
2``, ``--model NCF``) as subprocess runs of the port's driver with
``--smoke --backend cpu`` and ``import jax`` made to fail, plus
``--stream cal`` and ``--full_space --cg_maxiter 3``. The reference's
driver runs once a stream (its plain, calibrated and full-space smoke
runs, concurrently, in a module fixture): each port run's JSON line has
the reference's keys, and its ``users``, ``items``, ``train_rows``,
``num_queries`` and ``num_scores`` equal the reference's on the same
stream (the same numpy synthesis and queries give the same related
counts). The stress configuration itself (pad bucket 512, damping 1e-6,
direct) is held against the reference's engine on the 16 smoke queries
with the reference's trained params carried across: identical related
sets, scores at atol 1e-6 and rtol ``SCORE_RTOL``, MF and NCF.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from fia_tpu.data.synthetic import sample_heldout_pairs as ref_pairs
from fia_tpu.data.synthetic import synthesize_ratings as ref_synth
from fia_tpu.influence.engine import InfluenceEngine as RefEngine
from fia_tpu.models import MF as RefMF
from fia_tpu.models import NCF as RefNCF
from fia_tpu.train.trainer import Trainer as RefTrainer
from fia_tpu.train.trainer import TrainConfig as RefTrainConfig
from fia_tpu_torch.cli import stress
from fia_tpu_torch.models import params_from_numpy
from fia_tpu_torch.parallel import mesh as pmesh

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-6
# At damping 1e-6 the trained smoke blocks reach cond(H) = 3.85e3 (MF)
# and 1.33e4 (NCF), where two float32 LU solves (torch's, XLA's) part by
# ~cond·eps in their smallest entries: port against reference the
# scores need rtol 8.72e-5 (MF, query 15) and 2.09e-4 (NCF, query 5)
# elementwise at ATOL, and 4.5e-5 / 4.1e-5 of each query's largest
# score. The bar is one fixed rtol just above the larger need.
SCORE_RTOL = 3e-4
COUNTS = ("users", "items", "train_rows", "num_queries", "num_scores")
# the reference's runs a port case is held to, by stream
REF_RUNS = {"zipf": [], "cal": ["--stream", "cal"],
            "full": ["--full_space", "--cg_maxiter", "3"]}


@pytest.fixture(scope="module")
def ref_lines(tmp_path_factory):
    """The reference driver's JSON line of each ``REF_RUNS`` entry (one
    process each, started together; events under a scratch cwd)."""
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "2"}
    procs = {}
    for name, flags in REF_RUNS.items():
        cwd = tmp_path_factory.mktemp(f"ref-{name}")
        procs[name] = subprocess.Popen(
            [sys.executable, os.path.join(REPO, "scripts", "stress.py"),
             "--smoke", *flags], cwd=cwd, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    out = {}
    try:
        for name, p in procs.items():
            so, se = p.communicate(timeout=300)
            assert p.returncode == 0, se[-2000:]
            out[name] = json.loads(so.strip().splitlines()[-1])
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
    return out


@pytest.fixture(scope="module")
def no_jax_env(tmp_path_factory):
    """A subprocess environment in which ``import jax`` fails, no card is
    visible, and torch keeps to 2 threads."""
    stub = tmp_path_factory.mktemp("nojax")
    for name in ("jax", "jaxlib"):
        os.makedirs(stub / name)
        (stub / name / "__init__.py").write_text(
            f"raise ImportError('{name} is blocked in this process')\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(stub), REPO])
    env["CUDA_VISIBLE_DEVICES"] = ""
    env["OMP_NUM_THREADS"] = "2"
    return env


def _port(flags, env, cwd) -> dict:
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys, torch; torch.set_num_threads(2)\n"
         "from fia_tpu_torch.cli import stress\n"
         "try:\n    import jax\nexcept ImportError:\n    pass\n"
         "else:\n    sys.exit('jax was importable')\n"
         "stress.main(sys.argv[1:])\n"
         "assert not any(m == 'jax' or m.startswith(('jax.', 'fia_tpu.'))\n"
         "               for m in sys.modules), 'jax or fia_tpu loaded'\n",
         "--smoke", "--backend", "cpu", *flags],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert os.path.exists(os.path.join(cwd, "output", "events-stress.jsonl"))
    return json.loads(out.stdout.strip().splitlines()[-1])


def _keys(line: dict) -> dict:
    return {"top": sorted(line), "details": sorted(line["details"]),
            "full_space": sorted(line["details"].get("full_space", {}))}


@pytest.mark.parametrize("flags,ref", [
    (["--model_parallel", "2"], "zipf"),
    (["--model", "NCF"], "zipf"),
    (["--stream", "cal"], "cal"),
    (["--full_space", "--cg_maxiter", "3"], "full"),
], ids=["model_parallel", "ncf", "cal", "full_space"])
def test_smoke_matches_reference(flags, ref, ref_lines, no_jax_env,
                                 tmp_path):
    got = _port(flags, no_jax_env, tmp_path)
    want = ref_lines[ref]
    assert _keys(got) == _keys(want)
    for k in COUNTS:
        assert got["details"][k] == want["details"][k], k
    d = got["details"]
    assert got["value"] > 0 and d["backend"] == "cpu"
    assert d["model_parallel"] == (2 if "--model_parallel" in flags else 1)
    assert d["model"] == ("NCF" if "NCF" in flags else "MF")
    assert d["train_stream"] == ("cal" if ref == "cal" else "zipf")
    if ref == "full":
        fs = d["full_space"]
        assert fs["finite"] and fs["cg_maxiter"] == 3
        assert fs["num_params"] == want["details"]["full_space"]["num_params"]
        assert fs["hvp_batch"] == want["details"]["full_space"]["hvp_batch"]


def test_default_device_raises_without_a_card(monkeypatch):
    """Without ``--backend`` the driver runs on the card: with none
    visible it raises before any work, ``--smoke`` or not."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        stress.main(["--smoke"])


def test_model_parallel_that_does_not_divide_exits():
    with pmesh.virtual_devices(4):
        assert stress.stress_mesh(1, "cpu") is None
        assert dict(stress.stress_mesh(2, "cpu").shape) == {"data": 2,
                                                            "model": 2}
        with pytest.raises(SystemExit, match="--model_parallel 3"):
            stress.stress_mesh(3, "cpu")


def test_flags_are_the_references():
    """The reference's flags one for one, plus ``--backend``."""
    import ast

    with open(os.path.join(REPO, "scripts", "stress.py")) as f:
        tree = ast.parse(f.read())
    ref = {node.args[0].value for node in ast.walk(tree)
           if isinstance(node, ast.Call)
           and getattr(node.func, "attr", None) == "add_argument"}
    port = {a.option_strings[0] for a in stress.parser()._actions
            if a.option_strings and a.option_strings[0] != "-h"}
    assert port == ref | {"--backend"}


@pytest.mark.parametrize("family", ["MF", "NCF"])
def test_stress_engine_matches_reference(family):
    """The driver's engine (``stress_engine``: direct, damping 1e-6, pad
    bucket 512) on the smoke data and queries, with the reference's
    trained params, against the reference's engine of the same
    configuration."""
    args = stress.parser().parse_args(["--smoke", "--backend", "cpu",
                                       "--model", family])
    users, items, rows, steps, n_q, batch = stress.shapes(args)
    train = ref_synth(users, items, rows, seed=0)
    ref_cls = RefNCF if family == "NCF" else RefMF
    ref_model = ref_cls(users, items, 16, weight_decay=1e-3)
    tr = RefTrainer(ref_model, RefTrainConfig(batch_size=batch,
                                              num_steps=steps,
                                              learning_rate=1e-2))
    state = tr.fit(tr.init_state(ref_model.init_params(
        jax.random.PRNGKey(0))), train.x, train.y)
    arrays = jax.tree_util.tree_map(np.asarray, state.params)
    pts = ref_pairs(train.x, users, items, n_q, seed=17)
    want = RefEngine(ref_model, arrays, train, damping=1e-6,
                     solver="direct", pad_bucket=512,
                     **({"model_name": "ncf"} if family == "NCF" else {})
                     ).query_batch(pts)

    port_train = stress.synthesize(args, users, items, rows)
    assert np.array_equal(port_train.x, train.x)
    model = (stress.NCF if family == "NCF" else stress.MF)(
        users, items, 16, weight_decay=1e-3)
    eng = stress.stress_engine(args, model, params_from_numpy(
        model, arrays, "cpu"), port_train, None, "cpu")
    assert eng.pad_bucket == 512 and eng.damping == 1e-6
    assert eng.model_name == ("ncf" if family == "NCF" else "model")
    got = eng.query_batch(pts)
    assert np.array_equal(got.counts, want.counts)
    for t in range(n_q):
        assert np.array_equal(got.related_of(t), want.related_of(t))
        np.testing.assert_allclose(got.scores_of(t), want.scores_of(t),
                                   rtol=SCORE_RTOL,
                                   atol=ATOL)

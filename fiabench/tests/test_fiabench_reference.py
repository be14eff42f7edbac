"""The plain reference agrees with the port's engine on the CPU at a
tiny size, for MF and NCF, and imports nothing it must not."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from fiabench import data, reference

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


@pytest.mark.parametrize("config", ["mf-k16-ml1m", "ncf-k16-ml1m"])
@pytest.mark.parametrize("heldout", [True, False])
def test_reference_matches_the_engine(tiny, config, heldout):
    from fia_tpu_torch import models
    from fia_tpu_torch.data.dataset import RatingDataset
    from fia_tpu_torch.influence.engine import InfluenceEngine

    cfg = tiny.config(config)
    r = data.load_ratings(cfg)
    pairs = data.job_pool(r, {"item": "uniform", "heldout": heldout,
                              "job_queries": 24, "pool_jobs": 1,
                              "pool_seed": 9})[0]
    params = reference.make_params(cfg, 1234, "cpu")
    model = getattr(models, cfg["port_model"])(
        cfg["num_users"], cfg["num_items"], cfg["embedding_size"],
        cfg["weight_decay"])
    eng = InfluenceEngine(model, params, RatingDataset(r.x, r.y),
                          damping=cfg["damping"], device="cpu")
    res = eng.query_batch(pairs)
    post = reference.Postings(r.x, r.num_users, r.num_items)
    ref = reference.influence(cfg, params, r.x, r.y, post,
                              pairs.astype(np.int64), "cpu")
    assert heldout or (r.pair_rows(pairs[:, 0], pairs[:, 1]) > 0).any()
    for t, q in enumerate(ref):
        assert res.counts[t] == len(q["rows"])
        np.testing.assert_array_equal(res.related_of(t), q["rows"])
        if q["kink"]:
            continue
        np.testing.assert_allclose(res.ihvp[t], q["ihvp"], rtol=1e-4,
                                   atol=1e-5 * np.abs(q["ihvp"]).max())
        np.testing.assert_allclose(res.scores_of(t), q["scores"], rtol=1e-3,
                                   atol=1e-5 * np.abs(q["scores"]).max())


def test_weights_are_seeded(tiny):
    cfg = tiny.config("ncf-k16-ml1m")
    a = reference.make_params(cfg, 2 ** 31 + 77, "cpu")
    b = reference.make_params(cfg, 2 ** 31 + 77, "cpu")
    c = reference.make_params(cfg, 2 ** 31 + 78, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["W1"], c["W1"])
    assert float(a["b1"].abs().max()) == 0.0
    std = float(a["P_mlp"].std())
    assert 0.7 * 0.25 < std < 0.25  # 1/sqrt(k), truncated at 2 sigma


def _loaded(code: str) -> list:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\nprint(json.dumps("
         "sorted({m.split('.')[0] for m in sys.modules})))"],
        capture_output=True, text=True, cwd=ROOT, timeout=300,
        env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_reference_imports_nothing_of_the_program():
    mods = _loaded("import fiabench.reference, fiabench.check, "
                   "fiabench.models.mf, fiabench.models.ncf, "
                   "fiabench.roofline, fiabench.precision")
    assert not {"fia_tpu_torch", "fia_tpu", "jax", "jaxlib"} & set(mods)


@pytest.mark.parametrize("cell", ["mf-k16-ml1m.uniform4k",
                                  "ncf-k16-ml1m.mesh4-uniform16k"])
def test_a_run_loads_no_jax(cell):
    """A whole run (on the CPU, tiny) loads no module whose top-level
    name is jax, jaxlib, flax or fia_tpu; fia_tpu_torch, whose name
    begins with fia_tpu, is compared whole and allowed."""
    mods = _loaded(
        "import sys; sys.path.insert(0, 'fiabench/tests')\n"
        "from conftest import TinySpec\nfrom fiabench import cell, run\n"
        f"out = cell.run(TinySpec(), {cell!r}, 3, 0.3, True, 'cpu')\n"
        "assert out['correct'], out\nassert not run.loaded_banned()")
    assert "fia_tpu_torch" in mods
    assert not {"jax", "jaxlib", "flax", "fia_tpu"} & set(mods)

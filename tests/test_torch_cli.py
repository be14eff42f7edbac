"""The port's drivers, ``python -m fia_tpu_torch.cli.rq1`` and
``...cli.rq2``, against the reference's (``fia_tpu.cli.rq1|rq2``).

The port's drivers run in a subprocess with ``--backend cpu`` and
``import jax`` made to fail (a stub package first on ``PYTHONPATH``).
The RQ1 comparison starts both from the same trained weights: the
reference's driver trains and publishes its checkpoint, which is copied
into the port's ``--train_dir``, where the port's driver loads it (the
checkpoint names and fingerprints are the reference's). Retraining runs
at ``--batch_size`` = n, one batch an epoch, so the result does not
depend on the schedule's draws. The artifact then has the same keys,
the same removed rows and provenance exactly, the predicted diffs at
rtol 2e-5 / atol 2e-6, and the retrained predictions and actual diffs at
atol 5e-6, MF and NCF (the bar of ``test_torch_eval.py``'s RQ1 case;
the actual diffs there are 0.014-0.018 in median size, 5.7e-4 at the
smallest, so the bar is under 1% of the smallest).

Retraining restarts Adam, whose first step is g / (|g| + 1e-8): an entry
of the first gradient within about 1e-7 of 0 steps in proportion to its
own float32 rounding, and only there do two correct float32
implementations part. Near convergence, removing one row of n moves an
entry by about |wd·p| / n, the size of what convergence leaves, so the
two cancel within 1e-8 in some entry of most lanes: after 200 training
steps NCF's GMF entry P_gmf[20, 1] is 2.3e-9 in float64 in every removal
lane, a cancellation of 1.65e-4 against 1.65e-4. Rounding each
prediction to float32 alone moves that entry by 9% (standard deviation);
the port's forward pass is as accurate as the reference's (0.74 and 0.72
ulps rms), yet its rounding put the entry 12% off and the reference's
2.8%, and the lane 2.6e-4 apart. A 2-ulp change of the weights moved
that gap to another lane, anywhere from 1e-6 to 2.6e-4. So the drivers
train 60 steps here, short of convergence, where every first
gradient's smallest nonzero entry is 1.2e-5 (MF and NCF), and the test
requires of the retraining it compares that none lies within 10·eps of
0 (``_first_step_floor``); the reference and the port then agree within
9.5e-7 on every lane, over five 2-ulp changes of the weights, and no
predicted diff is clamped (ROADMAP Queue C).

The RQ2 JSON line has the same keys and the same query and score
counts; its times are each machine's own.
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from fia_tpu.cli import rq1 as ref_rq1
from fia_tpu.cli import rq2 as ref_rq2
from fia_tpu_torch.cli import common
from fia_tpu_torch.cli import rq1 as port_rq1
from fia_tpu_torch.cli import rq2 as port_rq2
from fia_tpu_torch.influence.engine import InfluenceEngine
from fia_tpu_torch.train import checkpoint

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--dataset", "synthetic", "--synth_users", "40", "--synth_items",
         "30", "--synth_train", "1500", "--synth_test", "50",
         "--embed_size", "4", "--lr", "1e-2", "--damping", "1e-3"]
RQ1 = SMALL + ["--num_steps_train", "60", "--num_steps_retrain", "30",
               "--num_test", "2", "--retrain_times", "2",
               "--num_to_remove", "5", "--batch_size", "1500"]
RTOL, PRED_ATOL = 2e-5, 2e-6
RETRAIN_ATOL = 5e-6
# Adam's eps: a first-gradient entry within 10x of it steps by its rounding
ADAM_EPS = 1e-8


@pytest.fixture(scope="module")
def no_jax_env(tmp_path_factory):
    """Environment of a subprocess in which ``import jax`` fails, no
    card is visible, and torch keeps to 2 threads."""
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


def _port(driver: str, argv, env, check=True):
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys, torch; torch.set_num_threads(2)\n"
         f"from fia_tpu_torch.cli import {driver}\n"
         "try:\n    import jax\nexcept ImportError:\n    pass\n"
         "else:\n    sys.exit('jax was importable')\n"
         f"{driver}.main(sys.argv[1:])\n"
         "assert not any(m == 'jax' or m.startswith(('jax.', 'fia_tpu.'))\n"
         "               for m in sys.modules), 'jax or fia_tpu loaded'\n",
         *argv],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    if check:
        assert out.returncode == 0, out.stderr[-3000:]
    return out


def _first_step_floor(flags, ckpt_dir: str, art) -> float:
    """The smallest nonzero |entry| of the first gradient of every lane
    the artifact's retraining ran (each removed row, and the drift lane
    that removes none), in float64 from the checkpoint in ``ckpt_dir``."""
    args = common.base_parser("t").parse_args(flags + ["--backend", "cpu"])
    splits = common.load_splits(args)
    model, params = common.build_model(args, splits)
    name = [f for f in os.listdir(ckpt_dir) if f.endswith(".npz")
            and "-checkpoint-" in f][0]
    params, _, _ = checkpoint.load(os.path.join(ckpt_dir, name), params)
    train, test = splits["train"], splits["test"]
    eng = InfluenceEngine(model, params, train, **common.engine_kwargs(args))
    removed = [-1]
    for t in np.unique(art["test_index_of_row"]):
        related = eng.query_batch(test.x[t][None]).related_of(0)
        removed += list(related[art["indices_to_remove"][
            art["test_index_of_row"] == t]])
    p64 = {k: v.double().requires_grad_(True) for k, v in params.items()}
    x = torch.as_tensor(train.x)
    y = torch.as_tensor(train.y, dtype=torch.float64)
    floor = np.inf
    for r in removed:
        w = torch.ones(len(y), dtype=torch.float64)
        if r >= 0:
            w[r] = 0.0
        for g in torch.autograd.grad(model.loss(p64, x, y, w),
                                     list(p64.values())):
            g = g.abs()
            floor = min(floor, float(g[g > 0].min()))
    return floor


def _copy_checkpoint(src: str, dst: str) -> None:
    os.makedirs(dst, exist_ok=True)
    for name in os.listdir(src):
        if "-checkpoint-" in name:
            shutil.copy(os.path.join(src, name), dst)


@pytest.mark.parametrize("model", ["MF", "NCF"])
def test_rq1_matches_the_reference_driver(model, tmp_path, no_jax_env):
    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    flags = RQ1 + ["--model", model]
    ref_rq1.main(flags + ["--train_dir", ref_dir])
    _copy_checkpoint(ref_dir, port_dir)
    out = _port("rq1", flags + ["--backend", "cpu", "--train_dir", port_dir],
                no_jax_env)
    assert "Checkpoint found" in out.stdout
    name = f"RQ1-{model}-synthetic.npz"
    with np.load(os.path.join(port_dir, name)) as g, \
            np.load(os.path.join(ref_dir, name)) as w:
        assert sorted(g.files) == sorted(w.files)
        for key in ("indices_to_remove", "test_index_of_row", "protocol",
                    "stream_tag", "model_key"):
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)
            assert g[key].dtype == w[key].dtype, key
        assert np.count_nonzero(w["predicted_loss_diffs"]) == len(
            w["predicted_loss_diffs"])  # none clamped to 0
        np.testing.assert_allclose(g["predicted_loss_diffs"],
                                   w["predicted_loss_diffs"], rtol=RTOL,
                                   atol=PRED_ATOL)
        floor = _first_step_floor(flags, ref_dir, w)
        assert floor > 10 * ADAM_EPS, (
            f"a first retraining gradient has an entry {floor:.2e} from 0: "
            "Adam steps it by its float32 rounding")
        for key in ("actual_loss_diffs", "repeat_y", "drift_repeat_y",
                    "y0_of_point"):
            assert g[key].shape == w[key].shape and np.isfinite(g[key]).all()
            np.testing.assert_allclose(g[key], w[key], rtol=0,
                                       atol=RETRAIN_ATOL, err_msg=key)
    with open(os.path.join(port_dir, name + ".manifest.json")) as f:
        assert json.load(f)["fingerprint"]["kind"] == "rq1-chain"


def test_rq2_json_line_matches_and_checkpoints_cross(tmp_path, capsys,
                                                     no_jax_env):
    """The JSON line of both drivers; the port's own checkpoint, trained
    from scratch, then loads in the reference's driver."""
    port_dir = str(tmp_path / "port")
    flags = SMALL + ["--model", "NCF", "--num_steps_train", "40",
                     "--batch_size", "150", "--num_test", "6",
                     "--query_batch", "4"]
    out = _port("rq2", flags + ["--backend", "cpu", "--train_dir", port_dir],
                no_jax_env)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert "Training NCF at step 0/40" in out.stdout
    capsys.readouterr()
    ref_rq2.main(flags + ["--train_dir", port_dir])
    ref_out = capsys.readouterr().out
    assert "Checkpoint found" in ref_out
    want = json.loads(ref_out.strip().splitlines()[-1])
    assert sorted(got) == sorted(want)
    for key in ("model", "dataset", "embed_size", "num_queries", "num_scores"):
        assert got[key] == want[key], key
    assert got["num_scores"] > 0 and got["per_query_ms"] > 0


def test_without_a_card_the_drivers_raise(tmp_path, no_jax_env):
    for driver in ("rq1", "rq2", "factor"):
        out = _port(driver, SMALL + ["--train_dir", str(tmp_path)], no_jax_env,
                    check=False)
        assert out.returncode != 0 and "CUDA" in out.stderr
        assert not os.listdir(tmp_path)  # nothing trained or written


def test_unported_options_raise(tmp_path):
    """``--mesh`` and ``--model_parallel`` are ported: with one CPU slot
    visible ``--mesh 2`` exits naming the virtual slots, over two virtual
    slots the driver runs (the sampled rung escalating, as on every mesh
    engine), and with ``--model_parallel 2`` on row-sharded tables; a
    ``--model_parallel`` that does not divide ``--mesh``, or one without
    ``--mesh``, exits."""
    from fia_tpu_torch.parallel import mesh as pmesh

    with pytest.raises(SystemExit, match="set_virtual_devices"):
        port_rq2.main(SMALL + ["--backend", "cpu", "--mesh", "2",
                               "--train_dir", str(tmp_path)])
    with pmesh.virtual_devices(2):
        timing = port_rq2.main(SMALL + [
            "--backend", "cpu", "--solver", "sampled", "--mesh", "2",
            "--num_steps_train", "5", "--batch_size", "300",
            "--lissa_depth", "20", "--num_test", "3",
            "--train_dir", str(tmp_path)])
        assert timing.num_queries == 3 and timing.num_scores > 0
        sharded = port_rq2.main(SMALL + [
            "--backend", "cpu", "--mesh", "2", "--model_parallel", "2",
            "--num_steps_train", "5", "--batch_size", "300",
            "--num_test", "3", "--train_dir", str(tmp_path)])
        assert sharded.num_queries == 3 and sharded.num_scores > 0
        with pytest.raises(SystemExit, match="does not divide"):
            port_rq2.main(SMALL + ["--backend", "cpu", "--mesh", "2",
                                   "--model_parallel", "3",
                                   "--train_dir", str(tmp_path)])
    with pytest.raises(SystemExit, match="requires --mesh"):
        port_rq2.main(SMALL + ["--backend", "cpu", "--model_parallel", "2",
                               "--train_dir", str(tmp_path)])
    with pytest.raises(SystemExit, match="out of range"):
        common.load_splits(common.base_parser("t").parse_args(
            SMALL + ["--test_indices", "50"]))


def test_factor_driver_publishes_a_bank(tmp_path, no_jax_env):
    """``python -m fia_tpu_torch.cli.factor`` with no JAX: trains, builds
    and publishes a bank that a ``precomputed`` engine over the same
    ``--train_dir`` loads whole; ``--verify`` serves against it in
    process and passes."""
    from fia_tpu_torch.influence import factor as fbank

    flags = SMALL + ["--model", "MF", "--backend", "cpu", "--batch_size",
                     "300", "--num_steps_train", "20", "--bank_entries",
                     "32", "--bank_top_users", "8", "--bank_top_items", "8",
                     "--train_dir", str(tmp_path)]
    out = _port("factor", flags, no_jax_env)
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    assert summary["entries"] == 32 and summary["block_d"] == 10
    assert summary["cholesky"] + summary["inverse"] == 32
    from fia_tpu_torch.cli import factor as port_factor

    args = port_factor.add_factor_flags(common.base_parser("t")).parse_args(
        flags)
    splits = common.load_splits(args)
    model, params = common.build_model(args, splits)
    _, state, _ = common.train_or_load(args, model, params, splits,
                                       verbose=False)
    name = common.model_name_for(args, splits=splits)
    assert summary["path"] == fbank.default_bank_path(str(tmp_path), name)
    eng = InfluenceEngine(model, state.params, splits["train"],
                          solver="precomputed", cache_dir=str(tmp_path),
                          model_name=name, damping=1e-3, device="cpu")
    assert eng.ensure_factor_bank() == 32
    assert eng.bank_stats()["dropped_stale"] == 0
    assert port_factor.main(flags + ["--verify"]) == 0


def test_rq2_runs_the_sampled_rung(tmp_path, capsys):
    port_rq2.main(SMALL + ["--backend", "cpu", "--solver", "sampled",
                           "--sampled_cap", "8", "--num_steps_train", "5",
                           "--batch_size", "300", "--num_test", "4",
                           "--train_dir", str(tmp_path)])
    assert "Inverse HVP + scoring for 4 queries" in capsys.readouterr().out


def test_rq1_resume_and_deadline(tmp_path):
    """A deadline stops the chain after its first point; ``--resume``
    then computes only the rest, and the artifact equals an unbroken
    run's byte for byte."""
    flags = RQ1 + ["--model", "MF", "--backend", "cpu", "--batch_size",
                   "300", "--num_steps_train", "40", "--num_steps_retrain",
                   "10", "--num_test", "3"]
    whole_dir, part_dir = str(tmp_path / "whole"), str(tmp_path / "part")
    port_rq1.main(flags + ["--train_dir", whole_dir])
    port_rq1.main(flags + ["--train_dir", part_dir, "--deadline", "1e-9"])
    name = "RQ1-MF-synthetic.npz"
    with np.load(os.path.join(part_dir, name)) as z:
        assert len(set(z["test_index_of_row"])) == 1
    port_rq1.main(flags + ["--train_dir", part_dir, "--resume"])
    with open(os.path.join(whole_dir, name), "rb") as a, \
            open(os.path.join(part_dir, name), "rb") as b:
        assert a.read() == b.read()


def test_artifact_path_rules_match_the_reference(tmp_path):
    """The divert ladder picks the same name as the reference's in each
    of its cases (tests/test_eval.py's scenarios, on one directory)."""
    def args(**kw):
        base = dict(num_steps_retrain=2000, retrain_times=2,
                    num_to_remove=30, num_test=8, maxinf=0, seed=0,
                    test_indices=None)
        base.update(kw)
        return type("A", (), base)()

    td = str(tmp_path)
    cases = [
        (args(), [1, 2], "cal2", "mf_cfg"),
        (args(), [1, 2], "cal2", "mf_cfg_steps9000"),
        (args(num_steps_retrain=18000, retrain_times=4), [1, 2], "cal2", ""),
        (args(maxinf=1), [1, 2], "cal3", "k"),
        (args(seed=3), [1, 2], "cal2", "k"),
        (args(test_indices=[5, 9]), [5, 9], "cal2", "cfg_A"),
    ]
    for a, idx, tag, key in cases:
        want = ref_rq1.artifact_path(td, "MF", "movielens", a, idx, tag,
                                     model_key=key)
        assert port_rq1.artifact_path(td, "MF", "movielens", a, idx, tag,
                                      model_key=key) == want
        # bank it under this run's provenance, as the driver does
        np.savez(want, protocol=np.asarray(
            [a.num_steps_retrain, a.retrain_times, a.num_to_remove,
             a.num_test, a.maxinf, a.seed], np.int64),
            stream_tag=np.asarray(tag), model_key=np.asarray(key + "x"))


def test_train_or_load_signature_is_the_references():
    """``train_or_load`` takes the reference's parameters, in its order
    and with its defaults, ``mesh`` last (ROADMAP Queue C.5: the port
    lacked it); the driver hands it to the ``Trainer``."""
    import inspect

    from fia_tpu.cli import common as ref_common

    port = inspect.signature(common.train_or_load).parameters
    ref = inspect.signature(ref_common.train_or_load).parameters
    assert list(port) == list(ref)
    for name, p in ref.items():
        assert port[name].default == p.default, name


def test_chaos_parser_is_the_references_plus_backend():
    """``cli.chaos``'s flags are the reference's, flag for flag, with
    the same defaults and choices, plus ``--backend`` and nothing else."""
    from fia_tpu.cli import chaos as ref_chaos
    from fia_tpu_torch.cli import chaos as port_chaos

    def flags(parser):
        return {a.dest: (tuple(a.option_strings), a.default, a.choices)
                for a in parser._actions if a.dest != "help"}

    got, want = (flags(port_chaos.build_parser()),
                 flags(ref_chaos.build_parser()))
    backend = got.pop("backend")
    assert got == want
    assert backend == (("--backend",), None, [None, "cuda", "cpu"])
    assert port_chaos.SMOKE_SCENARIOS == ref_chaos.SMOKE_SCENARIOS
    assert (port_chaos.SMOKE_SEEDS_PER_SCENARIO, port_chaos.SMOKE_FAULTS) \
        == (ref_chaos.SMOKE_SEEDS_PER_SCENARIO, ref_chaos.SMOKE_FAULTS)

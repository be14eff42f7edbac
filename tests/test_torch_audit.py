"""The port's audit subsystem (``fia_tpu_torch/audit``) and its driver
(``fia_tpu_torch/cli/debug_data.py``) on the CPU.

Port against port: ``tests/test_audit.py`` restated on the reference's
random data (U = 30, I = 20, K = 4, 240 rows): the sweep bitwise under
chunking, batching, padding and segment width, the journal's record and
bitwise resume, plan filters, validation and round trips, the fenced
apply (remove, reweight, swap rollback, entry-site rollback, stale
plans) and verify's rank helpers, journal and artifact, and
``test_mesh_shard_bitwise_invariant``: the sweep the same bytes over 1,
2 and 4 virtual CPU slots. ``verify_plan`` over a 2-slot mesh shards its
lanes and meets the reference's lane bar (rtol 2e-4 / atol 1e-5) of the
meshless run.

Port against the JAX package, on the same params and rows:

- ``_plan_id`` and the sweep id equal;
- ``_segmented_topk_negative``: row ids and values exactly the
  reference's on crafted accumulators (runs of exact zeros, equal values
  across segment edges, ``n`` not a multiple of the segment,
  ``k > segment``, ``k > n``), where a plain ``torch.topk`` could order
  ties otherwise on the card;
- ``reverse_topk``: ``group_scores`` within rtol 1e-4 / atol 1e-6 (the
  engine's bar at this conditioning), row ids equal except at pairs whose
  reference values lie within that bar of each other (counted);
- ``verify_plan`` with one batch an epoch (so the frameworks' shuffles
  cannot matter): ``predicted`` equal, ``actual`` within the same bar
  (1.5e-7 apart at most, measured);
- ``spearman``, ``sign_agreement`` and ``_ranks`` equal.

And the driver: ``python -m fia_tpu_torch.cli.debug_data`` with
``scripts/unlearn_smoke.sh``'s arguments and ``--backend cpu``, in a
process where ``import jax`` fails, returns 0 and writes the reference's
``--json_out`` keys; with ``--mesh 2`` it runs over two virtual slots
(armed in the driver's process), and without them it exits naming them.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from fia_tpu.api import FIAModel as RefFIAModel
from fia_tpu.audit import plan as ref_plan
from fia_tpu.audit import reverse as ref_reverse
from fia_tpu.audit import verify as ref_verify
from fia_tpu.data.dataset import RatingDataset as RefDataset
from fia_tpu_torch.api import FIAModel
from fia_tpu_torch.audit import plan as port_plan
from fia_tpu_torch.audit import reverse as port_reverse
from fia_tpu_torch.audit import verify as port_verify
from fia_tpu_torch.audit.plan import (
    UnlearnPlan,
    apply_plan,
    build_plan,
    load_plan,
    save_plan,
)
from fia_tpu_torch.audit.reverse import SweepResult, reverse_topk
from fia_tpu_torch.audit.verify import (
    sign_agreement,
    spearman,
    verify_fingerprint,
    verify_plan,
)
from fia_tpu_torch.data.dataset import RatingDataset
from fia_tpu_torch.influence.engine import InfluenceEngine
from fia_tpu_torch.models import params_from_numpy
from fia_tpu_torch.parallel import mesh as pmesh
from fia_tpu_torch.reliability import inject, sites, taxonomy
from fia_tpu_torch.reliability import policy as rpolicy
from fia_tpu_torch.reliability.artifacts import load_npz, read_manifest
from fia_tpu_torch.reliability.journal import Journal
from fia_tpu_torch.train.trainer import TrainState, adam_init

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
U, I, K = 30, 20, 4
WD, DAMP = 1e-2, 1e-3
N_TRAIN = 240
STEPS = 8
# the engine's scores and the sweep's fold, port against the reference
RTOL, ATOL = 1e-4, 1e-6


def _data(seed=1, n=N_TRAIN):
    rng = np.random.default_rng(seed)
    x = np.stack([rng.integers(0, U, n), rng.integers(0, I, n)],
                 axis=1).astype(np.int32)
    y = rng.integers(1, 6, n).astype(np.float32)
    return x, y


def _port_model(train_dir, name="audit-test"):
    x, y = _data()
    return FIAModel(
        "MF", U, I, K, WD, batch_size=50,
        data_sets={"train": RatingDataset(x, y)},
        initial_learning_rate=1e-2, damping=DAMP,
        train_dir=str(train_dir), model_name=name, solver="direct",
        seed=0, device="cpu",
    )


@pytest.fixture(scope="module")
def base_model(tmp_path_factory):
    """One trained FIAModel shared across tests; the ``fm`` fixture
    snapshots and restores its state around each test."""
    m = _port_model(tmp_path_factory.mktemp("audit-base"))
    m._trainer.clock = rpolicy.VirtualClock()
    m.train(24, save_checkpoints=False, verbose=False)
    return m


@pytest.fixture()
def fm(base_model, tmp_path):
    saved = (base_model.state, base_model.data_sets["train"],
             base_model.train_dir)
    base_model.train_dir = str(tmp_path)
    yield base_model
    (base_model.state, base_model.data_sets["train"],
     base_model.train_dir) = saved
    base_model._engines.clear()


def _test_points(fm, n=6):
    x = np.asarray(fm.data_sets["train"].x, np.int64)[:n]
    y = np.asarray(fm.data_sets["train"].y, np.float32)[:n]
    return x, y


def _sweep_bytes(r):
    return (r.row_ids.tobytes(), r.loss_deltas.tobytes(),
            r.group_scores.tobytes())


def _params_bytes(fm):
    return b"".join(
        np.ascontiguousarray(fm.state.params[k].numpy()).tobytes()
        for k in sorted(fm.state.params))


# -- port against port: tests/test_audit.py restated -------------------------
class TestReverseSweepInvariance:
    def test_chunking_and_batching_bitwise_invariant(self, fm):
        pts, ty = _test_points(fm)
        ref = reverse_topk(fm, pts, ty, k=12)
        for kwargs in ({"chunk_points": 2, "batch_queries": 2},
                       {"chunk_points": 3, "batch_queries": 1},
                       {"batch_queries": 4, "pad_to": 32},
                       {"segment": 8}):
            r = reverse_topk(fm, pts, ty, k=12, **kwargs)
            assert r.sweep_id == ref.sweep_id
            assert _sweep_bytes(r) == _sweep_bytes(ref), kwargs

    def test_mesh_shard_bitwise_invariant(self, fm):
        # the sweep ranking must not depend on how many slots the
        # dispatch shards over
        pts, ty = _test_points(fm)
        outs = []
        with pmesh.virtual_devices(4):
            for ndev in (1, 2, 4):
                eng = InfluenceEngine(
                    fm.model, fm.state.params, fm.data_sets["train"],
                    damping=DAMP, solver="direct",
                    mesh=pmesh.make_mesh(ndev, device="cpu"))
                outs.append(_sweep_bytes(
                    reverse_topk(fm, pts, ty, k=12, engine=eng)))
        assert outs[0] == outs[1] == outs[2]
        assert outs[0] == _sweep_bytes(reverse_topk(fm, pts, ty, k=12))

    def test_journal_records_and_resume_replays_bitwise(self, fm, tmp_path):
        pts, ty = _test_points(fm)
        ref = reverse_topk(fm, pts, ty, k=12, chunk_points=3)
        path = str(tmp_path / "sweep.journal.jsonl")
        fp = {"kind": "audit.sweep-test", "sweep_id": ref.sweep_id,
              "chunk_points": 3}
        with Journal.open(path, fp, fsync=False) as j:
            first = reverse_topk(fm, pts, ty, k=12, chunk_points=3,
                                 journal=j)
        assert _sweep_bytes(first) == _sweep_bytes(ref)
        size = os.path.getsize(path)
        assert size > 0
        with Journal.open(path, fp, resume=True, fsync=False) as j2:
            resumed = reverse_topk(fm, pts, ty, k=12, chunk_points=3,
                                   journal=j2)
        assert _sweep_bytes(resumed) == _sweep_bytes(ref)
        assert os.path.getsize(path) == size


class TestPlan:
    def test_build_plan_filters_and_caps(self, fm):
        pts, ty = _test_points(fm)
        sweep = reverse_topk(fm, pts, ty, k=16)
        plan = build_plan(fm, sweep, action="remove", max_rows=4)
        assert plan.rows <= 4
        assert np.all(plan.per_row_delta < 0)  # only_negative default
        assert plan.predicted_delta == pytest.approx(
            float(plan.per_row_delta.sum()))
        assert plan.train_rows == N_TRAIN
        assert plan.base_step == int(fm.state.step)

    def test_build_plan_refuses_empty(self, fm):
        fake = SweepResult(
            row_ids=np.arange(3, dtype=np.int64),
            loss_deltas=np.array([0.0, 0.5, 1.0], np.float32),
            group_scores=np.zeros(N_TRAIN, np.float32), sweep_id="x",
            test_points=np.zeros((1, 2), np.int64), rows_scored=3,
            chunks=1, seconds=0.0,
        )
        with pytest.raises(ValueError, match="no candidate rows"):
            build_plan(fm, fake, action="remove")

    def test_build_plan_validates_action_and_reweight(self, fm):
        pts, ty = _test_points(fm)
        sweep = reverse_topk(fm, pts, ty, k=8)
        with pytest.raises(ValueError, match="action"):
            build_plan(fm, sweep, action="drop")
        with pytest.raises(ValueError, match="reweight"):
            build_plan(fm, sweep, action="reweight", reweight=1.0)

    @pytest.mark.parametrize("action,reweight",
                             [("remove", 0.5), ("reweight", 0.25)])
    def test_save_load_round_trip(self, fm, tmp_path, action, reweight):
        pts, ty = _test_points(fm)
        sweep = reverse_topk(fm, pts, ty, k=8)
        plan = build_plan(fm, sweep, action=action, max_rows=3,
                          reweight=reweight)
        path = save_plan(plan, str(tmp_path / "plan.npz"))
        back = load_plan(path)
        assert isinstance(back, UnlearnPlan)
        assert back.plan_id == plan.plan_id
        assert back.action == plan.action
        assert back.reweight == plan.reweight
        assert back.train_rows == plan.train_rows
        assert back.base_step == plan.base_step
        assert back.model_key == plan.model_key
        assert np.array_equal(back.row_ids, plan.row_ids)
        assert np.array_equal(back.per_row_delta, plan.per_row_delta)
        assert np.array_equal(back.test_points, plan.test_points)
        assert back.predicted_delta == pytest.approx(plan.predicted_delta)


class TestApply:
    def test_remove_commits_and_shrinks_train_set(self, fm):
        pts, ty = _test_points(fm)
        plan = build_plan(fm, reverse_topk(fm, pts, ty, k=8),
                          action="remove", max_rows=3)
        before = _params_bytes(fm)
        r = apply_plan(fm, plan, steps=STEPS, checkpoint_every=4)
        assert r.committed, (r.status, r.reason)
        assert len(fm.data_sets["train"].x) == N_TRAIN - plan.rows
        assert _params_bytes(fm) != before
        assert int(fm.state.step) > plan.base_step

    def test_reweight_commits_and_softens_labels_in_place(self, fm):
        pts, ty = _test_points(fm)
        plan = build_plan(fm, reverse_topk(fm, pts, ty, k=8),
                          action="reweight", max_rows=3, reweight=0.5)
        old_y = np.array(fm.data_sets["train"].y)
        r = apply_plan(fm, plan, steps=STEPS, checkpoint_every=4)
        assert r.committed, (r.status, r.reason)
        new_y = np.asarray(fm.data_sets["train"].y)
        assert len(new_y) == N_TRAIN  # nothing deleted
        changed = np.flatnonzero(new_y != old_y)
        assert set(changed) <= set(plan.row_ids.tolist())
        assert len(changed) > 0

    def test_classified_swap_failure_rolls_back(self, fm):
        pts, ty = _test_points(fm)
        plan = build_plan(fm, reverse_topk(fm, pts, ty, k=8),
                          action="remove", max_rows=3)
        before = _params_bytes(fm)
        with inject.active(inject.Fault(sites.STREAM_SWAP, at=0,
                                        kind=taxonomy.PREEMPTION)):
            r = apply_plan(fm, plan, steps=STEPS)
        assert r.status == "rolled_back"
        assert r.reason == taxonomy.PREEMPTION
        assert _params_bytes(fm) == before
        assert len(fm.data_sets["train"].x) == N_TRAIN
        # the restored train set keeps the plan fresh: the retry commits
        again = apply_plan(fm, plan, steps=STEPS)
        assert again.committed

    def test_entry_site_failure_rolls_back_before_any_work(self, fm):
        pts, ty = _test_points(fm)
        plan = build_plan(fm, reverse_topk(fm, pts, ty, k=8),
                          action="remove", max_rows=3)
        with inject.active(inject.Fault(sites.AUDIT_APPLY, at=0,
                                        kind=taxonomy.WORKER)):
            r = apply_plan(fm, plan, steps=STEPS)
        assert r.status == "rolled_back"
        assert r.reason == taxonomy.WORKER
        assert len(fm.data_sets["train"].x) == N_TRAIN

    def test_stale_plan_rejected(self, fm):
        pts, ty = _test_points(fm)
        plan = build_plan(fm, reverse_topk(fm, pts, ty, k=8),
                          action="remove", max_rows=3)
        assert apply_plan(fm, plan, steps=STEPS).committed
        with pytest.raises(ValueError, match="stale plan"):
            apply_plan(fm, plan, steps=STEPS)
        with pytest.raises(ValueError, match="stale plan"):
            verify_plan(fm, plan, pts, ty, num_steps=2, retrain_times=1)


class TestVerify:
    def test_rank_helpers(self):
        a = np.array([3.0, 1.0, 2.0])
        assert spearman(a, a) == pytest.approx(1.0)
        assert spearman(a, -a) == pytest.approx(-1.0)
        assert sign_agreement(np.array([-1.0, 2.0]),
                              np.array([-0.5, 0.1])) == pytest.approx(1.0)
        assert sign_agreement(np.array([-1.0, 2.0]),
                              np.array([0.5, 0.1])) == pytest.approx(0.5)

    def test_verify_runs_journals_and_publishes(self, fm, tmp_path):
        pts, ty = _test_points(fm)
        plan = build_plan(fm, reverse_topk(fm, pts, ty, k=8),
                          action="remove", max_rows=2)
        kw = dict(num_steps=20, batch_size=50, learning_rate=1e-3,
                  retrain_times=2, max_rows=2, seed=0)
        jpath = str(tmp_path / "verify.journal.jsonl")
        apath = str(tmp_path / "verify.npz")
        fp = verify_fingerprint(fm, plan, pts, **kw)
        with Journal.open(jpath, fp, fsync=False) as j:
            res = verify_plan(fm, plan, pts, ty, journal=j,
                              artifact_path=apath, **kw)
        assert np.all(np.isfinite(res.actual))
        assert len(res.predicted) == len(res.actual) == 2
        assert -1.0 <= res.spearman <= 1.0
        assert 0.0 <= res.sign_agreement <= 1.0
        arrays = load_npz(apath, require_manifest=True)
        assert np.array_equal(arrays["row_ids"], res.row_ids)
        man = read_manifest(apath)
        assert man["fingerprint"]["plan_id"] == plan.plan_id
        size = os.path.getsize(jpath)
        with Journal.open(jpath, fp, resume=True, fsync=False) as j2:
            res2 = verify_plan(fm, plan, pts, ty, journal=j2, **kw)
        assert res2.actual.tobytes() == res.actual.tobytes()
        assert res2.sign_agreement == res.sign_agreement
        assert os.path.getsize(jpath) == size

    def test_mesh_raises_naming_a13(self, fm):
        """``verify_plan(mesh=...)`` shards the lanes (ported): the
        predictions equal, the retrained outcomes within the reference's
        lane bar of the meshless run, two mesh runs bitwise."""
        pts, ty = _test_points(fm)
        plan = build_plan(fm, reverse_topk(fm, pts, ty, k=8),
                          action="remove", max_rows=2)
        kw = dict(num_steps=6, batch_size=50, retrain_times=2, max_rows=2)
        base = verify_plan(fm, plan, pts, ty, **kw)
        with pmesh.virtual_devices(2):
            m = pmesh.make_mesh(2, device="cpu")
            got = verify_plan(fm, plan, pts, ty, mesh=m, **kw)
            again = verify_plan(fm, plan, pts, ty, mesh=m, **kw)
        assert np.array_equal(got.predicted, base.predicted)
        np.testing.assert_allclose(got.actual, base.actual, rtol=2e-4,
                                   atol=1e-5)
        assert got.actual.tobytes() == again.actual.tobytes()


# -- port against the JAX package --------------------------------------------
def _tied_accumulators():
    """(name, acc32, k, segment): runs of exact zeros, equal values
    across segment edges, n not a multiple of the segment, k > segment,
    k > n."""
    rng = np.random.default_rng(11)
    out = []
    acc = np.zeros(1000, np.float32)
    acc[[5, 77, 640]] = [-2.0, -1.0, -1.0]
    out.append(("zeros_k_past_negatives", acc, 40, 64))
    acc = np.zeros(1000, np.float32)
    acc[[63, 64, 127, 128, 191, 192, 999]] = -0.5
    out.append(("ties_across_edges", acc, 5, 64))
    vals = np.array([-3.0, -1.0, 0.0, 1.0], np.float32)
    acc = vals[rng.integers(0, 4, 1003)]
    out.append(("ragged_last_segment", acc, 50, 64))
    out.append(("k_past_segment", acc, 100, 64))
    out.append(("k_past_n", acc, 2000, 64))
    out.append(("one_segment", acc, 17, 1 << 16))
    acc = rng.standard_normal(777).astype(np.float32)
    acc[rng.integers(0, 777, 200)] = 0.0
    out.append(("random_with_zeros", acc, 300, 100))
    return out


class TestSelectionAgainstReference:
    @pytest.mark.parametrize("name,acc,k,segment", _tied_accumulators(),
                             ids=[c[0] for c in _tied_accumulators()])
    def test_exactly_the_references(self, name, acc, k, segment):
        got_i, got_v = port_reverse._segmented_topk_negative(
            acc, k, segment, device="cpu")
        want_i, want_v = ref_reverse._segmented_topk_negative(acc, k, segment)
        assert np.array_equal(got_i, np.asarray(want_i)), name
        assert got_v.tobytes() == np.asarray(want_v, np.float32).tobytes()
        # and the plain selection under the total (value, id) order
        order = np.lexsort((np.arange(len(acc)), acc))[:k]
        assert np.array_equal(got_i, order)


def _carry(ref_model, port_model) -> None:
    """Put the reference's trained params into the port's model (a fresh
    Adam state: verify and the sweep read only the params)."""
    params = params_from_numpy(
        port_model.model,
        {k: np.asarray(v) for k, v in ref_model.state.params.items()}, "cpu")
    port_model.state = TrainState(params, adam_init(params),
                                  int(ref_model.state.step))


@pytest.fixture(scope="module")
def ref_pair(tmp_path_factory):
    """The reference's FIAModel trained 24 steps, and the port's model at
    its params."""
    x, y = _data()
    ref = RefFIAModel(
        "MF", U, I, K, WD, batch_size=50,
        data_sets={"train": RefDataset(x, y)},
        initial_learning_rate=1e-2, damping=DAMP,
        train_dir=str(tmp_path_factory.mktemp("ref-audit")),
        model_name="audit-test", solver="direct", seed=0,
    )
    ref.train(24, save_checkpoints=False, verbose=False)
    port = _port_model(tmp_path_factory.mktemp("port-audit"))
    _carry(ref, port)
    return ref, port


class TestAgainstReference:
    def test_sweep_scores_and_ids(self, ref_pair):
        ref, port = ref_pair
        pts, ty = _test_points(port, n=12)
        want = ref_reverse.reverse_topk(ref, pts, ty, k=24)
        got = reverse_topk(port, pts, ty, k=24)
        assert got.sweep_id == want.sweep_id
        assert got.rows_scored == want.rows_scored
        np.testing.assert_allclose(got.group_scores, want.group_scores,
                                   rtol=RTOL, atol=ATOL)
        # row ids equal, but where two reference values lie within the
        # bar of each other, float32 rounding may order them either way
        g = np.asarray(want.group_scores, np.float64)
        near = 0
        for a, b in zip(got.row_ids, want.row_ids):
            if a != b:
                assert abs(g[a] - g[b]) <= ATOL + RTOL * abs(g[b]), (a, b)
                near += 1
        print(f"float32 near-tie positions: {near} of {len(got.row_ids)}")
        np.testing.assert_allclose(got.loss_deltas, want.loss_deltas,
                                   rtol=RTOL, atol=ATOL)

    @pytest.mark.parametrize("action,reweight",
                             [("remove", None), ("reweight", 0.25)])
    def test_plan_id(self, ref_pair, action, reweight):
        ref, port = ref_pair
        rows = np.array([7, 3, 201], np.int64)
        assert port_plan._plan_id(action, rows, reweight, 24, "k") == \
            ref_plan._plan_id(action, rows, reweight, 24, "k")

    def test_plan_and_verify(self, ref_pair, tmp_path):
        ref, port = ref_pair
        pts, ty = _test_points(port, n=12)
        sweep = reverse_topk(port, pts, ty, k=16)
        plan = build_plan(port, sweep, action="remove", max_rows=3)
        rsweep = ref_reverse.reverse_topk(ref, pts, ty, k=16)
        rplan = ref_plan.build_plan(ref, rsweep, action="remove",
                                    max_rows=3)
        assert np.array_equal(rplan.row_ids, plan.row_ids)
        assert rplan.plan_id == plan.plan_id
        # the same plan through both verifiers, one batch an epoch
        twin = ref_plan.UnlearnPlan(**vars(plan))
        controls = np.argsort(-sweep.group_scores.astype(np.float64),
                              kind="stable")[:2].astype(np.int64)
        deltas = sweep.group_scores[controls].astype(np.float64)
        kw = dict(num_steps=20, batch_size=N_TRAIN, learning_rate=1e-3,
                  retrain_times=2, max_rows=3, seed=0,
                  control_rows=controls, control_deltas=deltas)
        got = verify_plan(port, plan, pts, ty, **kw)
        want = ref_verify.verify_plan(ref, twin, pts, ty, **kw)
        assert got.predicted.tobytes() == np.asarray(
            want.predicted).tobytes()
        assert np.array_equal(got.row_ids, want.row_ids)
        assert got.plan_rows == want.plan_rows
        np.testing.assert_allclose(got.actual, want.actual,
                                   rtol=RTOL, atol=ATOL)
        # the fingerprints that bind a journal are the reference's
        fkw = {k: kw[k] for k in ("num_steps", "batch_size", "learning_rate",
                                  "retrain_times", "seed", "max_rows")}
        assert verify_fingerprint(port, plan, pts, control_rows=controls,
                                  **fkw) == ref_verify.verify_fingerprint(
            ref, twin, pts, control_rows=controls, **fkw)

    def test_rank_helpers_equal(self):
        rng = np.random.default_rng(3)
        for n in (1, 2, 7, 40):
            a = rng.integers(-3, 4, n).astype(np.float64)
            b = rng.standard_normal(n)
            assert port_verify._ranks(a).tobytes() == \
                ref_verify._ranks(a).tobytes()
            assert port_verify.spearman(a, b) == ref_verify.spearman(a, b)
            assert port_verify.sign_agreement(a, b) == \
                ref_verify.sign_agreement(a, b)


# -- the driver --------------------------------------------------------------
# scripts/unlearn_smoke.sh's arguments
UNLEARN_SMOKE = [
    "--dataset", "synthetic", "--synth_users", "60", "--synth_items", "40",
    "--synth_train", "2000", "--synth_test", "40", "--split_seed", "3",
    "--seed", "0", "--model", "MF", "--embed_size", "4",
    "--weight_decay", "1e-3", "--damping", "1e-3", "--lr", "1e-2",
    "--batch_size", "200", "--num_steps_train", "300", "--solver", "direct",
    "--corrupt_rows", "40", "--topk", "16", "--plan_rows", "4",
    "--controls", "4", "--verify", "1", "--verify_steps", "150",
    "--retrain_times", "2", "--apply", "1", "--apply_steps", "40",
    "--force_apply",
]
SUMMARY_KEYS = {
    "model_key", "sweep_id", "rows_scored", "rows_per_s", "plan_id",
    "plan_action", "plan_rows", "predicted_delta", "planted_hit_rate",
    "plan_path", "gate_passed", "sign_agreement", "spearman",
    "verify_artifact", "apply_status", "apply_seconds",
}


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


def _driver(argv, env, virtual_slots=None):
    """The driver in a subprocess; ``virtual_slots`` arms that many
    virtual device slots in it first (``--mesh`` over one CPU)."""
    arm = ("" if virtual_slots is None else
           "from fia_tpu_torch.parallel import mesh\n"
           f"mesh.set_virtual_devices({int(virtual_slots)})\n")
    return subprocess.run(
        [sys.executable, "-c",
         "import sys, torch; torch.set_num_threads(2)\n" + arm +
         "from fia_tpu_torch.cli import debug_data\n"
         "debug_data.main(sys.argv[1:])\n"
         "assert not any(m == 'jax' or m.startswith(('jax.', 'fia_tpu.'))\n"
         "               for m in sys.modules), 'jax or fia_tpu loaded'\n",
         *argv],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)


class TestDriver:
    def test_unlearn_smoke_arguments(self, no_jax_env, tmp_path):
        out_json = tmp_path / "unlearn.json"
        out = _driver(UNLEARN_SMOKE + [
            "--backend", "cpu", "--train_dir", str(tmp_path),
            "--json_out", str(out_json)], no_jax_env)
        assert out.returncode == 0, out.stderr[-3000:]
        s = json.loads(out_json.read_text())
        assert set(s) == SUMMARY_KEYS
        assert s["rows_scored"] > 0 and s["rows_per_s"] > 0
        assert s["plan_action"] == "remove" and s["plan_rows"] == 4
        assert s["predicted_delta"] < 0
        assert s["planted_hit_rate"] is not None
        assert np.isfinite(s["sign_agreement"]) and np.isfinite(
            s["spearman"])
        assert isinstance(s["gate_passed"], bool)
        assert s["apply_status"] == "committed"
        for art in (s["plan_path"], s["verify_artifact"]):
            assert os.path.exists(art)
            assert os.path.exists(art + ".manifest.json")

    def test_mesh_raises_naming_a13(self, no_jax_env, tmp_path):
        """``--mesh 2`` (ported): over two virtual slots the driver runs
        to the end with the reference's keys; with one CPU slot visible
        it exits naming the virtual slots, before training."""
        out_json = tmp_path / "mesh.json"
        out = _driver(UNLEARN_SMOKE + [
            "--backend", "cpu", "--train_dir", str(tmp_path / "a"),
            "--json_out", str(out_json), "--mesh", "2"], no_jax_env,
            virtual_slots=2)
        assert out.returncode == 0, out.stderr[-3000:]
        s = json.loads(out_json.read_text())
        assert set(s) == SUMMARY_KEYS and s["rows_scored"] > 0
        out = _driver(UNLEARN_SMOKE + [
            "--backend", "cpu", "--train_dir", str(tmp_path / "b"),
            "--mesh", "2"], no_jax_env)
        assert out.returncode != 0
        assert "--mesh 2 requested" in out.stderr
        assert "set_virtual_devices" in out.stderr
        assert not os.path.exists(tmp_path / "b") or not os.listdir(
            tmp_path / "b")

    def test_default_device_is_cuda(self, no_jax_env, tmp_path):
        out = _driver(UNLEARN_SMOKE + ["--train_dir", str(tmp_path)],
                      no_jax_env)
        assert out.returncode != 0 and "CUDA" in out.stderr


@pytest.mark.parametrize("mod,name", [
    ("reverse", "reverse_topk"), ("reverse", "sweep_fingerprint"),
    ("plan", "build_plan"), ("plan", "save_plan"), ("plan", "load_plan"),
    ("plan", "apply_plan"), ("verify", "verify_plan"),
    ("verify", "verify_fingerprint")])
def test_signature_is_the_references(mod, name):
    """The reference's parameters, in its order and with its defaults
    (``verify_plan``'s ``mesh`` among them)."""
    import inspect

    port_mod = {"reverse": port_reverse, "plan": port_plan,
                "verify": port_verify}[mod]
    ref_mod = {"reverse": ref_reverse, "plan": ref_plan,
               "verify": ref_verify}[mod]
    port = inspect.signature(getattr(port_mod, name)).parameters
    ref = inspect.signature(getattr(ref_mod, name)).parameters
    assert list(port) == list(ref)
    for key, p in ref.items():
        assert port[key].default == p.default, key

"""End-to-end chaos scenarios over the production entry points (port of
``fia_tpu/chaos/scenarios.py``: the same scenarios, names, workload
shapes, fault domains, caps and oracles).

Each scenario is a small, CPU-bounded workload driven through the REAL
Trainer / InfluenceEngine / InfluenceService code paths — not mocks —
with a declared *fault domain*: the injection sites the workload is
guaranteed to reach, the kinds meaningful there, and how many calls
each site is guaranteed to see (``max_at``). The benign domain is the
subset whose documented recovery is bit-identity-preserving; schedules
drawn from it must reproduce the undisturbed golden run exactly.

Scenario state that is safe to share across runs (trainers, engines and
their captured CUDA graphs) lives on the scenario instance so a smoke
run captures each geometry once; everything run-scoped (checkpoints,
journals, disk caches) lands in the per-run ``workdir``. All retry backoff runs
under a :class:`~fia_tpu_torch.reliability.policy.VirtualClock` — a chaos
run never sleeps wall-clock time.

The two ``selftest`` scenarios are the harness's own fixtures: a
trivial retry-loop workload with a deliberately *broken* variant whose
retry path drops a unit's contribution. The broken one exists so tests
(and ``--scenario selftest-broken``) can watch the full
fail → shrink → replay pipeline end-to-end without touching a device.

What differs from the reference:

- every scenario takes ``device`` (None: the CUDA device, raising
  without one; ``"cpu"``: the CPU), and its engines resolve their score
  stage from ``kernel="auto"`` — the hand kernels on the card, their
  plain versions on the CPU — where the reference pins its XLA twin;
- fresh weights come from a ``torch.Generator`` seeded 0
  (:func:`init_params`), not ``jax.random.PRNGKey(0)``: golden runs are
  port against port;
- the mesh scenarios always build their mesh: over real CUDA devices
  when that many are visible, else over virtual slots laid on the one
  device (``parallel.mesh.virtual_devices``, armed for the scenario's
  construction and each of its runs), so they never degrade to one
  device and always arm the reference's mesh domains.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

from fia_tpu_torch.reliability import inject, sites, taxonomy
from fia_tpu_torch.reliability import policy as rpolicy
from fia_tpu_torch.reliability.journal import Journal

# Transient device kinds whose retry recovery is bit-identical
# (functional inputs reused verbatim).
_TRANSIENT_KINDS = (taxonomy.WORKER, taxonomy.PREEMPTION, taxonomy.AMBIGUOUS)
# On-disk damage kinds; recovery is walk-back / self-heal — bit-identical.
_DAMAGE_KINDS = (inject.TORN, inject.BITFLIP, inject.STALE_MANIFEST)
# Kinds that kill a workload (classified surfacing, no bit-identity).
_KILL_KINDS = (taxonomy.OOM, taxonomy.HOST_OOM, taxonomy.DEADLINE)

# Shared tiny-MF workload shape (the repo's test convention).
_U, _I, _K = 30, 20, 4
_WD, _DAMP = 1e-2, 1e-3

# Backoff shaped like production training retry but able to absorb a
# worst-case smoke schedule (3 consecutive transient faults on one
# site); the VirtualClock makes the delays free.
_CHAOS_RETRY = rpolicy.RetryPolicy(
    max_attempts=4, base_delay=2.0, max_delay=30.0, jitter=0.25
)


def init_params(model, device):
    """A scenario model's fresh weights: a ``torch.Generator`` seeded 0
    (the reference's ``jax.random.PRNGKey(0)`` draws cannot be
    reproduced; ROADMAP Queue C)."""
    return model.init_params(torch.Generator().manual_seed(0), device)


def _host(x) -> np.ndarray:
    """A host numpy copy of an outcome array (oracles compare bytes)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy().copy()
    return np.array(x, copy=True)


def _mesh_slots(n: int, device):
    """The scope in which a scenario's ``n``-slot mesh lives: the real
    CUDA devices when ``n`` are visible, else ``n`` virtual slots over
    the one device. The count stays armed for every run, so the
    liveness probe sees the slots a loss has not dropped."""
    from fia_tpu_torch.device import resolve_device
    from fia_tpu_torch.parallel import mesh as pmesh

    dev = resolve_device(device)
    if dev.type == "cuda" and torch.cuda.device_count() >= n:
        return contextlib.nullcontext()
    return pmesh.virtual_devices(n)


def _toy_data(seed: int, n: int):
    rng = np.random.default_rng(seed)
    x = np.stack(
        [rng.integers(0, _U, n), rng.integers(0, _I, n)], axis=1
    ).astype(np.int32)
    y = rng.integers(1, 6, n).astype(np.float32)
    return x, y


class Scenario:
    """Base: a named workload with benign/full fault domains.

    ``run(workdir, events)`` executes the workload under whatever fault
    plan the runner armed and returns the outcome payload (name →
    array/str/int). It raises on unrecovered failure — classification
    is the runner's job.
    """

    name: str = "?"
    benign_domain: dict = {}
    full_domain: dict = {}

    def __init__(self, device=None):
        self.device = device

    def domain(self, benign: bool) -> dict:
        return self.benign_domain if benign else self.full_domain

    def run(self, workdir: str, events: list) -> dict:
        raise NotImplementedError

    def check(self, golden: dict, record) -> list:
        """Scenario-specific oracles beyond the standard battery."""
        return []


class SelftestScenario(Scenario):
    """Retry-loop counter workload — the harness validating itself.

    Six work units, each firing ``chaos.unit`` inside a production
    RetryPolicy under virtual time. Transient kinds retry to the same
    unit value (bit-identical); kill kinds surface classified.
    """

    name = "selftest"
    UNITS = 6
    broken = False
    benign_domain = {
        sites.CHAOS_UNIT: (_TRANSIENT_KINDS, UNITS),
    }
    full_domain = {
        sites.CHAOS_UNIT: (_TRANSIENT_KINDS + _KILL_KINDS, UNITS),
        sites.CHAOS_SCENARIO: ((taxonomy.WORKER,), 1),
    }

    def run(self, workdir: str, events: list) -> dict:
        clock = rpolicy.VirtualClock()
        vals = []
        for u in range(self.UNITS):
            retried = []

            def work(u=u):
                inject.fire(sites.CHAOS_UNIT)
                return float(u * 3 + 1)

            v = _CHAOS_RETRY.run(
                work, clock=clock,
                on_retry=lambda kind, a, e: retried.append(kind),
            )
            if retried:
                events.append({"event": "unit_retried", "unit": u,
                               "kinds": list(retried)})
            if self.broken and retried:
                # The deliberately seeded bug (selftest-broken only): a
                # retried unit loses its contribution. The bit_identity
                # oracle must catch this and ddmin must shrink any
                # schedule that trips it to a single transient fault.
                v = 0.0
            vals.append(v)
        return {"units": np.asarray(vals, np.float64)}


class SelftestBrokenScenario(SelftestScenario):
    name = "selftest-broken"
    broken = True


class TrainResumeScenario(Scenario):
    """train → checkpoint → kill → restore → resume, bit-identically.

    Phase 1 trains to the kill step under rotated checkpointing, then
    the in-memory state is discarded (the kill). Phase 2 sweeps stale
    temps, restores the newest valid generation — walking back past
    damaged ones, all the way to from-scratch when every generation is
    corrupt — and finishes training. The absolute-step epoch keys and
    step masks make the final params bit-identical to an uninterrupted
    golden run from ANY valid restore point, which is exactly what the
    oracle asserts.
    """

    name = "train_resume"
    N, BATCH, STEPS, KILL, EVERY, KEEP = 400, 100, 40, 24, 8, 3
    # phase 1: 6 epoch dispatches; phase 2: >= 4 more (restore at the
    # kill step) — 10 guaranteed. Checkpoint publishes: 3 in phase 1,
    # >= 2 in phase 2.
    benign_domain = {
        sites.TRAINER_EPOCH: (_TRANSIENT_KINDS, 10),
        sites.CHECKPOINT_PUBLISH: (_DAMAGE_KINDS, 5),
    }
    full_domain = {
        sites.TRAINER_EPOCH: (_TRANSIENT_KINDS + (taxonomy.OOM,), 10),
        sites.CHECKPOINT_PUBLISH: (_DAMAGE_KINDS, 5),
        sites.CHAOS_SCENARIO: ((taxonomy.WORKER,), 1),
    }

    def __init__(self, device=None):
        from fia_tpu_torch.models import MF
        from fia_tpu_torch.train.trainer import TrainConfig, Trainer

        super().__init__(device)
        self.x, self.y = _toy_data(0, self.N)
        self.model = MF(_U, _I, _K, _WD)
        self.params0 = init_params(self.model, device)
        cfg = TrainConfig(batch_size=self.BATCH, num_steps=self.STEPS,
                          learning_rate=1e-2, seed=0)
        # one Trainer for every run/phase, and the VirtualClock absorbs
        # retry backoff
        self.trainer = Trainer(self.model, cfg, retry_policy=_CHAOS_RETRY,
                               clock=rpolicy.VirtualClock(), device=device)
        self.fingerprint = {"kind": "chaos-train", "seed": 0,
                            "steps": self.STEPS, "batch": self.BATCH}

    def _params_outcome(self, state) -> dict:
        # leaves numbered in sorted-key order, as jax.tree_util.tree_leaves
        # numbers the reference's dict: param{i} names the same tensor
        out = {"step": int(state.step)}
        for i, name in enumerate(sorted(state.params)):
            out[f"param{i}"] = _host(state.params[name])
        return out

    def run(self, workdir: str, events: list) -> dict:
        from fia_tpu_torch.train import checkpoint
        from fia_tpu_torch.train.trainer import TrainState
        from fia_tpu_torch.utils import io

        ckpt_dir = os.path.join(workdir, "ckpts")
        ck1 = checkpoint.PeriodicCheckpointer(
            ckpt_dir, every=self.EVERY, keep=self.KEEP,
            fingerprint=self.fingerprint)
        state = self.trainer.init_state(self.params0)
        # phase 1: train to the kill point, then discard state (the kill)
        self.trainer.fit(state, self.x, self.y, num_steps=self.KILL,
                         checkpointer=ck1)

        # phase 2: a fresh process would sweep temps, restore, resume
        io.sweep_stale_tmps(ckpt_dir)
        restored = checkpoint.restore_latest_valid(
            ckpt_dir, self.params0, self.trainer.init_state(self.params0).opt_state,
            fingerprint=self.fingerprint, verbose=False)
        if restored is None:
            # every generation corrupt: the ladder's last rung
            events.append({"event": "restore_exhausted",
                           "kind": "from_scratch"})
            state2 = self.trainer.init_state(self.params0)
        else:
            events.append({"event": "resumed", "step": int(restored[2])})
            state2 = TrainState(restored[0], restored[1], restored[2])
        ck2 = checkpoint.PeriodicCheckpointer(
            ckpt_dir, every=self.EVERY, keep=self.KEEP,
            fingerprint=self.fingerprint)
        ck2._last_step = state2.step
        final = self.trainer.fit(
            state2, self.x, self.y,
            num_steps=self.STEPS - int(state2.step), checkpointer=ck2)
        return self._params_outcome(final)


class QueryCacheScenario(Scenario):
    """Journaled ``query_many`` plus the verified iHVP disk cache.

    Part A runs a journaled multi-batch ``query_many`` with a resume
    loop: an injected ``deadline`` surfaces cleanly with completed
    batches banked, and the reopened journal finishes the remainder —
    the combined scores must be bit-identical to one undisturbed run.
    Part B exercises the disk-cache tier twice per point so a damaged
    entry is quarantined and self-heals into a clean recompute.
    """

    name = "query_cache"
    NPTS, BQ = 6, 2
    benign_domain = {
        # 3 guaranteed pipelined dispatches (part A)
        sites.ENGINE_DISPATCH_FLAT: (
            _TRANSIENT_KINDS[:2] + (taxonomy.DEADLINE,), 3),
        # 2 guaranteed first-publish cache entries (part B)
        sites.ENGINE_CACHE_PUBLISH: (_DAMAGE_KINDS, 2),
    }
    full_domain = {
        sites.ENGINE_DISPATCH_FLAT: (
            _TRANSIENT_KINDS + (taxonomy.OOM, taxonomy.DEADLINE), 3),
        sites.ENGINE_CACHE_PUBLISH: (_DAMAGE_KINDS, 2),
        sites.ENGINE_SOLVE: ((taxonomy.NAN,), 1),
        sites.CHAOS_SCENARIO: ((taxonomy.WORKER,), 1),
    }

    def __init__(self, device=None):
        from fia_tpu_torch.data.dataset import RatingDataset
        from fia_tpu_torch.influence.engine import InfluenceEngine
        from fia_tpu_torch.models import MF

        super().__init__(device)
        x, y = _toy_data(0, 400)
        self.train = RatingDataset(x, y)
        self.model = MF(_U, _I, _K, _WD)
        params = init_params(self.model, device)
        rng = np.random.default_rng(1)
        self.pts = np.stack(
            [rng.integers(0, _U, self.NPTS), rng.integers(0, _I, self.NPTS)],
            axis=1).astype(np.int32)
        self.test_ds = RatingDataset(
            self.pts[:2].copy(), np.full(2, 4.0, np.float32))
        # one engine for every run (captured graphs shared); the disk
        # cache tier is re-pointed into each run's workdir. The score
        # stage stays on kernel='auto' (here and in every scenario
        # below): the hand kernels on the card, their plain versions on
        # the CPU. Golden runs are bitwise contracts within one device,
        # which every run of a scenario shares.
        self.engine = InfluenceEngine(
            self.model, params, self.train, damping=_DAMP,
            model_name="chaos-mf", device=device)

    def run(self, workdir: str, events: list) -> dict:
        eng = self.engine
        eng.cache_dir = os.path.join(workdir, "cache")
        jpath = os.path.join(workdir, "journal.jsonl")
        fp = eng.journal_fingerprint(self.pts, batch_queries=self.BQ)

        # part A: journaled query_many with a deadline-resume loop
        results = None
        for attempt in range(len(self.pts) + 2):
            j = Journal.open(jpath, fp, resume=os.path.exists(jpath),
                             fsync=False)
            try:
                results = eng.query_many(self.pts, batch_queries=self.BQ,
                                         journal=j)
                break
            except taxonomy.DeadlineExpired:
                events.append({"event": "deadline_resume",
                               "attempt": attempt})
            finally:
                j.close()
        if results is None:
            raise taxonomy.DeadlineExpired(
                "query_many never completed within the resume budget")

        out: dict = {}
        t = 0
        for r in results:
            for row in range(len(np.asarray(r.counts))):
                out[f"scores{t}"] = _host(r.scores_of(row))
                t += 1
        out["points_done"] = t

        # part B: publish two cache entries, then re-read them — a
        # damaged entry must quarantine and self-heal to the same scores
        for k in range(2):
            first = eng.get_influence_on_test_loss([k], self.test_ds)
            healed = eng.get_influence_on_test_loss(
                [k], self.test_ds, force_refresh=False)
            out[f"cache{k}"] = _host(healed)
            if not np.array_equal(np.asarray(first), np.asarray(healed)):
                events.append({"event": "cache_heal_drift", "point": k})
        return out

    def check(self, golden: dict, record) -> list:
        from fia_tpu_torch.chaos.oracles import OracleFailure

        failures = []
        for e in record.events:
            if e.get("event") == "cache_heal_drift":
                failures.append(OracleFailure(
                    "cache_self_heal",
                    f"healed cache entry for point {e['point']} is not "
                    "bit-identical to its first computation",
                ))
        if record.error is None and record.workdir:
            jpath = os.path.join(record.workdir, "journal.jsonl")
            if os.path.exists(jpath):
                fp = self.engine.journal_fingerprint(
                    self.pts, batch_queries=self.BQ)
                try:
                    j = Journal.open(jpath, fp, resume=True, fsync=False)
                    if j.corrupt_lines:
                        failures.append(OracleFailure(
                            "journal_consistency",
                            f"{j.corrupt_lines} corrupt journal line(s) "
                            "after a clean completion",
                        ))
                    j.close()
                except Exception as e:
                    failures.append(OracleFailure(
                        "journal_consistency",
                        f"journal reopen failed: {e!r}",
                    ))
        return failures


class ServeStreamScenario(Scenario):
    """A deterministic request stream under overload + dispatch faults.

    Two submit waves sized past the admission queue bound produce
    deterministic ``overload``/``invalid`` rejections; admitted keys
    resolve through hot/disk cache tiers and micro-batched dispatches.
    Benign schedules (disk-tier damage only) must reproduce the golden
    stream bit-identically; under dispatch faults the scenario oracle
    still requires every OK response to match golden byte-for-byte and
    every rejection to carry a classified or admission reason.
    """

    name = "serve_stream"
    MAX_BATCH, MAX_QUEUE, WAVE = 3, 6, 9
    mesh = None  # serve_stream_mesh shards dispatch over a device mesh
    # a JSONL path for the service's events, spans and final metrics
    # snapshot (what ``cli.obs`` reads); None keeps them in memory
    metrics_path = None
    # 4 guaranteed micro-batch dispatches; 10 disk-tier publishes on a
    # shed-free run (benign damage never sheds), but only the first
    # publish is guaranteed once full-domain dispatch faults can shed
    # whole batches.
    benign_domain = {
        sites.SERVE_CACHE_PUBLISH: (_DAMAGE_KINDS, 10),
    }
    full_domain = {
        sites.SERVE_DISPATCH: (
            (taxonomy.WORKER, taxonomy.OOM, taxonomy.DEADLINE), 4),
        sites.SERVE_CACHE_PUBLISH: (_DAMAGE_KINDS, 1),
        sites.CHAOS_SCENARIO: ((taxonomy.WORKER,), 1),
    }

    def __init__(self, device=None):
        from fia_tpu_torch.data.dataset import RatingDataset
        from fia_tpu_torch.influence.engine import InfluenceEngine
        from fia_tpu_torch.models import MF

        super().__init__(device)
        x, y = _toy_data(0, 400)
        self.model = MF(_U, _I, _K, _WD)
        self.params = init_params(self.model, device)
        self.train_ds = RatingDataset(x, y)
        self.engine = InfluenceEngine(
            self.model, self.params, self.train_ds, damping=_DAMP,
            model_name="chaos-serve", device=device)
        # 12 distinct keys; the stream below replays some of them
        rng = np.random.default_rng(2)
        flat = rng.choice(_U * _I, size=12, replace=False)
        self.keys = [(int(k // _I), int(k % _I)) for k in flat]

    def _stream(self):
        k = self.keys
        # wave 1: 6 distinct admits fill the queue, then one invalid id
        # and two duplicates shed as overload
        wave1 = k[:6] + [(-1, 5), k[0], k[1]]
        # wave 2: two hot-cache replays + 4 new keys admit, then 2 new
        # keys and a replay shed as overload
        wave2 = [k[0], k[1]] + k[6:10] + k[10:12] + [k[2]]
        return wave1 + wave2

    def run(self, workdir: str, events: list) -> dict:
        from fia_tpu_torch.serve.request import Request
        from fia_tpu_torch.serve.service import InfluenceService, ServeConfig

        eng = self.engine
        eng.cache_dir = os.path.join(workdir, "cache")
        svc = InfluenceService(
            engine=eng,
            config=ServeConfig(max_batch=self.MAX_BATCH,
                               max_queue=self.MAX_QUEUE,
                               mesh=self.mesh,
                               metrics_path=self.metrics_path),
            clock=rpolicy.VirtualClock(),
        )
        reqs = [Request(u, i, id=f"q{n}")
                for n, (u, i) in enumerate(self._stream())]
        responses = svc.run(reqs, drain_every=self.WAVE)
        if self.metrics_path:
            svc.close()
        out: dict = {}
        for r in responses:
            out[f"{r.id}:status"] = f"{r.status}/{r.reason or ''}"
            if r.ok:
                out[f"{r.id}:scores"] = _host(r.scores)
        stats = svc.cache.stats
        out["shed_batches"] = sum(
            1 for e in events if e.get("event") == "batch_shed")
        events.append({"event": "cache_stats",
                       "hits_hot": int(stats.hits_hot),
                       "hits_disk": int(stats.hits_disk)})
        return out

    def check(self, golden: dict, record) -> list:
        from fia_tpu_torch.chaos.oracles import OracleFailure, _value_diff
        from fia_tpu_torch.serve import admission

        if record.error is not None or record.outcome is None:
            return []
        failures = []
        got = record.outcome
        allowed = {
            taxonomy.OOM, taxonomy.HOST_OOM, taxonomy.AMBIGUOUS,
            taxonomy.WORKER, taxonomy.PREEMPTION, taxonomy.NAN,
            taxonomy.DEADLINE, taxonomy.DEVICE_LOST, taxonomy.HOST_LOST,
            admission.REASON_OVERLOAD, admission.REASON_INVALID,
            admission.REASON_DEGRADED,
        }
        for name, g in golden.items():
            if name.endswith(":status"):
                rid = name[:-len(":status")]
                gs = str(g)
                cs = str(got.get(name, "<missing>"))
                # admission decisions (overload/invalid) are a pure
                # function of the submit stream — faults cannot move them
                for adm in (admission.REASON_OVERLOAD,
                            admission.REASON_INVALID):
                    if (gs.endswith("/" + adm)) != (cs.endswith("/" + adm)):
                        failures.append(OracleFailure(
                            "admission_determinism",
                            f"{rid}: golden {gs} vs chaos {cs}",
                        ))
                if cs.startswith("rejected/"):
                    reason = cs.split("/", 1)[1]
                    if reason not in allowed:
                        failures.append(OracleFailure(
                            "classified_rejection",
                            f"{rid}: unclassified rejection {reason!r}",
                        ))
            elif name.endswith(":scores") and name in got:
                # every answer actually served must match golden bytes
                d = _value_diff(name, g, got[name])
                if d:
                    failures.append(OracleFailure("served_bit_identity", d))
        return failures


class ServeStreamMeshScenario(ServeStreamScenario):
    """The serve_stream workload with dispatch sharded over a 2-slot
    ``data`` mesh (query-axis sharding, docs/design.md §15).

    Same request stream, admission bounds, and fault domain as
    ``serve_stream`` — a dispatch fault on a sharded micro-batch sheds
    exactly that batch, and admission stays a pure function of the
    submit stream. The mesh-specific oracle: every score actually
    served, in the golden run AND under faults, must be BIT-identical
    to a single-device reference stream computed fault-free at
    construction — sharding must never show through in results.
    The mesh is always built: over real CUDA devices when two are
    visible, else over two virtual slots on the one device
    (:func:`_mesh_slots`), where the reference degrades to one device
    with a ``mesh_skipped`` event.
    """

    name = "serve_stream_mesh"
    NDEV = 2
    MODEL_NAME = "chaos-serve-mesh"

    def __init__(self, device=None):
        super().__init__(device)
        from fia_tpu_torch.influence.engine import InfluenceEngine
        from fia_tpu_torch.parallel.mesh import make_mesh

        self.ref = self._single_device_reference()
        with _mesh_slots(self.NDEV, device):
            self.mesh = make_mesh(self.NDEV, device=device)
            self.engine = InfluenceEngine(
                self.model, self.params, self.train_ds, damping=_DAMP,
                model_name=self.MODEL_NAME, mesh=self.mesh,
                device=device)

    def _single_device_reference(self) -> dict:
        """The single-device reference stream, computed fault-free before
        any schedule is armed (no workdir: the disk tier stays off, as it
        is for the first dispatch of every chaos run)."""
        from fia_tpu_torch.serve.request import Request
        from fia_tpu_torch.serve.service import InfluenceService, ServeConfig

        ref_svc = InfluenceService(
            engine=self.engine,
            config=ServeConfig(max_batch=self.MAX_BATCH,
                               max_queue=self.MAX_QUEUE),
            clock=rpolicy.VirtualClock(),
        )
        reqs = [Request(u, i, id=f"q{n}")
                for n, (u, i) in enumerate(self._stream())]
        return {
            r.id: _host(r.scores)
            for r in ref_svc.run(reqs, drain_every=self.WAVE) if r.ok
        }

    def run(self, workdir: str, events: list) -> dict:
        with _mesh_slots(self.NDEV, self.device):
            return super().run(workdir, events)

    def _identity_failures(self, golden: dict, record,
                           oracle: str, why: str) -> list:
        """Every score served, golden and chaos, against the
        single-device reference."""
        from fia_tpu_torch.chaos.oracles import OracleFailure

        failures = []
        outcomes = [("golden", golden)]
        if record.error is None and record.outcome is not None:
            outcomes.append(("chaos", record.outcome))
        for label, out in outcomes:
            for name, v in out.items():
                if not name.endswith(":scores"):
                    continue
                rid = name[: -len(":scores")]
                ref = self.ref.get(rid)
                if ref is None:
                    failures.append(OracleFailure(
                        oracle,
                        f"{label} run served {rid}, which the "
                        "single-device reference rejected",
                    ))
                elif not np.array_equal(np.asarray(v), ref):
                    failures.append(OracleFailure(
                        oracle, f"{label} run: scores for {rid} " + why))
        return failures

    def check(self, golden: dict, record) -> list:
        return super().check(golden, record) + self._identity_failures(
            golden, record, "mesh_single_device_identity",
            "diverge from the single-device reference (sharded dispatch "
            "must be bit-identical)")


class DeviceLossRecoveryScenario(ServeStreamMeshScenario):
    """Kill mesh devices mid-wave; the service must shrink and recover.

    The serve_stream workload over a 4-slot ``data`` mesh, with
    ``device_lost`` faults armed at ``serve.dispatch``. Each loss must
    trigger the mesh-shrink recovery (docs/design.md §18): rebuild over
    the survivors, re-arm, re-dispatch the failed batch — so a BENIGN
    schedule of losses sheds *nothing* and reproduces the golden stream
    bit-identically, through up to three consecutive shrinks (4 → 3 →
    2 → 1 slots; ``max_at=3`` keeps every benign schedule within what
    four slots can absorb). Scenario oracles:

    - ``shrunk_mesh_identity`` — every score served, golden AND chaos,
      matches a fault-free single-device reference bit-for-bit; the
      mesh size the run ended on must never show through in results.
    - ``no_unclassified_errors`` — a run may die or shed, but only
      classified: an unclassified escape or rejection reason means the
      recovery path leaked a raw backend error.

    The mesh is always built (real devices or virtual slots, as in
    ``serve_stream_mesh``), so ``device_lost`` is always in the benign
    domain, as in the reference's runs over its 8 virtual devices.
    """

    name = "device_loss_recovery"
    NDEV = 4
    MODEL_NAME = "chaos-devloss"
    # mesh.rebuild is deliberately NOT in any domain — the site is
    # reachable only after a loss fires, so arming it directly would
    # violate the armed ⇒ fired contract; rebuild-time faults are
    # unit-tested instead. Device loss is benign: its recovery is a
    # bit-identical re-dispatch over the survivors.
    benign_domain = {
        sites.SERVE_DISPATCH: ((taxonomy.DEVICE_LOST,), 3),
        sites.SERVE_CACHE_PUBLISH: (_DAMAGE_KINDS, 10),
    }
    full_domain = {
        sites.SERVE_DISPATCH: (
            (taxonomy.WORKER, taxonomy.OOM, taxonomy.DEADLINE,
             taxonomy.DEVICE_LOST), 4),
        sites.SERVE_CACHE_PUBLISH: (_DAMAGE_KINDS, 1),
        sites.CHAOS_SCENARIO: ((taxonomy.WORKER,), 1),
    }

    def run(self, workdir: str, events: list) -> dict:
        from fia_tpu_torch.parallel.mesh import mesh_fingerprint

        with _mesh_slots(self.NDEV, self.device):
            if (mesh_fingerprint(self.engine.mesh)
                    != mesh_fingerprint(self.mesh)):
                # a prior run's recovery left the shared engine on a
                # shrunk mesh; restore the full topology so every run
                # starts equal
                self.engine.rebuild_mesh(self.mesh)
            out = ServeStreamScenario.run(self, workdir, events)
            # recovery accounting goes in events, NOT the outcome — the
            # golden run never shrinks, and benign runs must stay
            # bit-identical to it in outcome space
            events.append({
                "event": "mesh_after",
                "devices": int(self.engine.mesh.devices.size),
                "shrunk": int(self.NDEV - self.engine.mesh.devices.size),
            })
        return out

    def check(self, golden: dict, record) -> list:
        from fia_tpu_torch.chaos.oracles import OracleFailure

        failures = ServeStreamScenario.check(self, golden, record)
        if record.error is not None and record.error.get("kind") is None:
            failures.append(OracleFailure(
                "no_unclassified_errors",
                f"run died unclassified: {record.error.get('error')}",
            ))
        # rejection-reason classification is covered by the parent's
        # classified_rejection oracle; here: identity
        return failures + self._identity_failures(
            golden, record, "shrunk_mesh_identity",
            "diverge from the fault-free single-device reference "
            "(mesh-shrink recovery must be bit-identical)")


class HostLossRecoveryScenario(DeviceLossRecoveryScenario):
    """Kill whole hosts mid-wave; the pod must shrink by hosts and
    recover.

    The device-loss workload scaled to a pod stand-in: 8 slots under
    a 4-host virtual overlay (2 slots per host,
    ``parallel.mesh.virtual_hosts``), with ``host_lost`` faults armed at
    ``serve.dispatch``. Each loss must trigger the host-granular
    mesh-shrink recovery (docs/design.md §25): drop the lost host's
    ENTIRE slot group via ``surviving_mesh(..., unnamed="host")``,
    rebuild, re-arm, re-dispatch — so a benign schedule of up to
    three host losses (8 → 6 → 4 → 2 slots) sheds nothing and stays
    bit-identical to the fault-free single-device reference. Oracles
    are inherited: ``shrunk_mesh_identity`` and
    ``no_unclassified_errors`` — a host loss that escapes unclassified
    or perturbs a single served byte is the failure this scenario
    exists to catch. ``mesh.rebuild_multihost`` is deliberately NOT in
    any domain for the same armed ⇒ fired reason as ``mesh.rebuild``.
    """

    name = "host_loss_recovery"
    NDEV = 8
    NHOSTS = 4
    # the device-loss sites and caps, with host-granular evidence
    benign_domain = {
        sites.SERVE_DISPATCH: ((taxonomy.HOST_LOST,), 3),
        sites.SERVE_CACHE_PUBLISH: (_DAMAGE_KINDS, 10),
    }
    full_domain = {
        sites.SERVE_DISPATCH: (
            (taxonomy.WORKER, taxonomy.OOM, taxonomy.DEADLINE,
             taxonomy.HOST_LOST), 4),
        sites.SERVE_CACHE_PUBLISH: (_DAMAGE_KINDS, 1),
        sites.CHAOS_SCENARIO: ((taxonomy.WORKER,), 1),
    }

    def run(self, workdir: str, events: list) -> dict:
        from fia_tpu_torch.parallel import mesh as pmesh

        # the virtual-host overlay is scoped to the run so other
        # scenarios in the same battery see real process indices
        overlay = {
            int(d.id): int(d.id) // (self.NDEV // self.NHOSTS)
            for d in self.mesh.devices.flat
        }
        with pmesh.virtual_hosts(overlay):
            out = super().run(workdir, events)
            events.append({
                "event": "hosts_after",
                "hosts": int(len(pmesh.mesh_hosts(self.engine.mesh))),
            })
        return out


class FactorBankScenario(Scenario):
    """Factor-bank publish → verified load → O(1) hit serving → miss
    fall-through, under artifact damage and load faults.

    Each run republishes the (fixed, precomputed) bank into its workdir
    — the ``factor.publish`` damage point — then a ``precomputed``
    engine attempts the verified load (``engine.factor_load``) and
    serves every banked pair plus a few unbanked ones, one query at a
    time. A torn/bit-rotted/stale-manifest bank must quarantine and
    degrade to the solver ladder; a transient load fault must degrade
    the same way; and in every case each served answer must be
    byte-identical to one of the two fault-free references computed at
    construction (bank hit or bank-less ladder — anything else is a
    silent wrong answer). Miss-pair scores go into the outcome payload:
    they are served by the ladder regardless of bank health, so benign
    schedules must reproduce them bit-identically.
    """

    name = "factor_bank"
    NPAIRS, NMISS = 8, 3
    benign_domain = {
        sites.FACTOR_PUBLISH: (_DAMAGE_KINDS, 1),
        sites.ENGINE_FACTOR_LOAD: (_TRANSIENT_KINDS, 1),
    }
    full_domain = {
        sites.FACTOR_PUBLISH: (_DAMAGE_KINDS, 1),
        sites.ENGINE_FACTOR_LOAD: (
            _TRANSIENT_KINDS + (taxonomy.HOST_OOM,), 1),
        sites.ENGINE_SOLVE: ((taxonomy.NAN,), 1),
        sites.CHAOS_SCENARIO: ((taxonomy.WORKER,), 1),
    }

    def __init__(self, device=None):
        import tempfile

        from fia_tpu_torch.data.dataset import RatingDataset
        from fia_tpu_torch.influence import factor as fbank
        from fia_tpu_torch.influence.engine import InfluenceEngine
        from fia_tpu_torch.models import MF

        super().__init__(device)
        x, y = _toy_data(0, 400)
        self.model = MF(_U, _I, _K, _WD)
        params = init_params(self.model, device)
        train = RatingDataset(x, y)
        bank_src = InfluenceEngine(
            self.model, params, train, damping=_DAMP,
            model_name="chaos-factor", lissa_depth=30, device=device)
        pairs = fbank.select_hot_pairs(
            bank_src.index, max_entries=self.NPAIRS,
            top_users=4, top_items=4)
        # the bank content is fixed; runs only re-PUBLISH it (that is
        # where the damage channel bites), never re-factorize
        self.bank = fbank.build_bank(bank_src, pairs)
        self.fp = fbank.bank_fingerprint(
            "chaos-factor", self.model.block_size, _DAMP,
            *bank_src._train_host)
        self.pairs = [(int(u), int(i)) for u, i in pairs]
        banked = set(self.pairs)
        self.miss_pairs = [
            (int(u), int(i))
            for u, i in zip(x[:, 0], x[:, 1])
            if (int(u), int(i)) not in banked
        ][: self.NMISS]

        # one precomputed engine for every run (captured programs are
        # shared); its cache_dir/bank state is re-pointed per run
        self.eng = InfluenceEngine(
            self.model, params, train, damping=_DAMP,
            solver="precomputed", cache_dir=tempfile.mkdtemp(
                prefix="fia-chaos-factor-init-"),
            model_name="chaos-factor", lissa_depth=30, device=device)

        # fault-free references: bank-hit bytes and bank-less ladder
        # bytes per pair, each queried alone (T=1) so per-pair results
        # are independent of what else is in a batch
        path = fbank.default_bank_path(self.eng.cache_dir, "chaos-factor")
        fbank.publish_bank(self.bank, path, self.fp)
        assert self.eng.ensure_factor_bank() == len(self.bank)
        self.ref_bank = [
            self._one(self.eng, p).tobytes() for p in self.pairs
        ]
        # the rung a rejected bank degrades to — since the certified
        # rung landed that is ``sampled``, not lissa (bitwise-exact
        # here: toy counts sit below the default sample cap)
        ladder = InfluenceEngine(
            self.model, params, train, damping=_DAMP,
            solver=rpolicy.next_solver("precomputed"),
            model_name="chaos-factor", lissa_depth=30, device=device)
        self.ref_ladder = [
            self._one(ladder, p).tobytes() for p in self.pairs
        ]

    @staticmethod
    def _one(engine, pair) -> np.ndarray:
        res = engine.query_batch(np.asarray([pair], np.int64))
        return _host(res.scores_of(0))

    def run(self, workdir: str, events: list) -> dict:
        from fia_tpu_torch.influence import factor as fbank

        eng = self.eng
        eng.cache_dir = os.path.join(workdir, "cache")
        eng.unload_factor_bank()
        eng.solver = "precomputed"  # undo any sticky prior escalation
        path = fbank.default_bank_path(eng.cache_dir, eng.model_name)
        fbank.publish_bank(self.bank, path, self.fp)
        n = eng.ensure_factor_bank()
        events.append({"event": "bank_loaded", "entries": int(n)})

        for k, pair in enumerate(self.pairs):
            b = self._one(eng, pair).tobytes()
            via = ("bank" if b == self.ref_bank[k]
                   else "ladder" if b == self.ref_ladder[k]
                   else "neither")
            events.append({"event": "pair_served", "pair": k, "via": via})

        out: dict = {}
        for k, pair in enumerate(self.miss_pairs):
            out[f"miss{k}"] = self._one(eng, pair).copy()
        out["pairs_total"] = len(self.pairs)
        events.append({"event": "bank_stats", **eng.bank_stats()})
        return out

    def check(self, golden: dict, record) -> list:
        from fia_tpu_torch.chaos.oracles import OracleFailure

        if record.error is not None or record.outcome is None:
            return []
        failures = []
        entries = next(
            (e["entries"] for e in record.events
             if e.get("event") == "bank_loaded"), 0)
        for e in record.events:
            if e.get("event") != "pair_served":
                continue
            if e["via"] == "neither":
                failures.append(OracleFailure(
                    "factor_serving_integrity",
                    f"pair {e['pair']}: served scores match neither the "
                    "bank reference nor the ladder reference "
                    "(silent wrong answer)",
                ))
            elif entries == 0 and e["via"] != "ladder":
                failures.append(OracleFailure(
                    "factor_fall_through",
                    f"pair {e['pair']} served via {e['via']} with no "
                    "bank loaded — a rejected bank must degrade to the "
                    "solver ladder",
                ))
        return failures


class UpdateWhileServingScenario(Scenario):
    """Streaming updates (``FIAModel.apply_updates``) under live serving,
    mid-update kills, and swap faults — docs/design.md §17.

    The train set is split into two non-interacting communities; both
    updates land entirely in community A, so community-B probes are
    provably outside every footprint. Three fault-free reference states
    (base, after update 1, after both) are served T=1 at construction;
    every probe answered during a chaos run must match the reference of
    the state it was admitted under, byte-for-byte:

    - pre/mid/post waves pin serving to base / post-1 / post-2 state;
    - a ticket submitted BEFORE update 2 and drained after it must
      answer on its admission epoch (the fenced post-1 state);
    - untouched (community-B) probes must be bit-identical in every
      wave — the local-update projection at work;
    - a rolled-back attempt must leave serving answering the old state,
      and the retry (resuming the attempt's checkpoints) must commit to
      the same bytes as the uninterrupted golden run;
    - a committed swap must re-key untouched cache entries, never
      wholesale-flush (``swap_stats`` oracle).
    """

    name = "update_while_serving"
    BASE_STEPS, STEPS, EVERY = 24, 16, 4
    # community A: users 0-14 x items 0-9; community B: the rest. The
    # update rows below stay inside A, so B probes are untouched by
    # construction (footprint reach cannot cross communities).
    TOUCHED = ((2, 3), (5, 1), (11, 8))
    UNTOUCHED = ((16, 12), (22, 17), (28, 11))
    FENCE = (2, 3)
    # each update fires stream.update once and stream.swap once on a
    # fault-free attempt: 2 guaranteed calls per site across the two
    # updates; the retry budget (4 attempts/update) absorbs a worst-case
    # 3-fault smoke schedule on one site with one attempt to spare
    benign_domain = {
        sites.STREAM_UPDATE: (_TRANSIENT_KINDS, 2),
        sites.STREAM_SWAP: (_TRANSIENT_KINDS, 2),
    }
    full_domain = {
        sites.STREAM_UPDATE: (_TRANSIENT_KINDS + _KILL_KINDS, 2),
        sites.STREAM_SWAP: (_TRANSIENT_KINDS + _KILL_KINDS, 2),
        sites.CHAOS_SCENARIO: ((taxonomy.WORKER,), 1),
    }

    @staticmethod
    def _community_data(seed: int, n: int):
        rng = np.random.default_rng(seed)
        half = n // 2
        xa = np.stack([rng.integers(0, 15, half),
                       rng.integers(0, 10, half)], axis=1)
        xb = np.stack([rng.integers(15, _U, n - half),
                       rng.integers(10, _I, n - half)], axis=1)
        x = np.concatenate([xa, xb]).astype(np.int32)
        y = rng.integers(1, 6, n).astype(np.float32)
        return x, y

    def __init__(self, device=None):
        import tempfile

        from fia_tpu_torch.api import FIAModel
        from fia_tpu_torch.data.dataset import RatingDataset

        super().__init__(device)
        x, y = self._community_data(0, 240)
        self.fm = FIAModel(
            "MF", _U, _I, _K, _WD, batch_size=50,
            data_sets={"train": RatingDataset(x, y)},
            initial_learning_rate=1e-2, damping=_DAMP,
            train_dir=tempfile.mkdtemp(prefix="fia-chaos-stream-init-"),
            model_name="chaos-stream", solver="direct", seed=0,
            device=device,
        )
        # virtual time everywhere: retry backoff and staleness timers
        # must never sleep wall-clock in a chaos run
        self.fm._trainer.clock = rpolicy.VirtualClock()
        self.fm.train(self.BASE_STEPS, save_checkpoints=False,
                      verbose=False)
        self.base_state = self.fm.state
        self.base_train = self.fm.data_sets["train"]
        # both update batches live strictly inside community A; update 2
        # touches user 2 so the FENCE probe distinguishes mid from post
        self.upd1 = (np.array([[2, 3], [5, 1], [11, 8]], np.int32),
                     np.array([5.0, 4.0, 3.0], np.float32))
        self.upd2 = (np.array([[2, 5], [7, 2], [13, 6]], np.int32),
                     np.array([2.0, 5.0, 4.0], np.float32))

        # fault-free per-state references, each probe served alone (T=1)
        # so bytes are independent of batch composition
        self.ref_old = self._snapshot_refs()
        assert self.fm.apply_updates(*self.upd1, steps=self.STEPS,
                                     checkpoint_every=self.EVERY).committed
        self.ref_mid = self._snapshot_refs()
        assert self.fm.apply_updates(*self.upd2, steps=self.STEPS,
                                     checkpoint_every=self.EVERY).committed
        self.ref_new = self._snapshot_refs()
        self._reset()
        for p in self.UNTOUCHED:
            # the projection guarantee surgical invalidation rests on
            assert self.ref_old[p] == self.ref_mid[p] == self.ref_new[p], (
                f"untouched probe {p} moved across a footprinted update")
        assert self.ref_old[self.FENCE] != self.ref_mid[self.FENCE]
        assert self.ref_mid[self.FENCE] != self.ref_new[self.FENCE]

    def _reset(self):
        self.fm.state = self.base_state
        self.fm.data_sets["train"] = self.base_train
        self.fm._engines.clear()

    def _service(self):
        from fia_tpu_torch.serve.service import InfluenceService, ServeConfig

        return InfluenceService.from_model(
            self.fm, config=ServeConfig(), clock=rpolicy.VirtualClock())

    def _one(self, svc, pair, rid):
        from fia_tpu_torch.serve.request import Request

        return svc.run([Request(pair[0], pair[1], id=rid)],
                       drain_every=1)[0]

    def _snapshot_refs(self) -> dict:
        svc = self._service()
        return {
            p: _host(self._one(svc, p, f"ref{k}").scores).tobytes()
            for k, p in enumerate(self.TOUCHED + self.UNTOUCHED)
        }

    def _wave(self, svc, wave: str, refs: dict, out: dict,
              events: list) -> None:
        for k, p in enumerate(self.TOUCHED + self.UNTOUCHED):
            r = self._one(svc, p, f"{wave}{k}")
            match = bool(r.ok) and (
                _host(r.scores).tobytes() == refs[p])
            events.append({"event": "probe_served", "wave": wave,
                           "probe": k, "match": match})
            if r.ok:
                out[f"{wave}{k}:scores"] = _host(r.scores)

    def _apply(self, svc, upd, events: list, tag: int,
               probe_on_rollback: bool):
        """One update under the chaos retry budget; a rolled-back
        attempt leaves its checkpoints behind, so the retry resumes."""
        for attempt in range(_CHAOS_RETRY.max_attempts):
            r = self.fm.apply_updates(*upd, steps=self.STEPS,
                                      checkpoint_every=self.EVERY)
            if r.committed:
                if attempt:
                    events.append({"event": "update_retried",
                                   "update": tag,
                                   "attempts": attempt + 1})
                return r
            events.append({"event": "update_rolled_back", "update": tag,
                           "reason": r.reason,
                           "resumed_step": r.resumed_step})
            if probe_on_rollback:
                # rollback must keep answering — on the OLD state
                pr = self._one(svc, self.FENCE, f"rb{tag}-{attempt}")
                events.append({
                    "event": "post_rollback_serve", "update": tag,
                    "ok": bool(pr.ok) and (
                        _host(pr.scores).tobytes()
                        == self.ref_old[self.FENCE]),
                })
        raise taxonomy.DeadlineExpired(
            f"update {tag} never committed within the retry budget")

    def run(self, workdir: str, events: list) -> dict:
        from fia_tpu_torch.serve.request import Request

        self._reset()
        self.fm.train_dir = os.path.join(workdir, "train")
        svc = self._service()
        out: dict = {}

        self._wave(svc, "pre", self.ref_old, out, events)
        r1 = self._apply(svc, self.upd1, events, 1,
                         probe_on_rollback=True)
        self._wave(svc, "mid", self.ref_mid, out, events)

        # epoch fence: admitted before update 2, drained after — must
        # answer on its admission state whatever the update does
        assert svc.submit(Request(*self.FENCE, id="fence")) is None
        r2 = self._apply(svc, self.upd2, events, 2,
                         probe_on_rollback=False)
        fr = next(r for r in svc.drain() if r.id == "fence")
        events.append({"event": "probe_served", "wave": "fence",
                       "probe": 0,
                       "match": bool(fr.ok) and (
                           _host(fr.scores).tobytes()
                           == self.ref_mid[self.FENCE])})
        if fr.ok:
            out["fence:scores"] = _host(fr.scores)
        self._wave(svc, "post", self.ref_new, out, events)

        st = svc.cache.stats
        events.append({"event": "swap_stats",
                       "rekeyed": int(st.rekeyed),
                       "rekey_dropped": int(st.rekey_dropped),
                       "disk_rekeyed": int(st.disk_rekeyed),
                       "disk_rekey_dropped": int(st.disk_rekey_dropped)})
        out["update1"] = r1.status
        out["update2"] = r2.status
        out["epochs"] = int(svc.epoch)
        return out

    def check(self, golden: dict, record) -> list:
        from fia_tpu_torch.chaos.oracles import OracleFailure

        if record.error is not None or record.outcome is None:
            return []
        failures = []
        for e in record.events:
            if e.get("event") == "probe_served" and not e["match"]:
                failures.append(OracleFailure(
                    "epoch_serving_integrity",
                    f"wave {e['wave']} probe {e['probe']}: served bytes "
                    "do not match the reference of the state the request "
                    "was admitted under (stale or half-swapped answer)",
                ))
            elif e.get("event") == "post_rollback_serve" and not e["ok"]:
                failures.append(OracleFailure(
                    "rollback_keeps_serving",
                    f"after a rolled-back update {e['update']}, serving "
                    "did not answer bit-identically on the old state",
                ))
        stats = next((e for e in record.events
                      if e.get("event") == "swap_stats"), None)
        if stats is not None and (
                stats["rekeyed"] + stats["disk_rekeyed"]) == 0:
            failures.append(OracleFailure(
                "surgical_invalidation",
                "no cache entry survived the swaps by re-keying — the "
                "untouched community-B blocks must ride through a "
                "footprinted update without recompute",
            ))
        return failures


class UnlearnWhileServingScenario(Scenario):
    """An audited unlearning plan (``audit.plan.apply_plan``) flowing
    through the live epoch-fenced loop under serve traffic, mid-apply
    kills, and swap faults — docs/design.md §23.

    Structurally the unlearning twin of ``update_while_serving``: same
    two-community train set, but the deltas are REMOVALS chosen by a
    real reverse sweep (``audit.reverse.reverse_topk`` over community-A
    test points → ``build_plan``), not hand-picked appends. Apply 1 is
    a ``remove`` plan, apply 2 a ``reweight`` plan built against the
    shrunk post-removal set — exercising the stale-plan row-count gate
    on the retry path too (a rollback must restore the train set or the
    retry is refused as stale). Sweeping A-community test points keeps
    every plan row inside A by construction (a B row shares no user or
    item with an A test pair, so its sweep score is exactly zero and
    the ``only_negative`` filter drops it); construction asserts this,
    so community-B probes are provably outside both footprints' READ
    reach (stream/footprint.py). Oracles as in the update twin:

    - every probe byte-matches the reference of its admission state;
    - community-B probes are bit-identical in every wave;
    - a rolled-back apply keeps serving the old state; the retry
      (resuming the attempt's checkpoints) commits the golden bytes;
    - committed swaps re-key untouched entries, never wholesale-flush;
    - plan identity is deterministic: plan ids and predicted deltas
      must replay exactly against the golden run (``plan_determinism``).
    """

    name = "unlearn_while_serving"
    BASE_STEPS, STEPS, EVERY = 24, 16, 4
    # sweep provenance: test points inside community A (users 0-14 x
    # items 0-9); B probes below are untouched by construction
    TESTPTS = ((2, 3), (5, 1), (11, 8), (7, 2), (13, 6), (4, 4))
    TOUCHED = ((2, 3), (5, 1), (11, 8))
    UNTOUCHED = ((16, 12), (22, 17), (28, 11))
    FENCE = (2, 3)
    PLAN_ROWS = 3
    # each apply fires audit.apply once and stream.swap once on a
    # fault-free attempt: 2 guaranteed calls per site across the two
    # plans; the retry budget absorbs a worst-case 3-fault schedule
    benign_domain = {
        sites.AUDIT_APPLY: (_TRANSIENT_KINDS, 2),
        sites.STREAM_SWAP: (_TRANSIENT_KINDS, 2),
    }
    full_domain = {
        sites.AUDIT_APPLY: (_TRANSIENT_KINDS + _KILL_KINDS, 2),
        sites.STREAM_SWAP: (_TRANSIENT_KINDS + _KILL_KINDS, 2),
        sites.CHAOS_SCENARIO: ((taxonomy.WORKER,), 1),
    }

    def __init__(self, device=None):
        import tempfile

        from fia_tpu_torch.api import FIAModel
        from fia_tpu_torch.audit.plan import build_plan
        from fia_tpu_torch.audit.reverse import reverse_topk
        from fia_tpu_torch.data.dataset import RatingDataset

        super().__init__(device)
        x, y = UpdateWhileServingScenario._community_data(1, 240)
        self.fm = FIAModel(
            "MF", _U, _I, _K, _WD, batch_size=50,
            data_sets={"train": RatingDataset(x, y)},
            initial_learning_rate=1e-2, damping=_DAMP,
            train_dir=tempfile.mkdtemp(prefix="fia-chaos-unlearn-init-"),
            model_name="chaos-unlearn", solver="direct", seed=0,
            device=device,
        )
        self.fm._trainer.clock = rpolicy.VirtualClock()
        self.fm.train(self.BASE_STEPS, save_checkpoints=False,
                      verbose=False)
        self.base_state = self.fm.state
        self.base_train = self.fm.data_sets["train"]

        pts = np.asarray(self.TESTPTS, np.int64)
        ty = np.asarray(self.base_train.y[:len(pts)], np.float32)

        def _plan(action):
            sweep = reverse_topk(self.fm, pts, ty, k=16)
            return build_plan(self.fm, sweep, action=action,
                              max_rows=self.PLAN_ROWS)

        # fault-free golden pass: plans + per-state references, each
        # probe served alone (T=1) so bytes are batch-independent
        self.ref_old = self._snapshot_refs()
        self.plan1 = _plan("remove")
        rx = np.asarray(self.base_train.x, np.int64)[self.plan1.row_ids]
        assert bool(np.all(rx[:, 0] < 15) and np.all(rx[:, 1] < 10)), (
            "sweep surfaced a community-B row for A-only test points")
        assert self._apply_plan(self.plan1).committed
        self.ref_mid = self._snapshot_refs()
        # the reweight plan is built against the SHRUNK train set — its
        # row-count stamp is what the stale-plan gate checks on retry
        self.plan2 = _plan("reweight")
        assert self._apply_plan(self.plan2).committed
        self.ref_new = self._snapshot_refs()
        self._reset()
        for p in self.UNTOUCHED:
            # both footprints' READ reach stops at the community border
            assert self.ref_old[p] == self.ref_mid[p] == self.ref_new[p], (
                f"untouched probe {p} moved across an unlearning apply")
        assert self.ref_old[self.FENCE] != self.ref_mid[self.FENCE]
        assert self.ref_mid[self.FENCE] != self.ref_new[self.FENCE]

    def _apply_plan(self, plan):
        from fia_tpu_torch.audit.plan import apply_plan

        return apply_plan(self.fm, plan, steps=self.STEPS,
                          checkpoint_every=self.EVERY)

    def _reset(self):
        self.fm.state = self.base_state
        self.fm.data_sets["train"] = self.base_train
        self.fm._engines.clear()

    def _service(self):
        from fia_tpu_torch.serve.service import InfluenceService, ServeConfig

        return InfluenceService.from_model(
            self.fm, config=ServeConfig(), clock=rpolicy.VirtualClock())

    def _one(self, svc, pair, rid):
        from fia_tpu_torch.serve.request import Request

        return svc.run([Request(pair[0], pair[1], id=rid)],
                       drain_every=1)[0]

    def _snapshot_refs(self) -> dict:
        svc = self._service()
        return {
            p: _host(self._one(svc, p, f"ref{k}").scores).tobytes()
            for k, p in enumerate(self.TOUCHED + self.UNTOUCHED)
        }

    def _wave(self, svc, wave: str, refs: dict, out: dict,
              events: list) -> None:
        for k, p in enumerate(self.TOUCHED + self.UNTOUCHED):
            r = self._one(svc, p, f"{wave}{k}")
            match = bool(r.ok) and (
                _host(r.scores).tobytes() == refs[p])
            events.append({"event": "probe_served", "wave": wave,
                           "probe": k, "match": match})
            if r.ok:
                out[f"{wave}{k}:scores"] = _host(r.scores)

    def _apply(self, svc, plan, events: list, tag: int,
               probe_on_rollback: bool):
        """One plan apply under the chaos retry budget; a rolled-back
        attempt restores the pre-apply train set (else the retry would
        be refused as a stale plan) and leaves its checkpoints behind,
        so the retry resumes rather than restarts."""
        for attempt in range(_CHAOS_RETRY.max_attempts):
            r = self._apply_plan(plan)
            if r.committed:
                if attempt:
                    events.append({"event": "apply_retried",
                                   "plan": plan.plan_id,
                                   "attempts": attempt + 1})
                return r
            events.append({"event": "apply_rolled_back", "apply": tag,
                           "plan": plan.plan_id, "reason": r.reason,
                           "resumed_step": r.resumed_step})
            if probe_on_rollback:
                pr = self._one(svc, self.FENCE, f"rb{tag}-{attempt}")
                events.append({
                    "event": "post_rollback_serve", "update": tag,
                    "ok": bool(pr.ok) and (
                        _host(pr.scores).tobytes()
                        == self.ref_old[self.FENCE]),
                })
        raise taxonomy.DeadlineExpired(
            f"plan {plan.plan_id} never committed within the retry budget")

    def run(self, workdir: str, events: list) -> dict:
        from fia_tpu_torch.serve.request import Request

        self._reset()
        self.fm.train_dir = os.path.join(workdir, "train")
        svc = self._service()
        out: dict = {}

        self._wave(svc, "pre", self.ref_old, out, events)
        r1 = self._apply(svc, self.plan1, events, 1,
                         probe_on_rollback=True)
        self._wave(svc, "mid", self.ref_mid, out, events)

        # epoch fence: admitted before the reweight apply, drained
        # after — must answer on its admission state (post-removal)
        assert svc.submit(Request(*self.FENCE, id="fence")) is None
        r2 = self._apply(svc, self.plan2, events, 2,
                         probe_on_rollback=False)
        fr = next(r for r in svc.drain() if r.id == "fence")
        events.append({"event": "probe_served", "wave": "fence",
                       "probe": 0,
                       "match": bool(fr.ok) and (
                           _host(fr.scores).tobytes()
                           == self.ref_mid[self.FENCE])})
        if fr.ok:
            out["fence:scores"] = _host(fr.scores)
        self._wave(svc, "post", self.ref_new, out, events)

        st = svc.cache.stats
        events.append({"event": "swap_stats",
                       "rekeyed": int(st.rekeyed),
                       "rekey_dropped": int(st.rekey_dropped),
                       "disk_rekeyed": int(st.disk_rekeyed),
                       "disk_rekey_dropped": int(st.disk_rekey_dropped)})
        out["apply1"] = r1.status
        out["apply2"] = r2.status
        out["plan1"] = self.plan1.plan_id
        out["plan2"] = self.plan2.plan_id
        out["predicted_delta1"] = round(self.plan1.predicted_delta, 6)
        out["predicted_delta2"] = round(self.plan2.predicted_delta, 6)
        out["train_rows"] = len(self.fm.data_sets["train"].x)
        out["epochs"] = int(svc.epoch)
        return out

    def check(self, golden: dict, record) -> list:
        from fia_tpu_torch.chaos.oracles import OracleFailure

        if record.error is not None or record.outcome is None:
            return []
        failures = []
        for e in record.events:
            if e.get("event") == "probe_served" and not e["match"]:
                failures.append(OracleFailure(
                    "epoch_serving_integrity",
                    f"wave {e['wave']} probe {e['probe']}: served bytes "
                    "do not match the reference of the state the request "
                    "was admitted under (stale or half-swapped answer)",
                ))
            elif e.get("event") == "post_rollback_serve" and not e["ok"]:
                failures.append(OracleFailure(
                    "rollback_keeps_serving",
                    f"after a rolled-back apply {e['update']}, serving "
                    "did not answer bit-identically on the old state",
                ))
        for key in ("plan1", "plan2", "predicted_delta1",
                    "predicted_delta2", "train_rows"):
            if record.outcome.get(key) != golden.get(key):
                failures.append(OracleFailure(
                    "plan_determinism",
                    f"{key} diverged from the golden run: "
                    f"{record.outcome.get(key)!r} != {golden.get(key)!r} "
                    "— plan identity must be a pure function of the "
                    "sweep, not of the fault schedule",
                ))
        stats = next((e for e in record.events
                      if e.get("event") == "swap_stats"), None)
        if stats is not None and (
                stats["rekeyed"] + stats["disk_rekeyed"]) == 0:
            failures.append(OracleFailure(
                "surgical_invalidation",
                "no cache entry survived the swaps by re-keying — the "
                "untouched community-B blocks must ride through a "
                "footprinted unlearning apply without recompute",
            ))
        return failures


class ServeBrownoutScenario(Scenario):
    """Certified-approximate serving through a forced brownout episode
    (docs/design.md §22, docs/reliability.md "Degraded modes").

    Wave A serves four cold misses in ``full`` mode — real dispatches
    plus disk-tier publishes (the damage point; no wave-A key is ever
    re-read, so benign damage is invisible to the outcome). A synthetic
    sick-backend drain signal is then fed to the health controller —
    deterministic, identical in golden and chaos runs — forcing
    ``full → bank_preferred``. Wave B mixes two banked pairs (exact
    O(1) bank hits) with four unbanked misses that must be ANSWERED
    from the certified ``sampled`` rung, ``approx=True`` with a stamped
    error bound, instead of shed ``degraded``.

    The scenario oracle (``certified_approx_integrity``) holds every
    approx answer to its own certificate: |served − direct reference|
    must stay within the stamped bound. A transient fault at
    ``engine.sampled_solve`` escalates the whole sampled micro-batch
    one ladder rung — those answers must then byte-match the
    escalation-rung reference (computed per micro-batch, since the
    fallback re-solves the batch verbatim) and drop the approx stamp.
    Either way, an in-bounds query is never rejected ``degraded``.
    """

    name = "serve_brownout"
    MAX_BATCH = 3
    NWARM, NBANK, NAPPROX = 4, 2, 4
    SAMPLED_CAP = 16  # < typical block count: genuinely subsampled
    # wave-A misses publish 4 disk entries; approx answers never
    # publish, so damage is bounded by the exact-path dispatches
    benign_domain = {
        sites.SERVE_CACHE_PUBLISH: (_DAMAGE_KINDS, 4),
    }
    # 2 guaranteed sampled dispatches (NAPPROX=4 misses, micro-batches
    # of MAX_BATCH=3): the fire seam's call index is the dispatch
    # ordinal, and an escalated batch still lets the next one dispatch
    full_domain = {
        sites.SERVE_CACHE_PUBLISH: (_DAMAGE_KINDS, 4),
        sites.ENGINE_SAMPLED_SOLVE: (_TRANSIENT_KINDS, 2),
        sites.CHAOS_SCENARIO: ((taxonomy.WORKER,), 1),
    }

    def __init__(self, device=None):
        import tempfile

        from fia_tpu_torch.data.dataset import RatingDataset
        from fia_tpu_torch.influence import factor as fbank
        from fia_tpu_torch.influence.engine import InfluenceEngine
        from fia_tpu_torch.models import MF

        super().__init__(device)
        x, y = _toy_data(3, 400)
        self.model = MF(_U, _I, _K, _WD)
        params = init_params(self.model, device)
        train = RatingDataset(x, y)
        self.eng = InfluenceEngine(
            self.model, params, train, damping=_DAMP,
            solver="precomputed", cache_dir=tempfile.mkdtemp(
                prefix="fia-chaos-brownout-init-"),
            model_name="chaos-brownout", lissa_depth=30,
            sampled_cap=self.SAMPLED_CAP, device=device)
        pairs = fbank.select_hot_pairs(
            self.eng.index, max_entries=self.NBANK + 2,
            top_users=4, top_items=4)
        self.bank = fbank.build_bank(self.eng, pairs)
        self.fp = fbank.bank_fingerprint(
            "chaos-brownout", self.model.block_size, _DAMP,
            *self.eng._train_host)
        banked = {(int(u), int(i)) for u, i in pairs}
        self.bank_pairs = sorted(banked)[: self.NBANK]
        fresh: list = []
        for u, i in zip(x[:, 0], x[:, 1]):
            p = (int(u), int(i))
            if p not in banked and p not in fresh:
                fresh.append(p)
        self.warm_pairs = fresh[: self.NWARM]
        self.approx_pairs = fresh[self.NWARM: self.NWARM + self.NAPPROX]

        # fault-free references for the oracle: the exact answer each
        # certificate bounds against, and the escalation-rung bytes a
        # fault-escalated sampled batch must reproduce — per service
        # micro-batch, because escalation re-solves the batch verbatim
        direct = InfluenceEngine(
            self.model, params, train, damping=_DAMP, solver="direct",
            model_name="chaos-brownout", device=device)
        ladder = InfluenceEngine(
            self.model, params, train, damping=_DAMP,
            solver=rpolicy.next_solver("sampled") or "direct",
            model_name="chaos-brownout", lissa_depth=30, device=device)
        self.ref_direct: dict = {}
        self.ref_ladder: dict = {}
        for lo in range(0, self.NAPPROX, self.MAX_BATCH):
            chunk = self.approx_pairs[lo: lo + self.MAX_BATCH]
            pts = np.asarray(chunk, np.int64)
            res_d = direct.query_batch(pts)
            res_l = ladder.query_batch(pts)
            for t, p in enumerate(chunk):
                self.ref_direct[p] = _host(res_d.scores_of(t))
                self.ref_ladder[p] = _host(res_l.scores_of(t)).tobytes()

    def run(self, workdir: str, events: list) -> dict:
        from fia_tpu_torch.influence import factor as fbank
        from fia_tpu_torch.serve.health import MODE_BANK_PREFERRED, HealthConfig
        from fia_tpu_torch.serve.request import Request
        from fia_tpu_torch.serve.service import InfluenceService, ServeConfig

        eng = self.eng
        eng.cache_dir = os.path.join(workdir, "cache")
        eng.unload_factor_bank()
        eng.solver = "precomputed"  # undo any sticky prior escalation
        path = fbank.default_bank_path(eng.cache_dir, eng.model_name)
        fbank.publish_bank(self.bank, path, self.fp)
        if eng.ensure_factor_bank() == 0:
            raise RuntimeError("serve_brownout: factor bank not loaded")
        svc = InfluenceService(
            engine=eng,
            config=ServeConfig(
                max_batch=self.MAX_BATCH,
                health=HealthConfig(
                    window=4, err_degrade=0.5, err_cache_only=2.0,
                    err_recover=0.25, min_evidence=2, queue_hold=3,
                    hold=8),
            ),
            clock=rpolicy.VirtualClock(),
        )
        # wave A: cold misses in full mode (dispatches + publishes)
        for j, p in enumerate(self.warm_pairs):
            svc.submit(Request(*p, id=f"w{j}"))
        res_a = svc.drain()
        # the forced episode: one synthetic sick-backend drain signal —
        # min_evidence=2 is met and the windowed error rate crosses
        # err_degrade, so the ladder steps to bank_preferred; hold=8
        # keeps it there for the remainder of the run
        svc.health.observe(errors=8, dispatches=8, queue_depth=0,
                           queue_cap=svc.admission.max_queue)
        if svc.health.mode != MODE_BANK_PREFERRED:
            raise RuntimeError(
                f"forced brownout did not engage ({svc.health.mode})")
        events.append({"event": "brownout_forced",
                       "mode": svc.health.mode})
        # wave B: bank hits + unbanked misses under bank_preferred
        for j, p in enumerate(self.bank_pairs):
            svc.submit(Request(*p, id=f"b{j}"))
        for j, p in enumerate(self.approx_pairs):
            svc.submit(Request(*p, id=f"a{j}"))
        res_b = svc.drain()

        out: dict = {"mode": svc.health.mode}
        for r in res_a + res_b:
            out[f"{r.id}:status"] = f"{r.status}/{r.reason or ''}"
            out[f"{r.id}:approx"] = int(bool(r.approx))
            out[f"{r.id}:err"] = (float(r.err_bound)
                                  if r.err_bound is not None else -1.0)
            if r.ok:
                out[f"{r.id}:scores"] = _host(r.scores)
        roll = svc.rollup()
        out["answered_approx"] = int(roll["answered_approx"])
        out["rejected_degraded"] = int(
            roll["rejected"].get("degraded", 0))
        events.append({"event": "serve_rollup",
                       "answered_approx": int(roll["answered_approx"]),
                       "modes": roll["modes"]})
        return out

    def check(self, golden: dict, record) -> list:
        from fia_tpu_torch.chaos.oracles import OracleFailure

        if record.error is not None or record.outcome is None:
            return []
        got = record.outcome
        failures = []
        for j, p in enumerate(self.approx_pairs):
            rid = f"a{j}"
            status = str(got.get(f"{rid}:status", "<missing>"))
            if status != "ok/":
                failures.append(OracleFailure(
                    "certified_approx_integrity",
                    f"{rid}: in-bounds brownout miss not answered "
                    f"(got {status}) — certified approx serving must "
                    "replace the degraded shed",
                ))
                continue
            scores = np.asarray(got[f"{rid}:scores"])
            if got.get(f"{rid}:approx"):
                eb = float(got.get(f"{rid}:err", -1.0))
                ref = self.ref_direct[p]
                diff = (float(np.max(np.abs(scores - ref)))
                        if scores.size else 0.0)
                if eb < 0.0:
                    failures.append(OracleFailure(
                        "certified_approx_integrity",
                        f"{rid}: approx answer with no stamped "
                        "err_bound",
                    ))
                elif diff > eb + 1e-6:
                    failures.append(OracleFailure(
                        "certified_approx_integrity",
                        f"{rid}: served score error {diff:.3e} exceeds "
                        f"the stamped certificate {eb:.3e}",
                    ))
            elif scores.tobytes() != self.ref_ladder[p]:
                # a sampled-solve fault escalates the whole micro-batch
                # one rung; an un-stamped answer matching neither
                # reference is the silent-wrong-answer class
                failures.append(OracleFailure(
                    "certified_approx_integrity",
                    f"{rid}: un-stamped answer does not byte-match the "
                    "escalation-rung reference (silent wrong answer)",
                ))
        degraded = int(got.get("rejected_degraded", 0))
        if degraded:
            failures.append(OracleFailure(
                "certified_approx_integrity",
                f"{degraded} request(s) shed 'degraded' while the "
                "sampled rung was allowed to answer them",
            ))
        return failures


class ServeMultitenantScenario(Scenario):
    """Multi-tenant overload survival: quotas, fair queueing, and the
    class-aware brownout under a 2× scavenger flood
    (docs/reliability.md "Multi-tenant serving & fairness").

    Three phases over one service on a deterministic tick clock:

    - **U (unloaded)**: an interactive-only wave establishes the
      unloaded interactive latency baseline.
    - **O (overload)**: a scavenger flood at 2× its queue quota (the
      excess must shed class-tagged ``overload`` without consuming
      interactive headroom — every interactive/batch submit after the
      flood still admits), mixed with interactive + batch traffic. A
      *scripted* ``serve.dispatch`` fault — identical in golden and
      chaos runs — kills exactly the first scavenger batch: because
      batches are class-pure, the shed hits only scavenger waiters.
    - **B (brownout)**: a synthetic sick-backend signal (min_evidence
      is set far above what organic traffic can accumulate, so
      injected faults can never move the ladder — the transition log's
      mode path is fault-invariant) forces ``bank_preferred``.
      Interactive misses must still be answered EXACT (the class-aware
      ladder leaves interactive at full until severity 2) while
      scavenger misses come back certified-approximate.

    Scenario oracles: **starvation_bound** (every admitted request
    resolves within STARVATION_BOUND_S of virtual queue wait, even
    while lower-priority work dispatches), **class_isolation**
    (interactive p99 under the flood within ISOLATION_FACTOR of its
    unloaded p99), **class_batch_purity** (every dispatched batch id —
    served or shed — carries exactly one class), admission/quota
    determinism, classified rejections, and the brownout ladder's
    (from, to, tick) path vs golden. Benign schedules additionally get
    whole-outcome bit identity from the standard battery.
    """

    name = "serve_multitenant"
    MAX_BATCH, MAX_QUEUE = 3, 12
    N_UNLOADED = 4          # phase-U interactive wave
    N_FLOOD = 13            # scavenger submits (quota cap is 6 → 2×+)
    N_OVER_I, N_OVER_B = 4, 2  # interactive/batch riding the flood
    N_BROWN = 3             # per-class phase-B misses
    FAULT_ORDINAL = 3       # phase-O dispatch #3 = first scavenger batch
    STARVATION_BOUND_S = 1.0   # virtual seconds (ticks of 1e-3)
    ISOLATION_FACTOR = 3.0
    # exact-path publishes on a shed-free run: 4 (U) + 9 (O, the shed
    # scavenger batch never publishes) + 3 (B) = 16; approx answers
    # never publish. Damage is invisible to the outcome (no key is
    # ever re-read), so the benign domain stays bit-identical.
    benign_domain = {
        sites.SERVE_CACHE_PUBLISH: (_DAMAGE_KINDS, 12),
    }
    # every planned batch fires serve.dispatch before its device call
    # (9 fires on the undisturbed run: 2 U + 5 O + 2 B); injected
    # faults shed exactly the class-pure batch they land on
    full_domain = {
        sites.SERVE_DISPATCH: (
            (taxonomy.WORKER, taxonomy.OOM, taxonomy.DEADLINE), 6),
        sites.SERVE_CACHE_PUBLISH: (_DAMAGE_KINDS, 4),
        sites.CHAOS_SCENARIO: ((taxonomy.WORKER,), 1),
    }

    def __init__(self, device=None):
        from fia_tpu_torch.data.dataset import RatingDataset
        from fia_tpu_torch.influence.engine import InfluenceEngine
        from fia_tpu_torch.models import MF

        super().__init__(device)
        x, y = _toy_data(7, 400)
        self.model = MF(_U, _I, _K, _WD)
        self.params = init_params(self.model, device)
        self.train_ds = RatingDataset(x, y)
        self.engine = InfluenceEngine(
            self.model, self.params, self.train_ds, damping=_DAMP,
            model_name="chaos-multitenant", device=device)
        rng = np.random.default_rng(11)
        flat = rng.choice(_U * _I, size=32, replace=False)
        keys = [(int(k // _I), int(k % _I)) for k in flat]
        it = iter(keys)

        def take(n):
            return [next(it) for _ in range(n)]

        self.unloaded_keys = take(self.N_UNLOADED)
        self.flood_keys = take(self.N_FLOOD)
        self.over_i_keys = take(self.N_OVER_I)
        self.over_b_keys = take(self.N_OVER_B)
        self.brown_i_keys = take(self.N_BROWN)
        self.brown_s_keys = take(self.N_BROWN)

    class _TickClock:
        """Deterministic monotonic stand-in: every read advances one
        fixed tick, so queue waits measure dispatch ORDER (the thing
        fair queueing controls), identically across replays."""

        def __init__(self):
            self.t = 0.0

        def __call__(self):
            self.t += 1e-3
            return self.t

    def run(self, workdir: str, events: list) -> dict:
        import json

        from fia_tpu_torch.serve.health import MODE_BANK_PREFERRED, HealthConfig
        from fia_tpu_torch.serve.request import Request
        from fia_tpu_torch.serve.service import InfluenceService, ServeConfig

        eng = self.engine
        eng.cache_dir = os.path.join(workdir, "cache")
        svc = InfluenceService(
            engine=eng,
            config=ServeConfig(
                max_batch=self.MAX_BATCH, max_queue=self.MAX_QUEUE,
                dispatch_window=1,  # scripted fault needs query_batch
                class_quotas={"scavenger": 0.5},
                health=HealthConfig(
                    window=4, err_degrade=0.5, err_cache_only=2.0,
                    err_recover=0.25, min_evidence=50, queue_hold=3,
                    hold=8),
            ),
            clock=self._TickClock(),
        )
        responses = []

        # phase U: unloaded interactive baseline
        for j, p in enumerate(self.unloaded_keys):
            svc.submit(Request(*p, id=f"u{j}", cls="interactive",
                               tenant="t-int"))
        responses += svc.drain()

        # phase O: 2× scavenger flood + interactive/batch riders. The
        # flood goes FIRST: its quota rejections prove it cannot eat
        # the headroom the later interactive/batch submits then use.
        for j, p in enumerate(self.flood_keys):
            r = svc.submit(Request(*p, id=f"s{j}", cls="scavenger",
                                   tenant="t-scav"))
            if r is not None:
                responses.append(r)
        for j, p in enumerate(self.over_i_keys):
            svc.submit(Request(*p, id=f"i{j}", cls="interactive",
                               tenant="t-int"))
        for j, p in enumerate(self.over_b_keys):
            svc.submit(Request(*p, id=f"m{j}", cls="batch",
                               tenant="t-bulk"))
        # scripted serve.dispatch fault, part of the workload itself
        # (identical in golden and chaos runs): the FAULT_ORDINAL-th
        # exact dispatch of this drain is the first scavenger batch —
        # interactive/batch dispatch ahead of it under DRR priority
        orig_qb = eng.query_batch
        calls = {"n": 0}

        def scripted(pts):
            n = calls["n"]
            calls["n"] += 1
            if n == self.FAULT_ORDINAL:
                raise taxonomy.DeadlineExpired(
                    "scripted chaos fault: scavenger batch dispatch")
            return orig_qb(pts)

        eng.query_batch = scripted
        try:
            responses += svc.drain()
        finally:
            eng.query_batch = orig_qb

        # phase B: forced brownout (deterministic synthetic signal; 60
        # dispatches of evidence meets min_evidence=50 on its own —
        # organic drains never can)
        svc.health.observe(errors=60, dispatches=60, queue_depth=0,
                           queue_cap=svc.admission.max_queue)
        if svc.health.mode != MODE_BANK_PREFERRED:
            raise RuntimeError(
                f"forced brownout did not engage ({svc.health.mode})")
        events.append({"event": "brownout_forced",
                       "mode": svc.health.mode})
        for j, p in enumerate(self.brown_i_keys):
            svc.submit(Request(*p, id=f"bi{j}", cls="interactive",
                               tenant="t-int"))
        for j, p in enumerate(self.brown_s_keys):
            svc.submit(Request(*p, id=f"bs{j}", cls="scavenger",
                               tenant="t-scav"))
        responses += svc.drain()

        out: dict = {"mode": svc.health.mode}
        for r in responses:
            out[f"{r.id}:status"] = f"{r.status}/{r.reason or ''}"
            out[f"{r.id}:class"] = r.cls
            out[f"{r.id}:wait"] = float(r.queue_wait_s)
            out[f"{r.id}:batch"] = (-1 if r.batch_id is None
                                    else int(r.batch_id))
            out[f"{r.id}:approx"] = int(bool(r.approx))
            if r.ok:
                out[f"{r.id}:scores"] = _host(r.scores)
        # the ladder's mode path must replay identically even under
        # injected dispatch faults (signal VALUES may differ there;
        # benign bit-identity covers the full log)
        out["transitions"] = json.dumps(
            [(t["from"], t["to"], t["tick"])
             for t in svc.health.transitions])
        roll = svc.rollup()
        out["answered_approx"] = int(roll["answered_approx"])
        events.append({"event": "serve_rollup",
                       "classes": roll["classes"],
                       "rejected": roll["rejected"]})
        return out

    def _ids(self):
        return (
            [f"u{j}" for j in range(self.N_UNLOADED)]
            + [f"s{j}" for j in range(self.N_FLOOD)]
            + [f"i{j}" for j in range(self.N_OVER_I)]
            + [f"m{j}" for j in range(self.N_OVER_B)]
            + [f"bi{j}" for j in range(self.N_BROWN)]
            + [f"bs{j}" for j in range(self.N_BROWN)]
        )

    def check(self, golden: dict, record) -> list:
        from fia_tpu_torch.chaos.oracles import OracleFailure
        from fia_tpu_torch.serve import admission

        if record.error is not None or record.outcome is None:
            return []
        got = record.outcome
        failures = []
        allowed = {
            taxonomy.OOM, taxonomy.HOST_OOM, taxonomy.AMBIGUOUS,
            taxonomy.WORKER, taxonomy.PREEMPTION, taxonomy.NAN,
            taxonomy.DEADLINE, taxonomy.DEVICE_LOST, taxonomy.HOST_LOST,
            admission.REASON_OVERLOAD, admission.REASON_INVALID,
            admission.REASON_DEGRADED,
        }
        admission_reasons = ("/" + admission.REASON_OVERLOAD,
                            "/" + admission.REASON_INVALID)
        waits_unloaded, waits_overload = [], []
        by_batch: dict[int, set] = {}
        for rid in self._ids():
            status = str(got.get(f"{rid}:status", "<missing>"))
            if status == "<missing>":
                failures.append(OracleFailure(
                    "starvation_bound",
                    f"{rid}: admitted request never resolved",
                ))
                continue
            gs = str(golden.get(f"{rid}:status", "<missing>"))
            # admission decisions are a pure function of the submit
            # stream + quotas — faults cannot move them
            for adm in admission_reasons:
                if gs.endswith(adm) != status.endswith(adm):
                    failures.append(OracleFailure(
                        "admission_determinism",
                        f"{rid}: golden {gs} vs chaos {status}",
                    ))
            if status.startswith("rejected/"):
                reason = status.split("/", 1)[1]
                if reason not in allowed:
                    failures.append(OracleFailure(
                        "classified_rejection",
                        f"{rid}: unclassified rejection {reason!r}",
                    ))
                if reason in (admission.REASON_OVERLOAD,
                              admission.REASON_INVALID):
                    continue  # refused at the door: no wait to bound
            # admitted (served, or admitted-then-shed): bounded wait
            wait = float(got.get(f"{rid}:wait", 0.0))
            if wait > self.STARVATION_BOUND_S:
                failures.append(OracleFailure(
                    "starvation_bound",
                    f"{rid}: queue wait {wait:.3f}s exceeds the "
                    f"{self.STARVATION_BOUND_S}s starvation bound",
                ))
            if rid.startswith("u"):
                waits_unloaded.append(wait)
            elif rid.startswith("i"):
                waits_overload.append(wait)
            bid = int(got.get(f"{rid}:batch", -1))
            if bid >= 0:
                by_batch.setdefault(bid, set()).add(
                    str(got.get(f"{rid}:class")))
        for bid, classes in sorted(by_batch.items()):
            if len(classes) != 1:
                failures.append(OracleFailure(
                    "class_batch_purity",
                    f"batch {bid} mixes classes {sorted(classes)} — "
                    "a fault there cannot shed a single class",
                ))
        if waits_unloaded and waits_overload:
            p99_u = float(np.percentile(waits_unloaded, 99))
            p99_o = float(np.percentile(waits_overload, 99))
            if p99_o > self.ISOLATION_FACTOR * max(p99_u, 1e-9):
                failures.append(OracleFailure(
                    "class_isolation",
                    f"interactive p99 under 2× scavenger overload "
                    f"({p99_o:.4f}s) exceeds {self.ISOLATION_FACTOR}× "
                    f"its unloaded p99 ({p99_u:.4f}s)",
                ))
        if str(got.get("transitions")) != str(golden.get("transitions")):
            failures.append(OracleFailure(
                "brownout_replay",
                f"ladder mode path diverged: golden "
                f"{golden.get('transitions')} vs chaos "
                f"{got.get('transitions')}",
            ))
        # the class-aware ladder: phase-B interactive misses answer
        # EXACT; scavenger misses answer certified-approximate (an
        # injected dispatch fault may shed them classified instead —
        # but an answered one must carry the right stamp)
        for j in range(self.N_BROWN):
            bi = f"bi{j}"
            if (str(got.get(f"{bi}:status")) == "ok/"
                    and int(got.get(f"{bi}:approx", 0))):
                failures.append(OracleFailure(
                    "class_aware_brownout",
                    f"{bi}: interactive answered approximate at "
                    "severity 1 — interactive degrades only at "
                    "severity 2",
                ))
            bs = f"bs{j}"
            if (str(got.get(f"{bs}:status")) == "ok/"
                    and not int(got.get(f"{bs}:approx", 0))):
                failures.append(OracleFailure(
                    "class_aware_brownout",
                    f"{bs}: scavenger brownout miss answered exact — "
                    "the sampled rung must absorb scavenger work "
                    "first",
                ))
        return failures


def make_scenarios() -> dict:
    """Fresh scenario registry (instances are lazily constructed, so the
    selftest path never builds a model or touches a device)."""
    return {
        SelftestScenario.name: SelftestScenario,
        SelftestBrokenScenario.name: SelftestBrokenScenario,
        TrainResumeScenario.name: TrainResumeScenario,
        QueryCacheScenario.name: QueryCacheScenario,
        ServeStreamScenario.name: ServeStreamScenario,
        ServeStreamMeshScenario.name: ServeStreamMeshScenario,
        DeviceLossRecoveryScenario.name: DeviceLossRecoveryScenario,
        HostLossRecoveryScenario.name: HostLossRecoveryScenario,
        FactorBankScenario.name: FactorBankScenario,
        UpdateWhileServingScenario.name: UpdateWhileServingScenario,
        UnlearnWhileServingScenario.name: UnlearnWhileServingScenario,
        ServeBrownoutScenario.name: ServeBrownoutScenario,
        ServeMultitenantScenario.name: ServeMultitenantScenario,
    }


SCENARIO_NAMES = tuple(make_scenarios())

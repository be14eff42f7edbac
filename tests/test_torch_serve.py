"""The port's serving layer (``fia_tpu_torch/serve``) on the CPU.

Port against port: the 36 tests of ``tests/test_serve.py`` restated on
``fia_tpu_torch.serve`` (byte identity with ``query_many`` over the
scheduler's order, admission and deadlines, the disk tier, invalidation,
the index memos and program reuse, solver resolution, the in-process smoke
stream, the planner pins, multi-tenant serving). Where the reference
counts its jit cache (``eng._jitted``), the port counts its build records:
``engine.compiled_geometries()`` and ``utils.compilemon`` builds. The
port's padded program is eager (it builds nothing to count), so the
same-bucket test also holds a flat geometry to one build.

Port against the JAX package: the same seeded stream (``_setup``'s
U = 30, I = 20, K = 4, damping 1e-3, the reference's params carried over
with ``params_from_numpy``) through both services under a
``VirtualClock``: the same ok / reason / tier / batch id per request,
the same ``dispatch_log``, the same rollup, related ids equal, scores
within rtol 1e-4 / atol 1e-6 (``test_torch_engine.py``'s bar for this
conditioning). ``MicroBatcher``/``FairScheduler`` plans, admission
decisions and ``HealthController`` transition logs equal the
reference's exactly.

Added, the windowed loop's faults: with ``dispatch_window`` 2 and 3, a
worker death or a preemption at ``serve.dispatch`` sheds exactly that
batch; at the engine's ``engine.dispatch_flat`` site, or when a finalize
fails, the in-flight handles are dropped, the device state rebuilt, and
the survivors re-dispatched (no handle fetched after a reset it
predates); every served answer bitwise the fault-free stream's, the shed
set the same on a replay. A device loss on every dispatch sheds each
batch classified with no reset, and the ladder walks to ``cache_only``.
"""

import os

import jax
import numpy as np
import pytest
import torch

from fia_tpu.data.dataset import RatingDataset as RefDataset
from fia_tpu.influence.engine import InfluenceEngine as RefEngine
from fia_tpu.models import MF as RefMF
from fia_tpu.reliability import policy as ref_policy
from fia_tpu.serve import InfluenceService as RefService
from fia_tpu.serve import Request as RefRequest
from fia_tpu.serve import ServeConfig as RefConfig
from fia_tpu.serve import admission as ref_admission
from fia_tpu.serve import health as ref_health
from fia_tpu.serve import metrics as ref_metrics
from fia_tpu.serve import scheduler as ref_scheduler
from fia_tpu_torch.data.dataset import RatingDataset
from fia_tpu_torch.data.index import InteractionIndex, bucketed_pad
from fia_tpu_torch.influence.engine import InfluenceEngine
from fia_tpu_torch.models import MF, params_from_numpy
from fia_tpu_torch.reliability import inject, taxonomy
from fia_tpu_torch.reliability import policy as rpolicy
from fia_tpu_torch.reliability.journal import Journal, JournalMismatch
from fia_tpu_torch.serve import (
    FairScheduler,
    HealthConfig,
    InfluenceService,
    MicroBatcher,
    Request,
    ServeConfig,
)
from fia_tpu_torch.serve import admission, health, metrics, scheduler
from fia_tpu_torch.utils import compilemon

torch.set_num_threads(2)

U, I, K = 30, 20, 4
WD = 1e-2
DAMP = 1e-3
# the port against the reference at this conditioning (cond ~1.1e3)
RTOL, ATOL = 1e-4, 1e-6


def _data(seed=0, n=400):
    rng = np.random.default_rng(seed)
    x = np.stack(
        [rng.integers(0, U, n), rng.integers(0, I, n)], axis=1
    ).astype(np.int32)
    y = rng.integers(1, 6, n).astype(np.float32)
    return x, y


def _setup(seed=0, n=400):
    x, y = _data(seed, n)
    model = MF(U, I, K, WD)
    params = model.init_params(torch.Generator().manual_seed(seed))
    return model, params, RatingDataset(x, y)


def _engine(model, params, train, **kw):
    kw.setdefault("damping", DAMP)
    kw.setdefault("solver", "direct")
    kw.setdefault("device", "cpu")
    return InfluenceEngine(model, params, train, **kw)


def _unique_points(train, n):
    """n distinct (u, i) pairs drawn from the train stream."""
    uniq = np.unique(train.x, axis=0)
    assert len(uniq) >= n
    return uniq[:n].astype(np.int64)


def _service(engine, **cfg):
    cfg.setdefault("disk_cache", False)
    return InfluenceService(engine=engine, config=ServeConfig(**cfg))


def _builds(eng) -> int:
    """Every program the engine holds: armed ahead of time or built on a
    dispatch."""
    g = eng.compiled_geometries()
    return len(g["aot"]) + len(g["jit"])


class TestByteIdentity:
    def test_admitted_results_match_query_many(self):
        """The coalesced dispatch stream is reproducible by query_many
        over the scheduler's order, and the per-request payloads are
        bit-identical to it."""
        model, params, train = _setup()
        pts = _unique_points(train, 11)
        mb = 4

        eng = _engine(model, params, train)
        svc = _service(eng, max_batch=mb)
        responses = svc.run([Request(int(u), int(i)) for u, i in pts])
        assert all(r.ok for r in responses)

        eng2 = _engine(model, params, train)
        order = MicroBatcher(mb, "bucket",
                             pad_bucket=eng2.pad_bucket).order(
            eng2.index.counts_batch(pts)
        )
        many = eng2.query_many(pts[order], batch_queries=mb)

        chunks = [pts[order][s: s + mb] for s in range(0, len(pts), mb)]
        assert len(svc.dispatch_log) == len(chunks)
        for (_, got), want in zip(svc.dispatch_log, chunks):
            assert np.array_equal(got, want)

        flat = [(res, t) for res in many for t in range(len(res.counts))]
        for rank, pos in enumerate(order):
            res, t = flat[rank]
            r = responses[pos]
            assert np.array_equal(r.scores, res.scores_of(t))
            assert np.array_equal(r.ihvp, res.ihvp[t])
            assert np.array_equal(r.test_grad, res.test_grad[t])
            assert np.array_equal(r.related, res.related_of(t))

    def test_admitted_results_match_query_many_at_mega_geometry(self):
        """The default geometry (max_batch 1024) coalesces the whole
        stream into one fused dispatch through the windowed path, every
        payload bit-identical to query_many over the scheduler's order."""
        model, params, train = _setup(seed=7)
        pts = _unique_points(train, 37)
        eng = _engine(model, params, train)
        svc = _service(eng)
        responses = svc.run([Request(int(u), int(i)) for u, i in pts])
        assert all(r.ok for r in responses)
        assert len(svc.dispatch_log) == 1

        eng2 = _engine(model, params, train)
        mb = ServeConfig().max_batch
        order = MicroBatcher(mb, "bucket",
                             pad_bucket=eng2.pad_bucket).order(
            eng2.index.counts_batch(pts)
        )
        many = eng2.query_many(pts[order], batch_queries=mb)
        flat = [(res, t) for res in many for t in range(len(res.counts))]
        for rank, pos in enumerate(order):
            res, t = flat[rank]
            r = responses[pos]
            assert np.array_equal(r.scores, res.scores_of(t))
            assert np.array_equal(r.ihvp, res.ihvp[t])
            assert np.array_equal(r.test_grad, res.test_grad[t])

    def test_duplicates_compute_once_and_hit_bit_identical(self):
        model, params, train = _setup()
        u, i = (int(v) for v in _unique_points(train, 1)[0])
        eng = _engine(model, params, train)
        svc = _service(eng)
        first, dup = svc.run([Request(u, i), Request(u, i)])
        assert first.cache_tier == "compute"
        assert dup.cache_tier == "hot"
        assert np.array_equal(first.scores, dup.scores)
        assert len(svc.dispatch_log) == 1

        again = svc.run([Request(u, i)])[0]
        assert again.cache_tier == "hot"
        assert np.array_equal(again.scores, first.scores)
        assert len(svc.dispatch_log) == 1


class TestAdmissionAndDeadlines:
    def test_overload_sheds_newest_deterministically(self):
        model, params, train = _setup()
        pts = _unique_points(train, 8)
        eng = _engine(model, params, train)

        def run_stream():
            svc = _service(eng, max_queue=5)
            return svc.run(
                [Request(int(u), int(i), id=f"q{k}")
                 for k, (u, i) in enumerate(pts)],
            )

        out = run_stream()
        shed = [r.id for r in out if not r.ok]
        assert shed == ["q5", "q6", "q7"]
        assert all(r.reason == "overload" for r in out if not r.ok)
        assert [r.id for r in run_stream() if not r.ok] == shed

    def test_invalid_ids_rejected_at_the_door(self):
        model, params, train = _setup()
        svc = _service(_engine(model, params, train))
        out = svc.run([Request(U + 5, 0), Request(0, -1), Request(0, 0)])
        assert [r.status for r in out] == ["rejected", "rejected", "ok"]
        assert out[0].reason == "invalid"
        assert out[1].reason == "invalid"

    def test_queued_past_deadline_rejected_with_taxonomy_kind(self):
        model, params, train = _setup()
        eng = _engine(model, params, train)
        t = [0.0]
        svc = InfluenceService(
            engine=eng,
            config=ServeConfig(disk_cache=False, default_deadline_s=1.0),
            clock=lambda: t[0],
        )
        u, i = (int(v) for v in train.x[0])
        assert svc.submit(Request(u, i)) is None
        t[0] = 5.0
        out = svc.drain()
        assert out[0].status == "rejected"
        assert out[0].reason == taxonomy.DEADLINE

    def test_injected_deadline_fault_sheds_batch_stream_completes(self):
        """A deadline fault at ``serve.dispatch`` rejects exactly that
        batch with the taxonomy kind; the rest of the stream completes,
        byte-identical to the engine's own answers."""
        model, params, train = _setup()
        pts = _unique_points(train, 6)
        mb = 3
        eng = _engine(model, params, train)
        svc = _service(eng, max_batch=mb)
        reqs = [Request(int(u), int(i), id=f"q{k}")
                for k, (u, i) in enumerate(pts)]
        with inject.active(inject.Fault("serve.dispatch", at=0,
                                        kind="deadline")) as plan:
            out = svc.run(reqs)
        assert plan.unfired() == []

        rejected = [r for r in out if not r.ok]
        ok = [r for r in out if r.ok]
        assert len(rejected) == mb and len(ok) == mb
        assert all(r.reason == taxonomy.DEADLINE for r in rejected)

        survivors = list(svc.dispatch_log)
        direct = _engine(model, params, train).query_batch(survivors[1][1])
        by_key = {(int(p[0]), int(p[1])): t
                  for t, p in enumerate(survivors[1][1])}
        for r in ok:
            t = by_key[(r.user, r.item)]
            assert np.array_equal(r.scores, direct.scores_of(t))


class TestDiskTier:
    def test_disk_hit_after_process_restart(self, tmp_path):
        model, params, train = _setup()
        u, i = (int(v) for v in train.x[0])
        eng1 = _engine(model, params, train, cache_dir=str(tmp_path))
        svc1 = InfluenceService(engine=eng1, config=ServeConfig())
        first = svc1.run([Request(u, i)])[0]
        assert first.cache_tier == "compute"

        eng2 = _engine(model, params, train, cache_dir=str(tmp_path))
        svc2 = InfluenceService(engine=eng2, config=ServeConfig())
        hit = svc2.run([Request(u, i)])[0]
        assert hit.cache_tier == "disk"
        assert np.array_equal(hit.scores, first.scores)
        assert len(svc2.dispatch_log) == 0

    def test_torn_disk_entry_is_a_clean_recompute(self, tmp_path):
        model, params, train = _setup()
        u, i = (int(v) for v in train.x[0])
        eng1 = _engine(model, params, train, cache_dir=str(tmp_path))
        svc1 = InfluenceService(engine=eng1, config=ServeConfig())
        with inject.active(inject.Fault("serve.cache_publish", at=0,
                                        kind="torn")) as plan:
            first = svc1.run([Request(u, i)])[0]
        assert plan.unfired() == []
        assert first.ok

        eng2 = _engine(model, params, train, cache_dir=str(tmp_path))
        svc2 = InfluenceService(engine=eng2, config=ServeConfig())
        got = svc2.run([Request(u, i)])[0]
        assert got.ok and got.cache_tier == "compute"
        assert svc2.cache.stats.disk_rejects == 1
        assert np.array_equal(got.scores, first.scores)
        quarantined = [p for p in os.listdir(tmp_path / "serve")
                       if p.endswith(".corrupt")]
        assert quarantined
        eng3 = _engine(model, params, train, cache_dir=str(tmp_path))
        svc3 = InfluenceService(engine=eng3, config=ServeConfig())
        assert svc3.run([Request(u, i)])[0].cache_tier == "disk"

    def test_shared_cache_dir_interleaved_services_stay_keyed(
        self, tmp_path
    ):
        """Two services with different solve configs interleave drains
        over one cache_dir: neither serves the other's blocks, and their
        query_many journals refuse each other's fingerprints."""
        model, params, train = _setup()
        pts = _unique_points(train, 4)
        eng_a = _engine(model, params, train, cache_dir=str(tmp_path))
        eng_b = _engine(model, params, train, cache_dir=str(tmp_path),
                        solver="cg", cg_maxiter=50)
        svc_a = InfluenceService(engine=eng_a, config=ServeConfig())
        svc_b = InfluenceService(engine=eng_b, config=ServeConfig())

        for u, i in pts:
            ra = svc_a.run([Request(int(u), int(i))])[0]
            rb = svc_b.run([Request(int(u), int(i))])[0]
            assert ra.ok and rb.ok
        assert all(r[1].shape[0] for r in svc_b.dispatch_log)
        assert svc_b.cache.stats.hits_disk == 0

        svc_a2 = InfluenceService(
            engine=_engine(model, params, train, cache_dir=str(tmp_path)),
            config=ServeConfig(),
        )
        u, i = (int(v) for v in pts[0])
        assert svc_a2.run([Request(u, i)])[0].cache_tier == "disk"

        jpath = str(tmp_path / "stream.journal")
        with Journal.open(jpath, eng_a.journal_fingerprint(pts, 2)) as j:
            eng_a.query_many(pts, batch_queries=2, journal=j)
        with pytest.raises(JournalMismatch):
            Journal.open(jpath, eng_b.journal_fingerprint(pts, 2),
                         resume=True)


class TestInvalidation:
    def test_retrain_invalidates_serving_caches(self):
        """FIAModel._invalidate reaches the serving layer: a
        post-retrain query recomputes instead of hot-hitting."""
        from fia_tpu_torch.api import FIAModel

        _, _, train = _setup()
        ds = {"train": train, "validation": train, "test": train}
        m = FIAModel("MF", U, I, K, weight_decay=WD, batch_size=64,
                     data_sets=ds, damping=DAMP, solver="direct",
                     train_dir="", device="cpu")
        svc = m.serve(config=ServeConfig(disk_cache=False))
        u, i = (int(v) for v in train.x[0])
        before = svc.run([Request(u, i)])[0]
        assert svc.run([Request(u, i)])[0].cache_tier == "hot"

        m.retrain(num_steps=5)
        assert svc.cache.stats.invalidations == 1
        after = svc.run([Request(u, i)])[0]
        assert after.cache_tier == "compute"
        assert not np.array_equal(after.scores, before.scores)

    def test_fingerprint_key_guards_even_without_invalidate(self):
        """A service nobody told about a params change cannot serve stale
        blocks: the fingerprint in the key misses."""
        model, params, train = _setup()
        eng1 = _engine(model, params, train)
        engines = [eng1]
        svc = InfluenceService(engine_provider=lambda: engines[-1],
                               config=ServeConfig(disk_cache=False))
        u, i = (int(v) for v in train.x[0])
        svc.run([Request(u, i)])

        p2 = model.init_params(torch.Generator().manual_seed(99))
        engines.append(_engine(model, p2, train))
        r = svc.run([Request(u, i)])[0]
        assert r.cache_tier == "compute"


class TestIndexMemoAndCompileCache:
    def test_related_memo_hits_and_is_write_protected(self):
        _, _, train = _setup()
        idx = InteractionIndex(train.x, U, I)
        u, i = (int(v) for v in train.x[0])
        a = idx.related(u, i)
        b = idx.related(u, i)
        assert a is b and idx.memo_hits == 1
        with pytest.raises(ValueError):
            a[0] = 7
        assert np.array_equal(
            a, np.concatenate([idx.rows_of_user(u), idx.rows_of_item(i)])
        )

    def test_single_query_padded_memo(self):
        _, _, train = _setup()
        idx = InteractionIndex(train.x, U, I)
        pt = train.x[:1]
        r1 = idx.related_padded(pt, bucket=16)
        r2 = idx.related_padded(pt, bucket=16)
        assert r1[0] is r2[0] and r1[1] is r2[1]

    def test_same_bucket_queries_share_compiled_program(self):
        """Two different queries landing in the same pad bucket build
        nothing new: on the padded path (eager in the port: no build at
        all), and on the flat path at one (t_pad, s_pad) geometry."""
        model, params, train = _setup()
        uniq = np.unique(train.x, axis=0)
        counts = InteractionIndex(train.x, U, I).counts_batch(uniq)

        eng = _engine(model, params, train, impl="padded")
        svc = _service(eng, coalesce="fifo", max_batch=1)
        by_pad = {}
        for (u, i), c in zip(uniq, counts):
            by_pad.setdefault(bucketed_pad(int(c), eng.pad_bucket),
                              []).append((int(u), int(i)))
        pair = next(v for v in by_pad.values() if len(v) >= 2)[:2]
        svc.run([Request(*pair[0])])
        builds = compilemon.count()
        svc.run([Request(*pair[1])])
        assert compilemon.count() == builds and _builds(eng) == 0

        flat = _engine(model, params, train)
        svc = _service(flat, coalesce="fifo", max_batch=1)
        by_geom = {}
        for u, i in uniq:
            by_geom.setdefault(flat.flat_geometry(np.array([[u, i]])),
                               []).append((int(u), int(i)))
        pair = next(v for v in by_geom.values() if len(v) >= 2)[:2]
        svc.run([Request(*pair[0])])
        builds = compilemon.count()
        held = _builds(flat)
        svc.run([Request(*pair[1])])
        assert compilemon.count() == builds and _builds(flat) == held == 1

    def test_warmup_precompiles_the_serving_buckets(self):
        model, params, train = _setup()
        pts = _unique_points(train, 8)
        eng = _engine(model, params, train)
        svc = _service(eng, max_batch=4)
        info = svc.warmup(pts)
        assert info["batches"] == 2
        assert info["all_planned_compiled"]
        assert info["kernel_variant"] == "torch"  # the CPU's plain stage
        assert info["compiled_keys"] == []  # all armed ahead of time
        builds, held = compilemon.count(), _builds(eng)
        out = svc.run([Request(int(u), int(i)) for u, i in pts])
        assert all(r.ok for r in out)
        assert compilemon.count() == builds and _builds(eng) == held


class TestSolverResolution:
    def test_resolve_solver_walks_the_ladder(self):
        assert rpolicy.resolve_solver(None, default="direct") == "direct"
        assert rpolicy.resolve_solver("lissa") == "lissa"
        assert rpolicy.resolve_solver(
            "direct", supported=rpolicy.FULL_SOLVERS) == "cg"
        assert rpolicy.resolve_solver(
            "schulz", supported=rpolicy.FULL_SOLVERS) == "cg"
        assert rpolicy.resolve_solver(
            None, default="lissa", supported=rpolicy.FULL_SOLVERS
        ) == "lissa"

    def test_get_inverse_hvp_honours_model_solver(self):
        """A direct-solver model resolves through the one path (direct
        has no full-Hessian rung, so it maps to cg)."""
        from fia_tpu_torch.api import FIAModel

        _, _, train = _setup(n=120)
        ds = {"train": train, "validation": train, "test": train}
        m = FIAModel("MF", U, I, K, weight_decay=WD, batch_size=64,
                     data_sets=ds, damping=1e-2, solver="direct",
                     train_dir="", device="cpu")
        d = sum(int(p.numel()) for p in m.params.values())
        v = np.ones(d, np.float32)
        x = np.asarray(m.get_inverse_hvp(v))
        assert x.shape == (d,) and np.isfinite(x).all()


class TestSmoke:
    def test_inprocess_smoke_stream(self):
        """The CI gate's in-process form: a 200-query repeat-heavy
        stream — nothing dropped without a reason, the hot tier absorbs
        repeats, accounting adds up."""
        from fia_tpu_torch.cli.serve import smoke_stream

        model, params, train = _setup()
        eng = _engine(model, params, train)
        svc = _service(eng, max_batch=16)
        reqs = smoke_stream(train.x, 200, hot_frac=0.5, seed=3)
        out = svc.run(reqs, drain_every=16)
        assert len(out) == 200
        assert not [r for r in out if not r.ok and not r.reason]
        assert svc.cache.stats.hits_hot > 0
        roll = svc.rollup()
        assert roll["ok"] + sum(roll["rejected"].values()) == 200
        assert roll["ok"] == 200
        assert roll["solve_ms"]["p95"] >= roll["solve_ms"]["p50"] >= 0


class TestMicroBatcherPins:
    def test_order_stable_under_equal_bucket_keys(self):
        mb = MicroBatcher(max_batch=4, coalesce="bucket", pad_bucket=128)
        counts = np.array([3, 120, 7, 64, 1])
        assert np.array_equal(mb.order(counts), np.arange(5))
        counts = np.array([300, 3, 200, 7, 150])
        assert list(mb.order(counts)) == [1, 3, 2, 4, 0]

    def test_plan_ragged_final_chunk(self):
        mb = MicroBatcher(max_batch=3, coalesce="fifo")
        plan = mb.plan(np.full(7, 5))
        assert [len(b) for b in plan] == [3, 3, 1]
        assert np.array_equal(np.concatenate(plan), np.arange(7))

    def test_fair_scheduler_single_class_verbatim(self):
        mb = MicroBatcher(max_batch=4, coalesce="bucket", pad_bucket=64)
        fair = FairScheduler(mb)
        rng = np.random.default_rng(5)
        counts = rng.integers(1, 300, size=13)
        want = mb.plan(counts)
        for classes in (None, ["batch"] * 13, ["interactive"] * 13):
            got = fair.plan(counts, classes)
            assert len(got) == len(want)
            for g, w in zip(got, want):
                assert np.array_equal(g, w)


class TestMultiTenant:
    def test_drr_plan_class_pure_and_priority_ordered(self):
        fair = FairScheduler(MicroBatcher(max_batch=4, coalesce="fifo"))
        counts = np.full(10, 3)
        classes = (["scavenger"] * 5) + (["interactive"] * 5)
        plan = fair.plan(counts, classes)
        for b in plan:
            assert len({classes[int(p)] for p in b}) == 1
        first_cls = [classes[int(b[0])] for b in plan]
        assert first_cls.index("scavenger") > max(
            i for i, c in enumerate(first_cls) if c == "interactive")
        assert sorted(int(p) for b in plan for p in b) == list(range(10))

    def test_drr_scavenger_never_starves(self):
        fair = FairScheduler(MicroBatcher(max_batch=2, coalesce="fifo"))
        for _ in range(5):
            counts = np.full(10, 2)
            classes = (["interactive"] * 8) + (["scavenger"] * 2)
            plan = fair.plan(counts, classes)
            assert [b for b in plan if classes[int(b[0])] == "scavenger"]

    def test_urgent_batches_promote_to_front(self):
        fair = FairScheduler(MicroBatcher(max_batch=2, coalesce="fifo"))
        counts = np.full(6, 2)
        classes = (["interactive"] * 4) + (["scavenger"] * 2)
        urgent = [False] * 4 + [True, False]
        plan = fair.plan(counts, classes, urgent)
        assert classes[int(plan[0][0])] == "scavenger"
        assert 4 in {int(p) for p in plan[0]}

    def test_scavenger_quota_flood_sheds_class_tagged(self):
        model, params, train = _setup()
        pts = _unique_points(train, 14)
        eng = _engine(model, params, train)
        svc = _service(eng, max_batch=4, max_queue=8,
                       class_quotas={"scavenger": 0.5})
        assert svc.admission.class_caps["scavenger"] == 4
        rejected = []
        for j, (u, i) in enumerate(pts[:8]):
            r = svc.submit(Request(int(u), int(i), id=f"s{j}",
                                   cls="scavenger", tenant="t-s"))
            if r is not None:
                rejected.append(r)
        assert len(rejected) == 4
        for r in rejected:
            assert r.reason == "overload"
            assert r.cls == "scavenger" and r.tenant == "t-s"
            assert r.json()["class"] == "scavenger"
        for j, (u, i) in enumerate(pts[8:12]):
            assert svc.submit(Request(int(u), int(i), id=f"i{j}",
                                      cls="interactive")) is None
        out = {r.id: r for r in svc.drain()}
        assert all(out[f"i{j}"].ok for j in range(4))
        lane = svc.rollup()["classes"]["scavenger"]
        assert lane["requests"] == 8 and lane["ok"] == 4
        assert lane["rejected"] == {"overload": 4}

    def test_tenant_quota_flood_sheds_only_the_noisy_tenant(self):
        model, params, train = _setup()
        pts = _unique_points(train, 14)
        eng = _engine(model, params, train)
        svc = _service(eng, max_batch=4, max_queue=8,
                       tenant_quotas={"acme": 0.25})
        assert svc.admission.tenant_caps["acme"] == 2
        rejected = []
        for j, (u, i) in enumerate(pts[:6]):
            r = svc.submit(Request(int(u), int(i), id=f"a{j}",
                                   cls="batch", tenant="acme"))
            if r is not None:
                rejected.append(r)
        assert len(rejected) == 4
        for r in rejected:
            assert r.reason == "overload"
            assert r.tenant == "acme" and r.cls == "batch"
            assert r.json()["tenant"] == "acme"
        for j, (u, i) in enumerate(pts[6:9]):
            assert svc.submit(Request(int(u), int(i), id=f"b{j}",
                                      cls="batch", tenant="beta")) is None
        for j, (u, i) in enumerate(pts[9:12]):
            assert svc.submit(Request(int(u), int(i),
                                      id=f"u{j}", cls="batch")) is None
        out = {r.id: r for r in svc.drain()}
        assert all(out[f"a{j}"].ok for j in range(2))
        assert all(out[f"b{j}"].ok for j in range(3))
        assert all(out[f"u{j}"].ok for j in range(3))
        u, i = (int(v) for v in pts[12])
        assert svc.submit(Request(u, i, id="a-next",
                                  cls="batch", tenant="acme")) is None

    def test_tenant_quota_validation(self):
        model, params, train = _setup()
        eng = _engine(model, params, train)
        with pytest.raises(ValueError, match="tenant quota"):
            _service(eng, tenant_quotas={"acme": 1.5})

    def test_unknown_class_rejected_invalid(self):
        model, params, train = _setup()
        u, i = (int(v) for v in _unique_points(train, 1)[0])
        svc = _service(_engine(model, params, train))
        r = svc.submit(Request(u, i, cls="platinum"))
        assert r is not None and r.reason == "invalid"

    def test_mixed_stream_class_pure_priority_dispatch(self):
        model, params, train = _setup()
        pts = _unique_points(train, 12)
        svc = _service(_engine(model, params, train), max_batch=4)
        reqs = [Request(int(u), int(i), id=f"r{j}",
                        cls="scavenger" if j < 6 else "interactive")
                for j, (u, i) in enumerate(pts)]
        out = {r.id: r for r in svc.run(reqs)}
        assert all(r.ok for r in out.values())
        by_batch = {}
        for j in range(12):
            r = out[f"r{j}"]
            by_batch.setdefault(r.batch_id, set()).add(r.cls)
        assert all(len(c) == 1 for c in by_batch.values())
        i_bids = [b for b, c in by_batch.items() if "interactive" in c]
        s_bids = [b for b, c in by_batch.items() if "scavenger" in c]
        assert max(i_bids) < min(s_bids), (i_bids, s_bids)

    def test_mixed_stream_per_class_byte_identity(self):
        model, params, train = _setup(seed=3)
        pts = _unique_points(train, 12)
        svc = _service(_engine(model, params, train), max_batch=4)
        reqs = [Request(int(u), int(i), id=f"r{j}",
                        cls=("interactive", "batch", "scavenger")[j % 3])
                for j, (u, i) in enumerate(pts)]
        mixed = {r.id: r for r in svc.run(reqs)}
        assert all(r.ok for r in mixed.values())
        for cls in ("interactive", "batch", "scavenger"):
            solo_svc = _service(_engine(model, params, train), max_batch=4)
            lane = [Request(r.user, r.item, id=r.id, cls=cls)
                    for r in reqs if r.cls == cls]
            solo = {r.id: r for r in solo_svc.run(lane)}
            for rid, r in solo.items():
                assert np.array_equal(mixed[rid].scores, r.scores)
                assert np.array_equal(mixed[rid].ihvp, r.ihvp)

    def _browned_service(self, eng, approx_ok=True):
        svc = _service(
            eng, max_batch=8,
            health=HealthConfig(window=4, err_degrade=0.5,
                                err_cache_only=2.0, err_recover=0.25,
                                min_evidence=2, queue_hold=3, hold=8,
                                approx_ok=approx_ok))
        svc.health.observe(errors=8, dispatches=8, queue_depth=0,
                           queue_cap=svc.admission.max_queue)
        assert svc.health.mode == "bank_preferred"
        return svc

    def test_class_aware_brownout_interactive_stays_exact(self):
        model, params, train = _setup()
        pts = _unique_points(train, 9)
        svc = self._browned_service(_engine(model, params, train))
        reqs = [Request(int(u), int(i), id=f"{cls[0]}{j}", cls=cls)
                for j, (u, i) in enumerate(pts)
                for cls in [("interactive", "batch", "scavenger")[j % 3]]]
        out = {r.id: r for r in svc.run(reqs)}
        assert all(r.ok for r in out.values())
        for rid, r in out.items():
            if rid.startswith("i"):
                assert not r.approx and r.err_bound is None
            else:
                assert r.approx and r.err_bound is not None
        healthy = _service(_engine(model, params, train), max_batch=8)
        ref = {r.id: r for r in healthy.run(
            [Request(q.user, q.item, id=q.id, cls=q.cls)
             for q in reqs if q.cls == "interactive"])}
        for rid, r in ref.items():
            assert np.array_equal(out[rid].scores, r.scores)

    def test_class_aware_brownout_approx_off_sheds_lower_classes(self):
        model, params, train = _setup()
        pts = _unique_points(train, 6)
        svc = self._browned_service(_engine(model, params, train),
                                    approx_ok=False)
        reqs = [Request(int(u), int(i), id=f"{cls[0]}{j}", cls=cls)
                for j, (u, i) in enumerate(pts)
                for cls in [("interactive", "scavenger")[j % 2]]]
        out = {r.id: r for r in svc.run(reqs)}
        for rid, r in out.items():
            if rid.startswith("i"):
                assert r.ok and not r.approx
            else:
                assert not r.ok and r.reason == "degraded"
                assert r.cls == "scavenger"

    def test_brownout_transitions_replay_deterministic(self):
        model, params, train = _setup()
        pts = _unique_points(train, 6)

        def episode():
            svc = self._browned_service(_engine(model, params, train))
            svc.run([Request(int(u), int(i), id=f"q{j}",
                             cls=("interactive", "scavenger")[j % 2])
                     for j, (u, i) in enumerate(pts)])
            return svc.health.transitions

        assert episode() == episode()

    def test_rollup_class_lanes_partition_the_stream(self):
        model, params, train = _setup()
        pts = _unique_points(train, 10)
        svc = _service(_engine(model, params, train), max_batch=4,
                       max_queue=4)
        for j, (u, i) in enumerate(pts):
            svc.submit(Request(int(u), int(i), id=f"r{j}",
                               cls=("interactive", "batch")[j % 2]))
            if j % 4 == 3:
                svc.drain()
        svc.drain()
        roll = svc.rollup()
        lanes = roll["classes"]
        assert sum(lane["requests"] for lane in lanes.values()) \
            == roll["requests"]
        for lane in lanes.values():
            assert lane["ok"] + sum(lane["rejected"].values()) \
                == lane["requests"]

    def test_health_class_mode_ladder(self):
        h = health.HealthController(HealthConfig())
        assert h.class_mode("interactive") == "full"
        assert h.allows_solve("scavenger")
        h.mode = "bank_preferred"
        assert h.class_mode("interactive") == "full"
        assert h.class_mode("batch") == "bank_preferred"
        assert h.allows_solve("interactive")
        assert not h.allows_solve("scavenger")
        assert h.allows_bank("batch")
        assert not h.allows_bank("scavenger")
        assert not h.allows_approx("interactive")
        assert h.allows_approx("scavenger")
        h.mode = "cache_only"
        for cls in ("interactive", "batch", "scavenger"):
            assert h.class_mode(cls) == "cache_only"
            assert not h.allows_solve(cls)
            assert not h.allows_bank(cls)
            assert not h.allows_approx(cls)


# -- the port against the reference --------------------------------------

def _ref_setup(seed=0, n=400):
    """The reference's ``_setup`` and the same model in the port, its
    params carried over."""
    x, y = _data(seed, n)
    ref_model = RefMF(U, I, K, WD)
    ref_params = ref_model.init_params(jax.random.PRNGKey(seed))
    model = MF(U, I, K, WD)
    params = params_from_numpy(
        model, jax.tree_util.tree_map(np.asarray, ref_params), "cpu")
    return (ref_model, ref_params, RefDataset(x, y)), \
        (model, params, RatingDataset(x, y))


def _stream_spec(x, n=48, seed=11):
    """(user, item, id, cls, deadline) of a seeded stream over the train
    pairs: half from a hot set of 6, a few out-of-range ids, every class,
    and a deadline that the clock's jumps expire for some."""
    rng = np.random.default_rng(seed)
    uniq = np.unique(x, axis=0)
    hot = uniq[rng.choice(len(uniq), 6, replace=False)]
    out = []
    for k in range(n):
        if k % 13 == 5:
            u, i = U + int(rng.integers(1, 4)), 0
        elif rng.random() < 0.5:
            u, i = hot[rng.integers(len(hot))]
        else:
            u, i = uniq[rng.integers(len(uniq))]
        cls = ("interactive", "batch", "scavenger")[int(rng.integers(3))]
        dl = 2.5 if k % 7 == 3 else None
        out.append((int(u), int(i), f"s{k}", cls, dl))
    return out


def _run_stream(svc_cls, req_cls, clock, svc, spec):
    """Submit in waves of 10 (an admission bound of 8 sheds the tail of
    each), advancing the virtual clock a second a wave; drain after
    each."""
    out = {}
    for w in range(0, len(spec), 10):
        for u, i, rid, cls, dl in spec[w: w + 10]:
            r = svc.submit(req_cls(u, i, id=rid, cls=cls, deadline_s=dl))
            if r is not None:
                out[rid] = r
        clock.advance(1.0 + (w // 10) % 2 * 2.0)
        for r in svc.drain():
            out[r.id] = r
    return out


@pytest.fixture(scope="module")
def both_streams():
    (rm, rp, rtrain), (m, p, train) = _ref_setup()
    spec = _stream_spec(train.x)
    cfg = dict(max_batch=4, max_queue=8, disk_cache=False,
               dispatch_window=2, deadline_slack_s=1.0)
    rclock = ref_policy.VirtualClock()
    ref_svc = RefService(
        engine=RefEngine(rm, rp, rtrain, damping=DAMP, solver="direct"),
        config=RefConfig(**cfg), clock=rclock)
    ref = _run_stream(RefService, RefRequest, rclock, ref_svc, spec)
    clock = rpolicy.VirtualClock()
    svc = InfluenceService(engine=_engine(m, p, train),
                           config=ServeConfig(**cfg), clock=clock)
    got = _run_stream(InfluenceService, Request, clock, svc, spec)
    return {"spec": spec, "ref": ref, "got": got, "ref_svc": ref_svc,
            "svc": svc}


class TestAgainstReference:
    def test_same_outcome_per_request(self, both_streams):
        ref, got = both_streams["ref"], both_streams["got"]
        assert sorted(ref) == sorted(got)
        reasons = set()
        for rid, r in ref.items():
            g = got[rid]
            assert (g.status, g.reason, g.cache_tier, g.batch_id,
                    g.batch_size, g.mode, g.cls, g.approx) == (
                r.status, r.reason, r.cache_tier, r.batch_id,
                r.batch_size, r.mode, r.cls, r.approx), rid
            assert g.json(include_payload=False) == \
                r.json(include_payload=False)
            reasons.add(r.reason)
        # the stream exercises each admission outcome
        assert {None, "invalid", "overload", "deadline"} <= reasons

    def test_same_dispatch_log(self, both_streams):
        ref_log = both_streams["ref_svc"].dispatch_log
        log = both_streams["svc"].dispatch_log
        assert len(log) == len(ref_log) > 4
        for (bid, pts), (rbid, rpts) in zip(log, ref_log):
            assert bid == rbid and np.array_equal(pts, rpts)

    def test_same_rollup(self, both_streams):
        assert both_streams["svc"].rollup() == \
            both_streams["ref_svc"].rollup()

    def test_payloads_within_the_bar(self, both_streams):
        ref, got = both_streams["ref"], both_streams["got"]
        n = 0
        for rid, r in ref.items():
            if not r.ok:
                continue
            g = got[rid]
            assert np.array_equal(g.related, r.related)
            np.testing.assert_allclose(g.scores, np.asarray(r.scores),
                                       rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(g.ihvp, np.asarray(r.ihvp),
                                       rtol=RTOL, atol=ATOL)
            n += 1
        assert n > 10


def _random_counts(rng, n):
    """Counts with equal bucket keys (many below one pad bucket) and a
    spread across several buckets."""
    small = rng.integers(1, 120, n)
    wide = rng.integers(1, 700, n)
    return np.where(rng.random(n) < 0.5, small, wide)


@pytest.mark.parametrize("coalesce", ["bucket", "fifo"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_planner_equals_reference(coalesce, seed):
    """MicroBatcher and FairScheduler plans index for index the
    reference's, over a sequence of plan calls (the DRR deficits carry
    across them), with classes, urgency, equal bucket keys and ragged
    tails."""
    rng = np.random.default_rng(seed)
    mb = int(rng.integers(2, 7))
    weights = {"batch": int(rng.integers(1, 5))}
    got = FairScheduler(MicroBatcher(mb, coalesce, pad_bucket=64), weights)
    ref = ref_scheduler.FairScheduler(
        ref_scheduler.MicroBatcher(mb, coalesce, pad_bucket=64), weights)
    for _ in range(6):
        n = int(rng.integers(1, 40))
        counts = _random_counts(rng, n)
        assert [list(b) for b in got.batcher.plan(counts)] == \
            [list(b) for b in ref.batcher.plan(counts)]
        assert got.batcher.planned_shapes(counts) == \
            ref.batcher.planned_shapes(counts)
        classes = [scheduler.CLASSES[int(c)] if c < 3 else "batch"
                   for c in rng.integers(0, 4, n)]
        urgent = list(rng.random(n) < 0.15) if rng.random() < 0.5 else None
        a = got.plan(counts, classes, urgent)
        b = ref.plan(counts, classes, urgent)
        assert [list(x) for x in a] == [list(x) for x in b]
        assert got._deficit == ref._deficit


@pytest.mark.parametrize("cfg", [
    {},
    {"window": 3, "min_evidence": 2, "hold": 3, "queue_hold": 2},
    {"err_degrade": 0.4, "err_cache_only": 0.6, "err_recover": 0.1,
     "queue_degrade": 0.7, "queue_recover": 0.3, "approx_ok": False},
], ids=["default", "short-window", "tight"])
def test_health_transition_log_equals_reference(cfg):
    rng = np.random.default_rng(len(cfg))
    # stormy and calm spells of 30 drains each, so the ladder steps
    # down and back up several times
    stream = []
    for spell in range(10):
        storm = spell % 2 == 0
        stream += [
            dict(errors=int(rng.integers(0, 4)) if storm else
                 int(rng.random() < 0.1),
                 dispatches=int(rng.integers(0, 5)) if storm else
                 int(rng.integers(1, 5)),
                 queue_depth=int(rng.integers(0, 12)) if storm else
                 int(rng.integers(0, 4)), queue_cap=8)
            for _ in range(30)
        ]
    got = health.HealthController(HealthConfig(**cfg))
    ref = ref_health.HealthController(ref_health.HealthConfig(**cfg))
    for s in stream:
        assert got.observe(**s) == ref.observe(**s)
        for cls in ("interactive", "batch", "scavenger"):
            assert (got.allows_solve(cls), got.allows_bank(cls),
                    got.allows_approx(cls)) == (
                ref.allows_solve(cls), ref.allows_bank(cls),
                ref.allows_approx(cls))
    assert got.transitions == ref.transitions
    assert len(got.transitions) > 2


def test_admission_equals_reference():
    """The same reject reason and ticket deadline for random requests
    at random depths, under class and tenant quotas and class SLOs."""
    rng = np.random.default_rng(4)
    kw = dict(max_queue=10, default_deadline_s=3.0, num_users=U,
              num_items=I, class_quotas={"scavenger": 0.3},
              tenant_quotas={"acme": 0.2},
              class_deadlines={"interactive": 0.5})
    got = admission.AdmissionController(**kw)
    ref = ref_admission.AdmissionController(**kw)
    assert got.class_caps == ref.class_caps
    assert got.tenant_caps == ref.tenant_caps
    for k in range(300):
        u, i = int(rng.integers(-2, U + 3)), int(rng.integers(-2, I + 3))
        cls = ("interactive", "batch", "scavenger", "gold")[
            int(rng.integers(4))]
        tenant = (None, "acme", "beta")[int(rng.integers(3))]
        dl = (None, 1.5, 0.0)[int(rng.integers(3))]
        depths = [int(d) for d in rng.integers(0, 12, 3)]
        a = got.reject_reason(Request(u, i, cls=cls, tenant=tenant,
                                      deadline_s=dl), *depths)
        b = ref.reject_reason(RefRequest(u, i, cls=cls, tenant=tenant,
                                         deadline_s=dl), *depths)
        assert a == b
        if a is None:
            ta = got.ticket(Request(u, i, cls=cls, deadline_s=dl), 7.0)
            tb = ref.ticket(RefRequest(u, i, cls=cls, deadline_s=dl), 7.0)
            assert ta.t_deadline == tb.t_deadline


def test_schema_and_wire_keys_equal_reference():
    """The JSONL schema and a response's wire keys are the reference's,
    so the reference's readers read the port's files."""
    assert metrics.SCHEMA == ref_metrics.SCHEMA
    got = Request(1, 2)
    assert sorted(vars(got)) == sorted(vars(RefRequest(1, 2)))
    from fia_tpu.serve.request import Response as RefResponse
    from fia_tpu_torch.serve.request import Response

    a = Response(id="x", user=1, item=2, scores=np.ones(2, np.float32),
                 related=np.arange(2)).json()
    b = RefResponse(id="x", user=1, item=2, scores=np.ones(2, np.float32),
                    related=np.arange(2)).json()
    assert a == b


# -- the windowed loop's faults ------------------------------------------

def _fault_stream(window, fault=None, finalize_at=None, tag=False):
    """Serve 14 distinct pairs at max_batch 3 (five batches) with the
    given dispatch window, under ``fault`` (an inject.Fault) or a
    worker-death signature raised by the ``finalize_at``-th finalize.
    Returns (responses by id, shed ids, the engine's reset count, the
    finalize log of (dispatch epoch, finalize epoch))."""
    model, params, train = _setup(seed=2)
    pts = _unique_points(train, 14)
    eng = _engine(model, params, train)
    state = {"epoch": 0, "finals": 0, "log": []}
    real_reset = eng._reset_device_state
    real_dispatch = eng._dispatch_flat
    real_finalize = eng._finalize_flat

    def reset(*a, **kw):
        state["epoch"] += 1
        return real_reset(*a, **kw)

    def dispatch(points, pad_to):
        return (state["epoch"], real_dispatch(points, pad_to))

    def finalize(handle):
        epoch, h = handle
        state["log"].append((epoch, state["epoch"]))
        k = state["finals"]
        state["finals"] += 1
        if k == finalize_at:
            raise RuntimeError(
                "UNAVAILABLE: TPU worker process crashed or restarted")
        return real_finalize(h)

    eng._reset_device_state = reset
    eng._dispatch_flat = dispatch
    eng._finalize_flat = finalize
    svc = _service(eng, max_batch=3, dispatch_window=window)
    reqs = [Request(int(u), int(i), id=f"q{k}")
            for k, (u, i) in enumerate(pts)]
    if fault is None:
        out = svc.run(reqs)
    else:
        with inject.active(fault, strict=True, validate=True):
            out = svc.run(reqs)
    by_id = {r.id: r for r in out}
    shed = sorted(r.id for r in out if not r.ok)
    return by_id, shed, state["epoch"], state["log"], svc


def _batch_ids(svc, bid):
    """The request ids of dispatch batch ``bid``."""
    pts = dict(svc.dispatch_log)[bid]
    return {(int(u), int(i)) for u, i in pts}


@pytest.mark.parametrize("window", [2, 3])
@pytest.mark.parametrize("site,kind,sheds", [
    ("serve.dispatch", taxonomy.WORKER, True),
    ("serve.dispatch", taxonomy.PREEMPTION, True),
    ("engine.dispatch_flat", taxonomy.WORKER, False),
    ("engine.dispatch_flat", taxonomy.PREEMPTION, False),
    ("finalize", taxonomy.WORKER, True),
], ids=["serve-worker", "serve-preemption", "engine-worker",
        "engine-preemption", "finalize-worker"])
def test_windowed_fault_sheds_only_the_faulted_batch(window, site, kind,
                                                     sheds):
    base, base_shed, _, _, _ = _fault_stream(window)
    assert base_shed == []
    # the second batch faults while the first is in flight
    if site == "finalize":
        run = lambda: _fault_stream(window, finalize_at=1)  # noqa: E731
    else:
        run = lambda: _fault_stream(  # noqa: E731
            window, fault=inject.Fault(site, at=1, kind=kind))
    got, shed, resets, log, svc = run()
    assert sorted(got) == sorted(base)
    for rid, r in got.items():
        if r.ok:
            assert np.array_equal(r.scores, base[rid].scores), rid
            assert np.array_equal(r.ihvp, base[rid].ihvp), rid
    if sheds:
        assert len(shed) == 3 and all(got[i].reason == kind for i in shed)
        faulted = {(got[i].user, got[i].item) for i in shed}
        assert faulted == _batch_ids(svc, 1)
    else:
        assert shed == []
    # the device state is rebuilt once where the fault kills the
    # in-flight dispatches, and no handle outlives a reset
    assert resets == (0 if site == "serve.dispatch" else 1)
    assert all(d == f for d, f in log)
    # a replay sheds the same requests
    assert run()[1] == shed


def test_sticky_device_loss_sheds_every_batch_without_reset():
    """A device loss on every dispatch (a sticky CUDA error on the card):
    each batch sheds ``device_lost``, nothing resets or retries, and the
    ladder walks to ``cache_only`` within two drains."""
    model, params, train = _setup(seed=2)
    pts = _unique_points(train, 12)
    eng = _engine(model, params, train)
    resets = []
    real_reset = eng._reset_device_state
    eng._reset_device_state = lambda *a, **kw: (resets.append(1),
                                                real_reset(*a, **kw))
    svc = _service(eng, max_batch=3, health=HealthConfig(min_evidence=4))
    faults = [inject.Fault("engine.dispatch_flat", at=k,
                           kind=taxonomy.DEVICE_LOST) for k in range(8)]
    with inject.active(*faults):
        first = svc.run([Request(int(u), int(i), id=f"a{k}")
                         for k, (u, i) in enumerate(pts[:6])])
        second = svc.run([Request(int(u), int(i), id=f"b{k}")
                          for k, (u, i) in enumerate(pts[6:])])
    assert all(not r.ok and r.reason == taxonomy.DEVICE_LOST
               for r in first + second)
    assert resets == []
    assert svc.health.mode == "cache_only"
    third = svc.run([Request(int(u), int(i)) for u, i in pts[:3]])
    assert all(r.reason == "degraded" for r in third)

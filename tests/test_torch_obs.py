"""The port's observability spine (``fia_tpu_torch/obs``), port against
port: the classes ``TestTrace``, ``TestRegistry``, ``TestExporters``,
``TestDiag`` and ``TestCompilemonMirror`` of ``tests/test_obs.py``
restated on ``fia_tpu_torch.obs``, with the reference's golden files
(``tests/data/obs_perfetto.json``, ``obs_prometheus.txt``): the port's
exporters write the same bytes. The compile mirror is the port's: each
flat-program capture the engine records goes to
``compile.backend_total``, with its seconds in ``compile.backend_us``.

``TestServeChains`` is restated over a traced stream of the port's
service (``fia_tpu_torch.serve``), its JSONL audited and rendered by the
port's ``fia_tpu_torch.cli.obs`` (``audit_chains``, ``last_snapshot``,
``report``, ``trace``); fed the same file, the reference's
``fia_tpu.cli.obs`` prints the same ``report``, ``trace`` and ``prom``
bytes with the same exit codes (the port writes the reference's span and
metrics schema). ``TestChaosOracle`` is restated on the port's
``serve_stream`` scenario. Added here: a traced ``query_many`` returns
the untraced run's scores as equal arrays, and emits the engine's spans.
"""

import hashlib
import json
import os

import numpy as np
import pytest
import torch

from fia_tpu_torch import obs
from fia_tpu_torch.data.dataset import RatingDataset
from fia_tpu_torch.influence.engine import InfluenceEngine
from fia_tpu_torch.models import MF
from fia_tpu_torch.obs.export import (
    perfetto,
    prometheus,
    read_spans,
    span_fields,
)
from fia_tpu_torch.obs.registry import (
    US_BUCKETS,
    Registry,
    percentile_from_snapshot,
)
from fia_tpu_torch.obs.trace import NOOP_SPAN, Tracer, trace_id_for
from fia_tpu_torch.utils import compilemon

torch.set_num_threads(2)

DATA = os.path.join(os.path.dirname(__file__), "data")


@pytest.fixture(autouse=True)
def _clean_obs():
    """Tests share the process-wide TRACER/REGISTRY — start and leave
    each test with tracing off and both stores empty."""
    obs.configure(trace=False)
    obs.TRACER.reset()
    obs.REGISTRY.reset()
    yield
    obs.configure(trace=False)
    obs.TRACER.reset()
    obs.REGISTRY.reset()


# ---------------------------------------------------------------- trace


class TestTrace:
    def test_trace_id_derived_not_random(self):
        want = hashlib.sha1(b"req-7").hexdigest()[:16]
        assert trace_id_for("req-7") == want
        assert trace_id_for("req-7") == trace_id_for("req-7")
        assert len(trace_id_for("x")) == 16

    def test_span_ids_and_nesting(self):
        obs.configure(trace=True)
        with obs.trace("t1"):
            with obs.span("outer", k=1) as a:
                with obs.span("inner") as b:
                    assert b.parent_id == a.span_id
        tid = trace_id_for("t1")
        assert a.span_id == f"{tid}.0"
        assert b.span_id == f"{tid}.1"
        assert a.parent_id is None
        assert a.attrs == {"k": 1}
        # inner finishes (and is collected) before outer
        names = [s.name for s in obs.TRACER.flush()]
        assert names == ["inner", "outer"]

    def test_anonymous_trace_deterministic(self):
        """Two tracers given the same call sequence mint the same ids:
        anonymous traces are seeded from a counter, not a clock."""
        def run():
            tr = Tracer(enabled=True)
            out = []
            with tr.span("solo") as sp:
                out.append(sp.span_id)
            with tr.span("solo") as sp:
                out.append(sp.span_id)
            return out

        a, b = run(), run()
        assert a == b
        assert a[0] != a[1]  # distinct anonymous traces

    def test_disabled_is_noop(self):
        assert not obs.tracing_enabled()
        with obs.span("x", k=1) as sp:
            sp.set(a=2)
            sp.event("mark")
            obs.event("other")
        assert obs.TRACER.flush() == []
        assert obs.TRACER.current_span() is NOOP_SPAN

    def test_retroactive_record(self):
        obs.configure(trace=True)
        tid = trace_id_for("req-9")
        obs.TRACER.record(tid, "serve.request", 10.0, 10.5, seq=0,
                          status="ok")
        obs.TRACER.record(tid, "serve.solver", 10.1, 10.4, seq=1,
                          parent_seq=0, solver="cg")
        root, solver = obs.TRACER.flush()
        assert solver.parent_id == root.span_id
        assert root.t1 - root.t0 == pytest.approx(0.5)
        assert solver.attrs == {"solver": "cg"}

    def test_event_attaches_to_innermost(self):
        obs.configure(trace=True)
        with obs.span("outer"):
            with obs.span("inner") as sp:
                obs.event("mark", n=3)
        assert sp.events[0]["name"] == "mark"
        assert sp.events[0]["n"] == 3


# ------------------------------------------------------------- registry


class TestRegistry:
    def test_series_keys_sort_labels(self):
        r = Registry()
        r.counter("c", b=2, a=1).inc()
        assert "c{a=1,b=2}" in r.snapshot()["counters"]

    def test_instruments(self):
        r = Registry()
        r.counter("n").inc()
        r.counter("n").inc(2)
        g = r.gauge("g")
        g.set(5)
        g.max(3)   # below: no-op
        g.max(9)
        h = r.histogram("h")
        for v in (10, 100, 1000):
            h.observe(v)
        snap = r.snapshot()
        assert snap["counters"]["n"] == 3.0
        assert snap["gauges"]["g"] == 9.0
        assert snap["histograms"]["h"]["count"] == 3
        assert snap["histograms"]["h"]["sum"] == pytest.approx(1110.0)

    def test_snapshot_deterministic_bytes(self):
        def traffic():
            r = Registry()
            r.counter("z.last").inc()
            r.counter("a.first", mode="full").inc(4)
            r.gauge("depth").set(7)
            r.histogram("lat_us", solver="direct").observe(123.0)
            return json.dumps(r.snapshot(), sort_keys=True)

        assert traffic() == traffic()

    def test_percentile_live_matches_snapshot(self):
        r = Registry()
        h = r.histogram("h")
        rng = np.random.default_rng(0)
        for v in rng.uniform(5, 5e5, 200):
            h.observe(float(v))
        snap = r.snapshot()["histograms"]["h"]
        for q in (50, 90, 99):
            assert h.percentile(q) == pytest.approx(
                percentile_from_snapshot(snap, q))


# ---------------------------------------------- exporters + golden files


def _fixed_spans():
    """A tiny deterministic span stream (fixed timestamps) — the input
    behind the tests/data/ exporter goldens."""
    tr = Tracer(enabled=True)
    t = 1_700_000_000.0
    a, b = trace_id_for("req-a"), trace_id_for("req-b")
    sp = tr.record(a, "serve.request", t, t + 0.004, seq=0, status="ok")
    sp.events.append({"name": "mark", "dt_us": 10.0})
    tr.record(a, "serve.solver", t + 0.001, t + 0.003, seq=1,
              parent_seq=0, solver="direct")
    tr.record(b, "serve.request", t + 0.002, t + 0.005, seq=0,
              status="rejected")
    return [span_fields(s) for s in tr.flush()]


def _fixed_snapshot():
    """A small deterministic registry snapshot for the Prometheus
    golden."""
    r = Registry()
    r.counter("serve.requests_total", mode="full", status="ok").inc(3)
    r.gauge("serve.queue_depth").set(2)
    h = r.histogram("serve.queue_wait_us", mode="full")
    for v in (40.0, 700.0, 90_000.0):
        h.observe(v)
    return r.snapshot()


class TestExporters:
    def test_jsonl_roundtrip(self, tmp_path):
        spans = _fixed_spans()
        path = tmp_path / "s.jsonl"
        with open(path, "w") as fh:
            fh.write(json.dumps({"event": "serve.rollup"}) + "\n")
            for d in spans:
                fh.write(json.dumps({"event": "obs.span", **d}) + "\n")
            fh.write('{"event": "obs.span", "torn')  # killed process
        got = read_spans(str(path))
        assert [
            {k: v for k, v in d.items() if k != "event"} for d in got
        ] == spans

    def test_perfetto_golden(self):
        with open(os.path.join(DATA, "obs_perfetto.json")) as fh:
            assert perfetto(_fixed_spans()) == json.load(fh)

    def test_perfetto_shape(self):
        doc = perfetto(_fixed_spans())
        dur = [e for e in doc["traceEvents"] if e["ph"] == "X"]
        assert len(dur) == 3
        # one timeline row per trace, ts normalised to the first span
        assert len({e["tid"] for e in dur}) == 2
        assert min(e["ts"] for e in dur) == 0

    def test_prometheus_golden(self):
        with open(os.path.join(DATA, "obs_prometheus.txt")) as fh:
            assert prometheus(_fixed_snapshot()) == fh.read()

    def test_prometheus_histogram_is_cumulative(self):
        text = prometheus(_fixed_snapshot())
        # +inf bucket count equals _count
        assert 'le="+Inf"} 3' in text
        assert "serve_queue_wait_us_count{mode=\"full\"} 3" in text


# ------------------------------------------------- diag + compile mirror


class TestDiag:
    def test_stderr_counter_and_span_event(self, capsys):
        obs.configure(trace=True)
        with obs.span("stage") as sp:
            obs.diag("chan", "something happened", code=7)
        err = capsys.readouterr().err
        assert "[chan] something happened code=7" in err
        snap = obs.REGISTRY.snapshot()
        assert snap["counters"]["diag_total{channel=chan}"] == 1.0
        assert any(e["name"] == "diag.chan" for e in sp.events)


class TestCompilemonMirror:
    def test_backend_compile_mirrors_into_registry(self):
        """A capture the engine records (with its seconds, as on the
        card) is counted, observed and attached to the active span; the
        build count the no-recapture checks read moves by one."""
        obs.configure(trace=True)
        before = compilemon.count()
        with obs.span("engine.precompile") as sp:
            compilemon.record(0.25)
        assert compilemon.count() == before + 1
        snap = obs.REGISTRY.snapshot()
        assert snap["counters"]["compile.backend_total"] == 1.0
        assert snap["histograms"]["compile.backend_us"]["count"] == 1
        ev = [e for e in sp.events if e["name"] == "compile.backend"]
        assert ev and ev[0]["dur_us"] == pytest.approx(0.25e6)


# ---------------------------------------------- the engine under tracing

U, I, K = 30, 20, 4


def _engine():
    rng = np.random.default_rng(0)
    x = np.stack([rng.integers(0, U, 400), rng.integers(0, I, 400)],
                 axis=1).astype(np.int32)
    y = rng.integers(1, 6, 400).astype(np.float32)
    model = MF(U, I, K, 1e-2)
    params = model.init_params(torch.Generator().manual_seed(0))
    return InfluenceEngine(model, params, RatingDataset(x, y),
                           damping=1e-3, device="cpu"), x


def test_traced_query_many_equals_untraced_and_emits_engine_spans():
    """Tracing on changes no result byte, and the flat path's spans and
    counters appear: one ``engine.dispatch_flat`` a batch, the
    ``engine.precompile`` span around an armed geometry, and each
    dispatch an AOT hit or miss."""
    eng, x = _engine()
    pts = np.unique(x, axis=0)[:10].astype(np.int64)
    base = eng.query_many(pts, batch_queries=4)
    want = eng.query_batch(pts[:3])
    obs.REGISTRY.reset()
    obs.configure(trace=True)
    traced_eng, _ = _engine()
    traced_eng.precompile_flat([traced_eng.flat_geometry(pts[:4])])
    with obs.trace("qm"):
        got = traced_eng.query_many(pts, batch_queries=4)
    with obs.trace("qb"):
        one = traced_eng.query_batch(pts[:3])
    for g, b in zip(got, base):
        assert np.array_equal(g.counts, b.counts)
        assert np.array_equal(g.ihvp, b.ihvp)
        for t in range(len(g.counts)):
            assert np.array_equal(g.scores_of(t), b.scores_of(t))
    for t in range(3):
        assert np.array_equal(one.scores_of(t), want.scores_of(t))
    spans = [span_fields(s) for s in obs.TRACER.flush()]
    names = [s["name"] for s in spans]
    assert names.count("engine.dispatch_flat") == 4  # 3 batches + 1 query
    assert names.count("engine.precompile") == 1
    query = [s for s in spans if s["name"] == "engine.query"]
    assert len(query) == 1
    assert query[0]["attrs"]["solver_requested"] == "direct"
    assert query[0]["attrs"]["n"] == 3
    # the query's dispatch is its child, in the same derived trace
    (disp,) = [s for s in spans if s["name"] == "engine.dispatch_flat"
               and s["trace"] == query[0]["trace"]]
    assert disp["parent"] == query[0]["span"]
    assert query[0]["trace"] == trace_id_for("qb")
    pre = [s for s in spans if s["name"] == "engine.precompile"][0]
    assert pre["attrs"] == {"compiled": 1, "cached": 0}
    snap = obs.REGISTRY.snapshot()["counters"]
    hits, misses = (snap.get(f"engine.aot_{k}", 0) for k in ("hits",
                                                             "misses"))
    assert hits + misses == 4 and hits >= 1
    assert snap["engine.queries_total{solver=direct}"] == 1
    assert json.loads(json.dumps(perfetto(spans)))["traceEvents"]
    assert "engine_queries_total" in prometheus(obs.REGISTRY.snapshot())


# ------------------------------------------------------------- timing


class TestTiming:
    """``utils/timing.py`` on the CPU (no fence needed there; on the
    card it synchronises the outputs' devices)."""

    def test_timer_sections_are_spans(self):
        from fia_tpu_torch.utils.timing import Timer

        obs.configure(trace=True)
        t = Timer(span_prefix="bench")
        with t("solve", fence=True) as sec:
            out = sec.fence(torch.ones(3) * 2)
        with t("solve"):
            pass
        assert torch.equal(out, torch.full((3,), 2.0))
        assert set(t.report()) == {"solve"} and t.report()["solve"] >= 0
        assert [s.name for s in obs.TRACER.flush()] == ["bench.solve"] * 2

    def test_fenced_time_returns_the_result(self):
        from fia_tpu_torch.utils.timing import fenced_time

        out, secs = fenced_time(lambda a: {"x": (a + 1,)}, torch.zeros(2))
        assert torch.equal(out["x"][0], torch.ones(2)) and secs >= 0

    def test_profile_trace_writes_a_chrome_trace(self, tmp_path):
        from fia_tpu_torch.utils.timing import profile_trace

        with profile_trace(str(tmp_path / "prof")):
            torch.ones(64) @ torch.ones(64)
        with open(tmp_path / "prof" / "trace.json") as fh:
            assert json.load(fh)["traceEvents"]
        with profile_trace(None):  # off: a no-op
            pass


# ------------------------------------------------------------- serving


def _serve(pts, metrics_path):
    from fia_tpu_torch.serve import InfluenceService, Request, ServeConfig

    eng, _ = _engine()
    svc = InfluenceService(engine=eng, config=ServeConfig(
        disk_cache=False, metrics_path=metrics_path))
    out = []
    for i, (u, it) in enumerate(pts):
        svc.submit(Request(user=int(u), item=int(it), id=f"q{i}"))
    out.append(svc.submit(Request(user=-1, item=0, id="bad")))
    out.extend(svc.drain())
    svc.close()
    return out


@pytest.fixture(scope="module")
def traced_stream(tmp_path_factory):
    """One traced stream of the port's service (plus its untraced twin)
    shared by the chain/identity/CLI tests below."""
    _, x = _engine()
    pts = np.unique(x, axis=0)[:8].astype(np.int64)
    ref = _serve(pts, None)
    path = str(tmp_path_factory.mktemp("obs") / "serve.jsonl")
    obs.TRACER.reset()
    obs.REGISTRY.reset()
    obs.configure(trace=True)
    try:
        got = _serve(pts, path)
    finally:
        obs.configure(trace=False)
        obs.TRACER.reset()
    return {"path": path, "ref": ref, "got": got, "n_ok": len(pts)}


class TestServeChains:
    def test_payload_invariance(self, traced_stream):
        """Tracing on changes zero response bytes."""
        by_id = {r.id: r for r in traced_stream["ref"]}
        n_ok = 0
        for r in traced_stream["got"]:
            b = by_id[r.id]
            assert r.ok == b.ok
            if r.ok:
                n_ok += 1
                assert np.array_equal(np.asarray(r.scores),
                                      np.asarray(b.scores))
                assert np.array_equal(np.asarray(r.related),
                                      np.asarray(b.related))
        assert n_ok == traced_stream["n_ok"]

    def test_chains_complete_from_file_alone(self, traced_stream):
        from fia_tpu_torch.cli import obs as cli_obs

        spans = read_spans(traced_stream["path"])
        audit = cli_obs.audit_chains(spans)
        assert audit["incomplete"] == 0
        assert audit["ok_complete"] == traced_stream["n_ok"]
        assert audit["rejected_complete"] == 1

    def test_trace_ids_derive_from_request_ids(self, traced_stream):
        spans = read_spans(traced_stream["path"])
        roots = {s["trace"]: s for s in spans
                 if s["name"] == "serve.request"}
        want = {trace_id_for(f"req-q{i}")
                for i in range(traced_stream["n_ok"])}
        want.add(trace_id_for("req-bad"))
        assert set(roots) == want

    def test_solver_attr_matches_engine(self, traced_stream):
        spans = read_spans(traced_stream["path"])
        solver = [s for s in spans if s["name"] == "serve.solver"]
        assert solver
        assert {s["attrs"]["solver"] for s in solver} == {"direct"}

    def test_seq_layout(self, traced_stream):
        """Span ids encode the documented seq layout: root .0, solver
        .5, rejected chains stop at .2."""
        spans = read_spans(traced_stream["path"])
        ok_tid = trace_id_for("req-q0")
        chain = sorted((s["span"], s["name"]) for s in spans
                       if s["trace"] == ok_tid)
        assert chain == [
            (f"{ok_tid}.0", "serve.request"),
            (f"{ok_tid}.1", "serve.admit"),
            (f"{ok_tid}.2", "serve.queue"),
            (f"{ok_tid}.3", "serve.batch"),
            (f"{ok_tid}.4", "serve.dispatch"),
            (f"{ok_tid}.5", "serve.solver"),
        ]
        bad_tid = trace_id_for("req-bad")
        assert len([s for s in spans if s["trace"] == bad_tid]) == 3

    def test_metrics_snapshot_on_close(self, traced_stream):
        from fia_tpu_torch.cli import obs as cli_obs

        snap = cli_obs.last_snapshot(traced_stream["path"])
        assert snap is not None
        key = "serve.requests_total{mode=full,status=ok}"
        assert snap["counters"][key] == traced_stream["n_ok"]
        assert snap["buckets_us"] == list(US_BUCKETS)
        hist = [k for k in snap["histograms"]
                if k.startswith("serve.solve_by_solver_us")]
        assert hist == ["serve.solve_by_solver_us{solver=direct}"]

    def test_cli_report_exit_codes(self, traced_stream, tmp_path, capsys):
        from fia_tpu_torch.cli import obs as cli_obs

        assert cli_obs.main(["report", traced_stream["path"]]) == 0
        out = capsys.readouterr().out
        assert "incomplete: 0" in out
        assert "solver=direct" in out
        broken = tmp_path / "broken.jsonl"
        with open(traced_stream["path"]) as src, open(broken, "w") as dst:
            for line in src:
                if '"name": "serve.solver"' not in line:
                    dst.write(line)
        assert cli_obs.main(["report", str(broken)]) == 1

    def test_cli_trace_export(self, traced_stream, tmp_path):
        from fia_tpu_torch.cli import obs as cli_obs

        out = tmp_path / "t.json"
        assert cli_obs.main(["trace", traced_stream["path"],
                                 "--last", "2", "--out", str(out)]) == 0
        doc = json.load(open(out))
        dur = [e for e in doc["traceEvents"] if e["ph"] == "X"]
        assert dur
        assert len({e["tid"] for e in dur}) == 2

    @pytest.mark.parametrize("argv", [
        ["report"], ["trace"], ["trace", "--last", "2"], ["prom"],
        ["report", "<broken>"], ["prom", "<empty>"], ["trace", "<empty>"],
    ], ids=["report", "trace", "trace-last", "prom", "report-broken",
            "prom-empty", "trace-empty"])
    def test_cli_output_is_the_references(self, traced_stream, tmp_path,
                                          capsys, argv):
        """Fed the same JSONL, the port's and the reference's
        ``cli.obs`` print the same bytes (stdout and stderr) and exit
        with the same code."""
        from fia_tpu.cli import obs as ref_cli_obs
        from fia_tpu_torch.cli import obs as cli_obs

        path = traced_stream["path"]
        if "<broken>" in argv:
            path = str(tmp_path / "broken.jsonl")
            with open(traced_stream["path"]) as src, open(path, "w") as dst:
                for line in src:
                    if '"name": "serve.solver"' not in line:
                        dst.write(line)
        elif "<empty>" in argv:
            path = str(tmp_path / "empty.jsonl")
            open(path, "w").close()
        args = [argv[0], path] + [a for a in argv[1:] if "<" not in a]
        outs = []
        for cli in (cli_obs, ref_cli_obs):
            capsys.readouterr()
            rc = cli.main(list(args))
            outs.append((rc, *capsys.readouterr()))
        assert outs[0] == outs[1]
        if argv[0] == "trace" and outs[0][0] == 0:
            assert json.loads(outs[0][1])["traceEvents"]


class TestChaosOracle:
    def test_tracing_preserves_chaos_outcome_bytes(self, tmp_path):
        """The chaos golden-run byte contract survives tracing: the
        serve_stream scenario (overload + cache tiers + micro-batched
        dispatch) produces an identical outcome payload — statuses,
        reasons, score arrays — with the tracer on."""
        from fia_tpu_torch.chaos.scenarios import ServeStreamScenario

        def run(traced, sub):
            obs.TRACER.reset()
            obs.configure(trace=traced)
            try:
                return ServeStreamScenario(device="cpu").run(
                    str(tmp_path / sub), [])
            finally:
                obs.configure(trace=False)
                obs.TRACER.reset()

        off, on = run(False, "off"), run(True, "on")
        assert set(off) == set(on)
        for k in off:
            if isinstance(off[k], np.ndarray):
                assert np.array_equal(off[k], on[k]), k
            else:
                assert off[k] == on[k], k

    def test_chaos_stream_jsonl_through_cli_obs(self, tmp_path, capsys):
        """A traced ``serve_stream`` run writes its JSONL
        (``metrics_path``): every request chain complete, and both
        packages' ``cli.obs`` render it to the same bytes."""
        from fia_tpu.cli import obs as ref_cli_obs
        from fia_tpu_torch.chaos.scenarios import ServeStreamScenario
        from fia_tpu_torch.cli import obs as cli_obs

        scen = ServeStreamScenario(device="cpu")
        scen.metrics_path = str(tmp_path / "stream.jsonl")
        obs.configure(trace=True)
        try:
            out = scen.run(str(tmp_path / "run"), [])
        finally:
            obs.configure(trace=False)
            obs.TRACER.reset()
        n_ok = sum(str(v).startswith("ok/") for k, v in out.items()
                   if k.endswith(":status"))
        audit = cli_obs.audit_chains(read_spans(scen.metrics_path))
        assert audit["incomplete"] == 0 and audit["ok_complete"] == n_ok
        for argv in (["report"], ["trace"], ["prom"]):
            got = []
            for cli in (cli_obs, ref_cli_obs):
                capsys.readouterr()
                got.append((cli.main([argv[0], scen.metrics_path]),
                            *capsys.readouterr()))
            assert got[0] == got[1] and got[0][0] == 0, argv

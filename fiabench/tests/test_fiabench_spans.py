"""The readers of the engine's spans: the span medians and the fetch
mean, the hot path's captures, the eager warm-ups' and the records'
seconds, and the split of each card's idle time by the program step the
host was in (``fiabench/idlesplit.py``), on small synthetic traces whose
shares are worked out by hand; and ``spanstat.py``'s grouping of a run's
spans."""

import pytest

from fia_tpu_torch import obs
from fiabench import cell, data, idlesplit, reference, spanstat
from fiabench.devtrace import Trace
from fiabench.spec import metric_reader

IDLE = ("device.idle_dispatch_pct", "device.idle_finalize_pct",
        "device.idle_outside_pct")
SPANS = ("engine.upload_ms", "engine.replay_ms", "engine.fetch_ms",
         "engine.stitch_ms", "engine.plan_ms")
SETUP = ("setup.warmup_s", "setup.record_s")
NEW = IDLE + SPANS + SETUP + ("engine.capture_ms",)


def _ev(name, cat, a, b, card=0):
    return {"ph": "X", "name": name, "cat": cat, "ts": a, "dur": b - a,
            "args": {"device": card}}


def _job(card1=None):
    """One job on card 0, the host's ranges in microseconds:

    - kernels [0, 10], [30, 40], [70, 85], [95, 100]: idle [10, 30],
      [40, 70], [85, 95] (60 of the window's 100);
    - ``engine.query_many`` [5, 90] over dispatches [5, 20], [25, 35] and
      a finalize [50, 80], with a runtime call inside it [55, 60];

    so dispatch 10 + 5, finalize 20, the loop 5 + 10 + 5, outside 5.
    ``card1``: a second card's kernel intervals."""
    evs = [_ev("k", "kernel", a, b) for a, b in
           ((0, 10), (30, 40), (70, 85), (95, 100))]
    evs += [_ev("engine.query_many", "user_annotation", 5, 90),
            _ev("engine.dispatch_flat", "user_annotation", 5, 20),
            _ev("engine.plan", "user_annotation", 6, 9),
            _ev("engine.dispatch_flat", "user_annotation", 25, 35),
            _ev("engine.finalize_flat", "user_annotation", 50, 80),
            _ev("cudaMemcpyAsync", "cuda_runtime", 55, 60)]
    for a, b in card1 or ():
        evs.append(_ev("k", "kernel", a, b, card=1))
    return Trace(evs)


def _read(name, ctx):
    return metric_reader(name)(ctx)


def _ctx(tr=None, spans=(), pre=None):
    return {"trace": tr, "spans": list(spans),
            "precompile": pre or {"seconds": 2.0}}


def test_idle_split_by_hand():
    shares = idlesplit.split(_job())
    assert shares == {"dispatch": pytest.approx(15.0),
                      "finalize": pytest.approx(20.0),
                      "loop": pytest.approx(20.0),
                      "outside": pytest.approx(5.0)}
    ctx = _ctx(_job())
    assert [_read(n, ctx) for n in IDLE] == [
        pytest.approx(15.0), pytest.approx(20.0), pytest.approx(5.0)]


@pytest.mark.parametrize("card1", [None, [(0, 100)], [(0, 3), (50, 52)],
                                   [(12, 13), (60, 99)]])
def test_shares_and_the_loop_make_up_the_idle_share(card1):
    """``device.idle_pct`` is the three shares plus the loop's own, to
    1e-9, whatever the cards run."""
    tr = _job(card1)
    ctx = _ctx(tr)
    total = _read("device.idle_pct", ctx)
    loop = idlesplit.split(tr)["loop"]
    assert sum(_read(n, ctx) for n in IDLE) + loop == pytest.approx(
        total, abs=1e-9)
    assert sum(_read(n, ctx) for n in IDLE) <= total + 1e-9


def test_two_cards_are_averaged():
    # card 1 busy all through: half of card 0's shares
    assert idlesplit.split(_job([(0, 100)]))["finalize"] == pytest.approx(
        10.0)


def test_the_innermost_step_takes_the_gap():
    tr = Trace([_ev("k", "kernel", 0, 1), _ev("k", "kernel", 99, 100),
                _ev("engine.query_many", "user_annotation", 0, 100),
                _ev("engine.dispatch_flat", "user_annotation", 10, 60),
                _ev("engine.finalize_flat", "user_annotation", 20, 30)])
    shares = idlesplit.split(tr)
    assert shares["finalize"] == pytest.approx(10.0)
    assert shares["dispatch"] == pytest.approx(40.0)
    assert shares["loop"] == pytest.approx(48.0)
    assert shares["outside"] == pytest.approx(0.0)


def test_span_medians_and_the_fetch_mean():
    """The span readers take the median, so a profiled outlier (the
    40 ms upload) does not move them; the fetch reader takes the mean, so
    a job's one fetch that waits for the card (16 ms) counts."""
    spans = [("engine.upload", 1.0, 1.002), ("engine.upload", 2.0, 2.003),
             ("engine.upload", 3.0, 3.04),
             ("engine.replay", 1.0, 1.001), ("engine.fetch", 3.0, 3.016),
             ("engine.fetch", 4.0, 4.0005), ("engine.fetch", 5.0, 5.0005),
             ("engine.fetch", 6.0, 6.001),
             ("engine.stitch", 4.0, 4.0005), ("engine.plan", 5.0, 5.0002),
             ("engine.plan", 6.0, 6.0004), ("engine.dispatch_flat", 0, 9)]
    ctx = _ctx(spans=spans)
    assert [_read(n, ctx) for n in SPANS] == [
        pytest.approx(3.0), pytest.approx(1.0), pytest.approx(4.5),
        pytest.approx(0.5), pytest.approx(0.3)]


def test_captures_in_the_window_are_summed():
    job = ("engine.query_many", 0.0, 1.0)
    assert _read("engine.capture_ms", _ctx(spans=[job])) == 0.0
    caps = [("engine.capture", 2.0, 2.5), ("engine.capture", 3.0, 3.25)]
    assert _read("engine.capture_ms", _ctx(spans=[job] + caps)) == (
        pytest.approx(750.0))


def test_warmup_and_record_seconds():
    ctx = _ctx(pre={"seconds": 9.0, "warmup_s": 7.5, "record_s": 0.5})
    assert [_read(n, ctx) for n in SETUP] == [7.5, 0.5]


@pytest.mark.parametrize("name", NEW)
def test_nothing_to_read_reads_none(name):
    """No trace, no spans, a precompile without the warm-ups' and the
    records' counts (a program from before them), or a trace without the
    program's ranges: every new reader returns None."""
    assert _read(name, _ctx()) is None
    bare = Trace([_ev("k", "kernel", 0, 10), _ev("k", "kernel", 50, 60),
                  _ev("cudaGraphLaunch", "cuda_runtime", 20, 30)])
    assert _read(name, _ctx(bare)) is None


def test_a_traced_cpu_run_reads_the_spans(tiny):
    """A tiny traced run on the CPU reports the five span readers and no
    capture in the window; the CPU captures no graph and has no device
    trace, so the warm-ups, the records and the idle shares read nothing
    there."""
    out = cell.run(tiny, "mf-k16-ml1m.uniform4k", 2 ** 31 + 9, 0.5, True,
                   "cpu")
    assert out["correct"]
    got = out["metrics"]
    for name in SPANS:
        assert got[name]["value"] > 0 and got[name]["unit"] == "ms"
    assert got["engine.capture_ms"] == {"value": 0.0, "unit": "ms"}
    for name in IDLE + SETUP:
        assert name not in got


def test_spanstat_groups_a_runs_spans(tiny):
    """``spanstat.py``'s grouping of the spans of four jobs of a tiny
    cell on the CPU: the first two left out, each step split into the
    first batch's and the rest's."""
    cfg = tiny.config("mf-k16-ml1m")
    traffic = tiny.traffic("uniform4k")
    ratings = data.load_ratings(cfg)
    jobs = data.job_pool(ratings, traffic)
    eng = cell._engine(cfg, ratings, reference.make_params(cfg, 7, "cpu"),
                       1, "cpu")
    obs.configure(trace=True)
    try:
        for job in jobs[:4]:
            eng.query_many(job, batch_queries=int(traffic["batch_queries"]),
                           window=int(traffic["window"]))
        spans = obs.TRACER.flush()
    finally:
        obs.configure(trace=False)
    got = spanstat.stats(spans)
    assert got["job"]["n"] == 2 and got["caller_between_jobs"]["n"] == 1
    batches = len(jobs[0]) // int(traffic["batch_queries"])
    for step in ("engine.dispatch_flat", "engine.plan", "engine.upload",
                 "engine.replay", "engine.finalize_flat", "engine.fetch",
                 "engine.stitch"):
        assert got[f"{step}|first"]["n"] == 2
        assert got[f"{step}|rest"]["n"] == 2 * (batches - 1)
    assert got["job"]["median"] > got["engine.fetch|first"]["median"] > 0

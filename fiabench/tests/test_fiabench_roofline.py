"""The roofline and MFU arithmetic on hand-counted shapes, and the
reduction of a profiler trace to busy time, gaps and top operations."""

import pytest

from fiabench import roofline as R
from fiabench.devtrace import Trace, union

MF = {"family": "mf", "embedding_size": 16, "num_users": 6040,
      "num_items": 3706}
NCF = dict(MF, family="ncf")


def test_bound_takes_the_larger_side():
    assert R.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert R.bound_s(0, 67e12) == pytest.approx(1.0)
    assert R.bound_s(3.35e12, 134e12) == pytest.approx(2.0)


def test_mf_scores_bytes():
    ln = R.Launch(t_pad=1024, s_pad=327680, queries=1024, rows=300000,
                  user_rows=150000, item_rows=150000, both_rows=0)
    # tx 8 B a query, B (d + 2) floats a query; t 4, rel_x 8, e 4, wv 4
    # and the score 4 B a flat row; P and Q whole
    nb = 1024 * 8 + 1024 * 36 * 4 + 327680 * 24 + (6040 + 3706) * 16 * 4
    assert R.mf_scores_s(MF, ln) == pytest.approx(nb / 3.35e12)


def test_ncf_scores_operations():
    ln = R.Launch(t_pad=64, s_pad=2048, queries=64, rows=1000,
                  user_rows=510, item_rows=500, both_rows=10)
    k, k2 = 16, 8
    fma = 990 * k * k + 1000 * 2 * k * k2 + 1010 * 2 * k + 64 * 4 * k * k
    flops = 2 * fma + 5 * 1000 + 64 * 2 * k
    nb = (64 * 8 + 2048 * 24 + 64 * 66 * 4
          + 4 * ((6040 + 3706) * 2 * 16 + 32 * 16 + 16 + 16 * 8 + 8 + 24
                 + 1))
    assert R.ncf_scores_s(NCF, ln) == pytest.approx(
        max(nb / 3.35e12, flops / 67e12))


def test_segment_and_solve():
    ln = R.Launch(t_pad=1024, s_pad=393216, queries=1000, rows=400000,
                  user_rows=0, item_rows=0, both_rows=0)
    d = 34
    rows = 393216  # the rows past the flat pad are not read
    nb = rows * (d * 4 + 8) + 1025 * 8 + 1024 * d * d * 4 + 1024 * 4
    assert R.segment_hessian_s(MF, ln, d) == pytest.approx(
        max(nb / 3.35e12, rows * d * (d + 1) / 67e12))
    assert R.solve_s(MF, ln, d) == pytest.approx(max(
        1024 * (d * d + 3 * d) * 4 / 3.35e12,
        1024 * (2 * d ** 3 / 3 + 2 * d * d) / 67e12))


def test_query_flops():
    d = 34
    per_row = (4 * 16 + 6) + d * (d + 1) + 2 * d + 4
    assert R.query_flops(MF, 100, 2, d) == pytest.approx(
        100 * per_row + 2 * (2 * d ** 3 / 3 + 2 * d * d))


def _ev(name, cat, ts, dur, card=0):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "args": {"device": card}}


def test_trace_reduction():
    tr = Trace([
        _ev("job", "user_annotation", 0, 100),
        _ev("cudaGraphLaunch", "cuda_runtime", 10, 5),
        _ev("k1", "kernel", 20, 30), _ev("k2", "kernel", 40, 20),
        _ev("k1", "kernel", 80, 10), _ev("copy", "gpu_memcpy", 90, 5, 1),
        {"ph": "i", "name": "marker", "ts": 5},
    ])
    assert union([(3, 4), (1, 2), (2, 3)]) == [(1, 4)]
    assert tr.window_s == pytest.approx(100e-6)
    assert tr.cards() == [0, 1]
    assert tr.busy_s(0) == pytest.approx(50e-6)  # [20, 60] and [80, 90]
    assert tr.seconds(("k1",)) == pytest.approx(40e-6)
    assert tr.top_ops(2) == [["k1", pytest.approx(40e-6)],
                             ["k2", pytest.approx(20e-6)]]
    gaps = tr.idle_gaps(3)
    assert gaps[0] == ["job", pytest.approx(90e-6)]  # card 1: 0 to 90
    assert [g[1] for g in gaps[1:]] == [pytest.approx(20e-6)] * 2

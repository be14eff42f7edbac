"""The port's certified ``sampled`` rung (``solver="sampled"``,
``influence/sampled.py``, ``kernels/certificate.py``) on the CPU.

Restates ``tests/test_sampled.py`` port against port, on the reference's
setup and params carried across (MF, U = 12, I = 10, k = 3, 600 rows):

- at a cap above every related count the rung is BITWISE the port's own
  direct path with every bound exactly 0 (the reference's own
  ``test_exact_at_cap_bitwise`` fails against itself; ROADMAP Queue C);
- the certificate holds: |sampled − direct| ≤ err_bound + 1e-6;
- a query's scores and bound are the same bits alone and in a batch;
- over-tolerance queries come back bitwise the ``lissa`` engine's, the
  rest keep their sampled bytes and bounds;
- a classified fault degrades the batch; ``approx_sibling``.

And against the reference: ``sample_weights`` byte for byte; the plain
certificate against ``segment_sample_std`` and the reference's maxima on
the same inputs; the sampled rung against the reference's sampled rung on
the same samples (MF and NCF, and MF on ``tiny_splits`` at the direct
path's bar there, ROADMAP Queue C); a non-finite h on an unsampled row.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fia_tpu.data.dataset import RatingDataset as RefDataset
from fia_tpu.influence import sampled as ref_sampled
from fia_tpu.influence.engine import InfluenceEngine as RefEngine
from fia_tpu.models import MF as RefMF
from fia_tpu.models import NCF as RefNCF
from fia_tpu_torch.data.dataset import RatingDataset
from fia_tpu_torch.influence import sampled as sampled_mod
from fia_tpu_torch.influence.engine import InfluenceEngine, _concat_results
from fia_tpu_torch.influence.kernels import certificate as kcert
from fia_tpu_torch.models import MF, NCF, params_from_numpy
from fia_tpu_torch.reliability import inject, sites, taxonomy
from fia_tpu_torch.reliability import policy as rpolicy
from fia_tpu_torch.utils import compilemon

torch.set_num_threads(2)

U, I, K = 12, 10, 3
WD = 1e-2
DAMP = 1e-3
CAP = 8  # far below the ~100 related rows per pair at n = 600
# the rung against the reference's on the same samples: the direct path's
# bars (scores rtol 2e-5 / atol 1e-6; rtol 1e-4 where the blocks are
# ill-conditioned, test_torch_engine.py's TINY_RTOL). MF's sampled blocks
# here (8 rows of 10 dims, damping 1e-3) reach cond ≈ 2.5e2 (measured),
# so a float32 LU carries ~cond·eps ≈ 1.5e-5 normwise (measured: port vs
# a float64 solve of the same H 1.4e-5, reference 7.2e-6), and a score
# with cancellation (2e g·x + reg_dot) up to 8e-5 relative: MF's bar is
# rtol 1e-4 on both inputs. NCF's blocks reach cond 38 and meet RTOL. The
# bound is a product of σ̂ (squared deviations summed in another order),
# λ_min (another eigensolver) and the maxima: rtol 1e-4 (measured 1.9e-5)
RTOL, ATOL = 2e-5, 1e-6
TINY_RTOL = 1e-4
BOUND_RTOL = 1e-4
# the plain certificate against segment_sample_std: two float32 orders of
# the same sums (σ̂ from up to ~100 squared deviations)
CERT_RTOL = 1e-5


def _setup(seed=0, n=600):
    rng = np.random.default_rng(seed)
    x = np.stack([rng.integers(0, U, n), rng.integers(0, I, n)],
                 axis=1).astype(np.int32)
    y = rng.integers(1, 6, n).astype(np.float32)
    ref_model = RefMF(U, I, K, WD)
    arrays = jax.tree_util.tree_map(
        np.asarray, ref_model.init_params(jax.random.PRNGKey(seed)))
    return ref_model, arrays, x, y


def _engine(model, params, x, y, **kw):
    kw.setdefault("damping", DAMP)
    kw.setdefault("lissa_depth", 30)
    return InfluenceEngine(model, params, RatingDataset(x, y), device="cpu",
                           **kw)


def _points(x, n):
    uniq = np.unique(x, axis=0)
    assert len(uniq) >= n
    return uniq[:n].astype(np.int64)


@pytest.fixture(scope="module")
def workload():
    ref_model, arrays, x, y = _setup()
    model = MF(U, I, K, WD)
    params = params_from_numpy(model, arrays, "cpu")
    return model, params, x, y, _points(x, 6), ref_model, arrays


def _same_bytes(a, b):
    return np.asarray(a).tobytes() == np.asarray(b).tobytes()


class TestEstimator:
    def test_exact_at_cap_bitwise(self, workload):
        model, params, x, y, pts, *_ = workload
        samp = _engine(model, params, x, y, solver="sampled",
                       sampled_cap=10**6)
        ref = _engine(model, params, x, y, solver="direct")
        res, res_ref = samp.query_batch(pts), ref.query_batch(pts)
        assert res.approx and res.err_bound is not None
        assert np.all(np.asarray(res.err_bound) == 0.0)
        for t in range(len(pts)):
            assert _same_bytes(res.scores_of(t), res_ref.scores_of(t)), t
        assert _same_bytes(res.ihvp, res_ref.ihvp)

    def test_certificate_honored_vs_direct(self, workload):
        model, params, x, y, pts, *_ = workload
        samp = _engine(model, params, x, y, solver="sampled",
                       sampled_cap=CAP)
        ref = _engine(model, params, x, y, solver="direct")
        res, res_ref = samp.query_batch(pts), ref.query_batch(pts)
        eb = np.asarray(res.err_bound)
        assert np.all(eb >= 0.0) and float(eb.max()) > 0.0
        for t in range(len(pts)):
            diff = float(np.max(np.abs(res.scores_of(t)
                                       - res_ref.scores_of(t))))
            assert diff <= float(eb[t]) + 1e-6, (t, diff, eb[t])

    def test_per_pair_determinism_across_batches(self, workload):
        model, params, x, y, pts, *_ = workload
        samp = _engine(model, params, x, y, solver="sampled",
                       sampled_cap=CAP)
        res = samp.query_batch(pts)
        for t in range(len(pts)):
            solo = samp.query_batch(pts[t:t + 1])
            assert _same_bytes(solo.scores_of(0), res.scores_of(t)), t
            assert _same_bytes(solo.err_bound[:1], res.err_bound[t:t + 1]), t

    def test_query_many_any_split_bitwise(self, workload):
        model, params, x, y, *_ = workload
        pts = _points(x, 23)
        samp = _engine(model, params, x, y, solver="sampled",
                       sampled_cap=CAP)
        whole = samp.query_batch(pts)
        for bq in (23, 7, 4):
            parts = samp.query_many(pts, batch_queries=bq)
            got = _concat_results(parts)
            assert _same_bytes(got._packed, whole._packed), bq
            assert _same_bytes(got.err_bound, whole.err_bound), bq
            assert got.approx


class TestSampleWeights:
    def test_exhaustive_below_cap(self):
        pairs = np.asarray([[1, 2], [3, 4]], np.int64)
        counts = np.asarray([3, 5])
        ws, m = sampled_mod.sample_weights(pairs, counts, 12, cap=8)
        assert m.tolist() == [3, 5]
        assert np.all(ws[:8] == 1.0) and np.all(ws[8:] == 0.0)

    def test_horvitz_thompson_weights(self):
        pairs = np.asarray([[1, 2]], np.int64)
        counts = np.asarray([40])
        ws, m = sampled_mod.sample_weights(pairs, counts, 48, cap=10)
        assert m.tolist() == [10]
        picked = np.flatnonzero(ws)
        assert len(picked) == 10 and np.all(picked < 40)
        assert np.allclose(ws[picked], 4.0)
        assert float(ws.sum()) == pytest.approx(40.0)

    def test_sample_keyed_on_pair_not_position(self):
        pairs2 = np.asarray([[9, 9], [1, 2]], np.int64)
        counts2 = np.asarray([40, 40])
        ws2, _ = sampled_mod.sample_weights(pairs2, counts2, 80, cap=10)
        ws1, _ = sampled_mod.sample_weights(pairs2[1:], counts2[1:], 40,
                                            cap=10)
        assert np.array_equal(np.flatnonzero(ws2[40:]), np.flatnonzero(ws1))

    @pytest.mark.parametrize("cap,seed", [(1, 0), (7, 0), (64, 3)])
    def test_bytes_equal_reference(self, cap, seed):
        rng = np.random.default_rng(cap + seed)
        pairs = rng.integers(0, 5000, (40, 2)).astype(np.int64)
        counts = rng.integers(0, 200, 40)
        s_pad = int(counts.sum()) + 17
        got = sampled_mod.sample_weights(pairs, counts, s_pad, cap, seed)
        want = ref_sampled.sample_weights(pairs, counts, s_pad, cap, seed)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and _same_bytes(a, b)

    def test_overflow_raises(self):
        with pytest.raises(ValueError, match="exceed"):
            sampled_mod.sample_weights(np.zeros((1, 2), np.int64),
                                       np.asarray([9]), 8, cap=4)


class TestEscalation:
    def test_tolerance_splits_the_batch(self, workload):
        model, params, x, y, pts, *_ = workload
        base = _engine(model, params, x, y, solver="sampled",
                       sampled_cap=CAP)
        res = base.query_batch(pts)
        eb = np.asarray(res.err_bound)
        order = np.sort(eb)
        tol = float(order[len(pts) // 2 - 1] + order[len(pts) // 2]) / 2.0
        over = np.flatnonzero(eb > tol)
        keep = np.flatnonzero(eb <= tol)
        assert len(over) and len(keep), eb

        tight = _engine(model, params, x, y, solver="sampled",
                        sampled_cap=CAP, sampled_tol=tol)
        res2 = tight.query_batch(pts)
        rung = rpolicy.next_solver("sampled")
        ref = _engine(model, params, x, y, solver=rung).query_batch(pts[over])
        for k, t in enumerate(over):
            assert _same_bytes(res2.scores_of(int(t)), ref.scores_of(k))
            assert float(res2.err_bound[int(t)]) == 0.0
        for t in keep:
            assert _same_bytes(res2.scores_of(int(t)), res.scores_of(int(t)))
            assert float(res2.err_bound[int(t)]) == float(eb[int(t)])
        assert res2.approx
        st = tight.sampled_stats()
        assert st == {"queries": len(pts),
                      "escalations": {"tolerance": len(over)}}

    def test_classified_fault_degrades_whole_batch(self, workload):
        model, params, x, y, pts, *_ = workload
        samp = _engine(model, params, x, y, solver="sampled",
                       sampled_cap=CAP)
        rung = rpolicy.next_solver("sampled")
        ref = _engine(model, params, x, y, solver=rung).query_batch(pts)
        with inject.active(
            inject.Fault(site=sites.ENGINE_SAMPLED_SOLVE, at=0,
                         kind=taxonomy.WORKER),
            strict=True, validate=True,
        ):
            res = samp.query_batch(pts)
        for t in range(len(pts)):
            assert _same_bytes(res.scores_of(t), ref.scores_of(t)), t
        assert samp.sampled_stats()["escalations"] == {
            taxonomy.WORKER: len(pts)}


class TestApproxSibling:
    def test_sampled_engine_is_its_own_sibling(self, workload):
        model, params, x, y, *_ = workload
        samp = _engine(model, params, x, y, solver="sampled")
        assert samp.approx_sibling() is samp

    def test_sibling_is_sampled_no_disk(self, workload, tmp_path):
        model, params, x, y, pts, *_ = workload
        eng = _engine(model, params, x, y, solver="precomputed",
                      cache_dir=str(tmp_path), sampled_cap=CAP)
        sib = eng.approx_sibling()
        assert sib.solver == "sampled" and sib.cache_dir is None
        assert sib.sampled_cap == CAP
        assert sib is eng.approx_sibling()
        direct = _engine(model, params, x, y, solver="sampled",
                         sampled_cap=CAP).query_batch(pts[:2])
        got = sib.query_batch(pts[:2])
        for t in range(2):
            assert _same_bytes(got.scores_of(t), direct.scores_of(t))
        assert np.array_equal(got.err_bound, direct.err_bound)

    def test_sibling_shares_index_and_device_data(self, workload, tmp_path):
        """A sibling reuses its parent's index, postings and device train
        tensors; its programs, bank and counters are its own."""
        model, params, x, y, pts, *_ = workload
        eng = _engine(model, params, x, y, solver="precomputed",
                      cache_dir=str(tmp_path), sampled_cap=CAP)
        sib = eng.approx_sibling()
        miss = eng._miss_delegate()
        for other in (sib, miss):
            assert other.index is eng.index
            assert other._postings is eng._postings
            assert other.train_x is eng.train_x
            assert other.train_y is eng.train_y
            assert other.params is not eng.params
            assert all(other.params[k] is v for k, v in eng.params.items())
            assert other._programs is not eng._programs
            assert other._bank_delegate is None
        sib.query_batch(pts[:2])
        assert sib.sampled_stats()["queries"] == 2
        assert eng.sampled_stats()["queries"] == 0


# -- the certificate's plain version against the reference's -------------
def _cert_inputs(seed=0, T=5, d=6, nan_row=None):
    """Random flat operands: T segments of 0..40 rows (one empty), a pad
    tail past the last segment, about half the rows sampled."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(1, 40, T)
    counts[1] = 0
    total = int(counts.sum())
    S = total + 9
    off = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    t = np.minimum(np.searchsorted(off[1:T], np.arange(S), side="right"),
                   T - 1).astype(np.int32)
    g = rng.standard_normal((S, d)).astype(np.float32)
    ihvp = rng.standard_normal((T, d)).astype(np.float32)
    cx = rng.standard_normal((T, d)).astype(np.float32)
    wv = (np.arange(S) < total).astype(np.float32)
    ws = np.where(rng.random(S) < 0.5, 2.5, 0.0).astype(np.float32) * wv
    abe = (rng.standard_normal(S) * (rng.random(S) < 0.1)).astype(np.float32)
    e = rng.standard_normal(S).astype(np.float32)
    m = np.asarray([int(np.count_nonzero(ws[off[k]:off[k + 1]]))
                    for k in range(T)], np.int32)
    if nan_row is not None:
        g[nan_row] = np.inf
    return g, t, ihvp, cx, wv, ws, abe, e, off, m


def _ref_certificate(g, t, ihvp, cx, wv, ws, abe, e, off, m):
    """The reference's certificate arithmetic (engine.py:2492-2522) over
    the rows in segments."""
    T = len(m)
    total = int(off[-1])
    g, t, wv, ws, abe, e = (a[:total] for a in (g, t, wv, ws, abe, e))
    g_, x_, c_ = jnp.asarray(g), jnp.asarray(ihvp), jnp.asarray(cx)
    gx = jnp.einsum("sd,sd->s", g_, x_[t])
    h = wv[:, None] * g_ * gx[:, None] + abe[:, None] * c_[t]
    sigma = ref_sampled.segment_sample_std(h, jnp.asarray(ws), t,
                                           jnp.asarray(m), T)
    gnorm = jnp.sqrt(jnp.sum(g_ * g_, axis=1))
    gmax = jnp.maximum(jax.ops.segment_max(wv * 2.0 * jnp.abs(e) * gnorm,
                                           t, T), 0.0)
    wmax = jnp.maximum(jax.ops.segment_max(wv, t, T), 0.0)
    return tuple(np.asarray(a) for a in (sigma, gmax, wmax))


def _port_certificate(ops):
    return tuple(o.numpy() for o in kcert.segment_certificate(
        *(torch.as_tensor(a) for a in ops)))


@pytest.mark.parametrize("seed,d", [(0, 6), (1, 34), (2, 64), (3, 1)])
def test_plain_certificate_matches_reference(seed, d):
    ops = _cert_inputs(seed, d=d)
    got, want = _port_certificate(ops), _ref_certificate(*ops)
    for a, b, what in zip(got, want, ("sigma", "gmax", "wmax")):
        np.testing.assert_allclose(a, b, rtol=CERT_RTOL,
                                   atol=1e-6 * float(np.max(np.abs(b))),
                                   err_msg=what)
    # the empty segment and the one-sample case: 0 and exactly 0
    assert got[0][1] == 0.0 and got[1][1] == 0.0 and got[2][1] == 0.0


def test_plain_certificate_nonfinite_unsampled_row():
    """A non-finite h on an UNSAMPLED row of segment 0 turns its σ̂ NaN
    (the mask multiplies, it does not select), and no other segment's."""
    ops = list(_cert_inputs(4))
    ws, off = ops[5], ops[8]
    row = next(r for r in range(int(off[0]), int(off[1])) if ws[r] == 0.0)
    ops = _cert_inputs(4, nan_row=row)
    got, want = _port_certificate(ops), _ref_certificate(*ops)
    assert np.isnan(got[0][0]) and np.isnan(want[0][0])
    assert np.all(np.isfinite(got[0][1:])) and np.all(np.isfinite(want[0][1:]))
    np.testing.assert_allclose(got[0][1:], want[0][1:], rtol=CERT_RTOL)


def test_plain_certificate_rows_past_last_segment_ignored():
    ops = list(_cert_inputs(5))
    total = int(ops[8][-1])
    base = _port_certificate(ops)
    ops[0] = ops[0].copy()
    ops[0][total:] = np.nan  # the flat pad's rows
    got = _port_certificate(ops)
    for a, b in zip(got, base):
        assert _same_bytes(a, b)


# -- the rung against the reference's, on the same samples ----------------
@pytest.fixture(scope="module", params=["mf", "ncf", "mf-tiny"])
def rung_case(request):
    if request.param == "mf-tiny":
        splits = request.getfixturevalue("tiny_splits")
        x, y = splits["train"].x, splits["train"].y
        shape, pts = (60, 40, 8), splits["test"].x[:20].astype(np.int64)
        Port, Ref, rtol = MF, RefMF, TINY_RTOL
    else:
        _, _, x, y = _setup()
        shape, pts = (U, I, 4), _points(x, 6)
        Port, Ref = (MF, RefMF) if request.param == "mf" else (NCF, RefNCF)
        rtol = TINY_RTOL if request.param == "mf" else RTOL
    ref_model = Ref(*shape, WD)
    arrays = jax.tree_util.tree_map(
        np.asarray, ref_model.init_params(jax.random.PRNGKey(0)))
    model = Port(*shape, WD)
    port = _engine(model, params_from_numpy(model, arrays, "cpu"), x, y,
                   solver="sampled", sampled_cap=CAP)
    ref = RefEngine(ref_model, arrays, RefDataset(x, y), damping=DAMP,
                    solver="sampled", sampled_cap=CAP)
    return port, ref, pts, rtol


def test_rung_matches_reference(rung_case):
    port, ref, pts, rtol = rung_case
    res, want = port.query_batch(pts), ref.query_batch(pts)
    assert np.array_equal(res.counts, want.counts)
    for t in range(len(pts)):
        np.testing.assert_allclose(res.scores_of(t), want.scores_of(t),
                                   rtol=rtol, atol=ATOL)
    np.testing.assert_allclose(res.err_bound, np.asarray(want.err_bound),
                               rtol=BOUND_RTOL, atol=1e-9)
    assert float(np.max(res.err_bound)) > 0.0


# -- the sampled program: one build a geometry ------------------------------
def test_sampled_program_built_once_a_geometry(workload):
    """The sampled program is built once a ``(t_pad, s_pad)`` geometry
    (on the card a captured CUDA graph, here the program closure),
    counted by ``compilemon`` and listed by ``compiled_geometries``, as
    the direct program is (``tests/test_torch_dispatch.py``)."""
    model, params, x, y, *_ = workload
    pts = _points(x, 23)
    samp = _engine(model, params, x, y, solver="sampled", sampled_cap=CAP)
    before = compilemon.count()
    first = samp.query_batch(pts)
    again = samp.query_batch(pts)
    assert compilemon.count() == before + 1
    assert _same_bytes(first._packed, again._packed)
    assert _same_bytes(first.err_bound, again.err_bound)
    got = samp.compiled_geometries()
    t_pad, _ = samp.flat_geometry(pts)
    _, _, ws, _, s_pad = samp._sampled_inputs(pts)
    assert got["aot"] == [] and len(got["jit"]) == 1
    assert got["jit"][0].startswith(f"('sampled', {t_pad}, {s_pad},")
    # other splits build each new geometry once (a sampled dispatch's flat
    # pad covers its query-pad rows too), and nothing when warm
    samp = _engine(model, params, x, y, solver="sampled", sampled_cap=CAP,
                   query_bucket=4)
    geoms = set()
    for bq in (23, 7, 3):
        for k in range(0, len(pts), bq):
            _, tx, _, _, sp = samp._sampled_inputs(pts[k: k + bq])
            geoms.add((tx.shape[0], sp))
    assert len(geoms) > 2
    before = compilemon.count()
    for _ in range(2):
        for bq in (23, 7, 3):
            samp.query_many(pts, batch_queries=bq)
        assert compilemon.count() == before + len(geoms)
    assert len(samp.compiled_geometries()["jit"]) == len(geoms)


def test_sampled_program_runs_the_block_eigmin_plain_version(workload,
                                                              monkeypatch):
    """On the CPU the sampled program's λ_min is ``block_eigmin``'s plain
    version, and no library eigensolver is called."""
    from fia_tpu_torch.influence.kernels import eigmin

    model, params, x, y, pts, *_ = workload
    calls = []
    real = eigmin.block_eigmin_reference

    def spy(H, *a, **kw):
        calls.append(tuple(H.shape))
        return real(H, *a, **kw)

    def refuse(*a, **kw):
        raise AssertionError("torch.linalg.eigvalsh called")

    monkeypatch.setattr(eigmin, "block_eigmin_reference", spy)
    monkeypatch.setattr(torch.linalg, "eigvalsh", refuse)
    samp = _engine(model, params, x, y, solver="sampled", sampled_cap=CAP)
    res = samp.query_batch(pts)
    d = model.block_size
    assert calls == [(samp._query_pad(len(pts)), d, d)]
    assert np.all(np.isfinite(res.err_bound))


@pytest.mark.cuda
def test_sampled_graph_replay_equals_eager_program_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the sampled program is captured as "
                    "a CUDA graph only there")
    model, params, x, y, *_ = workload
    pts = _points(x, 23)
    samp = InfluenceEngine(model, {k: v.cuda() for k, v in params.items()},
                           RatingDataset(x, y), damping=DAMP,
                           solver="sampled", sampled_cap=CAP)
    _, tx, ws, m, s_pad = samp._sampled_inputs(pts)
    eager = samp._flat_fn(s_pad, mode="sampled")(
        samp.params, samp.train_x, samp.train_y, samp._postings, tx, ws, m)
    res = samp.query_batch(pts)
    total = int(res.counts.sum())
    assert res._packed.tobytes() == eager[0][:total].cpu().numpy().tobytes()
    assert res.err_bound.tobytes() == eager[3][: len(pts)].cpu().numpy(
        ).tobytes()


@pytest.mark.parametrize("piece", [1, 7, kcert.CERT_PIECE_ROWS])
def test_certificate_slots_cover_every_piece_once(piece, monkeypatch):
    """The certificate kernel's slot scheme, restated: slot j holds piece
    q = j - (r0[t] // P + t) of the last segment t with r0[t] // P + t
    <= j, when such a piece starts before the segment's end. Every piece
    of every segment (an empty one has none) is found exactly once,
    inside ``scratch_slots``."""
    monkeypatch.setattr(kcert, "CERT_PIECE_ROWS", piece)
    rng = np.random.default_rng(piece)
    for trial in range(20):
        counts = rng.integers(0, 4 * piece + 3, rng.integers(1, 40))
        counts[rng.random(counts.size) < 0.2] = 0
        S = int(counts.sum()) + int(rng.integers(0, 2 * piece))
        if trial % 3 == 0:  # a last segment cut at the flat pad
            S = max(0, int(counts.sum()) - int(rng.integers(0, piece + 1)))
        off = np.minimum(np.concatenate([[0], np.cumsum(counts)]), S)
        r0, r1 = off[:-1], off[1:]
        first = r0 // piece + np.arange(len(counts))
        want = {(t, q) for t in range(len(counts))
                for q in range(-(-(r1[t] - r0[t]) // piece))}
        found = set()
        for j in range(kcert.scratch_slots(S, len(counts))):
            t = int(np.searchsorted(first, j, side="right")) - 1
            if t < 0:
                continue
            q = j - int(first[t])
            if r0[t] + q * piece < r1[t]:
                assert (t, q) not in found
                found.add((t, q))
        assert found == want

"""The flat path's segment Hessian sums (``fia_tpu_torch/influence/
kernels/segment.py``) against the reference's Hessian stage.

The port's plain forms (the scatter form, which ``flat_accum="auto"``
takes on the CPU, and the one-hot product) go through
``_flat_fn(s_pad, "hessian")`` beside the reference's
``_flat_fn(s_pad, "hessian")`` run with each of its own ``flat_accum``
forms on the CPU, on the same numpy inputs (the reference's params
carried across), for MF and NCF. The damped Hessians meet rtol 1e-5
with an absolute bar of 1e-7 × max |H| (float32 sums of the same
products in another order: measured within 2.4e-7 relative). The batch
includes a count-0 query (an empty segment) and query-pad segments
truncated at the flat pad. Synthetic segments (empty, one row, wv = 0
rows, a truncated last segment) hold both plain forms against a float64
sum, and the scatter form bitwise against itself at another chunking,
offset and batch size. The pieced form (the kernel's order: pieces of P
rows from a segment's start, each in row order, the partials added in
piece order) meets the same float64 bar with pieces short enough that
the long segments span many, equals the row-order form bit for bit when
one piece covers every segment, and gives a segment the same bits alone
and at another offset in another batch. Under the sampled rung's
Horvitz-Thompson weights n/m (m < n, and m = 1) both forms meet the
float64 bar, the pieced form's block is its upper triangle mirrored
(the kernel's definition), and a segment keeps its bits in any batch.
The CUDA kernel itself is held
against the pieced form on the card by ``chip_smoke.py``; here the
wrapper must take the plain version for CPU tensors and count no
launch.
"""

import inspect

import jax
import numpy as np
import pytest
import torch

from fia_tpu.data.dataset import RatingDataset as RefDataset
from fia_tpu.influence.engine import InfluenceEngine as RefEngine
from fia_tpu.models import MF as RefMF
from fia_tpu.models import NCF as RefNCF
from fia_tpu_torch.data.dataset import RatingDataset
from fia_tpu_torch.influence.engine import InfluenceEngine
from fia_tpu_torch.influence.kernels import segment
from fia_tpu_torch.models import MF, NCF, params_from_numpy

torch.set_num_threads(2)

RTOL, ATOL_REL = 1e-5, 1e-7
FAMILIES = {"mf": (MF, RefMF), "ncf": (NCF, RefNCF)}
PORT_ACCUM = ("auto", "scan", "onehot")
REF_ACCUM = ("scan", "onehot")


def _setup():
    """tests/test_kernels.py:44-54's input (U=24, I=18, k=4, 400 rows);
    the last pair is unseen, a count-0 query."""
    U, I = 24, 18
    rng = np.random.default_rng(0)
    x = np.stack([rng.integers(0, U - 1, 400), rng.integers(0, I - 1, 400)],
                 axis=1).astype(np.int32)
    y = rng.integers(1, 6, 400).astype(np.float32)
    pts = x[np.random.default_rng(7).choice(400, size=11, replace=False)]
    pts = np.concatenate([pts.astype(np.int64), [[U - 1, I - 1]]])
    return (U, I, 4), x, y, pts


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def family_case(request):
    (U, I, k), x, y, pts = _setup()
    Port, Ref = FAMILIES[request.param]
    ref_model = Ref(U, I, k, 1e-3)
    arrays = jax.tree_util.tree_map(
        np.asarray, ref_model.init_params(jax.random.PRNGKey(0)))
    model = Port(U, I, k, 1e-3)
    ports = {a: InfluenceEngine(model, params_from_numpy(model, arrays, "cpu"),
                                RatingDataset(x, y), damping=1e-3,
                                flat_accum=a, device="cpu")
             for a in PORT_ACCUM}
    refs = {a: RefEngine(ref_model, arrays, RefDataset(x, y), damping=1e-3,
                         flat_accum=a) for a in REF_ACCUM}
    return ports, refs, pts


@pytest.mark.parametrize("ref_accum", REF_ACCUM)
@pytest.mark.parametrize("port_accum", PORT_ACCUM)
def test_hessian_stage_matches_reference(family_case, port_accum, ref_accum):
    ports, refs, pts = family_case
    port, ref = ports[port_accum], refs[ref_accum]
    counts, tx, s_pad = port._flat_inputs(pts)
    assert counts[-1] == 0 and tx.shape[0] > len(pts)  # empty + pad segments
    got = port._flat_fn(s_pad, "hessian")(
        port.params, port.train_x, port.train_y, port._postings, tx).numpy()
    want = np.asarray(ref._flat_fn(s_pad, "hessian")(
        ref.params, ref.train_x, ref.train_y, ref._postings,
        jax.numpy.asarray(tx.numpy()), ref._rowfeat))
    T = len(pts)
    got, want = got[:T], want[:T]
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL_REL * np.abs(want).max())
    # the count-0 query's block is the damped regulariser alone
    np.testing.assert_array_equal(got[-1], np.diag(np.diag(got[-1])))


def test_auto_and_scan_are_one_form_on_the_cpu(family_case):
    ports, _, pts = family_case
    a, s = ports["auto"], ports["scan"]
    ra, rs = a.query_batch(pts), s.query_batch(pts)
    assert ra._packed.tobytes() == rs._packed.tobytes()
    assert ra.ihvp.tobytes() == rs.ihvp.tobytes()


def _synthetic(counts, S, d, seed=0):
    """(g, t, wv, abe, off) for segments of ``counts`` rows on an S-row
    axis (offsets clamped to S, rows past the total in the last segment
    with wv = 0, as the prelude lays them out; every 5th row wv = 0)."""
    rng = np.random.default_rng(seed)
    counts = np.asarray(counts, np.int64)
    T = len(counts)
    off = np.minimum(np.concatenate([[0], np.cumsum(counts)]), S)
    t = np.searchsorted(off[1:T], np.arange(S), side="right").astype(np.int32)
    wv = (np.arange(S) < off[-1]).astype(np.float32)
    wv[::5] = 0.0
    g = rng.standard_normal((S, d)).astype(np.float32)
    abe = (rng.standard_normal(S) * wv).astype(np.float32)
    return tuple(torch.as_tensor(a) for a in (g, t, wv, abe, off))


def _exact(g, wv, abe, off):
    """float64 sums by definition, segment by segment."""
    g, wv, abe, off = (a.double().numpy() for a in (g, wv, abe, off))
    off = off.astype(np.int64)
    T, d = len(off) - 1, g.shape[1]
    HH, sabe = np.zeros((T, d, d)), np.zeros(T)
    for j in range(T):
        r = slice(off[j], off[j + 1])
        HH[j] = (g[r] * wv[r, None]).T @ g[r]
        sabe[j] = abe[r].sum()
    return HH, sabe


CASES = {
    "empty and one-row segments": ([0, 1, 0, 37, 1, 0], 60),
    "truncated last segment": ([40, 1, 300], 191),
    "long segment": ([3, 1500, 2], 1600),
}


@pytest.mark.parametrize("onehot", [False, True], ids=["scan", "onehot"])
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("d", [6, 34])
def test_plain_forms_against_float64(case, d, onehot):
    counts, S = CASES[case]
    g, t, wv, abe, off = _synthetic(counts, S, d)
    HH, sabe = segment.segment_sums_reference(g, t, wv, abe, len(counts), 64,
                                              onehot=onehot)
    want, want_s = _exact(g, wv, abe, off)
    scale = np.abs(want).max()
    np.testing.assert_allclose(HH.numpy(), want, rtol=RTOL,
                               atol=ATOL_REL * scale)
    np.testing.assert_allclose(sabe.numpy(), want_s, rtol=RTOL,
                               atol=ATOL_REL * max(np.abs(want_s).max(), 1.0))
    empty = np.diff(off.numpy()) == 0
    assert not HH.numpy()[empty].any() and not sabe.numpy()[empty].any()


def test_scan_form_is_split_invariant_on_the_cpu():
    """The CPU's scatter form adds each entry's rows in row order, so a
    segment's sums do not depend on the chunking, on its offset or on
    the batch around it."""
    d = 10
    g1, t1, wv1, abe1, _ = _synthetic([700], 700, d, seed=1)
    one = segment.segment_sums_reference(g1, t1, wv1, abe1, 1, 2048)
    counts = np.random.default_rng(2).integers(0, 90, 30)
    counts[17] = 700
    g2, t2, wv2, abe2, off2 = _synthetic(counts, int(counts.sum()), d,
                                         seed=3)
    a, b = int(off2[17]), int(off2[18])
    g2[a:b], wv2[a:b], abe2[a:b] = g1, wv1, abe1
    for chunk in (1, 64, 2048):
        many = segment.segment_sums_reference(g2, t2, wv2, abe2, 30, chunk)
        assert torch.equal(many[0][17], one[0][0])
        assert torch.equal(many[1][17], one[1][0])


def test_wrapper_takes_the_plain_version_on_the_cpu():
    g, t, wv, abe, off = _synthetic([0, 1, 37, 5], 50, 6)
    before = (segment.launches, segment.captured)
    got = segment.segment_sums(g, t, wv, abe, off, 16)
    want = segment.segment_sums_reference(g, t, wv, abe, 4, 16)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert (segment.launches, segment.captured) == before


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_flat_accum_values_as_the_reference(family):
    (U, I, k), x, y, _ = _setup()
    Port, Ref = FAMILIES[family]
    ref_model = Ref(U, I, k, 1e-3)
    arrays = jax.tree_util.tree_map(
        np.asarray, ref_model.init_params(jax.random.PRNGKey(0)))
    model = Port(U, I, k, 1e-3)
    params = params_from_numpy(model, arrays, "cpu")
    for value in PORT_ACCUM:
        eng = InfluenceEngine(model, params, RatingDataset(x, y),
                              flat_accum=value, device="cpu")
        assert eng.flat_accum == value
    with pytest.raises(ValueError, match="unknown flat_accum 'bogus'") as got:
        InfluenceEngine(model, params, RatingDataset(x, y),
                        flat_accum="bogus", device="cpu")
    with pytest.raises(ValueError) as want:
        RefEngine(ref_model, arrays, RefDataset(x, y), flat_accum="bogus")
    assert str(got.value) == str(want.value)


@pytest.mark.cuda
def test_kernel_matches_scan_form_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the segment_hessian kernel has no "
                    "CPU form (chip_smoke.py holds it on the card)")
    d = 34
    P = segment.piece_rows(d)
    ops = _synthetic([0, 1, 37, 5, 300, P - 1, P, P + 1, 3 * P + 5],
                     1400 + 5 * P, d)
    got = segment.segment_sums(*(a.cuda() for a in ops), 0)
    want = segment.segment_sums_reference(*ops[:4], 9, 64, piece=P,
                                          off=ops[4])
    # wv in {0, 1}: the kernel is the pieced form's arithmetic in its order
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])


PIECES = (7, 64)


@pytest.mark.parametrize("piece", PIECES)
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("d", [6, 34])
def test_pieced_form_against_float64(case, d, piece):
    """Pieces of 7 and 64 rows: the 1,500-row segment spans 215 / 24 of
    them and the truncated one 22 / 3."""
    counts, S = CASES[case]
    g, t, wv, abe, off = _synthetic(counts, S, d)
    HH, sabe = segment.segment_sums_reference(g, t, wv, abe, len(counts), 64,
                                              piece=piece, off=off)
    want, want_s = _exact(g, wv, abe, off)
    scale = np.abs(want).max()
    np.testing.assert_allclose(HH.numpy(), want, rtol=RTOL,
                               atol=ATOL_REL * scale)
    np.testing.assert_allclose(sabe.numpy(), want_s, rtol=RTOL,
                               atol=ATOL_REL * max(np.abs(want_s).max(), 1.0))
    empty = np.diff(off.numpy()) == 0
    assert not HH.numpy()[empty].any() and not sabe.numpy()[empty].any()
    # wv in {0, 1}: both halves are the same sums
    assert torch.equal(HH, HH.transpose(1, 2))


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("d", [6, 34])
def test_one_piece_is_the_row_order_form(case, d):
    """A piece at least as long as the longest segment is the whole
    segment in row order: the scatter form's bits."""
    counts, S = CASES[case]
    g, t, wv, abe, off = _synthetic(counts, S, d)
    T = len(counts)
    rows = segment.segment_sums_reference(g, t, wv, abe, T, 64)
    for piece in (max(counts), S + 1):
        one = segment.segment_sums_reference(g, t, wv, abe, T, 64,
                                             piece=piece, off=off)
        assert torch.equal(one[0], rows[0]) and torch.equal(one[1], rows[1])


@pytest.mark.parametrize("piece", PIECES)
def test_pieced_form_is_split_invariant(piece):
    """Pieces are counted from a segment's start, so its sums do not
    depend on its offset (on or off a multiple of the piece), on the
    batch around it, on the flat pad or on the chunk argument."""
    d = 10
    g1, t1, wv1, abe1, off1 = _synthetic([700], 700, d, seed=1)
    one = segment.segment_sums_reference(g1, t1, wv1, abe1, 1, 2048,
                                         piece=piece, off=off1)
    for T, at, pad, seed in ((30, 17, 0, 3), (9, 2, 300, 4), (64, 63, 51, 5)):
        counts = np.random.default_rng(seed).integers(0, 90, T)
        counts[at] = 700
        g2, t2, wv2, abe2, off2 = _synthetic(counts, int(counts.sum()) + pad,
                                             d, seed=seed)
        a, b = int(off2[at]), int(off2[at + 1])
        g2[a:b], wv2[a:b], abe2[a:b] = g1, wv1, abe1
        for chunk in (1, 64, 2048):
            many = segment.segment_sums_reference(g2, t2, wv2, abe2, T, chunk,
                                                  piece=piece, off=off2)
            assert torch.equal(many[0][at], one[0][0])
            assert torch.equal(many[1][at], one[1][0])


def _ht_weights(counts, S, cap, seed=0):
    """The sampled rung's Hessian weights on the rows of ``counts``-row
    segments: min(n, cap) rows a segment at the Horvitz-Thompson weight
    n/m (non-integral for most n, m; n at m = 1), the rest 0
    (``influence/sampled.py:sample_weights``)."""
    from fia_tpu_torch.influence.sampled import sample_weights

    counts = np.asarray(counts, np.int64)
    pairs = np.random.default_rng(seed).integers(0, 10**6, (len(counts), 2))
    ws, _ = sample_weights(pairs, counts, max(S, int(counts.sum())), cap)
    return torch.as_tensor(ws[:S])


HT_CASES = {"m < n": 13, "m = 1": 1}


@pytest.mark.parametrize("piece", PIECES)
@pytest.mark.parametrize("cap", sorted(HT_CASES.values()),
                         ids=sorted(HT_CASES, key=HT_CASES.get))
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("d", [6, 34])
def test_pieced_form_ht_weights(case, d, cap, piece):
    """Under the sampled rung's weights n/m both forms meet the float64
    bar, and the pieced form is the kernel's definition: the upper
    triangle summed, the lower its mirror (Σ (wv g_j) g_i would round
    otherwise), so its block is exactly symmetric."""
    counts, S = CASES[case]
    g, t, wv, abe, off = _synthetic(counts, S, d)
    w = wv * _ht_weights(counts, S, cap)
    # weights other than 0 and 1 (n/m; n itself at m = 1)
    assert bool(((w != 0) & (w != 1)).any())
    T = len(counts)
    want, want_s = _exact(g, w, abe, off)
    scale = np.abs(want).max()
    pieced = segment.segment_sums_reference(g, t, w, abe, T, 64, piece=piece,
                                            off=off)
    scatter = segment.segment_sums_reference(g, t, w, abe, T, 64)
    for HH, sabe in (pieced, scatter):
        np.testing.assert_allclose(HH.numpy(), want, rtol=RTOL,
                                   atol=ATOL_REL * scale)
        np.testing.assert_allclose(
            sabe.numpy(), want_s, rtol=RTOL,
            atol=ATOL_REL * max(np.abs(want_s).max(), 1.0))
    assert torch.equal(pieced[0], pieced[0].transpose(1, 2))
    iu = torch.triu_indices(d, d)
    one = segment.segment_sums_reference(g, t, w, abe, T, 64,
                                         piece=S + 1, off=off)
    # one piece covering every segment: the row-order form's upper half
    assert torch.equal(one[0][:, iu[0], iu[1]], scatter[0][:, iu[0], iu[1]])


@pytest.mark.parametrize("cap", sorted(HT_CASES.values()))
def test_pieced_form_ht_weights_split_invariant(cap):
    """A segment's weighted sums are the same bits alone and at another
    offset in another batch (its sample keyed on its pair, not its
    place)."""
    d, piece = 10, 64
    g1, t1, wv1, abe1, off1 = _synthetic([700], 700, d, seed=1)
    w1 = wv1 * _ht_weights([700], 700, cap, seed=9)
    one = segment.segment_sums_reference(g1, t1, w1, abe1, 1, 2048,
                                         piece=piece, off=off1)
    counts = np.random.default_rng(3).integers(0, 90, 30)
    counts[17] = 700
    g2, t2, wv2, abe2, off2 = _synthetic(counts, int(counts.sum()), d, seed=3)
    w2 = wv2 * _ht_weights(counts, int(counts.sum()), cap, seed=4)
    a, b = int(off2[17]), int(off2[18])
    g2[a:b], w2[a:b], abe2[a:b] = g1, w1, abe1
    many = segment.segment_sums_reference(g2, t2, w2, abe2, 30, 64,
                                          piece=piece, off=off2)
    assert torch.equal(many[0][17], one[0][0])
    assert torch.equal(many[1][17], one[1][0])


@pytest.mark.cuda
def test_kernel_matches_pieced_form_ht_weights_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the segment_hessian kernel has no "
                    "CPU form (chip_smoke.py holds it on the card)")
    d = 34
    P = segment.piece_rows(d)
    counts = [0, 1, 37, 5, 300, P - 1, P, P + 1, 3 * P + 5]
    S = 1400 + 5 * P
    g, t, wv, abe, off = _synthetic(counts, S, d)
    w = wv * _ht_weights(counts, S, 13)
    got = segment.segment_sums(*(a.cuda() for a in (g, t, w, abe, off)), 0)
    want = segment.segment_sums_reference(g, t, w, abe, 9, 64, piece=P,
                                          off=off)
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])


def test_piece_rows_depends_on_d_only():
    assert list(inspect.signature(segment.piece_rows).parameters) == ["d"]
    # 256 rows a 64 x 64 tile on or above the diagonal
    want = {1: 256, 6: 256, 34: 256, 64: 256, 65: 768, 130: 1536,
            514: 11520, 1024: 34816}
    for d, rows in want.items():
        assert segment.piece_rows(d) == rows
        assert segment.piece_rows(np.int64(d)) == rows
    got = [segment.piece_rows(d) for d in range(1, 600)]
    assert got == sorted(got)


@pytest.mark.parametrize("piece", [1, 7, 64])
def test_piece_slots_cover_every_piece_once(piece):
    """The kernel's slot scheme, restated: slot j >= 1 holds piece
    q = j - r0[t] // P of the last segment t with r0[t] < jP, when such a
    piece starts before the segment's end. Every piece q >= 1 of every
    segment is found exactly once, inside ``scratch_slots``."""
    rng = np.random.default_rng(piece)
    for trial in range(20):
        counts = rng.integers(0, 4 * piece + 3, rng.integers(1, 40))
        counts[rng.random(counts.size) < 0.2] = 0
        S = int(counts.sum()) + int(rng.integers(0, 2 * piece))
        if trial % 3 == 0:  # a last segment cut at the flat pad
            S = max(0, int(counts.sum()) - int(rng.integers(0, piece + 1)))
        off = torch.as_tensor(np.minimum(
            np.concatenate([[0], np.cumsum(counts)]), S))
        r0, r1 = (x.numpy() for x in segment.segment_rows(off, S))
        n = segment.piece_counts(off, S, piece).numpy()
        want = {(t, q) for t in range(len(counts)) for q in range(1, n[t])}
        found = set()
        for j in range(1, -(-S // piece)):
            below = np.nonzero(off.numpy()[:-1].clip(max=S) < j * piece)[0]
            if below.size == 0:
                continue
            t = int(below[-1])
            q = j - int(r0[t]) // piece
            if r0[t] + q * piece < r1[t]:
                assert q >= 1 and (t, q) not in found
                assert j - 1 < segment.scratch_slots(S, piece)
                found.add((t, q))
        assert found == want


def test_pieced_form_arguments():
    g, t, wv, abe, off = _synthetic([3, 4], 7, 6)
    with pytest.raises(ValueError, match="one-hot"):
        segment.segment_sums_reference(g, t, wv, abe, 2, 4, onehot=True,
                                       piece=3, off=off)
    with pytest.raises(ValueError, match="offsets"):
        segment.segment_sums_reference(g, t, wv, abe, 2, 4, piece=3)
    with pytest.raises(ValueError, match="piece must be"):
        segment.segment_sums_reference(g, t, wv, abe, 2, 4, piece=0, off=off)

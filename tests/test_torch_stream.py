"""The port's streaming updates (``fia_tpu_torch/stream``) on the CPU.

Port against port: the 11 tests of ``tests/test_stream.py`` restated on
``fia_tpu_torch`` (the footprint's moved and read sets, the projection,
the epoch fence, surgical versus wholesale re-keying, the
``stream.update`` / ``stream.swap`` JSONL lines, kill → resume bitwise,
both rollbacks, bad ids), on the reference's community data
(U = 30, I = 20, K = 4).

Port against the JAX package, on the same numpy inputs:

- ``compute_footprint``: all four masks equal on community and random
  graphs;
- ``project_params``: the same bytes for MF and NCF;
- ``_update_id`` / ``_removal_id``: equal for the same params and rows;
- ``apply_updates`` and ``apply_removal`` (remove, reweight) started
  from the reference's trained params and Adam state, with the
  trainer's batch equal to the grown or shrunk train set, so that one
  batch is the whole set and the frameworks' shuffles cannot matter:
  rows and leaves outside the moved masks bitwise the base params in
  both, the moved rows within rtol 1e-4 / atol 1e-6 (1.2e-7 apart at
  most, measured; the fine-tune starts from a trained Adam state, so
  ROADMAP Queue C's first-step note does not bite), status, touched
  counts and ``new_rows`` equal.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from fia_tpu.api import FIAModel as RefFIAModel
from fia_tpu.data.dataset import RatingDataset as RefDataset
from fia_tpu.models import MF as RefMF
from fia_tpu.models import NCF as RefNCF
from fia_tpu.reliability import policy as ref_policy
from fia_tpu.stream import compute_footprint as ref_compute_footprint
from fia_tpu.stream import project_params as ref_project_params
from fia_tpu.stream import update as ref_update
from fia_tpu.stream.footprint import Footprint as RefFootprint
from fia_tpu_torch.api import FIAModel
from fia_tpu_torch.data.dataset import RatingDataset
from fia_tpu_torch.models import MF, NCF, params_from_numpy
from fia_tpu_torch.reliability import inject, sites, taxonomy
from fia_tpu_torch.reliability import policy as rpolicy
from fia_tpu_torch.serve import InfluenceService, Request, ServeConfig
from fia_tpu_torch.stream import compute_footprint, project_params
from fia_tpu_torch.stream import update as port_update
from fia_tpu_torch.stream.footprint import Footprint
from fia_tpu_torch.train.trainer import AdamState, TrainState

torch.set_num_threads(2)

U, I, K = 30, 20, 4
WD = 1e-2
DAMP = 1e-3
STEPS = 8  # fine-tune steps per update in these tests
# the fine-tuned moved rows, port against the reference
RTOL, ATOL = 1e-4, 1e-6

# community A: users 0-14 x items 0-9; community B: the rest. Updates
# land in A, so B pairs are provably outside every footprint.
TOUCHED_PAIR = (2, 3)
UNTOUCHED_PAIR = (22, 17)
UPD_X = np.array([[2, 3], [5, 1], [11, 8]], np.int32)
UPD_Y = np.array([5.0, 4.0, 3.0], np.float32)


def _community_data(seed=0, n=240):
    rng = np.random.default_rng(seed)
    half = n // 2
    xa = np.stack([rng.integers(0, 15, half),
                   rng.integers(0, 10, half)], axis=1)
    xb = np.stack([rng.integers(15, U, n - half),
                   rng.integers(10, I, n - half)], axis=1)
    x = np.concatenate([xa, xb]).astype(np.int32)
    y = rng.integers(1, 6, n).astype(np.float32)
    return x, y


def _random_data(seed=1, n=240):
    rng = np.random.default_rng(seed)
    x = np.stack([rng.integers(0, U, n), rng.integers(0, I, n)],
                 axis=1).astype(np.int32)
    y = rng.integers(1, 6, n).astype(np.float32)
    return x, y


def _params_bytes(params: dict) -> bytes:
    return b"".join(
        np.ascontiguousarray(params[k].detach().cpu().numpy()).tobytes()
        for k in sorted(params))


def _port_model(x, y, train_dir, name="stream-test"):
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
    x, y = _community_data()
    m = _port_model(x, y, tmp_path_factory.mktemp("stream-base"))
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


def _service(fm, **cfg):
    return InfluenceService.from_model(
        fm, config=ServeConfig(**cfg), clock=rpolicy.VirtualClock())


def _one(svc, pair, rid="q"):
    r = svc.run([Request(pair[0], pair[1], id=rid)], drain_every=1)[0]
    assert r.ok, (r.status, r.reason)
    return r


# -- port against port: tests/test_stream.py restated ------------------------
class TestFootprint:
    def test_second_order_reach_matches_hessian_read_set(self):
        # rows: u0-i0, u1-i0, u2-i1; update adds u0-i1
        train_x = np.array([[0, 0], [1, 0], [2, 1]], np.int32)
        fp = compute_footprint(train_x, np.array([[0, 1]], np.int32), 5, 4)
        # moved rows: u0 (direct), u2 (shares i1); i1 (direct), i0
        assert set(np.flatnonzero(fp.user_touched)) == {0, 2}
        assert set(np.flatnonzero(fp.item_touched)) == {0, 1}
        assert fp.touched(1, 0)
        # u1's own row is pinned, but its blocks gather Q[0], which moved
        assert set(np.flatnonzero(fp.user_read)) == {0, 1, 2}
        assert fp.touched(1, 2)
        assert not fp.touched(3, 3)
        assert not fp.touched(3, 2)

    def test_touched_pairs_vectorized_matches_scalar(self):
        x, _ = _community_data(n=60)
        fp = compute_footprint(x, UPD_X, U, I)
        pairs = np.stack([np.repeat(np.arange(U), I),
                          np.tile(np.arange(I), U)], axis=1)
        mask = fp.touched_pairs(pairs)
        for (u, i), m in zip(pairs[::17], mask[::17]):
            assert m == fp.touched(u, i)
        assert not fp.touched(*UNTOUCHED_PAIR)

    def test_projection_pins_untouched_rows_and_globals(self):
        model = MF(U, I, K, WD)
        old = {k: v.numpy() for k, v in model.init_params(
            torch.Generator().manual_seed(0)).items()}
        new = {k: v + 1.0 for k, v in old.items()}
        fp = Footprint(
            user_touched=np.arange(U) < 3,
            item_touched=np.arange(I) < 2,
            delta_users=np.arange(3), delta_items=np.arange(2),
        )
        proj = project_params(model, old, new, fp)
        assert np.array_equal(proj["P"][:3], new["P"][:3])
        assert np.array_equal(proj["P"][3:], old["P"][3:])
        assert np.array_equal(proj["Q"][:2], new["Q"][:2])
        assert np.array_equal(proj["Q"][2:], old["Q"][2:])
        assert np.array_equal(proj["bg"], old["bg"])


class TestEpochFencedCommit:
    def test_inflight_ticket_answers_on_admission_epoch(self, fm):
        svc = _service(fm)
        old_bytes = np.asarray(
            _one(svc, TOUCHED_PAIR, "warm").scores).tobytes()
        assert svc.submit(Request(*TOUCHED_PAIR, id="inflight")) is None

        r = fm.apply_updates(UPD_X, UPD_Y, steps=STEPS,
                             checkpoint_every=4)
        assert r.committed and r.status == "committed"
        assert svc.epoch == 1

        inflight = next(x for x in svc.drain() if x.id == "inflight")
        assert inflight.ok
        assert np.asarray(inflight.scores).tobytes() == old_bytes
        new_bytes = np.asarray(
            _one(svc, TOUCHED_PAIR, "after").scores).tobytes()
        assert new_bytes != old_bytes

    def test_surgical_rekey_not_wholesale_flush(self, fm):
        svc = _service(fm)
        old_untouched = np.asarray(
            _one(svc, UNTOUCHED_PAIR, "b").scores).tobytes()
        _one(svc, TOUCHED_PAIR, "a")
        inv_before = svc.cache.stats.invalidations

        assert fm.apply_updates(UPD_X, UPD_Y, steps=STEPS).committed
        st = svc.cache.stats
        assert st.rekeyed >= 1
        assert st.rekey_dropped >= 1
        assert st.invalidations == inv_before
        assert st.disk_rekeyed >= 1
        assert st.disk_rekey_dropped >= 1
        assert len(svc.cache) >= 1

        r = _one(svc, UNTOUCHED_PAIR, "b2")
        assert r.cache_tier == "hot"  # re-keyed entry, no recompute
        assert np.asarray(r.scores).tobytes() == old_untouched

    def test_wholesale_invalidation_still_available(self, fm):
        svc = _service(fm)
        _one(svc, UNTOUCHED_PAIR, "b")
        out = svc.advance_epoch(None)  # no footprint -> wholesale
        assert out["wholesale"] is True
        assert len(svc.cache) == 0
        assert svc.cache.stats.invalidations >= 1

    def test_metrics_jsonl_carries_update_and_swap(self, fm, tmp_path):
        path = str(tmp_path / "metrics.jsonl")
        svc = _service(fm, metrics_path=path)
        _one(svc, UNTOUCHED_PAIR, "b")
        assert fm.apply_updates(UPD_X, UPD_Y, steps=STEPS).committed
        svc.metrics.close()
        events = [json.loads(ln) for ln in open(path)]
        upd = next(e for e in events if e["event"] == "stream.update")
        assert upd["status"] == "committed" and upd["new_rows"] == 3
        swap = next(e for e in events if e["event"] == "stream.swap")
        assert swap["epoch"] == 1 and swap["wholesale"] is False
        assert swap["hot_rekeyed"] >= 1


class TestCrashSafety:
    def test_kill_resume_bit_identical_to_uninterrupted(self, fm):
        base_state, base_train = fm.state, fm.data_sets["train"]
        clean = fm.apply_updates(UPD_X, UPD_Y, steps=STEPS,
                                 checkpoint_every=2)
        assert clean.committed
        clean_bytes = _params_bytes(fm.state.params)

        fm.state, fm.data_sets["train"] = base_state, base_train
        fm._engines.clear()
        # the 8-step fine-tune runs 2 epoch dispatches (4 + 4 steps at
        # batch 50 over 243 rows): kill the second, after a checkpoint
        with inject.active(inject.Fault(sites.TRAINER_EPOCH, at=1,
                                        kind=taxonomy.OOM)):
            killed = fm.apply_updates(UPD_X, UPD_Y, steps=STEPS,
                                      checkpoint_every=2)
        assert killed.status == "rolled_back"
        assert killed.reason == taxonomy.OOM
        assert _params_bytes(fm.state.params) == _params_bytes(
            base_state.params)
        ckpt_dir = os.path.join(fm.train_dir, "stream",
                                f"upd-{killed.update_id}")
        assert os.path.isdir(ckpt_dir)

        resumed = fm.apply_updates(UPD_X, UPD_Y, steps=STEPS,
                                   checkpoint_every=2)
        assert resumed.committed
        assert resumed.update_id == killed.update_id
        assert resumed.resumed_step is not None
        assert resumed.resumed_step > int(base_state.step)
        assert _params_bytes(fm.state.params) == clean_bytes
        assert not os.path.isdir(ckpt_dir)  # cleaned after commit

    def test_rollback_on_classified_swap_failure(self, fm):
        svc = _service(fm)
        old_bytes = np.asarray(
            _one(svc, TOUCHED_PAIR, "warm").scores).tobytes()
        base_bytes = _params_bytes(fm.state.params)

        with inject.active(inject.Fault(sites.STREAM_SWAP, at=0,
                                        kind=taxonomy.PREEMPTION)):
            r = fm.apply_updates(UPD_X, UPD_Y, steps=STEPS)
        assert r.status == "rolled_back"
        assert r.reason == taxonomy.PREEMPTION
        assert _params_bytes(fm.state.params) == base_bytes
        assert fm.data_sets["train"].num_examples == 240
        assert svc.epoch == 0
        again = np.asarray(
            _one(svc, TOUCHED_PAIR, "after").scores).tobytes()
        assert again == old_bytes

    def test_update_site_failure_rolls_back_before_any_work(self, fm):
        with inject.active(inject.Fault(sites.STREAM_UPDATE, at=0,
                                        kind=taxonomy.WORKER)):
            r = fm.apply_updates(UPD_X, UPD_Y, steps=STEPS)
        assert r.status == "rolled_back"
        assert r.reason == taxonomy.WORKER

    def test_bad_ids_rejected(self, fm):
        with pytest.raises(ValueError):
            fm.apply_updates(np.array([[U, 0]], np.int32),
                             np.array([1.0], np.float32))
        with pytest.raises(ValueError):
            fm.apply_updates(np.zeros((0, 2), np.int32),
                             np.zeros(0, np.float32))


# -- port against the JAX package --------------------------------------------
def _ref_fp(fp: Footprint) -> RefFootprint:
    return RefFootprint(fp.user_touched, fp.item_touched, fp.delta_users,
                        fp.delta_items, fp.user_read, fp.item_read)


class TestFootprintAgainstReference:
    @pytest.mark.parametrize("graph", ["community", "random"])
    @pytest.mark.parametrize("delta", ["update", "removal"])
    def test_masks_equal(self, graph, delta):
        x, _ = (_community_data() if graph == "community"
                else _random_data())
        nx = UPD_X if delta == "update" else x[[3, 100, 200]]
        got = compute_footprint(x, nx, U, I)
        want = ref_compute_footprint(x, nx, U, I)
        for name in ("user_touched", "item_touched", "user_read",
                     "item_read", "delta_users", "delta_items"):
            assert np.array_equal(getattr(got, name), getattr(want, name)), \
                name
        pairs = np.stack([np.repeat(np.arange(U), I),
                          np.tile(np.arange(I), U)], axis=1)
        assert np.array_equal(got.touched_pairs(pairs),
                              want.touched_pairs(pairs))


class TestProjectionAgainstReference:
    @pytest.mark.parametrize("family", ["MF", "NCF"])
    def test_same_bytes(self, family):
        ref_model = (RefMF if family == "MF" else RefNCF)(U, I, K, WD)
        port_model = (MF if family == "MF" else NCF)(U, I, K, WD)
        old = jax.tree_util.tree_map(
            np.asarray, ref_model.init_params(jax.random.PRNGKey(0)))
        rng = np.random.default_rng(5)
        new = {k: (v + rng.standard_normal(v.shape)).astype(np.float32)
               for k, v in old.items()}
        x, _ = _random_data()
        fp = compute_footprint(x, x[[4, 9]], U, I)
        got = project_params(port_model, old, new, fp)
        want = ref_project_params(ref_model, old, new, _ref_fp(fp))
        assert sorted(got) == sorted(want)
        for k in got:
            assert got[k].tobytes() == np.asarray(want[k]).tobytes(), k
        # the globals (NCF's W*/b*, MF's bg) stayed, moved rows moved
        assert not np.array_equal(got["P" if family == "MF" else "P_mlp"],
                                  old["P" if family == "MF" else "P_mlp"])


def _carry_state(ref_state, model) -> TrainState:
    """The reference's (params, Adam state, step) as the port's."""
    host = lambda t: {k: np.asarray(v) for k, v in t.items()}  # noqa: E731
    adam = ref_state.opt_state[0]
    put = lambda t: {k: torch.tensor(v) for k, v in host(t).items()}  # noqa: E731
    return TrainState(
        params_from_numpy(model, host(ref_state.params), "cpu"),
        AdamState(torch.tensor(np.asarray(adam.count)), put(adam.mu),
                  put(adam.nu)),
        int(ref_state.step))


@pytest.fixture(scope="module")
def ref_base(tmp_path_factory):
    """The reference's FIAModel trained 24 steps on the community data."""
    x, y = _community_data()
    m = RefFIAModel(
        "MF", U, I, K, WD, batch_size=50,
        data_sets={"train": RefDataset(x, y)},
        initial_learning_rate=1e-2, damping=DAMP,
        train_dir=str(tmp_path_factory.mktemp("ref-stream")),
        model_name="stream-test", solver="direct", seed=0,
    )
    m._trainer.clock = ref_policy.VirtualClock()
    m.train(24, save_checkpoints=False, verbose=False)
    return m


@pytest.fixture()
def pair(ref_base, tmp_path):
    """(reference, port) FIAModels at the same params and Adam state."""
    saved = (ref_base.state, ref_base.data_sets["train"],
             ref_base.train_dir, ref_base._trainer.config.batch_size)
    ref_base.train_dir = str(tmp_path / "ref")
    train = ref_base.data_sets["train"]
    port = _port_model(np.asarray(train.x), np.asarray(train.y),
                       tmp_path / "port")
    port._trainer.clock = rpolicy.VirtualClock()
    port.state = _carry_state(ref_base.state, port.model)
    yield ref_base, port
    (ref_base.state, ref_base.data_sets["train"], ref_base.train_dir,
     ref_base._trainer.config.batch_size) = saved
    ref_base._engines.clear()


def _one_batch(ref, port, n: int) -> None:
    ref._trainer.config.batch_size = n
    port._trainer.config.batch_size = n


def _hold_update(ref, port, r_ref, r_port, base: dict) -> None:
    """Status, counts, outside-the-mask bytes and moved rows."""
    assert r_port.status == r_ref.status == "committed"
    assert r_port.update_id == r_ref.update_id
    assert r_port.new_rows == r_ref.new_rows
    assert (r_port.touched_users, r_port.touched_items) == (
        r_ref.touched_users, r_ref.touched_items)
    assert r_port.base_step == r_ref.base_step
    assert int(port.state.step) == int(ref.state.step)
    assert np.array_equal(port.data_sets["train"].x,
                          np.asarray(ref.data_sets["train"].x))
    np.testing.assert_allclose(port.data_sets["train"].y,
                               np.asarray(ref.data_sets["train"].y),
                               rtol=RTOL, atol=ATOL)
    fp = r_port.footprint
    got = {k: v.numpy() for k, v in port.state.params.items()}
    want = {k: np.asarray(v) for k, v in ref.state.params.items()}
    moved_any = False
    for k in sorted(base):
        tags = port_update._leaf_tags(port.model, base[k])
        if "global" in tags:
            assert got[k].tobytes() == base[k].tobytes() == \
                want[k].tobytes(), k
            continue
        keep = fp.user_touched if tags == {"user"} else fp.item_touched
        assert got[k][~keep].tobytes() == base[k][~keep].tobytes() == \
            want[k][~keep].tobytes(), k
        np.testing.assert_allclose(got[k][keep], want[k][keep], rtol=RTOL,
                                   atol=ATOL, err_msg=k)
        moved_any |= not np.array_equal(got[k][keep], base[k][keep])
    assert moved_any


class TestWritePathAgainstReference:
    def test_ids_equal(self, pair):
        ref, port = pair
        assert port_update._update_id(port, UPD_X, UPD_Y, STEPS) == \
            ref_update._update_id(ref, UPD_X, UPD_Y, STEPS)
        rows = np.array([3, 17, 101], np.int64)
        for tag in ("remove", "reweight:0.5"):
            assert port_update._removal_id(port, rows, tag, STEPS) == \
                ref_update._removal_id(ref, rows, tag, STEPS)

    def test_apply_updates(self, pair):
        ref, port = pair
        base = {k: v.numpy().copy() for k, v in port.state.params.items()}
        _one_batch(ref, port, 240 + len(UPD_X))
        r_ref = ref.apply_updates(UPD_X, UPD_Y, steps=STEPS)
        r_port = port.apply_updates(UPD_X, UPD_Y, steps=STEPS)
        _hold_update(ref, port, r_ref, r_port, base)

    @pytest.mark.parametrize("reweight", [None, 0.5])
    def test_apply_removal(self, pair, reweight):
        ref, port = pair
        rows = np.array([3, 17, 101, 230], np.int64)
        base = {k: v.numpy().copy() for k, v in port.state.params.items()}
        _one_batch(ref, port, 240 - (len(rows) if reweight is None else 0))
        r_ref = ref.apply_removal(rows, steps=STEPS, reweight=reweight)
        r_port = port.apply_removal(rows, steps=STEPS, reweight=reweight)
        _hold_update(ref, port, r_ref, r_port, base)


@pytest.mark.parametrize("name", ["apply_updates", "apply_removal",
                                  "project_params", "compute_footprint"])
def test_signature_is_the_references(name):
    """The reference's parameters, in its order and with its defaults."""
    import inspect

    from fia_tpu.stream import footprint as ref_footprint
    from fia_tpu_torch.stream import footprint as port_footprint

    mods = ((port_footprint, ref_footprint) if name == "compute_footprint"
            else (port_update, ref_update))
    port, ref = (inspect.signature(getattr(m, name)).parameters
                 for m in mods)
    assert list(port) == list(ref)
    for key, p in ref.items():
        assert port[key].default == p.default, key


def test_capture_warmups_share_one_stream_a_device(monkeypatch):
    """Every capture's warm-up runs on one stream a device: cuBLAS keeps a
    workspace for each (handle, stream) it has run on for the life of the
    process, so a fresh stream a capture grew device memory with every
    engine an update replaced (streams stood in for: they need the
    card; ``chip_smoke.py`` 11a bounds the memory there)."""
    from fia_tpu_torch.influence import engine as E

    made = []
    monkeypatch.setattr(E, "_WARMUP_STREAMS", {})
    monkeypatch.setattr(torch.cuda, "Stream",
                        lambda index: made.append(index) or object())
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    a = E._warmup_stream("cuda")
    assert E._warmup_stream(torch.device("cuda", 0)) is a
    assert E._warmup_stream("cuda:1") is not a
    assert made == [0, 1]


@pytest.mark.cuda
def test_device_memory_flat_across_updates_on_the_card(tmp_path):
    """Fenced engines and their captured graphs are released once their
    epoch drains: device memory after the third update's drain is no
    more than after the first's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flat program is captured as a "
                    "CUDA graph only there")
    import gc

    x, y = _community_data()
    m = FIAModel("MF", U, I, K, WD, batch_size=50,
                 data_sets={"train": RatingDataset(x, y)},
                 initial_learning_rate=1e-2, damping=DAMP,
                 train_dir=str(tmp_path), model_name="stream-cuda")
    svc = _service(m)
    probes = [TOUCHED_PAIR, UNTOUCHED_PAIR]
    allocated = []
    for k in range(3):
        for u, i in probes:
            svc.submit(Request(u, i))
        assert m.apply_updates(UPD_X + [0, k % 2], UPD_Y,
                               steps=STEPS).committed
        svc.drain()
        for pair in probes:
            _one(svc, pair)
        gc.collect()
        torch.cuda.synchronize()
        allocated.append(torch.cuda.memory_allocated())
    assert allocated[2] <= allocated[0], allocated

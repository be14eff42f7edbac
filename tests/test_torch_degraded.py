"""Degraded-mode serving in the port (``fia_tpu_torch/serve``) on the CPU.

Restated from ``tests/test_degraded.py`` port against port:
``TestHealthController`` (all ten), ``TestBrownoutServing`` (all five),
``TestSurvivingMesh`` (all five), ``TestMeshShrinkRecovery`` (all five:
a 4-slot mesh over virtual CPU slots shrinks on an injected device loss
and answers bit for bit the single-device service) and
``TestConstructionLiveness`` (both). A mesh the engine is not built over
fails construction, and so does a host role whose index lies outside its
host count. ``TestDeviceLostTaxonomy`` is restated in
``tests/test_torch_reliability.py`` (the taxonomy's device-loss kind,
its signatures, CUDA's sticky errors among them, and its being neither
transient nor size evidence) and is not repeated here.

Against the reference: one brownout stream through both services (each
package's own published bank, the reference's params carried over, the
sampled rung at cap 8 so the bounds are not 0): the same modes, the same
approx/exact split, tiers and shed set, err_bounds within rtol 1e-4
(``test_torch_sampled.py``'s bound bar), approximate answers' scores within
rtol 1e-4 / atol 1e-6. A bank hit's iHVP comes from each package's own
float32 factorization of a block at cond ~1e3 (factors agree at rtol 1e-4,
``test_torch_factor.py``), which moves a score with cancellation by up to
~2e-3 relative (measured): bank hits are held at the reference's
factor-smoke bar instead, Spearman >= 0.999 against the reference's hit.
"""

import jax
import numpy as np
import pytest
import torch

from fia_tpu.data.dataset import RatingDataset as RefDataset
from fia_tpu.influence import factor as ref_fbank
from fia_tpu.influence.engine import InfluenceEngine as RefEngine
from fia_tpu.models import MF as RefMF
from fia_tpu.reliability import inject as ref_inject
from fia_tpu.serve import HealthConfig as RefHealthConfig
from fia_tpu.serve import InfluenceService as RefService
from fia_tpu.serve import Request as RefRequest
from fia_tpu.serve import ServeConfig as RefConfig
from fia_tpu_torch.data.dataset import RatingDataset
from fia_tpu_torch.eval.metrics import spearman
from fia_tpu_torch.influence import factor as fbank
from fia_tpu_torch.influence.engine import InfluenceEngine
from fia_tpu_torch.models import MF, params_from_numpy
from fia_tpu_torch.parallel import mesh as pmesh
from fia_tpu_torch.reliability import inject, taxonomy
from fia_tpu_torch.serve import (
    MODE_BANK_PREFERRED,
    MODE_CACHE_ONLY,
    MODE_FULL,
    REASON_DEGRADED,
    HealthConfig,
    HealthController,
    InfluenceService,
    Request,
    ServeConfig,
)

torch.set_num_threads(2)

U, I, K = 30, 20, 4
WD = 1e-2
DAMP = 1e-3
BOUND_RTOL = 1e-4
RTOL, ATOL = 1e-4, 1e-6
BANK_RHO = 0.999


@pytest.fixture(autouse=True, scope="module")
def slots():
    with pmesh.virtual_devices(8):
        yield


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


def _service(engine, **cfg):
    cfg.setdefault("disk_cache", False)
    return InfluenceService(engine=engine, config=ServeConfig(**cfg))


def _unique_points(train, n):
    uniq = np.unique(train.x, axis=0)
    assert len(uniq) >= n
    return uniq[:n].astype(np.int64)


def _requests(pts):
    return [Request(int(u), int(i), id=f"q{n}")
            for n, (u, i) in enumerate(pts)]


class TestMeshless:
    def test_meshless_loss_sheds_classified(self):
        """No mesh to shrink: the batch sheds with the classified kind as
        its rejection reason and the stream keeps going."""
        model, params, train = _setup(seed=1)
        pts = _unique_points(train, 6)
        svc = _service(_engine(model, params, train), max_batch=3,
                       max_queue=64)
        with inject.active(
            inject.Fault("serve.dispatch", at=0,
                         kind=taxonomy.DEVICE_LOST),
            strict=True, validate=True,
        ):
            responses = svc.run(_requests(pts))
        shed = [r for r in responses if not r.ok]
        assert len(shed) == 3
        assert all(r.reason == taxonomy.DEVICE_LOST for r in shed)
        assert sum(1 for r in responses if r.ok) == 3
        assert svc.rollup()["device_loss_recoveries"] == 0

    @pytest.mark.parametrize("cfg,exc,match", [
        (lambda: {"mesh": 2}, ValueError, "does not match the engine"),
        (lambda: {"mesh": pmesh.make_mesh(2, device="cpu")}, ValueError,
         "does not match the engine"),
        (lambda: {"host_role": (2, 2, "/tmp/j")}, ValueError,
         "out of range")], ids=["mesh-int", "mesh-object", "host-role"])
    def test_mesh_and_host_role_wait_for_the_multi_device_slice(
            self, cfg, exc, match):
        """A mesh (an int or a Mesh) asked of a service over a meshless
        engine fails construction: the engine must be built over it. A
        host role's index must lie in its host count (the reference's
        check; host roles themselves: ``test_torch_multihost.py``)."""
        model, params, train = _setup()
        with pytest.raises(exc, match=match):
            _service(_engine(model, params, train), **cfg())


class TestSurvivingMesh:
    def test_drops_last_device_without_named_losses(self):
        mesh = pmesh.make_mesh(4, device="cpu")
        new = pmesh.surviving_mesh(mesh)
        assert new is not None and new.devices.size == 3
        assert ([int(d.id) for d in new.devices.flat]
                == [int(d.id) for d in mesh.devices.flat][:-1])

    def test_named_losses_are_dropped(self):
        mesh = pmesh.make_mesh(4, device="cpu")
        ids = [int(d.id) for d in mesh.devices.flat]
        new = pmesh.surviving_mesh(mesh, lost_ids=ids[1:3])
        assert new is not None
        assert [int(d.id) for d in new.devices.flat] == [ids[0], ids[3]]
        assert tuple(new.axis_names) == tuple(mesh.axis_names)

    def test_disjoint_losses_mean_no_shrink(self):
        # named ids not in the mesh: nothing to shrink, so the caller
        # must not rebuild onto an identical topology and retry
        mesh = pmesh.make_mesh(2, device="cpu")
        assert pmesh.surviving_mesh(mesh, lost_ids=[10 ** 9]) is None

    def test_nothing_survives(self):
        mesh = pmesh.make_mesh(1, device="cpu")
        ids = [int(d.id) for d in mesh.devices.flat]
        assert pmesh.surviving_mesh(mesh, lost_ids=ids) is None

    def test_lost_device_ids_against_backend(self, monkeypatch):
        mesh = pmesh.make_mesh(1, device="cpu")
        assert pmesh.lost_device_ids(mesh) == ()
        assert pmesh.lost_device_ids(None) == ()
        monkeypatch.setattr(pmesh, "live_device_ids", lambda: frozenset())
        assert pmesh.lost_device_ids(mesh) == tuple(
            sorted(int(d.id) for d in mesh.devices.flat))


class TestMeshShrinkRecovery:
    def _reference(self, model, params, train, pts):
        svc = _service(_engine(model, params, train), max_batch=3,
                       max_queue=64)
        return {r.id: np.asarray(r.scores).copy()
                for r in svc.run(_requests(pts))}

    def _mesh_service(self, model, params, train, ndev):
        mesh = pmesh.make_mesh(ndev, device="cpu")
        eng = _engine(model, params, train, mesh=mesh)
        return _service(eng, max_batch=3, max_queue=64, mesh=mesh)

    def test_single_loss_recovers_bit_identical(self):
        model, params, train = _setup()
        pts = _unique_points(train, 8)
        ref = self._reference(model, params, train, pts)

        svc = self._mesh_service(model, params, train, 4)
        with inject.active(
            inject.Fault("serve.dispatch", at=1,
                         kind=taxonomy.DEVICE_LOST),
            strict=True, validate=True,
        ):
            responses = svc.run(_requests(pts))

        assert all(r.ok for r in responses)
        for r in responses:
            assert np.array_equal(np.asarray(r.scores), ref[r.id])
        assert int(svc.mesh.devices.size) == 3
        assert int(svc._peek_engine().mesh.devices.size) == 3
        assert svc.rollup()["device_loss_recoveries"] == 1

    def test_consecutive_losses_keep_shrinking(self):
        model, params, train = _setup(seed=3)
        pts = _unique_points(train, 9)
        ref = self._reference(model, params, train, pts)

        svc = self._mesh_service(model, params, train, 4)
        with inject.active(
            inject.Fault("serve.dispatch", at=0,
                         kind=taxonomy.DEVICE_LOST),
            inject.Fault("serve.dispatch", at=2,
                         kind=taxonomy.DEVICE_LOST),
            strict=True, validate=True,
        ):
            responses = svc.run(_requests(pts))

        assert all(r.ok for r in responses)
        for r in responses:
            assert np.array_equal(np.asarray(r.scores), ref[r.id])
        assert int(svc.mesh.devices.size) == 2
        assert svc.rollup()["device_loss_recoveries"] == 2

    def test_zero_steady_state_compiles_after_recovery(self):
        """Re-arming after the rebuild: once the mesh has shrunk and the
        failed work re-dispatched, further traffic at the same geometries
        builds nothing."""
        from fia_tpu_torch.utils import compilemon

        model, params, train = _setup(seed=5)
        pts = _unique_points(train, 12)
        svc = self._mesh_service(model, params, train, 4)
        with inject.active(
            inject.Fault("serve.dispatch", at=1,
                         kind=taxonomy.DEVICE_LOST),
            strict=True, validate=True,
        ):
            first = svc.run(_requests(pts[:6]))
        assert all(r.ok for r in first)
        eng = svc._peek_engine()
        armed = set(eng._aot)
        assert armed, "recovery left no geometry armed"
        c0 = compilemon.count()
        more = svc.run(_requests(pts[6:]))
        assert all(r.ok for r in more)
        assert set(eng._aot) == armed, (
            "steady-state traffic after recovery armed new geometries")
        assert compilemon.count() == c0

    def test_meshless_loss_sheds_classified(self):
        """As ``TestMeshless``'s: no mesh to shrink, the batch sheds."""
        model, params, train = _setup(seed=1)
        pts = _unique_points(train, 6)
        svc = _service(_engine(model, params, train), max_batch=3,
                       max_queue=64)
        with inject.active(
            inject.Fault("serve.dispatch", at=0,
                         kind=taxonomy.DEVICE_LOST),
            strict=True, validate=True,
        ):
            responses = svc.run(_requests(pts))
        shed = [r for r in responses if not r.ok]
        assert len(shed) == 3
        assert all(r.reason == taxonomy.DEVICE_LOST for r in shed)
        assert sum(1 for r in responses if r.ok) == 3

    def test_rebuild_fault_fails_classified(self):
        """A second fault during the rebuild itself must not escape
        unclassified: recovery aborts, the batch sheds with the
        device-loss reason, the rest of the stream still serves."""
        model, params, train = _setup(seed=2)
        pts = _unique_points(train, 8)
        svc = self._mesh_service(model, params, train, 4)
        with inject.active(
            inject.Fault("serve.dispatch", at=1,
                         kind=taxonomy.DEVICE_LOST),
            inject.Fault("mesh.rebuild", at=0, kind=taxonomy.OOM),
            strict=True, validate=True,
        ):
            responses = svc.run(_requests(pts))
        shed = [r for r in responses if not r.ok]
        assert shed, "rebuild fault should shed the failed batch"
        assert all(r.reason in (taxonomy.DEVICE_LOST, taxonomy.OOM)
                   for r in shed)
        assert any(r.ok for r in responses)

    def test_upload_fault_in_rebuild_keeps_the_old_placement(self):
        """An upload that fails inside the rebuild (an OOM, which the
        retry policy does not retry) leaves the engine on its old mesh
        and replicas, in agreement with the service: the batch sheds
        classified, and the next traffic serves bitwise."""
        model, params, train = _setup(seed=4)
        pts = _unique_points(train, 8)
        ref = self._reference(model, params, train, pts)
        svc = self._mesh_service(model, params, train, 4)
        eng = svc._peek_engine()
        fp = pmesh.mesh_fingerprint(eng.mesh)
        with inject.active(
            inject.Fault("serve.dispatch", at=1,
                         kind=taxonomy.DEVICE_LOST),
            inject.Fault("engine.upload", at=0, kind=taxonomy.OOM),
            strict=True, validate=True,
        ):
            responses = svc.run(_requests(pts))
        shed = [r for r in responses if not r.ok]
        assert shed and all(r.reason in (taxonomy.DEVICE_LOST, taxonomy.OOM)
                            for r in shed)
        assert (pmesh.mesh_fingerprint(svc.mesh)
                == pmesh.mesh_fingerprint(eng.mesh) == fp)
        assert list(eng._replicas) == eng._devices()
        assert svc.rollup()["device_loss_recoveries"] == 0
        svc.invalidate()
        again = svc.run(_requests(pts))
        assert all(r.ok for r in again)
        for r in [*again, *(r for r in responses if r.ok)]:
            assert np.array_equal(np.asarray(r.scores), ref[r.id])

    def test_rebuild_upload_fault_restores_the_engine(self):
        """The engine alone: a rebuild onto the mesh without its first
        slot (a new home slot) whose upload fails restores the old mesh,
        home device and state of the engine and of its delegates, and
        the next batch is the single-device engine's bits."""
        model, params, train = _setup(seed=6)
        pts = _unique_points(train, 7)
        want = _engine(model, params, train).query_batch(pts)
        mesh = pmesh.make_mesh(4, device="cpu")
        eng = _engine(model, params, train, mesh=mesh)
        sib = eng.approx_sibling()
        before = (eng.device, eng._replicas, sib._replicas)
        with inject.active(
            inject.Fault("engine.upload", at=0, kind=taxonomy.OOM),
            strict=True, validate=True,
        ):
            with pytest.raises(Exception) as err:
                eng.rebuild_mesh(pmesh.surviving_mesh(mesh, [0]))
        assert taxonomy.classify(err.value) == taxonomy.OOM
        assert eng.mesh is mesh and sib.mesh is mesh
        assert (eng.device, eng._replicas, sib._replicas) == before
        got = eng.query_batch(pts)
        assert got._packed.tobytes() == want._packed.tobytes()
        assert got.ihvp.tobytes() == want.ihvp.tobytes()


class TestConstructionLiveness:
    def test_dead_mesh_device_fails_construction(self, monkeypatch):
        model, params, train = _setup()
        mesh = pmesh.make_mesh(1, device="cpu")
        eng = _engine(model, params, train, mesh=mesh)
        dead_id = int(next(iter(mesh.devices.flat)).id)
        monkeypatch.setattr(
            pmesh, "live_device_ids",
            lambda: frozenset(range(8)) - {dead_id},
        )
        with pytest.raises(taxonomy.DeviceLost) as ei:
            _service(eng, mesh=mesh)
        assert taxonomy.classify(ei.value) == taxonomy.DEVICE_LOST
        assert str(dead_id) in str(ei.value)
        assert ei.value.devices == [dead_id]

    def test_live_mesh_constructs(self):
        model, params, train = _setup()
        mesh = pmesh.make_mesh(1, device="cpu")
        eng = _engine(model, params, train, mesh=mesh)
        svc = _service(eng, mesh=mesh)
        assert svc.health.mode == MODE_FULL


class TestHealthController:
    def test_config_validation(self):
        with pytest.raises(ValueError):
            HealthConfig(err_recover=0.5, err_degrade=0.5).validate()
        with pytest.raises(ValueError):
            HealthConfig(queue_recover=0.9, queue_degrade=0.9).validate()
        with pytest.raises(ValueError):
            HealthConfig(min_evidence=0).validate()
        HealthConfig().validate()

    def test_replay_reproduces_transition_log(self):
        rng = np.random.default_rng(11)
        stream = [
            dict(errors=int(rng.integers(0, 3)),
                 dispatches=int(rng.integers(0, 4)),
                 queue_depth=int(rng.integers(0, 10)), queue_cap=8)
            for _ in range(200)
        ]
        a, b = HealthController(), HealthController()
        modes_a = [a.observe(**s) for s in stream]
        modes_b = [b.observe(**s) for s in stream]
        assert modes_a == modes_b
        assert a.transitions == b.transitions

    def test_error_signal_needs_evidence(self):
        hc = HealthController(HealthConfig(min_evidence=4,
                                           err_cache_only=2.0))
        assert hc.observe(errors=2, dispatches=2) == MODE_FULL
        assert hc.observe(errors=2, dispatches=2) == MODE_BANK_PREFERRED

    def test_queue_signal_needs_consecutive_saturation(self):
        hc = HealthController(HealthConfig(queue_hold=3))
        assert hc.observe(queue_depth=8, queue_cap=8) == MODE_FULL
        assert hc.observe(queue_depth=8, queue_cap=8) == MODE_FULL
        assert hc.observe(queue_depth=8, queue_cap=8) == \
            MODE_BANK_PREFERRED

    def test_queue_saturation_resets_on_calm_sample(self):
        hc = HealthController(HealthConfig(queue_hold=2))
        hc.observe(queue_depth=8, queue_cap=8)
        hc.observe(queue_depth=0, queue_cap=8)
        hc.observe(queue_depth=8, queue_cap=8)
        assert hc.mode == MODE_FULL

    def test_queue_alone_never_forces_cache_only(self):
        hc = HealthController(HealthConfig(queue_hold=1))
        for _ in range(20):
            hc.observe(queue_depth=8, queue_cap=8)
        assert hc.mode == MODE_BANK_PREFERRED

    def test_error_rate_can_jump_to_cache_only(self):
        hc = HealthController(HealthConfig(min_evidence=4))
        hc.observe(errors=4, dispatches=4)
        assert hc.mode == MODE_CACHE_ONLY
        assert [t["to"] for t in hc.transitions] == [MODE_CACHE_ONLY]

    def test_recovery_is_held_and_one_rung_at_a_time(self):
        hc = HealthController(HealthConfig(min_evidence=2, hold=2,
                                           window=4))
        hc.observe(errors=4, dispatches=4)
        assert hc.mode == MODE_CACHE_ONLY
        seen = [hc.observe(dispatches=1) for _ in range(8)]
        assert MODE_BANK_PREFERRED in seen
        assert seen[-1] == MODE_FULL
        tos = [t["to"] for t in hc.transitions]
        assert tos == [MODE_CACHE_ONLY, MODE_BANK_PREFERRED, MODE_FULL]

    def test_dead_band_prevents_flapping(self):
        cfg = HealthConfig(window=4, min_evidence=2, err_degrade=0.5,
                           err_cache_only=2.0, err_recover=0.25, hold=2)
        hc = HealthController(cfg)
        hc.observe(errors=2, dispatches=2)
        assert hc.mode == MODE_BANK_PREFERRED
        for _ in range(12):
            hc.observe(errors=1, dispatches=3)
        assert hc.mode == MODE_BANK_PREFERRED
        assert len(hc.transitions) == 1

    def test_interrupted_calm_restarts_the_hold(self):
        cfg = HealthConfig(window=2, min_evidence=2, hold=3,
                           err_cache_only=2.0)
        hc = HealthController(cfg)
        hc.observe(errors=2, dispatches=2)
        assert hc.mode == MODE_BANK_PREFERRED
        hc.observe(dispatches=1)
        hc.observe(dispatches=1)
        hc.observe(dispatches=1)
        hc.observe(dispatches=1, queue_depth=8, queue_cap=8)
        hc.observe(dispatches=1)
        hc.observe(dispatches=1)
        assert hc.mode == MODE_BANK_PREFERRED
        hc.observe(dispatches=1)
        assert hc.mode == MODE_FULL


def _bank_engine(model, params, train, tmp_path, **kw):
    eng = InfluenceEngine(
        model, params, train, damping=DAMP, solver="precomputed",
        cache_dir=str(tmp_path), model_name="degraded-test",
        lissa_depth=30, device="cpu", **kw)
    hot = fbank.select_hot_pairs(eng.index, max_entries=16,
                                 top_users=6, top_items=6)
    bank = fbank.build_bank(eng, hot)
    fp = fbank.bank_fingerprint("degraded-test", model.block_size,
                                DAMP, *eng._train_host)
    fbank.publish_bank(
        bank, fbank.default_bank_path(str(tmp_path), "degraded-test"), fp)
    assert eng.ensure_factor_bank() == len(bank) >= 6
    return eng, [(int(u), int(i)) for u, i in hot]


def _health_cfg(cls=HealthConfig, **kw):
    kw.setdefault("window", 4)
    kw.setdefault("min_evidence", 2)
    kw.setdefault("hold", 2)
    kw.setdefault("err_cache_only", 2.0)
    return cls(**kw)


class TestBrownoutServing:
    def _degrade(self, svc, misses):
        """Two all-shed drains: trusted 100% error rate."""
        with inject.active(
            inject.Fault("serve.dispatch", at=0, kind=taxonomy.WORKER),
            inject.Fault("serve.dispatch", at=1, kind=taxonomy.WORKER),
            strict=True, validate=True,
        ):
            for n, p in enumerate(misses):
                svc.submit(Request(*p, id=f"m{n}"))
                svc.drain()

    def test_bank_preferred_serves_bank_answers_misses_approx(
            self, tmp_path):
        model, params, train = _setup()
        eng, banked = _bank_engine(model, params, train, tmp_path)
        misses = [tuple(p) for p in _unique_points(train, 20)
                  if tuple(p) not in set(banked)][:3]
        ref = np.asarray(eng.query_batch(
            np.asarray([banked[0]], np.int64)).scores_of(0)).copy()

        svc = _service(eng, max_batch=4, max_queue=64,
                       health=_health_cfg())
        self._degrade(svc, misses[:2])
        assert svc.health.mode == MODE_BANK_PREFERRED

        svc.submit(Request(*banked[0], id="b0"))
        svc.submit(Request(*misses[2], id="m2"))
        got = {r.id: r for r in svc.drain()}
        b0, m2 = got["b0"], got["m2"]
        assert b0.ok and np.array_equal(np.asarray(b0.scores), ref)
        assert not b0.approx and b0.err_bound is None
        assert m2.ok and m2.approx and m2.err_bound is not None
        assert b0.mode == m2.mode == MODE_BANK_PREFERRED

        exact = _engine(model, params, train, model_name="degraded-test")
        ref_m = np.asarray(exact.query_batch(
            np.asarray([misses[2]], np.int64)).scores_of(0))
        diff = float(np.max(np.abs(np.asarray(m2.scores) - ref_m)))
        assert diff <= float(m2.err_bound) + 1e-6

        roll = svc.rollup()
        assert roll["rejected"].get(REASON_DEGRADED) is None
        assert roll["answered_approx"] == 1
        assert roll["modes"].get(MODE_BANK_PREFERRED, 0) >= 2

    def test_bank_preferred_approx_off_sheds_degraded(self, tmp_path):
        model, params, train = _setup()
        eng, banked = _bank_engine(model, params, train, tmp_path)
        misses = [tuple(p) for p in _unique_points(train, 20)
                  if tuple(p) not in set(banked)][:3]
        svc = _service(eng, max_batch=4, max_queue=64,
                       health=_health_cfg(approx_ok=False))
        self._degrade(svc, misses[:2])
        assert svc.health.mode == MODE_BANK_PREFERRED

        svc.submit(Request(*misses[2], id="m2"))
        (m2,) = svc.drain()
        assert not m2.ok and m2.reason == REASON_DEGRADED
        assert not m2.approx and m2.err_bound is None
        roll = svc.rollup()
        assert roll["rejected"].get(REASON_DEGRADED) == 1
        assert roll["answered_approx"] == 0

    def test_recovers_to_full_without_flapping(self, tmp_path):
        model, params, train = _setup()
        eng, banked = _bank_engine(model, params, train, tmp_path)
        misses = [tuple(p) for p in _unique_points(train, 20)
                  if tuple(p) not in set(banked)][:2]
        svc = _service(eng, max_batch=4, max_queue=64,
                       health=_health_cfg())
        self._degrade(svc, misses)
        assert svc.health.mode == MODE_BANK_PREFERRED

        for n, p in enumerate(banked[:6]):
            assert svc.submit(Request(*p, id=f"b{n}")) is None
            (r,) = svc.drain()
            assert r.ok
            if svc.health.mode == MODE_FULL:
                break
        assert svc.health.mode == MODE_FULL
        assert [(t["from"], t["to"]) for t in svc.health.transitions] \
            == [(MODE_FULL, MODE_BANK_PREFERRED),
                (MODE_BANK_PREFERRED, MODE_FULL)]
        assert svc.rollup()["mode_transitions"] == 2

    def test_cache_only_serves_hot_hits_only(self, tmp_path):
        model, params, train = _setup()
        eng, banked = _bank_engine(model, params, train, tmp_path)
        misses = [tuple(p) for p in _unique_points(train, 20)
                  if tuple(p) not in set(banked)][:2]
        svc = _service(eng, max_batch=4, max_queue=64,
                       health=_health_cfg(err_cache_only=0.5))
        svc.submit(Request(*banked[0], id="warm"))
        (warm,) = svc.drain()
        assert warm.ok and warm.mode == MODE_FULL

        with inject.active(
            inject.Fault("serve.dispatch", at=0, kind=taxonomy.WORKER),
            strict=True, validate=True,
        ):
            svc.submit(Request(*misses[0], id="m0"))
            svc.drain()
        assert svc.health.mode == MODE_CACHE_ONLY

        svc.submit(Request(*banked[0], id="hot"))
        svc.submit(Request(*banked[1], id="bank"))
        got = {r.id: r for r in svc.drain()}
        hot, bank = got["hot"], got["bank"]
        assert hot.ok and np.array_equal(np.asarray(hot.scores),
                                         np.asarray(warm.scores))
        assert not bank.ok and bank.reason == REASON_DEGRADED
        assert hot.mode == bank.mode == MODE_CACHE_ONLY

    def test_replayed_service_stream_sheds_identically(self, tmp_path):
        model, params, train = _setup()

        def episode(sub):
            eng, banked = _bank_engine(model, params, train, tmp_path / sub)
            misses = [tuple(p) for p in _unique_points(train, 20)
                      if tuple(p) not in set(banked)][:3]
            svc = _service(eng, max_batch=4, max_queue=64,
                           health=_health_cfg())
            self._degrade(svc, misses[:2])
            out = []
            for n, p in enumerate([banked[0], misses[2], banked[1]]):
                svc.submit(Request(*p, id=f"r{n}"))
                out += svc.drain()
            trs = [(t["from"], t["to"], t["tick"])
                   for t in svc.health.transitions]
            return [(r.id, r.status, r.reason, r.mode)
                    for r in out], trs

        assert episode("a") == episode("b")


# -- one brownout stream against the reference ---------------------------

CAP = 8


def _brownout_stream(svc, req_cls, inj, banked, misses):
    """Degrade with two shed drains, then three drains of mixed banked
    and unbanked pairs in every class (and a repeat, a hot hit)."""
    with inj.active(
        inj.Fault("serve.dispatch", at=0, kind="worker"),
        inj.Fault("serve.dispatch", at=1, kind="worker"),
        strict=True,
    ):
        for n, p in enumerate(misses[:2]):
            svc.submit(req_cls(*p, id=f"d{n}"))
            svc.drain()
    out = {}
    classes = ("interactive", "batch", "scavenger")
    waves = [
        [banked[0], misses[2], misses[3], banked[1], misses[4]],
        [misses[5], banked[2], misses[2], misses[6], banked[3]],
        [misses[7], banked[0], misses[8], banked[4], misses[9]],
    ]
    k = 0
    for wave in waves:
        for p in wave:
            svc.submit(req_cls(*p, id=f"w{k}", cls=classes[k % 3]))
            k += 1
        for r in svc.drain():
            out[r.id] = r
    return out


def test_brownout_stream_equals_reference(tmp_path):
    x, y = _data()
    ref_model = RefMF(U, I, K, WD)
    ref_params = ref_model.init_params(jax.random.PRNGKey(0))
    model = MF(U, I, K, WD)
    params = params_from_numpy(
        model, jax.tree_util.tree_map(np.asarray, ref_params), "cpu")

    ref_eng = RefEngine(ref_model, ref_params, RefDataset(x, y),
                        damping=DAMP, solver="precomputed",
                        cache_dir=str(tmp_path / "ref"),
                        model_name="degraded-test", lissa_depth=30,
                        sampled_cap=CAP)
    hot = ref_fbank.select_hot_pairs(ref_eng.index, max_entries=16,
                                     top_users=6, top_items=6)
    ref_fbank.publish_bank(
        ref_fbank.build_bank(ref_eng, hot),
        ref_fbank.default_bank_path(str(tmp_path / "ref"),
                                    "degraded-test"),
        ref_fbank.bank_fingerprint("degraded-test", ref_model.block_size,
                                   DAMP, *ref_eng._train_host))
    assert ref_eng.ensure_factor_bank() == len(hot)
    eng, banked = _bank_engine(model, params, RatingDataset(x, y),
                               tmp_path / "port", sampled_cap=CAP)
    assert [tuple(p) for p in hot.tolist()] == banked
    misses = [tuple(p) for p in _unique_points(RatingDataset(x, y), 40)
              if tuple(p) not in set(banked)][:10]

    cfg = dict(max_batch=4, max_queue=64, disk_cache=False)
    ref = _brownout_stream(
        RefService(engine=ref_eng, config=RefConfig(
            health=_health_cfg(RefHealthConfig), **cfg)),
        RefRequest, ref_inject, banked, misses)
    got = _brownout_stream(
        InfluenceService(engine=eng, config=ServeConfig(
            health=_health_cfg(), **cfg)),
        Request, inject, banked, misses)

    assert sorted(got) == sorted(ref)
    n_approx = n_bank = 0
    for rid, r in ref.items():
        g = got[rid]
        assert (g.status, g.reason, g.cache_tier, g.mode, g.approx,
                g.batch_id) == (r.status, r.reason, r.cache_tier, r.mode,
                                r.approx, r.batch_id), rid
        if not r.ok:
            continue
        assert np.array_equal(g.related, r.related)
        if r.cache_tier == "precomputed" or (
                not r.approx and tuple((r.user, r.item)) in set(banked)):
            n_bank += 1
            assert spearman(g.scores, np.asarray(r.scores)) >= BANK_RHO
        else:
            np.testing.assert_allclose(g.scores, np.asarray(r.scores),
                                       rtol=RTOL, atol=ATOL)
        if r.approx:
            n_approx += 1
            np.testing.assert_allclose(g.err_bound, r.err_bound,
                                       rtol=BOUND_RTOL)
        else:
            assert g.err_bound is None and r.err_bound is None
    assert n_approx >= 3 and n_bank >= 3
    assert any(r.err_bound > 0 for r in ref.values() if r.approx)
    assert any(not r.approx and r.ok for r in ref.values())

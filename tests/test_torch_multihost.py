"""Multi-host serving in the port (``fia_tpu_torch/serve/hostshard.py``,
``ServeConfig.host_role``, the host-loss shrink) on the CPU.

Restates ``tests/test_multihost.py`` (all 34) port against port, over 8
virtual CPU slots (``parallel.mesh.virtual_devices``) with a
``virtual_hosts`` overlay for the host topology, as the reference runs on
8 virtual XLA devices: the ``host_lost`` taxonomy, the host topology and
fingerprint, ``shard_rows``, the shard journals (merge bitwise one
process, resume without recompute, a missing peer classified
``host_lost`` on a ``VirtualClock``, a foreign fingerprint never merged;
a journal mid-publish polled, not quarantined),
the service's host-granular shrink (bitwise the meshless service) and a
meshless host loss shed classified, construction liveness naming whole
hosts, host roles (adoption, then resume) and the class deadlines.

Added: two host roles serving at once over one journal directory (two
threads, each with its own engine) answer bitwise one service, with the
single-process batch ids and dispatch log, and a restarted host resumes
with no ``query_many`` call; a host role on a mesh; the
``mesh.rebuild_multihost`` site firing on a shrink whose survivors still
span hosts. Against the reference: ``shard_rows``, ``shard_path`` and
``shard_fingerprint`` are its values, and a host-role stream over the
reference's params answers within the reference's two-process bar (rtol
1e-4 / atol 1e-6) of the reference's service, related rows exactly.
"""

import os
import threading

import jax
import numpy as np
import pytest
import torch

from fia_tpu.data.dataset import RatingDataset as RefDataset
from fia_tpu.influence.engine import InfluenceEngine as RefEngine
from fia_tpu.models import MF as RefMF
from fia_tpu.serve import InfluenceService as RefService
from fia_tpu.serve import Request as RefRequest
from fia_tpu.serve import ServeConfig as RefConfig
from fia_tpu.serve import hostshard as ref_hostshard
from fia_tpu_torch.data.dataset import RatingDataset
from fia_tpu_torch.influence.engine import InfluenceEngine
from fia_tpu_torch.models import MF, params_from_numpy
from fia_tpu_torch.parallel import mesh as pmesh
from fia_tpu_torch.reliability import inject, policy as rpolicy, taxonomy
from fia_tpu_torch.serve import InfluenceService, Request, ServeConfig
from fia_tpu_torch.serve import hostshard
from fia_tpu_torch.serve.admission import AdmissionController
from fia_tpu_torch.serve.request import CLASS_SLOS

torch.set_num_threads(2)

U, I, K = 30, 20, 4
WD = 1e-2
DAMP = 1e-3


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
    clock = cfg.pop("clock", None)
    kw = {"clock": clock} if clock is not None else {}
    return InfluenceService(engine=engine, config=ServeConfig(**cfg), **kw)


def _mesh(n):
    return pmesh.make_mesh(n, device="cpu")


def _unique_points(train, n):
    uniq = np.unique(train.x, axis=0)
    assert len(uniq) >= n
    return uniq[:n].astype(np.int64)


def _requests(pts):
    return [Request(int(u), int(i), id=f"q{n}")
            for n, (u, i) in enumerate(pts)]


def _two_host_overlay(mesh):
    """First half of the mesh slots on host 0, second half on 1."""
    devs = [int(d.id) for d in mesh.devices.flat]
    half = len(devs) // 2
    return {d: (0 if k < half else 1) for k, d in enumerate(devs)}


class _PublishOnSleep(rpolicy.VirtualClock):
    """A virtual clock whose first sleep finishes a peer's publish: the
    manifest moved aside comes back."""

    def __init__(self, manifest: str):
        super().__init__()
        self.manifest = manifest

    def sleep(self, seconds: float) -> None:
        if os.path.exists(self.manifest + ".held"):
            os.replace(self.manifest + ".held", self.manifest)
        super().sleep(seconds)


def _boom(*a, **kw):
    raise AssertionError("resume path recomputed a journaled shard")


class TestHostLostTaxonomy:
    def test_exception_type_classifies(self):
        assert taxonomy.classify(
            taxonomy.HostLost("host 2 gone")) == taxonomy.HOST_LOST

    @pytest.mark.parametrize("msg", [
        "DEADLINE_EXCEEDED: collective operation timed out waiting "
        "for peer task",
        "coordination service reports task unavailable: missed "
        "heartbeat from worker 3",
        "UNAVAILABLE: host worker-2 unreachable on the DCN",
    ])
    def test_message_signatures(self, msg):
        assert taxonomy.classify(RuntimeError(msg)) == taxonomy.HOST_LOST

    def test_injected_message_classifies(self):
        # the injection harness produces the classification a real
        # host loss would
        assert taxonomy.classify(RuntimeError(
            inject.MESSAGES[taxonomy.HOST_LOST])) == taxonomy.HOST_LOST

    def test_device_signatures_stay_device_lost(self):
        # host-loss evidence mentions devices too; plain device-loss
        # messages must not get promoted to host granularity
        assert taxonomy.classify(RuntimeError(
            "device tpu:2 is in an unhealthy state"
        )) == taxonomy.DEVICE_LOST

    def test_neither_transient_nor_size_evidence(self):
        # a dead host stays dead: retry and batch-halving both useless
        assert taxonomy.HOST_LOST not in taxonomy.TRANSIENT
        assert taxonomy.HOST_LOST not in taxonomy.SIZE_EVIDENCE


class TestHostTopology:
    def test_virtual_overlay_and_fallback(self):
        mesh = _mesh(4)
        devs = list(mesh.devices.flat)
        with pmesh.virtual_hosts({int(devs[0].id): 7}):
            assert pmesh.host_index(devs[0]) == 7
            # slots absent from the map keep their own process index
            assert pmesh.host_index(devs[1]) == int(devs[1].process_index)
        assert pmesh.host_index(devs[0]) == int(devs[0].process_index)

    def test_mesh_hosts_sorted_distinct(self):
        mesh = _mesh(4)
        with pmesh.virtual_hosts(_two_host_overlay(mesh)):
            assert pmesh.mesh_hosts(mesh) == (0, 1)
        assert pmesh.mesh_hosts(None) == ()

    def test_lost_host_ids_needs_whole_host_dark(self, monkeypatch):
        mesh = _mesh(4)
        ids = [int(d.id) for d in mesh.devices.flat]
        with pmesh.virtual_hosts(_two_host_overlay(mesh)):
            assert pmesh.lost_host_ids(mesh) == ()
            # one of host 1's slots dead: device loss, NOT host loss
            monkeypatch.setattr(
                pmesh, "live_device_ids",
                lambda: frozenset(i for i in ids if i != ids[2]))
            assert pmesh.lost_host_ids(mesh) == ()
            # both of host 1's slots dead: the host is lost
            monkeypatch.setattr(pmesh, "live_device_ids",
                                lambda: frozenset(ids[:2]))
            assert pmesh.lost_host_ids(mesh) == (1,)

    def test_surviving_mesh_drops_named_host(self):
        mesh = _mesh(4)
        ids = [int(d.id) for d in mesh.devices.flat]
        with pmesh.virtual_hosts(_two_host_overlay(mesh)):
            new = pmesh.surviving_mesh(mesh, lost_hosts=[0])
            assert new is not None
            assert [int(d.id) for d in new.devices.flat] == ids[2:]

    def test_unnamed_host_drops_last_devices_host(self):
        mesh = _mesh(4)
        ids = [int(d.id) for d in mesh.devices.flat]
        with pmesh.virtual_hosts(_two_host_overlay(mesh)):
            new = pmesh.surviving_mesh(mesh, unnamed="host")
            assert new is not None
            assert [int(d.id) for d in new.devices.flat] == ids[:2]

    def test_host_drop_preserves_model_axis(self):
        # 4 hosts x 2 slots laid out (4, 2) data x model: losing one
        # host leaves 6 survivors = 3 full model groups
        mesh = pmesh.make_mesh(8, axis_names=("data", "model"),
                               shape=(4, 2), device="cpu")
        overlay = {int(d.id): k // 2
                   for k, d in enumerate(mesh.devices.flat)}
        with pmesh.virtual_hosts(overlay):
            new = pmesh.surviving_mesh(mesh, lost_hosts=[1])
            assert new is not None
            assert dict(new.shape) == {"data": 3, "model": 2}

    def test_ragged_host_drop_trims_to_full_model_groups(self):
        # 2 hosts x 3 slots, model=2: losing a host leaves 3 survivors —
        # only one full model group fits, the excess survivor is dropped
        # rather than re-replicating tables
        mesh = pmesh.make_mesh(6, axis_names=("data", "model"),
                               shape=(3, 2), device="cpu")
        overlay = {int(d.id): k // 3
                   for k, d in enumerate(mesh.devices.flat)}
        with pmesh.virtual_hosts(overlay):
            new = pmesh.surviving_mesh(mesh, lost_hosts=[1])
            assert new is not None
            assert dict(new.shape) == {"data": 1, "model": 2}


class TestMeshFingerprint:
    def test_stable_across_rebuilds(self):
        # a restarted host rebuilding the same topology computes the
        # same fingerprint (journal and program-cache reuse)
        assert pmesh.mesh_fingerprint(_mesh(4)) == pmesh.mesh_fingerprint(
            _mesh(4))
        with pmesh.virtual_hosts(_two_host_overlay(_mesh(4))):
            fa = pmesh.mesh_fingerprint(_mesh(4))
            fb = pmesh.mesh_fingerprint(_mesh(4))
        assert fa == fb

    def test_keyed_on_host_layout(self):
        mesh = _mesh(4)
        base = pmesh.mesh_fingerprint(mesh)
        with pmesh.virtual_hosts(_two_host_overlay(mesh)):
            split = pmesh.mesh_fingerprint(mesh)
        assert base != split
        # the host layout is the 4th leg
        assert len(split) == 4 and split[:3] == base[:3]


class TestShardRows:
    def test_even_split(self):
        assert hostshard.shard_rows(8, 2) == [(0, 4), (4, 8)]

    def test_ragged_alignment_keeps_batch_boundaries(self):
        # 12 rows in batches of 5 -> 3 units; 2 units to host 0
        assert hostshard.shard_rows(12, 2, align=5) == [(0, 10), (10, 12)]

    def test_hosts_past_the_work_get_empty_ranges(self):
        rows = hostshard.shard_rows(3, 4, align=2)
        assert rows == [(0, 2), (2, 3), (3, 3), (3, 3)]

    def test_ranges_partition_exactly(self):
        for n, nhosts, align in [(0, 2, 4), (7, 3, 2), (24, 5, 8)]:
            rows = hostshard.shard_rows(n, nhosts, align)
            assert rows[0][0] == 0 and rows[-1][1] == n
            for (a, b), (c, d) in zip(rows, rows[1:]):
                assert b == c and a <= b

    def test_rejects_no_hosts(self):
        with pytest.raises(ValueError):
            hostshard.shard_rows(4, 0)

    def test_partition_path_and_fingerprint_equal_reference(self):
        for n in range(0, 40, 3):
            for nhosts in (1, 2, 3, 5):
                for align in (1, 4, 7):
                    assert hostshard.shard_rows(n, nhosts, align) == \
                        ref_hostshard.shard_rows(n, nhosts, align)
        pts = np.arange(20, dtype=np.int64).reshape(10, 2)
        for h in range(3):
            assert hostshard.shard_path("/j", "drain4", h, 3) == \
                ref_hostshard.shard_path("/j", "drain4", h, 3)
            assert hostshard.shard_fingerprint("fp", "drain4", h, 3, pts) \
                == ref_hostshard.shard_fingerprint("fp", "drain4", h, 3, pts)


class TestHostShardJournals:
    MB = 3

    def _dispatch_all(self, eng, pts, jdir, nhosts=2, tag="t1"):
        for h in range(nhosts):
            hostshard.dispatch_local_shard(
                eng, pts, host=h, nhosts=nhosts, journal_dir=str(jdir),
                tag=tag, engine_fp="fp-a", max_batch=self.MB)

    def test_merge_bitwise_identical_to_single_process(self, tmp_path):
        model, params, train = _setup()
        eng = _engine(model, params, train)
        pts = _unique_points(train, 8)
        ref = hostshard._pack_result(
            eng.query_many(pts, batch_queries=self.MB))
        self._dispatch_all(eng, pts, tmp_path)
        merged = hostshard.merge_host_shards(
            str(tmp_path), "t1", 2, pts, engine_fp="fp-a",
            max_batch=self.MB, timeout_s=5.0)
        for key in ("scores", "counts", "ihvp", "test_grad"):
            assert np.array_equal(np.asarray(merged[key]),
                                  np.asarray(ref[key])), key
        assert merged["offsets"][-1] == merged["scores"].size

    def test_resume_skips_recompute(self, tmp_path, monkeypatch):
        model, params, train = _setup(seed=1)
        eng = _engine(model, params, train)
        pts = _unique_points(train, 6)
        self._dispatch_all(eng, pts, tmp_path)
        # a restarted host resumes from its verified journal — if it
        # recomputes, this engine now explodes
        monkeypatch.setattr(eng, "query_many", _boom)
        self._dispatch_all(eng, pts, tmp_path)

    def test_missing_peer_times_out_classified(self, tmp_path):
        model, params, train = _setup(seed=2)
        eng = _engine(model, params, train)
        pts = _unique_points(train, 6)
        hostshard.dispatch_local_shard(
            eng, pts, host=0, nhosts=2, journal_dir=str(tmp_path),
            tag="t1", engine_fp="fp-a", max_batch=self.MB)
        clock = rpolicy.VirtualClock()
        with pytest.raises(taxonomy.HostLost) as ei:
            hostshard.merge_host_shards(
                str(tmp_path), "t1", 2, pts, engine_fp="fp-a",
                max_batch=self.MB, timeout_s=1.0, clock=clock)
        assert taxonomy.classify(ei.value) == taxonomy.HOST_LOST
        assert "[1]" in str(ei.value)
        # the wait ran on the virtual clock: one poll past the budget
        assert 1.0 <= clock.monotonic() < 1.2

    def test_foreign_fingerprint_is_a_verified_miss(self, tmp_path):
        # a journal from another engine generation must never merge
        model, params, train = _setup(seed=3)
        eng = _engine(model, params, train)
        pts = _unique_points(train, 6)
        self._dispatch_all(eng, pts, tmp_path)
        with pytest.raises(taxonomy.HostLost):
            hostshard.merge_host_shards(
                str(tmp_path), "t1", 2, pts, engine_fp="fp-b",
                max_batch=self.MB, timeout_s=0.0,
                clock=rpolicy.VirtualClock())
        # nor a journal of other query bytes under the same tag
        with pytest.raises(taxonomy.HostLost):
            hostshard.merge_host_shards(
                str(tmp_path), "t1", 2, pts[::-1].copy(), engine_fp="fp-a",
                max_batch=self.MB, timeout_s=0.0,
                clock=rpolicy.VirtualClock())


    def test_journal_mid_publish_is_polled_not_quarantined(self, tmp_path):
        """A peer's journal whose data file has landed but whose manifest
        has not is still being published: the merge polls it again and
        merges it once the manifest lands (the reference's merge
        quarantines it). A journal failing its checksum is quarantined."""
        from fia_tpu_torch.reliability import artifacts

        model, params, train = _setup(seed=4)
        eng = _engine(model, params, train)
        pts = _unique_points(train, 6)
        self._dispatch_all(eng, pts, tmp_path)
        path = hostshard.shard_path(str(tmp_path), "t1", 1, 2)
        manifest = artifacts.manifest_path(path)
        os.replace(manifest, manifest + ".held")
        clock = _PublishOnSleep(manifest)
        merged = hostshard.merge_host_shards(
            str(tmp_path), "t1", 2, pts, engine_fp="fp-a",
            max_batch=self.MB, timeout_s=1.0, clock=clock)
        assert 0 < clock.monotonic() < 1.0
        assert merged["counts"].sum() == merged["scores"].size
        assert not os.path.exists(path + ".corrupt")
        with open(path, "r+b") as f:  # rot one byte of the data file
            f.seek(40)
            b = f.read(1)
            f.seek(40)
            f.write(bytes([b[0] ^ 0xFF]))
        with pytest.raises(taxonomy.HostLost):
            hostshard.merge_host_shards(
                str(tmp_path), "t1", 2, pts, engine_fp="fp-a",
                max_batch=self.MB, timeout_s=0.0,
                clock=rpolicy.VirtualClock())
        assert os.path.exists(path + ".corrupt")


class TestServiceHostLossRecovery:
    def _reference(self, model, params, train, pts):
        svc = _service(_engine(model, params, train), max_batch=3,
                       max_queue=64)
        return {r.id: np.asarray(r.scores).copy()
                for r in svc.run(_requests(pts))}

    def test_host_loss_recovers_bit_identical(self):
        model, params, train = _setup()
        pts = _unique_points(train, 8)
        ref = self._reference(model, params, train, pts)
        mesh = _mesh(4)
        with pmesh.virtual_hosts(_two_host_overlay(mesh)):
            eng = _engine(model, params, train, mesh=mesh)
            svc = _service(eng, max_batch=3, max_queue=64, mesh=mesh)
            with inject.active(
                inject.Fault("serve.dispatch", at=1,
                             kind=taxonomy.HOST_LOST),
                strict=True, validate=True,
            ):
                responses = svc.run(_requests(pts))
            assert all(r.ok for r in responses)
            for r in responses:
                assert np.array_equal(np.asarray(r.scores), ref[r.id])
            # a host-granular shrink: BOTH of the lost host's slots left
            # the mesh at once
            assert int(svc.mesh.devices.size) == 2
            assert int(svc._peek_engine().mesh.devices.size) == 2
            assert svc.rollup()["host_loss_recoveries"] == 1
            assert svc.rollup()["device_loss_recoveries"] == 0

    def test_meshless_host_loss_sheds_classified(self):
        model, params, train = _setup(seed=1)
        pts = _unique_points(train, 6)
        svc = _service(_engine(model, params, train), max_batch=3,
                       max_queue=64)
        with inject.active(
            inject.Fault("serve.dispatch", at=0,
                         kind=taxonomy.HOST_LOST),
            strict=True, validate=True,
        ):
            responses = svc.run(_requests(pts))
        shed = [r for r in responses if not r.ok]
        assert len(shed) == 3
        assert all(r.reason == taxonomy.HOST_LOST for r in shed)

    def test_shrink_over_surviving_hosts_fires_multihost_site(self):
        """Three virtual hosts: the survivors of one host's loss still
        span two, so the rebuild fires ``mesh.rebuild_multihost``; the
        answers stay bitwise the meshless service's."""
        model, params, train = _setup(seed=4)
        pts = _unique_points(train, 9)
        ref = self._reference(model, params, train, pts)
        mesh = _mesh(6)
        overlay = {int(d.id): k // 2 for k, d in enumerate(mesh.devices.flat)}
        with pmesh.virtual_hosts(overlay):
            eng = _engine(model, params, train, mesh=mesh)
            svc = _service(eng, max_batch=3, max_queue=64, mesh=mesh)
            with inject.active(
                inject.Fault("serve.dispatch", at=1,
                             kind=taxonomy.HOST_LOST),
                strict=True, validate=True,
            ) as inj:
                responses = svc.run(_requests(pts))
            assert pmesh.mesh_hosts(svc.mesh) == (0, 1)
        assert inj.counts.get("mesh.rebuild_multihost") == 1
        assert inj.counts.get("host.lost") == 1
        assert all(r.ok for r in responses)
        for r in responses:
            assert np.array_equal(np.asarray(r.scores), ref[r.id])
        assert svc.rollup()["host_loss_recoveries"] == 1


class TestConstructionLivenessNamesCulprits:
    def test_whole_host_dark_raises_host_lost_with_members(
            self, monkeypatch):
        model, params, train = _setup()
        mesh = _mesh(4)
        ids = [int(d.id) for d in mesh.devices.flat]
        with pmesh.virtual_hosts(_two_host_overlay(mesh)):
            eng = _engine(model, params, train, mesh=mesh)
            monkeypatch.setattr(pmesh, "live_device_ids",
                                lambda: frozenset(ids[:2]))
            with pytest.raises(taxonomy.HostLost) as ei:
                _service(eng, mesh=mesh)
        assert taxonomy.classify(ei.value) == taxonomy.HOST_LOST
        # the classified error names exactly which members failed
        assert sorted(ei.value.devices) == sorted(ids[2:])
        assert ei.value.hosts == [1]
        assert "host(s) [1]" in str(ei.value)

    def test_partial_host_raises_device_lost(self, monkeypatch):
        model, params, train = _setup()
        mesh = _mesh(4)
        ids = [int(d.id) for d in mesh.devices.flat]
        with pmesh.virtual_hosts(_two_host_overlay(mesh)):
            eng = _engine(model, params, train, mesh=mesh)
            monkeypatch.setattr(
                pmesh, "live_device_ids",
                lambda: frozenset(i for i in ids if i != ids[3]))
            with pytest.raises(taxonomy.DeviceLost) as ei:
                _service(eng, mesh=mesh)
        assert ei.value.devices == [ids[3]]
        assert ei.value.hosts == []


def _single(model, params, train, pts, **cfg):
    """The one-process service's answers and dispatch log."""
    svc = _service(_engine(model, params, train), max_batch=3,
                   max_queue=64, **cfg)
    out = svc.run(_requests(pts))
    return {r.id: r for r in out}, svc.dispatch_log


class TestHostRoleDispatch:
    def test_two_host_roles_serve_reference_bytes(self, tmp_path):
        model, params, train = _setup()
        pts = _unique_points(train, 9)
        ref, _ = _single(model, params, train, pts)
        eng = _engine(model, params, train)
        # host 0 drains first: its merge times out waiting for host 1
        # (which never ran) and ADOPTS that shard via the journals
        svc0 = _service(eng, max_batch=3, max_queue=64,
                        host_role=(0, 2, str(tmp_path)),
                        host_merge_timeout_s=0.5,
                        clock=rpolicy.VirtualClock())
        r0 = svc0.run(_requests(pts))
        assert all(r.ok for r in r0)
        for r in r0:
            assert np.array_equal(np.asarray(r.scores), ref[r.id].scores)
        assert svc0.rollup()["host_loss_recoveries"] == 1
        # host 1 then RESUMES from the journals host 0 published for it
        # — no adoption, no recompute, same bytes
        svc1 = _service(eng, max_batch=3, max_queue=64,
                        host_role=(1, 2, str(tmp_path)),
                        host_merge_timeout_s=0.5,
                        clock=rpolicy.VirtualClock())
        r1 = svc1.run(_requests(pts))
        assert all(r.ok for r in r1)
        for r in r1:
            assert np.array_equal(np.asarray(r.scores), ref[r.id].scores)
        assert svc1.rollup()["host_loss_recoveries"] == 0

    def test_host_role_validates_index(self):
        model, params, train = _setup()
        eng = _engine(model, params, train)
        with pytest.raises(ValueError):
            _service(eng, host_role=(2, 2, "/tmp/x"))

    def test_concurrent_roles_bitwise_one_service_and_restart_resumes(
            self, tmp_path, monkeypatch):
        """Two hosts serving the same stream at once, each its own engine
        over one journal directory: every answer (scores, iHVP, test
        gradient, related rows) and the batch ids and dispatch log are
        the one-process service's; neither adopts. A restarted host 1
        then resumes from the journals without a ``query_many`` call."""
        model, params, train = _setup(seed=5)
        pts = _unique_points(train, 11)
        ref, ref_log = _single(model, params, train, pts)
        svcs = [_service(_engine(model, params, train), max_batch=3,
                         max_queue=64, host_role=(h, 2, str(tmp_path)),
                         host_merge_timeout_s=60.0) for h in (0, 1)]
        out, errs = [None, None], []

        def serve(h):
            try:
                out[h] = svcs[h].run(_requests(pts))
            except Exception as e:  # surfaced below
                errs.append(e)

        threads = [threading.Thread(target=serve, args=(h,)) for h in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not errs and all(o is not None for o in out), errs
        for svc, got in zip(svcs, out):
            assert svc.rollup()["host_loss_recoveries"] == 0
            assert [b for b, _ in svc.dispatch_log] == [b for b, _ in
                                                         ref_log]
            for (_, a), (_, b) in zip(svc.dispatch_log, ref_log):
                assert np.array_equal(a, b)
            for r in got:
                want = ref[r.id]
                assert r.ok and r.batch_id == want.batch_id
                for f in ("scores", "ihvp", "test_grad", "related"):
                    assert np.asarray(getattr(r, f)).tobytes() == \
                        np.asarray(getattr(want, f)).tobytes(), f
        restarted = _engine(model, params, train)
        monkeypatch.setattr(restarted, "query_many", _boom)
        again = _service(restarted, max_batch=3, max_queue=64,
                         host_role=(1, 2, str(tmp_path)),
                         host_merge_timeout_s=0.0,
                         clock=rpolicy.VirtualClock()).run(_requests(pts))
        for r in again:
            assert np.array_equal(np.asarray(r.scores), ref[r.id].scores)

    def test_host_role_on_a_mesh_is_bitwise(self, tmp_path):
        """A host role whose engine runs over a 4-slot mesh: each shard
        through the mesh's ``query_many``, the merge bitwise one
        meshless service."""
        model, params, train = _setup(seed=6)
        pts = _unique_points(train, 10)
        ref, _ = _single(model, params, train, pts)
        mesh = _mesh(4)
        eng = _engine(model, params, train, mesh=mesh)
        svc = _service(eng, max_batch=3, max_queue=64, mesh=mesh,
                       host_role=(0, 1, str(tmp_path)))
        for r in svc.run(_requests(pts)):
            assert np.array_equal(np.asarray(r.scores), ref[r.id].scores)

    def test_host_role_stream_matches_reference_service(self, tmp_path):
        """The reference's params through both packages: a two-role
        stream (host 0 adopting host 1's shard) against the reference's
        one-host service, related rows exactly, scores at the
        reference's two-process bar."""
        x, y = _data(seed=7)
        ref_model = RefMF(U, I, K, WD)
        arrays = jax.tree_util.tree_map(
            np.asarray, ref_model.init_params(jax.random.PRNGKey(7)))
        pts = _unique_points(RatingDataset(x, y), 9)
        ref_eng = RefEngine(ref_model, arrays, RefDataset(x, y),
                            damping=DAMP, solver="direct")
        want = {r.id: r for r in RefService(
            engine=ref_eng, config=RefConfig(max_batch=3, max_queue=64,
                                             disk_cache=False)).run(
            [RefRequest(int(u), int(i), id=f"q{n}")
             for n, (u, i) in enumerate(pts)])}
        model = MF(U, I, K, WD)
        eng = _engine(model, params_from_numpy(model, arrays, "cpu"),
                      RatingDataset(x, y))
        got = _service(eng, max_batch=3, max_queue=64,
                       host_role=(0, 2, str(tmp_path)),
                       host_merge_timeout_s=0.1,
                       clock=rpolicy.VirtualClock()).run(_requests(pts))
        for r in got:
            w = want[r.id]
            assert r.ok and r.batch_id == w.batch_id
            assert np.array_equal(np.asarray(r.related),
                                  np.asarray(w.related))
            np.testing.assert_allclose(np.asarray(r.scores),
                                       np.asarray(w.scores),
                                       rtol=1e-4, atol=1e-6)


class TestClassDeadlines:
    def test_true_resolves_published_slos(self):
        model, params, train = _setup()
        svc = _service(_engine(model, params, train), class_deadlines=True)
        assert svc.class_deadlines == CLASS_SLOS
        # slack derives from the tightest SLO when not pinned
        assert svc.deadline_slack_s == pytest.approx(
            0.25 * min(CLASS_SLOS.values()))

    def test_dict_merges_over_slos_and_slack_stays_pinnable(self):
        model, params, train = _setup()
        svc = _service(_engine(model, params, train),
                       class_deadlines={"batch": 5.0},
                       deadline_slack_s=0.05)
        assert svc.class_deadlines["batch"] == 5.0
        assert svc.class_deadlines["interactive"] == (
            CLASS_SLOS["interactive"])
        assert svc.deadline_slack_s == 0.05

    def test_off_by_default(self):
        model, params, train = _setup()
        svc = _service(_engine(model, params, train))
        assert svc.class_deadlines is None
        assert svc.deadline_slack_s is None

    def test_ticket_budget_resolution_order(self):
        adm = AdmissionController(class_deadlines={"interactive": 0.5},
                                  default_deadline_s=9.0)
        # explicit deadline wins over the class SLO
        t = adm.ticket(Request(1, 1, cls="interactive", deadline_s=2.0),
                       now=100.0)
        assert t.t_deadline == pytest.approx(102.0)
        # no explicit deadline: the class SLO applies
        t = adm.ticket(Request(1, 1, cls="interactive"), now=100.0)
        assert t.t_deadline == pytest.approx(100.5)
        # classes without an SLO fall through to the global default
        t = adm.ticket(Request(1, 1, cls="batch"), now=100.0)
        assert t.t_deadline == pytest.approx(109.0)

    def test_unknown_class_rejected(self):
        with pytest.raises(ValueError):
            AdmissionController(class_deadlines={"vip": 1.0})

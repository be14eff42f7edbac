"""The port's multi-process runtime (``fia_tpu_torch.parallel.
distributed``) on the CPU, restating ``tests/test_distributed.py``.

One process (8 virtual slots) for the helpers, and a REAL two-process
run: this file run as a script is the worker (``python
tests/test_torch_distributed.py --process_id P --coordinator
127.0.0.1:PORT --params F --out F``). Each worker lays 4 virtual CPU
slots, joins a gloo group on loopback, and builds the global
``make_hybrid_mesh(model_parallel=2)`` (4 x 2, the ``model`` rows inside
a process). On it: the sharded flat ``query_batch`` and ``query_many``,
the sharded padded program, ``block_hessians``, ``FullInfluenceEngine``'s
CG influence, a few data-parallel ``Trainer.fit`` steps and
``loo_retrain_many``. Every result is held BITWISE against the
one-process 8-slot mesh of the same layout (each shard runs the same
program; the exchanges stitch and sum in global slot order), and the
influence at the reference's bars against the JAX package's
single-process engines (rtol 1e-4 / atol 1e-6 for the flat scores, the
reference's own two-process bar; ``test_torch_full.py``'s port-against-
reference rtol 5e-3 / atol 1e-6 for the full CG influence). On the same
mesh each process runs an ``InfluenceService`` over the same request
stream: its answers and batch ids are the one-process mesh service's,
bit for bit. The sharded engine's params are saved by both processes
(``train/checkpoint_orbax.py``, collective over the group), restored and
queried again: the same bits. Each worker joins with ``local_device_ids=[0]``; ROADMAP
C.7's slot layout over given CUDA ordinals is held in one process
(``TestLocalDeviceIds``).
``mp_worker.py``'s ``row_features="on"`` leg is left out: the fused
row-feature table is not ported (ROADMAP Queue A.6b).
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from fia_tpu_torch.data.dataset import RatingDataset  # noqa: E402
from fia_tpu_torch.influence.engine import InfluenceEngine  # noqa: E402
from fia_tpu_torch.influence.full import FullInfluenceEngine  # noqa: E402
from fia_tpu_torch.models import MF  # noqa: E402
from fia_tpu_torch.parallel import distributed as D  # noqa: E402
from fia_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from fia_tpu_torch.parallel.sharded import whole_params  # noqa: E402
from fia_tpu_torch.reliability import taxonomy  # noqa: E402
from fia_tpu_torch.serve import (  # noqa: E402
    InfluenceService,
    Request,
    ServeConfig,
)
from fia_tpu_torch.train import checkpoint_orbax as co  # noqa: E402
from fia_tpu_torch.train.trainer import (  # noqa: E402
    Trainer,
    TrainConfig,
    loo_retrain_many,
)

torch.set_num_threads(2)

N, USERS, ITEMS, K = 400, 20, 16, 4
PTS = np.array([[3, 5], [0, 1], [7, 2], [11, 9], [1, 1], [19, 15]],
               np.int64)
FIT = dict(batch_size=50, num_steps=12, learning_rate=1e-2, seed=3)
LOO = dict(removed=[5, 9, 123, -1, 77], seeds=[0, 1, 2, 3, 4], steps=10,
           batch=50)


def _data():
    rng = np.random.default_rng(0)
    x = np.stack([rng.integers(0, USERS, N), rng.integers(0, ITEMS, N)],
                 axis=1).astype(np.int32)
    y = rng.integers(1, 6, N).astype(np.float32)
    return RatingDataset(x, y)


def _run_all(mesh, params, ckpt_dir: str) -> dict:
    """Every multi-process path on ``mesh``: host results by name (the
    same calls, in the same order, on every process); the sharded
    checkpoint goes to ``ckpt_dir`` (one directory every process
    shares)."""
    model = MF(USERS, ITEMS, K, 1e-3)
    train = _data()
    out = {}
    flat = InfluenceEngine(model, params, train, damping=1e-3, mesh=mesh,
                           shard_tables=True, impl="flat", device="cpu")
    assert flat._flat_eligible() and flat._sharded_now()
    res = flat.query_batch(PTS)
    out.update(flat_packed=res._packed, flat_ihvp=res.ihvp,
               flat_v=res.test_grad, counts=res.counts)
    many = flat.query_many(PTS, batch_queries=4)
    out["many_packed"] = np.concatenate([r._packed for r in many])
    out["hessians"] = flat.block_hessians(PTS)
    padded = InfluenceEngine(model, params, train, damping=1e-3, mesh=mesh,
                             shard_tables=True, impl="padded", device="cpu")
    res = padded.query_batch(PTS)
    out.update(padded_packed=res._packed, padded_ihvp=res.ihvp)
    full = FullInfluenceEngine(model, params, train, damping=1.0,
                               solver="cg", cg_maxiter=50, mesh=mesh,
                               hvp_batch=100, device="cpu")
    out["full_scores"] = full.get_influence_on_test_loss(train.x[:2],
                                                         train.y[:2])
    # the service over the mesh: every process serves the same stream
    svc = InfluenceService(engine=flat, config=ServeConfig(
        mesh=mesh, max_batch=4, disk_cache=False))
    answers = svc.run([Request(int(u), int(i)) for u, i in PTS])
    assert all(r.ok for r in answers)
    out["serve_scores"] = np.concatenate([r.scores for r in answers])
    out["serve_ihvp"] = np.stack([r.ihvp for r in answers])
    out["serve_batches"] = np.asarray([r.batch_id for r in answers])
    # the sharded engine's params checkpointed by every process (each
    # its own slots' shards), restored into a template of zeros, and an
    # engine rebuilt from them: the same influence
    path = co.save(os.path.join(ckpt_dir, "sharded"), flat.params, step=5)
    zeros = InfluenceEngine(model, {k: torch.zeros_like(v)
                                    for k, v in params.items()}, train,
                            damping=1e-3, mesh=mesh, shard_tables=True,
                            impl="flat", device="cpu").params
    got, _, step = co.load(path, zeros)
    assert step == 5
    again = InfluenceEngine(model, whole_params(got, model), train,
                            damping=1e-3, mesh=mesh, shard_tables=True,
                            impl="flat", device="cpu").query_batch(PTS)
    out["ckpt_packed"] = again._packed
    tr = Trainer(model, TrainConfig(**FIT), mesh=mesh, device="cpu")
    state = tr.fit(tr.init_state(params), train.x, train.y)
    out.update({f"fit_{k}": v.numpy() for k, v in state.params.items()})
    lanes = loo_retrain_many(model, params, train.x, train.y,
                             np.asarray(LOO["removed"]), LOO["steps"],
                             LOO["batch"], 1e-2,
                             seeds=np.asarray(LOO["seeds"], np.uint32),
                             mesh=mesh, device="cpu")
    out.update({f"loo_{k}": v.numpy() for k, v in lanes.items()})
    return out


def worker(argv) -> int:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--process_id", type=int, required=True)
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--params", required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    pmesh.set_virtual_devices(4)
    D.initialize(coordinator_address=args.coordinator, num_processes=2,
                 process_id=args.process_id, local_device_ids=[0])
    try:
        info = D.runtime_info(device="cpu")
        assert info.process_count == 2 and info.is_multi_host, info
        assert info.global_device_count == 8, info
        pod = pmesh.init_pod_mesh(device="cpu")
        assert [(s.id, s.process_index) for s in pod.devices.flat] == [
            (j, j // 4) for j in range(8)]
        granules = D._granules(pod.devices.flat)
        assert len(granules) == 2 and all(len(g) == 4 for g in granules)
        mesh = D.make_hybrid_mesh(model_parallel=2, device="cpu")
        assert dict(mesh.shape) == {"data": 4, "model": 2}
        for row in mesh.devices:  # 'model' rows stay inside a process
            assert len({s.process_index for s in row}) == 1
        assert D.spans_processes(mesh)
        # each process feeds only its rows; its slots get shard_along's
        x = _data().x.astype(np.int64)
        sl = D.process_local_rows(N, mesh)
        assert sl == slice(200 * args.process_id, 200 * args.process_id + 200)
        got = D.global_batch(mesh, x[sl], global_rows=N)
        want = pmesh.shard_along(mesh, torch.as_tensor(x))
        assert all((g is None) == (w is None) and (g is None
                                                   or torch.equal(g, w))
                   for g, w in zip(got, want))
        with np.load(args.params) as f:
            params = {k: torch.as_tensor(f[k]) for k in f.files}
        out = _run_all(mesh, params, os.path.dirname(args.out))
        if args.process_id == 0:
            np.savez(args.out, **out)
        print(f"worker {args.process_id}: ok", flush=True)
    finally:
        D.shutdown()
    return 0


@pytest.fixture(autouse=True, scope="module")
def slots():
    with pmesh.virtual_devices(8):
        yield


class TestRuntime:
    def test_initialize_single_process_noop(self):
        D.initialize()  # must not raise or block without a coordinator
        info = D.runtime_info(device="cpu")
        assert info.process_count == 1 and not info.is_multi_host
        assert info.global_device_count == 8  # the virtual slots
        with pytest.raises(ValueError, match="together"):
            D.initialize(num_processes=2)

    def test_runtime_info_fields(self):
        info = D.runtime_info(device="cpu")
        assert info.local_device_count == info.global_device_count
        assert info.platform == "cpu" and info.process_index == 0


class TestHybridMesh:
    def test_single_process_fallback(self):
        mesh = D.make_hybrid_mesh(model_parallel=2, device="cpu")
        assert mesh.axis_names == ("data", "model")
        assert mesh.shape["model"] == 2 and mesh.devices.size == 8
        assert pmesh.mesh_fingerprint(mesh) == pmesh.mesh_fingerprint(
            pmesh.make_mesh(8, ("data", "model"), (4, 2), device="cpu"))

    def test_bad_model_parallel_raises(self):
        with pytest.raises(ValueError, match="does not divide"):
            D.make_hybrid_mesh(model_parallel=3, device="cpu")

    def test_multi_granule_layout(self):
        """2 hosts x 4 slots: each 'model' group within a granule, 'data'
        across granules."""
        devs = list(pmesh.make_mesh(8, device="cpu").devices.flat)
        mesh = D.make_hybrid_mesh(model_parallel=2,
                                  granules=[devs[:4], devs[4:]])
        assert dict(mesh.shape) == {"data": 4, "model": 2}
        for row in mesh.devices:
            ids = {s.id for s in row}
            assert ids <= {0, 1, 2, 3} or ids <= {4, 5, 6, 7}

    def test_granule_grouping_by_attr(self):
        devs = list(pmesh.make_mesh(8, device="cpu").devices.flat)
        assert len(D._granules(devs)) == 1  # one process: one granule
        two = [pmesh.Slot(s.id, s.id // 4, s.device) for s in devs]
        assert [[s.id for s in g] for g in D._granules(two)] == [
            [0, 1, 2, 3], [4, 5, 6, 7]]

    def test_unequal_granules_rejected(self):
        devs = list(pmesh.make_mesh(8, device="cpu").devices.flat)
        with pytest.raises(ValueError, match="equal-sized"):
            D.make_hybrid_mesh(granules=[devs[:3], devs[3:8]])


class TestGlobalBatch:
    def test_local_rows_cover_batch(self):
        assert D.process_local_rows(13) == slice(0, 13)

    def test_local_rows_match_sharding_boundaries(self):
        """The mesh-aware range covers this process's shards exactly,
        and a global batch built from it gives each slot shard_along's
        shard of the whole."""
        mesh = D.make_hybrid_mesh(device="cpu")
        n = 16
        sl = D.process_local_rows(n, mesh)
        assert (sl.start, sl.stop) == (0, n)
        x = torch.arange(n, dtype=torch.float32)
        got = D.global_batch(mesh, x[sl].numpy(), global_rows=n)
        assert torch.equal(torch.cat(got), x)

    def test_local_rows_ragged_raises_early(self):
        mesh = D.make_hybrid_mesh(device="cpu")
        with pytest.raises(ValueError, match="pad the batch"):
            D.process_local_rows(10, mesh)  # 10 % 8 != 0

    def test_global_batch_matches_shard_along(self):
        mesh = D.make_hybrid_mesh(device="cpu")
        x = np.arange(32, dtype=np.float32).reshape(16, 2)
        got = D.global_batch(mesh, x[D.process_local_rows(16)])
        want = pmesh.shard_along(mesh, torch.as_tensor(x))
        assert all(torch.equal(a, b) for a, b in zip(got, want))

    def test_global_batch_pytree(self):
        mesh = D.make_hybrid_mesh(device="cpu")
        out = D.global_batch(mesh, {"x": np.zeros((8, 2), np.int32),
                                    "y": np.ones((8,), np.float32)})
        assert sum(float(o["y"].sum()) for o in out) == 8.0
        assert all(o["x"].shape == (1, 2) for o in out)

    def test_put_global_single_process(self):
        mesh = D.make_hybrid_mesh(model_parallel=2, device="cpu")
        x = np.arange(8, dtype=np.float32)
        rep = D.put_global(mesh, x)
        assert all(r is rep[0] for r in rep)  # one copy a device
        assert torch.equal(rep[0], torch.as_tensor(x))
        shards = D.put_global(mesh, x, "model")
        assert [s.tolist() for s in shards[:2]] == [[0, 1, 2, 3],
                                                    [4, 5, 6, 7]]
        assert shards[2] is shards[0]  # same device, same coordinate

    def test_sharded_train_step_on_global_batch(self):
        """The shards of a global batch feed a data-parallel loss: their
        weighted sum is the whole batch's loss."""
        mesh = D.make_hybrid_mesh(device="cpu")
        model = MF(16, 12, 4, 1e-3)
        params = model.init_params(torch.Generator().manual_seed(0))
        rng = np.random.default_rng(0)
        x = np.stack([rng.integers(0, 16, 24), rng.integers(0, 12, 24)], 1)
        y = rng.integers(1, 6, 24).astype(np.float32)
        gx = D.global_batch(mesh, x[D.process_local_rows(24)].astype(
            np.int32))
        gy = D.global_batch(mesh, y[D.process_local_rows(24)])
        err = sum(torch.sum(model.indiv_loss(params, a, b))
                  for a, b in zip(gx, gy))
        loss = err / 24 + model.reg_loss(params)
        ref = model.loss(params, torch.as_tensor(x), torch.as_tensor(y))
        np.testing.assert_allclose(float(loss), float(ref), rtol=1e-6)


class TestLocalDeviceIds:
    """ROADMAP C.7: ``initialize``'s ``local_device_ids``."""

    def test_signature_is_the_references(self):
        import inspect

        from fia_tpu.parallel import distributed as ref

        assert inspect.signature(D.initialize) == inspect.signature(
            ref.initialize)

    def test_slots_lie_over_the_given_ordinals(self, monkeypatch):
        """A process of a four-card host that joined with ids [2, 0]
        lays two slots, over cuda:2 then cuda:0, alive while those
        ordinals are visible; virtual slots lie over the first id; None
        restores every device."""
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(pmesh, "_VIRTUAL_DEVICES", None)
        try:
            pmesh.set_local_device_ids([2, 0])
            assert pmesh._local_slots("cuda", None) == [
                pmesh.Slot(0, 0, torch.device("cuda", 2)),
                pmesh.Slot(1, 0, torch.device("cuda", 0))]
            with pmesh.virtual_devices(3):
                assert {s.device for s in pmesh._local_slots("cuda", None)
                        } == {torch.device("cuda", 2)}
                assert pmesh.live_device_ids() == frozenset({0, 1, 2})
            assert pmesh.live_device_ids() == frozenset({0, 1})
            assert D.runtime_info(device="cuda").local_device_count == 2
            pmesh.set_local_device_ids([5])  # past the visible count
            assert pmesh.live_device_ids() == frozenset()
            pmesh.set_local_device_ids(None)
            assert [s.device.index for s in pmesh._local_slots("cuda", None)
                    ] == [0, 1, 2, 3]
            # the CPU's slots do not depend on CUDA ordinals
            pmesh.set_local_device_ids([3])
            assert pmesh._local_slots("cpu", None) == [
                pmesh.Slot(0, 0, torch.device("cpu"))]
        finally:
            pmesh.set_local_device_ids(None)

    @pytest.mark.parametrize("ids", [[], [1, 1], [-1]])
    def test_bad_ids_raise(self, ids):
        with pytest.raises(ValueError, match="local_device_ids"):
            pmesh.set_local_device_ids(ids)

    def test_ids_without_a_group_change_nothing(self, monkeypatch):
        """With no coordinator ``initialize`` is a no-op, ids and all, as
        the reference's; a failed join forgets them."""
        D.initialize(local_device_ids=[3])
        assert pmesh._LOCAL_DEVICE_IDS is None

        def refuse(*a, **k):
            raise RuntimeError("connection refused")

        monkeypatch.setattr(torch.distributed, "init_process_group", refuse)
        with pytest.raises(taxonomy.HostLost):
            D.initialize("127.0.0.1:1", 2, 1, local_device_ids=[3])
        assert pmesh._LOCAL_DEVICE_IDS is None


class TestFailures:
    def test_failed_join_raises_host_lost(self, monkeypatch):
        """A group that cannot be joined raises, classified host_lost."""
        def refuse(*a, **k):
            raise RuntimeError("connect() timed out")

        monkeypatch.setattr(torch.distributed, "init_process_group", refuse)
        with pytest.raises(taxonomy.HostLost) as got:
            D.initialize("127.0.0.1:1", num_processes=2, process_id=0)
        assert taxonomy.classify(got.value) == taxonomy.HOST_LOST
        assert not D._initialized

    def test_failed_exchange_raises_host_lost(self, monkeypatch):
        monkeypatch.setattr(pmesh, "process_count", lambda: 2)

        def closed(*a, **k):
            raise RuntimeError("Connection closed by peer")

        monkeypatch.setattr(torch.distributed, "all_gather_object", closed)
        with pytest.raises(taxonomy.HostLost, match="closed by peer"):
            D.gather_shards({0: 1}, 2)

    def test_service_over_processes_raises(self):
        """A service over a mesh that spans processes constructs (its
        two-process run: ``TestTwoProcess``); its engine is ``_multihost``,
        so it keeps the sequential guarded path and arms nothing ahead of
        time. In one process, with no peer to run shard 1, a dispatch
        raises naming the shard, never a silent hole."""
        cpu = torch.device("cpu")
        mesh = pmesh.Mesh(np.array([pmesh.Slot(0, 0, cpu),
                                    pmesh.Slot(1, 1, cpu)], dtype=object),
                          ("data",))
        assert D.spans_processes(mesh) and pmesh.local_slots(mesh)[0].id == 0
        model = MF(USERS, ITEMS, K, 1e-3)
        eng = InfluenceEngine(model, model.init_params(
            torch.Generator().manual_seed(0)), _data(), mesh=mesh,
            device="cpu")
        assert eng._shard_devices() == [cpu, None] and eng._multihost
        svc = InfluenceService(engine=eng, config=ServeConfig(
            mesh=mesh, disk_cache=False))
        assert not svc._overlap_eligible(eng)
        with pytest.raises(ValueError, match=r"shard\(s\) \[1\]"):
            svc.run([Request(3, 5), Request(0, 1)])

    def test_fill_shards_in_one_process(self):
        """Every shard local: the list itself, no exchange; a shard no
        process ran is an error, never a silent hole."""
        parts = [torch.ones(2), (torch.zeros(1), {"g": torch.ones(1)})]
        assert D.fill_shards(parts) is parts
        with pytest.raises(ValueError, match="no process"):
            D.fill_shards([torch.ones(2), None])

    def test_gather_shards_one_owner_each(self):
        assert D.gather_shards({0: "a", 1: "b"}, 2) == ["a", "b"]
        with pytest.raises(ValueError, match="no process"):
            D.gather_shards({0: "a"}, 2)


class TestTwoProcess:
    """A REAL 2-process x 4-slot run (gloo on loopback)."""

    def test_two_process_influence_matches(self, tmp_path):
        import jax

        from fia_tpu.data.dataset import RatingDataset as RefDataset
        from fia_tpu.influence.engine import InfluenceEngine as RefEngine
        from fia_tpu.influence.full import FullInfluenceEngine as RefFull
        from fia_tpu.models import MF as RefMF
        from fia_tpu_torch.models import params_from_numpy
        from fia_tpu_torch.parallel.sharded import make_2d_mesh

        ref_model = RefMF(USERS, ITEMS, K, 1e-3)
        arrays = jax.tree_util.tree_map(
            np.asarray, ref_model.init_params(jax.random.PRNGKey(0)))
        pfile = tmp_path / "params.npz"
        np.savez(pfile, **arrays)
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        out = tmp_path / "proc0.npz"
        env = {**os.environ, "OMP_NUM_THREADS": "2"}
        env.pop("JAX_PLATFORMS", None)
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--process_id",
             str(p), "--coordinator", f"127.0.0.1:{port}", "--params",
             str(pfile), "--out", str(out)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for p in (0, 1)]
        try:
            logs = [p.communicate(timeout=300)[0].decode() for p in procs]
        finally:
            for p in procs:  # a crashed worker leaves its peer waiting
                if p.poll() is None:
                    p.kill()
        for p, log in zip(procs, logs):
            assert p.returncode == 0, f"worker failed:\n{log}"
        got = dict(np.load(out))

        # the one-process mesh of the same 8 slots: bitwise
        model = MF(USERS, ITEMS, K, 1e-3)
        params = params_from_numpy(model, arrays, "cpu")
        one = tmp_path / "one"
        one.mkdir()
        want = _run_all(make_2d_mesh(8, model_parallel=2, device="cpu"),
                        params, str(one))
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].tobytes() == want[k].tobytes(), k
        assert got["ckpt_packed"].tobytes() == got["flat_packed"].tobytes()

        # the JAX package's single-process engines: the reference's bars
        train = _data()
        base = RefEngine(ref_model, arrays, RefDataset(train.x, train.y),
                         damping=1e-3).query_batch(PTS)
        assert np.array_equal(got["counts"], base.counts)
        off = np.concatenate([[0], np.cumsum(base.counts)])
        for t in range(len(PTS)):
            np.testing.assert_allclose(
                got["flat_packed"][off[t]:off[t + 1]], base.scores_of(t),
                rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(got["flat_ihvp"], got["padded_ihvp"],
                                   rtol=1e-3, atol=1e-5)
        full = RefFull(ref_model, arrays, RefDataset(train.x, train.y),
                       damping=1.0, solver="cg", cg_maxiter=50,
                       hvp_batch=100)
        np.testing.assert_allclose(
            got["full_scores"],
            np.asarray(full.get_influence_on_test_loss(train.x[:2],
                                                       train.y[:2])),
            rtol=5e-3, atol=1e-6)


if __name__ == "__main__":
    sys.exit(worker(sys.argv[1:]))

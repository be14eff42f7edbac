"""The port's reliability layer (``fia_tpu_torch/reliability``) and the
engine's device-failure recovery ladders, on the CPU.

Restated from ``tests/test_reliability.py`` on the port: ``TestTaxonomy``,
``TestPolicy``, ``TestInjector``, ``TestJournal``, ``TestEngineRecovery``
(all eight: a worker fault in ``query_many`` recovered bit for bit,
preemption retried at the same size, OOM degrading to the CPU rung, OOM
rising with ``cpu_fallback=False``, the two NaN ladders, journal resume,
deadline) and ``TestTrainerRetry``. Elsewhere: the RQ1 driver's resume
(``TestRq1Resume``) in ``test_torch_cli.py::test_rq1_resume_and_deadline``,
the artifact ladder (``TestArtifactLadderCollision``) in
``test_torch_cli.py::test_artifact_path_rules_match_the_reference``;
``TestDistributedRetry`` waits for the multi-process port (ROADMAP Queue
A.13b).

Added: each CUDA, cuBLAS, cuSOLVER and NCCL signature on the literal
message PyTorch raises, and the kernel-launch and build strings that
must stay unclassified; halving after a worker death; the padded path's
memory envelope (halving on an injected OOM, pre-chunking from a
persisted ceiling, a quarantined corrupt file, a success clearing a
ceiling); a reset that leaves no delegate holding a pre-reset tensor;
the sampled rung rebuilding on a classified fault; unclassified and
sticky failures rising without a retry or the CPU rung (a C entry's
out-of-memory code among them); the CPU rung off by default, and each
batch it answers counted and announced; the padded path's ambiguous
failure rising (its one ceiling is learned from OOMs only).

Recovered flat results are held bit for bit (the flat program is split
invariant); the CPU rung and the padded path's halved chunks at the
reference's rtol 1e-4 / atol 1e-6. Faults are injected at the engine's
sites; backoff runs in virtual time or not at all.
"""

import os

import jax
import numpy as np
import pytest
import torch

from fia_tpu.data.dataset import RatingDataset as RefDataset
from fia_tpu.influence.engine import InfluenceEngine as RefEngine
from fia_tpu.models import MF as RefMF
from fia_tpu_torch import obs
from fia_tpu_torch.data.dataset import RatingDataset
from fia_tpu_torch.influence.engine import InfluenceEngine
from fia_tpu_torch.influence.kernels import common as Kc
from fia_tpu_torch.models import MF, params_from_numpy
from fia_tpu_torch.reliability import inject, sites, taxonomy
from fia_tpu_torch.reliability import policy as rpolicy
from fia_tpu_torch.reliability.journal import (Journal, JournalMismatch,
                                               pack, unpack)
from fia_tpu_torch.train.trainer import Trainer, TrainConfig
from fia_tpu_torch.utils import compilemon, memlimits

torch.set_num_threads(2)

U, I, K = 30, 20, 4
WD = 1e-2
DAMP = 1e-3

# no-sleep policy for tests that exercise retry logic, not backoff
FAST = rpolicy.RetryPolicy(max_attempts=3, base_delay=0.0, jitter=0.0)

# PyTorch's footer on every CUDA error it raises (c10/cuda/CUDAException)
CUDA_FOOTER = (
    "\nCUDA kernel errors might be asynchronously reported at some other "
    "API call, so the stacktrace below might be incorrect.\nFor debugging "
    "consider passing CUDA_LAUNCH_BLOCKING=1\nCompile with "
    "`TORCH_USE_CUDA_DSA` to enable device-side assertions.\n")


@pytest.fixture(autouse=True)
def _clean(monkeypatch, tmp_path):
    """A private memory-envelope file and an empty registry per test."""
    monkeypatch.setenv("FIA_MEMLIMIT_CACHE", str(tmp_path / "mem.json"))
    obs.REGISTRY.reset()
    yield
    obs.REGISTRY.reset()


def _data(seed=0, n=400):
    rng = np.random.default_rng(seed)
    x = np.stack([rng.integers(0, U, n), rng.integers(0, I, n)],
                 axis=1).astype(np.int32)
    y = rng.integers(1, 6, n).astype(np.float32)
    return x, y


def _setup(seed=0, n=400):
    x, y = _data(seed, n)
    model = MF(U, I, K, WD)
    params = model.init_params(torch.Generator().manual_seed(seed))
    return model, params, RatingDataset(x, y)


def _counter(name: str) -> float:
    return obs.REGISTRY.snapshot()["counters"].get(name, 0.0)


def _same_bits(got, base, n):
    np.testing.assert_array_equal(got.counts, base.counts)
    np.testing.assert_array_equal(got.ihvp, base.ihvp)
    for t in range(n):
        np.testing.assert_array_equal(got.scores_of(t), base.scores_of(t))


class TestTaxonomy:
    def test_signature_strings_classify(self):
        cases = {
            "RESOURCE_EXHAUSTED: Ran out of memory in memory space hbm":
                taxonomy.OOM,
            "XLA:TPU ran out of memory while allocating": taxonomy.OOM,
            "HTTP 500: tpu_compile_helper subprocess exit code 1":
                taxonomy.AMBIGUOUS,
            "UNAVAILABLE: TPU worker process crashed or restarted":
                taxonomy.WORKER,
            "INTERNAL: TPU backend error (Internal).": taxonomy.WORKER,
            "ABORTED: The TPU worker was preempted by a maintenance "
            "event": taxonomy.PREEMPTION,
        }
        for msg, kind in cases.items():
            assert taxonomy.classify(RuntimeError(msg)) == kind, msg

    def test_preemption_wins_over_worker_signatures(self):
        e = RuntimeError(
            "UNAVAILABLE: TPU worker process crashed or restarted: "
            "the node was preempted"
        )
        assert taxonomy.classify(e) == taxonomy.PREEMPTION
        assert taxonomy.PREEMPTION not in taxonomy.SIZE_EVIDENCE

    def test_compile_phase_and_ordinary_errors_unclassified(self):
        assert taxonomy.classify(RuntimeError(
            "INTERNAL: TPU backend error: Mosaic lowering failed"
        )) is None
        assert taxonomy.classify(ValueError("shape mismatch")) is None

    def test_exception_types_classify(self):
        assert taxonomy.classify(
            taxonomy.DeadlineExpired("t")) == taxonomy.DEADLINE
        assert taxonomy.classify(taxonomy.NanPayload("n")) == taxonomy.NAN
        assert taxonomy.classify(MemoryError("m")) == taxonomy.HOST_OOM

    def test_classify_payload(self):
        clean = np.ones(4, np.float32)
        bad = clean.copy()
        bad[2] = np.nan
        assert taxonomy.classify_payload(clean, None) is None
        assert taxonomy.classify_payload(clean, bad) == taxonomy.NAN
        assert taxonomy.classify_payload(
            np.full(3, np.inf, np.float64)) == taxonomy.NAN


# the messages PyTorch raises on a CUDA card, each with the kind the
# recovery ladders must see
CUDA_SIGNATURES = [
    ("CUDA out of memory. Tried to allocate 2.00 GiB. GPU 0 has a total "
     "capacity of 79.19 GiB of which 1.06 GiB is free. Including "
     "non-PyTorch memory, this process has 78.12 GiB memory in use.",
     taxonomy.OOM),
    ("CUDA error: CUBLAS_STATUS_ALLOC_FAILED when calling "
     "`cublasCreate(handle)`" + CUDA_FOOTER, taxonomy.OOM),
    ("cusolver error: CUSOLVER_STATUS_ALLOC_FAILED, when calling "
     "`cusolverDnCreate(&handle)`. If you keep seeing this error, you may "
     "use `torch.backends.cuda.preferred_linalg_library()` to try linear "
     "algebra operators with other supported backends.", taxonomy.OOM),
    ("CUDA error: an illegal memory access was encountered" + CUDA_FOOTER,
     taxonomy.DEVICE_LOST),
    ("CUDA error: device-side assert triggered" + CUDA_FOOTER,
     taxonomy.DEVICE_LOST),
    ("CUDA error: unspecified launch failure" + CUDA_FOOTER,
     taxonomy.DEVICE_LOST),
    ("CUDA error: misaligned address" + CUDA_FOOTER, taxonomy.DEVICE_LOST),
    ("CUDA error: uncorrectable ECC error encountered" + CUDA_FOOTER,
     taxonomy.DEVICE_LOST),
    ("CUDA error: an illegal instruction was encountered" + CUDA_FOOTER,
     taxonomy.DEVICE_LOST),
    ("[Rank 0] Watchdog caught collective operation timeout: "
     "WorkNCCL(SeqNum=12, OpType=ALLREDUCE, NumelIn=1024, NumelOut=1024, "
     "Timeout(ms)=600000) ran for 600042 milliseconds before timing out.",
     taxonomy.HOST_LOST),
]

# a kernel's own launch errors and build failures: they must rise
UNCLASSIFIED = [
    "CUDA error: invalid configuration argument" + CUDA_FOOTER,
    "CUDA error: too many resources requested for launch" + CUDA_FOOTER,
    "CUDA error: no kernel image is available for execution on the device"
    + CUDA_FOOTER,
    str(Kc.launch_error("mf_scores", 9)),
    str(Kc.launch_error("segment_certificate", 701)),
    str(Kc.launch_error("block_eigmin", 209)),
    "CUDA kernel build failed: mf_scores (nvcc exit 1):\n"
    "mf_scores.cu(12): error: identifier \"kTile\" is undefined",
    # whatever the compiler's log says, a build failure is no device fault
    "CUDA kernel build failed: ncf_scores (nvcc exit 1):\n"
    "cc1plus: out of memory allocating 65536 bytes",
    "the direct flat program at (t_pad, s_pad) = (64, 2048) could not be "
    "captured as a CUDA graph: warm-up: CUDA kernel build failed: "
    "block_eigmin (nvcc exit 2):\nptxas fatal: Memory allocation failure",
]


class TestCudaSignatures:
    @pytest.mark.parametrize("msg,kind", CUDA_SIGNATURES,
                             ids=lambda v: v if isinstance(v, str)
                             and len(v) < 16 else None)
    def test_pytorch_message_classifies(self, msg, kind):
        assert taxonomy.classify(RuntimeError(msg)) == kind
        # the engine wraps a failed capture: the class survives the wrap
        wrapped = RuntimeError("the direct flat program at (t_pad, s_pad) "
                               f"= (64, 2048) could not be captured as a "
                               f"CUDA graph: capture: {msg}")
        assert taxonomy.classify(wrapped) == kind

    @pytest.mark.parametrize("msg", UNCLASSIFIED)
    def test_kernel_launch_and_build_errors_rise(self, msg):
        assert taxonomy.classify(RuntimeError(msg)) is None

    @pytest.mark.parametrize("rc,kind", [
        (9, None), (701, None), (209, None), (98, None), (1, None),
        (2, None), (700, taxonomy.DEVICE_LOST),
        (710, taxonomy.DEVICE_LOST), (719, taxonomy.DEVICE_LOST)])
    def test_kernel_wrapper_errors_carry_the_cuda_text(self, rc, kind):
        """A C entry's return code becomes CUDA's own text: the kernel's
        launch errors rise unclassified (out of memory too: no ladder
        takes a kernel that cannot launch off the card), a sticky error
        left by earlier work reads as a lost device."""
        e = Kc.launch_error("ncf_scores", rc)
        assert f"cudaError {rc} (" in str(e)
        assert taxonomy.classify(e) == kind

    def test_cuda_oom_type_classifies_without_cuda(self):
        """``torch.cuda.OutOfMemoryError`` by type, whatever its text,
        with no CUDA state touched."""
        assert taxonomy.classify(torch.cuda.OutOfMemoryError("x")) == \
            taxonomy.OOM
        assert not torch.cuda.is_initialized()

    def test_sticky_errors_are_not_retriable(self):
        """A poisoned context must not enter a rebuild-and-retry ladder."""
        for msg, kind in CUDA_SIGNATURES:
            if kind == taxonomy.DEVICE_LOST:
                assert kind not in taxonomy.TRANSIENT
                assert kind not in taxonomy.SIZE_EVIDENCE

    def test_reference_signatures_unchanged(self):
        """The reference's TPU signatures (which the injector replays)
        classify as the reference classifies them."""
        from fia_tpu.reliability import taxonomy as ref_tax

        for msg in [*inject.MESSAGES.values(),
                    "TPU backend error (compile)",
                    "UNAVAILABLE: TPU device is in an unhealthy state"]:
            assert taxonomy.classify(RuntimeError(msg)) == \
                ref_tax.classify(RuntimeError(msg)), msg


class TestPolicy:
    def test_backoff_deterministic_and_bounded(self):
        p = rpolicy.RetryPolicy(max_attempts=6, base_delay=0.5,
                                max_delay=4.0, jitter=0.25, seed=7)
        assert p.delays() == p.delays()
        for i, d in enumerate(p.delays()):
            raw = min(0.5 * 2.0 ** i, 4.0)
            assert raw * 0.75 <= d <= raw * 1.25
        q = rpolicy.RetryPolicy(max_attempts=6, base_delay=0.5,
                                max_delay=4.0, jitter=0.25, seed=8)
        assert p.delays() != q.delays()

    def test_run_retries_transient_then_succeeds(self):
        calls = []

        def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise RuntimeError(inject.MESSAGES[taxonomy.WORKER])
            return "ok"

        obs.configure(trace=True)
        try:
            with obs.span("unit") as sp:
                assert FAST.run(flaky) == "ok"
        finally:
            obs.configure(trace=False)
            obs.TRACER.reset()
        assert len(calls) == 3
        # each retry is counted and marked on the span
        assert _counter("reliability.retries_total{kind=worker}") == 2
        assert [e["attempt"] for e in sp.events if e["name"] == "retry"] \
            == [0, 1]

    def test_run_surfaces_non_retryable_immediately(self):
        calls = []

        def broken():
            calls.append(1)
            raise ValueError("not transient")

        with pytest.raises(ValueError):
            FAST.run(broken)
        assert len(calls) == 1
        assert _counter("reliability.retries_total{kind=worker}") == 0

    def test_run_exhausts_attempts(self):
        calls = []

        def always():
            calls.append(1)
            raise RuntimeError(inject.MESSAGES[taxonomy.WORKER])

        with pytest.raises(RuntimeError):
            FAST.run(always)
        assert len(calls) == FAST.max_attempts

    def test_run_refuses_to_sleep_past_deadline(self):
        slow = rpolicy.RetryPolicy(max_attempts=4, base_delay=100.0,
                                   jitter=0.0)
        vc = rpolicy.VirtualClock()
        calls = []

        def always():
            calls.append(1)
            raise RuntimeError(inject.MESSAGES[taxonomy.WORKER])

        with pytest.raises(RuntimeError):
            slow.run(always, deadline=rpolicy.Deadline(0.5, clock=vc),
                     clock=vc)
        assert len(calls) == 1
        assert vc.monotonic() == 0.0

    def test_deadline(self):
        assert not rpolicy.Deadline(None).expired()
        assert rpolicy.Deadline(0.0).remaining() == float("inf")
        vc = rpolicy.VirtualClock()
        d = rpolicy.Deadline(1.0, clock=vc)
        assert not d.expired() and d.remaining() == 1.0
        vc.advance(0.75)
        assert d.remaining() == pytest.approx(0.25)
        vc.advance(0.5)
        assert d.expired()
        with pytest.raises(taxonomy.DeadlineExpired):
            d.check("unit test")

    def test_backoff_runs_entirely_in_virtual_time(self):
        pol = rpolicy.RetryPolicy(max_attempts=4, base_delay=2.0,
                                  max_delay=30.0, jitter=0.25, seed=3)
        vc = rpolicy.VirtualClock()
        calls = []

        def flaky():
            calls.append(1)
            if len(calls) < 4:
                raise RuntimeError(inject.MESSAGES[taxonomy.WORKER])
            return "ok"

        import time
        t0 = time.monotonic()
        assert pol.run(flaky, clock=vc) == "ok"
        assert vc.monotonic() == pytest.approx(sum(pol.delays()))
        assert time.monotonic() - t0 < 1.0

    def test_virtual_clock_sleep_advances_monotonic(self):
        vc = rpolicy.VirtualClock(start=5.0)
        vc.sleep(2.5)
        vc.sleep(-1.0)
        assert vc.monotonic() == 7.5
        vc.advance(0.5)
        assert vc.monotonic() == 8.0

    def test_solver_ladders(self):
        assert rpolicy.next_solver("lissa") == "cg"
        assert rpolicy.next_solver("cg") == "direct"
        assert rpolicy.next_solver("schulz") == "direct"
        assert rpolicy.next_solver("direct") is None
        assert rpolicy.next_solver(
            "lissa", rpolicy.FULL_SOLVER_FALLBACK) == "cg"
        assert rpolicy.next_solver(
            "cg", rpolicy.FULL_SOLVER_FALLBACK) is None


class TestInjector:
    def test_fires_at_exact_call_index(self):
        with inject.active(
            inject.Fault("site.a", at=1, kind=taxonomy.WORKER)
        ) as inj:
            inject.fire("site.a")
            with pytest.raises(RuntimeError) as ei:
                inject.fire("site.a")
            inject.fire("site.a")
            assert taxonomy.classify(ei.value) == taxonomy.WORKER
        assert inj.counts == {"site.a": 3}
        assert inj.unfired() == []
        assert inject.call_count("site.a") == 0

    def test_all_synthetic_signatures_classify_like_production(self):
        for kind in (taxonomy.OOM, taxonomy.AMBIGUOUS, taxonomy.WORKER,
                     taxonomy.PREEMPTION):
            with inject.active(inject.Fault("s", at=0, kind=kind)):
                with pytest.raises(RuntimeError) as ei:
                    inject.fire("s")
            assert taxonomy.classify(ei.value) == kind
        with inject.active(
            inject.Fault("s", at=0, kind=taxonomy.HOST_OOM)
        ):
            with pytest.raises(MemoryError):
                inject.fire("s")

    def test_corrupt_writes_nan_without_touching_input(self):
        arr = np.arange(4.0, dtype=np.float32)
        with inject.active(inject.Fault("s", at=0, kind=taxonomy.NAN)):
            out = inject.corrupt("s", arr)
            again = inject.corrupt("s", arr)
        assert np.isnan(out[0]) and np.isfinite(out[1:]).all()
        assert np.isfinite(arr).all()
        assert again is arr

    def test_nesting_rejected(self):
        with inject.active():
            with pytest.raises(RuntimeError, match="already armed"):
                with inject.active():
                    pass

    def test_unfired_fault_warns_at_teardown(self, capsys):
        with inject.active(
            inject.Fault("site.a", at=7, kind=taxonomy.WORKER)
        ):
            inject.fire("site.a")
        out = capsys.readouterr().err
        assert "never fired" in out and "site.a@7:worker" in out
        assert _counter("diag_total{channel=inject}") == 1

    def test_unfired_fault_strict_raises(self):
        with pytest.raises(inject.UnfiredFaultError,
                           match="site.a@3:worker"):
            with inject.active(
                inject.Fault("site.a", at=3, kind=taxonomy.WORKER),
                strict=True,
            ):
                inject.fire("site.a")
        assert inject.call_count("site.a") == 0

    def test_strict_never_masks_inflight_exception(self):
        with pytest.raises(ValueError, match="real failure"):
            with inject.active(
                inject.Fault("site.a", at=9, kind=taxonomy.WORKER),
                strict=True,
            ):
                raise ValueError("real failure")

    def test_validate_rejects_unregistered_site(self):
        with pytest.raises(ValueError, match="unknown injection site"):
            with inject.active(
                inject.Fault("no.such.site", at=0, kind=taxonomy.WORKER),
                validate=True,
            ):
                pass  # pragma: no cover — arm-time rejection

    def test_report_accounts_fired_and_unfired(self):
        with inject.active(
            inject.Fault("site.a", at=0, kind=taxonomy.WORKER),
            inject.Fault("site.b", at=5, kind=taxonomy.OOM),
        ) as inj:
            with pytest.raises(RuntimeError):
                inject.fire("site.a")
            inject.fire("site.a")
        rep = inj.report()
        assert rep["counts"] == {"site.a": 2}
        assert rep["fired"] == [["site.a", 0, taxonomy.WORKER]]
        assert rep["unfired"] == [["site.b", 5, taxonomy.OOM]]


class TestJournal:
    FP = {"kind": "test", "n": 3}

    def test_exact_array_and_float_round_trip(self, tmp_path):
        path = str(tmp_path / "j.jsonl")
        payload = {
            "f32": np.float32(np.pi) * np.arange(5, dtype=np.float32),
            "f64": np.asarray([0.1, 1.0 / 3.0, 1e-300]),
            "i64": np.asarray([-1, 1 << 60]),
            "scalar": float(np.float32(2.0) / 3.0),
        }
        with Journal.open(path, self.FP, fsync=False) as j:
            j.record("u:0", payload)
        with Journal.open(path, self.FP, resume=True, fsync=False) as j2:
            assert j2.done("u:0") and not j2.done("u:1")
            got = j2.get("u:0")
        for k in ("f32", "f64", "i64"):
            assert got[k].dtype == payload[k].dtype
            np.testing.assert_array_equal(got[k], payload[k])
        assert got["scalar"] == payload["scalar"]

    def test_pack_unpack_inverse(self):
        obj = {"a": [np.float32(1.5), {"b": np.arange(3)}], "c": None}
        rt = unpack(pack(obj))
        assert rt["a"][0] == 1.5 and rt["c"] is None
        np.testing.assert_array_equal(rt["a"][1]["b"], np.arange(3))

    def test_non_resume_rotates_stale(self, tmp_path):
        path = str(tmp_path / "j.jsonl")
        with Journal.open(path, self.FP, fsync=False) as j:
            j.record("u:0", {"x": 1})
        with Journal.open(path, self.FP, resume=False, fsync=False) as j2:
            assert not j2.done("u:0")
        assert os.path.exists(path + ".stale")

    def test_fingerprint_mismatch_fails_loudly(self, tmp_path):
        path = str(tmp_path / "j.jsonl")
        Journal.open(path, self.FP, fsync=False).close()
        with pytest.raises(JournalMismatch):
            Journal.open(path, {"kind": "test", "n": 4}, resume=True,
                         fsync=False)

    def test_truncated_tail_dropped_not_fatal(self, tmp_path):
        path = str(tmp_path / "j.jsonl")
        with Journal.open(path, self.FP, fsync=False) as j:
            j.record("u:0", {"x": np.arange(3)})
            j.record("u:1", {"x": np.arange(4)})
        with open(path, "a") as fh:
            fh.write('{"kind": "done", "key": "u:2", "payl')
        with Journal.open(path, self.FP, resume=True, fsync=False) as j2:
            assert j2.done("u:0") and j2.done("u:1") and not j2.done("u:2")
            assert j2.corrupt_lines == 1

    def test_headerless_file_rotated_fresh(self, tmp_path):
        path = str(tmp_path / "j.jsonl")
        with open(path, "w") as fh:
            fh.write("not a journal at all\n")
        with Journal.open(path, self.FP, resume=True, fsync=False) as j:
            assert not j.entries
        assert os.path.exists(path + ".stale")


class TestEngineRecovery:
    """Injected faults on the CPU drive the real ladders; a recovered
    flat result must be bit for bit the fault-free one."""

    def _engine(self, **kw):
        # the CPU rung on (the reference's default; the port's is off),
        # so each test shows whether the ladder ended there
        model, params, train = _setup()
        kw.setdefault("damping", DAMP)
        kw.setdefault("impl", "flat")
        kw.setdefault("cpu_fallback", True)
        return InfluenceEngine(model, params, train, device="cpu", **kw), train

    def test_worker_fault_in_query_many_bit_identical(self):
        eng, train = self._engine()
        pts = np.asarray(train.x[:4])
        base = eng.query_many(pts, batch_queries=2)
        fresh, _ = self._engine()
        with inject.active(
            inject.Fault("engine.dispatch_flat", at=1,
                         kind=taxonomy.WORKER)
        ) as inj:
            got = fresh.query_many(pts, batch_queries=2)
        assert inj.unfired() == []
        # the crash killed both in-flight batches; both re-run in order
        assert inj.counts["engine.dispatch_flat"] == 4
        assert inj.counts["engine.upload"] == 1
        assert _counter("engine.device_resets") == 1
        assert len(got) == len(base)
        for g, b in zip(got, base):
            _same_bits(g, b, len(g.counts))
        # and the recovered stream is the reference's answer
        x, y = _data()
        ref_model = RefMF(U, I, K, WD)
        ref = RefEngine(ref_model, dict(fresh._params_host),
                        RefDataset(x, y), damping=DAMP).query_batch(pts)
        for t in range(4):
            g = got[t // 2]
            np.testing.assert_allclose(g.scores_of(t % 2), ref.scores_of(t),
                                       rtol=2e-5, atol=1e-6)

    def test_worker_fault_halves_bit_identical(self):
        eng, train = self._engine()
        pts = np.asarray(train.x[:5])
        base = eng.query_batch(pts)
        fresh, _ = self._engine()
        with inject.active(
            inject.Fault("engine.dispatch_flat", at=0,
                         kind=taxonomy.WORKER)
        ) as inj:
            got = fresh.query_batch(pts)
        # one failed dispatch of 5, then 3 + 2
        assert inj.counts["engine.dispatch_flat"] == 3
        assert inj.counts["engine.upload"] == 1
        _same_bits(got, base, len(pts))
        assert got._pad == base._pad
        assert fresh._cpu_engine is None

    def test_preemption_retries_same_size(self):
        eng, train = self._engine()
        pts = np.asarray(train.x[:4])
        base = eng.query_batch(pts)
        fresh, _ = self._engine()
        with inject.active(
            inject.Fault("engine.dispatch_flat", at=0,
                         kind=taxonomy.PREEMPTION)
        ) as inj:
            got = fresh.query_batch(pts)
        assert inj.counts["engine.dispatch_flat"] == 2
        assert inj.counts["engine.upload"] == 1
        _same_bits(got, base, len(pts))

    def test_oom_degrades_to_cpu_backend_rung(self, capsys):
        eng, train = self._engine()
        pts = np.asarray(train.x[:4])
        base = eng.query_batch(pts)
        fresh, _ = self._engine()
        with inject.active(
            inject.Fault("engine.dispatch_flat", at=0, kind=taxonomy.OOM)
        ):
            got = fresh.query_batch(pts)
        assert fresh._cpu_engine is not None
        assert fresh._cpu_engine._is_cpu_fallback
        assert "degrading to the CPU backend" in capsys.readouterr().err
        assert _counter("diag_total{channel=reliability}") == 1
        assert _counter("engine.cpu_fallback_batches") == 1
        for t in range(len(pts)):
            np.testing.assert_allclose(got.scores_of(t), base.scores_of(t),
                                       rtol=1e-4, atol=1e-6)

    def test_every_cpu_rung_batch_is_counted_and_announced(self, capsys):
        """The rung's engine is built once, but each batch it answers is
        counted and announced: none leaves the card unseen."""
        fresh, train = self._engine()
        pts = np.asarray(train.x[:4])
        # the rung's own dispatch fires the site too: calls 1 and 3
        with inject.active(
            inject.Fault("engine.dispatch_flat", at=0, kind=taxonomy.OOM),
            inject.Fault("engine.dispatch_flat", at=2, kind=taxonomy.OOM),
        ) as inj:
            fresh.query_batch(pts[:2])
            rung = fresh._cpu_engine
            fresh.query_batch(pts[2:])
        assert inj.counts["engine.dispatch_flat"] == 4
        assert fresh._cpu_engine is rung
        assert _counter("engine.cpu_fallback_batches") == 2
        assert _counter("diag_total{channel=reliability}") == 2
        assert capsys.readouterr().err.count(
            "degrading to the CPU backend") == 2

    def test_cpu_rung_is_off_by_default(self):
        """The port's one default that differs from the reference's: a
        classified OOM rises unless the caller turned the rung on."""
        model, params, train = _setup()
        eng = InfluenceEngine(model, params, train, damping=DAMP,
                              impl="flat", device="cpu")
        assert eng.cpu_fallback is False
        with inject.active(
            inject.Fault("engine.dispatch_flat", at=0, kind=taxonomy.OOM)
        ):
            with pytest.raises(RuntimeError, match="RESOURCE_EXHAUSTED"):
                eng.query_batch(np.asarray(train.x[:4]))
        assert eng._cpu_engine is None
        assert _counter("engine.cpu_fallback_batches") == 0

    def test_oom_surfaces_when_cpu_rung_disabled(self):
        fresh, train = self._engine(cpu_fallback=False)
        pts = np.asarray(train.x[:4])
        with inject.active(
            inject.Fault("engine.dispatch_flat", at=0, kind=taxonomy.OOM)
        ):
            with pytest.raises(RuntimeError, match="RESOURCE_EXHAUSTED"):
                fresh.query_batch(pts)
        assert fresh._cpu_engine is None

    def test_nan_solve_escalates_lissa_to_cg(self):
        model, params, train = _setup()
        pts = np.asarray(train.x[:4])
        clean = InfluenceEngine(model, params, train, damping=2.0,
                                solver="lissa", device="cpu")
        base = clean.query_batch(pts)
        assert clean.solver == "lissa"
        eng = InfluenceEngine(model, params, train, damping=2.0,
                              solver="lissa", device="cpu")
        with inject.active(
            inject.Fault("engine.solve", at=0, kind=taxonomy.NAN)
        ):
            got = eng.query_batch(pts)
        assert eng.solver == "cg"
        assert taxonomy.classify_payload(np.asarray(got.ihvp)) is None
        assert _counter("engine.solver_escalations{from=lissa,to=cg}") == 1
        for t in range(len(pts)):
            np.testing.assert_allclose(got.scores_of(t), base.scores_of(t),
                                       rtol=1e-3, atol=1e-6)

    def test_nan_ladder_reaches_direct(self):
        model, params, train = _setup()
        pts = np.asarray(train.x[:2])
        eng = InfluenceEngine(model, params, train, damping=2.0,
                              solver="lissa", device="cpu")
        with inject.active(
            inject.Fault("engine.solve", at=0, kind=taxonomy.NAN),
            inject.Fault("engine.solve", at=1, kind=taxonomy.NAN),
        ):
            got = eng.query_batch(pts)
        assert eng.solver == "direct"
        assert taxonomy.classify_payload(np.asarray(got.ihvp)) is None
        assert _counter("diag_total{channel=reliability}") == 2

    def test_query_many_journal_resume_recomputes_nothing(self, tmp_path):
        eng, train = self._engine()
        pts = np.asarray(train.x[:4])
        path = str(tmp_path / "qm.jsonl")
        fp = eng.journal_fingerprint(pts, batch_queries=2)
        with Journal.open(path, fp, fsync=False) as j:
            base = eng.query_many(pts, batch_queries=2, journal=j)
        with Journal.open(path, fp, resume=True, fsync=False) as j2:
            with inject.active() as inj:
                got = eng.query_many(pts, batch_queries=2, journal=j2)
            assert inj.counts.get("engine.dispatch_flat", 0) == 0
        for g, b in zip(got, base):
            _same_bits(g, b, len(g.counts))

    def test_query_many_deadline_stops_cleanly_then_resumes(self, tmp_path):
        eng, train = self._engine()
        pts = np.asarray(train.x[:4])
        path = str(tmp_path / "dl.jsonl")
        fp = eng.journal_fingerprint(pts, batch_queries=2)
        vc = rpolicy.VirtualClock()
        expired = rpolicy.Deadline(1.0, clock=vc)
        vc.advance(2.0)
        with Journal.open(path, fp, fsync=False) as j:
            with pytest.raises(taxonomy.DeadlineExpired):
                eng.query_many(pts, batch_queries=2, journal=j,
                               deadline=expired)
        base = eng.query_many(pts, batch_queries=2)
        with Journal.open(path, fp, resume=True, fsync=False) as j2:
            got = eng.query_many(pts, batch_queries=2, journal=j2)
        for g, b in zip(got, base):
            _same_bits(g, b, len(g.counts))

    def test_worker_crash_keeps_journaled_batches(self, tmp_path):
        """Batches finalized before the crash are kept (and journaled);
        only the unfinished ones run again."""
        eng, train = self._engine()
        pts = np.asarray(train.x[:6])
        base = eng.query_many(pts, batch_queries=2)
        fresh, _ = self._engine()
        path = str(tmp_path / "crash.jsonl")
        fp = fresh.journal_fingerprint(pts, batch_queries=2)
        with Journal.open(path, fp, fsync=False) as j:
            with inject.active(
                inject.Fault("engine.dispatch_flat", at=2,
                             kind=taxonomy.PREEMPTION)
            ) as inj:
                got = fresh.query_many(pts, batch_queries=2, window=1,
                                       journal=j)
            assert sorted(j.entries) == ["batch:0", "batch:1", "batch:2"]
        # window 1: batches 0 and 1 finished; batch 2's dispatch failed
        # and ran again alone
        assert inj.counts["engine.dispatch_flat"] == 4
        for g, b in zip(got, base):
            _same_bits(g, b, len(g.counts))

    def test_unclassified_and_sticky_failures_rise(self, monkeypatch):
        """A kernel that cannot launch, and CUDA's sticky errors, rise at
        once: no rebuild, no retry, no CPU rung."""
        for msg in (str(Kc.launch_error("mf_scores", 9)),
                    str(Kc.launch_error("ncf_scores", 2)),
                    "CUDA error: an illegal memory access was encountered"
                    + CUDA_FOOTER,
                    "CUDA error: device-side assert triggered"
                    + CUDA_FOOTER):
            eng, train = self._engine()

            def boom(*a, msg=msg, **k):
                raise RuntimeError(msg)

            monkeypatch.setattr(eng, "_flat_exec", boom)
            with inject.active() as inj:
                with pytest.raises(RuntimeError) as ei:
                    eng.query_batch(np.asarray(train.x[:4]))
            assert str(ei.value) == msg
            assert inj.counts["engine.dispatch_flat"] == 1
            assert inj.counts.get("engine.upload", 0) == 0
            assert eng._cpu_engine is None
        assert _counter("diag_total{channel=reliability}") == 0
        assert _counter("engine.device_resets") == 0


def _tensors(eng) -> dict:
    """``id -> tensor`` of every tensor reachable from the engine's
    attributes (dicts, tuples, lists, programs' closures aside), and from
    each delegate's."""
    out, seen, stack = {}, set(), [eng, *eng._delegates_deep()]
    while stack:
        obj = stack.pop()
        if id(obj) in seen:
            continue
        seen.add(id(obj))
        if isinstance(obj, torch.Tensor):
            out[id(obj)] = obj
        elif isinstance(obj, dict):
            stack.extend(obj.values())
        elif isinstance(obj, (tuple, list)):
            stack.extend(obj)
        elif isinstance(obj, InfluenceEngine):
            stack.extend(vars(obj).values())
    return out


class TestDeviceReset:
    def test_reset_leaves_no_delegate_holding_a_pre_reset_tensor(self):
        model, params, train = _setup()
        pts = np.asarray(train.x[:4])
        eng = InfluenceEngine(model, params, train, damping=DAMP,
                              device="cpu")
        base = eng.query_batch(pts)
        # delegates two deep: the approximate sibling (sampled) and its
        # escalation rung (lissa)
        sib = eng.approx_sibling()
        sib._sampled_fallback()
        eng.precompile_flat([eng.flat_geometry(pts)])
        before = _tensors(eng)
        assert len(eng._delegates_deep()) == 2
        assert eng.compiled_geometries()["aot"]
        eng._reset_device_state()
        after = _tensors(eng)
        assert not set(before) & set(after)
        for e in (eng, *eng._delegates_deep()):
            assert e.params.keys() == eng.params.keys()
            assert all(e.params[k] is eng.params[k] for k in eng.params)
            assert e.train_x is eng.train_x and e._postings is eng._postings
            assert e.compiled_geometries() == {"aot": [], "jit": []}
        n0 = compilemon.count()
        got = eng.query_batch(pts)
        assert compilemon.count() == n0 + 1  # recaptured
        _same_bits(got, base, len(pts))
        assert _counter("engine.device_resets") == 1

    def test_reset_replaces_the_bank_on_the_device(self, tmp_path):
        from fia_tpu_torch.influence import factor as fbank

        model, params, train = _setup()
        kw = dict(damping=DAMP, cache_dir=str(tmp_path), device="cpu")
        builder = InfluenceEngine(model, params, train, **kw)
        pairs = np.unique(np.asarray(train.x), axis=0)[:8].astype(np.int64)
        fbank.publish_bank(
            fbank.build_bank(builder, pairs, batch_queries=8),
            builder.factor_bank_path(),
            fbank.bank_fingerprint("model", model.block_size, DAMP,
                                   *builder._train_host))
        eng = InfluenceEngine(model, params, train, solver="precomputed",
                              **kw)
        assert eng.ensure_factor_bank() == len(pairs)
        base = eng.query_batch(pairs[:4])
        old = eng._bank_device
        eng._reset_device_state()
        assert all(a is not b for a, b in zip(eng._bank_device, old))
        got = eng.query_batch(pairs[:4])
        _same_bits(got, base, 4)

    def test_upload_retries_in_virtual_time(self, monkeypatch):
        """A re-upload that fails with the worker signature backs off and
        retries (counted in ``reliability.retries_total``)."""
        eng, _ = TestEngineRecovery()._engine()
        vc = rpolicy.VirtualClock()
        monkeypatch.setattr(rpolicy, "WALL", vc)
        with inject.active(
            inject.Fault("engine.upload", at=0, kind=taxonomy.WORKER),
            strict=True,
        ) as inj:
            eng._reset_device_state()
        assert inj.counts["engine.upload"] == 2
        assert _counter("reliability.retries_total{kind=worker}") == 1
        assert vc.monotonic() > 0


class TestSampledRebuild:
    def test_classified_fault_rebuilds_before_escalating(self):
        model, params, train = _setup()
        pts = np.asarray(train.x[:6])
        kw = dict(damping=DAMP, lissa_depth=500, device="cpu")
        samp = InfluenceEngine(model, params, train, solver="sampled",
                               sampled_cap=8, **kw)
        ref = InfluenceEngine(model, params, train,
                              solver=rpolicy.next_solver("sampled"),
                              **kw).query_batch(pts)
        old = samp.params
        with inject.active(
            inject.Fault(sites.ENGINE_SAMPLED_SOLVE, at=0,
                         kind=taxonomy.WORKER), strict=True,
        ) as inj:
            res = samp.query_batch(pts)
        assert inj.counts["engine.upload"] == 1
        assert all(samp.params[k] is not old[k] for k in old)
        fb = samp._sampled_fallback()
        assert all(fb.params[k] is samp.params[k] for k in old)
        _same_bits(res, ref, len(pts))
        assert samp.sampled_stats()["escalations"] == {
            taxonomy.WORKER: len(pts)}
        assert _counter("engine.sampled_escalations{reason=worker}") == \
            len(pts)
        assert _counter("engine.device_resets") == 1


class TestPaddedEnvelope:
    """The padded path's memory envelope: a batch that runs out of
    memory finishes in halves and teaches the envelope (persisted in
    the ``FIA_MEMLIMIT_CACHE`` file, a temporary one here)."""

    PTS = 8

    def _engine(self):
        model, params, train = _setup()
        return InfluenceEngine(model, params, train, damping=DAMP,
                               impl="padded", device="cpu"), train

    def test_oom_halves_then_a_fresh_engine_prechunks(self, tmp_path):
        eng, train = self._engine()
        pts = np.asarray(train.x[: self.PTS])
        base = eng.query_batch(pts)
        fresh, _ = self._engine()
        with inject.active(
            inject.Fault("engine.dispatch_padded", at=0, kind=taxonomy.OOM)
        ) as inj:
            got = fresh.query_batch(pts)
        # one failing dispatch of 8, then two of 4
        assert inj.counts["engine.dispatch_padded"] == 3
        pad = base._pad
        assert got._pad == pad
        for t in range(self.PTS):
            np.testing.assert_allclose(got.scores_of(t), base.scores_of(t),
                                       rtol=1e-4, atol=1e-6)
        key = fresh._memkey
        assert key.startswith("torch-cpu:n1:")
        ok, bad = memlimits.load(key)
        # the hard ceiling is the failing size; the success sizes merge in
        assert bad == self.PTS * pad and ok >= (self.PTS // 2) * pad
        # a fresh engine pre-chunks from the file: no failing dispatch
        again, _ = self._engine()
        with inject.active() as inj:
            res = again.query_batch(pts)
        assert inj.counts["engine.dispatch_padded"] == 2
        for t in range(self.PTS):
            np.testing.assert_array_equal(res.scores_of(t), got.scores_of(t))

    def test_corrupt_file_is_quarantined(self, tmp_path, capsys):
        path = tmp_path / "mem.json"
        path.write_text('{"torch-cpu:n1:model:d10": {"cells_ok": 5, ')
        eng, train = self._engine()
        res = eng.query_batch(np.asarray(train.x[:4]))
        assert res.counts.sum() > 0
        assert (tmp_path / "mem.json.corrupt").exists()
        assert "[memlimits] quarantined" in capsys.readouterr().err
        # the file was rewritten, sealed, from what this batch taught
        assert memlimits.load(eng._memkey)[0] > 0

    def test_success_clears_a_refuted_ceiling(self):
        eng, train = self._engine()
        eng._memlimits_seed()
        key = eng._memkey
        memlimits.update(key, 0, 1)  # a bogus ceiling of one cell
        fresh, _ = self._engine()
        pts = np.asarray(train.x[:1])
        with inject.active() as inj:
            fresh.query_batch(pts)
        assert inj.counts["engine.dispatch_padded"] == 1
        assert memlimits.load(key)[1] == memlimits.UNSET_BAD

    def test_ambiguous_failure_rises(self):
        """One ceiling, learned from out-of-memory failures only: the
        reference's ambiguous TPU failure (nothing on CUDA raises it) is
        neither retried nor halved here, and teaches the envelope
        nothing."""
        fresh, train = self._engine()
        with inject.active(
            inject.Fault("engine.dispatch_padded", at=0,
                         kind=taxonomy.AMBIGUOUS)
        ) as inj:
            with pytest.raises(RuntimeError) as ei:
                fresh.query_batch(np.asarray(train.x[: self.PTS]))
        assert taxonomy.classify(ei.value) == taxonomy.AMBIGUOUS
        assert inj.counts["engine.dispatch_padded"] == 1
        assert fresh._cells_bad == memlimits.UNSET_BAD
        assert memlimits.load(fresh._memkey)[1] == memlimits.UNSET_BAD

    def test_worker_fault_rebuilds_and_halves(self):
        eng, train = self._engine()
        pts = np.asarray(train.x[: self.PTS])
        base = eng.query_batch(pts)
        fresh, _ = self._engine()
        with inject.active(
            inject.Fault("engine.dispatch_padded", at=0,
                         kind=taxonomy.WORKER)
        ) as inj:
            got = fresh.query_batch(pts)
        assert inj.counts["engine.dispatch_padded"] == 3
        assert inj.counts["engine.upload"] == 1
        # a worker death is no memory evidence: nothing persisted as bad
        assert memlimits.load(fresh._memkey)[1] == memlimits.UNSET_BAD
        for t in range(self.PTS):
            np.testing.assert_allclose(got.scores_of(t), base.scores_of(t),
                                       rtol=1e-4, atol=1e-6)


class TestTrainerRetry:
    def test_transient_epoch_fault_retries_bit_identical(self):
        model, params, train = _setup()
        cfg = TrainConfig(batch_size=100, num_steps=30, learning_rate=1e-2)
        t1 = Trainer(model, cfg, device="cpu")
        clean = t1.fit(t1.init_state(params), train.x, train.y)
        t2 = Trainer(model, cfg, retry_policy=FAST, device="cpu")
        with inject.active(
            inject.Fault("trainer.epoch", at=0, kind=taxonomy.WORKER)
        ) as inj:
            got = t2.fit(t2.init_state(params), train.x, train.y)
        assert inj.unfired() == []
        assert _counter("reliability.retries_total{kind=worker}") == 1
        for k in clean.params:
            np.testing.assert_array_equal(got.params[k].numpy(),
                                          clean.params[k].numpy())

    def test_non_transient_fault_surfaces(self):
        model, params, train = _setup()
        cfg = TrainConfig(batch_size=100, num_steps=10, learning_rate=1e-2)
        t = Trainer(model, cfg, retry_policy=FAST, device="cpu")
        with inject.active(
            inject.Fault("trainer.epoch", at=0, kind=taxonomy.OOM)
        ):
            with pytest.raises(RuntimeError, match="RESOURCE_EXHAUSTED"):
                t.fit(t.init_state(params), train.x, train.y)
        assert _counter("reliability.retries_total{kind=oom}") == 0


def test_params_host_copies_are_taken_at_construction():
    """The host copies exist before any device work, are float32, and
    are what the device state is built from (a rebuild reads them, not
    the device)."""
    model, params, train = _setup()
    ref_arrays = jax.tree_util.tree_map(
        np.asarray, RefMF(U, I, K, WD).init_params(jax.random.PRNGKey(0)))
    eng = InfluenceEngine(model, params_from_numpy(model, ref_arrays, "cpu"),
                          train, damping=DAMP, device="cpu")
    for k, v in ref_arrays.items():
        assert eng._params_host[k].dtype == np.float32
        np.testing.assert_array_equal(eng._params_host[k], v)
        np.testing.assert_array_equal(eng.params[k].numpy(), v)

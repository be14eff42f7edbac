"""The port's chaos engine (``fia_tpu_torch/chaos``), port against port:
the 14 tests of ``tests/test_chaos.py`` restated on ``fia_tpu_torch``
(``TestSchedule``, ``TestDdmin``, ``TestSelftestEngine``,
``TestEndToEndScenario``; the end-to-end scenario on the CPU).

Port against the JAX package:

- ``generate`` gives the reference's schedule JSON byte for byte, for
  seeds 0-4 of every smoke scenario in both domains, the domains taken
  from scenarios with meshes on both sides (the reference's over the 8
  virtual XLA devices of ``tests/conftest.py``, the port's over virtual
  slots);
- ``ddmin`` returns the reference's subset for the same predicate;
- a repro file written by the reference loads and replays in the port
  to the same failure, and one written by the port in the reference.
"""

import json

import pytest
import torch

from fia_tpu.chaos import ChaosEngine as RefChaosEngine
from fia_tpu.chaos import schedule as ref_sched
from fia_tpu.chaos.scenarios import make_scenarios as ref_make_scenarios
from fia_tpu.chaos.shrink import ddmin as ref_ddmin
from fia_tpu.cli import chaos as ref_chaos_cli
from fia_tpu_torch.chaos import ChaosEngine
from fia_tpu_torch.chaos import schedule as sched
from fia_tpu_torch.chaos.scenarios import make_scenarios
from fia_tpu_torch.chaos.shrink import ddmin
from fia_tpu_torch.cli import chaos as chaos_cli
from fia_tpu_torch.reliability import sites, taxonomy

torch.set_num_threads(2)

DOMAIN = {
    sites.CHAOS_UNIT: ((taxonomy.WORKER, taxonomy.PREEMPTION), 6),
    sites.CHAOS_SCENARIO: ((taxonomy.WORKER,), 1),
}


class TestSchedule:
    def test_generation_is_pure(self):
        a = sched.generate("selftest", DOMAIN, seed=7, n_faults=3)
        b = sched.generate("selftest", DOMAIN, seed=7, n_faults=3)
        assert a == b and len(a.faults) == 3
        # a different seed (or scenario, or domain flavor) re-rolls
        assert a != sched.generate("selftest", DOMAIN, seed=8, n_faults=3)
        assert a != sched.generate("selftest", DOMAIN, seed=7, n_faults=3,
                                   benign=False)

    def test_no_duplicate_site_at_channel(self):
        # the injector fires the FIRST unfired match, so a duplicate
        # (site, at, channel) would be armed-but-unreachable
        s = sched.generate(
            "selftest", {sites.CHAOS_UNIT: ((taxonomy.WORKER,), 2)},
            seed=0, n_faults=10)
        keys = [(f.site, f.at) for f in s.faults]
        assert len(keys) == len(set(keys)) == 2  # domain exhausted

    def test_json_round_trip(self, tmp_path):
        s = sched.generate("selftest", DOMAIN, seed=3, n_faults=2,
                           benign=False)
        path = str(tmp_path / "s.json")
        s.save(path)
        assert sched.Schedule.load(path) == s

    def test_bad_magic_rejected(self):
        with pytest.raises(ValueError, match="magic"):
            sched.Schedule.from_dict({"magic": "nope", "scenario": "x"})

    def test_to_inject_validates_site(self):
        good = sched.ChaosFault(sites.CHAOS_UNIT, 0, taxonomy.WORKER)
        assert good.to_inject().site == sites.CHAOS_UNIT
        bad = sched.ChaosFault("no.such.site", 0, taxonomy.WORKER)
        with pytest.raises(ValueError, match="unknown injection site"):
            bad.to_inject()


class TestDdmin:
    def test_single_culprit(self):
        calls = []

        def fails(fs):
            calls.append(list(fs))
            return "bad" in fs

        out = ddmin(["a", "b", "bad", "c", "d", "e", "f", "g"], fails)
        assert out == ["bad"]

    def test_pair_interaction_kept_together(self):
        # the failure needs BOTH x and y — 1-minimality must not drop
        # either, whatever else gets removed
        items = ["a", "x", "b", "c", "y", "d"]
        out = ddmin(items, lambda fs: "x" in fs and "y" in fs)
        assert sorted(out) == ["x", "y"]

    def test_budget_exhaustion_returns_failing_set(self):
        items = list(range(16))
        out = ddmin(items, lambda fs: 13 in fs, max_tests=3)
        assert 13 in out  # maybe not minimal, but still a repro


class TestSelftestEngine:
    """The device-free harness loop: golden, oracles, shrink, replay."""

    def test_benign_schedule_bit_identical(self, tmp_path):
        eng = ChaosEngine(str(tmp_path), device="cpu")
        report = eng.run("selftest", seed=0, n_faults=3)
        assert report.passed, [f.to_dict() for f in report.failures]
        assert report.record.report["unfired"] == []

    def test_unreachable_fault_fails_accounting(self, tmp_path):
        eng = ChaosEngine(str(tmp_path), device="cpu")
        s = sched.Schedule("selftest", seed=0, faults=(
            sched.ChaosFault(sites.CHAOS_UNIT, 999, taxonomy.WORKER),
        ))
        report = eng.run_report(s, shrink=False)
        assert [f.oracle for f in report.failures] == ["fault_accounting"]

    def test_broken_scenario_shrinks_and_replays(self, tmp_path):
        """A deliberately broken oracle produces a shrunk schedule of <=3
        faults whose repro JSON replays to the same failure through the
        CLI."""
        eng = ChaosEngine(str(tmp_path), device="cpu")
        report = eng.run("selftest-broken", seed=0, n_faults=3)
        assert not report.passed
        assert report.failures[0].oracle == "bit_identity"
        assert report.shrunk is not None
        assert 1 <= len(report.shrunk.faults) <= 3
        assert report.repro_path is not None

        with open(report.repro_path) as f:
            repro = json.load(f)
        assert repro["magic"] == "fia-chaos-repro-v1"

        rc = chaos_cli.main([
            "--replay", report.repro_path,
            "--workdir", str(tmp_path / "replay"), "--quiet",
            "--backend", "cpu",
        ])
        assert rc == 1  # the shrunk schedule still fails — a true repro

    def test_replayed_failure_names_same_oracle(self, tmp_path, capsys):
        eng = ChaosEngine(str(tmp_path), device="cpu")
        report = eng.run("selftest-broken", seed=0, n_faults=3)
        replayed = ChaosEngine(str(tmp_path / "r"), device="cpu").replay(
            report.repro_path)
        assert {f.oracle for f in replayed.failures} == {
            f.oracle for f in report.failures}

    def test_kill_kind_surfaces_classified(self, tmp_path):
        # full-domain schedules may die, but only with a classified
        # error; bit_identity is not asserted for them
        eng = ChaosEngine(str(tmp_path), device="cpu")
        s = sched.Schedule("selftest", seed=0, benign=False, faults=(
            sched.ChaosFault(sites.CHAOS_UNIT, 0, taxonomy.OOM),
            sched.ChaosFault(sites.CHAOS_UNIT, 0, taxonomy.OOM),
            sched.ChaosFault(sites.CHAOS_UNIT, 0, taxonomy.OOM),
            sched.ChaosFault(sites.CHAOS_UNIT, 0, taxonomy.OOM),
        ))
        report = eng.run_report(s, shrink=False)
        assert report.passed  # retries exhausted -> classified surfacing
        assert report.record.error is not None
        assert report.record.error["kind"] == taxonomy.OOM


class TestEndToEndScenario:
    def test_train_resume_benign_bit_identical(self, tmp_path):
        """A benign schedule against the real train->kill->resume path
        reproduces the golden run's final params byte-for-byte."""
        eng = ChaosEngine(str(tmp_path), device="cpu")
        for seed in (0, 1):
            report = eng.run("train_resume", seed=seed, n_faults=3)
            assert report.passed, [f.to_dict() for f in report.failures]


# -------------------------------------------------- against the reference


@pytest.fixture(scope="module")
def domains():
    """Each smoke scenario's (port, reference) instance; the mesh
    scenarios' domains are per instance in the reference, so both sides
    are built (every other scenario's domains are class attributes)."""
    port, ref = make_scenarios(), ref_make_scenarios()
    meshy = ("device_loss_recovery", "host_loss_recovery")
    out = {}
    for name in ref_chaos_cli.SMOKE_SCENARIOS:
        if name in meshy:
            out[name] = (port[name](device="cpu"), ref[name]())
        else:
            out[name] = (port[name], ref[name])
    return out


def _domain(scen, benign: bool) -> dict:
    return scen.benign_domain if benign else scen.full_domain


@pytest.mark.parametrize("benign", [True, False], ids=["benign", "full"])
def test_generate_is_the_references_byte_for_byte(domains, benign):
    assert chaos_cli.SMOKE_SCENARIOS == ref_chaos_cli.SMOKE_SCENARIOS
    for name, (port, ref) in domains.items():
        assert _domain(port, benign) == _domain(ref, benign), name
        for seed in range(5):
            got = sched.generate(name, _domain(port, benign), seed, 3,
                                 benign)
            want = ref_sched.generate(name, _domain(ref, benign), seed, 3,
                                      benign)
            assert (json.dumps(got.to_dict(), indent=2)
                    == json.dumps(want.to_dict(), indent=2)), (name, seed)


@pytest.mark.parametrize("culprits", [("bad",), ("x", "y"), (3, 11, 12)])
def test_ddmin_is_the_references(culprits):
    items = ["a", "x", "b", "bad", "c", "y", "d", "e"] + list(range(16))

    def fails(fs):
        return all(c in fs for c in culprits)

    assert ddmin(items, fails) == ref_ddmin(items, fails)
    assert ddmin(items, fails, max_tests=3) == ref_ddmin(items, fails,
                                                         max_tests=3)


def test_repro_files_cross_between_packages(tmp_path):
    ref_report = RefChaosEngine(str(tmp_path / "ref")).run(
        "selftest-broken", seed=0, n_faults=3)
    assert ref_report.repro_path is not None
    loaded = ChaosEngine.load_repro(ref_report.repro_path)
    assert loaded.to_dict() == ref_report.shrunk.to_dict()
    replayed = ChaosEngine(str(tmp_path / "port"), device="cpu").replay(
        ref_report.repro_path)
    assert [f.to_dict() for f in replayed.failures] == [
        f.to_dict() for f in RefChaosEngine(str(tmp_path / "r2")).replay(
            ref_report.repro_path).failures]

    port_report = ChaosEngine(str(tmp_path / "port2"), device="cpu").run(
        "selftest-broken", seed=0, n_faults=3)
    with open(port_report.repro_path) as f, open(ref_report.repro_path) as g:
        assert f.read() == g.read()
    back = RefChaosEngine(str(tmp_path / "ref2")).replay(
        port_report.repro_path)
    assert {f.oracle for f in back.failures} == {"bit_identity"}


def test_cli_backend_defaults_to_cuda(tmp_path, monkeypatch):
    """``--backend`` none is the CUDA device: without one an end-to-end
    scenario raises rather than running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        chaos_cli.main(["--scenario", "serve_stream", "--quiet",
                        "--workdir", str(tmp_path)])
    assert chaos_cli.main(["--scenario", "selftest", "--quiet",
                           "--workdir", str(tmp_path / "s")]) == 0


def test_smoke_battery_on_cpu(tmp_path, capsys):
    """``--smoke --backend cpu``: the whole battery passes and prints
    its summary."""
    rc = chaos_cli.main(["--smoke", "--backend", "cpu", "--quiet",
                         "--workdir", str(tmp_path)])
    out = json.loads(capsys.readouterr().out)
    assert rc == 0, out["failed"]
    assert out["runs"] == (len(chaos_cli.SMOKE_SCENARIOS)
                           * chaos_cli.SMOKE_SEEDS_PER_SCENARIO)
    assert out["passed"] == out["runs"]


@pytest.fixture(scope="module")
def chip_smoke_module():
    import os
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)
    try:
        import chip_smoke
    finally:
        sys.path.remove(repo)
    return chip_smoke


@pytest.mark.parametrize("name,lost,left", [
    ("device_loss_recovery", 2, {"mesh_after": {"devices": 2,
                                                "shrunk": 2}}),
    ("host_loss_recovery", 2, {"mesh_after": {"devices": 4, "shrunk": 4},
                               "hosts_after": {"hosts": 2}}),
])
def test_chip_smoke_shrink_accounting(chip_smoke_module, tmp_path, name,
                                      lost, left):
    """``chip_smoke.py`` 15a's accounting on the CPU: benign seed 1
    fires two losses, and the mesh ends two slots (device loss) or two
    hosts of two slots (host loss) short."""
    rep = ChaosEngine(str(tmp_path), device="cpu").run(name, seed=1,
                                                       n_faults=3)
    assert rep.passed
    got = chip_smoke_module.chaos_run_checks(name, rep, "test")
    assert len([f for f in got["fired"] if f[2].endswith("_lost")]) == lost
    assert {k: got[k] for k in left} == left


def test_chip_smoke_traced_stream_on_cpu(chip_smoke_module, tmp_path,
                                         monkeypatch):
    """``chip_smoke.py`` 15c on the CPU: traced equals untraced, every
    chain complete, the trace and the Prometheus text parse."""
    monkeypatch.setattr(chip_smoke_module, "CARD", "cpu")
    out = chip_smoke_module.chaos_traced(str(tmp_path))
    assert out["chains"]["incomplete"] == 0
    assert out["chains"]["ok_complete"] == out["ok"] > 0
    assert out["trace_events"] > 0 and out["prom_samples"] > 0

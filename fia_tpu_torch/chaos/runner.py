"""The chaos engine: golden runs, armed runs, oracles, shrink, repro
(port of ``fia_tpu/chaos/runner.py``; the same repro files).

:class:`ChaosEngine` owns a root directory and a scenario registry.
For each scenario it computes one undisturbed *golden* run (cached —
built workload state lives on the scenario instance, so repeated
chaos runs capture each CUDA graph once), then executes schedules against
fresh per-run workdirs with the fault plan armed, applies the oracle
battery, and on failure shrinks the schedule with ddmin and emits a
replayable JSON repro
(``python -m fia_tpu_torch.cli.chaos --replay <repro.json>``).

Every run arms its plan with ``validate=True`` — a chaos schedule
naming an unregistered site is a bug in the schedule generator, not a
finding.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

from fia_tpu_torch import obs
from fia_tpu_torch.chaos import oracles as ochk
from fia_tpu_torch.chaos import schedule as sched
from fia_tpu_torch.chaos.oracles import OracleFailure, RunRecord
from fia_tpu_torch.chaos.scenarios import make_scenarios
from fia_tpu_torch.chaos.shrink import ddmin
from fia_tpu_torch.reliability import inject, sites, taxonomy
from fia_tpu_torch.utils import io

REPRO_MAGIC = "fia-chaos-repro-v1"


@dataclass
class ChaosReport:
    """One schedule's verdict (plus shrink artifacts on failure)."""

    schedule: sched.Schedule
    failures: list = field(default_factory=list)
    record: RunRecord | None = None
    shrunk: sched.Schedule | None = None
    repro_path: str | None = None

    @property
    def passed(self) -> bool:
        return not self.failures

    def to_dict(self) -> dict:
        return {
            "schedule": self.schedule.to_dict(),
            "passed": self.passed,
            "failures": [f.to_dict() for f in self.failures],
            "error": self.record.error if self.record else None,
            "events": list(self.record.events) if self.record else [],
            "shrunk": self.shrunk.to_dict() if self.shrunk else None,
            "repro_path": self.repro_path,
        }


class ChaosEngine:
    """Runs seeded schedules against scenarios and checks oracles."""

    def __init__(self, root: str, verbose: bool = False, device=None):
        self.root = root
        self.verbose = verbose
        # where the scenarios' engines, trainers and meshes live: None is
        # the CUDA device (raising without one), "cpu" the CPU
        self.device = device
        self._classes = make_scenarios()
        self._scenarios: dict = {}  # name -> constructed instance
        self._goldens: dict = {}  # name -> golden outcome payload
        self._runs = 0
        os.makedirs(root, exist_ok=True)

    def _say(self, msg: str) -> None:
        if self.verbose:
            obs.diag("chaos", msg)

    def scenario(self, name: str):
        if name not in self._classes:
            raise ValueError(
                f"unknown scenario {name!r}; have {sorted(self._classes)}"
            )
        if name not in self._scenarios:
            self._scenarios[name] = self._classes[name](device=self.device)
        return self._scenarios[name]

    def golden(self, name: str) -> dict:
        """The undisturbed run's outcome (computed once per scenario).

        The golden run executes with NO plan armed, in its own workdir;
        a failure here is a broken scenario, not a chaos finding, so it
        propagates.
        """
        if name not in self._goldens:
            scen = self.scenario(name)
            workdir = os.path.join(self.root, f"golden-{name}")
            self._say(f"golden run: {name}")
            events: list = []
            self._goldens[name] = scen.run(workdir, events)
        return self._goldens[name]

    def run_schedule(self, schedule: sched.Schedule
                     ) -> tuple[RunRecord, list]:
        """Execute one schedule; returns (record, oracle failures)."""
        scen = self.scenario(schedule.scenario)
        golden = self.golden(schedule.scenario)
        self._runs += 1
        workdir = os.path.join(
            self.root, f"run-{self._runs:04d}-{schedule.scenario}")
        events: list = []
        outcome = error = None
        with inject.active(*schedule.inject_faults(),
                           validate=True) as inj:
            try:
                inject.fire(sites.CHAOS_SCENARIO)
                outcome = scen.run(workdir, events)
            except Exception as e:
                error = {"kind": taxonomy.classify(e), "error": repr(e)}
        record = RunRecord(outcome=outcome, error=error, events=events,
                           report=inj.report(), workdir=workdir)
        failures = ochk.standard(golden, record, benign=schedule.benign)
        failures += scen.check(golden, record)
        self._say(
            f"{schedule.describe()} -> "
            + ("PASS" if not failures
               else f"FAIL ({', '.join(f.oracle for f in failures)})")
        )
        return record, failures

    def run(self, scenario_name: str, seed: int, n_faults: int,
            benign: bool = True, shrink: bool = True) -> ChaosReport:
        """Generate, run, and (on failure) shrink one seeded schedule."""
        scen = self.scenario(scenario_name)
        schedule = sched.generate(
            scenario_name, scen.domain(benign), seed, n_faults, benign)
        return self.run_report(schedule, shrink=shrink)

    def run_report(self, schedule: sched.Schedule,
                   shrink: bool = True) -> ChaosReport:
        record, failures = self.run_schedule(schedule)
        report = ChaosReport(schedule=schedule, failures=failures,
                             record=record)
        if failures and shrink and len(schedule.faults) > 1:
            report.shrunk = self.shrink(schedule, failures[0].oracle)
        elif failures and schedule.faults:
            report.shrunk = schedule
        if report.shrunk is not None:
            report.repro_path = self.write_repro(report)
        return report

    def shrink(self, schedule: sched.Schedule,
               target_oracle: str) -> sched.Schedule:
        """ddmin ``schedule`` down to a minimal plan still violating
        ``target_oracle`` (the first failure's stable id — shrinking
        against "any failure" can walk to an unrelated, weaker bug)."""
        self._say(f"shrinking against oracle {target_oracle!r} …")

        def still_fails(faults) -> bool:
            _, fls = self.run_schedule(schedule.with_faults(faults))
            return any(f.oracle == target_oracle for f in fls)

        minimal = ddmin(list(schedule.faults), still_fails)
        return schedule.with_faults(minimal)

    def write_repro(self, report: ChaosReport) -> str:
        """Publish the replayable repro JSON for a failed report."""
        shrunk = report.shrunk or report.schedule
        path = os.path.join(
            self.root,
            f"repro-{shrunk.scenario}-seed{shrunk.seed}.json")
        io.save_json_atomic(path, {
            "magic": REPRO_MAGIC,
            "schedule": shrunk.to_dict(),
            "original_schedule": report.schedule.to_dict(),
            "failures": [f.to_dict() for f in report.failures],
        }, indent=2)
        self._say(f"repro written: {path}")
        return path

    @staticmethod
    def load_repro(path: str) -> sched.Schedule:
        """The schedule inside a repro file (or a bare schedule JSON)."""
        import json

        with open(path) as f:
            d = json.load(f)
        if d.get("magic") == REPRO_MAGIC:
            d = d["schedule"]
        return sched.Schedule.from_dict(d)

    def replay(self, path: str) -> ChaosReport:
        """Re-run a repro file's schedule (no shrinking — it already is
        the minimal plan); the same failure must reproduce."""
        schedule = self.load_repro(path)
        record, failures = self.run_schedule(schedule)
        return ChaosReport(schedule=schedule, failures=failures,
                           record=record)

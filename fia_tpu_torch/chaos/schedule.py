"""Seeded, replayable fault schedules (copy of
``fia_tpu/chaos/schedule.py``; the same schedules and JSON bytes).

A *schedule* is the unit the chaos engine runs, shrinks, and replays:
an ordered set of ``(site, at, kind)`` faults drawn from a scenario's
declared fault domain — the injection sites the workload is guaranteed
to reach and the fault kinds meaningful there. Generation is a pure
function of ``(scenario, seed, n_faults, benign)``, so a schedule
printed in a failure report regenerates bit-identically anywhere, and
the JSON form (:meth:`Schedule.save` / :meth:`Schedule.load`) makes a
shrunk repro a file you can commit next to the bug it witnesses.

``benign=True`` restricts generation to each scenario's
*bit-identity-preserving* fault subset — kinds whose documented
recovery reproduces the undisturbed answer exactly (transient retry,
checkpoint walk-back, verified-cache self-heal, journaled deadline
resume). The full domain adds kinds whose recovery legitimately
changes results (solver escalation, CPU rung) or kills the run; those
schedules are checked against the weaker oracles only.
"""

from __future__ import annotations

import json
import random
from dataclasses import dataclass, field, replace

from fia_tpu_torch.reliability import inject, sites
from fia_tpu_torch.utils import io

MAGIC = "fia-chaos-schedule-v1"

# A scenario's fault domain: site -> (kinds, max_at). ``max_at`` is the
# number of calls the workload is *guaranteed* to make at that site on
# any run (retries and resumes only add calls, never remove them), so
# every generated fault is reachable and the injector's armed ⇒
# fired-or-reported contract holds for complete runs.
Domain = dict


@dataclass(frozen=True, order=True)
class ChaosFault:
    """One scheduled fault: serializable mirror of ``inject.Fault``."""

    site: str
    at: int
    kind: str

    def to_inject(self) -> inject.Fault:
        return inject.Fault(sites.check(self.site), int(self.at), self.kind)


@dataclass(frozen=True)
class Schedule:
    """A seeded fault schedule bound to one scenario."""

    scenario: str
    seed: int
    faults: tuple = field(default_factory=tuple)  # tuple[ChaosFault, ...]
    benign: bool = True

    def inject_faults(self) -> list:
        return [f.to_inject() for f in self.faults]

    def describe(self) -> str:
        body = ", ".join(f"{f.site}@{f.at}:{f.kind}" for f in self.faults)
        return f"{self.scenario}/seed={self.seed} [{body or 'no faults'}]"

    def with_faults(self, faults) -> "Schedule":
        return replace(self, faults=tuple(faults))

    def to_dict(self) -> dict:
        return {
            "magic": MAGIC,
            "scenario": self.scenario,
            "seed": int(self.seed),
            "benign": bool(self.benign),
            "faults": [
                {"site": f.site, "at": int(f.at), "kind": f.kind}
                for f in self.faults
            ],
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Schedule":
        if d.get("magic") != MAGIC:
            raise ValueError(
                f"not a chaos schedule (magic {d.get('magic')!r}, "
                f"want {MAGIC!r})"
            )
        faults = tuple(
            ChaosFault(str(f["site"]), int(f["at"]), str(f["kind"]))
            for f in d.get("faults", ())
        )
        return cls(
            scenario=str(d["scenario"]), seed=int(d.get("seed", 0)),
            faults=faults, benign=bool(d.get("benign", True)),
        )

    def save(self, path: str) -> str:
        return io.save_json_atomic(path, self.to_dict(), indent=2)

    @classmethod
    def load(cls, path: str) -> "Schedule":
        with open(path) as f:
            return cls.from_dict(json.load(f))


def generate(
    scenario_name: str,
    domain: Domain,
    seed: int,
    n_faults: int,
    benign: bool = True,
) -> Schedule:
    """A seeded schedule of ``n_faults`` faults over ``domain``.

    Pure function of its arguments (``random.Random(seed)``, no global
    state). Duplicate ``(site, at, channel)`` triples are rejected
    during sampling — the injector fires the *first* unfired match, so
    a duplicate would be armed but unreachable, violating the
    armed ⇒ fired-or-reported contract by construction.
    """
    rng = random.Random((seed, scenario_name, benign).__repr__())
    site_names = sorted(domain)
    taken: set = set()
    faults: list[ChaosFault] = []
    budget = max(int(n_faults), 0) * 8 + 8  # rejection-sampling bound
    while len(faults) < n_faults and budget > 0:
        budget -= 1
        site = rng.choice(site_names)
        kinds, max_at = domain[site]
        kind = rng.choice(list(kinds))
        at = rng.randrange(max(int(max_at), 1))
        key = (site, at, inject._channel(kind))
        if key in taken:
            continue
        taken.add(key)
        faults.append(ChaosFault(site, at, kind))
    return Schedule(
        scenario=scenario_name, seed=int(seed),
        faults=tuple(sorted(faults)), benign=benign,
    )

"""End-to-end invariant oracles (copy of ``fia_tpu/chaos/oracles.py``).

An oracle inspects one finished chaos run — its outcome payload, the
classified error that ended it (if any), the injector's fault
accounting, and the artifacts it left on disk — and returns
:class:`OracleFailure` records. The oracles encode the contracts the
reliability PRs promised:

- ``bit_identity`` — a run under a *benign* schedule (every fault has
  a bit-identity-preserving recovery) must produce outcomes
  bit-identical to the undisturbed golden run. Equality is on raw
  bytes + dtype + shape, not ``allclose``: the FIA fidelity story is
  "the fast path gives the same answer", and tolerance here would let
  silent-wrong-answer regressions hide inside it.
- ``classified_error`` — a run may *fail*, but only with an error the
  taxonomy classifies. An unclassified escape is a silent-wrong-answer
  hazard (nothing upstream knows how to recover from it).
- ``fault_accounting`` — armed ⇒ fired or reported: every scheduled
  fault either fired or the run ended early with a classified error
  (in which case unreached faults are expected). A complete run with
  unfired faults means the schedule did not test what it scripts.
- ``artifact_detectability`` — every artifact the run left under its
  original (non-quarantined) name either verifies or fails with a
  classified :class:`ArtifactIntegrityError`; nothing on disk can be
  parsed into garbage silently. Quarantined ``*.corrupt`` evidence is
  never re-verified (and never deleted — the run directory keeps it).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from fia_tpu_torch.reliability.artifacts import (
    MANIFEST_SUFFIX,
    ArtifactIntegrityError,
    verify,
)


@dataclass
class OracleFailure:
    """One violated invariant: a stable oracle id plus evidence."""

    oracle: str
    detail: str

    def to_dict(self) -> dict:
        return {"oracle": self.oracle, "detail": self.detail}


@dataclass
class RunRecord:
    """What one scenario run produced (the oracles' input)."""

    outcome: dict | None  # name -> np.ndarray | str | int; None on error
    error: dict | None  # {"kind": taxonomy kind | None, "error": repr}
    events: list = field(default_factory=list)
    report: dict = field(default_factory=dict)  # Injector.report()
    workdir: str | None = None


def _value_diff(name: str, a, b) -> str | None:
    """A human-readable diff for one outcome entry, or None if
    bit-identical."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        if a.dtype != b.dtype:
            return f"{name}: dtype {a.dtype} != {b.dtype}"
        if a.shape != b.shape:
            return f"{name}: shape {a.shape} != {b.shape}"
        if a.tobytes() != b.tobytes():
            return f"{name}: bytes differ"
        return None
    if a != b:
        return f"{name}: {a!r} != {b!r}"
    return None


def compare_outcomes(golden: dict, got: dict) -> list[str]:
    """All bit-level differences between two outcome payloads."""
    diffs = []
    for name in sorted(set(golden) | set(got)):
        if name not in golden:
            diffs.append(f"{name}: unexpected (absent from golden)")
        elif name not in got:
            diffs.append(f"{name}: missing")
        else:
            d = _value_diff(name, golden[name], got[name])
            if d:
                diffs.append(d)
    return diffs


def bit_identity(golden: dict, record: RunRecord) -> list[OracleFailure]:
    if record.error is not None or record.outcome is None:
        return []  # a surfaced error is classified_error's business
    diffs = compare_outcomes(golden, record.outcome)
    if not diffs:
        return []
    head = "; ".join(diffs[:4]) + ("; …" if len(diffs) > 4 else "")
    return [OracleFailure(
        "bit_identity",
        f"{len(diffs)} outcome entr{'y' if len(diffs) == 1 else 'ies'} "
        f"differ from the golden run: {head}",
    )]


def classified_error(record: RunRecord) -> list[OracleFailure]:
    if record.error is None:
        return []
    if record.error.get("kind") is not None:
        return []
    return [OracleFailure(
        "classified_error",
        f"run died with an unclassified error: {record.error.get('error')}",
    )]


def fault_accounting(record: RunRecord) -> list[OracleFailure]:
    unfired = record.report.get("unfired", [])
    if not unfired or record.error is not None:
        return []
    desc = ", ".join(f"{s}@{at}:{k}" for s, at, k in unfired)
    return [OracleFailure(
        "fault_accounting",
        f"run completed but {len(unfired)} armed fault(s) never fired "
        f"({desc}) — the schedule's reachability assumptions are wrong",
    )]


def artifact_detectability(record: RunRecord) -> list[OracleFailure]:
    if not record.workdir or not os.path.isdir(record.workdir):
        return []
    failures = []
    for dirpath, _dirnames, filenames in os.walk(record.workdir):
        for name in filenames:
            if ".corrupt" in name or name.endswith(MANIFEST_SUFFIX):
                continue
            full = os.path.join(dirpath, name)
            if not os.path.exists(full + MANIFEST_SUFFIX):
                continue  # not published through the integrity layer
            try:
                verify(full)
            except ArtifactIntegrityError:
                pass  # detectable damage is the contract working
            except Exception as e:
                failures.append(OracleFailure(
                    "artifact_detectability",
                    f"{full}: verification crashed unclassified: {e!r}",
                ))
    return failures


def standard(golden: dict, record: RunRecord,
             benign: bool) -> list[OracleFailure]:
    """The oracle battery every scenario gets; ``bit_identity`` only
    applies to benign schedules (the full fault domain includes kinds
    whose recovery legitimately changes results — solver escalation,
    CPU rung — and kinds that kill the run)."""
    failures = []
    if benign:
        failures += bit_identity(golden, record)
    failures += classified_error(record)
    failures += fault_accounting(record)
    failures += artifact_detectability(record)
    return failures

"""Deterministic fault-injection harness (copy of
``fia_tpu/reliability/inject.py``).

Every recovery path in the engine/trainer/distributed stack exists
because a real TPU failure was observed once — but before this module,
exercising those paths meant monkeypatching private engine methods per
test. Now the production code itself carries named *injection sites*
(:func:`fire` / :func:`corrupt` calls that are no-ops unless a plan is
armed), and tests script synthetic failures against them:

    from fia_tpu_torch.reliability import inject

    plan = [inject.Fault("engine.dispatch_flat", at=0, kind="worker"),
            inject.Fault("engine.solve", at=1, kind="nan")]
    with inject.active(*plan):
        engine.query_many(pts)          # recovery paths actually run

Faults fire on exact per-site call indices (``at``), so a schedule is
fully deterministic: the same plan against the same workload exercises
the same recovery decisions every run, on CPU, with no hardware in the
loop. Synthetic exception messages reuse the *observed* production
signatures (the worker-death and tunnel-500 strings), so the
taxonomy classifies injected faults exactly like real ones — the test
never talks to the classifier directly.

Site names are declared once in :mod:`fia_tpu_torch.reliability.sites`
(production call sites use the constants), with the reference's names.

On-disk corruption kinds (fired through :func:`damage`, applied AFTER a
publish completes so the atomic-write path itself stays honest):
``torn`` truncates the published file to half its bytes, ``bitflip``
flips one bit at the middle byte, ``stale_manifest`` rewrites the
sidecar manifest's checksum to another generation's — each a distinct
way the integrity layer's read-side verification must catch what the
write-side atomicity cannot.

Thread-safety: the armed plan is process-global module state (like a
real fault domain); arm it from the test thread only.
"""

from __future__ import annotations

import json
import os
from contextlib import contextmanager
from dataclasses import dataclass, field

import numpy as np

from fia_tpu_torch import obs
from fia_tpu_torch.reliability import sites as _sites
from fia_tpu_torch.reliability import taxonomy

# Artifact-corruption kinds (the damage channel). Not taxonomy kinds:
# they never raise — they mutate bytes on disk, and the read-side
# integrity layer (reliability/artifacts.py) must classify the result.
TORN = "torn"
BITFLIP = "bitflip"
STALE_MANIFEST = "stale_manifest"
ARTIFACT_KINDS = frozenset({TORN, BITFLIP, STALE_MANIFEST})


def _channel(kind: str) -> str:
    """Which injection channel a fault kind fires on: ``raise`` (fire),
    ``payload`` (corrupt), or ``artifact`` (damage)."""
    if kind == taxonomy.NAN:
        return "payload"
    if kind in ARTIFACT_KINDS:
        return "artifact"
    return "raise"

# Observed production signatures (BASELINE §4.1, engine.py history) —
# injected faults must classify identically to the real thing.
MESSAGES = {
    taxonomy.OOM: (
        "RESOURCE_EXHAUSTED: XLA:TPU compile permanent error. "
        "Ran out of memory in memory space hbm (injected)"
    ),
    taxonomy.AMBIGUOUS: (
        "HTTP 500: tpu_compile_helper subprocess exit code 1 (injected)"
    ),
    taxonomy.WORKER: (
        "UNAVAILABLE: TPU worker process crashed or restarted "
        "(kernel fault, injected)"
    ),
    taxonomy.PREEMPTION: (
        "ABORTED: The TPU worker was preempted by a maintenance event "
        "(injected)"
    ),
    taxonomy.DEVICE_LOST: (
        "UNAVAILABLE: TPU device lost: chip unreachable on the ICI "
        "fabric (injected)"
    ),
    taxonomy.HOST_LOST: (
        "DEADLINE_EXCEEDED: collective operation timed out waiting for "
        "peer task; host unreachable on the DCN (injected)"
    ),
}


@dataclass
class Fault:
    """One scheduled synthetic fault.

    ``site``: injection-site name (see module docstring).
    ``at``: 0-based call index at that site (the N-th ``fire``/
    ``corrupt`` there).
    ``kind``: a taxonomy kind — ``oom`` / ``ambiguous`` / ``worker`` /
    ``preemption`` raise a RuntimeError carrying the observed signature,
    ``host_oom`` raises :class:`MemoryError`, ``deadline`` raises
    :class:`~fia_tpu_torch.reliability.taxonomy.DeadlineExpired` (a budget
    expiring mid-dispatch), ``nan`` corrupts the
    payload passed through :func:`corrupt` (it never raises) — or an
    artifact kind (``torn`` / ``bitflip`` / ``stale_manifest``) that
    mutates the on-disk file passed through :func:`damage`.
    ``message``: optional signature override.
    """

    site: str
    at: int
    kind: str
    message: str | None = None
    fired: bool = field(default=False, compare=False)


class UnfiredFaultError(ValueError):
    """Armed faults never fired — the plan did not test what it thinks.

    A fault armed at a site the workload never reaches (or at a call
    index past the site's actual call count) is a silent no-op: the
    test passes without exercising the recovery path it scripts. Chaos
    schedules depend on the ``armed ⇒ fired or reported`` contract, so
    :func:`active` reports leftovers loudly at teardown — as a printed
    warning by default, as this error under ``strict=True``.
    """


class Injector:
    """Counts calls per site and fires the scheduled faults.

    ``validate=True`` checks every armed site against the
    :mod:`~fia_tpu_torch.reliability.sites` registry at arm time (chaos
    schedules always validate; hand-written unit-test plans may use
    synthetic site names and default to unvalidated).
    """

    def __init__(self, faults, validate: bool = False):
        self.faults = list(faults)
        if validate:
            for f in self.faults:
                _sites.check(f.site)
        self.counts: dict[str, int] = {}
        self.log: list[tuple[str, int, str]] = []

    def _tick(self, site: str) -> int:
        idx = self.counts.get(site, 0)
        self.counts[site] = idx + 1
        return idx

    def _match(self, site: str, idx: int, channel: str):
        for f in self.faults:
            if (
                f.site == site
                and f.at == idx
                and _channel(f.kind) == channel
                and not f.fired
            ):
                return f
        return None

    def fire(self, site: str) -> None:
        idx = self._tick(site)
        f = self._match(site, idx, "raise")
        if f is None:
            return
        f.fired = True
        self.log.append((site, idx, f.kind))
        if f.kind == taxonomy.HOST_OOM:
            raise MemoryError(f.message or "injected host allocation failure")
        if f.kind == taxonomy.DEADLINE:
            raise taxonomy.DeadlineExpired(
                f.message or f"injected deadline expiry at {site}"
            )
        msg = f.message or MESSAGES.get(f.kind)
        if msg is None:
            raise ValueError(f"no synthetic signature for kind {f.kind!r}")
        raise RuntimeError(msg)

    def corrupt(self, site: str, array):
        idx = self._tick(site)
        f = self._match(site, idx, "payload")
        if f is None:
            return array
        f.fired = True
        self.log.append((site, idx, f.kind))
        out = np.array(array, copy=True)
        if out.size:
            out.reshape(-1)[0] = np.nan
        return out

    def damage(self, site: str, path: str, manifest_path: str | None) -> None:
        idx = self._tick(site)
        f = self._match(site, idx, "artifact")
        if f is None:
            return
        f.fired = True
        self.log.append((site, idx, f.kind))
        if f.kind == TORN:
            # a torn write: the file stops mid-byte-stream
            os.truncate(path, os.path.getsize(path) // 2)
        elif f.kind == BITFLIP:
            # single-bit rot at the middle byte: size (and usually the
            # zip envelope) stay plausible — only the checksum can tell
            with open(path, "r+b") as fh:
                off = max(0, os.path.getsize(path) // 2 - 1)
                fh.seek(off)
                b = fh.read(1) or b"\x00"
                fh.seek(off)
                fh.write(bytes([b[0] ^ 0x01]))
        elif f.kind == STALE_MANIFEST and manifest_path and os.path.exists(
            manifest_path
        ):
            # a manifest left behind by a previous generation of the
            # file: internally well-formed, checksum of different bytes
            with open(manifest_path) as fh:
                m = json.load(fh)
            m["checksum"] = "sha256:" + "0" * 64
            with open(manifest_path, "w") as fh:
                json.dump(m, fh, sort_keys=True)

    def unfired(self) -> list[Fault]:
        return [f for f in self.faults if not f.fired]

    def report(self) -> dict:
        """Machine-readable fault accounting for oracles and repro
        files: per-site call counts, faults that fired (site, index,
        kind), and armed faults that never fired."""
        return {
            "counts": dict(self.counts),
            "fired": [list(entry) for entry in self.log],
            "unfired": [[f.site, f.at, f.kind] for f in self.unfired()],
        }


_active: Injector | None = None


def fire(site: str) -> None:
    """Injection site: raises the scheduled synthetic failure, if any.
    A no-op (one global read) when no plan is armed."""
    if _active is not None:
        _active.fire(site)


def corrupt(site: str, array):
    """Payload injection site: returns ``array`` with NaN written into
    its first element when a ``nan`` fault is scheduled here, else the
    array untouched."""
    if _active is not None:
        return _active.corrupt(site, array)
    return array


def damage(site: str, path: str, manifest_path: str | None = None) -> None:
    """On-disk injection site: applies a scheduled ``torn`` /
    ``bitflip`` / ``stale_manifest`` corruption to a just-published
    artifact. A no-op (one global read) when no plan is armed."""
    if _active is not None:
        _active.damage(site, path, manifest_path)


def call_count(site: str) -> int:
    """How many times ``site`` has been reached under the armed plan
    (0 when no plan is armed) — tests assert recovery-path shapes."""
    if _active is None:
        return 0
    return _active.counts.get(site, 0)


@contextmanager
def active(*faults: Fault, strict: bool = False, validate: bool = False):
    """Arm a fault plan for the duration of the block.

    Yields the :class:`Injector` so tests can inspect ``log``/
    ``counts``/``unfired`` afterwards. Nesting is rejected — overlapping
    plans would make schedules ambiguous.

    Armed ⇒ fired or reported: a fault left unfired at teardown (a site
    the workload never reached, or an ``at`` index past the site's call
    count) is printed as a loud warning; under ``strict=True`` it
    raises :class:`UnfiredFaultError` instead — unless the block is
    already unwinding with an exception, which the leftover report must
    not mask. ``validate=True`` rejects unregistered site names at arm
    time (see :class:`Injector`).
    """
    global _active
    if _active is not None:
        raise RuntimeError("a fault-injection plan is already armed")
    inj = Injector(faults, validate=validate)
    _active = inj
    completed = False
    try:
        yield inj
        completed = True
    finally:
        _active = None
        leftovers = inj.unfired()
        if leftovers:
            desc = ", ".join(
                f"{f.site}@{f.at}:{f.kind}" for f in leftovers
            )
            msg = (
                f"{len(leftovers)} armed fault(s) never fired ({desc}) — "
                "the workload never reached those (site, call-index) "
                "points, so the plan did not test what it scripts"
            )
            if strict and completed:
                raise UnfiredFaultError(msg)
            obs.diag("inject", f"WARNING: {msg}")

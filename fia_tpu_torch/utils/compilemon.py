"""Process-wide counter of flat-program builds (the port's counterpart
of ``fia_tpu/utils/compilemon.py``).

The no-rebuild steady-state contract (the reference's
``docs/design.md`` §14) needs an observable that counts builds, not
cache entries. In the port a build is a CUDA-graph capture of one flat
program geometry on the card, and the build of a geometry's program
closure on the CPU; the engine records each one here
(``InfluenceEngine._build_flat``), so a hot path that builds nothing
leaves the count where it was::

    from fia_tpu_torch.utils import compilemon
    before = compilemon.count()
    ... hot path ...
    assert compilemon.count() == before
"""

from __future__ import annotations

_counts = {"builds": 0}


def install() -> None:
    """Idempotent, as the reference's: the engine records its builds
    itself, so there is no listener to register."""


def record() -> None:
    """One flat program built (captured, on the card)."""
    _counts["builds"] += 1


def count() -> int:
    """Flat programs built so far in this process."""
    install()
    return _counts["builds"]

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

Each build is also mirrored into the obs spine as the reference mirrors
a backend compile: ``compile.backend_total`` counts it, and a capture's
seconds go to the ``compile.backend_us`` histogram and, as a
``compile.backend`` event, to whatever span was active (e.g.
``engine.precompile``), which is how a capture is attributed to a key.
"""

from __future__ import annotations

from fia_tpu_torch.obs.registry import REGISTRY
from fia_tpu_torch.obs.trace import TRACER

_counts = {"builds": 0}


def install() -> None:
    """Idempotent, as the reference's: the engine records its builds
    itself, so there is no listener to register."""


def record(seconds: float | None = None) -> None:
    """One flat program built; ``seconds``, the capture's duration on
    the card (``None`` for a CPU closure, which has none)."""
    _counts["builds"] += 1
    REGISTRY.counter("compile.backend_total").inc()
    if seconds is not None:
        REGISTRY.histogram("compile.backend_us").observe(seconds * 1e6)
        TRACER.current_span().event(
            "compile.backend", dur_us=round(seconds * 1e6, 1))


def count() -> int:
    """Flat programs built so far in this process."""
    install()
    return _counts["builds"]

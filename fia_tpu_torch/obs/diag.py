"""Structured diagnostics (copy of ``fia_tpu/obs/diag.py``): the
replacement for bare ``print`` in library code.

Library code that needs a human-visible note calls :func:`diag`, which
does three things at once so the note is never lost:

- writes one ``[channel] message`` line to **stderr** (stdout stays
  reserved for machine-readable CLI output),
- bumps the ``diag_total{channel=...}`` counter in the obs registry,
- attaches a ``diag.<channel>`` event to the current trace span, if
  any — so a solver escalation shows up inside the very query that hit
  it.
"""

from __future__ import annotations

import sys

from fia_tpu_torch.obs.registry import REGISTRY
from fia_tpu_torch.obs.trace import TRACER


def diag(channel: str, msg: str, **fields) -> None:
    """One diagnostic: stderr line + counter + span event."""
    REGISTRY.counter("diag_total", channel=channel).inc()
    TRACER.current_span().event(f"diag.{channel}", msg=msg, **fields)
    extra = ""
    if fields:
        extra = " " + " ".join(f"{k}={v}" for k, v in fields.items())
    sys.stderr.write(f"[{channel}] {msg}{extra}\n")

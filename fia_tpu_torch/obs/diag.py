"""Structured diagnostics (port of ``fia_tpu/obs/diag.py``).

Library code that needs a human-visible note calls :func:`diag`, which
writes one ``[channel] message`` line to stderr, so stdout stays
reserved for machine-readable CLI output. The reference also bumps a
``diag_total`` counter and attaches a trace-span event; the port has no
registry or tracer yet (ROADMAP Queue A.10), so the line is all.
"""

from __future__ import annotations

import sys


def diag(channel: str, msg: str, **fields) -> None:
    """One diagnostic line on stderr, in the reference's format."""
    extra = ""
    if fields:
        extra = " " + " ".join(f"{k}={v}" for k, v in fields.items())
    sys.stderr.write(f"[{channel}] {msg}{extra}\n")

"""Declared obs event schema (JSONL surface; copy of
``fia_tpu/obs/events.py``).

The obs spine adds two event kinds to a JSONL event stream: one line a
finished span and one a registry snapshot, in the reference's field
names, so files written by either package read alike. Keep this a
literal dict (the reference's linter reads its copy with
``ast.literal_eval``).
"""

from __future__ import annotations

SCHEMA = {
    # one line per finished span (export.span_fields): trace/span/parent
    # are derived ids (obs/trace.py),
    # t0 epoch-seconds, dur_us the span duration, attrs/events the
    # span's key-value annotations and zero-duration markers
    "obs.span": (
        "trace", "span", "parent", "name", "t0", "dur_us",
        "attrs", "events",
    ),
    # the registry snapshot (obs/registry.py Registry.snapshot())
    "obs.metrics": ("snapshot",),
}

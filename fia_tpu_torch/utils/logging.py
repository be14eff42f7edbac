"""Structured logging (copy of ``fia_tpu/utils/logging.py``).

The reference logs with bare ``print`` to redirected files and accepts a
``log_dir`` kwarg it never uses (``genericNeuralNet.py:89``; SURVEY.md
§5). This is the working equivalent: a tiny JSONL event logger for
training curves, influence-query timings and experiment artifacts —
machine-readable, append-only, dependency-free.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any


class EventLog:
    """Append-only JSONL event log. Falsy path = disabled (no-op)."""

    def __init__(self, path: str | None):
        self.path = path
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._fh = open(path, "a", buffering=1)
        else:
            self._fh = None

    def log(self, event: str, **fields: Any) -> None:
        if self._fh is None:
            return
        rec = {"t": round(time.time(), 3), "event": event, **fields}
        self._fh.write(json.dumps(rec) + "\n")

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_events(path: str) -> list[dict]:
    with open(path) as fh:
        return [json.loads(line) for line in fh if line.strip()]

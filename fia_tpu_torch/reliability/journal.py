"""Fingerprinted JSONL progress journal for resumable execution (copy
of ``fia_tpu/reliability/journal.py``; the same file format).

A long RQ1 chain that dies mid-run must not recompute what it had
finished: the journal holds durable, append-only progress under a run
fingerprint, so an interrupted workload restarts and *skips* completed
units.

Format — one JSON object per line:

    {"kind": "header", "magic": "fia-journal-v1", "fingerprint": {...}}
    {"kind": "done", "key": "point:17", "payload": {...}}
    ...

Design points:

- **Fingerprint.** The header binds the journal to the run's identity
  (model key, protocol, test set, …). A resume against a different
  fingerprint raises :class:`JournalMismatch` — silently reusing
  another config's progress is exactly the artifact-clobbering bug
  class the RQ1 provenance scheme exists to prevent.
- **Append-only + crash-tolerant reads.** Each completed unit is one
  ``write + flush + fsync``; a kill mid-append leaves at most one
  truncated trailing line, which :func:`Journal.open` drops (any
  undecodable or wrong-shaped line is skipped, counted in
  ``corrupt_lines``). Progress is never rewritten in place, so a
  corrupt tail can only cost the last unit.
- **Exact payload round-trips.** Numpy arrays are encoded with dtype +
  shape and element-exact number serialisation (Python ``repr`` floats
  survive JSON exactly), so a resumed run reconstructs byte-identical
  artifacts — the RQ1 ``--resume`` acceptance test diffs npz bytes.
"""

from __future__ import annotations

import json
import os

import numpy as np

MAGIC = "fia-journal-v1"


class JournalMismatch(RuntimeError):
    """Resume attempted against a journal with a different fingerprint."""


def pack(obj):
    """JSON-encodable form of ``obj`` (numpy arrays/scalars included).

    Arrays become ``{"__ndarray__": {dtype, shape, data}}`` with
    ``data`` a flat list of Python numbers — int exactly, float via the
    shortest-repr round-trip (exact for every float64, and for every
    float32 once re-cast, since a float32 is exactly representable in
    float64).
    """
    if isinstance(obj, np.ndarray):
        return {
            "__ndarray__": {
                "dtype": obj.dtype.str,
                "shape": list(obj.shape),
                "data": [x.item() for x in obj.reshape(-1)],
            }
        }
    if isinstance(obj, np.generic):
        return obj.item()
    if isinstance(obj, dict):
        return {str(k): pack(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [pack(v) for v in obj]
    return obj


def unpack(obj):
    """Inverse of :func:`pack`."""
    if isinstance(obj, dict):
        if set(obj) == {"__ndarray__"}:
            spec = obj["__ndarray__"]
            return np.asarray(spec["data"], dtype=np.dtype(spec["dtype"])
                              ).reshape(spec["shape"])
        return {k: unpack(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [unpack(v) for v in obj]
    return obj


class Journal:
    """Append-only progress journal bound to one run fingerprint.

    Use :meth:`open` (the only constructor callers should use): it
    creates, loads, or refuses the on-disk file according to ``resume``.
    """

    def __init__(self, path, fingerprint, entries, corrupt_lines, fh):
        self.path = path
        self.fingerprint = fingerprint
        self.entries: dict[str, object] = entries
        self.corrupt_lines = int(corrupt_lines)
        self._fh = fh

    @classmethod
    def open(cls, path: str, fingerprint: dict, *, resume: bool = False,
             fsync: bool = True) -> "Journal":
        """Open (and on non-resume, reset) the journal at ``path``.

        ``resume=False``: any existing file is rotated aside to
        ``<path>.stale`` and a fresh journal begins — a non-resume run
        must not inherit progress it did not compute.
        ``resume=True``: completed entries are loaded; a header whose
        fingerprint differs raises :class:`JournalMismatch` (loud, per
        the provenance rules); a missing or headerless/corrupt file
        degrades to a fresh journal (there is nothing safe to reuse).
        """
        fingerprint = json.loads(json.dumps(pack(fingerprint),
                                            sort_keys=True))
        entries: dict[str, object] = {}
        corrupt = 0
        exists = os.path.exists(path)
        if exists and not resume:
            os.replace(path, path + ".stale")
            exists = False
        if exists:
            header = None
            with open(path) as fh:
                for line in fh:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                        kind = rec["kind"]
                    except (ValueError, TypeError, KeyError):
                        corrupt += 1  # truncated/garbled line: skip
                        continue
                    if kind == "header":
                        if rec.get("magic") != MAGIC:
                            corrupt += 1
                            continue
                        header = rec.get("fingerprint")
                    elif kind == "done":
                        try:
                            entries[str(rec["key"])] = unpack(rec["payload"])
                        except (KeyError, TypeError, ValueError):
                            corrupt += 1
            if header is None:
                # no intact header: nothing trustworthy to resume from
                os.replace(path, path + ".stale")
                entries, exists = {}, False
            elif header != fingerprint:
                raise JournalMismatch(
                    f"journal {path} was written by a different run "
                    f"configuration; refusing to resume (its fingerprint "
                    f"{header!r} != {fingerprint!r}). Move it aside or "
                    "drop --resume to start fresh."
                )
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        fh = open(path, "a", buffering=1)
        j = cls(path, fingerprint, entries, corrupt, fh)
        j._fsync = bool(fsync)
        if not exists:
            j._append({"kind": "header", "magic": MAGIC,
                       "fingerprint": fingerprint})
        return j

    # -- progress ---------------------------------------------------------
    def done(self, key: str) -> bool:
        return str(key) in self.entries

    def get(self, key: str):
        return self.entries[str(key)]

    def record(self, key: str, payload) -> None:
        """Durably mark ``key`` complete (one fsynced appended line)."""
        packed = pack(payload)
        self._append({"kind": "done", "key": str(key), "payload": packed})
        self.entries[str(key)] = unpack(
            json.loads(json.dumps(packed, sort_keys=True))
        )

    def _append(self, rec: dict) -> None:
        # sort_keys: a replayed journal must be byte-identical to the
        # original, so line bytes can't follow dict construction order
        self._fh.write(json.dumps(rec, sort_keys=True) + "\n")
        self._fh.flush()
        if getattr(self, "_fsync", True):
            os.fsync(self._fh.fileno())

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

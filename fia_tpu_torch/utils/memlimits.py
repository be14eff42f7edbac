"""Cross-process persistence of learned device-memory envelopes (port
of ``fia_tpu/utils/memlimits.py``; the same sealed file format and the
same ``FIA_MEMLIMIT_CACHE`` variable).

The engine's memory-adaptive padded path (``engine.py:
_query_padded_adaptive``) learns, per engine, the largest (queries x
pad) cell count that dispatched successfully and the smallest that
exhausted device memory. Within one process that stops repeated failing
dispatches — but every fresh process would pay one failing dispatch
(and the allocator's unwinding) to rediscover the same ceiling. This
module shares the learned envelope across processes via a small JSON
file, keyed by (device kind, device count, model name, block dim) —
the inputs the per-cell temporary cost actually depends on (see
``key``).

Best-effort by design: concurrent writers publish atomically (private
tmp + rename, the same convention as the inverse-HVP cache) and the
worst outcome of a lost update is exactly the status quo ante: one
extra learning failure in some later process.

Integrity: every write seals the file with an ``__integrity__`` record
(magic + sha256 of the canonical entries JSON). A sealed file whose
checksum no longer matches its entries — bit rot, a torn concurrent
write — is quarantined (renamed ``*.corrupt``, evidence preserved,
never re-read) and treated as absent; a pre-seal legacy file is
accepted as-is. Wrong-*shaped* but well-formed JSON is tolerated as a
virgin cache (it is not provably ours to quarantine).
"""

from __future__ import annotations

import hashlib
import json
import os

from fia_tpu_torch import obs

_MAGIC = "fia-memlimits-v1"
_SEAL = "__integrity__"

_ENV = "FIA_MEMLIMIT_CACHE"
_DEFAULT = os.path.join("output", ".mem_limits.json")

# Sentinel for "no failing size on record", shared with the engine's
# padded envelope, whose out-of-memory failures are the only ones that
# lower it.
UNSET_BAD = 1 << 62


def _path() -> str:
    return os.environ.get(_ENV, _DEFAULT)


def key(
    backend: str, num_devices: int, model_name: str, block_dim: int
) -> str:
    """Cache key for one memory-envelope regime.

    ``backend`` names the device kind: ``"cuda:" +`` the card's name
    (``torch.cuda.get_device_name``) on the card, so a card of another
    memory size keeps its own entries, and ``"torch-cpu"`` on the CPU.
    Neither matches a key of the reference's (``"tpu"``, ``"cpu"``), so
    the two packages can share one file without reading each other's
    envelopes. ``num_devices`` matters once a multi-device padded path
    shards T across devices (per-device temporaries scale with
    T x pad / n).
    """
    return f"{backend}:n{int(num_devices)}:{model_name}:d{int(block_dim)}"


def _entries_checksum(entries: dict) -> str:
    canon = json.dumps(entries, sort_keys=True)
    return "sha256:" + hashlib.sha256(canon.encode()).hexdigest()


def _quarantine(path: str) -> None:
    """Rename a damaged cache aside (``*.corrupt``, incremented on
    collision) so the evidence survives but is never re-read."""
    dst = path + ".corrupt"
    n = 0
    while os.path.exists(dst):
        n += 1
        dst = f"{path}.corrupt.{n}"
    try:
        os.replace(path, dst)
        obs.diag(
            "memlimits",
            f"quarantined corrupt cache -> {os.path.basename(dst)}",
        )
    except OSError:
        pass


def _open_checked(path: str) -> dict:
    """Entries from the cache file, seal-verified.

    Unparseable files and sealed files whose checksum mismatches are
    quarantined and read as empty; legacy (seal-less) and wrong-shaped
    files are read as empty/as-is without quarantine.
    """
    try:
        with open(path) as f:
            data = json.load(f)
    except OSError:
        return {}
    except ValueError:
        _quarantine(path)
        return {}
    if not isinstance(data, dict):
        return {}
    seal = data.pop(_SEAL, None)
    if seal is not None:
        ok = (
            isinstance(seal, dict)
            and seal.get("magic") == _MAGIC
            and seal.get("checksum") == _entries_checksum(data)
        )
        if not ok:
            _quarantine(path)
            return {}
    return data


def load(k: str) -> tuple[int, int]:
    """(cells_ok, cells_bad) previously learned for key ``k``.

    Returns (0, UNSET_BAD) — the engine's virgin state — when the
    cache is absent, unreadable, corrupt (quarantined), wrong-shaped,
    or has no entry.
    """
    try:
        data = _open_checked(_path())
        entry = data.get(k)
        if not isinstance(entry, dict):
            return 0, UNSET_BAD
        ok = max(0, int(entry.get("cells_ok", 0)))
        bad = int(entry.get("cells_bad", UNSET_BAD))
        if bad <= 0:
            bad = UNSET_BAD
        return ok, bad
    except (OSError, ValueError, TypeError):
        return 0, UNSET_BAD


def update(
    k: str,
    cells_ok: int,
    cells_bad: int,
    *,
    clear_bad_at: int | None = None,
) -> None:
    """Merge one engine's learned envelope into the shared cache.

    Merging widens monotonically (max ok, min bad) so concurrent
    engines can only make the cached envelope more informed. No-ops
    when there is nothing learned, or when the cache directory does
    not exist (e.g. library use outside a repo checkout).

    ``clear_bad_at``: the caller observed a dispatch of this many cells
    SUCCEED at or above a previously recorded failing size — direct
    evidence that record was a misclassified transient fault, not a
    memory ceiling. Any stored ``cells_bad`` at or below the observed
    success is dropped; a stored bad strictly above it remains
    plausible and survives. (The observed size, not the merged
    ``cells_ok``, is the comparison point: a stale over-large ok from
    an old cache must not launder away a genuine ceiling.) Callers must
    only persist ``cells_bad`` values learned from explicit
    out-of-memory errors (a poisoned shared ceiling degrades every
    later process until the file is deleted by hand).
    """
    if cells_ok <= 0 and cells_bad >= UNSET_BAD and clear_bad_at is None:
        return
    path = _path()
    d = os.path.dirname(path) or "."
    if not os.path.isdir(d):
        return
    try:
        data = _open_checked(path)
        prev = data.get(k)
        if not isinstance(prev, dict):
            prev = {}

        def _int(v, default):
            try:
                return int(v)
            except (ValueError, TypeError):
                return default

        merged_ok = max(_int(prev.get("cells_ok"), 0), int(cells_ok))
        prev_bad = _int(prev.get("cells_bad"), UNSET_BAD)
        # The clear applies to the PREVIOUSLY stored ceiling only; the
        # caller's own cells_bad is newer evidence than its observed
        # success and must survive the merge (a run can clear a stale
        # ceiling AND re-learn a genuine one at the same size).
        if clear_bad_at is not None and prev_bad <= int(clear_bad_at):
            prev_bad = UNSET_BAD
        merged_bad = min(prev_bad, int(cells_bad))
        merged = {"cells_ok": merged_ok, "cells_bad": merged_bad}
        if merged == prev:
            return
        data[k] = merged
        sealed = dict(data)
        sealed[_SEAL] = {
            "magic": _MAGIC, "checksum": _entries_checksum(data)
        }
        from fia_tpu_torch.utils.io import save_json_atomic

        save_json_atomic(path, sealed)
    except OSError:
        pass  # best-effort: a lost update costs one re-learning failure

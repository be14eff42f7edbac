"""Small IO helpers shared by the checkpoints and experiment drivers
(copy of ``fia_tpu/utils/io.py``).

This module owns the low-level durable-write primitives; the integrity
layer on top (checksums, manifests, quarantine) is
:mod:`fia_tpu_torch.reliability.artifacts`. Artifact writers go through
that layer rather than raw ``open(.., "w")`` / ``np.save*`` calls.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import tempfile

import numpy as np

# Temp-file naming embeds the writer's pid so a kill between write and
# rename leaves something sweep_stale_tmps can prove is dead:
#   .npztmp.<pid>.XXXXXX.npz      (this module's mkstemp pattern)
#   <stem>.tmp.<pid>.npz          (the legacy checkpoint.save pattern)
_TMP_PATTERNS = (
    re.compile(r"^\.npztmp\.(\d+)\..*\.npz$"),
    re.compile(r"\.tmp\.(\d+)\.npz$"),
    re.compile(r"^\.jsontmp\.(\d+)\..*\.json$"),
    re.compile(r"^\.txttmp\.(\d+)\..*\.txt$"),
    re.compile(r"^\.manifest-tmp\.(\d*).*\.json$"),  # pid-less: see sweep
)


def fsync_dir(path: str) -> None:
    """fsync a directory so a just-renamed entry survives power loss.

    ``os.replace`` makes the rename atomic against concurrent readers,
    but the new directory entry itself is not durable until the
    directory inode is synced — a kill after replace could resurface
    the old file (or nothing). Best-effort: some platforms/filesystems
    refuse directory fsync; that degrades to the pre-PR durability, not
    an error.
    """
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def save_npz_atomic(path: str, **arrays) -> tuple[str, str, int]:
    """np.savez published by fsync'd write + atomic rename.

    A kill mid-write must never leave a truncated npz at ``path`` (the
    engine's inverse-HVP cache is read back; RQ sweeps accumulate hours
    of results in one file). A private mkstemp tmp also keeps concurrent
    writers from interleaving into each other's files. The temp file is
    fsync'd before the rename and the directory after it, so the
    published bytes are durable — not just atomic — at return.

    Returns ``(path, sha256_hex, size)`` of the published bytes, so the
    integrity layer (reliability/artifacts.py) can stamp its manifest
    without re-reading the file it just wrote.
    """
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(
        dir=d, prefix=f".npztmp.{os.getpid()}.", suffix=".npz"
    )
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
            f.flush()
            os.fsync(f.fileno())
        sha = _file_sha256(tmp)
        size = os.path.getsize(tmp)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    fsync_dir(d)
    return path, sha, size


def _write_atomic(path: str, prefix: str, suffix: str, write_fn) -> str:
    """Shared fsync'd temp-write + atomic-rename dance.

    ``write_fn(file_object)`` produces the bytes; the temp name embeds
    the writer's pid so :func:`sweep_stale_tmps` can reap droppings
    from a killed writer.
    """
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(
        dir=d, prefix=f"{prefix}{os.getpid()}.", suffix=suffix
    )
    try:
        with os.fdopen(fd, "w") as f:
            write_fn(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    fsync_dir(d)
    return path


def save_json_atomic(path: str, obj, *, indent: int | None = None) -> str:
    """json.dump published by fsync'd write + atomic rename.

    The JSON counterpart of :func:`save_npz_atomic` for experiment
    reports and sealed envelopes: a kill mid-write never leaves a
    truncated document at ``path``. This (or the artifacts layer) is
    the sanctioned route for persisted JSON — raw ``json.dump`` /
    ``open(.., "w")`` writes are flagged by lint rule FIA101.
    """
    return _write_atomic(
        path, ".jsontmp.", ".json",
        # sort_keys pins the byte stream to the content, not to dict
        # construction order (FIA504: fingerprints hash these bytes)
        lambda f: json.dump(obj, f, indent=indent, sort_keys=True),
    )


def save_text_atomic(path: str, text: str) -> str:
    """A text document published by fsync'd write + atomic rename."""
    return _write_atomic(
        path, ".txttmp.", ".txt", lambda f: f.write(text)
    )


def savetxt_atomic(path: str, array, **kwargs) -> str:
    """np.savetxt published by fsync'd write + atomic rename (the TSV
    dataset-fixture writer's durable form)."""
    return _write_atomic(
        path, ".txttmp.", ".txt",
        lambda f: np.savetxt(f, array, **kwargs),
    )


def _file_sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except (PermissionError, OSError):
        return True  # exists but not ours — leave its temp files alone
    return True


def sweep_stale_tmps(
    dirpath: str, age_horizon_s: float = 6 * 3600.0
) -> list[str]:
    """Remove temp files abandoned by a killed writer; return them.

    A kill between write and rename leaves ``.npztmp.<pid>.*.npz`` /
    ``*.tmp.<pid>.npz`` droppings that would otherwise accumulate
    forever. A temp file is provably stale when its embedded pid is no
    longer a live process. A *live* pid is not proof of ownership —
    pids are recycled, so a kill-loop (the chaos engine's
    train→kill→resume scenario, or any supervisor that restarts
    writers) can leave a dropping whose pid now names an unrelated
    process, which the pid probe would protect forever. The age
    fallback breaks that tie: a temp file older than ``age_horizon_s``
    (default 6 h — no atomic publish holds its temp open that long) is
    sweepable regardless of what its embedded pid looks like today.
    pid-less manifest temps are swept only when their mtime is over an
    hour old.
    """
    removed: list[str] = []
    if not os.path.isdir(dirpath):
        return removed
    import time

    for name in os.listdir(dirpath):
        for pat in _TMP_PATTERNS:
            m = pat.search(name)
            if not m:
                continue
            full = os.path.join(dirpath, name)
            pid = int(m.group(1)) if m.group(1) else None
            stale = (
                (not _pid_alive(pid)
                 or _older_than(full, age_horizon_s, time.time()))
                if pid is not None
                else _older_than(full, 3600.0, time.time())
            )
            if stale:
                try:
                    os.unlink(full)
                    removed.append(full)
                except OSError:
                    pass
            break
    return removed


def _older_than(path: str, age_s: float, now: float) -> bool:
    try:
        return now - os.path.getmtime(path) > age_s
    except OSError:
        return False

"""Crash-safe artifact integrity layer (copy of
``fia_tpu/reliability/artifacts.py``; the same npz and manifest
format, so each package reads what the other publishes).

Every artifact the system persists — training checkpoints, the engine's
inverse-HVP cache, RQ result npz files — is published and restored
through this module. The retry and journal layers make in-process
execution survive faults; this layer extends the same contract to everything on disk, where the failure
modes are kills between write and rename, torn writes on non-atomic
filesystems, bit rot, and manifests left behind by an older generation
of the same file ("Scaling Up Influence Functions", PAPERS.md: production
influence work is dominated by long restartable jobs whose on-disk state
must survive all of these).

The contract:

- **Publish** (:func:`publish_npz`): write to a private temp file in the
  destination directory, ``fsync`` the temp, ``os.replace`` into place,
  ``fsync`` the directory — then publish a sidecar *manifest*
  (``<path>.manifest.json``, same atomic dance) carrying a content
  checksum, the byte size, and an optional config *fingerprint*
  (model key / seed / shapes — the journal fingerprint idiom,
  :mod:`fia_tpu_torch.reliability.journal`). A kill at any point leaves either
  the previous generation intact or the new one complete; the only
  in-between state (new file, old/absent manifest) is detected on read.
- **Verify on read** (:func:`verify` / :func:`load_npz`): the manifest's
  checksum and size are checked against the bytes actually on disk, and
  the fingerprint against the reader's expected one, *before* any array
  is deserialised. Corruption is never an exception the caller has to
  anticipate mid-parse.
- **Quarantine, never delete** (:func:`quarantine`): a file that fails
  verification is renamed to ``<name>.corrupt`` (suffix-incremented,
  collision-safe). Evidence is preserved for post-mortem, the original
  name is freed for a clean rewrite, and a quarantined file is never
  re-read — the read path sees a miss, not a retry loop on poison.

Fault injection: :func:`publish_npz` carries a named injection site
(default ``artifacts.publish``; checkpoint and engine-cache writers pass
their own), and :func:`fia_tpu_torch.reliability.inject.damage` applies
scheduled ``torn`` / ``bitflip`` / ``stale_manifest`` corruption right
after a publish completes — so every fallback rung below (checkpoint
walk-back, cache miss-on-corruption) is exercised deterministically on
CPU.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile

import numpy as np

from fia_tpu_torch import obs
from fia_tpu_torch.reliability import inject, sites
from fia_tpu_torch.reliability.journal import pack

MAGIC = "fia-artifact-v1"
MANIFEST_SUFFIX = ".manifest.json"


class ArtifactIntegrityError(RuntimeError):
    """A persisted artifact failed verification.

    ``reason`` is a stable machine-readable tag:

    - ``missing-file`` — nothing at the path (no quarantine);
    - ``missing-manifest`` — file present but unaccompanied (a kill
      between file and manifest publish, or a foreign writer);
    - ``manifest-unreadable`` / ``bad-magic`` — the manifest itself is
      damaged or not ours;
    - ``size-mismatch`` / ``checksum-mismatch`` — the bytes on disk are
      not the bytes that were published (torn write, bit flip, stale
      manifest from a previous generation);
    - ``fingerprint-mismatch`` — intact file written under a different
      run configuration (NOT corruption: skipped, never quarantined);
    - ``unreadable`` — checksum passed but the payload failed to parse
      (should be unreachable; quarantined defensively).
    """

    def __init__(self, path: str, reason: str, detail: str = ""):
        self.path = path
        self.reason = reason
        self.detail = detail
        super().__init__(
            f"artifact {path}: {reason}" + (f" ({detail})" if detail else "")
        )


def manifest_path(path: str) -> str:
    return path + MANIFEST_SUFFIX


def file_sha256(path: str) -> str:
    """Streaming sha256 of a file's bytes (hex digest)."""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def canonical_fingerprint(fp):
    """Fingerprint in canonical JSON form (the journal idiom: numpy
    arrays/scalars packed, then a JSON round-trip so comparisons are
    representation-independent). None passes through."""
    if fp is None:
        return None
    return json.loads(json.dumps(pack(fp)))


def _write_atomic_json(path: str, obj: dict) -> None:
    d = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".manifest-tmp.", suffix=".json")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(obj, f, sort_keys=True)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    from fia_tpu_torch.utils.io import fsync_dir

    fsync_dir(d)


def publish_npz(
    path: str,
    arrays: dict,
    *,
    fingerprint=None,
    site: str = sites.ARTIFACTS_PUBLISH,
) -> str:
    """Durably publish ``arrays`` as an npz at ``path`` with a manifest.

    fsync'd temp write + atomic rename + directory fsync for the data
    file, then the same for the sidecar manifest. ``site`` names the
    fault-injection point (``inject.damage``) fired after the publish
    completes, so tests corrupt exactly the generation they schedule.
    """
    from fia_tpu_torch.utils import io

    out, sha, size = io.save_npz_atomic(path, **arrays)
    _write_atomic_json(manifest_path(out), {
        "magic": MAGIC,
        "checksum": f"sha256:{sha}",
        "size": size,
        "fingerprint": canonical_fingerprint(fingerprint),
        "keys": sorted(arrays.keys()),
    })
    inject.damage(site, out, manifest_path(out))
    return out


def read_manifest(path: str) -> dict | None:
    """The manifest for ``path``, or None when absent. Raises
    :class:`ArtifactIntegrityError` when present but unreadable or not
    ours (a damaged manifest is as untrustworthy as a damaged file)."""
    mp = manifest_path(path)
    if not os.path.exists(mp):
        return None
    try:
        with open(mp) as f:
            m = json.load(f)
    except (OSError, ValueError) as e:
        raise ArtifactIntegrityError(path, "manifest-unreadable", str(e))
    if not isinstance(m, dict) or m.get("magic") != MAGIC:
        raise ArtifactIntegrityError(path, "bad-magic")
    return m


def verify(
    path: str,
    *,
    expected_fingerprint=None,
    require_manifest: bool = True,
) -> dict | None:
    """Check ``path`` against its manifest; return the manifest.

    Raises :class:`ArtifactIntegrityError` on any mismatch (see the
    reason taxonomy there). With ``require_manifest=False`` a
    manifest-less file passes with ``None`` — the lenient mode for
    artifacts that predate this layer.
    """
    if not os.path.exists(path):
        raise ArtifactIntegrityError(path, "missing-file")
    m = read_manifest(path)
    if m is None:
        if require_manifest:
            raise ArtifactIntegrityError(path, "missing-manifest")
        return None
    size = os.path.getsize(path)
    if int(m.get("size", -1)) != size:
        raise ArtifactIntegrityError(
            path, "size-mismatch", f"manifest {m.get('size')} != disk {size}"
        )
    want = str(m.get("checksum", ""))
    got = f"sha256:{file_sha256(path)}"
    if want != got:
        raise ArtifactIntegrityError(
            path, "checksum-mismatch", f"manifest {want} != disk {got}"
        )
    if expected_fingerprint is not None:
        want_fp = canonical_fingerprint(expected_fingerprint)
        if m.get("fingerprint") != want_fp:
            raise ArtifactIntegrityError(
                path, "fingerprint-mismatch",
                f"manifest {m.get('fingerprint')!r} != expected {want_fp!r}",
            )
    return m


def rewrite_fingerprint(path: str, fingerprint) -> bool:
    """Re-key an intact artifact to a new config fingerprint in place.

    The manifest's checksum covers only the data file's bytes, so an
    entry whose *content* is provably unchanged across a config change
    (e.g. a serve-tier block untouched by a streaming params update) can
    adopt the new fingerprint by republishing just the manifest — no
    recompute, no data rewrite. The data bytes are verified against the
    existing manifest first: a torn or rotted entry is never laundered
    into the new generation (it stays behind under the old fingerprint
    and dies as a verified miss). Returns True when re-keyed, False when
    the entry is missing or fails verification.
    """
    try:
        m = verify(path, require_manifest=True)
    except ArtifactIntegrityError:
        return False
    m = dict(m)
    m["fingerprint"] = canonical_fingerprint(fingerprint)
    _write_atomic_json(manifest_path(path), m)
    return True


def quarantine(path: str, reason: str = "") -> list[str]:
    """Move a failed artifact (and its manifest) aside as evidence.

    Renamed to ``<name>.corrupt`` (``.corrupt.1``, … on collision) —
    never deleted, never re-read; the original name is freed so the
    writer can publish a clean replacement. Returns the new paths.
    """
    moved = []
    for p in (path, manifest_path(path)):
        if not os.path.exists(p):
            continue
        dst = p + ".corrupt"
        n = 0
        while os.path.exists(dst):
            n += 1
            dst = f"{p}.corrupt.{n}"
        os.replace(p, dst)
        moved.append(dst)
    if moved and reason:
        obs.diag(
            "artifacts",
            f"quarantined {path} ({reason}) -> "
            f"{', '.join(os.path.basename(m) for m in moved)}",
        )
    return moved


def load_npz(
    path: str,
    *,
    expected_fingerprint=None,
    require_manifest: bool = False,
    quarantine_on_corrupt: bool = True,
) -> dict:
    """Verified read of a published npz; returns {name: array}.

    Verification failures raise :class:`ArtifactIntegrityError`; the
    corrupt classes (everything except ``missing-file`` and
    ``fingerprint-mismatch`` — an intact file from another config is
    evidence of nothing) are quarantined first, so the caller's retry
    path sees a clean miss rather than re-reading poison.
    """
    try:
        verify(path, expected_fingerprint=expected_fingerprint,
               require_manifest=require_manifest)
    except ArtifactIntegrityError as e:
        if quarantine_on_corrupt and e.reason not in (
            "missing-file", "fingerprint-mismatch"
        ):
            quarantine(path, e.reason)
        raise
    try:
        with np.load(path, allow_pickle=False) as z:
            return {k: z[k] for k in z.files}
    except Exception as e:  # zip/parse damage the checksum cannot see
        if quarantine_on_corrupt:
            quarantine(path, f"unreadable: {e}")
        raise ArtifactIntegrityError(path, "unreadable", str(e))

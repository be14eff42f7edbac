"""Hot-block caching for the serving layer (copy of
``fia_tpu/serve/cache.py``: the same disk-entry names, payload keys and
manifest fingerprints).

Three tiers above the engine's from-scratch device compute:

- :class:`HotBlockCache` — a bounded in-memory LRU over per-(user,
  item) solved blocks (iHVP, test-side vector, unpadded scores). Keys
  fold in the engine's params fingerprint digest and solver name, so a
  retrained/mutated model can never serve a stale entry even if a
  caller forgets to invalidate (api.FIAModel._invalidate also clears
  derived services explicitly — belt and braces).
- the on-disk tier — verified npz entries under
  ``<cache_dir>/serve/``, published and read through the artifact
  integrity layer (:mod:`fia_tpu_torch.reliability.artifacts`): fsync'd
  atomic publish with a checksummed manifest carrying the same
  fingerprint, verify-on-read with quarantine-to-``*.corrupt`` on
  damage — a torn or bit-rotted entry is a clean miss, never poison.
- the factor-bank tier — below both: a miss that reaches the device on
  a ``solver='precomputed'`` engine is answered from the preloaded
  factorized block-inverse bank (one triangular-solve/matvec) when the
  (user, item) pair is banked, falling through the solver ladder
  otherwise. The bank itself is engine state
  (:meth:`~fia_tpu_torch.influence.engine.InfluenceEngine.load_factor_bank`);
  this layer only labels the tier and counts the hits
  (``CacheStats.hits_bank``).

Entry payloads are plain numpy arrays, write-protected before they
enter the hot tier so a consumer mutating a response cannot corrupt
later hits.
"""

from __future__ import annotations

import os
from collections import OrderedDict
from dataclasses import dataclass, field

import numpy as np

from fia_tpu_torch.reliability import sites


@dataclass
class CacheStats:
    hits_hot: int = 0
    hits_disk: int = 0
    hits_bank: int = 0  # factor-bank (precomputed-tier) dispatch hits
    misses: int = 0
    evictions: int = 0
    invalidations: int = 0
    disk_rejects: int = 0  # corrupt/foreign disk entries refused
    # surgical-invalidation accounting (streaming updates): entries
    # re-keyed to a new params fingerprint without recompute vs dropped
    # because the update's footprint touched them
    rekeyed: int = 0
    rekey_dropped: int = 0
    disk_rekeyed: int = 0
    disk_rekey_dropped: int = 0

    def json(self) -> dict:
        return dict(self.__dict__)


@dataclass
class BlockEntry:
    """One solved (user, item) block: everything a Response needs."""

    scores: np.ndarray  # (count,) unpadded related scores
    ihvp: np.ndarray  # (d,)
    test_grad: np.ndarray  # (d,)
    count: int
    extra: dict = field(default_factory=dict)

    def freeze(self) -> "BlockEntry":
        for a in (self.scores, self.ihvp, self.test_grad):
            a.setflags(write=False)
        return self

    @property
    def nbytes(self) -> int:
        return self.scores.nbytes + self.ihvp.nbytes + self.test_grad.nbytes


class HotBlockCache:
    """Bounded LRU over solved blocks, keyed on
    ``(params_fp_digest, solver, user, item)``.

    ``capacity_entries`` bounds the entry count; ``capacity_bytes``
    (optional) additionally bounds the payload footprint — eviction is
    strictly LRU under whichever bound binds first, so the shed set for
    a given access sequence is deterministic.
    """

    def __init__(self, capacity_entries: int = 1024,
                 capacity_bytes: int | None = None):
        self.capacity_entries = max(int(capacity_entries), 0)
        self.capacity_bytes = capacity_bytes
        self.stats = CacheStats()
        self._entries: OrderedDict[tuple, BlockEntry] = OrderedDict()
        self._nbytes = 0

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def nbytes(self) -> int:
        return self._nbytes

    def get(self, key: tuple) -> BlockEntry | None:
        e = self._entries.get(key)
        if e is None:
            self.stats.misses += 1
            return None
        self._entries.move_to_end(key)
        self.stats.hits_hot += 1
        return e

    def peek(self, key: tuple) -> BlockEntry | None:
        """Lookup without touching recency or the hit/miss counters."""
        return self._entries.get(key)

    def put(self, key: tuple, entry: BlockEntry) -> None:
        if self.capacity_entries == 0:
            return
        entry.freeze()
        old = self._entries.pop(key, None)
        if old is not None:
            self._nbytes -= old.nbytes
        self._entries[key] = entry
        self._nbytes += entry.nbytes
        while len(self._entries) > self.capacity_entries or (
            self.capacity_bytes is not None
            and self._nbytes > self.capacity_bytes
            and len(self._entries) > 1
        ):
            _, ev = self._entries.popitem(last=False)
            self._nbytes -= ev.nbytes
            self.stats.evictions += 1

    def invalidate(self) -> None:
        self.stats.invalidations += 1
        self._entries.clear()
        self._nbytes = 0

    def rekey(self, old_fp: str, new_fp: str, touched) -> dict:
        """Surgical re-key after a footprinted params update.

        Entries under ``old_fp`` whose (user, item) block the update's
        footprint did NOT touch adopt ``new_fp`` in place — the update
        provably left their solved block bit-identical, so the cached
        payload is still the answer the new engine would compute.
        Touched entries (and entries under any other fingerprint) are
        dropped. LRU order is preserved. ``touched`` is a
        ``(user, item) -> bool`` predicate
        (:meth:`fia_tpu_torch.stream.footprint.Footprint.touched`).
        """
        out: OrderedDict[tuple, BlockEntry] = OrderedDict()
        nbytes = 0
        rekeyed = dropped = 0
        for key, e in self._entries.items():
            if key[0] == old_fp and not touched(key[2], key[3]):
                out[(new_fp,) + key[1:]] = e
                nbytes += e.nbytes
                rekeyed += 1
            else:
                dropped += 1
        self._entries = out
        self._nbytes = nbytes
        self.stats.rekeyed += rekeyed
        self.stats.rekey_dropped += dropped
        return {"rekeyed": rekeyed, "dropped": dropped}


# -- on-disk tier ----------------------------------------------------------

def disk_entry_path(cache_dir: str, model_name: str, solver: str,
                    user: int, item: int) -> str:
    """Path of one serving-tier disk entry under ``cache_dir``.

    Keyed like the engine's reference-shaped iHVP cache (model name +
    solver in the filename) plus the query pair; the params fingerprint
    lives in the manifest, not the name — a retrain overwrites the
    entry in place rather than accumulating dead generations.
    """
    return os.path.join(
        cache_dir, "serve",
        f"{model_name}-{solver}-u{int(user)}-i{int(item)}.npz",
    )


def disk_fingerprint(model_name: str, solver: str, fp_digest: str) -> dict:
    return {
        "kind": "serve-block",
        "model_key": model_name,
        "solver": solver,
        "params_fp": fp_digest,
    }


def disk_get(path: str, fingerprint: dict,
             stats: CacheStats | None = None) -> BlockEntry | None:
    """Verified read of a disk-tier entry; any integrity or fingerprint
    failure is a miss (corrupt classes are quarantined by load_npz)."""
    from fia_tpu_torch.reliability import artifacts

    if not os.path.exists(path):
        return None
    try:
        d = artifacts.load_npz(
            path, expected_fingerprint=fingerprint, require_manifest=True
        )
    except artifacts.ArtifactIntegrityError:
        if stats is not None:
            stats.disk_rejects += 1
        return None
    try:
        # certificate provenance (certified-approximate entries — an
        # engine on the 'sampled' rung): round-trip the stamped bound
        # so a disk hit cannot launder an approximate block into an
        # exact-looking response
        extra = {}
        if "err_bound" in d and bool(np.asarray(d.get("approx", 0))):
            extra = {"approx": True, "err_bound": float(d["err_bound"])}
        return BlockEntry(
            scores=np.asarray(d["scores"]),
            ihvp=np.asarray(d["ihvp"]),
            test_grad=np.asarray(d["test_grad"]),
            count=int(d["count"]),
            extra=extra,
        ).freeze()
    except KeyError:
        if stats is not None:
            stats.disk_rejects += 1
        return None


def disk_rekey(cache_dir: str, model_name: str, solver: str,
               old_fp: str, new_fp: str, touched,
               stats: CacheStats | None = None) -> dict:
    """Surgical re-key of the on-disk serve tier (streaming updates).

    Walks ``<cache_dir>/serve/`` entries of this (model, solver):
    touched blocks are unlinked (their payload is stale under the new
    params); untouched blocks — whose manifest fingerprint matches the
    OLD params digest and whose bytes verify — adopt the new fingerprint
    via a manifest-only rewrite
    (:func:`fia_tpu_torch.reliability.artifacts.rewrite_fingerprint`): no
    recompute, no data rewrite, and a torn/foreign entry is skipped, so
    nothing stale is ever laundered into the new generation.
    """
    import re

    from fia_tpu_torch.reliability import artifacts

    d = os.path.join(cache_dir, "serve")
    out = {"rekeyed": 0, "dropped": 0}
    if not os.path.isdir(d):
        return out
    pat = re.compile(
        re.escape(f"{model_name}-{solver}-") + r"u(\d+)-i(\d+)\.npz"
    )
    old_want = artifacts.canonical_fingerprint(
        disk_fingerprint(model_name, solver, old_fp)
    )
    new_fingerprint = disk_fingerprint(model_name, solver, new_fp)
    for fn in sorted(os.listdir(d)):
        m = pat.fullmatch(fn)
        if m is None:
            continue
        path = os.path.join(d, fn)
        if touched(int(m.group(1)), int(m.group(2))):
            for p in (path, artifacts.manifest_path(path)):
                try:
                    os.unlink(p)
                except OSError:
                    pass
            out["dropped"] += 1
            continue
        try:
            man = artifacts.read_manifest(path)
        except artifacts.ArtifactIntegrityError:
            continue  # damaged manifest: leave for the read path's miss
        if man is None or man.get("fingerprint") != old_want:
            continue  # foreign/older generation: unservable either way
        if artifacts.rewrite_fingerprint(path, new_fingerprint):
            out["rekeyed"] += 1
    if stats is not None:
        stats.disk_rekeyed += out["rekeyed"]
        stats.disk_rekey_dropped += out["dropped"]
    return out


def disk_put(path: str, entry: BlockEntry, fingerprint: dict) -> None:
    """Publish a disk-tier entry through the integrity layer.

    ``serve.cache_publish`` is the fault-injection site: the damage
    channel corrupts exactly this generation after the (honest) atomic
    publish, so tests exercise the read-side verification above.
    """
    from fia_tpu_torch.reliability import artifacts

    payload = dict(
        scores=np.asarray(entry.scores),
        ihvp=np.asarray(entry.ihvp),
        test_grad=np.asarray(entry.test_grad),
        count=np.asarray(entry.count, np.int64),
    )
    if entry.extra.get("approx"):
        payload["approx"] = np.asarray(1, np.int64)
        payload["err_bound"] = np.asarray(
            entry.extra["err_bound"], np.float64
        )
    artifacts.publish_npz(
        path,
        payload,
        fingerprint=fingerprint,
        site=sites.SERVE_CACHE_PUBLISH,
    )

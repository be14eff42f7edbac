"""Host-sharded miss dispatch (port of ``fia_tpu/serve/hostshard.py``;
docs/design.md §25): the same names, shard partition, journal layout,
fingerprint keys and ``HostLost`` message.

One drain's coalesced dispatch order is embarrassingly parallel across
hosts: the query axis has no cross-query coupling (docs/design.md §14),
so each host computes a contiguous row-slice of it with no hot-path
collective — no all-gather of results, no barrier per batch, nothing
for a dead peer to stall. Hosts coordinate through durable journals
instead: each publishes its shard through the artifact integrity layer
(:func:`fia_tpu_torch.reliability.artifacts.publish_npz` — fsync'd
atomic rename, checksummed manifest, fingerprint), and every host merges
the journals in host order. Three properties follow:

- **Byte identity.** Shards are contiguous, batch-aligned slices of the
  single-process dispatch order, each computed by the same engine
  program (``query_many``: the flat direct program, one captured graph a
  geometry on the card), so the host-order concatenation is bitwise one
  process running the whole order.
- **Restart resumption.** A shard journal that already exists and
  verifies (checksum + fingerprint over the engine state, the drain tag
  and the exact query bytes) is NOT recomputed — a restarted host picks
  up where the journals left off.
- **Classified host loss.** A peer whose journal never appears inside
  the merge budget is a ``host_lost`` failure
  (:class:`~fia_tpu_torch.reliability.taxonomy.HostLost`), not a hang:
  the wait loop runs on the injectable reliability clock
  (:data:`fia_tpu_torch.reliability.policy.WALL`), times out, and the
  service adopts or sheds exactly the missing hosts' rows.

Difference from the reference: its merge quarantines a journal that has
no manifest yet, which is what a peer's journal looks like between the
rename of its data file and that of its manifest; a host polling while
its peer publishes then moves the peer's good shard aside and, after the
merge budget, recomputes it as a lost host's. The port's merge polls
such a journal again (``_NOT_YET``) and quarantines only a journal that
fails its checksum, size or format.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np

from fia_tpu_torch import obs
from fia_tpu_torch.reliability import artifacts, policy as rpolicy, taxonomy

# verification failures of a peer's journal that mean "not (yet) there",
# never quarantined by the merge: no file, a publish between its data
# file's rename and its manifest's, a journal of another drain or state
_NOT_YET = ("missing-file", "missing-manifest", "fingerprint-mismatch")


def shard_rows(n: int, nhosts: int, align: int = 1) -> list[tuple[int, int]]:
    """Contiguous ``[start, stop)`` row ranges per host.

    An even split with the remainder spread over the first hosts —
    pure arithmetic on (n, nhosts, align), so every host computes the
    same partition without talking to anyone. Hosts past the work get
    empty ranges (they still journal, so the merge never waits on a
    host with no work).

    ``align`` (the dispatcher's ``max_batch``) keeps every shard
    boundary on a batch boundary of the single-process dispatch order:
    each batch's compile pad derives from the max related-count IN that
    batch, so splitting a batch across hosts would change batch
    composition — and with it the pad geometry — versus the
    single-process run the byte-identity contract is pinned against.
    Whole batches are the unit of distribution; rows only denominate
    the ranges.
    """
    n, nhosts, align = int(n), int(nhosts), max(int(align), 1)
    if nhosts < 1:
        raise ValueError(f"nhosts must be >= 1, got {nhosts}")
    units = (n + align - 1) // align
    base, rem = divmod(units, nhosts)
    out = []
    start_u = 0
    for h in range(nhosts):
        size_u = base + (1 if h < rem else 0)
        stop_u = start_u + size_u
        out.append((min(start_u * align, n), min(stop_u * align, n)))
        start_u = stop_u
    return out


def shard_path(journal_dir: str, tag: str, host: int, nhosts: int) -> str:
    """The journal file one host's shard publishes to."""
    return os.path.join(
        str(journal_dir), f"shard-{tag}-{int(host)}of{int(nhosts)}.npz"
    )


def shard_fingerprint(engine_fp: str, tag: str, host: int, nhosts: int,
                      points: np.ndarray):
    """The manifest fingerprint a shard journal is keyed under.

    Binds the journal to the engine state (params fingerprint), the
    drain tag, the shard geometry AND the exact query bytes — a journal
    from another drain, another model generation, or a reordered query
    stream is a verified miss, never silently merged.
    """
    pts = np.ascontiguousarray(np.asarray(points, np.int64))
    return {
        "engine_fp": str(engine_fp),
        "tag": str(tag),
        "host": int(host),
        "nhosts": int(nhosts),
        "points_sha1": hashlib.sha1(pts.tobytes()).hexdigest(),
    }


def _pack_result(results) -> dict:
    """Per-batch InfluenceResults as flat journal arrays.

    ``results`` is ``query_many``'s return — one InfluenceResult per
    consecutive batch of the shard's rows. The packed form is
    ragged-safe and byte-exact: per-row score slices concatenate into
    one flat array with explicit counts (offsets are re-derived as the
    cumulative sum on load), and the uniform-shape ihvp/test_grad
    blocks ride as-is.
    """
    if not results:
        return {
            "scores": np.zeros((0,), np.float64),
            "counts": np.zeros((0,), np.int64),
            "ihvp": np.zeros((0, 0), np.float64),
            "test_grad": np.zeros((0, 0), np.float64),
        }
    counts, scores = [], []
    for res in results:
        n = len(res.counts)
        counts.extend(int(res.counts[r]) for r in range(n))
        scores.extend(np.asarray(res.scores_of(r)).reshape(-1)
                      for r in range(n))
    counts = np.asarray(counts, np.int64)
    return {
        "scores": (np.concatenate(scores) if counts.sum()
                   else np.zeros((0,), np.float64)),
        "counts": counts,
        "ihvp": np.concatenate(
            [np.asarray(res.ihvp) for res in results]),
        "test_grad": np.concatenate(
            [np.asarray(res.test_grad) for res in results]),
    }


def dispatch_local_shard(
    eng,
    points: np.ndarray,
    *,
    host: int,
    nhosts: int,
    journal_dir: str,
    tag: str,
    engine_fp: str,
    max_batch: int | None = None,
) -> str:
    """Compute and journal THIS host's shard of one dispatch order.

    ``points`` is the FULL coalesced (T, 2) dispatch order — every host
    receives the same array and derives its own contiguous slice from
    :func:`shard_rows`, so there is no work-assignment round trip. The
    slice runs through the engine's own dispatch (``query_many``: on the
    flat path the direct program, whose score and Hessian stages are the
    hand kernels on the card), then publishes through the artifact layer
    under :func:`shard_fingerprint`. If a verified journal for exactly this
    (engine state, tag, geometry, query bytes) already exists, the
    compute is skipped entirely — the resume path after a host restart.

    Returns the journal path.
    """
    points = np.asarray(points, np.int64)
    start, stop = shard_rows(
        len(points), nhosts, align=max_batch or len(points) or 1
    )[int(host)]
    path = shard_path(journal_dir, tag, host, nhosts)
    fp = shard_fingerprint(engine_fp, tag, host, nhosts, points)
    try:
        artifacts.verify(path, expected_fingerprint=fp)
        obs.diag(
            "hostshard",
            f"host {host}/{nhosts}: shard journal {os.path.basename(path)}"
            " verified, resuming without recompute",
        )
        return path
    except artifacts.ArtifactIntegrityError:
        pass
    with obs.span("serve.hostshard_dispatch", host=int(host),
                  nhosts=int(nhosts), rows=int(stop - start)):
        results = []
        if stop > start:
            results = eng.query_many(
                points[start:stop],
                batch_queries=max_batch or len(points),
            )
        arrays = _pack_result(results)
    os.makedirs(str(journal_dir), exist_ok=True)
    return artifacts.publish_npz(path, arrays, fingerprint=fp)


def merge_host_shards(
    journal_dir: str,
    tag: str,
    nhosts: int,
    points: np.ndarray,
    *,
    engine_fp: str,
    max_batch: int | None = None,
    timeout_s: float = 60.0,
    poll_s: float = 0.05,
    clock: rpolicy.Clock = rpolicy.WALL,
) -> dict:
    """Merge every host's shard journal back into dispatch order.

    Pure journal reads — a host needs no live connection to any peer,
    which is exactly why a restart resumes from here. Each shard is a
    verified load under the same fingerprint the publisher used; shards
    not yet on disk are polled for on the injectable reliability clock
    until ``timeout_s``, after which the missing hosts are a *proved*
    loss and :class:`taxonomy.HostLost` raises with their indices (the
    service adopts those shards, or sheds their rows classified
    ``host_lost``).

    Returns ``{"scores", "counts", "offsets", "ihvp", "test_grad"}``
    over the full ``points`` order — shards are contiguous slices, so
    host-order concatenation IS the single-process order, byte for
    byte.
    """
    points = np.asarray(points, np.int64)
    ranges = shard_rows(
        len(points), nhosts, align=max_batch or len(points) or 1
    )
    shards: dict[int, dict] = {}
    deadline = clock.monotonic() + float(timeout_s)
    pending = list(range(int(nhosts)))
    while pending:
        still = []
        for h in pending:
            path = shard_path(journal_dir, tag, h, nhosts)
            fp = shard_fingerprint(engine_fp, tag, h, nhosts, points)
            try:
                shards[h] = artifacts.load_npz(
                    path, expected_fingerprint=fp, require_manifest=True,
                    quarantine_on_corrupt=False,
                )
            except artifacts.ArtifactIntegrityError as e:
                # a journal whose manifest has not landed is still being
                # published (the data file is renamed in first): poll it
                # again; anything else corrupt goes aside as evidence
                if e.reason not in _NOT_YET:
                    artifacts.quarantine(path, e.reason)
                still.append(h)
        pending = still
        if not pending:
            break
        if clock.monotonic() >= deadline:
            raise taxonomy.HostLost(
                f"shard journal(s) from host(s) {pending} never "
                f"appeared within {timeout_s}s (tag {tag!r}, "
                f"{nhosts} hosts); those hosts are presumed lost"
            )
        clock.sleep(float(poll_s))
    counts = np.concatenate([
        np.asarray(shards[h]["counts"], np.int64) for h in range(nhosts)
    ]) if nhosts else np.zeros((0,), np.int64)
    scores = np.concatenate([
        np.asarray(shards[h]["scores"]).reshape(-1) for h in range(nhosts)
    ]) if nhosts else np.zeros((0,))
    blocks = [h for h in range(nhosts)
              if ranges[h][1] > ranges[h][0]]
    ihvp = (np.concatenate([shards[h]["ihvp"] for h in blocks])
            if blocks else np.zeros((0, 0)))
    test_grad = (np.concatenate([shards[h]["test_grad"] for h in blocks])
                 if blocks else np.zeros((0, 0)))
    offsets = np.zeros(len(counts) + 1, np.int64)
    np.cumsum(counts, out=offsets[1:])
    return {
        "scores": scores,
        "counts": counts,
        "offsets": offsets,
        "ihvp": ihvp,
        "test_grad": test_grad,
    }

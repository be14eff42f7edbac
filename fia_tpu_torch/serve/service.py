"""``InfluenceService`` — the online influence-query event loop (port of
``fia_tpu/serve/service.py``: the same loop, names, batch ids, response
fields and JSONL lines).

One synchronous, deterministic loop (no threads: determinism is a
feature the reliability tests pin, and the engine's device dispatch is
already async under the hood):

1. :meth:`submit` runs admission (queue bound, id validation, deadline
   stamping) and enqueues a ticket or returns an immediate rejection.
2. :meth:`drain` resolves every queued ticket: expired deadlines are
   rejected; hot-cache and verified disk-tier hits answer without
   device work; the misses are de-duplicated, micro-batched by the
   scheduler, and dispatched — one compiled mega-batch program per
   batch instead of one per query. On the single-device flat path up
   to ``dispatch_window`` programs stay in flight (dispatch of batch
   N+1 overlaps result assembly of batch N — docs/design.md §14);
   everywhere else batches go through ``engine.query_batch``
   sequentially. Results fill both cache tiers, then every ticket
   resolves from the hot tier (a key repeated within one drain
   computes once and hits for the rest).
3. A classified device/deadline failure during a batch dispatch rejects
   exactly that batch's requests with the taxonomy kind as the reason
   and the loop continues — overload and faults shed load
   deterministically; unclassified failures surface.

Byte-identity contract: for a given drain, the dispatch stream is the
scheduler's coalesced order and batches are consecutive ``max_batch``
chunks of it, so the admitted results are bit-identical to
``engine.query_many(points[order], batch_queries=max_batch)`` —
serving must not change answers (tests/test_serve.py pins this).

Brownout (serve/health.py): in ``bank_preferred`` mode, misses the
factor bank cannot answer serve a *certified approximate* answer from
the engine's cache-less ``sampled`` sibling — ``approx=True`` plus a
stamped error bound on the response (docs/design.md §22) — instead of
shedding ``degraded``; ``cache_only`` remains the shed-everything
floor. See :meth:`InfluenceService._dispatch_approx` for the isolation
rules that keep the exact path byte-identical to an approx-off run.

Differences from the reference:

- The reference's ``_wide_block_cap`` term (it caps wide-block flat
  dispatches at 32 queries to dodge a fault of its TPU worker) is not
  carried over: :meth:`InfluenceService._overlap_eligible` and
  :meth:`~InfluenceService.warmup` drop it, as the port's
  ``InfluenceEngine.query_many`` does.
- A mesh that spans processes is one the processes joined over gloo
  (``parallel.distributed``), not one runtime: every process runs the
  same service over the same request stream, and each dispatch
  all-gathers its shards' host results in slot order (``fill_shards``),
  so the answers are the one-process mesh's bits.
- The host roles' journal merge (:mod:`fia_tpu_torch.serve.hostshard`)
  polls a peer's journal whose manifest has not landed yet instead of
  quarantining it (see that module).
- :meth:`~InfluenceService.warmup` reads the port's build records, the
  engine's :meth:`compiled_geometries` and the program builds counted by
  :mod:`fia_tpu_torch.utils.compilemon` (CUDA graph captures on the
  card), where the reference reads its jit and AOT caches.
- A classified worker death or preemption inside the windowed loop
  rebuilds the engine's device state (``_reset_device_state``) before
  the surviving batches re-dispatch, as the port's ``query_many`` does:
  no handle dispatched before the reset is fetched after it.
"""

from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass

import numpy as np

from fia_tpu_torch import obs
from fia_tpu_torch.reliability import inject, sites, taxonomy
from fia_tpu_torch.reliability import policy as rpolicy
from fia_tpu_torch.serve.admission import (
    REASON_DEADLINE,
    REASON_DEGRADED,
    AdmissionController,
)
from fia_tpu_torch.serve import cache as scache
from fia_tpu_torch.serve import hostshard
from fia_tpu_torch.serve.cache import BlockEntry, HotBlockCache
from fia_tpu_torch.serve.health import (
    MODE_FULL,
    HealthConfig,
    HealthController,
)
from fia_tpu_torch.serve.metrics import ServeMetrics
from fia_tpu_torch.serve.request import (
    CLASSES,
    STATUS_REJECTED,
    TIER_COMPUTE,
    TIER_DISK,
    TIER_HOT,
    TIER_PRECOMPUTED,
    Request,
    Response,
    Ticket,
)
from fia_tpu_torch.serve.scheduler import FairScheduler, MicroBatcher
from fia_tpu_torch.utils import compilemon

# Failure kinds whose recovery is a topology shrink (rebuild the mesh
# over survivors) rather than a same-topology retry ladder: device loss
# drops one device, host loss drops every device behind a dead process.
# The dispatch paths treat them identically up to which shrink runs —
# see _recover_topology (meshless here: no shrink, the batch sheds).
_TOPOLOGY_KINDS = (taxonomy.DEVICE_LOST, taxonomy.HOST_LOST)
# Failure kinds that kill every dispatch in flight: the windowed loop
# rebuilds the device state before the survivors re-dispatch.
_RESET_KINDS = (taxonomy.WORKER, taxonomy.PREEMPTION)


@dataclass
class ServeConfig:
    """Service knobs (see module docstrings for the semantics)."""

    # Mega-batch coalescing cap: the default packs as many queued
    # queries as fit into one fused dispatch (one captured graph a
    # geometry amortises the host's share of a dispatch over the batch);
    # latency-sensitive deployments dial it back down.
    max_batch: int = 1024
    max_queue: int = 4096  # admission: tickets allowed to wait
    coalesce: str = "bucket"  # "bucket" | "fifo" dispatch order
    default_deadline_s: float | None = None  # per-request budget
    cache_entries: int = 1024  # hot-block LRU capacity
    cache_bytes: int | None = None  # optional hot-tier byte bound
    disk_cache: bool = True  # use cache_dir tier when engine has one
    include_related: bool = True  # attach related train-row ids
    metrics_path: str | None = None  # JSONL events (None = in-memory)
    # Overlapped dispatch: up to this many flat programs in flight per
    # drain, so host-side result assembly of batch N overlaps device
    # execution of batch N+1 (engine dispatch is async). 1 = the
    # sequential guarded path; >1 applies wherever the engine's flat
    # path is eligible.
    dispatch_window: int = 2
    # Serve over a device mesh: an int (shard the flat dispatch over the
    # first N devices' 'data' axis; <= 1 means no mesh) or a
    # parallel.mesh.Mesh (validated at construction against the
    # engine's); from_model builds its engines over it.
    mesh: object | None = None
    # Factor-bank tier: warmup() preloads the engine's published bank
    # device-resident (solver='precomputed' engines only; a no-op
    # elsewhere) so the first hot-set request never pays the load.
    # False skips the preload — the engine still loads lazily on its
    # first precomputed dispatch.
    factor_bank: bool = True
    # Brownout-ladder thresholds (serve/health.py); None = defaults.
    health: HealthConfig | None = None
    # Multi-tenant knobs (docs/reliability.md "Multi-tenant serving &
    # fairness"). class_quotas: per-class queue quota fractions merged
    # over admission.DEFAULT_CLASS_QUOTAS; class_weights: DRR weights
    # merged over scheduler.CLASS_WEIGHTS. None = defaults (unclassed
    # streams behave exactly as before the multi-tenant layer).
    class_quotas: dict | None = None
    class_weights: dict | None = None
    # Per-tenant admission quotas (fractions of max_queue), applied
    # UNDER the class quotas: {"acme": 0.25} bounds tenant "acme" to a
    # quarter of the queue regardless of class mix. Unlisted tenants
    # and unlabelled requests are uncapped (opt-in per tenant).
    tenant_quotas: dict | None = None
    # Deadline-aware packing: a queued request whose remaining budget
    # is at or under this slack promotes its batch to the front of a
    # multi-class plan. None disables the promotion (single-class
    # plans are never reordered — that order is the pinned contract).
    # When class_deadlines is active and this is None, the slack is
    # derived from the tightest class SLO (see class_deadlines).
    deadline_slack_s: float | None = None
    # SLO-derived per-class deadline defaults. True adopts
    # request.CLASS_SLOS verbatim; a dict merges over it (values in
    # seconds); None/False disables (requests without deadlines keep
    # default_deadline_s, the pre-SLO behaviour). When active, a
    # request carrying no deadline of its own is stamped its class's
    # SLO at admission, and deadline_slack_s (if unset) defaults to a
    # quarter of the tightest configured SLO — the dispatcher's
    # "about to miss" horizon tracks the strictest promise made.
    class_deadlines: dict | bool | None = None
    # Host-sharded dispatch (docs/design.md §25): a (host, n_hosts,
    # journal_dir) triple naming this process's shard of the pod's
    # miss-dispatch work. Each host computes a contiguous, batch-aligned
    # row-slice of every drain's coalesced dispatch order, journals it
    # durably (reliability/artifacts.py), and every host merges the
    # shard journals — no hot-path collective, and a restarted host
    # resumes from the journals instead of recomputing. None =
    # single-host dispatch (every prior behaviour unchanged).
    host_role: tuple | None = None
    # Merge budget for peer shard journals (seconds): a peer whose
    # journal never appears within this window is a *proved* host loss
    # (classified ``host_lost``), and the survivors adopt its shard.
    host_merge_timeout_s: float = 60.0


class _MergedRows:
    """Rows ``[base, base + n)`` of a merged host-shard result,
    presented through the InfluenceResult row accessors
    ``_bank_batch`` consumes (``scores_of`` / ``counts`` / ``ihvp`` /
    ``test_grad``)."""

    def __init__(self, merged: dict, base: int, n: int):
        self._scores = merged["scores"]
        self._offsets = merged["offsets"]
        self._base = int(base)
        self.counts = merged["counts"][base:base + n]
        self.ihvp = merged["ihvp"][base:base + n]
        self.test_grad = merged["test_grad"][base:base + n]

    def scores_of(self, row: int):
        r = self._base + int(row)
        return self._scores[self._offsets[r]:self._offsets[r + 1]]


def _resolve_mesh(mesh, device=None):
    """ServeConfig.mesh → a Mesh (int = the first N slots' 'data' mesh
    on ``device``'s kind, <= 1 or None = no mesh)."""
    if mesh is None:
        return None
    if isinstance(mesh, int):
        if mesh <= 1:
            return None
        from fia_tpu_torch.parallel.mesh import make_mesh

        return make_mesh(mesh, device=device)
    return mesh


def _approx_extra(res, row: int) -> dict:
    """BlockEntry.extra for one result row: the certificate provenance
    ({'approx': True, 'err_bound': f} from a sampled-rung result, {}
    from an exact one) — cached alongside the payload so later hot/disk
    hits re-stamp the same bound instead of laundering the answer into
    an exact-looking response."""
    if not getattr(res, "approx", False) or res.err_bound is None:
        return {}
    return {"approx": True, "err_bound": float(res.err_bound[row])}


class InfluenceService:
    """Serve a stream of (user, item) influence queries over one engine.

    Args:
      engine: an :class:`~fia_tpu_torch.influence.engine.InfluenceEngine`
        (fixed-engine mode), or
      engine_provider: a zero-arg callable returning the current engine
        — the :meth:`from_model` path, so a retrained
        :class:`~fia_tpu_torch.api.FIAModel` transparently swaps a fresh
        engine in and the fingerprinted cache keys retire stale entries.
      config: a :class:`ServeConfig`.
      clock: monotonic-seconds callable, or a
        :class:`fia_tpu_torch.reliability.policy.Clock` object (its
        ``monotonic`` method is used) — injectable for deterministic
        tests, simulated open-loop load, and virtual-time chaos runs.

    The engine's device is the service's: an engine built with the
    default device runs on the card (and raises without one).
    """

    def __init__(self, engine=None, engine_provider=None,
                 config: ServeConfig | None = None,
                 clock=time.monotonic):
        if (engine is None) == (engine_provider is None):
            raise ValueError("pass exactly one of engine/engine_provider")
        self._engine_static = engine
        self._engine_provider = engine_provider
        self.config = config or ServeConfig()
        # a policy.Clock (e.g. VirtualClock) normalises to its reader
        self.clock = getattr(clock, "monotonic", clock)
        # keep the full Clock object (monotonic + sleep) when one was
        # passed: the host-shard merge SPENDS time waiting on peers'
        # journals, and virtual-time tests need that wait to be virtual
        self._clock_obj = clock if hasattr(clock, "monotonic") else None
        self.cache = HotBlockCache(self.config.cache_entries,
                                   self.config.cache_bytes)
        self.metrics = ServeMetrics(self.config.metrics_path)
        self.batcher = MicroBatcher(
            self.config.max_batch, self.config.coalesce,
            pad_bucket=int(getattr(self._peek_engine(), "pad_bucket", 128)),
        )
        # fair-queueing over per-class lanes; single-class streams pass
        # through to the wrapped batcher verbatim (byte identity)
        self.scheduler = FairScheduler(self.batcher,
                                       self.config.class_weights)
        eng = self._peek_engine()
        self.mesh = _resolve_mesh(self.config.mesh,
                                  getattr(eng, "device", None))
        if self.mesh is not None:
            self._check_mesh(eng)
        self.health = HealthController(self.config.health)
        # SLO-derived deadline defaults: resolve the class_deadlines
        # knob (True = the published CLASS_SLOS; dict = overrides
        # merged over them), and derive the urgent-lane slack from the
        # tightest SLO when the operator did not pin one explicitly.
        cds = self.config.class_deadlines
        if cds:
            from fia_tpu_torch.serve.request import CLASS_SLOS

            resolved = dict(CLASS_SLOS)
            if isinstance(cds, dict):
                resolved.update({k: float(v) for k, v in cds.items()})
            self.class_deadlines = resolved
        else:
            self.class_deadlines = None
        self.deadline_slack_s = self.config.deadline_slack_s
        if self.deadline_slack_s is None and self.class_deadlines:
            self.deadline_slack_s = 0.25 * min(
                self.class_deadlines.values()
            )
        # Host-sharded dispatch role: (host, n_hosts, journal_dir)
        self.host_role = None
        if self.config.host_role is not None:
            h, n, jdir = self.config.host_role
            h, n = int(h), int(n)
            if not 0 <= h < n:
                raise ValueError(
                    f"host_role host index {h} out of range for "
                    f"{n} host(s)")
            self.host_role = (h, n, str(jdir))
        self.admission = AdmissionController(
            max_queue=self.config.max_queue,
            default_deadline_s=self.config.default_deadline_s,
            num_users=eng.model.num_users,
            num_items=eng.model.num_items,
            class_quotas=self.config.class_quotas,
            tenant_quotas=self.config.tenant_quotas,
            class_deadlines=self.class_deadlines,
        )
        self._queue: list[Ticket] = []
        # queued tickets per class / per tenant (admission quota
        # signals) — rebuilt to empty when a drain swaps the queue out
        self._class_depth: dict[str, int] = {}
        self._tenant_depth: dict[str, int] = {}
        self._next_id = 0
        self._batch_id = 0
        self._fp_cache: tuple | None = None  # (engine identity, digest)
        # Epoch fence (docs/design.md §17): tickets are stamped with the
        # serving epoch at admission; a streaming update pins the old
        # (engine, fp) here before swapping, so a drain resolves each
        # ticket against the state it was admitted under. Entries are
        # cleared once the queue that referenced them is consumed.
        self._epoch = 0
        self._fenced: dict[int, tuple] = {}  # epoch -> (engine, fp)
        # dispatch log: (batch_id, (T, 2) points) per device dispatch —
        # the byte-identity tests and capacity post-mortems read this
        self.dispatch_log: list[tuple[int, np.ndarray]] = []
        # per-drain health signals (classified failures / dispatches)
        self._drain_errors = 0
        self._drain_dispatches = 0
        # drain counter: seeds the per-drain trace id (obs/trace.py) —
        # deterministic across runs of the same request stream
        self._drain_seq = 0

    def _check_mesh(self, eng) -> None:
        """The construction-time checks of a configured mesh. Liveness
        first: a mesh naming dead slots fails with a CLASSIFIED error
        (the operator restarted onto a shrunk slice), not at the first
        dispatch; the error names the dead slot ids (and whole hosts when
        every slot behind one is dark) and carries them as ``devices`` /
        ``hosts``. Then the engine must be built over the same mesh."""
        from fia_tpu_torch.parallel.mesh import (
            lost_device_ids,
            lost_host_ids,
            mesh_fingerprint,
            mesh_hosts,
        )

        dead = lost_device_ids(self.mesh)
        if dead:
            dead_hosts = (lost_host_ids(self.mesh)
                          if len(mesh_hosts(self.mesh)) > 1 else ())
            host_note = (f" (host(s) {list(dead_hosts)} lost entirely)"
                         if dead_hosts else "")
            err = taxonomy.HostLost if dead_hosts else taxonomy.DeviceLost
            e = err(
                f"ServeConfig.mesh references device id(s) {list(dead)} "
                f"the backend cannot see{host_note}; rebuild the mesh over "
                "live devices (parallel.mesh.make_mesh / surviving_mesh) "
                "before constructing the service")
            e.devices = list(dead)
            e.hosts = list(dead_hosts)
            raise e
        if mesh_fingerprint(getattr(eng, "mesh", None)) != \
                mesh_fingerprint(self.mesh):
            raise ValueError(
                "ServeConfig.mesh does not match the engine's mesh; build "
                "the engine over the same mesh (InfluenceEngine(mesh=...) "
                "/ cli mesh_for) or use from_model, which builds its "
                "engines over it")

    # -- wiring ------------------------------------------------------------
    @classmethod
    def from_model(cls, model, config: ServeConfig | None = None,
                   solver: str | None = None, clock=time.monotonic,
                   **engine_extra) -> "InfluenceService":
        """A service over an :class:`~fia_tpu_torch.api.FIAModel`.

        The engine is resolved lazily through ``model.engine()`` (the
        one solver-resolution path), so ``model.retrain`` /
        ``update_train_x_y`` — which clear the model's engines and
        notify derived services — leave the service answering from
        fresh state, never a stale hot block. A ``config.mesh`` is
        resolved once here and handed to every engine the model builds.
        """
        m = _resolve_mesh((config or ServeConfig()).mesh, model.device)
        if m is not None:
            engine_extra.setdefault("mesh", m)
        svc = cls(
            engine_provider=lambda: model.engine(solver, **engine_extra),
            config=config, clock=clock,
        )
        model._register_serving(svc)
        return svc

    def _peek_engine(self):
        return (self._engine_static if self._engine_static is not None
                else self._engine_provider())

    def _engine_and_fp(self):
        eng = self._peek_engine()
        if self._fp_cache is not None and self._fp_cache[0] is eng:
            return eng, self._fp_cache[1]
        fp = hashlib.sha1(
            np.ascontiguousarray(eng._params_fingerprint()).tobytes()
        ).hexdigest()
        self._fp_cache = (eng, fp)
        return eng, fp

    def invalidate(self) -> None:
        """Drop every serving-layer cache derived from model state.

        Called by ``FIAModel._invalidate()`` (retrain, checkpoint load,
        train-set mutation). The fingerprinted keys already make stale
        hits impossible; this additionally frees the dead entries and
        forgets the memoized engine fingerprint. Fenced epochs are
        dropped too — wholesale invalidation means queued tickets
        resolve against the fresh state, exactly as before streaming
        updates existed.
        """
        self.cache.invalidate()
        self._fp_cache = None
        self._fenced.clear()

    # -- epoch-fenced streaming swap (docs/design.md §17) ------------------
    @property
    def epoch(self) -> int:
        return self._epoch

    def pin_epoch(self) -> None:
        """Fence the current (engine, fingerprint) under the serving
        epoch — called by the streaming update loop *before* the model
        mutates, so tickets admitted under this epoch keep resolving
        against exactly this state. Harmless if the update later rolls
        back (the fence is cleared at the next drain)."""
        self._fenced[self._epoch] = self._engine_and_fp()

    def advance_epoch(self, footprint=None) -> dict:
        """Swap serving onto the model's new state, surgically.

        Bumps the serving epoch (new admissions stamp the new one),
        resolves the NEW engine and fingerprint — making the new state
        resident *before* any old entry is dropped — then, given a
        ``footprint`` (:class:`fia_tpu_torch.stream.footprint.Footprint` or a
        ``(user, item) -> bool`` predicate), re-keys every untouched
        hot/disk entry to the new fingerprint in place and drops exactly
        the touched blocks. Without a footprint the hot tier is
        wholesale-invalidated (the epoch fence still holds for queued
        tickets). Returns the swap accounting, also logged as a
        ``stream.swap`` metrics event.
        """
        old = self._fenced.get(self._epoch) or self._fp_cache
        if old is not None:
            self._fenced[self._epoch] = old
        self._epoch += 1
        self._fp_cache = None
        eng, new_fp = self._engine_and_fp()  # new state resident now
        out = {"epoch": self._epoch, "wholesale": footprint is None,
               "hot_rekeyed": 0, "hot_dropped": 0,
               "disk_rekeyed": 0, "disk_dropped": 0}
        touched = getattr(footprint, "touched", footprint)
        with obs.span("stream.rekey",
                      trace_seed=f"epoch-{self._epoch}") as sp:
            if touched is None:
                if old is not None:
                    self.cache.invalidate()
            elif old is not None and old[1] != new_fp:
                hot = self.cache.rekey(old[1], new_fp, touched)
                out["hot_rekeyed"] = hot["rekeyed"]
                out["hot_dropped"] = hot["dropped"]
                d = self._disk_dir(eng)
                if d is not None:
                    disk = scache.disk_rekey(
                        d, eng.model_name, eng.solver, old[1], new_fp,
                        touched, stats=self.cache.stats,
                    )
                    out["disk_rekeyed"] = disk["rekeyed"]
                    out["disk_dropped"] = disk["dropped"]
            sp.set(**out)
        self.metrics.record_swap(**out)
        self.metrics.flush_obs()
        return out

    # -- request intake ----------------------------------------------------
    def submit(self, req: Request) -> Response | None:
        """Admit ``req`` into the queue, or reject it immediately.

        Returns None when admitted (the answer arrives from a later
        :meth:`drain`), or a rejected :class:`Response`.
        """
        if req.id is None:
            req.id = f"r{self._next_id}"
        self._next_id += 1
        reason = self.admission.reject_reason(
            req, len(self._queue),
            class_depth=self._class_depth.get(req.cls, 0),
            tenant_depth=(self._tenant_depth.get(req.tenant, 0)
                          if req.tenant is not None else 0),
        )
        if reason is not None:
            resp = Response(
                id=req.id, user=req.user, item=req.item,
                status=STATUS_REJECTED, reason=reason,
                mode=self.health.mode,
                cls=req.cls, tenant=req.tenant,
            )
            self.metrics.record_request(resp)
            self._trace_request(resp, self.clock())
            self.metrics.flush_obs()
            return resp
        t = self.admission.ticket(req, self.clock())
        t.epoch = self._epoch
        self._queue.append(t)
        self._class_depth[req.cls] = self._class_depth.get(req.cls, 0) + 1
        if req.tenant is not None:
            self._tenant_depth[req.tenant] = (
                self._tenant_depth.get(req.tenant, 0) + 1)
        return None

    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    # -- the drain loop ----------------------------------------------------
    def drain(self) -> list[Response]:
        """Resolve every queued ticket (see module docstring).

        Tickets are grouped by admission epoch and each group resolves
        against that epoch's fenced (engine, fingerprint) — a streaming
        update between submit and drain never changes what an in-flight
        ticket answers from. The current epoch (and any epoch whose
        fence was dropped by a wholesale invalidation) resolves against
        the live engine. The fence table is cleared afterwards: the
        service is synchronous, so the queue that referenced the old
        epochs is fully consumed here.

        Span-only wrapper since the obs spine landed: the loop body
        lives in ``_drain_impl``; this level opens the drain trace,
        rebuilds each resolved request's span chain, and flushes the
        queued spans to the metrics JSONL. Tracing never touches the
        responses themselves (byte identity vs tracing-off is pinned by
        tests/test_obs.py and tests/test_torch_obs.py).
        """
        if not self._queue:
            return []
        self._drain_seq += 1
        obs.REGISTRY.gauge("serve.queue_depth").set(len(self._queue))
        with obs.trace(f"drain-{self._drain_seq}"):
            with obs.span("serve.drain", n=len(self._queue)) as sp:
                out = self._drain_impl()
                sp.set(responses=len(out))
        now = self.clock()
        for r in out:
            self._trace_request(r, now)
        self.metrics.flush_obs()
        return out

    def _drain_impl(self) -> list[Response]:
        depth = len(self._queue)  # health signal: occupancy at drain start
        work, self._queue = self._queue, []
        self._class_depth = {}
        self._tenant_depth = {}
        now = self.clock()
        # the mode is FIXED for the whole drain (self.health only moves
        # in the observe() below) — within-drain decisions stay a pure
        # function of the signal history, never of this drain's own luck
        self._drain_errors = 0
        self._drain_dispatches = 0

        responses: dict[int, Response] = {}  # queue position -> response
        by_epoch: dict[int, list[tuple[int, Ticket]]] = {}
        for pos, t in enumerate(work):
            if t.expired(now):
                responses[pos] = self._reject(t, REASON_DEADLINE, now)
            else:
                by_epoch.setdefault(t.epoch, []).append((pos, t))

        for epoch in sorted(by_epoch):
            fenced = (self._fenced.get(epoch)
                      if epoch != self._epoch else None)
            eng, fp = (fenced if fenced is not None
                       else self._engine_and_fp())
            self._resolve_group(eng, fp, by_epoch[epoch], responses)
        self._fenced.clear()

        out = [responses[pos] for pos in sorted(responses)]
        for r in out:
            self.metrics.record_request(r)
        n0 = len(self.health.transitions)
        self.health.observe(
            errors=self._drain_errors, dispatches=self._drain_dispatches,
            queue_depth=depth, queue_cap=self.admission.max_queue,
        )
        for tr in self.health.transitions[n0:]:
            self.metrics.record_mode(**tr)
            obs.REGISTRY.counter(
                "serve.mode_transitions",
                **{"from": tr["from"], "to": tr["to"]}
            ).inc()
            obs.event("serve.mode_transition",
                      **{"from": tr["from"], "to": tr["to"]})
        return out

    def _trace_request(self, resp: Response, now: float) -> None:
        """Rebuild one resolved request's span chain retroactively.

        The drain loop already tracks every per-request latency
        (queue_wait_s spans arrival→resolve, solve_s the batch
        dispatch), so the chain is reconstructed at flush time instead
        of threading span handles through the dispatch machinery. Ids
        are derived from the request id (``trace_id_for(f"req-{id}")``)
        — deterministic, and zero bytes change on the response. Chain
        (seq): 0 serve.request (root) > 1 serve.admit, 2 serve.queue,
        3 serve.batch > 4 serve.dispatch > 5 serve.solver.
        """
        if not obs.tracing_enabled():
            return
        tr = obs.TRACER
        tid = obs.trace_id_for(f"req-{resp.id}")
        t_res = now
        t_arr = t_res - max(resp.queue_wait_s, 0.0)
        t_disp = t_res - max(resp.solve_s, 0.0)
        tr.record(
            tid, "serve.request", t_arr, t_res, seq=0,
            id=resp.id, user=int(resp.user), item=int(resp.item),
            status=resp.status, reason=resp.reason, mode=resp.mode,
            approx=bool(resp.approx), err_bound=resp.err_bound,
        )
        tr.record(tid, "serve.admit", t_arr, t_arr, seq=1, parent_seq=0)
        tr.record(tid, "serve.queue", t_arr, t_disp, seq=2, parent_seq=0)
        if not resp.ok:
            return
        tr.record(tid, "serve.batch", t_disp, t_res, seq=3, parent_seq=0,
                  batch_id=resp.batch_id, batch_size=resp.batch_size)
        tr.record(tid, "serve.dispatch", t_disp, t_res, seq=4,
                  parent_seq=3, tier=resp.cache_tier)
        tr.record(tid, "serve.solver", t_disp, t_res, seq=5,
                  parent_seq=4, tier=resp.cache_tier,
                  solver=resp.extra.get("solver"),
                  approx=bool(resp.approx), err_bound=resp.err_bound)

    def _resolve_group(self, eng, fp, live, responses) -> None:
        """Resolve one epoch group of live tickets against (eng, fp)."""
        now = self.clock()
        # cache tiers first; misses keep first-arrival order per key
        misses: dict[tuple, list[tuple[int, Ticket]]] = {}
        exact_solver = eng.solver != "sampled"
        for pos, t in live:
            key = (fp, eng.solver) + t.req.key()
            entry = self.cache.get(key)
            if entry is not None:
                responses[pos] = self._respond(t, entry, TIER_HOT, now, eng)
                continue
            entry = self._disk_get(eng, fp, t.req)
            if entry is not None:
                self.cache.put(key, entry)
                responses[pos] = self._respond(t, entry, TIER_DISK, now, eng)
                continue
            if exact_solver and self.health.allows_approx(t.req.cls):
                # a certified answer banked by an earlier brownout drain
                # (hot tier only, under the sampled sibling's solver key
                # — the exact key space above stays byte-untouched)
                entry = self.cache.peek((fp, "sampled") + t.req.key())
                if entry is not None:
                    self.cache.stats.hits_hot += 1
                    responses[pos] = self._respond(
                        t, entry, TIER_HOT, now, eng.approx_sibling()
                    )
                    continue
            misses.setdefault(key, []).append((pos, t))

        approx: dict[tuple, list] = {}
        if misses and self.health.mode != MODE_FULL:
            misses, approx = self._shed_degraded(eng, misses, responses)
        # exact-path batches dispatch FIRST: their batch ids (and bytes)
        # match a run with approx serving disabled, where the approx
        # misses below would have been shed before any dispatch
        if misses:
            self._dispatch_misses(eng, fp, misses, responses)
        if approx:
            self._dispatch_approx(eng, fp, approx, responses)

    @staticmethod
    def _key_class(waiting) -> str:
        """The class a miss key is served under: the highest-priority
        class among its coalesced waiters (a duplicate key shared by an
        interactive and a scavenger waiter dispatches as interactive —
        de-duplication must never demote the urgent one)."""
        return min((t.req.cls for _, t in waiting),
                   key=lambda c: CLASSES.index(c))

    def _shed_degraded(self, eng, misses, responses) -> tuple[dict, dict]:
        """Brownout: route each miss where the active mode may serve
        its class (serve/health.py class_mode — the ladder degrades
        scavenger → batch → interactive in order).

        Per miss key, under the highest-priority waiter's class:
        classes the global rung leaves at ``full`` (interactive at
        ``bank_preferred``) keep their exact ladder solve; degraded
        classes keep misses the precomputed factor bank answers in
        O(1) where the class may still use it (docs/design.md §14,
        unchanged bytes vs full mode — scavenger loses the bank one
        rung early); the rest serve a certified approximate answer
        from the engine's ``sampled`` sibling when
        ``health.allows_approx(cls)`` says so, and are rejected
        ``degraded`` otherwise. In ``cache_only`` — or with
        ``approx_ok`` off — every unbanked miss is shed ``degraded``:
        that rung is the exhaustion floor for every class. Hits never
        reach here: degraded modes shed only miss-path work. Returns
        ``(exact_misses, approx_misses)``.
        """
        bank_loaded = (
            eng.solver == "precomputed"
            and eng.ensure_factor_bank() > 0
        )
        keep: dict[tuple, list] = {}
        approx: dict[tuple, list] = {}
        now = self.clock()
        for key, waiting in misses.items():
            cls = self._key_class(waiting)
            if self.health.allows_solve(cls):
                keep[key] = waiting
            elif (bank_loaded and self.health.allows_bank(cls)
                  and eng.bank_contains(key[2], key[3])):
                keep[key] = waiting
            elif self.health.allows_approx(cls):
                approx[key] = waiting
            else:
                for pos, t in waiting:
                    responses[pos] = self._reject(t, REASON_DEGRADED, now)
        return keep, approx

    def _overlap_eligible(self, eng) -> bool:
        """Windowed dispatch applies only where query_batch would run
        one flat dispatch per batch anyway — so the overlapped stream
        is dispatch-for-dispatch the program sequence the byte-identity
        contract pins. Local meshes qualify (the flat path shards the
        query axis in process); engines over a mesh that spans processes
        keep the sequential guarded path. (The reference's
        ``_wide_block_cap`` term is dropped: see the module docstring.)"""
        return (
            int(self.config.dispatch_window) > 1
            and eng.impl in ("auto", "flat")
            and eng._flat_eligible()
            and not eng._multihost
        )

    def _miss_lanes(self, misses, keys) -> tuple[list, list | None]:
        """(classes, urgent) scheduler inputs for a miss-key list:
        per key, the highest-priority waiter's class, and whether any
        waiter's remaining deadline budget is inside the configured
        slack (None when deadline promotion is disabled)."""
        classes = [self._key_class(misses[k]) for k in keys]
        slack = self.deadline_slack_s
        if slack is None:
            return classes, None
        now = self.clock()
        urgent = [
            any(t.t_deadline is not None
                and (t.t_deadline - now) <= float(slack)
                for _, t in misses[k])
            for k in keys
        ]
        return classes, urgent

    def _dispatch_misses(self, eng, fp, misses, responses) -> None:
        keys = list(misses.keys())  # first-arrival order (dict insertion)
        points = np.asarray([[k[2], k[3]] for k in keys], np.int64)
        counts = eng.index.counts_batch(points)
        classes, urgent = self._miss_lanes(misses, keys)
        plan = self.scheduler.plan(counts, classes, urgent)
        if self.host_role is not None:
            self._dispatch_hostshard(eng, fp, misses, responses, keys,
                                     counts, points, plan)
            return
        if not self._overlap_eligible(eng):
            for batch in plan:
                self._dispatch_one(eng, fp, misses, responses, keys,
                                   counts, points, batch)
            return
        # Overlapped mega-batch dispatch: keep up to dispatch_window
        # flat programs in flight; finalize strictly in dispatch order.
        # The SERVE_DISPATCH fire stays host-side immediately before
        # each batch's dispatch, so a classified fault there (injected
        # or real) sheds exactly that batch and the stream continues —
        # the same shed contract as the sequential path.
        window = int(self.config.dispatch_window)
        inflight: list = []  # (batch, bid, t0, handle) in dispatch order
        bi = 0
        while bi < len(plan) or inflight:
            while bi < len(plan) and len(inflight) < window:
                batch = plan[bi]
                bi += 1
                bid = self._batch_id
                self._batch_id += 1
                bpts = points[batch]
                self.dispatch_log.append((bid, np.array(bpts)))
                t0 = self.clock()
                try:
                    inject.fire(sites.SERVE_DISPATCH)
                except Exception as e:
                    kind = taxonomy.classify(e)
                    if kind is None:
                        raise
                    if kind in _TOPOLOGY_KINDS:
                        # a lost device/host poisons the in-flight
                        # handles too: shrink the mesh, then re-dispatch
                        # this batch, the in-flight ones and the
                        # remainder on the survivors — nothing sheds and
                        # the stream completes bit-identically. Only if
                        # no shrink is possible does this batch shed.
                        if self._recover_topology(kind, eng, [
                            points[b] for (b, _, _, _) in inflight
                        ] + [bpts] + [points[b] for b in plan[bi:]]):
                            retry = [(b, b_bid)
                                     for (b, b_bid, _, _) in inflight]
                            retry += [(batch, bid)]
                            retry += [(b, None) for b in plan[bi:]]
                            inflight.clear()
                            for b, b_bid in retry:
                                self._dispatch_one(eng, fp, misses,
                                                   responses, keys,
                                                   counts, points, b,
                                                   bid=b_bid)
                            return
                    self._shed_batch(misses, responses, keys, counts,
                                     batch, bid, kind, t0)
                    continue
                try:
                    with obs.span("serve.batch_dispatch", batch_id=bid,
                                  size=len(batch)):
                        h = eng._dispatch_flat(bpts, None)
                except Exception as e:
                    kind = taxonomy.classify(e)
                    if kind is None:
                        raise
                    if kind in _TOPOLOGY_KINDS:
                        # best-effort shrink before rerouting: on
                        # success the guarded path below re-dispatches
                        # everything on the surviving mesh; on failure
                        # it sheds classified, batch by batch
                        self._recover_topology(kind, eng, [
                            points[b] for (b, _, _, _) in inflight
                        ] + [bpts] + [points[b] for b in plan[bi:]])
                    # A real dispatch-time device fault poisons the
                    # in-flight handles too. Nothing sheds here: drop
                    # them (after a worker death or a preemption, with
                    # the device state they were dispatched on), then
                    # reroute this batch, the in-flight ones, and the
                    # remainder through the guarded sequential path —
                    # the engine-side ladder (reset → retry → halve →
                    # CPU rung) absorbs what it can, exactly as the
                    # non-overlapped path would have.
                    inflight_dead = [(b, b_bid)
                                     for (b, b_bid, _, _) in inflight]
                    inflight.clear()
                    self._reset_after(kind, eng)
                    retry = list(inflight_dead)
                    retry += [(batch, bid)]
                    retry += [(b, None) for b in plan[bi:]]
                    for b, b_bid in retry:
                        self._dispatch_one(eng, fp, misses, responses,
                                           keys, counts, points, b,
                                           bid=b_bid)
                    return
                inflight.append((batch, bid, t0, h))
            if not inflight:
                continue
            batch, bid, t0, h = inflight.pop(0)
            try:
                with obs.span("serve.batch_finalize", batch_id=bid):
                    res = eng._finalize_flat(h)
                    # same NaN screen query_batch applies: a non-finite
                    # payload walks the solver degradation ladder
                    res = eng._nan_ladder(
                        res,
                        lambda b=points[batch]: eng._query_batch_impl(b)
                    )
            except Exception as e:
                kind = taxonomy.classify(e)
                if kind is None:
                    raise
                # A classified finalize fault (worker crash, preemption)
                # killed every in-flight buffer with it. Shed ONLY the
                # faulted batch; drop the dead handles and re-dispatch
                # their batches — plus the unplanned remainder — through
                # the guarded sequential path, whose engine-side ladder
                # (reset → retry → halve → CPU rung) owns the recovery.
                # DEVICE_LOST differs: the ladder cannot fix a dead
                # device, so the mesh shrinks first, and on a successful
                # shrink the faulted batch re-dispatches too instead of
                # shedding (its inputs are host-side).
                recovered = (
                    kind in _TOPOLOGY_KINDS
                    and self._recover_topology(kind, eng, [
                        points[batch]
                    ] + [points[b] for (b, _, _, _) in inflight]
                        + [points[b] for b in plan[bi:]])
                )
                retry = []
                if recovered:
                    retry += [(batch, bid)]
                else:
                    self._shed_batch(misses, responses, keys, counts,
                                     batch, bid, kind, t0)
                retry += [(b, b_bid) for (b, b_bid, _, _) in inflight]
                retry += [(b, None) for b in plan[bi:]]
                inflight.clear()
                self._reset_after(kind, eng)
                for b, b_bid in retry:
                    self._dispatch_one(eng, fp, misses, responses, keys,
                                       counts, points, b, bid=b_bid)
                return
            self._bank_batch(eng, fp, misses, responses, keys, counts,
                             batch, bid, res, t0)

    @staticmethod
    def _reset_after(kind, eng) -> None:
        """After a worker death or a preemption in the windowed loop,
        rebuild the engine's device state (every captured graph is
        dropped with it) before anything re-dispatches, as the port's
        ``query_many`` does. A reset that fails classified leaves the
        guarded path to shed batch by batch; other kinds leave the
        device state alone."""
        if kind not in _RESET_KINDS:
            return
        try:
            eng._reset_device_state()
        except Exception as e:
            if taxonomy.classify(e) is None:
                raise

    def _dispatch_one(self, eng, fp, misses, responses, keys, counts,
                      points, batch, bid=None) -> None:
        """One guarded sequential dispatch (the non-overlapped serve
        path, and the degradation rung after a classified fault in the
        overlapped loop). ``bid`` reuses a batch id the windowed loop
        already allocated and logged for this batch."""
        if bid is None:
            bid = self._batch_id
            self._batch_id += 1
            self.dispatch_log.append((bid, np.array(points[batch])))
        t0 = self.clock()
        try:
            inject.fire(sites.SERVE_DISPATCH)
            with obs.span("serve.batch_dispatch", batch_id=bid,
                          size=len(batch)):
                res = eng.query_batch(points[batch])
        except Exception as e:
            kind = taxonomy.classify(e)
            if kind is None:
                raise
            if kind in _TOPOLOGY_KINDS and self._recover_topology(
                kind, eng, [points[batch]]
            ):
                # the shrink succeeded: this very batch re-dispatches on
                # the surviving mesh (bounded: every recovery drops a
                # slot, and with none left the batch sheds below)
                self._dispatch_one(eng, fp, misses, responses, keys,
                                   counts, points, batch, bid=bid)
                return
            self._shed_batch(misses, responses, keys, counts, batch, bid,
                             kind, t0)
            return
        self._bank_batch(eng, fp, misses, responses, keys, counts, batch,
                         bid, res, t0)

    def _shed_batch(self, misses, responses, keys, counts, batch, bid,
                    kind, t0) -> None:
        self._drain_errors += 1
        self._drain_dispatches += 1
        dt = self.clock() - t0
        self.metrics.record_batch(
            bid, len(batch), int(counts[batch].sum()), dt, status=kind
        )
        for j in batch:
            for pos, t in misses[keys[int(j)]]:
                responses[pos] = self._reject(
                    t, kind, self.clock(), batch_id=bid,
                    batch_size=len(batch),
                )

    def _bank_batch(self, eng, fp, misses, responses, keys, counts, batch,
                    bid, res, t0) -> None:
        self._drain_dispatches += 1
        dt = self.clock() - t0
        self.metrics.record_batch(
            bid, len(batch), int(counts[batch].sum()), dt
        )
        now = self.clock()
        for row, j in enumerate(batch):
            key = keys[int(j)]
            entry = BlockEntry(
                scores=np.array(res.scores_of(row)),
                ihvp=np.array(res.ihvp[row]),
                test_grad=np.array(res.test_grad[row]),
                count=int(res.counts[row]),
                extra=_approx_extra(res, row),
            )
            self.cache.put(key, entry)
            self._disk_put(eng, fp, key, entry)
            waiting = misses[key]
            # dispatch answered from the factor bank (an O(1)
            # triangular-solve/matvec, not a ladder solve): label the
            # paying waiter with the bank tier and count the hit
            banked = (
                eng.solver == "precomputed"
                and eng.bank_contains(key[2], key[3])
            )
            for rank, (pos, t) in enumerate(waiting):
                # first waiter per key pays the compute; duplicates
                # coalesced into the same drain are hot-tier hits
                if rank == 0:
                    tier = TIER_PRECOMPUTED if banked else TIER_COMPUTE
                    if banked:
                        self.cache.stats.hits_bank += 1
                else:
                    tier = TIER_HOT
                    self.cache.stats.hits_hot += 1
                responses[pos] = self._respond(
                    t, entry, tier, now, eng, solve_s=dt,
                    batch_id=bid, batch_size=len(batch),
                )

    # -- host-sharded dispatch (docs/design.md §25) ------------------------
    def _dispatch_hostshard(self, eng, fp, misses, responses, keys,
                            counts, points, plan) -> None:
        """One drain's miss dispatch split across hosts by journal.

        Every host runs this same code over the same coalesced plan:
        compute OWN contiguous batch-aligned shard of the dispatch order
        through the engine (``hostshard.dispatch_local_shard`` — skipped
        entirely when a verified journal for it already exists, the
        restart-resume path), then merge every host's journal back into
        dispatch order (``hostshard.merge_host_shards`` — pure journal
        reads, no hot-path collective). Shards are batch-boundary-aligned
        slices of the single-process order, so the merged results are
        bitwise the single-host stream.

        A peer whose journal never lands inside ``host_merge_timeout_s``
        is a proved ``host_lost``: the survivors adopt the dead hosts'
        shards (recompute them locally from the same plan — the journals
        make the adoption idempotent) and the drain still answers every
        request. Only when adoption itself fails classified does the
        drain shed, batch by batch, with the taxonomy kind.
        """
        host, nhosts, jdir = self.host_role
        order = [int(j) for batch in plan for j in batch]
        opts = points[order]
        tag = f"drain{self._drain_seq}"
        mb = int(self.config.max_batch)
        t0 = self.clock()
        # batch ids allocated up front in plan order, so ids and the
        # dispatch log match the single-host stream
        bids = []
        for batch in plan:
            bid = self._batch_id
            self._batch_id += 1
            self.dispatch_log.append((bid, np.array(points[batch])))
            bids.append(bid)
        try:
            inject.fire(sites.SERVE_DISPATCH)
            with obs.span("serve.hostshard_drain", host=int(host),
                          nhosts=int(nhosts), rows=len(order)):
                hostshard.dispatch_local_shard(
                    eng, opts, host=host, nhosts=nhosts,
                    journal_dir=jdir, tag=tag, engine_fp=fp,
                    max_batch=mb,
                )
                merged = hostshard.merge_host_shards(
                    jdir, tag, nhosts, opts, engine_fp=fp, max_batch=mb,
                    timeout_s=float(self.config.host_merge_timeout_s),
                    clock=self._merge_clock(),
                )
        except Exception as e:
            kind = taxonomy.classify(e)
            if kind is None:
                raise
            merged = None
            if kind == taxonomy.HOST_LOST:
                merged = self._adopt_missing_shards(eng, fp, opts, tag)
            if merged is None:
                for bi, batch in enumerate(plan):
                    self._shed_batch(misses, responses, keys, counts,
                                     batch, bids[bi], kind, t0)
                return
        base = 0
        for bi, batch in enumerate(plan):
            view = _MergedRows(merged, base, len(batch))
            self._bank_batch(eng, fp, misses, responses, keys, counts,
                             batch, bids[bi], view, t0)
            base += len(batch)

    def _merge_clock(self):
        return self._clock_obj if self._clock_obj is not None \
            else rpolicy.WALL

    def _adopt_missing_shards(self, eng, fp, opts, tag):
        """Survivor-side recovery for the journal transport: recompute
        every shard whose journal is missing (``dispatch_local_shard``
        verifies and skips the ones already on disk — including our
        own) and re-merge with a zero wait. Returns the merged arrays,
        or None when the adoption itself failed classified (the caller
        sheds)."""
        host, nhosts, jdir = self.host_role
        mb = int(self.config.max_batch)
        try:
            inject.fire(sites.HOST_LOST)
            seed = f"host-loss-{self.metrics.host_loss_recoveries}"
            with obs.span("serve.host_loss_recovery", trace_seed=seed,
                          host=int(host), nhosts=int(nhosts),
                          transport="journal"):
                for h in range(nhosts):
                    hostshard.dispatch_local_shard(
                        eng, opts, host=h, nhosts=nhosts,
                        journal_dir=jdir, tag=tag, engine_fp=fp,
                        max_batch=mb,
                    )
                merged = hostshard.merge_host_shards(
                    jdir, tag, nhosts, opts, engine_fp=fp, max_batch=mb,
                    timeout_s=0.0, clock=self._merge_clock(),
                )
        except Exception as e:
            if taxonomy.classify(e) is None:
                raise
            return None
        self.metrics.record_host_loss_recovery()
        obs.REGISTRY.counter("serve.host_loss_recoveries").inc()
        return merged

    def _dispatch_approx(self, eng, fp, misses, responses) -> None:
        """Serve brownout misses from the certified ``sampled`` rung.

        A guarded sequential dispatch stream over the engine's
        cache-less :meth:`~fia_tpu_torch.influence.engine.InfluenceEngine.
        approx_sibling` (solver='sampled'): every answer is stamped
        ``approx=True`` with its concentration error bound
        (docs/design.md §22), and results bank only in the HOT tier
        under the sibling's solver key — never under the exact
        solver's hot/disk keys, so the exact path's bytes are
        identical to a run with approx serving disabled. A classified
        fault sheds exactly that batch with the taxonomy kind (the
        rung is salvage — it gets no retry ladder of its own).

        These dispatches also run AFTER the drain's exact-path batches
        (stable batch ids on the exact path) and stay OUT of the
        drain's health signals: the brownout controller listens to the
        primary dispatch path only, so the salvage rung can neither
        mask a sick backend with its successes nor deepen the brownout
        with its failures.
        """
        sib = eng.approx_sibling()
        keys = list(misses.keys())
        points = np.asarray([[k[2], k[3]] for k in keys], np.int64)
        counts = eng.index.counts_batch(points)
        classes, urgent = self._miss_lanes(misses, keys)
        for batch in self.scheduler.plan(counts, classes, urgent):
            bid = self._batch_id
            self._batch_id += 1
            self.dispatch_log.append((bid, np.array(points[batch])))
            t0 = self.clock()
            try:
                inject.fire(sites.SERVE_DISPATCH)
                with obs.span("serve.batch_dispatch", batch_id=bid,
                              size=len(batch), approx=True):
                    res = sib.query_batch(points[batch])
            except Exception as e:
                kind = taxonomy.classify(e)
                if kind is None:
                    raise
                dt = self.clock() - t0
                self.metrics.record_batch(
                    bid, len(batch), int(counts[batch].sum()), dt,
                    status=kind,
                )
                for j in batch:
                    for pos, t in misses[keys[int(j)]]:
                        responses[pos] = self._reject(
                            t, kind, self.clock(), batch_id=bid,
                            batch_size=len(batch),
                        )
                continue
            dt = self.clock() - t0
            self.metrics.record_batch(
                bid, len(batch), int(counts[batch].sum()), dt
            )
            now = self.clock()
            for row, j in enumerate(batch):
                key = keys[int(j)]
                entry = BlockEntry(
                    scores=np.array(res.scores_of(row)),
                    ihvp=np.array(res.ihvp[row]),
                    test_grad=np.array(res.test_grad[row]),
                    count=int(res.counts[row]),
                    extra=_approx_extra(res, row),
                )
                self.cache.put((fp, sib.solver) + key[2:], entry)
                for rank, (pos, t) in enumerate(misses[key]):
                    # first waiter per key pays the compute; duplicates
                    # coalesced into the same drain are hot-tier hits
                    if rank == 0:
                        tier = TIER_COMPUTE
                    else:
                        tier = TIER_HOT
                        self.cache.stats.hits_hot += 1
                    responses[pos] = self._respond(
                        t, entry, tier, now, sib, solve_s=dt,
                        batch_id=bid, batch_size=len(batch),
                    )

    # -- response/tier helpers --------------------------------------------
    def _respond(self, t: Ticket, entry: BlockEntry, tier: str, now: float,
                 eng, solve_s: float = 0.0, batch_id=None,
                 batch_size=None) -> Response:
        related = None
        if self.config.include_related:
            related = eng.index.related(int(t.req.user), int(t.req.item))
        return Response(
            id=t.req.id, user=t.req.user, item=t.req.item,
            scores=entry.scores, related=related, ihvp=entry.ihvp,
            test_grad=entry.test_grad, cache_tier=tier,
            queue_wait_s=max(now - t.t_arrival, 0.0), solve_s=solve_s,
            batch_id=batch_id, batch_size=batch_size,
            mode=self.health.mode,
            cls=t.req.cls, tenant=t.req.tenant,
            # certificate provenance rides the cached entry, so hot/disk
            # hits of an approximate block keep their stamped bound
            approx=bool(entry.extra.get("approx", False)),
            err_bound=entry.extra.get("err_bound"),
            # solver provenance for the serve.solver span + per-rung
            # histograms; extra never reaches Response.json(), so the
            # wire bytes are unchanged (and identical trace-on/off)
            extra={"solver": eng.solver},
        )

    def _reject(self, t: Ticket, reason: str, now: float, batch_id=None,
                batch_size=None) -> Response:
        return Response(
            id=t.req.id, user=t.req.user, item=t.req.item,
            status=STATUS_REJECTED, reason=reason,
            queue_wait_s=max(now - t.t_arrival, 0.0),
            batch_id=batch_id, batch_size=batch_size,
            mode=self.health.mode,
            cls=t.req.cls, tenant=t.req.tenant,
        )

    # -- device-loss recovery (docs/design.md §18) -------------------------
    def _recover_device_loss(self, eng, pending_points) -> bool:
        """Shrink the serving mesh over the surviving slots.

        Called when a dispatch failure classified ``device_lost``: asks
        which mesh slots are still visible
        (:func:`~fia_tpu_torch.parallel.mesh.lost_device_ids`; an
        injected loss names none, so the deterministic last-slot drop
        applies), re-homes the engine on the survivors
        (:meth:`~fia_tpu_torch.influence.engine.InfluenceEngine.
        rebuild_mesh`) and re-arms the still-pending dispatch geometries
        (``precompile_flat``), so steady state captures nothing on the
        new topology. Results are unchanged by construction: every mesh
        size runs the single-device program per shard (docs/design.md
        §15).

        Returns False — the caller sheds classified — when there is no
        mesh to shrink (a single-device engine; on the card a sticky
        CUDA error classifies ``device_lost`` and every later batch sheds
        the same way), no survivor to shrink to, or the rebuild itself
        failed with a classified fault.
        """
        from fia_tpu_torch.parallel import mesh as pmesh

        cur = getattr(eng, "mesh", None)
        if cur is None:
            return False
        new = pmesh.surviving_mesh(cur, pmesh.lost_device_ids(cur))
        if new is None:
            return False
        try:
            seed = f"device-loss-{self.metrics.device_loss_recoveries}"
            with obs.span("serve.device_loss_recovery", trace_seed=seed,
                          ndev=int(new.devices.size)) as sp:
                eng.rebuild_mesh(new)
                self._rearm(eng, pending_points, sp)
        except Exception as e:
            if taxonomy.classify(e) is None:
                raise
            # the mesh the engine is on: the old one where the rebuild
            # failed (it keeps its placement), the new one where only
            # the re-arming did
            self.mesh = eng.mesh
            return False
        self.mesh = new
        self.metrics.record_device_loss_recovery()
        obs.REGISTRY.counter("serve.device_loss_recoveries").inc()
        return True

    @staticmethod
    def _rearm(eng, pending_points, sp) -> None:
        """Build the still-pending dispatch geometries on the new mesh
        (``precompile_flat``) where the flat path serves and the mesh
        stays in one process, so steady state captures nothing."""
        if (eng.impl in ("auto", "flat") and eng._flat_eligible()
                and not eng._multihost):
            geoms = {tuple(eng.flat_geometry(np.asarray(p)))
                     for p in pending_points if len(p)}
            eng.precompile_flat(sorted(geoms))
            sp.set(rearmed=len(geoms))

    # -- host-loss recovery (docs/design.md §25) ---------------------------
    def _recover_host_loss(self, eng, pending_points) -> bool:
        """Shrink the serving mesh over the surviving *hosts*.

        The ``host_lost`` analogue of :meth:`_recover_device_loss`, one
        granularity up: a failed exchange (``parallel.distributed``
        raises ``HostLost``) says some peer process is gone, so the
        liveness probe asks which mesh hosts lost every slot
        (:func:`~fia_tpu_torch.parallel.mesh.lost_host_ids`; an injected
        loss names none, so the deterministic last-host drop applies),
        drops those hosts wholesale, re-homes the engine on the
        survivors — which re-shards row-sharded tables onto them and
        fires the ``mesh.rebuild_multihost`` site when the result still
        spans hosts — and re-arms the pending dispatch geometries.
        Results are unchanged by construction: every mesh size runs the
        single-device program per shard (docs/design.md §15), so the
        survivors' answers are a fault-free smaller mesh's bits.

        Returns False — caller sheds classified — when there is no mesh
        to shrink, no host would survive the drop, or the rebuild itself
        failed with a classified fault.
        """
        from fia_tpu_torch.parallel import mesh as pmesh

        cur = getattr(eng, "mesh", None)
        if cur is None:
            return False
        new = pmesh.surviving_mesh(
            cur,
            lost_ids=pmesh.lost_device_ids(cur),
            lost_hosts=pmesh.lost_host_ids(cur),
            unnamed="host",
        )
        if new is None:
            return False
        try:
            inject.fire(sites.HOST_LOST)
            seed = f"host-loss-{self.metrics.host_loss_recoveries}"
            with obs.span("serve.host_loss_recovery", trace_seed=seed,
                          ndev=int(new.devices.size),
                          nhosts=len(pmesh.mesh_hosts(new))) as sp:
                eng.rebuild_mesh(new)
                self._rearm(eng, pending_points, sp)
        except Exception as e:
            if taxonomy.classify(e) is None:
                raise
            self.mesh = eng.mesh
            return False
        self.mesh = new
        self.metrics.record_host_loss_recovery()
        obs.REGISTRY.counter("serve.host_loss_recoveries").inc()
        return True

    def _recover_topology(self, kind, eng, pending_points) -> bool:
        """Route a topology-loss kind to its shrink: ``host_lost``
        drops whole hosts, ``device_lost`` drops one device."""
        if kind == taxonomy.HOST_LOST:
            return self._recover_host_loss(eng, pending_points)
        return self._recover_device_loss(eng, pending_points)

    def _disk_dir(self, eng) -> str | None:
        if not self.config.disk_cache or not eng.cache_dir:
            return None
        return eng.cache_dir

    def _disk_get(self, eng, fp: str, req: Request) -> BlockEntry | None:
        d = self._disk_dir(eng)
        if d is None:
            return None
        path = scache.disk_entry_path(
            d, eng.model_name, eng.solver, req.user, req.item
        )
        e = scache.disk_get(
            path, scache.disk_fingerprint(eng.model_name, eng.solver, fp),
            stats=self.cache.stats,
        )
        if e is not None:
            self.cache.stats.hits_disk += 1
        return e

    def _disk_put(self, eng, fp: str, key: tuple, entry: BlockEntry) -> None:
        d = self._disk_dir(eng)
        if d is None:
            return
        scache.disk_put(
            scache.disk_entry_path(d, eng.model_name, eng.solver,
                                   key[2], key[3]),
            entry,
            scache.disk_fingerprint(eng.model_name, eng.solver, fp),
        )

    # -- convenience -------------------------------------------------------
    def run(self, requests, drain_every: int | None = None
            ) -> list[Response]:
        """Submit a request iterable and drain to completion.

        ``drain_every``: drain after every N submits (None = one drain
        at the end — maximal coalescing). Responses return in
        submission order.
        """
        by_id: dict[str, Response] = {}
        order: list[str] = []
        n = 0
        for req in requests:
            if not isinstance(req, Request):
                req = Request(*req)
            r = self.submit(req)
            order.append(req.id)
            if r is not None:
                by_id[req.id] = r
            n += 1
            if drain_every and n % drain_every == 0:
                for resp in self.drain():
                    by_id[resp.id] = resp
        for resp in self.drain():
            by_id[resp.id] = resp
        return [by_id[i] for i in order]

    def rollup(self) -> dict:
        return self.metrics.rollup(self.cache.stats.json())

    def close(self) -> dict:
        """Final rollup (logged to the metrics JSONL) + release files."""
        r = self.metrics.log_rollup(self.cache.stats.json())
        self.metrics.close()
        return r

    # -- warmup ------------------------------------------------------------
    def warmup(self, points: np.ndarray, fill_cache: bool = False) -> dict:
        """Arm the serving dispatch path for ``points``' planned batches.

        Two stages. First, every planned batch's flat dispatch geometry
        is built ahead of time (``engine.precompile_flat``: on the card
        each is captured as a CUDA graph), so steady-state serving never
        builds on the hot path. Second, the planned batches are actually
        dispatched: that exercises the exact program the stream will
        hit, and covers the engines the ahead-of-time stage skips (the
        ``precomputed`` and ``sampled`` rungs are not flat-eligible:
        their real dispatches capture their geometries, and a later
        batch whose hit/miss split makes a new geometry captures then,
        as the reference's jit caches fill per shape). ``fill_cache=True``
        additionally banks the warmup results in the hot/disk tiers
        (useful when ``points`` are the expected hot set, not
        synthetic).

        Returns {"batches", "compiled_keys", "builds", "seconds",
        "planned_geometries", "aot", "kernel_variant",
        "factor_bank_entries", "all_planned_compiled"} — smoke runs
        assert ``all_planned_compiled`` so a warmup that missed a planned
        geometry fails loudly instead of paying a first-request capture
        in production. ``compiled_keys`` are the programs built on
        their first dispatch (the engine's ``compiled_geometries()
        ["jit"]``) during the warmup, ``builds`` every program build it
        counted (``utils.compilemon``).
        """
        eng, fp = self._engine_and_fp()
        points = np.asarray(points)
        if points.ndim == 1:
            points = points[None, :]
        before = set(eng.compiled_geometries()["jit"])
        builds0 = compilemon.count()
        t0 = time.perf_counter()
        bank_entries = 0
        if self.config.factor_bank and eng.solver == "precomputed":
            # preload the published factor bank device-resident (a
            # verified load: checksum + fingerprint + per-entry params
            # digests) so the first hot-set request never pays it
            bank_entries = eng.ensure_factor_bank()
        counts = eng.index.counts_batch(points)
        plan = self.batcher.plan(counts)
        flat_ok = (eng.impl in ("auto", "flat") and eng._flat_eligible()
                   and not eng._multihost)
        planned = []
        aot = {"compiled": [], "cached": [], "seconds": 0.0}
        if flat_ok:
            planned = [list(eng.flat_geometry(points[b])) for b in plan]
            aot = eng.precompile_flat(planned)
        nb = 0
        for batch in plan:
            bpts = points[batch]
            res = eng.query_batch(bpts)
            nb += 1
            if fill_cache:
                for row, j in enumerate(batch):
                    key = (fp, eng.solver, int(bpts[row, 0]),
                           int(bpts[row, 1]))
                    entry = BlockEntry(
                        scores=np.array(res.scores_of(row)),
                        ihvp=np.array(res.ihvp[row]),
                        test_grad=np.array(res.test_grad[row]),
                        count=int(res.counts[row]),
                        extra=_approx_extra(res, row),
                    )
                    self.cache.put(key, entry)
                    self._disk_put(eng, fp, key, entry)
        built = eng.compiled_geometries()
        armed = {tuple(g) for g in built["aot"]}
        return {
            "batches": nb,
            "compiled_keys": sorted(set(built["jit"]) - before),
            "builds": compilemon.count() - builds0,
            "seconds": round(time.perf_counter() - t0, 3),
            "planned_geometries": planned,
            "aot": aot,
            # which score-kernel variant the armed programs embed
            # (influence/kernels/): "cuda" on the card — smoke/ops
            # checks pin it so a deployment never silently serves the
            # plain PyTorch score stage after a model/config drift
            "kernel_variant": eng.active_kernel_variant(),
            "factor_bank_entries": bank_entries,
            "all_planned_compiled": (
                all(tuple(g) in armed for g in planned) if flat_ok
                else True  # the real dispatches captured their programs
            ),
        }

"""The port's lint configuration.

fialint is a *repo-native* linter: its rules encode this codebase's
invariants, so the allowlists naming which modules own which privilege
live here — in code, reviewed like code — rather than in an external
config file. This is the port's own copy of ``fia_tpu/analysis/config.py``:
the same names, each pointing at the port's counterpart under
``fia_tpu_torch/``. Every path is a full ``fia_tpu_torch/...`` prefix or
suffix, never a bare ``fia_tpu``: the reference's tree sits beside the
port in one root, and a path of either config must never match a file
of the other package (``"fia_tpu_torch/x".startswith("fia_tpu/")`` is
false; ``"fia_tpu"`` would match both).
"""

from __future__ import annotations

# FIA101: the only modules allowed to perform raw persisted writes.
# utils/io.py owns the fsync'd-atomic primitives; reliability/artifacts.py
# owns the checksummed-manifest publish built on top.
RAW_WRITE_ALLOWED = (
    "fia_tpu_torch/utils/io.py",
    "fia_tpu_torch/reliability/artifacts.py",
)

# FIA2xx: the programs captured as CUDA graphs (the reference's jit
# scopes). The engine's flat programs are built as closures and handed
# to ``_FlatGraph`` (influence/engine.py), which runs them once on a
# warm-up stream and then records them under ``torch.cuda.graph``; a
# captured program's kernel wrappers run inside the same capture. None of
# this is visible to the AST (the closures travel as values), so each
# scope is registered here. Entries are (path suffix, qualified name)
# with an optional third element naming the static argument positions
# (host values fixed at capture time: the model object, a variant
# string, geometry ints); when omitted, no position is static. Every
# other parameter is a tensor. Nested defs of a registered scope run in
# the capture too and are policed with it.
REGISTERED_CAPTURE_ENTRY_POINTS = (
    # InfluenceEngine._flat_prelude's and _flat_fn's programs: the query
    # block and CSR postings to per-row ids; then every stage up to the
    # scores (and the sampled rung's certificate). Captured per
    # (t_pad, s_pad) geometry by _FlatGraph (and run eagerly on the CPU).
    ("fia_tpu_torch/influence/engine.py", "_flat_prelude.prelude"),
    ("fia_tpu_torch/influence/engine.py", "_flat_fn.fn"),
    # The kernel dispatch of influence/kernels: ``model`` and the resolved
    # ``variant`` string are host values fixed at capture (the engine
    # keys its graphs by geometry under one variant).
    ("fia_tpu_torch/influence/kernels/__init__.py", "fused_scores", (0, 1)),
    ("fia_tpu_torch/influence/kernels/__init__.py", "row_grads", (0,)),
    # The hand kernels' wrappers (each launches its CUDA kernel on the
    # capturing stream and counts the launch as captured) and their plain
    # versions (the capture's body under kernel="torch" on a card).
    ("fia_tpu_torch/influence/kernels/mf.py", "fused_scores"),
    ("fia_tpu_torch/influence/kernels/mf.py", "fused_scores_reference"),
    ("fia_tpu_torch/influence/kernels/ncf.py", "fused_scores"),
    ("fia_tpu_torch/influence/kernels/ncf.py", "fused_scores_reference"),
    ("fia_tpu_torch/influence/kernels/segment.py", "segment_sums", (5,)),
    ("fia_tpu_torch/influence/kernels/segment.py", "segment_sums_reference",
     (4, 5, 6, 7)),
    ("fia_tpu_torch/influence/kernels/certificate.py",
     "segment_certificate"),
    ("fia_tpu_torch/influence/kernels/eigmin.py", "block_eigmin"),
    # Shared score-epilogue helpers (``d`` is a geometry int).
    ("fia_tpu_torch/influence/kernels/common.py", "query_matrix"),
    ("fia_tpu_torch/influence/kernels/common.py", "score_epilogue", (4,)),
)

# FIA2xx: ``with`` context calls that record their block as a CUDA
# graph: torch's own, and the engine's wrapper of it (influence/engine.py
# ``capturing``, which pauses the cyclic collector around the capture).
CAPTURE_CONTEXT_CALLS = frozenset({
    "torch.cuda.graph",
    "capturing",
})

# FIA204: the registered dispatch hot path. These functions sit between
# "a batch of queries exists on the host" and "one fused device program
# runs"; the mega-batch design moves data host→device once per
# *dispatch*, never once per *query*. A transfer call lexically inside a
# Python loop in one of them reintroduces the per-query dispatch wall
# the fused path exists to kill. Entries are (path suffix, bare function
# name). The reference's ``_dispatch_flat_inner`` has no twin: the
# port's ``_dispatch_flat`` is one function (its body enqueues through
# ``_enqueue_flat``), so nothing is registered for it.
DISPATCH_PATH_FUNCTIONS = (
    ("fia_tpu_torch/influence/engine.py", "_dispatch_flat"),
    ("fia_tpu_torch/influence/engine.py", "_finalize_flat"),
    ("fia_tpu_torch/influence/engine.py", "query_many"),
    ("fia_tpu_torch/influence/engine.py", "_query_bank_hits"),
    ("fia_tpu_torch/serve/service.py", "_dispatch_misses"),
    ("fia_tpu_torch/serve/service.py", "drain"),
    ("fia_tpu_torch/serve/service.py", "_drain_impl"),
    # Host-sharded dispatch: the per-host shard compute and the
    # coordinator's journal merge sit on the same "queries exist → fused
    # program runs" path, one level up; a per-row transfer inside either
    # would reintroduce the dispatch wall across every host at once.
    ("fia_tpu_torch/serve/service.py", "_dispatch_hostshard"),
    ("fia_tpu_torch/serve/hostshard.py", "dispatch_local_shard"),
    ("fia_tpu_torch/serve/hostshard.py", "merge_host_shards"),
    # The sharded hot path's one sanctioned cross-device fetch: the
    # masked gather of per-query block rows out of the row-sharded tables,
    # whose partials move between devices by design. Registered so a
    # per-table *host* transfer inside it is a lint finding.
    ("fia_tpu_torch/parallel/sharded.py", "gather_table_rows"),
)

# Call names FIA204 treats as host→device transfer initiators when they
# appear inside a loop on the dispatch path: tensors made from host data
# (torch.as_tensor/torch.tensor), and put_global, the mesh-aware
# equivalent. ``.to(<device>)`` and ``.cuda()`` are transfers
# too when their receiver is host data (rules_trace decides that); on a
# device tensor they are device moves, which the sharded gather makes by
# design.
DISPATCH_TRANSFER_CALLS = frozenset({
    "torch.as_tensor",
    "torch.tensor",
    "put_global",
})

# FIA205: mesh-aware placement discipline on the same dispatch path. A
# bare ``torch.as_tensor(x, device=d)`` / ``x.to(d)`` of a batch-axis
# array in a registered dispatch-path function lands the WHOLE batch on
# one device — under a mesh that serializes every shard's work through
# it and silently undoes the query-axis sharding. Per-shard placement
# must go through the fia_tpu_torch/parallel helpers below.
MESH_PLACEMENT_HELPERS = frozenset({
    "put_global",
    "shard_along",
    "replicate",
})
# tensor constructors FIA205 inspects for a ``device=`` placement.
UNSHARDED_TRANSFER_CALLS = frozenset({
    "torch.as_tensor",
    "torch.tensor",
})

# FIA302 applies to files whose repo-relative path contains:
RELIABILITY_PREFIX = "fia_tpu_torch/reliability/"

# FIA302: exception types the reliability layer may raise. The four
# reliability-owned types are taxonomy-classifiable (or ARE the
# taxonomy); the builtins are programmer-contract errors that indicate
# a bug at the call site, not a runtime fault to classify.
RELIABILITY_RAISABLE = frozenset({
    "DeadlineExpired",
    "NanPayload",
    "ArtifactIntegrityError",
    "JournalMismatch",
    "UnfiredFaultError",
    "ValueError",
    "TypeError",
    "KeyError",
    "NotImplementedError",
    "AssertionError",
})

# FIA301/FIA303: where the site registry and its documentation live. The
# port's sites are the reference's, name for name, so the reference's
# table documents them (read, never edited).
SITES_MODULE = "fia_tpu_torch/reliability/sites.py"
SITES_DOC = "docs/reliability.md"

# FIA401: the emitted-schema and consumer declarations. The latency
# report reads the port's serving log under the same schema.
METRICS_MODULE = "fia_tpu_torch/serve/metrics.py"
METRICS_CONSUMER = "scripts/latency_report.py"
# Event-log calls checked against the schema are restricted to this
# subtree (EventLog is also used for training curves / bench logs whose
# ad-hoc events are not part of the serving contract).
METRICS_SCOPE = "fia_tpu_torch/serve/"
# Fields every EventLog record carries implicitly.
METRICS_IMPLICIT_FIELDS = frozenset({"t", "event"})

# FIA401 (obs extension): the tracing/metrics event schema is unioned
# with the serving SCHEMA for the producer-side checks, and every
# consumer below must declare a CONSUMES literal checked against that
# union (consumers are checked only when the file exists under the lint
# root).
OBS_MODULE = "fia_tpu_torch/obs/events.py"
OBS_CONSUMERS = (
    "scripts/latency_report.py",
    "fia_tpu_torch/cli/obs.py",
)

# ---------------------------------------------------------------------
# FIA5xx — call-graph determinism family. Sources are nondeterministic
# reads; sinks are the things the repo byte-pins (published artifacts,
# fingerprints, cache keys, metrics events, dispatch-path return
# values). The dataflow engine (analysis/dataflow.py) flags a source
# only when its value *reaches* a sink through the project call graph.
# ---------------------------------------------------------------------

# FIA501: draws through numpy's legacy global generator
# (np.random.rand & friends). The new-style Generator API is exempt
# when seeded — these attrs construct deterministic streams.
NP_RANDOM_DETERMINISTIC_ATTRS = frozenset({
    "default_rng", "Generator", "Philox", "PCG64", "PCG64DXSM",
    "MT19937", "SFC64", "SeedSequence", "BitGenerator", "RandomState",
})
# constructors that are deterministic ONLY when given a seed argument;
# the zero-argument form seeds from the OS and is a source.
RNG_SEEDED_CONSTRUCTORS = frozenset({
    "numpy.random.default_rng", "numpy.random.RandomState",
    "random.Random",
})
# stdlib ``random`` module-level draws (the hidden global Mersenne
# state; ``random.Random(seed).x()`` through an instance is fine).
RANDOM_MODULE_FNS = frozenset({
    "random", "randint", "randrange", "uniform", "choice", "choices",
    "sample", "shuffle", "getrandbits", "gauss", "normalvariate",
    "betavariate", "expovariate", "triangular", "vonmisesvariate",
    "paretovariate", "weibullvariate", "lognormvariate", "randbytes",
})
# torch's counterpart of the numpy and ``random`` rules: draws through
# torch's global generator — these functions without a ``generator=``
# argument — and a ``torch.Generator()`` never seeded (no
# ``.manual_seed(...)``), which draws from a default seed no caller
# pinned.
TORCH_RANDOM_FNS = frozenset({
    "torch.rand", "torch.randn", "torch.randint", "torch.randperm",
    "torch.normal", "torch.bernoulli", "torch.multinomial",
})
TORCH_GENERATOR = "torch.Generator"
TORCH_SEEDING_METHODS = frozenset({"manual_seed", "set_state"})
# unconditionally nondeterministic value reads.
ALWAYS_RANDOM_CALLS = frozenset({
    "uuid.uuid4", "uuid.uuid1", "secrets.token_bytes",
    "secrets.token_hex", "secrets.token_urlsafe", "secrets.randbelow",
    "os.urandom",
})

# FIA502: wall-clock reads. Production time flows through the
# injectable Clock seam (reliability/policy.py WALL/VirtualClock);
# reads through a clock *object* don't match here by construction
# (they resolve to the object attribute, not the time module), and the
# seam module itself — the one sanctioned place that touches
# time.monotonic — is exempted below.
WALLCLOCK_CALLS = frozenset({
    "time.time", "time.time_ns", "time.monotonic", "time.monotonic_ns",
    "time.perf_counter", "time.perf_counter_ns", "time.process_time",
    "datetime.datetime.now", "datetime.datetime.utcnow",
    "datetime.datetime.today", "datetime.date.today",
})
WALLCLOCK_SEAM_FILES = ("fia_tpu_torch/reliability/policy.py",)

# FIA503: arbitrarily-ordered filesystem enumerations (os.listdir
# order is filesystem-dependent; glob inherits it).
FS_ORDER_CALLS = frozenset({
    "os.listdir", "os.scandir", "os.walk", "glob.glob", "glob.iglob",
})
FS_ORDER_METHOD_ATTRS = frozenset({"iterdir", "rglob"})

# FIA506: process-varying identity/ordering primitives.
ID_HASH_CALLS = frozenset({"id", "hash"})

# Sanitizers. KILL_ORDER: result independent of argument *order*
# (kills FIA503/505/506-order taint, keeps FIA501/502 value taint —
# a sorted list of random numbers is still random). KILL_ALL: result
# deterministic regardless (shape/structure probes).
SANITIZE_ORDER_CALLS = frozenset({
    "sorted", "min", "max", "sum", "any", "all", "set", "frozenset",
    "collections.Counter", "Counter",
})
SANITIZE_ALL_CALLS = frozenset({
    "len", "isinstance", "hasattr", "callable", "type",
})

# Sink *functions*: project-internal defs whose arguments end up
# byte-pinned — matched through the call graph, so a transform wrapper,
# an import alias or a cross-module from-import still resolves to the
# registered sink. Entries are (path suffix, qualpath, description).
DETERMINISM_SINK_FUNCTIONS = (
    ("fia_tpu_torch/utils/io.py", "save_npz_atomic", "published artifact"),
    ("fia_tpu_torch/utils/io.py", "save_json_atomic", "published artifact"),
    ("fia_tpu_torch/utils/io.py", "save_text_atomic", "published artifact"),
    ("fia_tpu_torch/utils/io.py", "savetxt_atomic", "published artifact"),
    ("fia_tpu_torch/reliability/artifacts.py", "publish_npz",
     "published artifact"),
    ("fia_tpu_torch/reliability/artifacts.py", "canonical_fingerprint",
     "artifact fingerprint"),
    ("fia_tpu_torch/reliability/artifacts.py", "rewrite_fingerprint",
     "artifact fingerprint"),
    ("fia_tpu_torch/reliability/journal.py", "Journal.record",
     "journal entry"),
    ("fia_tpu_torch/reliability/journal.py", "Journal.open",
     "journal fingerprint"),
    ("fia_tpu_torch/serve/cache.py", "disk_put", "disk cache entry"),
    ("fia_tpu_torch/serve/cache.py", "disk_entry_path", "cache key path"),
    ("fia_tpu_torch/serve/cache.py", "disk_fingerprint",
     "cache fingerprint"),
    ("fia_tpu_torch/train/checkpoint.py", "save", "checkpoint artifact"),
    ("fia_tpu_torch/train/checkpoint.py", "save_rotated",
     "checkpoint artifact"),
)

# Name-based sink fallback for calls the graph cannot resolve to a
# project def (fixture trees without the io module, attribute calls on
# objects). Keys are the *last* component of the canonical callee.
DETERMINISM_SINK_CALL_NAMES = {
    "save_npz_atomic": "published artifact",
    "save_json_atomic": "published artifact",
    "save_text_atomic": "published artifact",
    "savetxt_atomic": "published artifact",
    "publish_npz": "published artifact",
    "canonical_fingerprint": "artifact fingerprint",
    "disk_put": "disk cache entry",
}

# Functions whose RETURN VALUE is byte-pinned (the sharded-vs-
# replicated identity contract pins exact bytes out of the dispatch
# path): a tainted return is a finding. Seeded from the FIA204/205
# dispatch registry; (path suffix, name) pairs.
DETERMINISM_SINK_RETURNS = DISPATCH_PATH_FUNCTIONS

# Metrics SCHEMA events (``*.log("event.name", field=...)``) are sinks
# for the ORDER/RNG rules only — wall-clock values flowing into events
# are the observability contract itself (``t`` is an implicit field),
# so FIA502 does not treat event emission as a sink.
METRICS_EVENT_SINK_RULES = frozenset({
    "FIA501", "FIA503", "FIA505", "FIA506",
})

# FIA402: bare ``print(`` is banned in library code under this prefix —
# stdout belongs to CLI mains (machine-readable JSON lines), and
# human-facing diagnostics must ride the obs spine
# (fia_tpu_torch.obs.diag: stderr + counter + span event) so they are
# never lost. Exemptions: CLI entry points own stdout; the linter's own
# terminal reporter is a CLI in all but path.
OBS_PRINT_SCOPE = "fia_tpu_torch/"
OBS_PRINT_EXEMPT_PREFIXES = (
    "fia_tpu_torch/cli/",
    "fia_tpu_torch/analysis/lint.py",
)

"""`fialint` for the port — repo-native static analysis of fia_tpu_torch.

The port's copy of ``fia_tpu/analysis``: the same AST lint engine
(`python -m fia_tpu_torch.analysis.lint`), rule ids, suppression syntax
and reporters, run under a port-local configuration
(:mod:`fia_tpu_torch.analysis.config`) whose allowlists and registries
name the port's modules. Its rules encode the invariants the port rides
on:

- **FIA101 raw-write discipline** — every persisted byte goes through
  `utils/io.py` / `reliability/artifacts.py` (the fsync'd-atomic +
  checksummed-manifest path); a raw `open(.., "w")` elsewhere is how
  caches get torn.
- **FIA201/202/203 capture hygiene** — host syncs, Python control flow
  on tensor values, and tensors a captured closure reads that are later
  replaced rather than copied into, inside programs captured as CUDA
  graphs: the hazards that either fail a capture or replay stale work.
  **FIA204/205** police the host-side dispatch path (per-query
  host→device transfers; placement outside the mesh helpers).
- **FIA301/302/303 fault-site integrity** — injection-site literals
  must resolve to the checked-in registry
  (`reliability/sites.py`), reliability-layer raises must be
  classifiable, and `docs/reliability.md` must document every site.
- **FIA401/402 metrics schema and stdout** — the serving and obs events
  against their declared consumers; no bare `print` in library code.
- **FIA501–506 determinism** — nondeterministic reads (unseeded numpy,
  `random` or torch generators, wall clocks, listing and set orders,
  `id`/`hash`) reaching byte-pinned sinks.

The rule catalog and suppression syntax are the reference's
(`docs/lint.md`, `# fialint: disable=FIA101 -- justification`); the
capture family's port meaning is in :mod:`~fia_tpu_torch.analysis.rules_trace`.
"""

from fia_tpu_torch.analysis.core import (  # noqa: F401
    Finding,
    LintResult,
    all_rules,
    lint_paths,
)

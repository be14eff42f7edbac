"""FIA501–FIA506 — the call-graph determinism family.

The repo's headline guarantees are bitwise: sharded == replicated to
the last mantissa bit, artifacts carry canonical fingerprints, cache
keys and journal entries replay byte-identically. Those contracts die
quietly when a nondeterministic value — an unseeded RNG draw, a
wall-clock read, an arbitrary listing order — leaks into something
byte-pinned, often through two or three intermediate calls where no
single function looks wrong. These six rules run the interprocedural
taint engine (:mod:`fia_tpu_torch.analysis.dataflow`) over the project call
graph (:mod:`fia_tpu_torch.analysis.callgraph`) and flag only *completed*
source→sink flows, with the call chain in the message:

- **FIA501 unseeded-rng-to-sink** — draws through numpy's legacy
  global generator (``np.random.rand``...), the stdlib ``random``
  module's hidden global state, zero-argument
  ``default_rng()``/``RandomState()``/``Random()``, torch's global
  generator (``torch.rand``/``randn``/``randint``/``randperm``/
  ``normal``/``bernoulli``/``multinomial`` without ``generator=``), a
  ``torch.Generator()`` never seeded, and entropy reads
  (``uuid.uuid4``, ``os.urandom``, ``secrets.*``) reaching a sink.
- **FIA502 wallclock-to-sink** — ``time.*``/``datetime.now`` reads
  outside the injectable Clock seam (``reliability/policy.py``)
  reaching a *byte-pinned* sink. Metrics events are exempt for this
  rule: timestamps in the event stream ARE the observability contract.
- **FIA503 fs-order-to-sink** — ``os.listdir``/``glob.glob``/
  ``Path.iterdir`` enumeration order (filesystem-dependent) reaching a
  sink unsorted. ``sorted()`` on the listing kills the taint.
- **FIA504 unsorted-json-keys** — ``json.dump`` without
  ``sort_keys=True`` (flagged directly: it writes persisted bytes by
  definition), and ``json.dumps`` without it whose string reaches a
  sink.
- **FIA505 set-order-to-sink** — iteration order of a ``set`` (hash-
  seed dependent) reaching a sink; ``sorted(the_set)`` is the fix.
- **FIA506 identity-ordering-to-sink** — ``id()``/``hash()``-derived
  values or ``sorted(..., key=id)`` orderings reaching a sink.

All six share ONE call-graph + dataflow run per lint invocation
(memoized on the :class:`~fia_tpu_torch.analysis.core.LintContext`).

Findings anchor at the SOURCE line, so a single justified
``# fialint: disable=FIA50x`` at the nondeterministic read suppresses
every chain that starts there — "suppress at the source propagates to
the chain". When only the *sink* line carries the suppression, the
finding re-anchors there instead, so either end of a flow is a valid
place to take responsibility for it.
"""

from __future__ import annotations

import ast

from fia_tpu_torch.analysis import core
from fia_tpu_torch.analysis.core import Finding, ProjectRule, SourceFile, register
from fia_tpu_torch.analysis.dataflow import DataflowEngine, Flow, has_sort_keys
from fia_tpu_torch.analysis.visitor import dotted_name


def _dataflow(files: list[SourceFile], root: str):
    """The invocation-shared (engine, flows) pair — one call-graph
    build and one taint fixpoint no matter how many FIA5xx rules run."""
    def build():
        engine = DataflowEngine(
            [sf for sf in files if sf.tree is not None], root
        )
        return engine, engine.run()

    ctx = core.current_context()
    if ctx is not None and ctx.root == root:
        return ctx.memo("determinism-dataflow", build)
    return build()


class _FlowRule(ProjectRule):
    """Shared runner: filter the flow set down to this rule's id and
    render findings with the source→sink chain in the message."""

    def check_project(self, files: list[SourceFile], root: str):
        _, flows = _dataflow(files, root)
        supp = {sf.rel: sf.suppressions for sf in files}
        return [
            self._finding(fl, supp) for fl in flows if fl.rule == self.id
        ]

    def _finding(self, fl: Flow, supp: dict) -> Finding:
        path, line, col = fl.source_rel, fl.source_line, fl.source_col
        at_source = self.id in supp.get(
            fl.source_rel, {}).get(fl.source_line, set())
        at_sink = self.id in supp.get(
            fl.sink_rel, {}).get(fl.sink_line, set())
        if at_sink and not at_source:
            # the sink line took responsibility for the flow: anchor
            # there so the core suppression machinery sees it
            path, line, col = fl.sink_rel, fl.sink_line, 0
        chain = " -> ".join(fl.chain)
        return Finding(
            self.id, path, line, col,
            f"{fl.desc} reaches {fl.sink_desc} at "
            f"{fl.sink_rel}:{fl.sink_line} (chain: {chain})",
        )


@register
class UnseededRngRule(_FlowRule):
    """Global/unseeded RNG draws must not reach byte-pinned outputs."""

    id = "FIA501"
    name = "unseeded-rng-to-sink"


@register
class WallclockRule(_FlowRule):
    """Wall-clock reads outside the Clock seam must not be byte-pinned."""

    id = "FIA502"
    name = "wallclock-to-sink"


@register
class FsOrderRule(_FlowRule):
    """Filesystem enumeration order must be sorted before it is pinned."""

    id = "FIA503"
    name = "fs-order-to-sink"


@register
class JsonSortKeysRule(_FlowRule):
    """Persisted JSON must pin key order with sort_keys=True."""

    id = "FIA504"
    name = "unsorted-json-keys"

    def check_project(self, files: list[SourceFile], root: str):
        # taint half: json.dumps strings that reach a sink
        findings = super().check_project(files, root)
        # direct half: json.dump writes persisted bytes by definition —
        # no flow analysis needed, the call site IS the sink
        engine, _ = _dataflow(files, root)
        for sf in files:
            if sf.tree is None:
                continue
            mi = engine.graph.modules.get(sf.rel)
            if mi is None:
                continue
            for node in ast.walk(sf.tree):
                if not isinstance(node, ast.Call):
                    continue
                name = dotted_name(node.func)
                if name is None:
                    continue
                if (engine.graph.canonical(mi, name) == "json.dump"
                        and not has_sort_keys(node)):
                    findings.append(Finding(
                        self.id, sf.rel, node.lineno, node.col_offset,
                        "json.dump without sort_keys=True — persisted "
                        "JSON key order follows dict construction order "
                        "and breaks byte-stable fingerprints",
                    ))
        return findings


@register
class SetOrderRule(_FlowRule):
    """Set iteration order (hash-seed dependent) must not be pinned."""

    id = "FIA505"
    name = "set-order-to-sink"


@register
class IdentityOrderRule(_FlowRule):
    """id()/hash()-derived orderings must not reach pinned outputs."""

    id = "FIA506"
    name = "identity-ordering-to-sink"

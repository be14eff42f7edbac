"""Source→sink determinism dataflow over the project call graph.

Every headline contract in this repo is a *determinism* contract —
sharded-vs-replicated bitwise identity, chunking-invariant reverse
top-k, replayable brownout ladders, pair-keyed reproducible sampling.
This engine is the static half of those contracts: it follows a value
from a nondeterministic read (an unseeded RNG draw, a wall-clock read
outside the Clock seam, an arbitrarily-ordered directory listing, a
``set`` iteration, an ``id()``/``hash()``-derived ordering) to a place
where the repo byte-pins bytes (published artifacts, journal and cache
fingerprints, metrics SCHEMA events, dispatch-path return values), and
reports the full call chain in between. A source that never reaches a
sink is *not* a finding — timing a solve for a log line is fine;
letting that timestamp into a fingerprinted artifact is not.

Architecture (docs/design.md §24):

- per-function **taint pass**: a source-order walk of one function
  body tracking which local names carry which taints. Assignments
  propagate, ``sorted()``/``min``/``len``-style calls sanitize
  (order-taints die at ``sorted``, value-taints like an RNG draw
  survive it), container mutations (``xs.append(tainted)``) taint the
  container.
- per-function **summary**: which taints escape through ``return``,
  which parameters pass through to the return value, and which
  parameters reach a sink inside the function (transitively).
- **fixpoint** over the call graph: summaries start empty and the
  passes repeat until no summary changes, so a chain
  ``a() → b() → c() → publish`` converges regardless of definition
  order. Flows are collected on the stable final pass.

Taint *kinds*: ``order`` (FIA503/505 and the ``key=id`` half of 506 —
the multiset of values is fine, their order is not; killed by
``sorted()``) and ``value`` (FIA501/502/504/506 — the bytes themselves
vary; survive sorting).

Known limits, by design (the engine is stdlib-``ast`` only, no type
inference): instance attributes are tracked only as whole-``self``
taint, implicit flows through comparisons/branch conditions are not
tracked, and subscripted callees (``self._graphs[k](...)``) do not
resolve — the conservative fallback passes argument taint through
unresolved calls.
"""

from __future__ import annotations

import ast
from collections import deque
from dataclasses import dataclass, replace

from fia_tpu_torch.analysis import config
from fia_tpu_torch.analysis.callgraph import CallGraph, FuncDef
from fia_tpu_torch.analysis.core import SourceFile
from fia_tpu_torch.analysis.visitor import dotted_name

MAX_PASSES = 8
MAX_CHAIN = 8

ORDER = "order"
VALUE = "value"


@dataclass(frozen=True)
class Tag:
    """One live taint: which rule, where it was born, how it travelled."""

    rule: str
    kind: str            # ORDER or VALUE
    origin_rel: str
    origin_line: int
    origin_col: int
    desc: str            # e.g. "numpy.random.rand (global RNG draw)"
    via: tuple[str, ...]  # function displays, origin first


@dataclass(frozen=True)
class ParamTaint:
    """Placeholder taint seeded on parameter ``index`` to discover
    passthrough and param→sink behavior for the summary."""

    index: int


@dataclass(frozen=True)
class SinkRef:
    """A sink reachable from a parameter, for function summaries."""

    desc: str
    rel: str
    line: int
    path: tuple[str, ...]  # function displays from the summarised fn in


@dataclass(frozen=True)
class Summary:
    returns: frozenset      # of Tag
    passthrough: frozenset  # of int (param index flows to return)
    param_sinks: frozenset  # of (int, SinkRef)


EMPTY_SUMMARY = Summary(frozenset(), frozenset(), frozenset())


@dataclass(frozen=True)
class Flow:
    """One complete source→sink path (pre-Finding; the FIA5xx rules
    convert these, choosing the anchor line suppression-aware)."""

    rule: str
    source_rel: str
    source_line: int
    source_col: int
    desc: str
    sink_desc: str
    sink_rel: str
    sink_line: int
    chain: tuple[str, ...]


UNSEEDED_GENERATOR = "torch.Generator() never seeded"


def _unseeded_generator(t) -> bool:
    return isinstance(t, Tag) and t.desc == UNSEEDED_GENERATOR


def has_sort_keys(call: ast.Call) -> bool:
    """True when a json.dump/json.dumps call pins key order."""
    for kw in call.keywords:
        if kw.arg == "sort_keys":
            return not (isinstance(kw.value, ast.Constant)
                        and kw.value.value is False)
        if kw.arg is None:
            return True  # **kwargs may carry it: benefit of the doubt
    return False


def _extend_via(tag: Tag, name: str) -> Tag:
    if tag.via and tag.via[-1] == name:
        return tag
    if len(tag.via) >= MAX_CHAIN:
        return tag
    return replace(tag, via=tag.via + (name,))


def _real(tags) -> set:
    return {t for t in tags if isinstance(t, Tag)}


def _dedup_tags(tags) -> frozenset:
    """Collapse via-variants of the same logical taint to the shortest
    chain. Without this, call cycles mint a new variant per fixpoint
    round and summaries never stabilise."""
    best: dict[tuple, Tag] = {}
    for t in tags:
        k = (t.rule, t.kind, t.origin_rel, t.origin_line,
             t.origin_col, t.desc)
        cur = best.get(k)
        if cur is None or (len(t.via), t.via) < (len(cur.via), cur.via):
            best[k] = t
    return frozenset(best.values())


def _dedup_sinks(pairs) -> frozenset:
    """Same normalisation for (param index, SinkRef) summary entries."""
    best: dict[tuple, tuple] = {}
    for i, s in pairs:
        k = (i, s.desc, s.rel, s.line)
        cur = best.get(k)
        if cur is None or (
            (len(s.path), s.path) < (len(cur[1].path), cur[1].path)
        ):
            best[k] = (i, s)
    return frozenset(best.values())


class _FunctionPass:
    """One taint pass over one function body."""

    def __init__(self, engine: "DataflowEngine", fd: FuncDef,
                 collect: bool):
        self.e = engine
        self.fd = fd
        self.collect = collect
        self.env: dict[str, set] = {}
        self.set_vars: set[str] = set()
        self.local_aliases: dict[str, FuncDef] = {}
        self.returns: set = set()
        self.passthrough: set[int] = set()
        self.param_sinks: set[tuple[int, SinkRef]] = set()
        self.flows: list[Flow] = []
        params = fd.param_names()
        self.param_index = {p: i for i, p in enumerate(params)}
        for p, i in self.param_index.items():
            self.env[p] = {ParamTaint(i)}

    # -- run -----------------------------------------------------------

    def run(self) -> Summary:
        for stmt in self.fd.body_statements():
            self.stmt(stmt)
        return Summary(
            returns=_dedup_tags(_real(self.returns)),
            passthrough=frozenset(
                t.index for t in self.returns if isinstance(t, ParamTaint)
            ),
            param_sinks=_dedup_sinks(self.param_sinks),
        )

    # -- statements ----------------------------------------------------

    def stmt(self, node: ast.stmt) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return  # analysed as their own FuncDefs
        if isinstance(node, ast.Assign):
            taints = self.expr(node.value)
            is_set = self.expr_is_set(node.value)
            for tgt in node.targets:
                self.assign_target(tgt, taints, is_set, strong=True)
            if (len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)):
                target_fd = self.e.graph.resolve_value(self.fd, node.value)
                if target_fd is not None:
                    self.local_aliases[node.targets[0].id] = target_fd
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            self.assign_target(node.target, self.expr(node.value),
                               self.expr_is_set(node.value), strong=True)
        elif isinstance(node, ast.AugAssign):
            taints = self.expr(node.value)
            self.assign_target(node.target, taints,
                               self.expr_is_set(node.value), strong=False)
        elif isinstance(node, ast.Return):
            if node.value is not None:
                taints = self.expr(node.value)
                self.returns |= taints
                self.check_return_sink(node, taints)
        elif isinstance(node, (ast.For, ast.AsyncFor)):
            taints = self.expr(node.iter) | self.iteration_tags(node.iter)
            self.assign_target(node.target, taints, False, strong=False)
            for s in node.body + node.orelse:
                self.stmt(s)
        elif isinstance(node, ast.While):
            self.expr(node.test)
            for s in node.body + node.orelse:
                self.stmt(s)
        elif isinstance(node, ast.If):
            self.expr(node.test)
            for s in node.body + node.orelse:
                self.stmt(s)
        elif isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                taints = self.expr(item.context_expr)
                if item.optional_vars is not None:
                    self.assign_target(item.optional_vars, taints, False,
                                       strong=True)
            for s in node.body:
                self.stmt(s)
        elif isinstance(node, ast.Try):
            for s in node.body:
                self.stmt(s)
            for h in node.handlers:
                for s in h.body:
                    self.stmt(s)
            for s in node.orelse + node.finalbody:
                self.stmt(s)
        elif isinstance(node, ast.Expr):
            self.expr(node.value)
        elif isinstance(node, (ast.Raise, ast.Assert)):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.expr):
                    self.expr(child)

    def assign_target(self, tgt: ast.AST, taints: set, is_set: bool,
                      strong: bool) -> None:
        if isinstance(tgt, ast.Name):
            if strong:
                self.env[tgt.id] = set(taints)
                self.set_vars.discard(tgt.id)
            else:
                self.env.setdefault(tgt.id, set()).update(taints)
            if is_set:
                self.set_vars.add(tgt.id)
        elif isinstance(tgt, (ast.Tuple, ast.List)):
            for el in tgt.elts:
                self.assign_target(el, taints, False, strong=strong)
        elif isinstance(tgt, ast.Starred):
            self.assign_target(tgt.value, taints, False, strong=strong)
        elif isinstance(tgt, (ast.Attribute, ast.Subscript)):
            # self.x = tainted / d[k] = tainted: taint the container
            root = tgt
            while isinstance(root, (ast.Attribute, ast.Subscript)):
                root = root.value
            if isinstance(root, ast.Name):
                self.env.setdefault(root.id, set()).update(taints)

    # -- expressions ---------------------------------------------------

    def expr(self, node: ast.AST) -> set:
        if node is None:
            return set()
        if isinstance(node, ast.Call):
            return self.call(node)
        if isinstance(node, ast.Name):
            return set(self.env.get(node.id, ()))
        if isinstance(node, ast.Attribute):
            return self.expr(node.value)
        if isinstance(node, ast.Await):
            return self.expr(node.value)
        if isinstance(node, ast.Subscript):
            return self.expr(node.value) | self.expr(node.slice)
        if isinstance(node, ast.BinOp):
            return self.expr(node.left) | self.expr(node.right)
        if isinstance(node, ast.BoolOp):
            out: set = set()
            for v in node.values:
                out |= self.expr(v)
            return out
        if isinstance(node, ast.UnaryOp):
            return self.expr(node.operand)
        if isinstance(node, ast.Compare):
            # a comparison's bool is insensitive to order/identity
            # taint; still walk operands so nested calls are processed
            self.expr(node.left)
            for c in node.comparators:
                self.expr(c)
            return set()
        if isinstance(node, ast.IfExp):
            self.expr(node.test)
            return self.expr(node.body) | self.expr(node.orelse)
        if isinstance(node, (ast.List, ast.Tuple, ast.Set)):
            out = set()
            for el in node.elts:
                out |= self.expr(el)
            return out
        if isinstance(node, ast.Dict):
            out = set()
            for k in node.keys:
                if k is not None:
                    out |= self.expr(k)
            for v in node.values:
                out |= self.expr(v)
            return out
        if isinstance(node, (ast.JoinedStr, ast.FormattedValue)):
            out = set()
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.expr):
                    out |= self.expr(child)
            return out
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp,
                             ast.DictComp)):
            out = set()
            for gen in node.generators:
                taints = self.expr(gen.iter) | self.iteration_tags(gen.iter)
                self.assign_target(gen.target, taints, False, strong=False)
                out |= taints
                for cond in gen.ifs:
                    self.expr(cond)
            if isinstance(node, ast.DictComp):
                out |= self.expr(node.key) | self.expr(node.value)
            else:
                out |= self.expr(node.elt)
            return out
        if isinstance(node, ast.Starred):
            return self.expr(node.value)
        if isinstance(node, ast.NamedExpr):
            taints = self.expr(node.value)
            self.assign_target(node.target, taints,
                               self.expr_is_set(node.value), strong=True)
            return taints
        if isinstance(node, (ast.Constant, ast.Lambda)):
            return set()
        # conservative default: union over expression children
        out = set()
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.expr):
                out |= self.expr(child)
        return out

    def expr_is_set(self, node: ast.AST) -> bool:
        if isinstance(node, (ast.Set, ast.SetComp)):
            return True
        if isinstance(node, ast.Name):
            return node.id in self.set_vars
        if isinstance(node, ast.Call):
            cn = self.canonical_name(node)
            return cn in ("set", "frozenset")
        if isinstance(node, ast.BinOp) and isinstance(
            node.op, (ast.BitOr, ast.BitAnd, ast.Sub, ast.BitXor)
        ):
            return (self.expr_is_set(node.left)
                    or self.expr_is_set(node.right))
        return False

    def iteration_tags(self, iter_expr: ast.AST) -> set:
        """Extra taint born from *iterating* the expression: set
        iteration order is interpreter/hash-seed dependent. (Dict
        iteration is insertion-ordered and therefore fine; fs-listing
        calls tag their result at the call itself.)"""
        if self.expr_is_set(iter_expr):
            return {self.tag("FIA505", ORDER, iter_expr,
                             "set iteration order")}
        return set()

    def canonical_name(self, call: ast.Call) -> str | None:
        mi = self.e.graph.modules.get(self.fd.rel)
        name = dotted_name(call.func)
        if name is None or mi is None:
            return name
        return self.e.graph.canonical(mi, name)

    def tag(self, rule: str, kind: str, node: ast.AST, desc: str) -> Tag:
        return Tag(
            rule=rule, kind=kind, origin_rel=self.fd.rel,
            origin_line=getattr(node, "lineno", 1),
            origin_col=getattr(node, "col_offset", 0),
            desc=desc, via=(self.fd.display,),
        )

    # -- calls ---------------------------------------------------------

    def call(self, call: ast.Call) -> set:
        arg_taints = [self.expr(a) for a in call.args]
        kw_taints = {kw.arg: self.expr(kw.value) for kw in call.keywords}
        all_args: set = set()
        for t in arg_taints:
            all_args |= t
        for t in kw_taints.values():
            all_args |= t
        obj_taints: set = set()
        if isinstance(call.func, ast.Attribute):
            obj_taints = self.expr(call.func.value)

        target_fd, canonical = self.e.graph.resolve_call(
            self.fd, call, self.local_aliases
        )
        if target_fd is not None:
            # reverse edge for the worklist: when the callee's summary
            # changes, this function must be re-analysed
            self.e.callers.setdefault(target_fd.qual, set()).add(
                self.fd.qual
            )
        attr = call.func.attr if isinstance(
            call.func, ast.Attribute) else None

        # sources -----------------------------------------------------
        src = self.source_tag(call, canonical, attr)
        if src is not None:
            return all_args | obj_taints | {src}

        # sanitizers --------------------------------------------------
        if canonical in config.SANITIZE_ALL_CALLS:
            return set()
        if canonical in config.SANITIZE_ORDER_CALLS or attr == "sort":
            out = {t for t in all_args | obj_taints
                   if not (isinstance(t, Tag) and t.kind == ORDER)}
            key_tag = self.key_identity_tag(call)
            if key_tag is not None:
                out.add(key_tag)
                if attr == "sort":
                    self.mutate_object(call, {key_tag})
            return out

        # seeding: g.manual_seed(s) pins a torch.Generator ------------
        if attr in config.TORCH_SEEDING_METHODS:
            self.reseed_object(call)
            return {t for t in obj_taints
                    if not _unseeded_generator(t)} | all_args

        # container mutation: xs.append(tainted) taints xs ------------
        if attr in ("append", "add", "extend", "insert", "update",
                    "setdefault", "appendleft", "push"):
            self.mutate_object(call, all_args)

        result = all_args | obj_taints

        # project-internal summary application ------------------------
        if target_fd is not None:
            summary = self.e.summaries.get(target_fd.qual, EMPTY_SUMMARY)
            params = target_fd.param_names()
            offset = 1 if params[:1] == ["self"] else 0
            index_of = {p: i for i, p in enumerate(params)}
            mapped: dict[int, set] = {}
            for pos, taints in enumerate(arg_taints):
                mapped[pos + offset] = taints
            for name, taints in kw_taints.items():
                if name in index_of:
                    mapped[index_of[name]] = taints
            # resolved calls get the precise summary, not the blanket
            # arg passthrough (obj taint stays: instance state)
            result = set(obj_taints)
            for t in summary.returns:
                result.add(_extend_via(t, self.fd.display))
            for i in summary.passthrough:
                result |= mapped.get(i, set())
            for i, sink in summary.param_sinks:
                for t in mapped.get(i, ()):
                    if isinstance(t, Tag):
                        self.emit(t, sink.desc, sink.rel, sink.line,
                                  extra_path=sink.path)
                    elif isinstance(t, ParamTaint):
                        # cycle/depth guard: don't extend a path that
                        # already passed through this function or is
                        # at the chain cap
                        if (self.fd.display in sink.path
                                or len(sink.path) >= MAX_CHAIN):
                            continue
                        self.param_sinks.add((t.index, SinkRef(
                            desc=sink.desc, rel=sink.rel, line=sink.line,
                            path=(self.fd.display,) + sink.path,
                        )))

        # sink checks -------------------------------------------------
        sink_desc = self.sink_desc(target_fd, canonical)
        if sink_desc is not None:
            self.record_sink_args(call, all_args, sink_desc)
        event = self.metrics_event(call)
        if event is not None:
            self.record_sink_args(
                call, all_args, f"metrics event {event!r}",
                rules=config.METRICS_EVENT_SINK_RULES,
            )
        return result

    def source_tag(self, call: ast.Call, canonical: str | None,
                   attr: str | None) -> Tag | None:
        if canonical is None:
            if attr in config.FS_ORDER_METHOD_ATTRS:
                return self.tag("FIA503", ORDER, call,
                                f".{attr}() listing order")
            return None
        if canonical in config.ALWAYS_RANDOM_CALLS:
            return self.tag("FIA501", VALUE, call,
                            f"{canonical} (entropy read)")
        if canonical.startswith("numpy.random."):
            tail = canonical.rsplit(".", 1)[-1]
            if tail not in config.NP_RANDOM_DETERMINISTIC_ATTRS:
                return self.tag("FIA501", VALUE, call,
                                f"{canonical} (global RNG draw)")
        if (canonical in config.RNG_SEEDED_CONSTRUCTORS
                and not call.args and not call.keywords):
            return self.tag("FIA501", VALUE, call,
                            f"{canonical}() without a seed")
        if (canonical in config.TORCH_RANDOM_FNS
                and not any(kw.arg == "generator" for kw in call.keywords)):
            return self.tag("FIA501", VALUE, call,
                            f"{canonical} (global RNG draw)")
        if canonical == config.TORCH_GENERATOR:
            return self.tag("FIA501", VALUE, call, UNSEEDED_GENERATOR)
        if (canonical.count(".") == 1
                and canonical.startswith("random.")
                and canonical.split(".")[1] in config.RANDOM_MODULE_FNS):
            return self.tag("FIA501", VALUE, call,
                            f"{canonical} (global RNG draw)")
        if canonical in config.WALLCLOCK_CALLS:
            if not self.fd.rel.endswith(config.WALLCLOCK_SEAM_FILES):
                return self.tag("FIA502", VALUE, call,
                                f"{canonical} (wall-clock read)")
        if canonical in config.FS_ORDER_CALLS:
            return self.tag("FIA503", ORDER, call,
                            f"{canonical} (filesystem enumeration "
                            "order)")
        if canonical in config.ID_HASH_CALLS and call.args:
            return self.tag("FIA506", VALUE, call,
                            f"{canonical}() (process-varying value)")
        if canonical == "json.dumps" and not has_sort_keys(call):
            return self.tag("FIA504", VALUE, call,
                            "json.dumps without sort_keys=True")
        return None

    def key_identity_tag(self, call: ast.Call) -> Tag | None:
        """``sorted(xs, key=id)`` orders by process-varying identity."""
        for kw in call.keywords:
            if kw.arg == "key" and dotted_name(kw.value) in (
                config.ID_HASH_CALLS
            ):
                return self.tag(
                    "FIA506", ORDER, call,
                    f"ordering by {dotted_name(kw.value)}()",
                )
        return None

    def reseed_object(self, call: ast.Call) -> None:
        """``g.manual_seed(s)``: ``g`` no longer draws from a seed no
        caller pinned (strong update of the receiver's taint)."""
        root = call.func.value
        if isinstance(root, ast.Name) and root.id in self.env:
            self.env[root.id] = {t for t in self.env[root.id]
                                 if not _unseeded_generator(t)}

    def mutate_object(self, call: ast.Call, taints: set) -> None:
        root = call.func
        while isinstance(root, (ast.Attribute, ast.Subscript)):
            root = root.value
        if isinstance(root, ast.Name) and taints:
            self.env.setdefault(root.id, set()).update(taints)

    def sink_desc(self, target_fd: FuncDef | None,
                  canonical: str | None) -> str | None:
        if target_fd is not None:
            desc = self.e.sink_functions.get(target_fd.qual)
            if desc is not None:
                return desc
            return None
        if canonical is not None:
            tail = canonical.rsplit(".", 1)[-1]
            return config.DETERMINISM_SINK_CALL_NAMES.get(tail)
        return None

    @staticmethod
    def metrics_event(call: ast.Call) -> str | None:
        if (isinstance(call.func, ast.Attribute)
                and call.func.attr == "log" and call.args
                and isinstance(call.args[0], ast.Constant)
                and isinstance(call.args[0].value, str)
                and "." in call.args[0].value):
            return call.args[0].value
        return None

    def record_sink_args(self, call: ast.Call, all_args: set,
                         desc: str, rules=None) -> None:
        for t in all_args:
            if isinstance(t, Tag):
                if rules is not None and t.rule not in rules:
                    continue
                self.emit(t, desc, self.fd.rel, call.lineno)
            elif isinstance(t, ParamTaint) and rules is None:
                self.param_sinks.add((t.index, SinkRef(
                    desc=desc, rel=self.fd.rel, line=call.lineno,
                    path=(self.fd.display,),
                )))

    def check_return_sink(self, node: ast.Return, taints: set) -> None:
        if self.fd.qual not in self.e.return_sinks:
            return
        desc = (f"byte-pinned return of dispatch-path function "
                f"{self.fd.display!r}")
        for t in taints:
            if isinstance(t, Tag):
                self.emit(t, desc, self.fd.rel, node.lineno)
            elif isinstance(t, ParamTaint):
                self.param_sinks.add((t.index, SinkRef(
                    desc=desc, rel=self.fd.rel, line=node.lineno,
                    path=(self.fd.display,),
                )))

    def emit(self, tag: Tag, sink_desc: str, sink_rel: str,
             sink_line: int, extra_path: tuple[str, ...] = ()) -> None:
        if not self.collect:
            return
        chain = tag.via
        for name in (self.fd.display,) + extra_path:
            if not chain or chain[-1] != name:
                chain = chain + (name,)
        self.flows.append(Flow(
            rule=tag.rule, source_rel=tag.origin_rel,
            source_line=tag.origin_line, source_col=tag.origin_col,
            desc=tag.desc, sink_desc=sink_desc, sink_rel=sink_rel,
            sink_line=sink_line, chain=chain[:MAX_CHAIN],
        ))


class DataflowEngine:
    """The fixpoint loop: summaries to a fixpoint via a worklist,
    then one collecting pass."""

    def __init__(self, files: list[SourceFile], root: str):
        self.graph = CallGraph(files)
        self.root = root
        self.summaries: dict[str, Summary] = {}
        self.callers: dict[str, set[str]] = {}  # callee qual -> callers
        self.sink_functions: dict[str, str] = {}
        self.return_sinks: set[str] = set()
        for fd in self.graph.functions:
            for path, qual, desc in config.DETERMINISM_SINK_FUNCTIONS:
                if fd.rel.endswith(path) and fd.qualpath == qual:
                    self.sink_functions[fd.qual] = desc
            for path, name in config.DETERMINISM_SINK_RETURNS:
                if fd.rel.endswith(path) and (
                    fd.qualpath.rsplit(".", 1)[-1] == name
                ):
                    self.return_sinks.add(fd.qual)

    def run(self) -> list[Flow]:
        # phase 1: summaries to a fixpoint. The worklist starts with
        # every function once and re-enqueues only the callers of a
        # function whose summary changed — most summaries stabilise on
        # the first visit, so this beats whole-project passes by a
        # large margin on a real tree.
        by_qual = {fd.qual: fd for fd in self.graph.functions}
        work = deque(self.graph.functions)
        queued = {fd.qual for fd in self.graph.functions}
        budget = len(self.graph.functions) * MAX_PASSES
        while work and budget > 0:
            budget -= 1
            fd = work.popleft()
            queued.discard(fd.qual)
            summary = _FunctionPass(self, fd, collect=False).run()
            if self.summaries.get(fd.qual, EMPTY_SUMMARY) != summary:
                self.summaries[fd.qual] = summary
                for caller in self.callers.get(fd.qual, ()):
                    if caller not in queued and caller in by_qual:
                        queued.add(caller)
                        work.append(by_qual[caller])
        # phase 2: one collecting pass with stable summaries
        flows: list[Flow] = []
        for fd in self.graph.functions:
            fp = _FunctionPass(self, fd, collect=True)
            fp.run()
            flows.extend(fp.flows)
        seen = set()
        out = []
        for f in flows:
            key = (f.rule, f.source_rel, f.source_line, f.source_col,
                   f.sink_rel, f.sink_line, f.sink_desc)
            if key not in seen:
                seen.add(key)
                out.append(f)
        out.sort(key=lambda f: (f.source_rel, f.source_line,
                                f.source_col, f.rule, f.sink_rel,
                                f.sink_line))
        return out


def analyze(files: list[SourceFile], root: str) -> list[Flow]:
    """All source→sink determinism flows in the file set."""
    return DataflowEngine(files, root).run()

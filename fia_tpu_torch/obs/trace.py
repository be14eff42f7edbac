"""Deterministic request tracing: TraceContext + spans (copy of
``fia_tpu/obs/trace.py``).

A *trace* is one causal story (one query batch, one request, one
streaming update); a *span* is one timed stage inside it. Ids are
**derived, not random**: ``trace_id_for(seed)`` hashes a stable seed
(the request id, the update id) and span ids are ``<trace>.<seq>``
with ``seq`` assigned in creation order — so two runs of the same
traffic produce identical ids whether or not tracing was on.

Propagation is a contextvar (`_CUR`), so nested ``with span(...)``
blocks parent correctly through the engine→dispatch→solver call stack
without any plumbing through signatures. When tracing is disabled
(the default for raw library use) ``span`` and ``trace`` return one
shared no-op context manager that yields the shared no-op span: no
allocation, no clock read. Spans time the host: a span around an
enqueue on the card ends when the work is queued, not when it has run.

While tracing is on and a ``torch.profiler`` is recording, each span
also enters ``torch.profiler.record_function(<span name>)`` for its
duration, so it appears in the profiler's trace as a
``user_annotation`` on the clock of the device's kernels and copies.
With no profiler recording, no range is entered.
"""

from __future__ import annotations

import contextvars
import hashlib
import sys
import time
from collections import deque
from contextlib import contextmanager


def trace_id_for(seed: str) -> str:
    """16-hex-char trace id, deterministic in the seed."""
    return hashlib.sha1(seed.encode()).hexdigest()[:16]


class Span:
    """One timed stage. Mutable until its ``with`` block exits."""

    __slots__ = ("trace_id", "seq", "parent_seq", "name",
                 "t0", "t1", "attrs", "events")

    def __init__(self, trace_id: str, seq: int, parent_seq: int | None,
                 name: str, t0: float):
        self.trace_id = trace_id
        self.seq = seq
        self.parent_seq = parent_seq
        self.name = name
        self.t0 = t0
        self.t1 = t0
        self.attrs: dict = {}
        self.events: list = []

    @property
    def span_id(self) -> str:
        return f"{self.trace_id}.{self.seq}"

    @property
    def parent_id(self) -> str | None:
        if self.parent_seq is None:
            return None
        return f"{self.trace_id}.{self.parent_seq}"

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def event(self, name: str, **attrs) -> None:
        """Zero-duration marker attached to this span."""
        self.events.append({"name": name,
                            "dt_us": round((time.time() - self.t0) * 1e6, 1),
                            **attrs})


class _NoopSpan:
    """Accepts the full Span surface, does nothing. Shared singleton."""

    __slots__ = ()
    trace_id = ""
    seq = -1
    parent_seq = None
    name = ""
    span_id = ""
    parent_id = None

    def set(self, **attrs) -> None:
        pass

    def event(self, name: str, **attrs) -> None:
        pass


NOOP_SPAN = _NoopSpan()


class _NoopContext:
    """``with`` of a disabled span or trace: yields ``NOOP_SPAN``.
    Shared singleton."""

    __slots__ = ()

    def __enter__(self):
        return NOOP_SPAN

    def __exit__(self, *exc) -> bool:
        return False


NOOP_CONTEXT = _NoopContext()


def _profiler_range(name: str):
    """An entered ``torch.profiler.record_function(name)`` while a torch
    profiler records, else ``None``. A process that never imported torch
    runs no profiler, so this imports nothing."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.autograd.profiler._is_profiler_enabled:
        return None
    rf = torch.profiler.record_function(name)
    rf.__enter__()
    return rf


class _Ctx:
    """Per-trace mutable state carried by the contextvar."""

    __slots__ = ("trace_id", "next_seq", "current")

    def __init__(self, trace_id: str):
        self.trace_id = trace_id
        self.next_seq = 0
        self.current: Span | None = None


_CUR: contextvars.ContextVar[_Ctx | None] = contextvars.ContextVar(
    "fia_obs_ctx", default=None)


class Tracer:
    """Collects finished spans into a bounded ring + an export queue.

    ``spans`` keeps the last ``max_spans`` for in-process inspection
    (tests, scripts); ``flush()`` drains the export queue, whose spans a
    host writes out as ``obs.span`` JSONL lines.
    """

    def __init__(self, enabled: bool = False, max_spans: int = 4096):
        self.enabled = enabled
        self.spans: deque[Span] = deque(maxlen=max_spans)
        self._pending: deque[Span] = deque(maxlen=65536)
        self._anon = 0  # anonymous-trace counter (deterministic order)

    # -- trace / span entry points -----------------------------------

    def trace(self, seed: str):
        """Open a fresh trace context derived from ``seed``."""
        if not self.enabled:
            return NOOP_CONTEXT
        return self._trace(seed)

    @contextmanager
    def _trace(self, seed: str):
        tok = _CUR.set(_Ctx(trace_id_for(seed)))
        try:
            yield NOOP_SPAN
        finally:
            _CUR.reset(tok)

    def span(self, name: str, trace_seed: str | None = None, **attrs):
        """Timed stage under the current trace (opens an anonymous
        deterministic trace when none is active)."""
        if not self.enabled:
            return NOOP_CONTEXT
        return self._span(name, trace_seed, attrs)

    @contextmanager
    def _span(self, name: str, trace_seed: str | None, attrs: dict):
        ctx = _CUR.get()
        tok = None
        if ctx is None:
            if trace_seed is None:
                self._anon += 1
                trace_seed = f"{name}-{self._anon}"
            ctx = _Ctx(trace_id_for(trace_seed))
            tok = _CUR.set(ctx)
        parent = ctx.current
        sp = Span(ctx.trace_id, ctx.next_seq,
                  parent.seq if parent is not None else None,
                  name, time.time())
        ctx.next_seq += 1
        if attrs:
            sp.attrs.update(attrs)
        ctx.current = sp
        rf = _profiler_range(name)
        try:
            yield sp
        finally:
            if rf is not None:
                rf.__exit__(None, None, None)
            sp.t1 = time.time()
            ctx.current = parent
            self._finish(sp)
            if tok is not None:
                _CUR.reset(tok)

    def record(self, trace_id: str, name: str, t0: float, t1: float,
               seq: int, parent_seq: int | None = None,
               **attrs) -> Span:
        """Retroactively record a finished span with explicit times — a
        serving layer rebuilds each request's admit→queue→batch chain at
        resolve time from the latencies it already tracks."""
        if not self.enabled:
            return NOOP_SPAN
        sp = Span(trace_id, seq, parent_seq, name, t0)
        sp.t1 = t1
        if attrs:
            sp.attrs.update(attrs)
        self._finish(sp)
        return sp

    def current_span(self):
        if not self.enabled:
            return NOOP_SPAN
        ctx = _CUR.get()
        if ctx is None or ctx.current is None:
            return NOOP_SPAN
        return ctx.current

    # -- collection ---------------------------------------------------

    def _finish(self, sp: Span) -> None:
        self.spans.append(sp)
        self._pending.append(sp)

    def flush(self) -> list[Span]:
        """Drain and return spans queued since the last flush."""
        out = []
        while self._pending:
            out.append(self._pending.popleft())
        return out

    def reset(self) -> None:
        self.spans.clear()
        self._pending.clear()
        self._anon = 0


# The process-wide tracer (disabled until a host opts in).
TRACER = Tracer()


def configure(trace: bool | None = None) -> None:
    """Toggle tracing process-wide (a host that exports spans calls
    this)."""
    if trace is not None:
        TRACER.enabled = bool(trace)


def tracing_enabled() -> bool:
    return TRACER.enabled


# the process-wide tracer's entry points, bound: a disabled span costs one
# call and one attribute read
span = TRACER.span
trace = TRACER.trace


def current_span():
    return TRACER.current_span()


def event(name: str, **attrs) -> None:
    """Attach a marker to the current span (no-op outside any span)."""
    TRACER.current_span().event(name, **attrs)

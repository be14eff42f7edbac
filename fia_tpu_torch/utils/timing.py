"""Timing helpers (port of ``fia_tpu/utils/timing.py``).

The reference benchmarks with bare ``time.time()`` prints around
``sess.run`` calls (``matrix_factorization.py:216-250``). CUDA launches
return before the card has run them, so a host clock alone measures the
enqueue; these helpers fence on the card, and can record a
``torch.profiler`` trace.
"""

from __future__ import annotations

import contextlib
import time

import torch

from fia_tpu_torch import obs


def _devices_of(out) -> set:
    """The CUDA devices holding the tensors of ``out`` (a tensor or a
    nest of tuples, lists and dict values)."""
    found = set()
    stack = [out]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            if x.device.type == "cuda":
                found.add(x.device)
        elif isinstance(x, (tuple, list)):
            stack.extend(x)
        elif isinstance(x, dict):
            stack.extend(x.values())
    return found


def fenced_time(fn, *args, **kwargs):
    """(result, seconds) with a fence after ``fn``: each CUDA device that
    holds an output is synchronised (not every device); outputs on the
    CPU need none."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    for dev in _devices_of(out):
        torch.cuda.synchronize(dev)
    return out, time.perf_counter() - t0


def _flush_device_queue():
    """Block until the work queued so far on the current CUDA stream has
    run (no-op without CUDA)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.current_stream().synchronize()


class Timer:
    """Named section timer: ``with timer('solve'): ...``; .report() dict.

    ``fence=True`` drains the current stream before stopping the clock
    (an enqueue otherwise records only the launch time). For exact
    fencing on a specific result, call ``.fence(out)`` on the yielded
    handle instead: ``with timer('x') as t: t.fence(f())``.
    """

    class _Section:
        def fence(self, value):
            for dev in _devices_of(value):
                torch.cuda.synchronize(dev)
            return value

    def __init__(self, span_prefix: str = "timer"):
        self.sections: dict[str, float] = {}
        # span name prefix when tracing is on: each timed section also
        # becomes an obs span, so stage timers and engine spans report
        # from one instrument set
        self.span_prefix = span_prefix

    @contextlib.contextmanager
    def __call__(self, name: str, fence: bool = False):
        with obs.span(f"{self.span_prefix}.{name}"):
            t0 = time.perf_counter()
            yield Timer._Section()
            if fence:
                _flush_device_queue()
            self.sections[name] = self.sections.get(name, 0.0) + time.perf_counter() - t0

    def report(self) -> dict[str, float]:
        return dict(self.sections)


@contextlib.contextmanager
def profile_trace(log_dir: str | None):
    """Optionally record the block with ``torch.profiler`` (host and,
    where there is one, CUDA activity) and write a Chrome trace,
    ``<log_dir>/trace.json``, when it ends."""
    if not log_dir:
        yield
        return
    import os

    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))

"""Timing helpers (port of ``fia_tpu/utils/timing.py``).

The reference benchmarks with bare ``time.time()`` prints around
``sess.run`` calls (``matrix_factorization.py:216-250``). CUDA launches
return before the card has run them, so a host clock alone measures the
enqueue; ``fenced_time`` fences on the card. The reference's ``Timer``
and ``profile_trace`` have no twin here: the engine's own spans
(:mod:`fia_tpu_torch.obs`) time its steps, and mirror them into a torch
profiler's trace while one records.
"""

from __future__ import annotations

import time

import torch


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

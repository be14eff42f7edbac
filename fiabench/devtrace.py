"""The reduction of a ``torch.profiler`` trace to device time.

A traced run profiles a steady run of whole jobs and exports the Chrome
trace. ``Trace`` reads from it the device operations (kernels, copies,
sets) with their card, and the host's events. Busy time is the union of
a card's operation intervals, so operations that overlap count once.
"""

from __future__ import annotations

import json
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime")
#: characters of an operation's name a breakdown keeps
NAME_CHARS = 160


def union(intervals) -> list[tuple[float, float]]:
    """Sorted, merged ``(start, end)`` intervals."""
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class Trace:
    """Device and host events of one profile, times in microseconds."""

    def __init__(self, events: list[dict]):
        self.device = []  # (name, card, start, end)
        self.host = []  # (name, start, end)
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            a = float(e["ts"])
            b = a + float(e["dur"])
            cat = e.get("cat", "")
            if cat in DEVICE_CATS:
                card = int(e.get("args", {}).get("device", 0))
                self.device.append((e["name"], card, a, b))
            elif cat in HOST_CATS:
                self.host.append((e["name"], a, b))
        spans = [(a, b) for _, _, a, b in self.device] + \
                [(a, b) for _, a, b in self.host]
        self.lo = min((a for a, _ in spans), default=0.0)
        self.hi = max((b for _, b in spans), default=0.0)

    @classmethod
    def load(cls, path: str) -> "Trace":
        with open(path) as f:
            return cls(json.load(f).get("traceEvents", []))

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) / 1e6

    def cards(self) -> list[int]:
        return sorted({c for _, c, _, _ in self.device})

    def busy_s(self, card: int) -> float:
        return sum(b - a for a, b in union(
            (a, b) for _, c, a, b in self.device if c == card)) / 1e6

    def seconds(self, names) -> float:
        """Device seconds of the operations whose name holds any of
        ``names``, summed over cards."""
        return sum(b - a for n, _, a, b in self.device
                   if any(s in n for s in names)) / 1e6

    def top_ops(self, n: int = 10) -> list[list]:
        """The ``n`` device operations that took most time, by name (the
        first ``NAME_CHARS`` characters of it)."""
        by = defaultdict(float)
        for name, _, a, b in self.device:
            by[name] += (b - a) / 1e6
        return [[k[:NAME_CHARS], v] for k, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list[list]:
        """The ``n`` longest stretches inside the window in which a card
        ran nothing, each named by the innermost host event around its
        middle (``host: none`` where the host was in no traced event)."""
        gaps = []
        for card in self.cards():
            busy = union((a, b) for _, c, a, b in self.device if c == card)
            edges = [self.lo] + [x for ab in busy for x in ab] + [self.hi]
            for a, b in zip(edges[0::2], edges[1::2]):
                if b > a:
                    gaps.append((b - a, (a + b) / 2))
        gaps.sort(reverse=True)
        out = []
        for length, mid in gaps[:n]:
            around = [(b - a, name) for name, a, b in self.host
                      if a <= mid <= b]
            name = min(around)[1] if around else "host: none"
            out.append([name, length / 1e6])
        return out

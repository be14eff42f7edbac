"""Each card's idle time split by the step of the program the host was in.

While a traced run profiles, the engine's spans are also profiler ranges
of their names (``user_annotation`` events, which ``Trace.host`` keeps)
on the clock of the device's operations. Every stretch in which a card
ran nothing is cut at the edges of the ranges named in ``STEPS`` and
``JOB``, and each piece is charged to:

- ``dispatch`` or ``finalize``: the innermost ``engine.dispatch_flat``
  or ``engine.finalize_flat`` range that covers it;
- ``loop``: else an ``engine.query_many`` range, the job loop's own time;
- ``outside``: else nothing of the program, the caller between jobs.

The four shares, each in percent of the profiled window and averaged over
the cards, add up to ``device.idle_pct``:

    device.idle_pct = dispatch + finalize + outside + loop
"""

from __future__ import annotations

from fiabench.devtrace import union

STEPS = {"engine.dispatch_flat": "dispatch", "engine.finalize_flat": "finalize"}
JOB = "engine.query_many"
SHARES = ("dispatch", "finalize", "loop", "outside")


def _segments(lo: float, hi: float, ranges) -> list[tuple]:
    """``[lo, hi]`` cut at every edge of ``ranges`` (``(start, end,
    name)``) into contiguous ``(start, end, share)`` pieces."""
    edges = sorted([(a, 1, i) for i, (a, _, _) in enumerate(ranges)]
                   + [(b, 0, i) for i, (_, b, _) in enumerate(ranges)])
    steps: list[int] = []  # open step ranges, innermost last
    jobs, t, out = 0, lo, []

    def share() -> str:
        if steps:
            return STEPS[ranges[steps[-1]][2]]
        return "loop" if jobs else "outside"

    for x, opens, i in edges:
        x = min(max(x, lo), hi)
        if x > t:
            out.append((t, x, share()))
            t = x
        is_job = ranges[i][2] == JOB
        if opens:
            if is_job:
                jobs += 1
            else:
                steps.append(i)
        elif is_job:
            jobs -= 1
        else:
            steps.remove(i)
    if hi > t:
        out.append((t, hi, share()))
    return out


def split(tr) -> dict[str, float] | None:
    """The four idle shares of ``tr`` (a ``devtrace.Trace``) in percent
    of its window, mean over its cards; ``None`` without a trace, a card
    or an ``engine.query_many`` range (a program that does not mirror its
    spans into the profiler)."""
    if tr is None or not tr.cards() or tr.window_s <= 0:
        return None
    ranges = [(a, b, name) for name, a, b in tr.host
              if name in STEPS or name == JOB]
    if not any(name == JOB for _, _, name in ranges):
        return None
    segs = _segments(tr.lo, tr.hi, ranges)
    total = dict.fromkeys(SHARES, 0.0)
    for card in tr.cards():
        busy = union((a, b) for _, c, a, b in tr.device if c == card)
        edges = [tr.lo] + [x for ab in busy for x in ab] + [tr.hi]
        j = 0
        for a, b in zip(edges[0::2], edges[1::2]):
            while j < len(segs) and segs[j][1] <= a:
                j += 1
            k = j
            while k < len(segs) and segs[k][0] < b:
                s0, s1, share = segs[k]
                total[share] += min(b, s1) - max(a, s0)
                k += 1
    scale = 100.0 / len(tr.cards()) / (tr.hi - tr.lo)
    return {k: v * scale for k, v in total.items()}

"""Median host time of one ``engine.replay`` span (the engine's obs
spine, on in the traced run): one a card a dispatch: the call of a built
flat program, its inputs copied in, the CUDA graph replayed and its
outputs cloned, all enqueued; the program's build is not in it.

The median, and not the mean: the spans cover the whole window, the
profiler only a few seconds of it, and while it records each span is
also a profiler range and CUPTI holds a job's first graph launch for
milliseconds. The median stays with the unprofiled spans, which are most
of the window's."""

import statistics


def read(ctx):
    spans = [t1 - t0 for name, t0, t1 in ctx.get("spans", [])
             if name == "engine.replay"]
    return 1e3 * statistics.median(spans) if spans else None

"""Mean host time of one ``engine.fetch`` span (the engine's obs spine,
on in the traced run): the host blocked until every shard's outputs of
one dispatch are on the host, the wait for the card included.

The mean, and not the median that the other span readers take: only a
job's first fetch waits for the card (its batches are all in flight),
and the median would be the other fetches', which wait for nothing. The
profiler does not slow a fetch: its mean reads the same in the profiled
stretch and out of it."""


def read(ctx):
    spans = [t1 - t0 for name, t0, t1 in ctx.get("spans", [])
             if name == "engine.fetch"]
    return 1e3 * sum(spans) / len(spans) if spans else None

"""Mean host time of one ``engine.dispatch_flat`` span (the engine's own
obs spine, on in the traced run): the host's enqueue of a batch, from
its related counts and geometry to the graph replay."""


def read(ctx):
    spans = [t1 - t0 for name, t0, t1 in ctx.get("spans", [])
             if name == "engine.dispatch_flat"]
    return 1e3 * sum(spans) / len(spans) if spans else None

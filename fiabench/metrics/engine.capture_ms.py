"""Host milliseconds of every ``engine.capture`` span in the traced
window, summed: the flat programs built on the hot path, each a stall
of the job it falls in (0 for a warmed engine; ``flat.captures_in_window``
counts them, this says what they cost). ``None`` for a program without
the ``engine.query_many`` span, which has no ``engine.capture`` span
either."""


def read(ctx):
    spans = ctx.get("spans", [])
    if not any(name == "engine.query_many" for name, _, _ in spans):
        return None
    return 1e3 * sum(t1 - t0 for name, t0, t1 in spans
                     if name == "engine.capture")

"""Share of the profiled window in which a card ran nothing while the
host was in no ``engine.query_many``: the caller, between jobs; mean over
the cards (``fiabench/idlesplit.py``). With the other two shares and the
job loop's own (idle under ``engine.query_many`` alone):

    device.idle_pct = device.idle_dispatch_pct + device.idle_finalize_pct
                      + device.idle_outside_pct + loop
"""

from fiabench import idlesplit


def read(ctx):
    shares = idlesplit.split(ctx.get("trace"))
    return None if shares is None else shares["outside"]

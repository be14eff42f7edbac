"""Share of the profiled window in which a card ran nothing while the
host was in ``engine.finalize_flat`` (a batch's fetch to the host and
its assembly), mean over the cards (``fiabench/idlesplit.py``). With the
other two shares and the job loop's own:

    device.idle_pct = device.idle_dispatch_pct + device.idle_finalize_pct
                      + device.idle_outside_pct + loop
"""

from fiabench import idlesplit


def read(ctx):
    shares = idlesplit.split(ctx.get("trace"))
    return None if shares is None else shares["finalize"]

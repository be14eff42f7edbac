"""Share of the profiled window in which a card ran nothing while the
host was in ``engine.dispatch_flat`` (a batch's plan, upload and
replays), mean over the cards (``fiabench/idlesplit.py``). With the
other two shares and the job loop's own:

    device.idle_pct = device.idle_dispatch_pct + device.idle_finalize_pct
                      + device.idle_outside_pct + loop

It reads the profiled dispatch, not the untraced one: under the profiler
CUPTI holds a job's first graph launch for milliseconds, which an
untraced replay does not take (``fiabench/spanstat.py`` times the
untraced steps).
"""

from fiabench import idlesplit


def read(ctx):
    shares = idlesplit.split(ctx.get("trace"))
    return None if shares is None else shares["dispatch"]

"""The whole influence step's share of the cards' float32 peak: the
model operations of the profiled jobs' queries (``roofline.query_flops``,
counted from shapes, whatever computes them) over the profiled window
times 67 TFLOP/s times the cards."""

from fiabench import roofline


def read(ctx):
    tr, lns = ctx.get("trace"), ctx.get("launches")
    if tr is None or not lns or tr.window_s <= 0:
        return None
    flops = roofline.query_flops(ctx["config"], sum(l.rows for l in lns),
                                 sum(l.queries for l in lns), ctx["d"])
    return 100.0 * flops / (tr.window_s * roofline.FP32_FLOP_PER_S
                            * ctx["chips"])

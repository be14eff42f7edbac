"""Share of its roofline the NCF score kernels (``csrc/ncf_scores.cu``:
the query products, then the row kernel) reach: the least time of their
launches in the profiled jobs (``roofline.ncf_scores_s``) over their
device time."""

from fiabench import roofline

KERNELS = ("ncf_query_products_kernel", "ncf_rows_kernel",
           "ncf_rows_general_kernel")


def read(ctx):
    tr, lns = ctx.get("trace"), ctx.get("launches")
    if tr is None or not lns:
        return None
    t = tr.seconds(KERNELS)
    if t <= 0:
        return None
    least = sum(roofline.ncf_scores_s(ctx["config"], ln) for ln in lns)
    return 100.0 * least / t

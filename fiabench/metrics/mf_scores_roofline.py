"""Share of its roofline the MF score kernel (``csrc/mf_scores.cu``)
reaches: the least time of its launches in the profiled jobs
(``roofline.mf_scores_s``) over its device time."""

from fiabench import roofline

KERNELS = ("mf_fused_scores_kernel",)


def read(ctx):
    tr, lns = ctx.get("trace"), ctx.get("launches")
    if tr is None or not lns:
        return None
    t = tr.seconds(KERNELS)
    if t <= 0:
        return None
    least = sum(roofline.mf_scores_s(ctx["config"], ln) for ln in lns)
    return 100.0 * least / t

"""Share of its roofline the segment Hessian sums
(``csrc/segment_hessian.cu``: pieces, then the combine) reach: the
least time of their launches in the profiled jobs
(``roofline.segment_hessian_s``) over their device time."""

from fiabench import roofline

KERNELS = ("segment_pieces_kernel", "segment_combine_kernel")


def read(ctx):
    tr, lns = ctx.get("trace"), ctx.get("launches")
    if tr is None or not lns:
        return None
    t = tr.seconds(KERNELS)
    if t <= 0:
        return None
    least = sum(roofline.segment_hessian_s(ctx["config"], ln, ctx["d"]) for ln in lns)
    return 100.0 * least / t

"""Share of its roofline the batched LU solve reaches
(``torch.linalg.solve_ex`` in ``influence/solvers.py``: cuBLAS's and
cuSOLVER's batched factorisation and triangular solves, by name): the
least time of the profiled jobs' solves (``roofline.solve_s``) over
their device time."""

from fiabench import roofline

KERNELS = ("getrf", "getrs", "trsm", "trsv", "laswp")


def read(ctx):
    tr, lns = ctx.get("trace"), ctx.get("launches")
    if tr is None or not lns:
        return None
    t = tr.seconds(KERNELS)
    if t <= 0:
        return None
    least = sum(roofline.solve_s(ctx["config"], ln, ctx["d"]) for ln in lns)
    return 100.0 * least / t

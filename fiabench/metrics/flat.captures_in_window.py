"""Flat programs (CUDA graphs, one a geometry and card) the engine built
inside the window: every one a stall a warmed engine should not take."""


def read(ctx):
    return ctx["captures_in_window"]

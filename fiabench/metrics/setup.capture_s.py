"""Seconds the engine's ``precompile_flat`` took in set-up (its own
count): each geometry's eager warm-up and CUDA graph capture, over the
geometries and cards of the cell's traffic."""


def read(ctx):
    return ctx["precompile"]["seconds"] or None

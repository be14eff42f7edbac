"""Seconds of the eager warm-ups in set-up: the sum over the CUDA graphs
``precompile_flat`` captured of each program's first, eager run to the
card's drain (its own count, beside the records'), the part of
``setup.capture_s`` that is not the graph record."""


def read(ctx):
    return ctx["precompile"].get("warmup_s") or None

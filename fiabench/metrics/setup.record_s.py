"""Seconds of the CUDA graph records in set-up: the sum over the graphs
``precompile_flat`` captured of each program's record (its own count,
beside the eager warm-ups' ``setup.warmup_s``), the rest of
``setup.capture_s``."""


def read(ctx):
    return ctx["precompile"].get("record_s") or None

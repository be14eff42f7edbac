"""Peak device memory the caching allocator handed out over the run
(``torch.cuda.max_memory_allocated``), on the fullest card, in MiB."""


def read(ctx):
    return ctx["peak_bytes"] / 2 ** 20 if ctx["peak_bytes"] else None

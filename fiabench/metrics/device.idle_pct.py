"""Share of the profiled window in which a card ran no operation (the
union of its kernels, copies and sets), averaged over the cell's cards."""


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or not tr.cards() or tr.window_s <= 0:
        return None
    busy = [tr.busy_s(c) for c in tr.cards()]
    return 100.0 * (1.0 - sum(busy) / len(busy) / tr.window_s)

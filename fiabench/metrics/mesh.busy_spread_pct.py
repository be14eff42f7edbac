"""The busiest card's busy share of the profiled window minus the least
busy card's: how unevenly ``_mesh_plan``'s query shards load the mesh."""


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or len(tr.cards()) < 2 or tr.window_s <= 0:
        return None
    busy = [tr.busy_s(c) for c in tr.cards()]
    return 100.0 * (max(busy) - min(busy)) / tr.window_s

"""Median time of a job in the traced run, from handing it to
``InfluenceEngine.query_many`` to its results on the host (the harness's
job clock): the host pipeline's typical job beside the untraced p95."""

import statistics


def read(ctx):
    lat = ctx["latencies_s"]
    return 1e3 * statistics.median(lat) if lat else None

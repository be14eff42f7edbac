"""Seconds of set-up on the harness's clock around the ratings, the job
pool, the weights, and the engine's index and upload."""


def read(ctx):
    return ctx["data_s"]

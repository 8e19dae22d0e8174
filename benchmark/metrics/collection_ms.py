"""Collection (the collection's CUDA graph: the env step over K1, the
actor-critic, GAE and the shuffle): mean ms an iteration, from the
runner's CUDA events (``last_timing["collection_s"]``)."""

import statistics


def read(ctx):
    its = ctx["iterations"]
    return statistics.mean(i["collection_s"] for i in its) * 1e3 if its else None

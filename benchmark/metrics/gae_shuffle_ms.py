"""GAE and shuffle (``learn/runner.py`` ``_returns``, ``learn/graphs.py``
``CompiledIteration._stage_update``: the last values, GAE, the permutation,
the update's inputs staged, the metric sums): mean ms an iteration, from the
marks captured in the collection graph (``last_timing["gae_s"]`` +
``["stage_s"]``, ``learn/spans.py``); None where the program has no such
span."""

import statistics


def read(ctx):
    its = ctx["iterations"]
    if not its or any("gae_s" not in i or "stage_s" not in i for i in its):
        return None
    return statistics.mean(i["gae_s"] + i["stage_s"] for i in its) * 1e3

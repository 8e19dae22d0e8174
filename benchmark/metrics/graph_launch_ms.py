"""Graphs (``learn/graphs.py`` ``CompiledIteration.__call__``): mean ms an
iteration the host spends in the calls that launch the collection's and the
update's graphs (``last_timing["launch_s"]``, host clock); None where the
program does not report it."""

import statistics


def read(ctx):
    its = ctx["iterations"]
    if not its or any("launch_s" not in i for i in its):
        return None
    return statistics.mean(i["launch_s"] for i in its) * 1e3

"""Trainer (``learn/runner.py`` ``_train_iter``): the mean per iteration of
the wall time outside the collection and the update as CUDA events time
them: the state's copy-in, the draws' copy-in, the launches and the
synchronize."""

import statistics


def read(ctx):
    its = ctx["iterations"]
    if not its:
        return None
    return statistics.mean(i["wall_s"] - i["collection_s"] - i["update_s"] for i in its) * 1e3

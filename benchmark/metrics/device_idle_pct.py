"""Device: the share of the traced iterations' window in which no kernel,
copy or set ran on the card (averaged over the cards)."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])

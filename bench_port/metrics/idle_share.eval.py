"""idle_share.eval: the share of the inference cell's window, in %, in which
no operation ran on the card.

``1 - busy / window``: busy is the union of the device operations'
intervals (kernels, copies, fills) inside the harness's window span, from
the profiler's trace. Moves ``forward_ms``.
"""
TRAIN = False


def read(ctx):
    if ctx.train != TRAIN or ctx.window_s <= 0 or not ctx.trace.device:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)

"""mfu.eval: the whole full-batch forward's share of the card's peak, in %.

Operations of a forward from the model's equations in their published
order (``models/<model>.py``: every sparse product, 2 per entry and
column, and every GEMM, ``2 M K N``), over the traced window's time per
forward, over the card's float32 peak (``peaks.py``; outside the tensor
cores, TF32 off). The count never changes with the implementation.
Nothing to read on an unknown card or outside an inference cell. Moves
``forward_ms``.
"""
from bench_port import work

TRAIN = False


def read(ctx):
    if ctx.train != TRAIN or ctx.peak is None or not ctx.steps:
        return None
    vg = bool(ctx.traffic["value_grad"])
    flops = sum(work.sparse_flops(k, K, ctx.nnz)
                for k, K in ctx.model.sparse_ops(ctx.config, TRAIN, vg))
    flops += ctx.model.dense_flops(ctx.config, ctx.n, TRAIN, vg)
    return 100.0 * flops / (ctx.window_s / ctx.steps) / ctx.peak[
        "flops_per_s"]

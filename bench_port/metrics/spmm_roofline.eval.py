"""spmm_roofline.eval: K1's share of its roofline in a forward, in %.

K1 is ``csrc/spmm_spans.cu``'s ``spmm_spans_kernel`` at one span a row:
every ``A @ h`` of the forward. Its least time: for each of those products
(``models/<model>.py``'s ``sparse_ops``, kind ``spmm``),
the larger of its bytes read and written once over the card's HBM rate
and its operations over the f32 rate (``work.py``); over the device time
of K1's launches in the trace. Nothing to read when the launches counted
in the window or seen in the trace are not the products' number, or on an
unknown card. Moves ``forward_ms``.
"""
from bench_port import work

TRAIN = False
KERNELS = ("spmm_spans_kernel",)
OPS = ("spmm", "spmm_t")
COUNTER = "spmm_csr"


def read(ctx):
    if ctx.train != TRAIN or ctx.peak is None or not ctx.steps:
        return None
    from bench_port.devtrace import matcher, seconds_of
    ops = [(k, K) for k, K in ctx.model.sparse_ops(
        ctx.config, TRAIN, bool(ctx.traffic["value_grad"])) if k in OPS]
    secs, seen = seconds_of(ctx.trace, matcher(KERNELS))
    want = len(ops) * ctx.steps
    if not ops or ctx.launches.get(COUNTER) != want or seen != want \
            or secs <= 0:
        return None
    least = ctx.steps * work.sparse_least_seconds(ops, ctx.n, ctx.nnz,
                                                  ctx.itemsize, ctx.peak)
    return 100.0 * least / secs

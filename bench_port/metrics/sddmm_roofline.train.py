"""sddmm_roofline.train: K2's share of its roofline in a train step, in %.

K2 is ``csrc/sddmm_spans.cu``'s ``sddmm_spans_kernel`` at one span a row:
``d value`` alone, where the edge values need grads and no ``d x`` is
wanted with it (the first layer: the features need no grad). Its least
time: for each such product (``sparse_ops`` kind ``sddmm``), the larger of
its bytes once (the row pointer, cols, ``g`` and ``x`` read; ``d value``
written) over the HBM rate and its operations over the f32 rate
(``work.py``); over the device time of K2's launches in the trace. Nothing
to read when the counted or traced launches are not the products' number,
or on an unknown card. Moves ``train_step_ms``.
"""
from bench_port import work

KERNELS = ("sddmm_spans_kernel",)
OPS = ("sddmm",)
COUNTER = "sddmm_csr"


def read(ctx):
    if not ctx.train or ctx.peak is None or not ctx.steps:
        return None
    from bench_port.devtrace import matcher, seconds_of
    ops = [(k, K) for k, K in ctx.model.sparse_ops(
        ctx.config, True, bool(ctx.traffic["value_grad"])) if k in OPS]
    secs, seen = seconds_of(ctx.trace, matcher(KERNELS))
    want = len(ops) * ctx.steps
    if not ops or ctx.launches.get(COUNTER) != want or seen != want \
            or secs <= 0:
        return None
    least = ctx.steps * work.sparse_least_seconds(ops, ctx.n, ctx.nnz,
                                                  ctx.itemsize, ctx.peak)
    return 100.0 * least / secs

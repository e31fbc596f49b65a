"""fused_bwd_roofline.train: K2′'s share of its roofline in a train step,
in %.

K2′ is ``csrc/spmm_sddmm_csc.cu``'s ``spmm_sddmm_kernel`` (or its
``_tight`` build): both grads of ``A @ h`` in one pass over the CSC view,
where the edge values need grads. Its least time: for each such product
(``sparse_ops`` kind ``spmm_sddmm``), the larger of its bytes once (the
CSC pointer, rows, values, ``g`` and ``x`` read; ``d x`` and ``d value``
written) over the HBM rate and its operations over the f32 rate
(``work.py``); over the device time of K2′'s launches in the trace. The
relays of the values around it are ATen gathers (``aten_ms.train``).
Nothing to read when the counted or traced launches are not the products'
number, or on an unknown card. Moves ``train_step_ms``.
"""
from bench_port import work

KERNELS = ("spmm_sddmm_kernel", "spmm_sddmm_kernel_tight")
OPS = ("spmm_sddmm",)
COUNTER = "spmm_sddmm_csc"


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

"""heads_aten_ms.eval: device ms a GAT forward spends around its per-head
aggregations in operations that are not the port's kernels: each head's
attention weights and operand made contiguous, the ``where`` of
``with_value``, the stack of the heads and their mean. K1, which does the
aggregations, is left out (``spmm_roofline.eval`` reads it).

The program opens ``psp.model.gat.heads`` around the heads' ``with_value``
and ``spmm`` calls and their concat or mean (``models/gcn.py::GAT``).
Read from the profiler's trace of the window: every device operation whose
name is none of the ``__global__`` functions of the program's CUDA sources
and whose launch lies inside that span, summed over the forwards that pair
(``steps.py``), over their number. Nothing to read where no operation lies
inside it (a program without it, or a model without heads), or where no
forward pairs. Moves ``forward_ms``.
"""
from bench_port import steps

SPAN = "psp.model.gat.heads"


def read(ctx):
    if ctx.train or not ctx.steps or not ctx.trace.device:
        return None
    paired = steps.step_paths(ctx.trace)
    if not any(SPAN in p for _, paths in paired for p in paths):
        return None
    s = sum(o.dur for ops, paths in paired for o, p in zip(ops, paths)
            if SPAN in p and not ctx.port(o.name))
    return 1e3 * s / len(paired)

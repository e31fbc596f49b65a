"""spmm_aten_ms.train: device ms a train step spends in operations that
the SpMM autograd layer launches and that are not the port's kernels: the
relays of the values into CSC order, the read-backs of ``d value``, the
output fills, casts and copies around the kernels. A part of
``aten_ms.train``, never larger.

Read from the profiler's trace of the window: every device operation
whose name is none of the ``__global__`` functions of the program's CUDA
sources and whose launch lies inside a ``psp.spmm.`` span of the program
(``attribution.py``), summed, over the steps. Nothing to read where no
operation lies inside a program span (a program without them), or where
the launches and operations do not pair. Moves ``train_step_ms``.
"""
from bench_port import attribution

LAYER = "psp.spmm."


def read(ctx):
    if not ctx.train or not ctx.steps or not ctx.trace.device:
        return None
    paths = attribution.op_paths(ctx.trace)
    if paths is None or not any(paths):
        return None
    s = sum(o.dur for o, p in zip(ctx.trace.device, paths)
            if not ctx.port(o.name) and any(n.startswith(LAYER) for n in p))
    return 1e3 * s / ctx.steps

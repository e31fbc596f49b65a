"""aten_ms.train: device ms a train step spends in operations that are not
the port's kernels (ATen and cuBLAS: GEMMs, elementwise work, the loss,
the relays' gathers, copies and fills).

Read from the profiler's trace of the window: every device operation whose
name is none of the ``__global__`` functions of the program's CUDA
sources, summed, over the steps. Moves ``train_step_ms``.
"""
TRAIN = True


def read(ctx):
    if ctx.train != TRAIN or not ctx.steps or not ctx.trace.device:
        return None
    s = sum(o.dur for o in ctx.trace.device if not ctx.port(o.name))
    return 1e3 * s / ctx.steps

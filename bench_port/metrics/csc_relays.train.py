"""csc_relays.train: relays of A's values into CSC order a train step,
cache hits left out.

The program opens a ``psp.spmm.relay`` span around each gather of the
values through the CSC view's ``perm`` that it runs (``ops/spmm.py``:
``csc_values`` on a miss, and the fused backward's own relay), and none
where ``csc_values`` serves the values it kept. Read from the profiler's
trace of the window: those spans over the steps. Nothing to read where the
window holds no ``psp.spmm.`` span at all (a program without them). Moves
``train_step_ms``.
"""
from bench_port import attribution

LAYER = "psp.spmm."
RELAY = "psp.spmm.relay"


def read(ctx):
    if not ctx.train or not ctx.steps:
        return None
    spans = attribution.program_spans(ctx.trace)
    if not any(s.name.startswith(LAYER) for s in spans):
        return None
    return sum(s.name == RELAY for s in spans) / ctx.steps

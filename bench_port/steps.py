"""Which of the program's spans launched each device operation, paired a
step at a time.

``attribution.op_paths`` pairs the window's launches with its device
operations by order, and reads nothing unless the two lists are as long
as each other. The trace puts the card's operations on the host's clock
and clips them to the window, and that clock is off by up to a few tenths
of a millisecond: on an H100 an operation of a traced ``gat-products.eval``
run can read 0.16 ms earlier than its launch, and the window's last
operation starts 0.15 to 0.43 ms before the window closes. So a window can
lose its last operation. Here the pairing is the same, by order from the
window's start, taken a step at a time (the harness's ``bench.step``
span): the launches inside a step pair with the operations at the same
places in the window's order, kind by kind, and a step that reaches past
the operations the window kept, or whose kinds differ, is left out.
"""
from typing import List, Tuple

from bench_port import attribution
from bench_port.devtrace import Op, Trace

STEP = "bench.step"


def step_paths(trace: Trace
               ) -> List[Tuple[List[Op], List[attribution.Path]]]:
    """For each step whose launches pair with the window's operations: the
    step's device operations, in order, and the program spans around the
    call that launched each (``()``: none). Steps that do not pair are
    left out."""
    calls = attribution.launches(trace)
    spans = attribution.program_spans(trace)
    steps = sorted((o for o in trace.host if o.name == STEP
                    and trace.window[0] <= o.start <= trace.window[1]),
                   key=lambda o: o.start)
    out, at = [], 0
    for st in steps:
        a, b = st.start, st.start + st.dur
        while at < len(calls) and calls[at].start < a:
            at += 1
        lo = at
        while at < len(calls) and calls[at].start <= b:
            at += 1
        c, d = calls[lo:at], trace.device[lo:at]
        if len(d) != len(c) or any(attribution.launch_kind(x.name)
                                   != attribution.op_kind(o.name)
                                   for x, o in zip(c, d)):
            continue
        inner = [s for s in spans if a <= s.start <= b]
        out.append((d, [attribution.span_path(inner, x.start) for x in c]))
    return out

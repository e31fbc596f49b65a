"""attention_ms.eval: device ms a GAT forward spends in its attention: the
per-head scores ``hw . a_src`` and ``hw . a_dst``, the ``(E, H)`` edge
logits and their softmax over each row's entries (plain torch: gathers,
row reductions, elementwise work).

The program opens ``psp.model.gat.scores`` around the scores and logits
and ``psp.model.edge_softmax`` inside ``edge_softmax`` (``models/gcn.py``).
Read from the profiler's trace of the window: every device operation whose
launch lies inside either span, summed over the forwards that pair
(``steps.py``), over their number. Nothing to read where no operation lies
inside one of them (a program without them, or a model without
attention), or where no forward pairs. Moves ``forward_ms``.
"""
from bench_port import steps

SPANS = ("psp.model.gat.scores", "psp.model.edge_softmax")


def read(ctx):
    if ctx.train or not ctx.steps or not ctx.trace.device:
        return None
    paired = steps.step_paths(ctx.trace)
    inside = [o.dur for ops, paths in paired for o, p in zip(ops, paths)
              if any(n in SPANS for n in p)]
    if not inside:
        return None
    return 1e3 * sum(inside) / len(paired)

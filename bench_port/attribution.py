"""Which of the program's spans launched each device operation of the
window.

The program names its layers with ``record_function`` spans (``psp.``,
``paddle_sparse_tpu_torch/profiling.py::scope``); the profiler keeps them
beside the runtime's launch calls (``cudaLaunchKernel``,
``cudaMemcpyAsync``, ``cudaMemsetAsync``, the driver's ``cuLaunchKernel``)
and the card's operations, all on one clock. A launch belongs to the
program spans that enclose its start; a device operation to its launch.

:class:`devtrace.Trace` keeps each event's name and times but not the
correlation id that joins an operation to its launch, nor the thread. So
the operations are joined to the launches by order: on one stream the card
runs operations in the order the host enqueued them, and the window opens
and closes on a synchronized, idle card, so the window's k-th launch is its
k-th operation. The join is taken only where both lists agree kind by kind
(kernel, copy, fill) over the whole window; elsewhere there is nothing to
read. The spans are matched by time, not by thread: the harness's step
launches from one thread at a time (the forward from the caller's, the
backward from autograd's device thread while the caller waits).
"""
from typing import List, Optional, Tuple

from bench_port.devtrace import Op, Trace

PREFIX = "psp."                  # the program's spans
Path = Tuple[str, ...]           # enclosing program spans, outer to inner


def op_kind(name: str) -> str:
    """``copy``, ``fill`` or ``kernel``, from a device operation's name."""
    if name.startswith("Memcpy"):
        return "copy"
    if name.startswith("Memset"):
        return "fill"
    return "kernel"


def launch_kind(name: str) -> Optional[str]:
    """The kind of device operation a host call enqueues, or None for a
    call that enqueues none (a synchronize, an attribute query)."""
    if "Memcpy" in name:
        return "copy"
    if "Memset" in name:
        return "fill"
    if "LaunchKernel" in name or "LaunchCooperativeKernel" in name:
        return "kernel"
    return None


def _inside(trace: Trace, o: Op) -> bool:
    return trace.window[0] <= o.start <= trace.window[1]


def launches(trace: Trace) -> List[Op]:
    """The host calls in the window that enqueue a device operation, in
    order."""
    return sorted((o for o in trace.host if launch_kind(o.name)
                   and _inside(trace, o)), key=lambda o: o.start)


def program_spans(trace: Trace) -> List[Op]:
    """The program's spans (``psp.``) that start in the window."""
    return [o for o in trace.host if o.name.startswith(PREFIX)
            and _inside(trace, o)]


def span_path(spans: List[Op], t: float) -> Path:
    """The names of the spans around ``t``, outer to inner."""
    around = [s for s in spans if s.start <= t <= s.start + s.dur]
    around.sort(key=lambda s: (s.start, -s.dur))
    return tuple(s.name for s in around)


def op_paths(trace: Trace) -> Optional[List[Path]]:
    """For each of ``trace.device``, in its order, the program spans around
    the call that launched it (``()``: none); None where the window's
    launches and operations do not pair kind by kind."""
    calls = launches(trace)
    if len(calls) != len(trace.device) or any(
            launch_kind(c.name) != op_kind(o.name)
            for c, o in zip(calls, trace.device)):
        return None
    spans = program_spans(trace)
    return [span_path(spans, c.start) for c in calls]


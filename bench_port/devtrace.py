"""The device trace of a measured window, from ``torch.profiler``.

The profiler records the host's ops and the harness's own spans
(``record_function``) beside every kernel, copy and fill on the card. It is
exported as a Chrome trace into a temporary directory under ``TMPDIR``,
read back, and deleted: the format is the same across PyTorch versions,
and it tells kernels (``cat`` ``kernel``, ``gpu_memcpy``, ``gpu_memset``)
from the annotations that the profiler mirrors onto the device's
timeline. Times are in seconds on the trace's own clock, on which the
host's spans and the device's operations line up.

The port's kernels are told from the rest by name: the ``__global__``
functions of the program's CUDA sources (``csrc/*.cu``, ``*.cuh``).
"""
import contextlib
import json
import re
import tempfile
from pathlib import Path
from typing import Dict, List, NamedTuple, Sequence, Tuple

import torch

WINDOW = "bench.window"          # the harness's span around the window
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


class Op(NamedTuple):
    name: str
    start: float     # s
    dur: float       # s


class Trace(NamedTuple):
    window: Tuple[float, float]   # start, end of the WINDOW span, s
    device: List[Op]              # device operations, clipped to the window
    host: List[Op]                # host ops and spans inside the window


@contextlib.contextmanager
def profiled(enabled: bool):
    """``torch.profiler`` over the block when ``enabled`` (the trace is
    read by :func:`read`); nothing otherwise."""
    if not enabled:
        yield None
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof


def read(prof) -> Trace:
    """The window's device operations and host events, from the
    profiler's Chrome trace."""
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    win = [e for e in events if e.get("name") == WINDOW
           and e.get("cat") == "user_annotation"]
    if not win:
        raise RuntimeError(f"the trace holds no {WINDOW} span")
    w0 = float(win[0]["ts"]) * 1e-6
    w1 = w0 + float(win[0]["dur"]) * 1e-6
    device, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat")
        a = float(e["ts"]) * 1e-6
        b = a + float(e["dur"]) * 1e-6
        if cat in DEVICE_CATS:
            a, b = max(a, w0), min(b, w1)
            if b > a:
                device.append(Op(e.get("name", "?"), a, b - a))
        elif cat in HOST_CATS and a < w1 and b > w0:
            host.append(Op(e.get("name", "?"), a, b - a))
    device.sort(key=lambda o: o.start)
    return Trace((w0, w1), device, host)


def busy_intervals(ops: Sequence[Op]) -> List[Tuple[float, float]]:
    """The union of the operations' intervals, in order."""
    out: List[List[float]] = []
    for o in sorted(ops, key=lambda o: o.start):
        a, b = o.start, o.start + o.dur
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy_seconds(trace: Trace) -> float:
    return sum(b - a for a, b in busy_intervals(trace.device))


def idle_gaps(trace: Trace) -> List[Tuple[float, float]]:
    """The window's stretches with no device operation running."""
    gaps, t = [], trace.window[0]
    for a, b in busy_intervals(trace.device):
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if trace.window[1] > t:
        gaps.append((t, trace.window[1]))
    return gaps


def host_label(trace: Trace, t: float) -> str:
    """What the host was doing at ``t``: the outermost harness span and
    the innermost host event around ``t``, as ``outer/inner``."""
    around = [o for o in trace.host if o.start <= t <= o.start + o.dur
              and o.name != WINDOW]
    if not around:
        return "host"
    outer = max(around, key=lambda o: o.dur).name
    inner = min(around, key=lambda o: o.dur).name
    return outer if outer == inner else f"{outer}/{inner}"


def short_name(name: str, width: int = 160) -> str:
    """A kernel's name without its leading ``void`` and its argument list
    (the balanced parentheses that end it), cut to ``width`` characters."""
    n = name[5:] if name.startswith("void ") else name
    if n.endswith(")"):
        depth = 0
        for i in range(len(n) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(n[i], 0)
            if depth == 0:
                n = n[:i]
                break
    return n[:width]


def top_ops(trace: Trace, count: int = 10) -> List[list]:
    """The device operations that took most time, summed by name, as
    ``[name, seconds]``."""
    by: Dict[str, float] = {}
    for o in trace.device:
        k = short_name(o.name)
        by[k] = by.get(k, 0.0) + o.dur
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
            [:count]]


def top_gaps(trace: Trace, count: int = 10) -> List[list]:
    """The longest idle gaps, each as ``[what the host was doing,
    seconds]``."""
    gaps = sorted(idle_gaps(trace), key=lambda g: g[0] - g[1])[:count]
    return [[host_label(trace, (a + b) / 2), b - a] for a, b in gaps]


_GLOBAL = re.compile(r"__global__\s+(?:void\s+)?(?:__launch_bounds__\s*"
                     r"\([^)]*\)\s*)?(?:void\s+)?(\w+)\s*\(")


def kernel_names(csrc: Path) -> List[str]:
    """The ``__global__`` functions of the program's CUDA sources."""
    names = set()
    for p in sorted(Path(csrc).glob("*.cu")) + sorted(
            Path(csrc).glob("*.cuh")):
        names.update(_GLOBAL.findall(p.read_text()))
    return sorted(names)


def matcher(names: Sequence[str]):
    """A predicate on a trace name: does it name one of ``names`` (as a
    whole word)?"""
    if not names:
        return lambda name: False
    rx = re.compile(r"\b(?:" + "|".join(map(re.escape, names)) + r")\b")
    return lambda name: rx.search(name) is not None


def seconds_of(trace: Trace, pred) -> Tuple[float, int]:
    """Device seconds and count of the operations whose name ``pred``
    accepts."""
    ops = [o for o in trace.device if pred(o.name)]
    return sum(o.dur for o in ops), len(ops)


def window_seconds(trace: Trace) -> float:
    return trace.window[1] - trace.window[0]

"""Observability: named spans and timing (port of
``paddle_sparse_tpu/profiling.py``).

* :func:`scope`: a ``torch.profiler.record_function`` span while a profiler
  records, nothing otherwise. The profiler is the one store of the spans:
  it keeps them in memory beside the device's operations, on the same
  clock, and whoever holds it writes them out. The program's spans are the
  SpMM autograd layer's, named ``psp.spmm.*`` (``ops/spmm.py``,
  ``ops/kernels/spmm_sddmm_cuda.py``).
* :func:`time_fn`: seconds per call, the device synchronized before each
  clock read, so the time is the work's and not its enqueue.
"""
import contextlib
import time
from typing import Callable

import torch

_NO_SPAN = contextlib.nullcontext()


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def scope(name: str):
    """A context manager: the span ``name`` in the profiler's trace while a
    profiler records (``record_function``); with none recording it only
    runs the block, with no call into the dispatcher. ``name`` is a fixed
    string: the trace's readers match it whole."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


def time_fn(fn: Callable, *args, iters: int = 10, warmup: int = 2) -> float:
    """Mean wall seconds per call of ``fn(*args)`` over ``iters`` calls after
    ``warmup`` calls, the device synchronized before each clock read."""
    for _ in range(warmup):
        fn(*args)
    _sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    _sync()
    return (time.perf_counter() - t0) / iters

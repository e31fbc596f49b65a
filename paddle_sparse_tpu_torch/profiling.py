"""Observability: named scopes, traces, timing and roofline accounting
(port of ``paddle_sparse_tpu/profiling.py``).

* :func:`scope`: a ``torch.profiler.record_function`` range, and an NVTX
  range when a card is visible, so the name shows in a torch.profiler trace
  and in NVIDIA's tools.
* :func:`trace`: ``torch.profiler.profile`` (CPU, and CUDA when a card is
  visible) around a block, exported as a Chrome trace into ``log_dir``.
* :func:`time_fn`: seconds per call, the device synchronized before each
  clock read, so the time is the work's and not its enqueue.
* :class:`SpmmRoofline`: the SpMM byte model of the JAX package's bench,
  unchanged.
"""
import contextlib
import os
import tempfile
import time
from dataclasses import dataclass
from typing import Callable, Optional

import torch


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def scope(name: str):
    """Named range visible in torch.profiler traces (and NVTX on CUDA)."""
    nvtx = torch.cuda.is_available()
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """Profile a block of work; on exit the Chrome trace is written to
    ``log_dir/trace.json`` (default: ``psp_trace`` in the temp directory).
    Yields the ``torch.profiler.profile`` object, whose ``key_averages()``
    sums time by op and kernel."""
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "psp_trace")
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
        _sync()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


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


@dataclass
class SpmmRoofline:
    """Byte model for CSR/COO SpMM (BASELINE.md contract)."""
    nnz: int
    num_rows: int
    dim: int
    index_bytes: int = 4
    value_bytes: int = 4

    @property
    def bytes_moved(self) -> int:
        return (self.nnz * self.index_bytes * 2      # row + col
                + self.nnz * self.value_bytes        # edge values
                + self.nnz * self.dim * self.value_bytes   # gathered X
                + self.num_rows * self.dim * self.value_bytes)  # out

    def fraction(self, seconds: float, hbm_gbps: float) -> float:
        return (self.bytes_moved / (hbm_gbps * 1e9)) / seconds

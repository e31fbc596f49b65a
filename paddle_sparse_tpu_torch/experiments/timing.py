"""Timing for the probes: ``experiments/tpu_timing.py::bench_op`` on the
card."""
import time

import torch


def bench_op(fn, iters: int = 20, warmup: bool = True,
             device="cuda") -> float:
    """Seconds per call of ``fn()``: ``iters`` calls and then ``2 * iters``
    calls are timed, and the difference over ``iters`` removes the fixed
    cost of a timed run. On a CUDA device the runs are timed with CUDA
    events (device time, ended by a synchronize); on the CPU by the host
    clock."""
    dev = torch.device(device)
    if warmup:
        fn()

    def run(n: int) -> float:
        if dev.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(n):
                fn()
            b.record()
            b.synchronize()
            return a.elapsed_time(b) / 1e3
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return time.perf_counter() - t0

    t1 = run(iters)
    t2 = run(2 * iters)
    return (t2 - t1) / iters

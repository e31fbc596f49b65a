"""``experiments/r4_dma_issue.py`` on the card: what one async copy costs to
issue. Each of ``STEPS`` steps stages ``NS`` spans of ``CAP`` rows of a bf16
(8,388,608, 256) stream, each starting at a random 16-aligned row, and sums
them. This bounds the per-step cost of a span staging SpMM kernel (one step
per 128-row tile, S spans staged per step).

``run`` sums the spans through ``span_colsum_cuda``: each row the spans
cover is read once (``csrc/probes.cu::span_colsum``: pieces between span
endpoints streamed once through a ring of 16 KB bulk async copies, then
each step's pieces added), so ``us_per_dma`` is time per span, not per
copy. The probe's own schedule, one CTA staging each step's spans, is
``span_colsum_staged_cuda``: on an H100 at the defaults it ran at 96% of
its staged bytes, so a copy's issue cost hides behind its bytes.

Usage: python -m paddle_sparse_tpu_torch.experiments.r4_dma_issue [NS] [CAP]
"""
import json
import sys
import time

import torch

from ..ops.kernels.probes_cuda import dma_issue_output, span_colsum_cuda
from ..utils import as_device
from .timing import bench_op

K = 256
R = 128
STEPS = 2048
ITERS = 10
NSTREAM = 8 << 20 >> 9 << 9    # stream rows


def make_inputs(NS: int, CAP: int, *, steps=None, nstream=None,
                device="cuda", seed: int = 0):
    """``(stream, e0, seed)``: an N(0, 1) bf16 (nstream, K) stream, ``steps *
    NS`` span starts in ``[0, nstream - CAP)`` rounded down to a multiple of
    16, and the all-ones (1, R) f32 seed. ``steps`` and ``nstream`` default
    to ``STEPS`` and ``NSTREAM``."""
    dev = as_device(device)
    steps = STEPS if steps is None else steps
    nstream = NSTREAM if nstream is None else nstream
    g = torch.Generator(device=dev).manual_seed(seed)
    stream = torch.randn((nstream, K), generator=g, device=dev,
                         dtype=torch.bfloat16)
    e0 = (torch.randint(0, nstream - CAP, (steps * NS,), generator=g,
                        device=dev) // 16 * 16).to(torch.int32)
    return stream, e0, torch.ones((1, R), dtype=torch.float32, device=dev)


def run(stream: torch.Tensor, e0: torch.Tensor, seed: torch.Tensor, *,
        NS: int, CAP: int, steps: int) -> torch.Tensor:
    """The probe's (8 * R, K) f32 output: step ``t`` writes ``bf16(seed[0, r])
    * sum of its NS spans' rows`` into block ``t % 8``; the last step of each
    residue class wins. Refuses ``steps < 8``."""
    if steps < 8:
        raise ValueError(f"r4_dma_issue needs at least 8 steps (one per "
                         f"output block), got {steps}")
    return dma_issue_output(span_colsum_cuda(stream, e0, NS, CAP, steps),
                            seed)


def main(argv=None, device="cuda"):
    """Time ``run`` at ``[NS] [CAP]`` (default 19 384); prints and returns
    the probe's JSON fields."""
    argv = sys.argv[1:] if argv is None else argv
    NS = int(argv[0]) if len(argv) > 0 else 19
    CAP = int(argv[1]) if len(argv) > 1 else 384
    dev = as_device(device)
    stream, e0, seed = make_inputs(NS, CAP, device=dev)

    def call():
        return run(stream, e0, seed, NS=NS, CAP=CAP, steps=STEPS)

    t0 = time.perf_counter()
    call()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    cs = time.perf_counter() - t0
    per_step = bench_op(call, iters=ITERS, device=dev) / STEPS
    edges = NS * CAP
    res = {"case": f"NS={NS} CAP={CAP}",
           "us_per_step": round(per_step * 1e6, 3),
           "us_per_dma": round(per_step * 1e6 / NS, 4),
           "edges_per_s_M": round(edges / per_step / 1e6, 1),
           "bytes_per_step_KB": edges * K * 2 // 1024,
           "compile_s": round(cs, 1),
           "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                      else "cpu")}
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()

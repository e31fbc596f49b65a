"""``experiments/r5_vmem_expand.py`` on the card: can a row gather served
from a slice held on chip beat one gather from device memory per edge?

Edges are sorted by source slice (512 rows, 256 KB bf16 at K=256); each
2048-edge chunk gathers from ONE slice. ``onehot_write`` writes every
gathered row, one CTA per chunk holding 128 columns of its slice in shared
memory (``csrc/probes.cu::slice_gather``); ``onehot_reduce`` only each
chunk's sum, which is the chunk's row counts times its slice: the chunks of
one slice share one load of it (``slice_reduce``). The probe's cols are drawn in [0, 512) per chunk: the local
(in-community) edges of a clustered graph after the sort. The references
gather the same number of rows at random from a 64 MB source (over the
card's 50 MB L2): ``embedding_bag`` sums them without writing them,
``index_select`` writes them.

Usage: python -m paddle_sparse_tpu_torch.experiments.r5_vmem_expand [NCH]
"""
import sys
import time

import torch

from ..ops.kernels.probes_cuda import slice_gather_cuda
from ..utils import as_device
from .timing import bench_op

R = 512          # slice rows
E = 2048         # edges per chunk
K = 256
NROWS = 306_176  # x rows (1/8 scale, tile-aligned)
NSLICE = NROWS // R
ITERS = 5


def make_call(variant: str):
    """``(fs, cols, x) -> out`` for ``onehot_write`` ((nch * E, K) bf16) or
    ``onehot_reduce`` ((nch * 8, K) bf16)."""
    def call(fs, cols, x):
        return slice_gather_cuda(fs, cols, x, R, variant)
    return call


def make_inputs(nch: int, device="cuda", seed: int = 0):
    """``(fs, cols, x)``: chunk ``c`` reads slice ``37 c mod NSLICE``, its
    cols uniform in [0, R); x is N(0, 1) bf16 (NROWS, K)."""
    dev = as_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    cols = torch.randint(0, R, (nch * E,), generator=g, device=dev,
                         dtype=torch.int32)
    x = torch.randn((NROWS, K), generator=g, device=dev,
                    dtype=torch.bfloat16)
    fs = (torch.arange(nch, dtype=torch.int32, device=dev) * 37) % NSLICE
    return fs, cols, x


def main(argv=None, device="cuda"):
    """Time both variants and the two references at ``[NCH]`` chunks
    (default 10,000); prints ms per call and ns per edge of each, and
    returns the ns per edge by name."""
    argv = sys.argv[1:] if argv is None else argv
    nch = int(argv[0]) if argv else 10_000
    dev = as_device(device)
    t_start = time.perf_counter()

    def log(m):
        print(f"[{time.perf_counter() - t_start:7.1f}s] {m}", flush=True)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    ns = {}

    def timed(tag, fn):
        t0 = time.perf_counter()
        fn()
        sync()
        c = time.perf_counter() - t0
        per = bench_op(fn, iters=ITERS, warmup=False, device=dev)
        ns[tag] = per / (nch * E) * 1e9
        log(f"{tag:20s} {per * 1e3:9.3f} ms/iter = {ns[tag]:6.3f} ns/edge  "
            f"(first call {c:.1f}s)")

    fs, cols, x = make_inputs(nch, dev)
    sync()
    log(f"data ready: {nch} chunks x {E} edges, slice {R}x{K} bf16")
    for variant in ("onehot_write", "onehot_reduce"):
        call = make_call(variant)
        timed(variant, lambda call=call: call(fs, cols, x))

    # the references: the same number of rows gathered at random from a
    # 64 MB source, summed per chunk without writing them, and written
    src = x[: (64 << 20) // (K * 2)]
    g = torch.Generator(device=dev).manual_seed(9)
    gcols = torch.randint(0, src.shape[0], (nch * E,), generator=g,
                          device=dev)
    timed("gather_sum", lambda: torch.nn.functional.embedding_bag(
        gcols.view(nch, E), src, mode="sum"))
    timed("index_select", lambda: torch.index_select(src, 0, gcols))

    # the slice gather against a plain gather, on the first chunk
    out = make_call("onehot_write")(fs, cols, x)
    f0 = int(fs[0])
    want = x[f0 * R:(f0 + 1) * R][cols[:E].long()]
    err = float((out[:E].float() - want.float()).abs().max())
    log(f"slice gather max abs err vs a plain gather: {err:.2e}")
    return ns


if __name__ == "__main__":
    main()

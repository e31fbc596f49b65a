"""``experiments/bisect_pallas.py`` on the card, stage by stage: (1) the
trivial kernel, ``2 * x``; (2) chunks copied in and summed per tile through
a ring of one shared-memory slot or two (``dma1``, ``dma2``); (3) the CSR
row-sum (K1) through ``segment_rows_matmul``. Each stage prints its seconds
and a checksum, comparable with the TPU probe's (the same inputs).

Usage: python -m paddle_sparse_tpu_torch.experiments.bisect_pallas
       [all|trivial|dma1|dma2|spmm]
"""
import sys
import time

import numpy as np
import torch

from ..ops.kernels.probes_cuda import chunk_sum_cuda, scale2_cuda
from ..ops.kernels.spmm_spans_cuda import segment_rows_matmul
from ..utils import as_device

T, E, K = 8, 256, 128          # tiles, rows per chunk, columns
CHUNKS_PER_TILE = 4
SPMM_M, SPMM_K, SPMM_NNZ = 1024, 64, 20000


def stage(name, fn):
    t0 = time.time()
    out = fn()
    if out.is_cuda:
        torch.cuda.synchronize(out.device)
    print(f"{name}: ok in {time.time() - t0:.1f}s, checksum "
          f"{float(out.double().sum()):.3f}", flush=True)
    return out


def trivial(device="cuda") -> torch.Tensor:
    """``2 * ones((256, 128))`` through the kernel."""
    x = torch.ones((256, 128), dtype=torch.float32,
                   device=as_device(device))
    return scale2_cuda(x)


def dma_inputs(device="cuda"):
    """The probe's ``(ptr, src)``: T tiles of 4 chunks of (E, K) f32, each
    entry its flat index mod 7."""
    dev = as_device(device)
    total = T * CHUNKS_PER_TILE * E
    src = torch.arange(total * K, dtype=torch.float32,
                       device=dev).reshape(total, K) % 7
    ptr = torch.arange(T + 1, dtype=torch.int32, device=dev) \
        * CHUNKS_PER_TILE
    return ptr, src


def dma_copy(double_buffer: bool, device="cuda") -> torch.Tensor:
    """Per tile, the sum of its chunks, staged through two slots
    (``double_buffer``) or one: (T * E, K) f32."""
    ptr, src = dma_inputs(device)
    return chunk_sum_cuda(ptr, src, E, double_buffer)


def spmm_inputs(device="cuda"):
    """The probe's row-sorted (nnz, K) stream and CSR pointer, drawn with
    numpy as the TPU probe draws them."""
    dev = as_device(device)
    rng = np.random.default_rng(0)
    row = np.sort(rng.integers(0, SPMM_M, SPMM_NNZ))
    val = rng.standard_normal((SPMM_NNZ, SPMM_K)).astype(np.float32)
    rowptr = np.searchsorted(row, np.arange(SPMM_M + 1))
    return (torch.from_numpy(val).to(dev),
            torch.from_numpy(row.astype(np.int32)).to(dev),
            torch.from_numpy(rowptr.astype(np.int32)).to(dev))


def spmm(device="cuda") -> torch.Tensor:
    val, row, rowptr = spmm_inputs(device)
    return segment_rows_matmul(val, row, rowptr, SPMM_M)


def main(argv=None, device="cuda"):
    """Run the stage named by ``argv[0]`` (default ``all``); returns each
    stage's output by name."""
    argv = sys.argv[1:] if argv is None else argv
    which = argv[0] if argv else "all"
    dev = as_device(device)
    out = {}
    if which in ("all", "trivial"):
        out["trivial"] = stage("trivial", lambda: trivial(dev))
    if which in ("all", "dma1"):
        out["dma1"] = stage("dma single-buffer", lambda: dma_copy(False, dev))
    if which in ("all", "dma2"):
        out["dma2"] = stage("dma double-buffer", lambda: dma_copy(True, dev))
    if which in ("all", "spmm"):
        out["spmm"] = stage("spmm kernel", lambda: spmm(dev))
    return out


if __name__ == "__main__":
    main()

"""``experiments/r4_band_cost.py`` on the card: K4 (``band_reduce_call``) at
the probe's sizes, and the probe's bisect of its per-chunk cost
(``variants``): the full span sum, no product (the edge count of each tile's
row 0), no selection (each chunk's column sum to every row), an empty body
(each chunk's first 128 rows) and the untransposed selection. full and
untrans are K4's function and run on K4's port (after a host check that the
schedule covers every edge, so that K4's sum from the bounds equals the
schedule's); the other three run ``csrc/probes.cu::band_ablate``.

Usage: python -m paddle_sparse_tpu_torch.experiments.r4_band_cost
       (VARIANTS=1 in the environment runs the bisect as well)
"""
import json
import os
import time
from types import SimpleNamespace

import torch

from ..ops.kernels.probes_cuda import (band_ablate_cuda, band_visits,
                                       check_band_schedule)
from ..ops.kernels.spmm_spans_cuda import band_reduce_call
from ..utils import as_device
from .timing import bench_op

S = 19
BAND = 28672
BR_pad = BAND + 128
E = 512
K = 256
R = 128
CAP = 77824          # edges per (band, seg) window
TMAX = 4
ITERS = 20

# (printed name, kind) in the probe's order
VARIANTS = (("full(transposed sel)", "full"), ("no-dot", "nodot"),
            ("no-sel(const)", "nosel"), ("empty-body", "empty"),
            ("untransposed sel+reshape", "untrans"))


def tables(*, S=S, BAND=BAND, E=E, K=K, CAP=CAP, R=R, TMAX=TMAX,
           device="cuda", seed=0):
    """The probe's stream, bounds and schedule (``r4_band_cost.py:32-57``,
    ``:95-114``): every span of ``CAP`` edges covers the band's rows evenly,
    each chunk of ``E`` edges visits the ``nj`` tiles its edges touch from
    ``row0``. Returns a namespace with the sizes and ``stream`` (S * CAP, K)
    bf16, ``bst``/``ben`` (S * BR_pad / R, R) int32, ``cs``/``cr``/``cn``
    (nchunks,) int32 and the schedule's ``visits`` by tile (built once, as
    the TPU's scalar-prefetched schedule is)."""
    dev = as_device(device)
    BR_pad = BAND + 128
    ncs = CAP // E
    g = torch.Generator(device=dev).manual_seed(seed)
    stream = torch.randn((S * CAP, K), generator=g, device=dev,
                         dtype=torch.bfloat16)
    i32 = torch.int32
    loc = torch.clamp((torch.arange(BAND + 1, device=dev) * (CAP / BAND))
                      .to(i32), 0, CAP)
    offs = (torch.arange(S, dtype=i32, device=dev) * CAP)[:, None]
    padv = loc[-1:].expand(S, 128)
    lb = loc[None, :].expand(S, BAND + 1)
    bst = (torch.cat([lb[:, :-1], padv], 1) + offs).reshape(-1, R)
    ben = (torch.cat([lb[:, 1:], padv], 1) + offs).reshape(-1, R)
    q = torch.arange(ncs, dtype=i32, device=dev) * E
    r_lo = torch.clamp(torch.searchsorted(loc, q, right=True) - 1, 0,
                       BAND - 1)
    r_hi = torch.clamp(torch.searchsorted(loc, torch.minimum(q + E, loc[-1]))
                       - 1, 0, BAND - 1)
    r0 = (r_lo // 128) * 128
    nj = torch.clamp(-(-(torch.maximum(r_hi, r_lo) - r0 + 1) // R), 0, TMAX)
    cr, cn = r0.repeat(S).to(i32), nj.repeat(S).to(i32)
    return SimpleNamespace(
        S=S, BAND=BAND, BR_pad=BR_pad, E=E, K=K, R=R, CAP=CAP, TMAX=TMAX,
        nchunks=S * ncs, stream=stream, bst=bst.contiguous(),
        ben=ben.contiguous(),
        cs=torch.repeat_interleave(torch.arange(S, dtype=i32, device=dev),
                                   ncs),
        cr=cr, cn=cn, visits=band_visits(cr, cn, BR_pad=BR_pad, R=R,
                                         TMAX=TMAX))


def check_schedule(tb) -> None:
    """Raise unless the schedule covers every edge of every bound (see
    ``probes_cuda.check_band_schedule``)."""
    check_band_schedule(tb.cs, tb.cr, tb.cn, tb.bst, tb.ben, S=tb.S,
                        BR_pad=tb.BR_pad, E=tb.E, R=tb.R, TMAX=tb.TMAX)


def variant_call(kind: str, tb) -> torch.Tensor:
    """The (BR_pad, K) f32 output of one variant on the tables ``tb``: full
    and untrans through ``band_reduce_call`` (check the schedule first with
    :func:`check_schedule`), the others through ``band_ablate_cuda``."""
    kw = dict(S=tb.S, BR_pad=tb.BR_pad, E=tb.E, K=tb.K, R=tb.R,
              TMAX=tb.TMAX)
    args = (tb.cs, tb.cr, tb.cn, tb.bst, tb.ben, tb.stream)
    if kind in ("full", "untrans"):
        return band_reduce_call(*args, **kw)
    return band_ablate_cuda(kind, *args, **kw, visits=tb.visits)


def main(device="cuda"):
    """Time K4 at the probe's sizes; prints and returns its JSON fields."""
    dev = as_device(device)
    tb = tables(device=dev)
    check_schedule(tb)

    def call():
        return variant_call("full", tb)

    t0 = time.perf_counter()
    call()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    cs_t = time.perf_counter() - t0
    dt = bench_op(call, iters=ITERS, device=dev)
    res = {"case": f"band_reduce E={E} nchunks={tb.nchunks}",
           "ms": round(dt * 1e3, 4),
           "us_per_step": round(dt / tb.nchunks * 1e6, 4),
           "edges_per_s_M": round(S * CAP / dt / 1e6, 1),
           "compile_s": round(cs_t, 1)}
    print(json.dumps(res), flush=True)
    return res


def variants(device="cuda"):
    """Time each variant of the bisect; prints one JSON line each and
    returns them by kind."""
    dev = as_device(device)
    tb = tables(device=dev)
    check_schedule(tb)
    out = {}
    for name, kind in VARIANTS:
        dt = bench_op(lambda: variant_call(kind, tb), iters=ITERS,
                      device=dev)
        out[kind] = {"case": name, "ms": round(dt * 1e3, 4),
                     "us_per_step": round(dt / tb.nchunks * 1e6, 4)}
        print(json.dumps(out[kind]), flush=True)
    return out


if __name__ == "__main__":
    main()
    if os.environ.get("VARIANTS"):
        variants()

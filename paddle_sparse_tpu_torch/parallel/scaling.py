"""Scaling-efficiency estimator for the distributed SpMM strategies.

Port of ``paddle_sparse_tpu/parallel/scaling.py``, the same arithmetic
(pure Python, so the two agree exactly on the same arguments). It estimates
the scaling of each interchange from an analytic roofline model:

  per-device step time  T_D = max(compute_D, comm_D)   (collectives overlap
                                                         compute)
  efficiency(D)         E_D = T_1 / (D * T_D)

with per-device compute bytes = the local share of the single-device SpMM
traffic at a *measured* achieved bandwidth (``achieved_gbps``), and comm
bytes by strategy:

  all_gather  (D-1)/D * N*K*b        (replicates x transiently)
  ring        same total, spread over D steps (overlaps per step)
  halo        unique-cols * K * b    (deduplicated exchange)
  2d          (Dc-1)/Dc * (M/Dr)*K*b (reduce-scatter of row-block partials)

``CHIP_SPECS`` holds the JAX package's rows: the published HBM and ICI
rates of TPU generations (GB/s). They are the TPUs' spec figures, kept as
data so that a call with the same ``device_kind`` gives the same estimate in
both packages; they are not the port's, and no H100 row is given (one card
measures no interconnect). An estimate, never a measurement.
"""
from typing import NamedTuple, Optional

# per-chip spec defaults: HBM GB/s, ICI GB/s (per-direction aggregate)
CHIP_SPECS = {
    "TPU v4": (1228.0, 270.0),
    "TPU v5 lite": (819.0, 200.0),
    "TPU v5e": (819.0, 200.0),
    "TPU v5p": (2765.0, 540.0),
    "TPU v6e": (1640.0, 360.0),
}


class ScalingEstimate(NamedTuple):
    strategy: str
    n_devices: int
    compute_s: float      # per-device compute time per SpMM
    comm_s: float         # per-device interchange time per SpMM
    step_s: float         # max(compute, comm)
    efficiency: float     # T_1 / (D * T_D)
    comm_bytes: int


def _spmm_bytes(nnz: int, m: int, n: int, k: int, b: int = 4) -> int:
    # the SpMM bytes model: indices + value + gathered rows + out
    return nnz * (2 * 4 + 4) + nnz * k * b + m * k * b


def estimate_scaling(strategy: str, n_devices: int, nnz: int, m: int,
                     n: int, k: int, *, achieved_gbps: float,
                     device_kind: str = "TPU v5 lite",
                     unique_cols: Optional[int] = None,
                     grid: Optional[tuple] = None,
                     elem_bytes: int = 4) -> ScalingEstimate:
    """Estimate per-device step time + scaling efficiency for one strategy.

    ``achieved_gbps``: the measured single-device SpMM effective bandwidth
    (GB/s); the compute model divides the local traffic share by it. It
    has no default, so no estimate rests on an unmeasured rate.
    ``unique_cols``: per-device deduplicated column footprint for the halo
    strategy (defaults to min(local nnz, N)).
    ``grid``: (dr, dc) for the 2-D strategy (defaults to a near-square
    factorization of ``n_devices``).
    """
    D = n_devices
    ici = next((v[1] for kd, v in CHIP_SPECS.items()
                if device_kind.lower().startswith(kd.lower())), 200.0)
    t1 = _spmm_bytes(nnz, m, n, k, elem_bytes) / (achieved_gbps * 1e9)
    compute = t1 / D

    if strategy == "all_gather":
        comm_bytes = (D - 1) * n * k * elem_bytes // max(D, 1)
    elif strategy == "ring":
        # D-1 ppermutes of the (N/D, K) block; per-step overlap with the
        # bucket-local SpMM
        comm_bytes = (D - 1) * (n // max(D, 1)) * k * elem_bytes
    elif strategy == "halo":
        uc = unique_cols if unique_cols is not None else min(nnz // D, n)
        comm_bytes = uc * k * elem_bytes
    elif strategy == "2d":
        if grid is None:
            dr = int(D ** 0.5)
            while D % dr:
                dr -= 1
            grid = (dr, D // dr)
        dr, dc = grid
        comm_bytes = (dc - 1) * (m // dr) * k * elem_bytes // max(dc, 1)
    else:
        raise ValueError(f"unknown strategy {strategy!r}")

    comm = comm_bytes / (ici * 1e9)
    step = max(compute, comm)
    eff = t1 / (D * step) if step > 0 else 1.0
    return ScalingEstimate(strategy, D, compute, comm, step, min(eff, 1.0),
                           comm_bytes)


def scaling_report(n_devices: int, nnz: int, m: int, n: int, k: int,
                   *, achieved_gbps: float,
                   device_kind: str = "TPU v5 lite", **kw) -> dict:
    """Estimates for every strategy at ``n_devices`` (a dict for
    printing).

    Two columns per strategy (at a compute-dominated measured bandwidth
    every efficiency reads 1.0, which says nothing):

    * ``efficiency`` — at the MEASURED single-chip bandwidth, where
      compute usually dominates every comm term;
    * ``efficiency_at_target`` — at the 0.70-roofline TARGET bandwidth
      (the north star), where comm terms actually bind and the
      strategies separate.  This is the column that shows whether the
      interchange designs can carry a chip that reaches target speed.
    """
    hbm = next((v[0] for kd, v in CHIP_SPECS.items()
                if device_kind.lower().startswith(kd.lower())), 819.0)
    target_gbps = 0.70 * hbm
    out = {}
    for s in ("all_gather", "ring", "halo", "2d"):
        e = estimate_scaling(s, n_devices, nnz, m, n, k,
                             achieved_gbps=achieved_gbps,
                             device_kind=device_kind, **kw)
        et = estimate_scaling(s, n_devices, nnz, m, n, k,
                              achieved_gbps=target_gbps,
                              device_kind=device_kind, **kw)
        out[s] = {"efficiency": round(e.efficiency, 3),
                  "efficiency_at_target": round(et.efficiency, 3),
                  "step_ms": round(e.step_s * 1e3, 3),
                  "step_ms_at_target": round(et.step_s * 1e3, 3),
                  "comm_MB": round(e.comm_bytes / 1e6, 1)}
    out["target_gbps"] = round(target_gbps, 1)
    return out
"""The numbers that decide ``correct``, each held to its limit.

Training (``train_numbers``): the program's first three steps against the
reference's three steps from the same inputs.

* ``loss``: the largest ``|L_prog - L_ref| / |L_ref|`` over the steps;
* ``grad``: the first step's gradient as the optimizer got it (each
  parameter's ``grad`` after the first step); by the worst leaf, the gap
  between the program's norm and the reference's, over the larger of the
  reference's norm of that leaf and of the median leaf;
* ``change``: the same gap for each parameter's change over the three
  steps, ``p3 - p0``, leaving out leaves whose reference gradient is under
  a thousandth of the median leaf's (round-off alone moves those);
* ``grad_diff``, ``change_diff``: the same two by the norm of the
  difference, ``|prog_k - ref_k|``, over the same denominators: a gap of
  norms cannot see a gradient or a change that points the wrong way;
* ``d_value`` (when the edge values need grads): ``d value`` after the
  first step, ``|dv_prog - dv_ref| / |dv_ref|``. ``d value`` is not in the
  optimizer's state, so the norm of the difference, not a gap of norms,
  which could not see entries in the wrong place.

Inference (``eval_numbers``): ``logits``, the largest ``|z_prog - z_ref|``
over the reference's largest ``|z_ref|``, over the last forward's whole
output and the sampled rows of every forward kept from the window.

A readings dict holds ``losses``, ``grad1`` and ``change`` (by leaf, float64)
and ``d_value1`` (or None) for training; ``out`` and ``samples`` for
inference.
"""
import math
from statistics import median
from typing import Dict, List, Optional, Tuple

import torch

LEAF_FLOOR = 1e-3      # a leaf whose reference gradient is under this share
                       # of the median leaf's moves by round-off alone


def _norms(leaves: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double()))
            for k, v in leaves.items()}


def worst_leaf_gap(prog: Dict[str, torch.Tensor],
                   ref: Dict[str, torch.Tensor],
                   keep: Optional[List[str]] = None) -> float:
    """``max_k | |prog_k| - |ref_k| | / max(|ref_k|, median_k |ref_k|)``
    over the leaves ``keep`` (default all); a NaN gap is kept."""
    rn, pn = _norms(ref), _norms(prog)
    med = median(rn.values())
    worst = 0.0
    for k in (keep if keep is not None else list(ref)):
        denom = max(rn[k], med)
        gap = abs(pn[k] - rn[k]) / denom if denom > 0 else math.inf
        worst = gap if not gap <= worst else worst
    return worst


def worst_leaf_diff(prog: Dict[str, torch.Tensor],
                    ref: Dict[str, torch.Tensor],
                    keep: Optional[List[str]] = None) -> float:
    """``max_k |prog_k - ref_k| / max(|ref_k|, median_k |ref_k|)`` over the
    leaves ``keep`` (default all); a NaN is kept."""
    rn = _norms(ref)
    med = median(rn.values())
    worst = 0.0
    for k in (keep if keep is not None else list(ref)):
        denom = max(rn[k], med)
        d = float(torch.linalg.vector_norm(
            prog[k].to(ref[k].device, torch.float64) - ref[k].double()))
        gap = d / denom if denom > 0 else math.inf
        worst = gap if not gap <= worst else worst
    return worst


def moved_leaves(grad1: Dict[str, torch.Tensor]) -> List[str]:
    """The leaves whose reference gradient is at least ``LEAF_FLOOR`` of
    the median leaf's."""
    n = _norms(grad1)
    med = median(n.values())
    return [k for k, v in n.items() if v >= LEAF_FLOOR * med]


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    losses = [abs(a - b) / abs(b) for a, b in zip(prog["losses"],
                                                  ref["losses"])]
    moved = moved_leaves(ref["grad1"])
    out = {"loss": max(losses) if all(map(math.isfinite, losses))
           else math.inf,
           "grad": worst_leaf_gap(prog["grad1"], ref["grad1"]),
           "change": worst_leaf_gap(prog["change"], ref["change"], moved),
           "grad_diff": worst_leaf_diff(prog["grad1"], ref["grad1"]),
           "change_diff": worst_leaf_diff(prog["change"], ref["change"],
                                          moved)}
    if ref.get("d_value1") is not None:
        r = ref["d_value1"].double()
        p = prog["d_value1"].to(r.device, torch.float64)[:r.numel()]
        out["d_value"] = float(torch.linalg.vector_norm(p - r)
                               / torch.linalg.vector_norm(r))
    return {k: (v if math.isfinite(v) else math.inf) for k, v in out.items()}


def eval_numbers(prog: dict, ref_logits: torch.Tensor,
                 rows: torch.Tensor) -> Dict[str, float]:
    ref = ref_logits.double()
    scale = float(ref.abs().max())
    out = prog["out"].to(ref.device, torch.float64)
    worst = float((out - ref).abs().max())
    samples = prog["samples"]
    if samples is not None and samples.numel():
        s = samples.to(ref.device, torch.float64)
        worst = max(worst, float((s - ref[rows.to(ref.device)]).abs().max()))
    v = worst / scale
    return {"logits": v if math.isfinite(v) else math.inf}


def held(numbers: Dict[str, float], limits: Dict[str, dict]
         ) -> List[Tuple[str, float, float, bool]]:
    """``(name, value, limit, ok)`` for every number that has a limit (a
    cell's limits file leaves out a number that nothing separates from
    sound runs); a limit without a number is an error."""
    missing = sorted(set(limits) - set(numbers))
    if missing:
        raise KeyError(f"limits without a number: {missing}")
    return [(k, numbers[k], float(limits[k]["limit"]),
             numbers[k] <= float(limits[k]["limit"])) for k in sorted(limits)]

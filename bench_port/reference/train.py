"""The reference's SGD steps, for any model module of this package."""
from typing import Dict

import torch


def sgd_steps(model, adj, x, y, params: Dict[str, torch.Tensor], mm,
              lr: float, steps: int, value_grad: bool) -> dict:
    """``steps`` steps of ``p -= lr * grad`` from ``params`` (copied): each
    step's loss, the first step's gradients (and ``d value``), and each
    parameter's change over all the steps.

    The parameters stay in the configuration's float32 between steps, as
    in any float32 training run: each step computes in ``x``'s dtype and
    rounds its update to float32 once. Kept in float64, the change would
    differ from a float32 run's by the rounding of the state, which is of
    the size of a step where ``lr * grad`` is small beside the weights."""
    p = {k: v.clone() for k, v in params.items()}
    losses, grad1, dv1 = [], None, None
    for t in range(steps):
        loss, grads, dv = model.gradients(
            adj, x, y, {k: v.to(x.dtype) for k, v in p.items()}, mm,
            value_grad)
        losses.append(loss)
        if t == 0:
            grad1, dv1 = grads, dv
        with torch.no_grad():
            for k in p:
                p[k] = (p[k].to(x.dtype) - lr * grads[k]).to(p[k].dtype)
        del grads, dv
    return {"losses": losses, "grad1": grad1, "d_value1": dv1,
            "change": {k: p[k].double() - params[k].double() for k in p}}

"""Faults planted in the program, under the harness, to show that the
comparison catches them (``calibrate.py`` reads them on the card at a
cell's size; the tests see ``correct`` come out false on the CPU).

* ``unchanged``: a train step that computes the loss and its gradients
  and returns the state unchanged;
* ``half_batch``: the loss over the first half of the nodes, the mean
  taken over that half;
* ``altered``: one row of every SpMM's output scaled by ``1 + 1e-3`` where
  the product is made (``PaddedCOO.spmm``).
"""
import contextlib
import importlib

import torch

FAULTS = {"train": ("unchanged", "half_batch"), "eval": ("altered",)}
ALTERED_ROW = 7
ALTERED_BY = 1e-3


@contextlib.contextmanager
def planted(fault: str, psp):
    entry = importlib.import_module(f"{psp.__name__}.entry")
    if fault == "unchanged":
        name, orig = "train_step", entry.train_step

        def broken(model, adj, x, y, lr):
            model.zero_grad(set_to_none=True)
            loss = entry.gcn_loss(model, adj, x, y)
            loss.backward()
            return loss.detach()
        target = entry
    elif fault == "half_batch":
        name, orig = "gcn_loss", entry.gcn_loss

        def broken(model, adj, x, y):
            half = y.shape[0] // 2
            logp = torch.log_softmax(model(adj, x), dim=-1)[:half]
            return -logp.gather(1, y[:half, None]).mean()
        target = entry
    elif fault == "altered":
        target, name = psp.PaddedCOO, "spmm"
        orig = target.spmm

        def broken(self, x, *a, **k):
            out = orig(self, x, *a, **k)
            scale = torch.ones(out.shape[0], 1, dtype=out.dtype,
                               device=out.device)
            scale[ALTERED_ROW % out.shape[0]] += ALTERED_BY
            return out * scale
    else:
        raise ValueError(f"unknown fault {fault!r}")
    setattr(target, name, broken)
    try:
        yield
    finally:
        setattr(target, name, orig)

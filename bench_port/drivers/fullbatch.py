"""Full-batch GNN training or inference on one card, as OGB's full-batch
examples run it: every step, or every forward, takes the whole graph.

Set-up, from the seed (``graphs.py``): the graph, features, labels and
weights on the device; the program's adjacency (``PaddedCOO.from_arrays``,
``gcn_normalize`` where the model normalizes, the row pointer and, to
train, the CSC view ``structure()``) and its model holding the
benchmark's weights. Then the first steps, which are also the warm-up:

* ``train``: three ``entry.train_step`` calls on the object the window
  then drives, the state read around them (``first_steps``); with
  ``value_grad`` the normalized edge values require grad, and their grad
  is reset before each step;
* ``eval``: two forwards under ``torch.no_grad()``.

The window repeats the same call until ``seconds`` have passed, each step
closed by a ``synchronize`` (OGB's loop reads the loss every epoch), and
ends in one. Inference keeps the sampled rows of each forward (in a ring of
``STASH`` forwards) and the last whole output, for the comparison. After the
window the program's state is freed and the reference runs from the same
seed (``reference_readings``).
"""
import gc
import importlib
import time
from types import SimpleNamespace
from typing import Dict, Optional

import torch

from bench_port import compare, devtrace, graphs
from bench_port.reference import sparse as ref_sparse
from bench_port.reference.train import sgd_steps

SAMPLE_ROWS = 1024        # rows of every forward kept for the comparison
STASH = 64                # forwards whose sampled rows are kept, a ring
FIRST_STEPS = 3           # train steps compared with the reference
WARM_FORWARDS = 2
COUNTERS = {              # launch counters of the program, by kernel
    "spmm_csr": "spmm_csr_cuda",
    "sddmm_csr": "sddmm_csr_cuda",
    "spmm_sddmm_csc": "spmm_sddmm_csc_cuda",
    "fold_pieces": "fold_pieces_cuda",
}
KERNEL_OF_OP = {"spmm": "spmm_csr", "spmm_t": "spmm_csr",
                "sddmm": "sddmm_csr", "spmm_sddmm": "spmm_sddmm_csc"}


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def is_train(cell) -> bool:
    mode = cell.traffic["mode"]
    if mode not in ("train", "eval"):
        raise ValueError(f"unknown mode {mode!r}")
    return mode == "train"


def inputs(cell, model, seed: int, device):
    """Everything a run feeds both sides, from ``seed``, in one draw
    order: graph, features, labels, weights, sampled rows."""
    cfg, tr = cell.config, cell.traffic
    gen = graphs.generator(seed, device)
    g = graphs.graph(gen, tr["graph"], cfg["num_nodes"], cfg["degree"],
                     **tr.get("graph_args", {}))
    x = graphs.features(gen, g.num_nodes, cfg["in_channels"])
    y = graphs.labels(gen, g.num_nodes, cfg["out_channels"])
    params = graphs.weights(gen, model.param_shapes(cfg))
    rows = graphs.sample_rows(gen, g.num_nodes,
                              min(SAMPLE_ROWS, g.num_nodes))
    return g, x, y, params, rows


def expected_launches(cell, model) -> Dict[str, int]:
    """Launches a step (or a forward) of each counted kernel on the path
    the cell names: each sparse op of the equations on its kernel (the
    port's routing, ``ops/spmm.py``), no fold pass; a traffic file may
    state its own (``launches``)."""
    if "launches" in cell.traffic:
        return dict(cell.traffic["launches"])
    out = {k: 0 for k in COUNTERS}
    for op, _ in model.sparse_ops(cell.config, is_train(cell),
                                  cell.traffic["value_grad"]):
        out[KERNEL_OF_OP[op]] += 1
    return out


def launch_counts(psp) -> Dict[str, int]:
    return {k: int(getattr(psp, v).launches) for k, v in COUNTERS.items()}


def prepare(cell, psp, model, seed: int, device, spans: dict):
    """The program's objects for the cell, built from ``seed``."""
    cfg = cell.config
    if cfg["dtype"] != "float32":
        raise ValueError("the fullbatch driver runs float32 alone")
    with torch.profiler.record_function("bench.setup.inputs"):
        g, x, y, params, rows = inputs(cell, model, seed, device)
        n = g.num_nodes
        raw = psp.PaddedCOO.from_arrays(g.row, g.col, g.value, (n, n))
        del g
    sync(device)
    t = time.perf_counter()
    with torch.profiler.record_function("bench.setup.structure"):
        adj = psp.gcn_normalize(raw) if model.NORMALIZE else raw
        del raw
        adj.rowptr()
        adj.row_split()
        if is_train(cell):
            adj.structure()
        sync(device)
    spans["structure_s"] = time.perf_counter() - t
    if cell.traffic["value_grad"]:
        adj.value.requires_grad_()
    net = model.build(psp, cfg, params, device)
    # the module, not the package's ``entry`` (a function of that name)
    entry = importlib.import_module(f"{psp.__name__}.entry")
    return SimpleNamespace(entry=entry, adj=adj, x=x, y=y, model=net,
                           rows=rows,
                           lr=float(cfg["lr"]), n=n, nnz=adj.nnz,
                           value_grad=bool(cell.traffic["value_grad"]))


def _snapshot(net) -> Dict[str, torch.Tensor]:
    return {k: v.detach().clone() for k, v in net.named_parameters()}


def train_step(st):
    """One step of the window's call: ``entry.train_step``, the edge
    values' grad reset first."""
    if st.value_grad:
        st.adj.value.grad = None
    return st.entry.train_step(st.model, st.adj, st.x, st.y, st.lr)


def first_steps(st) -> dict:
    """The first ``FIRST_STEPS`` steps through the window's own call, and
    the readings the comparison takes from the program's state: each
    loss; the first gradient as SGD got it, each parameter's ``grad``
    after the first step (``train_step`` leaves it until the next step
    zeroes it); the change ``p3 - p0``; and ``d value`` after the first
    step (on the host). Float64."""
    p0 = _snapshot(st.model)
    losses, grad1, dv1 = [], None, None
    for t in range(FIRST_STEPS):
        losses.append(train_step(st))
        if t == 0:
            grad1 = {k: p.grad.detach().double()
                     for k, p in st.model.named_parameters()}
            if st.value_grad:
                dv1 = st.adj.value.grad.detach().to("cpu", copy=True)
    p3 = _snapshot(st.model)
    return {"losses": [float(v) for v in losses], "grad1": grad1,
            "change": {k: p3[k].double() - p0[k].double() for k in p0},
            "d_value1": dv1}


def forward(st):
    with torch.no_grad():
        return st.model(st.adj, st.x)


def reference_readings(cell, model, refmod, seed: int, device,
                       control: bool = False) -> dict:
    """The plain reference from the same seed: float64, or for the
    control float32 with TF32 GEMMs. Training: ``sgd_steps`` over the
    first steps; inference: the logits (``logits``) and ``rows``."""
    dtype = torch.float32 if control else torch.float64
    mm = ref_sparse.matmul_for(control)
    g, x, y, params, rows = inputs(cell, model, seed, device)
    adj = ref_sparse.adjacency(g.row, g.col, g.value, g.num_nodes, dtype,
                               normalize=model.NORMALIZE,
                               block_bytes=ref_sparse.BLOCK_BYTES)
    del g
    x = x.to(dtype)
    if is_train(cell):     # the state stays float32 (``sgd_steps``)
        return sgd_steps(refmod, adj, x, y, params, mm,
                         float(cell.config["lr"]), FIRST_STEPS,
                         bool(cell.traffic["value_grad"]))
    params = {k: v.to(dtype) for k, v in params.items()}
    with torch.no_grad():
        return {"logits": refmod.forward(adj, x, params, mm), "rows": rows}


def numbers(cell, prog: dict, ref: dict) -> Dict[str, float]:
    if is_train(cell):
        return compare.train_numbers(prog, ref)
    return compare.eval_numbers(prog, ref["logits"], ref["rows"])


def control_readings(cell, ref: dict) -> dict:
    """The control's outputs in the program's readings' form."""
    if is_train(cell):
        return {"losses": ref["losses"],
                "grad1": {k: v.double() for k, v in ref["grad1"].items()},
                "change": {k: v.double() for k, v in ref["change"].items()},
                "d_value1": ref["d_value1"]}
    z = ref["logits"]
    return {"out": z, "samples": z[ref["rows"]][None]}


def free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def run(cell, psp, model, refmod, seed: int, seconds: float, trace: bool,
        device, t0: float, log) -> dict:
    """One run: set-up, the window, the reference. Returns the measured
    end-to-end values, what the per-layer readers read, and the numbers
    held to the limits."""
    train = is_train(cell)
    cuda = torch.device(device).type == "cuda"
    spans: Dict[str, float] = {}
    st = prepare(cell, psp, model, seed, device, spans)
    sync(device)
    log(f"inputs and structure at {time.perf_counter() - t0:.3f} s "
        f"(structure {spans['structure_s']:.3f} s)")
    prog: Optional[dict] = None
    if train:
        with torch.profiler.record_function("bench.setup.first_steps"):
            prog = first_steps(st)
        log(f"first steps: losses {prog['losses']}")
    else:
        for _ in range(WARM_FORWARDS):
            out = forward(st)
        del out
        stash = torch.empty(STASH, st.rows.numel(), cell.config[
            "out_channels"], device=device)
    sync(device)
    log(f"warm at {time.perf_counter() - t0:.3f} s")
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    before = launch_counts(psp)
    steps, out, losses = 0, None, []
    setup_s = time.perf_counter() - t0
    with devtrace.profiled(trace) as prof:
        with torch.profiler.record_function(devtrace.WINDOW):
            w0 = time.perf_counter()
            deadline = w0 + seconds
            while True:
                with torch.profiler.record_function("bench.step"):
                    if train:
                        losses.append(train_step(st))
                    else:
                        out = forward(st)
                        torch.index_select(out, 0, st.rows,
                                           out=stash[steps % STASH])
                with torch.profiler.record_function("bench.sync"):
                    sync(device)
                steps += 1
                if time.perf_counter() >= deadline:
                    break
            window_s = time.perf_counter() - w0
    tr = devtrace.read(prof) if trace else None
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    after = launch_counts(psp)
    launches = {k: after[k] - before[k] for k in after}
    n, nnz = st.n, st.nnz
    failed = 0
    if train:
        failed = int((~torch.isfinite(torch.stack(losses))).sum())
    else:
        prog = {"out": out, "samples": stash[:min(steps, STASH)]}
    del st, losses
    free(device)

    t = time.perf_counter()
    ref = reference_readings(cell, model, refmod, seed, device)
    nums = numbers(cell, prog, ref)
    del ref, prog, out
    free(device)
    log(f"reference and comparison: {time.perf_counter() - t:.3f} s")

    expect = expected_launches(cell, model)
    per_step = {k: v / steps for k, v in launches.items()}
    log(f"launches per {'step' if train else 'forward'} in the window: "
        f"{per_step}; expected {expect}")
    # the path check counts on the card only: the plain versions that a
    # CPU run takes count no launch
    path_off = (sum(launches[k] != expect.get(k, 0) * steps
                    for k in launches) if cuda else None)
    e2e = {("train_step_ms" if train else "forward_ms"):
           window_s * 1e3 / steps,
           "peak_mem_gb": peak / 1e9, "setup_s": setup_s}
    return {"e2e": e2e, "numbers": nums, "attempted": steps,
            "failed": failed, "memory_peak_bytes": max(peak, setup_peak),
            "window_s": window_s, "trace": tr, "spans": spans,
            "launches": launches, "path_off": path_off, "train": train,
            "n": n, "nnz": nnz}

"""Measurements of paddle_sparse_tpu_torch on one NVIDIA GPU (written for an
H100) that ``chip_smoke.py`` does not take on every run. Run from the
repository root:

    python3 chip_probe.py sweep        # the long-row cap sweep
    python3 chip_probe.py ab PARENT    # this tree against another, in turns
    python3 chip_probe.py calls PARENT [PAIRS]   # small calls, in turns
    python3 chip_probe.py gat          # where a GAT step's device time goes
    python3 chip_probe.py sage         # and a GraphSAGE step's
    python3 chip_probe.py launch       # a kernel launch's host path
    python3 chip_probe.py slice        # P5's per-chunk kernel, part by part
    python3 chip_probe.py band         # P4 nodot, part by part
    python3 chip_probe.py fused [PARENT]   # the fused backward, by parts
    python3 chip_probe.py probes       # P3's, P4's and P5's calls, by kernel
    python3 chip_probe.py gloo         # which collectives gloo runs on CUDA
    python3 chip_probe.py strided      # K1 on GAT's head views vs copies

``sweep``: the span kernels, K1 and K2 alone at K=256 on the bench's zipf
graph at 1/8 scale (``chip_smoke.bench_graph``) for each piece size ``cap``
in 512 ... 16384, each timed with CUDA events after a warm-up, in f32 and
bf16, and on the uniform graph, which no cap in that range splits. One JSON
line per cap.

``ab PARENT``: the whole calls of ``launch`` (P1, P2 and K1 host ns and
event ms per call beside their library calls, P1's and P2's output hashes,
the toy GCN's forward and train step ms; P3, P4's three modes and P5's two
variants at their probes' defaults: CUDA-event ms per call and the hash of
each output), the uniform GCN forward (phase
4), train step (phase 5) and its peak memory, the fused CSC backward's
pass at K=256 f32 there as phase 5 times it (``k2p_ms``, beside the pair it
replaced), forward and forward+backward ms and peak memory of phase 7c's
seg2 f32 and bf16 on the uniform graph (seg2 f32 also the fused span
backward's launch alone and as routed, ``k2pp_launch_ms`` and
``k2pp_routed_ms``), split on the clustered graph, seg2 on zipf at
1/8 (bf16), and seg2 and split on zipf at 1/8 transposed (bf16: its hub
rows become x rows, cut into pieces, as in a symmetric power-law graph),
and the four A @ A paths
of phase 6c (800k rowsorted, 10M rowsorted and rowblocked, zipf padded:
ms per call, and K5 alone on the call's compress input) of
``chip_smoke.py``, run from ``PARENT`` (another checkout, e.g. ``git
archive`` of the parent commit) and from this tree in turns: parent, this,
this, parent, each in a process of its own. One JSON line per run, then
their summary (each output hash: equal in every run, and within each
side's two runs, or not).

``calls PARENT [PAIRS]``: the small, host-bound calls of ``ab``
(:func:`small_calls`: K1 at M = N = 256, K = 64 and ``torch.mul`` and
``view().sum(1)`` beside it, which run no code of the port, host ns and
CUDA-event ms per back-to-back call; the toy GCN's forward and train step
ms; and, where the tree has them, the host ns of the checks that integer
operands added to K1's path, each alone) from ``PARENT`` and from this
tree, each run a process of its own, in
``PAIRS`` pairs (default 10) whose first side alternates (parent, this;
this, parent; ...). One JSON line per run, then their summary: each
side's runs, their medians, the change of the median, and in how many
pairs this tree read more than the parent.

``gat``: first the attention pass (``gat_attention_cuda``: node scores,
then each row's edge softmax) at the shapes of the benchmark's
``gat-products.eval`` (the uniform graph of ``chip_smoke.products_graph``,
2,449,029 nodes of degree 50; 4 heads of 128, then 4 of 47):
``chip_smoke.gat_attention_check``'s CUDA-event ms of the call, of the
node scores and of the edge pass alone, its bound, the plain version's ms
and the two compared; one JSON line a shape; then the cell's model (PyG's
3 layers of 4 heads, the output heads averaged, bias and skips) on that
graph: the host ms of a forward under ``no_grad`` and its attention passes
and K1 launches (3 and 12). Then ``chip_smoke.py`` phase 8d's GAT (3 layers, 4
heads of 64, output 47) on the zipf graph at 1/8 scale: its gather of 15.76M
rows of 4 floats by the row groups' entry index, ``index_select`` against
``take_rows``, each timed alone with CUDA events; then, after a warm-up, one
forward
and one train step, each timed on the host clock around a synchronize and
then run once more under ``torch.profiler``; one JSON line each with the
device time, the kernels that took the most of it and the aten ops that
launched the most (their device time, children included).

``sage``: the same profile of ``chip_smoke.py`` phase 8c's GraphSAGE
(100 -> 256 -> 256 -> 47, mean) at ogbn-products scale.

``launch``: the host path from a wrapper to ``cudaLaunchKernel``, stage by
stage, for P1 (``scale2_cuda`` at (256, 128) f32) and P2 (``chunk_sum_cuda``
at ``bisect_pallas.dma_inputs``, one and two slots): the checks, the output
allocation, the library handle, the device guard or check, the stream, the
ctypes call with and without the launch, each alone over 10,000 calls after
a warm-up (host ns per call, one synchronize at the end), in the wrappers'
former path and in this one (``_build.launch``); then the whole calls as
``ab`` takes them.

``slice``: P5's per-chunk kernel as it was before its reduce was
redesigned (one CTA per (chunk, 128 columns), the slice part and the
chunk's indices in shared memory; ``chip_probe_slice.cu``, built here into
the package's ``build/chip_probe_slice/``, no part of the package) at
``r5_vmem_expand``'s defaults, each variant whole, with the slice load
alone and with the edge loop alone, in turns (whole, load, loop, loop,
load, whole; CUDA events, 5 calls after a warm-up), with the microseconds
of one wave of CTAs on the card. One JSON line.

``band``: P4 nodot (``band_ablate_cuda("nodot", ...)``) at
``r4_band_cost``'s defaults, part by part, beside the kernel it had before
its redesign (``chip_probe_band.cu``, built here into the package's
``build/chip_probe_band/``, no part of the package): that kernel whole,
its walk alone (a store only where a count equals a sentinel no input
reaches) and its fill alone (the same grid storing a constant); fills of
the same bytes in equal contiguous ranges, one a CTA, by 16-byte streaming
stores and by bulk stores from shared memory, at 1, 2, 4 and 8 CTAs an
SM; the one-round count of every tile alone; the package's call; and
``torch.empty(...).fill_(1.0)``, the card's own store rate on those
bytes. Each checked (equal to the plain version, or every value stored),
then its device time under ``torch.profiler`` over 100 calls and CUDA
events in turns (100 calls each, the order and back); then the wrapper's
host path stage by stage (checks, allocation, ``_index32``, launch) and
its whole call back to back (host ns and event ms per call, 300 calls).
One JSON line.

``fused [PARENT]``: the fused CSC backward (K2', ``spmm_sddmm_csc_cuda``)
at phase 5's graph (``chip_smoke.py``'s GCN-normalized
ogbn-products-scale graph), K=256 f32, part by part: a copy of the kernel
as it was before its redesign (``chip_probe_fused.cu``, built here into
the package's ``build/chip_probe_fused/``, no part of the package) whole;
with value read, d value written, or both at the CSC position (the values
relayed before, d value read back after); with the dots off (d x alone);
with the per-edge butterfly replaced by one halving exchange per batch,
merged in groups of 4 or over the whole batch in registers; with the
broadcast shuffles replaced by a shared-memory stage of the batch's (row,
value); with at most 64 or 72 registers (8 or 7 blocks an SM); with the
edge loop unrolled 2 times; and combinations. With ``PARENT`` (another
checkout, e.g. ``git archive`` of the parent commit) also that
checkout's own ``csrc/spmm_sddmm_csc.cu`` (built alone into
``build/chip_probe_fused_parent/``): the former kernel as it ran, beside
its copy. Beside them the package's launch alone (values in CSC order) and
as the backward runs it (both relays), each relay alone (``value[perm]``,
``d value_t[inv_perm]``), the zeroed d value buffer, ``invert_perm``, the
scatter the relay replaces (``index_copy_`` at ``perm``), K1 over the CSC
view (the same gathered rows, d x alone) and the pair K2' replaced. Then
the span form (K2'') on phase 7c's seg2 f32 path, values relayed: the
copy with the per-edge butterfly and with each exchange, the package's
launch and PARENT's. Each checked once (d x and d value bit for bit equal
to the copy's whole, which equals the pair's), then its device time under
``torch.profiler`` and CUDA events in turns (the order and back, 3 calls
each). Also ``nvcc -Xptxas -v`` of both sources: registers and spills of
the f32 kernels, the most registers and any spills over all. One JSON
line.

``probes``: P3 (``span_colsum_cuda`` and ``span_colsum_staged_cuda``),
P4's three modes (``band_ablate_cuda``) and P5's reduce
(``slice_gather_cuda``, at ``r5_vmem_expand``'s defaults and at 2,049
edges a chunk, past the TF32 path) at their probes' defaults, P4's output
allocation alone, and each plan alone on the card and in torch ops: each
call's device time kernel by kernel under ``torch.profiler`` (10 calls
after a warm-up; 100 for P4) and its host time per call (as many calls,
no synchronize between them). One JSON line per call. First, before
anything else fills the process's caching allocator, P5's reduce, its
plan, its output's allocation alone, P3 and P4's output allocation on a
cold pool (:func:`cold_pool`: each call alone after ``empty_cache()``,
the segments it took from the driver) and on the warm one: a ``COLD``
line each.

``gloo``: whether the gloo backend takes CUDA tensors for each collective
of ``paddle_sparse_tpu_torch/parallel/collectives.py`` (all-gather,
reduce-scatter, all-to-all, the ring's ``batch_isend_irecv``) and the
train step's all-reduce and broadcast: for each, two fresh ranks on card 0
(``torch.multiprocessing`` spawn, a file store, a 30 s timeout) call it
once; each rank's outcome (ok, or the error it raised), or that a rank
died. One JSON line.

``strided``: K1 (``spmm_csr_cuda``) on GAT's head views against the same
launch on contiguous operands, on a uniform graph of ``gat-products.eval``'s
size (2,449,029 rows of 50 entries, seed 3), at D = 47 and 128 with H = 4:
``x`` contiguous or the view ``hw[:, 1]`` (row stride H * D, or 2 * D),
``out`` contiguous or the view ``buf[:, 1]``; CUDA-event ms a launch (8
launches after a warm-up) in 3 rounds of every case in turn. One line a
case, then one JSON line.

Each prints the card's ``nvidia-smi`` name and power limit and exits
non-zero without a card.
"""
import ctypes
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

CAPS = (512, 1024, 2048, 4096, 8192, 16384)
REPS = 5

# the phases one A/B run takes, from the checkout it runs in
AB_RUN = r"""
import importlib.util, json, sys, torch, chip_smoke as c
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda", 0)
spec = importlib.util.spec_from_file_location("probe_here", sys.argv[1])
probe = importlib.util.module_from_spec(spec)
spec.loader.exec_module(probe)
print("AB_LAUNCH " + json.dumps(probe.whole_calls(dev)), flush=True)
adj, x, model, _ = c.phase4_forward(dev, "")
torch.cuda.empty_cache()
fused = c.phase5_train(dev, "", adj, x, model)["fused"]
print("AB_FUSED " + json.dumps({"k2p_ms": fused["ms"],
                                "k2p_pair_ms": fused["pair_ms"]}))
del adj, x, model, fused
torch.cuda.empty_cache()
packed = {}
for key, kind, scale, backend, stream, transpose, kw in (
        ("seg2_f32", "uniform", 1.0, "seg2", "f32", False, {}),
        ("seg2_bf16", "uniform", 1.0, "seg2", "bf16", False, {}),
        ("split_bf16", "clustered", 1.0, "seg2split", "bf16", False,
         {"block": 2048}),
        ("seg2_zipf_bf16", "zipf", 0.125, "seg2", "bf16", False, {}),
        ("seg2_zipf_t_bf16", "zipf", 0.125, "seg2", "bf16", True, {}),
        ("split_zipf_t_bf16", "zipf", 0.125, "seg2split", "bf16", True,
         {"block": 2048})):
    graph = c.bench_graph(dev, kind, scale, 256)
    if transpose:          # the hub rows become x rows
        row, col, val, x = graph
        order = torch.argsort(col, stable=True)
        graph = (col[order], row[order], val[order], x)
        del row, col, val, x, order
    st = c.phase7c_path(dev, "", key, backend, graph, stream, **kw)
    packed[key] = {k: st["stats"][k]
                   for k in ("fwd_ms", "fwd_bwd_ms", "peak_gb")}
    if key == "seg2_f32":        # K2'', launched alone and as routed
        args = (st["plan"], st["s"], st["packed"], graph[3], st["gw"])
        with torch.inference_mode():
            vt = st["packed"].index_select(0, st["s"].relay_ft)
            packed[key]["k2pp_launch_ms"] = c.timed(c.dropped(
                lambda: c.fused_span_kernel(*args, relayed=vt)), 5)[0]
            packed[key]["k2pp_routed_ms"] = c.timed(c.dropped(
                lambda: c.fused_span_kernel(*args)), 5)[0]
        del args, vt
    del graph, st
    torch.cuda.empty_cache()
print("AB_PACKED " + json.dumps(packed))
sp = c.phase6c_spgemm(dev, "")
print("AB_SPGEMM " + json.dumps({p: {"ms": v["ms"], "k5_ms": v["k5"]["ms"]}
                                 for p, v in sp.items()}))
"""


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def sweep() -> None:
    import chip_smoke as c
    from paddle_sparse_tpu_torch import (ind2ptr, make_seg2_plan,
                                         pack_values, sddmm_csr_cuda,
                                         sddmm_spans_cuda, spmm_csr_cuda,
                                         spmm_spans_cuda, split_rows)
    dev = torch.device("cuda", 0)
    card = card_line()
    for kind, scale in (("zipf", 0.125), ("uniform", 1.0)):
        row, col, val, x = c.bench_graph(dev, kind, scale, 256)
        n, K = x.shape
        plan, s = make_seg2_plan(row, col, n, n, feat_dim=K)
        packed = pack_values(s, val)
        st, en = s.rp_f[:, :n], s.rp_f[:, 1:n + 1]
        rowptr = ind2ptr(row, n).to(torch.int32)
        g = torch.randn(n, K, generator=torch.Generator(
            device=dev).manual_seed(12), device=dev)
        longest = int(torch.diff(rowptr).max())
        for cap in CAPS:
            t_sp = split_rows(st, en, cap)
            t_csr = split_rows(rowptr[None, :-1], rowptr[None, 1:], cap)
            res = {"graph": f"{kind} {scale}", "nnz": row.numel(),
                   "longest_row": longest, "cap": cap,
                   "split_rows": 0 if t_sp is None
                   else t_sp.fold_row.numel(),
                   "pieces": 0 if t_sp is None else t_sp.num_slots}
            with torch.inference_mode():
                for dt in (torch.float32, torch.bfloat16):
                    xd, gd, pd, vd = x.to(dt), g.to(dt), packed.to(dt), \
                        val.to(dt)
                    name = str(dt)[6:]
                    res[f"spmm_spans_{name}"] = c.timed(
                        lambda: spmm_spans_cuda(st, en, s.col_f, pd,
                                                s.sbase_f, xd, out_dtype=dt,
                                                split=t_sp), REPS)[0]
                    res[f"sddmm_spans_{name}"] = c.timed(
                        lambda: sddmm_spans_cuda(st, en, s.col_f, s.sbase_f,
                                                 gd, xd, split=t_sp),
                        REPS)[0]
                    res[f"spmm_csr_{name}"] = c.timed(
                        lambda: spmm_csr_cuda(rowptr, col, vd, xd,
                                              split=t_csr), REPS)[0]
                    res[f"sddmm_csr_{name}"] = c.timed(
                        lambda: sddmm_csr_cuda(rowptr, col, gd, xd,
                                               split=t_csr), REPS)[0]
                    del xd, gd, pd, vd
            print("SWEEP " + json.dumps(res) + f" [{card}]", flush=True)
            if t_sp is None and t_csr is None and cap != CAPS[0]:
                break       # nothing splits from here on: the same launches
        del row, col, val, x, plan, s, packed, g
        torch.cuda.empty_cache()


def _ab_run(where: Path) -> dict:
    env = dict(os.environ, PYTHONPATH=str(where))
    out = subprocess.run([sys.executable, "-c", AB_RUN,
                          str(Path(__file__).resolve())], cwd=where, env=env,
                         capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"A/B run in {where} failed:\n{out.stdout[-3000:]}"
                           f"\n{out.stderr[-3000:]}")

    def mean(pattern):
        return float(re.search(pattern + r".*?\(mean ([0-9.]+)",
                               out.stdout).group(1))
    launches = json.loads(re.search(r"^AB_LAUNCH (.*)$", out.stdout,
                                    re.M).group(1))
    packed = json.loads(re.search(r"^AB_PACKED (.*)$", out.stdout,
                                  re.M).group(1))
    fused = json.loads(re.search(r"^AB_FUSED (.*)$", out.stdout,
                                 re.M).group(1))
    spgemm = json.loads(re.search(r"^AB_SPGEMM (.*)$", out.stdout,
                                  re.M).group(1))
    peak = re.search(r"phase 5 train step ms.*?peak mem ([0-9.]+) GB",
                     out.stdout)
    return {"tree": str(where), "gcn_forward_ms": mean(r"phase 4 forward ms"),
            "gcn_train_step_ms": mean(r"phase 5 train step ms"),
            "gcn_train_peak_gb": float(peak.group(1)),
            **fused, **launches,
            **{f"{p}_{k}": v[k] for p, v in packed.items() for k in v},
            **{f"{p}_{k}": v[k] for p, v in spgemm.items() for k in v}}


def calls(parent: Path, pairs: int) -> None:
    here = Path(__file__).resolve().parent
    parent = parent.resolve()
    card = card_line()
    runs = []
    for i in range(pairs):
        for where in ((parent, here) if i % 2 == 0 else (here, parent)):
            env = dict(os.environ, PYTHONPATH=str(where))
            out = subprocess.run([sys.executable, "-c", CALLS_RUN,
                                  str(Path(__file__).resolve())], cwd=where,
                                 env=env, capture_output=True, text=True)
            if out.returncode != 0:
                raise RuntimeError(f"run in {where} failed:\n"
                                   f"{out.stdout[-3000:]}\n"
                                   f"{out.stderr[-3000:]}")
            r = json.loads(re.search(r"^CALLS (.*)$", out.stdout,
                                     re.M).group(1))
            r.update(pair=i, side="parent" if where == parent else "change")
            runs.append(r)
            print("CALLS " + json.dumps(r) + f" [{card}]", flush=True)
    summary = {"pairs": pairs}
    for k in [k for k in runs[0] if k.endswith(("_ms", "_ns"))]:
        side = {sd: [r[k] for r in runs if r["side"] == sd]
                for sd in ("parent", "change")}
        if None in side["parent"]:          # this tree's code alone
            summary[k] = {"change": side["change"], "change_median": sorted(
                side["change"])[pairs // 2]}
            continue
        med = {sd: sorted(v)[len(v) // 2] for sd, v in side.items()}
        summary[k] = {**side, "parent_median": med["parent"],
                      "change_median": med["change"],
                      "change_vs_parent_median_pct":
                      100 * (med["change"] / med["parent"] - 1),
                      "pairs_change_above": sum(
                          c > p for p, c in zip(side["parent"],
                                                side["change"]))}
    print("CALLS_SUMMARY " + json.dumps(summary) + f" [{card}]", flush=True)


def ab(parent: Path) -> None:
    here = Path(__file__).resolve().parent
    card = card_line()
    runs = []
    for where in (parent, here, here, parent):
        r = _ab_run(where.resolve())
        r["side"] = "parent" if where == parent else "change"
        runs.append(r)
        print("AB " + json.dumps(r) + f" [{card}]", flush=True)
    summary = {k: {"every_run": len({r[k] for r in runs}) == 1,
                   "within_each_side": all(
                       len({r[k] for r in runs if r["side"] == side}) == 1
                       for side in ("parent", "change"))}
               for k in runs[0] if k.endswith("_sha")}   # bit for bit
    for k in [k for k in runs[0] if k.endswith(("ms", "gb", "_ns", "_us"))
              and all(r[k] is not None for r in runs)]:
        p = [r[k] for r in runs if r["side"] == "parent"]
        c = [r[k] for r in runs if r["side"] == "change"]
        summary[k] = {"parent": p, "change": c,
                      "change_vs_parent_pct":
                      100 * (sum(c) / sum(p) - 1)}
    print("AB_SUMMARY " + json.dumps(summary) + f" [{card}]", flush=True)


GAT_CELL_SHAPES = ((4, 128), (4, 47))    # gat-products: hidden, last layer


def gat_attention_cell(dev: torch.device, card: str) -> None:
    """The attention pass at ``gat-products.eval``'s shapes against its
    bound and its plain version (``chip_smoke.gat_attention_check``), one
    JSON line a shape; then the cell's model: a forward's host ms, its
    attention passes and K1 launches."""
    import chip_smoke as c
    from paddle_sparse_tpu_torch import (gat_attention_cuda, init_gat,
                                         spmm_csr_cuda)
    adj, x = c.products_graph(dev)
    adj = adj.with_value(None)
    for H, D in GAT_CELL_SHAPES:
        res = c.gat_attention_check("probe", card, adj, H, D)
        print("GAT_ATTENTION " + json.dumps({
            "nodes": adj.N, "entries": adj.capacity, "heads": H,
            "channels": D, **res}) + f" [{card}]", flush=True)
        torch.cuda.empty_cache()
    # the cell's model: PyG's stacking, forwards under no_grad
    model = init_gat(torch.Generator().manual_seed(0), c.GCN_DIMS[0], 128,
                     c.GCN_DIMS[2], heads=4, num_layers=3, device=dev,
                     out_heads=4, bias=True, skip=True)
    with torch.no_grad():
        model(adj, x)
        torch.cuda.synchronize()
        before = (gat_attention_cuda.launches, spmm_csr_cuda.launches)
        t0 = time.perf_counter()
        for _ in range(3):
            model(adj, x)
        torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / 3 * 1e3
    per = [(gat_attention_cuda.launches - before[0]) / 3,
           (spmm_csr_cuda.launches - before[1]) / 3]
    print("GAT_CELL_FORWARD " + json.dumps({
        "ms": ms, "attention_passes": per[0], "k1": per[1]})
        + f" [{card}]", flush=True)
    c.check(per == [3, 12], f"the cell's forward: {per} attention passes "
                            f"and K1 launches, not 3 and 12")
    del adj, x, model
    torch.cuda.empty_cache()


def gat(dev: torch.device) -> None:
    import chip_smoke as c

    from paddle_sparse_tpu_torch import PaddedCOO, init_gat
    card = card_line()
    gat_attention_cell(dev, card)
    row, col, val, x = c.bench_graph(dev, "zipf", 0.125, c.GCN_DIMS[0])
    n = x.shape[0]
    adj = PaddedCOO.from_arrays(row, col, val, (n, n))
    del row, col, val
    adj.structure()
    model = init_gat(torch.Generator().manual_seed(0), c.GCN_DIMS[0],
                     c.GAT_HIDDEN, c.GCN_DIMS[2], heads=c.GAT_HEADS,
                     num_layers=3, device=dev)
    y = torch.randint(0, c.GCN_DIMS[2], (n,), generator=torch.Generator(
        device=dev).manual_seed(5), device=dev)

    # the gather edge_softmax uses against index_select, on its own indices
    from paddle_sparse_tpu_torch.ops.segment import take_rows
    groups = adj.row_groups()
    table = torch.randn(groups.group_row.numel(), c.GAT_HEADS, device=dev)
    idx = groups.entry_group
    res = {"index_select": c.timed(lambda: table.index_select(0, idx), 5)[0],
           "take_rows": c.timed(lambda: take_rows(table, idx), 5)[0]}
    print("GAT_GATHERS " + json.dumps({"rows": idx.numel(),
                                       "width": c.GAT_HEADS, "ms": res})
          + f" [{card}]", flush=True)
    del table

    profile_model("GAT", card, model, adj, x, y)


def profile_model(name, card, model, adj, x, y) -> None:
    """After a warm-up, one forward (inference mode) and one train step,
    each timed on the host clock around a synchronize and then run once
    more under ``torch.profiler``: one JSON line each with the device time,
    the kernels that took the most of it and the aten ops that launched the
    most (their device time, children included)."""
    import time

    import chip_smoke as c
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from paddle_sparse_tpu_torch import train_step

    def forward():
        with torch.inference_mode():
            return model(adj, x)

    for part, run in (("forward", forward),
                      ("train_step",
                       lambda: train_step(model, adj, x, y, c.LR))):
        run()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        ev = prof.key_averages()
        kernels = sorted((e for e in ev if e.device_type == DeviceType.CUDA),
                         key=lambda e: e.self_device_time_total,
                         reverse=True)
        ops = sorted((e for e in ev if e.device_type == DeviceType.CPU
                      and e.key.startswith("aten::")),
                     key=lambda e: e.device_time_total, reverse=True)
        print(f"{name}_PROFILE " + json.dumps({
            "part": part, "host_ms": host_ms,
            "device_ms": sum(e.self_device_time_total for e in kernels) / 1e3,
            "kernels": [[e.key[:90], e.self_device_time_total / 1e3, e.count]
                        for e in kernels[:15]],
            "aten_ops": [[e.key, e.device_time_total / 1e3, e.count]
                         for e in ops[:15]]}) + f" [{card}]", flush=True)


def sage(dev: torch.device) -> None:
    import chip_smoke as c

    from paddle_sparse_tpu_torch import init_sage
    adj, x = c.products_graph(dev)
    adj.structure()
    model = init_sage(torch.Generator().manual_seed(0), *c.GCN_DIMS,
                      num_layers=3, device=dev)
    y = torch.randint(0, c.GCN_DIMS[2], (x.shape[0],),
                      generator=torch.Generator(device=dev).manual_seed(5),
                      device=dev)
    adj.value.requires_grad_()
    profile_model("SAGE", card_line(), model, adj, x, y)


CALLS = 10_000          # calls per host-timed loop of ``launch``


# one run of ``calls``, from the checkout it runs in
CALLS_RUN = r"""
import importlib.util, json, sys, torch
dev = torch.device("cuda", 0)
spec = importlib.util.spec_from_file_location("probe_here", sys.argv[1])
probe = importlib.util.module_from_spec(spec)
spec.loader.exec_module(probe)
print("CALLS " + json.dumps(probe.small_calls(dev)), flush=True)
"""


def per_call(fn, n=CALLS):
    """``fn``'s host ns and CUDA-event ms per back-to-back call: ``n`` calls
    after 100 of warm-up, the host clock read around the loop, events
    recorded before and after it, one synchronize at the end."""
    for _ in range(100):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    t0 = time.perf_counter_ns()
    for _ in range(n):
        fn()
    t1 = time.perf_counter_ns()
    b.record()
    torch.cuda.synchronize()
    return (t1 - t0) / n, a.elapsed_time(b) / n


def _former_stages(x, ptr, src, E):
    """The statements of ``scale2_cuda`` and ``chunk_sum_cuda`` as they
    launched before ``_build.launch`` (a device guard, a ``Stream`` object
    for its handle, a locked library load, copies of contiguous inputs), one
    stage each, copied here so that they time the same on any tree."""
    import threading

    from paddle_sparse_tpu_torch.ops.kernels import _build

    def on_card(fn, t):
        if t.device.type not in ("cpu", "cuda"):
            raise ValueError(fn)
        return t.device.type == "cuda"

    def same_device(fn, dev, **tensors):
        for name, t in tensors.items():
            if t is not None and t.device != dev:
                raise ValueError(f"{fn}: {name}")

    def checks_scale2():
        on_card("scale2_cuda", x)
        if x.dtype != torch.float32:
            raise TypeError
        x.contiguous()
        x.numel()

    def checks_chunk_sum():
        on_card("chunk_sum_cuda", src)
        same_device("chunk_sum_cuda", src.device, ptr=ptr)
        if src.dtype != torch.float32 or src.dim() != 2:
            raise TypeError
        s = src.contiguous()
        T, K = ptr.numel() - 1, s.shape[1]
        if (E * K) % 4 or s.data_ptr() % 16 != 0:
            raise ValueError
        if T > 65535:
            raise ValueError

    lock = threading.Lock()

    def library():
        with lock:
            if _build._lib is None:
                raise RuntimeError("library not loaded")
            return _build._lib

    def guard():
        with torch.cuda.device(src.device):
            pass

    T, K = ptr.numel() - 1, src.shape[1]
    return {
        "scale2": {
            "checks": checks_scale2,
            "alloc": lambda: torch.empty_like(x),
            "load_library": library, "device_guard": guard,
            "stream": lambda: torch.cuda.current_stream().cuda_stream},
        "chunk_sum": {
            "checks": checks_chunk_sum,
            "index32": lambda: ptr.reshape(-1).to(torch.int32).contiguous(),
            "alloc": lambda: torch.empty((T * E, K), dtype=torch.float32,
                                         device=src.device),
            "load_library": library, "device_guard": guard,
            "stream": lambda: torch.cuda.current_stream().cuda_stream}}


def _sha(t: torch.Tensor) -> str:
    import hashlib
    return hashlib.sha256(t.cpu().contiguous().view(torch.uint8).numpy()
                          .tobytes()).hexdigest()[:16]


def _toy_calls(dev: torch.device, res: dict) -> None:
    """The toy GCN of phases 3 and 3b (32 -> 64 -> 8, 256 nodes): forward
    and train step ms on the host clock over 200 calls ended by a
    synchronize, and the kernel launches of one call, into ``res``."""
    import chip_smoke as c
    from paddle_sparse_tpu_torch import entry, train_entry, train_step
    model, adj, xt = entry(dev)
    tmodel, tadj, txt, ty = train_entry(dev)
    tadj.value.requires_grad_()

    def forward():
        with torch.inference_mode():
            return model(adj, xt)
    for key, fn in (("toy_forward", forward),
                    ("toy_train_step", lambda: train_step(
                        tmodel, tadj, txt, ty, c.LR))):
        fn()
        torch.cuda.synchronize()
        c._zero_launch_counts()
        fn()
        torch.cuda.synchronize()
        res[f"{key}_launches"] = sum(
            v for k, v in c._launch_counts().items()
            if k != "segcompact_row_sorted")
        t0 = time.perf_counter()
        for _ in range(200):
            fn()
        torch.cuda.synchronize()
        res[f"{key}_ms"] = (time.perf_counter() - t0) * 1e3 / 200


def _small_k1(dev: torch.device, g: torch.Generator):
    """K1's small-call inputs: M = N = 256, K = 64, 2,048 edges."""
    M = N = 256
    rowptr = torch.arange(0, M * 8 + 1, 8, dtype=torch.int32, device=dev)
    col = torch.randint(0, N, (M * 8,), generator=g, device=dev,
                        dtype=torch.int32)
    val = torch.rand(M * 8, generator=g, device=dev)
    xk = torch.randn(N, 64, generator=g, device=dev)
    return rowptr, col, val, xk


def small_calls(dev: torch.device) -> dict:
    """K1 at its small-call shape (``split=None``), ``torch.mul`` on a
    (256, 128) f32 tensor and ``view().sum(1)`` on P2's probe input (host
    ns and CUDA-event ms per back-to-back call), and :func:`_toy_calls`;
    on any tree of the port. Where the tree has them, the host ns of the
    checks the integer operands added to K1's wrapper
    (``kernel_operands``) and to the entry (its mixed-pair test) on the
    same f32 operands, each alone; else None."""
    from paddle_sparse_tpu_torch import spmm_csr_cuda
    from paddle_sparse_tpu_torch.experiments import bisect_pallas as bp
    x = torch.ones((256, 128), device=dev)
    ptr, src = bp.dma_inputs(dev)
    T, E, K = bp.T, bp.E, src.shape[1]
    rowptr, col, val, xk = _small_k1(
        dev, torch.Generator(device=dev).manual_seed(1))
    res = {}
    empty_ns, _ = per_call(lambda: None)
    for key, fn in (
            ("k1", lambda: spmm_csr_cuda(rowptr, col, val, xk, split=None)),
            ("torch_mul", lambda: torch.mul(x, 2.0)),
            ("view_sum", lambda: src.view(T, bp.CHUNKS_PER_TILE, E, K)
             .sum(1))):
        host, ev = per_call(fn)
        res[f"{key}_host_ns"] = host - empty_ns
        res[f"{key}_events_ms"] = ev
    from paddle_sparse_tpu_torch.ops.kernels import spmm_cuda
    ops = getattr(spmm_cuda, "kernel_operands", None)
    res["k1_kernel_operands_host_ns"] = None if ops is None else \
        per_call(lambda: ops(val, xk))[0] - empty_ns
    res["entry_mixed_pair_test_host_ns"] = None if ops is None else \
        per_call(lambda: val.is_floating_point()
                 != xk.is_floating_point())[0] - empty_ns
    _toy_calls(dev, res)
    return res


def whole_calls(dev: torch.device) -> dict:
    """Whole calls through the public wrappers, on any tree of the port: P1
    and P2 (both depths) at the probe's shapes and their library calls (host
    ns and CUDA-event ms per back-to-back call, ``torch.profiler`` device ms),
    the hash of each probe's output on seeded random inputs of those shapes,
    K1 (``spmm_csr_cuda``, M = N = 256, K = 64, 2,048 edges, ``split=None``)
    beside ``torch.sparse.mm``, :func:`probe_calls` (P3-P5), and
    :func:`_toy_calls`."""
    import chip_smoke as c
    from paddle_sparse_tpu_torch import spmm_csr_cuda
    from paddle_sparse_tpu_torch.experiments import bisect_pallas as bp
    from paddle_sparse_tpu_torch.ops.kernels.probes_cuda import (
        chunk_sum_cuda, scale2_cuda)
    x = torch.ones((256, 128), device=dev)
    ptr, src = bp.dma_inputs(dev)
    T, E, K = bp.T, bp.E, src.shape[1]
    res = {}
    empty_ns, _ = per_call(lambda: None)
    for key, fn in (
            ("p1", lambda: scale2_cuda(x)),
            ("torch_mul", lambda: torch.mul(x, 2.0)),
            ("p2_one_slot", lambda: chunk_sum_cuda(ptr, src, E, False)),
            ("p2_two_slots", lambda: chunk_sum_cuda(ptr, src, E, True)),
            ("view_sum", lambda: src.view(T, bp.CHUNKS_PER_TILE, E, K)
             .sum(1))):
        host, ev = per_call(fn)
        res[f"{key}_host_ns"] = host - empty_ns
        res[f"{key}_events_ms"] = ev
        res[f"{key}_device_ms"] = c.device_ms(fn, 200)[0]
    g = torch.Generator(device=dev).manual_seed(1)
    xr = torch.randn((256, 128), generator=g, device=dev)
    sr = torch.randn(src.shape, generator=g, device=dev)
    res["p1_sha"] = _sha(scale2_cuda(xr))
    for db, key in ((False, "p2_one_slot"), (True, "p2_two_slots")):
        res[f"{key}_sha"] = _sha(chunk_sum_cuda(ptr, sr, E, db))

    rowptr, col, val, xk = _small_k1(dev, g)
    A = torch.sparse_csr_tensor(rowptr, col, val, (256, 256))
    for key, fn in (("k1", lambda: spmm_csr_cuda(rowptr, col, val, xk,
                                                 split=None)),
                    ("sparse_mm", lambda: torch.sparse.mm(A, xk))):
        host, ev = per_call(fn)
        res[f"{key}_host_us"] = (host - empty_ns) / 1e3
        res[f"{key}_events_ms"] = ev

    res.update(probe_calls(dev))
    _toy_calls(dev, res)
    return res


def cold_pool(fn, reps=3):
    """``fn`` on a cold caching allocator, ``torch.cuda.empty_cache()``
    before each of ``reps`` calls, and then on the warm one (after a
    warm-up call): each call alone between CUDA events, with the device
    segments the allocator took from the driver during it
    (``segment.all.allocated``) and the bytes it held before the call.
    Means per call: ``{"ms", "segments", "warm_ms", "warm_segments",
    "reserved_bytes"}``; what ``empty_cache()`` can give back depends on
    which segments the caller's live tensors hold."""
    def one(empty):
        torch.cuda.synchronize()
        if empty:
            torch.cuda.empty_cache()
        st = torch.cuda.memory_stats()
        s0 = st.get("segment.all.allocated", 0)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        return (a.elapsed_time(b),
                torch.cuda.memory_stats().get("segment.all.allocated", 0)
                - s0, st.get("reserved_bytes.all.current", 0))
    cold = [one(True) for _ in range(reps)]
    fn()
    warm = [one(False) for _ in range(reps)]
    return {"ms": sum(c[0] for c in cold) / reps,
            "segments": sum(c[1] for c in cold) / reps,
            "warm_ms": sum(w[0] for w in warm) / reps,
            "warm_segments": sum(w[1] for w in warm) / reps,
            "reserved_bytes": cold[0][2]}


def probe_calls(dev: torch.device) -> dict:
    """P3 (``span_colsum_cuda``), P4's nodot, nosel and empty and P5's two
    variants (``slice_gather_cuda``) through the public wrappers at their
    probes' defaults, on any tree of the port: CUDA-event ms per call
    (``chip_smoke.timed``) and the hash of each output on the probes' own
    seeded inputs; P3's and P5's calls also alone on a cold caching
    allocator (:func:`cold_pool`: ms and segments taken a call)."""
    import chip_smoke as c
    from paddle_sparse_tpu_torch.experiments import r4_band_cost as rb
    from paddle_sparse_tpu_torch.experiments import r4_dma_issue as rd
    from paddle_sparse_tpu_torch.experiments import r5_vmem_expand as rv
    from paddle_sparse_tpu_torch.ops.kernels.probes_cuda import (
        slice_gather_cuda, span_colsum_cuda)
    res = {}
    stream, e0, _ = rd.make_inputs(19, 384, device=dev)
    ms, out = c.timed(lambda: span_colsum_cuda(stream, e0, 19, 384,
                                               rd.STEPS), 10)
    res["p3_ms"], res["p3_sha"] = ms, _sha(out)
    del out
    cold = cold_pool(lambda: span_colsum_cuda(stream, e0, 19, 384,
                                              rd.STEPS))
    res["p3_cold_pool_ms"] = cold["ms"]
    res["p3_cold_pool_segments"] = cold["segments"]
    del stream, e0
    tb = rb.tables(device=dev)
    for kind in ("nodot", "nosel", "empty"):
        ms, out = c.timed(lambda kind=kind: rb.variant_call(kind, tb), 20)
        res[f"p4_{kind}_ms"], res[f"p4_{kind}_sha"] = ms, _sha(out)
    del tb, out
    fs, cols, x = rv.make_inputs(10_000, dev)
    for variant, key in (("onehot_write", "p5_write"),
                         ("onehot_reduce", "p5_reduce")):
        ms, out = c.timed(lambda v=variant: slice_gather_cuda(
            fs, cols, x, rv.R, v), 5)
        res[f"{key}_ms"], res[f"{key}_sha"] = ms, _sha(out)
        del out
        cold = cold_pool(lambda v=variant: slice_gather_cuda(
            fs, cols, x, rv.R, v))
        res[f"{key}_cold_pool_ms"] = cold["ms"]
        res[f"{key}_cold_pool_segments"] = cold["segments"]
    torch.cuda.empty_cache()
    return res


SLICE_STAGES = ("full", "load", "loop")   # psp_slice_stages' stage 0, 1, 2


def slice_breakdown(dev: torch.device) -> None:
    """P5's per-chunk kernel part by part (the module docstring's
    ``slice``)."""
    import chip_smoke as c
    from paddle_sparse_tpu_torch.experiments import r5_vmem_expand as rv
    from paddle_sparse_tpu_torch.ops.kernels import _build
    from paddle_sparse_tpu_torch.ops.kernels.probes_cuda import (
        SLICE_VARIANTS, slice_gather_cuda, slice_gather_reference)
    card = card_line()
    so = _build.build_library([Path(__file__).resolve().parent
                               / "chip_probe_slice.cu"],
                              _build.BUILD_DIR / "chip_probe_slice")
    lib = ctypes.CDLL(str(so))
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    fn = lib.psp_slice_stages
    fn.argtypes = [i32, i32, p, p, p, p, i64, i64, i64, i64, p]
    fn.restype = ctypes.c_int
    nch = 10_000
    fs, cols, x = rv.make_inputs(nch, dev)
    cols = cols.reshape(-1).int()
    E, K = rv.E, rv.K

    def call(variant, stage):
        reduce = variant == "onehot_reduce"
        out = torch.empty((nch * (8 if reduce else E), K),
                          dtype=torch.bfloat16, device=dev)
        _build.launch("slice_stages", fn, dev, int(reduce),
                      SLICE_STAGES.index(stage), fs.data_ptr(),
                      cols.data_ptr(), x.data_ptr(), out.data_ptr(), nch,
                      rv.R, E, K)
        return out

    ctas = nch * -(-K // 128)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    # 256 R + 4 E bytes of slice part and indices: one CTA an SM at R = 512
    per_sm = max(1, (227 * 1024) // (rv.R * 256 + E * 4 + 8 * 1024 + 64))
    waves = ctas / (sms * per_sm)
    res = {"at": f"NCH={nch} chunks of {E} edges, R={rv.R}, K={K} bf16",
           "ctas": ctas, "ctas_per_sm": per_sm, "waves": waves}
    for variant in SLICE_VARIANTS:
        ms = {st: [] for st in SLICE_STAGES}
        for st in SLICE_STAGES + SLICE_STAGES[::-1]:
            ms[st].append(c.timed(lambda st=st: call(variant, st), 5)[0])
        res[variant] = {st: {"ms": v, "mean_ms": sum(v) / 2,
                             "us_per_wave": sum(v) / 2 * 1e3 / waves}
                        for st, v in ms.items()}
    # the whole kernel: write equal to the package's, reduce beside the
    # plain version (f32 sums, rounded to bf16 once)
    res["write_equal_to_package"] = bool(torch.equal(
        call("onehot_write", "full"),
        slice_gather_cuda(fs, cols, x, rv.R, "onehot_write")))
    want = slice_gather_reference(fs, cols, x, rv.R, "onehot_reduce")
    res["reduce_max_abs_diff_vs_plain"] = float(
        (call("onehot_reduce", "full").float() - want.float()).abs().max())
    print("SLICE " + json.dumps(res) + f" [{card}]", flush=True)


BAND_STAGES = ("whole", "walk", "fill", "fill_v4", "fill_bulk", "counts")
BAND_REPS = 100         # calls a profiled or event-timed loop of ``band``
BAND_HOST_CALLS = 300   # calls a host-timed loop of ``band`` (< the queue)


def _band_host_stages(tb, out):
    """The statements of ``band_ablate_cuda("nodot", ...)`` on the card, one
    stage each: its checks (copied here, so that they time the same on any
    tree), the output's allocation as it was (``torch.empty``) and as it is
    (``new_empty``), the three ``_index32`` of its tables as they were
    (copied) and as this tree has them, and the launch (into ``out``, no
    allocation)."""
    from paddle_sparse_tpu_torch.ops.kernels import _build
    from paddle_sparse_tpu_torch.ops.kernels import probes_cuda as pc
    stream, (tile_ptr, visit) = tb.stream, tb.visits
    S, BR_pad, E, K, R = tb.S, tb.BR_pad, tb.E, tb.K, tb.R
    dev = stream.device
    lib = _build.load_library()
    ntiles = BR_pad // R

    def checks():
        if not stream.is_cuda:
            raise ValueError
        for t in (tb.cs, tb.cr, tb.cn, tb.bst, tb.ben):
            if t.device != dev:
                raise ValueError
        if stream.dtype != torch.bfloat16 or stream.dim() != 2 or \
                stream.shape[1] != K:
            raise TypeError
        if K % 8 or R != pc.TILE_ROWS or BR_pad % R:
            raise ValueError
        s = stream.contiguous()
        if s.data_ptr() % 16:
            raise ValueError
        if tb.cs.numel() * E > s.shape[0] or \
                tb.bst.numel() != S * BR_pad or tb.ben.numel() != S * BR_pad:
            raise ValueError
        if tile_ptr.numel() != ntiles + 1 or tile_ptr.device != dev:
            raise ValueError

    def index32():
        return (pc._index32("band_ablate_cuda", "chunk_span", tb.cs),
                pc._index32("band_ablate_cuda", "bounds_start", tb.bst),
                pc._index32("band_ablate_cuda", "bounds_end", tb.ben))

    def index32_former():          # a copy of _index32 before the redesign
        return tuple(t if t.dtype == torch.int32 and t.dim() == 1
                     and t.is_contiguous() else
                     t.reshape(-1).to(torch.int32).contiguous()
                     for t in (tb.cs, tb.bst, tb.ben))

    span, bst, ben = index32()
    return {
        "checks": checks,
        "alloc": lambda: torch.empty((BR_pad, K), dtype=torch.float32,
                                     device=dev),
        "alloc_new_empty": lambda: stream.new_empty((BR_pad, K),
                                                    dtype=torch.float32),
        "index32_former": index32_former, "index32": index32,
        "launch": lambda: _build.launch(
            "band_ablate", lib.psp_band_ablate, dev, 0, tile_ptr.data_ptr(),
            visit.data_ptr(), span.data_ptr(), bst.data_ptr(),
            ben.data_ptr(), BR_pad, stream.data_ptr(), None, out.data_ptr(),
            ntiles, K, E)}


def band_breakdown(dev: torch.device) -> None:
    """P4 nodot part by part (the module docstring's ``band``)."""
    import chip_smoke as c
    from paddle_sparse_tpu_torch.experiments import r4_band_cost as rb
    from paddle_sparse_tpu_torch.ops.kernels import _build
    from paddle_sparse_tpu_torch.ops.kernels import probes_cuda as pc
    card = card_line()
    so = _build.build_library([Path(__file__).resolve().parent
                               / "chip_probe_band.cu"],
                              _build.BUILD_DIR / "chip_probe_band")
    lib = ctypes.CDLL(str(so))
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    fn = lib.psp_band_stages
    fn.argtypes = [i32, i64, p, p, p, p, p, i64, p, i64, i64, i64,
                   ctypes.c_float, p]
    fn.restype = ctypes.c_int
    tb = rb.tables(device=dev)
    rb.check_schedule(tb)
    tile_ptr, visit = tb.visits
    BR_pad, K, E = tb.BR_pad, tb.K, tb.E
    ntiles = BR_pad // tb.R
    out = torch.empty((BR_pad, K), dtype=torch.float32, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def stage(name, grid=1, value=-1.0):
        # walk: -1 is the sentinel no count reaches; the fills store it
        return lambda: _build.launch(
            "band_stages", fn, dev, BAND_STAGES.index(name), grid,
            tile_ptr.data_ptr(), visit.data_ptr(), tb.cs.data_ptr(),
            tb.bst.data_ptr(), tb.ben.data_ptr(), BR_pad, out.data_ptr(),
            ntiles, K, E, value)

    kw = dict(S=tb.S, BR_pad=BR_pad, E=E, K=K, R=tb.R, TMAX=tb.TMAX,
              visits=tb.visits)
    args = (tb.cs, tb.cr, tb.cn, tb.bst, tb.ben, tb.stream)
    want = pc.band_ablate_reference("nodot", *args, **kw)
    checks = {}
    stage("whole")()
    checks["whole_equal_to_plain"] = bool(torch.equal(out, want))
    checks["package_equal_to_plain"] = bool(torch.equal(
        pc.band_ablate_cuda("nodot", *args, **kw), want))
    stage("counts")()
    checks["counts_equal_to_plain"] = bool(torch.equal(
        out.view(-1)[:ntiles], want[::tb.R, 0]))
    for name in ("fill_v4", "fill_bulk"):
        out.zero_()
        stage(name, 4 * sms, 1.5)()
        checks[f"{name}_stores_every_value"] = bool((out == 1.5).all())
    out.zero_()
    stage("fill", value=1.5)()
    checks["fill_stores_every_value"] = bool((out == 1.5).all())
    res = {"at": f"S={tb.S} BAND={tb.BAND} E={E} K={K} f32 out "
                 f"({BR_pad * K * 4} B), {tb.nchunks} chunks, {ntiles} "
                 f"tiles, up to {int(tile_ptr.diff().max())} visits a tile",
           "sms": sms, "former_grid": ntiles * -(-K // 64), **checks}
    variants = {"whole": stage("whole"), "walk": stage("walk"),
                "fill": stage("fill"), "counts": stage("counts")}
    for per_sm in (1, 2, 4, 8):
        for name in ("fill_v4", "fill_bulk"):
            variants[f"{name}_x{per_sm}"] = stage(name, per_sm * sms, 1.5)
    variants["package_nodot"] = lambda: pc.band_ablate_cuda("nodot", *args,
                                                            **kw)
    variants["torch_fill_"] = lambda: torch.empty(
        (BR_pad, K), dtype=torch.float32, device=dev).fill_(1.0)
    # device time under the profiler, then CUDA events in turns
    dev_ms = {}
    for name, f in variants.items():
        host, device, rows = _profile(f, BAND_REPS)
        dev_ms[name] = {"device_ms": device, "host_ms_per_call": host,
                        "by_kernel": rows[:3]}
    order = list(variants)
    turns = {name: [] for name in order}
    for name in order + order[::-1]:
        turns[name].append(c.timed(variants[name], BAND_REPS)[0])
    res["stages"] = {name: {**dev_ms[name], "event_ms_in_turns": turns[name]}
                     for name in order}
    # the wrapper's host path, stage by stage, and whole calls back to back
    empty_ns, _ = per_call(lambda: None, BAND_HOST_CALLS)
    host = {}
    for name, f in _band_host_stages(tb, out).items():
        host[name] = per_call(f, BAND_HOST_CALLS)[0] - empty_ns
    ns, ms = per_call(variants["package_nodot"], BAND_HOST_CALLS)
    host["whole_call"] = ns - empty_ns
    res["host_ns_per_call"] = host
    res["package_nodot_event_ms_back_to_back"] = ms
    print("BAND " + json.dumps(res) + f" [{card}]", flush=True)


def _profile(fn, reps=10):
    """``(host ms per call, device ms per call, [(ms, launches, kernel)])``
    of ``fn`` after a warm-up: the host clock around ``reps`` calls with no
    synchronize between them, then ``torch.profiler``'s device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
          and getattr(e, "self_device_time_total", 0) > 0]
    rows = sorted(((e.self_device_time_total / 1e3 / reps, e.count / reps,
                    e.key[:60]) for e in ev), reverse=True)
    return host, sum(r[0] for r in rows), rows


def probe_profiles(dev: torch.device) -> None:
    """P3's, P4's and P5's calls kernel by kernel (the module docstring's
    ``probes``)."""
    from paddle_sparse_tpu_torch.experiments import r4_band_cost as rb
    from paddle_sparse_tpu_torch.experiments import r4_dma_issue as rd
    from paddle_sparse_tpu_torch.experiments import r5_vmem_expand as rv
    from paddle_sparse_tpu_torch.ops.kernels import probes_cuda as pc
    card = card_line()
    stream, e0, _ = rd.make_inputs(19, 384, device=dev)
    n, L = 19 * rd.STEPS, stream.shape[0]
    fs, cols, x = rv.make_inputs(10_000, dev)
    cols2 = torch.randint(0, rv.R, (10_000 * 2049,), device=dev,
                          dtype=torch.int32,
                          generator=torch.Generator(device=dev).manual_seed(2))
    nslices = x.shape[0] // rv.R
    # each call on a fresh process's pool, before anything else has filled
    # it (after one call for the library and the kernels' attributes): the
    # inputs hold segments of their own, so empty_cache() gives back what
    # a call took, and the next must take it from the driver again
    for name, fn in (
            ("slice_reduce", lambda: pc.slice_gather_cuda(
                fs, cols, x, rv.R, "onehot_reduce")),
            ("slice_plan", lambda: pc.slice_items(fs, nslices)),
            ("slice_reduce_output", lambda: torch.empty(
                (10_000 * 8, rv.K), dtype=torch.bfloat16, device=dev)),
            ("span_colsum", lambda: pc.span_colsum_cuda(
                stream, e0, 19, 384, rd.STEPS)),
            ("band_output", lambda: torch.empty(
                (rb.BR_pad, rb.K), dtype=torch.float32, device=dev))):
        fn()
        print("COLD " + json.dumps({"call": name, **cold_pool(fn, 5)})
              + f" [{card}]", flush=True)
    tb = rb.tables(device=dev)
    for name, fn in (
            ("span_colsum", lambda: pc.span_colsum_cuda(
                stream, e0, 19, 384, rd.STEPS)),
            ("span_colsum_staged", lambda: pc.span_colsum_staged_cuda(
                stream, e0, 19, 384, rd.STEPS)),
            ("span_plan", lambda: pc.span_pieces(e0[:n], 384, L)),
            ("span_plan_torch", lambda: pc.span_pieces_reference(
                e0[:n], 384, L)),
            ("slice_reduce", lambda: pc.slice_gather_cuda(
                fs, cols, x, rv.R, "onehot_reduce")),
            ("slice_reduce_e2049", lambda: pc.slice_gather_cuda(
                fs, cols2, x, rv.R, "onehot_reduce")),
            ("slice_plan", lambda: pc.slice_items(fs, nslices)),
            ("slice_plan_torch", lambda: pc.slice_items_reference(fs)),
            ("band_nodot", lambda: rb.variant_call("nodot", tb)),
            ("band_nosel", lambda: rb.variant_call("nosel", tb)),
            ("band_empty", lambda: rb.variant_call("empty", tb)),
            ("band_output", lambda: torch.empty(
                (rb.BR_pad, rb.K), dtype=torch.float32, device=dev))):
        host, device, rows = _profile(
            fn, BAND_REPS if name.startswith("band") else 10)
        print("PROBES " + json.dumps({
            "call": name, "host_ms_per_call": host,
            "device_ms_per_call": device, "by_kernel": rows[:8]})
              + f" [{card}]", flush=True)


def launch(dev: torch.device) -> None:
    """The host path of a kernel launch, stage by stage, for P1
    (``scale2_cuda``) and P2 (``chunk_sum_cuda``) at the probe's shapes:
    each stage alone over ``CALLS`` calls (host ns per call, the empty
    loop's cost taken off), in the wrappers' former path and in this one;
    then :func:`whole_calls`."""
    from paddle_sparse_tpu_torch.experiments import bisect_pallas as bp
    from paddle_sparse_tpu_torch.ops.kernels import _build
    from paddle_sparse_tpu_torch.ops.kernels import probes_cuda as pc
    card = card_line()
    lib = _build.load_library()
    x = torch.ones((256, 128), device=dev)
    ptr, src = bp.dma_inputs(dev)
    T, E, K = bp.T, bp.E, src.shape[1]
    out_x, out_c = torch.empty_like(x), torch.empty((T * E, K), device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    idx = dev.index or 0
    empty_ns, _ = per_call(lambda: None)
    former = _former_stages(x, ptr, src, E)
    # the same C function, called with the GIL held (no release/reacquire)
    pylib = ctypes.PyDLL(lib._name, handle=lib._handle)
    for fn in ("psp_scale2", "psp_chunk_sum"):
        getattr(pylib, fn).argtypes = getattr(lib, fn).argtypes
        getattr(pylib, fn).restype = ctypes.c_int
    n, EK = x.numel(), E * K

    def checks_scale2():          # scale2_cuda's, before its allocation
        if not x.is_cuda:
            raise ValueError
        if x.dtype != torch.float32:
            raise TypeError
        x.is_contiguous()
        x.numel()

    def checks_chunk_sum():       # chunk_sum_cuda's, before _index32
        if not src.is_cuda:
            raise ValueError
        if ptr.device != src.device:
            raise ValueError
        if src.dtype != torch.float32 or src.dim() != 2:
            raise TypeError
        src.is_contiguous()
        T, K = ptr.numel() - 1, src.shape[1]
        if (E * K) % 4 or src.data_ptr() % 16:
            raise ValueError
        if T > 65535:
            raise ValueError

    shared = {
        "library": _build.load_library,
        "device_check": lambda: torch._C._cuda_getDevice() != idx,
        "raw_stream": lambda: torch._C._cuda_getCurrentRawStream(idx)}
    this = {
        "scale2": {
            "checks": checks_scale2,
            "alloc": lambda: torch.empty_like(x), **shared,
            "ctypes_launch": lambda: lib.psp_scale2(
                x.data_ptr(), out_x.data_ptr(), n, stream),
            "ctypes_launch_gil_held": lambda: pylib.psp_scale2(
                x.data_ptr(), out_x.data_ptr(), n, stream),
            "build_launch": lambda: _build.launch(
                "scale2", lib.psp_scale2, dev, x.data_ptr(),
                out_x.data_ptr(), n),
            # a launch through PyTorch's own binding and runtime, for scale
            "torch_cuda_sleep0": lambda: torch._C._cuda_sleep(0)},
        "chunk_sum": {
            "checks": checks_chunk_sum,
            "index32": lambda: pc._index32("chunk_sum_cuda", "ptr", ptr),
            "alloc": lambda: src.new_empty(T * E, K), **shared,
            "data_ptrs": lambda: (ptr.data_ptr(), src.data_ptr(),
                                  out_c.data_ptr()),
            # depth 3 is refused before any CUDA call: ctypes alone
            "ctypes_no_launch": lambda: lib.psp_chunk_sum(
                ptr.data_ptr(), src.data_ptr(), out_c.data_ptr(), T, EK, 3,
                stream),
            "ctypes_launch_one_slot": lambda: lib.psp_chunk_sum(
                ptr.data_ptr(), src.data_ptr(), out_c.data_ptr(), T, EK, 1,
                stream),
            "ctypes_launch_two_slots": lambda: lib.psp_chunk_sum(
                ptr.data_ptr(), src.data_ptr(), out_c.data_ptr(), T, EK, 2,
                stream),
            "ctypes_launch_two_slots_gil_held": lambda: pylib.psp_chunk_sum(
                ptr.data_ptr(), src.data_ptr(), out_c.data_ptr(), T, EK, 2,
                stream),
            "build_launch_two_slots": lambda: _build.launch(
                "chunk_sum", lib.psp_chunk_sum, dev, ptr.data_ptr(),
                src.data_ptr(), out_c.data_ptr(), T, EK, 2)}}
    for name in ("scale2", "chunk_sum"):
        res = {"wrapper": f"{name}_cuda", "calls_per_loop": CALLS,
               "empty_loop_ns": empty_ns}
        for part, stages in (("former_path_ns", former[name]),
                             ("this_path_ns", this[name])):
            res[part] = {st: per_call(fn)[0] - empty_ns
                         for st, fn in stages.items()}
        print("LAUNCH " + json.dumps(res) + f" [{card}]", flush=True)
    print("LAUNCH_WHOLE " + json.dumps(whole_calls(dev)) + f" [{card}]",
          flush=True)


# the variants of chip_probe_fused.cu's former K2' (its MODE bits: 1 value
# at e, 16 d value at e, 2 no dots, 4 the incremental batch exchange, 32
# the exchange on a whole batch in registers, 8 (row, value) staged in
# shared memory, 64 at most 64 registers, 256 at most 72, 128 the edge
# loop unrolled 2 times)
FUSED_MODES = {"whole": 0, "value_at_e": 1, "d_value_at_e": 16,
               "contig": 17, "nodots": 2, "value_at_e_nodots": 3,
               "batch": 4, "contig_batch": 21, "batch32": 32,
               "contig_batch32": 49, "smem": 8, "contig_smem": 25,
               "occupancy": 64, "contig_occupancy": 81,
               "contig_batch_occupancy": 85, "contig_unroll2": 145,
               "contig_blocks7": 273, "contig_unroll2_blocks7": 401,
               "contig_unroll2_occupancy": 209}
FUSED_REPS = 3          # calls a timed loop of ``fused``
FUSED_K = 256


def _ptxas_start(src: Path):
    """``nvcc -Xptxas -v`` of ``src`` (compile only), started: the process
    and its temporary directory, for :func:`_ptxas_read`."""
    import tempfile

    from paddle_sparse_tpu_torch.ops.kernels import _build
    tmp = tempfile.TemporaryDirectory()
    proc = subprocess.Popen(
        [_build.find_nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
         f"{tmp.name}/probe.o", str(src)], stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True, cwd=src.parent)
    return proc, tmp


def _ptxas_read(started, keep):
    """What ptxas said of each kernel of a :func:`_ptxas_start`: every
    kernel whose demangled name contains ``keep`` with its registers and
    spill bytes, and over all kernels the most registers and the spills."""
    proc, tmp = started
    err = proc.communicate()[1]
    tmp.cleanup()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc -Xptxas -v failed:\n{err[-3000:]}")
    rows, name = {}, None
    for line in err.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            rows[name] = {"registers": None, "spill_stores": 0,
                          "spill_loads": 0}
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            rows[name]["spill_stores"] = int(m.group(1))
            rows[name]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows[name]["registers"] = int(m.group(1))
    from paddle_sparse_tpu_torch.ops.kernels import _build
    filt = Path(_build.find_nvcc()).parent / "cu++filt"
    names = list(rows)
    if filt.exists() and names:
        out = subprocess.run([str(filt)], input="\n".join(names),
                             capture_output=True, text=True).stdout
        names = out.splitlines() or names
    # template arguments without their casts, the parameter list cut off
    names = [re.sub(r"\((int|bool)\)", "", n).split("(")[0] for n in names]
    named = dict(zip(names, rows.values()))
    return {"kernels": len(named),
            "max_registers": max(r["registers"] or 0 for r in named.values()),
            "spilling": {n: r for n, r in named.items()
                         if r["spill_stores"] or r["spill_loads"]},
            "kept": {n: r for n, r in named.items() if keep in n}}


def _parts(dev_ms, turns):
    return {name: {**dev_ms[name], "event_ms_in_turns": turns[name],
                   "event_ms": sum(turns[name]) / 2} for name in turns}


def _timed_parts(c, variants):
    """Each of ``variants`` under the profiler, then by CUDA events in
    turns (the order and back)."""
    dev_ms = {}
    for name, f in variants.items():
        host, device, rows = _profile(f, FUSED_REPS)
        dev_ms[name] = {"device_ms": device, "host_ms_per_call": host,
                        "by_kernel": rows[:3]}
    order = list(variants)
    turns = {name: [] for name in order}
    for name in order + order[::-1]:
        turns[name].append(c.timed(variants[name], FUSED_REPS)[0])
    return _parts(dev_ms, turns)


def _fused_spans(dev, lib, old) -> dict:
    """K2'' on phase 7c's seg2 f32 path (the uniform graph at full scale,
    K=256): the former span kernel with the per-edge butterfly, with the
    incremental batch exchange and with the whole-batch one, the package's
    launch and (``old``, a :func:`_parent_fused_library`) the parent's, on
    values already relayed; each checked bit for bit against the per-edge
    form, then timed."""
    import chip_smoke as c
    from paddle_sparse_tpu_torch import make_seg2_plan, pack_values
    from paddle_sparse_tpu_torch.ops.kernels import _build
    from paddle_sparse_tpu_torch.ops.kernels.spmm_sddmm_cuda import (
        spmm_sddmm_spans_cuda)
    from paddle_sparse_tpu_torch.ops.kernels.spmm_spans_cuda import (
        check_span_args)
    from paddle_sparse_tpu_torch.ops.spmm_seg2 import span_layouts
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    fn = lib.psp_fused_former_spans
    fn.argtypes = [i32, p, p, i64, i64, p, p, p, p, p, p, p, i64, i64, p]
    fn.restype = ctypes.c_int
    row, col, val, x = c.bench_graph(dev, "uniform", 1.0, FUSED_K)
    n, K = x.shape
    plan, ss = make_seg2_plan(row, col, n, n, feat_dim=K, stream="f32")
    t = span_layouts(plan, ss)[1]
    if t.split is not None:
        raise RuntimeError("fused: the uniform graph's x rows split")
    vt = pack_values(ss, val).index_select(0, ss.relay_ft)
    del row, col, val
    g = torch.randn(n, K, generator=torch.Generator(device=dev).manual_seed(
        21), device=dev)
    start, end, base = check_span_args("fused", t.start, t.end, t.base, dev)
    col_t = t.col.to(torch.int32).contiguous()
    dx = torch.empty(n, K, device=dev)
    dv = torch.zeros(vt.numel(), device=dev)

    def former(mode):
        return lambda: _build.launch(
            "fused_former_spans", fn, dev, mode, start.data_ptr(),
            end.data_ptr(), start.stride(0), start.shape[0],
            col_t.data_ptr(), None if base is None else base.data_ptr(),
            vt.data_ptr(), g.data_ptr(), x.data_ptr(), dx.data_ptr(),
            dv.data_ptr(), n, K)

    def package():
        return spmm_sddmm_spans_cuda(t.start, t.end, t.col, vt, t.base, g, x,
                                     split=t.split)

    def parent_launch():
        _build.launch(
            "spmm_sddmm_spans", old.psp_spmm_sddmm_spans, dev,
            start.data_ptr(), end.data_ptr(), start.stride(0),
            col_t.data_ptr(), None if base is None else base.data_ptr(),
            vt.data_ptr(), 0, g.data_ptr(), x.data_ptr(), dx.data_ptr(),
            dv.data_ptr(), start.shape[0], n, K, 0, 0, 0, 0, None, None, 0,
            0, None, None)

    modes = {"whole": 0, "batch": 4, "batch32": 32}
    checks = {}
    with torch.inference_mode():
        former(0)()
        ref_dx, ref_dv = dx.clone(), dv.clone()
        for name, mode in modes.items():
            dv.zero_()
            former(mode)()
            checks[f"{name}_equal"] = bool(torch.equal(dx, ref_dx)
                                           and torch.equal(dv, ref_dv))
        got = package()
        checks["package_equal"] = bool(torch.equal(got[0], ref_dx)
                                       and torch.equal(got[1], ref_dv))
        if old is not None:
            dv.zero_()
            parent_launch()
            checks["parent_equal"] = bool(torch.equal(dx, ref_dx)
                                          and torch.equal(dv, ref_dv))
        del got, ref_dx, ref_dv
        variants = {} if old is None else {"parent_launch": parent_launch}
        variants.update({name: former(mode) for name, mode in modes.items()})
        variants["package_launch"] = c.dropped(package)
        parts = _timed_parts(c, variants)
    bad = [k for k, v in checks.items() if not v]
    if bad:
        raise RuntimeError(f"fused spans: outputs differ: {bad}")
    return {"at": f"seg2 f32 on the uniform graph ({n} nodes, "
                  f"{vt.numel()} edges), S_t={plan.S_t}, K={K}, values "
                  f"relayed", **checks, "parts": parts}


def _parent_fused_library(parent: Path):
    """``PARENT``'s ``csrc/spmm_sddmm_csc.cu`` built alone into
    ``build/chip_probe_fused_parent/`` and loaded, its two entry points
    declared as that file has them (the CSC form with ``perm`` and the
    values in COO order)."""
    from paddle_sparse_tpu_torch.ops.kernels import _build
    src = parent / "paddle_sparse_tpu_torch" / "csrc" / "spmm_sddmm_csc.cu"
    lib = ctypes.CDLL(str(_build.build_library(
        [src], _build.BUILD_DIR / "chip_probe_fused_parent")))
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.psp_spmm_sddmm_csc.argtypes = [p, p, p, p, i32, p, p, p, p, i64,
                                       i64, i32, i32, i32, i32, p, p, i64,
                                       i64, p, p, p]
    lib.psp_spmm_sddmm_spans.argtypes = [p, p, i64, p, p, p, i32, p, p, p,
                                         p, i64, i64, i64, i32, i32, i32,
                                         i32, p, p, i64, i64, p, p, p]
    for fn in (lib.psp_spmm_sddmm_csc, lib.psp_spmm_sddmm_spans):
        fn.restype = ctypes.c_int
    return lib


def fused_breakdown(dev: torch.device, parent=None) -> None:
    """K2' part by part (the module docstring's ``fused``)."""
    import chip_smoke as c
    from paddle_sparse_tpu_torch import gcn_normalize, spmm_csr_cuda
    from paddle_sparse_tpu_torch.ops.convert import invert_perm
    from paddle_sparse_tpu_torch.ops.kernels import _build
    from paddle_sparse_tpu_torch.ops.kernels.spmm_sddmm_cuda import (
        spmm_sddmm_csc_cuda)
    card = card_line()
    here = Path(__file__).resolve().parent
    ptx = {"chip_probe_fused.cu": _ptxas_start(here / "chip_probe_fused.cu"),
           "spmm_sddmm_csc.cu": _ptxas_start(_build.CSRC_DIR
                                             / "spmm_sddmm_csc.cu")}
    so = _build.build_library([here / "chip_probe_fused.cu"],
                              _build.BUILD_DIR / "chip_probe_fused")
    lib = ctypes.CDLL(str(so))
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    fn = lib.psp_fused_former
    fn.argtypes = [i32, p, p, p, p, p, p, p, p, i64, i64, p]
    fn.restype = ctypes.c_int
    pkg = _build.load_library()
    old = None if parent is None else _parent_fused_library(parent)

    raw, _ = c.products_graph(dev)
    adj = gcn_normalize(raw)
    del raw
    s = adj.structure()
    n, nnz, P, K = adj.shape[1], adj.nnz, s.perm.numel(), FUSED_K
    gen = torch.Generator(device=dev).manual_seed(20)
    g = torch.randn(adj.shape[0], K, generator=gen, device=dev)
    x = torch.randn(n, K, generator=gen, device=dev)
    value = adj.value
    colptr = s.colptr.to(torch.int32).contiguous()
    col_t = s.col_t.to(torch.int32).contiguous()
    value_t = value.index_select(0, s.perm)
    dx = torch.empty(n, K, device=dev)
    dv = torch.zeros(P, device=dev)
    dx_t = torch.empty(n, K, device=dev)
    dv_t = torch.zeros(P, device=dev)

    def former(mode):
        v = value_t if mode & 1 else value
        return lambda: _build.launch(
            "fused_former", fn, dev, mode, colptr.data_ptr(),
            col_t.data_ptr(), s.perm.data_ptr(), v.data_ptr(), g.data_ptr(),
            x.data_ptr(), dx.data_ptr(), dv.data_ptr(), n, K)

    def package_kernel():       # the launch alone, values in CSC order
        _build.launch(
            "spmm_sddmm_csc", pkg.psp_spmm_sddmm_csc, dev, colptr.data_ptr(),
            col_t.data_ptr(), value_t.data_ptr(), 0, g.data_ptr(),
            x.data_ptr(), dx_t.data_ptr(), dv_t.data_ptr(), n, K, 0, 0, 0, 0,
            None, None, 0, 0, None, None)

    def package_routed():       # as the backward runs it
        return spmm_sddmm_csc_cuda(s.colptr, s.col_t, s.perm, value, g, x,
                                   split=s.col_split, inv_perm=s.inv_perm)

    def parent_kernel():        # PARENT's own kernel, as it ran
        _build.launch(
            "spmm_sddmm_csc", old.psp_spmm_sddmm_csc, dev, colptr.data_ptr(),
            col_t.data_ptr(), s.perm.data_ptr(), value.data_ptr(), 0,
            g.data_ptr(), x.data_ptr(), dx.data_ptr(), dv.data_ptr(), n, K,
            0, 0, 0, 0, None, None, 0, 0, None, None)

    # each variant once: d x and d value against the former kernel whole
    checks = {}
    with torch.inference_mode():
        want = c.fused_pair(adj, value, g, x, torch.float32)
        former(0)()
        torch.cuda.synchronize()
        checks["whole_equal_to_pair"] = bool(
            torch.equal(dx, want[0]) and torch.equal(dv, want[1]))
        ref_dx, ref_dv = dx.clone(), dv.clone()
        del want
        for name, mode in FUSED_MODES.items():
            dv.zero_()
            former(mode)()
            got_dv = dv.index_select(0, s.inv_perm) if mode & 16 else dv
            checks[f"{name}_equal"] = bool(torch.equal(dx, ref_dx)) and (
                bool(mode & 2) or bool(torch.equal(got_dv, ref_dv)))
        if old is not None:
            dv.zero_()
            parent_kernel()
            checks["parent_kernel_equal"] = bool(
                torch.equal(dx, ref_dx) and torch.equal(dv, ref_dv))
        package_kernel()
        checks["package_kernel_equal"] = bool(
            torch.equal(dx_t, ref_dx)
            and torch.equal(dv_t.index_select(0, s.inv_perm), ref_dv))
        got = package_routed()
        checks["package_routed_equal"] = bool(
            torch.equal(got[0], ref_dx) and torch.equal(got[1], ref_dv))
        checks["inv_perm_inverts_perm"] = bool(torch.equal(
            s.inv_perm[s.perm.long()],
            torch.arange(P, device=dev, dtype=s.inv_perm.dtype)))
        del got, ref_dx, ref_dv
        torch.cuda.empty_cache()

        perm_l = s.perm.long()
        variants = {} if old is None else {"parent_kernel": parent_kernel}
        variants.update({name: former(mode)
                         for name, mode in FUSED_MODES.items()})
        variants.update({
            "package_kernel": package_kernel,
            "package_routed": c.dropped(package_routed),
            "value_relay": c.dropped(lambda: value.index_select(0, s.perm)),
            "d_value_relay": c.dropped(
                lambda: dv_t.index_select(0, s.inv_perm)),
            "d_value_zeros": c.dropped(lambda: torch.zeros(P, device=dev)),
            "inv_perm_build": c.dropped(lambda: invert_perm(s.perm)),
            "d_value_scatter": c.dropped(
                lambda: torch.empty_like(dv).index_copy_(0, perm_l, dv_t)),
            "k1_over_csc": c.dropped(lambda: spmm_csr_cuda(
                colptr, col_t, value_t, g, split=s.col_split)),
            "pair": c.dropped(lambda: c.fused_pair(adj, value, g, x,
                                                    torch.float32))})
        parts = _timed_parts(c, variants)
    gather = nnz * K * 4 / c.HBM_BYTES_PER_S * 1e3
    res = {"at": f"phase 5's graph ({n} nodes, {nnz} nnz), K={K} f32, "
                 f"value and x from seed 20",
           "gather_bound_ms": gather, **checks, "parts": parts}
    del adj, s, g, x, value, colptr, col_t, value_t, dx, dv, dx_t, dv_t
    del perm_l, variants
    torch.cuda.empty_cache()
    res["spans"] = _fused_spans(dev, lib, old)
    res["ptxas"] = {
        "chip_probe_fused.cu": _ptxas_read(ptx["chip_probe_fused.cu"],
                                           "former_fused_kernel<2,"),
        "spmm_sddmm_csc.cu": _ptxas_read(
            ptx["spmm_sddmm_csc.cu"],
            "<float, float, float, 4, 2,")}
    print("FUSED " + json.dumps(res) + f" [{card}]", flush=True)
    bad = [k for k, v in checks.items() if not v]
    if bad:
        raise RuntimeError(f"fused: outputs differ: {bad}")


GLOO_COLLECTIVES = ("all_gather_into_tensor", "reduce_scatter_tensor",
                    "all_to_all_single", "batch_isend_irecv", "all_reduce",
                    "broadcast")


def _gloo_call(name: str, rank: int, dev) -> None:
    """One call of the collective ``name`` between ranks 0 and 1."""
    import torch.distributed as dist
    x = torch.arange(6., device=dev).reshape(3, 2) + 10 * rank
    if name == "all_gather_into_tensor":
        dist.all_gather_into_tensor(torch.empty(6, 2, device=dev), x)
    elif name == "reduce_scatter_tensor":
        dist.reduce_scatter_tensor(torch.empty(3, 2, device=dev),
                                   torch.cat([x, x]))
    elif name == "all_to_all_single":
        dist.all_to_all_single(torch.empty(4, 2, device=dev),
                               torch.ones(4, 2, device=dev))
    elif name == "batch_isend_irecv":
        peer = 1 - rank
        for req in dist.batch_isend_irecv(
                [dist.P2POp(dist.isend, x.clone(), peer),
                 dist.P2POp(dist.irecv, torch.empty_like(x), peer)]):
            req.wait()
    elif name == "all_reduce":
        dist.all_reduce(x.clone())
    else:
        dist.broadcast(x.clone(), 0)


def _gloo_rank(rank: int, name: str, tmp: str) -> None:
    """A spawned rank of ``gloo``: its outcome into ``tmp/rank<r>.txt``."""
    import datetime

    import torch.distributed as dist
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=30))
    try:
        _gloo_call(name, rank, torch.device("cuda", 0))
        torch.cuda.synchronize()
        msg = "ok"
    except (RuntimeError, ValueError) as e:  # a refusal is what is asked
        msg = f"{type(e).__name__}: {str(e).splitlines()[0][:200]}"
    with open(f"{tmp}/rank{rank}.txt", "w") as f:
        f.write(msg)


def gloo_check() -> None:
    """Each of ``GLOO_COLLECTIVES`` on CUDA tensors through gloo, in two
    fresh ranks on card 0; one JSON line."""
    import tempfile

    import torch.multiprocessing as mp
    out = {}
    for name in GLOO_COLLECTIVES:
        with tempfile.TemporaryDirectory() as tmp:
            died = None
            try:
                mp.spawn(_gloo_rank, args=(name, tmp), nprocs=2)
            except (mp.ProcessRaisedException,
                    mp.ProcessExitedException) as e:    # a rank that died
                died = str(e).strip().splitlines()[-1][:200]
            got = {}
            for r in range(2):
                path = Path(tmp) / f"rank{r}.txt"
                got[f"rank{r}"] = (path.read_text() if path.exists()
                                   else "no result")
        out[name] = {**got, "rank_died": died}
        print(f"gloo on CUDA tensors, {name}: {out[name]}", flush=True)
    print(json.dumps({"gloo_cuda": out, "card": card_line()}), flush=True)


def strided(dev: torch.device) -> None:
    """The ``strided`` probe (module docstring)."""
    from paddle_sparse_tpu_torch import spmm_csr_cuda
    n, deg = 2_449_029, 50
    g = torch.Generator(device=dev).manual_seed(3)
    rowptr = torch.arange(n + 1, device=dev, dtype=torch.int32) * deg
    col = torch.randint(0, n, (n * deg,), generator=g, device=dev,
                        dtype=torch.int32)
    val = torch.rand(n * deg, generator=g, device=dev)

    def timed(fn, reps=8):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        fn()
        torch.cuda.synchronize()
        ev[0].record()
        for _ in range(reps):
            fn()
        ev[1].record()
        torch.cuda.synchronize()
        return ev[0].elapsed_time(ev[1]) / reps

    res = {}
    for D, H in ((47, 4), (128, 4)):
        hw = torch.randn(n, H, D, generator=g, device=dev)
        hw2 = torch.randn(n, 2, D, generator=g, device=dev)
        buf = torch.empty(n, H, D, device=dev)
        xc = hw[:, 1].contiguous()
        oc = torch.empty(n, D, device=dev)
        cases = {
            "x contiguous, out contiguous": (xc, oc),
            f"x view ld {H * D}, out contiguous": (hw[:, 1], oc),
            f"x contiguous, out view ld {H * D}": (xc, buf[:, 1]),
            f"x view ld {H * D}, out view ld {H * D}": (hw[:, 1], buf[:, 1]),
            f"x view ld {2 * D}, out contiguous": (hw2[:, 1], oc),
        }
        ms = {k: [] for k in cases}
        for _ in range(3):
            for k, (x, o) in cases.items():
                ms[k].append(timed(lambda: spmm_csr_cuda(
                    rowptr, col, val, x, split=None, out=o)))
        for k, v in ms.items():
            print(f"K1 D={D}: {k}: ms {' '.join(f'{t:.3f}' for t in v)}",
                  flush=True)
            res[f"D={D}: {k}"] = v
        del hw, hw2, buf, xc, oc
        torch.cuda.empty_cache()
    print(json.dumps({"strided_k1_ms": res, "card": card_line()}),
          flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_probe: no CUDA device visible", file=sys.stderr)
        return 1
    if len(sys.argv) >= 2 and sys.argv[1] == "sweep":
        sweep()
    elif len(sys.argv) == 3 and sys.argv[1] == "ab":
        ab(Path(sys.argv[2]))
    elif len(sys.argv) in (3, 4) and sys.argv[1] == "calls":
        calls(Path(sys.argv[2]),
              int(sys.argv[3]) if len(sys.argv) == 4 else 10)
    elif len(sys.argv) == 2 and sys.argv[1] == "gat":
        gat(torch.device("cuda", 0))
    elif len(sys.argv) == 2 and sys.argv[1] == "sage":
        sage(torch.device("cuda", 0))
    elif len(sys.argv) == 2 and sys.argv[1] == "launch":
        launch(torch.device("cuda", 0))
    elif len(sys.argv) == 2 and sys.argv[1] == "slice":
        slice_breakdown(torch.device("cuda", 0))
    elif len(sys.argv) == 2 and sys.argv[1] == "band":
        band_breakdown(torch.device("cuda", 0))
    elif len(sys.argv) in (2, 3) and sys.argv[1] == "fused":
        fused_breakdown(torch.device("cuda", 0),
                        Path(sys.argv[2]) if len(sys.argv) == 3 else None)
    elif len(sys.argv) == 2 and sys.argv[1] == "probes":
        probe_profiles(torch.device("cuda", 0))
    elif len(sys.argv) == 2 and sys.argv[1] == "gloo":
        gloo_check()
    elif len(sys.argv) == 2 and sys.argv[1] == "strided":
        strided(torch.device("cuda", 0))
    else:
        print(__doc__, file=sys.stderr)
        return 2
    print(card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())

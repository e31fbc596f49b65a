"""Smoke test of paddle_sparse_tpu_torch on one NVIDIA GPU (written for an H100).

Run from the repository root:

    python3 chip_smoke.py

Phases, one or more printed lines each:

1. Device and build: the card's name and power limit (nvidia-smi), the torch
   and CUDA versions, then the CUDA kernels built from ``csrc/`` with nvcc.
2. SpMM kernel vs plain: ``spmm_csr_cuda`` against ``spmm_csr_reference``
   run in f64 on the card, over K, dtypes, ``value=None``, empty rows, a row
   of over 1M edges and a padded ``PaddedCOO``.
2b. SDDMM kernel vs plain: ``sddmm_csr_cuda`` against
   ``sddmm_csr_reference`` run in f64 on the card, over K, f32 and bf16
   inputs, empty rows, a padded ``PaddedCOO`` with poisoned padding cols
   (padding reads back 0), a row of over 1M edges, and the identity
   structure (where the kernel is ``mul_rowsum``).
3. Toy slice: ``entry("cuda")``'s GCN forward against the same model run on
   the CPU through the plain path.
3b. Toy train step: ``train_entry("cuda")`` against ``train_entry("cpu")``:
   loss, every parameter's grad and d value, then 20 SGD steps.
4. GCN inference at ogbn-products scale (2,449,029 nodes, degree 50, the OGB
   products GCN baseline 100 -> 256 -> 256 -> 47): 1 warm-up and 3 timed
   forwards, the kernel's launch count, per-layer times, a sampled-row check
   against f64, and the K=256 SpMM timed through the kernel and the plain
   version.
5. GCN train step at the same scale, on phase 4's graph, features and model,
   with labels and ``adj.value.requires_grad_()``: the CSC view's build time,
   1 warm-up and 3 timed steps (forward + backward + SGD), peak memory, the
   launch counts (SpMM 3 forward + 2 backward, SDDMM 3 per step), per-part
   times, d value on sampled edges and d x on sampled columns against f64,
   and the K=256 and K=100 SDDMM timed through the kernel and the plain
   version.
6a. Run compaction (K5) vs plain: ``compact_runs_cuda`` against
   ``compact_runs_reference`` in f64 on the card, over per-row-sorted grids,
   a row block's grid, a flat (row, col)-sorted stream, runs across many
   tiles and one of over 1M elements, ``out_capacity`` truncation and
   structure only.
6b. Toy SpGEMM: ``spgemm_entry("cuda")``'s A @ A through the three variants
   against the CPU: structure, values and value grads.
6c. SpGEMM at the JAX package's probe sizes (``bench.py::spgemm_probe``):
   A of 50,000 nodes x 16 (800k nnz) through ``plan_spgemm_rows`` +
   ``spspmm_rowsorted``; A of 625,000 x 16 (10M nnz) through
   ``spspmm_rowsorted`` and ``plan_spgemm_blocked`` + ``spspmm_rowblocked``;
   a zipf (alpha 1.5) A of 100,000 nodes through the path the planners
   choose. For each A @ A: plan seconds, 1 warm-up and 3 timed calls, C's
   nnz, output Mnnz/s, peak memory, K5 launches, no overflow, sampled rows
   of C against scipy in f64, and K5 timed alone on the call's own compress
   input against the plain version and against its library call,
   ``torch.sparse_coo_tensor(...).coalesce()`` on the same stream, in turns.
   At 800k also the value grads of ``sum(G * C)`` on sampled entries against
   f64.
7a. Multi-span SpMM (``spmm_spans_cuda``, the counterpart of K3/K4) and
   span SDDMM (``sddmm_spans_cuda``, K2's span form) against their plain
   versions in f64 over S in 1 3 19 40 and K in 1 47 64 100 256 300, f32 and
   bf16, with slice bases, empty rows and spans; S = 1 against K1's wrapper
   (``spmm_csr_cuda``, the same kernel over a CSR pointer) bit for bit; the
   stream form with a row of 1.1M edges, exact; ``tilespan_call`` (K3's
   entry point) on seg3's own tables of a 200k-node graph; and
   ``band_reduce_call`` (K4's) at ``experiments/r4_band_cost.py``'s sizes,
   timed against its plain version and ``torch.sparse.mm`` of the 0/1 span
   CSR. Then the long-row split (``RowSplit`` pieces, one warp each, and the
   fold pass) of both span kernels against plain f64 at S = 1 and S = 38:
   rows of CAP-1, CAP, CAP+1 and 2*CAP+3 edges, K 1 47 256 300, f32 and
   bf16; a row of 10M edges over spans that cross 32-span chunks, with empty
   spans and rows around it, exact; and the fold alone against its plain
   version.
7b. Toy packed SpMMs: ``spmm_entry`` for seg2, seg3 and split, forward and
   grads, card vs CPU.
7c. The bench's packed-SpMM cells at full width, on torch rewrites of
   ``bench.py``'s generators: seg2 on the uniform graph at full
   ogbn-products scale (2,449,029 nodes, 122,451,450 nnz, K=256) with the
   f32 and the bf16 stream, seg3 there (bf16), seg2 at K=64 and 1/8 scale
   (``dim64``), split on the clustered graph (bf16), seg2 on zipf at 1/8
   scale after seg3's refusal, and seg2 on zipf at full scale (bf16, hub
   rows of 18.6M and 17.7M edges). For each: plan seconds, 1 warm-up and 3
   timed forwards and forward+backwards, peak memory, the launches (counts
   zeroed just before, read just after; the fold pass runs exactly where a
   plan has split rows, so never on the uniform graphs), sampled rows
   (the longest among them), ``d value`` and ``d x`` against f64; the first
   path's first forward+backward runs under the profiler. On the f32 path
   the two span kernels alone, kernel vs plain in turns, with their bounds,
   K1 on the same graph and the library calls computing the same products
   (``torch.sparse.mm``, ``torch.sparse.sampled_addmm``), which the port
   never calls. On zipf 1/8 the span kernels, K1 and K2 alone in f32 and
   bf16, each in turns with its library call in the same dtype, two launches
   of each bit for bit equal, and the fold alone on the hub's partials.

Every kernel in the JSON line carries its time, launches, plain time,
bound (the larger of the bytes each input and output moves once over
3.35 TB/s and its f32 operations over 67 TFLOP/s; ``gather_bound_ms`` is
the gathered rows alone) and library time (null where no single call
computes the same function).

Then the kernels' JSON line, the nvidia-smi line, and as the last line
``{"ok": true, "device": {...}}``. Any failed check exits non-zero; so does a
machine where ``torch.cuda.is_available()`` is False.

f32 matrix products run in full f32: TF32 is switched off below, for the
forward and the backward GEMMs alike.
"""
import dataclasses
import json
import subprocess
import sys
import time

import torch

F32_TOL = dict(rtol=1e-5, atol=1e-4)    # f32 sums taken in another order
BF16_TOL = dict(rtol=2e-2, atol=2e-2)   # output rounded to bf16
# gradients at scale are tiny (the loss is a mean over 2.4M nodes), so their
# f64 checks bound the error by 1e-5 of the sum of |terms| of each dot or
# row-sum: f32 rounding of K-term sums stays far below that
GRAD_REL = 1e-5

# published H100 SXM peaks (NVIDIA's data sheet), for the bounds
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

PRODUCTS_NODES = 2_449_029              # ogbn-products, as bench.py
PRODUCTS_DEG = 50                       # 122,451,450 nnz
GCN_DIMS = (100, 256, 47)               # in, hidden, classes; 3 layers
SAMPLED_ROWS = 4096
SAMPLED_EDGES = 4096
SAMPLED_COLS = 1024
LR = 0.1


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke failed: {msg}")


def _event():
    return torch.cuda.Event(enable_timing=True)


def timed(fn, reps, warm=True):
    """Mean ms of ``reps`` calls after one warm-up (none with ``warm``
    False), by CUDA events; and the last result."""
    if warm:
        fn()
    a, b = _event(), _event()
    a.record()
    for _ in range(reps):
        res = fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps, res


def in_turns(run_p, run_k, reps_p, reps_k):
    """Plain, kernel, kernel, plain: ``(p1, k1, k2, p2, out_p, out_k)``."""
    p1, out_p = timed(run_p, reps_p)
    k1, out_k = timed(run_k, reps_k)
    k2, _ = timed(run_k, reps_k)
    p2, _ = timed(run_p, reps_p)
    return p1, k1, k2, p2, out_p, out_k


def bound_ms(nbytes: float, flops: float):
    """The least time the card could take: the larger of ``nbytes`` over the
    HBM rate and ``flops`` over the f32 rate (the kernels' FMAs run in f32
    on the CUDA cores), with which of the two bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def library_timed(name, fn, reps, ref=None, warm=True):
    """A PyTorch library call timed as a yardstick (never used by the
    port): mean ms over ``reps`` after a warm-up (if ``warm``), and its max
    abs difference from ``ref`` (a sparse result by its values); ``(None,
    None)`` with the error printed if the call fails or runs out of
    memory."""
    try:
        ms, out = timed(fn, reps, warm)
    except (RuntimeError, ValueError, TypeError) as e:
        print(f"library {name}: failed, {type(e).__name__}: "
              f"{str(e).splitlines()[0][:200]}", flush=True)
        torch.cuda.empty_cache()
        return None, None
    if out.layout in (torch.sparse_csr, torch.sparse_coo):
        out = out.values()
    err = (None if ref is None or out.shape != ref.shape
           else float((out.double() - ref.double()).abs().max()))
    del out
    torch.cuda.empty_cache()
    return ms, err


def library_in_turns(name, run_lib, run_k, reps, ref=None):
    """A library call and a kernel in turns, library, kernel, kernel,
    library: ``(library ms or None, kernel ms, library max abs error)``,
    each ms the mean of its two turns."""
    l1, err = library_timed(name, run_lib, reps, ref)
    k1, _ = timed(run_k, reps)
    k2, _ = timed(run_k, reps)
    l2, _ = library_timed(name, run_lib, reps) if l1 is not None else (
        None, None)
    lib = None if l1 is None or l2 is None else (l1 + l2) / 2
    return lib, (k1 + k2) / 2, err


def random_csr(gen, dev, M, N, max_deg):
    deg = torch.randint(0, max_deg + 1, (M,), generator=gen, device=dev)
    deg[[0, M // 3, M - 1]] = 0                  # empty, last row too
    rowptr = torch.zeros(M + 1, dtype=torch.int32, device=dev)
    rowptr[1:] = deg.cumsum(0)
    nnz = int(rowptr[-1])
    col = torch.randint(0, N, (nnz,), generator=gen, device=dev,
                        dtype=torch.int32)
    value = torch.rand(nnz, generator=gen, device=dev) * 2 - 1
    return rowptr, col, value


def long_row_csr(gen, dev, N):
    """One row of 1,100,000 edges among short and empty ones."""
    deg = torch.tensor([3, 0, 1_100_000, 5, 7, 0], device=dev)
    lrp = torch.zeros(deg.numel() + 1, dtype=torch.int32, device=dev)
    lrp[1:] = deg.cumsum(0)
    lcol = torch.randint(0, N, (int(lrp[-1]),), generator=gen, device=dev,
                         dtype=torch.int32)
    return lrp, lcol


def phase2_spmm(gen, dev):
    from paddle_sparse_tpu_torch import (PaddedCOO, spmm_csr_cuda,
                                         spmm_csr_reference)

    def compare(name, out, rowptr, col, value, x, tol):
        ref = spmm_csr_reference(rowptr, col,
                                 None if value is None else value.double(),
                                 x.double())
        got = out.double()
        err = float((got - ref).abs().max()) if ref.numel() else 0.0
        ok = bool(torch.allclose(got, ref, **tol))
        print(f"phase 2 {name}: out {tuple(out.shape)} {out.dtype} "
              f"max_abs_err {err:.3e} {'ok' if ok else 'FAIL'}", flush=True)
        check(ok, f"kernel disagrees with plain f64 on {name} (max abs err "
                  f"{err:.3e}, tol {tol})")

    M, N = 3000, 2000
    rowptr, col, value = random_csr(gen, dev, M, N, 40)
    for K in (1, 8, 47, 100, 256):
        x = torch.randn(N, K, generator=gen, device=dev)
        out = spmm_csr_cuda(rowptr, col, value, x)
        compare(f"K={K} f32", out, rowptr, col, value, x, F32_TOL)
        check(not out[[0, M // 3, M - 1]].any(), "empty rows not zero")
        xb, vb = x.bfloat16(), value.bfloat16()
        out = spmm_csr_cuda(rowptr, col, vb, xb)
        check(out.dtype == torch.bfloat16, "bf16 inputs must give bf16 out")
        compare(f"K={K} bf16", out, rowptr, col, vb, xb, BF16_TOL)
    x = torch.randn(N, 47, generator=gen, device=dev)
    compare("K=47 f32 value=None", spmm_csr_cuda(rowptr, col, None, x),
            rowptr, col, None, x, F32_TOL)
    xb = torch.randn(N, 256, generator=gen, device=dev).bfloat16()
    compare("K=256 bf16 value=None", spmm_csr_cuda(rowptr, col, None, xb),
            rowptr, col, None, xb, BF16_TOL)
    xb = torch.randn(N, 100, generator=gen, device=dev).bfloat16()
    out = spmm_csr_cuda(rowptr, col, value, xb)
    check(out.dtype == torch.float32, "f32 value with bf16 x gives f32 out")
    compare("K=100 bf16 x, f32 value", out, rowptr, col, value, xb, F32_TOL)

    # one row of 1,100,000 edges; small-integer inputs keep every sum exact
    # in f32, so this case checks the long walk and not rounding
    lrp, lcol = long_row_csr(gen, dev, N)
    lval = torch.randint(-2, 3, (lcol.numel(),), generator=gen,
                         device=dev).float()
    for K, dt, tol in ((256, torch.float32, F32_TOL),
                       (47, torch.float32, F32_TOL),
                       (8, torch.bfloat16, BF16_TOL)):
        x = torch.randint(-4, 5, (N, K), generator=gen, device=dev).to(dt)
        v = lval.to(dt)
        compare(f"1.1M-edge row K={K} {dt}", spmm_csr_cuda(lrp, lcol, v, x),
                lrp, lcol, v, x, tol)

    # padded PaddedCOO: pads must never be read; poisoning their col with an
    # index far outside x makes a read fault
    prow = torch.repeat_interleave(
        torch.arange(M, device=dev), (rowptr[1:] - rowptr[:-1]).long())
    adj = PaddedCOO.from_arrays(prow, col, value, (M, N),
                                capacity=col.numel() + 1000, device=dev)
    x = torch.randn(N, 64, generator=gen, device=dev)
    with torch.inference_mode():
        compare("PaddedCOO +1000 pads K=64", adj.spmm(x), rowptr, col,
                value, x, F32_TOL)
        poisoned = dataclasses.replace(adj, col=torch.where(
            adj.valid_mask(), adj.col, torch.full_like(adj.col, 1 << 30)))
        out = poisoned.spmm(x)
        torch.cuda.synchronize()
        compare("PaddedCOO pads col=2**30 K=64", out, rowptr, col, value, x,
                F32_TOL)


def phase2b_sddmm(gen, dev):
    from paddle_sparse_tpu_torch import (PaddedCOO, sddmm_csr_cuda,
                                         sddmm_csr_reference)

    def compare(name, out, rowptr, col, g, x, tol):
        ref = sddmm_csr_reference(rowptr, col, g.double(), x.double(),
                                  out_dtype=torch.float64)
        got = out.double()
        err = float((got - ref).abs().max()) if ref.numel() else 0.0
        ok = bool(torch.allclose(got, ref, **tol))
        print(f"phase 2b {name}: dv {tuple(out.shape)} {out.dtype} "
              f"max_abs_err {err:.3e} {'ok' if ok else 'FAIL'}", flush=True)
        check(ok, f"SDDMM kernel disagrees with plain f64 on {name} (max abs "
                  f"err {err:.3e}, tol {tol})")

    M, N = 3000, 2000
    rowptr, col, _ = random_csr(gen, dev, M, N, 40)      # with empty rows
    for K in (1, 8, 47, 100, 256):
        g = torch.randn(M, K, generator=gen, device=dev)
        x = torch.randn(N, K, generator=gen, device=dev)
        compare(f"K={K} f32", sddmm_csr_cuda(rowptr, col, g, x), rowptr,
                col, g, x, F32_TOL)
        gb, xb = g.bfloat16(), x.bfloat16()
        compare(f"K={K} bf16 in, f32 out", sddmm_csr_cuda(rowptr, col, gb, xb),
                rowptr, col, gb, xb, F32_TOL)
        out = sddmm_csr_cuda(rowptr, col, gb, xb, out_dtype=torch.bfloat16)
        check(out.dtype == torch.bfloat16, "out_dtype bf16 not honoured")
        compare(f"K={K} bf16 in, bf16 out", out, rowptr, col, gb, xb,
                BF16_TOL)

    # padded PaddedCOO: pad slots read back 0, poisoned pad cols never read
    prow = torch.repeat_interleave(
        torch.arange(M, device=dev), (rowptr[1:] - rowptr[:-1]).long())
    adj = PaddedCOO.from_arrays(prow, col, None, (M, N),
                                capacity=col.numel() + 1000, device=dev)
    poisoned = dataclasses.replace(adj, col=torch.where(
        adj.valid_mask(), adj.col, torch.full_like(adj.col, 1 << 30)))
    g = torch.randn(M, 64, generator=gen, device=dev)
    x = torch.randn(N, 64, generator=gen, device=dev)
    out = sddmm_csr_cuda(poisoned.rowptr(), poisoned.col, g, x)
    torch.cuda.synchronize()
    check(out.numel() == col.numel() + 1000 and not out[col.numel():].any(),
          "SDDMM pad slots must read back 0")
    compare("PaddedCOO +1000 pads col=2**30 K=64", out[:col.numel()],
            rowptr, col, g, x, F32_TOL)

    # one row of 1,100,000 edges; small-integer inputs make every dot exact
    lrp, lcol = long_row_csr(gen, dev, N)
    for K, dt in ((256, torch.float32), (100, torch.float32),
                  (8, torch.bfloat16)):
        g = torch.randint(-4, 5, (lrp.numel() - 1, K), generator=gen,
                          device=dev).to(dt)
        x = torch.randint(-4, 5, (N, K), generator=gen, device=dev).to(dt)
        compare(f"1.1M-edge row K={K} {dt}", sddmm_csr_cuda(lrp, lcol, g, x),
                lrp, lcol, g, x, dict(rtol=0, atol=0))

    # identity structure: the kernel is mul_rowsum(a, b)
    L = 50_000
    ident_ptr = torch.arange(L + 1, dtype=torch.int32, device=dev)
    ident_col = torch.arange(L, dtype=torch.int32, device=dev)
    for K in (47, 256):
        a = torch.randn(L, K, generator=gen, device=dev)
        b = torch.randn(L, K, generator=gen, device=dev)
        compare(f"identity (mul_rowsum) L={L} K={K}",
                sddmm_csr_cuda(ident_ptr, ident_col, a, b), ident_ptr,
                ident_col, a, b, F32_TOL)


def phase3_toy(dev):
    from paddle_sparse_tpu_torch import entry
    model_c, adj_c, x_c = entry(dev)
    model_h, adj_h, x_h = entry("cpu")
    with torch.inference_mode():
        out_c = model_c(adj_c, x_c)
        out_h = model_h(adj_h, x_h)
    err = float((out_c.cpu() - out_h).abs().max())
    ok = bool(torch.allclose(out_c.cpu(), out_h, **F32_TOL))
    print(f"phase 3 toy GCN 32->64->8, 256 nodes: cuda vs cpu max_abs_err "
          f"{err:.3e} {'ok' if ok else 'FAIL'}", flush=True)
    check(ok, f"toy GCN on the card disagrees with the CPU ({err:.3e})")


def phase3b_toy_train(dev):
    from paddle_sparse_tpu_torch import gcn_loss, train_entry, train_step
    runs = {}
    for where in (dev, "cpu"):
        model, adj, x, y = train_entry(where)
        adj.value.requires_grad_()
        loss0 = gcn_loss(model, adj, x, y)
        loss0.backward()
        # copies: .cpu() of a CPU tensor is the tensor itself, and the
        # SGD steps below accumulate into adj.value.grad in place
        grads = [p.grad.cpu().clone() for p in model.parameters()]
        grads.append(adj.value.grad.cpu().clone())
        losses = [float(train_step(model, adj, x, y, LR)) for _ in range(20)]
        runs[str(where)] = (float(loss0.detach()), grads, losses)
    (lc, gc, sc), (lh, gh, sh) = runs[str(dev)], runs["cpu"]
    grad_err = max(float((a - b).abs().max()) for a, b in zip(gc, gh))
    step_err = max(abs(a - b) for a, b in zip(sc, sh))
    ok = (abs(lc - lh) <= 1e-5 and step_err <= 1e-4
          and all(torch.allclose(a, b, **F32_TOL) for a, b in zip(gc, gh)))
    print(f"phase 3b toy train step 32->64->8: loss cuda {lc:.6f} cpu "
          f"{lh:.6f}; {len(gc)} grads (params + d value) max_abs_err "
          f"{grad_err:.3e}; 20 SGD steps (lr {LR}) loss {sc[0]:.6f} -> "
          f"{sc[-1]:.6f}, cuda vs cpu max diff {step_err:.3e} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    check(ok, "toy train step on the card disagrees with the CPU")
    check(sc[-1] < sc[0], "toy SGD did not decrease the loss")


def phase4_forward(dev, card):
    from paddle_sparse_tpu_torch import (CAP, PaddedCOO, gcn_normalize,
                                         init_gcn, spmm_csr_cuda,
                                         spmm_csr_reference)
    n, deg_ = PRODUCTS_NODES, PRODUCTS_DEG
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(0)
    row = torch.arange(n, device=dev, dtype=torch.int32).repeat_interleave(
        deg_)
    col = torch.randint(0, n, (n * deg_,), generator=g, device=dev,
                        dtype=torch.int32)
    val = torch.rand(n * deg_, generator=g, device=dev)
    x = torch.randn(n, GCN_DIMS[0], generator=g, device=dev)
    adj = gcn_normalize(PaddedCOO.from_arrays(row, col, val, (n, n)))
    del row, col, val
    model = init_gcn(torch.Generator().manual_seed(0), *GCN_DIMS,
                     num_layers=3, device=dev)
    torch.cuda.synchronize()
    print(f"phase 4 graph: {n} nodes, {adj.nnz} nnz, GCN "
          f"{GCN_DIMS[0]}->{GCN_DIMS[1]}->{GCN_DIMS[1]}->{GCN_DIMS[2]}; "
          f"set-up {time.perf_counter() - t0:.2f} s {card}", flush=True)

    torch.cuda.reset_peak_memory_stats()
    times = []
    with torch.inference_mode():
        _zero_launch_counts()
        out = model(adj, x)                                     # warm-up
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = model(adj, x)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        counts = _launch_counts()
        launches, sddmm_launches = counts["spmm_csr"], counts["sddmm_csr"]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    split = adj.row_split()
    print(f"phase 4 forward ms: {' '.join(f'{t:.3f}' for t in times)} "
          f"(mean {sum(times) / len(times):.3f}) peak mem {peak_gb:.2f} GB "
          f"{card}", flush=True)
    print(f"phase 4 launches in 4 forwards: spmm_csr {launches} "
          f"({launches / 4:g} per forward), sddmm_csr {sddmm_launches}, "
          f"fold_pieces {counts['fold_pieces']} (longest row "
          f"{int(torch.diff(adj.rowptr()).max())} edges, CAP {CAP}: row "
          f"table {split})", flush=True)
    check(split is None and counts["fold_pieces"] == 0,
          "the uniform graph split rows or launched the fold pass")
    check(launches == 3 * 4, f"expected 3 kernel launches per forward, "
                             f"counted {launches} in 4 forwards")
    check(sddmm_launches == 0, f"the forward launched the SDDMM kernel "
                               f"{sddmm_launches} times")
    check(out.shape == (n, GCN_DIMS[2]) and bool(torch.isfinite(out).all()),
          f"forward output not finite or of shape {tuple(out.shape)}")

    # the layers once more, one by one: per-layer times, and each SpMM's
    # output on sampled rows against an f64 recomputation of those rows
    rowptr = adj.rowptr()
    rows = torch.randperm(n, generator=torch.Generator().manual_seed(2)
                          )[:SAMPLED_ROWS].to(dev)
    start = rowptr[rows].long()
    cnt = (rowptr[rows + 1] - rowptr[rows]).long()
    sub_ptr = torch.zeros(SAMPLED_ROWS + 1, dtype=torch.long, device=dev)
    sub_ptr[1:] = cnt.cumsum(0)
    edge = (torch.repeat_interleave(start - sub_ptr[:-1], cnt)
            + torch.arange(int(sub_ptr[-1]), device=dev))
    sub_col = torch.arange(edge.numel(), device=dev)
    sub_val = adj.value[edge].double()
    h = x
    layer_inputs = []
    ev = [_event() for _ in range(3)]
    with torch.inference_mode():
        for i, (w, b) in enumerate(zip(model.weight, model.bias)):
            layer_inputs.append(h)
            ev[0].record()
            s = adj.spmm(h)
            ev[1].record()
            h = s @ w + b
            if i < len(model.weight) - 1:
                h = torch.relu(h)
            ev[2].record()
            torch.cuda.synchronize()
            ref = spmm_csr_reference(sub_ptr, sub_col, sub_val,
                                     layer_inputs[-1][adj.col[edge].long()]
                                     .double())
            got = s[rows].double()
            err = float((got - ref).abs().max())
            ok = bool(torch.allclose(got, ref, **F32_TOL))
            print(f"phase 4 layer {i}: spmm K={s.shape[1]} "
                  f"{ev[0].elapsed_time(ev[1]):.3f} ms, dense "
                  f"{ev[1].elapsed_time(ev[2]):.3f} ms; {SAMPLED_ROWS} "
                  f"sampled rows vs f64 max_abs_err {err:.3e} "
                  f"{'ok' if ok else 'FAIL'} {card}", flush=True)
            check(ok, f"layer {i} SpMM disagrees with f64 on sampled rows")
    check(torch.allclose(h, out, **F32_TOL),
          "layer-by-layer pass disagrees with the model's forward")

    # one K=256 SpMM, kernel vs plain, timed in turns plain/kernel/kernel/plain
    h2 = layer_inputs[1]
    col, value = adj.col, adj.value
    with torch.inference_mode():
        p1, k1, k2, p2, out_p, out_k = in_turns(
            lambda: spmm_csr_reference(rowptr, col, value, h2),
            lambda: spmm_csr_cuda(rowptr, col, value, h2, split=split), 2, 5)
    max_err = float((out_k - out_p).abs().max())
    ok = bool(torch.allclose(out_k, out_p, **F32_TOL))
    print(f"phase 4 spmm K=256 at {adj.nnz} nnz: kernel {k1:.3f} / "
          f"{k2:.3f} ms, plain {p1:.3f} / {p2:.3f} ms; kernel vs plain "
          f"max_abs_err {max_err:.3e} {'ok' if ok else 'FAIL'} {card}",
          flush=True)
    check(ok, "kernel and plain K=256 SpMM disagree at scale")
    # the same product through torch.sparse.mm on the CSR: the yardstick
    nnz = adj.nnz
    csr = torch.sparse_csr_tensor(rowptr, col[:nnz], value[:nnz], (n, n))
    with torch.inference_mode():
        lib_ms, lib_err = library_timed(
            "torch.sparse.mm (K1's product)",
            lambda: torch.sparse.mm(csr, h2), 3, out_k)
    bound, by = bound_ms(nbytes(rowptr, col[:nnz], value[:nnz], h2, out_k),
                         2 * nnz * h2.shape[1])
    print(f"phase 4 spmm K=256: bound {bound:.3f} ms ({by}); "
          f"torch.sparse.mm {lib_ms} ms (vs kernel max_abs_err {lib_err}) "
          f"{card}", flush=True)
    del csr
    stats = {"launches": launches, "sddmm_launches": sddmm_launches,
             "counts": counts, "max_abs_err": max_err,
             "ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
             "bound_ms": bound, "bound_by": by, "library_ms": lib_ms,
             "gather_bound_ms": nnz * h2.shape[1] * h2.element_size()
             / HBM_BYTES_PER_S * 1e3}
    return adj, x, model, stats


def _grad_close(got, ref, scale, out_rel=0.0):
    """Max abs error and whether ``|got - ref| <= GRAD_REL * scale +
    out_rel * |ref|``, with ``scale`` the sum of |terms| of each entry (all
    f64) and ``out_rel`` the rounding of a narrower output."""
    ref = ref.double()
    err = (got.double() - ref).abs()
    bound = GRAD_REL * scale + out_rel * ref.abs() + 1e-30
    return float(err.max()), bool((err <= bound).all())


def phase5_train(dev, card, adj, x, model):
    from paddle_sparse_tpu_torch import (gcn_loss, sddmm_csr_cuda,
                                         sddmm_csr_reference, spmm_csr_cuda,
                                         train_step)
    n, nnz, L = PRODUCTS_NODES, adj.nnz, len(model.weight)
    gen = torch.Generator(device=dev).manual_seed(5)
    y = torch.randint(0, GCN_DIMS[2], (n,), generator=gen, device=dev)
    adj.value.requires_grad_()      # d value, through the SDDMM kernel

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s = adj.structure()
    torch.cuda.synchronize()
    csc_gb = sum(t.numel() * t.element_size()
                 for t in (s.perm, s.col_t, s.colptr)) / 1e9
    print(f"phase 5 CSC view (perm, col_t, colptr): built in "
          f"{(time.perf_counter() - t0) * 1e3:.3f} ms, {csc_gb:.2f} GB "
          f"{card}", flush=True)

    torch.cuda.reset_peak_memory_stats()
    _zero_launch_counts()
    times, losses = [], []
    for _ in range(4):                                  # 1 warm-up + 3
        adj.value.grad = None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = train_step(model, adj, x, y, LR)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    counts = _launch_counts()
    k1_launches, k2_launches = counts["spmm_csr"], counts["sddmm_csr"]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_ms = sum(times[1:]) / 3
    print(f"phase 5 train step ms (forward + backward + SGD): warm-up "
          f"{times[0]:.3f}, timed {' '.join(f'{t:.3f}' for t in times[1:])} "
          f"(mean {step_ms:.3f}); losses "
          f"{' '.join(f'{v:.6f}' for v in losses)}; peak mem "
          f"{peak_gb:.2f} GB {card}", flush=True)
    print(f"phase 5 launches in 4 steps: spmm_csr {k1_launches} "
          f"({k1_launches / 4:g} per step), sddmm_csr {k2_launches} "
          f"({k2_launches / 4:g} per step)", flush=True)
    check(k1_launches == 5 * 4, f"expected 5 spmm_csr launches per step (3 "
                                f"forward, 2 backward), counted {k1_launches}")
    check(k2_launches == 3 * 4, f"expected 3 sddmm_csr launches per step, "
                                f"counted {k2_launches}")
    check(counts["fold_pieces"] == 0 and s.row_split is None
          and s.col_split is None,
          f"the uniform graph's rows or columns split (fold_pieces "
          f"{counts['fold_pieces']})")
    grads = [p.grad for p in model.parameters()] + [adj.value.grad]
    check(all(bool(torch.isfinite(v).all()) for v in grads)
          and all(v == v and abs(v) < float("inf") for v in losses),
          "train step loss or grads not finite")

    # one more step's forward and backward, layer by layer, with CUDA events
    # around each part; the SpMM outputs and inputs keep their grads
    model.zero_grad(set_to_none=True)
    adj.value.grad = None
    ev = [_event() for _ in range(2 * L + 3)]
    hs, ss = [], []
    h = x
    ev[0].record()
    for i, (w, b) in enumerate(zip(model.weight, model.bias)):
        hs.append(h)
        if h.requires_grad:
            h.retain_grad()
        sp = adj.spmm(h)
        sp.retain_grad()
        ss.append(sp)
        ev[2 * i + 1].record()
        h = sp @ w + b
        if i < L - 1:
            h = torch.relu(h)
        ev[2 * i + 2].record()
    loss = -torch.log_softmax(h, dim=-1).gather(1, y[:, None]).mean()
    ev[2 * L + 1].record()
    loss.backward()
    ev[2 * L + 2].record()
    torch.cuda.synchronize()
    check(torch.allclose(loss.detach(),
                         gcn_loss(model, adj, x, y).detach(), rtol=1e-6,
                         atol=0),
          "layer-by-layer loss disagrees with gcn_loss")
    fwd_parts = []
    for i in range(L):
        fwd_parts.append((f"fwd layer {i} spmm K={hs[i].shape[1]}",
                          ev[2 * i].elapsed_time(ev[2 * i + 1])))
        fwd_parts.append((f"fwd layer {i} dense",
                          ev[2 * i + 1].elapsed_time(ev[2 * i + 2])))
    fwd_parts.append(("loss (log_softmax + nll)",
                      ev[2 * L].elapsed_time(ev[2 * L + 1])))
    bwd_ms = ev[2 * L + 1].elapsed_time(ev[2 * L + 2])

    # the backward's kernels replayed alone on this step's own inputs
    rowptr, col = adj.rowptr(), adj.col
    value = adj.value.detach()
    gs = [sp.grad for sp in ss]
    bwd_parts = []
    for i in range(L):
        ms, _ = timed(lambda: sddmm_csr_cuda(rowptr, col, gs[i], hs[i],
                                             split=s.row_split), 1)
        bwd_parts.append((f"bwd layer {i} sddmm K={hs[i].shape[1]}", ms))
        if hs[i].requires_grad:
            ms, value_t = timed(lambda: value.index_select(0, s.perm), 1)
            bwd_parts.append((f"bwd layer {i} value[perm]", ms))
            ms, _ = timed(lambda: spmm_csr_cuda(s.colptr, s.col_t, value_t,
                                                gs[i], split=s.col_split), 1)
            bwd_parts.append((f"bwd layer {i} spmm (CSC) K="
                              f"{hs[i].shape[1]}", ms))
    rest = bwd_ms - sum(ms for _, ms in bwd_parts)
    bwd_parts.append(("bwd dense/autograd rest", rest))
    total = sum(ms for _, ms in fwd_parts) + bwd_ms
    for name, ms in fwd_parts + bwd_parts:
        print(f"phase 5 part {name}: {ms:.3f} ms ({100 * ms / total:.1f}% of "
              f"{total:.3f} ms forward + backward) {card}", flush=True)

    # d value on sampled edges: the sum over layers of g_i[row] . h_i[col]
    gen_h = torch.Generator().manual_seed(6)
    e = torch.randint(0, nnz, (SAMPLED_EDGES,), generator=gen_h).to(dev)
    er = torch.searchsorted(rowptr.long(), e, right=True) - 1
    ec = col[e].long()
    ref = torch.zeros(SAMPLED_EDGES, dtype=torch.float64, device=dev)
    scale = torch.zeros_like(ref)
    for gi, hi in zip(gs, hs):
        terms = gi[er].double() * hi.detach()[ec].double()
        ref += terms.sum(1)
        scale += terms.abs().sum(1)
    err_dv, ok = _grad_close(adj.value.grad[e], ref, scale)
    print(f"phase 5 d value on {SAMPLED_EDGES} sampled edges vs f64: "
          f"max_abs_err {err_dv:.3e} (max |dv| {float(ref.abs().max()):.3e}) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    check(ok, "d value disagrees with f64 on sampled edges")

    # d x on sampled columns: sum over the column's edges of value * g[row]
    cols = torch.randperm(n, generator=gen_h)[:SAMPLED_COLS].to(dev)
    slot = torch.full((n,), -1, dtype=torch.long, device=dev)
    slot[cols] = torch.arange(SAMPLED_COLS, device=dev)
    edges = torch.nonzero(slot[col[:nnz].long()] >= 0).squeeze(1)
    erow = torch.searchsorted(rowptr.long(), edges, right=True) - 1
    eslot = slot[col[edges].long()]
    for i in range(L):
        if not hs[i].requires_grad:
            continue
        terms = value[edges].double()[:, None] * gs[i][erow].double()
        ref = torch.zeros(SAMPLED_COLS, terms.shape[1], dtype=torch.float64,
                          device=dev).index_add_(0, eslot, terms)
        scale = torch.zeros_like(ref).index_add_(0, eslot, terms.abs())
        err_dx, ok = _grad_close(hs[i].grad[cols], ref, scale)
        print(f"phase 5 layer {i} d x on {SAMPLED_COLS} sampled columns "
              f"({edges.numel()} edges) vs f64: max_abs_err {err_dx:.3e} "
              f"(max |dx| {float(ref.abs().max()):.3e}) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        check(ok, f"layer {i} d x disagrees with f64 on sampled columns")

    # the SDDMM at K=256 (layer 1) and K=100 (layer 0), kernel vs plain,
    # timed in turns plain/kernel/kernel/plain
    sddmm_stats = {}
    for i in (1, 0):
        gi, hi = gs[i], hs[i].detach()
        K = hi.shape[1]
        p1, k1, k2, p2, out_p, out_k = in_turns(
            lambda: sddmm_csr_reference(rowptr, col, gi, hi),
            lambda: sddmm_csr_cuda(rowptr, col, gi, hi, split=s.row_split),
            2, 5)
        max_err = float((out_k - out_p).abs().max())
        scale = float(out_p.abs().max())
        ok = bool(torch.allclose(out_k, out_p, rtol=1e-4,
                                 atol=GRAD_REL * scale))
        print(f"phase 5 sddmm K={K} at {nnz} nnz: kernel {k1:.3f} / "
              f"{k2:.3f} ms, plain {p1:.3f} / {p2:.3f} ms; kernel vs plain "
              f"max_abs_err {max_err:.3e} (max |dv| {scale:.3e}) "
              f"{'ok' if ok else 'FAIL'} {card}", flush=True)
        check(ok, f"kernel and plain K={K} SDDMM disagree at scale")
        sddmm_stats[K] = {"max_abs_err": max_err, "ms": (k1 + k2) / 2,
                          "plain_ms": (p1 + p2) / 2}
    # K=256 through torch.sparse.sampled_addmm on the CSR: the yardstick
    gi, hi = gs[1], hs[1].detach()
    hi_t = hi.t().contiguous()
    csr = torch.sparse_csr_tensor(rowptr, col[:nnz], value[:nnz], (n, n))
    with torch.no_grad():
        lib_ms, lib_err = library_timed(
            "torch.sparse.sampled_addmm (K2's product)",
            lambda: torch.sparse.sampled_addmm(csr, gi, hi_t, beta=0.0), 2,
            sddmm_csr_cuda(rowptr, col, gi, hi)[:nnz])
    del csr, hi_t
    bound, by = bound_ms(nbytes(rowptr, col[:nnz], gi, hi) + 4 * nnz,
                         2 * nnz * hi.shape[1])
    print(f"phase 5 sddmm K=256: bound {bound:.3f} ms ({by}); "
          f"torch.sparse.sampled_addmm {lib_ms} ms (vs kernel max_abs_err "
          f"{lib_err}) {card}", flush=True)
    sddmm_stats[256].update(bound_ms=bound, bound_by=by, library_ms=lib_ms,
                            gather_bound_ms=nnz * hi.shape[1] * 4
                            / HBM_BYTES_PER_S * 1e3)
    return {"spmm_launches": k1_launches, "sddmm_launches": k2_launches,
            "counts": counts, "sddmm": sddmm_stats}


def _launch_counts():
    from paddle_sparse_tpu_torch import (compact_runs_cuda, fold_pieces_cuda,
                                         sddmm_csr_cuda, sddmm_spans_cuda,
                                         spmm_csr_cuda, spmm_spans_cuda)
    return {"spmm_csr": spmm_csr_cuda.launches,
            "sddmm_csr": sddmm_csr_cuda.launches,
            "segcompact": compact_runs_cuda.launches,
            "spmm_spans": spmm_spans_cuda.launches,
            "sddmm_spans": sddmm_spans_cuda.launches,
            "fold_pieces": fold_pieces_cuda.launches}


def _zero_launch_counts():
    from paddle_sparse_tpu_torch import (compact_runs_cuda, fold_pieces_cuda,
                                         sddmm_csr_cuda, sddmm_spans_cuda,
                                         spmm_csr_cuda, spmm_spans_cuda)
    spmm_csr_cuda.launches = sddmm_csr_cuda.launches = 0
    compact_runs_cuda.launches = fold_pieces_cuda.launches = 0
    spmm_spans_cuda.launches = sddmm_spans_cuda.launches = 0


def _same_compacted(got, ref, tol):
    """Max abs value error and whether K5's output equals the plain one's:
    count, coordinates and seg exact, values within ``tol``."""
    err = 0.0
    ok = (int(got.count) == int(ref.count) and torch.equal(got.row, ref.row)
          and torch.equal(got.col, ref.col)
          and (ref.seg is None or torch.equal(got.seg, ref.seg)))
    if ref.value is not None:
        g, r = got.value.double(), ref.value.double()
        err = float((g - r).abs().max()) if r.numel() else 0.0
        ok = ok and bool(torch.allclose(g, r, **tol))
    return err, ok


def phase6a_segcompact(gen, dev):
    from paddle_sparse_tpu_torch import (compact_runs_cuda,
                                         compact_runs_reference)
    f64_sums = dict(rtol=1e-12, atol=1e-12)   # f64 sums in another order

    def compare(name, col, rows, value, shape, cap, tol=f64_sums):
        got = compact_runs_cuda(col, rows, value, shape, cap, seg=True)
        ref = compact_runs_reference(
            col, rows, None if value is None else value.double(), shape, cap,
            seg=True)
        torch.cuda.synchronize()
        err, ok = _same_compacted(got, ref, tol)
        print(f"phase 6a {name}: {col.numel()} elements, {int(ref.count)} "
              f"runs, cap {cap}: max_abs_err {err:.3e} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        check(ok, f"K5 disagrees with plain f64 on {name}")
        return int(ref.count)

    def grid(R, F, N, dtype=torch.float64):
        fill = torch.randint(0, F + 1, (R,), generator=gen, device=dev)
        fill[0], fill[-1] = 0, F                       # empty, full rows
        key = torch.randint(0, N, (R, F), generator=gen, device=dev,
                            dtype=torch.int32)
        key = torch.where(torch.arange(F, device=dev) < fill[:, None], key, N)
        key = key.sort(dim=1).values.contiguous()
        val = torch.randn(R, F, generator=gen, device=dev, dtype=torch.float64)
        return key, torch.where(key < N, val, 0.0).to(dtype).contiguous()

    for R, F, N in ((7, 16, 12), (5, 32, 6), (3000, 64, 500),
                    (20_000, 256, 100_000), (64, 1, 3)):
        key, val = grid(R, F, N)
        rows = torch.arange(R, dtype=torch.int32, device=dev)
        cap = int((key < N).sum()) + 5
        compare(f"grid ({R}, {F}) N={N} f64", key, rows, val, (R, N), cap)
        count = compare(f"grid ({R}, {F}) N={N} structure only", key, rows,
                        None, (R, N), cap)
        if count > 1000:
            compare(f"grid ({R}, {F}) N={N} out_capacity count-1000", key,
                    rows, val, (R, N), count - 1000)
    key, val = grid(3000, 64, 500, torch.float32)
    compare("grid (3000, 64) N=500 f32", key,
            torch.arange(3000, dtype=torch.int32, device=dev), val,
            (3000, 500), 200_000, dict(rtol=1e-5, atol=1e-5))
    key, val = grid(777, 40, 90)
    compare("row block: grid rows 5000..5776", key,
            torch.arange(5000, 5777, dtype=torch.int32, device=dev), val,
            (6000, 90), 40_000)
    M, N, L, pads = 3000, 400, 200_000, 3001
    k = (torch.randint(0, M, (L,), generator=gen, device=dev) * (N + 1)
         + torch.randint(0, N, (L,), generator=gen, device=dev)).sort().values
    k = torch.cat([k, torch.full((pads,), M * (N + 1) + N, device=dev)])
    val = torch.randn(L + pads, generator=gen, device=dev, dtype=torch.float64)
    val[L:] = 0
    compare("flat (row, col)-sorted stream", (k % (N + 1)).int(),
            (k // (N + 1)).int(), val, (M, N), L + 10)
    for run in (100_000, 1_100_000):
        # small integers keep the f32 sum of the long run exact
        col = torch.cat([torch.tensor([0, 0, 1], device=dev),
                         torch.full((run,), 2, device=dev),
                         torch.tensor([3, 3, 5], device=dev)]).int()
        v = torch.randint(-3, 4, (col.numel(),), generator=gen,
                          device=dev).float()
        compare(f"one run of {run} elements f32", col, torch.zeros_like(col),
                v, (1, 6), 8, dict(rtol=0, atol=0))


def phase6b_toy_spgemm(dev):
    from paddle_sparse_tpu_torch import (plan_spgemm, plan_spgemm_blocked,
                                         plan_spgemm_rows, spgemm_entry,
                                         spspmm_padded, spspmm_rowblocked,
                                         spspmm_rowsorted)
    runs = {}
    for where in (dev, "cpu"):
        A = spgemm_entry(where)
        v = A.value.clone().requires_grad_()
        Ai = A.with_value(v)
        F, oc = plan_spgemm_rows(Ai, Ai)
        fc, oc2 = plan_spgemm(Ai, Ai)
        blocked = plan_spgemm_blocked(Ai, Ai)
        G = torch.linspace(-1, 1, 20_000, device=where)
        for name, res in (
                ("rowsorted", spspmm_rowsorted(Ai, Ai, F, oc)),
                ("padded", spspmm_padded(Ai, Ai, fc, oc2)),
                ("rowblocked", spspmm_rowblocked(Ai, Ai, blocked[0],
                                                 blocked[1], 64, Ai.capacity,
                                                 blocked[4]))):
            (res.matrix.value * G[:res.matrix.capacity]).sum().backward(
                retain_graph=True)
            C = res.matrix
            runs[str(where), name] = (C.nnz, res.overflowed, C.row.cpu(),
                                      C.col.cpu(), C.value.detach().cpu(),
                                      v.grad.cpu().clone())
            v.grad = None
    for name in ("rowsorted", "padded", "rowblocked"):
        c, h = runs[str(dev), name], runs["cpu", name]
        err_v = float((c[4] - h[4]).abs().max())
        err_g = float((c[5] - h[5]).abs().max())
        ok = (c[0] == h[0] and not c[1] and not h[1]
              and torch.equal(c[2], h[2]) and torch.equal(c[3], h[3])
              and torch.allclose(c[4], h[4], **F32_TOL)
              and torch.allclose(c[5], h[5], **F32_TOL))
        print(f"phase 6b toy A @ A ({name}), 256 nodes: nnz {c[0]}; cuda vs "
              f"cpu structure equal, values max_abs_err {err_v:.3e}, d value "
              f"max_abs_err {err_g:.3e} {'ok' if ok else 'FAIL'}", flush=True)
        check(ok, f"toy A @ A ({name}) on the card disagrees with the CPU")


def spgemm_operand(dev, num_nodes, deg, zipf_alpha=None):
    """``bench.py::_spgemm_operand`` in torch: rows ``arange // deg`` (or
    zipf degrees from numpy seed 0, as there), uniform random cols and
    U(0, 1) values from a seeded generator, then ``from_arrays`` and
    ``coalesce()`` (adjacent duplicates merge; cols within a row stay
    unsorted, as in the JAX operand)."""
    import numpy as np

    from paddle_sparse_tpu_torch import PaddedCOO
    g = torch.Generator(device=dev).manual_seed(1 if zipf_alpha is None
                                                else 2)
    if zipf_alpha is None:
        nnz = num_nodes * deg
        row = torch.arange(nnz, device=dev, dtype=torch.int32) // deg
    else:
        w = np.random.default_rng(0).zipf(zipf_alpha, num_nodes).astype(
            np.float64)
        degs = np.maximum(1, np.floor(w * (num_nodes * deg / w.sum())))
        degs = torch.as_tensor(degs.astype(np.int64), device=dev)
        row = torch.arange(num_nodes, device=dev,
                           dtype=torch.int32).repeat_interleave(degs)
        nnz = row.numel()
    col = torch.randint(0, num_nodes, (nnz,), generator=g, device=dev,
                        dtype=torch.int32)
    val = torch.rand(nnz, generator=g, device=dev)
    return PaddedCOO.from_arrays(row, col, val,
                                 (num_nodes, num_nodes)).coalesce()


class _RecordCompress:
    """Keeps the arguments of every K5 call made inside the ``with``: the
    compress inputs exactly as the SpGEMM path hands them over. Launches
    inside count on the recorder, not on the wrapper's counter."""

    def __enter__(self):
        from paddle_sparse_tpu_torch.ops.kernels import segcompact_cuda
        self.module, self.orig, self.calls = (
            segcompact_cuda, segcompact_cuda.compact_runs_cuda, [])

        def record(*args, **kw):
            self.calls.append((args, kw))
            return self.orig(*args, **kw)

        record.launches = 0
        segcompact_cuda.compact_runs_cuda = record
        return self.calls

    def __exit__(self, *exc):
        self.module.compact_runs_cuda = self.orig


def _check_sampled_rows(A, C, rows):
    """C's ``rows`` against scipy's f64 ``A[rows] @ A`` from host copies of
    A's entries: structure exact, values within f32 rounding."""
    import numpy as np
    import scipy.sparse as sp
    n = A.nnz
    a = sp.csr_matrix((A.value[:n].double().cpu().numpy(),
                       (A.row[:n].cpu().numpy(), A.col[:n].cpu().numpy())),
                      shape=A.shape)
    want = (a[rows.cpu().numpy()] @ a).tocsr()
    want.sort_indices()
    rp = C.rowptr().long()
    lo, hi = rp[rows], rp[rows + 1]
    cnt = hi - lo
    idx = (torch.repeat_interleave(lo - torch.cumsum(cnt, 0) + cnt, cnt)
           + torch.arange(int(cnt.sum()), device=lo.device))
    got_ptr = np.concatenate([[0], torch.cumsum(cnt, 0).cpu().numpy()])
    got_col = C.col[idx].cpu().numpy()
    got_val = C.value[idx].detach().double().cpu().numpy()
    ok = (np.array_equal(got_ptr, want.indptr)
          and np.array_equal(got_col, want.indices))
    err = float(np.abs(got_val - want.data).max()) if ok else float("inf")
    ok = ok and bool(np.allclose(got_val, want.data, rtol=1e-5, atol=1e-6))
    return err, ok, int(cnt.sum())


def _sampled_rows(A, n_rows=1024, seed=3):
    """1024 random rows of A, with its row of most entries among them."""
    n, M = A.nnz, A.shape[0]
    deg = torch.bincount(A.row[:n].long(), minlength=M)
    rows = torch.randperm(M, generator=torch.Generator().manual_seed(seed))
    rows = torch.cat([deg.argmax().view(1).cpu(), rows[:n_rows - 1]])
    return rows.unique().to(A.row.device)


def phase6c_spgemm_path(dev, card, name, A, kind):
    """Plan and run one A @ A path at scale: times, launches, checks, and
    K5 alone on the path's own compress input, kernel vs plain."""
    from paddle_sparse_tpu_torch import (compact_runs_cuda,
                                         compact_runs_reference, plan_spgemm,
                                         plan_spgemm_blocked, plan_spgemm_rows,
                                         spspmm_padded, spspmm_rowblocked,
                                         spspmm_rowsorted)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if kind == "rowsorted":
        F, oc = plan_spgemm_rows(A, A)
        check(F is not None, f"{name}: plan_spgemm_rows refused")

        def call():
            return spspmm_rowsorted(A, A, F, oc)
        plan = {"F": F, "out_cap": oc}
    elif kind == "rowblocked":
        blocked = plan_spgemm_blocked(A, A)
        check(blocked is not None, f"{name}: plan_spgemm_blocked refused")

        def call():
            return spspmm_rowblocked(A, A, *blocked)
        plan = dict(zip(("F", "out_cap", "MB", "EB", "BOC"), blocked))
    else:       # the planners' choice, as bench.py's power-law probe
        check(plan_spgemm_blocked(A, A) is None
              and plan_spgemm_rows(A, A)[0] is None,
              f"{name}: the grid planners accepted the skewed operand")
        fc, oc = plan_spgemm(A, A, exact_out=False)

        def call():
            return spspmm_padded(A, A, fc, oc)
        plan = {"flop_cap": fc, "out_cap": oc}
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base_gb = torch.cuda.memory_allocated() / 1e9
    _zero_launch_counts()
    times = []
    with torch.inference_mode():
        for _ in range(4):                              # 1 warm-up + 3
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = call()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    launches = _launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ms = sum(times[1:]) / 3
    C = res.matrix
    rate = C.nnz / ms / 1e3
    print(f"phase 6c {name}: A {A.nnz} nnz {A.shape}, plan {plan} in "
          f"{plan_s:.3f} s; ms per call: warm-up {times[0]:.3f}, timed "
          f"{' '.join(f'{t:.3f}' for t in times[1:])} (mean {ms:.3f}); "
          f"c_nnz {C.nnz}, {rate:.1f} output Mnnz/s; peak mem {peak_gb:.2f} "
          f"GB (A and the plan {base_gb:.2f} GB); overflowed "
          f"{res.overflowed} {card}", flush=True)
    print(f"phase 6c {name} launches in 4 calls: segcompact "
          f"{launches['segcompact']}, spmm_csr {launches['spmm_csr']}, "
          f"sddmm_csr {launches['sddmm_csr']}", flush=True)
    per_call = -(-A.shape[0] // plan["MB"]) if "MB" in plan else 1
    check(launches["segcompact"] == 4 * per_call,
          f"{name}: expected {4 * per_call} K5 launches (one per call and "
          f"row block), counted {launches['segcompact']}")
    check(not res.overflowed, f"{name}: overflowed")
    check(bool(torch.isfinite(C.value[:C.nnz]).all()), f"{name}: not finite")

    rows = _sampled_rows(A)
    err, ok, n_cmp = _check_sampled_rows(A, C, rows)
    print(f"phase 6c {name}: {rows.numel()} sampled rows of C ({n_cmp} "
          f"entries, A's longest row among them) vs "
          f"scipy f64 A[rows] @ A: max_abs_err {err:.3e} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    check(ok, f"{name}: sampled rows of C disagree with f64")

    # K5 alone on this path's own (largest) compress input, in turns
    c_nnz = C.nnz
    del res, C
    with torch.inference_mode(), _RecordCompress() as calls:
        call()
    args, kw = max(calls, key=lambda c: c[0][0].numel())
    del calls
    with torch.inference_mode():
        p1, k1, k2, p2, out_p, out_k = in_turns(
            lambda: compact_runs_reference(*args, **kw),
            lambda: compact_runs_cuda(*args, **kw), 3, 10)
    err, ok = _same_compacted(out_k, out_p, F32_TOL)
    print(f"phase 6c {name} compress (K5) on the call's "
          f"{tuple(args[0].shape)} input, {int(out_p.count)} runs: kernel "
          f"{k1:.3f} / {k2:.3f} ms, plain {p1:.3f} / {p2:.3f} ms; kernel vs "
          f"plain max_abs_err {err:.3e} {'ok' if ok else 'FAIL'} {card}",
          flush=True)
    check(ok, f"{name}: K5 and its plain version disagree at scale")
    ins = [a for a in (*args, *kw.values()) if isinstance(a, torch.Tensor)]
    moved = nbytes(*ins, out_k.row, out_k.col, out_k.value, out_k.seg)
    bound, by = bound_ms(moved, args[0].numel())     # one add per element
    lib_ms, lib_k_ms, lib_err = k5_library(name, card, args, kw, out_k)
    return {"launches": launches, "ms": ms, "c_nnz": c_nnz,
            "k5": {"max_abs_err": err, "ms": (k1 + k2) / 2,
                   "plain_ms": (p1 + p2) / 2, "bound_ms": bound,
                   "bound_by": by, "library_ms": lib_ms,
                   "ms_beside_library": lib_k_ms,
                   "library_max_abs_err": lib_err}}


def k5_library(name, card, args, kw, out_k):
    """K5's library call on K5's own input stream: ``torch.sparse_coo_tensor
    (...).coalesce()`` sums the runs of equal coordinates (and sorts, which
    the stream already is), in turns with K5. The COO indices of the
    stream's real elements are made outside the timing."""
    from paddle_sparse_tpu_torch import compact_runs_cuda
    col, rows, value, shape = args[:4]
    r = rows[:, None].expand_as(col) if col.dim() == 2 else rows
    keep = (col < shape[1]) & (r < shape[0])
    idx = torch.stack([r[keep], col[keep]]).long()
    vals = (torch.ones(idx.shape[1], device=idx.device) if value is None
            else value[keep])
    n = int(out_k.count)
    with torch.inference_mode():
        lib_ms, k_ms, err = library_in_turns(
            "torch.sparse_coo_tensor(...).coalesce() (K5's function)",
            lambda: torch.sparse_coo_tensor(idx, vals, shape).coalesce(),
            lambda: compact_runs_cuda(*args, **kw), 5, out_k.value[:n])
    print(f"phase 6c {name} K5's library call, torch.sparse_coo_tensor"
          f"(...).coalesce() on the same {idx.shape[1]} elements: "
          f"{lib_ms} ms vs K5 {k_ms:.3f} ms in turns (values max_abs_err "
          f"{err}) {card}", flush=True)
    return lib_ms, k_ms, err


def phase6c_value_grad(dev, A):
    """d value of ``sum(G * C)``, C = A @ A with the two operands as
    separate leaves, on sampled entries of each against f64."""
    from paddle_sparse_tpu_torch import plan_spgemm_rows, spspmm_rowsorted
    F, oc = plan_spgemm_rows(A, A)
    va = A.value.clone().requires_grad_()
    vb = A.value.clone().requires_grad_()
    C = spspmm_rowsorted(A.with_value(va), A.with_value(vb), F, oc).matrix
    G = torch.randn(C.capacity, generator=torch.Generator(
        device=dev).manual_seed(7), device=dev)
    (C.value * G).sum().backward()

    n, N = A.nnz, A.shape[1]
    row, col = A.row[:n].long(), A.col[:n].long()
    val = A.value[:n].double()
    rowptr = A.rowptr().long()
    ckey = C.row[:C.nnz].long() * (N + 1) + C.col[:C.nnz].long()
    Gd = G.double()

    def g_at(r, c):
        return Gd[torch.searchsorted(ckey, r * (N + 1) + c)]

    e = torch.randperm(n, generator=torch.Generator().manual_seed(8))[
        :SAMPLED_EDGES // 16].to(dev)
    worst, ok = 0.0, True
    for side, grad in (("left", va.grad), ("right", vb.grad)):
        refs, scales = [], []
        for i in e.tolist():
            if side == "left":      # sum over B's row col[i]
                lo, hi = rowptr[col[i]], rowptr[col[i] + 1]
                t = g_at(row[i], col[lo:hi]) * val[lo:hi]
            else:                   # sum over A's entries in column row[i]
                a = torch.nonzero(col == row[i]).squeeze(1)
                t = g_at(row[a], col[i]) * val[a]
            refs.append(t.sum())
            scales.append(t.abs().sum())
        err, good = _grad_close(grad[e], torch.stack(refs),
                                torch.stack(scales))
        worst, ok = max(worst, err), ok and good
        print(f"phase 6c 800k d value ({side} operand) on {e.numel()} sampled "
              f"entries vs f64: max_abs_err {err:.3e} "
              f"{'ok' if good else 'FAIL'}", flush=True)
    check(ok, "SpGEMM value grads disagree with f64 on sampled entries")


def phase6c_spgemm(dev, card):
    paths = {}
    A = spgemm_operand(dev, 50_000, 16)
    paths["spgemm_800k_rowsorted"] = phase6c_spgemm_path(
        dev, card, "800k rowsorted", A, "rowsorted")
    phase6c_value_grad(dev, A)
    del A
    A = spgemm_operand(dev, 625_000, 16)
    for kind in ("rowsorted", "rowblocked"):
        paths[f"spgemm_10M_{kind}"] = phase6c_spgemm_path(
            dev, card, f"10M {kind}", A, kind)
    del A
    A = spgemm_operand(dev, 100_000, 16, zipf_alpha=1.5)
    paths["spgemm_zipf_padded"] = phase6c_spgemm_path(
        dev, card, "zipf padded (planners' fallback)", A, "padded")
    return paths

# ---- phase 7: packed-layout SpMMs (seg2, seg3, split) ----------------------

BENCH_NODES = 2_449_029                 # bench.py::get_config defaults
BENCH_NNZ = 123_718_280
# experiments/r4_band_cost.py:21-28: S, BAND, E, K, CAP (edges per span)
R4_BAND_SIZES = (19, 28672, 512, 256, 77824)
TILESPAN_NODES = 200_000                # phase 7a's seg3 graph, degree 10


def span_ptrs(gen, dev, S, M, max_len, empty_rows=(0,)):
    """(S, M+1) int32 row pointers of contiguous spans, span-major, each of
    0..max_len edges, with ``empty_rows`` empty in every span."""
    lens = torch.randint(0, max_len + 1, (S, M), generator=gen, device=dev)
    lens[:, list(empty_rows)] = 0
    ptr = torch.zeros(S * M + 1, dtype=torch.int64, device=dev)
    ptr[1:] = lens.reshape(-1).cumsum(0)
    return ptr.as_strided((S, M + 1), (M, 1)).to(torch.int32)


def spans_csr(start, end, n_cols, dtype):
    """The (M, n_cols) 0/1 CSR whose row m holds the positions of row m's
    (S, M) spans: a library SpMM of it with the stream is the spans' sum.
    The spans of a row must be disjoint and increasing in s (no duplicate
    or unsorted columns), as K4's are."""
    lens = (end.long() - start.long()).clamp_min(0).t().reshape(-1)
    first = start.long().t().reshape(-1)
    M = start.shape[1]
    crow = torch.zeros(M + 1, dtype=torch.int64, device=start.device)
    torch.cumsum(lens.view(M, -1).sum(1), 0, out=crow[1:])
    total = int(crow[-1])
    excl = torch.cumsum(lens, 0) - lens
    col = (torch.repeat_interleave(first - excl, lens)
           + torch.arange(total, device=start.device))
    return torch.sparse_csr_tensor(
        crow, col, torch.ones(total, dtype=dtype, device=start.device),
        (M, n_cols))


def phase7a_spans(gen, dev, card):
    """The multi-span SpMM and the span SDDMM against their plain versions
    in f64; S = 1 against K1 bit for bit; K3's and K4's entry points."""
    from paddle_sparse_tpu_torch import (band_reduce_call, make_seg3_plan,
                                         sddmm_spans_cuda,
                                         sddmm_spans_reference,
                                         spmm_csr_cuda, spmm_spans_cuda,
                                         spmm_spans_reference, tilespan_call,
                                         tilespan_tables)
    M, N = 3000, 2000
    worst = 0.0
    for S in (1, 3, 19, 40):
        rp = span_ptrs(gen, dev, S, M, 3, empty_rows=(0, M // 3, M - 1))
        nnz = int(rp[-1, -1])
        base = torch.randint(0, 100, (S,), generator=gen, device=dev,
                             dtype=torch.int32)
        idx = torch.randint(0, N - 100, (nnz,), generator=gen, device=dev,
                            dtype=torch.int32)
        val = torch.rand(nnz, generator=gen, device=dev) * 2 - 1
        errs = []
        for K in (1, 47, 64, 100, 256, 300):
            for dt in (torch.float32, torch.bfloat16):   # f32 out, f32 sums
                x = torch.randn(N, K, generator=gen, device=dev).to(dt)
                v = None if K == 47 else val
                out = spmm_spans_cuda(rp[:, :-1], rp[:, 1:], idx, v, base, x,
                                      out_dtype=torch.float32)
                ref = spmm_spans_reference(
                    rp[:, :-1], rp[:, 1:], idx,
                    None if v is None else v.double(), base, x.double())
                gm = torch.randn(M, K, generator=gen, device=dev).to(dt)
                dv = sddmm_spans_cuda(rp[:, :-1], rp[:, 1:], idx, base, gm,
                                      x)
                dref = sddmm_spans_reference(rp[:, :-1], rp[:, 1:], idx, base,
                                             gm.double(), x.double(),
                                             torch.float64)
                torch.cuda.synchronize()
                e1 = float((out.double() - ref).abs().max())
                e2 = float((dv.double() - dref).abs().max())
                errs.append(max(e1, e2))
                check(torch.allclose(out.double(), ref, **F32_TOL)
                      and torch.allclose(dv.double(), dref, **F32_TOL)
                      and not out[[0, M // 3, M - 1]].any(),
                      f"span kernels disagree with plain f64 at S={S} K={K} "
                      f"{dt} ({e1:.3e}, {e2:.3e})")
        worst = max(worst, *errs)
        print(f"phase 7a S={S} ({nnz} edges, empty rows and spans), K in 1 "
              f"47 64 100 256 300, f32 and bf16: spmm_spans and sddmm_spans "
              f"vs plain f64 max_abs_err {max(errs):.3e} ok", flush=True)

    # one span: K1's edges, order and operations, so the same bits
    rowptr, col, value = random_csr(gen, dev, M, N, 40)
    rp = rowptr[None]
    for K in (1, 8, 47, 100, 256):
        for dt in (torch.float32, torch.bfloat16):
            x = torch.randn(N, K, generator=gen, device=dev).to(dt)
            for v in (value, None):
                a = spmm_spans_cuda(rp[:, :-1], rp[:, 1:], col, v, None, x)
                check(torch.equal(a, spmm_csr_cuda(rowptr, col, v, x)),
                      f"S=1 spans differ from K1 at K={K} {dt}")
    print("phase 7a S=1: spmm_spans equals spmm_csr (K1) bit for bit at K 1 "
          "8 47 100 256, f32 and bf16, with and without values ok",
          flush=True)

    # one row of 1.1M edges over 3 spans in the stream form, overlapping
    # and reversed spans elsewhere; small integers keep every sum exact
    L, K = 1_200_000, 64
    src = torch.randint(-3, 4, (L, K), generator=gen, device=dev).float()
    start = torch.randint(0, L - 100, (3, 500), generator=gen, device=dev)
    end = start + torch.randint(-5, 60, (3, 500), generator=gen, device=dev)
    start[:, 7] = torch.tensor([0, 400_000, 800_000], device=dev)
    end[:, 7] = torch.tensor([366_000, 766_000, 1_168_000], device=dev)
    out = spmm_spans_cuda(start.int(), end.int(), None, None, None, src)
    ref = spmm_spans_reference(start, end, None, None, None, src.double())
    check(torch.equal(out.double(), ref), "1.1M-edge stream row not exact")
    print("phase 7a stream form, a row of 1,100,000 edges over 3 spans, "
          "overlapping and reversed spans: exact ok", flush=True)

    # K3: tilespan_call on seg3's own tables of a 200k-node graph
    g = torch.Generator(device=dev).manual_seed(70)
    n = TILESPAN_NODES
    row = torch.arange(n * 10, device=dev, dtype=torch.int32) // 10
    col = torch.randint(0, n, (n * 10,), generator=g, device=dev,
                        dtype=torch.int32)
    plan, s = make_seg3_plan(row, col, n, n, feat_dim=256, stream="bf16",
                             sr=16384)
    e0a, bst, ben = tilespan_tables(s.rp_f, S=plan.S, BAND=plan.BAND,
                                    cap=plan.cap, CAP_TS=plan.CAP_TS)
    R, T_B = 128, plan.BAND // 128
    for b in (0, e0a.shape[0] - 1):
        stream = torch.randn(plan.S * plan.cap + plan.CAP_TS, 256,
                             generator=g, device=dev).bfloat16()
        got = tilespan_call(e0a[b], bst[b], ben[b], stream, S=plan.S,
                            T_B=T_B, CAP_TS=plan.CAP_TS, K=256, R=R)
        band = s.rp_f[:, b * plan.BAND:(b + 1) * plan.BAND + 1].long()
        loc = band - band[:, :1] + (torch.arange(plan.S, device=dev)
                                    * plan.cap)[:, None]
        ref = spmm_spans_reference(loc[:, :-1], loc[:, 1:], None, None,
                                   None, stream.double())
        err = float((got.double() - ref).abs().max())
        check(torch.allclose(got.double(), ref, **F32_TOL),
              f"tilespan_call band {b} disagrees ({err:.3e})")
        print(f"phase 7a tilespan_call (K3) band {b} of seg3's tables: "
              f"S={plan.S} T_B={T_B} CAP_TS={plan.CAP_TS} bf16 stream "
              f"{tuple(stream.shape)} vs plain f64 from the row pointers "
              f"max_abs_err {err:.3e} ok", flush=True)
    del plan, s, e0a, bst, ben, stream, row, col

    # K4: band_reduce_call at experiments/r4_band_cost.py's own sizes
    S, BAND, E, K, CAP = R4_BAND_SIZES
    TMAX = 4
    BR_pad = BAND + R
    stream = torch.randn(S * CAP, K, generator=g, device=dev).bfloat16()
    loc = torch.clamp((torch.arange(BAND + 1, device=dev) * (CAP / BAND))
                      .to(torch.int32), 0, CAP)
    offs = (torch.arange(S, device=dev, dtype=torch.int32) * CAP)[:, None]
    lb = torch.cat([loc, loc[-1:].expand(R)])            # pad rows empty
    bounds_start = (lb[None, :BR_pad] + offs).reshape(-1, R)
    bounds_end = (torch.cat([loc[1:], loc[-1:].expand(R + 1)])[None, :BR_pad]
                  + offs).reshape(-1, R)
    sched = [torch.zeros(1, dtype=torch.int32, device=dev)] * 3
    st, en = bounds_start.reshape(S, BR_pad), bounds_end.reshape(S, BR_pad)
    p1, k1, k2, p2, out_p, out_k = in_turns(
        lambda: spmm_spans_reference(st, en, None, None, None, stream,
                                     torch.float32),
        lambda: band_reduce_call(*sched, bounds_start, bounds_end, stream,
                                 S=S, BR_pad=BR_pad, E=E, K=K, TMAX=TMAX),
        1, 5)
    ref = spmm_spans_reference(st, en, None, None, None, stream.double())
    err = float((out_k.double() - ref).abs().max())
    check(torch.allclose(out_k.double(), ref, **F32_TOL)
          and torch.allclose(out_k, out_p, **F32_TOL),
          f"band_reduce_call disagrees with plain f64 ({err:.3e})")
    moved = nbytes(stream, bounds_start, bounds_end, out_k)
    bound, by = bound_ms(moved, S * CAP * K)
    # the library yardstick: the 0/1 span CSR (built outside the timing)
    # times the stream, in the stream's dtype, else in an f32 copy
    lib = "torch.sparse.mm of the 0/1 span CSR, bf16"
    P = spans_csr(st, en, stream.shape[0], stream.dtype)
    lib_ms, lib_err = library_timed(f"{lib} (K4's sum)",
                                    lambda: torch.sparse.mm(P, stream), 5,
                                    out_k)
    if lib_ms is None:
        lib = "torch.sparse.mm of the 0/1 span CSR, f32 copy of the stream"
        P, s32 = spans_csr(st, en, stream.shape[0], torch.float32), \
            stream.float()
        lib_ms, lib_err = library_timed(f"{lib} (K4's sum)",
                                        lambda: torch.sparse.mm(P, s32), 5,
                                        out_k)
        del s32
    del P
    print(f"phase 7a band_reduce_call (K4) at r4_band_cost sizes: S={S} "
          f"BAND={BAND} E={E} K={K} bf16 stream {tuple(stream.shape)} "
          f"({nbytes(stream) / 1e9:.2f} GB): kernel {k1:.3f} / {k2:.3f} ms, "
          f"plain {p1:.3f} / {p2:.3f} ms, bound {bound:.3f} ms ({by}); "
          f"library ({lib}) {lib_ms} ms (max_abs_err {lib_err}); vs plain "
          f"f64 max_abs_err {err:.3e} ok {card}", flush=True)
    return {"max_abs_err": worst,
            "band_reduce": {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
                            "bound_ms": bound, "bound_by": by,
                            "max_abs_err": err, "library_ms": lib_ms,
                            "library": lib}}


def long_row_bounds(gen, dev, S, totals, empty_spans=0.0):
    """(S, M) span bounds whose row m holds ``totals[m]`` flat edges cut at
    random points over the S spans, a share ``empty_spans`` of the cuts
    collapsed (empty spans), span-major as a packed layout lays them out."""
    lens = torch.zeros(S, len(totals), dtype=torch.int64, device=dev)
    for m, n in enumerate(totals):
        if n:
            cut = torch.sort(torch.randint(0, n + 1, (S - 1,), generator=gen,
                                           device=dev)).values
            if S > 1 and empty_spans:
                drop = torch.rand(S - 1, generator=gen, device=dev)
                cut = torch.sort(torch.where(drop < empty_spans,
                                             cut.roll(1), cut)).values
            edges = torch.cat([cut.new_zeros(1), cut, cut.new_full((1,), n)])
            lens[:, m] = torch.diff(edges)
    M = len(totals)
    ptr = torch.zeros(lens.numel() + 1, dtype=torch.int64, device=dev)
    ptr[1:] = lens.reshape(-1).cumsum(0)
    rp = ptr.as_strided((S, M + 1), (M, 1)).to(torch.int32)
    return rp[:, :-1], rp[:, 1:], int(ptr[-1])


def phase7a_long_rows(gen, dev, card):
    """The long-row split of both span kernels against plain f64: rows
    around CAP at S = 1 and 38 over K and dtypes, then a row of 10M edges
    whose spans cross 32-span chunks, exact with small-integer inputs. A
    row sum of thousands of f32 terms is held within GRAD_REL of its sum of
    |terms| (f32 rounding in another order), the K-term dots to F32_TOL."""
    from paddle_sparse_tpu_torch import (CAP, fold_pieces_cuda,
                                         sddmm_spans_cuda,
                                         sddmm_spans_reference, split_rows,
                                         spmm_spans_cuda,
                                         spmm_spans_reference)
    N = 2000
    worst = 0.0
    totals = [0, CAP - 1, 3, CAP, 0, CAP + 1, 7, 2 * CAP + 3, 0, 1]
    for S in (1, 38):
        start, end, nnz = long_row_bounds(gen, dev, S, totals, 0.2)
        t = split_rows(start, end)
        check(t is not None and t.fold_row.tolist() == [5, 7]
              and t.num_slots == 5, f"S={S}: rows CAP+1 and 2*CAP+3 must "
                                    f"split into 2 and 3 pieces")
        base = torch.randint(0, 100, (S,), generator=gen, device=dev,
                             dtype=torch.int32)
        idx = torch.randint(0, N - 100, (nnz,), generator=gen, device=dev,
                            dtype=torch.int32)
        val = torch.rand(nnz, generator=gen, device=dev) * 2 - 1
        errs = []
        for K in (1, 47, 256, 300):
            for dt in (torch.float32, torch.bfloat16):
                x = torch.randn(N, K, generator=gen, device=dev).to(dt)
                gm = torch.randn(len(totals), K, generator=gen,
                                 device=dev).to(dt)
                folds = fold_pieces_cuda.launches
                out = spmm_spans_cuda(start, end, idx, val, base, x,
                                      out_dtype=torch.float32, split=t)
                check(fold_pieces_cuda.launches == folds + 1,
                      "a split spans launch must run the fold once")
                ref = spmm_spans_reference(start, end, idx, val.double(),
                                           base, x.double())
                scale = spmm_spans_reference(start, end, idx,
                                             val.double().abs(), base,
                                             x.double().abs())
                dv = sddmm_spans_cuda(start, end, idx, base, gm, x, split=t)
                dref = sddmm_spans_reference(start, end, idx, base,
                                             gm.double(), x.double(),
                                             torch.float64)
                torch.cuda.synchronize()
                e1, ok1 = _grad_close(out, ref, scale)
                e2 = float((dv.double() - dref).abs().max())
                errs.append(max(e1, e2))
                check(ok1 and torch.allclose(dv.double(), dref, **F32_TOL),
                      f"split span kernels disagree with plain f64 at S={S} "
                      f"K={K} {dt} ({e1:.3e}, {e2:.3e})")
        worst = max(worst, *errs)
        print(f"phase 7a split S={S}: rows of {CAP - 1}, {CAP}, {CAP + 1}, "
              f"{2 * CAP + 3} edges (CAP {CAP}) among short and empty rows, "
              f"20% empty spans, K in 1 47 256 300, f32 and bf16: "
              f"spmm_spans (+ fold) and sddmm_spans vs plain f64 max_abs_err "
              f"{max(errs):.3e} (rows within {GRAD_REL} of their sums of "
              f"|terms|) ok", flush=True)

    # a row of 10M edges among short and empty rows; at S = 38 its spans
    # cross the 32-span chunk boundary and some are empty. Values and x in
    # {-1, 0, 1} keep every f32 sum (|sum| < 2**24) and every dot exact.
    totals = [3, 0, 10_000_000, 5, 0, CAP + 1, 2]
    for S, cases in ((1, ((300, torch.float32), (1, torch.bfloat16))),
                     (38, ((1, torch.float32), (300, torch.bfloat16)))):
        start, end, nnz = long_row_bounds(gen, dev, S, totals, 0.3)
        t = split_rows(start, end)
        base = torch.randint(0, 100, (S,), generator=gen, device=dev,
                             dtype=torch.int32)
        idx = torch.randint(0, N - 100, (nnz,), generator=gen, device=dev,
                            dtype=torch.int32)
        val = torch.randint(-1, 2, (nnz,), generator=gen, device=dev).float()
        for K, dt in cases:
            x = torch.randint(-1, 2, (N, K), generator=gen, device=dev).to(dt)
            gm = torch.randint(-1, 2, (len(totals), K), generator=gen,
                               device=dev).to(dt)
            out = spmm_spans_cuda(start, end, idx, val.to(dt), base, x,
                                  out_dtype=torch.float32, split=t)
            ref = spmm_spans_reference(start, end, idx, val.double(), base,
                                       x.double())
            dv = sddmm_spans_cuda(start, end, idx, base, gm, x, split=t)
            dref = sddmm_spans_reference(start, end, idx, base, gm.double(),
                                         x.double(), torch.float64)
            torch.cuda.synchronize()
            check(torch.equal(out.double(), ref)
                  and torch.equal(dv.double(), dref),
                  f"10M-edge row at S={S} K={K} {dt} not exact")
            del out, ref, dv, dref
        print(f"phase 7a split S={S}: a row of 10,000,000 edges "
              f"({int(t.fold_ptr[-1])} workspace rows; 30% empty spans) "
              f"among short and empty rows, K/dtype "
              f"{[(K, str(dt)[6:]) for K, dt in cases]}: spmm_spans and "
              f"sddmm_spans exact vs plain f64 ok {card}", flush=True)
    return worst


def _packed_fns(backend):
    import paddle_sparse_tpu_torch as p
    if backend == "seg2split":
        return (p.make_split_plan, p.pack_values_split, p.spmm_split,
                p.unpack_values_split)
    plan_fn = p.make_seg3_plan if backend == "seg3" else p.make_seg2_plan
    fn = p.spmm_seg3 if backend == "seg3" else p.spmm_seg2
    return plan_fn, p.pack_values, fn, p.unpack_values


def _leaves(packed):
    if isinstance(packed, tuple):
        return tuple(t.detach().requires_grad_() for t in packed)
    return packed.detach().requires_grad_()


def _grads(leaves):
    return (tuple(t.grad for t in leaves) if isinstance(leaves, tuple)
            else leaves.grad)


def phase7b_toy(dev):
    """``spmm_entry`` for each backend: forward and grads, card vs CPU."""
    from paddle_sparse_tpu_torch import SPMM_BACKENDS, spmm_entry
    for backend in SPMM_BACKENDS:
        fn = _packed_fns(backend)[2]
        runs = {}
        for where in (dev, "cpu"):
            plan, s, packed, x = spmm_entry(backend, where)
            pv, xx = _leaves(packed), x.clone().requires_grad_()
            out = fn(plan, s, pv, xx)
            w = torch.linspace(-1, 1, out.numel(), device=where).view(
                out.shape)
            (out * w).sum().backward()
            gv = _grads(pv)
            gv = gv if isinstance(gv, tuple) else (gv,)
            runs[str(where)] = [t.detach().cpu() for t in (out, xx.grad,
                                                           *gv)]
        err = max(float((a - b).abs().max())
                  for a, b in zip(runs[str(dev)], runs["cpu"]))
        ok = all(torch.allclose(a, b, **F32_TOL)
                 for a, b in zip(runs[str(dev)], runs["cpu"]))
        print(f"phase 7b toy {backend}, 256 nodes, K=32: forward, d packed "
              f"and d x cuda vs cpu max_abs_err {err:.3e} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        check(ok, f"toy {backend} on the card disagrees with the CPU")


def bench_graph(dev, kind, scale, dim):
    """``bench.py``'s generators (``synthetic_graph``, ``zipf_graph``,
    ``clustered_graph``, ``:122-220``) in torch at ``get_config(scale)``'s
    size: rows ``arange // deg`` (zipf: degrees from numpy seed 0, as
    there), uniform cols (clustered: 80% inside the row's 2048-node
    community), U(0,1) values and N(0,1) features from a seeded
    generator. Returns row-sorted int32 ``row``/``col``, ``val``, ``x``."""
    import numpy as np
    n = max(1024, int(BENCH_NODES * scale))
    e = max(16384, int(BENCH_NNZ * scale))
    g = torch.Generator(device=dev).manual_seed(0)
    if kind == "zipf":
        w = np.random.default_rng(0).zipf(1.5, size=n).astype(np.float64)
        deg = np.maximum(1, np.floor(w * (e / w.sum()))).astype(np.int64)
        row = torch.arange(n, device=dev, dtype=torch.int32).repeat_interleave(
            torch.as_tensor(deg, device=dev))
    else:
        deg = max(1, e // n)
        row = torch.arange(deg * n, device=dev, dtype=torch.int32) // deg
    nnz = row.numel()
    col = torch.randint(0, n, (nnz,), generator=g, device=dev,
                        dtype=torch.int32)
    if kind == "clustered":
        c = 2048
        v_in = torch.clamp(row // c * c + torch.randint(
            0, c, (nnz,), generator=g, device=dev, dtype=torch.int32),
            max=n - 1)
        col = torch.where(torch.rand(nnz, generator=g, device=dev) < 0.8,
                          v_in, col)
    val = torch.rand(nnz, generator=g, device=dev)
    x = torch.randn(n, dim, generator=g, device=dev)
    return row, col, val, x


def _sub_csr(rowptr, rows):
    """COO positions of ``rows``' edges and the sub-CSR pointer over them."""
    start = rowptr[rows].long()
    cnt = (rowptr[rows + 1] - rowptr[rows]).long()
    sub_ptr = torch.zeros(rows.numel() + 1, dtype=torch.long,
                          device=rows.device)
    sub_ptr[1:] = cnt.cumsum(0)
    edge = (torch.repeat_interleave(start - sub_ptr[:-1], cnt)
            + torch.arange(int(sub_ptr[-1]), device=rows.device))
    return edge, sub_ptr


def check_packed_grads(name, row, col, val, x, gw, out, d_val, d_x, pdt,
                       rowptr):
    """Sampled rows of ``out``, edges of ``d value`` (COO order) and
    columns of ``d x`` against f64, each within GRAD_REL of the sum of
    |terms| of its entry; sources rounded to ``pdt`` as the port gathers
    them (the plain version widens each window to f64)."""
    from paddle_sparse_tpu_torch import spmm_csr_reference
    dev, n = x.device, x.shape[0]
    xs = x.to(pdt)
    gen = torch.Generator().manual_seed(11)
    deg = rowptr[1:] - rowptr[:-1]
    rows = torch.cat([deg.argmax().view(1).cpu(), torch.randperm(
        n, generator=gen)[:SAMPLED_ROWS - 1]]).unique().to(dev)
    edge, sub_ptr = _sub_csr(rowptr, rows)
    sub_col, sub_val = col[edge], val[edge].double()
    ref = spmm_csr_reference(sub_ptr, sub_col, sub_val, xs)
    scale = spmm_csr_reference(sub_ptr, sub_col, sub_val.abs(), xs.abs())
    err_o, ok_o = _grad_close(out[rows], ref, scale)
    e = torch.randint(0, row.numel(), (SAMPLED_EDGES,), generator=gen).to(dev)
    terms = (gw[row[e].long()].to(pdt).double()
             * xs[col[e].long()].double())
    err_v, ok_v = _grad_close(d_val[e], terms.sum(1), terms.abs().sum(1))
    cols = torch.randperm(n, generator=gen)[:SAMPLED_COLS].to(dev)
    slot = torch.full((n,), -1, dtype=torch.long, device=dev)
    slot[cols] = torch.arange(SAMPLED_COLS, device=dev)
    edges = torch.nonzero(slot[col.long()] >= 0).squeeze(1)
    t = (val[edges].double()[:, None]
         * gw[row[edges].long()].to(pdt).double())
    eslot = slot[col[edges].long()]
    ref_x = torch.zeros(SAMPLED_COLS, x.shape[1], dtype=torch.float64,
                        device=dev).index_add_(0, eslot, t)
    sc_x = torch.zeros_like(ref_x).index_add_(0, eslot, t.abs())
    err_x, ok_x = _grad_close(d_x[cols], ref_x, sc_x)
    ok = ok_o and ok_v and ok_x
    print(f"phase 7c {name}: {rows.numel()} sampled rows ({edge.numel()} "
          f"edges, the longest row among them) max_abs_err {err_o:.3e}; "
          f"d value on {SAMPLED_EDGES} edges {err_v:.3e}; d x on "
          f"{SAMPLED_COLS} columns ({edges.numel()} edges) {err_x:.3e}; vs "
          f"f64 within {GRAD_REL} of the sum of |terms| "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    check(ok, f"{name}: output or grads disagree with f64 on samples")


def first_fwd_bwd(name, card, run_fwd, run_bwd):
    """A path's first forward+backward under ``torch.profiler``, launched
    as the timed calls launch it (no synchronize between forward and
    backward): when the host's calls returned, when the device finished,
    the device time, the ops that took the most host time and the
    allocator's device allocations and retries, to show where a slow first
    call goes. Returns its ms and the output."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    m0 = torch.cuda.memory_stats()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = run_fwd()
        t1 = time.perf_counter()
        run_bwd(out)
        t2 = time.perf_counter()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
    m1 = torch.cuda.memory_stats()
    ev = prof.key_averages()
    dev_ms = sum(getattr(e, "self_device_time_total", 0) for e in ev
                 if e.device_type == DeviceType.CUDA) / 1e3
    top = sorted(ev, key=lambda e: e.self_cpu_time_total, reverse=True)[:6]
    delta = {k: m1.get(k, 0) - m0.get(k, 0)
             for k in ("num_device_alloc", "num_device_free",
                       "num_alloc_retries")}
    print(f"phase 7c {name} first forward+backward, profiled: host "
          f"returns from the forward after {(t1 - t0) * 1e3:.3f} ms and "
          f"from backward() after {(t2 - t0) * 1e3:.3f} ms, device done "
          f"after {(t3 - t0) * 1e3:.3f} ms; kernel time {dev_ms:.3f} ms; "
          f"allocator {delta}; most host time: " + "; ".join(
              f"{e.key[:60]} {e.self_cpu_time_total / 1e3:.3f} ms x{e.count}"
              for e in top) + f" {card}", flush=True)
    return (t3 - t0) * 1e3, out


def phase7c_path(dev, card, name, backend, graph, stream, reps=3,
                 profile_first=False, **plan_kw):
    """Plan once, then 1 warm-up + ``reps`` forwards and forward+backwards
    of ``backend`` on ``graph``: times, peak memory, launches (counts
    zeroed just before and read just after), sampled f64 checks. With
    ``profile_first`` the first forward+backward runs under the profiler
    (:func:`first_fwd_bwd`)."""
    from paddle_sparse_tpu_torch import ind2ptr, product_dtype
    row, col, val, x = graph
    n, K = x.shape
    plan_fn, pack_fn, fn, unpack_fn = _packed_fns(backend)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plan, s = plan_fn(row, col, n, n, feat_dim=K, stream=stream, **plan_kw)
    packed = pack_fn(s, val)
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    plans = [plan.local, plan.resid] if backend == "seg2split" else [plan]
    desc = "; ".join(f"S={q.S} SR={q.SR} S_t={q.S_t}" for q in plans)
    if backend == "seg2split":
        desc += (f"; local {s.idx_local.numel()} / resid "
                 f"{s.idx_resid.numel()} edges")
    if backend == "seg3":
        desc += f"; BAND={plan.BAND} cap={plan.cap} CAP_TS={plan.CAP_TS}"
    structs = [s.local, s.resid] if backend == "seg2split" else [s]
    for q in structs:
        for side, t in (("rows", q.split_f), ("x rows", q.split_t)):
            desc += (f"; no {side} split" if t is None else
                     f"; {t.fold_row.numel()} {side} split into "
                     f"{t.num_slots} pieces")
    gw = torch.randn(n, K, generator=torch.Generator(device=dev).manual_seed(
        12), device=dev)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero_launch_counts()
    fwd, fwdbwd = [], []
    with torch.inference_mode():
        for _ in range(reps + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(plan, s, packed, x)
            torch.cuda.synchronize()
            fwd.append((time.perf_counter() - t0) * 1e3)
    del out
    pv, xx = _leaves(packed), x.detach().requires_grad_()
    for i in range(reps + 1):
        xx.grad = None
        for t in (pv if isinstance(pv, tuple) else (pv,)):
            t.grad = None
        if i == 0 and profile_first:
            ms, out = first_fwd_bwd(name, card, lambda: fn(plan, s, pv, xx),
                                    lambda o: o.backward(gw))
            fwdbwd.append(ms)
            continue
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(plan, s, pv, xx)
        out.backward(gw)
        torch.cuda.synchronize()
        fwdbwd.append((time.perf_counter() - t0) * 1e3)
    counts = _launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    f_ms, fb_ms = sum(fwd[1:]) / reps, sum(fwdbwd[1:]) / reps
    print(f"phase 7c {name}: {n} nodes, {row.numel()} nnz, K={K}, stream "
          f"{stream}; plan ({desc}) in {plan_s:.3f} s; forward ms warm-up "
          f"{fwd[0]:.3f}, timed {' '.join(f'{t:.3f}' for t in fwd[1:])} "
          f"(mean {f_ms:.3f}); forward+backward ms warm-up {fwdbwd[0]:.3f}, "
          f"timed {' '.join(f'{t:.3f}' for t in fwdbwd[1:])} (mean "
          f"{fb_ms:.3f}); peak mem {peak_gb:.2f} GB {card}", flush=True)
    calls = len(plans)
    runs = reps + 1
    print(f"phase 7c {name} launches in {runs} forwards + {runs} "
          f"forward+backwards: " + ", ".join(f"{k} {v}" for k, v in
                                             counts.items()), flush=True)
    # the fold follows each spans launch over a split layout: the forward's
    # in every run, the transpose's in the forward+backwards
    folds = sum(runs * (2 * (q.split_f is not None)
                        + (q.split_t is not None)) for q in structs)
    want = {"spmm_spans": 3 * runs * calls, "sddmm_spans": runs * calls,
            "fold_pieces": folds}
    check(all(counts[k] == want.get(k, 0) for k in counts),
          f"{name}: expected launches {want} (spans 1 per forward, 2 per "
          f"forward+backward, span SDDMM 1, per seg2 call; the fold after "
          f"each spans launch over a split layout), counted {counts}")
    check(bool(torch.isfinite(out).all()) and out.shape == (n, K),
          f"{name}: output not finite or of shape {tuple(out.shape)}")
    d_val = unpack_fn(s, _grads(pv))
    pdt = product_dtype(val, x, stream)
    check_packed_grads(name, row, col, val, x, gw, out.detach(), d_val,
                       xx.grad, pdt, ind2ptr(row, n))
    return {"plan": plan, "s": s, "packed": packed, "gw": gw,
            "stats": {"plan_s": plan_s, "fwd_ms": f_ms, "fwd_bwd_ms": fb_ms,
                      "peak_gb": peak_gb, "launches": counts}}


def phase7c_kernels(dev, card, run, graph):
    """The multi-span SpMM and the span SDDMM alone on the seg2 f32 path's
    own inputs, kernel vs plain in turns, with their bounds, K1 on the same
    graph, and the library calls computing the same products."""
    from paddle_sparse_tpu_torch import (ind2ptr, sddmm_spans_cuda,
                                         sddmm_spans_reference, spmm_csr_cuda,
                                         spmm_spans_cuda,
                                         spmm_spans_reference, split_rows,
                                         unpack_values)
    row, col, val, x = graph
    plan, s, packed, gw = run["plan"], run["s"], run["packed"], run["gw"]
    M, nnz, K = plan.num_rows, row.numel(), x.shape[1]
    st, en = s.rp_f[:, :M], s.rp_f[:, 1:M + 1]
    res = {}
    with torch.inference_mode():
        p1, k1, k2, p2, out_p, out_k = in_turns(
            lambda: spmm_spans_reference(st, en, s.col_f, packed, s.sbase_f,
                                         x),
            lambda: spmm_spans_cuda(st, en, s.col_f, packed, s.sbase_f, x,
                                    split=s.split_f), 1, 5)
        err = float((out_k - out_p).abs().max())
        check(torch.allclose(out_k, out_p, **F32_TOL),
              f"spmm_spans kernel and plain disagree at scale ({err:.3e})")
        b, by = bound_ms(nbytes(s.rp_f, s.col_f, packed, s.sbase_f, x, out_k),
                         2 * nnz * K)
        res["spmm_spans"] = {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
                             "max_abs_err": err, "bound_ms": b,
                             "bound_by": by, "gather_bound_ms":
                             nnz * K * 4 / HBM_BYTES_PER_S * 1e3}
        print(f"phase 7c spmm_spans on seg2's forward (S={plan.S}, K={K}, "
              f"f32): kernel {k1:.3f} / {k2:.3f} ms, plain {p1:.3f} / "
              f"{p2:.3f} ms, bound {b:.3f} ms ({by}), the gathered rows "
              f"alone {res['spmm_spans']['gather_bound_ms']:.3f} ms; max_abs_"
              f"err {err:.3e} ok {card}", flush=True)
        xb = x.bfloat16()
        ms_b, out_b = timed(lambda: spmm_spans_cuda(st, en, s.col_f, packed,
                                                    s.sbase_f, xb,
                                                    split=s.split_f), 5)
        res["spmm_spans"]["ms_bf16"] = ms_b
        del out_b

        p1, k1, k2, p2, dv_p, dv_k = in_turns(
            lambda: sddmm_spans_reference(st, en, s.col_f, s.sbase_f, gw, x),
            lambda: sddmm_spans_cuda(st, en, s.col_f, s.sbase_f, gw, x,
                                     split=s.split_f), 1, 5)
        err = float((dv_k - dv_p).abs().max())
        scale = float(dv_p.abs().max())
        check(torch.allclose(dv_k, dv_p, rtol=1e-4, atol=GRAD_REL * scale),
              f"sddmm_spans kernel and plain disagree at scale ({err:.3e})")
        b, by = bound_ms(nbytes(s.rp_f, s.col_f, s.sbase_f, gw, x, dv_k),
                         2 * nnz * K)
        res["sddmm_spans"] = {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
                              "max_abs_err": err, "bound_ms": b,
                              "bound_by": by, "gather_bound_ms":
                              nnz * K * 4 / HBM_BYTES_PER_S * 1e3}
        print(f"phase 7c sddmm_spans on seg2's backward (K={K}, f32): kernel "
              f"{k1:.3f} / {k2:.3f} ms, plain {p1:.3f} / {p2:.3f} ms, bound "
              f"{b:.3f} ms ({by}); max_abs_err {err:.3e} (max |dv| "
              f"{scale:.3e}) ok {card}", flush=True)
        del dv_p, out_p

        # yardsticks on the same graph in CSR (COO) order, never on the path
        rowptr = ind2ptr(row, M).to(torch.int32)
        t_csr = split_rows(rowptr[None, :-1], rowptr[None, 1:])
        out_csr = out_k
        k1_ms, out_k1 = timed(lambda: spmm_csr_cuda(rowptr, col, val, x,
                                                    split=t_csr), 5)
        k1_err = float((out_k1 - out_csr).abs().max())
        del out_k1
        csr = torch.sparse_csr_tensor(rowptr, col, val, (M, M))
        lib_mm, lib_mm_err = library_timed(
            "torch.sparse.mm (the spans' product)",
            lambda: torch.sparse.mm(csr, x), 3, out_csr)
        x_t = x.t().contiguous()
        dv_coo = unpack_values(s, dv_k)
    lib_sd, lib_sd_err = library_timed(
        "torch.sparse.sampled_addmm (the span SDDMM's product)",
        lambda: torch.sparse.sampled_addmm(csr, gw, x_t, beta=0.0), 2, dv_coo)
    del csr, x_t, dv_coo
    torch.cuda.empty_cache()
    res["spmm_spans"].update(library_ms=lib_mm, k1_same_graph_ms=k1_ms)
    res["sddmm_spans"]["library_ms"] = lib_sd
    print(f"phase 7c yardsticks on the same graph (CSR order, f32, K={K}): "
          f"K1 spmm_csr {k1_ms:.3f} ms (vs spans max_abs_err {k1_err:.3e}); "
          f"torch.sparse.mm {lib_mm} ms (max_abs_err {lib_mm_err}); "
          f"torch.sparse.sampled_addmm {lib_sd} ms (max_abs_err "
          f"{lib_sd_err}); spans with a bf16 x {ms_b:.3f} ms {card}",
          flush=True)
    return res


def phase7c_scale(dev, card):
    """The bench's seg2/seg3/split cells at full width (K=256, K=64 for
    dim64): plan, times, launches and sampled f64 checks for each."""
    from paddle_sparse_tpu_torch import CAP, Seg3Infeasible, make_seg3_plan
    paths = {}
    graph = bench_graph(dev, "uniform", 1.0, 256)
    run = phase7c_path(dev, card, "seg2 uniform f32", "seg2", graph, "f32",
                       profile_first=True)
    paths["seg2_uniform_f32"] = run["stats"]
    kernels = phase7c_kernels(dev, card, run, graph)
    del run
    torch.cuda.empty_cache()
    paths["seg2_uniform_bf16"] = phase7c_path(
        dev, card, "seg2 uniform bf16", "seg2", graph, "bf16")["stats"]
    torch.cuda.empty_cache()
    paths["seg3_uniform_bf16"] = phase7c_path(
        dev, card, "seg3 uniform bf16", "seg3", graph, "bf16")["stats"]
    del graph
    torch.cuda.empty_cache()
    graph = bench_graph(dev, "uniform", 0.125, 64)
    paths["seg2_dim64_bf16"] = phase7c_path(
        dev, card, "seg2 dim64 1/8 bf16", "seg2", graph, "bf16")["stats"]
    del graph
    graph = bench_graph(dev, "clustered", 1.0, 256)
    torch.cuda.empty_cache()
    paths["split_clustered_bf16"] = phase7c_path(
        dev, card, "split clustered bf16", "seg2split", graph, "bf16",
        block=2048)["stats"]
    del graph
    torch.cuda.empty_cache()
    graph = bench_graph(dev, "zipf", 0.125, 256)
    row, col, _, x = graph
    try:
        make_seg3_plan(row, col, x.shape[0], x.shape[0], feat_dim=256,
                       stream="bf16")
        refused = None
    except Seg3Infeasible as e:
        refused = str(e)
    check(refused is not None, "seg3 planned the 1/8 zipf graph")
    deg = torch.bincount(row.long(), minlength=x.shape[0])
    print(f"phase 7c zipf 1/8 ({row.numel()} nnz, hub row of "
          f"{int(deg.max())} edges): make_seg3_plan refused "
          f"(Seg3Infeasible: {refused}); the bench falls back to seg2",
          flush=True)
    run = phase7c_path(dev, card, "seg2 zipf 1/8 bf16", "seg2", graph,
                       "bf16")
    paths["seg2_zipf_bf16"] = run["stats"]
    kernels["zipf"] = phase7c_zipf_kernels(dev, card, run, graph)
    del graph, run
    torch.cuda.empty_cache()
    graph = bench_graph(dev, "zipf", 1.0, 256)
    deg = torch.bincount(graph[0].long(), minlength=graph[3].shape[0])
    top = torch.topk(deg, 2).values.tolist()
    print(f"phase 7c zipf full scale: {graph[0].numel()} nnz, top rows "
          f"{top[0]} and {top[1]} edges, {int((deg > CAP).sum())} rows of "
          f"more than CAP = {CAP} edges holding "
          f"{int(deg[deg > CAP].sum())}", flush=True)
    paths["seg2_zipf_full_bf16"] = phase7c_path(
        dev, card, "seg2 zipf full bf16", "seg2", graph, "bf16")["stats"]
    del graph, deg
    torch.cuda.empty_cache()
    return paths, kernels


def phase7c_zipf_kernels(dev, card, run, graph):
    """On the zipf 1/8 path, whose hub rows split: the two span kernels
    alone on the path's own inputs, K1 and K2 on the same graph's CSR, each
    in f32 and bf16 in turns with its library call in the same dtype
    (``torch.sparse.mm``, ``torch.sparse.sampled_addmm``); two launches of
    each bit for bit equal; and the fold alone on the hub's partials
    against its plain version and ``index_add_``."""
    from paddle_sparse_tpu_torch import (fold_pieces_cuda, ind2ptr,
                                         sddmm_csr_cuda, sddmm_spans_cuda,
                                         spmm_csr_cuda, spmm_spans_cuda,
                                         split_rows, unpack_values)
    from paddle_sparse_tpu_torch.ops.kernels.row_split import \
        fold_pieces_reference
    row, col, val, x = graph
    plan, s, packed, gw = run["plan"], run["s"], run["packed"], run["gw"]
    M, K, nnz = plan.num_rows, x.shape[1], row.numel()
    st, en = s.rp_f[:, :M], s.rp_f[:, 1:M + 1]
    rowptr = ind2ptr(row, M).to(torch.int32)
    t_csr = split_rows(rowptr[None, :-1], rowptr[None, 1:])
    res = {"hub_edges": int(torch.diff(rowptr).max()),
           "split_rows": int(s.split_f.fold_row.numel()),
           "pieces": int(s.split_f.row.numel())}
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt)[6:]
        xd, gd, vd, pd = x.to(dt), gw.to(dt), val.to(dt), packed.to(dt)
        csr = torch.sparse_csr_tensor(rowptr, col, vd, (M, M))
        x_t = xd.t().contiguous()
        with torch.inference_mode():
            def spans():
                return spmm_spans_cuda(st, en, s.col_f, pd, s.sbase_f, xd,
                                       out_dtype=dt, split=s.split_f)

            def k1():
                return spmm_csr_cuda(rowptr, col, vd, xd, split=t_csr)

            def span_sddmm():
                return sddmm_spans_cuda(st, en, s.col_f, s.sbase_f, gd, xd,
                                        split=s.split_f)

            def k2():
                return sddmm_csr_cuda(rowptr, col, gd, xd, split=t_csr)
            out, out_k1 = spans(), k1()
            dv, dv_k2 = span_sddmm(), k2()
            check(all(torch.equal(a, b) for a, b in (
                (out, spans()), (out_k1, k1()), (dv, span_sddmm()),
                (dv_k2, k2()))), f"zipf {name}: two launches differ")
            dv_coo = unpack_values(s, dv)
            # the hub row's 10M terms summed in two orders (packed and
            # CSR): each within GRAD_REL of the row's sum of |terms|, and a
            # bf16 output rounded once on each side (up to 2**-8 of it each)
            scale = spmm_spans_cuda(st, en, s.col_f, pd.abs(), s.sbase_f,
                                    xd.abs(), out_dtype=torch.float32,
                                    split=s.split_f).double()
            err, ok = _grad_close(out_k1, out, 2 * scale,
                                  0.0 if dt == torch.float32 else 2 ** -7)
            check(ok and torch.allclose(dv_coo, dv_k2, **F32_TOL),
                  f"zipf {name}: the spans and K1 ({err:.3e}) or the span "
                  f"SDDMM and K2 disagree")
            del scale
            lib = f"torch.sparse.mm ({name})"
            mm_ms, sp_ms, mm_err = library_in_turns(
                lib, lambda: torch.sparse.mm(csr, xd), spans, 3, out)
            _, k1_ms, _ = library_in_turns(
                lib, lambda: torch.sparse.mm(csr, xd), k1, 3)
        # sampled_addmm takes seconds on this graph: one call before and
        # one after the two kernels' turns, no warm-up
        lib2 = f"torch.sparse.sampled_addmm ({name})"

        def sampled():
            return torch.sparse.sampled_addmm(csr, gd, x_t, beta=0.0)
        sa1, sa_err = library_timed(lib2, sampled, 1, dv_coo, warm=False)
        sd1, _ = timed(span_sddmm, 3)
        k21, _ = timed(k2, 3)
        k22, _ = timed(k2, 3)
        sd2, _ = timed(span_sddmm, 3)
        sa2 = (None if sa1 is None
               else library_timed(lib2, sampled, 1, warm=False)[0])
        sa_ms = None if sa2 is None else (sa1 + sa2) / 2
        sd_ms, k2_ms = (sd1 + sd2) / 2, (k21 + k22) / 2
        gather = nnz * K * xd.element_size() / HBM_BYTES_PER_S * 1e3
        sp_b = bound_ms(nbytes(s.rp_f, s.col_f, pd, s.sbase_f, xd)
                        + M * K * xd.element_size(), 2 * nnz * K)
        k1_b = bound_ms(nbytes(rowptr, col, vd, xd)
                        + M * K * xd.element_size(), 2 * nnz * K)
        sd_b = bound_ms(nbytes(s.rp_f, s.col_f, s.sbase_f, gd, xd)
                        + 4 * nnz, 2 * nnz * K)
        k2_b = bound_ms(nbytes(rowptr, col, gd, xd) + 4 * nnz, 2 * nnz * K)
        del csr, x_t, out, out_k1, dv, dv_k2, dv_coo, pd
        torch.cuda.empty_cache()
        res[name] = {
            "spmm_spans": {"ms": sp_ms, "library_ms": mm_ms,
                           "library_max_abs_err": mm_err,
                           "bound_ms": sp_b[0], "bound_by": sp_b[1]},
            "spmm_csr": {"ms": k1_ms, "library_ms": mm_ms,
                         "bound_ms": k1_b[0], "bound_by": k1_b[1]},
            "sddmm_spans": {"ms": sd_ms, "library_ms": sa_ms,
                            "library_max_abs_err": sa_err,
                            "bound_ms": sd_b[0], "bound_by": sd_b[1]},
            "sddmm_csr": {"ms": k2_ms, "library_ms": sa_ms,
                          "bound_ms": k2_b[0], "bound_by": k2_b[1]},
            "gather_bound_ms": gather}
        print(f"phase 7c zipf 1/8 kernels alone ({name}, K={K}, {nnz} nnz, "
              f"hub row of {res['hub_edges']} edges, {res['split_rows']} "
              f"rows split into {s.split_f.num_slots} pieces), each in "
              f"turns with its library "
              f"call in {name}: spmm_spans {sp_ms:.3f} ms, K1 {k1_ms:.3f} ms "
              f"vs torch.sparse.mm {mm_ms} ms (max_abs_err {mm_err}); "
              f"sddmm_spans {sd_ms:.3f} ms, K2 {k2_ms:.3f} ms vs "
              f"sampled_addmm {sa_ms} ms (max_abs_err {sa_err}); gathered "
              f"rows bound {gather:.3f} ms; two launches of each bit for "
              f"bit equal {card}", flush=True)

    # the fold alone on the forward's split rows, K=256 f32 partials
    t = s.split_f
    ws = torch.randn(t.num_slots, K, generator=torch.Generator(
        device=dev).manual_seed(13), device=dev)
    out_p = torch.zeros(M, K, device=dev)
    out_k = torch.zeros(M, K, device=dev)
    slot_rows = torch.repeat_interleave(t.fold_row.long(),
                                        torch.diff(t.fold_ptr.long()))
    folds = fold_pieces_cuda.launches
    p1, k1_, k2_, p2, _, _ = in_turns(
        lambda: fold_pieces_reference(t, ws, out_p),
        lambda: fold_pieces_cuda(t, ws, out_k), 1, 20)
    check(fold_pieces_cuda.launches == folds + 42, "fold launches")
    # thousands of partials summed in two orders: within GRAD_REL of the
    # sum of their |values|
    scale = torch.zeros(M, K, device=dev)
    fold_pieces_reference(t, ws.abs(), scale)
    err, ok = _grad_close(out_k, out_p, scale.double())
    check(ok, f"fold disagrees with plain ({err:.3e})")
    out_l = torch.zeros(M, K, device=dev)
    lib_ms, _ = library_timed("index_add_ (the fold's sum)",
                              lambda: out_l.index_add_(0, slot_rows, ws), 20)
    fb, fby = bound_ms(nbytes(ws, t.fold_row, t.fold_ptr)
                       + t.fold_row.numel() * K * 4, t.num_slots * K)
    res["fold_pieces"] = {"ms": (k1_ + k2_) / 2, "plain_ms": (p1 + p2) / 2,
                          "max_abs_err": err, "bound_ms": fb,
                          "bound_by": fby, "library_ms": lib_ms,
                          "slots": t.num_slots, "rows": t.fold_row.numel()}
    print(f"phase 7c zipf 1/8 fold alone ({t.num_slots} partials of "
          f"{t.fold_row.numel()} split rows, K={K} f32): kernel {k1_:.3f} / "
          f"{k2_:.3f} ms, plain {p1:.3f} / {p2:.3f} ms, index_add_ {lib_ms} "
          f"ms, bound {fb:.4f} ms ({fby}); max_abs_err {err:.3e} ok {card}",
          flush=True)
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible "
              "(torch.cuda.is_available() is False); nothing was run",
              file=sys.stderr)
        return 1

    from paddle_sparse_tpu_torch.ops.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False   # full-f32 h @ w
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t_start = time.perf_counter()

    def stamp(done):
        print(f"elapsed {time.perf_counter() - t_start:.1f} s after {done}",
              flush=True)

    # ---- phase 1: device and build ---------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    card = f"[{smi}]"
    print(f"phase 1 device: {smi} | torch {torch.__version__} | CUDA "
          f"{torch.version.cuda} | {torch.cuda.get_device_name(0)} | "
          f"count {torch.cuda.device_count()}", flush=True)
    t0 = time.perf_counter()
    so = _build.build_library(_build.sources(), _build.BUILD_DIR)
    _build.load_library()
    build_s = time.perf_counter() - t0
    print(f"phase 1 build: {so.name} from {len(_build.sources())} source(s) "
          f"with nvcc for sm_90a in {build_s:.2f} s {card}", flush=True)

    # ---- phases 2-3b: kernels vs plain, toy slices -----------------------
    gen = torch.Generator(device=dev).manual_seed(1)
    phase2_spmm(gen, dev)
    phase2b_sddmm(gen, dev)
    phase3_toy(dev)
    phase3b_toy_train(dev)

    stamp("phases 1-3b")

    # ---- phases 4-5: GCN inference and train step at scale ---------------
    adj, x, model, fwd = phase4_forward(dev, card)
    torch.cuda.empty_cache()
    train = phase5_train(dev, card, adj, x, model)
    del adj, x, model
    torch.cuda.empty_cache()

    stamp("phases 4-5")

    # ---- phase 6: run compaction (K5) and SpGEMM --------------------------
    phase6a_segcompact(gen, dev)
    phase6b_toy_spgemm(dev)
    spgemm = phase6c_spgemm(dev, card)
    k5 = spgemm["spgemm_10M_rowsorted"]["k5"]

    stamp("phase 6")

    # ---- phase 7: packed-layout SpMMs (seg2, seg3, split) -----------------
    spans = phase7a_spans(gen, dev, card)
    stamp("phase 7a without the split")
    spans["split_max_abs_err"] = phase7a_long_rows(gen, dev, card)
    stamp("phase 7a's split")
    phase7b_toy(dev)
    packed_paths, span_k = phase7c_scale(dev, card)
    stamp("phase 7c")
    full = packed_paths["seg2_zipf_full_bf16"]["launches"]
    check(full["fold_pieces"] > 0 and full["spmm_spans"] > 0
          and full["sddmm_spans"] > 0,
          f"full-scale zipf did not run the split kernels: {full}")
    print("phase 7c summary " + json.dumps(
        {p: {k: v for k, v in st.items() if k != "launches"}
         for p, st in packed_paths.items()}), flush=True)

    launches = {"gcn_forward": fwd["counts"],
                "gcn_train_step": train["counts"],
                **{p: v["launches"] for p, v in spgemm.items()},
                **{p: v["launches"] for p, v in packed_paths.items()}}

    def by_path(kernel):
        return {p: c[kernel] for p, c in launches.items()}

    k256 = train["sddmm"][256]
    sp, sd = span_k["spmm_spans"], span_k["sddmm_spans"]
    zipf = span_k["zipf"]
    fold = zipf["fold_pieces"]

    def zipf_1_8(kernel):
        """The kernel alone on zipf 1/8 in f32 and bf16, beside its
        library call in the same dtype."""
        return {"hub_edges": zipf["hub_edges"], "K": 256,
                **{dt: {**zipf[dt][kernel],
                        "gather_bound_ms": zipf[dt]["gather_bound_ms"]}
                   for dt in ("float32", "bfloat16")}}
    print(json.dumps({"kernels": [
        {"name": "spmm_csr", "route": "cuda",
         "source": "paddle_sparse_tpu_torch/csrc/spmm_spans.cu",
         "source_note": "the multi-span kernel at S = 1 over the CSR "
                        "pointer, through spmm_csr_cuda",
         "replaces": "paddle_sparse_tpu/ops/kernels/spmm_pallas.py:45",
         "launches": train["spmm_launches"],
         "launches_by_path": by_path("spmm_csr"),
         "max_abs_err": fwd["max_abs_err"], "ms": fwd["ms"],
         "plain_ms": fwd["plain_ms"], "bound_ms": fwd["bound_ms"],
         "bound_by": fwd["bound_by"], "library_ms": fwd["library_ms"],
         "library": "torch.sparse.mm on the CSR",
         "gather_bound_ms": fwd["gather_bound_ms"], "K": 256,
         "ms_on_seg2_graph": sp["k1_same_graph_ms"],
         "zipf_1_8": zipf_1_8("spmm_csr")},
        {"name": "sddmm_csr", "route": "cuda",
         "source": "paddle_sparse_tpu_torch/csrc/sddmm_spans.cu",
         "source_note": "the span SDDMM at S = 1 over the CSR pointer, "
                        "through sddmm_csr_cuda",
         "replaces": "paddle_sparse_tpu/ops/kernels/spmm_pallas.py:877",
         "replaces_note": "K2 as ops/spmm_seg2.py:559 calls it; on the JAX "
                          "GCN train path d value is an XLA gather-dot "
                          "(ops/spmm.py:102-105, spmm_pallas.py:564-566); "
                          "its span form is sddmm_spans",
         "launches": train["sddmm_launches"],
         "launches_by_path": by_path("sddmm_csr"),
         "max_abs_err": k256["max_abs_err"], "ms": k256["ms"],
         "plain_ms": k256["plain_ms"], "bound_ms": k256["bound_ms"],
         "bound_by": k256["bound_by"], "library_ms": k256["library_ms"],
         "library": "torch.sparse.sampled_addmm on the CSR",
         "gather_bound_ms": k256["gather_bound_ms"], "K": 256,
         "ms_K100": train["sddmm"][100]["ms"],
         "plain_ms_K100": train["sddmm"][100]["plain_ms"],
         "zipf_1_8": zipf_1_8("sddmm_csr")},
        {"name": "segcompact", "route": "cuda",
         "source": "paddle_sparse_tpu_torch/csrc/segcompact.cu",
         "replaces": "paddle_sparse_tpu/ops/kernels/segcompact.py:42",
         "replaces_note": "the JAX package runs K5 only under "
                          "PSP_SPGEMM_COMPRESS=kernel "
                          "(core/spgemm.py:363-386); its default compress "
                          "is XLA segment ops, which "
                          "this kernel also stands for, as it does for "
                          "spspmm_padded, spspmm_rowblocked and coalesce",
         "launches": sum(v["launches"]["segcompact"]
                         for v in spgemm.values()),
         "launches_by_path": by_path("segcompact"),
         "max_abs_err": k5["max_abs_err"], "ms": k5["ms"],
         "plain_ms": k5["plain_ms"], "bound_ms": k5["bound_ms"],
         "bound_by": k5["bound_by"], "library_ms": k5["library_ms"],
         "library": "torch.sparse_coo_tensor(...).coalesce() on K5's input "
                    "stream",
         "at": "10M-nnz A @ A rowsorted grid",
         "by_path": {p: v["k5"] for p, v in spgemm.items()}},
        {"name": "spmm_spans", "route": "cuda",
         "source": "paddle_sparse_tpu_torch/csrc/spmm_spans.cu",
         "replaces": "paddle_sparse_tpu/ops/kernels/spmm_pallas.py:708",
         "replaces_also": ["paddle_sparse_tpu/ops/kernels/spmm_pallas.py:601"],
         "replaces_note": "K3 through tilespan_call, K4 through "
                          "band_reduce_call, and the windowed _reduce_call "
                          "passes of ops/spmm_seg2.py::_seg_pass",
         "launches": packed_paths["seg2_uniform_f32"]["launches"][
             "spmm_spans"],
         "launches_by_path": by_path("spmm_spans"),
         "max_abs_err": sp["max_abs_err"], "ms": sp["ms"],
         "plain_ms": sp["plain_ms"], "bound_ms": sp["bound_ms"],
         "bound_by": sp["bound_by"], "library_ms": sp["library_ms"],
         "library": "torch.sparse.mm on the CSR of the same matrix",
         "gather_bound_ms": sp["gather_bound_ms"], "K": 256,
         "at": "seg2 forward, uniform 2,449,029 nodes, f32",
         "ms_bf16_x": sp["ms_bf16"], "zipf_1_8": zipf_1_8("spmm_spans"),
         "k1_same_graph_ms": sp["k1_same_graph_ms"],
         "band_reduce_r4_sizes": spans["band_reduce"],
         "max_abs_err_vs_f64_sweep": spans["max_abs_err"]},
        {"name": "sddmm_spans", "route": "cuda",
         "source": "paddle_sparse_tpu_torch/csrc/sddmm_spans.cu",
         "replaces": "paddle_sparse_tpu/ops/kernels/spmm_pallas.py:877",
         "replaces_note": "K2 at its one JAX call site, "
                          "ops/spmm_seg2.py:559 (_sddmm_pass)",
         "launches": packed_paths["seg2_uniform_f32"]["launches"][
             "sddmm_spans"],
         "launches_by_path": by_path("sddmm_spans"),
         "max_abs_err": sd["max_abs_err"], "ms": sd["ms"],
         "plain_ms": sd["plain_ms"], "bound_ms": sd["bound_ms"],
         "bound_by": sd["bound_by"], "library_ms": sd["library_ms"],
         "library": "torch.sparse.sampled_addmm on the CSR",
         "gather_bound_ms": sd["gather_bound_ms"], "K": 256,
         "at": "seg2 backward, uniform 2,449,029 nodes, f32",
         "zipf_1_8": zipf_1_8("sddmm_spans"),
         "split_max_abs_err_vs_f64": spans["split_max_abs_err"]},
        {"name": "fold_pieces", "route": "cuda",
         "source": "paddle_sparse_tpu_torch/csrc/spmm_spans.cu",
         "source_note": "fold_pieces_kernel, the second pass of a split "
                        "spans launch (K1, K3, K4) over split rows' "
                        "partials, through row_split.fold_pieces_cuda",
         "replaces": "paddle_sparse_tpu/ops/spmm.py:293",
         "replaces_note": "_fold_rows, an XLA segment_sum over the pseudo-"
                          "rows of _split_long_rows; no pallas_call of its "
                          "own",
         "launches": packed_paths["seg2_zipf_full_bf16"]["launches"][
             "fold_pieces"],
         "launches_by_path": by_path("fold_pieces"),
         "max_abs_err": fold["max_abs_err"], "ms": fold["ms"],
         "plain_ms": fold["plain_ms"], "bound_ms": fold["bound_ms"],
         "bound_by": fold["bound_by"], "library_ms": fold["library_ms"],
         "library": "index_add_ of the partials into their rows",
         "at": f"zipf 1/8 forward's {fold['rows']} split rows, "
               f"{fold['slots']} partials, K=256 f32"}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Smoke test of paddle_sparse_tpu_torch on one NVIDIA GPU (written for an H100).

Run from the repository root:

    python3 chip_smoke.py

Phases, one or more printed lines each:

1. Device and build: the card's name and power limit (nvidia-smi), the torch
   and CUDA versions, then the CUDA kernels built from ``csrc/`` with nvcc.
2. Kernel vs plain: ``spmm_csr_cuda`` against ``spmm_csr_reference`` run in
   f64 on the card, over K, dtypes, ``value=None``, empty rows, a row of over
   1M edges and a padded ``PaddedCOO``.
3. Toy slice: ``entry("cuda")``'s GCN forward against the same model run on
   the CPU through the plain path.
4. GCN inference at ogbn-products scale (2,449,029 nodes, degree 50, the OGB
   products GCN baseline 100 -> 256 -> 256 -> 47): 1 warm-up and 3 timed
   forwards, the kernel's launch count, per-layer times, a sampled-row check
   against f64, and the K=256 SpMM timed through the kernel and the plain
   version.

Then the kernels' JSON line, the nvidia-smi line, and as the last line
``{"ok": true, "device": {...}}``. Any failed check exits non-zero; so does a
machine where ``torch.cuda.is_available()`` is False.

f32 matrix products run in full f32: TF32 is switched off below.
"""
import dataclasses
import json
import subprocess
import sys
import time

F32_TOL = dict(rtol=1e-5, atol=1e-4)    # f32 sums taken in another order
BF16_TOL = dict(rtol=2e-2, atol=2e-2)   # output rounded to bf16

PRODUCTS_NODES = 2_449_029              # ogbn-products, as bench.py
PRODUCTS_DEG = 50                       # 122,451,450 nnz
GCN_DIMS = (100, 256, 47)               # in, hidden, classes; 3 layers
SAMPLED_ROWS = 4096


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke failed: {msg}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible "
              "(torch.cuda.is_available() is False); nothing was run",
              file=sys.stderr)
        return 1

    from paddle_sparse_tpu_torch import (PaddedCOO, entry, gcn_normalize,
                                         init_gcn, spmm_csr_cuda,
                                         spmm_csr_reference)
    from paddle_sparse_tpu_torch.ops.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False   # full-f32 h @ w
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

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

    # ---- phase 2: kernel vs plain ----------------------------------------
    gen = torch.Generator(device=dev).manual_seed(1)

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

    def random_csr(M, N, max_deg):
        deg = torch.randint(0, max_deg + 1, (M,), generator=gen, device=dev)
        deg[[0, M // 3, M - 1]] = 0                  # empty, last row too
        rowptr = torch.zeros(M + 1, dtype=torch.int32, device=dev)
        rowptr[1:] = deg.cumsum(0)
        nnz = int(rowptr[-1])
        col = torch.randint(0, N, (nnz,), generator=gen, device=dev,
                            dtype=torch.int32)
        value = torch.rand(nnz, generator=gen, device=dev) * 2 - 1
        return rowptr, col, value

    M, N = 3000, 2000
    rowptr, col, value = random_csr(M, N, 40)
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
    deg = torch.tensor([3, 0, 1_100_000, 5, 7, 0], device=dev)
    lrp = torch.zeros(deg.numel() + 1, dtype=torch.int32, device=dev)
    lrp[1:] = deg.cumsum(0)
    lnnz = int(lrp[-1])
    lcol = torch.randint(0, N, (lnnz,), generator=gen, device=dev,
                         dtype=torch.int32)
    lval = torch.randint(-2, 3, (lnnz,), generator=gen, device=dev).float()
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

    # ---- phase 3: toy slice, card vs CPU ---------------------------------
    model_c, adj_c, x_c = entry("cuda")
    model_h, adj_h, x_h = entry("cpu")
    with torch.inference_mode():
        out_c = model_c(adj_c, x_c)
        out_h = model_h(adj_h, x_h)
    err = float((out_c.cpu() - out_h).abs().max())
    ok = bool(torch.allclose(out_c.cpu(), out_h, **F32_TOL))
    print(f"phase 3 toy GCN 32->64->8, 256 nodes: cuda vs cpu max_abs_err "
          f"{err:.3e} {'ok' if ok else 'FAIL'}", flush=True)
    check(ok, f"toy GCN on the card disagrees with the CPU ({err:.3e})")

    # ---- phase 4: GCN inference at ogbn-products scale -------------------
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
        spmm_csr_cuda.launches = 0
        out = model(adj, x)                                     # warm-up
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = model(adj, x)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        launches = spmm_csr_cuda.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"phase 4 forward ms: {' '.join(f'{t:.3f}' for t in times)} "
          f"(mean {sum(times) / len(times):.3f}) peak mem {peak_gb:.2f} GB "
          f"{card}", flush=True)
    print(f"phase 4 spmm_csr launches in 4 forwards: {launches} "
          f"({launches / 4:g} per forward)", flush=True)
    check(launches == 3 * 4, f"expected 3 kernel launches per forward, "
                             f"counted {launches} in 4 forwards")
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
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
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

    def timed(fn, reps):
        fn()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(reps):
            res = fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps, res

    run_k = lambda: spmm_csr_cuda(rowptr, col, value, h2)       # noqa: E731
    run_p = lambda: spmm_csr_reference(rowptr, col, value, h2)  # noqa: E731
    with torch.inference_mode():
        p1, out_p = timed(run_p, 2)
        k1, out_k = timed(run_k, 5)
        k2, _ = timed(run_k, 5)
        p2, _ = timed(run_p, 2)
    kernel_ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
    max_err = float((out_k - out_p).abs().max())
    ok = bool(torch.allclose(out_k, out_p, **F32_TOL))
    print(f"phase 4 spmm K=256 at {adj.nnz} nnz: kernel {k1:.3f} / "
          f"{k2:.3f} ms, plain {p1:.3f} / {p2:.3f} ms; kernel vs plain "
          f"max_abs_err {max_err:.3e} {'ok' if ok else 'FAIL'} {card}",
          flush=True)
    check(ok, "kernel and plain K=256 SpMM disagree at scale")

    print(json.dumps({"kernels": [{
        "name": "spmm_csr", "route": "cuda",
        "source": "paddle_sparse_tpu_torch/csrc/spmm_csr.cu",
        "replaces": "paddle_sparse_tpu/ops/kernels/spmm_pallas.py:45",
        "launches": launches, "max_abs_err": max_err,
        "ms": kernel_ms, "plain_ms": plain_ms}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

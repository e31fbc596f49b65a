"""The work counted from shapes (``work.py``, ``models/``) against hand
counts at a tiny size, and each per-layer metric's reader on a made-up
trace whose answer is known."""
from pathlib import Path
from types import SimpleNamespace

import pytest

from bench_port import devtrace, peaks, spec, work
from bench_port.models import gcn, sage

BENCH = Path(__file__).resolve().parent
CFG = {"num_layers": 3, "in_channels": 3, "hidden_channels": 5,
       "out_channels": 2}
n, nnz = 7, 11


def test_sparse_bytes_and_flops_by_hand():
    K, it = 5, 4
    ptr, idx, val = (n + 1) * 4, nnz * 4, nnz * it
    assert work.sparse_bytes("spmm", K, n, nnz, it) == \
        ptr + idx + val + n * K * it + n * K * it
    assert work.sparse_bytes("spmm_t", K, n, nnz, it) == \
        ptr + idx + val + 2 * n * K * it
    # pointer, cols, g and x read; d value written
    assert work.sparse_bytes("sddmm", K, n, nnz, it) == \
        ptr + idx + 2 * n * K * it + nnz * it
    # pointer, rows, values, g and x read; d x and d value written
    assert work.sparse_bytes("spmm_sddmm", K, n, nnz, it) == \
        ptr + idx + val + 3 * n * K * it + nnz * it
    assert work.sparse_flops("spmm", K, nnz) == 2 * nnz * K
    assert work.sparse_flops("sddmm", K, nnz) == 2 * nnz * K
    assert work.sparse_flops("spmm_sddmm", K, nnz) == 4 * nnz * K
    with pytest.raises(ValueError):
        work.sparse_bytes("spgemm", K, n, nnz, it)


def test_least_seconds_takes_the_larger_bound():
    p = {"hbm_bytes_per_s": 10.0, "flops_per_s": 100.0}
    assert work.least_seconds(50, 100, p) == 5.0
    assert work.least_seconds(5, 1000, p) == 10.0


def test_products_k1_bound_is_1793_ms():
    # the figure PERF.md carries: K1 at K = 256, f32, at products' size
    p = peaks.peak("NVIDIA H100 80GB HBM3")
    t = work.sparse_least_seconds([("spmm", 256)], 2449029, 122451450, 4, p)
    assert abs(t * 1e3 - 1.793) < 0.001


def test_gcn_sparse_ops_and_flops_by_hand():
    assert gcn.sparse_ops(CFG, False, False) == [
        ("spmm", 3), ("spmm", 5), ("spmm", 5)]
    assert gcn.sparse_ops(CFG, True, False) == [
        ("spmm", 3), ("spmm", 5), ("spmm", 5), ("spmm_t", 5),
        ("spmm_t", 5)]
    assert gcn.sparse_ops(CFG, True, True) == [
        ("spmm", 3), ("spmm", 5), ("spmm", 5), ("spmm_sddmm", 5),
        ("spmm_sddmm", 5), ("sddmm", 3)]
    fwd = 2 * n * (3 * 5 + 5 * 5 + 5 * 2)
    assert gcn.dense_flops(CFG, n, False, False) == fwd
    # d W everywhere, d s above the first layer
    assert gcn.dense_flops(CFG, n, True, False) == \
        2 * fwd + 2 * n * (5 * 5 + 5 * 2)
    assert gcn.dense_flops(CFG, n, True, True) == 3 * fwd


def test_sage_flops_by_hand():
    fwd = 2 * 2 * n * (3 * 5 + 5 * 5 + 5 * 2)
    assert sage.dense_flops(CFG, n, False, False) == fwd
    above = 2 * n * (5 * 5 + 5 * 2)      # one product above the first layer
    # both d W, then d h through W_self and d agg through W_neigh above it
    assert sage.dense_flops(CFG, n, True, False) == 2 * fwd + 2 * above
    assert sage.dense_flops(CFG, n, True, True) == \
        2 * fwd + 2 * above + 2 * n * 3 * 5
    assert [name for name, _ in sage.param_shapes(CFG)][:3] == [
        "self_weight.0", "self_weight.1", "self_weight.2"]


def _ctx(train, ops, names_times, steps=2, window=1.0, value_grad=False):
    """A made-up trace: ``names_times`` device operations back to back
    from 0.1 s, in a window of ``window`` seconds."""
    dev, t = [], 0.1
    for name, dur in names_times:
        dev.append(devtrace.Op(name, t, dur))
        t += dur
    tr = devtrace.Trace((0.0, window), dev, [])
    model = SimpleNamespace(
        sparse_ops=lambda cfg, tr_, vg: ops,
        dense_flops=lambda cfg, n_, tr_, vg: 1000)
    launches = {"spmm_csr": sum(k in ("spmm", "spmm_t") for k, _ in ops)
                * steps,
                "spmm_sddmm_csc": sum(k == "spmm_sddmm" for k, _ in ops)
                * steps,
                "sddmm_csr": sum(k == "sddmm" for k, _ in ops) * steps}
    return SimpleNamespace(
        train=train, config=CFG, traffic={"value_grad": value_grad},
        model=model, n=n, nnz=nnz, steps=steps, trace=tr, window_s=window,
        busy_s=devtrace.busy_seconds(tr),
        port=devtrace.matcher(["spmm_spans_kernel", "spmm_sddmm_kernel"]),
        peak={"hbm_bytes_per_s": 1e3, "flops_per_s": 1e4}, itemsize=4,
        spans={"structure_s": 0.25}, launches=launches)


def _reader(name):
    return spec.load_module(BENCH / "metrics" / f"{name}.py",
                            f"test_metric_{name}")


def test_roofline_readers():
    ops = [("spmm", 3), ("spmm", 5), ("spmm_sddmm", 5)]
    k1 = [("void psp::spmm_spans_kernel<float>(int const*)", 0.01)] * 4
    k2p = [("void spmm_sddmm_kernel_tight<float, 8>(int)", 0.02)] * 2
    ctx = _ctx(True, ops, k1 + k2p + [("ampere_sgemm_128x64_nn", 0.05)])
    p = ctx.peak
    least = 2 * work.sparse_least_seconds(ops[:2], n, nnz, 4, p)
    assert _reader("spmm_roofline.train").read(ctx) == pytest.approx(
        100 * least / 0.04)
    least = 2 * work.sparse_least_seconds(ops[2:], n, nnz, 4, p)
    assert _reader("fused_bwd_roofline.train").read(ctx) == pytest.approx(
        100 * least / 0.04)
    # a train reader reads nothing in an inference cell, and the other
    # way round
    assert _reader("spmm_roofline.eval").read(ctx) is None
    ctx.train = False
    assert _reader("spmm_roofline.train").read(ctx) is None


def test_sddmm_roofline_reader():
    ops = [("spmm", 3), ("spmm_sddmm", 5), ("sddmm", 3)]
    k2 = [("void psp::sddmm_spans_kernel<float, float, 4>(int const*)",
           0.03)] * 2
    ctx = _ctx(True, ops, k2 + [("spmm_spans_kernel<float>", 0.01)] * 2,
               value_grad=True)
    least = 2 * work.sparse_least_seconds(ops[2:], n, nnz, 4, ctx.peak)
    assert _reader("sddmm_roofline.train").read(ctx) == pytest.approx(
        100 * least / 0.06)
    # K2 off the path: no edge-value grads, no SDDMM to read
    ctx = _ctx(True, ops[:2], [("spmm_spans_kernel<float>", 0.01)] * 2)
    assert _reader("sddmm_roofline.train").read(ctx) is None


def test_roofline_reads_nothing_off_the_path():
    ops = [("spmm", 3), ("spmm", 5)]
    # three K1 kernels in the trace where the step's equations need four
    ctx = _ctx(True, ops, [("spmm_spans_kernel<float>", 0.01)] * 3)
    assert _reader("spmm_roofline.train").read(ctx) is None
    ctx = _ctx(True, ops, [("spmm_spans_kernel<float>", 0.01)] * 4)
    ctx.peak = None             # a card without a peak in the table
    assert _reader("spmm_roofline.train").read(ctx) is None
    assert _reader("mfu.train").read(ctx) is None


def test_mfu_aten_idle_structure_readers():
    ops = [("spmm", 3), ("spmm", 5)]
    ctx = _ctx(True, ops, [("spmm_spans_kernel<float>", 0.1)] * 4
               + [("at::native::elementwise_kernel<128>", 0.2)],
               steps=2, window=1.0)
    flops = 2 * nnz * 3 + 2 * nnz * 5 + 1000
    assert _reader("mfu.train").read(ctx) == pytest.approx(
        100 * flops / 0.5 / 1e4)
    assert _reader("aten_ms.train").read(ctx) == pytest.approx(100.0)
    assert _reader("idle_share.train").read(ctx) == pytest.approx(40.0)
    assert _reader("structure_s").read(ctx) == 0.25
    assert _reader("mfu.eval").read(ctx) is None
    ev = _ctx(False, ops, [("spmm_spans_kernel<float>", 0.1)] * 4)
    assert _reader("idle_share.eval").read(ev) == pytest.approx(60.0)
    assert _reader("aten_ms.eval").read(ev) == 0.0


def test_busy_counts_overlap_once():
    ops = [devtrace.Op("a", 0.0, 0.5), devtrace.Op("b", 0.25, 0.5),
           devtrace.Op("c", 0.9, 0.05)]
    tr = devtrace.Trace((0.0, 1.0), ops, [devtrace.Op("bench.step", 0.0,
                                                      1.0)])
    assert devtrace.busy_seconds(tr) == pytest.approx(0.8)
    gaps = devtrace.top_gaps(tr)
    assert [round(g[1], 6) for g in gaps] == [0.15, 0.05]
    assert gaps[0][0] == "bench.step"


def test_kernel_names_of_the_program():
    import paddle_sparse_tpu_torch as psp
    names = devtrace.kernel_names(Path(psp.__file__).parent / "csrc")
    for k in ("spmm_spans_kernel", "sddmm_spans_kernel",
              "spmm_sddmm_kernel", "spmm_sddmm_kernel_tight",
              "fold_pieces_kernel"):
        assert k in names
    port = devtrace.matcher(names)
    assert port("void psp::spmm_spans_kernel<float, 8>(int const*)")
    assert not port("void at::native::vectorized_elementwise_kernel<4>()")
    assert devtrace.short_name(
        "void psp::spmm_spans_kernel<float, (anon)::X<4> >(int const*, "
        "float*)") == "psp::spmm_spans_kernel<float, (anon)::X<4> >"
    assert devtrace.short_name(
        "void (anonymous namespace)::spmm_sddmm_kernel_tight<float, 8>"
        "(int const*, float*)") == \
        "(anonymous namespace)::spmm_sddmm_kernel_tight<float, 8>"
    assert devtrace.short_name("Memset (Device)") == "Memset "

"""The join of device operations to the program's spans
(``attribution.py``) and the SpMM autograd layer's readers
(``spmm_aten_ms.train``, ``csc_relays.train``) on made-up traces whose
answer is known, the other readers unmoved by the program's spans, and a
CPU run that reports the relays."""
import time
from pathlib import Path
from types import SimpleNamespace

import pytest

from bench_port import attribution, devtrace, spec
from bench_port.devtrace import Op, Trace

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
NEW = ("spmm_aten_ms.train", "csc_relays.train")
K1 = "void psp::spmm_spans_kernel<float, 8>(int const*)"
K2P = "void spmm_sddmm_kernel_tight<float, 8>(int)"
GATHER = "void at::native::index_elementwise_kernel<128, 4>()"
FILL = "void at::native::vectorized_elementwise_kernel<4, FillFunctor>()"
GEMM = "sm80_xmma_gemm_f32f32_f32f32_f32_tn_n"


def _step(t):
    """One made-up train step from ``t``: its host events (spans and
    launches) and the device operations they launch, 1 ms each, 0.5 ms
    after their launch. Forward K1 in ``psp.spmm.forward``, a GEMM outside
    any span; the backward (another thread's, the same clock) a relay, a
    fill, K2′ and a read-back inside ``psp.spmm.sum_grads``, a copy of the
    loss outside."""
    host, dev = [], []

    def launch(at, call, name, dur=1e-3):
        host.append(Op(call, at, 1e-5))
        dev.append(Op(name, at + 5e-4, dur))

    host.append(Op("bench.step", t, 0.02))
    host.append(Op("psp.spmm.forward", t + 1e-4, 1e-3))
    launch(t + 2e-4, "cudaLaunchKernel", K1)
    launch(t + 2e-3, "cuLaunchKernelEx", GEMM)
    host.append(Op("psp.spmm.backward", t + 4e-3, 0.01))
    host.append(Op("psp.spmm.sum_grads", t + 4.1e-3, 9e-3))
    host.append(Op("psp.spmm.relay", t + 4.2e-3, 1e-4))
    launch(t + 4.25e-3, "cudaLaunchKernel", GATHER)
    launch(t + 6e-3, "cudaLaunchKernel", FILL)
    launch(t + 8e-3, "cudaLaunchKernel", K2P, 2e-3)
    host.append(Op("psp.spmm.readback", t + 11e-3, 1e-4))
    launch(t + 11.05e-3, "cudaLaunchKernel", GATHER)
    launch(t + 16e-3, "cudaMemcpyAsync", "Memcpy DtoD (Device -> Device)")
    host.append(Op("cudaDeviceSynchronize", t + 17e-3, 2e-3))
    return host, dev


def _trace(steps=2, spans=True):
    host, dev = [Op(devtrace.WINDOW, 0.0, 1.0)], []
    for i in range(steps):
        h, d = _step(0.1 + 0.05 * i)
        host += h
        dev += d
    if not spans:
        host = [o for o in host if not o.name.startswith("psp.")]
    return Trace((0.0, 1.0), sorted(dev, key=lambda o: o.start), host)


def _ctx(trace, steps=2, train=True):
    return SimpleNamespace(
        train=train, steps=steps, trace=trace, window_s=1.0,
        busy_s=devtrace.busy_seconds(trace),
        port=devtrace.matcher(["spmm_spans_kernel", "spmm_sddmm_kernel",
                               "spmm_sddmm_kernel_tight"]),
        config={"num_layers": 3, "in_channels": 3, "hidden_channels": 5,
                "out_channels": 2},
        traffic={"value_grad": True}, n=7, nnz=11,
        model=SimpleNamespace(sparse_ops=lambda c, t, v: [("spmm", 3)],
                              dense_flops=lambda c, n, t, v: 1000),
        peak={"hbm_bytes_per_s": 1e3, "flops_per_s": 1e4}, itemsize=4,
        spans={"structure_s": 0.25},
        launches={"spmm_csr": steps, "spmm_sddmm_csc": steps,
                  "sddmm_csr": 0})


def _reader(name):
    return spec.load_module(BENCH / "metrics" / f"{name}.py",
                            f"test_attr_metric_{name}")


def test_each_operation_gets_the_spans_around_its_launch():
    tr = _trace(steps=1)
    paths = attribution.op_paths(tr)
    names = [devtrace.short_name(o.name, 24) for o in tr.device]
    got = dict(zip(names, paths))
    assert got[devtrace.short_name(K1, 24)] == ("psp.spmm.forward",)
    assert got[devtrace.short_name(GEMM, 24)] == ()
    assert got[devtrace.short_name(K2P, 24)] == (
        "psp.spmm.backward", "psp.spmm.sum_grads")
    assert got[devtrace.short_name(FILL, 24)] == (
        "psp.spmm.backward", "psp.spmm.sum_grads")
    # the innermost span ends the path: the relay's gather, then the
    # read-back's
    gathers = [p for o, p in zip(tr.device, paths) if o.name == GATHER]
    assert gathers == [
        ("psp.spmm.backward", "psp.spmm.sum_grads", "psp.spmm.relay"),
        ("psp.spmm.backward", "psp.spmm.sum_grads", "psp.spmm.readback")]
    # the copy launched outside any span, and not a kernel
    assert tr.device[-1].name.startswith("Memcpy") and paths[-1] == ()


def test_join_needs_launches_and_operations_to_pair():
    tr = _trace()
    # one operation more than launches: nothing pairs
    extra = Trace(tr.window, tr.device + [Op(GATHER, 0.9, 1e-3)], tr.host)
    assert attribution.op_paths(extra) is None
    # as many, but a fill where the launch enqueued a kernel
    dev = list(tr.device)
    dev[0] = Op("Memset (Device)", dev[0].start, dev[0].dur)
    assert attribution.op_paths(Trace(tr.window, dev, tr.host)) is None
    # calls that enqueue nothing are not launches
    host = tr.host + [Op("cudaStreamIsCapturing", 0.5, 1e-6),
                      Op("cudaFuncGetAttributes", 0.5, 1e-6)]
    assert attribution.op_paths(Trace(tr.window, tr.device, host)) == \
        attribution.op_paths(tr)
    # a launch outside the window is not the window's
    host = tr.host + [Op("cudaLaunchKernel", 1.5, 1e-5)]
    assert attribution.op_paths(Trace(tr.window, tr.device, host)) == \
        attribution.op_paths(tr)


@pytest.mark.parametrize("name,kind", [
    ("cudaLaunchKernel", "kernel"), ("cudaLaunchKernelExC", "kernel"),
    ("cuLaunchKernel", "kernel"), ("cuLaunchKernelEx", "kernel"),
    ("cudaMemcpyAsync", "copy"), ("cudaMemsetAsync", "fill"),
    ("cudaDeviceSynchronize", None), ("cudaStreamIsCapturing", None),
    ("aten::index_select", None), ("psp.spmm.relay", None)])
def test_launch_kinds(name, kind):
    assert attribution.launch_kind(name) == kind


def test_spmm_aten_ms_reads_the_layers_aten_work():
    ctx = _ctx(_trace())
    # a step: relay gather 1, fill 1, read-back gather 1 ms; K2′ and K1 are
    # the port's, the GEMM and the copy lie outside the layer
    assert _reader("spmm_aten_ms.train").read(ctx) == pytest.approx(3.0)
    assert _reader("spmm_aten_ms.train").read(ctx) <= \
        _reader("aten_ms.train").read(ctx)


def test_csc_relays_counts_relay_spans_per_step():
    ctx = _ctx(_trace(steps=3), steps=3)
    assert _reader("csc_relays.train").read(ctx) == 1.0
    # a cache hit opens no relay span
    tr = _trace(steps=3)
    host = [o for o in tr.host
            if not (o.name == "psp.spmm.relay" and o.start > 0.15)]
    ctx = _ctx(Trace(tr.window, tr.device, host), steps=3)
    assert _reader("csc_relays.train").read(ctx) == pytest.approx(1 / 3)


@pytest.mark.parametrize("name", NEW)
def test_new_readers_read_nothing_without_the_programs_spans(name):
    # the parent program: no psp. span in the trace
    assert _reader(name).read(_ctx(_trace(spans=False))) is None
    # an inference cell, or no step
    assert _reader(name).read(_ctx(_trace(), train=False)) is None
    assert _reader(name).read(_ctx(_trace(), steps=0)) is None


def test_spmm_aten_ms_reads_nothing_where_nothing_pairs():
    tr = _trace()
    extra = Trace(tr.window, tr.device + [Op(GATHER, 0.9, 1e-3)], tr.host)
    assert _reader("spmm_aten_ms.train").read(_ctx(extra)) is None
    # a CPU run: spans, but no device operation
    assert _reader("spmm_aten_ms.train").read(
        _ctx(Trace(tr.window, [], tr.host))) is None


def _existing_readers():
    names = sorted(p.name[:-3] for p in (BENCH / "metrics").glob("*.py"))
    return [n for n in names if n not in NEW]


@pytest.mark.parametrize("name", _existing_readers())
def test_existing_readers_ignore_the_programs_spans(name):
    with_spans = _reader(name).read(_ctx(_trace()))
    assert with_spans == _reader(name).read(_ctx(_trace(spans=False)))
    assert devtrace.top_ops(_trace()) == devtrace.top_ops(
        _trace(spans=False))


def test_a_cpu_run_reports_the_relays():
    from bench_port import run
    res = run.run_cell("gcn-products.train-edgegrad", 7, 0.2, True,
                       device="cpu", sizes={"num_nodes": 600, "degree": 6},
                       t0=time.perf_counter())
    assert res["correct"]
    # one relay a step, the second both-grads pass served by the cache; no
    # device operation on the CPU, so no device time to attribute
    assert res["metrics"]["csc_relays.train"]["value"] == 1.0
    assert "spmm_aten_ms.train" not in res["metrics"]

"""PyG's ogbn-products GAT on the port: ``GAT(..., out_heads=heads,
bias=True, skip=True)`` against the float64 plain reference
``tests/gat_reference.py`` (messages summed per row, no code of the port),
and the benchmark's pieces for it (``bench_port/models/gat.py``,
``bench_port/reference/gat.py``, the readers ``attention_ms.eval`` and
``heads_aten_ms.eval``, the cells ``gat-products.eval`` and
``gcn-products.train`` run on the CPU at a small size).

Tolerances, each over the reference's largest magnitude (of the logits, or
of each parameter's gradient):

* the port in float64: ``1e-10``. Both sides compute in float64 and differ
  only in the order of their sums (per-head SpMMs against summed messages,
  two-level row reductions against ``index_add``), ~1e-15 relative;
* the port in float32: ``1e-5`` for the logits and ``1e-4`` for the
  gradients, as ``tests/test_torch_models.py`` holds the port's float32
  models (forward, and SGD trajectories where rounding compounds; a
  backward through softmax and three layers compounds the same way);
* the benchmark's blocked reference against the test's: ``1e-10``, both
  float64, summed in other orders.
"""
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

import gat_reference
import paddle_sparse_tpu_torch as psp
from bench_port import (attribution, devtrace, faults, graphs, run, spec,
                        steps)
from bench_port.devtrace import Op, Trace
from bench_port.models import gat as gat_model
from bench_port.reference import gat as gat_blocked
from bench_port.reference import sparse as ref_sparse
from paddle_sparse_tpu_torch import GAT, PaddedCOO, init_gat
from stacked_heads import stacked_spmm

ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / "bench_port"
PUBLISHED = json.loads((BENCH / "configs" / "gat-products.json").read_text())
N, NNZ, CAP, IN, HID, OUT, HEADS = 60, 420, 500, 7, 5, 4, 3
SMALL = {"num_nodes": 600, "degree": 6}
SPANS = ("psp.model.gat.scores", "psp.model.edge_softmax",
         "psp.model.gat.heads")


def _graph(seed=0):
    """A row-sorted graph with duplicate entries and empty rows, padded
    past its entries; and its raw arrays."""
    g = torch.Generator().manual_seed(seed)
    row = torch.randint(0, N - 5, (NNZ,), generator=g).sort().values
    col = torch.randint(0, N, (NNZ,), generator=g)
    val = torch.rand(NNZ, generator=g)
    adj = PaddedCOO.from_arrays(row, col, val, (N, N), capacity=CAP)
    return adj, row, col


def _pyg_gat(num_layers, dtype, seed=1):
    """The port's GAT with PyG's options, every parameter (biases too)
    drawn, in ``dtype``; and its parameters by name, float64."""
    g = torch.Generator().manual_seed(seed)
    model = GAT(IN, HID, OUT, heads=HEADS, num_layers=num_layers,
                out_heads=HEADS, bias=True, skip=True)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.5)
    model = model.to(dtype)
    params = {k: v.detach().double() for k, v in model.state_dict().items()}
    return model, params


def _features(dtype, seed=2):
    return torch.randn(N, IN, generator=torch.Generator().manual_seed(
        seed)).to(dtype)


def _rel(got, ref):
    return float((got.detach().double() - ref).abs().max()
                 / ref.abs().max())


LOGIT_TOL = {torch.float64: 1e-10, torch.float32: 1e-5}
GRAD_TOL = {torch.float64: 1e-10, torch.float32: 1e-4}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("num_layers", [2, 3])
def test_logits_match_the_plain_reference(num_layers, dtype):
    adj, row, col = _graph()
    model, params = _pyg_gat(num_layers, dtype)
    x = _features(dtype)
    ref = gat_reference.gat_forward(row, col, N, x.double(), params)
    assert ref.shape == (N, OUT)
    assert _rel(model(adj, x), ref) <= LOGIT_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("num_layers", [2, 3])
def test_every_parameter_gradient_matches_the_reference(num_layers, dtype):
    adj, row, col = _graph(seed=4)
    model, params = _pyg_gat(num_layers, dtype, seed=5)
    x = _features(dtype, seed=6)
    w = torch.randn(N, OUT, generator=torch.Generator().manual_seed(7))
    (model(adj, x) * w.to(dtype)).sum().backward()
    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    (gat_reference.gat_forward(row, col, N, x.double(), leaves)
     * w.double()).sum().backward()
    got = dict(model.named_parameters())
    assert set(got) == set(leaves)
    assert len(got) == 6 * num_layers
    for k, p in got.items():
        assert _rel(p.grad, leaves[k].grad) <= GRAD_TOL[dtype], k


@pytest.mark.parametrize("out_heads", [1, 4])
def test_the_heads_equal_the_stacked_heads(monkeypatch, out_heads):
    """A hidden layer of 4 heads and an output layer of ``out_heads``,
    with bias and skips, in f32: the logits bit for bit, and every
    parameter's grad within f32 rounding, as the former per-head
    ``with_value`` SpMMs and their stack give them."""
    adj, _, _ = _graph(seed=8)
    g = torch.Generator().manual_seed(9)
    model = GAT(IN, HID, OUT, heads=4, num_layers=2, out_heads=out_heads,
                bias=True, skip=True)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.5)
    x = _features(torch.float32, seed=10)
    w = torch.randn(N, OUT, generator=g)
    runs = []
    for patch in (False, True):
        if patch:
            monkeypatch.setattr(PaddedCOO, "spmm",
                                stacked_spmm(PaddedCOO.spmm))
        model.zero_grad(set_to_none=True)
        logits = model(adj, x)
        (logits * w).sum().backward()
        runs.append((logits.detach(),
                     {k: p.grad for k, p in model.named_parameters()}))
    (got, got_g), (want, want_g) = runs
    assert torch.equal(got, want)
    assert got_g.keys() == want_g.keys()
    for k in got_g:
        torch.testing.assert_close(got_g[k], want_g[k], msg=k)


def _count(model):
    return sum(p.numel() for p in model.parameters())


def test_the_published_model_holds_751574_parameters():
    """OGB's "GAT w/NS" on ogbn-products, 751,574 parameters: the port's
    model with PyG's options at the published widths, layer by layer, and
    the benchmark's parameter shapes. No graph is made."""
    c = PUBLISHED
    model = GAT(c["in_channels"], c["hidden_channels"], c["out_channels"],
                heads=c["heads"], num_layers=c["num_layers"],
                out_heads=c["heads"], bias=True, skip=True, device="meta")
    assert _count(model) == 751574 == c["parameters"]
    per_layer = [sum(p.numel() for k, p in model.named_parameters()
                     if k.endswith(f".{i}")) for i in range(3)]
    assert per_layer == [104448, 526336, 120790]
    assert sum(math.prod(s) for _, s in gat_model.param_shapes(c)) == 751574


def test_the_benchmark_builds_the_program_from_its_parameters():
    """``models/gat.py::build`` loads the drawn parameters into the port's
    GAT: the attention vectors transposed from ``(C, H)`` to ``(H, C)``,
    the rest as drawn, every parameter of the model given."""
    cfg = {**PUBLISHED, "in_channels": IN, "hidden_channels": HID,
           "out_channels": OUT, "heads": HEADS}
    gen = graphs.generator(3, "cpu")
    params = graphs.weights(gen, gat_model.param_shapes(cfg))
    model = gat_model.build(psp, cfg, params, "cpu")
    state = model.state_dict()
    assert set(state) == set(gat_model.program_state(params))
    for i in range(cfg["num_layers"]):
        assert torch.equal(state[f"a_src.{i}"], params[f"att_src.{i}"].t())
        assert torch.equal(state[f"a_dst.{i}"], params[f"att_dst.{i}"].t())
        assert torch.equal(state[f"skip_weight.{i}"],
                           params[f"skip_weight.{i}"])
    # the attention vectors' std is sqrt(2 / C), C the head's channels
    big = graphs.weights(graphs.generator(4, "cpu"),
                         gat_model.param_shapes(PUBLISHED))
    assert float(big["att_src.0"].std()) == pytest.approx(0.125, rel=0.1)


def test_the_defaults_keep_the_jax_layer():
    """Without the new options: one output head, no bias, no skip, the
    JAX package's parameters only, drawn in the same order."""
    m = init_gat(torch.Generator().manual_seed(0), IN, HID, OUT,
                 heads=HEADS, num_layers=3)
    assert sorted(m.state_dict()) == sorted(
        f"{n}.{i}" for n in ("weight", "a_src", "a_dst") for i in range(3))
    assert m.bias is None and m.skip_weight is None
    assert tuple(m.a_src[2].shape) == (1, OUT)
    g = torch.Generator().manual_seed(0)
    for w, a, b in zip(m.weight, m.a_src, m.a_dst):
        for p in (w, a, b):
            want = torch.randn(tuple(p.shape), generator=g) * (
                2.0 / w.shape[0]) ** 0.5
            assert torch.equal(p.detach(), want)


def test_init_gat_draws_the_skips_after_the_jax_draws():
    """With PyG's options: the JAX draws as without them, then each skip
    weight He-normal from its input width; every bias zero."""
    kw = dict(heads=HEADS, num_layers=3)
    plain = init_gat(torch.Generator().manual_seed(0), IN, HID, OUT, **kw)
    g = torch.Generator().manual_seed(0)
    m = init_gat(g, IN, HID, OUT, out_heads=HEADS, bias=True, skip=True,
                 **kw)
    for name in ("weight", "a_src", "a_dst"):
        for a, b in zip(getattr(m, name)[:2], getattr(plain, name)[:2]):
            assert torch.equal(a, b)
    replay = torch.Generator().manual_seed(0)
    for p in [p for t in zip(m.weight, m.a_src, m.a_dst) for p in t]:
        torch.randn(tuple(p.shape), generator=replay)
    for s in m.skip_weight:
        want = torch.randn(tuple(s.shape), generator=replay) * (
            2.0 / s.shape[0]) ** 0.5
        assert torch.equal(s.detach(), want)
    assert all(not b.any() for b in [*m.bias, *m.skip_bias])


def _profiled_forward(model, adj, x):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        model(adj, x)
    return [e for e in prof.events() if e.name.startswith("psp.")]


def _ancestors(e):
    out, p = [], e.cpu_parent
    while p is not None:
        out.append(p.name)
        p = p.cpu_parent
    return out


@pytest.mark.parametrize("pyg", [True, False])
def test_each_layer_opens_the_three_spans(pyg):
    """A forward opens ``psp.model.gat.scores``, ``psp.model.edge_softmax``
    and ``psp.model.gat.heads`` once a layer, and every head's SpMM inside
    the heads' span."""
    adj, _, _ = _graph()
    model = _pyg_gat(3, torch.float32)[0] if pyg else init_gat(
        torch.Generator().manual_seed(0), IN, HID, OUT, heads=HEADS,
        num_layers=3)
    ev = _profiled_forward(model, adj, _features(torch.float32))
    names = [e.name for e in ev]
    for s in SPANS:
        assert names.count(s) == 3, s
    spmms = [e for e in ev if e.name == "psp.spmm.forward"]
    assert len(spmms) == 3 * HEADS - (0 if pyg else HEADS - 1)
    assert all("psp.model.gat.heads" in _ancestors(e) for e in spmms)


def test_the_cells_sparse_products_and_work():
    """Eval: each layer's heads at its head width, so K1 12 times a forward
    at the published sizes (K=128 x8, K=47 x4) and no other counted
    kernel; training is not counted."""
    ops = gat_model.sparse_ops(PUBLISHED, False, False)
    assert ops == [("spmm", 128)] * 8 + [("spmm", 47)] * 4
    cell = spec.load_cell(ROOT, "gat-products.eval")
    from bench_port.drivers import fullbatch
    assert fullbatch.expected_launches(cell, gat_model) == {
        "spmm_csr": 12, "sddmm_csr": 0, "spmm_sddmm_csc": 0,
        "fold_pieces": 0}
    n = 10
    want = sum(2 * n * a * b + 2 * n * a * c + 4 * n * b
               for a, b, c in ((100, 512, 512), (512, 512, 512),
                               (512, 188, 47)))
    assert gat_model.dense_flops(PUBLISHED, n, False, False) == want
    for fn in (gat_model.sparse_ops, lambda c, t, v: gat_model.dense_flops(
            c, n, t, v)):
        with pytest.raises(NotImplementedError):
            fn(PUBLISHED, True, False)


@pytest.mark.parametrize("block_bytes", [64, 1 << 31])
@pytest.mark.parametrize("kind", ["uniform", "zipf"])
@pytest.mark.parametrize("num_layers", [2, 3])
def test_the_blocked_reference_is_the_test_reference(num_layers, kind,
                                                     block_bytes):
    """``bench_port/reference/gat.py`` over blocks of entries far smaller
    than the graph (64 bytes: 2 entries of 4 float64 heads) and over one
    block equals the summed messages of ``tests/gat_reference.py``."""
    cfg = {"num_layers": num_layers, "in_channels": IN,
           "hidden_channels": HID, "out_channels": OUT, "heads": HEADS}
    gen = graphs.generator(11, "cpu")
    g = graphs.graph(gen, kind, 50, 4)
    x = graphs.features(gen, g.num_nodes, IN).double()
    params = {k: v.double() for k, v in graphs.weights(
        gen, gat_model.param_shapes(cfg)).items()}
    for k in params:             # non-zero biases, so their path counts
        if params[k].dim() == 1:
            params[k] = torch.randn(params[k].shape, generator=gen,
                                    dtype=torch.float64)
    adj = ref_sparse.adjacency(g.row, g.col, g.value, g.num_nodes,
                               torch.float64, normalize=False,
                               block_bytes=block_bytes)
    got = gat_blocked.forward(adj, x, params, torch.matmul)
    ref = gat_reference.gat_forward(g.row, g.col, g.num_nodes, x,
                                    gat_model.program_state(params))
    assert _rel(got, ref) <= 1e-10


def test_the_references_load_nothing_of_the_program():
    code = ("import sys; sys.path[:0] = ['.', 'tests'];"
            "import bench_port.reference.gat, bench_port.models.gat,"
            " gat_reference;"
            "print(sorted({m.split('.')[0] for m in sys.modules}"
            " & {'paddle_sparse_tpu_torch', 'paddle_sparse_tpu', 'jax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"


def _run(workload, seed, trace=False):
    return run.run_cell(workload, seed, 0.2, trace, device="cpu",
                        sizes=SMALL, t0=time.perf_counter())


@pytest.mark.parametrize("workload,fault", [
    ("gat-products.eval", None), ("gat-products.eval", "altered"),
    ("gcn-products.train", None), ("gcn-products.train", "unchanged"),
    ("gcn-products.train", "half_batch")])
def test_a_cpu_run_of_the_new_cells(workload, fault):
    """The new cells at 600 nodes of degree 6, the program's plain path
    underneath: correct, and not correct with each fault the cell can
    have planted."""
    if fault is None:
        res = _run(workload, 2**31 + 25)
        assert res["correct"] and res["failed"] == 0, res["checks"]
        assert res["attempted"] > 0
        return
    with faults.planted(fault, psp):
        res = _run(workload, 2**31 + 25)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("workload", ["gat-products.eval",
                                      "gcn-products.train"])
def test_the_control_fails_a_limit_of_the_new_cells(workload):
    """The reference in float32 with TF32 GEMMs (the precision below the
    configuration's) in the program's place is not correct."""
    from bench_port import compare
    cell = spec.load_cell(ROOT, workload)
    cell = cell._replace(config={**cell.config, **SMALL})
    model, refmod = spec.model_module(cell), spec.reference_module(cell)
    drv = spec.driver_module(cell)
    ref = drv.reference_readings(cell, model, refmod, 25, "cpu")
    ctl = drv.control_readings(cell, drv.reference_readings(
        cell, model, refmod, 25, "cpu", control=True))
    held = compare.held(drv.numbers(cell, ctl, ref), cell.limits)
    assert not all(ok for *_, ok in held), held


def test_a_traced_cpu_run_holds_the_spans_the_readers_read():
    """A traced CPU run of ``gat-products.eval``: correct; its window holds
    each of the three spans once a layer of every forward; the two readers
    are the cell's and read nothing there, since a CPU run has no device
    operation to attribute."""
    cell = spec.load_cell(ROOT, "gat-products.eval")
    names = [m["name"] for m in cell.per_layer]
    assert {"attention_ms.eval", "heads_aten_ms.eval"} <= set(names)
    cell = cell._replace(config={**cell.config, **SMALL})
    from bench_port.drivers import fullbatch
    res = fullbatch.run(cell, psp, spec.model_module(cell),
                        spec.reference_module(cell), 5, 0.2, True, "cpu",
                        time.perf_counter(), lambda msg: None)
    assert res["numbers"]["logits"] <= cell.limits["logits"]["limit"]
    spans = attribution.program_spans(res["trace"])
    for s in SPANS:
        assert sum(o.name == s for o in spans) == 3 * res["attempted"], s
    assert res["trace"].device == []
    full = _run("gat-products.eval", 5, trace=True)
    assert full["correct"]
    assert not {"attention_ms.eval", "heads_aten_ms.eval"} & set(
        full["metrics"])


# ---- the readers on a made-up trace ----------------------------------------

K1 = "void (anonymous namespace)::spmm_spans_kernel<float, float, 4, 2>()"
GEMM = "sm80_xmma_gemm_f32f32_f32f32_f32_nn_n"
GATHER = "void at::native::index_elementwise_kernel<128, 4>()"
COPY = "void at::native::elementwise_kernel<128, 2>(copy)"
ADD = "void at::native::vectorized_elementwise_kernel<4, add>()"


def _forward(t):
    """One made-up forward from ``t``: a GEMM outside any span; in
    ``scores`` two kernels of 1 ms; in ``edge_softmax`` a gather of 2 ms
    and a fill of 1 ms; in ``heads`` a copy of 3 ms, K1 of 5 ms inside
    ``psp.spmm.forward``, a copy of 1 ms; an add outside; all inside
    ``bench.step``, closed by ``bench.sync``. Each operation starts 0.1 ms
    after its launch."""
    host, dev = [], []

    def launch(at, call, name, dur):
        host.append(Op(call, at, 1e-5))
        dev.append(Op(name, at + 1e-4, dur))

    host.append(Op("bench.step", t, 27.5e-3))
    launch(t + 1e-4, "cuLaunchKernelEx", GEMM, 4e-3)
    host.append(Op("psp.model.gat.scores", t + 5e-3, 3e-3))
    launch(t + 5.1e-3, "cudaLaunchKernel", ADD, 1e-3)
    launch(t + 6.2e-3, "cudaLaunchKernel", GATHER, 1e-3)
    host.append(Op("psp.model.edge_softmax", t + 9e-3, 4e-3))
    launch(t + 9.1e-3, "cudaLaunchKernel", GATHER, 2e-3)
    launch(t + 11.2e-3, "cudaMemsetAsync", "Memset (Device)", 1e-3)
    host.append(Op("psp.model.gat.heads", t + 14e-3, 12e-3))
    launch(t + 14.1e-3, "cudaLaunchKernel", COPY, 3e-3)
    host.append(Op("psp.spmm.forward", t + 17.5e-3, 6e-3))
    launch(t + 17.6e-3, "cudaLaunchKernel", K1, 5e-3)
    launch(t + 23.7e-3, "cudaLaunchKernel", COPY, 1e-3)
    launch(t + 27e-3, "cudaLaunchKernel", ADD, 1e-3)
    host.append(Op("bench.sync", t + 28e-3, 2.1e-3))
    host.append(Op("cudaDeviceSynchronize", t + 28e-3, 2e-3))
    return host, dev



def _trace(steps=2, spans=True):
    host, dev = [Op(devtrace.WINDOW, 0.0, 1.0)], []
    for i in range(steps):
        h, d = _forward(0.1 + 0.05 * i)
        host += h
        dev += d
    if not spans:
        host = [o for o in host if not o.name.startswith("psp.")]
    return Trace((0.0, 1.0), sorted(dev, key=lambda o: o.start), host)


def _ctx(trace, steps=2, train=False):
    return SimpleNamespace(train=train, steps=steps, trace=trace,
                           port=devtrace.matcher(["spmm_spans_kernel"]))


def _reader(name):
    return spec.load_module(BENCH / "metrics" / f"{name}.py",
                            f"test_gat_metric_{name}")


def test_the_readers_read_their_spans():
    ctx = _ctx(_trace())
    # scores 1 + 1, edge softmax 2 + 1 ms a forward
    assert _reader("attention_ms.eval").read(ctx) == pytest.approx(5.0)
    # the heads' copies 3 + 1 ms; K1 is the port's, so left out
    assert _reader("heads_aten_ms.eval").read(ctx) == pytest.approx(4.0)


def test_a_step_that_does_not_pair_is_left_out():
    """The window's last operation lost, as a trace whose device clock runs
    late clips it: the whole-window join pairs nothing, the step join the
    first two forwards of three, and the readers read them as before. An
    operation without a launch in the second forward: the forwards from it
    on are left out, the first still read."""
    tr = _trace(steps=3)
    cut = Trace(tr.window, tr.device[:-1], tr.host)
    assert attribution.op_paths(cut) is None
    paired = steps.step_paths(cut)
    assert [len(ops) for ops, _ in paired] == [9, 9]
    assert paired[1][0] == tr.device[9:18]
    extra = Trace(tr.window, sorted(
        tr.device + [Op(GATHER, 0.16, 1e-3)], key=lambda o: o.start),
        tr.host)
    assert [ops for ops, _ in steps.step_paths(extra)] == [tr.device[:9]]
    for t in (cut, extra):
        ctx = _ctx(t, steps=3)
        assert _reader("attention_ms.eval").read(ctx) == pytest.approx(5.0)
        assert _reader("heads_aten_ms.eval").read(ctx) == pytest.approx(4.0)


@pytest.mark.parametrize("name", ["attention_ms.eval", "heads_aten_ms.eval"])
def test_the_readers_read_nothing_without_their_spans(name):
    tr = _trace()
    assert _reader(name).read(_ctx(_trace(spans=False))) is None
    assert _reader(name).read(_ctx(tr, train=True)) is None
    assert _reader(name).read(_ctx(tr, steps=0)) is None
    # no forward whose launches and operations pair
    extra = Trace(tr.window, sorted(
        tr.device + [Op(GATHER, 0.11, 1e-3), Op(GATHER, 0.16, 1e-3)],
        key=lambda o: o.start), tr.host)
    assert _reader(name).read(_ctx(extra)) is None
    # a CPU run: spans, but no device operation
    assert _reader(name).read(_ctx(Trace(tr.window, [], tr.host))) is None

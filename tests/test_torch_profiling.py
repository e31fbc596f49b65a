"""The port's ``profiling`` module and the spans of the SpMM autograd layer.

``scope`` names a ``record_function`` span while a profiler records and
does nothing else otherwise (no ``record_function``, no NVTX); ``time_fn``
calls the function ``warmup + iters`` times and returns seconds per call.

The layer's spans (``psp.spmm.*``, ``ops/spmm.py`` and
``ops/kernels/spmm_sddmm_cuda.py``) counted in a CPU profile, where the
same Functions run the kernels' plain versions: per GCN step with edge-value
grads, per GraphSAGE step without, per forward under ``no_grad``, and
through a double backward; each ``relay`` span is a gather done, so a
``csc_values`` cache hit opens none. The model step's span
``psp.model.transform_first`` (``models/gcn.py``) opens once per layer whose
weight narrows (F -> H -> H -> C here: the last) and never where no width
shrinks."""
import collections
import importlib

import pytest
import torch

import paddle_sparse_tpu_torch as psp
from paddle_sparse_tpu_torch import profiling
from paddle_sparse_tpu_torch.ops import spmm as spmm_mod
from paddle_sparse_tpu_torch.ops.kernels import spmm_sddmm_cuda

entry = importlib.import_module("paddle_sparse_tpu_torch.entry")

N, NNZ, F, H, C = 40, 200, 6, 8, 3
TRANSFORM_FIRST = "psp.model.transform_first"


def _profile(fn):
    """``fn()`` under a CPU profiler: its result and the ``psp.`` events."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, [e for e in prof.events() if e.name.startswith("psp.")]


def _counts(events):
    return collections.Counter(e.name for e in events)


def _ancestors(e):
    out, p = [], e.cpu_parent
    while p is not None:
        out.append(p.name)
        p = p.cpu_parent
    return out


def _graph(normalize, value_grad, seed=0):
    g = torch.Generator().manual_seed(seed)
    row = torch.randint(0, N, (NNZ,), generator=g).sort().values
    col = torch.randint(0, N, (NNZ,), generator=g)
    adj = psp.PaddedCOO.from_arrays(row, col, torch.rand(NNZ, generator=g),
                                    (N, N))
    adj = psp.gcn_normalize(adj) if normalize else adj
    if value_grad:
        adj.value.requires_grad_()
    x = torch.randn(N, F, generator=g)
    y = torch.randint(0, C, (N,), generator=g)
    return adj, x, y


def _steps(model, adj, x, y, steps):
    for _ in range(steps):
        if adj.value.requires_grad:
            adj.value.grad = None
        entry.train_step(model, adj, x, y, 0.1)


def test_scope_is_recorded_in_a_trace():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.scope("psp_spmm_block"):
            torch.ones(8, 8) @ torch.ones(8, 8)
    assert "psp_spmm_block" in {e.key for e in prof.key_averages()}
    mm = [e for e in prof.events() if e.name == "aten::mm"]
    assert mm and "psp_spmm_block" in _ancestors(mm[0])


def _refuse(*args, **kwargs):
    raise AssertionError("called with no profiler recording")


def _no_span_calls(monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _refuse)
    monkeypatch.setattr(torch.cuda.nvtx, "range_push", _refuse)
    monkeypatch.setattr(torch.cuda.nvtx, "range_pop", _refuse)


def test_scope_without_a_profiler_runs_the_block(monkeypatch):
    _no_span_calls(monkeypatch)
    ran = []
    with profiling.scope("outside"):
        ran.append(1)
    assert ran == [1]


def test_a_step_without_a_profiler_opens_no_span(monkeypatch):
    """A GCN step with edge-value grads passes every span of the layer."""
    _no_span_calls(monkeypatch)
    adj, x, y = _graph(True, True)
    torch.manual_seed(0)
    model = psp.GCN(F, H, C, 3, device="cpu")
    _steps(model, adj, x, y, 1)
    assert adj.value.grad is not None


def test_time_fn_counts_calls():
    calls = []
    s = profiling.time_fn(lambda a: calls.append(a), 3, iters=5, warmup=2)
    assert calls == [3] * 7 and s >= 0.0


@pytest.mark.parametrize("steps", [1, 2])
def test_gcn_step_with_value_grads(steps):
    adj, x, y = _graph(True, True)
    torch.manual_seed(0)
    model = psp.GCN(F, H, C, 3, device="cpu")
    _, ev = _profile(lambda: _steps(model, adj, x, y, steps))
    # per step: 3 forwards, the last layer's transform first; backward:
    # both grads twice (K2′, one relay, the second served by csc_values,
    # each d value read back), d value alone at the first layer (K2)
    assert _counts(ev) == {k: v * steps for k, v in {
        "psp.spmm.forward": 3, "psp.spmm.backward": 3,
        "psp.spmm.sum_grads": 2, "psp.spmm.sddmm": 1,
        "psp.spmm.relay": 1, "psp.spmm.readback": 2,
        TRANSFORM_FIRST: 1}.items()}
    for e in ev:
        if e.name in ("psp.spmm.relay", "psp.spmm.readback"):
            up = [a for a in _ancestors(e) if a.startswith("psp.")]
            assert up == ["psp.spmm.sum_grads", "psp.spmm.backward"]
        if e.name == "psp.spmm.sddmm":
            assert "psp.spmm.backward" in _ancestors(e)


def test_sage_step_without_value_grads():
    adj, x, y = _graph(False, False)
    torch.manual_seed(0)
    model = psp.GraphSAGE(F, H, C, 3, device="cpu")
    _, ev = _profile(lambda: _steps(model, adj, x, y, 1))
    # 3 forwards, the last layer's transform first; d x over the CSC view
    # at the two layers above the first, each a K1 forward of its own, the
    # values relayed once
    assert _counts(ev) == {"psp.spmm.forward": 5, "psp.spmm.backward": 2,
                           "psp.spmm.transpose": 2, "psp.spmm.relay": 1,
                           TRANSFORM_FIRST: 1}
    ups = []
    for e in ev:
        up = [a for a in _ancestors(e) if a.startswith("psp.")]
        if e.name == "psp.spmm.relay":
            assert up == ["psp.spmm.transpose", "psp.spmm.backward"]
        if e.name == "psp.spmm.forward" and up:
            ups.append(up)
    assert sorted(ups) == [[TRANSFORM_FIRST]] + [
        ["psp.spmm.transpose", "psp.spmm.backward"]] * 2


def test_forward_under_no_grad_opens_forward_spans_only():
    adj, x, _ = _graph(True, False)
    torch.manual_seed(0)
    model = psp.GCN(F, H, C, 3, device="cpu")
    with torch.no_grad():
        out, ev = _profile(lambda: model(adj, x))
    assert out.shape == (N, C)
    assert _counts(ev) == {"psp.spmm.forward": 3, TRANSFORM_FIRST: 1}
    inner = [e for e in ev if e.name == "psp.spmm.forward"
             and TRANSFORM_FIRST in _ancestors(e)]
    assert len(inner) == 1


@pytest.mark.parametrize("model", [psp.GCN, psp.GraphSAGE])
@pytest.mark.parametrize("dims", [(F, H, H), (F, F, F)])
def test_no_transform_first_span_where_no_width_shrinks(model, dims):
    """Widths that only grow or stay (ties aggregate first): a step opens
    every layer's SpMM spans and no ``psp.model.transform_first``."""
    adj, x, y = _graph(model is psp.GCN, False)
    torch.manual_seed(0)
    m = model(*dims, 3, device="cpu")
    _, ev = _profile(lambda: _steps(m, adj, x, y % dims[2], 1))
    counts = _counts(ev)
    assert TRANSFORM_FIRST not in counts and counts["psp.spmm.forward"] == 5


def test_fused_backward_relays_its_own_values():
    """Without the caller's values in CSC order, the fused backward relays
    them itself: one relay and one read-back a call, none without values."""
    adj, x, _ = _graph(False, False)
    s = adj.structure()
    g = torch.randn(N, F)
    for value, want in ((adj.value, {"psp.spmm.relay": 1,
                                     "psp.spmm.readback": 1}),
                        (None, {"psp.spmm.readback": 1})):
        (d_x, d_v), ev = _profile(
            lambda: spmm_sddmm_cuda.spmm_sddmm_csc_reference(
                s.colptr, s.col_t, s.perm, value, g, x,
                inv_perm=s.inv_perm))
        assert _counts(ev) == want and d_v.shape == (adj.value.numel(),)


@pytest.mark.parametrize("x_grad", [True, False])
def test_double_backward_spans(x_grad):
    """A gradient penalty differentiates the backward's Functions: their
    own backwards open ``sum_grads.backward`` (both grads) or
    ``sddmm.backward`` (``d value`` alone)."""
    adj, x, _ = _graph(False, False)
    value = adj.value.detach().clone().requires_grad_()
    x = x.clone().requires_grad_(x_grad)
    rowptr, col = adj.rowptr(), adj.col

    def penalty():
        out = spmm_mod.spmm_csr(rowptr, col, value, x)
        wrt = (value, x) if x_grad else (value,)
        grads = torch.autograd.grad((out ** 3).sum(), wrt, create_graph=True)
        sum(gr.pow(2).sum() for gr in grads).backward()

    _, ev = _profile(penalty)
    names = _counts(ev)
    if x_grad:
        assert names["psp.spmm.sum_grads.backward"] == 1
        assert "psp.spmm.sddmm.backward" not in names
    else:
        assert names["psp.spmm.sddmm.backward"] == 1
        assert "psp.spmm.sum_grads" not in names
    for e in ev:      # every relay and read-back inside one of the layer's
        if e.name in ("psp.spmm.relay", "psp.spmm.readback"):
            assert any(a.startswith("psp.spmm.") for a in _ancestors(e))
    assert value.grad is not None

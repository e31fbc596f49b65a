"""Port parity of the fused span backward of the packed SpMMs on the CPU:
``spmm_sddmm_spans_reference`` (the plain version of
``ops/kernels/spmm_sddmm_cuda.py::spmm_sddmm_spans_cuda``, which a CPU tensor
runs) over the transpose layout of ``spmm_seg2``, ``spmm_seg3`` and
``spmm_seg``, against ``jax.vjp`` of the JAX package's functions (Pallas in
interpret mode, as ``tests/test_torch_seg2.py`` runs them) and an f64 numpy
oracle; with values and with ``None``, K 1 to 520, empty rows and columns,
and the bf16 stream. Also: the plain fused version equals the plain pair it
replaces bit for bit (``spmm_spans_reference`` over the transpose with
``packed[relay]``, ``sddmm_spans_reference`` over the forward layout);
x rows cut into pieces of a small ``cap`` follow the table; and
``_PackedSpmm.backward``'s dispatch: the fused pass
(``spmm_seg2.fused_span_backward``) exactly when both grads are needed, the
spans launch or the span SDDMM alone otherwise. The plain fused version is
run as the backward runs the kernel: the values put into the transpose's
order through the relay before, ``d value`` read back through its inverse
after.

Tolerances, as ``tests/test_torch_seg2.py`` states them for sums of many
terms: against JAX within ``1e-4`` plus ``2**-16`` of each entry's sum of
|terms| (JAX's f32 path sums bf16 hi/lo halves, about 16 bits of each
product); against the f64 oracle within ``1e-5`` plus ``1e-5`` of it (f32
sums in another order); the bf16 stream against JAX within ``2e-2`` of it
(JAX rounds every product to bf16, the port multiplies in f32)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_sparse_tpu.ops import spmm_seg as Jseg
from paddle_sparse_tpu.ops import spmm_seg2 as J2
from paddle_sparse_tpu.ops import spmm_seg3 as J3
from paddle_sparse_tpu_torch import (make_seg2_plan, make_seg3_plan,
                                     make_split_plan, pack_values,
                                     pack_values_split, sddmm_spans_reference,
                                     spmm_sddmm_spans_cuda,
                                     spmm_sddmm_spans_reference, spmm_seg2,
                                     spmm_seg3, spmm_spans_reference,
                                     spmm_split, split_rows, unpack_values)
from paddle_sparse_tpu_torch.ops import spmm_seg as tseg
from paddle_sparse_tpu_torch.ops import spmm_seg2 as tseg2
from paddle_sparse_tpu_torch.ops.kernels.row_split import (
    sddmm_spans_piecewise, spmm_spans_piecewise)
from paddle_sparse_tpu_torch.ops.spmm_seg2 import SpanLayout

JAX_ABS, JAX_REL = 1e-4, 2.0 ** -16
ORACLE_ABS, ORACLE_REL = 1e-5, 1e-5
BF16_REL = 2e-2
M, N = 260, 230
EMPTY_ROWS = (0, 17, 259)
EMPTY_COLS = (0, 5, 229)
KS = [1, 3, 47, 64, 520]


def _graph(seed, nnz=1800, hub=0, k=64):
    """Row-sorted int32 COO over (M, N) with ``EMPTY_ROWS`` and
    ``EMPTY_COLS`` empty (with ``hub``, column 7 holds ``hub`` more edges),
    f32 values, ``x`` (N, k) and ``g`` (M, k) from ``seed``."""
    rng = np.random.default_rng(seed)
    rows = np.setdiff1d(np.arange(M), EMPTY_ROWS)
    cols = np.setdiff1d(np.arange(N), EMPTY_COLS)
    row = np.concatenate([rng.choice(rows, nnz), rng.choice(rows, hub)])
    col = np.concatenate([rng.choice(cols, nnz), np.full(hub, 7)])
    order = np.argsort(row, kind="stable")
    row, col = row[order].astype(np.int32), col[order].astype(np.int32)
    val = rng.standard_normal(row.size).astype(np.float32)
    x = rng.standard_normal((N, k)).astype(np.float32)
    g = rng.standard_normal((M, k)).astype(np.float32)
    return row, col, val, x, g


def _t(a):
    return torch.from_numpy(np.array(a))


def _oracle(row, col, val, x, g):
    """f64 ``(d x, d value)`` in COO order, and the same on |inputs| (each
    entry's sum of |terms|)."""
    res = []
    for v, xx, gg in ((val, x, g), (np.abs(val), np.abs(x), np.abs(g))):
        v = v.astype(np.float64)
        dx = np.zeros(xx.shape)
        np.add.at(dx, col, v[:, None] * gg[row])
        res.append((dx, (gg[row].astype(np.float64) * xx[col]).sum(1)))
    return res


def _within(got, want, scale, abs_tol, rel_tol):
    err = np.abs(np.asarray(got, np.float64) - want)
    assert (err <= abs_tol + rel_tol * scale).all(), float(
        (err - abs_tol - rel_tol * scale).max())


def _seg2(row, col, k, sr=32, stream="f32"):
    jp, js = J2.make_seg2_plan(row, col, M, N, feat_dim=k, sr=sr,
                               chunk_edges=256, stream=stream)
    tp, ts = make_seg2_plan(_t(row), _t(col), M, N, feat_dim=k, sr=sr,
                            stream=stream)
    assert tp.S_t > 1 and tp.S > 1
    return jp, js, tp, ts


def _transpose(ts):
    """The transpose layout of a seg2 / seg3 structure as the backward
    reads it: ``(SpanLayout, relay, relay inverse)``."""
    return (SpanLayout(ts.rp_t[:, :N], ts.rp_t[:, 1:N + 1], ts.col_t,
                       ts.sbase_t, ts.split_t), ts.relay_ft, ts.relay_tf)


def _fused(lay, packed, g, x, dx_dtype=None):
    """The plain fused version's ``(d value, d x)`` over a transpose
    layout ``lay`` (as :func:`_transpose` gives it), as the backward runs
    the kernel: the values relayed into the transpose's order, ``d value``
    read back through the relay's inverse."""
    t, relay, relay_inv = lay
    value_t = None if packed is None else packed.index_select(0, relay)
    d_x, d_value_t = spmm_sddmm_spans_reference(t.start, t.end, t.col,
                                                value_t, t.base, g, x,
                                                dx_dtype)
    return d_value_t.index_select(0, relay_inv), d_x


def _jax_vjp(fn, pv, x, g, xdt=jnp.float32):
    """``(d packed, d x)`` of ``fn(pv, x)`` under the cotangent ``g``."""
    xj = jnp.asarray(x, xdt)
    out, vjp = jax.vjp(fn, jnp.asarray(pv), xj)
    d_pv, d_x = vjp(jnp.asarray(g).astype(out.dtype))
    return np.asarray(d_pv), np.asarray(d_x.astype(jnp.float32))


def _check_vs_jax_and_oracle(ts, unpack, row, col, val, x, g, d_value, d_x,
                             j_dpv, j_dx):
    (w_dx, w_dv), (s_dx, s_dv) = _oracle(row, col, val, x, g)
    dv_coo = unpack(ts, d_value).numpy()
    j_dv = unpack(ts, _t(j_dpv)).numpy()
    for got, jax_, want, scale in ((d_x.numpy(), j_dx, w_dx, s_dx),
                                   (dv_coo, j_dv, w_dv, s_dv)):
        _within(got, jax_, scale, JAX_ABS, JAX_REL)
        _within(got, want, scale, ORACLE_ABS, ORACLE_REL)


@pytest.mark.parametrize("with_value", [True, False])
@pytest.mark.parametrize("k", KS)
def test_fused_plain_vs_jax_seg2(k, with_value):
    """seg2: the plain fused ``(d value, d x)`` against ``jax.vjp`` of JAX's
    ``spmm_seg2`` and the f64 oracle; ``value`` None against JAX's values
    of ones (``d value`` does not read the values)."""
    row, col, val, x, g = _graph(k, k=k)
    if not with_value:
        val = np.ones_like(val)
    jp, js, tp, ts = _seg2(row, col, k)
    packed = pack_values(ts, _t(val))
    d_value, d_x = _fused(_transpose(ts), packed if with_value else None,
                          _t(g), _t(x))
    j_dpv, j_dx = _jax_vjp(lambda p, xx: J2.spmm_seg2(jp, js, p, xx),
                           J2.pack_values(js, jnp.asarray(val)), x, g)
    _check_vs_jax_and_oracle(ts, unpack_values, row, col, val, x, g, d_value,
                             d_x, j_dpv, j_dx)


@pytest.mark.parametrize("xdt", ["f32", "bf16"])
def test_fused_plain_vs_jax_seg2_bf16_stream(xdt):
    """``stream="bf16"``: ``g`` and ``x`` gathered in bf16, as the backward
    passes them; ``d x`` in ``g``'s dtype. Within 2e-2 of each entry's sum
    of |terms| of JAX's, whose products are bf16."""
    k = 64
    row, col, val, x, g = _graph(11, k=k)
    jp, js, tp, ts = _seg2(row, col, k, stream="bf16")
    jdt, tdt = ((jnp.float32, torch.float32) if xdt == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    xb = np.array(jnp.asarray(x, jdt).astype(jnp.float32))
    gb = np.array(jnp.asarray(g, jdt).astype(jnp.float32))
    packed = pack_values(ts, _t(val))
    gt = _t(gb).to(tdt)
    d_value, d_x = _fused(_transpose(ts), packed, gt.to(torch.bfloat16),
                          _t(xb).to(torch.bfloat16), dx_dtype=tdt)
    assert d_x.dtype == tdt
    j_dpv, j_dx = _jax_vjp(lambda p, xx: J2.spmm_seg2(jp, js, p, xx),
                           J2.pack_values(js, jnp.asarray(val)), xb, gb, jdt)
    (_, _), (s_dx, s_dv) = _oracle(row, col, val, xb, gb)
    _within(d_x.float().numpy(), j_dx, s_dx, 0.0, BF16_REL)
    _within(unpack_values(ts, d_value).numpy(),
            unpack_values(ts, _t(j_dpv)).numpy(), s_dv, 0.0, BF16_REL)


@pytest.mark.parametrize("k", [3, 64])
def test_fused_plain_vs_jax_seg3(k):
    """seg3's structure (its ``rp_t`` padded to whole bands): the plain
    fused version against ``jax.vjp`` of JAX's ``spmm_seg3``."""
    row, col, val, x, g = _graph(20 + k, k=k)
    kw = dict(feat_dim=k, sr=32, band_rows=128)
    jp, js = J3.make_seg3_plan(row, col, M, N, **kw)
    tp, ts = make_seg3_plan(_t(row), _t(col), M, N, **kw)
    assert tp.S_t > 1 and ts.rp_t.shape[1] > N + 1
    packed = pack_values(ts, _t(val))
    d_value, d_x = _fused(_transpose(ts), packed, _t(g), _t(x))
    j_dpv, j_dx = _jax_vjp(lambda p, xx: J3.spmm_seg3(jp, js, p, xx),
                           J3.pack_values(js, jnp.asarray(val)), x, g)
    _check_vs_jax_and_oracle(ts, unpack_values, row, col, val, x, g, d_value,
                             d_x, j_dpv, j_dx)


def _seg(row, col, k):
    kw = dict(feat_dim=k, target_bytes=16 * 1024, seg_rows=64)
    jp, js = Jseg.make_seg_plan(jnp.asarray(row), jnp.asarray(col), M, N,
                                **kw)
    tp, ts = tseg.make_seg_plan(_t(row), _t(col), M, N, **kw)
    assert tp.num_segments > 1
    lay = tseg._layout(ts.bounds_t, ts.col_t, tp.seg_rows, ts.split_t)
    return jp, js, tp, ts, (lay, ts.perm_ft, ts.perm_tf)


@pytest.mark.parametrize("with_value", [True, False])
@pytest.mark.parametrize("k", [3, 64])
def test_fused_plain_vs_jax_seg(k, with_value):
    """``spmm_seg``'s (block, segment) windows, relay ``perm_ft``: the plain
    fused version against ``jax.vjp`` of JAX's ``spmm_seg``."""
    row, col, val, x, g = _graph(30 + k, k=k)
    if not with_value:
        val = np.ones_like(val)
    jp, js, tp, ts, lay = _seg(row, col, k)
    packed = tseg.pack_values(ts, _t(val))
    d_value, d_x = _fused(lay, packed if with_value else None, _t(g), _t(x))
    j_dpv, j_dx = _jax_vjp(lambda p, xx: Jseg.spmm_seg(jp, js, p, xx),
                           Jseg.pack_values(js, jnp.asarray(val)), x, g)
    _check_vs_jax_and_oracle(ts, tseg.unpack_values, row, col, val, x, g,
                             d_value, d_x, j_dpv, j_dx)


def _pair(ts, lay_f, lay_t, packed, g, x, dx_dtype=None):
    """What the fused pass replaces, in plain torch: the span SDDMM over the
    forward layout, then the spans SpMM over the transpose on
    ``packed[relay]``."""
    t, relay, _ = lay_t
    d_value = sddmm_spans_reference(*lay_f, g, x)
    value_t = None if packed is None else packed.index_select(0, relay)
    d_x = spmm_spans_reference(t.start, t.end, t.col, value_t, t.base, g,
                               dx_dtype)
    return d_value, d_x


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
def test_plain_equals_the_pair(dtype, k):
    """On the CPU the plain fused version gives the plain pair's outputs
    bit for bit, with values and with ``None``, in f32, bf16 and f64."""
    row, col, val, x, g = _graph(40 + k, k=k)
    tp, ts = make_seg2_plan(_t(row), _t(col), M, N, feat_dim=k, sr=32)
    lay_f = (ts.rp_f[:, :M], ts.rp_f[:, 1:M + 1], ts.col_f, ts.sbase_f)
    packed = pack_values(ts, _t(val)).to(dtype)
    gg, xx = _t(g).to(dtype), _t(x).to(dtype)
    for v in (packed, None):
        got = _fused(_transpose(ts), v, gg, xx)
        want = _pair(ts, lay_f, _transpose(ts), v, gg, xx)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b)


def test_plain_equals_the_pair_seg():
    """The same over ``spmm_seg``'s windows, whose bases are
    ``s * seg_rows`` and whose relay is ``perm_ft``."""
    k = 47
    row, col, val, x, g = _graph(50, k=k)
    _, _, tp, ts, lay = _seg(row, col, k)
    fwd = tseg._layout(ts.bounds_f, ts.col, tp.seg_rows, ts.split_f)
    lay_f = (fwd.start, fwd.end, fwd.col, fwd.base)
    packed = tseg.pack_values(ts, _t(val))
    got = _fused(lay, packed, _t(g), _t(x))
    want = _pair(ts, lay_f, lay, packed, _t(g), _t(x))
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_identity_relay_and_unreached_positions():
    """The fused pass reads values and writes ``d value`` in the
    transpose's own order (the identity relay), and ``relay_tf``
    (``perm_tf`` for ``spmm_seg``) inverts the relay, so the backward's
    form (``fused_span_backward``: values relayed before, d value read
    back after; the plain version on the CPU) equals the plain fused
    version and the plain pair bit for bit, over seg2's layout and
    ``spmm_seg``'s; an edge outside every span reads 0 in ``d value``."""
    row, col, val, x, g = _graph(60)
    tp, ts = make_seg2_plan(_t(row), _t(col), M, N, feat_dim=64, sr=32)
    _, _, seg_p, seg_s, seg_lay = _seg(row, col, 64)
    fwd_seg = tseg._layout(seg_s.bounds_f, seg_s.col, seg_p.seg_rows,
                           seg_s.split_f)
    for s, lay, lay_f, packed in (
            (ts, _transpose(ts), (ts.rp_f[:, :M], ts.rp_f[:, 1:M + 1],
                                  ts.col_f, ts.sbase_f),
             pack_values(ts, _t(val))),
            (seg_s, seg_lay, (fwd_seg.start, fwd_seg.end, fwd_seg.col,
                              fwd_seg.base),
             tseg.pack_values(seg_s, _t(val)))):
        t, relay, relay_inv = lay
        assert relay_inv.dtype == relay.dtype == torch.int32
        assert torch.equal(relay_inv[relay.long()],
                           torch.arange(row.size, dtype=torch.int32))
        got = tseg2.fused_span_backward(t, relay, relay_inv, packed, _t(x),
                                        _t(g), "f32")
        for want in (_fused(lay, packed, _t(g), _t(x)),
                     _pair(s, lay_f, lay, packed, _t(g), _t(x))):
            assert all(torch.equal(a, b) for a, b in zip(got, want))
    # drop the spans of the last segment: its edges' d value stays 0
    t, _, _ = _transpose(ts)
    cut_x, cut_v = spmm_sddmm_spans_cuda(t.start[:-1], t.end[:-1], t.col,
                                         None, t.base, _t(g), _t(x))
    tail = torch.arange(t.col.numel()) >= int(ts.rp_t[-1, 0])
    assert tail.any() and not cut_v[tail].any() and cut_v[~tail].all()
    assert cut_x.shape == (N, 64)


@pytest.mark.parametrize("cap", [3, 8, 64])
def test_pieces_follow_the_table(cap):
    """A hub x row (column 7, 600 more edges over every segment) cut into
    pieces of ``cap`` edges: d x from each piece's partial and the fold
    (``spmm_spans_piecewise`` over the transpose with ``packed[relay]``)
    and d value from each piece's own edges (``sddmm_spans_piecewise``
    with x's row as the piece's row, written back through ``relay``), as
    the kernel's pieces and ``fold_pieces`` compute them, against the f64
    oracle; the plain fused version there too."""
    row, col, val, x, g = _graph(70 + cap, hub=600)
    tp, ts = make_seg2_plan(_t(row), _t(col), M, N, feat_dim=64, sr=32)
    t, relay, relay_inv = _transpose(ts)
    table = split_rows(t.start, t.end, cap)
    assert table is not None and 7 in table.fold_row.tolist()
    packed = pack_values(ts, _t(val))
    gt, xt = _t(g), _t(x)
    dx_p = spmm_spans_piecewise(t.start, t.end, t.col,
                                packed.index_select(0, relay), t.base, gt,
                                table)
    dv_t = sddmm_spans_piecewise(t.start, t.end, t.col, t.base, xt, gt,
                                 table)
    dv_p = torch.empty_like(dv_t).index_copy_(0, relay.long(), dv_t)
    d_value, d_x = _fused((t._replace(split=table), relay, relay_inv),
                          packed, gt, xt)
    (w_dx, w_dv), (s_dx, s_dv) = _oracle(row, col, val, x, g)
    for dv, dx in ((dv_p, dx_p), (d_value, d_x)):
        _within(dx.numpy(), w_dx, s_dx, ORACLE_ABS, ORACLE_REL)
        _within(unpack_values(ts, dv).numpy(), w_dv, s_dv, ORACLE_ABS,
                ORACLE_REL)


class _Spy:
    """Counts the calls of the packed SpMM's three kernel wrappers as
    ``ops/spmm_seg2.py`` reaches them."""

    def __init__(self, monkeypatch):
        self.calls = {"fused": 0, "spans": 0, "sddmm": 0}
        for name, key in (("spmm_sddmm_spans_cuda", "fused"),
                          ("spmm_spans_cuda", "spans"),
                          ("sddmm_spans_cuda", "sddmm")):
            monkeypatch.setattr(tseg2, name,
                                self._wrap(getattr(tseg2, name), key))

    def _wrap(self, fn, key):
        def call(*args, **kw):
            self.calls[key] += 1
            return fn(*args, **kw)
        return call


def _entry(backend, row, col, k):
    """``(apply, packed, unpack, calls)``: the backend's SpMM over packed
    values, its packed COO values and the seg2 calls it makes."""
    r, c = _t(row), _t(col)
    if backend == "seg2":
        plan, s = make_seg2_plan(r, c, M, N, feat_dim=k, sr=32)
        return (lambda p, x: spmm_seg2(plan, s, p, x),
                lambda v: pack_values(s, v),
                lambda d: unpack_values(s, d), 1)
    if backend == "seg3":
        plan, s = make_seg3_plan(r, c, M, N, feat_dim=k, sr=32,
                                 band_rows=128)
        return (lambda p, x: spmm_seg3(plan, s, p, x),
                lambda v: pack_values(s, v),
                lambda d: unpack_values(s, d), 1)
    if backend == "seg":
        plan, s = tseg.make_seg_plan(r, c, M, N, feat_dim=k,
                                     target_bytes=16 * 1024, seg_rows=64)
        return (lambda p, x: tseg.spmm_seg(plan, s, p, x),
                lambda v: tseg.pack_values(s, v),
                lambda d: tseg.unpack_values(s, d), 1)
    plan, s = make_split_plan(r, c, M, N, feat_dim=k, block=64, sr=32)

    def unpack(d):
        out = torch.zeros(row.size)
        out[s.idx_local.long()] = unpack_values(s.local, d[0])
        out[s.idx_resid.long()] = unpack_values(s.resid, d[1])
        return out
    return (lambda p, x: spmm_split(plan, s, p, x),
            lambda v: pack_values_split(s, v), unpack, 2)


@pytest.mark.parametrize("wrt", ["both", "value", "x", "x_value_none"])
@pytest.mark.parametrize("backend", ["seg2", "seg3", "seg", "seg2split"])
def test_packed_backward_dispatch(monkeypatch, backend, wrt):
    """``_PackedSpmm.backward`` runs the fused span pass exactly when both
    ``d value`` and ``d x`` are needed; the span SDDMM over the forward
    layout for ``d value`` alone; the spans SpMM over the transpose for
    ``d x`` alone or with ``value`` None. The forward is one spans launch
    per seg2 call (split: two calls); the grads match the f64 oracle."""
    k = 16
    row, col, val, x, g = _graph(80, k=k)
    apply, pack, unpack, calls = _entry(backend, row, col, k)
    spy = _Spy(monkeypatch)
    packed = None
    if wrt != "x_value_none":
        packed = pack(_t(val))
        leaves = packed if isinstance(packed, tuple) else (packed,)
        for p in leaves:
            p.requires_grad_(wrt in ("both", "value"))
    xt = _t(x).requires_grad_(wrt != "value")
    (apply(packed, xt) * _t(g)).sum().backward()
    want = {"both": {"fused": 1, "spans": 1, "sddmm": 0},
            "value": {"fused": 0, "spans": 1, "sddmm": 1},
            "x": {"fused": 0, "spans": 2, "sddmm": 0},
            "x_value_none": {"fused": 0, "spans": 2, "sddmm": 0}}[wrt]
    assert spy.calls == {key: calls * n for key, n in want.items()}
    v = val if wrt != "x_value_none" else np.ones_like(val)
    (w_dx, w_dv), (s_dx, s_dv) = _oracle(row, col, v, x, g)
    if wrt != "value":
        _within(xt.grad.numpy(), w_dx, s_dx, ORACLE_ABS, ORACLE_REL)
    if wrt in ("both", "value"):
        grads = (tuple(p.grad for p in packed) if isinstance(packed, tuple)
                 else packed.grad)
        _within(unpack(grads).numpy(), w_dv, s_dv, ORACLE_ABS, ORACLE_REL)

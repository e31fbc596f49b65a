"""The multi-span SpMM (the counterpart of K3/K4) and the span SDDMM (K2's
span form) of paddle_sparse_tpu_torch, on the CPU through their plain
versions: against f64 numpy oracles, against ``spmm_csr_reference`` at S=1,
and the K3/K4 entry points ``tilespan_call``/``band_reduce_call`` against the
JAX package's (Pallas interpret mode) on the JAX planner's own tables.

Tolerances: plain versions against the f64 oracle ``rtol=atol=1e-5`` (f32
sums); against JAX's kernels ``rtol=atol=1e-4``, because their f32 path sums
bf16 hi/lo halves (about 2**-16 relative per term); a bf16 stream
``rtol=atol=2e-3`` (JAX's one-pass bf16 product, f32 sums)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_sparse_tpu.ops.kernels import spmm_pallas as jsp
from paddle_sparse_tpu.ops.spmm_seg3 import make_seg3_plan as j_seg3_plan
from paddle_sparse_tpu_torch import (band_reduce_call, product_dtype,
                                     sddmm_spans_cuda, sddmm_spans_reference,
                                     spmm_csr_reference, spmm_spans_cuda,
                                     spmm_spans_reference, tilespan_call,
                                     tilespan_tables)
from paddle_sparse_tpu_torch.ops.kernels.spmm_spans_cuda import \
    as_span_bounds
from paddle_sparse_tpu_torch.ops.spmm_seg3 import _pad_rp
from paddle_sparse_tpu_torch.ops.spmm_seg2 import build_layouts

ORACLE = dict(rtol=1e-5, atol=1e-5)
JAX_F32 = dict(rtol=1e-4, atol=1e-4)


def _spans(rng, S, M, max_len, empty_rows=(0,)):
    """Random (S, M+1) row pointers of contiguous spans, span-major, with
    empty spans and rows."""
    lens = rng.integers(0, max_len + 1, (S, M))
    lens[:, list(empty_rows)] = 0
    ptr = np.concatenate([[0], np.cumsum(lens.reshape(-1))])
    idx = (np.arange(S) * M)[:, None] + np.arange(M + 1)[None, :]
    return ptr[idx].astype(np.int32)


def _oracle(start, end, idx, value, base, src):
    S, M = start.shape
    out = np.zeros((M, src.shape[1]))
    for s in range(S):
        for m in range(M):
            for e in range(start[s, m], end[s, m]):
                r = (e if idx is None else idx[e]) + (0 if base is None
                                                     else base[s])
                out[m] += (1.0 if value is None else value[e]) * src[r]
    return out


@pytest.mark.parametrize("S", [1, 3, 19, 40])
@pytest.mark.parametrize("K", [1, 47, 64])
@pytest.mark.parametrize("with_value", [True, False])
def test_spans_reference_vs_oracle(S, K, with_value):
    rng = np.random.default_rng(S * 100 + K)
    M, N = 60, 90
    rp = _spans(rng, S, M, 3, empty_rows=(0, 7, M - 1))
    nnz = int(rp[-1, -1])
    base = rng.integers(0, 20, S).astype(np.int32)
    idx = rng.integers(0, N - 20, nnz).astype(np.int32)
    val = rng.standard_normal(nnz).astype(np.float32)
    x = rng.standard_normal((N, K)).astype(np.float32)
    rpt = torch.as_tensor(rp)
    out = spmm_spans_cuda(rpt[:, :-1], rpt[:, 1:], torch.as_tensor(idx),
                          torch.as_tensor(val) if with_value else None,
                          torch.as_tensor(base), torch.as_tensor(x))
    want = _oracle(rp[:, :-1], rp[:, 1:], idx, val if with_value else None,
                   base, x)
    assert out.dtype == torch.float32 and out.shape == (M, K)
    np.testing.assert_allclose(out.numpy(), want, **ORACLE)
    assert not out[[0, 7, M - 1]].any()


def test_spans_stream_form_overlapping_and_reversed():
    """idx=None reads the stream in place; spans may overlap, and a span
    with end < start is empty."""
    rng = np.random.default_rng(1)
    S, M, L, K = 4, 30, 200, 16
    start = rng.integers(0, L - 10, (S, M)).astype(np.int32)
    end = (start + rng.integers(-3, 10, (S, M))).astype(np.int32)
    src = rng.standard_normal((L, K)).astype(np.float32)
    out = spmm_spans_reference(torch.as_tensor(start), torch.as_tensor(end),
                               None, None, None, torch.as_tensor(src))
    want = _oracle(start, np.maximum(end, start), None, None, None, src)
    np.testing.assert_allclose(out.numpy(), want, **ORACLE)


@pytest.mark.parametrize("K", [1, 33, 128])
def test_spans_s1_equals_csr_reference(K):
    rng = np.random.default_rng(K)
    rp = torch.as_tensor(_spans(rng, 1, 200, 9, empty_rows=(0, 5)))
    nnz = int(rp[0, -1])
    col = torch.as_tensor(rng.integers(0, 70, nnz).astype(np.int32))
    val = torch.as_tensor(rng.standard_normal(nnz).astype(np.float32))
    x = torch.as_tensor(rng.standard_normal((70, K)).astype(np.float32))
    for v in (val, None):
        a = spmm_spans_reference(rp[:, :-1], rp[:, 1:], col, v, None, x)
        b = spmm_csr_reference(rp[0], col, v, x)
        assert torch.equal(a, b)


def test_spans_f64_and_bf16_dtypes():
    rng = np.random.default_rng(3)
    rp = torch.as_tensor(_spans(rng, 3, 40, 4))
    nnz = int(rp[-1, -1])
    idx = torch.as_tensor(rng.integers(0, 50, nnz))
    val = torch.as_tensor(rng.standard_normal(nnz))
    x = torch.as_tensor(rng.standard_normal((50, 8)))
    out = spmm_spans_reference(rp[:, :-1], rp[:, 1:], idx, val, None, x)
    assert out.dtype == torch.float64
    want = _oracle(rp[:, :-1].numpy(), rp[:, 1:].numpy(), idx.numpy(),
                   val.numpy(), None, x.numpy())
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-12, atol=1e-12)
    out = spmm_spans_reference(rp[:, :-1], rp[:, 1:], idx, None, None,
                               x.bfloat16())
    assert out.dtype == torch.bfloat16


def test_spans_windows_bound_the_plain_version(monkeypatch):
    """Windows of a few edges give the same sums as one window."""
    from paddle_sparse_tpu_torch.ops.kernels import spmm_spans_cuda as mod
    rng = np.random.default_rng(4)
    rp = torch.as_tensor(_spans(rng, 5, 50, 6))
    nnz = int(rp[-1, -1])
    idx = torch.as_tensor(rng.integers(0, 40, nnz).astype(np.int32))
    x = torch.as_tensor(rng.standard_normal((40, 8)).astype(np.float32))
    g = torch.as_tensor(rng.standard_normal((50, 8)).astype(np.float32))
    whole = spmm_spans_reference(rp[:, :-1], rp[:, 1:], idx, None, None, x)
    dv = sddmm_spans_reference(rp[:, :-1], rp[:, 1:], idx, None, g, x)
    monkeypatch.setattr(mod, "_WINDOW_BYTES", 3 * 8 * 4)
    torch.testing.assert_close(
        spmm_spans_reference(rp[:, :-1], rp[:, 1:], idx, None, None, x),
        whole, rtol=1e-6, atol=1e-6)
    assert torch.equal(
        sddmm_spans_reference(rp[:, :-1], rp[:, 1:], idx, None, g, x), dv)


@pytest.mark.parametrize("S", [1, 3, 40])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_sddmm_spans_vs_oracle(S, out_dtype):
    """dv[e] = g[m] . x[base[s] + col[e]]; positions outside every span
    read 0."""
    rng = np.random.default_rng(S)
    M, N, K = 50, 80, 24
    rp = _spans(rng, S, M, 3, empty_rows=(2,))
    nnz = int(rp[-1, -1])
    col = rng.integers(0, N - 10, nnz + 7).astype(np.int32)   # 7 pads
    base = rng.integers(0, 10, S).astype(np.int32)
    g = rng.standard_normal((M, K)).astype(np.float32)
    x = rng.standard_normal((N, K)).astype(np.float32)
    rpt = torch.as_tensor(rp)
    dv = sddmm_spans_cuda(rpt[:, :-1], rpt[:, 1:], torch.as_tensor(col),
                          torch.as_tensor(base), torch.as_tensor(g),
                          torch.as_tensor(x), out_dtype=out_dtype)
    want = np.zeros(nnz + 7)
    for s in range(S):
        for m in range(M):
            for e in range(rp[s, m], rp[s, m + 1]):
                want[e] = g[m].astype(np.float64) @ x[base[s] + col[e]]
    assert dv.dtype == out_dtype and dv.shape == (nnz + 7,)
    tol = ORACLE if out_dtype == torch.float32 else dict(rtol=1e-2,
                                                         atol=1e-2)
    np.testing.assert_allclose(dv.double().numpy(), want, **tol)
    assert not dv[nnz:].any()


def test_wrappers_on_cpu_launch_nothing():
    rng = np.random.default_rng(5)
    rp = torch.as_tensor(_spans(rng, 2, 20, 3))
    nnz = int(rp[-1, -1])
    col = torch.as_tensor(rng.integers(0, 20, nnz).astype(np.int32))
    x = torch.randn(20, 4)
    before = (spmm_spans_cuda.launches, sddmm_spans_cuda.launches)
    spmm_spans_cuda(rp[:, :-1], rp[:, 1:], col, None, None, x)
    sddmm_spans_cuda(rp[:, :-1], rp[:, 1:], col, None, torch.randn(20, 4), x)
    assert (spmm_spans_cuda.launches, sddmm_spans_cuda.launches) == before


def test_span_bounds_views_stay_views():
    rp = torch.arange(24, dtype=torch.int32).reshape(3, 8)
    st, en = as_span_bounds(rp[:, :-1], rp[:, 1:])
    assert st.data_ptr() == rp.data_ptr()
    assert en.data_ptr() == rp.data_ptr() + 4 and st.stride() == (8, 1)
    st, en = as_span_bounds(rp[:, :-1].long(), rp[:, 1:].long())
    assert st.dtype == torch.int32 and st.is_contiguous()
    assert torch.equal(en, rp[:, 1:])
    with pytest.raises(ValueError):
        as_span_bounds(rp[:, :-1], rp[:, :-2])
    with pytest.raises(TypeError):
        as_span_bounds(rp[:, :-1].float(), rp[:, 1:].float())


@pytest.mark.parametrize("stream", ["f32", "bf16"])
def test_product_dtype_matches_jax(stream):
    dts = {"f32": (torch.float32, jnp.float32),
           "bf16": (torch.bfloat16, jnp.bfloat16),
           "f64": (torch.float64, jnp.float64)}
    for v in (None, "f32", "bf16", "f64"):
        for x in ("f32", "bf16", "f64"):
            tv = None if v is None else torch.zeros(1, dtype=dts[v][0])
            jv = None if v is None else jnp.zeros(1, dts[v][1])
            got = product_dtype(tv, torch.zeros(1, dtype=dts[x][0]), stream)
            want = jsp._product_dtype(jv, jnp.zeros(1, dts[x][1]), stream)
            assert str(got) == f"torch.{jnp.dtype(want).name}", (v, x)


def _j_seg3(M, N, nnz, sr, band, seed):
    rng = np.random.default_rng(seed)
    row = np.sort(rng.integers(0, M, nnz)).astype(np.int32)
    col = rng.integers(0, N, nnz).astype(np.int32)
    return j_seg3_plan(row, col, M, N, feat_dim=32, sr=sr, band_rows=band,
                       stream="f32")


@pytest.mark.parametrize("M,N,nnz,sr,band", [(300, 200, 2500, 64, 128),
                                              (130, 500, 1800, 512, 256)])
def test_tilespan_tables_match_jax(M, N, nnz, sr, band):
    """The port's tables of seg3's band-padded row pointers equal
    ``spmm_seg3.py::_tables``, both orientations."""
    plan, s = _j_seg3(M, N, nnz, sr, band, seed=M)
    for rp, tab, S, cap, cts in (
            (s.rp_f, s.tab_f, plan.S, plan.cap, plan.CAP_TS),
            (s.rp_t, s.tab_t, plan.S_t, plan.cap_t, plan.CAP_TS_t)):
        got = tilespan_tables(torch.as_tensor(np.array(rp)), S=S,
                              BAND=plan.BAND, cap=cap, CAP_TS=cts)
        for a, b in zip(got, (tab.e0a, tab.bst, tab.ben)):
            assert np.array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_tilespan_call_matches_jax(dtype):
    """K3's entry point against ``tilespan_call`` in interpret mode, band by
    band, on the JAX planner's tables and a random band stream; and against
    an f64 oracle read straight from the row pointers."""
    plan, s = _j_seg3(300, 200, 2500, 64, 128, seed=7)
    S, T_B, CAP_TS, K = plan.S, plan.BAND // 128, plan.CAP_TS, 32
    rp = np.asarray(s.rp_f).astype(np.int64)
    rng = np.random.default_rng(8)
    L = S * plan.cap + CAP_TS
    for b in range(s.tab_f.e0a.shape[0]):
        stream = rng.standard_normal((L, K)).astype(np.float32)
        jst = jnp.asarray(stream, jnp.bfloat16 if dtype == "bf16"
                          else jnp.float32)
        want = np.asarray(jsp.tilespan_call(
            s.tab_f.e0a[b], s.tab_f.bst[b], s.tab_f.ben[b], jst, S=S,
            T_B=T_B, CAP_TS=CAP_TS, K=K, split=True, interpret=True))
        tst = torch.as_tensor(np.array(jst.astype(jnp.float32)))
        if dtype == "bf16":
            tst = tst.bfloat16()
        got = tilespan_call(torch.as_tensor(np.array(s.tab_f.e0a[b])),
                            torch.as_tensor(np.array(s.tab_f.bst[b])),
                            torch.as_tensor(np.array(s.tab_f.ben[b])), tst,
                            S=S, T_B=T_B, CAP_TS=CAP_TS, K=K)
        assert got.dtype == torch.float32 and got.shape == (T_B * 128, K)
        tol = JAX_F32 if dtype == "f32" else dict(rtol=2e-3, atol=2e-3)
        np.testing.assert_allclose(got.numpy(), want, **tol)
        lo = rp[:, b * plan.BAND:(b + 1) * plan.BAND + 1]
        loc = lo - lo[:, :1] + (np.arange(S) * plan.cap)[:, None]
        oracle = _oracle(loc[:, :-1], loc[:, 1:], None, None, None,
                         tst.double().numpy())
        np.testing.assert_allclose(got.numpy(), oracle, **ORACLE)


def _band_tables(S, BAND, E, CAP, TMAX, R=128):
    """The tables of ``experiments/r4_band_cost.py:36-56`` at a small
    size."""
    deg = CAP / BAND
    loc = jnp.clip((jnp.arange(BAND + 1) * deg).astype(jnp.int32), 0, CAP)
    offs = (jnp.arange(S, dtype=jnp.int32) * CAP)[:, None]
    padv = jnp.broadcast_to(loc[-1:], (S, 128))
    lb = jnp.broadcast_to(loc[None, :], (S, BAND + 1))
    bst = (jnp.concatenate([lb[:, :-1], padv], axis=1) + offs).reshape(-1, R)
    ben = (jnp.concatenate([lb[:, 1:], padv], axis=1) + offs).reshape(-1, R)
    ncs = CAP // E
    q = jnp.arange(ncs, dtype=jnp.int32) * E
    r_lo = jnp.clip(jnp.searchsorted(loc, q, side="right") - 1, 0, BAND - 1)
    r_hi = jnp.clip(jnp.searchsorted(loc, jnp.minimum(q + E, loc[-1]),
                                     side="left") - 1, 0, BAND - 1)
    r0 = (r_lo // 128) * 128
    nj = jnp.clip(-(-(jnp.maximum(r_hi, r_lo) - r0 + 1) // R), 0, TMAX)
    return (jnp.repeat(jnp.arange(S, dtype=jnp.int32), ncs),
            jnp.tile(r0, (S,)).astype(jnp.int32),
            jnp.tile(nj, (S,)).astype(jnp.int32), bst, ben)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_band_reduce_call_matches_jax(dtype):
    S, BAND, E, K, CAP, TMAX = 3, 256, 64, 32, 448, 4
    BR_pad = BAND + 128
    tables = _band_tables(S, BAND, E, CAP, TMAX)
    stream = jax.random.normal(jax.random.PRNGKey(0), (S * CAP, K),
                               jnp.bfloat16 if dtype == "bf16"
                               else jnp.float32)
    want = np.asarray(jsp.band_reduce_call(
        *tables, stream, S=S, BR_pad=BR_pad, E=E, K=K, TMAX=TMAX,
        split=True, interpret=True))
    tst = torch.as_tensor(np.array(stream.astype(jnp.float32)))
    if dtype == "bf16":
        tst = tst.bfloat16()
    got = band_reduce_call(*(torch.as_tensor(np.array(t)) for t in tables),
                           tst, S=S, BR_pad=BR_pad, E=E, K=K, TMAX=TMAX)
    assert got.dtype == torch.float32 and got.shape == (BR_pad, K)
    tol = JAX_F32 if dtype == "f32" else dict(rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(got.numpy(), want, **tol)
    st = np.asarray(tables[3]).reshape(S, BR_pad)
    en = np.asarray(tables[4]).reshape(S, BR_pad)
    oracle = _oracle(st, en, None, None, None, tst.double().numpy())
    np.testing.assert_allclose(got.numpy(), oracle, **ORACLE)


def test_seg3_row_pointers_pad_like_jax():
    """``_pad_rp`` extends the row pointers with their last column, as the
    JAX planner does, so the padded rows are empty spans."""
    rng = np.random.default_rng(9)
    row = torch.as_tensor(np.sort(rng.integers(0, 100, 500)).astype(
        np.int32))
    col = torch.as_tensor(rng.integers(0, 100, 500).astype(np.int32))
    rp = build_layouts(row, col, 100, 100, SR=32, SR_t=32)[3]
    padded = _pad_rp(rp, 256)
    assert padded.shape == (4, 257)
    assert torch.equal(padded[:, :101], rp)
    assert torch.equal(padded[:, 101:], rp[:, -1:].expand(-1, 156))

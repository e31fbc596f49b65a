"""The probes of ``experiments/`` in the port against the JAX probes, on the
CPU: the port's plain versions (``ops/kernels/probes_cuda.py``, through the
entry points of ``paddle_sparse_tpu_torch/experiments/``) and the Pallas
kernels in TPU interpret mode, fed the same inputs at small sizes.

* ``bisect_pallas.trivial`` and ``dma_copy(False/True)`` are called as they
  are, under ``pltpu.force_tpu_interpret_mode()`` with x64 off, as the TPU
  runs them (``dma_copy(True)``'s ``lax.rem`` mixes int32 and int64 under
  the tests' x64); its spmm stage, ``segment_rows_matmul``, against
  ``spmm_pallas.segment_rows_matmul(interpret=True)``.
* ``r5_vmem_expand.make_call`` is imported with ``sys.argv`` patched (the
  module reads it at import) and ``NCH`` set small.
* The kernels of ``r4_dma_issue.py:44-82`` and ``r4_band_cost.py:117-137``
  and ``:159-249`` (with the tables of ``:99-114``) live inside functions
  that build full-size inputs, so they are copied here verbatim with the
  sizes as arguments; ``test_copies_match_the_probe_files`` holds each copy
  to the file's lines, whitespace-normalised. ``r4_dma_issue``'s kernel runs
  at ``STEPS = 8``: the interpreter refuses to revisit an output block, so
  the last-visit rule at more steps is held against numpy.

Tolerances: bit for bit where both sides add the same terms in the same
order (2 x, the chunk sums, ``onehot_write``'s copies, ``nodot``'s counts,
``empty``'s f32 sums in chunk order); ``rtol=1e-5, atol=1e-4`` where f32
sums of bf16 terms are taken in another order (``full``, ``nosel``,
``segment_rows_matmul`` of bf16); within 2**-16 of each row's sum of
|terms| for ``segment_rows_matmul`` of f32, whose JAX kernel sums hi and
lo bf16 halves of each term; within 1e-5 of each entry's sum of |terms| for
``r4_dma_issue`` (the TPU sums ``seed * x`` products, the port scales the
sum once); ``onehot_reduce`` rounds an f32 sum to bf16 on both sides:
within one bf16 ulp (2**-7 of the value).
"""
import inspect
import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from experiments import bisect_pallas as jax_bisect
from paddle_sparse_tpu.ops.kernels import spmm_pallas
from paddle_sparse_tpu_torch import segment_rows_matmul
from paddle_sparse_tpu_torch.experiments import (bisect_pallas,
                                                 r4_band_cost,
                                                 r4_dma_issue,
                                                 r5_vmem_expand)
from paddle_sparse_tpu_torch.ops.kernels import probes_cuda as pc

REPO = Path(__file__).resolve().parents[1]
F32 = dict(rtol=1e-5, atol=1e-4)
SUM_REL = 1e-5
BF16_ULP = 2.0 ** -7


def _interpret():
    """TPU interpret mode with x64 off, as the probes run on the TPU."""
    import contextlib
    stack = contextlib.ExitStack()
    stack.enter_context(pltpu.force_tpu_interpret_mode())
    stack.enter_context(jax.enable_x64(False))
    return stack


def _np(t):
    return t.detach().cpu().float().numpy() if t.dtype == torch.bfloat16 \
        else t.detach().cpu().numpy()


def _jnp(t):
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy(), jnp.bfloat16)
    return jnp.asarray(t.numpy())


# ---- verbatim copies of the probes' nested kernels ----------------------------

def _dma_issue_run(stream, e0, seed, *, NS, CAP, STEPS, R, K):
    # copy: experiments/r4_dma_issue.py:44-82
    def kern(e0_ref, seed_ref, stream_ref, out_ref, staging, sems):
        t = pl.program_id(0)
        for s in range(NS):
            pltpu.make_async_copy(
                stream_ref.at[pl.ds(pl.multiple_of(e0_ref[t * NS + s], 16), CAP), :],
                staging.at[pl.ds(s * CAP, CAP), :],
                sems.at[s]).start()
        for s in range(NS):
            pltpu.make_async_copy(
                stream_ref.at[pl.ds(pl.multiple_of(e0_ref[t * NS + s], 16), CAP), :],
                staging.at[pl.ds(s * CAP, CAP), :],
                sems.at[s]).wait()
        sel = jnp.broadcast_to(
            seed_ref[0, :].astype(jnp.bfloat16)[None, :],
            (NS * CAP, R))
        out_ref[:] = jax.lax.dot_general(
            sel, staging[:], (((0,), (0,)), ((), ())),
            preferred_element_type=jnp.float32)

    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1,
        grid=(STEPS,),
        in_specs=[
            pl.BlockSpec((1, R), lambda t, e: (0, 0),
                         memory_space=pltpu.VMEM),
            pl.BlockSpec(memory_space=pltpu.ANY),
        ],
        out_specs=pl.BlockSpec((R, K), lambda t, e: (t % 8, 0),
                               memory_space=pltpu.VMEM),
        scratch_shapes=[
            pltpu.VMEM((NS * CAP, K), jnp.bfloat16),
            pltpu.SemaphoreType.DMA((NS,)),
        ])
    return pl.pallas_call(
        kern, grid_spec=grid_spec,
        out_shape=jax.ShapeDtypeStruct((8 * R, K), jnp.float32),
        compiler_params=pltpu.CompilerParams(
            vmem_limit_bytes=100 << 20),
    )(e0, seed, stream)
    # end copy


def _band_tables(*, S, BAND, E, R, CAP, TMAX):
    ncs = CAP // E
    # copy: experiments/r4_band_cost.py:99-114
    deg = CAP / BAND
    loc = jnp.clip((jnp.arange(BAND + 1) * deg).astype(jnp.int32), 0, CAP)
    offs = (jnp.arange(S, dtype=jnp.int32) * CAP)[:, None]
    padv = jnp.broadcast_to(loc[-1:], (S, 128))
    lb = jnp.broadcast_to(loc[None, :], (S, BAND + 1))
    bst = (jnp.concatenate([lb[:, :-1], padv], axis=1) + offs).reshape(-1, R)
    ben = (jnp.concatenate([lb[:, 1:], padv], axis=1) + offs).reshape(-1, R)
    q = jnp.arange(ncs, dtype=jnp.int32) * E
    r_lo = jnp.clip(jnp.searchsorted(loc, q, side="right") - 1, 0, BAND - 1)
    r_hi = jnp.clip(jnp.searchsorted(loc, jnp.minimum(q + E, loc[-1]),
                                     side="left") - 1, 0, BAND - 1)
    r0 = (r_lo // 128) * 128
    nj = jnp.clip(-(-(jnp.maximum(r_hi, r_lo) - r0 + 1) // R), 0, TMAX)
    cs_ = jnp.repeat(jnp.arange(S, dtype=jnp.int32), ncs)
    cr_ = jnp.tile(r0, (S,)).astype(jnp.int32)
    cn_ = jnp.tile(nj, (S,)).astype(jnp.int32)
    # end copy
    return bst, ben, cs_, cr_, cn_


def _band_variants(*, S, BR_pad, E, K, R, TMAX, nchunks):
    # copy: experiments/r4_band_cost.py:117-137
    def make_call(kernel):
        grid_spec = pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=3, grid=(nchunks,),
            in_specs=[
                pl.BlockSpec((S * BR_pad // R, R), lambda c, s, r, n: (0, 0),
                             memory_space=pltpu.VMEM),
                pl.BlockSpec((S * BR_pad // R, R), lambda c, s, r, n: (0, 0),
                             memory_space=pltpu.VMEM),
                pl.BlockSpec((E, K), lambda c, s, r, n: (c, 0),
                             memory_space=pltpu.VMEM),
            ],
            out_specs=pl.BlockSpec((BR_pad, K), lambda c, s, r, n: (0, 0),
                                   memory_space=pltpu.VMEM))
        def call(cs, cr, cn, bst, ben, st):
            return pl.pallas_call(
                kernel, grid_spec=grid_spec,
                out_shape=jax.ShapeDtypeStruct((BR_pad, K), jnp.float32),
                compiler_params=pltpu.CompilerParams(
                    vmem_limit_bytes=100 << 20),
            )(cs, cr, cn, bst, ben, st)
        return call
    # end copy
    # copy: experiments/r4_band_cost.py:159-249
    dn_t = (((0,), (0,)), ((), ()))

    def k_full(s_r, r_r, n_r, bs, be, ch, out):
        c = pl.program_id(0)
        @pl.when(c == 0)
        def _():
            out[:] = jnp.zeros_like(out)
        e_ids = jax.lax.broadcasted_iota(jnp.int32, (E, R), 0) + c * E
        p = ch[:]
        row0 = pl.multiple_of(r_r[c], R)
        basep = (s_r[c] * BR_pad + row0) // R
        for j in range(TMAX):
            @pl.when(j < n_r[c])
            def _():
                st = bs[pl.ds(basep + j, 1), :]
                en = be[pl.ds(basep + j, 1), :]
                sel = (e_ids >= st) & (e_ids < en)
                acc = jax.lax.dot_general(sel.astype(jnp.bfloat16), p,
                                          dimension_numbers=dn_t,
                                          preferred_element_type=jnp.float32)
                out[pl.ds(pl.multiple_of(row0 + j * R, R), R), :] += acc

    def k_nodot(s_r, r_r, n_r, bs, be, ch, out):
        c = pl.program_id(0)
        @pl.when(c == 0)
        def _():
            out[:] = jnp.zeros_like(out)
        e_ids = jax.lax.broadcasted_iota(jnp.int32, (E, R), 0) + c * E
        row0 = pl.multiple_of(r_r[c], R)
        basep = (s_r[c] * BR_pad + row0) // R
        for j in range(TMAX):
            @pl.when(j < n_r[c])
            def _():
                st = bs[pl.ds(basep + j, 1), :]
                en = be[pl.ds(basep + j, 1), :]
                sel = (e_ids >= st) & (e_ids < en)
                out[pl.ds(pl.multiple_of(row0 + j * R, R), R), :] += (
                    jnp.broadcast_to(
                        jnp.sum(sel.astype(jnp.float32), axis=0,
                                keepdims=True).reshape(1, R)[:, :1],
                        (R, K)))

    def k_nosel(s_r, r_r, n_r, bs, be, ch, out):
        c = pl.program_id(0)
        @pl.when(c == 0)
        def _():
            out[:] = jnp.zeros_like(out)
        p = ch[:]
        row0 = pl.multiple_of(r_r[c], R)
        for j in range(TMAX):
            @pl.when(j < n_r[c])
            def _():
                acc = jax.lax.dot_general(
                    jnp.ones((E, R), jnp.bfloat16), p,
                    dimension_numbers=dn_t,
                    preferred_element_type=jnp.float32)
                out[pl.ds(pl.multiple_of(row0 + j * R, R), R), :] += acc

    def k_empty(s_r, r_r, n_r, bs, be, ch, out):
        c = pl.program_id(0)
        @pl.when(c == 0)
        def _():
            out[:] = jnp.zeros_like(out)
        row0 = pl.multiple_of(r_r[c], R)
        for j in range(TMAX):
            @pl.when(j < n_r[c])
            def _():
                out[pl.ds(pl.multiple_of(row0 + j * R, R), R), :] += (
                    ch[:R, :].astype(jnp.float32))

    def k_untrans(s_r, r_r, n_r, bs, be, ch, out):
        # sel in (R, E) orientation; bounds transposed per j (1,R)->(R,1)
        c = pl.program_id(0)
        @pl.when(c == 0)
        def _():
            out[:] = jnp.zeros_like(out)
        e_ids = jax.lax.broadcasted_iota(jnp.int32, (R, E), 1) + c * E
        p = ch[:]
        dn = (((1,), (0,)), ((), ()))
        row0 = pl.multiple_of(r_r[c], R)
        basep = (s_r[c] * BR_pad + row0) // R
        for j in range(TMAX):
            @pl.when(j < n_r[c])
            def _():
                st = bs[pl.ds(basep + j, 1), :].reshape(R, 1)
                en = be[pl.ds(basep + j, 1), :].reshape(R, 1)
                sel = (e_ids >= st) & (e_ids < en)
                acc = jax.lax.dot_general(sel.astype(jnp.bfloat16), p,
                                          dimension_numbers=dn,
                                          preferred_element_type=jnp.float32)
                out[pl.ds(pl.multiple_of(row0 + j * R, R), R), :] += acc
    # end copy
    return make_call, {"full": k_full, "nodot": k_nodot, "nosel": k_nosel,
                       "empty": k_empty, "untrans": k_untrans}


def _copy_blocks():
    """``(path, first, last, copied source)`` of each verbatim copy above."""
    blocks = []
    for fn in (_dma_issue_run, _band_tables, _band_variants):
        text = inspect.getsource(fn)
        for m in re.finditer(r"# copy: (\S+):(\d+)-(\d+)\n(.*?)# end copy",
                             text, re.S):
            blocks.append((m[1], int(m[2]), int(m[3]), m[4]))
    return blocks


def test_copies_match_the_probe_files():
    blocks = _copy_blocks()
    assert len(blocks) == 4
    for path, a, b, copied in blocks:
        lines = (REPO / path).read_text().splitlines()[a - 1:b]
        assert " ".join(copied.split()) == " ".join("\n".join(lines).split()), \
            f"the copy of {path}:{a}-{b} no longer matches the file"


# ---- bisect_pallas ------------------------------------------------------------

def test_trivial_matches_jax():
    with _interpret():
        want = np.asarray(jax_bisect.trivial())
    got = bisect_pallas.trivial(device="cpu")
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(_np(got), want)


@pytest.mark.parametrize("double_buffer", [False, True])
def test_dma_copy_matches_jax(double_buffer):
    with _interpret():
        want = np.asarray(jax_bisect.dma_copy(double_buffer))
    got = bisect_pallas.dma_copy(double_buffer, device="cpu")
    np.testing.assert_array_equal(_np(got), want)


def test_chunk_sum_uneven_tiles_vs_numpy():
    """Tiles of 3, 0, 6 and 1 chunks: the sum of each tile's chunks in
    ascending order, bit for bit with numpy's f32 adds in that order."""
    rng = np.random.default_rng(0)
    ptr = np.array([0, 3, 3, 9, 10])
    src = rng.standard_normal((10 * 16, 12)).astype(np.float32)
    want = np.zeros((4, 16, 12), np.float32)
    for t in range(4):
        for c in range(ptr[t], ptr[t + 1]):
            want[t] += src[c * 16:(c + 1) * 16]
    got = pc.chunk_sum_cuda(torch.from_numpy(ptr).int(),
                            torch.from_numpy(src), 16, True)
    np.testing.assert_array_equal(_np(got), want.reshape(64, 12))


def _csr_stream(rng, M, nnz, K, long_row=None):
    row = np.sort(rng.integers(0, M, nnz))
    if long_row is not None:
        row[nnz // 4: 3 * nnz // 4] = long_row
        row = np.sort(row)
    val = rng.standard_normal((nnz, K)).astype(np.float32)
    rowptr = np.searchsorted(row, np.arange(M + 1)).astype(np.int32)
    return row.astype(np.int32), val, rowptr


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_acc", [False, True])
def test_segment_rows_matmul_matches_jax(dtype, with_acc):
    """K1's entry with JAX's signature: a long row (past the port's piece
    cap), rowptr past nnz (clipped), ``acc`` added."""
    rng = np.random.default_rng(1)
    M, nnz, K = 200, 3000, 24
    row, val, rowptr = _csr_stream(rng, M, nnz, K, long_row=7)
    rowptr[-1] = nnz + 40
    acc = rng.standard_normal((M, K)).astype(np.float32) if with_acc \
        else None
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want = spmm_pallas.segment_rows_matmul(
        jnp.asarray(val, jdt), jnp.asarray(row), jnp.asarray(rowptr), M,
        tile_rows=128, chunk_edges=256, interpret=True,
        acc=None if acc is None else jnp.asarray(acc))
    p = torch.from_numpy(val).to(getattr(torch, dtype))
    got = segment_rows_matmul(p, torch.from_numpy(row),
                              torch.from_numpy(rowptr), M, tile_rows=128,
                              chunk_edges=256,
                              acc=None if acc is None
                              else torch.from_numpy(acc))
    assert got.dtype == torch.float32 and got.shape == (M, K)
    terms = np.abs(_np(p)).astype(np.float64)
    _close_to_split_sum(_np(got), np.asarray(want), rowptr.clip(0, nnz),
                        terms)


def _close_to_split_sum(got, want, rowptr, abs_terms):
    """JAX's f32 path sums hi and lo bf16 halves of each term (about 16
    significant bits): within 2**-16 of each row's sum of |terms|."""
    scale = np.add.reduceat(np.vstack([abs_terms, np.zeros_like(
        abs_terms[:1])]), rowptr[:-1], axis=0)
    scale[rowptr[:-1] == rowptr[1:]] = 0.0
    assert np.all(np.abs(got - want) <= 2.0 ** -16 * scale + 1e-6)


def test_bisect_spmm_stage_matches_jax():
    """The bisect's spmm stage at its own sizes (M=1024, K=64, 20,000 edges,
    drawn with numpy as the probe draws them)."""
    val, row, rowptr = bisect_pallas.spmm_inputs("cpu")
    with _interpret():
        want = np.asarray(spmm_pallas.segment_rows_matmul(
            jnp.asarray(val.numpy()), jnp.asarray(row.numpy()),
            jnp.asarray(rowptr.numpy()), bisect_pallas.SPMM_M))
    _close_to_split_sum(_np(bisect_pallas.spmm("cpu")), want,
                        rowptr.numpy(), np.abs(val.numpy()).astype(np.float64))


def test_bisect_main_prints_each_stage(capsys):
    out = bisect_pallas.main(["dma2"], device="cpu")
    assert list(out) == ["dma2"]
    assert capsys.readouterr().out.startswith(
        "dma double-buffer: ok in ")
    assert set(bisect_pallas.main([], device="cpu")) == {
        "trivial", "dma1", "dma2", "spmm"}


# ---- r4_dma_issue -------------------------------------------------------------

def _dma_inputs(NS, CAP, K, steps, L=4096, seed=0):
    g = torch.Generator().manual_seed(seed)
    stream = torch.randn((L, K), generator=g).bfloat16()
    e0 = (torch.randint(0, L - CAP, (steps * NS,), generator=g) // 16
          * 16).int()
    e0[-1] = (L - CAP) // 16 * 16
    sd = torch.randn((1, 128), generator=g)
    return stream, e0, sd


@pytest.mark.parametrize("NS,CAP,K", [(3, 32, 128), (2, 48, 256)])
def test_dma_issue_matches_jax_at_8_steps(NS, CAP, K):
    stream, e0, sd = _dma_inputs(NS, CAP, K, 8)
    with _interpret():
        want = np.asarray(_dma_issue_run(
            _jnp(stream), _jnp(e0), _jnp(sd), NS=NS, CAP=CAP, STEPS=8,
            R=128, K=K)).astype(np.float64)
    got = r4_dma_issue.run(stream, e0, sd, NS=NS, CAP=CAP, steps=8)
    assert got.shape == (8 * 128, K) and got.dtype == torch.float32
    # each entry sums NS * CAP terms bf16(seed[r]) * x: bound by their |sum|
    s = np.abs(_np(sd.bfloat16()).astype(np.float64))[0]
    absx = pc.span_colsum_reference(stream.abs(), e0, NS, CAP, 8,
                                    torch.float64).numpy()
    scale = (s[None, :, None] * absx[:, None, :]).reshape(8 * 128, K)
    assert np.all(np.abs(_np(got) - want) <= SUM_REL * scale + 1e-30)


@pytest.mark.parametrize("steps", [8, 13, 24])
def test_dma_issue_last_visit_vs_numpy(steps):
    """Step t writes block t % 8 and the last step of each residue class
    wins: a numpy walk over every step, in f64."""
    NS, CAP, K = 2, 40, 64
    stream, e0, sd = _dma_inputs(NS, CAP, K, steps, L=1000, seed=steps)
    x = stream.double().numpy()
    s = sd.bfloat16().double().numpy()[0]
    want = np.full((8, 128, K), np.nan)
    for t in range(steps):
        rows = np.concatenate([np.arange(e, e + CAP)
                               for e in e0.numpy()[t * NS:(t + 1) * NS]])
        want[t % 8] = s[:, None] * x[rows].sum(0)[None, :]
    got = r4_dma_issue.run(stream.double(), e0, sd, NS=NS, CAP=CAP,
                           steps=steps)
    np.testing.assert_allclose(got.numpy(), want.reshape(8 * 128, K),
                               rtol=1e-12, atol=1e-12)


def test_dma_issue_refuses_fewer_than_8_steps():
    stream, e0, sd = _dma_inputs(2, 16, 64, 7)
    with pytest.raises(ValueError, match="at least 8 steps"):
        r4_dma_issue.run(stream, e0, sd, NS=2, CAP=16, steps=7)


def test_dma_issue_main_fields():
    """``main`` at a small size prints the probe's JSON fields."""
    old = (r4_dma_issue.STEPS, r4_dma_issue.NSTREAM, r4_dma_issue.ITERS)
    try:
        r4_dma_issue.STEPS, r4_dma_issue.NSTREAM = 16, 4096
        r4_dma_issue.ITERS = 1
        res = r4_dma_issue.main(["3", "64"], device="cpu")
    finally:
        r4_dma_issue.STEPS, r4_dma_issue.NSTREAM, r4_dma_issue.ITERS = old
    assert res["case"] == "NS=3 CAP=64" and res["device"] == "cpu"
    assert res["bytes_per_step_KB"] == 3 * 64 * 256 * 2 // 1024
    assert {"us_per_step", "us_per_dma", "edges_per_s_M",
            "compile_s"} <= set(res)


# ---- r4_band_cost -------------------------------------------------------------

BAND_SIZES = [dict(S=2, BAND=384, E=128, K=128, CAP=512),
              dict(S=3, BAND=640, E=128, K=256, CAP=1024)]


@pytest.mark.parametrize("sizes", BAND_SIZES)
def test_band_tables_match_jax(sizes):
    tb = r4_band_cost.tables(**sizes, device="cpu")
    with jax.enable_x64(False):
        want = _band_tables(S=sizes["S"], BAND=sizes["BAND"], E=sizes["E"],
                            R=128, CAP=sizes["CAP"], TMAX=4)
    for got, w in zip((tb.bst, tb.ben, tb.cs, tb.cr, tb.cn), want):
        np.testing.assert_array_equal(got.numpy(), np.asarray(w))


@pytest.mark.parametrize("kind", ["full", "nodot", "nosel", "empty",
                                  "untrans"])
@pytest.mark.parametrize("sizes", BAND_SIZES)
def test_band_variants_match_jax(sizes, kind):
    tb = r4_band_cost.tables(**sizes, device="cpu")
    r4_band_cost.check_schedule(tb)
    assert int(tb.visits[0].diff().max()) > 1   # tiles of several chunks
    with _interpret():
        make_call, kernels = _band_variants(
            S=tb.S, BR_pad=tb.BR_pad, E=tb.E, K=tb.K, R=tb.R, TMAX=tb.TMAX,
            nchunks=tb.nchunks)
        want = np.asarray(make_call(kernels[kind])(
            *(_jnp(t) for t in (tb.cs, tb.cr, tb.cn, tb.bst, tb.ben,
                                tb.stream))))
    got = _np(r4_band_cost.variant_call(kind, tb))
    if kind in ("nodot", "empty"):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **F32)


def _band_schedule(case, K, seed=0):
    """A schedule and bounds that ``r4_band_cost.tables`` never makes, for
    nodot against ``k_nodot``: ``unvisited`` leaves tiles 2 and 3 of 6 to no
    chunk; ``many`` sends 72 of 96 chunks to tile 1 from its first row, so
    that it has more than 64 visits (two rounds of a warp's lanes on the
    card). Spans and bounds are random, so a visit's overlap is anywhere in
    [0, E]."""
    rng = np.random.default_rng(seed)
    R, E, TMAX = 128, 16, 4
    if case == "unvisited":
        S, BAND, n = 2, 640, 40
        cr = rng.choice([0, 4], n) * R
        cn = rng.integers(0, 3, n)
    else:
        S, BAND, n = 2, 384, 96
        cr = np.where(np.arange(n) < 72, 1, rng.integers(0, 3, n)) * R
        cn = rng.integers(1, 3, n)
    BR_pad, L = BAND + 128, n * E
    bst = rng.integers(0, L + 1, S * BR_pad)
    ben = np.minimum(bst + rng.integers(0, L // 2, S * BR_pad), L)
    i32 = lambda a: torch.from_numpy(np.asarray(a, np.int32))
    stream = torch.from_numpy(rng.standard_normal((L, K),
                                                  np.float32)).bfloat16()
    tb = dict(cs=i32(rng.integers(0, S, n)), cr=i32(cr), cn=i32(cn),
              bst=i32(bst).reshape(-1, R), ben=i32(ben).reshape(-1, R),
              stream=stream)
    kw = dict(S=S, BR_pad=BR_pad, E=E, K=K, R=R, TMAX=TMAX)
    return tb, kw, n


@pytest.mark.parametrize("K", [8, 72])
@pytest.mark.parametrize("case", ["unvisited", "many"])
def test_band_nodot_schedules_match_jax(case, K):
    """nodot, bit for bit with ``k_nodot`` in interpret mode, on a band with
    tiles no chunk visits and on a tile of more than 64 visits."""
    tb, kw, n = _band_schedule(case, K)
    visits = pc.band_visits(tb["cr"], tb["cn"], BR_pad=kw["BR_pad"],
                            TMAX=kw["TMAX"])
    counts = visits[0].diff()
    if case == "unvisited":
        assert not counts[2:4].any() and bool(counts.any())
    else:
        assert int(counts.max()) > 64
    args = [tb[k] for k in ("cs", "cr", "cn", "bst", "ben", "stream")]
    with _interpret():
        make_call, kernels = _band_variants(nchunks=n, **kw)
        want = np.asarray(make_call(kernels["nodot"])(*map(_jnp, args)))
    got = pc.band_ablate_cuda("nodot", *args, **kw, visits=visits)
    np.testing.assert_array_equal(_np(got), want)
    assert want[:, 0].any()


def _covered_numpy(cs, cr, cn, bst, ben, S, BR_pad, E, R, TMAX):
    """Every edge of every (span, row) bound inside the whole chunks lies in
    a chunk of that span whose tiles include the row."""
    limit = len(cs) * E
    st = np.clip(bst.reshape(S, BR_pad), 0, limit)
    en = np.clip(ben.reshape(S, BR_pad), 0, limit)
    nj = np.clip(cn, 0, TMAX)
    for s in range(S):
        for r in range(BR_pad):
            for e in range(st[s, r], en[s, r]):
                c = e // E
                if cs[c] != s or not cr[c] <= r < cr[c] + nj[c] * R:
                    return False
    return True


def test_band_schedule_check_vs_numpy():
    """The host check raises exactly where numpy finds an edge that no
    visiting chunk of its span covers: the probe's schedule, a chunk that
    visits one tile too few, a chunk given another span, a shifted row0."""
    sizes = dict(S=2, BAND=384, E=128, K=128, CAP=512)
    rng = np.random.default_rng(4)
    cases = []
    for trial in range(12):
        tb = r4_band_cost.tables(**sizes, device="cpu")
        c = int(rng.integers(tb.nchunks))
        if trial % 4 == 1:
            tb.cn[c] = max(0, int(tb.cn[c]) - 1)
        elif trial % 4 == 2:
            tb.cs[c] = 1 - int(tb.cs[c])
        elif trial % 4 == 3:
            tb.cr[c] = int(tb.cr[c]) + 128 * int(rng.choice([-1, 1]))
            tb.cr[c] = min(max(int(tb.cr[c]), 0), 256)
        want = _covered_numpy(*(t.numpy().astype(np.int64) for t in (
            tb.cs, tb.cr, tb.cn, tb.bst, tb.ben)), tb.S, tb.BR_pad, tb.E,
            128, 4)
        try:
            r4_band_cost.check_schedule(tb)
            got = True
        except ValueError:
            got = False
        assert got == want, trial
        cases.append(want)
    assert True in cases and False in cases


def test_band_schedule_check_refuses_tiles_past_the_band():
    tb = r4_band_cost.tables(S=2, BAND=384, E=128, K=128, CAP=512,
                             device="cpu")
    tb.cr[-1], tb.cn[-1] = 384, 2
    with pytest.raises(ValueError, match="leave the band"):
        r4_band_cost.check_schedule(tb)


def test_band_main_and_variants_fields(monkeypatch):
    """``main`` and ``variants`` at a small band print the probe's fields,
    one line each, the variants in the probe's order."""
    small = dict(S=2, BAND=384, E=128, K=128, CAP=512)
    orig = r4_band_cost.tables
    monkeypatch.setattr(r4_band_cost, "tables",
                        lambda **kw: orig(**small, **kw))
    monkeypatch.setattr(r4_band_cost, "ITERS", 1)
    res = r4_band_cost.main(device="cpu")
    assert res["case"] == "band_reduce E=512 nchunks=8"
    assert {"ms", "us_per_step", "edges_per_s_M", "compile_s"} <= set(res)
    out = r4_band_cost.variants(device="cpu")
    assert [v["case"] for v in out.values()] == [
        n for n, _ in r4_band_cost.VARIANTS]


# ---- r5_vmem_expand -----------------------------------------------------------

@pytest.fixture(scope="module")
def jax_vmem():
    saved = sys.argv
    sys.argv = ["r5_vmem_expand.py"]     # the module reads argv at import
    try:
        from experiments import r5_vmem_expand as mod
    finally:
        sys.argv = saved
    return mod


@pytest.mark.parametrize("variant", ["onehot_write", "onehot_reduce"])
def test_vmem_expand_matches_jax(jax_vmem, monkeypatch, variant):
    monkeypatch.setattr(jax_vmem, "NCH", 3)
    R, E, K = r5_vmem_expand.R, r5_vmem_expand.E, r5_vmem_expand.K
    assert (R, E, K) == (jax_vmem.R, jax_vmem.E, jax_vmem.K)
    g = torch.Generator().manual_seed(5)
    fs = torch.tensor([2, 0, 2], dtype=torch.int32)   # a repeated slice
    cols = torch.randint(0, R, (3 * E,), generator=g, dtype=torch.int32)
    x = torch.randn((3 * R, K), generator=g).bfloat16()
    with _interpret():
        want = np.asarray(jax_vmem.make_call(variant)(
            _jnp(fs), _jnp(cols.view(-1, 1)), _jnp(x))).astype(np.float32)
    got = _np(r5_vmem_expand.make_call(variant)(fs, cols, x))
    assert got.shape == want.shape
    if variant == "onehot_write":
        np.testing.assert_array_equal(got, want)
    else:
        assert np.all(np.abs(got - want) <= BF16_ULP * np.abs(want))
        np.testing.assert_array_equal(got.reshape(3, 8, K),
                                      np.repeat(got[::8, None], 8, 1))


def test_vmem_expand_main_reports_each_variant(monkeypatch):
    monkeypatch.setattr(r5_vmem_expand, "ITERS", 1)
    ns = r5_vmem_expand.main(["2"], device="cpu")
    assert set(ns) == {"onehot_write", "onehot_reduce", "gather_sum",
                       "index_select"}


# ---- the plans of the redesigned P3 and P5 ------------------------------------
# span_colsum reads each covered row once through a piece plan; slice_gather's
# reduce sums each chunk's row counts times its slice over an item plan. The
# plans run on the CPU as on the card; their plain sums are held to the JAX
# probes in interpret mode and to f64.

SLICE_FS = {"all_equal": [4] * 70, "repeated": [2, 0, 2, 2, 1, 0, 2],
            "unsorted": [3, 1, 4, 1, 5, 0, 2, 6, 5, 3],
            "one_chunk": [5], "many_on_one": [1] * 100 + [0] * 33}


@pytest.mark.parametrize("case", sorted(SLICE_FS))
def test_slice_items_cover_each_chunk_once(case):
    """Every chunk in exactly one item; an item holds at most ITEM_CHUNKS
    chunks of one slice, in ascending order; a slice's chunks fill its
    items in order (only its last item may be short)."""
    fs = torch.tensor(SLICE_FS[case], dtype=torch.int32)
    it = pc.slice_items(fs)
    n = int(it.n_items[0])
    istart = it.istart.tolist()
    order = it.order.tolist()
    assert istart[0] == 0 and istart[n] == fs.numel()
    assert all(v == fs.numel() for v in istart[n:fs.numel() + 1])
    seen = []
    for i in range(n):
        chunks = order[istart[i]:istart[i + 1]]
        assert 1 <= len(chunks) <= pc.ITEM_CHUNKS
        assert chunks == sorted(chunks)
        assert {SLICE_FS[case][c] for c in chunks} == {int(it.sf[istart[i]])}
        if i + 1 < n and int(it.sf[istart[i + 1]]) == int(it.sf[istart[i]]):
            assert len(chunks) == pc.ITEM_CHUNKS
        seen += chunks
    assert sorted(seen) == list(range(fs.numel()))
    groups = {}
    for f in SLICE_FS[case]:
        groups[f] = groups.get(f, 0) + 1
    assert n == sum(-(-g // pc.ITEM_CHUNKS) for g in groups.values())


def _span_cases():
    """(e0, CAP, nstream): overlapping, identical, touching spans, unaligned
    starts, a span ending at the stream's last row, spans longer than a
    piece, and 13 random steps."""
    g = torch.Generator().manual_seed(3)
    rnd = torch.randint(0, 2000 - 77, (13 * 5,), generator=g)
    rnd[-1] = 2000 - 77
    return {"overlapping": ([10, 40, 35, 600], 50, 700),
            "identical": ([7, 7, 7, 300], 33, 400),
            "touching": ([0, 40, 80, 120], 40, 160),
            "at_the_end": ([3, 117, 59], 40, 157),
            "longer_than_a_piece": ([5, 700, 300], 601, 1400),
            "random_13_steps": (rnd.tolist(), 77, 2000)}


@pytest.mark.parametrize("case", sorted(_span_cases()))
def test_span_pieces_tile_each_span(case):
    """Each span is exactly the concatenation of its pieces; the pieces are
    disjoint, at most PIECE_ROWS rows, inside covered rows only, and no
    more than span_piece_bound of them."""
    starts, CAP, L = _span_cases()[case]
    e0 = torch.tensor(starts, dtype=torch.int32)
    plan = pc.span_pieces(e0, CAP, L)
    total = int(plan.total[0])
    assert plan.max_pieces == pc.span_piece_bound(len(starts), CAP, L)
    assert 0 < total <= plan.max_pieces
    row, length = plan.row.tolist(), plan.length.tolist()
    assert all(v == 0 for v in length[total:])
    covered = np.zeros(L, bool)
    for a in starts:
        covered[a:a + CAP] = True
    hit = np.zeros(L, int)
    for q in range(total):
        assert 1 <= length[q] <= pc.PIECE_ROWS
        hit[row[q]:row[q] + length[q]] += 1
    assert np.array_equal(hit, covered.astype(int))   # disjoint, exact
    for i, a in enumerate(starts):
        q0, q1 = int(plan.first[i]), int(plan.last[i])
        rows = [r for q in range(q0, q1)
                for r in range(row[q], row[q] + length[q])]
        assert rows == list(range(a, a + CAP))


def test_span_pieces_of_no_spans():
    plan = pc.span_pieces(torch.zeros(0, dtype=torch.int32), 16, 100)
    assert plan.max_pieces == 0 and int(plan.total[0]) == 0
    got = pc.span_colsum_pieces_reference(torch.randn(100, 8), plan, 0, 3)
    assert got.shape == (3, 8) and not got.any()


@pytest.mark.parametrize("NS,CAP,K", [(3, 32, 128), (2, 48, 256)])
def test_span_pieces_sums_match_jax_at_8_steps(NS, CAP, K):
    """Piece sums, then each step's spans' pieces, plain torch: the JAX
    probe's output in interpret mode within 1e-5 of each entry's sum of
    |terms|, and f64's within 1e-12."""
    stream, e0, sd = _dma_inputs(NS, CAP, K, 8)
    e0[1] = e0[0]                                     # identical spans
    e0[NS] = e0[0] + 5                                # overlapping steps
    with _interpret():
        want = np.asarray(_dma_issue_run(
            _jnp(stream), _jnp(e0), _jnp(sd), NS=NS, CAP=CAP, STEPS=8,
            R=128, K=K)).astype(np.float64)
    plan = pc.span_pieces(e0, CAP, stream.shape[0])
    got = pc.dma_issue_output(pc.span_colsum_pieces_reference(
        stream, plan, NS, 8), sd)
    s = np.abs(_np(sd.bfloat16()).astype(np.float64))[0]
    absx = pc.span_colsum_reference(stream.abs(), e0, NS, CAP, 8,
                                    torch.float64).numpy()
    scale = (s[None, :, None] * absx[:, None, :]).reshape(8 * 128, K)
    assert np.all(np.abs(_np(got) - want) <= SUM_REL * scale + 1e-30)
    f64 = pc.span_colsum_pieces_reference(stream, plan, NS, 8,
                                          torch.float64)
    np.testing.assert_allclose(
        f64.numpy(), pc.span_colsum_reference(stream, e0, NS, CAP, 8,
                                              torch.float64).numpy(),
        rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("fs_", [[2, 0, 2], [1, 1, 1]])
def test_slice_counts_sums_match_jax(jax_vmem, monkeypatch, fs_):
    """counts . slice per item, plain torch: the JAX probe's onehot_reduce
    in interpret mode within one bf16 ulp (both round an f32 sum once), and
    the f64 gather-and-sum within 1e-12 in f64."""
    monkeypatch.setattr(jax_vmem, "NCH", 3)
    R, E, K = r5_vmem_expand.R, r5_vmem_expand.E, r5_vmem_expand.K
    g = torch.Generator().manual_seed(6)
    fs = torch.tensor(fs_, dtype=torch.int32)
    cols = torch.randint(0, R, (3 * E,), generator=g, dtype=torch.int32)
    x = torch.randn((3 * R, K), generator=g).bfloat16()
    with _interpret():
        want = np.asarray(jax_vmem.make_call("onehot_reduce")(
            _jnp(fs), _jnp(cols.view(-1, 1)), _jnp(x))).astype(np.float32)
    got = _np(pc.slice_reduce_plan_reference(fs, cols, x, R))
    assert got.shape == want.shape
    assert np.all(np.abs(got - want) <= BF16_ULP * np.abs(want))
    np.testing.assert_allclose(
        pc.slice_reduce_plan_reference(fs, cols, x, R,
                                       acc=torch.float64).numpy(),
        pc.slice_gather_reference(fs, cols, x, R, "onehot_reduce",
                                  torch.float64).numpy(),
        rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("shape", [(8, 16, 7), (200, 400, 50),
                                   (40, 300, 100)])
def test_slice_counts_sums_vs_f64_at_odd_shapes(shape):
    """K 8, 200 and 40, R 16, 400 and 300, E 7, 50 and 100 over repeated,
    unsorted fs with more than ITEM_CHUNKS chunks on one slice: f32 counts
    . slice within 1e-5 of each entry's sum of |terms| of f64, before the
    bf16 rounding."""
    K, R, E = shape
    g = torch.Generator().manual_seed(K)
    fs = torch.tensor([1, 0, 1, 2] + [0] * 40, dtype=torch.int32)
    cols = torch.randint(0, R, (fs.numel() * E,), generator=g,
                         dtype=torch.int32)
    x = torch.randn((3 * R, K), generator=g).bfloat16()
    got = pc.slice_reduce_plan_reference(fs, cols, x, R, acc=torch.float32)
    want = pc.slice_gather_reference(fs, cols, x, R, "onehot_reduce",
                                     torch.float64)
    scale = pc.slice_gather_reference(fs, cols, x.abs(), R, "onehot_reduce",
                                      torch.float64)
    assert bool(((got.double() - want).abs()
                 <= SUM_REL * scale + 1e-30).all())


def test_reduce_shared_memory_and_piece_bounds():
    """The reduce kernel's shared memory fits a block's 227 KB at the
    probe's R = 512 and at every R up to 1,232 (the parts narrow past R =
    768), which covers the per-chunk kernel's R <= 799, and not at R =
    1,233; the piece bound counts every segment and a stream's worth of
    cuts."""
    assert pc._slice_reduce_smem(512, 256) <= pc._BLOCK_SMEM
    assert pc._slice_reduce_smem(16, 8) <= pc._BLOCK_SMEM
    for K in (8, 16, 200, 256):
        assert all(pc._slice_reduce_smem(R, K) <= pc._BLOCK_SMEM
                   for R in range(1, 1233))
        assert pc._slice_reduce_smem(1233, K) > pc._BLOCK_SMEM
    assert pc.span_piece_bound(19 * 2048, 384, 8 << 20) == \
        2 * 19 * 2048 - 1 + (8 << 20) // pc.PIECE_ROWS
    assert pc.span_piece_bound(0, 384, 100) == 0

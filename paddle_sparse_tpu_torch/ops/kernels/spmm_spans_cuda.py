"""Multi-span SpMM on the card: ``out[m] = sum_s sum_{start[s, m] <= e <
end[s, m]} value[e] * src[base[s] + idx[e]]``.

One function behind three TPU kernels of
``paddle_sparse_tpu/ops/kernels/spmm_pallas.py``: ``_tilespan_kernel`` (K3,
through :func:`tilespan_call`), ``_band_reduce_kernel`` (K4, through
:func:`band_reduce_call`) and the windowed, accumulate-in-place
``_reduce_call`` passes of ``ops/spmm_seg2.py::_seg_pass``. Each sums a row
over S spans of a packed, (segment, row)-sorted layout. Here one hand-written
CUDA kernel (``csrc/spmm_spans.cu``) does the gather, the scale and the sum
over all spans, and writes each output row once.

``start``/``end`` are (S, M) int32 tensors sharing one row stride, so the
(S, M+1) row pointers ``rp`` of a packed layout pass as ``rp[:, :-1]`` and
``rp[:, 1:]`` without a copy. ``idx=None`` is the stream form (``src[base[s]
+ e]``), ``value=None`` means ones and ``base=None`` means 0. The dtypes are
K1's (``spmm_cuda.check_spmm_dtypes``; the packed SpMMs gather in
:func:`product_dtype`, f32 or bf16). Sums are taken in f32, or in f64 when
the output is f64, and rounded once. A row of more than
``row_split.CAP`` edges is cut into pieces, one warp each, whose partials a
second pass sums (``ops/kernels/row_split.py``).
"""
from typing import Optional

import torch

from .row_split import AUTO, launch_spmm_spans, resolve_split, sum_dtype
from .spmm_cuda import _WINDOW_BYTES, _out_dtype, check_spmm_dtypes


def product_dtype(value: Optional[torch.Tensor], x: torch.Tensor,
                  stream: str) -> torch.dtype:
    """The dtype the packed-layout SpMMs gather ``x`` in: bf16 when
    ``value`` and ``x`` promote to bf16, or when they promote to f32 and
    ``stream == "bf16"`` opts in; f32 otherwise. A copy of
    ``spmm_pallas.py::_product_dtype`` that reads no environment variable:
    the caller passes ``stream`` (a plan carries it)."""
    common = (x.dtype if value is None
              else torch.promote_types(value.dtype, x.dtype))
    if common == torch.bfloat16:
        return torch.bfloat16
    if common == torch.float32 and stream == "bf16":
        return torch.bfloat16
    return torch.float32


def span_windows(start: torch.Tensor, end: torch.Tensor, width: int):
    """The edges of the (S, M) spans in bounded windows, for the plain
    versions: yields ``(s, rows, edges)``, each window at most
    ``1 GiB // width`` edges of span row ``s``, in (row, position) order."""
    M = start.shape[1]
    step = max(1, _WINDOW_BYTES // max(1, width))
    for s in range(start.shape[0]):
        st = start[s].long()
        lens = (end[s].long() - st).clamp_min(0)
        ptr = torch.zeros(M + 1, dtype=torch.int64, device=start.device)
        torch.cumsum(lens, 0, out=ptr[1:])
        total = int(ptr[-1])
        for a in range(0, total, step):
            flat = torch.arange(a, min(a + step, total), device=start.device)
            rows = torch.searchsorted(ptr, flat, right=True) - 1
            yield s, rows, st[rows] + (flat - ptr[rows])


def spmm_spans_reference(start: torch.Tensor, end: torch.Tensor,
                         idx: Optional[torch.Tensor],
                         value: Optional[torch.Tensor],
                         base: Optional[torch.Tensor], src: torch.Tensor,
                         out_dtype: Optional[torch.dtype] = None
                         ) -> torch.Tensor:
    """Plain PyTorch version of :func:`spmm_spans_cuda`, on any device.

    Walks each span row in bounded windows (gather, scale, ``index_add_``),
    summing in f32, in f64 when ``value`` or ``src`` is f64, and in int64
    for an integer output (then cast, which wraps as JAX's int sum does)."""
    out_dtype = out_dtype or _out_dtype(value, src)
    acc_dtype = (torch.float64 if torch.float64 in (
        src.dtype, out_dtype, None if value is None else value.dtype)
        else sum_dtype(out_dtype))
    K = src.shape[1]
    out = torch.zeros((start.shape[1], K), dtype=acc_dtype,
                      device=src.device)
    for s, rows, e in span_windows(start, end,
                                   K * out.element_size()):
        r = e if idx is None else idx[e].long()
        if base is not None:
            r = r + int(base[s])
        prod = src[r].to(acc_dtype)
        if value is not None:
            prod *= value[e, None].to(acc_dtype)
        out.index_add_(0, rows, prod)
    return out.to(out_dtype)


def as_span_bounds(start: torch.Tensor, end: torch.Tensor):
    """``start``/``end`` as int32 (S, M) tensors with one shared row stride
    and unit column stride, as the span kernels read them: views stay
    views, anything else becomes a contiguous copy."""
    if start.dim() != 2 or start.shape != end.shape:
        raise ValueError(f"start and end must be (S, M) of one shape, got "
                         f"{tuple(start.shape)} and {tuple(end.shape)}")
    for name, t in (("start", start), ("end", end)):
        if t.dtype not in (torch.int32, torch.int64):
            raise TypeError(f"{name} must be int32 or int64, got {t.dtype}")
    start, end = start.to(torch.int32), end.to(torch.int32)
    if start.stride() != end.stride() or start.stride(1) != 1:
        start, end = start.contiguous(), end.contiguous()
    return start, end


def check_span_args(fn: str, start, end, base, dev, *tensors):
    """Device, index dtype and int32-range checks shared by the span
    wrappers; returns ``(start, end, base)`` ready to launch."""
    for name, t in (("start", start), ("end", end), ("base", base),
                    *tensors):
        if t is not None and t.device != dev:
            raise ValueError(f"{fn}: {name} is on {t.device}, not {dev}")
    start, end = as_span_bounds(start, end)
    if base is not None:
        if base.dim() != 1 or base.numel() < start.shape[0]:
            raise ValueError(f"{fn}: base must be 1-D with one entry per "
                             f"span ({start.shape[0]}), got "
                             f"{tuple(base.shape)}")
        if base.dtype not in (torch.int32, torch.int64):
            raise TypeError(f"{fn}: base must be int32 or int64, got "
                            f"{base.dtype}")
        base = base.to(torch.int32).contiguous()
    sizes = [start.shape[0], start.shape[1]]
    sizes += [t.shape[0] for _, t in tensors if t is not None]
    if max(sizes) >= 2 ** 31:
        raise ValueError(f"{fn} indexes with int32: S, M, the edge arrays "
                         f"and the source rows must each be below 2**31")
    return start, end, base


def _check_cuda_args(start, end, idx, value, base, src, out_dtype):
    dev = src.device
    start, end, base = check_span_args(
        "spmm_spans_cuda", start, end, base, dev, ("idx", idx),
        ("value", value))
    if src.dim() != 2 or not src.is_contiguous():
        raise ValueError(f"src must be a contiguous 2-D tensor, got shape "
                         f"{tuple(src.shape)} (contiguous="
                         f"{src.is_contiguous()})")
    check_spmm_dtypes("spmm_spans_cuda", src.dtype,
                      None if value is None else value.dtype, out_dtype)
    if max(src.shape) >= 2 ** 31:
        raise ValueError("spmm_spans_cuda indexes with int32: N and K must "
                         "each be below 2**31")
    if idx is not None:
        if idx.dim() != 1 or idx.dtype not in (torch.int32, torch.int64):
            raise TypeError(f"idx must be 1-D int32 or int64, got "
                            f"{idx.dtype} {tuple(idx.shape)}")
        idx = idx.to(torch.int32).contiguous()
    if value is not None:
        if value.dim() != 1:
            raise ValueError(f"value must be 1-D, got {tuple(value.shape)}")
        if idx is not None and value.shape != idx.shape:
            raise ValueError(f"value shape {tuple(value.shape)} != idx "
                             f"shape {tuple(idx.shape)}")
        value = value.contiguous()
    return start, end, idx, value, base


def spmm_spans_cuda(start: torch.Tensor, end: torch.Tensor,
                    idx: Optional[torch.Tensor],
                    value: Optional[torch.Tensor],
                    base: Optional[torch.Tensor], src: torch.Tensor,
                    out_dtype: Optional[torch.dtype] = None,
                    split=AUTO) -> torch.Tensor:
    """Multi-span SpMM through the CUDA kernel ``csrc/spmm_spans.cu``.

    ``start``/``end`` (S, M) int32 (int64 is copied), ``idx``/``value``
    indexed by edge position, ``base`` (S,), ``src`` a contiguous (N, K)
    f32, bf16, f16 or f64 tensor; every position in a span must index
    ``idx`` and ``value`` (or ``src`` in the stream form) and every source
    row must lie in ``[0, N)``. ``out_dtype`` defaults to the promoted dtype
    of ``value`` and ``src``; it may be f64, f32 (from a src narrower than
    f64) or src's own dtype. ``split`` is the bounds'
    :class:`~.row_split.RowSplit` (a plan keeps it), ``None`` when no row
    is longer than its cap, or ``"auto"`` to build it here (one host read
    of the longest row). Returns (M, K). On a CPU tensor this runs
    :func:`spmm_spans_reference`; on a CUDA tensor it launches the kernel
    or raises. ``spmm_spans_cuda.launches`` counts kernel launches; the
    second pass of a split launch counts on
    ``row_split.fold_pieces_cuda.launches``."""
    out_dtype = out_dtype or _out_dtype(value, src)
    if src.device.type == "cpu":
        return spmm_spans_reference(start, end, idx, value, base, src,
                                    out_dtype)
    if src.device.type != "cuda":
        raise ValueError(f"spmm_spans_cuda runs on cpu or cuda, not "
                         f"{src.device}")
    start, end, idx, value, base = _check_cuda_args(start, end, idx, value,
                                                    base, src, out_dtype)
    (S, M), K = start.shape, src.shape[1]
    out = torch.empty((M, K), dtype=out_dtype, device=src.device)
    if M == 0 or K == 0:
        return out
    if S == 0:
        return out.zero_()
    launch_spmm_spans("spmm_spans", start, end, idx, value, base, src, out,
                      resolve_split(split, start, end))
    spmm_spans_cuda.launches += 1
    return out


spmm_spans_cuda.launches = 0


def tilespan_call(e0a: torch.Tensor, bst: torch.Tensor, ben: torch.Tensor,
                  stream2d: torch.Tensor, *, S: int, T_B: int, CAP_TS: int,
                  K: int, R: int = 128) -> torch.Tensor:
    """``spmm_pallas.py::tilespan_call`` (K3) with its signature: per
    ``R``-row output tile ``t``, the sum over ``S`` staged spans of the
    product stream ``stream2d`` (>= S * cap + CAP_TS, K). ``e0a`` (T_B * S,)
    holds each (tile, span)'s staged-slice start and ``bst``/``ben``
    (T_B, S, R) the staging-relative row bounds, as ``ops/spmm_seg3.py``'s
    tables lay them out: row ``r`` of tile ``t`` sums stream rows
    ``e0a[t, s] + clip(b - s * CAP_TS, 0, CAP_TS)`` for ``b`` from
    ``bst[t, s, r]`` to ``ben[t, s, r]``. Nothing is staged here: the
    absolute (start, end) of every (span, row) are computed in torch and one
    :func:`spmm_spans_cuda` launch reads the stream in place. Returns
    (T_B * R, K) f32."""
    if stream2d.dim() != 2 or stream2d.shape[1] != K:
        raise ValueError(f"stream2d must be (L, K={K}), got "
                         f"{tuple(stream2d.shape)}")
    dev = stream2d.device
    e0 = e0a.to(dev, torch.int64).reshape(T_B, S, 1)
    off = (torch.arange(S, device=dev) * CAP_TS)[None, :, None]
    bounds = []
    for b in (bst, ben):
        b = b.to(dev, torch.int64).reshape(T_B, S, R)
        b = (e0 + (b - off).clamp(0, CAP_TS)).clamp(0, stream2d.shape[0])
        bounds.append(b.permute(1, 0, 2).reshape(S, T_B * R))
    return spmm_spans_cuda(bounds[0], bounds[1], None, None, None, stream2d,
                           out_dtype=torch.float32)


def band_reduce_call(chunk_span: torch.Tensor, chunk_row0: torch.Tensor,
                     chunk_nj: torch.Tensor, bounds_start: torch.Tensor,
                     bounds_end: torch.Tensor, stream2d: torch.Tensor, *,
                     S: int, BR_pad: int, E: int, K: int, R: int = 128,
                     TMAX: int) -> torch.Tensor:
    """``spmm_pallas.py::band_reduce_call`` (K4) with its signature: row
    ``r`` of the (BR_pad, K) f32 output band sums stream rows ``e`` with
    ``bounds_start[s, r] <= e < bounds_end[s, r]`` over the ``S`` spans,
    the bounds being absolute positions in the band's stream ``stream2d``
    ((nchunks * E, K), lane-packed as (S * BR_pad / R, R) on the TPU).
    ``chunk_span``, ``chunk_row0``, ``chunk_nj`` and ``TMAX`` are the TPU's
    schedule (which chunk of ``E`` edges visits which row tiles); they are
    taken for the signature and not read: one :func:`spmm_spans_cuda`
    launch sums every (span, row) from the bounds alone. Positions past the
    last whole chunk are left out, as the TPU grid never reaches them."""
    del chunk_span, chunk_row0, chunk_nj, TMAX   # the TPU's schedule
    if stream2d.dim() != 2 or stream2d.shape[1] != K:
        raise ValueError(f"stream2d must be (L, K={K}), got "
                         f"{tuple(stream2d.shape)}")
    dev = stream2d.device
    limit = stream2d.shape[0] // E * E
    start, end = (b.to(dev, torch.int64).reshape(S, BR_pad).clamp(0, limit)
                  for b in (bounds_start, bounds_end))
    return spmm_spans_cuda(start, end, None, None, None, stream2d,
                           out_dtype=torch.float32)


def segment_rows_matmul(products: torch.Tensor,
                        row: Optional[torch.Tensor], rowptr: torch.Tensor,
                        num_rows: int, tile_rows: int = 128,
                        chunk_edges: int = 2048, split: bool = True,
                        acc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``spmm_pallas.py::segment_rows_matmul`` (K1) with its signature:
    ``out[m] = acc[m] + sum_{rowptr[m] <= e < rowptr[m+1]} products[e]`` over
    a row-sorted (nnz, K) stream, (num_rows, K) f32. A bf16 stream is summed
    as bf16, any other as f32, in f32; ``rowptr`` (num_rows + 1,) is clipped
    to ``[0, nnz]``. One :func:`spmm_spans_cuda` launch at S = 1 in the
    stream form, then ``acc`` added. ``row`` is ignored, as in JAX, and the
    TPU's tiling (``tile_rows``, ``chunk_edges``) and its hi/lo ``split``
    are taken and not read."""
    del row, tile_rows, chunk_edges, split   # the TPU's tiling
    if products.dtype != torch.bfloat16:
        products = products.float()
    nnz = products.shape[0]
    rp = rowptr.to(products.device, torch.int64)[:num_rows + 1].clamp(0, nnz)
    if rp.numel() != num_rows + 1:
        raise ValueError(f"rowptr needs num_rows + 1 = {num_rows + 1} "
                         f"entries, got {rowptr.numel()}")
    out = spmm_spans_cuda(rp[None, :-1], rp[None, 1:], None, None, None,
                          products.contiguous(), out_dtype=torch.float32)
    if acc is not None:
        out += acc.to(out.device, torch.float32)
    return out

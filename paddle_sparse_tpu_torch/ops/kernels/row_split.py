"""Long rows cut into pieces for the span kernels, and the launches that use
the pieces.

The span kernels (``csrc/spmm_spans.cu``: K1, K3, K4; ``csrc/sddmm_spans.cu``:
K2) give one warp to each output row, and that warp walks all of the row's
edges. On a power-law graph a few rows hold most edges (``bench.py``'s zipf
graph at 1/8 scale: 10,054,865 of 15,764,965 in one row), so one warp did
most of a launch's work. Here a row of more than ``cap`` edges becomes
``ceil(len / cap)`` pieces of at most ``cap`` consecutive edges in the row's
flat (span, position) order, and the kernels give one warp to each piece:

* the SpMM writes each piece of a split row as an f32 partial into a
  workspace, and a second pass (:func:`fold_pieces_cuda`) sums each split
  row's partials in a fixed order and writes the output row. No atomics, so
  two launches give the same bits;
* the SDDMM's pieces own disjoint edges, so it needs no second pass.

A row of at most ``cap`` edges is one piece, walked as before. When no row
is longer than ``cap``, :func:`split_rows` returns ``None`` and the kernels
launch one warp per row, with no workspace and no second pass.

:func:`split_long_rows` is ``paddle_sparse_tpu/ops/spmm.py::
_split_long_rows`` in torch (the port imports nothing of the JAX package).
The TPU cut rows to bound its product streams; the card cuts them for load
balance. The function computed does not change, only the schedule.
"""
from typing import NamedTuple, Optional, Union

import torch

from . import _build

# Edges per piece: the fastest of 512 ... 16384 for the span kernels, K1
# and K2 together on the bench's zipf graph at 1/8 scale, K=256, f32 and
# bf16 (``chip_probe.py sweep`` on an H100; PERF.md); 20x the uniform
# graph's degree of 50, so that graph splits nothing.
CAP = 1024
# the wrappers' default ``split``: build the table from the bounds per call
AUTO = "auto"


class RowSplit(NamedTuple):
    """The pieces of the span bounds of ``num_rows`` rows, from
    :func:`split_rows`: in row order and, within a row, in flat order."""
    row: torch.Tensor       # (P,) int32: the row of each piece
    piece: torch.Tensor     # (P,) int32: its index in the row; it covers
    #                         flat edges [piece * cap, (piece + 1) * cap)
    slot: torch.Tensor      # (P,) int32: its workspace row; -1 for the one
    #                         piece of a short row, written to the output
    fold_row: torch.Tensor  # (R,) int32: the rows of more than one piece
    fold_ptr: torch.Tensor  # (R+1,) int32: split row r's partials are the
    #                         workspace rows fold_ptr[r] .. fold_ptr[r+1]-1
    num_rows: int
    num_slots: int          # workspace rows: the pieces of split rows
    cap: int


def split_lengths(lens: torch.Tensor, cap: int = CAP) -> Optional[RowSplit]:
    """The :class:`RowSplit` of rows of ``lens`` flat edges, or ``None``
    when no row has more than ``cap``. Built on ``lens``' device; one host
    read (the longest row) when nothing splits, three when something does."""
    if cap < 1:
        raise ValueError(f"cap must be positive, got {cap}")
    M, dev = lens.numel(), lens.device
    lens = lens.long()
    if M == 0 or int(lens.max()) <= cap:
        return None
    pieces = torch.div(lens + cap - 1, cap, rounding_mode="floor").clamp_min(1)
    first = torch.cumsum(pieces, 0) - pieces
    P = int(first[-1] + pieces[-1])
    if P >= 2 ** 31:
        raise ValueError(f"{P} pieces: the kernels index pieces with int32")
    row = torch.repeat_interleave(torch.arange(M, device=dev), pieces,
                                  output_size=P)
    piece = torch.arange(P, device=dev) - first[row]
    split = pieces > 1
    fold_row = torch.nonzero(split).squeeze(1)
    fold_ptr = torch.zeros(fold_row.numel() + 1, dtype=torch.int64,
                           device=dev)
    torch.cumsum(pieces[fold_row], 0, out=fold_ptr[1:])
    in_split = split[row]
    slot = torch.where(in_split, torch.cumsum(in_split, 0) - 1, -1)
    i32 = torch.int32
    return RowSplit(row=row.to(i32), piece=piece.to(i32), slot=slot.to(i32),
                    fold_row=fold_row.to(i32), fold_ptr=fold_ptr.to(i32),
                    num_rows=M, num_slots=P - M + fold_row.numel(), cap=cap)


def split_rows(start: torch.Tensor, end: torch.Tensor,
               cap: int = CAP) -> Optional[RowSplit]:
    """:func:`split_lengths` of the rows of (S, M) span bounds (a span with
    ``end <= start`` is empty); a CSR pointer passes as
    ``rowptr[None, :-1]``, ``rowptr[None, 1:]``."""
    if start.dim() != 2 or start.shape != end.shape:
        raise ValueError(f"start and end must be (S, M) of one shape, got "
                         f"{tuple(start.shape)} and {tuple(end.shape)}")
    lens = (end - start).clamp_min_(0).sum(0, dtype=torch.int64)
    return split_lengths(lens, cap)


def split_long_rows(rowptr: torch.Tensor, cap: int = CAP):
    """``paddle_sparse_tpu/ops/spmm.py::_split_long_rows`` in torch: the CSR
    pointer refined so that no pseudo-row has more than ``cap`` edges,
    ``(rowptr_pseudo, fold)`` with ``fold[p]`` the real row of pseudo-row
    ``p``; ``(rowptr, None)`` when nothing splits."""
    t = split_rows(rowptr[None, :-1], rowptr[None, 1:], cap)
    if t is None:
        return rowptr, None
    rp, row = rowptr.long(), t.row.long()
    ptr = torch.minimum(rp[row] + t.piece.long() * cap, rp[row + 1])
    return torch.cat([ptr, rp[-1:]]), t.row


def resolve_split(split: Union[RowSplit, None, str], start: torch.Tensor,
                  end: torch.Tensor) -> Optional[RowSplit]:
    """A wrapper's ``split`` argument, ready to launch: :data:`AUTO` builds
    the table from the bounds (one host read when nothing splits), ``None``
    launches one warp per row, and a :class:`RowSplit` is checked against
    the bounds' rows and device. Its contents are trusted: it must be the
    table of these bounds."""
    if isinstance(split, str):
        if split != AUTO:
            raise ValueError(f"split must be a RowSplit, None or "
                             f"{AUTO!r}, not {split!r}")
        return split_rows(start, end)
    if split is None:
        return None
    if not isinstance(split, RowSplit):
        raise TypeError(f"split must be a RowSplit, None or {AUTO!r}, got "
                        f"{type(split).__name__}")
    if split.num_rows != start.shape[1]:
        raise ValueError(f"split table of {split.num_rows} rows for bounds "
                         f"of {start.shape[1]}")
    for name in ("row", "piece", "slot", "fold_row", "fold_ptr"):
        t = getattr(split, name)
        if (t.device != start.device or t.dtype != torch.int32
                or not t.is_contiguous()):
            raise ValueError(f"split.{name} must be contiguous int32 on "
                             f"{start.device}")
    return split


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _table(split: Optional[RowSplit]):
    """The C entry points' piece arguments: row, piece, P, cap."""
    if split is None:
        return None, None, 0, 0
    return (split.row.data_ptr(), split.piece.data_ptr(),
            split.row.numel(), split.cap)


def launch_spmm_spans(name: str, start, end, idx, value, base,
                      src: torch.Tensor, out: torch.Tensor,
                      split: Optional[RowSplit]) -> None:
    """``csrc/spmm_spans.cu`` over checked int32 (S, M) bounds into
    ``out``: one warp per row when ``split`` is None, else one per piece and
    then :func:`fold_pieces_cuda`. Raises if a launch fails; the caller
    counts its launch."""
    (S, M), K = start.shape, src.shape[1]
    ws = (None if split is None else torch.empty(
        (split.num_slots, K), dtype=torch.float32, device=src.device))
    lib = _build.load_library()
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.psp_spmm_spans(
            start.data_ptr(), end.data_ptr(), start.stride(0), _ptr(idx),
            _ptr(value), _ptr(base), src.data_ptr(), out.data_ptr(), S, M, K,
            int(src.dtype == torch.bfloat16),
            int(out.dtype == torch.bfloat16), *_table(split),
            None if split is None else split.slot.data_ptr(), _ptr(ws),
            stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    if split is not None:
        fold_pieces_cuda(split, ws, out)


def fold_pieces_cuda(split: RowSplit, ws: torch.Tensor,
                     out: torch.Tensor) -> None:
    """The second pass of a split SpMM launch (``csrc/spmm_spans.cu``):
    ``out[fold_row[r]]`` = the sum of the f32 workspace rows
    ``fold_ptr[r] .. fold_ptr[r+1]-1``, in a fixed order, written in
    ``out``'s dtype. ``fold_pieces_cuda.launches`` counts its launches."""
    lib = _build.load_library()
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.psp_fold_pieces(
            split.fold_row.data_ptr(), split.fold_ptr.data_ptr(),
            ws.data_ptr(), out.data_ptr(), split.fold_row.numel(),
            out.shape[1], int(out.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"fold_pieces kernel launch failed: CUDA error "
                           f"{err}")
    fold_pieces_cuda.launches += 1


fold_pieces_cuda.launches = 0


def fold_pieces_reference(split: RowSplit, ws: torch.Tensor,
                          out: torch.Tensor) -> None:
    """Plain version of :func:`fold_pieces_cuda`, on any device: each split
    row's workspace rows added in piece order (in ``ws``'s dtype), written
    into ``out``."""
    ptr = split.fold_ptr.long()
    n = ptr[1:] - ptr[:-1]
    acc = torch.zeros((n.numel(), ws.shape[1]), dtype=ws.dtype,
                      device=ws.device)
    for j in range(int(n.max())):
        more = n > j
        acc[more] += ws[ptr[:-1][more] + j]
    out[split.fold_row.long()] = acc.to(out.dtype)


def launch_sddmm_spans(name: str, start, end, col, base, g: torch.Tensor,
                       x: torch.Tensor, out: torch.Tensor,
                       split: Optional[RowSplit]) -> None:
    """``csrc/sddmm_spans.cu`` over checked int32 (S, M) bounds into
    ``out``: one warp per row when ``split`` is None, else one per piece.
    Raises if the launch fails; the caller counts it."""
    (S, M), K = start.shape, x.shape[1]
    lib = _build.load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.psp_sddmm_spans(
            start.data_ptr(), end.data_ptr(), start.stride(0),
            col.data_ptr(), _ptr(base), g.data_ptr(), x.data_ptr(),
            out.data_ptr(), S, M, K, int(x.dtype == torch.bfloat16),
            int(out.dtype == torch.bfloat16), *_table(split), stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


# ---- plain versions that follow the table (tests only) -----------------

def _piece_edges(start: torch.Tensor, end: torch.Tensor, split: RowSplit):
    """Every edge of the spans as a split launch visits it: ``(piece, span,
    position)``, piece by piece, and within a piece in flat order. The
    span of flat offset ``f`` of row ``m`` is the last span whose row
    offset is at most ``f``, as ``spans.cuh::span_edge`` finds it."""
    S, M = start.shape
    dev = start.device
    lens = (end.long() - start.long()).clamp_min(0).t()        # (M, S)
    row_len = lens.sum(1)
    row_base = torch.cumsum(row_len, 0) - row_len
    keys = (row_base[:, None] + torch.cumsum(lens, 1) - lens).reshape(-1)
    p_row = split.row.long()
    f0 = split.piece.long() * split.cap
    cnt = (row_len[p_row] - f0).clamp(0, split.cap)
    piece = torch.repeat_interleave(torch.arange(p_row.numel(), device=dev),
                                    cnt)
    f = (f0[piece] + torch.arange(piece.numel(), device=dev)
         - (torch.cumsum(cnt, 0) - cnt)[piece])
    q = row_base[p_row[piece]] + f
    k = torch.searchsorted(keys, q, right=True) - 1            # m * S + s
    s = k % S
    e = start.t().reshape(-1)[k].long() + (q - keys[k])
    return piece, s, e


def spmm_spans_piecewise(start, end, idx, value, base, src,
                         split: Optional[RowSplit], out_dtype=None):
    """Plain version of a split :func:`~.spmm_spans_cuda.spmm_spans_cuda`
    launch that follows ``split``: each piece's partial over its own edges,
    then each split row's partials added in piece order. Equal to
    ``spmm_spans_reference`` up to rounding, so the tests check the table's
    arithmetic on the CPU with it. Sums in f32 (f64 when ``src`` or
    ``value`` is); no windows, for small inputs."""
    if split is None:
        from .spmm_spans_cuda import spmm_spans_reference
        return spmm_spans_reference(start, end, idx, value, base, src,
                                    out_dtype)
    acc = (torch.float64 if torch.float64 in (
        src.dtype, None if value is None else value.dtype) else torch.float32)
    out_dtype = out_dtype or (src.dtype if value is None else
                              torch.promote_types(value.dtype, src.dtype))
    piece, s, e = _piece_edges(start, end, split)
    r = e if idx is None else idx[e].long()
    if base is not None:
        r = r + base.long()[s]
    prod = src[r].to(acc)
    if value is not None:
        prod *= value[e, None].to(acc)
    part = torch.zeros((split.row.numel(), src.shape[1]), dtype=acc,
                       device=src.device).index_add_(0, piece, prod)
    out = torch.zeros((split.num_rows, src.shape[1]), dtype=acc,
                      device=src.device)
    one = split.slot < 0
    out[split.row[one].long()] = part[one]
    fold_pieces_reference(split, part[~one], out)   # partials in slot order
    return out.to(out_dtype)


def sddmm_spans_piecewise(start, end, col, base, g, x,
                          split: Optional[RowSplit],
                          out_dtype=torch.float32):
    """Plain version of a split :func:`~.sddmm_cuda.sddmm_spans_cuda`
    launch that follows ``split``: each piece takes the dot of its row of
    ``g`` (from the table) with the sources of its own edges. Sums in f32
    (f64 when ``g`` or ``x`` is); no windows, for small inputs."""
    if split is None:
        from .sddmm_cuda import sddmm_spans_reference
        return sddmm_spans_reference(start, end, col, base, g, x, out_dtype)
    acc = (torch.float64 if torch.float64 in (g.dtype, x.dtype)
           else torch.float32)
    piece, s, e = _piece_edges(start, end, split)
    c = col[e].long()
    if base is not None:
        c = c + base.long()[s]
    out = torch.zeros(col.numel(), dtype=acc, device=x.device)
    out[e] = (g[split.row.long()[piece]].to(acc) * x[c].to(acc)).sum(1)
    return out.to(out_dtype)

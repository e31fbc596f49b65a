"""GAT's attention weights on the card (``csrc/gat_attention.cu``): per node
the head scores ``s_dst = hw . a_dst`` and ``s_src = hw . a_src``, then for
each entry ``e`` of row ``i`` the logit ``leaky_relu(s_dst[i] + s_src[col[e]],
slope)`` and its softmax over the row's entries, in two kernels.

It replaces no TPU kernel: the JAX package's GAT leaves its scores and
``edge_softmax`` to XLA, which fuses them into about two passes over the
edge stream; the port's plain torch version
(``models/gcn.py::gat_attention_reference``) takes some twenty passes of
``(E, H)`` arrays a layer. :func:`gat_scores_cuda` launches the node
scores, :func:`gat_softmax_cuda` the edge pass, and
:func:`gat_attention_cuda` the two in turn; the caller opens any spans.

The weights come back as the ``(E, H)`` view of an ``(H, E)`` buffer, so
head ``k``'s weights ``att[:, k]`` are contiguous; padding entries (past
``rowptr[M]``) hold 0. Rows longer than the piece table's cap run one warp a
piece, their partial (max, sum) folded in a fixed order
(``ops/kernels/row_split.py``): no atomics, so two launches give the same
bits. f32 or f64 throughout, as the scores' arithmetic.
"""
from typing import Optional, Tuple

import torch

from . import _build
from .row_split import RowSplit, resolve_split

DTYPES = (torch.float32, torch.float64)


def _on_cuda(t):
    if t.device.type != "cuda":
        raise ValueError(f"gat_attention_cuda runs on cuda, not {t.device}")


def _check_scores(hw, a_src, a_dst):
    for name, t in (("a_src", a_src), ("a_dst", a_dst)):
        if t.device != hw.device:
            raise ValueError(f"gat_attention_cuda: {name} is on {t.device}, "
                             f"hw on {hw.device}")
    if hw.dim() != 3 or a_src.shape != hw.shape[1:] \
            or a_dst.shape != hw.shape[1:]:
        raise ValueError(f"gat_attention_cuda: hw must be (N, H, D) and "
                         f"a_src, a_dst (H, D), got {tuple(hw.shape)}, "
                         f"{tuple(a_src.shape)}, {tuple(a_dst.shape)}")
    if hw.dtype not in DTYPES or a_src.dtype != hw.dtype \
            or a_dst.dtype != hw.dtype:
        raise TypeError(f"gat_attention_cuda takes f32 or f64 hw, a_src and "
                        f"a_dst of one dtype, got {hw.dtype}, {a_src.dtype}, "
                        f"{a_dst.dtype}")
    if hw.numel() >= 2 ** 31:
        raise ValueError("gat_attention_cuda indexes with int32: N * H * D "
                         "must be below 2**31")


def _check_edges(rowptr, col, s_dst, s_src):
    for name, t in (("rowptr", rowptr), ("col", col), ("s_src", s_src)):
        if t.device != s_dst.device:
            raise ValueError(f"gat_attention_cuda: {name} is on {t.device}, "
                             f"s_dst on {s_dst.device}")
    if s_dst.dim() != 2 or s_src.shape != s_dst.shape:
        raise ValueError(f"gat_attention_cuda: s_dst and s_src must be one "
                         f"(N, H) shape, got {tuple(s_dst.shape)}, "
                         f"{tuple(s_src.shape)}")
    if s_dst.dtype not in DTYPES or s_src.dtype != s_dst.dtype:
        raise TypeError(f"gat_attention_cuda takes f32 or f64 scores of one "
                        f"dtype, got {s_dst.dtype}, {s_src.dtype}")
    if rowptr.dim() != 1 or rowptr.numel() < 1 or col.dim() != 1:
        raise ValueError("gat_attention_cuda: rowptr must be 1-D and "
                         "non-empty, col 1-D")
    for name, t in (("rowptr", rowptr), ("col", col)):
        if t.dtype not in (torch.int32, torch.int64):
            raise TypeError(f"gat_attention_cuda: {name} must be int32 or "
                            f"int64, got {t.dtype}")
    if rowptr.numel() - 1 > s_dst.shape[0]:
        raise ValueError(f"gat_attention_cuda: {rowptr.numel() - 1} rows "
                         f"but scores of {s_dst.shape[0]} nodes")
    if col.numel() >= 2 ** 31:
        raise ValueError("gat_attention_cuda indexes with int32: the entries "
                         "must be below 2**31")


def gat_scores_cuda(hw: torch.Tensor, a_src: torch.Tensor,
                    a_dst: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(s_dst, s_src)``, the ``(N, H)`` scores ``hw . a_dst`` and ``hw .
    a_src`` of ``hw`` (``(N, H, D)``; ``a_src``, ``a_dst`` ``(H, D)``; CUDA
    f32 or f64), through the node-score kernel: ``hw`` read once."""
    _on_cuda(hw)
    _check_scores(hw, a_src, a_dst)
    N, H, D = hw.shape
    hw, a_src, a_dst = hw.contiguous(), a_src.contiguous(), a_dst.contiguous()
    s_dst = torch.empty((N, H), dtype=hw.dtype, device=hw.device)
    s_src = torch.empty_like(s_dst)
    if N:
        _build.launch("gat_node_scores", _build.load_library()
                      .psp_gat_node_scores, hw.device, hw.data_ptr(),
                      a_src.data_ptr(), a_dst.data_ptr(), s_src.data_ptr(),
                      s_dst.data_ptr(), N, H, D, _build.dtype_code(hw.dtype))
    return s_dst, s_src


def gat_softmax_cuda(rowptr: torch.Tensor, col: torch.Tensor,
                     s_dst: torch.Tensor, s_src: torch.Tensor,
                     negative_slope: float, split: Optional[RowSplit]
                     ) -> torch.Tensor:
    """The ``(E, H)`` weights (``E`` = ``col.numel()``, the capacity), the
    view of an ``(H, E)`` buffer: each row's softmax of ``leaky_relu(s_dst[
    row] + s_src[col], negative_slope)``, 0 past ``rowptr[M]``, through the
    edge pass (with split rows a fold and a write pass after it).
    ``rowptr`` (M+1,) is the CSR pointer of the real entries (M <= N) and
    every ``col[e]`` below ``rowptr[M]`` lies in ``[0, N)``; ``split`` is
    ``rowptr``'s piece table (``PaddedCOO.row_split()``) or None. Adds one
    to ``gat_attention_cuda.launches``."""
    _on_cuda(s_dst)
    _check_edges(rowptr, col, s_dst, s_src)
    H = s_dst.shape[1]
    M, E = rowptr.numel() - 1, col.numel()
    rowptr = rowptr.to(torch.int32).contiguous()
    col = col.to(torch.int32).contiguous()
    s_dst, s_src = s_dst.contiguous(), s_src.contiguous()
    split = resolve_split(split, rowptr[None, :-1], rowptr[None, 1:])
    dev = s_dst.device
    buf = torch.empty((H, E), dtype=s_dst.dtype, device=dev)
    if split is None:
        table, ws = (None, None, None, 0, 0, None, 0), None
    else:
        ws = torch.empty((split.num_slots, H, 2), dtype=s_dst.dtype,
                         device=dev)
        table = (split.row.data_ptr(), split.piece.data_ptr(),
                 split.slot.data_ptr(), split.row.numel(), split.cap,
                 split.fold_ptr.data_ptr(), split.fold_row.numel())
    if M:
        _build.launch("gat_edge_softmax",
                      _build.load_library().psp_gat_edge_softmax, dev,
                      rowptr.data_ptr(), col.data_ptr(), s_dst.data_ptr(),
                      s_src.data_ptr(), buf.data_ptr(), E, M, H,
                      float(negative_slope), _build.dtype_code(s_dst.dtype),
                      *table, None if ws is None else ws.data_ptr())
    else:
        buf.zero_()
    gat_attention_cuda.launches += 1
    return buf.t()


def gat_attention_cuda(rowptr: torch.Tensor, col: torch.Tensor,
                       hw: torch.Tensor, a_src: torch.Tensor,
                       a_dst: torch.Tensor, negative_slope: float,
                       split: Optional[RowSplit]
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(att, s_dst, s_src)`` of one GAT layer: :func:`gat_scores_cuda`,
    then :func:`gat_softmax_cuda` (its arguments and what each returns).
    Launches the kernels or raises: there is no CPU path here (the plain
    version, ``models/gcn.py::gat_attention_reference``, needs the whole
    ``PaddedCOO``). ``gat_attention_cuda.launches`` counts edge passes, one
    a layer."""
    s_dst, s_src = gat_scores_cuda(hw, a_src, a_dst)
    return (gat_softmax_cuda(rowptr, col, s_dst, s_src, negative_slope,
                             split), s_dst, s_src)


gat_attention_cuda.launches = 0

"""CSR SpMM (sum) on the card: ``out[m] = sum_e value[e] * x[col[e]]`` over
``rowptr[m] <= e < rowptr[m+1]``.

Port of ``paddle_sparse_tpu/ops/kernels/spmm_pallas.py::spmm_pallas``, which
gathers and scales ``x`` rows with XLA and row-sums the product stream with the
Pallas kernel ``_reduce_kernel``. Here one hand-written CUDA kernel does the
gather, the scale and the row-sum: the multi-span kernel of
``csrc/spmm_spans.cu`` with one span per row (S = 1, ``start = rowptr[:-1]``,
``end = rowptr[1:]``), which walks a CSR row in edge order.

Dtype contract, as in ``paddle_sparse_tpu/ops/spmm.py::spmm_coo``: the
output has the promoted dtype of ``value`` and ``x``. Floats (f32, bf16, f16
or f64) are each read in their own dtype (an f16 ``x`` with an f32 ``value``
is gathered as f16 and writes f32: no f32 copy of ``x``); sums are taken in
f32 and rounded once on the store, or in f64 when the output is f64, in the
kernel and in the plain version alike. Integers (int8, int16, int32, int64,
uint8, and bool beside an int) sum exactly: products and sums in int64, the
result cast to the promoted dtype, which truncates mod 2**bits and so equals
JAX's sum wrapped at every add (the ring arithmetic agrees). The kernel reads
int32 and int64; the wrapper casts a narrower int or a bool to int32 and the
result back. A mixed int/float pair is summed as the promoted float by the
plain version; the kernel refuses it (``TypeError``): the entry,
``ops/spmm.py``, casts such a pair to the float first, as JAX casts both.
bool with bool (or ``None`` with a bool ``x``) raises ``TypeError``, as
JAX's add does. ``value=None`` means implicit ones; any K works. A row of more than ``row_split.CAP`` edges is cut
into pieces, one warp each, whose partials a second pass sums
(``ops/kernels/row_split.py``).

Strided operands: ``x`` may be a view whose rows are contiguous and lie
further apart than K (last stride 1, row stride at least K), as one head
``hw[:, k]`` of GAT's (N, H, D) operand is; and ``out=`` takes such a view
to write into, as one head of the layer's (M, H, D) output. The kernel
reads and writes them in place at their row strides; no copy is made.
"""
from typing import Optional

import torch

from ._build import FLOAT_DTYPES
from .row_split import AUTO, launch_spmm_spans, resolve_split, sum_dtype

# the integer dtypes the kernel reads; narrower ints are cast to int32
INT_DTYPES = (torch.int32, torch.int64)

# edges per window of the plain version: bounds its (window, K) product
# stream to about 1 GiB, so it never builds the whole (nnz, K) stream
_WINDOW_BYTES = 1 << 30


def _out_dtype(value: Optional[torch.Tensor], x: torch.Tensor) -> torch.dtype:
    out = x.dtype if value is None else torch.promote_types(value.dtype,
                                                            x.dtype)
    if out == torch.bool:
        raise TypeError("spmm does not sum bool operands (JAX's add refuses "
                        "bool): give value or x a numeric dtype")
    return out


def kernel_operands(value: Optional[torch.Tensor], x: torch.Tensor):
    """``(value, x, out_dtype)`` as K1 reads them: for an integer output an
    int32 or int64 pair (a narrower int or a bool cast to int32), anything
    else as it is; ``out_dtype`` the promoted dtype of the originals."""
    out = _out_dtype(value, x)
    if out.is_floating_point:
        return value, x, out
    if value is not None and value.dtype not in INT_DTYPES:
        value = value.to(torch.int32)
    if x.dtype not in INT_DTYPES:
        x = x.to(torch.int32)
    return value, x, out


def check_spmm_dtypes(fn: str, src: torch.dtype,
                      value: Optional[torch.dtype], out: torch.dtype) -> None:
    """The dtypes ``csrc/spmm_spans.cu`` takes: ``src`` and ``value`` each
    f32, bf16, f16 or f64; ``out`` f64, or f32 from a src other than f64,
    or src's own dtype, and f64 whenever an input is (the sum's type follows
    ``out``). Or integers: ``src`` and ``value`` int32 or int64 and ``out``
    their promoted dtype (the sum in int64). Raises ``TypeError`` on
    anything else."""
    if src in INT_DTYPES or value in INT_DTYPES or out in INT_DTYPES:
        if (src not in INT_DTYPES or value not in INT_DTYPES + (None,)
                or out != (src if value is None
                           else torch.promote_types(src, value))):
            raise TypeError(f"{fn} sums int32/int64 src and value into "
                            f"their promoted int: not {src} x {value} -> "
                            f"{out}")
        return
    for name, dt in (("src", src), ("value", value)):
        if dt is not None and dt not in FLOAT_DTYPES:
            raise TypeError(f"{fn} takes f32, bf16, f16 or f64 {name}, got "
                            f"{dt}")
    if not (out == torch.float64 or out == src
            or (out == torch.float32 and src != torch.float64)):
        raise TypeError(f"{fn} writes f64, f32 (from a src narrower than "
                        f"f64) or src's own dtype; not {out} from {src}")
    if value == torch.float64 and out != torch.float64:
        raise TypeError(f"{fn} sums an f64 value in f64: out must be f64, "
                        f"not {out}")


def spmm_csr_reference(rowptr: torch.Tensor, col: torch.Tensor,
                       value: Optional[torch.Tensor],
                       x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`spmm_csr_cuda`, on any device.

    Processes the edges in bounded windows (gather, scale, ``index_add_``),
    accumulating in f32, in f64 when the promoted dtype is f64, and in int64
    when it is an int (then cast, which wraps as JAX's int sum does)."""
    M, K = rowptr.numel() - 1, x.shape[1]
    out_dtype = _out_dtype(value, x)
    acc_dtype = sum_dtype(out_dtype)
    out = torch.zeros((M, K), dtype=acc_dtype, device=x.device)
    rowptr = rowptr.long()
    e_begin, e_end = int(rowptr[0]), int(rowptr[-1])
    step = max(1, _WINDOW_BYTES // max(1, K * out.element_size()))
    for s in range(e_begin, e_end, step):
        t = min(s + step, e_end)
        edges = torch.arange(s, t, device=x.device)
        rows = torch.searchsorted(rowptr, edges, right=True) - 1
        prod = x[col[s:t].long()].to(acc_dtype)
        if value is not None:
            prod *= value[s:t, None].to(acc_dtype)
        out.index_add_(0, rows, prod)
    return out.to(out_dtype)


def _rows_contiguous(t: torch.Tensor) -> bool:
    """A 2-D tensor whose rows the kernel reads at a row stride: last
    stride 1 and rows at least K apart (where more than one of each)."""
    return (t.dim() == 2 and (t.shape[1] <= 1 or t.stride(1) == 1)
            and (t.shape[0] <= 1 or t.stride(0) >= t.shape[1]))


def _span(t: torch.Tensor):
    """The bytes ``[lo, hi)`` a non-empty 2-D tensor's elements lie in."""
    last = sum((n - 1) * st for n, st in zip(t.shape, t.stride()))
    return t.data_ptr(), t.data_ptr() + (last + 1) * t.element_size()


def _check_out(out: torch.Tensor, x: torch.Tensor, M: int,
               dtype: torch.dtype) -> None:
    """What ``out=`` takes: an (M, K) tensor of the output's dtype on x's
    device, rows contiguous, whose memory does not meet x's."""
    K = x.shape[1]
    if out.device != x.device:
        raise ValueError(f"out is on {out.device}, x on {x.device}")
    if out.dtype != dtype:
        raise TypeError(f"out must have the output's dtype {dtype}, got "
                        f"{out.dtype}")
    if not (dtype.is_floating_point or dtype in INT_DTYPES):
        raise TypeError(f"out= takes the kernel's own output dtype: int32, "
                        f"int64 or a float, not {dtype}")
    if tuple(out.shape) != (M, K) or not _rows_contiguous(out):
        raise ValueError(f"out must be an ({M}, {K}) tensor with last stride "
                         f"1 and row stride at least {K}, got shape "
                         f"{tuple(out.shape)} strides {out.stride()}")
    if out.numel() and x.numel():
        (a0, a1), (b0, b1) = _span(out), _span(x)
        if a0 < b1 and b0 < a1:
            raise ValueError("out overlaps x in memory")


def _check_cuda_args(rowptr, col, value, x):
    dev = x.device
    for name, t in (("rowptr", rowptr), ("col", col), ("value", value)):
        if t is not None and t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
    if not _rows_contiguous(x):
        raise ValueError(f"x must be a 2-D tensor with last stride 1 and row "
                         f"stride at least its width, got shape "
                         f"{tuple(x.shape)} strides {x.stride()}")
    check_spmm_dtypes("spmm_csr_cuda", x.dtype,
                      None if value is None else value.dtype,
                      _out_dtype(value, x))
    if rowptr.dim() != 1 or rowptr.numel() < 1 or col.dim() != 1:
        raise ValueError("rowptr and col must be 1-D, rowptr non-empty")
    for name, t in (("rowptr", rowptr), ("col", col)):
        if t.dtype not in (torch.int32, torch.int64):
            raise TypeError(f"{name} must be int32 or int64, got {t.dtype}")
    if max(col.numel(), x.shape[0], x.shape[1], x.stride(0),
           rowptr.numel()) >= 2 ** 31:
        raise ValueError("spmm_csr_cuda indexes with int32: nnz, N, K, M "
                         "and x's row stride must each be below 2**31")
    if value is not None:
        if value.shape != col.shape:
            raise ValueError(f"value shape {tuple(value.shape)} != col shape "
                             f"{tuple(col.shape)}")


def spmm_csr_cuda(rowptr: torch.Tensor, col: torch.Tensor,
                  value: Optional[torch.Tensor], x: torch.Tensor,
                  split=AUTO, out: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """CSR SpMM through the CUDA kernel ``csrc/spmm_spans.cu`` at S = 1.

    ``rowptr`` (M+1,) is a canonical CSR pointer into ``col``/``value``;
    ``x`` is an (N, K) f32, bf16, f16 or f64 tensor, rows contiguous (last
    stride 1, row stride at least K: a column slice of a wider array is
    read in place), ``value``
    (any of those dtypes, read as it is) or None, or both integers
    (:func:`kernel_operands`: int32 and int64 read as they are, narrower
    ints cast to int32, the sum in int64 and the result cast to the
    promoted dtype), and every ``col[e]`` with ``e < rowptr[M]`` lies in
    ``[0, N)``. ``split`` is the pointer's
    :class:`~.row_split.RowSplit` (``PaddedCOO`` caches it), ``None`` when
    no row is longer than its cap, or ``"auto"`` to build it here (one host
    read of the longest row). ``out``, if given, is the (M, K) tensor
    written and returned: the output's dtype (the kernel's own: a float,
    int32 or int64), rows contiguous as ``x``'s, its memory apart from
    ``x``'s. On a CPU tensor this runs :func:`spmm_csr_reference`; on a
    CUDA tensor it launches the kernel or raises.
    ``spmm_csr_cuda.launches`` counts kernel launches and
    ``spmm_csr_cuda.strided`` those of them whose ``x`` or ``out`` was not
    contiguous."""
    M = rowptr.numel() - 1
    if out is not None:
        _check_out(out, x, M, _out_dtype(value, x))
    if x.device.type == "cpu":
        res = spmm_csr_reference(rowptr, col, value, x)
        return res if out is None else out.copy_(res)
    if x.device.type != "cuda":
        raise ValueError(f"spmm_csr_cuda runs on cpu or cuda, not {x.device}")
    value, x, want = kernel_operands(value, x)
    _check_cuda_args(rowptr, col, value, x)
    out_dtype = _out_dtype(value, x)
    K = x.shape[1]
    strided = not x.is_contiguous() or (out is not None
                                        and not out.is_contiguous())
    if out is None:
        out = torch.empty((M, K), dtype=out_dtype, device=x.device)
    if M == 0 or K == 0:
        return out.to(want)
    rowptr = rowptr.to(torch.int32).contiguous()
    col = col.to(torch.int32).contiguous()
    if value is not None:
        value = value.contiguous()
    start, end = rowptr[None, :-1], rowptr[None, 1:]
    launch_spmm_spans("spmm_csr", start, end, col, value, None, x, out,
                      resolve_split(split, start, end))
    spmm_csr_cuda.launches += 1
    spmm_csr_cuda.strided += strided
    return out if out_dtype == want else out.to(want)


spmm_csr_cuda.launches = 0
spmm_csr_cuda.strided = 0

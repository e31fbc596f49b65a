"""The window plan of the windowed CSR SpMM (``csrc/spmm_window.cu``): which
tiles of output rows read enough of one window of ``x`` rows to stage that
window in shared memory.

K1 (``csrc/spmm_spans.cu`` at one span per row) reads the source row of
every edge from device memory, or from L2 when a neighbouring warp read it
shortly before. On a graph with locality (a clustered graph, or one
renumbered by ``partition`` or ``reverse_cuthill_mckee``) the rows of a tile
of consecutive output rows read mostly the rows of one short range of
``x``. The windowed kernel gives each such tile one block per slice of
columns, copies the range, the tile's *window*, into shared memory once,
and serves every edge that falls inside it from there.

The plan, in plain torch on the matrix's device:

* the rows are cut into tiles of ``tile_rows`` consecutive rows;
* each tile gets the window ``[w0, w0 + window_rows)`` that holds the most
  of its edges: the smallest edge column ``c`` whose ``[c, c + W)`` does,
  moved down to ``N - W`` when it would reach past ``N`` (not below 0);
* a tile is flagged when its in-window edges are at least
  :data:`MIN_GAIN` times ``window_rows`` and it holds no piece of a split
  row (``RowSplit``: a hub row keeps its pieces and its fold).

``window_rows`` is the number of ``x`` rows whose slice of
:data:`WINDOW_ROW_BYTES` (32 f32 or 64 bf16 columns) fills the shared
memory a block may have, so one plan serves both dtypes and every K.
Whether a launch may use the plan depends on the call: :func:`applies`.

No path of the port builds a plan: the windowed kernel beat the register
walk at no setting measured on an H100 (``PERF.md``: ``bench.py``'s
clustered graph, 68% of the edges in their windows, at K=256 f32, K=100
f32 and K=256 bf16). It walks the edge list once per 32-column chunk and
loads 4 bytes a lane, where the register walk loads 16 for all of a row's
columns and L2 serves its rows. The plan and the kernel are called
directly (``spmm_window_cuda``).
"""
from typing import NamedTuple, Optional

import torch

from .row_split import RowSplit

# bytes of one window row in shared memory: 32 f32 or 64 bf16 columns,
# so that a warp's 32 lanes read one row with one 4-byte access each
WINDOW_ROW_BYTES = 128
# rows per TMA box (csrc/spmm_window.cu): windows are whole boxes
BOX_ROWS = 64
# window rows: 221,184 bytes, and the kernel's 8,192 of stage, inside the
# 232,448 a block may have
WINDOW_ROWS = 27 * BOX_ROWS
# consecutive output rows per tile
TILE_ROWS = 2048
# A tile is flagged only when its in-window edges are at least MIN_GAIN x
# its window's rows: the copy reads each window row once, which the tile's
# gather would not otherwise read, so below 2 W it costs more row reads
# than it saves.
MIN_GAIN = 2


class RowWindow(NamedTuple):
    """The window plan of a CSR pointer, from :func:`window_plan`."""
    w0: torch.Tensor          # (n_tiles,) int32: each tile's window start
    in_window: torch.Tensor   # (n_tiles,) int64: its edges in the window
    edges: torch.Tensor       # (n_tiles,) int64: its edges
    flagged: torch.Tensor     # (n_tiles,) bool
    tiles: torch.Tensor       # (F,) int32: the flagged tiles, ascending
    tile_w0: torch.Tensor     # (F,) int32: their window starts
    num_rows: int
    num_cols: int
    tile_rows: int
    window_rows: int


def best_windows(rowptr: torch.Tensor, col: torch.Tensor, num_cols: int,
                 tile_rows: int = TILE_ROWS, window_rows: int = WINDOW_ROWS):
    """``(w0, in_window, edges)``, int64, of every tile of ``tile_rows``
    rows of the CSR ``(rowptr, col)`` with columns in ``[0, num_cols)``:
    the window start as the module says, the tile's edges in ``[w0, w0 +
    window_rows)`` and all its edges. One sort of the ``(tile, col)`` keys
    of every edge and three binary searches over them."""
    if tile_rows < 1 or window_rows < 1:
        raise ValueError(f"tile_rows and window_rows must be positive, got "
                         f"{tile_rows} and {window_rows}")
    M, W, dev = rowptr.numel() - 1, window_rows, col.device
    n_tiles = -(-M // tile_rows)
    rp = rowptr.long()
    tile_ptr = rp[(torch.arange(n_tiles + 1, device=dev) * tile_rows)
                  .clamp_(max=M)]
    edges = tile_ptr[1:] - tile_ptr[:-1]
    e0, nnz = int(rp[0]), int(rp[-1] - rp[0])
    # each tile's keys lie in [t * span, t * span + num_cols), more than W
    # below the next tile's, so [key, key + W) stays inside its tile
    span = num_cols + W
    base = torch.arange(n_tiles, device=dev) * span
    tile = torch.repeat_interleave(torch.arange(n_tiles, device=dev), edges,
                                   output_size=nnz)
    key = torch.sort(base[tile] + col[e0:e0 + nnz]).values
    # edges in [key, key + W) for each key; the best of each tile, and the
    # first (smallest) key that reaches it
    count = torch.searchsorted(key, key + W)
    count -= torch.arange(nnz, device=dev)
    best = torch.zeros(n_tiles, dtype=torch.long, device=dev)
    best.scatter_reduce_(0, tile, count, "amax")
    start = torch.where(count == best[tile], key - base[tile], num_cols)
    del count
    first = torch.full((n_tiles,), num_cols, dtype=torch.long, device=dev)
    first.scatter_reduce_(0, tile, start, "amin")
    del start, tile
    w0 = first.clamp_(max=num_cols - W).clamp_(min=0)
    in_window = (torch.searchsorted(key, base + w0 + W)
                 - torch.searchsorted(key, base + w0))
    return w0, in_window, edges


def window_plan(rowptr: torch.Tensor, col: torch.Tensor, num_cols: int,
                split: Optional[RowSplit] = None,
                tile_rows: int = TILE_ROWS,
                window_rows: int = WINDOW_ROWS) -> RowWindow:
    """The :class:`RowWindow` of the CSR ``(rowptr, col)`` over ``x`` of
    ``num_cols`` rows, whose piece table is ``split`` (``None``: no row
    longer than its cap). Built on ``col``'s device; a few host reads."""
    M, dev = rowptr.numel() - 1, col.device
    w0, in_window, edges = best_windows(rowptr, col, num_cols, tile_rows,
                                        window_rows)
    flagged = in_window >= MIN_GAIN * window_rows
    if split is not None and split.fold_row.numel():
        flagged[split.fold_row.long() // tile_rows] = False
    tiles = torch.nonzero(flagged).squeeze(1)
    i32 = torch.int32
    return RowWindow(w0=w0.to(i32), in_window=in_window, edges=edges,
                     flagged=flagged, tiles=tiles.to(i32),
                     tile_w0=w0[tiles].to(i32), num_rows=M,
                     num_cols=num_cols, tile_rows=tile_rows,
                     window_rows=window_rows)


def applies(plan: Optional[RowWindow], x: torch.Tensor) -> bool:
    """Whether the windowed kernel may run ``plan`` over ``x``: the plan
    flags a tile, ``x`` is f32 or bf16, its rows start on 16-byte
    boundaries, as a TMA copy needs (``K * elt`` a multiple of 16 and
    ``x`` 16-byte aligned), and it holds fewer than 2**31 32-bit words (the
    kernel's offsets into it are 32-bit)."""
    if plan is None or not plan.tiles.numel():
        return False
    if x.dtype not in (torch.float32, torch.bfloat16):
        return False
    return (x.shape[1] * x.element_size()) % 16 == 0 \
        and x.data_ptr() % 16 == 0 and x.numel() * x.element_size() < 2 ** 33

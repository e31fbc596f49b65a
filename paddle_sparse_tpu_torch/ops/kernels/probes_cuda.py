"""The five TPU probe kernels of ``experiments/`` on the card, each beside
its plain PyTorch version.

Each ``*_cuda`` wrapper launches one kernel of ``csrc/probes.cu`` on a CUDA
tensor (or raises: there is no fallback) and runs its ``*_reference`` on a
CPU tensor; ``<wrapper>.launches`` counts the kernel's launches. The
references are plain torch on any device, for the tests and for
``chip_smoke.py``; they sum in f32, or in f64 when the input is f64.

=================  =====================================================
``scale2``         ``experiments/bisect_pallas.py:23`` (``trivial``)
``chunk_sum``      ``bisect_pallas.py:38`` (``dma_copy``)
``span_colsum``    ``experiments/r4_dma_issue.py:44`` (``run``): each
                   covered row once, through a piece plan; its staged form
                   (``span_colsum_staged_cuda``) one CTA per step
``band_ablate``    ``experiments/r4_band_cost.py:181/201/217`` (nodot,
                   nosel, empty; full and untrans are K4's function and run
                   on ``band_reduce_call``)
``slice_gather``   ``experiments/r5_vmem_expand.py:56`` (``make_call``):
                   write per chunk, reduce through each chunk's row counts
                   over an item plan
=================  =====================================================

The probes' own entry points are ``paddle_sparse_tpu_torch/experiments/``.
"""
from typing import NamedTuple, Optional

import torch

from . import _build
from .spmm_cuda import _WINDOW_BYTES

TILE_ROWS = 128                           # band_ablate's output tile (R)
ABLATE_MODES = ("nodot", "nosel", "empty")
SLICE_VARIANTS = ("onehot_write", "onehot_reduce")
_SLICE_COLS = 128                         # slice_gather's columns per CTA
PIECE_ROWS = 256          # span_colsum's rows of a piece at most (P)
ITEM_CHUNKS = 32          # slice_gather reduce's chunks of a work item (G)
_PART_COLS = 32           # slice_gather reduce's columns of a slice part
_BLOCK_SMEM = 232448      # shared memory a block may have (227 KB)


def _acc_dtype(t: torch.Tensor) -> torch.dtype:
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def _on_card(fn: str, t: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if t.is_cuda:
        return True
    if t.device.type != "cpu":
        raise ValueError(f"{fn} runs on cpu or cuda, not {t.device}")
    return False


def _check_same_device(fn: str, dev, **tensors) -> None:
    for name, t in tensors.items():
        if t is not None and t.device != dev:
            raise ValueError(f"{fn}: {name} is on {t.device}, not {dev}")


def _aligned(*tensors) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def _index32(fn: str, name: str, t: torch.Tensor) -> torch.Tensor:
    """``t`` as a contiguous 1-D int32 tensor: itself when it is one, a flat
    view when it is a contiguous int32 tensor of another shape."""
    if t.dtype == torch.int32 and t.is_contiguous():
        return t if t.dim() == 1 else t.view(-1)
    if t.dtype != torch.int64 and t.dtype != torch.int32:
        raise TypeError(f"{fn}: {name} must be int32 or int64, got {t.dtype}")
    return t.reshape(-1).to(torch.int32).contiguous()


# ---- P1: scale2 -------------------------------------------------------------

def scale2_reference(x: torch.Tensor) -> torch.Tensor:
    """``2 * x``: ``bisect_pallas.py::trivial``'s kernel."""
    return x * 2


def scale2_cuda(x: torch.Tensor) -> torch.Tensor:
    """``2 * x`` over an f32 tensor of any shape through ``psp_scale2``."""
    if not _on_card("scale2_cuda", x):
        return scale2_reference(x)
    if x.dtype != torch.float32:
        raise TypeError(f"scale2_cuda takes f32, got {x.dtype}")
    if not x.is_contiguous():
        x = x.contiguous()
    out = torch.empty_like(x)
    n = x.numel()
    if n:
        _build.launch("scale2", _build.load_library().psp_scale2, x.device,
                      x.data_ptr(), out.data_ptr(), n)
        scale2_cuda.launches += 1
    return out


scale2_cuda.launches = 0


# ---- P2: chunk_sum ----------------------------------------------------------

def chunk_sum_reference(ptr: torch.Tensor, src: torch.Tensor,
                        E: int) -> torch.Tensor:
    """``out[t * E + i] = sum_{ptr[t] <= c < ptr[t+1]} src[c * E + i]``,
    (T * E, K), the chunks added in ascending ``c`` from 0 (so in f32 the
    same bits as the kernel). One host read of the longest tile."""
    T, K = ptr.numel() - 1, src.shape[1]
    p = ptr.to(src.device, torch.int64)
    lens = p[1:] - p[:-1]
    chunks = src.reshape(-1, E, K)
    out = torch.zeros((T, E, K), dtype=_acc_dtype(src), device=src.device)
    for j in range(int(lens.max()) if T else 0):
        live = lens > j
        out[live] += chunks[(p[:-1] + j)[live]].to(out.dtype)
    return out.reshape(T * E, K)


def chunk_sum_cuda(ptr: torch.Tensor, src: torch.Tensor, E: int,
                   double_buffer: bool) -> torch.Tensor:
    """:func:`chunk_sum_reference` through ``psp_chunk_sum``: one CTA per
    (tile, 16 KB block of the tile), staging its block of each chunk
    through a shared-memory ring of 2 slots (``double_buffer``) or 1.
    ``src`` is a contiguous, 16-byte aligned (L, K) f32 tensor with
    ``E * K`` a multiple of 4 and ``ptr[T] * E <= L``; ``ptr`` (T+1,) is
    non-decreasing. Returns (T * E, K) f32."""
    if not _on_card("chunk_sum_cuda", src):
        return chunk_sum_reference(ptr, src, E)
    dev = src.device
    if ptr.device != dev:
        raise ValueError(f"chunk_sum_cuda: ptr is on {ptr.device}, not {dev}")
    if src.dtype != torch.float32 or src.dim() != 2:
        raise TypeError(f"chunk_sum_cuda takes a 2-D f32 src, got "
                        f"{src.dtype} {tuple(src.shape)}")
    if not src.is_contiguous():
        src = src.contiguous()
    T, K = ptr.numel() - 1, src.shape[1]
    if (E * K) % 4 or src.data_ptr() % 16:
        raise ValueError(f"chunk_sum_cuda stages 16-byte blocks: E * K "
                         f"({E} * {K}) must be a multiple of 4 and src "
                         f"16-byte aligned")
    if T > 65535:
        raise ValueError(f"chunk_sum_cuda takes at most 65535 tiles, got {T}")
    ptr = _index32("chunk_sum_cuda", "ptr", ptr)
    out = src.new_empty(T * E, K)
    if T > 0 and E * K > 0:
        _build.launch("chunk_sum", _build.load_library().psp_chunk_sum, dev,
                      ptr.data_ptr(), src.data_ptr(), out.data_ptr(), T,
                      E * K, 2 if double_buffer else 1)
        chunk_sum_cuda.launches += 1
    return out


chunk_sum_cuda.launches = 0


# ---- P3: span_colsum --------------------------------------------------------

def span_colsum_reference(stream: torch.Tensor, e0: torch.Tensor, NS: int,
                          CAP: int, steps: int,
                          acc: Optional[torch.dtype] = None) -> torch.Tensor:
    """Step ``t``'s column sum of the ``NS`` spans ``stream[e0[t * NS + s] :
    e0[t * NS + s] + CAP]``, (steps, K), summed in ``acc`` (default f32, f64
    for an f64 stream). Steps are summed in blocks of at most ~1 GiB of
    gathered rows, never the whole staged set at once."""
    K = stream.shape[1]
    acc = acc or _acc_dtype(stream)
    out = torch.zeros((steps, K), dtype=acc, device=stream.device)
    per_step = max(1, NS * CAP * K * torch.finfo(acc).bits // 8)
    block = max(1, _WINDOW_BYTES // per_step)
    offs = torch.arange(CAP, device=stream.device)
    starts = e0.to(stream.device, torch.int64).reshape(-1)[:steps * NS]
    for a in range(0, steps, block):
        b = min(a + block, steps)
        rows = (starts[a * NS:b * NS, None] + offs).reshape(b - a, -1)
        out[a:b] = stream[rows].to(acc).sum(1)
    return out


def _check_colsum_stream(fn: str, stream: torch.Tensor) -> torch.Tensor:
    if stream.dtype != torch.bfloat16 or stream.dim() != 2:
        raise TypeError(f"{fn} takes a 2-D bf16 stream, got {stream.dtype} "
                        f"{tuple(stream.shape)}")
    K = stream.shape[1]
    if K < 8 or K > 2048 or K & (K - 1):
        raise ValueError(f"{fn} takes K = 8, 16, ..., 2048 (16-byte row "
                         f"vectors, a power of two of them), got {K}")
    stream = stream.contiguous()
    if not _aligned(stream):
        raise ValueError(f"{fn}: stream must be 16-byte aligned")
    return stream


class SpanPieces(NamedTuple):
    """The piece plan of ``n`` spans: piece ``q < total[0]`` is the stream
    rows ``[row[q], row[q] + length[q])``; span ``i`` is the run of pieces
    ``[first[i], last[i])``. All int32 on the spans' device; ``row`` and
    ``length`` hold ``max_pieces`` entries (those from ``total`` on are 0 in
    the reference's, unwritten in the card's)."""
    row: torch.Tensor
    length: torch.Tensor
    total: torch.Tensor
    first: torch.Tensor
    last: torch.Tensor
    max_pieces: int


def span_piece_bound(n: int, CAP: int, nstream: int) -> int:
    """At most this many pieces cover ``n`` spans of ``CAP`` rows of an
    ``nstream``-row stream: each of the ``2 n - 1`` segments between sorted
    endpoints adds at most one piece to its rows / ``PIECE_ROWS``."""
    return max(0, 2 * n - 1) + min(nstream, n * CAP) // PIECE_ROWS


def _plan_ws(dev: torch.device, span: bool, n: int,
             bits: int) -> torch.Tensor:
    """The workspace of the span plan (``span``: ``2 n`` endpoints) or the
    slice plan (``n`` chunks) over keys below ``2**bits``, as large as
    ``psp_plan_ws_bytes`` says: the plan's int arrays and CUB's own size
    query for its sort and prefix sums."""
    size = _build.load_library().psp_plan_ws_bytes(int(span), n, bits)
    return torch.empty(size, dtype=torch.uint8, device=dev)


def span_pieces(e0: torch.Tensor, CAP: int, nstream: int) -> SpanPieces:
    """:func:`span_pieces_reference`'s plan, built on the card by
    ``psp_span_plan`` (a radix sort of the ``2 n`` endpoints, two prefix sums
    and three small kernels, no host read; the tables from ``total`` on are
    left unwritten) or, for a CPU ``e0``, by the reference."""
    if not _on_card("span_pieces", e0):
        return span_pieces_reference(e0, CAP, nstream)
    a = _index32("span_pieces", "e0", e0)
    n, dev = a.numel(), a.device
    if n == 0:
        return span_pieces_reference(a, CAP, nstream)
    max_pieces = span_piece_bound(n, CAP, nstream)
    buf = torch.empty(2 * max_pieces + 2 * n + 1, dtype=torch.int32,
                      device=dev)
    row, length, first, last, total = torch.split(
        buf, [max_pieces, max_pieces, n, n, 1])
    bits = max(1, nstream.bit_length())
    ws = _plan_ws(dev, True, n, bits)
    _build.launch("span_plan", _build.load_library().psp_span_plan, dev,
                  a.data_ptr(), n, CAP, bits,
                  row.data_ptr(), length.data_ptr(), total.data_ptr(),
                  first.data_ptr(), last.data_ptr(), ws.data_ptr(),
                  ws.numel())
    span_pieces.launches += 1
    return SpanPieces(row, length, total, first, last, max_pieces)


span_pieces.launches = 0


def span_pieces_reference(e0: torch.Tensor, CAP: int,
                          nstream: int) -> SpanPieces:
    """Cut the rows that the spans ``[e0[i], e0[i] + CAP)`` cover into
    pieces: between consecutive span endpoints (all ``2 n`` of them, sorted,
    repeats kept as empty segments), a segment that some span covers is cut
    into pieces of at most :data:`PIECE_ROWS` rows; rows no span covers
    belong to no piece. Every span is a run of whole pieces, in ascending
    rows. Built on ``e0``'s device with no host read, so the tables hold
    :func:`span_piece_bound` entries."""
    dev = e0.device
    a = e0.reshape(-1).to(torch.int32)
    n = a.numel()
    if n == 0:
        z = torch.zeros(0, dtype=torch.int32, device=dev)
        return SpanPieces(z, z, torch.zeros(1, dtype=torch.int32,
                                            device=dev), z, z, 0)
    P = PIECE_ROWS
    max_pieces = span_piece_bound(n, CAP, nstream)
    b = a + CAP
    s, idx = torch.sort(torch.cat([a, b]))
    cover = torch.cumsum(torch.where(idx < n, 1, -1), 0)[:-1]
    seg_len = (s[1:] - s[:-1]).to(torch.int64)
    count = torch.where(cover > 0, (seg_len + P - 1) // P, 0)
    pe = torch.cat([count.new_zeros(1), torch.cumsum(count, 0)])
    q = torch.arange(max_pieces, device=dev)
    seg = torch.searchsorted(pe[1:], q, right=True).clamp_(max=2 * n - 2)
    row = s[seg].to(torch.int64) + (q - pe[seg]) * P
    length = torch.where(q < pe[-1], (s[seg + 1] - row).clamp_(max=P), 0)
    first = pe[torch.searchsorted(s, a)]
    last = pe[torch.searchsorted(s, b)]
    i32 = torch.int32
    return SpanPieces(row.to(i32), length.to(i32), pe[-1:].to(i32),
                      first.to(i32), last.to(i32), max_pieces)


def span_colsum_pieces_reference(stream: torch.Tensor, plan: SpanPieces,
                                 NS: int, steps: int,
                                 acc: Optional[torch.dtype] = None
                                 ) -> torch.Tensor:
    """:func:`span_colsum_reference` in the plan's form, plain torch: each
    piece's column sum once, then each step's spans' pieces added (steps,
    K) in ``acc`` (default f32, f64 for an f64 stream). One host read of
    the piece count."""
    dev, K = stream.device, stream.shape[1]
    acc = acc or _acc_dtype(stream)
    total = int(plan.total[0])
    length = plan.length[:total].to(dev, torch.int64)
    piece = torch.repeat_interleave(torch.arange(total, device=dev), length)
    start = torch.cumsum(length, 0) - length
    rows = plan.row.to(dev, torch.int64)[piece] + (
        torch.arange(piece.numel(), device=dev) - start[piece])
    psum = torch.zeros((total, K), dtype=acc, device=dev).index_add_(
        0, piece, stream[rows].to(acc))
    first = plan.first.to(dev, torch.int64)[:steps * NS]
    count = plan.last.to(dev, torch.int64)[:steps * NS] - first
    span = torch.repeat_interleave(torch.arange(first.numel(), device=dev),
                                   count)
    q = first[span] + torch.arange(span.numel(), device=dev) - (
        torch.cumsum(count, 0) - count)[span]
    return torch.zeros((steps, K), dtype=acc, device=dev).index_add_(
        0, span // max(NS, 1), psum[q])


def _span_checks(fn: str, stream, e0, NS: int, CAP: int, steps: int):
    _check_same_device(fn, stream.device, e0=e0)
    stream = _check_colsum_stream(fn, stream)
    e0 = _index32(fn, "e0", e0)
    if e0.numel() < steps * NS:
        raise ValueError(f"{fn}: e0 holds {e0.numel()} starts, {steps} "
                         f"steps of {NS} spans need {steps * NS}")
    if max(steps, NS * CAP, stream.shape[0]) >= 2 ** 31:
        raise ValueError(f"{fn}: steps, NS * CAP and the stream's rows must "
                         f"each be below 2**31")
    return stream, e0


def span_colsum_cuda(stream: torch.Tensor, e0: torch.Tensor, NS: int,
                     CAP: int, steps: int) -> torch.Tensor:
    """:func:`span_colsum_reference` through ``psp_span_colsum``, reading
    each covered row once: the spans' piece plan (:func:`span_pieces`,
    built on the card), then one kernel streams every piece once through a
    4-deep ring of 16 KB bulk async copies into its (K,) f32 column sum,
    and a second adds each step's spans' piece sums, spans in order, pieces
    in ascending rows. ``stream`` is a bf16 (L, K) tensor, K a power of two
    from 8 to 2048; ``e0`` holds ``steps * NS`` row starts with every span
    inside the stream; the spans hold fewer than 2**30 endpoints and the
    plan fewer than 2**31 pieces. Takes ``max_pieces * K * 4`` bytes of
    piece sums (at K = 2048, 8 KB a piece). Returns (steps, K) f32."""
    if not _on_card("span_colsum_cuda", stream):
        return span_colsum_reference(stream, e0, NS, CAP, steps)
    stream, e0 = _span_checks("span_colsum_cuda", stream, e0, NS, CAP, steps)
    n, K = steps * NS, stream.shape[1]
    if span_piece_bound(n, CAP, stream.shape[0]) >= 2 ** 31:
        raise ValueError("span_colsum_cuda: the piece plan would hold 2**31 "
                         "pieces or more")
    out = torch.empty((steps, K), dtype=torch.float32, device=stream.device)
    if steps > 0:
        plan = span_pieces(e0[:n], CAP, stream.shape[0])
        psum = torch.empty((plan.max_pieces, K), dtype=torch.float32,
                           device=stream.device)
        _build.launch("span_colsum", _build.load_library().psp_span_colsum,
                      stream.device, stream.data_ptr(), plan.row.data_ptr(),
                      plan.length.data_ptr(), plan.total.data_ptr(),
                      plan.max_pieces, plan.first.data_ptr(),
                      plan.last.data_ptr(), psum.data_ptr(), out.data_ptr(),
                      steps, NS, K)
        span_colsum_cuda.launches += 1
    return out


span_colsum_cuda.launches = 0


def span_colsum_staged_cuda(stream: torch.Tensor, e0: torch.Tensor, NS: int,
                            CAP: int, steps: int) -> torch.Tensor:
    """:func:`span_colsum_reference` through ``psp_span_colsum_staged``, the
    probe's own schedule: one CTA per step streams its spans in 16 KB
    sub-chunks through a 4-deep ring of bulk async copies and sums each
    column in f32, so a row two spans share is read twice. Where the spans
    are disjoint (``band_ablate``'s nosel: one span per chunk) it reads each
    row once with no plan. Same arguments as :func:`span_colsum_cuda`."""
    if not _on_card("span_colsum_staged_cuda", stream):
        return span_colsum_reference(stream, e0, NS, CAP, steps)
    stream, e0 = _span_checks("span_colsum_staged_cuda", stream, e0, NS, CAP,
                              steps)
    K = stream.shape[1]
    out = torch.empty((steps, K), dtype=torch.float32, device=stream.device)
    if steps > 0:
        _build.launch("span_colsum_staged",
                      _build.load_library().psp_span_colsum_staged,
                      stream.device, stream.data_ptr(), e0.data_ptr(),
                      out.data_ptr(), steps, NS, CAP, K)
        span_colsum_staged_cuda.launches += 1
    return out


span_colsum_staged_cuda.launches = 0


def dma_issue_output(colsum: torch.Tensor,
                     seed: torch.Tensor) -> torch.Tensor:
    """``r4_dma_issue.py``'s (8 * R, K) f32 output from the per-step column
    sums (steps, K) and the (1, R) seed: step ``t`` writes ``bf16(seed[0,
    r]) * colsum[t, k]`` into block ``t % 8``, and the last step of each
    residue class wins. Refuses fewer than 8 steps, where the TPU leaves
    blocks unwritten."""
    steps = colsum.shape[0]
    if steps < 8:
        raise ValueError(f"r4_dma_issue's output needs at least 8 steps "
                         f"(one per output block), got {steps}")
    last = steps - 8 + (torch.arange(8, device=colsum.device)
                        - (steps - 8)) % 8
    s = seed.reshape(-1).to(colsum.device, torch.bfloat16).to(colsum.dtype)
    return (s[None, :, None] * colsum[last][:, None, :]).reshape(
        8 * s.numel(), colsum.shape[1])


# ---- P4: band_ablate --------------------------------------------------------

def band_visits(chunk_row0: torch.Tensor, chunk_nj: torch.Tensor, *,
                BR_pad: int, R: int = TILE_ROWS, TMAX: int):
    """The (tile, chunk) visits of the K4 schedule, ``(row0_c / R + j, c)``
    for ``j < min(nj_c, TMAX)``, grouped by tile with the chunks of a tile in
    ascending order (the TPU grid's): ``(tile_ptr, visit_chunk)``, int32,
    ``tile_ptr`` (BR_pad / R + 1,). Built on the schedule's device (one host
    read of the visit count)."""
    dev = chunk_row0.device
    nj = chunk_nj.to(torch.int64).clamp(0, TMAX)
    nchunks = nj.numel()
    chunk = torch.repeat_interleave(torch.arange(nchunks, device=dev), nj)
    first = torch.cumsum(nj, 0) - nj
    j = torch.arange(chunk.numel(), device=dev) - first[chunk]
    tile = chunk_row0.to(torch.int64)[chunk] // R + j
    tile, order = torch.sort(tile, stable=True)   # chunks stay ascending
    ntiles = BR_pad // R
    tile_ptr = torch.searchsorted(tile, torch.arange(ntiles + 1, device=dev))
    return tile_ptr.to(torch.int32), chunk[order].to(torch.int32)


def check_band_schedule(chunk_span, chunk_row0, chunk_nj, bounds_start,
                        bounds_end, *, S: int, BR_pad: int, E: int,
                        R: int = TILE_ROWS, TMAX: int) -> None:
    """Raise ``ValueError`` unless the K4 schedule visits, for every edge of
    every (span, row) bound inside the whole chunks, the row's tile from the
    edge's own chunk, and that chunk belongs to the span. Then K4's function
    summed from the bounds alone (``band_reduce_call``) equals the TPU
    kernel's schedule-driven sum. Also checks that every chunk's tiles lie
    in the band. Runs on the host."""
    cs, cr, cn = (t.detach().cpu().to(torch.int64).reshape(-1)
                  for t in (chunk_span, chunk_row0, chunk_nj))
    nchunks = cs.numel()
    nj = cn.clamp(0, TMAX)
    if cr.numel() != nchunks or cn.numel() != nchunks:
        raise ValueError("chunk_span, chunk_row0 and chunk_nj differ in "
                         "length")
    if bool(((cs < 0) | (cs >= S)).any()):
        raise ValueError(f"a chunk's span lies outside [0, {S})")
    if bool(((cr % R != 0) | (cr < 0) | (cr + nj * R > BR_pad)).any()):
        raise ValueError(f"a chunk's tiles leave the band of {BR_pad} rows "
                         f"or its first row is not a multiple of {R}")
    limit = nchunks * E
    st, en = (b.detach().cpu().to(torch.int64).reshape(S, BR_pad)
              .clamp(0, limit) for b in (bounds_start, bounds_end))
    lens = (en - st).clamp_min(0).reshape(-1)
    total = int(lens.sum())
    owner = torch.repeat_interleave(torch.arange(S * BR_pad), lens)
    ptr = torch.cumsum(lens, 0) - lens
    e = st.reshape(-1)[owner] + torch.arange(total) - ptr[owner]
    s, row = owner // BR_pad, owner % BR_pad
    c = e // E
    lo = cr[c]
    ok = (cs[c] == s) & (row >= lo) & (row < lo + nj[c] * R)
    if not bool(ok.all()):
        bad = int((~ok).nonzero()[0, 0])
        raise ValueError(
            f"the schedule does not cover edge {int(e[bad])} of span "
            f"{int(s[bad])}, row {int(row[bad])}: its chunk {int(c[bad])} "
            f"(span {int(cs[c[bad]])}) visits rows {int(lo[bad])} to "
            f"{int(lo[bad] + nj[c[bad]] * R) - 1}")


def _chunk_colsum_reference(stream: torch.Tensor, E: int) -> torch.Tensor:
    acc = _acc_dtype(stream)
    n = stream.shape[0] // E
    return stream[:n * E].reshape(n, E, -1).to(acc).sum(1)


def band_ablate_reference(mode: str, chunk_span, chunk_row0, chunk_nj,
                          bounds_start, bounds_end, stream: torch.Tensor, *,
                          S: int, BR_pad: int, E: int, K: int,
                          R: int = TILE_ROWS, TMAX: int,
                          visits) -> torch.Tensor:
    """``r4_band_cost.py``'s ``k_nodot``/``k_nosel``/``k_empty`` as plain
    torch, (BR_pad, K): every tile's visits (the schedule's
    :func:`band_visits`) added in ascending chunk order, one round per rank
    of visit, vectorized over the tiles."""
    if mode not in ABLATE_MODES:
        raise ValueError(f"mode must be one of {ABLATE_MODES}, got {mode!r}")
    dev = stream.device
    acc = _acc_dtype(stream)
    ntiles = BR_pad // R
    tile_ptr, visit = (v.to(dev, torch.int64) for v in visits)
    counts = tile_ptr[1:] - tile_ptr[:-1]
    out = torch.zeros((ntiles, R, K), dtype=acc, device=dev)
    if mode == "nosel":
        colsum = _chunk_colsum_reference(stream, E)
    span = chunk_span.to(dev, torch.int64)
    bst = bounds_start.to(dev, torch.int64).reshape(-1)
    ben = bounds_end.to(dev, torch.int64).reshape(-1)
    tiles = torch.arange(ntiles, device=dev)
    for q in range(int(counts.max()) if ntiles else 0):
        live = counts > q
        t = tiles[live]
        c = visit[tile_ptr[:-1][live] + q]
        if mode == "empty":
            rows = c[:, None] * E + torch.arange(R, device=dev)
            out[live] += stream[rows].to(acc)
        elif mode == "nosel":
            out[live] += colsum[c][:, None, :]
        else:
            b = span[c] * BR_pad + t * R
            cnt = (torch.minimum(ben[b], (c + 1) * E)
                   - torch.maximum(bst[b], c * E)).clamp_min(0)
            out[live] += cnt.to(acc)[:, None, None]
    return out.reshape(BR_pad, K)


def band_ablate_cuda(mode: str, chunk_span, chunk_row0, chunk_nj,
                     bounds_start, bounds_end, stream: torch.Tensor, *,
                     S: int, BR_pad: int, E: int, K: int,
                     R: int = TILE_ROWS, TMAX: int,
                     visits) -> torch.Tensor:
    """:func:`band_ablate_reference` through ``psp_band_ablate``, each
    tile's visits (:func:`band_visits`, sorted on the device) added in
    ascending chunk order, no atomics. ``nosel`` and ``empty``: one CTA per
    (128-row tile, 64 columns) walks the tile's visits; ``nosel`` first
    takes each chunk's column sum once through
    :func:`span_colsum_staged_cuda` (one span of ``E`` rows per chunk,
    disjoint: no plan needed). ``nodot``, which reads no stream row: a fill
    of the output in equal contiguous shares, one a CTA, several CTAs an
    SM, each after the one-round counts of the tiles its share touches
    (one warp a tile, a lane a visit). ``stream``
    is a bf16 (nchunks * E, K) tensor, K a multiple of 8 (a power of two
    for ``nosel``); the bounds are (S * BR_pad / R, R) int32 absolute
    positions, as the TPU lays them out. ``visits`` is the schedule's
    :func:`band_visits`, built once before the calls, as the TPU's
    scalar-prefetched schedule is. Returns (BR_pad, K) f32."""
    if mode not in ABLATE_MODES:
        raise ValueError(f"mode must be one of {ABLATE_MODES}, got {mode!r}")
    args = (chunk_span, chunk_row0, chunk_nj, bounds_start, bounds_end,
            stream)
    if not _on_card("band_ablate_cuda", stream):
        return band_ablate_reference(mode, *args, S=S, BR_pad=BR_pad, E=E,
                                     K=K, R=R, TMAX=TMAX, visits=visits)
    dev = stream.device
    _check_same_device("band_ablate_cuda", dev, chunk_span=chunk_span,
                       chunk_row0=chunk_row0, chunk_nj=chunk_nj,
                       bounds_start=bounds_start, bounds_end=bounds_end)
    if stream.dtype != torch.bfloat16 or stream.dim() != 2 or \
            stream.shape[1] != K:
        raise TypeError(f"band_ablate_cuda takes a bf16 (L, K={K}) stream, "
                        f"got {stream.dtype} {tuple(stream.shape)}")
    if K % 8 or R != TILE_ROWS or BR_pad % R:
        raise ValueError(f"band_ablate_cuda takes K a multiple of 8, R = "
                         f"{TILE_ROWS} and BR_pad a multiple of R; got K={K}, "
                         f"R={R}, BR_pad={BR_pad}")
    stream = stream.contiguous()
    if not _aligned(stream):
        raise ValueError("band_ablate_cuda: stream must be 16-byte aligned")
    nchunks = chunk_span.numel()
    if nchunks * E > stream.shape[0] or bounds_start.numel() != S * BR_pad \
            or bounds_end.numel() != S * BR_pad:
        raise ValueError(f"band_ablate_cuda: {nchunks} chunks of {E} rows "
                         f"need that many stream rows ({stream.shape[0]}) "
                         f"and the bounds S * BR_pad = {S * BR_pad} entries")
    ntiles = BR_pad // R
    out = stream.new_empty((BR_pad, K), dtype=torch.float32)
    if ntiles == 0 or K == 0:
        return out
    tile_ptr, visit = visits
    if tile_ptr.numel() != ntiles + 1 or tile_ptr.device != dev:
        raise ValueError(f"band_ablate_cuda: visits must hold {ntiles + 1} "
                         f"tile pointers on {dev}")
    colsum = None
    if mode == "nosel":
        colsum = span_colsum_staged_cuda(
            stream, torch.arange(nchunks, device=dev, dtype=torch.int32) * E,
            1, E, nchunks)
    span = _index32("band_ablate_cuda", "chunk_span", chunk_span)
    bst = _index32("band_ablate_cuda", "bounds_start", bounds_start)
    ben = _index32("band_ablate_cuda", "bounds_end", bounds_end)
    _build.launch("band_ablate", _build.load_library().psp_band_ablate, dev,
                  ABLATE_MODES.index(mode), tile_ptr.data_ptr(),
                  visit.data_ptr(), span.data_ptr(), bst.data_ptr(),
                  ben.data_ptr(), BR_pad, stream.data_ptr(),
                  None if colsum is None else colsum.data_ptr(),
                  out.data_ptr(), ntiles, K, E)
    band_ablate_cuda.launches += 1
    return out


band_ablate_cuda.launches = 0


# ---- P5: slice_gather -------------------------------------------------------

def slice_gather_reference(fs: torch.Tensor, cols: torch.Tensor,
                           x: torch.Tensor, R: int, variant: str,
                           acc: Optional[torch.dtype] = None) -> torch.Tensor:
    """``r5_vmem_expand.py::make_call(variant)``: chunk ``c`` gathers rows
    ``x[fs[c] * R + cols[c * E + e]]``. ``onehot_write`` returns them,
    (nch * E, K) in ``x``'s dtype; ``onehot_reduce`` their sum over the
    chunk (f32, or f64 for f64 ``x``), cast to ``x``'s dtype, as 8 equal
    rows per chunk, (nch * 8, K); with ``acc`` given, summed and returned in
    that dtype instead. Windows of at most ~1 GiB."""
    if variant not in SLICE_VARIANTS:
        raise ValueError(f"variant must be one of {SLICE_VARIANTS}, got "
                         f"{variant!r}")
    nch, K = fs.numel(), x.shape[1]
    E = cols.numel() // max(1, nch)
    rows = (fs.to(x.device, torch.int64).repeat_interleave(E) * R
            + cols.to(x.device, torch.int64).reshape(-1))
    if variant == "onehot_write":
        return x[rows]
    out_dtype = acc or x.dtype
    acc = acc or _acc_dtype(x)
    sums = torch.empty((nch, K), dtype=acc, device=x.device)
    block = max(1, _WINDOW_BYTES // max(1, E * K * torch.finfo(acc).bits
                                        // 8))
    for a in range(0, nch, block):
        b = min(a + block, nch)
        sums[a:b] = x[rows[a * E:b * E]].to(acc).reshape(b - a, E, K).sum(1)
    return sums.to(out_dtype).repeat_interleave(8, 0)


class SliceItems(NamedTuple):
    """The work items of :func:`slice_gather_cuda`'s reduce: item ``i`` holds
    the chunks ``order[istart[i]:istart[i + 1]]`` (ascending, at most
    :data:`ITEM_CHUNKS`), all on slice ``sf[istart[i]]``; ``n_items`` is a
    one-entry tensor. int32 on ``fs``'s device; ``istart`` holds the items'
    starts and then ``nch`` (the reference's fills ``nch`` up to entry
    ``nch``, and has one more entry, scratch)."""
    order: torch.Tensor
    sf: torch.Tensor
    istart: torch.Tensor
    n_items: torch.Tensor


def slice_items(fs: torch.Tensor, nslices: Optional[int] = None
                ) -> SliceItems:
    """:func:`slice_items_reference`'s plan, built on the card by
    ``psp_slice_plan`` (a stable radix sort of ``fs``, over the bits that
    ``nslices``, the slice count, needs; a prefix sum and two small
    kernels, no host read; ``istart`` holds ``nch + 1`` entries, those past
    ``n_items`` unwritten) or, for a CPU ``fs``, by the reference."""
    if not _on_card("slice_items", fs):
        return slice_items_reference(fs)
    f = _index32("slice_items", "fs", fs)
    n, dev = f.numel(), f.device
    if n == 0:
        return slice_items_reference(f)
    buf = torch.empty(3 * n + 2, dtype=torch.int32, device=dev)
    order, sf, istart, n_items = torch.split(buf, [n, n, n + 1, 1])
    bits = 32 if nslices is None else max(1, (nslices - 1).bit_length())
    ws = _plan_ws(dev, False, n, bits)
    _build.launch("slice_plan", _build.load_library().psp_slice_plan, dev,
                  f.data_ptr(), n, bits, order.data_ptr(), sf.data_ptr(),
                  istart.data_ptr(), n_items.data_ptr(), ws.data_ptr(),
                  ws.numel())
    slice_items.launches += 1
    return SliceItems(order, sf, istart, n_items)


slice_items.launches = 0


def slice_items_reference(fs: torch.Tensor) -> SliceItems:
    """Group the chunks by slice (a stable sort of ``fs``: ascending chunk
    within a slice) and cut each group into items of at most
    :data:`ITEM_CHUNKS` chunks, in torch ops on ``fs``'s device with no
    host read."""
    dev = fs.device
    nch = fs.numel()
    sf, order = torch.sort(fs.reshape(-1).to(torch.int32), stable=True)
    pos = torch.arange(nch, device=dev)
    head = (pos - torch.searchsorted(sf, sf)) % ITEM_CHUNKS == 0
    item = torch.cumsum(head, 0) - 1
    istart = torch.full((nch + 2,), nch, dtype=torch.int32, device=dev)
    istart.scatter_(0, torch.where(head, item, nch + 1), pos.to(torch.int32))
    return SliceItems(order.to(torch.int32), sf, istart,
                      (item[-1:] + 1).to(torch.int32))


def slice_reduce_plan_reference(fs: torch.Tensor, cols: torch.Tensor,
                                x: torch.Tensor, R: int,
                                items: Optional[SliceItems] = None,
                                acc: Optional[torch.dtype] = None
                                ) -> torch.Tensor:
    """``onehot_reduce`` of :func:`slice_gather_reference` in the kernel's
    form, plain torch: per item, each chunk's counts of its cols over the R
    slice rows times the slice, ``counts (nc, R) @ slice (R, K)`` in ``acc``
    (default f32, f64 for f64 ``x``), cast to ``x``'s dtype (or returned in
    ``acc`` when given) as 8 equal rows per chunk. One host read a item."""
    nch, K = fs.numel(), x.shape[1]
    E = cols.numel() // max(1, nch)
    out_dtype = acc or x.dtype
    acc = acc or _acc_dtype(x)
    items = items or slice_items(fs)
    c = cols.to(x.device, torch.int64).reshape(nch, E)
    counts = torch.zeros((nch, R), dtype=acc, device=x.device).scatter_add_(
        1, c, torch.ones_like(c, dtype=acc))
    sums = torch.empty((nch, K), dtype=acc, device=x.device)
    order = items.order.to(x.device, torch.int64)
    istart = items.istart.tolist()
    for i in range(int(items.n_items[0])):
        chunks = order[istart[i]:istart[i + 1]]
        row0 = int(items.sf[istart[i]]) * R
        sums[chunks] = counts[chunks] @ x[row0:row0 + R].to(acc)
    return sums.to(out_dtype).repeat_interleave(8, 0)


def _slice_reduce_smem(R: int, K: int) -> int:
    """The reduce kernel's shared memory (``csrc/probes.cu::
    slice_reduce_shape``): two buffers of a slice part (boxes of at most
    256 rows, a multiple of 8) of the widest of 32, 16 and 8 columns (at
    most K) that fits, 128 bytes of counts a row (R rounded up to 8), 33 KB
    of the 8 warps' sums, 128 bytes to align them and 1 KB of barriers and
    chunk ids."""
    nbox = -(-R // 256)
    box_rows = -(-(-(-R // nbox)) // 8) * 8
    pw = min(K, _PART_COLS)
    while True:
        stage = -(-(nbox * box_rows * pw * 2) // 128) * 128
        smem = (128 + 2 * stage + -(-R // 8) * 8 * ITEM_CHUNKS * 4
                + 256 * 33 * 4 + 1024)
        if pw == 8 or smem <= _BLOCK_SMEM:
            return smem
        pw = 16 if pw > 16 else 8


def _slice_checks(fn: str, fs, cols, x, R: int):
    """``(fs, cols, x, E)`` checked and made int32 / contiguous."""
    _check_same_device(fn, x.device, fs=fs, cols=cols)
    if x.dtype != torch.bfloat16 or x.dim() != 2:
        raise TypeError(f"{fn} takes a 2-D bf16 x, got {x.dtype} "
                        f"{tuple(x.shape)}")
    nch, K = fs.numel(), x.shape[1]
    if nch == 0 or cols.numel() % nch:
        raise ValueError(f"{fn}: cols ({cols.numel()}) must hold E edges for "
                         f"each of {nch} chunks")
    if K % 8 or R < 1:
        raise ValueError(f"{fn} takes K a multiple of 8 and R >= 1, got "
                         f"K={K}, R={R}")
    x = x.contiguous()
    if not _aligned(x):
        raise ValueError(f"{fn}: x must be 16-byte aligned")
    E = cols.numel() // nch
    if max(nch, E, x.shape[0]) >= 2 ** 31:
        raise ValueError(f"{fn}: chunks, E and N must each be below 2**31")
    return _index32(fn, "fs", fs), _index32(fn, "cols", cols), x, E


def slice_gather_cuda(fs: torch.Tensor, cols: torch.Tensor, x: torch.Tensor,
                      R: int, variant: str) -> torch.Tensor:
    """:func:`slice_gather_reference` on the card. ``x`` is a bf16 (N, K)
    tensor, K a multiple of 8; every ``fs[c] * R + R <= N`` and every
    ``cols`` entry in ``[0, R)``; ``cols`` holds ``nch * E`` entries ((nch *
    E,) or (nch * E, 1)).

    ``onehot_write``: ``psp_slice_gather``, one CTA per (chunk, 128
    columns) holding its part of the chunk's slice and the chunk's indices
    in shared memory (``256 R + 4 E`` at most 200 KB) and serving every
    edge's row from there.
    ``onehot_reduce``: ``psp_slice_reduce`` over the item plan
    (:func:`slice_items`, built on the card): one persistent CTA an SM
    walks the items, histograms each chunk's cols over the R rows in shared
    memory, loads each part of the item's slice (32 columns, or 16 or 8
    past R = 768) once by TMA (two buffers) and sums ``counts . part`` in
    f32, rounded to bf16 once. Its shared memory, two parts, ``128 R``
    bytes of counts and 34 KB, must fit a block's 227 KB: R up to 1,232,
    at any E. ``.launches`` counts both variants' launches,
    ``.launches_reduce`` the reduce kernel's."""
    if variant not in SLICE_VARIANTS:
        raise ValueError(f"variant must be one of {SLICE_VARIANTS}, got "
                         f"{variant!r}")
    if not _on_card("slice_gather_cuda", x):
        return slice_gather_reference(fs, cols, x, R, variant)
    fs, cols, x, E = _slice_checks("slice_gather_cuda", fs, cols, x, R)
    nch, K = fs.numel(), x.shape[1]
    if variant == "onehot_write":
        if R * _SLICE_COLS * 2 + E * 4 > 200 * 1024:
            raise ValueError(f"slice_gather_cuda's onehot_write takes a "
                             f"128-column slice part and the chunk's indices "
                             f"within 200 KB of shared memory (256 R + 4 E), "
                             f"got K={K}, R={R}, E={E}")
        out = torch.empty((nch * E, K), dtype=torch.bfloat16,
                          device=x.device)
        if E:
            _build.launch("slice_gather",
                          _build.load_library().psp_slice_gather, x.device,
                          fs.data_ptr(), cols.data_ptr(), x.data_ptr(),
                          out.data_ptr(), nch, R, E, K)
            slice_gather_cuda.launches += 1
        return out
    if _slice_reduce_smem(R, K) > _BLOCK_SMEM:
        raise ValueError(f"slice_gather_cuda's reduce holds two 8-column "
                         f"parts of the slice at least, 128 R bytes of "
                         f"counts and 34 KB in a block's 227 KB of shared "
                         f"memory: R={R} needs {_slice_reduce_smem(R, K)} "
                         f"bytes")
    out = torch.empty((nch * 8, K), dtype=torch.bfloat16, device=x.device)
    if not E:
        return out.zero_()
    it = slice_items(fs, x.shape[0] // R)
    _build.launch("slice_reduce", _build.load_library().psp_slice_reduce,
                  x.device, it.order.data_ptr(), it.sf.data_ptr(),
                  it.istart.data_ptr(), it.n_items.data_ptr(),
                  cols.data_ptr(), x.data_ptr(), out.data_ptr(), nch,
                  x.shape[0], R, E, K)
    slice_gather_cuda.launches += 1
    slice_gather_cuda.launches_reduce += 1
    return out


slice_gather_cuda.launches = 0
slice_gather_cuda.launches_reduce = 0

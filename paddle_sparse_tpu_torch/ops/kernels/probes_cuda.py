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
``span_colsum``    ``experiments/r4_dma_issue.py:44`` (``run``)
``band_ablate``    ``experiments/r4_band_cost.py:181/201/217`` (nodot,
                   nosel, empty; full and untrans are K4's function and run
                   on ``band_reduce_call``)
``slice_gather``   ``experiments/r5_vmem_expand.py:56`` (``make_call``)
=================  =====================================================

The probes' own entry points are ``paddle_sparse_tpu_torch/experiments/``.
"""
from typing import Optional

import torch

from . import _build
from .spmm_cuda import _WINDOW_BYTES

TILE_ROWS = 128                           # band_ablate's output tile (R)
ABLATE_MODES = ("nodot", "nosel", "empty")
SLICE_VARIANTS = ("onehot_write", "onehot_reduce")
_SLICE_COLS = 128                         # slice_gather's columns per CTA


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
    """``t`` as a contiguous 1-D int32 tensor: itself when it is one."""
    if t.dtype == torch.int32 and t.dim() == 1 and t.is_contiguous():
        return t
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


def span_colsum_cuda(stream: torch.Tensor, e0: torch.Tensor, NS: int,
                     CAP: int, steps: int) -> torch.Tensor:
    """:func:`span_colsum_reference` through ``psp_span_colsum``: one CTA
    per step streams its spans in 16 KB sub-chunks through a 4-deep ring of
    bulk async copies and sums each column in f32. ``stream`` is a bf16
    (L, K) tensor, K a power of two from 8 to 2048; ``e0`` holds ``steps *
    NS`` row starts with every span inside the stream. Returns (steps, K)
    f32."""
    if not _on_card("span_colsum_cuda", stream):
        return span_colsum_reference(stream, e0, NS, CAP, steps)
    _check_same_device("span_colsum_cuda", stream.device, e0=e0)
    stream = _check_colsum_stream("span_colsum_cuda", stream)
    e0 = _index32("span_colsum_cuda", "e0", e0)
    if e0.numel() < steps * NS:
        raise ValueError(f"span_colsum_cuda: e0 holds {e0.numel()} starts, "
                         f"{steps} steps of {NS} spans need {steps * NS}")
    if max(steps, NS * CAP, stream.shape[0]) >= 2 ** 31:
        raise ValueError("span_colsum_cuda: steps, NS * CAP and the stream's "
                         "rows must each be below 2**31")
    K = stream.shape[1]
    out = torch.empty((steps, K), dtype=torch.float32, device=stream.device)
    if steps > 0:
        _build.launch("span_colsum", _build.load_library().psp_span_colsum,
                      stream.device, stream.data_ptr(), e0.data_ptr(),
                      out.data_ptr(), steps, NS, CAP, K)
        span_colsum_cuda.launches += 1
    return out


span_colsum_cuda.launches = 0


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
    """:func:`band_ablate_reference` through ``psp_band_ablate``: one CTA per
    (128-row tile, 64 columns) walks the tile's visits (:func:`band_visits`,
    sorted on the device) in ascending chunk order, no atomics. ``nosel``
    first takes each chunk's column sum once through
    :func:`span_colsum_cuda` (one span of ``E`` rows per chunk). ``stream``
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
    out = torch.empty((BR_pad, K), dtype=torch.float32, device=dev)
    if ntiles == 0 or K == 0:
        return out
    tile_ptr, visit = visits
    if tile_ptr.numel() != ntiles + 1 or tile_ptr.device != dev:
        raise ValueError(f"band_ablate_cuda: visits must hold {ntiles + 1} "
                         f"tile pointers on {dev}")
    colsum = None
    if mode == "nosel":
        colsum = span_colsum_cuda(
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


def slice_gather_cuda(fs: torch.Tensor, cols: torch.Tensor, x: torch.Tensor,
                      R: int, variant: str) -> torch.Tensor:
    """:func:`slice_gather_reference` through ``psp_slice_gather``: one CTA
    per (chunk, 128 columns) holds its part of the chunk's R-row slice and
    the chunk's column indices in shared memory and serves every edge's row
    from there. ``x`` is a bf16 (N, K) tensor, K a multiple of 8, with
    ``256 R + 4 E`` at most 200 KB; every ``fs[c] * R + R <= N`` and every
    ``cols`` entry in ``[0, R)``; ``cols`` holds ``nch * E`` entries ((nch *
    E,) or (nch * E, 1))."""
    if variant not in SLICE_VARIANTS:
        raise ValueError(f"variant must be one of {SLICE_VARIANTS}, got "
                         f"{variant!r}")
    if not _on_card("slice_gather_cuda", x):
        return slice_gather_reference(fs, cols, x, R, variant)
    _check_same_device("slice_gather_cuda", x.device, fs=fs, cols=cols)
    if x.dtype != torch.bfloat16 or x.dim() != 2:
        raise TypeError(f"slice_gather_cuda takes a 2-D bf16 x, got "
                        f"{x.dtype} {tuple(x.shape)}")
    nch, K = fs.numel(), x.shape[1]
    if nch == 0 or cols.numel() % nch:
        raise ValueError(f"slice_gather_cuda: cols ({cols.numel()}) must "
                         f"hold E edges for each of {nch} chunks")
    E = cols.numel() // nch
    if K % 8 or R * _SLICE_COLS * 2 + E * 4 > 200 * 1024 or R < 1:
        raise ValueError(f"slice_gather_cuda takes K a multiple of 8 and a "
                         f"128-column slice part and the chunk's indices "
                         f"within 200 KB of shared memory (256 R + 4 E), got "
                         f"K={K}, R={R}, E={E}")
    x = x.contiguous()
    if not _aligned(x):
        raise ValueError("slice_gather_cuda: x must be 16-byte aligned")
    if max(nch, E, x.shape[0]) >= 2 ** 31:
        raise ValueError("slice_gather_cuda: chunks, E and N must each be "
                         "below 2**31")
    fs = _index32("slice_gather_cuda", "fs", fs)
    cols = _index32("slice_gather_cuda", "cols", cols)
    reduce = variant == "onehot_reduce"
    out = torch.empty((nch * (8 if reduce else E), K), dtype=torch.bfloat16,
                      device=x.device)
    if K and E:
        _build.launch("slice_gather", _build.load_library().psp_slice_gather,
                      x.device, int(reduce), fs.data_ptr(), cols.data_ptr(),
                      x.data_ptr(), out.data_ptr(), nch, R, E, K)
        slice_gather_cuda.launches += 1
    elif reduce:
        out.zero_()
    return out


slice_gather_cuda.launches = 0

"""Smoke test of paddle_sparse_tpu_torch on one NVIDIA GPU (written for an H100).

Run from the repository root:

    python3 chip_smoke.py

Phases, one or more printed lines each:

1. Device and build: the card's name and power limit (nvidia-smi), the torch
   and CUDA versions, then the CUDA kernels built from ``csrc/`` with nvcc.
2. SpMM kernel vs plain: ``spmm_csr_cuda`` against ``spmm_csr_reference``
   run in f64 on the card, over K, dtypes, ``value=None``, empty rows, a row
   of over 1M edges and a padded ``PaddedCOO``.
2b. SDDMM kernel vs plain: ``sddmm_csr_cuda`` against
   ``sddmm_csr_reference`` run in f64 on the card, over K, f32 and bf16
   inputs, empty rows, a padded ``PaddedCOO`` with poisoned padding cols
   (padding reads back 0), a row of over 1M edges, and the identity
   structure (where the kernel is ``mul_rowsum``).
2c. The fused CSC backward (``spmm_sddmm_csc_cuda``) against the pair it
   replaces (K2 over the CSR, ``value[perm]`` and K1 over the CSC view) bit
   for bit, and against its plain version in f64, over K 1 3 47 64 100 256
   300 520, f32, bf16, bf16 x with f32 value, bf16 g and value with f32 x,
   ``value=None``, empty
   columns, poisoned padding and a hub column split into pieces; two
   launches bit for bit; the launch alone (``csc_order_cuda``, values and
   d value in CSC order) equal to the routed call read in CSC order.
3. Toy slice: ``entry("cuda")``'s GCN forward against the same model run on
   the CPU through the plain path.
3b. Toy train step: ``train_entry("cuda")`` against ``train_entry("cpu")``:
   loss, every parameter's grad and d value, then 20 SGD steps.
4. GCN inference at ogbn-products scale (2,449,029 nodes, degree 50, the OGB
   products GCN baseline 100 -> 256 -> 256 -> 47): 1 warm-up and 3 timed
   forwards, the kernel's launch count, per-layer times, a sampled-row
   check against f64, and
   the K=256 SpMM timed through the kernel and the plain version.
5. GCN train step at the same scale, on phase 4's graph, features and model,
   with labels and ``adj.value.requires_grad_()``: the CSC view's build time,
   1 warm-up and 3 timed steps (forward + backward + SGD), peak memory, the
   launch counts (per step K1 3 forward, K2 1 for layer 0's d value, the
   fused CSC backward 2 for layers 1 and 2), per-part times, d value on
   sampled edges and d x on sampled columns against f64, the K=256 and
   K=100 SDDMM timed through the kernel and the plain version, and the
   fused CSC backward at K=256 (layer 1's g and input) in turns with the
   pair it replaces (K2, ``value[perm]``, K1 over the CSC view), d x and d
   value equal to the pair's bit for bit, against its plain version, its
   bounds and its library calls (``torch.sparse.mm`` of the transpose,
   ``sampled_addmm``); then its parts: the launch alone (values and d value
   in CSC order) and each relay alone (``value[perm]`` before, ``d
   value_t[inv_perm]`` after).
4c. K1 on ``bench.py``'s clustered graph at full scale (2,449,029 nodes,
   122,451,450 nnz, 80% of each row's edges inside its 2,048-node
   community), at K=256 f32, K=100 f32 and K=256 bf16 (value and x): the
   register walk (``spmm_csr_cuda``) beside its three
   bounds (each byte once, the gathered rows, and the residual bound: each
   byte once plus one row per edge outside its community) and
   ``torch.sparse.mm``; then phase 4's GCN forward on the clustered
   graph's normalized adjacency, on the main path (launch counts exact, K1
   3 per forward), with per-layer times.
6a. Run compaction (K5) vs plain: ``compact_runs_cuda`` against
   ``compact_runs_reference`` in f64 on the card, over per-row-sorted grids,
   a row block's grid, a flat (row, col)-sorted stream, runs across many
   tiles and one of over 1M elements, ``out_capacity`` truncation and
   structure only; grids whose rows K5 sorts itself (``rows_sorted=False``,
   ties of equal cols, F up to ``F_MAX``, the 64-bit key), each also bit for
   bit against ``torch.sort`` + the presorted mode; flat runs of 100k, 1.1M
   and 10M normal f32 values against f64, two launches bit for bit.
6b. Toy SpGEMM: ``spgemm_entry("cuda")``'s A @ A through the three variants
   against the CPU: structure, values and value grads.
6c. SpGEMM at the JAX package's probe sizes (``bench.py::spgemm_probe``):
   A of 50,000 nodes x 16 (800k nnz) through ``plan_spgemm_rows`` +
   ``spspmm_rowsorted``; A of 625,000 x 16 (10M nnz) through
   ``spspmm_rowsorted`` and ``plan_spgemm_blocked`` + ``spspmm_rowblocked``;
   a zipf (alpha 1.5) A of 100,000 nodes through the path the planners
   choose. For each A @ A: plan seconds, 1 warm-up and 3 timed calls, C's
   nnz, output Mnnz/s, peak memory, K5 launches (on the grid paths every
   launch sorts its rows: the second counter), no overflow, sampled rows of
   C against scipy in f64, one call's stages by CUDA events (expansion, K5,
   the rest), and K5 timed alone on the call's own compress input against
   the plain version, against what its row sort replaces (``torch.sort`` +
   gather + the presorted mode, whose C must be equal bit for bit) and
   against its library call, ``torch.sparse_coo_tensor(...).coalesce()`` on
   the same elements, in turns.
   At 800k also the value grads of ``sum(G * C)`` on sampled entries against
   f64.
7a. Multi-span SpMM (``spmm_spans_cuda``, the counterpart of K3/K4) and
   span SDDMM (``sddmm_spans_cuda``, K2's span form) against their plain
   versions in f64 over S in 1 3 19 40 and K in 1 47 64 100 256 300, f32 and
   bf16, with slice bases, empty rows and spans; S = 1 against K1's wrapper
   (``spmm_csr_cuda``, the same kernel over a CSR pointer) bit for bit; the
   stream form with a row of 1.1M edges, exact; ``tilespan_call`` (K3's
   entry point) on seg3's own tables of a 200k-node graph; and
   ``band_reduce_call`` (K4's) at ``experiments/r4_band_cost.py``'s sizes,
   timed against its plain version and ``torch.sparse.mm`` of the 0/1 span
   CSR. Then the long-row split (``RowSplit`` pieces, one warp each, and the
   fold pass) of both span kernels against plain f64 at S = 1 and S = 38:
   rows of CAP-1, CAP, CAP+1 and 2*CAP+3 edges, K 1 47 256 300, f32 and
   bf16; a row of 10M edges over spans that cross 32-span chunks, with empty
   spans and rows around it, exact; and the fold alone against its plain
   version. Then the fused span backward (``spmm_sddmm_spans_cuda``) as
   the packed backward runs it (values gathered through a random relay, d
   value read back through its inverse) against its plain version in f64
   and bit for bit against the pair of span kernels over the same bounds,
   S in 1 3 19 40, K in 1 47 64 256 520, f32 and bf16, values or None; and
   over rows around CAP cut into pieces at S = 1 and 38 (the fold after).
7b. Toy packed SpMMs: ``spmm_entry`` for seg2, seg3 and split, forward and
   grads, card vs CPU.
7c. The bench's packed-SpMM cells at full width, on torch rewrites of
   ``bench.py``'s generators: seg2 on the uniform graph at full
   ogbn-products scale (2,449,029 nodes, 122,451,450 nnz, K=256) with the
   f32 and the bf16 stream, seg3 there (bf16), seg2 at K=64 and 1/8 scale
   (``dim64``), split on the clustered graph (bf16), seg2 on zipf at 1/8
   scale after seg3's refusal, and seg2 on zipf at full scale (bf16, hub
   rows of 18.6M and 17.7M edges). For each: plan seconds, 1 warm-up and 3
   timed forwards and forward+backwards, peak memory, the launches (counts
   zeroed just before, read just after: spans 1 per forward and the fused
   span backward 1 per backward, per seg2 call; the fold pass runs exactly
   where a plan has split rows, so never on the uniform graphs), sampled
   rows (the longest among them), ``d value`` and ``d x`` against f64, and
   each seg2 call's fused span backward bit for bit against the pair it
   replaces (the spans SpMM over the transpose, the span SDDMM over the
   forward layout); the first path's first forward+backward runs under
   the profiler. On the f32 path the two span kernels alone, kernel vs
   plain in turns, with their bounds, K1 on the same graph and the library
   calls computing the same products (``torch.sparse.mm``,
   ``torch.sparse.sampled_addmm``), which the port never calls; then the
   fused span backward against its plain version, as the backward runs it
   in turns with the pair (bit for bit), its bounds, and the library pair
   (``torch.sparse.mm`` of the transpose + ``sampled_addmm``). On zipf 1/8
   the span kernels, K1 and K2 alone in f32 and bf16, each in turns with
   its library call in the same dtype, two launches of each bit for bit
   equal, the fold alone on the hub's partials, and the fused span
   backward in turns with the pair, bit for bit, on the path's inputs and
   on the graph transposed (its hub rows become x rows cut into pieces;
   there also against the plain version in f64).
8a. SpMM ``reduce`` mean, min and max on a padded ``PaddedCOO`` (poisoned
   padding cols, empty rows, a row of negative products, duplicate entries,
   a hub row and a hub column past ``CAP``), in f32 and in small integers
   (ties), forward, d value and d x against the plain path in f64; mean's
   launches (K1 forward, the fused CSC backward for d x and d value, the
   fold after each), none for min and max. Then min and max at 1/8 of
   ogbn-products scale, where their (nnz, K) products fit the card:
   forwards at K=256 and forward+backwards at K=64, times, peak memory,
   sampled rows against f64.
8b. Toy GraphSAGE, GIN, APPNP and GAT (``model_entry``): forward, loss,
   every parameter's grad and d value, card vs CPU.
8c. GraphSAGE (mean aggregator) 100 -> 256 -> 256 -> 47 on phase 4's graph
   with ``adj.value.requires_grad_()``: 1 warm-up and 3 timed forwards and
   train steps, peak memory, the launch counts (K1 3 per forward and per
   step; K2 1 and the fused CSC backward 2 per step; no fold), the times
   beside phase 4's and 5's GCN,
   and every SpMM's sampled rows and d value on sampled edges against f64
   (the calls recorded during one more step); then GAT's attention pass
   alone on that graph at ``gat-products.eval``'s shapes, 4 heads of 128
   and 4 of 47, against its plain version and itself, its ms beside its
   bound and the plain version's (the 4 x 128 run is the ``kernels``
   line's ``gat_attention`` entry); and the heads aggregated by those
   weights as the model runs them (``adj.spmm(hw, value=att)``: a K1 a
   head on the views ``hw[:, k]`` and ``out[:, k]``, row stride 512, the
   vector path, and 188, the scalar one): sampled rows of each head
   against f64, H ``spmm_csr`` launches all on strided views, and its ms.
8d. On ``bench_graph``'s zipf graph at 1/8 scale with 100 features (hub row
   of 10M edges, split): GIN 100 -> 256 -> 256 -> 47 and APPNP 100 -> 256
   -> 47 (k = 10, alpha = 0.1) on the ``gcn_normalize``-d adjacency with
   its values requiring grad, and GAT (3 layers, 4 heads of 64, output 47)
   on the raw one: times, peak memory, launch counts (GAT: K1 sum(H) and
   the fused CSC backward sum(H) per step, the attention pass once a layer
   in forwards and steps, and K1 on strided views, ``spmm_csr_cuda.
   strided``, 8 a forward and a step: the hidden heads read and write
   their columns in place; the fold after every K1 over the split rows and
   every fused pass over split columns),
   sampled rows of every SpMM, GIN's and APPNP's d value and GAT's d att
   of every head and layer against f64; then GAT's attention pass alone at
   the model's shapes, 4 heads of 64 and 1 of 47, on that graph (split
   rows), as in 8c.
9a. The eager ``SparseTensor`` facade on ``facade_entry``'s toy graph
   (int64 indices, no value): ``gcn_norm``, ``A @ x`` with d value and d x,
   ``adj_t[idx]``, ``narrow``, ``t()``, ``masked_select`` and ``A @ A``,
   card vs CPU.
9b. PyG's ``gcn_norm`` on a ``SparseTensor`` built from phase 4's graph as
   int64 ``row``/``col`` with no value (``fill_diag``, ``sum(dim=1)``,
   ``pow(-0.5)``, two ``mul``), then ``adj_t @ x`` at K=100, forward and
   forward+backward: each step's ms (1 warm-up + 3), peak memory, 1,024
   sampled rows of the values (degree and columns exact) and of ``out``
   against f64 on the host, d value and d x on sampled entries against f64,
   ``out`` bit for bit against ``PaddedCOO.spmm`` on the same entries (both
   timed), launches exact (K1 1 per forward, the fused CSC backward 1 per
   backward, no fold) and no CSC view built after the first backward.
9c. ``adj_t[idx]`` (1/8 of the rows), ``narrow``, ``t()`` and
   ``masked_select`` on the normalized ``adj_t``: ms each, sampled rows
   equal to scipy's same op.
9d. ``A @ A`` through the facade on phase 6c's 10M-nnz operand: ms per call,
   K5 once per call, C bit for bit against ``spspmm_eager`` on the same
   arrays, sampled rows against scipy in f64.

10a. Toy sampling on ``sample_entry``'s graph, card vs CPU: the host
   sampler with one seed, ``saint_subgraph``, ``partition`` and RCM equal,
   ``sample_adj_padded``, ``random_walk`` and ``sample_neighbors`` equal when
   fed the same uniforms, ``sample`` and ``random_walk`` on the card's own
   generator structurally right; then ``spmm_seg``, ``spmm_sell`` and
   ``spmm_chunked`` toys (forward and grads) and ``backend="sell"``.
10b. Minibatch sampling at ogbn-products scale (phase 4's graph as PyG's
   ``NeighborSampler`` holds it, edge ids as values): 1,024 random seeds,
   fanouts 15, 10, 5 hop by hop through ``sample_adj`` (the host runtime):
   per hop the first and 3 warm calls' ms, node and edge counts, structural
   checks (``min(deg, F)`` distinct edges of each seed, ``n_id`` seeds first
   and unique, each column the local id of its edge's column), and
   ``adj_h @ x[n_id_h]`` at K=100 on K1 (one launch, sampled rows vs f64);
   then ``ops.sample.sample_adj_padded`` (F = 15, without and with
   replacement) and ``sample_neighbors`` for the same seeds, ms and checks.
10c. ``random_walk`` from every node (length 20): ms, walks/s, every step an
   edge; OGB's products GraphSAINT random-walk sampler (20,000 roots, length
   3, ``saint_subgraph`` of their nodes): ms, sampled rows vs scipy;
   ``reverse_cuthill_mckee``: seconds, a valid permutation, bandwidth before
   and after; ``partition`` with 15,000 parts (OGB's products
   ClusterGCN), started after those timings in a thread beside 10d (the
   host runtime lets go of the interpreter lock; it must return after
   10d's last timed call): seconds, ``partptr`` and ``perm`` on the card,
   ``partptr`` sums to N, ``out`` equals ``permute(perm)``, edge cut of
   the returned parts beside a random partition's.
10d. The three plan-holding SpMM entry points on phase 4's graph at K=256,
   f32: ``spmm_chunked``, ``spmm_seg``, ``backend="sell"`` (COO values)
   and ``spmm_sell`` with its ``(32, ng)`` value grid as the leaf, each in
   turns with ``spmm_csr`` (csr, path, path, csr): plan seconds, forward and
   forward+backward ms, peak memory, exact launches (K1 1 per forward, K1 1
   and the fused CSC backward 1 per forward+backward; seg: spans 1 / 1 and
   the fused span backward 1), and
   sampled rows, ``d value`` and ``d x`` against f64; the grid's ``d
   value`` 0 at every pad slot.
11. The TPU probes of ``experiments/`` through the port's entry points
   (``paddle_sparse_tpu_torch/experiments/``) at the probes' defaults:
   11a every launch count set to 0, then ``bisect_pallas`` (all stages),
   ``r4_dma_issue.run`` at NS=19, CAP=384, 2,048 steps, the five
   ``r4_band_cost`` variants and both ``r5_vmem_expand`` variants at 10,000
   chunks, with exact launches (scale2 1, chunk_sum 2, span_plan 1 and
   span_colsum 1 (the piece path), span_colsum_staged 1 (nosel's chunk
   sums), band_ablate 3, slice_plan 1, slice_gather 2 of which slice_reduce
   1, K1/K4's spans kernel 3). The plans built on the card equal their
   torch references (11c, 11e). Then
   each output against its plain version in f64 (bit for bit where the sum
   order matches) and edge cases: scale2 at odd sizes and offsets,
   chunk_sum on uneven tiles at both ring depths, ``segment_rows_matmul``
   with ``acc``, bf16 and a row of 4,000 edges (11b); the piece path and
   the staged kernel at 13 steps (not a multiple of 8), K 8 to 2,048, CAP
   17 to 300 from unaligned starts, identical, overlapping and shared
   spans, a span ending at the stream's end, 7 steps refused (11c); a small
   band whose tiles several chunks visit, a schedule that misses edges
   refused, nosel's first pass staged and through the pieces, nodot's
   device time under ``torch.profiler`` beside its turns and the card's
   own ``fill_`` of the same bytes (11d);
   repeated, unsorted and all-equal ``fs``, 10,000 chunks on one slice, K
   200, 40 and 8, R 400, 300, 16 and 799, E 7, 50, 100 and 2,500, ``cols``
   at a 4-byte offset (11e). Each kernel's time beside its plain
   version (in turns), bound and library call (``torch.mul``,
   ``view().sum(1)``, ``embedding_bag``, ``index_select``); per-step and
   per-span times of P3 (the piece path in turns with the staged kernel,
   its plan, its piece count and piece-sum memory), ns per edge of the
   slice gather beside random rows of a 64 MB source, the reduce's plan
   and the one-slice case, and the allocator's retries in the turns.
12. ``parallel/`` at world size 1: an NCCL process group of one rank from a
   file store and a 1-D mesh (one card runs NCCL at one rank only). 12a
   the dry run's blocks (``entry.DryRun`` on its toy graph of 64 nodes, GCN
   16 -> 32 -> 4): the row-sharded GCN step, ring, bucketed ring and halo
   against the all-gather SpMM, the 2-D SpMM on a (1, 1) grid, the seg2
   and seg2 x halo steps (more than one segment) and the row-sharded A @ A
   against dense, each step also with d value; every block's launches
   exact (``DRYRUN_LAUNCHES``). 12b at full width on phase 4's graph
   (2,449,029 nodes, 122,451,450 nnz), shards built on the card: phase 5's
   GCN train step (100 -> 256 -> 256 -> 47, f32, d value) through
   ``RowShardedAdjacency`` and ``sharded_train_step``, its first step's
   loss, grads, parameters after SGD and d value against phase 5's
   unsharded step from the same state (within 1e-6 of each tensor's max,
   bit for bit reported), 1 warm-up + 3 timed steps beside phase 5's
   ``step_ms``, peak memory, launches exact (K1 3, K2 1, the fused CSC
   backward 2 a step); then ``spmm_seg2_allgather`` at K=256 f32, one
   forward+backward against ``spmm_seg2`` on the same plan (1e-6), 1
   warm-up + 3 timed beside phase 7c's seg2 f32, launches exact (spans 1,
   the fused span backward 1 a call). Then phase 5's GCN step once with
   the input-gradient penalty (as 14b) through the row-sharded adjacency,
   bit for bit against the unsharded penalty step, launches exact.
13. Every float dtype of the JAX package: 13a K1, K2 and the fused CSC
   backward in f16, f64 and mixed pairs, and K5 in every value dtype,
   against plain f64, exact launches; 13b phase 5's GCN step in f64 and
   f16 against f32, the kernels alone at K=256; 13c ``A @ A`` 10M in bf16
   and f16; 13d ``coalesce`` of 122M entries with (capacity, 8) f32 and
   bf16 values.
14. Integer operands and the double backward. 14a on phase 4's graph as a
   structural A: ``A @ onehot(labels)`` (47 int32 classes: neighbour-label
   counts) and the two-hop path counts ``A @ (A @ 1)`` in int64, each K1
   launch on the main path (``PaddedCOO.spmm``), exact against the plain
   version on the card, timed in turns beside its bound and
   ``torch.sparse.mm`` (which refuses ints); int32 values and x of
   +-2**30 on a small graph with a hub row in pieces, exact, sums wrapped
   past 2**31. 14b phase 5's GCN with the input-gradient penalty ``CE +
   lam * |d CE / d x|^2`` (``lam`` a tenth of CE at the start): 1 warm-up
   + 3 timed steps beside phase 5's, peak memory, launches exact (K1 6,
   K2 3, the fused CSC backward 6 a step), the step's gradient along three
   unit directions of the last layer against an f64 central difference
   (within 1e-5 of the gradient's norm), the penalty's share of it
   printed beside and above ten times that. 14c in f64 on a small graph with
   a hub row and column in pieces: HVPs of ``spmm`` in value and x and of
   SpGEMM values, card against CPU (1e-10 of the largest entry), and the
   bilinear identity (the mixed second derivative of ``<G, A(v) x>`` is
   ``<G, A(dv) dx>``, within 1e-11).

Every kernel in the JSON line carries its time, launches, plain time,
bound (the larger of the bytes each input and output moves once over
3.35 TB/s and its f32 operations over 67 TFLOP/s; ``gather_bound_ms`` is
the gathered rows alone) and library time (null where no single call
computes the same function).

Then the kernels' JSON line, the nvidia-smi line, and as the last line
``{"ok": true, "device": {...}}``. Any failed check exits non-zero; so does a
machine where ``torch.cuda.is_available()`` is False.

f32 matrix products run in full f32: TF32 is switched off below, for the
forward and the backward GEMMs alike.
"""
import dataclasses
import json
import subprocess
import sys
import time

import torch

F32_TOL = dict(rtol=1e-5, atol=1e-4)    # f32 sums taken in another order
BF16_TOL = dict(rtol=2e-2, atol=2e-2)   # output rounded to bf16
# gradients at scale are tiny (the loss is a mean over 2.4M nodes), so their
# f64 checks bound the error by 1e-5 of the sum of |terms| of each dot or
# row-sum: f32 rounding of K-term sums stays far below that
GRAD_REL = 1e-5

# published H100 SXM peaks (NVIDIA's data sheet), for the bounds
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

PRODUCTS_NODES = 2_449_029              # ogbn-products, as bench.py
PRODUCTS_DEG = 50                       # 122,451,450 nnz
GCN_DIMS = (100, 256, 47)               # in, hidden, classes; 3 layers
SAMPLED_ROWS = 4096
SAMPLED_EDGES = 4096
SAMPLED_COLS = 1024
LR = 0.1


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke failed: {msg}")


def _event():
    return torch.cuda.Event(enable_timing=True)


def timed(fn, reps, warm=True):
    """Mean ms of ``reps`` calls after one warm-up (none with ``warm``
    False), by CUDA events; and the last result."""
    if warm:
        fn()
    a, b = _event(), _event()
    a.record()
    for _ in range(reps):
        res = fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps, res


def dropped(fn):
    """``fn`` with its result dropped: timed calls then hold one output at
    a time."""
    def run():
        fn()
    return run


def in_turns(run_p, run_k, reps_p, reps_k):
    """Plain, kernel, kernel, plain: ``(p1, k1, k2, p2, out_p, out_k)``."""
    p1, out_p = timed(run_p, reps_p)
    k1, out_k = timed(run_k, reps_k)
    k2, _ = timed(run_k, reps_k)
    p2, _ = timed(run_p, reps_p)
    return p1, k1, k2, p2, out_p, out_k


def bound_ms(nbytes: float, flops: float):
    """The least time the card could take: the larger of ``nbytes`` over the
    HBM rate and ``flops`` over the f32 rate (the kernels' FMAs run in f32
    on the CUDA cores), with which of the two bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def library_timed(name, fn, reps, ref=None, warm=True):
    """A PyTorch library call timed as a yardstick (never used by the
    port): mean ms over ``reps`` after a warm-up (if ``warm``), and its max
    abs difference from ``ref`` (a sparse result by its values); ``(None,
    None)`` with the error printed if the call fails or runs out of
    memory."""
    try:
        ms, out = timed(fn, reps, warm)
    except (RuntimeError, ValueError, TypeError) as e:
        print(f"library {name}: failed, {type(e).__name__}: "
              f"{str(e).splitlines()[0][:200]}", flush=True)
        torch.cuda.empty_cache()
        return None, None
    if out.layout in (torch.sparse_csr, torch.sparse_coo):
        out = out.values()
    err = (None if ref is None or out.shape != ref.shape
           else float((out.double() - ref.double()).abs().max()))
    del out
    torch.cuda.empty_cache()
    return ms, err


def library_in_turns(name, run_lib, run_k, reps, ref=None):
    """A library call and a kernel in turns, library, kernel, kernel,
    library: ``(library ms or None, kernel ms, library max abs error)``,
    each ms the mean of its two turns."""
    l1, err = library_timed(name, run_lib, reps, ref)
    k1, _ = timed(run_k, reps)
    k2, _ = timed(run_k, reps)
    l2, _ = library_timed(name, run_lib, reps) if l1 is not None else (
        None, None)
    lib = None if l1 is None or l2 is None else (l1 + l2) / 2
    return lib, (k1 + k2) / 2, err


def random_csr(gen, dev, M, N, max_deg):
    deg = torch.randint(0, max_deg + 1, (M,), generator=gen, device=dev)
    deg[[0, M // 3, M - 1]] = 0                  # empty, last row too
    rowptr = torch.zeros(M + 1, dtype=torch.int32, device=dev)
    rowptr[1:] = deg.cumsum(0)
    nnz = int(rowptr[-1])
    col = torch.randint(0, N, (nnz,), generator=gen, device=dev,
                        dtype=torch.int32)
    value = torch.rand(nnz, generator=gen, device=dev) * 2 - 1
    return rowptr, col, value


def long_row_csr(gen, dev, N):
    """One row of 1,100,000 edges among short and empty ones."""
    deg = torch.tensor([3, 0, 1_100_000, 5, 7, 0], device=dev)
    lrp = torch.zeros(deg.numel() + 1, dtype=torch.int32, device=dev)
    lrp[1:] = deg.cumsum(0)
    lcol = torch.randint(0, N, (int(lrp[-1]),), generator=gen, device=dev,
                         dtype=torch.int32)
    return lrp, lcol


def phase2_spmm(gen, dev):
    from paddle_sparse_tpu_torch import (PaddedCOO, spmm_csr_cuda,
                                         spmm_csr_reference)

    def compare(name, out, rowptr, col, value, x, tol):
        ref = spmm_csr_reference(rowptr, col,
                                 None if value is None else value.double(),
                                 x.double())
        got = out.double()
        err = float((got - ref).abs().max()) if ref.numel() else 0.0
        ok = bool(torch.allclose(got, ref, **tol))
        print(f"phase 2 {name}: out {tuple(out.shape)} {out.dtype} "
              f"max_abs_err {err:.3e} {'ok' if ok else 'FAIL'}", flush=True)
        check(ok, f"kernel disagrees with plain f64 on {name} (max abs err "
                  f"{err:.3e}, tol {tol})")

    M, N = 3000, 2000
    rowptr, col, value = random_csr(gen, dev, M, N, 40)
    for K in (1, 8, 47, 100, 256):
        x = torch.randn(N, K, generator=gen, device=dev)
        out = spmm_csr_cuda(rowptr, col, value, x)
        compare(f"K={K} f32", out, rowptr, col, value, x, F32_TOL)
        check(not out[[0, M // 3, M - 1]].any(), "empty rows not zero")
        xb, vb = x.bfloat16(), value.bfloat16()
        out = spmm_csr_cuda(rowptr, col, vb, xb)
        check(out.dtype == torch.bfloat16, "bf16 inputs must give bf16 out")
        compare(f"K={K} bf16", out, rowptr, col, vb, xb, BF16_TOL)
    x = torch.randn(N, 47, generator=gen, device=dev)
    compare("K=47 f32 value=None", spmm_csr_cuda(rowptr, col, None, x),
            rowptr, col, None, x, F32_TOL)
    xb = torch.randn(N, 256, generator=gen, device=dev).bfloat16()
    compare("K=256 bf16 value=None", spmm_csr_cuda(rowptr, col, None, xb),
            rowptr, col, None, xb, BF16_TOL)
    xb = torch.randn(N, 100, generator=gen, device=dev).bfloat16()
    out = spmm_csr_cuda(rowptr, col, value, xb)
    check(out.dtype == torch.float32, "f32 value with bf16 x gives f32 out")
    compare("K=100 bf16 x, f32 value", out, rowptr, col, value, xb, F32_TOL)

    # one row of 1,100,000 edges; small-integer inputs keep every sum exact
    # in f32, so this case checks the long walk and not rounding
    lrp, lcol = long_row_csr(gen, dev, N)
    lval = torch.randint(-2, 3, (lcol.numel(),), generator=gen,
                         device=dev).float()
    for K, dt, tol in ((256, torch.float32, F32_TOL),
                       (47, torch.float32, F32_TOL),
                       (8, torch.bfloat16, BF16_TOL)):
        x = torch.randint(-4, 5, (N, K), generator=gen, device=dev).to(dt)
        v = lval.to(dt)
        compare(f"1.1M-edge row K={K} {dt}", spmm_csr_cuda(lrp, lcol, v, x),
                lrp, lcol, v, x, tol)

    # padded PaddedCOO: pads must never be read; poisoning their col with an
    # index far outside x makes a read fault
    prow = torch.repeat_interleave(
        torch.arange(M, device=dev), (rowptr[1:] - rowptr[:-1]).long())
    adj = PaddedCOO.from_arrays(prow, col, value, (M, N),
                                capacity=col.numel() + 1000, device=dev)
    x = torch.randn(N, 64, generator=gen, device=dev)
    with torch.inference_mode():
        compare("PaddedCOO +1000 pads K=64", adj.spmm(x), rowptr, col,
                value, x, F32_TOL)
        poisoned = dataclasses.replace(adj, col=torch.where(
            adj.valid_mask(), adj.col, torch.full_like(adj.col, 1 << 30)))
        out = poisoned.spmm(x)
        torch.cuda.synchronize()
        compare("PaddedCOO pads col=2**30 K=64", out, rowptr, col, value, x,
                F32_TOL)


def phase2b_sddmm(gen, dev):
    from paddle_sparse_tpu_torch import (PaddedCOO, sddmm_csr_cuda,
                                         sddmm_csr_reference)

    def compare(name, out, rowptr, col, g, x, tol):
        ref = sddmm_csr_reference(rowptr, col, g.double(), x.double(),
                                  out_dtype=torch.float64)
        got = out.double()
        err = float((got - ref).abs().max()) if ref.numel() else 0.0
        ok = bool(torch.allclose(got, ref, **tol))
        print(f"phase 2b {name}: dv {tuple(out.shape)} {out.dtype} "
              f"max_abs_err {err:.3e} {'ok' if ok else 'FAIL'}", flush=True)
        check(ok, f"SDDMM kernel disagrees with plain f64 on {name} (max abs "
                  f"err {err:.3e}, tol {tol})")

    M, N = 3000, 2000
    rowptr, col, _ = random_csr(gen, dev, M, N, 40)      # with empty rows
    for K in (1, 8, 47, 100, 256):
        g = torch.randn(M, K, generator=gen, device=dev)
        x = torch.randn(N, K, generator=gen, device=dev)
        compare(f"K={K} f32", sddmm_csr_cuda(rowptr, col, g, x), rowptr,
                col, g, x, F32_TOL)
        gb, xb = g.bfloat16(), x.bfloat16()
        compare(f"K={K} bf16 in, f32 out", sddmm_csr_cuda(rowptr, col, gb, xb),
                rowptr, col, gb, xb, F32_TOL)
        out = sddmm_csr_cuda(rowptr, col, gb, xb, out_dtype=torch.bfloat16)
        check(out.dtype == torch.bfloat16, "out_dtype bf16 not honoured")
        compare(f"K={K} bf16 in, bf16 out", out, rowptr, col, gb, xb,
                BF16_TOL)

    # padded PaddedCOO: pad slots read back 0, poisoned pad cols never read
    prow = torch.repeat_interleave(
        torch.arange(M, device=dev), (rowptr[1:] - rowptr[:-1]).long())
    adj = PaddedCOO.from_arrays(prow, col, None, (M, N),
                                capacity=col.numel() + 1000, device=dev)
    poisoned = dataclasses.replace(adj, col=torch.where(
        adj.valid_mask(), adj.col, torch.full_like(adj.col, 1 << 30)))
    g = torch.randn(M, 64, generator=gen, device=dev)
    x = torch.randn(N, 64, generator=gen, device=dev)
    out = sddmm_csr_cuda(poisoned.rowptr(), poisoned.col, g, x)
    torch.cuda.synchronize()
    check(out.numel() == col.numel() + 1000 and not out[col.numel():].any(),
          "SDDMM pad slots must read back 0")
    compare("PaddedCOO +1000 pads col=2**30 K=64", out[:col.numel()],
            rowptr, col, g, x, F32_TOL)

    # one row of 1,100,000 edges; small-integer inputs make every dot exact
    lrp, lcol = long_row_csr(gen, dev, N)
    for K, dt in ((256, torch.float32), (100, torch.float32),
                  (8, torch.bfloat16)):
        g = torch.randint(-4, 5, (lrp.numel() - 1, K), generator=gen,
                          device=dev).to(dt)
        x = torch.randint(-4, 5, (N, K), generator=gen, device=dev).to(dt)
        compare(f"1.1M-edge row K={K} {dt}", sddmm_csr_cuda(lrp, lcol, g, x),
                lrp, lcol, g, x, dict(rtol=0, atol=0))

    # identity structure: the kernel is mul_rowsum(a, b)
    L = 50_000
    ident_ptr = torch.arange(L + 1, dtype=torch.int32, device=dev)
    ident_col = torch.arange(L, dtype=torch.int32, device=dev)
    for K in (47, 256):
        a = torch.randn(L, K, generator=gen, device=dev)
        b = torch.randn(L, K, generator=gen, device=dev)
        compare(f"identity (mul_rowsum) L={L} K={K}",
                sddmm_csr_cuda(ident_ptr, ident_col, a, b), ident_ptr,
                ident_col, a, b, F32_TOL)


def fused_pair(adj, value, g, x, out_dtype):
    """The two passes that ``spmm_sddmm_csc_cuda`` replaces, as the SpMM
    backward ran them: K2 over the CSR for d value, then ``value[perm]``
    and K1 over the CSC view for d x: ``(d x, d value)``."""
    from paddle_sparse_tpu_torch import sddmm_csr_cuda, spmm_csr_cuda
    s = adj.structure()
    dv = sddmm_csr_cuda(adj.rowptr(), adj.col, g, x, out_dtype=out_dtype,
                        split=s.row_split)
    vt = None if value is None else value.index_select(0, s.perm)
    return spmm_csr_cuda(s.colptr, s.col_t, vt, g, split=s.col_split), dv


def fused_kernel(adj, value, g, x, out_dtype):
    """``spmm_sddmm_csc_cuda`` over ``adj``'s CSC view: ``(d x, d
    value)``."""
    from paddle_sparse_tpu_torch import spmm_sddmm_csc_cuda
    s = adj.structure()
    return spmm_sddmm_csc_cuda(s.colptr, s.col_t, s.perm, value, g, x,
                               out_dtype=out_dtype, split=s.col_split,
                               inv_perm=s.inv_perm)


def phase2c_fused(gen, dev):
    """The fused CSC backward against the pair it replaces, bit for bit,
    and against the plain version in f64 (within GRAD_REL of each entry's
    sum of |terms|), over K, dtypes, value None, empty columns, poisoned
    padding and a column split into pieces; two launches bit for bit."""
    from paddle_sparse_tpu_torch import (CAP, PaddedCOO,
                                         spmm_sddmm_csc_reference)
    from paddle_sparse_tpu_torch.ops.kernels.spmm_sddmm_cuda import (
        csc_order_cuda)
    M, N = 3000, 2000
    rowptr, col, value = random_csr(gen, dev, M, N, 40)
    row = torch.repeat_interleave(torch.arange(M, device=dev),
                                  (rowptr[1:] - rowptr[:-1]).long())
    col = torch.where(col % 97 == 3, 5, col)          # empty columns
    hub = torch.randint(0, M, (2 * CAP + 5,), generator=gen, device=dev)
    graphs = {}
    for name, (r, c, v) in {
            "unsplit": (row, col, value),
            "hub column split": (torch.cat([row, hub]),
                                 torch.cat([col, torch.full_like(hub, 7)]),
                                 torch.cat([value, torch.rand(
                                     hub.numel(), generator=gen,
                                     device=dev)]))}.items():
        order = torch.argsort(r, stable=True)
        adj = PaddedCOO.from_arrays(r[order], c[order], v[order], (M, N),
                                    capacity=r.numel() + 1000, device=dev)
        graphs[name] = dataclasses.replace(adj, col=torch.where(
            adj.valid_mask(), adj.col, torch.full_like(adj.col, 1 << 30)))
    for name, adj in graphs.items():
        s = adj.structure()
        check((s.col_split is None) == (name == "unsplit"),
              f"{name}: column split table {s.col_split}")
        nnz = adj.nnz
        for tag, vdt, xdt, gdt in (
                ("f32", torch.float32, torch.float32, torch.float32),
                ("bf16", torch.bfloat16, torch.bfloat16, torch.bfloat16),
                ("bf16 x, f32 value", torch.float32, torch.bfloat16,
                 torch.float32),
                ("bf16 g and value, f32 x", torch.bfloat16, torch.float32,
                 torch.bfloat16),
                ("f32 value None", None, torch.float32, torch.float32)):
            errs = []
            for K in (1, 3, 47, 64, 100, 256, 300, 520):
                x = torch.randn(N, K, generator=gen, device=dev).to(xdt)
                v = None if vdt is None else adj.value.to(vdt)
                g = torch.randn(M, K, generator=gen, device=dev).to(gdt)
                odt = torch.float32 if v is None else v.dtype
                got = fused_kernel(adj, v, g, x, odt)
                want = fused_pair(adj, v, g, x, odt)
                again = fused_kernel(adj, v, g, x, odt)
                alone = csc_order_cuda(
                    s.colptr, s.col_t, None if v is None
                    else v.index_select(0, s.perm), g, x, odt, s.col_split)
                torch.cuda.synchronize()
                check(torch.equal(alone[0], got[0]) and torch.equal(
                    alone[1], got[1].index_select(0, s.perm)),
                      f"{name} {tag} K={K}: the launch alone differs from "
                      f"the routed call")
                for what, a, b, c in zip(("d x", "d value"), got, want,
                                         again):
                    check(a.dtype == b.dtype and torch.equal(a, b),
                          f"{name} {tag} K={K}: fused {what} differs from "
                          f"the pair's")
                    check(torch.equal(a, c), f"{name} {tag} K={K}: two "
                          f"launches' {what} differ")
                check(not got[1][nnz:].any(), "fused d value at padding")
                f64 = [spmm_sddmm_csc_reference(
                    s.colptr, s.col_t, s.perm, None if v is None else f(v),
                    f(g), f(x), torch.float64, s.inv_perm)
                    for f in (torch.Tensor.double,
                              lambda t: t.double().abs())]
                for i, out in enumerate(got):
                    out_rel = BF16_HALF_ULP if out.dtype == torch.bfloat16 \
                        else 0.0
                    err, ok = _grad_close(out, f64[0][i], f64[1][i], out_rel)
                    check(ok, f"{name} {tag} K={K}: fused "
                              f"{('d x', 'd value')[i]} vs plain f64 "
                              f"({err:.3e})")
                    errs.append(err)
            print(f"phase 2c fused CSC backward, {name}, {tag}, K 1 3 47 64 "
                  f"100 256 300 520: d x and d value equal to K2 + K1 over "
                  f"the CSC view bit for bit, two launches equal, the "
                  f"launch alone equal in CSC order, vs plain f64 "
                  f"max_abs_err {max(errs):.3e} ok", flush=True)


def phase3_toy(dev):
    from paddle_sparse_tpu_torch import entry
    model_c, adj_c, x_c = entry(dev)
    model_h, adj_h, x_h = entry("cpu")
    with torch.inference_mode():
        out_c = model_c(adj_c, x_c)
        out_h = model_h(adj_h, x_h)
    err = float((out_c.cpu() - out_h).abs().max())
    ok = bool(torch.allclose(out_c.cpu(), out_h, **F32_TOL))
    print(f"phase 3 toy GCN 32->64->8, 256 nodes: cuda vs cpu max_abs_err "
          f"{err:.3e} {'ok' if ok else 'FAIL'}", flush=True)
    check(ok, f"toy GCN on the card disagrees with the CPU ({err:.3e})")


def phase3b_toy_train(dev):
    from paddle_sparse_tpu_torch import gcn_loss, train_entry, train_step
    runs = {}
    for where in (dev, "cpu"):
        model, adj, x, y = train_entry(where)
        adj.value.requires_grad_()
        loss0 = gcn_loss(model, adj, x, y)
        loss0.backward()
        # copies: .cpu() of a CPU tensor is the tensor itself, and the
        # SGD steps below accumulate into adj.value.grad in place
        grads = [p.grad.cpu().clone() for p in model.parameters()]
        grads.append(adj.value.grad.cpu().clone())
        t0 = time.perf_counter()
        losses = [float(train_step(model, adj, x, y, LR)) for _ in range(20)]
        step_ms = (time.perf_counter() - t0) * 1e3 / 20
        runs[str(where)] = (float(loss0.detach()), grads, losses, step_ms)
    (lc, gc, sc, ms_c), (lh, gh, sh, ms_h) = runs[str(dev)], runs["cpu"]
    grad_err = max(float((a - b).abs().max()) for a, b in zip(gc, gh))
    step_err = max(abs(a - b) for a, b in zip(sc, sh))
    ok = (abs(lc - lh) <= 1e-5 and step_err <= 1e-4
          and all(torch.allclose(a, b, **F32_TOL) for a, b in zip(gc, gh)))
    print(f"phase 3b toy train step 32->64->8: loss cuda {lc:.6f} cpu "
          f"{lh:.6f}; {len(gc)} grads (params + d value) max_abs_err "
          f"{grad_err:.3e}; 20 SGD steps (lr {LR}) loss {sc[0]:.6f} -> "
          f"{sc[-1]:.6f}, cuda vs cpu max diff {step_err:.3e}; step "
          f"{ms_c:.3f} ms on the card, {ms_h:.3f} ms on the cpu (host clock, "
          f"each loss read back) {'ok' if ok else 'FAIL'}", flush=True)
    check(ok, "toy train step on the card disagrees with the CPU")
    check(sc[-1] < sc[0], "toy SGD did not decrease the loss")


def products_graph(dev):
    """``bench.py:112-145::synthetic_graph`` at its default size: 2,449,029
    nodes of degree 50, uniform cols, U(0,1) values (raw, not normalized)
    and N(0,1) features of width ``GCN_DIMS[0]``, from seed 0."""
    from paddle_sparse_tpu_torch import PaddedCOO
    n, deg_ = PRODUCTS_NODES, PRODUCTS_DEG
    g = torch.Generator(device=dev).manual_seed(0)
    row = torch.arange(n, device=dev, dtype=torch.int32).repeat_interleave(
        deg_)
    col = torch.randint(0, n, (n * deg_,), generator=g, device=dev,
                        dtype=torch.int32)
    val = torch.rand(n * deg_, generator=g, device=dev)
    x = torch.randn(n, GCN_DIMS[0], generator=g, device=dev)
    return PaddedCOO.from_arrays(row, col, val, (n, n)), x


def gcn_layer(adj, h, w, b, relu, ev):
    """One layer of ``GCN.forward`` in its order (``models/gcn.py``: ``w``
    applied before the SpMM where it narrows, ``_transform_first``), with
    the events ``ev[0]`` to ``ev[3]`` recorded at the layer's start, the
    SpMM's start and end, and the layer's end. Returns the SpMM's operand,
    its output and the layer's output."""
    from paddle_sparse_tpu_torch.models.gcn import _transform_first
    first = _transform_first(w)
    ev[0].record()
    op = h @ w if first else h
    ev[1].record()
    s = adj.spmm(op)
    ev[2].record()
    out = (s if first else s @ w) + b
    if relu:
        out = torch.relu(out)
    ev[3].record()
    return op, s, out


def _layer_ms(ev):
    """(SpMM ms, dense ms) of a layer timed by :func:`gcn_layer`."""
    return (ev[1].elapsed_time(ev[2]),
            ev[0].elapsed_time(ev[1]) + ev[2].elapsed_time(ev[3]))


def phase4_forward(dev, card):
    from paddle_sparse_tpu_torch import (CAP, gcn_normalize, init_gcn,
                                         spmm_csr_cuda, spmm_csr_reference)
    n = PRODUCTS_NODES
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    raw, x = products_graph(dev)
    adj = gcn_normalize(raw)
    del raw
    model = init_gcn(torch.Generator().manual_seed(0), *GCN_DIMS,
                     num_layers=3, device=dev)
    torch.cuda.synchronize()
    print(f"phase 4 graph: {n} nodes, {adj.nnz} nnz, GCN "
          f"{GCN_DIMS[0]}->{GCN_DIMS[1]}->{GCN_DIMS[1]}->{GCN_DIMS[2]}; "
          f"set-up {time.perf_counter() - t0:.2f} s {card}", flush=True)

    torch.cuda.reset_peak_memory_stats()
    times = []
    with torch.inference_mode():
        _zero_launch_counts()
        out = model(adj, x)                                     # warm-up
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = model(adj, x)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        counts = _launch_counts()
        launches, sddmm_launches = counts["spmm_csr"], counts["sddmm_csr"]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    split = adj.row_split()
    print(f"phase 4 forward ms: {' '.join(f'{t:.3f}' for t in times)} "
          f"(mean {sum(times) / len(times):.3f}) peak mem {peak_gb:.2f} GB "
          f"{card}", flush=True)
    print(f"phase 4 launches in 4 forwards: spmm_csr {launches} "
          f"({launches / 4:g} per forward), sddmm_csr {sddmm_launches}, "
          f"fold_pieces {counts['fold_pieces']} (longest row "
          f"{int(torch.diff(adj.rowptr()).max())} edges, CAP {CAP}: row "
          f"table {split})", flush=True)
    check(split is None and counts["fold_pieces"] == 0,
          "the uniform graph split rows or launched the fold pass")
    check(launches == 3 * 4, f"expected 3 kernel launches per forward, "
                             f"counted {launches} in 4 forwards")
    check(sddmm_launches == 0, f"the forward launched the SDDMM kernel "
                               f"{sddmm_launches} times")
    check(out.shape == (n, GCN_DIMS[2]) and bool(torch.isfinite(out).all()),
          f"forward output not finite or of shape {tuple(out.shape)}")

    # the layers once more, one by one: per-layer times, and each SpMM's
    # output on sampled rows against an f64 recomputation of those rows
    rowptr = adj.rowptr()
    rows = torch.randperm(n, generator=torch.Generator().manual_seed(2)
                          )[:SAMPLED_ROWS].to(dev)
    start = rowptr[rows].long()
    cnt = (rowptr[rows + 1] - rowptr[rows]).long()
    sub_ptr = torch.zeros(SAMPLED_ROWS + 1, dtype=torch.long, device=dev)
    sub_ptr[1:] = cnt.cumsum(0)
    edge = (torch.repeat_interleave(start - sub_ptr[:-1], cnt)
            + torch.arange(int(sub_ptr[-1]), device=dev))
    sub_col = torch.arange(edge.numel(), device=dev)
    sub_val = adj.value[edge].double()
    h = x
    layer_inputs = []                   # each SpMM's operand
    ev = [_event() for _ in range(4)]
    with torch.inference_mode():
        for i, (w, b) in enumerate(zip(model.weight, model.bias)):
            op, s, h = gcn_layer(adj, h, w, b, i < len(model.weight) - 1,
                                 ev)
            layer_inputs.append(op)
            torch.cuda.synchronize()
            ref = spmm_csr_reference(sub_ptr, sub_col, sub_val,
                                     op[adj.col[edge].long()].double())
            got = s[rows].double()
            err = float((got - ref).abs().max())
            ok = bool(torch.allclose(got, ref, **F32_TOL))
            sp_ms, dense_ms = _layer_ms(ev)
            print(f"phase 4 layer {i}: spmm K={s.shape[1]} "
                  f"{sp_ms:.3f} ms, dense {dense_ms:.3f} ms; {SAMPLED_ROWS} "
                  f"sampled rows vs f64 max_abs_err {err:.3e} "
                  f"{'ok' if ok else 'FAIL'} {card}", flush=True)
            check(ok, f"layer {i} SpMM disagrees with f64 on sampled rows")
    check(torch.allclose(h, out, **F32_TOL),
          "layer-by-layer pass disagrees with the model's forward")

    # one K=256 SpMM, kernel vs plain, timed in turns plain/kernel/kernel/plain
    h2 = layer_inputs[1]
    col, value = adj.col, adj.value
    with torch.inference_mode():
        p1, k1, k2, p2, out_p, out_k = in_turns(
            lambda: spmm_csr_reference(rowptr, col, value, h2),
            lambda: spmm_csr_cuda(rowptr, col, value, h2, split=split), 2, 5)
    max_err = float((out_k - out_p).abs().max())
    ok = bool(torch.allclose(out_k, out_p, **F32_TOL))
    print(f"phase 4 spmm K=256 at {adj.nnz} nnz: kernel {k1:.3f} / "
          f"{k2:.3f} ms, plain {p1:.3f} / {p2:.3f} ms; kernel vs plain "
          f"max_abs_err {max_err:.3e} {'ok' if ok else 'FAIL'} {card}",
          flush=True)
    check(ok, "kernel and plain K=256 SpMM disagree at scale")
    # the same product through torch.sparse.mm on the CSR: the yardstick
    nnz = adj.nnz
    csr = torch.sparse_csr_tensor(rowptr, col[:nnz], value[:nnz], (n, n))
    with torch.inference_mode():
        lib_ms, lib_err = library_timed(
            "torch.sparse.mm (K1's product)",
            lambda: torch.sparse.mm(csr, h2), 3, out_k)
    bound, by = bound_ms(nbytes(rowptr, col[:nnz], value[:nnz], h2, out_k),
                         2 * nnz * h2.shape[1])
    print(f"phase 4 spmm K=256: bound {bound:.3f} ms ({by}); "
          f"torch.sparse.mm {lib_ms} ms (vs kernel max_abs_err {lib_err}) "
          f"{card}", flush=True)
    del csr
    stats = {"launches": launches, "sddmm_launches": sddmm_launches,
             "counts": counts, "max_abs_err": max_err,
             "fwd_ms": sum(times) / len(times),
             "ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
             "bound_ms": bound, "bound_by": by, "library_ms": lib_ms,
             "gather_bound_ms": nnz * h2.shape[1] * h2.element_size()
             / HBM_BYTES_PER_S * 1e3}
    return adj, x, model, stats


def _grad_close(got, ref, scale, out_rel=0.0):
    """Max abs error and whether ``|got - ref| <= GRAD_REL * scale +
    out_rel * |ref|``, with ``scale`` the sum of |terms| of each entry (all
    f64) and ``out_rel`` the rounding of a narrower output."""
    ref = ref.double()
    err = (got.double() - ref).abs()
    bound = GRAD_REL * scale + out_rel * ref.abs() + 1e-30
    return float(err.max()), bool((err <= bound).all())


def _d_x_err(rowptr, col, value, g, d_x, cols):
    """Max abs error, pass flag, max |reference| and edge count of ``d x``
    on the columns ``cols`` against the f64 sum over each column's edges of
    ``value[e] * g[row[e]]``, within GRAD_REL of the sum of |terms|."""
    dev = col.device
    nnz = int(rowptr[-1])
    slot = torch.full((int(d_x.shape[0]),), -1, dtype=torch.long,
                      device=dev)
    slot[cols] = torch.arange(cols.numel(), device=dev)
    edges = torch.nonzero(slot[col[:nnz].long()] >= 0).squeeze(1)
    erow = torch.searchsorted(rowptr.long(), edges, right=True) - 1
    eslot = slot[col[edges].long()]
    terms = value[edges].double()[:, None] * g[erow].double()
    ref = torch.zeros(cols.numel(), terms.shape[1], dtype=torch.float64,
                      device=dev).index_add_(0, eslot, terms)
    scale = torch.zeros_like(ref).index_add_(0, eslot, terms.abs())
    err, ok = _grad_close(d_x[cols], ref, scale)
    return err, ok, float(ref.abs().max()), edges.numel()


def phase5_train(dev, card, adj, x, model):
    from paddle_sparse_tpu_torch import (gcn_loss, sddmm_csr_cuda,
                                         sddmm_csr_reference, train_step)
    n, nnz, L = PRODUCTS_NODES, adj.nnz, len(model.weight)
    gen = torch.Generator(device=dev).manual_seed(5)
    y = torch.randint(0, GCN_DIMS[2], (n,), generator=gen, device=dev)
    adj.value.requires_grad_()      # d value, through the SDDMM kernel

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s = adj.structure()
    torch.cuda.synchronize()
    csc_gb = sum(t.numel() * t.element_size()
                 for t in (s.perm, s.col_t, s.colptr)) / 1e9
    print(f"phase 5 CSC view (perm, col_t, colptr): built in "
          f"{(time.perf_counter() - t0) * 1e3:.3f} ms, {csc_gb:.2f} GB "
          f"{card}", flush=True)

    torch.cuda.reset_peak_memory_stats()
    _zero_launch_counts()
    times, losses = [], []
    for _ in range(4):                                  # 1 warm-up + 3
        adj.value.grad = None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = train_step(model, adj, x, y, LR)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    counts = _launch_counts()
    k1_launches, k2_launches = counts["spmm_csr"], counts["sddmm_csr"]
    fused_launches = counts["spmm_sddmm_csc"]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_ms = sum(times[1:]) / 3
    print(f"phase 5 train step ms (forward + backward + SGD): warm-up "
          f"{times[0]:.3f}, timed {' '.join(f'{t:.3f}' for t in times[1:])} "
          f"(mean {step_ms:.3f}); losses "
          f"{' '.join(f'{v:.6f}' for v in losses)}; peak mem "
          f"{peak_gb:.2f} GB {card}", flush=True)
    print(f"phase 5 launches in 4 steps: spmm_csr {k1_launches} "
          f"({k1_launches / 4:g} per step), sddmm_csr {k2_launches} "
          f"({k2_launches / 4:g} per step), spmm_sddmm_csc "
          f"{fused_launches} ({fused_launches / 4:g} per step)", flush=True)
    # layer 0's SpMM reads the features (no d x): K2 alone; layers 1 and 2
    # need both grads: the fused CSC backward
    check(k1_launches == 3 * 4, f"expected 3 spmm_csr launches per step (the "
                                f"forward), counted {k1_launches}")
    check(k2_launches == 1 * 4, f"expected 1 sddmm_csr launch per step, "
                                f"counted {k2_launches}")
    check(fused_launches == 2 * 4, f"expected 2 spmm_sddmm_csc launches per "
                                   f"step, counted {fused_launches}")
    check(counts["fold_pieces"] == 0 and s.row_split is None
          and s.col_split is None,
          f"the uniform graph's rows or columns split (fold_pieces "
          f"{counts['fold_pieces']})")
    grads = [p.grad for p in model.parameters()] + [adj.value.grad]
    check(all(bool(torch.isfinite(v).all()) for v in grads)
          and all(v == v and abs(v) < float("inf") for v in losses),
          "train step loss or grads not finite")

    # one more step's forward and backward, layer by layer, with CUDA events
    # around each part; the SpMM outputs and inputs keep their grads
    model.zero_grad(set_to_none=True)
    adj.value.grad = None
    ev = [[_event() for _ in range(4)] for _ in range(L)]
    ev_loss = [_event() for _ in range(2)]
    hs, ss = [], []                     # each SpMM's operand and output
    h = x
    for i, (w, b) in enumerate(zip(model.weight, model.bias)):
        op, sp, h = gcn_layer(adj, h, w, b, i < L - 1, ev[i])
        if op.requires_grad:
            op.retain_grad()
        sp.retain_grad()
        hs.append(op)
        ss.append(sp)
    loss = -torch.log_softmax(h, dim=-1).gather(1, y[:, None]).mean()
    ev_loss[0].record()
    loss.backward()
    ev_loss[1].record()
    torch.cuda.synchronize()
    check(torch.allclose(loss.detach(),
                         gcn_loss(model, adj, x, y).detach(), rtol=1e-6,
                         atol=0),
          "layer-by-layer loss disagrees with gcn_loss")
    fwd_parts = []
    for i in range(L):
        sp_ms, dense_ms = _layer_ms(ev[i])
        fwd_parts.append((f"fwd layer {i} spmm K={hs[i].shape[1]}", sp_ms))
        fwd_parts.append((f"fwd layer {i} dense", dense_ms))
    fwd_parts.append(("loss (log_softmax + nll)",
                      ev[L - 1][3].elapsed_time(ev_loss[0])))
    bwd_ms = ev_loss[0].elapsed_time(ev_loss[1])

    # the backward's kernels replayed alone on this step's own inputs
    rowptr, col = adj.rowptr(), adj.col
    value = adj.value.detach()
    gs = [sp.grad for sp in ss]
    bwd_parts = []
    for i in range(L):
        K = hs[i].shape[1]
        if hs[i].requires_grad:
            ms, _ = timed(lambda: fused_kernel(adj, value, gs[i],
                                               hs[i].detach(), value.dtype),
                          1)
            bwd_parts.append((f"bwd layer {i} spmm_sddmm_csc K={K}", ms))
        else:
            ms, _ = timed(lambda: sddmm_csr_cuda(rowptr, col, gs[i], hs[i],
                                                 split=s.row_split), 1)
            bwd_parts.append((f"bwd layer {i} sddmm K={K}", ms))
    rest = bwd_ms - sum(ms for _, ms in bwd_parts)
    bwd_parts.append(("bwd dense/autograd rest", rest))
    total = sum(ms for _, ms in fwd_parts) + bwd_ms
    for name, ms in fwd_parts + bwd_parts:
        print(f"phase 5 part {name}: {ms:.3f} ms ({100 * ms / total:.1f}% of "
              f"{total:.3f} ms forward + backward) {card}", flush=True)

    # d value on sampled edges: the sum over layers of g_i[row] . h_i[col]
    gen_h = torch.Generator().manual_seed(6)
    e = torch.randint(0, nnz, (SAMPLED_EDGES,), generator=gen_h).to(dev)
    er = torch.searchsorted(rowptr.long(), e, right=True) - 1
    ec = col[e].long()
    ref = torch.zeros(SAMPLED_EDGES, dtype=torch.float64, device=dev)
    scale = torch.zeros_like(ref)
    for gi, hi in zip(gs, hs):
        terms = gi[er].double() * hi.detach()[ec].double()
        ref += terms.sum(1)
        scale += terms.abs().sum(1)
    err_dv, ok = _grad_close(adj.value.grad[e], ref, scale)
    print(f"phase 5 d value on {SAMPLED_EDGES} sampled edges vs f64: "
          f"max_abs_err {err_dv:.3e} (max |dv| {float(ref.abs().max()):.3e}) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    check(ok, "d value disagrees with f64 on sampled edges")

    # d x on sampled columns: sum over the column's edges of value * g[row]
    cols = torch.randperm(n, generator=gen_h)[:SAMPLED_COLS].to(dev)
    for i in range(L):
        if not hs[i].requires_grad:
            continue
        err_dx, ok, ref_max, n_edges = _d_x_err(rowptr, col, value, gs[i],
                                                hs[i].grad, cols)
        print(f"phase 5 layer {i} d x on {SAMPLED_COLS} sampled columns "
              f"({n_edges} edges) vs f64: max_abs_err {err_dx:.3e} "
              f"(max |dx| {ref_max:.3e}) {'ok' if ok else 'FAIL'}",
              flush=True)
        check(ok, f"layer {i} d x disagrees with f64 on sampled columns")

    # the SDDMM at K=256 (layer 1) and K=100 (layer 0), kernel vs plain,
    # timed in turns plain/kernel/kernel/plain
    sddmm_stats = {}
    for i in (1, 0):
        gi, hi = gs[i], hs[i].detach()
        K = hi.shape[1]
        p1, k1, k2, p2, out_p, out_k = in_turns(
            lambda: sddmm_csr_reference(rowptr, col, gi, hi),
            lambda: sddmm_csr_cuda(rowptr, col, gi, hi, split=s.row_split),
            2, 5)
        max_err = float((out_k - out_p).abs().max())
        scale = float(out_p.abs().max())
        ok = bool(torch.allclose(out_k, out_p, rtol=1e-4,
                                 atol=GRAD_REL * scale))
        print(f"phase 5 sddmm K={K} at {nnz} nnz: kernel {k1:.3f} / "
              f"{k2:.3f} ms, plain {p1:.3f} / {p2:.3f} ms; kernel vs plain "
              f"max_abs_err {max_err:.3e} (max |dv| {scale:.3e}) "
              f"{'ok' if ok else 'FAIL'} {card}", flush=True)
        check(ok, f"kernel and plain K={K} SDDMM disagree at scale")
        sddmm_stats[K] = {"max_abs_err": max_err, "ms": (k1 + k2) / 2,
                          "plain_ms": (p1 + p2) / 2}
    # K=256 through torch.sparse.sampled_addmm on the CSR: the yardstick
    gi, hi = gs[1], hs[1].detach()
    hi_t = hi.t().contiguous()
    csr = torch.sparse_csr_tensor(rowptr, col[:nnz], value[:nnz], (n, n))
    with torch.no_grad():
        lib_ms, lib_err = library_timed(
            "torch.sparse.sampled_addmm (K2's product)",
            lambda: torch.sparse.sampled_addmm(csr, gi, hi_t, beta=0.0), 2,
            sddmm_csr_cuda(rowptr, col, gi, hi)[:nnz])
    del csr, hi_t
    bound, by = bound_ms(nbytes(rowptr, col[:nnz], gi, hi) + 4 * nnz,
                         2 * nnz * hi.shape[1])
    print(f"phase 5 sddmm K=256: bound {bound:.3f} ms ({by}); "
          f"torch.sparse.sampled_addmm {lib_ms} ms (vs kernel max_abs_err "
          f"{lib_err}) {card}", flush=True)
    sddmm_stats[256].update(bound_ms=bound, bound_by=by, library_ms=lib_ms,
                            gather_bound_ms=nnz * hi.shape[1] * 4
                            / HBM_BYTES_PER_S * 1e3)
    fused = phase5_fused(card, adj, value, gs[1], hs[1].detach())
    return {"losses": losses,
            "spmm_launches": k1_launches, "sddmm_launches": k2_launches,
            "fused_launches": fused_launches, "counts": counts,
            "sddmm": sddmm_stats, "fused": fused, "step_ms": step_ms,
            "peak_gb": peak_gb}


def phase5_fused(card, adj, value, g, h):
    """The fused CSC backward at K=256 f32 on the full graph, on layer 1's
    g and input: in turns with the pair it replaces (K2, ``value[perm]``,
    K1 over the CSC view), both outputs equal bit for bit; against its
    plain version in turns; its two bounds; the two library calls that
    compute its outputs, ``torch.sparse.mm`` of the transpose for d x and
    ``sampled_addmm`` for d value, each in turns with it; and its parts:
    the launch alone on values in CSC order (equal to the routed call) and
    each relay alone."""
    from paddle_sparse_tpu_torch import spmm_sddmm_csc_reference
    from paddle_sparse_tpu_torch.ops.kernels.spmm_sddmm_cuda import (
        csc_order_cuda)
    s, n, nnz, K = adj.structure(), adj.shape[0], adj.nnz, h.shape[1]
    with torch.no_grad():
        q1, f1, f2, q2, out_q, out_f = in_turns(
            lambda: fused_pair(adj, value, g, h, value.dtype),
            lambda: fused_kernel(adj, value, g, h, value.dtype), 3, 3)
        same = all(torch.equal(a, b) for a, b in zip(out_f, out_q))
        print(f"phase 5 spmm_sddmm_csc K={K} f32 at {nnz} nnz, in turns "
              f"with the pair it replaces (K2 + value[perm] + K1 over the "
              f"CSC view): pair {q1:.3f} / {q2:.3f} ms, fused {f1:.3f} / "
              f"{f2:.3f} ms; d x and d value bit for bit "
              f"{'equal' if same else 'DIFFERENT'} {card}", flush=True)
        check(same, "the fused kernel's d x or d value differs from the "
                    "pair's on the full graph")
        del out_q
        p1, k1, k2, p2, out_p, _ = in_turns(
            lambda: spmm_sddmm_csc_reference(s.colptr, s.col_t, s.perm,
                                             value, g, h,
                                             inv_perm=s.inv_perm),
            lambda: fused_kernel(adj, value, g, h, value.dtype), 1, 3)
        errs = [float((a - b).abs().max()) for a, b in zip(out_f, out_p)]
        scale = float(out_p[1].abs().max())
        ok = (bool(torch.allclose(out_f[0], out_p[0], **F32_TOL))
              and bool(torch.allclose(out_f[1], out_p[1], rtol=1e-4,
                                      atol=GRAD_REL * scale)))
        print(f"phase 5 spmm_sddmm_csc K={K}: kernel {k1:.3f} / {k2:.3f} "
              f"ms, plain {p1:.3f} / {p2:.3f} ms; kernel vs plain max_abs_err "
              f"d x {errs[0]:.3e}, d value {errs[1]:.3e} (max |dv| "
              f"{scale:.3e}) {'ok' if ok else 'FAIL'} {card}", flush=True)
        check(ok, "fused kernel and its plain version disagree at scale")
        del out_p
        torch.cuda.empty_cache()
        value_t = value.index_select(0, s.perm)[:nnz]
        at = torch.sparse_csr_tensor(s.colptr, s.col_t[:nnz], value_t,
                                     (n, n))
        lib_dx, ms_a, err_dx = library_in_turns(
            "torch.sparse.mm (A^T @ g, the fused kernel's d x)",
            lambda: torch.sparse.mm(at, g), lambda: fused_kernel(
                adj, value, g, h, value.dtype), 2, out_f[0])
        del at, value_t
        csr = torch.sparse_csr_tensor(adj.rowptr(), adj.col[:nnz],
                                      value[:nnz], (n, n))
        h_t = h.t().contiguous()
        lib_dv, ms_b, err_dv = library_in_turns(
            "torch.sparse.sampled_addmm (the fused kernel's d value)",
            lambda: torch.sparse.sampled_addmm(csr, g, h_t, beta=0.0),
            lambda: fused_kernel(adj, value, g, h, value.dtype), 2,
            out_f[1][:nnz])
        del csr, h_t
        torch.cuda.empty_cache()
        # the pass's parts: the launch alone on values in CSC order, and
        # the two relays around it (value[perm] before, d value read back
        # through inv_perm after), each one gather of 4-byte elements
        value_t = value.index_select(0, s.perm)
        launch_ms, out_t = timed(lambda: csc_order_cuda(
            s.colptr, s.col_t, value_t, g, h, split=s.col_split), 3)
        check(torch.equal(out_t[0], out_f[0]) and torch.equal(
            out_t[1].index_select(0, s.inv_perm), out_f[1]),
            "the fused kernel's launch alone differs from its routed call")
        dv_t = out_t[1]
        del out_t
        gather_ms, _ = timed(dropped(lambda: value.index_select(0, s.perm)),
                             3)
        relay_ms, _ = timed(dropped(lambda: dv_t.index_select(
            0, s.inv_perm)), 3)
        del value_t, dv_t
    print(f"phase 5 spmm_sddmm_csc K={K}: the launch alone {launch_ms:.3f} "
          f"ms, its relays value[perm] {gather_ms:.3f} ms and d value_t"
          f"[inv_perm] {relay_ms:.3f} ms {card}", flush=True)
    moved = nbytes(g, h, out_f[0], s.colptr, s.col_t[:nnz], s.perm[:nnz],
                   value[:nnz], out_f[1][:nnz])
    bound, by = bound_ms(moved, 4 * nnz * K)
    gather = nnz * K * g.element_size() / HBM_BYTES_PER_S * 1e3
    ms = (f1 + f2 + k1 + k2 + ms_a + ms_b) / 6
    print(f"phase 5 spmm_sddmm_csc K={K}: mean {ms:.3f} ms over its six "
          f"turns; bound {bound:.3f} ms ({by}, {moved / 1e9:.2f} GB each "
          f"once), gathered rows {gather:.3f} ms; library torch.sparse.mm "
          f"of the transpose {lib_dx} ms (vs d x max_abs_err {err_dx}), "
          f"sampled_addmm {lib_dv} ms (vs d value max_abs_err {err_dv}) "
          f"{card}", flush=True)
    return {"ms": ms, "pair_ms": (q1 + q2) / 2, "plain_ms": (p1 + p2) / 2,
            "max_abs_err": max(errs), "bound_ms": bound, "bound_by": by,
            "gather_bound_ms": gather, "library_ms": lib_dx,
            "library_d_value_ms": lib_dv, "bit_equal_to_pair": same,
            "launch_ms": launch_ms, "value_relay_ms": gather_ms,
            "d_value_relay_ms": relay_ms}


# ---- phase 4c: K1 on the clustered graph ----------------------------------

# (K, dtype of x and value) of the clustered graph's K1 settings
CLUSTERED_SETTINGS = ((256, torch.float32), (100, torch.float32),
                      (256, torch.bfloat16))
COMMUNITY = 2048    # bench.py's clustered_graph community size


def clustered_graph(dev):
    """``bench.py``'s clustered graph at full scale (``bench_graph``) as a
    ``PaddedCOO`` with its U(0,1) values, and its N(0,1) features at
    K=256 (K=100 takes the first 100 columns)."""
    from paddle_sparse_tpu_torch import PaddedCOO
    row, col, val, x = bench_graph(dev, "clustered", 1.0, 256)
    n = x.shape[0]
    return PaddedCOO.from_arrays(row, col, val, (n, n)), x


def k1_bounds(adj, xs, value):
    """K1's three bounds over ``xs`` in ms: each byte once (pointer, col,
    value, x read, out written), the gathered rows (one row of x per
    edge), and the residual bound: each byte once plus one row per edge
    whose column lies outside its row's community."""
    nnz, K, elt = adj.nnz, xs.shape[1], xs.element_size()
    once = nbytes(adj.rowptr(), adj.col[:nnz], value[:nnz], xs) \
        + adj.M * K * elt
    resid = int(((adj.row[:nnz] // COMMUNITY)
                 != (adj.col[:nnz] // COMMUNITY)).sum())
    ms = 1e3 / HBM_BYTES_PER_S
    t, by = bound_ms(once, 2 * nnz * K)
    return {"bytes_once_ms": t, "bound_by": by,
            "gather_bound_ms": nnz * K * elt * ms,
            "residual_bound_ms": (once + resid * K * elt) * ms,
            "residual_edges": resid}


def phase4c_register_walk(dev, card, adj, x):
    """K1's register walk (``spmm_csr_cuda``) on the clustered graph at
    each of ``CLUSTERED_SETTINGS``, beside its three bounds and
    ``torch.sparse.mm`` on the same CSR."""
    from paddle_sparse_tpu_torch import spmm_csr_cuda
    rowptr, nnz, n = adj.rowptr(), adj.nnz, adj.M
    res = {}
    for K, dt in CLUSTERED_SETTINGS:
        xs = x[:, :K].to(dt).contiguous()
        value = adj.value.to(dt)
        with torch.inference_mode():
            ms, out = timed(lambda: spmm_csr_cuda(rowptr, adj.col, value, xs,
                                                  split=None), 5)
            csr = torch.sparse_csr_tensor(rowptr, adj.col[:nnz],
                                          value[:nnz], (n, n))
            lib_ms, lib_err = library_timed(
                "torch.sparse.mm (clustered K1)",
                lambda: torch.sparse.mm(csr, xs), 3, out)
        b = k1_bounds(adj, xs, value)
        tag = f"K={K} {str(dt).split('.')[-1]}"
        print(f"phase 4c K1 clustered {tag} at {nnz} nnz: register walk "
              f"{ms:.3f} ms; bounds: bytes once {b['bytes_once_ms']:.3f}, "
              f"gathered rows {b['gather_bound_ms']:.3f}, residual "
              f"{b['residual_bound_ms']:.3f} ms ({b['residual_edges']} "
              f"edges outside their community); torch.sparse.mm {lib_ms} "
              f"ms (max_abs_err {lib_err}) {card}", flush=True)
        res[tag] = {"ms": ms, "library_ms": lib_ms, **b}
        del out, csr, xs
        torch.cuda.empty_cache()
    return res


def phase4c_gcn(dev, card, adj, x):
    """Phase 4's GCN (100 -> 256 -> 256 -> 47, seed 0) forward on the
    clustered graph's ``gcn_normalize``-d adjacency, on the main path
    (K1's register walk): 1 warm-up + 3 forwards with counts zeroed just
    before and read just after, then per-layer times."""
    from paddle_sparse_tpu_torch import gcn_normalize, init_gcn
    norm = gcn_normalize(adj)
    model = init_gcn(torch.Generator().manual_seed(0), *GCN_DIMS,
                     num_layers=3, device=dev)
    h0 = x[:, :GCN_DIMS[0]].contiguous()
    with torch.inference_mode():
        model(norm, h0)                         # warm-up
        _zero_launch_counts()
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = model(norm, h0)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        counts = _launch_counts()
        h, layer_ms = h0, []
        ev = [_event() for _ in range(4)]
        for i, (w, bias) in enumerate(zip(model.weight, model.bias)):
            _, _, h = gcn_layer(norm, h, w, bias,
                                i < len(model.weight) - 1, ev)
            torch.cuda.synchronize()
            layer_ms.append(_layer_ms(ev))
    ms = sum(times) / len(times)
    print(f"phase 4c GCN forward on the clustered graph, main path: "
          f"{' '.join(f'{t:.3f}' for t in times)} ms (mean {ms:.3f}); "
          f"launches in 3: " + ", ".join(f"{k} {v}" for k, v in
                                         counts.items() if v)
          + "; per layer spmm / dense ms: "
          + ", ".join(f"{sp:.3f} / {de:.3f}" for sp, de in layer_ms)
          + f" {card}", flush=True)
    check(out.shape == (adj.M, GCN_DIMS[2])
          and bool(torch.isfinite(out).all()),
          "clustered GCN forward not finite or misshapen")
    check(counts["spmm_csr"] == 9 and counts["fold_pieces"] == 0,
          f"the clustered forward launched {counts}")
    return {"ms": ms, "launches": counts, "layer_ms": layer_ms}


def _launch_counts():
    from paddle_sparse_tpu_torch import (compact_runs_cuda, fold_pieces_cuda,
                                         gat_attention_cuda,
                                         sddmm_csr_cuda, sddmm_spans_cuda,
                                         spmm_csr_cuda, spmm_sddmm_csc_cuda,
                                         spmm_sddmm_spans_cuda,
                                         spmm_spans_cuda)
    return {"spmm_csr": spmm_csr_cuda.launches,
            "sddmm_csr": sddmm_csr_cuda.launches,
            "spmm_sddmm_csc": spmm_sddmm_csc_cuda.launches,
            "segcompact": compact_runs_cuda.launches,
            "segcompact_row_sorted": compact_runs_cuda.launches_row_sorted,
            "spmm_spans": spmm_spans_cuda.launches,
            "sddmm_spans": sddmm_spans_cuda.launches,
            "spmm_sddmm_spans": spmm_sddmm_spans_cuda.launches,
            "fold_pieces": fold_pieces_cuda.launches,
            "gat_attention": gat_attention_cuda.launches}


def _zero_launch_counts():
    from paddle_sparse_tpu_torch import (compact_runs_cuda, fold_pieces_cuda,
                                         gat_attention_cuda,
                                         sddmm_csr_cuda, sddmm_spans_cuda,
                                         spmm_csr_cuda, spmm_sddmm_csc_cuda,
                                         spmm_sddmm_spans_cuda,
                                         spmm_spans_cuda)
    spmm_csr_cuda.launches = sddmm_csr_cuda.launches = 0
    spmm_sddmm_csc_cuda.launches = spmm_sddmm_spans_cuda.launches = 0
    compact_runs_cuda.launches = fold_pieces_cuda.launches = 0
    compact_runs_cuda.launches_row_sorted = 0
    spmm_spans_cuda.launches = sddmm_spans_cuda.launches = 0
    gat_attention_cuda.launches = 0


def _same_compacted(got, ref, tol):
    """Max abs value error and whether K5's output equals the plain one's:
    count, coordinates and seg exact, values within ``tol``."""
    err = 0.0
    ok = (int(got.count) == int(ref.count) and torch.equal(got.row, ref.row)
          and torch.equal(got.col, ref.col)
          and (ref.seg is None or torch.equal(got.seg, ref.seg)))
    if ref.value is not None:
        g, r = got.value.double(), ref.value.double()
        err = float((g - r).abs().max()) if r.numel() else 0.0
        ok = ok and bool(torch.allclose(g, r, **tol))
    return err, ok


def phase6a_segcompact(gen, dev):
    from paddle_sparse_tpu_torch import (compact_runs_cuda,
                                         compact_runs_reference)
    f64_sums = dict(rtol=1e-12, atol=1e-12)   # f64 sums in another order

    def compare(name, col, rows, value, shape, cap, tol=f64_sums, **kw):
        got = compact_runs_cuda(col, rows, value, shape, cap, seg=True, **kw)
        ref = compact_runs_reference(
            col, rows, None if value is None else value.double(), shape, cap,
            seg=True, **kw)
        torch.cuda.synchronize()
        err, ok = _same_compacted(got, ref, tol)
        print(f"phase 6a {name}: {col.numel()} elements, {int(ref.count)} "
              f"runs, cap {cap}: max_abs_err {err:.3e} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        check(ok, f"K5 disagrees with plain f64 on {name}")
        return int(ref.count)

    def grid(R, F, N, dtype=torch.float64):
        fill = torch.randint(0, F + 1, (R,), generator=gen, device=dev)
        fill[0], fill[-1] = 0, F                       # empty, full rows
        key = torch.randint(0, N, (R, F), generator=gen, device=dev,
                            dtype=torch.int32)
        key = torch.where(torch.arange(F, device=dev) < fill[:, None], key, N)
        key = key.sort(dim=1).values.contiguous()
        val = torch.randn(R, F, generator=gen, device=dev, dtype=torch.float64)
        return key, torch.where(key < N, val, 0.0).to(dtype).contiguous()

    for R, F, N in ((7, 16, 12), (5, 32, 6), (3000, 64, 500),
                    (20_000, 256, 100_000), (64, 1, 3)):
        key, val = grid(R, F, N)
        rows = torch.arange(R, dtype=torch.int32, device=dev)
        cap = int((key < N).sum()) + 5
        compare(f"grid ({R}, {F}) N={N} f64", key, rows, val, (R, N), cap)
        count = compare(f"grid ({R}, {F}) N={N} structure only", key, rows,
                        None, (R, N), cap)
        if count > 1000:
            compare(f"grid ({R}, {F}) N={N} out_capacity count-1000", key,
                    rows, val, (R, N), count - 1000)
    key, val = grid(3000, 64, 500, torch.float32)
    compare("grid (3000, 64) N=500 f32", key,
            torch.arange(3000, dtype=torch.int32, device=dev), val,
            (3000, 500), 200_000, dict(rtol=1e-5, atol=1e-5))
    key, val = grid(777, 40, 90)
    compare("row block: grid rows 5000..5776", key,
            torch.arange(5000, 5777, dtype=torch.int32, device=dev), val,
            (6000, 90), 40_000)
    M, N, L, pads = 3000, 400, 200_000, 3001
    k = (torch.randint(0, M, (L,), generator=gen, device=dev) * (N + 1)
         + torch.randint(0, N, (L,), generator=gen, device=dev)).sort().values
    k = torch.cat([k, torch.full((pads,), M * (N + 1) + N, device=dev)])
    val = torch.randn(L + pads, generator=gen, device=dev, dtype=torch.float64)
    val[L:] = 0
    compare("flat (row, col)-sorted stream", (k % (N + 1)).int(),
            (k // (N + 1)).int(), val, (M, N), L + 10)
    for run in (100_000, 1_100_000):
        # small integers keep the f32 sum of the long run exact
        col = torch.cat([torch.tensor([0, 0, 1], device=dev),
                         torch.full((run,), 2, device=dev),
                         torch.tensor([3, 3, 5], device=dev)]).int()
        v = torch.randint(-3, 4, (col.numel(),), generator=gen,
                          device=dev).float()
        compare(f"one run of {run} elements f32", col, torch.zeros_like(col),
                v, (1, 6), 8, dict(rtol=0, atol=0))

    # grid rows in the expansion's order: the kernel sorts them itself; ties
    # of equal cols down to N = 2; the 64-bit key at N = 2**30
    for R, F, N in ((3000, 64, 500), (20_000, 256, 100_000), (500, 24, 3),
                    (97, 1000, 40), (41, 1024, 2), (50, 300, 1 << 30)):
        key, val = grid(R, F, N, torch.float32)
        perm = torch.rand(R, F, generator=gen, device=dev).argsort(1)
        key = key.gather(1, perm).contiguous()
        val = val.gather(1, perm).contiguous()
        rows = torch.arange(R, dtype=torch.int32, device=dev)
        args = (key, rows, val, (R, N), int((key < N).sum()) + 5)
        compare(f"unsorted grid ({R}, {F}) N={N} f32", *args,
                dict(rtol=1e-5, atol=1e-5), rows_sorted=False)
        same = _same_bits(compact_runs_cuda(*args, seg=True,
                                            rows_sorted=False),
                          _k5_presorted_twin(args, {"seg": True}))
        print(f"phase 6a unsorted grid ({R}, {F}) N={N}: equal to "
              f"torch.sort + the presorted mode bit for bit: {same}",
              flush=True)
        check(same, f"K5's row sort differs from torch.sort at ({R}, {F})")

    # long runs in flat mode, normal f32 values, summed across lanes, warps
    # and tiles: within 1e-6 of each run's sum of |terms|; two launches equal
    for run in (100_000, 1_100_000, 10_000_000):
        lens = torch.tensor([3, run, 1, 5000, 2, run // 3, 7], device=dev)
        col = torch.repeat_interleave(torch.arange(7, device=dev), lens).int()
        row = torch.zeros_like(col)
        v = torch.randn(col.numel(), generator=gen, device=dev)
        a = compact_runs_cuda(col, row, v, (1, 7), 9, seg=True)
        b = compact_runs_cuda(col, row, v, (1, 7), 9, seg=True)
        ref = compact_runs_reference(col, row, v.double(), (1, 7), 9,
                                     seg=True)
        scale = compact_runs_reference(col, row, v.double().abs(), (1, 7),
                                       9).value
        err = float((a.value.double() - ref.value).abs().max())
        ok = (int(a.count) == 7 and torch.equal(a.row, ref.row)
              and torch.equal(a.col, ref.col) and torch.equal(a.seg, ref.seg)
              and bool(((a.value.double() - ref.value).abs()
                        <= 1e-6 * scale).all()) and _same_bits(a, b))
        print(f"phase 6a flat runs of {run} and {run // 3} elements, normal "
              f"f32: max_abs_err {err:.3e} vs f64 (within 1e-6 of the sum "
              f"of |terms|), two launches equal {'ok' if ok else 'FAIL'}",
              flush=True)
        check(ok, f"K5's flat mode disagrees on runs of {run}")


def _same_bits(a, b):
    """Two compactions equal bit for bit: count, coordinates, values, seg."""
    same = (int(a.count) == int(b.count) and torch.equal(a.row, b.row)
            and torch.equal(a.col, b.col))
    if a.value is not None:
        same = same and torch.equal(a.value.view(torch.int8),
                                    b.value.view(torch.int8))
    if a.seg is not None and b.seg is not None:
        same = same and torch.equal(a.seg, b.seg)
    return same


def _k5_presorted_twin(args, kw):
    """What the grid paths did before K5 sorted rows itself: ``torch.sort``
    (stable) of each grid row, the values gathered along, then K5's
    presorted mode; ``seg`` mapped back to the input's order."""
    from paddle_sparse_tpu_torch import compact_runs_cuda
    key, rows, val = args[:3]
    sk, perm = torch.sort(key, dim=1, stable=True)
    sv = None if val is None else val.gather(1, perm)
    out = compact_runs_cuda(sk, rows, sv, *args[3:],
                            **{**kw, "rows_sorted": True})
    if out.seg is None:
        return out
    seg = torch.empty_like(out.seg).view(key.shape).scatter_(
        1, perm, out.seg.view(key.shape))
    return out._replace(seg=seg.reshape(-1))


def phase6b_toy_spgemm(dev):
    from paddle_sparse_tpu_torch import (plan_spgemm, plan_spgemm_blocked,
                                         plan_spgemm_rows, spgemm_entry,
                                         spspmm_padded, spspmm_rowblocked,
                                         spspmm_rowsorted)
    runs = {}
    for where in (dev, "cpu"):
        A = spgemm_entry(where)
        v = A.value.clone().requires_grad_()
        Ai = A.with_value(v)
        F, oc = plan_spgemm_rows(Ai, Ai)
        fc, oc2 = plan_spgemm(Ai, Ai)
        blocked = plan_spgemm_blocked(Ai, Ai)
        G = torch.linspace(-1, 1, 20_000, device=where)
        for name, res in (
                ("rowsorted", spspmm_rowsorted(Ai, Ai, F, oc)),
                ("padded", spspmm_padded(Ai, Ai, fc, oc2)),
                ("rowblocked", spspmm_rowblocked(Ai, Ai, blocked[0],
                                                 blocked[1], 64, Ai.capacity,
                                                 blocked[4]))):
            (res.matrix.value * G[:res.matrix.capacity]).sum().backward(
                retain_graph=True)
            C = res.matrix
            runs[str(where), name] = (C.nnz, res.overflowed, C.row.cpu(),
                                      C.col.cpu(), C.value.detach().cpu(),
                                      v.grad.cpu().clone())
            v.grad = None
    for name in ("rowsorted", "padded", "rowblocked"):
        c, h = runs[str(dev), name], runs["cpu", name]
        err_v = float((c[4] - h[4]).abs().max())
        err_g = float((c[5] - h[5]).abs().max())
        ok = (c[0] == h[0] and not c[1] and not h[1]
              and torch.equal(c[2], h[2]) and torch.equal(c[3], h[3])
              and torch.allclose(c[4], h[4], **F32_TOL)
              and torch.allclose(c[5], h[5], **F32_TOL))
        print(f"phase 6b toy A @ A ({name}), 256 nodes: nnz {c[0]}; cuda vs "
              f"cpu structure equal, values max_abs_err {err_v:.3e}, d value "
              f"max_abs_err {err_g:.3e} {'ok' if ok else 'FAIL'}", flush=True)
        check(ok, f"toy A @ A ({name}) on the card disagrees with the CPU")


def spgemm_operand(dev, num_nodes, deg, zipf_alpha=None):
    """``bench.py::_spgemm_operand`` in torch: rows ``arange // deg`` (or
    zipf degrees from numpy seed 0, as there), uniform random cols and
    U(0, 1) values from a seeded generator, then ``from_arrays`` and
    ``coalesce()`` (adjacent duplicates merge; cols within a row stay
    unsorted, as in the JAX operand)."""
    import numpy as np

    from paddle_sparse_tpu_torch import PaddedCOO
    g = torch.Generator(device=dev).manual_seed(1 if zipf_alpha is None
                                                else 2)
    if zipf_alpha is None:
        nnz = num_nodes * deg
        row = torch.arange(nnz, device=dev, dtype=torch.int32) // deg
    else:
        w = np.random.default_rng(0).zipf(zipf_alpha, num_nodes).astype(
            np.float64)
        degs = np.maximum(1, np.floor(w * (num_nodes * deg / w.sum())))
        degs = torch.as_tensor(degs.astype(np.int64), device=dev)
        row = torch.arange(num_nodes, device=dev,
                           dtype=torch.int32).repeat_interleave(degs)
        nnz = row.numel()
    col = torch.randint(0, num_nodes, (nnz,), generator=g, device=dev,
                        dtype=torch.int32)
    val = torch.rand(nnz, generator=g, device=dev)
    return PaddedCOO.from_arrays(row, col, val,
                                 (num_nodes, num_nodes)).coalesce()


class _RecordCompress:
    """Keeps the arguments of every K5 call made inside the ``with``: the
    compress inputs exactly as the SpGEMM path hands them over. Launches
    inside count on the recorder, not on the wrapper's counter."""

    def __enter__(self):
        from paddle_sparse_tpu_torch.ops.kernels import segcompact_cuda
        self.module, self.orig, self.calls = (
            segcompact_cuda, segcompact_cuda.compact_runs_cuda, [])

        def record(*args, **kw):
            self.calls.append((args, kw))
            return self.orig(*args, **kw)

        record.launches = record.launches_row_sorted = 0
        segcompact_cuda.compact_runs_cuda = record
        return self.calls

    def __exit__(self, *exc):
        self.module.compact_runs_cuda = self.orig


def _check_sampled_rows(A, C, rows):
    """C's ``rows`` against scipy's f64 ``A[rows] @ A`` from host copies of
    A's entries: structure exact, values within f32 rounding."""
    import numpy as np
    import scipy.sparse as sp
    n = A.nnz
    a = sp.csr_matrix((A.value[:n].double().cpu().numpy(),
                       (A.row[:n].cpu().numpy(), A.col[:n].cpu().numpy())),
                      shape=A.shape)
    want = (a[rows.cpu().numpy()] @ a).tocsr()
    want.sort_indices()
    rp = C.rowptr().long()
    lo, hi = rp[rows], rp[rows + 1]
    cnt = hi - lo
    idx = (torch.repeat_interleave(lo - torch.cumsum(cnt, 0) + cnt, cnt)
           + torch.arange(int(cnt.sum()), device=lo.device))
    got_ptr = np.concatenate([[0], torch.cumsum(cnt, 0).cpu().numpy()])
    got_col = C.col[idx].cpu().numpy()
    got_val = C.value[idx].detach().double().cpu().numpy()
    ok = (np.array_equal(got_ptr, want.indptr)
          and np.array_equal(got_col, want.indices))
    err = float(np.abs(got_val - want.data).max()) if ok else float("inf")
    ok = ok and bool(np.allclose(got_val, want.data, rtol=1e-5, atol=1e-6))
    return err, ok, int(cnt.sum())


def _sampled_rows(A, n_rows=1024, seed=3):
    """1024 random rows of A, with its row of most entries among them."""
    n, M = A.nnz, A.shape[0]
    deg = torch.bincount(A.row[:n].long(), minlength=M)
    rows = torch.randperm(M, generator=torch.Generator().manual_seed(seed))
    rows = torch.cat([deg.argmax().view(1).cpu(), rows[:n_rows - 1]])
    return rows.unique().to(A.row.device)


def phase6c_spgemm_path(dev, card, name, A, kind):
    """Plan and run one A @ A path at scale: times, launches, checks, and
    K5 alone on the path's own compress input, kernel vs plain."""
    from paddle_sparse_tpu_torch import (compact_runs_cuda,
                                         compact_runs_reference, plan_spgemm,
                                         plan_spgemm_blocked, plan_spgemm_rows,
                                         spspmm_padded, spspmm_rowblocked,
                                         spspmm_rowsorted)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if kind == "rowsorted":
        F, oc = plan_spgemm_rows(A, A)
        check(F is not None, f"{name}: plan_spgemm_rows refused")

        def call():
            return spspmm_rowsorted(A, A, F, oc)
        plan = {"F": F, "out_cap": oc}
    elif kind == "rowblocked":
        blocked = plan_spgemm_blocked(A, A)
        check(blocked is not None, f"{name}: plan_spgemm_blocked refused")

        def call():
            return spspmm_rowblocked(A, A, *blocked)
        plan = dict(zip(("F", "out_cap", "MB", "EB", "BOC"), blocked))
    else:       # the planners' choice, as bench.py's power-law probe
        check(plan_spgemm_blocked(A, A) is None
              and plan_spgemm_rows(A, A)[0] is None,
              f"{name}: the grid planners accepted the skewed operand")
        fc, oc = plan_spgemm(A, A, exact_out=False)

        def call():
            return spspmm_padded(A, A, fc, oc)
        plan = {"flop_cap": fc, "out_cap": oc}
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base_gb = torch.cuda.memory_allocated() / 1e9
    _zero_launch_counts()
    times = []
    with torch.inference_mode():
        for _ in range(4):                              # 1 warm-up + 3
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = call()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    launches = _launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ms = sum(times[1:]) / 3
    C = res.matrix
    rate = C.nnz / ms / 1e3
    print(f"phase 6c {name}: A {A.nnz} nnz {A.shape}, plan {plan} in "
          f"{plan_s:.3f} s; ms per call: warm-up {times[0]:.3f}, timed "
          f"{' '.join(f'{t:.3f}' for t in times[1:])} (mean {ms:.3f}); "
          f"c_nnz {C.nnz}, {rate:.1f} output Mnnz/s; peak mem {peak_gb:.2f} "
          f"GB (A and the plan {base_gb:.2f} GB); overflowed "
          f"{res.overflowed} {card}", flush=True)
    print(f"phase 6c {name} launches in 4 calls: segcompact "
          f"{launches['segcompact']} (rows sorted by K5 "
          f"{launches['segcompact_row_sorted']}), spmm_csr "
          f"{launches['spmm_csr']}, sddmm_csr {launches['sddmm_csr']}",
          flush=True)
    per_call = -(-A.shape[0] // plan["MB"]) if "MB" in plan else 1
    check(launches["segcompact"] == 4 * per_call,
          f"{name}: expected {4 * per_call} K5 launches (one per call and "
          f"row block), counted {launches['segcompact']}")
    grid_path = kind != "padded"
    check(launches["segcompact_row_sorted"] == (4 * per_call if grid_path
                                                else 0),
          f"{name}: K5's row sort ran {launches['segcompact_row_sorted']} "
          f"times in 4 calls")
    check(not res.overflowed, f"{name}: overflowed")
    check(bool(torch.isfinite(C.value[:C.nnz]).all()), f"{name}: not finite")

    rows = _sampled_rows(A)
    err, ok, n_cmp = _check_sampled_rows(A, C, rows)
    print(f"phase 6c {name}: {rows.numel()} sampled rows of C ({n_cmp} "
          f"entries, A's longest row among them) vs "
          f"scipy f64 A[rows] @ A: max_abs_err {err:.3e} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    check(ok, f"{name}: sampled rows of C disagree with f64")

    stages = spgemm_stages(call, name, card)

    # K5 alone on this path's own (largest) compress input, in turns
    c_nnz = C.nnz
    del res, C
    with torch.inference_mode(), _RecordCompress() as calls:
        call()
    args, kw = max(calls, key=lambda c: c[0][0].numel())
    del calls
    with torch.inference_mode():
        p1, k1, k2, p2, out_p, out_k = in_turns(
            lambda: compact_runs_reference(*args, **kw),
            lambda: compact_runs_cuda(*args, **kw), 3, 10)
    err, ok = _same_compacted(out_k, out_p, F32_TOL)
    print(f"phase 6c {name} compress (K5) on the call's "
          f"{tuple(args[0].shape)} input (rows sorted by K5: "
          f"{kw.get('rows_sorted') is False}), {int(out_p.count)} runs: "
          f"kernel {k1:.3f} / {k2:.3f} ms, plain {p1:.3f} / {p2:.3f} ms; "
          f"kernel vs plain max_abs_err {err:.3e} {'ok' if ok else 'FAIL'} "
          f"{card}", flush=True)
    check(ok, f"{name}: K5 and its plain version disagree at scale")
    del out_p
    old_ms = pre_ms = None
    if kw.get("rows_sorted") is False:
        # what K5's row sort replaces: torch.sort + gather + presorted K5
        with torch.inference_mode():
            o1, n1, n2, o2, out_old, _ = in_turns(
                lambda: _k5_presorted_twin(args, kw),
                lambda: compact_runs_cuda(*args, **kw), 10, 10)
        same = _same_bits(out_k, out_old)
        old_ms = (o1 + o2) / 2
        del out_old
        # the presorted mode alone on the sorted grid: the row sort's share
        sk, perm = torch.sort(args[0], dim=1, stable=True)
        sv = None if args[2] is None else args[2].gather(1, perm)
        with torch.inference_mode():
            pre_ms, _ = timed(lambda: compact_runs_cuda(
                sk, args[1], sv, *args[3:], **{**kw, "rows_sorted": True}),
                10)
        del sk, perm, sv
        print(f"phase 6c {name} K5 with its row sort {n1:.3f} / {n2:.3f} ms "
              f"vs torch.sort + gather + presorted K5 {o1:.3f} / {o2:.3f} "
              f"ms in turns (presorted K5 alone {pre_ms:.3f} ms); C bit for "
              f"bit equal: {same} {card}", flush=True)
        check(same, f"{name}: K5's row sort and torch.sort + presorted K5 "
                    f"give different bits")
    ins = [a for a in (*args, *kw.values()) if isinstance(a, torch.Tensor)]
    moved = nbytes(*ins, out_k.row, out_k.col, out_k.value, out_k.seg)
    bound, by = bound_ms(moved, args[0].numel())     # one add per element
    lib_ms, lib_k_ms, lib_err = k5_library(name, card, args, kw, out_k)
    return {"launches": launches, "ms": ms, "c_nnz": c_nnz,
            "stages_ms": stages,
            "k5": {"max_abs_err": err, "ms": (k1 + k2) / 2,
                   "plain_ms": (p1 + p2) / 2, "bound_ms": bound,
                   "bound_by": by, "library_ms": lib_ms,
                   "ms_beside_library": lib_k_ms,
                   "library_max_abs_err": lib_err,
                   "old_sort_gather_k5_ms": old_ms,
                   "presorted_ms": pre_ms,
                   "mode": ("grid, rows sorted by K5"
                            if kw.get("rows_sorted") is False else
                            "flat stream")}}


def spgemm_stages(call, name, card):
    """CUDA events around the stages of one A @ A call: the expansion
    (``_sorted_row_grid``: the grid, and its torch.sort where F > F_MAX) and
    the compress (``compact_runs``, K5), then the rest (fan-out, host read,
    stitching); ms of each, summed over row blocks."""
    from paddle_sparse_tpu_torch.core import spgemm
    marks = {"expansion": [], "compress (K5)": []}
    orig = spgemm._sorted_row_grid, spgemm.compact_runs

    def timed_stage(stage, fn):
        def run(*a, **k):
            ev = _event(), _event()
            ev[0].record()
            out = fn(*a, **k)
            ev[1].record()
            marks[stage].append(ev)
            return out
        return run

    spgemm._sorted_row_grid = timed_stage("expansion", orig[0])
    spgemm.compact_runs = timed_stage("compress (K5)", orig[1])
    try:
        with torch.inference_mode():
            torch.cuda.synchronize()
            whole = _event(), _event()
            whole[0].record()
            call()
            whole[1].record()
            torch.cuda.synchronize()
    finally:
        spgemm._sorted_row_grid, spgemm.compact_runs = orig
    ms = {k: sum(a.elapsed_time(b) for a, b in v) for k, v in marks.items()}
    ms["call"] = whole[0].elapsed_time(whole[1])
    ms["rest"] = ms["call"] - ms["expansion"] - ms["compress (K5)"]
    print(f"phase 6c {name} stages of one call (CUDA events): "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in ms.items())
          + f" {card}", flush=True)
    return ms


def k5_library(name, card, args, kw, out_k):
    """K5's library call on K5's own input: ``torch.sparse_coo_tensor
    (...).coalesce()`` sorts the elements by (row, col) and sums the runs of
    equal coordinates, in turns with K5. The COO indices of the input's real
    elements are made outside the timing."""
    from paddle_sparse_tpu_torch import compact_runs_cuda
    col, rows, value, shape = args[:4]
    r = rows[:, None].expand_as(col) if col.dim() == 2 else rows
    keep = (col < shape[1]) & (r < shape[0])
    idx = torch.stack([r[keep], col[keep]]).long()
    vals = (torch.ones(idx.shape[1], device=idx.device) if value is None
            else value[keep])
    n = int(out_k.count)
    with torch.inference_mode():
        lib_ms, k_ms, err = library_in_turns(
            "torch.sparse_coo_tensor(...).coalesce() (K5's function)",
            lambda: torch.sparse_coo_tensor(idx, vals, shape).coalesce(),
            lambda: compact_runs_cuda(*args, **kw), 5, out_k.value[:n])
    print(f"phase 6c {name} K5's library call, torch.sparse_coo_tensor"
          f"(...).coalesce() on the same {idx.shape[1]} elements: "
          f"{lib_ms} ms vs K5 {k_ms:.3f} ms in turns (values max_abs_err "
          f"{err}) {card}", flush=True)
    return lib_ms, k_ms, err


def phase6c_value_grad(dev, A):
    """d value of ``sum(G * C)``, C = A @ A with the two operands as
    separate leaves, on sampled entries of each against f64."""
    from paddle_sparse_tpu_torch import plan_spgemm_rows, spspmm_rowsorted
    F, oc = plan_spgemm_rows(A, A)
    va = A.value.clone().requires_grad_()
    vb = A.value.clone().requires_grad_()
    C = spspmm_rowsorted(A.with_value(va), A.with_value(vb), F, oc).matrix
    G = torch.randn(C.capacity, generator=torch.Generator(
        device=dev).manual_seed(7), device=dev)
    (C.value * G).sum().backward()

    n, N = A.nnz, A.shape[1]
    row, col = A.row[:n].long(), A.col[:n].long()
    val = A.value[:n].double()
    rowptr = A.rowptr().long()
    ckey = C.row[:C.nnz].long() * (N + 1) + C.col[:C.nnz].long()
    Gd = G.double()

    def g_at(r, c):
        return Gd[torch.searchsorted(ckey, r * (N + 1) + c)]

    e = torch.randperm(n, generator=torch.Generator().manual_seed(8))[
        :SAMPLED_EDGES // 16].to(dev)
    worst, ok = 0.0, True
    for side, grad in (("left", va.grad), ("right", vb.grad)):
        refs, scales = [], []
        for i in e.tolist():
            if side == "left":      # sum over B's row col[i]
                lo, hi = rowptr[col[i]], rowptr[col[i] + 1]
                t = g_at(row[i], col[lo:hi]) * val[lo:hi]
            else:                   # sum over A's entries in column row[i]
                a = torch.nonzero(col == row[i]).squeeze(1)
                t = g_at(row[a], col[i]) * val[a]
            refs.append(t.sum())
            scales.append(t.abs().sum())
        err, good = _grad_close(grad[e], torch.stack(refs),
                                torch.stack(scales))
        worst, ok = max(worst, err), ok and good
        print(f"phase 6c 800k d value ({side} operand) on {e.numel()} sampled "
              f"entries vs f64: max_abs_err {err:.3e} "
              f"{'ok' if good else 'FAIL'}", flush=True)
    check(ok, "SpGEMM value grads disagree with f64 on sampled entries")


def phase6c_spgemm(dev, card):
    paths = {}
    A = spgemm_operand(dev, 50_000, 16)
    paths["spgemm_800k_rowsorted"] = phase6c_spgemm_path(
        dev, card, "800k rowsorted", A, "rowsorted")
    phase6c_value_grad(dev, A)
    del A
    A = spgemm_operand(dev, 625_000, 16)
    for kind in ("rowsorted", "rowblocked"):
        paths[f"spgemm_10M_{kind}"] = phase6c_spgemm_path(
            dev, card, f"10M {kind}", A, kind)
    del A
    A = spgemm_operand(dev, 100_000, 16, zipf_alpha=1.5)
    paths["spgemm_zipf_padded"] = phase6c_spgemm_path(
        dev, card, "zipf padded (planners' fallback)", A, "padded")
    return paths

# ---- phase 7: packed-layout SpMMs (seg2, seg3, split) ----------------------

BENCH_NODES = 2_449_029                 # bench.py::get_config defaults
BENCH_NNZ = 123_718_280
# experiments/r4_band_cost.py:21-28: S, BAND, E, K, CAP (edges per span)
R4_BAND_SIZES = (19, 28672, 512, 256, 77824)
TILESPAN_NODES = 200_000                # phase 7a's seg3 graph, degree 10


def span_ptrs(gen, dev, S, M, max_len, empty_rows=(0,)):
    """(S, M+1) int32 row pointers of contiguous spans, span-major, each of
    0..max_len edges, with ``empty_rows`` empty in every span."""
    lens = torch.randint(0, max_len + 1, (S, M), generator=gen, device=dev)
    lens[:, list(empty_rows)] = 0
    ptr = torch.zeros(S * M + 1, dtype=torch.int64, device=dev)
    ptr[1:] = lens.reshape(-1).cumsum(0)
    return ptr.as_strided((S, M + 1), (M, 1)).to(torch.int32)


def spans_csr(start, end, n_cols, dtype):
    """The (M, n_cols) 0/1 CSR whose row m holds the positions of row m's
    (S, M) spans: a library SpMM of it with the stream is the spans' sum.
    The spans of a row must be disjoint and increasing in s (no duplicate
    or unsorted columns), as K4's are."""
    lens = (end.long() - start.long()).clamp_min(0).t().reshape(-1)
    first = start.long().t().reshape(-1)
    M = start.shape[1]
    crow = torch.zeros(M + 1, dtype=torch.int64, device=start.device)
    torch.cumsum(lens.view(M, -1).sum(1), 0, out=crow[1:])
    total = int(crow[-1])
    excl = torch.cumsum(lens, 0) - lens
    col = (torch.repeat_interleave(first - excl, lens)
           + torch.arange(total, device=start.device))
    return torch.sparse_csr_tensor(
        crow, col, torch.ones(total, dtype=dtype, device=start.device),
        (M, n_cols))


def phase7a_spans(gen, dev, card):
    """The multi-span SpMM and the span SDDMM against their plain versions
    in f64; S = 1 against K1 bit for bit; K3's and K4's entry points."""
    from paddle_sparse_tpu_torch import (band_reduce_call, make_seg3_plan,
                                         sddmm_spans_cuda,
                                         sddmm_spans_reference,
                                         spmm_csr_cuda, spmm_spans_cuda,
                                         spmm_spans_reference, tilespan_call,
                                         tilespan_tables)
    M, N = 3000, 2000
    worst = 0.0
    for S in (1, 3, 19, 40):
        rp = span_ptrs(gen, dev, S, M, 3, empty_rows=(0, M // 3, M - 1))
        nnz = int(rp[-1, -1])
        base = torch.randint(0, 100, (S,), generator=gen, device=dev,
                             dtype=torch.int32)
        idx = torch.randint(0, N - 100, (nnz,), generator=gen, device=dev,
                            dtype=torch.int32)
        val = torch.rand(nnz, generator=gen, device=dev) * 2 - 1
        errs = []
        for K in (1, 47, 64, 100, 256, 300):
            for dt in (torch.float32, torch.bfloat16):   # f32 out, f32 sums
                x = torch.randn(N, K, generator=gen, device=dev).to(dt)
                v = None if K == 47 else val
                out = spmm_spans_cuda(rp[:, :-1], rp[:, 1:], idx, v, base, x,
                                      out_dtype=torch.float32)
                ref = spmm_spans_reference(
                    rp[:, :-1], rp[:, 1:], idx,
                    None if v is None else v.double(), base, x.double())
                gm = torch.randn(M, K, generator=gen, device=dev).to(dt)
                dv = sddmm_spans_cuda(rp[:, :-1], rp[:, 1:], idx, base, gm,
                                      x)
                dref = sddmm_spans_reference(rp[:, :-1], rp[:, 1:], idx, base,
                                             gm.double(), x.double(),
                                             torch.float64)
                torch.cuda.synchronize()
                e1 = float((out.double() - ref).abs().max())
                e2 = float((dv.double() - dref).abs().max())
                errs.append(max(e1, e2))
                check(torch.allclose(out.double(), ref, **F32_TOL)
                      and torch.allclose(dv.double(), dref, **F32_TOL)
                      and not out[[0, M // 3, M - 1]].any(),
                      f"span kernels disagree with plain f64 at S={S} K={K} "
                      f"{dt} ({e1:.3e}, {e2:.3e})")
        worst = max(worst, *errs)
        print(f"phase 7a S={S} ({nnz} edges, empty rows and spans), K in 1 "
              f"47 64 100 256 300, f32 and bf16: spmm_spans and sddmm_spans "
              f"vs plain f64 max_abs_err {max(errs):.3e} ok", flush=True)

    # one span: K1's edges, order and operations, so the same bits
    rowptr, col, value = random_csr(gen, dev, M, N, 40)
    rp = rowptr[None]
    for K in (1, 8, 47, 100, 256):
        for dt in (torch.float32, torch.bfloat16):
            x = torch.randn(N, K, generator=gen, device=dev).to(dt)
            for v in (value, None):
                a = spmm_spans_cuda(rp[:, :-1], rp[:, 1:], col, v, None, x)
                check(torch.equal(a, spmm_csr_cuda(rowptr, col, v, x)),
                      f"S=1 spans differ from K1 at K={K} {dt}")
    print("phase 7a S=1: spmm_spans equals spmm_csr (K1) bit for bit at K 1 "
          "8 47 100 256, f32 and bf16, with and without values ok",
          flush=True)

    # one row of 1.1M edges over 3 spans in the stream form, overlapping
    # and reversed spans elsewhere; small integers keep every sum exact
    L, K = 1_200_000, 64
    src = torch.randint(-3, 4, (L, K), generator=gen, device=dev).float()
    start = torch.randint(0, L - 100, (3, 500), generator=gen, device=dev)
    end = start + torch.randint(-5, 60, (3, 500), generator=gen, device=dev)
    start[:, 7] = torch.tensor([0, 400_000, 800_000], device=dev)
    end[:, 7] = torch.tensor([366_000, 766_000, 1_168_000], device=dev)
    out = spmm_spans_cuda(start.int(), end.int(), None, None, None, src)
    ref = spmm_spans_reference(start, end, None, None, None, src.double())
    check(torch.equal(out.double(), ref), "1.1M-edge stream row not exact")
    print("phase 7a stream form, a row of 1,100,000 edges over 3 spans, "
          "overlapping and reversed spans: exact ok", flush=True)

    # K3: tilespan_call on seg3's own tables of a 200k-node graph
    g = torch.Generator(device=dev).manual_seed(70)
    n = TILESPAN_NODES
    row = torch.arange(n * 10, device=dev, dtype=torch.int32) // 10
    col = torch.randint(0, n, (n * 10,), generator=g, device=dev,
                        dtype=torch.int32)
    plan, s = make_seg3_plan(row, col, n, n, feat_dim=256, stream="bf16",
                             sr=16384)
    e0a, bst, ben = tilespan_tables(s.rp_f, S=plan.S, BAND=plan.BAND,
                                    cap=plan.cap, CAP_TS=plan.CAP_TS)
    R, T_B = 128, plan.BAND // 128
    for b in (0, e0a.shape[0] - 1):
        stream = torch.randn(plan.S * plan.cap + plan.CAP_TS, 256,
                             generator=g, device=dev).bfloat16()
        got = tilespan_call(e0a[b], bst[b], ben[b], stream, S=plan.S,
                            T_B=T_B, CAP_TS=plan.CAP_TS, K=256, R=R)
        band = s.rp_f[:, b * plan.BAND:(b + 1) * plan.BAND + 1].long()
        loc = band - band[:, :1] + (torch.arange(plan.S, device=dev)
                                    * plan.cap)[:, None]
        ref = spmm_spans_reference(loc[:, :-1], loc[:, 1:], None, None,
                                   None, stream.double())
        err = float((got.double() - ref).abs().max())
        check(torch.allclose(got.double(), ref, **F32_TOL),
              f"tilespan_call band {b} disagrees ({err:.3e})")
        print(f"phase 7a tilespan_call (K3) band {b} of seg3's tables: "
              f"S={plan.S} T_B={T_B} CAP_TS={plan.CAP_TS} bf16 stream "
              f"{tuple(stream.shape)} vs plain f64 from the row pointers "
              f"max_abs_err {err:.3e} ok", flush=True)
    del plan, s, e0a, bst, ben, stream, row, col

    # K4: band_reduce_call at experiments/r4_band_cost.py's own sizes
    S, BAND, E, K, CAP = R4_BAND_SIZES
    TMAX = 4
    BR_pad = BAND + R
    stream = torch.randn(S * CAP, K, generator=g, device=dev).bfloat16()
    loc = torch.clamp((torch.arange(BAND + 1, device=dev) * (CAP / BAND))
                      .to(torch.int32), 0, CAP)
    offs = (torch.arange(S, device=dev, dtype=torch.int32) * CAP)[:, None]
    lb = torch.cat([loc, loc[-1:].expand(R)])            # pad rows empty
    bounds_start = (lb[None, :BR_pad] + offs).reshape(-1, R)
    bounds_end = (torch.cat([loc[1:], loc[-1:].expand(R + 1)])[None, :BR_pad]
                  + offs).reshape(-1, R)
    sched = [torch.zeros(1, dtype=torch.int32, device=dev)] * 3
    st, en = bounds_start.reshape(S, BR_pad), bounds_end.reshape(S, BR_pad)
    p1, k1, k2, p2, out_p, out_k = in_turns(
        lambda: spmm_spans_reference(st, en, None, None, None, stream,
                                     torch.float32),
        lambda: band_reduce_call(*sched, bounds_start, bounds_end, stream,
                                 S=S, BR_pad=BR_pad, E=E, K=K, TMAX=TMAX),
        1, 5)
    ref = spmm_spans_reference(st, en, None, None, None, stream.double())
    err = float((out_k.double() - ref).abs().max())
    check(torch.allclose(out_k.double(), ref, **F32_TOL)
          and torch.allclose(out_k, out_p, **F32_TOL),
          f"band_reduce_call disagrees with plain f64 ({err:.3e})")
    moved = nbytes(stream, bounds_start, bounds_end, out_k)
    bound, by = bound_ms(moved, S * CAP * K)
    # the library yardstick: the 0/1 span CSR (built outside the timing)
    # times the stream, in the stream's dtype, else in an f32 copy
    lib = "torch.sparse.mm of the 0/1 span CSR, bf16"
    P = spans_csr(st, en, stream.shape[0], stream.dtype)
    lib_ms, lib_err = library_timed(f"{lib} (K4's sum)",
                                    lambda: torch.sparse.mm(P, stream), 5,
                                    out_k)
    if lib_ms is None:
        lib = "torch.sparse.mm of the 0/1 span CSR, f32 copy of the stream"
        P, s32 = spans_csr(st, en, stream.shape[0], torch.float32), \
            stream.float()
        lib_ms, lib_err = library_timed(f"{lib} (K4's sum)",
                                        lambda: torch.sparse.mm(P, s32), 5,
                                        out_k)
        del s32
    del P
    print(f"phase 7a band_reduce_call (K4) at r4_band_cost sizes: S={S} "
          f"BAND={BAND} E={E} K={K} bf16 stream {tuple(stream.shape)} "
          f"({nbytes(stream) / 1e9:.2f} GB): kernel {k1:.3f} / {k2:.3f} ms, "
          f"plain {p1:.3f} / {p2:.3f} ms, bound {bound:.3f} ms ({by}); "
          f"library ({lib}) {lib_ms} ms (max_abs_err {lib_err}); vs plain "
          f"f64 max_abs_err {err:.3e} ok {card}", flush=True)
    return {"max_abs_err": worst,
            "band_reduce": {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
                            "bound_ms": bound, "bound_by": by,
                            "max_abs_err": err, "library_ms": lib_ms,
                            "library": lib}}


def long_row_bounds(gen, dev, S, totals, empty_spans=0.0):
    """(S, M) span bounds whose row m holds ``totals[m]`` flat edges cut at
    random points over the S spans, a share ``empty_spans`` of the cuts
    collapsed (empty spans), span-major as a packed layout lays them out."""
    lens = torch.zeros(S, len(totals), dtype=torch.int64, device=dev)
    for m, n in enumerate(totals):
        if n:
            cut = torch.sort(torch.randint(0, n + 1, (S - 1,), generator=gen,
                                           device=dev)).values
            if S > 1 and empty_spans:
                drop = torch.rand(S - 1, generator=gen, device=dev)
                cut = torch.sort(torch.where(drop < empty_spans,
                                             cut.roll(1), cut)).values
            edges = torch.cat([cut.new_zeros(1), cut, cut.new_full((1,), n)])
            lens[:, m] = torch.diff(edges)
    M = len(totals)
    ptr = torch.zeros(lens.numel() + 1, dtype=torch.int64, device=dev)
    ptr[1:] = lens.reshape(-1).cumsum(0)
    rp = ptr.as_strided((S, M + 1), (M, 1)).to(torch.int32)
    return rp[:, :-1], rp[:, 1:], int(ptr[-1])


def phase7a_long_rows(gen, dev, card):
    """The long-row split of both span kernels against plain f64: rows
    around CAP at S = 1 and 38 over K and dtypes, then a row of 10M edges
    whose spans cross 32-span chunks, exact with small-integer inputs. A
    row sum of thousands of f32 terms is held within GRAD_REL of its sum of
    |terms| (f32 rounding in another order), the K-term dots to F32_TOL."""
    from paddle_sparse_tpu_torch import (CAP, fold_pieces_cuda,
                                         sddmm_spans_cuda,
                                         sddmm_spans_reference, split_rows,
                                         spmm_spans_cuda,
                                         spmm_spans_reference)
    N = 2000
    worst = 0.0
    totals = [0, CAP - 1, 3, CAP, 0, CAP + 1, 7, 2 * CAP + 3, 0, 1]
    for S in (1, 38):
        start, end, nnz = long_row_bounds(gen, dev, S, totals, 0.2)
        t = split_rows(start, end)
        check(t is not None and t.fold_row.tolist() == [5, 7]
              and t.num_slots == 5, f"S={S}: rows CAP+1 and 2*CAP+3 must "
                                    f"split into 2 and 3 pieces")
        base = torch.randint(0, 100, (S,), generator=gen, device=dev,
                             dtype=torch.int32)
        idx = torch.randint(0, N - 100, (nnz,), generator=gen, device=dev,
                            dtype=torch.int32)
        val = torch.rand(nnz, generator=gen, device=dev) * 2 - 1
        errs = []
        for K in (1, 47, 256, 300):
            for dt in (torch.float32, torch.bfloat16):
                x = torch.randn(N, K, generator=gen, device=dev).to(dt)
                gm = torch.randn(len(totals), K, generator=gen,
                                 device=dev).to(dt)
                folds = fold_pieces_cuda.launches
                out = spmm_spans_cuda(start, end, idx, val, base, x,
                                      out_dtype=torch.float32, split=t)
                check(fold_pieces_cuda.launches == folds + 1,
                      "a split spans launch must run the fold once")
                ref = spmm_spans_reference(start, end, idx, val.double(),
                                           base, x.double())
                scale = spmm_spans_reference(start, end, idx,
                                             val.double().abs(), base,
                                             x.double().abs())
                dv = sddmm_spans_cuda(start, end, idx, base, gm, x, split=t)
                dref = sddmm_spans_reference(start, end, idx, base,
                                             gm.double(), x.double(),
                                             torch.float64)
                torch.cuda.synchronize()
                e1, ok1 = _grad_close(out, ref, scale)
                e2 = float((dv.double() - dref).abs().max())
                errs.append(max(e1, e2))
                check(ok1 and torch.allclose(dv.double(), dref, **F32_TOL),
                      f"split span kernels disagree with plain f64 at S={S} "
                      f"K={K} {dt} ({e1:.3e}, {e2:.3e})")
        worst = max(worst, *errs)
        print(f"phase 7a split S={S}: rows of {CAP - 1}, {CAP}, {CAP + 1}, "
              f"{2 * CAP + 3} edges (CAP {CAP}) among short and empty rows, "
              f"20% empty spans, K in 1 47 256 300, f32 and bf16: "
              f"spmm_spans (+ fold) and sddmm_spans vs plain f64 max_abs_err "
              f"{max(errs):.3e} (rows within {GRAD_REL} of their sums of "
              f"|terms|) ok", flush=True)

    # a row of 10M edges among short and empty rows; at S = 38 its spans
    # cross the 32-span chunk boundary and some are empty. Values and x in
    # {-1, 0, 1} keep every f32 sum (|sum| < 2**24) and every dot exact.
    totals = [3, 0, 10_000_000, 5, 0, CAP + 1, 2]
    for S, cases in ((1, ((300, torch.float32), (1, torch.bfloat16))),
                     (38, ((1, torch.float32), (300, torch.bfloat16)))):
        start, end, nnz = long_row_bounds(gen, dev, S, totals, 0.3)
        t = split_rows(start, end)
        base = torch.randint(0, 100, (S,), generator=gen, device=dev,
                             dtype=torch.int32)
        idx = torch.randint(0, N - 100, (nnz,), generator=gen, device=dev,
                            dtype=torch.int32)
        val = torch.randint(-1, 2, (nnz,), generator=gen, device=dev).float()
        for K, dt in cases:
            x = torch.randint(-1, 2, (N, K), generator=gen, device=dev).to(dt)
            gm = torch.randint(-1, 2, (len(totals), K), generator=gen,
                               device=dev).to(dt)
            out = spmm_spans_cuda(start, end, idx, val.to(dt), base, x,
                                  out_dtype=torch.float32, split=t)
            ref = spmm_spans_reference(start, end, idx, val.double(), base,
                                       x.double())
            dv = sddmm_spans_cuda(start, end, idx, base, gm, x, split=t)
            dref = sddmm_spans_reference(start, end, idx, base, gm.double(),
                                         x.double(), torch.float64)
            torch.cuda.synchronize()
            check(torch.equal(out.double(), ref)
                  and torch.equal(dv.double(), dref),
                  f"10M-edge row at S={S} K={K} {dt} not exact")
            del out, ref, dv, dref
        print(f"phase 7a split S={S}: a row of 10,000,000 edges "
              f"({int(t.fold_ptr[-1])} workspace rows; 30% empty spans) "
              f"among short and empty rows, K/dtype "
              f"{[(K, str(dt)[6:]) for K, dt in cases]}: spmm_spans and "
              f"sddmm_spans exact vs plain f64 ok {card}", flush=True)
    return worst


def phase7a_fused(gen, dev, card):
    """The fused span backward as the packed backward runs it (values
    gathered through a random relay, d value read back through its
    inverse) against its plain version in f64 and, bit for bit, against
    the pair of span kernels over the same bounds (the spans SpMM on
    ``value[relay]`` for d x; the span SDDMM with x's row as the row
    operand and g gathered, written through the relay, for d value): S in
    1 3 19 40 and K in 1 47 64 256 520, f32 and bf16, slice bases, empty
    rows and spans, values or None; then rows around CAP at S = 1 and 38
    cut into pieces (the fold after)."""
    from paddle_sparse_tpu_torch import (CAP, fold_pieces_cuda,
                                         sddmm_spans_cuda, split_rows,
                                         spmm_sddmm_spans_cuda,
                                         spmm_sddmm_spans_reference,
                                         spmm_spans_cuda)
    M = 2000
    worst = 0.0

    def run(start, end, idx, relay, value, base, g, x, split):
        """The kernel as the packed backward runs it (the values gathered
        through ``relay`` before, d value read back through its inverse
        after), the pair, and the plain version in f64 and on |inputs|."""
        rl = relay.long()
        inv = torch.empty_like(rl).index_copy_(
            0, rl, torch.arange(rl.numel(), device=rl.device))
        vt = None if value is None else value[rl]
        d_x, dv = spmm_sddmm_spans_cuda(start, end, idx, vt, base, g, x,
                                        dx_dtype=torch.float32, split=split)
        got = (d_x, dv[inv])
        dv_t = sddmm_spans_cuda(start, end, idx, base, x, g, split=split)
        want = (spmm_spans_cuda(start, end, idx, vt, base, g,
                                out_dtype=torch.float32, split=split),
                torch.empty_like(dv_t).index_copy_(0, rl, dv_t))
        ref, scale = (spmm_sddmm_spans_reference(
            start, end, idx, None if vt is None else f(vt), base, f(g),
            f(x), out_dtype=torch.float64)
            for f in (torch.Tensor.double, lambda t: t.double().abs()))
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        e_x, ok_x = _grad_close(d_x, ref[0], scale[0])
        e_v = float((dv.double() - ref[1]).abs().max())
        ok = same and ok_x and bool(torch.allclose(dv.double(), ref[1],
                                                   **F32_TOL))
        return ok, max(e_x, e_v)

    for S in (1, 3, 19, 40):
        N = 3000
        rp = span_ptrs(gen, dev, S, N, 3, empty_rows=(0, N // 3, N - 1))
        nnz = int(rp[-1, -1])
        base = torch.randint(0, 100, (S,), generator=gen, device=dev,
                             dtype=torch.int32)
        idx = torch.randint(0, M - 100, (nnz,), generator=gen, device=dev,
                            dtype=torch.int32)
        relay = torch.randperm(nnz, generator=gen, device=dev).int()
        val = torch.rand(nnz, generator=gen, device=dev) * 2 - 1
        errs = []
        for K in (1, 47, 64, 256, 520):
            for dt in (torch.float32, torch.bfloat16):
                x = torch.randn(N, K, generator=gen, device=dev).to(dt)
                g = torch.randn(M, K, generator=gen, device=dev).to(dt)
                v = None if K == 47 else val
                ok, err = run(rp[:, :-1], rp[:, 1:], idx, relay, v, base, g,
                              x, None)
                errs.append(err)
                check(ok, f"fused span kernel disagrees with the pair or "
                          f"plain f64 at S={S} K={K} {dt} ({err:.3e})")
        worst = max(worst, *errs)
        print(f"phase 7a spmm_sddmm_spans S={S} ({nnz} edges, empty rows and "
              f"spans, a random relay), K in 1 47 64 256 520, f32 and bf16: "
              f"bit for bit the spans SpMM + span SDDMM pair, vs plain f64 "
              f"max_abs_err {max(errs):.3e} ok", flush=True)

    totals = [0, CAP - 1, 3, CAP, 0, CAP + 1, 7, 2 * CAP + 3, 0, 1]
    for S in (1, 38):
        start, end, nnz = long_row_bounds(gen, dev, S, totals, 0.2)
        t = split_rows(start, end)
        base = torch.randint(0, 100, (S,), generator=gen, device=dev,
                             dtype=torch.int32)
        idx = torch.randint(0, M - 100, (nnz,), generator=gen, device=dev,
                            dtype=torch.int32)
        relay = torch.randperm(nnz, generator=gen, device=dev).int()
        val = torch.rand(nnz, generator=gen, device=dev) * 2 - 1
        errs = []
        for K in (1, 47, 256, 300):
            for dt in (torch.float32, torch.bfloat16):
                x = torch.randn(len(totals), K, generator=gen,
                                device=dev).to(dt)
                g = torch.randn(M, K, generator=gen, device=dev).to(dt)
                folds = fold_pieces_cuda.launches
                ok, err = run(start, end, idx, relay, val.to(dt), base, g, x,
                              t)
                check(fold_pieces_cuda.launches == folds + 2,
                      "the fused span launch and the spans launch over "
                      "split rows must each run the fold once")
                errs.append(err)
                check(ok, f"split fused span kernel disagrees at S={S} "
                          f"K={K} {dt} ({err:.3e})")
        worst = max(worst, *errs)
        print(f"phase 7a split spmm_sddmm_spans S={S}: x rows of {CAP - 1}, "
              f"{CAP}, {CAP + 1}, {2 * CAP + 3} edges among short and empty "
              f"ones, K in 1 47 256 300, f32 and bf16: bit for bit the pair "
              f"(+ fold), vs plain f64 max_abs_err {max(errs):.3e} (d x "
              f"within {GRAD_REL} of its sums of |terms|) ok {card}",
              flush=True)
    return worst


def _packed_fns(backend):
    import paddle_sparse_tpu_torch as p
    if backend == "seg2split":
        return (p.make_split_plan, p.pack_values_split, p.spmm_split,
                p.unpack_values_split)
    plan_fn = p.make_seg3_plan if backend == "seg3" else p.make_seg2_plan
    fn = p.spmm_seg3 if backend == "seg3" else p.spmm_seg2
    return plan_fn, p.pack_values, fn, p.unpack_values


def _leaves(packed):
    if isinstance(packed, tuple):
        return tuple(t.detach().requires_grad_() for t in packed)
    return packed.detach().requires_grad_()


def _grads(leaves):
    return (tuple(t.grad for t in leaves) if isinstance(leaves, tuple)
            else leaves.grad)


def toy_spmm(dev, phase, fns):
    """``spmm_entry`` for each backend of ``fns`` (backend -> SpMM entry
    point): forward and grads, card vs CPU."""
    from paddle_sparse_tpu_torch import spmm_entry
    for backend, fn in fns.items():
        runs = {}
        for where in (dev, "cpu"):
            plan, s, packed, x = spmm_entry(backend, where)
            pv, xx = _leaves(packed), x.clone().requires_grad_()
            out = fn(plan, s, pv, xx)
            w = torch.linspace(-1, 1, out.numel(), device=where).view(
                out.shape)
            (out * w).sum().backward()
            gv = _grads(pv)
            gv = gv if isinstance(gv, tuple) else (gv,)
            runs[str(where)] = [t.detach().cpu() for t in (out, xx.grad,
                                                           *gv)]
        err = max(float((a - b).abs().max())
                  for a, b in zip(runs[str(dev)], runs["cpu"]))
        ok = all(torch.allclose(a, b, **F32_TOL)
                 for a, b in zip(runs[str(dev)], runs["cpu"]))
        print(f"phase {phase} toy {backend}, 256 nodes, K=32: forward, d "
              f"packed and d x cuda vs cpu max_abs_err {err:.3e} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        check(ok, f"toy {backend} on the card disagrees with the CPU")


def phase7b_toy(dev):
    """The packed SpMMs' toys (seg2, seg3, split): card vs CPU."""
    toy_spmm(dev, "7b", {b: _packed_fns(b)[2]
                         for b in ("seg2", "seg3", "seg2split")})


def bench_graph(dev, kind, scale, dim):
    """``bench.py``'s generators (``synthetic_graph``, ``zipf_graph``,
    ``clustered_graph``, ``:122-220``) in torch at ``get_config(scale)``'s
    size: rows ``arange // deg`` (zipf: degrees from numpy seed 0, as
    there), uniform cols (clustered: 80% inside the row's 2048-node
    community), U(0,1) values and N(0,1) features from a seeded
    generator. Returns row-sorted int32 ``row``/``col``, ``val``, ``x``."""
    import numpy as np
    n = max(1024, int(BENCH_NODES * scale))
    e = max(16384, int(BENCH_NNZ * scale))
    g = torch.Generator(device=dev).manual_seed(0)
    if kind == "zipf":
        w = np.random.default_rng(0).zipf(1.5, size=n).astype(np.float64)
        deg = np.maximum(1, np.floor(w * (e / w.sum()))).astype(np.int64)
        row = torch.arange(n, device=dev, dtype=torch.int32).repeat_interleave(
            torch.as_tensor(deg, device=dev))
    else:
        deg = max(1, e // n)
        row = torch.arange(deg * n, device=dev, dtype=torch.int32) // deg
    nnz = row.numel()
    col = torch.randint(0, n, (nnz,), generator=g, device=dev,
                        dtype=torch.int32)
    if kind == "clustered":
        c = 2048
        v_in = torch.clamp(row // c * c + torch.randint(
            0, c, (nnz,), generator=g, device=dev, dtype=torch.int32),
            max=n - 1)
        col = torch.where(torch.rand(nnz, generator=g, device=dev) < 0.8,
                          v_in, col)
    val = torch.rand(nnz, generator=g, device=dev)
    x = torch.randn(n, dim, generator=g, device=dev)
    return row, col, val, x


def _sub_csr(rowptr, rows):
    """COO positions of ``rows``' edges and the sub-CSR pointer over them."""
    start = rowptr[rows].long()
    cnt = (rowptr[rows + 1] - rowptr[rows]).long()
    sub_ptr = torch.zeros(rows.numel() + 1, dtype=torch.long,
                          device=rows.device)
    sub_ptr[1:] = cnt.cumsum(0)
    edge = (torch.repeat_interleave(start - sub_ptr[:-1], cnt)
            + torch.arange(int(sub_ptr[-1]), device=rows.device))
    return edge, sub_ptr


def check_packed_grads(name, row, col, val, x, gw, out, d_val, d_x, pdt,
                       rowptr, phase="7c"):
    """Sampled rows of ``out``, edges of ``d value`` (COO order) and
    columns of ``d x`` against f64, each within GRAD_REL of the sum of
    |terms| of its entry; sources rounded to ``pdt`` as the port gathers
    them (the plain version widens each window to f64)."""
    from paddle_sparse_tpu_torch import spmm_csr_reference
    dev, n = x.device, x.shape[0]
    xs = x.to(pdt)
    gen = torch.Generator().manual_seed(11)
    deg = rowptr[1:] - rowptr[:-1]
    rows = torch.cat([deg.argmax().view(1).cpu(), torch.randperm(
        n, generator=gen)[:SAMPLED_ROWS - 1]]).unique().to(dev)
    edge, sub_ptr = _sub_csr(rowptr, rows)
    sub_col, sub_val = col[edge], val[edge].double()
    ref = spmm_csr_reference(sub_ptr, sub_col, sub_val, xs)
    scale = spmm_csr_reference(sub_ptr, sub_col, sub_val.abs(), xs.abs())
    err_o, ok_o = _grad_close(out[rows], ref, scale)
    e = torch.randint(0, row.numel(), (SAMPLED_EDGES,), generator=gen).to(dev)
    terms = (gw[row[e].long()].to(pdt).double()
             * xs[col[e].long()].double())
    err_v, ok_v = _grad_close(d_val[e], terms.sum(1), terms.abs().sum(1))
    cols = torch.randperm(n, generator=gen)[:SAMPLED_COLS].to(dev)
    slot = torch.full((n,), -1, dtype=torch.long, device=dev)
    slot[cols] = torch.arange(SAMPLED_COLS, device=dev)
    edges = torch.nonzero(slot[col.long()] >= 0).squeeze(1)
    t = (val[edges].double()[:, None]
         * gw[row[edges].long()].to(pdt).double())
    eslot = slot[col[edges].long()]
    ref_x = torch.zeros(SAMPLED_COLS, x.shape[1], dtype=torch.float64,
                        device=dev).index_add_(0, eslot, t)
    sc_x = torch.zeros_like(ref_x).index_add_(0, eslot, t.abs())
    err_x, ok_x = _grad_close(d_x[cols], ref_x, sc_x)
    ok = ok_o and ok_v and ok_x
    print(f"phase {phase} {name}: {rows.numel()} sampled rows ({edge.numel()} "
          f"edges, the longest row among them) max_abs_err {err_o:.3e}; "
          f"d value on {SAMPLED_EDGES} edges {err_v:.3e}; d x on "
          f"{SAMPLED_COLS} columns ({edges.numel()} edges) {err_x:.3e}; vs "
          f"f64 within {GRAD_REL} of the sum of |terms| "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    check(ok, f"{name}: output or grads disagree with f64 on samples")


def _transpose_layout(plan, s):
    from paddle_sparse_tpu_torch.ops.spmm_seg2 import span_layouts
    return span_layouts(plan, s)[1]


def fused_span_pair(plan, s, packed, x, g):
    """The two passes that the fused span backward replaces, as
    ``_PackedSpmm.backward`` ran them for one seg2 call: ``packed[relay]``
    and the spans SpMM over the transpose for d x (a bf16 g read as it
    is), the span SDDMM over the forward layout for d value, in the
    backward's dtypes: ``(d x, d value)``."""
    from paddle_sparse_tpu_torch import (product_dtype, sddmm_spans_cuda,
                                         spmm_spans_cuda)
    from paddle_sparse_tpu_torch.ops.spmm_seg2 import span_layouts
    fwd, t = span_layouts(plan, s)
    pdt = product_dtype(packed, g, plan.stream)
    src = g if g.dtype in (pdt, torch.bfloat16) else g.to(pdt)
    d_x = spmm_spans_cuda(t.start, t.end, t.col,
                          packed.index_select(0, s.relay_ft), t.base, src,
                          out_dtype=g.dtype, split=t.split)
    d_value = sddmm_spans_cuda(fwd.start, fwd.end, fwd.col, fwd.base,
                               g.to(pdt), x.to(pdt), split=fwd.split)
    return d_x.to(x.dtype), d_value.to(packed.dtype)


def fused_span_kernel(plan, s, packed, x, g, relayed=None):
    """The fused span backward of one seg2 call: the backward's own
    ``spmm_seg2.fused_span_backward`` (the values put in the transpose's
    order, one ``spmm_sddmm_spans_cuda`` launch, d value read back through
    ``relay_tf``): ``(d x, d value)``. With ``relayed`` (the values
    already in that order) the launch alone, d value in the transpose's
    order."""
    from paddle_sparse_tpu_torch import product_dtype, spmm_sddmm_spans_cuda
    from paddle_sparse_tpu_torch.ops.spmm_seg2 import fused_span_backward
    t = _transpose_layout(plan, s)
    if relayed is None:
        d_value, d_x = fused_span_backward(t, s.relay_ft, s.relay_tf, packed,
                                           x, g, plan.stream)
        return d_x, d_value
    pdt = product_dtype(packed, g, plan.stream)
    return spmm_sddmm_spans_cuda(t.start, t.end, t.col, relayed, t.base,
                                 g.to(pdt), x.to(pdt), dx_dtype=g.dtype,
                                 split=t.split)


def check_fused_equals_pair(name, plan, s, packed, x, g):
    """One seg2 call's fused span backward equal to the pair it replaces,
    d x and d value bit for bit, on the path's own inputs."""
    with torch.inference_mode():
        got = fused_span_kernel(plan, s, packed, x, g)
        want = fused_span_pair(plan, s, packed, x, g)
        same = all(torch.equal(a, b) for a, b in zip(got, want))
    print(f"phase 7c {name}: the fused span backward (S_t={plan.S_t}, x "
          f"rows {'split' if s.split_t is not None else 'unsplit'}) vs the "
          f"spans SpMM + span SDDMM pair: d x and d value bit for bit "
          f"{'equal' if same else 'DIFFERENT'}", flush=True)
    check(same, f"{name}: the fused span backward differs from the pair")


def first_fwd_bwd(name, card, run_fwd, run_bwd):
    """A path's first forward+backward under ``torch.profiler``, launched
    as the timed calls launch it (no synchronize between forward and
    backward): when the host's calls returned, when the device finished,
    the device time, the ops that took the most host time and the
    allocator's device allocations and retries, to show where a slow first
    call goes. Returns its ms and the output."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    m0 = torch.cuda.memory_stats()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = run_fwd()
        t1 = time.perf_counter()
        run_bwd(out)
        t2 = time.perf_counter()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
    m1 = torch.cuda.memory_stats()
    ev = prof.key_averages()
    dev_ms = sum(getattr(e, "self_device_time_total", 0) for e in ev
                 if e.device_type == DeviceType.CUDA) / 1e3
    top = sorted(ev, key=lambda e: e.self_cpu_time_total, reverse=True)[:6]
    delta = {k: m1.get(k, 0) - m0.get(k, 0)
             for k in ("num_device_alloc", "num_device_free",
                       "num_alloc_retries")}
    print(f"phase 7c {name} first forward+backward, profiled: host "
          f"returns from the forward after {(t1 - t0) * 1e3:.3f} ms and "
          f"from backward() after {(t2 - t0) * 1e3:.3f} ms, device done "
          f"after {(t3 - t0) * 1e3:.3f} ms; kernel time {dev_ms:.3f} ms; "
          f"allocator {delta}; most host time: " + "; ".join(
              f"{e.key[:60]} {e.self_cpu_time_total / 1e3:.3f} ms x{e.count}"
              for e in top) + f" {card}", flush=True)
    return (t3 - t0) * 1e3, out


def phase7c_path(dev, card, name, backend, graph, stream, reps=3,
                 profile_first=False, **plan_kw):
    """Plan once, then 1 warm-up + ``reps`` forwards and forward+backwards
    of ``backend`` on ``graph``: times, peak memory, launches (counts
    zeroed just before and read just after), sampled f64 checks. With
    ``profile_first`` the first forward+backward runs under the profiler
    (:func:`first_fwd_bwd`)."""
    from paddle_sparse_tpu_torch import ind2ptr, product_dtype
    row, col, val, x = graph
    n, K = x.shape
    plan_fn, pack_fn, fn, unpack_fn = _packed_fns(backend)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plan, s = plan_fn(row, col, n, n, feat_dim=K, stream=stream, **plan_kw)
    packed = pack_fn(s, val)
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    plans = [plan.local, plan.resid] if backend == "seg2split" else [plan]
    desc = "; ".join(f"S={q.S} SR={q.SR} S_t={q.S_t}" for q in plans)
    if backend == "seg2split":
        desc += (f"; local {s.idx_local.numel()} / resid "
                 f"{s.idx_resid.numel()} edges")
    if backend == "seg3":
        desc += f"; BAND={plan.BAND} cap={plan.cap} CAP_TS={plan.CAP_TS}"
    structs = [s.local, s.resid] if backend == "seg2split" else [s]
    for q in structs:
        for side, t in (("rows", q.split_f), ("x rows", q.split_t)):
            desc += (f"; no {side} split" if t is None else
                     f"; {t.fold_row.numel()} {side} split into "
                     f"{t.num_slots} pieces")
    gw = torch.randn(n, K, generator=torch.Generator(device=dev).manual_seed(
        12), device=dev)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero_launch_counts()
    fwd, fwdbwd = [], []
    with torch.inference_mode():
        for _ in range(reps + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(plan, s, packed, x)
            torch.cuda.synchronize()
            fwd.append((time.perf_counter() - t0) * 1e3)
    del out
    pv, xx = _leaves(packed), x.detach().requires_grad_()
    for i in range(reps + 1):
        xx.grad = None
        for t in (pv if isinstance(pv, tuple) else (pv,)):
            t.grad = None
        if i == 0 and profile_first:
            ms, out = first_fwd_bwd(name, card, lambda: fn(plan, s, pv, xx),
                                    lambda o: o.backward(gw))
            fwdbwd.append(ms)
            continue
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(plan, s, pv, xx)
        out.backward(gw)
        torch.cuda.synchronize()
        fwdbwd.append((time.perf_counter() - t0) * 1e3)
    counts = _launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    f_ms, fb_ms = sum(fwd[1:]) / reps, sum(fwdbwd[1:]) / reps
    print(f"phase 7c {name}: {n} nodes, {row.numel()} nnz, K={K}, stream "
          f"{stream}; plan ({desc}) in {plan_s:.3f} s; forward ms warm-up "
          f"{fwd[0]:.3f}, timed {' '.join(f'{t:.3f}' for t in fwd[1:])} "
          f"(mean {f_ms:.3f}); forward+backward ms warm-up {fwdbwd[0]:.3f}, "
          f"timed {' '.join(f'{t:.3f}' for t in fwdbwd[1:])} (mean "
          f"{fb_ms:.3f}); peak mem {peak_gb:.2f} GB {card}", flush=True)
    calls = len(plans)
    runs = reps + 1
    print(f"phase 7c {name} launches in {runs} forwards + {runs} "
          f"forward+backwards: " + ", ".join(f"{k} {v}" for k, v in
                                             counts.items()), flush=True)
    # the fold follows each spans launch over a split layout: the forward's
    # in every run, the transpose's in the forward+backwards
    folds = sum(runs * (2 * (q.split_f is not None)
                        + (q.split_t is not None)) for q in structs)
    want = {"spmm_spans": 2 * runs * calls,
            "spmm_sddmm_spans": runs * calls, "fold_pieces": folds}
    check(all(counts[k] == want.get(k, 0) for k in counts),
          f"{name}: expected launches {want} (spans 1 per forward, the fused "
          f"span backward 1 per backward, per seg2 call; the fold after "
          f"each launch over a split layout), counted {counts}")
    check(bool(torch.isfinite(out).all()) and out.shape == (n, K),
          f"{name}: output not finite or of shape {tuple(out.shape)}")
    d_val = unpack_fn(s, _grads(pv))
    pdt = product_dtype(val, x, stream)
    check_packed_grads(name, row, col, val, x, gw, out.detach(), d_val,
                       xx.grad, pdt, ind2ptr(row, n))
    del out, d_val, pv, xx
    for q_plan, q, q_packed in (
            zip((plan.local, plan.resid), structs, packed)
            if backend == "seg2split" else ((plan, s, packed),)):
        check_fused_equals_pair(name, q_plan, q, q_packed, x, gw)
    return {"plan": plan, "s": s, "packed": packed, "gw": gw,
            "stats": {"plan_s": plan_s, "fwd_ms": f_ms, "fwd_bwd_ms": fb_ms,
                      "peak_gb": peak_gb, "launches": counts}}


def phase7c_kernels(dev, card, run, graph):
    """The multi-span SpMM and the span SDDMM alone on the seg2 f32 path's
    own inputs, kernel vs plain in turns, with their bounds, K1 on the same
    graph, and the library calls computing the same products."""
    from paddle_sparse_tpu_torch import (ind2ptr, sddmm_spans_cuda,
                                         sddmm_spans_reference, spmm_csr_cuda,
                                         spmm_spans_cuda,
                                         spmm_spans_reference, split_rows,
                                         unpack_values)
    row, col, val, x = graph
    plan, s, packed, gw = run["plan"], run["s"], run["packed"], run["gw"]
    M, nnz, K = plan.num_rows, row.numel(), x.shape[1]
    st, en = s.rp_f[:, :M], s.rp_f[:, 1:M + 1]
    res = {}
    with torch.inference_mode():
        p1, k1, k2, p2, out_p, out_k = in_turns(
            lambda: spmm_spans_reference(st, en, s.col_f, packed, s.sbase_f,
                                         x),
            lambda: spmm_spans_cuda(st, en, s.col_f, packed, s.sbase_f, x,
                                    split=s.split_f), 1, 5)
        err = float((out_k - out_p).abs().max())
        check(torch.allclose(out_k, out_p, **F32_TOL),
              f"spmm_spans kernel and plain disagree at scale ({err:.3e})")
        b, by = bound_ms(nbytes(s.rp_f, s.col_f, packed, s.sbase_f, x, out_k),
                         2 * nnz * K)
        res["spmm_spans"] = {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
                             "max_abs_err": err, "bound_ms": b,
                             "bound_by": by, "gather_bound_ms":
                             nnz * K * 4 / HBM_BYTES_PER_S * 1e3}
        print(f"phase 7c spmm_spans on seg2's forward (S={plan.S}, K={K}, "
              f"f32): kernel {k1:.3f} / {k2:.3f} ms, plain {p1:.3f} / "
              f"{p2:.3f} ms, bound {b:.3f} ms ({by}), the gathered rows "
              f"alone {res['spmm_spans']['gather_bound_ms']:.3f} ms; max_abs_"
              f"err {err:.3e} ok {card}", flush=True)
        xb = x.bfloat16()
        ms_b, out_b = timed(lambda: spmm_spans_cuda(st, en, s.col_f, packed,
                                                    s.sbase_f, xb,
                                                    split=s.split_f), 5)
        res["spmm_spans"]["ms_bf16"] = ms_b
        del out_b

        p1, k1, k2, p2, dv_p, dv_k = in_turns(
            lambda: sddmm_spans_reference(st, en, s.col_f, s.sbase_f, gw, x),
            lambda: sddmm_spans_cuda(st, en, s.col_f, s.sbase_f, gw, x,
                                     split=s.split_f), 1, 5)
        err = float((dv_k - dv_p).abs().max())
        scale = float(dv_p.abs().max())
        check(torch.allclose(dv_k, dv_p, rtol=1e-4, atol=GRAD_REL * scale),
              f"sddmm_spans kernel and plain disagree at scale ({err:.3e})")
        b, by = bound_ms(nbytes(s.rp_f, s.col_f, s.sbase_f, gw, x, dv_k),
                         2 * nnz * K)
        res["sddmm_spans"] = {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
                              "max_abs_err": err, "bound_ms": b,
                              "bound_by": by, "gather_bound_ms":
                              nnz * K * 4 / HBM_BYTES_PER_S * 1e3}
        print(f"phase 7c sddmm_spans on seg2's backward (K={K}, f32): kernel "
              f"{k1:.3f} / {k2:.3f} ms, plain {p1:.3f} / {p2:.3f} ms, bound "
              f"{b:.3f} ms ({by}); max_abs_err {err:.3e} (max |dv| "
              f"{scale:.3e}) ok {card}", flush=True)
        del dv_p, out_p

        # yardsticks on the same graph in CSR (COO) order, never on the path
        rowptr = ind2ptr(row, M).to(torch.int32)
        t_csr = split_rows(rowptr[None, :-1], rowptr[None, 1:])
        out_csr = out_k
        k1_ms, out_k1 = timed(lambda: spmm_csr_cuda(rowptr, col, val, x,
                                                    split=t_csr), 5)
        k1_err = float((out_k1 - out_csr).abs().max())
        del out_k1
        csr = torch.sparse_csr_tensor(rowptr, col, val, (M, M))
        lib_mm, lib_mm_err = library_timed(
            "torch.sparse.mm (the spans' product)",
            lambda: torch.sparse.mm(csr, x), 3, out_csr)
        x_t = x.t().contiguous()
        dv_coo = unpack_values(s, dv_k)
    lib_sd, lib_sd_err = library_timed(
        "torch.sparse.sampled_addmm (the span SDDMM's product)",
        lambda: torch.sparse.sampled_addmm(csr, gw, x_t, beta=0.0), 2, dv_coo)
    del csr, x_t, dv_coo
    torch.cuda.empty_cache()
    res["spmm_spans"].update(library_ms=lib_mm, k1_same_graph_ms=k1_ms)
    res["sddmm_spans"]["library_ms"] = lib_sd
    res["spmm_sddmm_spans"] = phase7c_fused(card, run, graph, lib_sd)
    print(f"phase 7c yardsticks on the same graph (CSR order, f32, K={K}): "
          f"K1 spmm_csr {k1_ms:.3f} ms (vs spans max_abs_err {k1_err:.3e}); "
          f"torch.sparse.mm {lib_mm} ms (max_abs_err {lib_mm_err}); "
          f"torch.sparse.sampled_addmm {lib_sd} ms (max_abs_err "
          f"{lib_sd_err}); spans with a bf16 x {ms_b:.3f} ms {card}",
          flush=True)
    return res


def phase7c_fused(card, run, graph, lib_sd):
    """The fused span backward (``spmm_sddmm_spans_cuda``) on the seg2 f32
    path's own inputs (uniform graph, K=256): against its plain version;
    as the backward runs it (the values relayed, the launch, d value read
    back) in turns with the pair it replaces, d x and d value bit for bit;
    the launch alone; its bounds; and the library pair, ``torch.sparse.mm``
    of the transpose's CSR for d x in turns with it, plus ``sampled_addmm``
    for d value (``lib_sd``, timed by the caller)."""
    from paddle_sparse_tpu_torch import ind2ptr, spmm_sddmm_spans_reference
    row, col, val, x = graph
    plan, s, packed, gw = run["plan"], run["s"], run["packed"], run["gw"]
    nnz, K, n = row.numel(), x.shape[1], plan.num_cols
    st, en, col_t, base = _transpose_layout(plan, s)[:4]
    with torch.inference_mode():
        vt = packed.index_select(0, s.relay_ft)
        p1, k1, k2, p2, out_p, out_k = in_turns(
            lambda: spmm_sddmm_spans_reference(st, en, col_t, vt, base, gw,
                                               x),
            lambda: fused_span_kernel(plan, s, packed, x, gw, relayed=vt),
            1, 5)
        errs = [float((a - b).abs().max()) for a, b in zip(out_k, out_p)]
        scale = float(out_p[1].abs().max())
        ok = (bool(torch.allclose(out_k[0], out_p[0], **F32_TOL))
              and bool(torch.allclose(out_k[1], out_p[1], rtol=1e-4,
                                      atol=GRAD_REL * scale)))
        print(f"phase 7c spmm_sddmm_spans on seg2's backward (S_t="
              f"{plan.S_t}, K={K}, f32), the launch alone: kernel "
              f"{k1:.3f} / {k2:.3f} ms, plain {p1:.3f} / {p2:.3f} ms; "
              f"kernel vs plain max_abs_err d x {errs[0]:.3e}, d value "
              f"{errs[1]:.3e} (max |dv| {scale:.3e}) "
              f"{'ok' if ok else 'FAIL'} {card}", flush=True)
        check(ok, "the fused span kernel and its plain version disagree")
        moved = nbytes(s.rp_t, col_t, vt, base, gw, x, *out_k)
        del out_p, out_k
        q1, f1, f2, q2, out_q, out_f = in_turns(
            lambda: fused_span_pair(plan, s, packed, x, gw),
            lambda: fused_span_kernel(plan, s, packed, x, gw), 5, 5)
        same = all(torch.equal(a, b) for a, b in zip(out_f, out_q))
        print(f"phase 7c spmm_sddmm_spans as the backward runs it (values "
              f"relayed, the launch, d value read back) in turns with the "
              f"pair it replaces (packed[relay], spans over the transpose, "
              f"span SDDMM over the forward layout): pair {q1:.3f} / "
              f"{q2:.3f} ms, fused {f1:.3f} / {f2:.3f} ms; d x and d value "
              f"bit for bit {'equal' if same else 'DIFFERENT'} {card}",
              flush=True)
        check(same, "the fused span backward differs from the pair at scale")
        del out_q
        order = torch.argsort(col, stable=True)
        at = torch.sparse_csr_tensor(ind2ptr(col[order], n).to(torch.int32),
                                     row[order], val[order],
                                     (n, plan.num_rows))
        del order
        lib_t, ms_a, err_t = library_in_turns(
            "torch.sparse.mm (A^T @ g, the fused span kernel's d x)",
            lambda: torch.sparse.mm(at, gw), lambda: fused_span_kernel(
                plan, s, packed, x, gw, relayed=vt), 2, out_f[0])
        del at, vt, out_f
        torch.cuda.empty_cache()
    bound, by = bound_ms(moved, 4 * nnz * K)
    gather = nnz * K * gw.element_size() / HBM_BYTES_PER_S * 1e3
    lib = None if lib_t is None or lib_sd is None else lib_t + lib_sd
    print(f"phase 7c spmm_sddmm_spans K={K}: the launch {(k1 + k2) / 2:.3f} "
          f"ms, as routed {(f1 + f2) / 2:.3f} ms, the pair "
          f"{(q1 + q2) / 2:.3f} ms; bound {bound:.3f} ms ({by}, "
          f"{moved / 1e9:.2f} GB each once), gathered rows {gather:.3f} ms; "
          f"library torch.sparse.mm of the transpose {lib_t} ms (vs d x "
          f"max_abs_err {err_t}) + sampled_addmm {lib_sd} ms = {lib} ms "
          f"{card}", flush=True)
    return {"ms": (k1 + k2 + ms_a) / 3, "routed_ms": (f1 + f2) / 2,
            "pair_ms": (q1 + q2) / 2, "plain_ms": (p1 + p2) / 2,
            "max_abs_err": max(errs), "bound_ms": bound, "bound_by": by,
            "gather_bound_ms": gather, "library_ms": lib,
            "library_d_x_ms": lib_t, "library_d_value_ms": lib_sd,
            "bit_equal_to_pair": same}


def phase7c_scale(dev, card):
    """The bench's seg2/seg3/split cells at full width (K=256, K=64 for
    dim64): plan, times, launches and sampled f64 checks for each."""
    from paddle_sparse_tpu_torch import CAP, Seg3Infeasible, make_seg3_plan
    paths = {}
    graph = bench_graph(dev, "uniform", 1.0, 256)
    run = phase7c_path(dev, card, "seg2 uniform f32", "seg2", graph, "f32",
                       profile_first=True)
    paths["seg2_uniform_f32"] = run["stats"]
    kernels = phase7c_kernels(dev, card, run, graph)
    del run
    torch.cuda.empty_cache()
    paths["seg2_uniform_bf16"] = phase7c_path(
        dev, card, "seg2 uniform bf16", "seg2", graph, "bf16")["stats"]
    torch.cuda.empty_cache()
    paths["seg3_uniform_bf16"] = phase7c_path(
        dev, card, "seg3 uniform bf16", "seg3", graph, "bf16")["stats"]
    del graph
    torch.cuda.empty_cache()
    graph = bench_graph(dev, "uniform", 0.125, 64)
    paths["seg2_dim64_bf16"] = phase7c_path(
        dev, card, "seg2 dim64 1/8 bf16", "seg2", graph, "bf16")["stats"]
    del graph
    graph = bench_graph(dev, "clustered", 1.0, 256)
    torch.cuda.empty_cache()
    paths["split_clustered_bf16"] = phase7c_path(
        dev, card, "split clustered bf16", "seg2split", graph, "bf16",
        block=2048)["stats"]
    del graph
    torch.cuda.empty_cache()
    graph = bench_graph(dev, "zipf", 0.125, 256)
    row, col, _, x = graph
    try:
        make_seg3_plan(row, col, x.shape[0], x.shape[0], feat_dim=256,
                       stream="bf16")
        refused = None
    except Seg3Infeasible as e:
        refused = str(e)
    check(refused is not None, "seg3 planned the 1/8 zipf graph")
    deg = torch.bincount(row.long(), minlength=x.shape[0])
    print(f"phase 7c zipf 1/8 ({row.numel()} nnz, hub row of "
          f"{int(deg.max())} edges): make_seg3_plan refused "
          f"(Seg3Infeasible: {refused}); the bench falls back to seg2",
          flush=True)
    run = phase7c_path(dev, card, "seg2 zipf 1/8 bf16", "seg2", graph,
                       "bf16")
    paths["seg2_zipf_bf16"] = run["stats"]
    kernels["zipf"] = phase7c_zipf_kernels(dev, card, run, graph)
    del graph, run
    torch.cuda.empty_cache()
    graph = bench_graph(dev, "zipf", 1.0, 256)
    deg = torch.bincount(graph[0].long(), minlength=graph[3].shape[0])
    top = torch.topk(deg, 2).values.tolist()
    print(f"phase 7c zipf full scale: {graph[0].numel()} nnz, top rows "
          f"{top[0]} and {top[1]} edges, {int((deg > CAP).sum())} rows of "
          f"more than CAP = {CAP} edges holding "
          f"{int(deg[deg > CAP].sum())}", flush=True)
    paths["seg2_zipf_full_bf16"] = phase7c_path(
        dev, card, "seg2 zipf full bf16", "seg2", graph, "bf16")["stats"]
    del graph, deg
    torch.cuda.empty_cache()
    return paths, kernels


def phase7c_zipf_kernels(dev, card, run, graph):
    """On the zipf 1/8 path, whose hub rows split: the two span kernels
    alone on the path's own inputs, K1 and K2 on the same graph's CSR, each
    in f32 and bf16 in turns with its library call in the same dtype
    (``torch.sparse.mm``, ``torch.sparse.sampled_addmm``); two launches of
    each bit for bit equal; the fused CSC backward at K=256 and 47 in f32
    in turns with the pair it replaces, bit for bit; and the fold alone on
    the hub's partials against its plain version and ``index_add_``."""
    from paddle_sparse_tpu_torch import (fold_pieces_cuda, ind2ptr,
                                         sddmm_csr_cuda, sddmm_spans_cuda,
                                         spmm_csr_cuda, spmm_spans_cuda,
                                         split_rows, unpack_values)
    from paddle_sparse_tpu_torch.ops.kernels.row_split import \
        fold_pieces_reference
    row, col, val, x = graph
    plan, s, packed, gw = run["plan"], run["s"], run["packed"], run["gw"]
    M, K, nnz = plan.num_rows, x.shape[1], row.numel()
    st, en = s.rp_f[:, :M], s.rp_f[:, 1:M + 1]
    rowptr = ind2ptr(row, M).to(torch.int32)
    t_csr = split_rows(rowptr[None, :-1], rowptr[None, 1:])
    res = {"hub_edges": int(torch.diff(rowptr).max()),
           "split_rows": int(s.split_f.fold_row.numel()),
           "pieces": int(s.split_f.row.numel())}
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt)[6:]
        xd, gd, vd, pd = x.to(dt), gw.to(dt), val.to(dt), packed.to(dt)
        csr = torch.sparse_csr_tensor(rowptr, col, vd, (M, M))
        x_t = xd.t().contiguous()
        with torch.inference_mode():
            def spans():
                return spmm_spans_cuda(st, en, s.col_f, pd, s.sbase_f, xd,
                                       out_dtype=dt, split=s.split_f)

            def k1():
                return spmm_csr_cuda(rowptr, col, vd, xd, split=t_csr)

            def span_sddmm():
                return sddmm_spans_cuda(st, en, s.col_f, s.sbase_f, gd, xd,
                                        split=s.split_f)

            def k2():
                return sddmm_csr_cuda(rowptr, col, gd, xd, split=t_csr)
            out, out_k1 = spans(), k1()
            dv, dv_k2 = span_sddmm(), k2()
            check(all(torch.equal(a, b) for a, b in (
                (out, spans()), (out_k1, k1()), (dv, span_sddmm()),
                (dv_k2, k2()))), f"zipf {name}: two launches differ")
            dv_coo = unpack_values(s, dv)
            # the hub row's 10M terms summed in two orders (packed and
            # CSR): each within GRAD_REL of the row's sum of |terms|, and a
            # bf16 output rounded once on each side (up to 2**-8 of it each)
            scale = spmm_spans_cuda(st, en, s.col_f, pd.abs(), s.sbase_f,
                                    xd.abs(), out_dtype=torch.float32,
                                    split=s.split_f).double()
            err, ok = _grad_close(out_k1, out, 2 * scale,
                                  0.0 if dt == torch.float32 else 2 ** -7)
            check(ok and torch.allclose(dv_coo, dv_k2, **F32_TOL),
                  f"zipf {name}: the spans and K1 ({err:.3e}) or the span "
                  f"SDDMM and K2 disagree")
            del scale
            lib = f"torch.sparse.mm ({name})"
            mm_ms, sp_ms, mm_err = library_in_turns(
                lib, lambda: torch.sparse.mm(csr, xd), spans, 3, out)
            _, k1_ms, _ = library_in_turns(
                lib, lambda: torch.sparse.mm(csr, xd), k1, 3)
        # sampled_addmm takes seconds on this graph: one call before and
        # one after the two kernels' turns, no warm-up
        lib2 = f"torch.sparse.sampled_addmm ({name})"

        def sampled():
            return torch.sparse.sampled_addmm(csr, gd, x_t, beta=0.0)
        sa1, sa_err = library_timed(lib2, sampled, 1, dv_coo, warm=False)
        sd1, _ = timed(span_sddmm, 3)
        k21, _ = timed(k2, 3)
        k22, _ = timed(k2, 3)
        sd2, _ = timed(span_sddmm, 3)
        sa2 = (None if sa1 is None
               else library_timed(lib2, sampled, 1, warm=False)[0])
        sa_ms = None if sa2 is None else (sa1 + sa2) / 2
        sd_ms, k2_ms = (sd1 + sd2) / 2, (k21 + k22) / 2
        gather = nnz * K * xd.element_size() / HBM_BYTES_PER_S * 1e3
        sp_b = bound_ms(nbytes(s.rp_f, s.col_f, pd, s.sbase_f, xd)
                        + M * K * xd.element_size(), 2 * nnz * K)
        k1_b = bound_ms(nbytes(rowptr, col, vd, xd)
                        + M * K * xd.element_size(), 2 * nnz * K)
        sd_b = bound_ms(nbytes(s.rp_f, s.col_f, s.sbase_f, gd, xd)
                        + 4 * nnz, 2 * nnz * K)
        k2_b = bound_ms(nbytes(rowptr, col, gd, xd) + 4 * nnz, 2 * nnz * K)
        del csr, x_t, out, out_k1, dv, dv_k2, dv_coo, pd
        torch.cuda.empty_cache()
        res[name] = {
            "spmm_spans": {"ms": sp_ms, "library_ms": mm_ms,
                           "library_max_abs_err": mm_err,
                           "bound_ms": sp_b[0], "bound_by": sp_b[1]},
            "spmm_csr": {"ms": k1_ms, "library_ms": mm_ms,
                         "bound_ms": k1_b[0], "bound_by": k1_b[1]},
            "sddmm_spans": {"ms": sd_ms, "library_ms": sa_ms,
                            "library_max_abs_err": sa_err,
                            "bound_ms": sd_b[0], "bound_by": sd_b[1]},
            "sddmm_csr": {"ms": k2_ms, "library_ms": sa_ms,
                          "bound_ms": k2_b[0], "bound_by": k2_b[1]},
            "gather_bound_ms": gather}
        print(f"phase 7c zipf 1/8 kernels alone ({name}, K={K}, {nnz} nnz, "
              f"hub row of {res['hub_edges']} edges, {res['split_rows']} "
              f"rows split into {s.split_f.num_slots} pieces), each in "
              f"turns with its library "
              f"call in {name}: spmm_spans {sp_ms:.3f} ms, K1 {k1_ms:.3f} ms "
              f"vs torch.sparse.mm {mm_ms} ms (max_abs_err {mm_err}); "
              f"sddmm_spans {sd_ms:.3f} ms, K2 {k2_ms:.3f} ms vs "
              f"sampled_addmm {sa_ms} ms (max_abs_err {sa_err}); gathered "
              f"rows bound {gather:.3f} ms; two launches of each bit for "
              f"bit equal {card}", flush=True)

    # the fused CSC backward on this graph (64% of its edges read the hub's
    # row of g) at K=256 and at APPNP's K=47, f32, in turns with the pair
    # it replaces, bit for bit
    from paddle_sparse_tpu_torch import PaddedCOO
    adj = PaddedCOO.from_arrays(row, col, val, (M, M))
    res["spmm_sddmm_csc"] = {}
    with torch.no_grad():
        for k in (K, 47):
            xk, gk = x[:, :k].contiguous(), gw[:, :k].contiguous()
            q1, f1, f2, q2, out_q, out_f = in_turns(
                lambda: fused_pair(adj, val, gk, xk, val.dtype),
                lambda: fused_kernel(adj, val, gk, xk, val.dtype), 5, 5)
            check(all(torch.equal(a, b) for a, b in zip(out_f, out_q)),
                  f"zipf K={k}: the fused kernel differs from the pair")
            res["spmm_sddmm_csc"][f"K{k}"] = {"ms": (f1 + f2) / 2,
                                              "pair_ms": (q1 + q2) / 2}
            print(f"phase 7c zipf 1/8 spmm_sddmm_csc alone (K={k}, f32, "
                  f"columns {'split' if adj.structure().col_split else 'unsplit'}"
                  f"), in turns with K2 + value[perm] + K1 over the CSC "
                  f"view: pair {q1:.3f} / {q2:.3f} ms, fused {f1:.3f} / "
                  f"{f2:.3f} ms; d x and d value bit for bit equal {card}",
                  flush=True)
            del xk, gk, out_q, out_f
    del adj
    res["spmm_sddmm_spans"] = phase7c_zipf_fused(card, run, graph)

    # the fold alone on the forward's split rows, K=256 f32 partials
    t = s.split_f
    ws = torch.randn(t.num_slots, K, generator=torch.Generator(
        device=dev).manual_seed(13), device=dev)
    out_p = torch.zeros(M, K, device=dev)
    out_k = torch.zeros(M, K, device=dev)
    slot_rows = torch.repeat_interleave(t.fold_row.long(),
                                        torch.diff(t.fold_ptr.long()))
    folds = fold_pieces_cuda.launches
    p1, k1_, k2_, p2, _, _ = in_turns(
        lambda: fold_pieces_reference(t, ws, out_p),
        lambda: fold_pieces_cuda(t, ws, out_k), 1, 20)
    check(fold_pieces_cuda.launches == folds + 42, "fold launches")
    # thousands of partials summed in two orders: within GRAD_REL of the
    # sum of their |values|
    scale = torch.zeros(M, K, device=dev)
    fold_pieces_reference(t, ws.abs(), scale)
    err, ok = _grad_close(out_k, out_p, scale.double())
    check(ok, f"fold disagrees with plain ({err:.3e})")
    out_l = torch.zeros(M, K, device=dev)
    lib_ms, _ = library_timed("index_add_ (the fold's sum)",
                              lambda: out_l.index_add_(0, slot_rows, ws), 20)
    fb, fby = bound_ms(nbytes(ws, t.fold_row, t.fold_ptr)
                       + t.fold_row.numel() * K * 4, t.num_slots * K)
    res["fold_pieces"] = {"ms": (k1_ + k2_) / 2, "plain_ms": (p1 + p2) / 2,
                          "max_abs_err": err, "bound_ms": fb,
                          "bound_by": fby, "library_ms": lib_ms,
                          "slots": t.num_slots, "rows": t.fold_row.numel()}
    print(f"phase 7c zipf 1/8 fold alone ({t.num_slots} partials of "
          f"{t.fold_row.numel()} split rows, K={K} f32): kernel {k1_:.3f} / "
          f"{k2_:.3f} ms, plain {p1:.3f} / {p2:.3f} ms, index_add_ {lib_ms} "
          f"ms, bound {fb:.4f} ms ({fby}); max_abs_err {err:.3e} ok {card}",
          flush=True)
    return res


def phase7c_zipf_fused(card, run, graph):
    """The fused span backward on the zipf 1/8 path's own inputs (bf16
    stream) and on the same graph transposed, where the hub rows become x
    rows cut into pieces (the fold after): each as the backward runs it, in
    turns with the pair it replaces, d x and d value bit for bit; on the
    transposed graph also against its plain version in f64 (d x within
    GRAD_REL of each entry's sum of |terms|: the hub's 10M terms)."""
    from paddle_sparse_tpu_torch import (fold_pieces_cuda, make_seg2_plan,
                                         pack_values,
                                         spmm_sddmm_spans_reference)
    row, col, val, x = graph
    plan, s, packed, gw = run["plan"], run["s"], run["packed"], run["gw"]
    n, K = x.shape
    order = torch.argsort(col, stable=True)
    plan_t, s_t = make_seg2_plan(col[order], row[order], n, n, feat_dim=K,
                                 stream="bf16")
    packed_t = pack_values(s_t, val[order])
    del order
    check(s.split_t is None and s_t.split_t is not None,
          "zipf's x rows split, or its transpose's do not")
    res = {"x_rows_split_transposed": int(s_t.split_t.fold_row.numel()),
           "pieces_transposed": int(s_t.split_t.num_slots)}
    with torch.inference_mode():
        for tag, (q_plan, q, q_packed) in (
                ("zipf", (plan, s, packed)),
                ("transposed", (plan_t, s_t, packed_t))):
            folds = fold_pieces_cuda.launches
            q1, f1, f2, q2, out_q, out_f = in_turns(
                lambda: fused_span_pair(q_plan, q, q_packed, x, gw),
                lambda: fused_span_kernel(q_plan, q, q_packed, x, gw), 5, 5)
            same = all(torch.equal(a, b) for a, b in zip(out_f, out_q))
            check(same, f"zipf {tag}: the fused span backward differs from "
                        f"the pair")
            # 12 launches of each, the fold after every one over split rows
            check(fold_pieces_cuda.launches - folds
                  == (24 if q.split_t is not None else 0),
                  f"zipf {tag}: fold launches")
            res[tag] = {"ms": (f1 + f2) / 2, "pair_ms": (q1 + q2) / 2}
            print(f"phase 7c zipf 1/8 {tag} spmm_sddmm_spans as the backward "
                  f"runs it (bf16 stream, K={K}, S_t={q_plan.S_t}, x rows "
                  f"{'split' if q.split_t is not None else 'unsplit'}), in "
                  f"turns with the spans + span SDDMM pair: pair {q1:.3f} / "
                  f"{q2:.3f} ms, fused {f1:.3f} / {f2:.3f} ms; d x and d "
                  f"value bit for bit equal {card}", flush=True)
            del out_q
        st, en, col_t, base = _transpose_layout(plan_t, s_t)[:4]
        gb, xb = gw.bfloat16(), x.bfloat16()
        vt = packed_t.index_select(0, s_t.relay_ft)
        ref, scale = (spmm_sddmm_spans_reference(
            st, en, col_t, f(vt), base, f(gb), f(xb),
            out_dtype=torch.float64)
            for f in (torch.Tensor.double, lambda t: t.double().abs()))
        err_x, ok_x = _grad_close(out_f[0], ref[0], scale[0])
        ref_v = ref[1].index_select(0, s_t.relay_tf)   # the packed order
        err_v = float((out_f[1].double() - ref_v).abs().max())
        ok_v = bool(torch.allclose(out_f[1].double(), ref_v, **F32_TOL))
        del ref, scale, ref_v, out_f, gb, xb, vt
    print(f"phase 7c zipf 1/8 transposed spmm_sddmm_spans "
          f"({res['x_rows_split_transposed']} x rows split into "
          f"{res['pieces_transposed']} pieces) vs plain f64: d x "
          f"{err_x:.3e} (within {GRAD_REL} of its sums of |terms|), d value "
          f"{err_v:.3e} {'ok' if ok_x and ok_v else 'FAIL'} {card}",
          flush=True)
    check(ok_x and ok_v, "the fused span kernel over split x rows disagrees "
                         "with its plain version")
    res["transposed_max_abs_err"] = max(err_x, err_v)
    del plan_t, s_t, packed_t
    torch.cuda.empty_cache()
    return res


# ---- phase 8: SpMM mean/min/max and the other model families --------------

GAT_HEADS, GAT_HIDDEN = 4, 64           # 3 layers: 4 x 64, 4 x 64, 1 x 47
GAT_PRODUCTS_SHAPES = ((4, 128), (4, 47))  # gat-products: hidden, last
APPNP_K, APPNP_ALPHA = 10, 0.1
REDUCE_NODES = 4000


class SpmmCall:
    """One recorded SpMM: ``adj``, the ``value`` it multiplied by (its
    own, or the call's ``value=``), ``x``, ``reduce`` and ``out``; for one
    head of a per-head call (``value`` (E, H): GAT's heads) ``head`` is
    its index, and the properties below give that head's part."""

    def __init__(self, adj, value, x, reduce, out, head=None):
        self.adj, self.value, self.x, self.reduce, self.out = (
            adj, value, x, reduce, out)
        self.head = head

    def _part(self, t):
        """A head's columns of an (R, H * D) tensor; all of it else."""
        t = t.reshape(t.shape[0], -1)
        if self.head is None:
            return t
        return t.reshape(t.shape[0], self.value.shape[1], -1)[:, self.head]

    @property
    def vals(self):
        return self.value if self.head is None else self.value[:, self.head]

    @property
    def xs(self):
        return self._part(self.x.detach())

    @property
    def outs(self):
        return self._part(self.out.detach())

    @property
    def d_out(self):
        return None if self.out.grad is None else self._part(self.out.grad)

    @property
    def d_value(self):
        g = self.value.grad
        return g if g is None or self.head is None else g[:, self.head]


class SpmmCalls:
    """Records every ``PaddedCOO.spmm`` call made inside the ``with``
    block as :class:`SpmmCall` s, one a head of a per-head call, the grads
    of the output and of a non-leaf value (GAT's attention weights)
    retained, so that sampled rows and ``d value`` can be checked against
    f64 afterwards."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        from paddle_sparse_tpu_torch import PaddedCOO
        self._orig = orig = PaddedCOO.spmm
        calls = self.calls

        def spmm(adj, x, reduce="sum", backend="auto", value=None):
            out = orig(adj, x, reduce, backend, value)
            if out.requires_grad:
                out.retain_grad()
            v = adj.value if value is None else value
            if v is not None and v.requires_grad and not v.is_leaf:
                v.retain_grad()
            heads = [None] if v is None or v.dim() == 1 else range(
                v.shape[1])
            calls.extend(SpmmCall(adj, v, x, reduce, out, k) for k in heads)
            return out
        PaddedCOO.spmm = spmm
        return self

    def __exit__(self, *exc):
        from paddle_sparse_tpu_torch import PaddedCOO
        PaddedCOO.spmm = self._orig
        return False


def sampled_rows(rowptr, n_rows=SAMPLED_ROWS, seed=2):
    """``n_rows`` random rows and the longest one."""
    deg = rowptr[1:] - rowptr[:-1]
    rows = torch.randperm(rowptr.numel() - 1, generator=torch.Generator(
        ).manual_seed(seed))[:n_rows - 1]
    return torch.cat([deg.argmax().view(1).cpu(), rows]).unique().to(
        rowptr.device)


def check_spmm_calls(name, calls, rows):
    """Sampled rows of every recorded SpMM (sum or mean) against f64, each
    within GRAD_REL of its sum of |terms|; the gathered x rows are widened
    only where the sampled edges read them."""
    from paddle_sparse_tpu_torch import spmm_csr_reference
    worst, ok_all, n_edges = 0.0, True, 0
    for c in calls:
        rowptr = c.adj.rowptr()
        edge, sub_ptr = _sub_csr(rowptr, rows)
        n_edges = max(n_edges, edge.numel())
        uc, sub_col = torch.unique(c.adj.col[edge], return_inverse=True)
        xd = c.xs[uc.long()].double()
        val = c.vals[edge].detach().double()
        ref = spmm_csr_reference(sub_ptr, sub_col, val, xd)
        scale = spmm_csr_reference(sub_ptr, sub_col, val.abs(), xd.abs())
        if c.reduce == "mean":
            deg = (sub_ptr[1:] - sub_ptr[:-1]).clamp(min=1)[:, None]
            ref, scale = ref / deg, scale / deg
        got = c.outs[rows]
        err, ok = _grad_close(got, ref, scale)
        worst, ok_all = max(worst, err), ok_all and ok
    print(f"phase 8 {name}: {len(calls)} SpMMs of the forward, "
          f"{rows.numel()} sampled rows each (the longest among them; up to "
          f"{n_edges} edges) vs f64 within {GRAD_REL} of the sum of |terms|: "
          f"max_abs_err {worst:.3e} {'ok' if ok_all else 'FAIL'}",
          flush=True)
    check(ok_all, f"{name}: an SpMM disagrees with f64 on sampled rows")
    return worst


def _d_value_err(adj, calls, d_value):
    """Max abs error, pass flag and max |reference| of ``d value`` on
    ``SAMPLED_EDGES`` sampled edges against the f64 sum over ``calls`` of
    ``g[row] . x[col]`` (over the row's degree for a mean), within
    GRAD_REL of the sum of |terms|."""
    rowptr, col = adj.rowptr(), adj.col
    gen = torch.Generator().manual_seed(6)
    e = torch.randint(0, adj.nnz, (SAMPLED_EDGES,), generator=gen).to(
        adj.row.device)
    er = adj.row[e].long()
    ec = col[e].long()
    deg = (rowptr[1:] - rowptr[:-1]).clamp(min=1)[er].double()
    ref = torch.zeros(SAMPLED_EDGES, dtype=torch.float64, device=e.device)
    scale = torch.zeros_like(ref)
    for c in calls:
        if c.d_out is None:
            continue
        terms = c.d_out[er].double() * c.xs[ec].double()
        if c.reduce == "mean":
            terms = terms / deg[:, None]
        ref += terms.sum(1)
        scale += terms.abs().sum(1)
    err, ok = _grad_close(d_value[e], ref, scale)
    return err, ok, float(ref.abs().max())


def check_d_value(name, adj, calls, d_value):
    """``d value`` of the one value tensor that all ``calls`` share on
    sampled edges against f64 (:func:`_d_value_err`)."""
    err, ok, ref_max = _d_value_err(adj, calls, d_value)
    print(f"phase 8 {name}: d value on {SAMPLED_EDGES} sampled edges vs f64: "
          f"max_abs_err {err:.3e} (max |dv| {ref_max:.3e}) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    check(ok, f"{name}: d value disagrees with f64 on sampled edges")
    return err


def check_call_d_values(name, calls):
    """``d value`` of each call's own values (GAT's ``d att``, one call
    a head and layer) on sampled edges against that call's f64
    ``g[row] . x[col]`` (:func:`_d_value_err`)."""
    check(len(calls) > 0 and all(c.d_value is not None for c in calls),
          f"{name}: a recorded SpMM has no value grad")
    res = [_d_value_err(c.adj, [c], c.d_value) for c in calls]
    err = max(r[0] for r in res)
    ok = all(r[1] for r in res)
    print(f"phase 8 {name}: d value of each of {len(res)} SpMMs on "
          f"{SAMPLED_EDGES} sampled edges vs f64: max_abs_err {err:.3e} "
          f"(max |dv| {max(r[2] for r in res):.3e}) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    check(ok, f"{name}: d value disagrees with f64 on sampled edges")
    return err


def reduce_graph(gen, dev, ints):
    """A padded ``PaddedCOO`` of ``REDUCE_NODES`` nodes: a hub row (7) and a
    hub column (11) of ``2 * CAP + 5`` edges each, empty rows (0, 500,
    last), row 3's products all negative, duplicate entries; with ``ints``
    small-integer values and x (ties everywhere). Padding cols poisoned
    with 2**30: a gather of one faults. Returns it and x (K=48)."""
    from paddle_sparse_tpu_torch import CAP, PaddedCOO
    M = REDUCE_NODES
    hub = 2 * CAP + 5
    row = torch.cat([torch.full((hub,), 7, device=dev),
                     torch.randint(0, M, (40_000,), generator=gen,
                                   device=dev),
                     torch.arange(hub, device=dev) % M])
    col = torch.cat([torch.randint(0, M, (hub,), generator=gen, device=dev),
                     torch.randint(0, M, (40_000,), generator=gen,
                                   device=dev),
                     torch.full((hub,), 11, device=dev)])
    keep = (row != 0) & (row != 500) & (row != M - 1)
    row, col = row[keep], col[keep]
    row, col = torch.cat([row, row[:300]]), torch.cat([col, col[:300]])
    order = torch.argsort(row, stable=True)
    row, col = row[order], col[order]
    if ints:
        val = torch.randint(-2, 3, (row.numel(),), generator=gen,
                            device=dev).float()
        x = torch.randint(-2, 3, (M, 48), generator=gen, device=dev).float()
    else:
        val = torch.rand(row.numel(), generator=gen, device=dev) * 2 - 1
        x = torch.randn(M, 48, generator=gen, device=dev)
    val[row == 3] = -val[row == 3].abs() - 0.5
    pos = torch.zeros(M, dtype=torch.bool, device=dev)
    pos[col[row == 3]] = True
    x = torch.where(pos[:, None], x.abs() + 1, x)
    adj = PaddedCOO.from_arrays(row, col, val, (M, M),
                                capacity=row.numel() + 1000)
    adj = dataclasses.replace(adj, col=torch.where(
        adj.valid_mask(), adj.col, torch.full_like(adj.col, 1 << 30)))
    return adj, x


def phase8a_reductions(gen, dev):
    """SpMM mean, min and max on the card against the plain path in f64
    (the port on the CPU, f64 inputs): forward, d value and d x; mean
    within GRAD_REL of the sum of |terms|, min and max within F32_TOL; the
    launches (mean: K1 forward, the fused CSC backward for d x and d value,
    the fold after the split K1 and after the fused pass over split
    columns; min and max: none). The CPU runs keep the poisoned padding
    cols too."""
    stats = {}
    for ints in (False, True):
        adj, x = reduce_graph(gen, dev, ints)
        w = torch.randn(x.shape, generator=gen, device=dev)
        for reduce in ("mean", "min", "max"):
            runs = {}
            for where in ("card", "f64", "abs"):
                a = adj if where == "card" else adj.to("cpu")
                f = ((lambda t: t) if where == "card" else
                     (lambda t: t.double().cpu()) if where == "f64" else
                     (lambda t: t.double().abs().cpu()))
                v = f(a.value).clone().requires_grad_()
                xx = f(x).clone().requires_grad_()
                _zero_launch_counts()
                out = a.with_value(v).spmm(xx, reduce)
                (out * f(w)).sum().backward()
                if where == "card":
                    torch.cuda.synchronize()
                    counts = _launch_counts()
                runs[where] = (out.detach(), v.grad, xx.grad)
            want = ({"spmm_csr": 1, "spmm_sddmm_csc": 1, "fold_pieces": 2}
                    if reduce == "mean" else {})
            check(all(counts[k] == want.get(k, 0) for k in counts),
                  f"{reduce}: expected launches {want}, counted {counts}")
            errs, ok = [], True
            for name, c, h, a in zip(("out", "d value", "d x"), runs["card"],
                                     runs["f64"], runs["abs"]):
                c, h, a = c.cpu(), h.cpu(), a.cpu()
                if name == "d value":
                    check(not c[adj.nnz:].any(), "padding got a d value")
                    c, h, a = c[:adj.nnz], h[:adj.nnz], a[:adj.nnz]
                if reduce == "mean":
                    err, good = _grad_close(c, h, a)
                else:
                    err = float((c.double() - h).abs().max())
                    good = bool(torch.allclose(c.double(), h, **F32_TOL))
                errs.append(err)
                ok = ok and good
            out = runs["card"][0].cpu()
            check(not out[[0, 500, REDUCE_NODES - 1]].any(),
                  f"{reduce}: empty rows not 0")
            if reduce == "max":
                check(bool((out[3] < 0).all()),
                      "max: a row of negative products read a padding 0")
            label = f"{reduce}_{'ints' if ints else 'f32'}"
            print(f"phase 8a spmm {reduce} "
                  f"{'small ints (ties)' if ints else 'f32'}, {adj.nnz} nnz + "
                  f"{adj.capacity - adj.nnz} poisoned pads, K=48, a hub row "
                  f"and column past CAP: out / d value / d x vs "
                  f"plain f64 max_abs_err "
                  f"{' / '.join(f'{e:.3e}' for e in errs)}; launches "
                  f"{counts} {'ok' if ok else 'FAIL'}", flush=True)
            check(ok, f"spmm {label} disagrees with plain f64")
            stats[label] = {"max_abs_err": max(errs), "launches": counts}
    return stats


def phase8a_scale(dev, card):
    """Min and max at 1/8 of ogbn-products scale (``bench_graph``'s uniform
    graph: 306,128 nodes, 15.3M nnz), where the (nnz, K) product tensor that
    they materialize fits the card (at full scale, K=256 f32, it would take
    125 GB): forwards at K=256 in inference mode and forward+backwards at
    K=64, 1 warm-up + 2 timed each, peak memory, and the forward's sampled
    rows (the longest among them) against f64."""
    from paddle_sparse_tpu_torch import PaddedCOO
    row, col, val, x = bench_graph(dev, "uniform", 0.125, 256)
    n = x.shape[0]
    adj = PaddedCOO.from_arrays(row, col, val, (n, n))
    del row, col, val
    rows = sampled_rows(adj.rowptr())
    edge, sub_ptr = _sub_csr(adj.rowptr(), rows)
    sub_row = torch.repeat_interleave(torch.arange(rows.numel(),
                                                   device=dev),
                                      sub_ptr[1:] - sub_ptr[:-1])
    res = {}
    for reduce in ("min", "max"):
        for K, grad in ((256, False), (64, True)):
            xk = x[:, :K].contiguous().requires_grad_(grad)
            v = adj.value.detach().requires_grad_(grad)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            times = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if grad:
                    out = adj.with_value(v).spmm(xk, reduce)
                    out.sum().backward()
                else:
                    with torch.inference_mode():
                        out = adj.with_value(v).spmm(xk, reduce)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            peak = torch.cuda.max_memory_allocated() / 1e9
            prod = (adj.value[edge].detach().double()[:, None]
                    * xk.detach()[adj.col[edge].long()].double())
            ref = torch.full((rows.numel(), K), float("nan"),
                             dtype=torch.float64, device=dev)
            ref = ref.scatter_reduce(0, sub_row[:, None].expand_as(prod),
                                     prod, "amax" if reduce == "max"
                                     else "amin", include_self=False)
            got = out.detach()[rows].double()
            err = float((got - ref).abs().max())
            ok = bool(torch.allclose(got, ref, **F32_TOL))
            what = "forward+backward" if grad else "forward"
            res[f"{reduce}_{what}_K{K}"] = {
                "ms": sum(times[1:]) / 2, "peak_gb": peak,
                "max_abs_err": err}
            print(f"phase 8a {reduce} at 1/8 scale ({n} nodes, {adj.nnz} "
                  f"nnz), K={K} {what} ms: warm-up {times[0]:.3f}, timed "
                  f"{times[1]:.3f} {times[2]:.3f}; peak mem {peak:.2f} GB; "
                  f"{rows.numel()} sampled rows vs f64 max_abs_err "
                  f"{err:.3e} {'ok' if ok else 'FAIL'} {card}", flush=True)
            check(ok, f"{reduce} at 1/8 scale disagrees with f64")
            del out, prod, ref, xk, v
    del adj, x
    torch.cuda.empty_cache()
    return res


def phase8b_toy_models(dev):
    """Each of the four families on its toy set-up (``model_entry``):
    forward, loss, every parameter's grad and d value, card against CPU."""
    from paddle_sparse_tpu_torch import gcn_loss, model_entry
    for kind in ("sage", "gin", "appnp", "gat"):
        runs = {}
        for where in (dev, "cpu"):
            model, adj, x, y = model_entry(kind, where)
            adj.value.requires_grad_()
            with torch.inference_mode():
                out = model(adj, x).cpu()
            loss = gcn_loss(model, adj, x, y)
            loss.backward()
            grads = [p.grad.cpu() for p in model.parameters()]
            if adj.value.grad is not None:
                grads.append(adj.value.grad.cpu())
            runs[str(where)] = (out, float(loss.detach()), grads)
        (oc, lc, gc), (oh, lh, gh) = runs[str(dev)], runs["cpu"]
        err = max(float((a - b).abs().max()) for a, b in zip([oc] + gc,
                                                             [oh] + gh))
        ok = (abs(lc - lh) <= 1e-5 and len(gc) == len(gh)
              and all(torch.allclose(a, b, **F32_TOL)
                      for a, b in zip([oc] + gc, [oh] + gh)))
        what = ("params; GAT reads no values" if kind == "gat"
                else "params + d value")
        print(f"phase 8b toy {kind}: forward, loss ({lc:.6f} vs {lh:.6f}) "
              f"and {len(gc)} grads ({what}) cuda vs cpu max_abs_err "
              f"{err:.3e} {'ok' if ok else 'FAIL'}", flush=True)
        check(ok, f"toy {kind} on the card disagrees with the CPU")


def time_model(name, card, model, adj, x, y, reps=3):
    """1 warm-up + ``reps`` forwards (inference mode) and train steps, each
    timed on the host clock around work that ends in a synchronize; the
    launch counts and peak memory of each, counts zeroed just before and
    read just after, and the K1 launches on strided views
    (``spmm_csr_cuda.strided``: GAT's heads)."""
    from paddle_sparse_tpu_torch import spmm_csr_cuda, train_step
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    res = {}
    for part in ("forward", "train_step"):
        _zero_launch_counts()
        strided = spmm_csr_cuda.strided
        times = []
        for _ in range(reps + 1):
            adj.value.grad = None
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if part == "forward":
                with torch.inference_mode():
                    out = model(adj, x)
            else:
                out = train_step(model, adj, x, y, LR)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        counts = _launch_counts()
        check(bool(torch.isfinite(out).all()),
              f"{name} {part}: output or loss not finite")
        res[part] = {"ms": sum(times[1:]) / reps, "times_ms": times,
                     "launches": counts, "runs": reps + 1,
                     "strided": spmm_csr_cuda.strided - strided,
                     "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        print(f"phase 8 {name} {part} ms: warm-up {times[0]:.3f}, timed "
              f"{' '.join(f'{t:.3f}' for t in times[1:])} (mean "
              f"{res[part]['ms']:.3f}); launches in {reps + 1}: "
              + ", ".join(f"{k} {v}" for k, v in counts.items())
              + f", of spmm_csr on strided views {res[part]['strided']}"
              + f"; peak mem {res[part]['peak_gb']:.2f} GB {card}",
              flush=True)
    return res


def check_launches(name, res, fwd_spmm, dx_spmm, dv, fused, folds_fwd,
                   folds_step, attention=0):
    """The forward runs ``fwd_spmm`` K1; a step adds ``dx_spmm`` K1 for
    d x alone, ``dv`` K2 for d value alone and ``fused`` fused CSC
    backwards for both; the fold as given; GAT's attention pass
    ``attention`` times in the forward and in the step alike; nothing
    else."""
    for part, want in (
            ("forward", {"spmm_csr": fwd_spmm, "fold_pieces": folds_fwd,
                         "gat_attention": attention}),
            ("train_step", {"spmm_csr": fwd_spmm + dx_spmm,
                            "sddmm_csr": dv, "spmm_sddmm_csc": fused,
                            "fold_pieces": folds_step,
                            "gat_attention": attention})):
        runs, got = res[part]["runs"], res[part]["launches"]
        want = {k: v * runs for k, v in want.items()}
        check(all(got[k] == want.get(k, 0) for k in got),
              f"{name} {part}: expected launches {want} in {runs} runs, "
              f"counted {got}")


def phase8c_sage(dev, card, gcn_fwd_ms, gcn_step_ms):
    """GraphSAGE 100 -> 256 -> 256 -> 47 (mean aggregator) on phase 4's
    graph at ogbn-products scale, ``adj.value`` requiring grad: times,
    peak memory, exact launches (K1 3 per forward and per step; K2 1 and
    the fused CSC backward 2 per step; no fold), sampled rows of each
    layer's mean and d value against f64; then GAT's attention pass alone
    on that graph at ``gat-products.eval``'s shapes
    (:func:`gat_attention_check`), and its heads' aggregation on strided
    views there (:func:`gat_heads_check`)."""
    from paddle_sparse_tpu_torch import gcn_loss, init_sage
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    adj, x = products_graph(dev)
    model = init_sage(torch.Generator().manual_seed(0), *GCN_DIMS,
                      num_layers=3, device=dev)
    y = torch.randint(0, GCN_DIMS[2], (PRODUCTS_NODES,),
                      generator=torch.Generator(device=dev).manual_seed(5),
                      device=dev)
    adj.value.requires_grad_()
    adj.structure()
    torch.cuda.synchronize()
    print(f"phase 8c graph: {PRODUCTS_NODES} nodes, {adj.nnz} nnz, "
          f"GraphSAGE (mean) {GCN_DIMS[0]}->{GCN_DIMS[1]}->{GCN_DIMS[1]}->"
          f"{GCN_DIMS[2]}; set-up with the CSC view "
          f"{time.perf_counter() - t0:.2f} s {card}", flush=True)
    res = time_model("8c GraphSAGE", card, model, adj, x, y)
    check_launches("GraphSAGE", res, 3, 0, 1, 2, 0, 0)
    print(f"phase 8c GraphSAGE vs GCN in this run: forward "
          f"{res['forward']['ms']:.3f} vs {gcn_fwd_ms:.3f} ms "
          f"({res['forward']['ms'] / gcn_fwd_ms:.3f}x), train step "
          f"{res['train_step']['ms']:.3f} vs {gcn_step_ms:.3f} ms "
          f"({res['train_step']['ms'] / gcn_step_ms:.3f}x) {card}",
          flush=True)
    model.zero_grad(set_to_none=True)
    adj.value.grad = None
    with SpmmCalls() as rec:
        gcn_loss(model, adj, x, y).backward()
    rows = sampled_rows(adj.rowptr())
    res["rows_max_abs_err"] = check_spmm_calls("8c GraphSAGE", rec.calls,
                                               rows)
    res["d_value_max_abs_err"] = check_d_value("8c GraphSAGE", adj,
                                               rec.calls, adj.value.grad)
    del rec, x, model
    adj.value.grad = None
    torch.cuda.empty_cache()
    # GAT's attention pass at gat-products.eval's shapes on this graph
    res["attention"] = {
        f"{H}x{D}": gat_attention_check("8c", card, adj, H, D)
        for H, D in GAT_PRODUCTS_SHAPES}
    del adj
    torch.cuda.empty_cache()
    return res


def gat_attention_check(phase, card, adj, H, D, reps=5):
    """GAT's attention pass (``gat_attention_cuda``: the node scores, then
    each row's edge softmax, split rows through their pieces) on ``adj`` at
    ``H`` heads of ``D``: against its plain version on the card
    (``gat_attention_reference``, f32 ``rtol=1e-5, atol=1e-6``), two
    launches bit for bit, its CUDA-event ms beside its bound (each byte
    once over 3.35 TB/s: ``hw``, the attention vectors, the row pointer and
    ``col`` read, the scores and the weights written), the node scores'
    and the edge pass's ms each alone, and the plain version's ms."""
    from paddle_sparse_tpu_torch import (gat_attention_cuda,
                                         gat_attention_reference)
    from paddle_sparse_tpu_torch.ops.kernels.gat_attention_cuda import (
        gat_scores_cuda, gat_softmax_cuda)
    N, E = adj.N, adj.capacity
    g = torch.Generator(device=adj.col.device).manual_seed(11)
    hw = torch.randn(N, H, D, generator=g, device=adj.col.device)
    a_src, a_dst = (torch.randn(H, D, generator=g, device=adj.col.device)
                    * (2 / D) ** 0.5 for _ in range(2))
    args = (adj.rowptr(), adj.col, hw, a_src, a_dst, 0.2, adj.row_split())
    ms, got = timed(lambda: gat_attention_cuda(*args), reps)
    again = gat_attention_cuda(*args)
    parts = {"scores": timed(lambda: gat_scores_cuda(hw, a_src, a_dst),
                               reps)[0],
               "edge_pass": timed(lambda: gat_softmax_cuda(
                   args[0], adj.col, got[1], got[2], 0.2, args[6]),
                   reps)[0]}
    with torch.no_grad():
        plain_ms, want = timed(lambda: gat_attention_reference(
            adj, hw, a_src, a_dst, 0.2), 2)
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    ok = all(torch.allclose(a, b, rtol=1e-5, atol=1e-6)
             for a, b in zip(got, want))
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    nbytes = 4 * (N * H * D + 2 * H * D + adj.M + 1 + E + 2 * N * H + E * H)
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"phase {phase} GAT attention H={H} D={D} ({N} nodes, {E} "
          f"entries, split rows: {adj.row_split() is not None}): "
          f"{ms:.3f} ms (alone: "
          + ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
          + f"), bound {bound:.3f} ms (bytes once), plain "
          f"{plain_ms:.3f} ms; vs plain max_abs_err {err:.3e} "
          f"{'ok' if ok else 'FAIL'}, two launches "
          f"{'equal' if same else 'DIFFER'} {card}", flush=True)
    check(ok and same, f"phase {phase}: the attention pass disagrees with "
                       f"its plain version or itself")
    heads = gat_heads_check(phase, card, adj, hw, got[0], reps)
    return {"ms": ms, "parts_ms": parts, "bound_ms": bound,
            "plain_ms": plain_ms, "max_abs_err": err, "heads": heads}


def gat_heads_check(phase, card, adj, hw, att, reps):
    """GAT's aggregation of ``hw`` (N, H, D) by the head-major weights
    ``att`` (E, H), as the model runs it (``adj.spmm(hw, value=att)``: one
    K1 a head on the views ``hw[:, k]`` and ``out[:, k]``, row stride
    H * D): sampled rows of each head against f64
    (:func:`check_spmm_calls`), exactly H ``spmm_csr`` launches, each on
    strided views where H > 1 (one head's are contiguous), and the call's
    CUDA-event ms."""
    from paddle_sparse_tpu_torch import spmm_csr_cuda
    H, D = hw.shape[1:]
    before = spmm_csr_cuda.launches, spmm_csr_cuda.strided
    with torch.no_grad(), SpmmCalls() as rec:
        adj.spmm(hw, value=att)
    counts = (spmm_csr_cuda.launches - before[0],
              spmm_csr_cuda.strided - before[1])
    err = check_spmm_calls(f"{phase} GAT heads {H}x{D} (row stride "
                           f"{H * D})", rec.calls, sampled_rows(adj.rowptr()))
    del rec
    with torch.no_grad():
        ms = timed(lambda: adj.spmm(hw, value=att), reps)[0]
    want = (H, H if H > 1 else 0)
    print(f"phase {phase} GAT heads {H}x{D}: spmm_csr launches {counts[0]}, "
          f"of them on strided views {counts[1]} (expected {want[0]} and "
          f"{want[1]}); {ms:.3f} ms a call {card}", flush=True)
    check(counts == want, f"phase {phase}: GAT's heads at {H}x{D} ran "
                          f"{counts} (spmm_csr, strided), not {want}")
    return {"ms": ms, "max_abs_err": err, "launches": counts}


def phase8d_models(dev, card):
    """GIN (100 -> 256 -> 256 -> 47), APPNP (100 -> 256 -> 47, k = 10,
    alpha = 0.1), both on the ``gcn_normalize``-d adjacency with its values
    requiring grad, and GAT (3 layers, 4 heads x 64, output 47) on the raw
    one, on the zipf graph at 1/8 scale (hub row of 10M edges: split rows
    under attention values): times, launches (the fold above 0), sampled
    rows against f64, GIN's and APPNP's d value, and GAT's d att of every
    head and layer."""
    from paddle_sparse_tpu_torch import (PaddedCOO, gcn_loss, gcn_normalize,
                                         init_appnp, init_gat, init_gin)
    row, col, val, x = bench_graph(dev, "zipf", 0.125, GCN_DIMS[0])
    n = x.shape[0]
    raw = PaddedCOO.from_arrays(row, col, val, (n, n))
    del row, col, val
    s = raw.structure()
    norm = gcn_normalize(raw)
    norm.value.requires_grad_()
    y = torch.randint(0, GCN_DIMS[2], (n,), generator=torch.Generator(
        device=dev).manual_seed(5), device=dev)
    deg = torch.diff(raw.rowptr())
    print(f"phase 8d zipf 1/8: {n} nodes, {raw.nnz} nnz, hub row of "
          f"{int(deg.max())} edges, {s.row_split.fold_row.numel()} rows "
          f"split into {s.row_split.num_slots} pieces; columns "
          f"{'unsplit' if s.col_split is None else 'split'} {card}",
          flush=True)
    col_fold = int(s.col_split is not None)
    gen = torch.Generator().manual_seed(0)
    # (forward K1, then per step: K1 for d x alone, K2 for d value alone,
    # the fused CSC backward for both; the attention pass a forward and a
    # step); GIN's first layer reads the features (no d x)
    specs = {
        "gin": (init_gin(gen, *GCN_DIMS, num_layers=3, device=dev), norm,
                (3, 0, 1, 2, 0)),
        "appnp": (init_appnp(gen, GCN_DIMS[0], GCN_DIMS[1], GCN_DIMS[2],
                             k=APPNP_K, alpha=APPNP_ALPHA, device=dev),
                  norm, (APPNP_K, 0, 0, APPNP_K, 0)),
        "gat": (init_gat(gen, GCN_DIMS[0], GAT_HIDDEN, GCN_DIMS[2],
                         heads=GAT_HEADS, num_layers=3, device=dev), raw,
                (2 * GAT_HEADS + 1, 0, 0, 2 * GAT_HEADS + 1, 3)),
    }
    out = {}
    for kind, (model, adj, (fwd, dx, dv, fused, att)) in specs.items():
        res = time_model(f"8d {kind}", card, model, adj, x, y)
        check_launches(kind, res, fwd, dx, dv, fused, fwd,
                       fwd + col_fold * (dx + fused), att)
        # GAT's hidden heads read and write strided views (its one output
        # head is contiguous); a step's backward runs on copies
        views = 2 * GAT_HEADS if kind == "gat" else 0
        check(all(res[p]["strided"] == views * res[p]["runs"]
                  for p in ("forward", "train_step")),
              f"{kind}: K1 on strided views "
              f"{[res[p]['strided'] for p in ('forward', 'train_step')]}, "
              f"expected {views} a forward and a step")
        if kind == "gat":
            # the model's hidden layers and its output layer (1 x 47)
            res["attention"] = {
                f"{H}x{D}": gat_attention_check("8d", card, adj, H, D)
                for H, D in ((GAT_HEADS, GAT_HIDDEN), (1, GCN_DIMS[2]))}
        check(res["train_step"]["launches"]["fold_pieces"] > 0,
              f"{kind}: the hub row did not run the split pieces")
        model.zero_grad(set_to_none=True)
        adj.value.grad = None
        with SpmmCalls() as rec:
            gcn_loss(model, adj, x, y).backward()
        rows = sampled_rows(adj.rowptr())
        res["rows_max_abs_err"] = check_spmm_calls(f"8d {kind}", rec.calls,
                                                   rows)
        if kind == "gat":
            res["d_value_max_abs_err"] = check_call_d_values(
                f"8d {kind}", rec.calls)
        else:
            res["d_value_max_abs_err"] = check_d_value(
                f"8d {kind}", adj, rec.calls, adj.value.grad)
        del rec
        out[kind] = res
    del raw, norm, x, specs
    torch.cuda.empty_cache()
    return out


# ---- phase 9: the eager SparseTensor facade ---------------------------------

FACADE_ROWS = 1024                      # sampled rows of each facade check


def _host_ms(fn):
    """``fn()`` on the host clock around work that ends in
    ``torch.cuda.synchronize()``: ``(ms, result)``."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, res


def _host_runs(fn, reps=3):
    """1 warm-up and ``reps`` calls of ``fn`` (:func:`_host_ms`): the mean
    ms of the timed calls, every call's ms, and the last result."""
    times = []
    for _ in range(reps + 1):
        ms, res = _host_ms(fn)
        times.append(ms)
    return sum(times[1:]) / reps, times, res


def facade_gcn_norm(row, col, n):
    """PyG's ``gcn_norm`` of ``adj_t`` on the facade, step by step, each on
    the host clock: ``SparseTensor(row, col)`` with no value, ``fill_diag``
    1, ``deg = sum(dim=1)``, ``deg ** -0.5`` with inf set to 0, ``mul`` by
    it row-wise, then column-wise. ``(adj_t, deg, normalized, {step: ms})``.
    """
    from paddle_sparse_tpu_torch import SparseTensor, fill_diag, mul
    from paddle_sparse_tpu_torch import sum as sparsesum

    def inv_sqrt(deg):
        dis = deg.pow(-0.5)
        return dis.masked_fill(torch.isinf(dis), 0.0)

    ms = {}
    ms["SparseTensor(row, col)"], adj = _host_ms(
        lambda: SparseTensor(row=row, col=col, sparse_sizes=(n, n)))
    ms["fill_diag"], loop = _host_ms(lambda: fill_diag(adj, 1.0))
    ms["sum(dim=1)"], deg = _host_ms(lambda: sparsesum(loop, dim=1))
    ms["pow(-0.5), inf to 0"], dis = _host_ms(lambda: inv_sqrt(deg))
    ms["mul rows"], half = _host_ms(lambda: mul(loop, dis.view(-1, 1)))
    ms["mul cols"], norm = _host_ms(lambda: mul(half, dis.view(1, -1)))
    return adj, deg, norm, ms


def _facade_fields(A):
    """The COO fields of a facade tensor (indices, then value if any)."""
    return [t for t in A.coo() if t is not None]


def phase9a_toy_facade(dev):
    """``facade_entry``'s toy graph (int64 indices, no value) through the
    calls of 9b-9d on the card and on the CPU: ``gcn_norm``, ``A @ x`` and
    its d value and d x, ``adj_t[idx]``, ``narrow``, ``t()``,
    ``masked_select`` and ``A @ A``. Indices equal, values within F32_TOL."""
    from paddle_sparse_tpu_torch import facade_entry, gcn_norm
    runs = {}
    for where in (dev, "cpu"):
        adj, x = facade_entry(where)
        norm = gcn_norm(adj)
        n = norm.size(0)
        w = torch.randn(x.shape, generator=torch.Generator().manual_seed(3)
                        ).to(x.device)
        with torch.inference_mode():
            out = norm @ x
        plain = norm.detach()
        norm.requires_grad_()
        xg = x.clone().requires_grad_()
        (norm @ xg).backward(w)
        res = {"gcn_norm": _facade_fields(plain), "out": [out],
               "grads": [norm.storage.value().grad, xg.grad]}
        idx = torch.arange(0, n, 8, device=x.device).flip(0)
        mask = torch.arange(n, device=x.device) % 2 == 0
        for name, B in (("adj_t[idx]", plain[idx]),
                        ("narrow", plain.narrow(1, n // 4, n // 2)),
                        ("t", plain.t()),
                        ("masked_select", plain.masked_select(0, mask)),
                        ("A @ A", plain @ plain)):
            res[name] = _facade_fields(B)
        runs[str(where)] = {k: [t.detach().cpu() for t in v]
                            for k, v in res.items()}
    card, host = runs[str(dev)], runs["cpu"]
    err = 0.0
    for name in card:
        for a, b in zip(card[name], host[name]):
            if a.is_floating_point():
                err = max(err, float((a - b).abs().max()))
                ok = torch.allclose(a, b, **F32_TOL)
            else:
                ok = torch.equal(a, b)
            check(ok and len(card[name]) == len(host[name]),
                  f"toy facade {name}: the card disagrees with the CPU")
    print(f"phase 9a toy facade (256 nodes, int64 indices): gcn_norm, A @ x "
          f"and its d value and d x, adj_t[idx], narrow, t, masked_select, "
          f"A @ A: cuda vs cpu indices equal, values max_abs_err {err:.3e} "
          f"ok", flush=True)


def facade_graph(dev):
    """Phase 4's graph (:func:`products_graph`, the same seed) as PyG
    hands it to a ``SparseTensor``: int64 ``row`` and ``col``, no value;
    and its features at K=100. Row ``r`` holds entries ``r * deg ...
    (r + 1) * deg - 1`` of the generator's arrays."""
    P, x = products_graph(dev)
    row, col = P.row.long(), P.col.long()
    del P
    return row, col, x


def check_gcn_norm(row, col, deg, norm, rows):
    """The normalized ``adj_t`` on ``rows`` against f64 on the host: the
    degree exact (each row's entries off the diagonal, plus the self loop),
    each sampled row's columns those of the raw row without its diagonal
    entries plus the diagonal, in order, and each value ``deg[r] ** -0.5 *
    deg[c] ** -0.5`` within rtol 1e-6. Returns the max relative error and
    the f64 entries of the sampled rows, ``(ptr, col, value)``."""
    import numpy as np
    n = deg.numel()
    self_loops = torch.bincount(row[row == col], minlength=n)
    deg_ref = (PRODUCTS_DEG + 1 - self_loops).cpu().numpy()
    check(np.array_equal(deg.cpu().numpy(), deg_ref.astype(np.float32)),
          "gcn_norm: sum(dim=1) of fill_diag(adj_t) is not the degree")
    dis = deg_ref.astype(np.float64) ** -0.5
    r_np = rows.cpu().numpy()
    raw = col.view(n, PRODUCTS_DEG)[rows].cpu().numpy()
    want_ptr, want_col = [0], []
    for r, cs in zip(r_np, raw):
        c = np.sort(np.append(cs[cs != r], r), kind="stable")
        want_col.append(c)
        want_ptr.append(want_ptr[-1] + c.size)
    want_col = np.concatenate(want_col)
    want_row = np.repeat(r_np, np.diff(want_ptr))
    want_val = dis[want_row] * dis[want_col]
    rowptr, ncol, nval = norm.csr()
    edge, sub_ptr = _sub_csr(rowptr, rows)
    got_val = nval[edge].detach().double().cpu().numpy()
    ok = (np.array_equal(sub_ptr.cpu().numpy(), want_ptr)
          and np.array_equal(ncol[edge].cpu().numpy(), want_col))
    rel = (float(np.abs(got_val / want_val - 1).max()) if ok
           else float("inf"))
    check(ok and rel <= 1e-6,
          f"gcn_norm: sampled rows disagree with f64 (rel err {rel:.3e})")
    return rel, (np.asarray(want_ptr), want_col, want_val)


def phase9b_gcn_norm(dev, card, row, col, x):
    """PyG's ``gcn_norm`` on a ``SparseTensor`` at ogbn-products scale, then
    ``adj_t @ x`` at K=100: each step's ms (1 warm-up + 3), peak memory, the
    values and ``out`` on sampled rows against f64, ``d value`` and ``d x``
    on sampled entries against f64, ``out`` against ``PaddedCOO.spmm`` on
    the same entries bit for bit (both timed, so the facade's overhead
    shows), exact launches (K1 1 per forward, the fused CSC backward 1 per
    backward, no fold) and no CSC view built after the first backward."""
    import numpy as np

    from paddle_sparse_tpu_torch import SparseStorage, gcn_norm
    n, K = PRODUCTS_NODES, x.shape[1]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    steps = []
    for _ in range(4):                                  # 1 warm-up + 3
        adj, deg, norm, ms = facade_gcn_norm(row, col, n)
        steps.append(ms)
    norm_gb = torch.cuda.max_memory_allocated() / 1e9
    step_ms = {k: sum(s[k] for s in steps[1:]) / 3 for k in steps[0]}
    total = sum(v for k, v in step_ms.items() if k != "SparseTensor(row, col)")
    print(f"phase 9b graph: {n} nodes, {adj.nnz()} nnz (int64 indices, no "
          f"value), {norm.nnz()} after fill_diag; gcn_norm steps ms (warm-up,"
          f" 3 timed, mean of the 3): "
          + "; ".join(f"{k} " + " ".join(f"{s[k]:.3f}" for s in steps)
                      + f" ({v:.3f})" for k, v in step_ms.items())
          + f"; gcn_norm after the constructor {total:.3f} ms; peak mem "
          f"{norm_gb:.2f} GB {card}", flush=True)
    entry_norm = gcn_norm(adj)
    check(all(torch.equal(a, b) for a, b in zip(_facade_fields(entry_norm),
                                                _facade_fields(norm))),
          "entry.gcn_norm differs from the steps it is made of")
    del adj, entry_norm

    rows = sampled_rows(norm.storage.rowptr(), FACADE_ROWS)
    rel, (w_ptr, w_col, w_val) = check_gcn_norm(row, col, deg, norm, rows)
    print(f"phase 9b gcn_norm on {rows.numel()} sampled rows vs f64 on the "
          f"host: degree exact, columns exact, values max rel err {rel:.3e} "
          f"(tol 1e-6) ok", flush=True)

    # the forward, in inference mode; then forward + backward
    P = norm.detach().to_padded()
    torch.cuda.reset_peak_memory_stats()
    _zero_launch_counts()
    with torch.inference_mode():
        fwd_ms, fwd_times, out = _host_runs(lambda: norm @ x)
    fwd_counts = _launch_counts()
    with torch.inference_mode():
        out_p = P.spmm(x)
    check(torch.equal(out, out_p), "facade A @ x differs from PaddedCOO.spmm "
                                   "on the same entries")
    xs = x[torch.as_tensor(w_col, device=x.device)].double().cpu().numpy()
    terms = w_val[:, None] * xs
    ref = np.add.reduceat(terms, w_ptr[:-1], axis=0)
    scale = np.add.reduceat(np.abs(terms), w_ptr[:-1], axis=0)
    err_out, ok = _grad_close(out[rows].cpu(), torch.from_numpy(ref),
                              torch.from_numpy(scale))
    check(ok, "facade A @ x disagrees with f64 on sampled rows")

    norm.requires_grad_()
    value = norm.storage.value()
    xg = x.clone().requires_grad_()
    g = torch.randn(x.shape, generator=torch.Generator(device=dev
                                                       ).manual_seed(9),
                    device=dev)
    csc_builds = []

    def fwd_bwd():
        value.grad = xg.grad = None
        SparseStorage.csc_builds = 0
        res = norm @ xg
        res.retain_grad()
        res.backward(g)
        csc_builds.append(SparseStorage.csc_builds)
        return res
    _zero_launch_counts()
    step_ms_fb, fb_times, out_g = _host_runs(fwd_bwd)
    fb_counts = _launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"phase 9b adj_t @ x (K={K}) forward ms: "
          f"{' '.join(f'{t:.3f}' for t in fwd_times)} (mean {fwd_ms:.3f}); "
          f"forward+backward ms: {' '.join(f'{t:.3f}' for t in fb_times)} "
          f"(mean {step_ms_fb:.3f}); peak mem {peak_gb:.2f} GB; launches in 4 "
          f"forwards {fwd_counts}, in 4 forward+backwards {fb_counts}; CSC "
          f"views built per forward+backward {csc_builds} {card}",
          flush=True)
    check(fwd_counts["spmm_csr"] == 4 and fwd_counts["sddmm_csr"] == 0
          and fwd_counts["fold_pieces"] == 0,
          f"facade forward: expected K1 1 per forward and nothing else, "
          f"counted {fwd_counts} in 4")
    check(fb_counts["spmm_csr"] == 4 and fb_counts["sddmm_csr"] == 0
          and fb_counts["spmm_sddmm_csc"] == 4
          and fb_counts["fold_pieces"] == 0 and fb_counts["segcompact"] == 0,
          f"facade forward+backward: expected K1 1 and the fused CSC "
          f"backward 1 each, counted {fb_counts} in 4")
    check(csc_builds == [1, 0, 0, 0],
          f"the CSC view was built again after the first backward: "
          f"{csc_builds}")

    # d value on sampled edges and d x on sampled columns against f64
    err_dv, ok_dv, dv_max = _d_value_err(
        P, [SpmmCall(P, P.value, xg, "sum", out_g)], value.grad)
    cols = torch.randperm(n, generator=torch.Generator().manual_seed(7)
                          )[:SAMPLED_COLS].to(dev)
    err_dx, ok_dx, dx_max, n_edges = _d_x_err(P.rowptr(), P.col,
                                              value.detach(), g, xg.grad,
                                              cols)
    print(f"phase 9b vs f64: out on {rows.numel()} sampled rows max_abs_err "
          f"{err_out:.3e}; d value on {SAMPLED_EDGES} sampled edges "
          f"{err_dv:.3e} (max |dv| {dv_max:.3e}); d x on {SAMPLED_COLS} "
          f"sampled columns ({n_edges} edges) {err_dx:.3e} (max |dx| "
          f"{dx_max:.3e}); within {GRAD_REL} of each sum of |terms| "
          f"{'ok' if ok_dv and ok_dx else 'FAIL'}", flush=True)
    check(ok_dv, "facade d value disagrees with f64 on sampled edges")
    check(ok_dx, "facade d x disagrees with f64 on sampled columns")

    # the same products through PaddedCOO.spmm on the same entries
    P.value.requires_grad_()
    with torch.inference_mode():
        pad_fwd_ms, _, _ = _host_runs(lambda: P.spmm(x))

    def pad_fwd_bwd():
        P.value.grad = xg.grad = None
        P.spmm(xg).backward(g)
    pad_fb_ms, _, _ = _host_runs(pad_fwd_bwd)
    print(f"phase 9b the same entries through PaddedCOO.spmm: forward "
          f"{pad_fwd_ms:.3f} ms, forward+backward {pad_fb_ms:.3f} ms; the "
          f"facade {fwd_ms:.3f} / {step_ms_fb:.3f} ms ({fwd_ms / pad_fwd_ms:.3f}x"
          f" / {step_ms_fb / pad_fb_ms:.3f}x) {card}", flush=True)
    del P, out, out_p, out_g, xg, g
    torch.cuda.empty_cache()
    return norm.detach(), {
        "gcn_norm_steps_ms": step_ms, "gcn_norm_ms": total,
        "gcn_norm_peak_gb": norm_gb, "forward_ms": fwd_ms,
        "fwd_bwd_ms": step_ms_fb, "padded_forward_ms": pad_fwd_ms,
        "padded_fwd_bwd_ms": pad_fb_ms, "peak_gb": peak_gb,
        "values_max_rel_err": rel, "out_max_abs_err": err_out,
        "d_value_max_abs_err": err_dv, "d_x_max_abs_err": err_dx,
        "launches": {"facade_forward": fwd_counts,
                     "facade_fwd_bwd": fb_counts}}


def _same_rows(B, rows, want):
    """Rows ``rows`` of the facade's ``B`` equal ``want`` (scipy CSR of
    those rows, in order), entry for entry: lengths, columns and values,
    duplicates and their order included. Returns the entry count."""
    import numpy as np
    rowptr, col, value = B.csr()
    edge, sub_ptr = _sub_csr(rowptr, rows)
    ok = (np.array_equal(sub_ptr.cpu().numpy(), want.indptr)
          and np.array_equal(col[edge].cpu().numpy(), want.indices)
          and np.array_equal(value[edge].cpu().numpy(), want.data))
    return ok, edge.numel()


def phase9c_structural(dev, card, adj):
    """``adj_t[idx]`` with 1/8 of the rows in random order, ``narrow`` of
    the middle half of the columns, ``t()`` and ``masked_select`` of a
    random half of the rows on the normalized ``adj_t``: each timed (1
    warm-up + 3), sampled rows of each result equal to scipy's same op on
    a host copy."""
    import numpy as np
    import scipy.sparse as sp
    n = adj.size(0)
    gen = torch.Generator(device=dev).manual_seed(8)
    idx = torch.randperm(n, generator=gen, device=dev)[:n // 8]
    mask = torch.rand(n, generator=gen, device=dev) < 0.5
    lo, length = n // 4, n // 2
    ops = {"adj_t[idx] (1/8 of the rows)": lambda: adj[idx],
           "narrow(1, N/4, N/2)": lambda: adj.narrow(1, lo, length),
           "t()": lambda: adj.t(),
           "masked_select(0, half the rows)":
               lambda: adj.masked_select(0, mask)}
    rowptr, col, value = adj.csr()
    a = sp.csr_matrix((value.cpu().numpy(), col.cpu().numpy(),
                       rowptr.cpu().numpy()), shape=(n, n))
    idx_np, kept = idx.cpu().numpy(), np.flatnonzero(mask.cpu().numpy())
    res = {}
    for name, fn in ops.items():
        ms, _, B = _host_runs(fn)
        rows = sampled_rows(B.storage.rowptr(), FACADE_ROWS)
        r = rows.cpu().numpy()
        if name.startswith("adj_t[idx]"):
            want = a[idx_np[r]]
        elif name.startswith("narrow"):
            want = a[r][:, lo:lo + length]
        elif name == "t()":
            want = a.T.tocsr()[r]
        else:
            want = a[kept[r]]
        ok, n_cmp = _same_rows(B, rows, want)
        print(f"phase 9c {name}: {ms:.3f} ms (mean of 3 after a warm-up), "
              f"{B.nnz()} nnz {B.sparse_sizes()}; {rows.numel()} sampled rows "
              f"({n_cmp} entries) equal to scipy's "
              f"{'ok' if ok else 'FAIL'} {card}", flush=True)
        check(ok, f"facade {name} disagrees with scipy on sampled rows")
        res[name] = ms
        del B
    del a
    return res


def phase9d_a_at_a(dev, card):
    """``A @ A`` through the facade on phase 6c's 10M-nnz operand
    (``spgemm_operand``), handed over as int64 COO: 1 warm-up + 3 calls,
    K5 once per call and nothing else, C equal to ``spspmm_eager`` on the
    same arrays bit for bit, sampled rows against scipy in f64."""
    from paddle_sparse_tpu_torch import SparseTensor, spspmm_eager
    P = spgemm_operand(dev, 625_000, 16)
    k = P.nnz
    A = SparseTensor(row=P.row[:k].long(), col=P.col[:k].long(),
                     value=P.value[:k], sparse_sizes=P.shape)
    del P
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero_launch_counts()
    ms, times, C = _host_runs(lambda: A @ A)
    counts = _launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    row, col, value = A.coo()
    rowptr = A.storage.rowptr()
    eager_ms, _, ref = _host_runs(lambda: spspmm_eager(
        row, col, value, rowptr, col, value, *A.sparse_sizes()))
    same = all(torch.equal(a, b) for a, b in zip(C.coo(), ref))
    Ap, Cp = A.to_padded(), C.to_padded()
    rows = _sampled_rows(Ap)
    err, ok, n_cmp = _check_sampled_rows(Ap, Cp, rows)
    print(f"phase 9d A @ A through the facade: A {A.nnz()} nnz "
          f"{A.sparse_sizes()} (int64), C {C.nnz()} nnz; ms per call "
          f"{' '.join(f'{t:.3f}' for t in times)} (mean {ms:.3f}; "
          f"spspmm_eager on the same arrays {eager_ms:.3f}); peak mem "
          f"{peak_gb:.2f} GB; launches in 4 calls {counts}; C equal to "
          f"spspmm_eager bit for bit {same}; {rows.numel()} sampled rows "
          f"({n_cmp} entries) vs scipy f64 max_abs_err {err:.3e} "
          f"{'ok' if ok else 'FAIL'} {card}", flush=True)
    check(counts["segcompact"] == 4 and counts["spmm_csr"] == 0
          and counts["sddmm_csr"] == 0,
          f"facade A @ A: expected K5 once per call, counted {counts}")
    check(same, "facade A @ A differs from spspmm_eager on the same arrays")
    check(ok, "facade A @ A disagrees with scipy on sampled rows")
    del A, C, Ap, Cp, ref
    torch.cuda.empty_cache()
    return {"ms": ms, "spspmm_eager_ms": eager_ms, "peak_gb": peak_gb,
            "rows_max_abs_err": err, "launches": counts}


# ---- phase 10: sampling, walks, partitioning, the plan-holding SpMMs ------

SAMPLE_SEEDS = 1024                     # PyG ogbn_products_sage.py's batch
SAMPLE_SIZES = (15, 10, 5)              # its NeighborSampler fanouts
PADDED_FANOUT = 15
WALK_LENGTH = 20
SAINT_ROOTS, SAINT_WALK = 20_000, 3     # OGB products graph_saint.py
CLUSTER_PARTS = 15_000                  # OGB products cluster_gcn.py
SELL_GRID_G = 32                        # 10d grid block: 14 pads per row
ENTRY_K = 256


def _steps_are_edges(rowptr, col, walks):
    """Every step ``(u, v)`` of ``walks`` is an entry of the (host) CSR, or
    a repeat of a node of degree 0."""
    import numpy as np
    for w in walks:
        for u, v in zip(w[:-1], w[1:]):
            nbrs = col[rowptr[u]:rowptr[u + 1]]
            if not (np.isin(v, nbrs) or (nbrs.size == 0 and v == u)):
                return False
    return True


def phase10a_toy(dev):
    """``sample_entry`` on the card against the CPU: the host sampler with
    one seed, ``saint_subgraph``, ``partition`` and RCM equal; the device
    samplers and walks equal when fed the same uniforms; the public
    ``sample`` and ``random_walk`` (each device's own generator) pass the
    structural checks. Then ``spmm_seg``, ``spmm_sell`` and ``spmm_chunked``
    forward and grads card vs CPU, and ``backend="sell"`` of
    ``PaddedCOO.spmm`` equal to ``"auto"`` bit for bit on the card."""
    import numpy as np
    import paddle_sparse_tpu_torch as p
    from paddle_sparse_tpu_torch.ops import sample as ops_sample
    runs = {}
    for where in (dev, "cpu"):
        adj, seeds = p.sample_entry(where)
        p.seed(3)
        sub, n_id = p.sample_adj(adj, seeds, 5)
        sg, e_id = p.saint_subgraph(adj, seeds)
        out, partptr, perm = p.partition(adj, 8)
        rcm = p.reverse_cuthill_mckee(adj)
        rowptr, col, _ = adj.csr()
        g = torch.Generator().manual_seed(5)
        u_rep = torch.rand(16, 4, generator=g).to(where)
        prio = torch.rand(int((rowptr[seeds + 1] - rowptr[seeds]).sum()),
                          generator=g).to(where)
        u_walk = torch.rand(6, 16, generator=g).to(where)
        u_nb = torch.rand(16, 4, generator=g).to(where)
        padded = [ops_sample._sample_adj_padded(rowptr, col, seeds, 4, r, u)
                  for r, u in ((True, u_rep), (False, prio))]
        exact = [*sub.coo(), n_id, *sg.coo(), e_id, *out.coo(), partptr,
                 perm, rcm, ops_sample._random_walk(rowptr, col, seeds,
                                                    u_walk),
                 ops_sample._sample_neighbors(rowptr, col, u_nb, seeds),
                 *[f for pa in padded for f in pa]]
        walks = p.random_walk(adj, seeds, 4)
        drawn = p.sample(adj, 3, seeds)
        check(walks.device == out.device() == drawn.device,
              "toy sampling: a result left the tensor's device")
        runs[str(where)] = ([t.cpu() for t in exact], walks.cpu().numpy(),
                            drawn.cpu().numpy(), seeds.cpu().numpy(),
                            rowptr.cpu().numpy(), col.cpu().numpy())
    card, host = runs[str(dev)], runs["cpu"]
    same = all(torch.equal(a, b) for a, b in zip(card[0], host[0]))
    _, walks, drawn, seeds, rowptr, col = card
    ok_walk = _steps_are_edges(rowptr, col, walks)
    ok_draw = all(np.isin(d, col[rowptr[s]:rowptr[s + 1]]).all()
                  for s, d in zip(seeds, drawn))
    print(f"phase 10a toy sampling (256 nodes, 16 seeds): sample_adj (host "
          f"runtime, one seed), saint_subgraph, partition, RCM, and "
          f"sample_adj_padded / random_walk / sample_neighbors fed the same "
          f"uniforms: {len(card[0])} arrays cuda vs cpu equal {same}; "
          f"random_walk and sample on the card's generator: every step an "
          f"edge {ok_walk}, every draw a neighbour {ok_draw}", flush=True)
    check(same, "toy sampling: the card disagrees with the CPU")
    check(ok_walk and ok_draw, "toy sampling: a walk step or draw on the "
                               "card is not an edge")
    toy_spmm(dev, "10a", {"seg": p.spmm_seg, "sell": p.spmm_sell,
                          "chunked": p.spmm_chunked})
    adj = p.entry(dev)[1]
    x = torch.randn(256, 32, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(4))
    same = torch.equal(adj.spmm(x, backend="sell"), adj.spmm(x))
    print(f"phase 10a toy PaddedCOO.spmm(backend='sell') equal to 'auto' bit "
          f"for bit {same}", flush=True)
    check(same, "backend='sell' differs from 'auto' on the card")


def sampling_graph(dev):
    """Phase 4's graph (:func:`products_graph`, the same seed) as PyG's
    ``NeighborSampler`` holds it: ``SparseTensor(row, col, value=arange(E))``
    with int64 indices, so sampled values are edge ids; and the generator's
    row, col (int64), U(0,1) values and features (K=100), in its order."""
    from paddle_sparse_tpu_torch import SparseTensor
    P, x = products_graph(dev)
    n, nnz = P.shape[0], P.nnz
    row, col, val = P.row.long(), P.col.long(), P.value
    del P
    adj = SparseTensor(row=row, col=col,
                       value=torch.arange(nnz, device=dev),
                       sparse_sizes=(n, n))
    return adj, row, col, val, x


def _check_hop(sub, n_id, subset, F, row, col, deg, nnz):
    """A hop of ``sample_adj`` on the edge-id tracker: each seed row holds
    ``min(deg, F)`` distinct edges of its seed (``row[e]``), each column is
    the local id of ``col[e]``, and ``n_id`` starts with the seeds and is
    unique."""
    S = subset.numel()
    ptr = sub.storage.rowptr()
    cnt = ptr[1:] - ptr[:-1]
    e = sub.storage.value()
    seed_of = torch.repeat_interleave(torch.arange(S, device=e.device), cnt)
    key = seed_of * nnz + e
    return {"counts": torch.equal(cnt, deg[subset].clamp(max=F)),
            "rows": torch.equal(row[e], subset[seed_of]),
            "cols": torch.equal(col[e], n_id[sub.storage.col()]),
            "distinct": key.unique().numel() == key.numel(),
            "n_id": (torch.equal(n_id[:S], subset)
                     and n_id.unique().numel() == n_id.numel())}


def phase10b_minibatch(dev, card, adj, row, col, val, x):
    """PyG's ogbn-products GraphSAGE NeighborSampler: 1,024 random seeds,
    fanouts 15, 10, 5 hop by hop through ``sample_adj`` (the host runtime;
    each hop's subset is the previous hop's ``n_id``): per hop the first
    call (hop 1's builds the host CSR) and 3 warm calls, node and edge
    counts, the structural checks, and ``adj_h @ x[n_id_h]`` at K=100 on K1
    (exact launches, sampled rows against f64). Then
    ``ops.sample.sample_adj_padded`` (F = 15, without and with replacement)
    and ``sample_neighbors`` for the same seeds on the card."""
    import numpy as np
    from paddle_sparse_tpu_torch import (runtime, sample_adj,
                                         spmm_csr_reference)
    from paddle_sparse_tpu_torch.ops.sample import (SENTINEL,
                                                    sample_adj_padded,
                                                    sample_neighbors)
    n, nnz = adj.size(0), adj.nnz()
    rowptr = adj.storage.rowptr()
    deg = rowptr[1:] - rowptr[:-1]
    gen = torch.Generator(device=dev).manual_seed(10)
    seeds = torch.randperm(n, generator=gen, device=dev)[:SAMPLE_SEEDS]
    subset, res = seeds, {"hops": []}
    for hop, F in enumerate(SAMPLE_SIZES, 1):
        times = []
        for _ in range(4):
            ms, (sub, n_id) = _host_ms(lambda: sample_adj(adj, subset, F))
            times.append(ms)
        ok = _check_hop(sub, n_id, subset, F, row, col, deg, nnz)
        # the host runtime's call alone, on the cached host CSR
        rp_h, col_h = adj.storage.host_csr()
        sub_h = subset.cpu().numpy()
        native = []
        for _ in range(3):
            t0 = time.perf_counter()
            runtime.sample_adj(rp_h, col_h, sub_h, F, False, 7)
            native.append((time.perf_counter() - t0) * 1e3)
        # the hop's propagation as SAGEConv runs it, on K1
        sub_v = sub.set_value(val[sub.storage.value()], layout="coo")
        xs = x[n_id]
        _zero_launch_counts()
        with torch.inference_mode():
            out = sub_v @ xs
        counts = _launch_counts()
        torch.cuda.synchronize()
        srp, scol, sval = sub_v.csr()
        rows = sampled_rows(srp, FACADE_ROWS)
        edge, sub_ptr = _sub_csr(srp, rows)
        terms_v = sval[edge].double()
        ref = spmm_csr_reference(sub_ptr, scol[edge], terms_v,
                                 xs.double())
        scale = spmm_csr_reference(sub_ptr, scol[edge], terms_v.abs(),
                                   xs.double().abs())
        err, ok_out = _grad_close(out[rows], ref, scale)
        print(f"phase 10b hop {hop} (fanout {F}): {subset.numel()} seeds -> "
              f"{sub.nnz()} edges, {n_id.numel()} nodes; sample_adj ms first "
              f"{times[0]:.3f}, warm {' '.join(f'{t:.3f}' for t in times[1:])}"
              f" (the host runtime's call alone "
              f"{' '.join(f'{t:.3f}' for t in native)}); checks {ok}; "
              f"adj_h @ x[n_id_h] (K={x.shape[1]}) launches "
              f"{counts}, {rows.numel()} sampled rows vs f64 max_abs_err "
              f"{err:.3e} {'ok' if ok_out else 'FAIL'} {card}", flush=True)
        check(all(ok.values()), f"hop {hop}: sampled subgraph fails {ok}")
        check(ok_out, f"hop {hop}: adj_h @ x disagrees with f64")
        check(counts["spmm_csr"] == 1 and sum(counts.values()) == 1,
              f"hop {hop}: expected one K1 launch, counted {counts}")
        res["hops"].append({"fanout": F, "seeds": subset.numel(),
                            "edges": sub.nnz(), "nodes": n_id.numel(),
                            "first_ms": times[0],
                            "warm_ms": sum(times[1:]) / 3,
                            "native_ms": sum(native) / 3,
                            "rows_max_abs_err": err, "launches": counts})
        subset = n_id
        del sub, sub_v, xs, out

    rowptr_c, col_c, _ = adj.csr()
    S = seeds.numel()
    for replace in (False, True):
        g = torch.Generator(device=dev).manual_seed(11)
        ms, times, out = _host_runs(lambda: sample_adj_padded(
            rowptr_c, col_c, seeds, PADDED_FANOUT, replace, g))
        cnt = out.rowptr[1:] - out.rowptr[:-1]
        valid = out.edge_mask
        e, loc = out.e_id[valid], out.col[valid]
        seed_of = torch.repeat_interleave(torch.arange(S, device=dev), cnt)
        s_rows = seeds[seed_of]
        key = seed_of * nnz + e
        k = int(out.num_nodes)
        want = (torch.where(deg[seeds] > 0, PADDED_FANOUT, 0) if replace
                else deg[seeds].clamp(max=PADDED_FANOUT))
        ok = {"counts": torch.equal(cnt, want),
              "rows": bool(((e >= rowptr_c[s_rows])
                            & (e < rowptr_c[s_rows + 1])).all()),
              "cols": torch.equal(col_c[e], out.n_id[loc]),
              "distinct": replace or key.unique().numel() == key.numel(),
              "n_id": (torch.equal(out.n_id[:S], seeds)
                       and out.n_id[:k].unique().numel() == k
                       and bool((out.n_id[k:] == SENTINEL).all()))}
        mode = "replace" if replace else "distinct"
        print(f"phase 10b sample_adj_padded (F={PADDED_FANOUT}, {mode}): "
              f"{int(out.num_edges)} edges, {k} nodes; ms "
              f"{' '.join(f'{t:.3f}' for t in times)} (mean {ms:.3f}); "
              f"checks {ok} {card}", flush=True)
        check(all(ok.values()), f"sample_adj_padded {mode} fails {ok}")
        res[f"padded_{mode}_ms"] = ms
    g = torch.Generator(device=dev).manual_seed(12)
    ms, times, drawn = _host_runs(lambda: sample_neighbors(
        rowptr_c, col_c, g, PADDED_FANOUT, seeds))
    rp_h, col_h = adj.storage.host_csr()
    ok = all(np.isin(d, col_h[rp_h[s]:rp_h[s + 1]]).all()
             for s, d in zip(seeds.cpu().numpy(), drawn.cpu().numpy()))
    print(f"phase 10b sample_neighbors (F={PADDED_FANOUT}): ms "
          f"{' '.join(f'{t:.3f}' for t in times)} (mean {ms:.3f}); every "
          f"draw a neighbour of its seed {ok} {card}", flush=True)
    check(ok, "sample_neighbors drew a non-neighbour")
    res["neighbors_ms"] = ms
    return res


def phase10c_walks(dev, card, adj_f):
    """``random_walk`` from every node (length 20): ms, walks per second,
    every step an edge (a sorted (row, col) key searched on the card). Then
    OGB's products GraphSAINT random-walk sampler: 20,000 roots, walks of
    length 3, their unique nodes into ``saint_subgraph``: ms, and sampled
    rows against scipy."""
    import numpy as np
    import scipy.sparse as sp
    from paddle_sparse_tpu_torch import random_walk, saint_subgraph
    n = adj_f.size(0)
    starts = torch.arange(n, device=dev)
    gen = torch.Generator(device=dev).manual_seed(13)
    ms, times, walks = _host_runs(
        lambda: random_walk(adj_f, starts, WALK_LENGTH, gen))
    rowptr = adj_f.storage.rowptr()
    deg = rowptr[1:] - rowptr[:-1]
    key = adj_f.storage.row() * n + adj_f.storage.col()
    bad = 0
    for t in range(WALK_LENGTH):
        u, v = walks[:, t], walks[:, t + 1]
        q = u * n + v
        pos = torch.searchsorted(key, q).clamp(max=key.numel() - 1)
        bad += int((~((key[pos] == q) | ((deg[u] == 0) & (v == u)))).sum())
    del key
    ok = bad == 0 and torch.equal(walks[:, 0], starts)
    print(f"phase 10c random_walk from all {n} nodes, length {WALK_LENGTH}: "
          f"ms {' '.join(f'{t:.3f}' for t in times)} (mean {ms:.3f}, "
          f"{n / ms * 1e3:.4g} walks/s, {n * WALK_LENGTH / ms * 1e3:.4g} "
          f"steps/s); steps not an edge: {bad} {card}", flush=True)
    check(ok, f"random_walk: {bad} steps are not edges")
    res = {"walk_ms": ms, "walks_per_s": n / ms * 1e3}

    def saint_step():
        roots = torch.randint(0, n, (SAINT_ROOTS,), generator=gen,
                              device=dev)
        node_idx = random_walk(adj_f, roots, SAINT_WALK, gen).flatten() \
            .unique()
        return (node_idx, *saint_subgraph(adj_f, node_idx))
    ms, times, (node_idx, sub, e_id) = _host_runs(saint_step)
    rp, col, val = adj_f.csr()
    a = sp.csr_matrix((val.cpu().numpy(), col.cpu().numpy(),
                       rp.cpu().numpy()), shape=(n, n))
    nid = node_idx.cpu().numpy()
    srp, scol, sval = sub.csr()
    rows = sampled_rows(srp, FACADE_ROWS)
    r = rows.cpu().numpy()
    want = a[nid[r]]
    wr = np.repeat(np.arange(r.size), np.diff(want.indptr))
    keep = np.isin(want.indices, nid)
    w_ptr = np.concatenate([[0], np.cumsum(np.bincount(wr[keep],
                                                       minlength=r.size))])
    edge, sub_ptr = _sub_csr(srp, rows)
    ok = (np.array_equal(sub_ptr.cpu().numpy(), w_ptr)
          and np.array_equal(scol[edge].cpu().numpy(),
                             np.searchsorted(nid, want.indices[keep]))
          and np.array_equal(sval[edge].cpu().numpy(), want.data[keep])
          and torch.equal(sval, val[e_id.long()]))
    print(f"phase 10c GraphSAINT random-walk sampler ({SAINT_ROOTS} roots, "
          f"walk length {SAINT_WALK}): {nid.size} nodes, {sub.nnz()} edges; "
          f"ms (walks + unique + saint_subgraph) "
          f"{' '.join(f'{t:.3f}' for t in times)} (mean {ms:.3f}); "
          f"{r.size} sampled rows ({edge.numel()} entries) equal to scipy's "
          f"{ok} {card}", flush=True)
    check(ok, "saint_subgraph disagrees with scipy on sampled rows")
    res["saint_ms"] = ms
    del a, sub, walks
    return res


def phase10c_rcm(dev, card, adj_f):
    """``reverse_cuthill_mckee`` (``to_symmetric`` on the card, the host
    runtime's RCM): seconds, a valid permutation, bandwidth before and
    after."""
    from paddle_sparse_tpu_torch import reverse_cuthill_mckee
    n = adj_f.size(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    perm = reverse_cuthill_mckee(adj_f)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    valid = torch.equal(perm.sort().values, torch.arange(n, device=dev))
    before, after = adj_f.bandwidth(), adj_f.permute(perm).bandwidth()
    print(f"phase 10c reverse_cuthill_mckee: {secs:.3f} s (symmetrize on the "
          f"card, host copy, host runtime); valid permutation {valid}; "
          f"bandwidth {before} -> {after} {card}", flush=True)
    check(valid, "RCM did not return a permutation")
    torch.cuda.empty_cache()
    return {"rcm_s": secs, "bandwidth": [before, after]}


def partition_in_thread(adj_f):
    """``partition(adj_f, 15000)``, the entry point, in a thread, so that its
    host clustering (the C++ runtime, from the cached host CSR) runs beside
    phase 10d's card work: ctypes lets go of the interpreter lock during
    the call. Started after every timed host section of phase 10. Returns
    the thread and the dict it fills with ``partition``'s return, its
    seconds and the clock when it returned, or the exception."""
    import importlib
    import threading
    part_mod = importlib.import_module("paddle_sparse_tpu_torch.partition")
    adj_f.storage.host_csr()            # the one device read, here
    box = {}

    def run():
        try:
            t0 = time.perf_counter()
            box["result"] = part_mod.partition(adj_f, CLUSTER_PARTS)
            torch.cuda.synchronize()
            box["done"] = time.perf_counter()
            box["s"] = box["done"] - t0
        except BaseException as e:      # re-raised by the main thread
            box["error"] = e
    th = threading.Thread(target=run, name="partition")
    th.start()
    return th, box


def phase10c_partition(dev, card, adj_f, th, box, after_s):
    """OGB's products ClusterGCN setting, 15,000 parts, from the thread's
    ``partition`` call: ``partptr`` on the card, non-decreasing and summing
    to N; ``perm`` a permutation on the card; ``out`` equal to
    ``adj_f.permute(perm)``; the edge cut of the parts (cluster ids read
    from ``partptr``/``perm``) beside a random partition's. ``after_s`` is
    the clock when phase 10d's last timed call ended: ``partition`` must
    return after it, so that its card work overlapped no timing."""
    import importlib
    part_mod = importlib.import_module("paddle_sparse_tpu_torch.partition")
    th.join()
    if "error" in box:
        raise box["error"]
    out, partptr, perm = box["result"]
    n = adj_f.size(0)
    idx = adj_f.storage.col()
    sizes = partptr[1:] - partptr[:-1]
    cluster = torch.empty(n, dtype=torch.long, device=dev)
    cluster[perm.long()] = torch.repeat_interleave(
        torch.arange(CLUSTER_PARTS, device=dev), sizes.long())
    want = adj_f.permute(perm)
    ok = {"on_card": all(a.device == idx.device and a.dtype == idx.dtype
                         for a in (partptr, perm)),
          "partptr": (partptr.numel() == CLUSTER_PARTS + 1
                      and int(partptr[0]) == 0 and int(partptr[-1]) == n
                      and bool((sizes >= 0).all())),
          "perm": torch.equal(perm.sort().values,
                              torch.arange(n, device=dev, dtype=perm.dtype)),
          "out": (out.sparse_sizes() == adj_f.sparse_sizes()
                  and all(torch.equal(a, b) for a, b in zip(
                      (out.storage.row(), out.storage.col(),
                       out.storage.value()),
                      (want.storage.row(), want.storage.col(),
                       want.storage.value())))),
          "after_10d": box["done"] > after_s}
    del want
    cut = part_mod.edge_cut_fraction(adj_f, cluster)
    rnd = part_mod.random_cut_fraction(cluster)
    print(f"phase 10c partition ({CLUSTER_PARTS} parts): partition() "
          f"{box['s']:.3f} s (host clustering + argsort + permute on the "
          f"card, in a thread beside phase 10d, returned "
          f"{box['done'] - after_s:.3f} s after 10d's last timed call); part "
          f"sizes {int(sizes.min())}..{int(sizes.max())}; checks {ok}; edge "
          f"cut {cut:.4f} vs random {rnd:.4f} {card}", flush=True)
    check(all(ok.values()), f"partition: checks {ok}")
    return {"partition_s": box["s"], "edge_cut": cut, "random_cut": rnd}


def _nonzero(counts):
    return {k: v for k, v in counts.items() if v}


def _entry_block(fn, leaf, x, gw, reps=3):
    """1 warm-up + ``reps`` forwards (inference mode) and forward+backwards
    of ``fn(leaf, x)``: every ms, the launches of the forwards and of the
    forward+backwards (each zeroed just before), peak memory, the last
    output and the grads of the leaf and ``x``."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero_launch_counts()
    fwd, fb = [], []
    with torch.inference_mode():
        for _ in range(reps + 1):
            fwd.append(_host_ms(lambda: fn(leaf, x))[0])
    counts_fwd = _launch_counts()
    _zero_launch_counts()
    v, xx = leaf.detach().requires_grad_(), x.detach().requires_grad_()

    def step():
        v.grad = xx.grad = None
        o = fn(v, xx)
        o.backward(gw)
        return o
    for _ in range(reps + 1):
        ms, out = _host_ms(step)
        fb.append(ms)
    return {"fwd": fwd, "fwd_bwd": fb, "counts_fwd": counts_fwd,
            "counts": _launch_counts(),
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "out": out.detach(), "d_leaf": v.grad, "d_x": xx.grad}


def phase10d_entry_points(dev, card):
    """Phase 4's graph at K=256, f32: ``spmm_chunked`` (its plan),
    ``spmm_seg``, ``backend="sell"`` (``spmm_coo``, its plan cached on the
    first call, COO values) and ``spmm_sell`` with the ``(G, ng)`` value
    grid as the leaf (``d value`` back in the grid, 0 at every pad slot),
    each in turns with ``spmm_csr`` on the same graph (csr, path, path,
    csr): plan seconds, forward and forward+backward ms, peak memory, exact
    launches, sampled rows, ``d value`` and ``d x`` against f64 (as phase
    7c checks them). Returns the stats and the clock after the last timed
    call."""
    import paddle_sparse_tpu_torch as p
    from paddle_sparse_tpu_torch.ops import spmm as spmm_mod
    from paddle_sparse_tpu_torch.ops import spmm_seg as seg_mod
    from paddle_sparse_tpu_torch.ops import spmm_sell as sell_mod
    P, _ = products_graph(dev)
    n = P.shape[0]
    row, col, val = P.row, P.col, P.value
    rowptr = P.rowptr()
    del P
    g = torch.Generator(device=dev).manual_seed(14)
    x = torch.randn(n, ENTRY_K, generator=g, device=dev)
    gw = torch.randn(n, ENTRY_K, generator=g, device=dev)

    def csr_fn(v, xx):
        return p.spmm_csr(rowptr, col, v, xx)

    def plan_chunked():
        plan, s = p.make_spmm_plan(row, col, n, n, ENTRY_K)
        return (lambda v, xx: p.spmm_chunked(plan, s, v, xx)), val, None

    def plan_seg():
        plan, s = seg_mod.make_seg_plan(row, col, n, n, feat_dim=ENTRY_K)
        desc = (f"CR={plan.rows_per_block} S={plan.num_segments} "
                f"S_t={plan.num_segments_t}")
        return ((lambda v, xx: seg_mod.spmm_seg(plan, s, v, xx)),
                seg_mod.pack_values(s, val),
                (lambda d: seg_mod.unpack_values(s, d), desc, None))

    def grid_desc(plan, s):
        pads = (s.eid < 0).reshape(-1, plan.group).T    # the grid's layout
        return pads, (f"G={plan.group}, grid {tuple(pads.shape)}, "
                      f"{int(pads.sum())} pad slots")

    def plan_sell():
        plan, s = spmm_mod._cached_sell_plan(row, col, n, n, ENTRY_K)
        return ((lambda v, xx: p.spmm_coo(row, col, v, xx, n,
                                          backend="sell")), val,
                (None, grid_desc(plan, s)[1], None))

    def plan_sell_grid():
        # G=32, the smallest group JAX's pick weighs: "auto" picks G=50 on
        # this degree-50 graph and leaves no pad slot to check
        plan, s = sell_mod.make_sell_plan(row, col, n, n, group=SELL_GRID_G)
        grid = sell_mod.pad_values(s, val, group=plan.group)
        pads, desc = grid_desc(plan, s)
        return ((lambda v, xx: sell_mod.spmm_sell(plan, s, v, xx)), grid,
                (lambda d: sell_mod.unpad_values(s, d, group=plan.group),
                 desc + " (plan + pad_values)", pads))

    # per block: 4 forwards, then 4 forward+backwards
    k1 = ({"spmm_csr": 4}, {"spmm_csr": 4, "spmm_sddmm_csc": 4})
    want_path = {"chunked": k1, "sell": k1, "sell_grid": k1,
                 "seg": ({"spmm_spans": 4},
                         {"spmm_spans": 4, "spmm_sddmm_spans": 4})}
    res = {}
    for name, make in (("chunked", plan_chunked), ("seg", plan_seg),
                       ("sell", plan_sell), ("sell_grid", plan_sell_grid)):
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn, leaf, extra = make()
        torch.cuda.synchronize()
        plan_s = time.perf_counter() - t0
        unpack, desc, pads = extra or (None, "", None)
        blocks = [_entry_block(f, lf, x, gw) for f, lf in (
            (csr_fn, val), (fn, leaf), (fn, leaf), (csr_fn, val))]
        timed_until = time.perf_counter()
        csr_b, path_b = (blocks[0], blocks[3]), (blocks[1], blocks[2])

        def mean(bs, part):
            return sum(sum(b[part][1:]) / 3 for b in bs) / len(bs)
        stats = {"plan_s": plan_s, "fwd_ms": mean(path_b, "fwd"),
                 "fwd_bwd_ms": mean(path_b, "fwd_bwd"),
                 "csr_fwd_ms": mean(csr_b, "fwd"),
                 "csr_fwd_bwd_ms": mean(csr_b, "fwd_bwd"),
                 "peak_gb": max(b["peak_gb"] for b in path_b),
                 "csr_peak_gb": max(b["peak_gb"] for b in csr_b),
                 "launches_fwd": path_b[0]["counts_fwd"],
                 "launches": path_b[0]["counts"]}
        print(f"phase 10d {name} (K={ENTRY_K}, f32, {row.numel()} nnz): plan "
              f"{plan_s:.3f} s {desc}; in turns csr, {name}, {name}, csr: "
              + "; ".join(
                  f"{lbl} forward ms {' '.join(f'{t:.3f}' for t in b['fwd'])}"
                  f", forward+backward ms "
                  f"{' '.join(f'{t:.3f}' for t in b['fwd_bwd'])}, peak "
                  f"{b['peak_gb']:.2f} GB"
                  for lbl, b in zip(("csr", name, name, "csr"), blocks))
              + f"; means (after each warm-up) {name} {stats['fwd_ms']:.3f} / "
              f"{stats['fwd_bwd_ms']:.3f} ms vs spmm_csr "
              f"{stats['csr_fwd_ms']:.3f} / {stats['csr_fwd_bwd_ms']:.3f} ms; "
              f"launches in 4 forwards / 4 forward+backwards: " + "; ".join(
                  f"{lbl} {_nonzero(b['counts_fwd'])} / "
                  f"{_nonzero(b['counts'])}"
                  for lbl, b in zip(("csr", name, name, "csr"), blocks))
              + f" {card}", flush=True)
        for lbl, want, bs in ((name, want_path[name], path_b),
                              ("spmm_csr", k1, csr_b)):
            for b in bs:
                got = (b["counts_fwd"], b["counts"])
                check(all(g[k] == w.get(k, 0) for g, w in zip(got, want)
                          for k in g),
                      f"{lbl}: expected launches {want} in 4 forwards / 4 "
                      f"forward+backwards, counted {got}")
        last = path_b[1]
        d_val = unpack(last["d_leaf"]) if unpack else last["d_leaf"]
        check_packed_grads(name, row, col, val, x, gw, last["out"], d_val,
                           last["d_x"], torch.float32, rowptr, phase="10d")
        if pads is not None:
            pad_grad = float(last["d_leaf"][pads].abs().max()) \
                if bool(pads.any()) else 0.0
            print(f"phase 10d {name}: d value in the grid "
                  f"{tuple(last['d_leaf'].shape)}, max |grad| over "
                  f"{int(pads.sum())} pad slots {pad_grad} {card}",
                  flush=True)
            check(pad_grad == 0.0, f"{name}: pad slots got a gradient")
        res[name] = stats
        del fn, leaf, extra, blocks, csr_b, path_b, last, d_val, pads
        spmm_mod._SELL_CACHE.clear()
    return res, timed_until


# ---- phase 11: the experiments/ probes (P1-P5) ----------------------------

PROBE_SLICE_CHUNKS = 10_000             # r5_vmem_expand.py's default NCH
# a sum rounded to bf16 once lies within half a bf16 ulp of the exact sum,
# which is at most 2**-8 of its magnitude
BF16_HALF_ULP = 2.0 ** -8


def _probe_launches():
    from paddle_sparse_tpu_torch.ops.kernels import probes_cuda as pc
    return {"scale2": pc.scale2_cuda.launches,
            "chunk_sum": pc.chunk_sum_cuda.launches,
            "span_plan": pc.span_pieces.launches,
            "span_colsum": pc.span_colsum_cuda.launches,
            "span_colsum_staged": pc.span_colsum_staged_cuda.launches,
            "band_ablate": pc.band_ablate_cuda.launches,
            "slice_gather": pc.slice_gather_cuda.launches,
            "slice_plan": pc.slice_items.launches,
            "slice_reduce": pc.slice_gather_cuda.launches_reduce}


def _zero_probe_launches():
    from paddle_sparse_tpu_torch.ops.kernels import probes_cuda as pc
    for fn in (pc.scale2_cuda, pc.chunk_sum_cuda, pc.span_pieces,
               pc.span_colsum_cuda, pc.span_colsum_staged_cuda,
               pc.band_ablate_cuda, pc.slice_items, pc.slice_gather_cuda):
        fn.launches = 0
    pc.slice_gather_cuda.launches_reduce = 0


def phase11a_probe_path(dev):
    """Each probe's entry points once, at its defaults, with every launch
    count set to 0 just before and read just after."""
    from paddle_sparse_tpu_torch.experiments import (bisect_pallas,
                                                     r4_band_cost,
                                                     r4_dma_issue,
                                                     r5_vmem_expand)
    from paddle_sparse_tpu_torch.ops.kernels.probes_cuda import SLICE_VARIANTS
    torch.cuda.synchronize()
    _zero_launch_counts()
    _zero_probe_launches()
    bisect = bisect_pallas.main(["all"], device=dev)
    stream, e0, seed = r4_dma_issue.make_inputs(19, 384, device=dev)
    dma = r4_dma_issue.run(stream, e0, seed, NS=19, CAP=384,
                           steps=r4_dma_issue.STEPS)
    tb = r4_band_cost.tables(device=dev)
    r4_band_cost.check_schedule(tb)
    band = {kind: r4_band_cost.variant_call(kind, tb)
            for _, kind in r4_band_cost.VARIANTS}
    fs, cols, x = r5_vmem_expand.make_inputs(PROBE_SLICE_CHUNKS, dev)
    sl = {v: r5_vmem_expand.make_call(v)(fs, cols, x)
          for v in SLICE_VARIANTS}
    torch.cuda.synchronize()
    counts = {**_launch_counts(), **_probe_launches()}
    # bisect: scale2 1, chunk_sum 2 (one per depth), K1 1 (spmm stage);
    # r4_dma_issue: span_plan 1, span_colsum 1; r4_band_cost: K4 2 (full,
    # untrans), band_ablate 3, span_colsum_staged 1 (nosel's chunk sums);
    # r5: slice_gather 2, of them slice_reduce 1 (onehot_reduce) after
    # slice_plan 1
    want = {k: 0 for k in counts}
    want.update(scale2=1, chunk_sum=2, spmm_spans=3, span_plan=1,
                span_colsum=1, span_colsum_staged=1, band_ablate=3,
                slice_plan=1, slice_gather=2, slice_reduce=1)
    check(counts == want, f"probe path launches {counts}, want {want}")
    print(f"phase 11a probe entry points (bisect_pallas all, r4_dma_issue "
          f"19 384, r4_band_cost's five variants, r5_vmem_expand "
          f"{PROBE_SLICE_CHUNKS} chunks): launches exact "
          f"{ {k: v for k, v in counts.items() if v} } ok", flush=True)
    return {"bisect": bisect, "dma": (stream, e0, seed, dma),
            "band": (tb, band), "slice": (fs, cols, x, sl)}, counts


def device_ms(fn, reps):
    """``fn``'s device time per call from ``torch.profiler``: the self
    device time of every kernel, copy and memset that ``reps`` calls ran
    (after one warm-up call), over ``reps``, without the host's cost of
    launching them; and the names of those device activities. ``(None,
    [])`` if the profiler saw no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
          and getattr(e, "self_device_time_total", 0) > 0]
    if not ev:
        return None, []
    total = sum(e.self_device_time_total for e in ev) / 1e3 / reps
    return total, sorted(f"{e.key[:48]} x{e.count}" for e in ev)


def host_per_call(fn, n=2000):
    """``fn``'s host us and CUDA-event ms per back-to-back call, alone: ``n``
    calls after 100 of warm-up, the host clock read around the loop and
    events recorded before and after it, one synchronize at the end."""
    for _ in range(100):
        fn()
    torch.cuda.synchronize()
    a, b = _event(), _event()
    a.record()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    b.record()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e6 / n, a.elapsed_time(b) / n


def _probe_entry(ms, plain_ms, lib_ms, lib, moved, flops, err, **extra):
    bound, by = bound_ms(moved, flops)
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": by, "library_ms": lib_ms, "library": lib,
            "max_abs_err": err, **extra}


def phase11_bisect(gen, dev, card, outs):
    """P1 and P2 against their plain versions, bit for bit, over odd sizes
    and both ring depths; the spmm stage (segment_rows_matmul, K1) against
    f64; their times."""
    from paddle_sparse_tpu_torch import segment_rows_matmul, spmm_spans_reference
    from paddle_sparse_tpu_torch.experiments import bisect_pallas as bp
    from paddle_sparse_tpu_torch.ops.kernels.probes_cuda import (
        chunk_sum_cuda, chunk_sum_reference, scale2_cuda, scale2_reference)
    x = torch.ones((256, 128), device=dev)
    check(torch.equal(outs["trivial"], x * 2), "trivial stage is not 2 * x")
    for n in (1, 3, 4099, 1 << 20):
        y = torch.randn(n + 1, generator=gen, device=dev)
        for v in (y[:n], y[1:]):          # aligned and 4-byte offset
            check(torch.equal(scale2_cuda(v), scale2_reference(v)),
                  f"scale2 differs at n={n}")
    ptr, src = bp.dma_inputs(dev)
    ref = chunk_sum_reference(ptr, src.double(), bp.E)
    for name in ("dma1", "dma2"):
        check(torch.equal(outs[name].double(), ref),
              f"{name} stage differs from the f64 chunk sums")
    # uneven tiles (an empty one, one of six chunks), odd K, both depths
    ptr2 = torch.tensor([0, 3, 3, 9, 10], device=dev, dtype=torch.int32)
    src2 = torch.randn(1000, 36, generator=gen, device=dev)
    for db in (False, True):
        check(torch.equal(chunk_sum_cuda(ptr2, src2, 100, db),
                          chunk_sum_reference(ptr2, src2, 100)),
              f"chunk_sum (double_buffer={db}) differs from the plain f32 "
              f"sum on uneven tiles")
    val, row, rowptr = bp.spmm_inputs(dev)
    rp = rowptr.long()
    ref = spmm_spans_reference(rp[None, :-1], rp[None, 1:], None, None,
                               None, val.double())
    err = float((outs["spmm"].double() - ref).abs().max())
    check(torch.allclose(outs["spmm"].double(), ref, **F32_TOL),
          f"spmm stage vs f64 ({err:.3e})")
    # segment_rows_matmul with acc, bf16, rowptr past nnz, a row > CAP
    M, nnz, K = 300, 9000, 40
    row = torch.sort(torch.randint(0, M, (nnz,), generator=gen,
                                   device=dev)).values
    row[2000:6000] = row[2000]                    # a long row: pieces
    row = torch.sort(row).values
    rp = torch.searchsorted(row, torch.arange(M + 1, device=dev))
    rp[-1] += 50                                  # clipped to nnz
    acc = torch.randn(M, K, generator=gen, device=dev)
    srm_err = err
    for dt in (torch.float32, torch.bfloat16):
        p = torch.randn(nnz, K, generator=gen, device=dev).to(dt)
        got = segment_rows_matmul(p, row, rp, M, acc=acc)
        c = rp.clamp(max=nnz)
        want = spmm_spans_reference(c[None, :-1], c[None, 1:], None, None,
                                    None, p.double()) + acc.double()
        e = float((got.double() - want).abs().max())
        srm_err = max(srm_err, e)
        check(got.dtype == torch.float32
              and torch.allclose(got.double(), want, **F32_TOL),
              f"segment_rows_matmul {dt} with acc vs f64 ({e:.3e})")
    print(f"phase 11b bisect_pallas: trivial = 2 x, dma1/dma2 equal to the "
          f"f64 chunk sums, scale2 bit for bit at odd sizes and offsets, "
          f"chunk_sum bit for bit on uneven tiles at both depths; spmm stage "
          f"and segment_rows_matmul (acc, bf16, rowptr past nnz, a row of "
          f"4,000 edges) vs f64 max_abs_err {srm_err:.3e} ok", flush=True)

    p1, k1, k2, p2, _, _ = in_turns(lambda: scale2_reference(x),
                                    lambda: scale2_cuda(x), 500, 500)
    lib_ms, _ = library_timed("torch.mul", lambda: torch.mul(x, 2.0), 500)
    scale2 = _probe_entry((k1 + k2) / 2, (p1 + p2) / 2, lib_ms,
                          "torch.mul(x, 2.0)", 2 * nbytes(x), x.numel(), 0.0,
                          at="(256, 128) f32, bisect_pallas.trivial")
    T, cpt, E = bp.T, bp.CHUNKS_PER_TILE, bp.E
    depth = {}
    for db in (False, True):
        p1, k1, k2, p2, out_p, out_k = in_turns(
            lambda: chunk_sum_reference(ptr, src, E),
            lambda db=db: chunk_sum_cuda(ptr, src, E, db), 50, 500)
        check(torch.equal(out_k, out_p), "chunk_sum timed run differs")
        depth[db] = ((k1 + k2) / 2, (p1 + p2) / 2)
    lib_ms, lib_err = library_timed(
        "view(...).sum(1)", lambda: src.view(T, cpt, E, -1).sum(1), 500,
        out_k.view(T, E, -1))
    chunk = _probe_entry(depth[True][0], depth[True][1], lib_ms,
                         "src.view(T, 4, E, K).sum(1)",
                         nbytes(src, ptr, out_k), src.numel(), 0.0,
                         at="T=8 tiles of 4 chunks of (256, 128) f32, two "
                            "slots (dma2)",
                         ms_one_slot=depth[False][0],
                         plain_ms_one_slot=depth[False][1],
                         library_max_abs_err=lib_err)
    print(f"phase 11b scale2 (256, 128): kernel {scale2['ms']:.4f} ms, "
          f"plain {scale2['plain_ms']:.4f}, torch.mul {scale2['library_ms']}"
          f", bound {scale2['bound_ms']:.5f}; chunk_sum one slot "
          f"{depth[False][0]:.4f} ms, two slots {depth[True][0]:.4f} ms, "
          f"plain {depth[True][1]:.4f}, view().sum(1) {lib_ms}, bound "
          f"{chunk['bound_ms']:.5f} {card}", flush=True)
    # the device's own time, apart from each call's host cost (the CUDA
    # events above time back-to-back calls, so they see the host's launch
    # cost when it exceeds the kernel's)
    dev_t, host = {}, {}
    for name, fn in (
            ("scale2", lambda: scale2_cuda(x)),
            ("torch.mul", lambda: torch.mul(x, 2.0)),
            ("chunk_sum one slot", lambda: chunk_sum_cuda(ptr, src, E, False)),
            ("chunk_sum two slots", lambda: chunk_sum_cuda(ptr, src, E, True)),
            ("view().sum(1)", lambda: src.view(T, cpt, E, -1).sum(1))):
        dev_t[name] = device_ms(fn, 200)
        host[name] = host_per_call(fn)
    print("phase 11b device time per call from torch.profiler (CUDA events "
          "per call in brackets): " + "; ".join(
              f"{name} {'not measured' if t is None else f'{t:.5f} ms'} "
              f"[{ev}] ({names})" for (name, (t, names)), ev in zip(
                  dev_t.items(), (
                      f"{scale2['ms']:.4f}", f"{scale2['library_ms']}",
                      f"{depth[False][0]:.4f}", f"{depth[True][0]:.4f}",
                      f"{lib_ms}"))) + f" {card}", flush=True)
    print("phase 11b per back-to-back call, alone (host us, CUDA events ms, "
          "device ms): " + "; ".join(
              f"{name} {h:.2f} us, {ev:.4f} ms, "
              f"{'not measured' if dev_t[name][0] is None else f'{dev_t[name][0]:.5f}'}"
              f" ms" for name, (h, ev) in host.items()) + f" {card}",
          flush=True)
    scale2.update(device_ms=dev_t["scale2"][0],
                  library_device_ms=dev_t["torch.mul"][0],
                  host_us=host["scale2"][0], events_ms=host["scale2"][1],
                  library_host_us=host["torch.mul"][0],
                  library_events_ms=host["torch.mul"][1])
    chunk.update(device_ms=dev_t["chunk_sum two slots"][0],
                 device_ms_one_slot=dev_t["chunk_sum one slot"][0],
                 library_device_ms=dev_t["view().sum(1)"][0],
                 host_us=host["chunk_sum two slots"][0],
                 host_us_one_slot=host["chunk_sum one slot"][0],
                 events_ms=host["chunk_sum two slots"][1],
                 events_ms_one_slot=host["chunk_sum one slot"][1],
                 library_host_us=host["view().sum(1)"][0],
                 library_events_ms=host["view().sum(1)"][1])
    return scale2, chunk, srm_err


def phase11_dma_issue(gen, dev, card, run):
    """P3 at the probe's defaults: the piece path (``span_colsum_cuda``, the
    probe's ``run``) and the staged kernel against f64 (within 1e-5 of each
    entry's sum of |terms|); 13 steps (not a multiple of 8), K 8 to 2,048,
    CAP 17/33/40/50/300 from unaligned starts, identical and overlapping
    spans within a step, two steps holding the same spans, a span ending at
    the stream's end; each kernel's time in turns with the plain version
    and with the other, beside the bytes-once and staged bounds."""
    from paddle_sparse_tpu_torch.experiments import r4_dma_issue as rd
    from paddle_sparse_tpu_torch.ops.kernels.probes_cuda import (
        PIECE_ROWS, dma_issue_output, span_colsum_cuda,
        span_colsum_reference, span_colsum_staged_cuda, span_pieces,
        span_pieces_reference)
    stream, e0, seed, out = run
    NS, CAP, steps = 19, 384, rd.STEPS

    def f64(st, sd, ns, cap, n, e):
        return dma_issue_output(span_colsum_reference(
            st, e, ns, cap, n, acc=torch.float64), sd)

    def held(got, st, sd, ns, cap, n, e, tag):
        want, sc = f64(st, sd, ns, cap, n, e), f64(st.abs(), sd.abs(), ns,
                                                   cap, n, e)
        d = (got.double() - want).abs()
        check(bool((d <= GRAD_REL * sc + 1e-30).all()),
              f"r4_dma_issue {tag} vs f64 ({float(d.max()):.3e})")
        return float(d.max())

    err = held(out, stream, seed, NS, CAP, steps, e0, "pieces")
    err_staged = held(dma_issue_output(span_colsum_staged_cuda(
        stream, e0, NS, CAP, steps), seed), stream, seed, NS, CAP, steps,
        e0, "staged")
    # 13 steps (blocks from steps 8..12 and 5..7), random seeds, K 8-2048
    for K, ns, cap, L in ((256, 3, 40, 6000), (128, 5, 33, 6000),
                          (8, 2, 300, 6000), (2048, 4, 50, 3000),
                          (16, 6, 17, 500)):
        st = torch.randn(L, K, generator=gen, device=dev).bfloat16()
        e = torch.randint(0, L - cap, (13 * ns,), generator=gen,
                          device=dev).int()
        e[1] = e[0]                              # identical in one step
        e[ns - 1] = min(int(e[0]) + cap // 2, L - cap)   # overlapping
        e[ns:2 * ns] = e[:ns]                    # steps 0 and 1 share all
        e[-1] = L - cap                          # a span ending at row L
        sd = torch.randn(1, 128, generator=gen, device=dev)
        held(rd.run(st, e, sd, NS=ns, CAP=cap, steps=13), st, sd, ns, cap,
             13, e, f"pieces at 13 steps, K={K}")
        held(dma_issue_output(span_colsum_staged_cuda(st, e, ns, cap, 13),
                              sd), st, sd, ns, cap, 13, e,
             f"staged at 13 steps, K={K}")
    try:
        rd.run(stream, e0, seed, NS=NS, CAP=CAP, steps=7)
        check(False, "r4_dma_issue ran at 7 steps")
    except ValueError:
        pass
    print(f"phase 11c r4_dma_issue NS={NS} CAP={CAP} STEPS={steps}: "
          f"output vs f64 max_abs_err {err:.3e} through the pieces, "
          f"{err_staged:.3e} staged (within {GRAD_REL} of each entry's sum "
          f"of |terms|); 13 steps at K 256/128/8/2048/16, CAP "
          f"40/33/300/50/17, identical, overlapping and shared spans, a span "
          f"ending at the stream's end ok; 7 steps refused ok", flush=True)

    K = stream.shape[1]
    e = e0[:steps * NS]
    L = stream.shape[0]
    r1, c1, c2, r2, ref_plan, plan = in_turns(
        lambda: span_pieces_reference(e, CAP, L),
        lambda: span_pieces(e, CAP, L), 5, 20)
    pieces = int(plan.total[0])
    check(pieces == int(ref_plan.total[0])
          and all(torch.equal(a[:pieces], b[:pieces]) for a, b in (
              (plan.row, ref_plan.row), (plan.length, ref_plan.length)))
          and torch.equal(plan.first, ref_plan.first)
          and torch.equal(plan.last, ref_plan.last),
          "the card's span plan differs from its torch reference")
    plan_ms = (c1 + c2) / 2
    plan_entry = _probe_entry(
        plan_ms, (r1 + r2) / 2, None, None,
        nbytes(e) + pieces * 8 + nbytes(plan.first, plan.last) + 4, 0, 0.0,
        at=f"{steps * NS} spans of {CAP} rows (NS={NS}, STEPS={steps})",
        pieces=pieces, max_pieces=plan.max_pieces)
    p1, k1, k2, p2, _, _ = in_turns(
        lambda: span_colsum_reference(stream, e0, NS, CAP, steps),
        lambda: span_colsum_cuda(stream, e0, NS, CAP, steps), 1, 10)
    s1, n1, n2, s2, out_s, out_n = in_turns(
        lambda: span_colsum_staged_cuda(stream, e0, NS, CAP, steps),
        lambda: span_colsum_cuda(stream, e0, NS, CAP, steps), 10, 10)
    rows = (e0.long().view(steps, NS, 1)
            + torch.arange(CAP, device=dev)).view(steps, -1)
    lib_ms, lib_err = library_timed(
        "embedding_bag sum", lambda: torch.nn.functional.embedding_bag(
            rows, stream, mode="sum"), 5,
        span_colsum_reference(stream, e0, NS, CAP, steps))
    seen = torch.zeros(stream.shape[0], dtype=torch.bool, device=dev)
    seen[rows.reshape(-1)] = True
    distinct = int(seen.sum())
    del rows, seen
    ms = (k1 + k2) / 2
    staged = steps * NS * CAP * K * 2
    moved = distinct * K * 2 + nbytes(e0) + steps * K * 4
    lib = ("torch.nn.functional.embedding_bag(mode='sum') over each step's "
           "span rows")
    at = f"NS={NS} CAP={CAP} STEPS={steps}, bf16 stream {tuple(stream.shape)}"
    entry = _probe_entry(
        ms, (p1 + p2) / 2, lib_ms, lib, moved, steps * NS * CAP * K, err,
        library_max_abs_err=lib_err, at=at, distinct_rows=distinct,
        staged_bytes=staged, staged_bound_ms=staged / HBM_BYTES_PER_S * 1e3,
        us_per_step=ms / steps * 1e3, us_per_span=ms / steps / NS * 1e3,
        ms_in_turns_with_staged=(n1 + n2) / 2,
        staged_ms_in_turns=(s1 + s2) / 2, plan_ms=plan_ms, pieces=pieces,
        max_pieces=plan.max_pieces, piece_rows=PIECE_ROWS,
        piece_sum_bytes=plan.max_pieces * K * 4,
        piece_sum_bytes_at_k2048=plan.max_pieces * 2048 * 4)
    staged_entry = _probe_entry(
        (s1 + s2) / 2, (p1 + p2) / 2, lib_ms, lib, moved,
        steps * NS * CAP * K, err_staged, library_max_abs_err=lib_err,
        at=at, staged_bytes=staged,
        staged_bound_ms=staged / HBM_BYTES_PER_S * 1e3,
        us_per_step=(s1 + s2) / 2 / steps * 1e3,
        us_per_dma=(s1 + s2) / 2 / steps / NS * 1e3)
    print(f"phase 11c span_colsum (pieces): kernel {k1:.4f} / {k2:.4f} ms "
          f"({entry['us_per_step']:.4f} us per step, "
          f"{entry['us_per_span']:.5f} per span), plain {p1:.3f} / "
          f"{p2:.3f}, embedding_bag {lib_ms} (max_abs_err {lib_err}); "
          f"bound {entry['bound_ms']:.4f} ms ({distinct} distinct rows), "
          f"staged bound {entry['staged_bound_ms']:.4f} ms; plan "
          f"{c1:.4f} / {c2:.4f} ms (its torch reference {r1:.4f} / "
          f"{r2:.4f}, equal), {pieces} pieces of at most {PIECE_ROWS} rows "
          f"(room for {plan.max_pieces}: {plan.max_pieces * K * 4} bytes of "
          f"piece sums, {plan.max_pieces * 2048 * 4} at K=2048) {card}",
          flush=True)
    print(f"phase 11c span_colsum staged {s1:.4f} / {s2:.4f} ms in turns "
          f"with the pieces {n1:.4f} / {n2:.4f} ms (staged "
          f"{staged_entry['us_per_dma']:.5f} us per span copy) {card}",
          flush=True)
    return entry, staged_entry, plan_entry


def phase11_band(gen, dev, card, run):
    """P4's five variants at the probe's sizes against f64 (full/untrans on
    K4) and the plain versions (nodot and empty bit for bit), a small band
    visited by several chunks per tile, a schedule that misses an edge; the
    variants' times."""
    from paddle_sparse_tpu_torch import spmm_spans_reference
    from paddle_sparse_tpu_torch.experiments import r4_band_cost as rb
    from paddle_sparse_tpu_torch.ops.kernels.probes_cuda import (
        band_ablate_reference, span_colsum_cuda, span_colsum_staged_cuda)
    tb, outs = run

    def refs(t, stream):
        kw = dict(S=t.S, BR_pad=t.BR_pad, E=t.E, K=t.K, R=t.R, TMAX=t.TMAX,
                  visits=t.visits)
        st, en = t.bst.reshape(t.S, -1), t.ben.reshape(t.S, -1)
        full = spmm_spans_reference(st, en, None, None, None, stream)
        return {"full": full, "untrans": full, **{m: band_ablate_reference(
            m, t.cs, t.cr, t.cn, t.bst, t.ben, stream, **kw)
            for m in ("nodot", "nosel", "empty")}}

    errs = {}
    small = rb.tables(S=2, BAND=384, E=128, K=128, CAP=512, device=dev)
    rb.check_schedule(small)
    for name, t, got in (("probe", tb, outs), ("small", small, {
            k: rb.variant_call(k, small) for _, k in rb.VARIANTS})):
        want = refs(t, t.stream.double())
        plain32 = refs(t, t.stream)
        for kind, g in got.items():
            e = float((g.double() - want[kind]).abs().max())
            errs[(name, kind)] = e
            check(torch.allclose(g.double(), want[kind], **F32_TOL),
                  f"r4_band_cost {kind} ({name}) vs f64 ({e:.3e})")
            if kind in ("nodot", "empty"):
                check(torch.equal(g, plain32[kind]),
                      f"band_ablate {kind} ({name}) differs from the plain "
                      f"f32 sum in chunk order")
        visits = small.visits[0].diff()
        check(int(visits.max()) > 1, "small band: no tile has two visits")
    bad = rb.tables(S=2, BAND=384, E=128, K=128, CAP=512, device=dev)
    bad.cn[1] = 0
    try:
        rb.check_schedule(bad)
        check(False, "a schedule that misses edges passed the check")
    except ValueError:
        pass
    print(f"phase 11d r4_band_cost at S={tb.S} BAND={tb.BAND} E={tb.E} "
          f"K={tb.K} CAP={tb.CAP} ({tb.nchunks} chunks, up to "
          f"{int(tb.visits[0].diff().max())} visits a tile) and at S=2 "
          f"BAND=384: every variant vs f64 max_abs_err "
          f"{max(errs.values()):.3e}, nodot and empty bit for bit with the "
          f"plain sums; a schedule missing a chunk's tiles refused ok",
          flush=True)

    S, BR_pad, E, K = tb.S, tb.BR_pad, tb.E, tb.K
    R, n = tb.R, tb.nchunks
    sched = nbytes(tb.cs, tb.cr, tb.cn)
    out_b = BR_pad * K * 4
    tiles = int((tb.visits[0].diff() > 0).sum())
    heads = int((tb.cn > 0).sum())
    moved = {"nodot": out_b + sched + 8 * S * tiles,
             "nosel": out_b + sched + nbytes(tb.stream),
             "empty": out_b + sched + heads * R * K * 2}
    flops = {"nodot": BR_pad * K, "nosel": nbytes(tb.stream) // 2,
             "empty": int(tb.visits[1].numel()) * R * K}
    kw = dict(S=S, BR_pad=BR_pad, E=E, K=K, R=R, TMAX=tb.TMAX,
              visits=tb.visits)
    entry = {}
    for mode in ("nodot", "nosel", "empty"):
        p1, k1, k2, p2, _, _ = in_turns(
            lambda mode=mode: band_ablate_reference(
                mode, tb.cs, tb.cr, tb.cn, tb.bst, tb.ben, tb.stream, **kw),
            lambda mode=mode: rb.variant_call(mode, tb), 1, 20)
        entry[mode] = _probe_entry((k1 + k2) / 2, (p1 + p2) / 2, None, None,
                                   moved[mode], flops[mode],
                                   errs[("probe", mode)],
                                   kernel_ms_in_turns=[k1, k2])
    # nodot on the device alone (its calls back to back read the host's
    # rate), beside the card's own store of the same bytes: fill_ does not
    # compute nodot, and no PyTorch call does
    fill = "torch.empty((BR_pad, K), float32).fill_(1.0)"
    nodot_dev, _ = device_ms(lambda: rb.variant_call("nodot", tb), 100)

    def fill_call():
        return torch.empty((BR_pad, K), dtype=torch.float32,
                           device=dev).fill_(1.0)

    fill_dev, _ = device_ms(fill_call, 100)
    fill_ms, _ = timed(dropped(fill_call), 100)
    check(nodot_dev is not None and fill_dev is not None,
          "the profiler saw no device time for nodot or its fill yardstick")
    e = entry["nodot"]
    e.update(device_ms=nodot_dev, fill_yardstick=fill,
             fill_yardstick_device_ms=fill_dev, fill_yardstick_ms=fill_ms)
    print(f"phase 11d band_ablate nodot: device {nodot_dev:.5f} ms "
          f"(torch.profiler, 100 calls), in turns "
          f"{e['kernel_ms_in_turns'][0]:.5f} / "
          f"{e['kernel_ms_in_turns'][1]:.5f} ms; {fill} device "
          f"{fill_dev:.5f} ms, events {fill_ms:.5f} ms; bound "
          f"{e['bound_ms']:.5f} ms ({e['bound_by']}) {card}", flush=True)
    # no PyTorch call computes nosel; one computes its first pass, the
    # chunks' column sums, which nosel takes from the staged span kernel
    # (disjoint spans: each byte once, no plan) and the piece path could
    first = "stream.view(nchunks, E, K).sum(1, dtype=float32)"
    first_ms, _ = library_timed(first, lambda: tb.stream.view(
        n, E, K).sum(1, dtype=torch.float32), 20)
    starts = torch.arange(n, device=dev, dtype=torch.int32) * E
    s1, c1, c2, s2, out_s, out_c = in_turns(
        lambda: span_colsum_staged_cuda(tb.stream, starts, 1, E, n),
        lambda: span_colsum_cuda(tb.stream, starts, 1, E, n), 20, 20)
    check(torch.allclose(out_c, out_s, **F32_TOL),
          "nosel's chunk sums differ between the staged and piece paths")
    entry["nosel"].update(
        first_pass_library=first + " (first pass only: the chunk column "
                                   "sums; no PyTorch call computes nosel)",
        first_pass_library_ms=first_ms,
        first_pass_staged_ms=(s1 + s2) / 2,
        first_pass_pieces_ms=(c1 + c2) / 2)
    print(f"phase 11d nosel's first pass (chunk column sums): staged span "
          f"kernel {s1:.4f} / {s2:.4f} ms, piece path {c1:.4f} / {c2:.4f} "
          f"ms in turns; {first} {first_ms} ms {card}", flush=True)
    k4 = {}
    for kind in ("full", "untrans"):
        k4[kind], _ = timed(lambda kind=kind: rb.variant_call(kind, tb), 20)
    for kind, e in entry.items():
        print(f"phase 11d band_ablate {kind}: kernel {e['ms']:.4f} ms, plain "
              f"{e['plain_ms']:.3f}, library {e['library_ms']}, bound "
              f"{e['bound_ms']:.4f} ({e['bound_by']}) {card}", flush=True)
    print(f"phase 11d K4 (band_reduce_call) full {k4['full']:.4f} ms, "
          f"untrans {k4['untrans']:.4f} ms {card}", flush=True)
    return entry, k4


def phase11_slice(gen, dev, card, run):
    """P5 at the probe's defaults: onehot_write equal to the plain gather,
    onehot_reduce within half a bf16 ulp (+ 1e-5 of the sum of |terms|) of
    f64; fs all equal, repeated and unsorted, 10,000 chunks on one slice, E
    7, 50, 64, 100 and 2,500 (past the TF32 path), R 16, 100, 300, 400 and
    799 (16-column parts), K 8, 40, 64 and 200 (a narrow last column part),
    cols starting one entry past a 16-byte boundary at the probe's E; both
    in turns with the plain version; ns per edge beside index_select and
    embedding_bag."""
    from paddle_sparse_tpu_torch.experiments import r5_vmem_expand as rv
    from paddle_sparse_tpu_torch.ops.kernels.probes_cuda import (
        ITEM_CHUNKS, slice_gather_cuda, slice_gather_reference, slice_items,
        slice_items_reference)
    fs, cols, x, outs = run
    R, E, K = rv.R, rv.E, rv.K
    nch = fs.numel()

    def check_reduce(got, f, c, xx, r, tag):
        want = slice_gather_reference(f, c, xx, r, "onehot_reduce",
                                      acc=torch.float64)
        sc = slice_gather_reference(f, c, xx.abs(), r, "onehot_reduce",
                                    acc=torch.float64)
        d = (got.double() - want).abs()
        check(bool((d <= BF16_HALF_ULP * want.abs() + GRAD_REL * sc
                    + 1e-30).all()),
              f"slice_gather reduce ({tag}) vs f64 ({float(d.max()):.3e})")
        return float(d.max())

    check(torch.equal(outs["onehot_write"],
                      slice_gather_reference(fs, cols, x, R,
                                             "onehot_write")),
          "onehot_write differs from the plain gather")
    errs = {"onehot_write": 0.0,
            "onehot_reduce": check_reduce(outs["onehot_reduce"], fs, cols, x,
                                          R, "probe")}
    # cols one int32 past a 16-byte boundary: the histogram's 16-byte
    # loads do not apply
    buf = torch.empty(cols.numel() + 1, dtype=cols.dtype, device=dev)
    buf[1:] = cols
    errs["onehot_reduce"] = max(errs["onehot_reduce"], check_reduce(
        slice_gather_cuda(fs, buf[1:], x, R, "onehot_reduce"), fs, buf[1:],
        x, R, "cols at a 4-byte offset"))
    del buf
    for f_, K2, R2, E2 in (([3, 3, 3, 3, 3], 256, 512, 2048),
                           ([0, 4, 4, 1, 0, 4], 200, 400, 50),
                           ([2, 1], 8, 16, 7),
                           ([1, 0, 1, 1], 40, 300, 100),
                           ([1, 0, 1], 64, 100, 2500),
                           ([4, 1, 4], 256, 799, 64)):
        f = torch.tensor(f_, device=dev, dtype=torch.int32)
        c = torch.randint(0, R2, (len(f_) * E2,), generator=gen, device=dev,
                          dtype=torch.int32)
        xx = torch.randn(5 * R2, K2, generator=gen, device=dev).bfloat16()
        check(torch.equal(slice_gather_cuda(f, c, xx, R2, "onehot_write"),
                          slice_gather_reference(f, c, xx, R2,
                                                 "onehot_write")),
              f"onehot_write at K={K2} R={R2}")
        errs["onehot_reduce"] = max(errs["onehot_reduce"], check_reduce(
            slice_gather_cuda(f, c, xx, R2, "onehot_reduce"), f, c, xx, R2,
            f"K={K2} R={R2} E={E2}"))
    # every chunk on one slice: 313 items of one slice spread over the SMs
    one = torch.full_like(fs, 7)
    one_out = slice_gather_cuda(one, cols, x, R, "onehot_reduce")
    errs["onehot_reduce"] = max(errs["onehot_reduce"], check_reduce(
        one_out, one, cols, x, R, f"{nch} chunks on one slice"))
    del one_out
    print(f"phase 11e r5_vmem_expand NCH={nch}: onehot_write equal to the "
          f"plain gather, onehot_reduce vs f64 max_abs_err "
          f"{errs['onehot_reduce']:.3e} (within half a bf16 ulp); fs all "
          f"equal, repeated and unsorted fs, {nch} chunks on one slice, K "
          f"200, 40, 8 and 64, R 400, 300, 16, 100 and 799, E 50, 100, 7, "
          f"2500 (f32 FMAs past 2,048) and 64, cols at a 4-byte offset ok",
          flush=True)
    del outs
    torch.cuda.empty_cache()

    rows = fs.long().repeat_interleave(E) * R + cols.long()
    seen = torch.zeros(x.shape[0], dtype=torch.bool, device=dev)
    seen[rows] = True
    distinct = int(seen.sum())
    del seen
    nslices = x.shape[0] // R
    r1, c1, c2, r2, ref_items, items = in_turns(
        lambda: slice_items_reference(fs), lambda: slice_items(fs, nslices),
        5, 20)
    n_items = int(items.n_items[0])
    check(n_items == int(ref_items.n_items[0])
          and torch.equal(items.order, ref_items.order)
          and torch.equal(items.sf, ref_items.sf)
          and torch.equal(items.istart[:n_items + 1],
                          ref_items.istart[:n_items + 1]),
          "the card's slice plan differs from its torch reference")
    plan_ms = (c1 + c2) / 2
    plan_entry = _probe_entry(
        plan_ms, (r1 + r2) / 2, None, None,
        nbytes(fs) + 2 * nbytes(fs) + (n_items + 2) * 4, 0, 0.0,
        at=f"{nch} chunks on {nslices} slices", items=n_items)
    entry = {}
    for variant, lib, run_lib in (
            ("onehot_write", "torch.index_select(x, 0, rows)",
             lambda: torch.index_select(x, 0, rows)),
            ("onehot_reduce", "torch.nn.functional.embedding_bag(rows, x, "
             "mode='sum') (sums per chunk, not rounded, not repeated)",
             lambda: torch.nn.functional.embedding_bag(rows.view(nch, E), x,
                                                       mode="sum"))):
        # each call's output dropped before the next (a write's is 10.5
        # GB), so that the caching allocator can reuse one block; its
        # retries (cached blocks freed for a new device allocation) counted
        held = torch.cuda.memory_allocated() / 2 ** 30
        retries = torch.cuda.memory_stats().get("num_alloc_retries", 0)
        p1, k1, k2, p2, _, _ = in_turns(
            dropped(lambda v=variant: slice_gather_reference(fs, cols, x, R,
                                                             v)),
            dropped(lambda v=variant: slice_gather_cuda(fs, cols, x, R, v)),
            1, 5)
        retries = (torch.cuda.memory_stats().get("num_alloc_retries", 0)
                   - retries)
        lib_ms, _ = library_timed(lib, run_lib, 5)
        out_b = nch * (E if variant == "onehot_write" else 8) * K * 2
        ms = (k1 + k2) / 2
        per_chunk = nbytes(fs, cols) + nch * R * K * 2 + out_b
        entry[variant] = _probe_entry(
            ms, (p1 + p2) / 2, lib_ms, lib,
            nbytes(fs, cols) + distinct * K * 2 + out_b,
            0 if variant == "onehot_write" else nch * E * K, errs[variant],
            ns_per_edge=ms * 1e6 / (nch * E),
            library_ns_per_edge=(None if lib_ms is None
                                 else lib_ms * 1e6 / (nch * E)),
            distinct_rows=distinct,
            per_chunk_slice_bound_ms=per_chunk / HBM_BYTES_PER_S * 1e3,
            allocated_gb_before_turns=held, alloc_retries_in_turns=retries)
        torch.cuda.empty_cache()
    # every chunk on one slice
    one_ms, _ = timed(lambda: slice_gather_cuda(one, cols, x, R,
                                                "onehot_reduce"), 5)
    entry["onehot_reduce"].update(
        plan_ms=plan_ms, items=n_items, item_chunks=ITEM_CHUNKS,
        one_slice_ms=one_ms)
    # the probe's own yardstick: random rows of a 64 MB source (over L2)
    src = x[: (64 << 20) // (K * 2)]
    g = torch.Generator(device=dev).manual_seed(9)
    gcols = torch.randint(0, src.shape[0], (nch * E,), generator=g,
                          device=dev)
    ms64, _ = library_timed("index_select 64 MB",
                            lambda: torch.index_select(src, 0, gcols), 5)
    bag64, _ = library_timed(
        "embedding_bag 64 MB", lambda: torch.nn.functional.embedding_bag(
            gcols.view(nch, E), src, mode="sum"), 5)
    for v, val in (("index_select_64MB", ms64), ("embedding_bag_64MB",
                                                   bag64)):
        entry["onehot_write"][f"{v}_ns_per_edge"] = (
            None if val is None else val * 1e6 / (nch * E))
    for v, e in entry.items():
        print(f"phase 11e slice_gather {v}: kernel {e['ms']:.4f} ms "
              f"({e['ns_per_edge']:.4f} ns/edge), plain {e['plain_ms']:.3f}, "
              f"library {e['library_ms']} ({e['library_ns_per_edge']} "
              f"ns/edge), bound {e['bound_ms']:.4f} ({distinct} distinct x "
              f"rows), per-chunk-slice bound "
              f"{e['per_chunk_slice_bound_ms']:.4f}; "
              f"{e['alloc_retries_in_turns']} allocator retries in the turns, "
              f"{e['allocated_gb_before_turns']:.2f} GB held before {card}",
              flush=True)
    print(f"phase 11e slice_reduce plan {c1:.4f} / {c2:.4f} ms (its torch "
          f"reference {r1:.4f} / {r2:.4f}, equal; {n_items} items of at most "
          f"{ITEM_CHUNKS} chunks); all {nch} chunks on one slice "
          f"{one_ms:.4f} ms {card}", flush=True)
    w = entry["onehot_write"]
    print(f"phase 11e from a 64 MB source: index_select "
          f"{w['index_select_64MB_ns_per_edge']} ns/edge, embedding_bag "
          f"{w['embedding_bag_64MB_ns_per_edge']} ns/edge {card}",
          flush=True)
    return entry, plan_entry


def phase11_probes(gen, dev, card):
    run, counts = phase11a_probe_path(dev)
    scale2, chunk, srm_err = phase11_bisect(gen, dev, card, run["bisect"])
    colsum, staged, span_plan = phase11_dma_issue(gen, dev, card,
                                                  run["dma"])
    del run["dma"]
    band, k4 = phase11_band(gen, dev, card, run["band"])
    del run["band"]
    torch.cuda.empty_cache()
    sl, slice_plan = phase11_slice(gen, dev, card, run.pop("slice"))
    torch.cuda.empty_cache()
    return {"counts": counts, "scale2": scale2, "chunk_sum": chunk,
            "span_plan": span_plan, "span_colsum": colsum,
            "span_colsum_staged": staged, "slice_plan": slice_plan,
            "band_ablate": band, "k4": k4,
            "slice_gather": sl, "segment_rows_matmul_max_abs_err": srm_err}


def probe_kernels(probes):
    """The kernels line's entries of the probe kernels (phase 11): P1-P5,
    P3 as the piece path and its staged form, P5 as write and reduce."""
    src = "paddle_sparse_tpu_torch/csrc/probes.cu"
    n = probes["counts"]
    band = probes["band_ablate"]
    sl = probes["slice_gather"]
    return [
        {"name": "scale2", "route": "cuda", "source": src,
         "replaces": "experiments/bisect_pallas.py:26",
         "launches": n["scale2"], "launches_by_path": {"probes": n["scale2"]},
         **probes["scale2"]},
        {"name": "chunk_sum", "route": "cuda", "source": src,
         "replaces": "experiments/bisect_pallas.py:86",
         "launches": n["chunk_sum"],
         "launches_by_path": {"probes": n["chunk_sum"]},
         **probes["chunk_sum"]},
        {"name": "span_plan", "route": "cuda", "source": src,
         "replaces": "experiments/r4_dma_issue.py:77",
         "source_note": "span_colsum's piece plan: CUB radix sort and "
                        "prefix sums, three small kernels; plain version "
                        "span_pieces_reference (torch ops)",
         "launches": n["span_plan"],
         "launches_by_path": {"probes": n["span_plan"]},
         **probes["span_plan"]},
        {"name": "span_colsum", "route": "cuda", "source": src,
         "replaces": "experiments/r4_dma_issue.py:77",
         "source_note": "piece_colsum + step_colsum, one launch call: each "
                        "covered row once (r4_dma_issue.run)",
         "launches": n["span_colsum"],
         "launches_by_path": {"probes": n["span_colsum"]},
         **probes["span_colsum"]},
        {"name": "span_colsum_staged", "route": "cuda", "source": src,
         "replaces": "experiments/r4_dma_issue.py:77",
         "source_note": "the probe's own schedule, one CTA per step; "
                        "band_ablate nosel's chunk column sums",
         "launches": n["span_colsum_staged"],
         "launches_by_path": {"probes": n["span_colsum_staged"]},
         **probes["span_colsum_staged"]},
        {"name": "band_ablate", "route": "cuda", "source": src,
         "replaces": "experiments/r4_band_cost.py:131",
         "replaces_note": "k_nodot, k_nosel, k_empty; k_full and k_untrans "
                          "are K4's function, on band_reduce_call "
                          "(spmm_spans)",
         "source_note": "nodot redesigned (band_nodot_kernel): each tile's "
                        "count from one round of loads, one warp a tile and "
                        "a lane a visit, then an even fill of the band, "
                        "equal contiguous shares, 4 CTAs an SM, 16-byte "
                        "streaming stores; nosel and empty walk each tile's "
                        "visits, one CTA per (tile, 64 columns)",
         "launches": n["band_ablate"],
         "launches_by_path": {"probes": n["band_ablate"]},
         "at": "nosel at r4_band_cost.py's sizes (S=19, BAND=28,672, E=512, "
               "K=256 bf16); the other modes below",
         **band["nosel"], "modes": band,
         "k4_full_ms": probes["k4"]["full"],
         "k4_untrans_ms": probes["k4"]["untrans"]},
        {"name": "slice_gather", "route": "cuda", "source": src,
         "replaces": "experiments/r5_vmem_expand.py:85",
         "launches": n["slice_gather"] - n["slice_reduce"],
         "launches_by_path": {"probes": n["slice_gather"]
                              - n["slice_reduce"]},
         "at": f"onehot_write, NCH={PROBE_SLICE_CHUNKS} chunks of 2,048 "
               f"edges, R=512, K=256 bf16",
         **sl["onehot_write"]},
        {"name": "slice_plan", "route": "cuda", "source": src,
         "replaces": "experiments/r5_vmem_expand.py:85",
         "source_note": "slice_reduce's item plan: CUB radix sort and a "
                        "prefix sum, two small kernels; plain version "
                        "slice_items_reference (torch ops)",
         "launches": n["slice_plan"],
         "launches_by_path": {"probes": n["slice_plan"]},
         **probes["slice_plan"]},
        {"name": "slice_reduce", "route": "cuda", "source": src,
         "replaces": "experiments/r5_vmem_expand.py:85",
         "source_note": "onehot_reduce: each chunk's row counts times its "
                        "slice, a slice loaded once per item",
         "launches": n["slice_reduce"],
         "launches_by_path": {"probes": n["slice_reduce"]},
         "at": f"onehot_reduce, NCH={PROBE_SLICE_CHUNKS} chunks of 2,048 "
               f"edges, R=512, K=256 bf16",
         **sl["onehot_reduce"]}]


# ---- phase 12: parallel/ at world size 1 on NCCL ----------------------------

PARALLEL_REL = 1e-6      # sharded against unsharded: at most 1e-6 relative
# one input-gradient penalty step of phase 5's GCN (3 layers, d value on, x
# a leaf): forward K1 3; d CE / d x under create_graph, the fused CSC pass
# a layer (d value and d x, as without create_graph); the backward through
# both: the fused pass for each layer's forward SpMM, and along each fused
# pass's d x K2 (its d value) and K1 over the CSR (its d g); no fused pass's
# d value is differentiated again, so no K1 for it
PENALTY_LAUNCHES = {"spmm_csr": 6, "sddmm_csr": 3, "spmm_sddmm_csc": 6}

# the launches of each block of the dry run on one rank, from the dispatch
# of _SpmmSum (ops/spmm.py) and _PackedSpmm (ops/spmm_seg2.py): a GCN step
# whose adjacency values need no grad runs K1 forward in both layers and
# over the CSC view for layer 1's d x (layer 0 reads the features, no d x);
# with d value, layer 0 runs K2 alone and layer 1 the fused CSC backward.
# The seg2 steps add one spans forward (the check against the all-gather
# SpMM) and, with d value, the span SDDMM for layer 0 and the fused span
# backward for layer 1. The interchanges run K1 once each (all-gather, ring
# and bucketed ring of one step, halo); A @ A runs K5 once.
DRYRUN_LAUNCHES = {
    "gcn_step": {"spmm_csr": 3},
    "gcn_step_d_value": {"spmm_csr": 2, "sddmm_csr": 1, "spmm_sddmm_csc": 1},
    "interchanges": {"spmm_csr": 4},
    "grid_2d": {"spmm_csr": 1},
    "seg2_step": {"spmm_spans": 4},
    "seg2_step_d_value": {"spmm_spans": 3, "sddmm_spans": 1,
                          "spmm_sddmm_spans": 1},
    "seg2_halo_step": {"spmm_spans": 4},
    "seg2_halo_step_d_value": {"spmm_spans": 3, "sddmm_spans": 1,
                               "spmm_sddmm_spans": 1},
    "spgemm": {"segcompact": 1},
}


def phase12a_dryrun(dev, mesh):
    """The dry run's blocks at its toy size on one rank, each with its
    launch counts set to 0 just before and read just after, held to
    ``DRYRUN_LAUNCHES`` exactly; the steps also with d value."""
    from paddle_sparse_tpu_torch.entry import DryRun, dryrun_nodes
    run = DryRun(mesh, dev, dryrun_nodes(1))
    blocks = (("gcn_step", run.gcn_step),
              ("gcn_step_d_value", lambda: run.gcn_step(value_grad=True)),
              ("interchanges", run.interchanges), ("grid_2d", run.grid_2d),
              ("seg2_step", run.seg2_step),
              ("seg2_step_d_value", lambda: run.seg2_step(value_grad=True)),
              ("seg2_halo_step", run.seg2_halo_step),
              ("seg2_halo_step_d_value",
               lambda: run.seg2_halo_step(value_grad=True)),
              ("spgemm", run.spgemm))
    launches = {}
    for name, fn in blocks:
        _zero_launch_counts()
        res = fn()
        torch.cuda.synchronize()
        counts = _launch_counts()
        want = {k: DRYRUN_LAUNCHES[name].get(k, 0) for k in counts}
        print(f"phase 12a {name}: launches "
              + ", ".join(f"{k} {v}" for k, v in counts.items() if v)
              + f" {'ok' if counts == want else 'FAIL'}", flush=True)
        check(counts == want, f"dry run block {name}: expected launches "
                              f"{DRYRUN_LAUNCHES[name]}, counted {counts}")
        if isinstance(res, dict) and "loss" in res:
            check(bool(torch.isfinite(res["loss"])),
                  f"dry run block {name}: loss not finite")
        launches[f"parallel_toy_{name}"] = counts
    return launches


def _rel_diff(got, ref):
    """Max abs difference and that difference over max |ref|."""
    err = float((got.double() - ref.double()).abs().max())
    return err, err / max(float(ref.double().abs().max()), 1e-30)


def _same_step(name, got, ref):
    """Loss, grads, parameters after the step and d value of a sharded step
    against the unsharded one: each within ``PARALLEL_REL`` of its max
    |ref|; prints the max abs differences."""
    pairs = [("loss", got["loss"], ref["loss"])]
    pairs += [(f"grad {k}", got["grads"][k], ref["grads"][k])
              for k in ref["grads"]]
    pairs += [(f"param {k}", got["params"][k], ref["params"][k])
              for k in ref["params"]]
    pairs.append(("d value", got["d_value"], ref["d_value"]))
    worst, bitwise = 0.0, True
    for what, a, b in pairs:
        err, rel = _rel_diff(a, b)
        bitwise &= bool(torch.equal(a, b))
        worst = max(worst, rel)
        check(rel <= PARALLEL_REL, f"{name}: {what} differs from the "
                                   f"unsharded step by {err:.3e} ({rel:.3e} "
                                   f"of its max)")
    print(f"phase 12b {name} vs unsharded: loss {float(got['loss']):.8f} / "
          f"{float(ref['loss']):.8f}; {len(pairs)} tensors (loss, grads, "
          f"params after SGD, d value), worst max abs diff over max |ref| "
          f"{worst:.3e} (tolerance {PARALLEL_REL:g}); bit for bit "
          f"{bitwise}", flush=True)
    return worst, bitwise


def penalty_lambda(model, adj, x, y):
    """The penalty weight that makes ``lam * |d CE / d x|^2`` a tenth of CE
    at this state (the gradient of a mean over millions of nodes is tiny,
    so a fixed weight would leave the penalty out of the step; at a weight
    that makes it equal to CE, SGD at lr 0.1 diverges within three steps)."""
    x = x.detach().requires_grad_()
    logp = torch.log_softmax(model(adj, x), dim=-1)
    ce = -logp.gather(1, y[:, None]).mean()
    gx, = torch.autograd.grad(ce, x)
    return 0.1 * float(ce.detach()) / float(gx.double().square().sum())


def penalty_step(model, adj, x, y, num_nodes, lam, group=None):
    """One SGD step (lr LR) of the input-gradient penalty ``CE + lam * |d
    CE / d x|^2``, CE the NLL summed over ``adj``'s rows over
    ``num_nodes``: ``d CE / d x`` under ``create_graph`` (a sharded ``adj``
    all-gathers, so its backward sums the ranks' shares), then the
    backward of the sum through it (the double backward of every SpMM);
    with a ``group``, loss and parameter grads summed over its ranks.
    Returns ``{"loss", "penalty", "grads", "params", "d_value"}``."""
    import torch.distributed as dist
    model.zero_grad(set_to_none=True)
    x = x.detach().requires_grad_()
    logp = torch.log_softmax(model(adj, x), dim=-1)
    ce = -logp.gather(1, y[:, None]).sum() / num_nodes
    gx, = torch.autograd.grad(ce, x, create_graph=True)
    pen = lam * gx.square().sum()
    (ce + pen).backward()
    parts = torch.stack([ce.detach(), pen.detach()])
    with torch.no_grad():
        for prm in model.parameters():
            if group is not None:
                dist.all_reduce(prm.grad, group=group)
            prm -= LR * prm.grad
    if group is not None:
        dist.all_reduce(parts, group=group)
    return {"loss": parts.sum(), "penalty": parts[1],
            "grads": {k: p.grad for k, p in model.named_parameters()},
            "params": model.state_dict()}


def phase12b_gcn(dev, card, mesh, step_ms_phase5):
    """Phase 5's GCN train step, row-sharded at world size 1 through
    ``RowShardedAdjacency`` and ``sharded_train_step``, against phase 5's
    unsharded step on the same inputs: shards built on the card, 1 warm-up
    (the compared step) + 3 timed steps, exact launches, peak memory."""
    from paddle_sparse_tpu_torch import (GCN, SparseTensor, gcn_normalize,
                                         init_gcn, train_step)
    from paddle_sparse_tpu_torch.entry import sharded_train_step
    from paddle_sparse_tpu_torch.parallel import (RowShardedAdjacency,
                                                  shard_padded_coo,
                                                  shard_rows)
    from paddle_sparse_tpu_torch.parallel.mesh import axis_rank
    from paddle_sparse_tpu_torch.parallel.spmm import (
        block_coo, device_put_sharded_matrix)
    n = PRODUCTS_NODES
    group, rank, world = axis_rank(mesh)
    raw, x = products_graph(dev)
    adj = gcn_normalize(raw)
    del raw
    y = torch.randint(0, GCN_DIMS[2], (n,), generator=torch.Generator(
        device=dev).manual_seed(5), device=dev)
    state0 = init_gcn(torch.Generator().manual_seed(0), *GCN_DIMS,
                      num_layers=3, device=dev).state_dict()

    def model():
        m = GCN(*GCN_DIMS, num_layers=3, device=dev)
        m.load_state_dict(state0)
        return m

    # phase 5's step, unsharded, from the same state: the reference
    ref_model = model()
    adj.value.requires_grad_()
    loss = train_step(ref_model, adj, x, y, LR)
    ref = {"loss": loss, "params": {k: v.clone() for k, v in
                                    ref_model.state_dict().items()},
           "grads": {k: p.grad for k, p in ref_model.named_parameters()},
           "d_value": adj.value.grad}
    del ref_model
    # the input-gradient penalty step once, unsharded, from the same state
    lam = penalty_lambda(model(), adj, x, y)
    adj.value.grad = None
    pen_ref = penalty_step(model(), adj, x, y, n, lam)
    pen_ref = {"loss": pen_ref["loss"], "penalty": pen_ref["penalty"],
               "grads": {k: v.clone() for k, v in pen_ref["grads"].items()},
               "params": {k: v.clone() for k, v in pen_ref["params"].items()},
               "d_value": adj.value.grad}
    adj.value.grad = None
    torch.cuda.empty_cache()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eager = SparseTensor(row=adj.row, col=adj.col, value=adj.value.detach(),
                         sparse_sizes=adj.shape, is_sorted=True,
                         trust_data=True)
    mat = shard_padded_coo(eager, world)
    block = block_coo(device_put_sharded_matrix(mat, rank, dev))
    # shard_padded_coo left 0 at any padding: the values are the leaf
    leaf = block.value.detach().requires_grad_()
    sharded = RowShardedAdjacency(dataclasses.replace(block, value=leaf),
                                  group)
    x_local, y_local = (shard_rows(x, world, rank),
                        shard_rows(y, world, rank))
    torch.cuda.synchronize()
    shard_s = time.perf_counter() - t0
    del eager, adj

    m = model()
    torch.cuda.reset_peak_memory_stats()
    _zero_launch_counts()
    times = []
    for i in range(4):
        leaf.grad = None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = sharded_train_step(m, sharded, x_local, y_local, n, LR, group)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            first = {"loss": res["loss"].clone(),
                     "grads": {k: v.clone() for k, v in res["grads"].items()},
                     "params": {k: v.clone()
                                for k, v in res["params"].items()},
                     "d_value": leaf.grad.clone()}
    counts = _launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_ms, med_ms = sum(times[1:]) / 3, sorted(times[1:])[1]
    print(f"phase 12b row-sharded GCN step (world {world}, NCCL; "
          f"RowShardedAdjacency + GCN, {mat.row.shape[1]} slots a shard, "
          f"built on the card in {shard_s:.3f} s) ms: warm-up "
          f"{times[0]:.3f}, timed {' '.join(f'{t:.3f}' for t in times[1:])} "
          f"(mean {step_ms:.3f}, median {med_ms:.3f}) beside phase 5's "
          f"unsharded step "
          f"{step_ms_phase5:.3f} ms; peak mem {peak_gb:.2f} GB {card}",
          flush=True)
    want = {k: 0 for k in counts}
    want.update(spmm_csr=3 * 4, sddmm_csr=1 * 4, spmm_sddmm_csc=2 * 4)
    print("phase 12b row-sharded GCN launches in 4 steps: "
          + ", ".join(f"{k} {v}" for k, v in counts.items() if v), flush=True)
    check(counts == want, f"row-sharded GCN step: expected launches {want}, "
                          f"counted {counts}")
    worst, bitwise = _same_step("row-sharded GCN step", first, ref)
    # the penalty step once through the all-gathers (their backward and
    # its backward at world size 1), against the unsharded penalty step
    m = model()
    leaf.grad = None
    _zero_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pen = penalty_step(m, sharded, x_local, y_local, n, lam, group)
    torch.cuda.synchronize()
    pen_ms = (time.perf_counter() - t0) * 1e3
    pen["d_value"] = leaf.grad
    pen_counts = _launch_counts()
    print(f"phase 12b row-sharded penalty step (lam {lam:.6e}, penalty "
          f"{float(pen['penalty']):.8f} of loss {float(pen['loss']):.8f}): "
          f"{pen_ms:.3f} ms, launches "
          + ", ".join(f"{k} {v}" for k, v in pen_counts.items() if v),
          flush=True)
    check(pen_counts == {**{k: 0 for k in pen_counts}, **PENALTY_LAUNCHES},
          f"row-sharded penalty step: expected launches {PENALTY_LAUNCHES}, "
          f"counted {pen_counts}")
    pen_worst, pen_bitwise = _same_step("row-sharded penalty step", pen,
                                        pen_ref)
    check(pen_bitwise, "the row-sharded penalty step at world size 1 is not "
                       "bit for bit the unsharded one")
    return mat, {"step_ms": step_ms, "median_ms": med_ms,
                 "warmup_ms": times[0],
                 "phase5_step_ms": step_ms_phase5, "shard_s": shard_s,
                 "peak_gb": peak_gb, "worst_rel_diff": worst,
                 "bit_for_bit": bitwise, "launches": counts,
                 "penalty": {"lam": lam, "ms": pen_ms,
                             "loss": float(pen["loss"]),
                             "worst_rel_diff": pen_worst,
                             "bit_for_bit": pen_bitwise,
                             "launches": pen_counts}}


def phase12b_seg2(dev, card, mesh, mat, seg2_fwd_bwd_ms):
    """One forward+backward of ``spmm_seg2_allgather`` at K=256 f32 on the
    row-sharded graph, against ``spmm_seg2`` on the same plan unsharded: the
    plan built on the card, 1 warm-up (the compared call) + 3 timed, exact
    launches, beside phase 7c's seg2 f32 forward+backward."""
    from paddle_sparse_tpu_torch import spmm_seg2
    from paddle_sparse_tpu_torch.parallel import (device_put_sharded_seg2,
                                                  make_seg2_plan_sharded,
                                                  pack_values_sharded,
                                                  shard_rows,
                                                  spmm_seg2_allgather)
    from paddle_sparse_tpu_torch.parallel.mesh import axis_rank
    _, rank, world = axis_rank(mesh)
    n, K = PRODUCTS_NODES, 256
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sh = make_seg2_plan_sharded(mat, feat_dim=K, ranks=[rank])
    shard = device_put_sharded_seg2(sh, rank, dev)
    packed = pack_values_sharded(sh, mat.value)[rank]
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    gen = torch.Generator(device=dev).manual_seed(12)
    x = torch.randn(n, K, generator=gen, device=dev)
    gw = torch.randn(n, K, generator=gen, device=dev)
    nnz = shard.structure.col_f.numel()

    def run(fn):
        pv = packed.detach().clone().requires_grad_()
        xx = shard_rows(x, world, rank).detach().requires_grad_()
        out = fn(pv, xx)
        out.backward(gw)
        return {"out": out.detach(), "d_x": xx.grad, "d_value": pv.grad}

    ref = run(lambda pv, xx: spmm_seg2(shard.plan, shard.structure,
                                       pv[:nnz], xx))
    torch.cuda.reset_peak_memory_stats()
    _zero_launch_counts()
    times = []
    for i in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = run(lambda pv, xx: spmm_seg2_allgather(mesh, shard, pv, xx))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            first = got
        del got
    counts = _launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    fb_ms, med_ms = sum(times[1:]) / 3, sorted(times[1:])[1]
    print(f"phase 12b seg2 all-gather K={K} f32 (world {world}; plan S="
          f"{shard.plan.S} SR={shard.plan.SR}, built on the card in "
          f"{plan_s:.3f} s) forward+backward ms: warm-up {times[0]:.3f}, "
          f"timed {' '.join(f'{t:.3f}' for t in times[1:])} (mean "
          f"{fb_ms:.3f}, median {med_ms:.3f}) beside phase 7c's seg2 uniform "
          f"f32 "
          f"{seg2_fwd_bwd_ms:.3f} ms (its graph: {BENCH_NNZ} nnz); peak mem "
          f"{peak_gb:.2f} GB {card}", flush=True)
    want = {k: 0 for k in counts}
    want.update(spmm_spans=4, spmm_sddmm_spans=4)
    print("phase 12b seg2 all-gather launches in 4 forward+backwards: "
          + ", ".join(f"{k} {v}" for k, v in counts.items() if v), flush=True)
    check(counts == want, f"seg2 all-gather: expected launches {want}, "
                          f"counted {counts}")
    worst, bitwise = 0.0, True
    for what in ("out", "d_x", "d_value"):
        err, rel = _rel_diff(first[what], ref[what])
        worst = max(worst, rel)
        bitwise &= bool(torch.equal(first[what], ref[what]))
        check(rel <= PARALLEL_REL, f"seg2 all-gather {what} differs from "
                                   f"the unsharded call by {err:.3e}")
    print(f"phase 12b seg2 all-gather vs unsharded spmm_seg2: out, d x, d "
          f"value worst max abs diff over max |ref| {worst:.3e} (tolerance "
          f"{PARALLEL_REL:g}); bit for bit {bitwise}", flush=True)
    return {"fwd_bwd_ms": fb_ms, "median_ms": med_ms, "warmup_ms": times[0],
            "phase7c_fwd_bwd_ms": seg2_fwd_bwd_ms, "plan_s": plan_s,
            "peak_gb": peak_gb, "worst_rel_diff": worst,
            "bit_for_bit": bitwise, "launches": counts}


def phase12_parallel(dev, card, step_ms_phase5, seg2_fwd_bwd_ms):
    """``parallel/`` at world size 1: an NCCL process group of one rank
    from a file store, a 1-D mesh; 12a the dry run's blocks with exact
    launches, 12b the row-sharded GCN step and seg2 SpMM at full width
    against their unsharded runs. One card runs NCCL at world size 1
    only."""
    import os
    import tempfile

    import torch.distributed as dist
    from paddle_sparse_tpu_torch.parallel import make_mesh
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(
            os.path.join(tmp, "store"), 1), rank=0, world_size=1)
        try:
            mesh = make_mesh(1)
            launches = phase12a_dryrun(dev, mesh)
            torch.cuda.empty_cache()
            mat, gcn = phase12b_gcn(dev, card, mesh, step_ms_phase5)
            torch.cuda.empty_cache()
            seg2 = phase12b_seg2(dev, card, mesh, mat, seg2_fwd_bwd_ms)
            del mat
        finally:
            dist.destroy_process_group()
    torch.cuda.empty_cache()
    launches["parallel_gcn_step_full"] = gcn["launches"]
    launches["parallel_penalty_step_full"] = gcn["penalty"]["launches"]
    launches["parallel_seg2_allgather_full"] = seg2["launches"]
    return {"launches": launches, "gcn": gcn, "seg2": seg2}


# ---- phase 13: every float dtype of the JAX package on the card -------------

F16_HALF_ULP = 2.0 ** -11
# f16's subnormal spacing is 2**-24: half of it bounds a tiny output's rounding
F16_TINY = 2.0 ** -25
# f64 sums taken in another order: within this share of each entry's sum of
# |terms| (n * 2**-53 is 1.2e-10 at n = 1.1M in the worst case, ~1e-13
# typical)
F64_REL = 1e-12
PHASE13_K = (1, 3, 47, 64, 100, 256, 300)


def _close_in(got, ref, scale):
    """Max abs error and whether ``got`` is within its dtype's bound of the
    f64 ``ref``: f64 outputs within F64_REL of each entry's sum of |terms|
    (``scale``); others within GRAD_REL of it (an f32 sum) plus half an
    ulp of the output's dtype (one rounding on the store)."""
    ref = ref.double()
    err = (got.double() - ref).abs()
    if got.dtype == torch.float64:
        bound = F64_REL * scale
    else:
        out_rel = {torch.float16: F16_HALF_ULP,
                   torch.bfloat16: BF16_HALF_ULP}.get(got.dtype, 0.0)
        tiny = F16_TINY if got.dtype == torch.float16 else 0.0
        bound = GRAD_REL * scale + out_rel * ref.abs() + tiny
    ok = bool((err <= bound + 1e-300).all())
    return (float(err.max()) if err.numel() else 0.0), ok


def dtype_graphs(gen, dev):
    """Phase 2c's graph (3,000 x 2,000, up to 40 edges a row, empty rows
    and columns, 1,000 pads whose cols are poisoned with 2**30) and the same
    with a hub row (row 5) and a hub column (column 7) of 1,100,000 edges
    each, which the kernels cut into pieces; the hub column's rows leave
    phase 2's empty rows empty."""
    from paddle_sparse_tpu_torch import PaddedCOO
    M, N, H = 3000, 2000, 1_100_000
    rowptr, col, value = random_csr(gen, dev, M, N, 40)
    row = torch.repeat_interleave(torch.arange(M, device=dev),
                                  (rowptr[1:] - rowptr[:-1]).long())
    col = torch.where(col % 97 == 3, 5, col)          # empty columns
    hub_cols = torch.randint(0, N, (H,), generator=gen, device=dev,
                             dtype=torch.int32)
    hub_rows = torch.randint(1, M - 1, (H,), generator=gen, device=dev)
    hub_rows = torch.where(hub_rows == M // 3, 1, hub_rows)   # keep empty
    graphs = {}
    for name, (r, c, v) in {
            "unsplit": (row, col, value),
            "hub row and column of 1.1M edges": (
                torch.cat([row, torch.full((H,), 5, device=dev), hub_rows]),
                torch.cat([col, hub_cols, torch.full_like(hub_cols, 7)]),
                torch.cat([value, torch.rand(2 * H, generator=gen,
                                             device=dev) * 2 - 1]))}.items():
        order = torch.argsort(r, stable=True)
        adj = PaddedCOO.from_arrays(r[order], c[order], v[order], (M, N),
                                    capacity=r.numel() + 1000, device=dev)
        graphs[name] = dataclasses.replace(adj, col=torch.where(
            adj.valid_mask(), adj.col, torch.full_like(adj.col, 1 << 30)))
    return graphs


def _tag(*dts):
    return "/".join("None" if d is None else str(d).replace("torch.", "")
                    for d in dts)


def phase13a_kernels(gen, dev):
    """K1, K2 and the fused CSC backward in f16, f64 and the mixed pairs,
    against their plain versions run in f64 on the card, over K in
    PHASE13_K (the odd K take the scalar path), empty rows and columns,
    poisoned padding, and a hub row and column of 1.1M edges in pieces
    (K 3 and 256 there); each call one launch (the counters read before and
    after). The fused kernel also bit for bit against the pair it replaces
    (K2 + K1 over the CSC view). Returns the max abs errors by kernel."""
    from paddle_sparse_tpu_torch import (sddmm_csr_cuda, sddmm_csr_reference,
                                         spmm_csr_cuda, spmm_csr_reference,
                                         spmm_sddmm_csc_cuda,
                                         spmm_sddmm_csc_reference)
    f16, bf16 = torch.float16, torch.bfloat16
    f32, f64 = torch.float32, torch.float64
    k1_pairs = ((f16, f16), (f16, f32), (f32, f16), (f16, bf16), (bf16, f16),
                (f16, None), (f64, f64), (f64, f32), (f32, f64), (f16, f64),
                (bf16, f64), (f64, None))             # (x, value)
    k2_sets = ((f16, f16, f16), (f16, f16, f32), (f32, f16, f32),
               (f16, f32, f32), (f64, f64, f64), (f64, f32, f64),
               (f64, f16, f64), (f64, bf16, f64))     # (g, x, d value)
    fused_sets = ((f16, f16, f16), (f32, f16, f32), (f16, f32, f32),
                  (bf16, f16, f32), (f16, bf16, f32), (f64, f64, f64),
                  (f64, f32, f64), (f32, f64, f64),
                  (f64, f16, f64))                    # (value, x, g)
    errs = {"spmm_csr": 0.0, "sddmm_csr": 0.0, "spmm_sddmm_csc": 0.0}

    def one_launch(name, fn):
        before = _launch_counts()
        out = fn()
        torch.cuda.synchronize()
        after = _launch_counts()
        moved = {k: after[k] - before[k] for k in after
                 if after[k] != before[k] and k != "fold_pieces"}
        check(moved == {name: 1}, f"expected one {name} launch, counted "
                                  f"{moved}")
        return out

    for gname, adj in dtype_graphs(gen, dev).items():
        s = adj.structure()
        rowptr, col, nnz = adj.rowptr(), adj.col, adj.nnz
        M, N = adj.shape
        Ks = PHASE13_K if gname == "unsplit" else (3, 256)
        check((s.row_split is None) == (gname == "unsplit")
              and (s.col_split is None) == (gname == "unsplit"),
              f"{gname}: split tables {s.row_split is None} "
              f"{s.col_split is None}")
        for xdt, vdt in k1_pairs:
            e = []
            for K in Ks:
                x = torch.randn(N, K, generator=gen, device=dev).to(xdt)
                v = None if vdt is None else adj.value.to(vdt)
                out = one_launch("spmm_csr", lambda: spmm_csr_cuda(
                    rowptr, col, v, x, split=s.row_split))
                want = x.dtype if v is None else torch.promote_types(
                    v.dtype, x.dtype)
                check(out.dtype == want, f"K1 {_tag(xdt, vdt)} wrote "
                                         f"{out.dtype}, not {want}")
                ref, scale = (spmm_csr_reference(
                    rowptr, col, None if v is None else f(v.double()),
                    f(x.double())) for f in (lambda t: t, torch.abs))
                err, ok = _close_in(out, ref, scale)
                check(ok, f"{gname}: K1 x/value {_tag(xdt, vdt)} K={K} vs "
                          f"plain f64 ({err:.3e})")
                check(not out[[0, M // 3, M - 1]].any(), "empty rows not 0")
                e.append(err)
            errs["spmm_csr"] = max(errs["spmm_csr"], *e)
            print(f"phase 13a {gname}: spmm_csr x/value {_tag(xdt, vdt)} "
                  f"-> {out.dtype}, K {' '.join(map(str, Ks))}: one launch "
                  f"each, vs plain f64 max_abs_err {max(e):.3e} ok",
                  flush=True)
        for gdt, xdt, odt in k2_sets:
            e = []
            for K in Ks:
                g = torch.randn(M, K, generator=gen, device=dev).to(gdt)
                x = torch.randn(N, K, generator=gen, device=dev).to(xdt)
                out = one_launch("sddmm_csr", lambda: sddmm_csr_cuda(
                    rowptr, col, g, x, out_dtype=odt, split=s.row_split))
                check(out.dtype == odt and not out[nnz:].any(),
                      f"K2 {_tag(gdt, xdt, odt)}: dtype {out.dtype} or "
                      f"padding not 0")
                ref, scale = (sddmm_csr_reference(
                    rowptr, col[:nnz], f(g.double()), f(x.double()), f64)
                    for f in (lambda t: t, torch.abs))
                err, ok = _close_in(out[:nnz], ref, scale)
                check(ok, f"{gname}: K2 g/x/dv {_tag(gdt, xdt, odt)} K={K} "
                          f"vs plain f64 ({err:.3e})")
                e.append(err)
            errs["sddmm_csr"] = max(errs["sddmm_csr"], *e)
            print(f"phase 13a {gname}: sddmm_csr g/x/d value "
                  f"{_tag(gdt, xdt, odt)}, K {' '.join(map(str, Ks))}: one "
                  f"launch each, vs plain f64 max_abs_err {max(e):.3e} ok",
                  flush=True)
        for vdt, xdt, gdt in fused_sets:
            e = []
            for K in Ks:
                x = torch.randn(N, K, generator=gen, device=dev).to(xdt)
                g = torch.randn(M, K, generator=gen, device=dev).to(gdt)
                v = adj.value.to(vdt)
                got = one_launch("spmm_sddmm_csc", lambda: fused_kernel(
                    adj, v, g, x, vdt))
                pair = fused_pair(adj, v, g, x, vdt)
                dx_dt = torch.promote_types(vdt, gdt)
                check(got[0].dtype == dx_dt and got[1].dtype == vdt
                      and not got[1][nnz:].any(),
                      f"fused {_tag(vdt, xdt, gdt)}: dtypes "
                      f"{got[0].dtype}/{got[1].dtype} or padding not 0")
                for what, a, b in zip(("d x", "d value"), got, pair):
                    check(a.dtype == b.dtype and torch.equal(a, b),
                          f"{gname} fused {_tag(vdt, xdt, gdt)} K={K}: "
                          f"{what} differs from the pair's")
                ref, scale = (spmm_sddmm_csc_reference(
                    s.colptr, s.col_t, s.perm, f(v.double()), f(g.double()),
                    f(x.double()), f64, s.inv_perm)
                    for f in (lambda t: t, torch.abs))
                for i, out in enumerate(got):
                    err, ok = _close_in(out, ref[i], scale[i])
                    check(ok, f"{gname}: fused value/x/g "
                              f"{_tag(vdt, xdt, gdt)} K={K} "
                              f"{('d x', 'd value')[i]} vs plain f64 "
                              f"({err:.3e})")
                    e.append(err)
            errs["spmm_sddmm_csc"] = max(errs["spmm_sddmm_csc"], *e)
            print(f"phase 13a {gname}: spmm_sddmm_csc value/x/g "
                  f"{_tag(vdt, xdt, gdt)}, K {' '.join(map(str, Ks))}: one "
                  f"launch each, d x and d value equal to K2 + K1 over the "
                  f"CSC view bit for bit, vs plain f64 max_abs_err "
                  f"{max(e):.3e} ok", flush=True)
    return errs


def phase13a_public_path(gen, dev):
    """The user's call: ``PaddedCOO.spmm`` (the facade's ``A @ x`` runs it)
    with an f16 ``x`` and an f32 value launches K1 once and allocates no f32
    copy of ``x`` (the call's peak allocation stays below it); under
    autograd, f64 and f16 backward passes launch K1 once forward and the
    fused CSC backward once (no K2, no plain version), with d value in the
    value's dtype and d x in x's, against f64."""
    from paddle_sparse_tpu_torch import spmm_sddmm_csc_reference
    adj = dtype_graphs(gen, dev)["unsplit"]
    s = adj.structure()
    M, N = adj.shape
    x16 = torch.randn(N, 256, generator=gen, device=dev).half()
    adj.rowptr(), adj.row_split()                 # cached before the call
    torch.cuda.synchronize()
    _zero_launch_counts()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        out = adj.spmm(x16)
    torch.cuda.synchronize()
    extra = (torch.cuda.max_memory_allocated() - base
             - out.numel() * out.element_size())
    counts = _launch_counts()
    copy = x16.numel() * 4
    print(f"phase 13a f16 x @ f32 value (K=256): out {out.dtype}, launches "
          f"{ {k: v for k, v in counts.items() if v} }, {extra} B allocated "
          f"during the call besides the output (an f32 copy of x is "
          f"{copy} B)", flush=True)
    check(out.dtype == torch.float32 and counts["spmm_csr"] == 1
          and sum(counts.values()) == 1, f"f16 x: launches {counts}")
    check(extra < copy // 2, f"f16 x: {extra} B allocated besides the "
                             f"output; an f32 copy of x takes {copy}")
    rows = {}
    for dt in (torch.float64, torch.float16):
        v = adj.value.to(dt).requires_grad_()
        x = torch.randn(N, 64, generator=gen, device=dev).to(
            dt).requires_grad_()
        gw = torch.randn(M, 64, generator=gen, device=dev).to(dt)
        _zero_launch_counts()
        out = adj.with_value(v).spmm(x)
        (out * gw).sum().backward()
        torch.cuda.synchronize()
        counts = _launch_counts()
        check(counts["spmm_csr"] == 1 and counts["spmm_sddmm_csc"] == 1
              and counts["sddmm_csr"] == 0 and sum(counts.values()) == 2,
              f"{dt} A @ x forward + backward: launches {counts}")
        check(out.dtype == dt and v.grad.dtype == dt and x.grad.dtype == dt,
              f"{dt}: dtypes {out.dtype} {v.grad.dtype} {x.grad.dtype}")
        ref, scale = (spmm_sddmm_csc_reference(
            s.colptr, s.col_t, s.perm, f(adj.value.to(dt).double()),
            f(gw.double()), f(x.detach().double()), torch.float64,
            s.inv_perm) for f in (lambda t: t, torch.abs))
        err_x, ok_x = _close_in(x.grad, ref[0], scale[0])
        err_v, ok_v = _close_in(v.grad[:adj.nnz], ref[1][:adj.nnz],
                                scale[1][:adj.nnz])
        check(ok_x and ok_v, f"{dt} backward vs f64: d x {err_x:.3e}, "
                             f"d value {err_v:.3e}")
        rows[str(dt)] = counts
        print(f"phase 13a {dt} A @ x forward + backward (K=64): launches "
              f"spmm_csr 1, spmm_sddmm_csc 1, nothing else; d x "
              f"{x.grad.dtype} max_abs_err {err_x:.3e}, d value "
              f"{v.grad.dtype} max_abs_err {err_v:.3e} vs f64 ok",
              flush=True)
    return rows


def phase13a_segcompact(gen, dev):
    """K5 in every value dtype (f32, bf16, f16, f64, int32, int64) against
    its plain version in f64 (the ints exact): a flat (row, col)-sorted
    stream with a run of 1.1M elements across tiles and 1,000 pads, at
    D = 1 and D = 8 (the trailing-dim pass; also cut at out_capacity), an
    unsorted (K5 sorts) and a sorted grid, and a sorted grid wider than
    F_MAX (the stream kernel); structure, seg and count exact, each call
    one launch. A grid with trailing dims is refused. Returns the max abs
    error of the float runs."""
    from paddle_sparse_tpu_torch import (compact_runs_cuda,
                                         compact_runs_reference)
    dtypes = (torch.float32, torch.bfloat16, torch.float16, torch.float64,
              torch.int32, torch.int64)

    def values(shape, dt):
        if dt.is_floating_point:
            return torch.randn(shape, generator=gen, device=dev).to(dt)
        return torch.randint(-100, 101, shape, generator=gen, device=dev,
                             dtype=dt)

    worst = 0.0

    def compare(name, col, rows, val, shape, cap, **kw):
        nonlocal worst
        before = _launch_counts()["segcompact"]
        got = compact_runs_cuda(col, rows, val, shape, cap, seg=True, **kw)
        torch.cuda.synchronize()
        check(_launch_counts()["segcompact"] == before + 1,
              f"{name}: not one K5 launch")
        wide = torch.float64 if val.is_floating_point() else torch.int64
        ref = compact_runs_reference(col, rows, val.to(wide), shape, cap,
                                     seg=True, **kw)
        ok = (int(got.count) == int(ref.count)
              and torch.equal(got.row, ref.row)
              and torch.equal(got.col, ref.col)
              and torch.equal(got.seg, ref.seg)
              and got.value.dtype == val.dtype
              and got.value.shape == ref.value.shape)
        if val.is_floating_point():
            scale = compact_runs_reference(col, rows, val.double().abs(),
                                           shape, cap, **kw).value
            err = (got.value.double() - ref.value).abs()
            rel = 1e-6 if val.dtype != torch.float64 else F64_REL
            out_rel = {torch.float16: F16_HALF_ULP,
                       torch.bfloat16: BF16_HALF_ULP}.get(val.dtype, 0.0)
            ok = ok and bool((err <= rel * scale + out_rel * ref.value.abs()
                              + (F16_TINY if val.dtype == torch.float16
                                 else 0.0) + 1e-300).all())
            err = float(err.max()) if err.numel() else 0.0
            worst = max(worst, err)
        else:
            ok = ok and torch.equal(got.value, ref.value.to(val.dtype))
            err = 0.0
        print(f"phase 13a segcompact {name} {_tag(val.dtype)} "
              f"{tuple(val.shape)}: {int(ref.count)} runs, cap {cap}: one "
              f"launch, structure and seg exact, max_abs_err {err:.3e} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        check(ok, f"K5 {name} {val.dtype} {tuple(val.shape)} disagrees with "
                  f"plain f64")

    # the flat stream: keys sorted, a run of 1.1M equal keys, pads last
    M, N, L, pads = 50_000, 400, 2_000_000, 1000
    k = torch.randint(0, M * (N + 1), (L,), generator=gen, device=dev)
    k = k[(k % (N + 1)) < N]
    k = torch.cat([k, torch.full((1_100_000,), 777 * (N + 1) + 3,
                                 device=dev)]).sort().values
    k = torch.cat([k, torch.full((pads,), M * (N + 1) + N, device=dev)])
    fcol, frow = (k % (N + 1)).int(), (k // (N + 1)).int()
    runs = int(compact_runs_reference(fcol, frow, None, (M, N), 1).count)
    for dt in dtypes:
        for D in (1, 8):
            shape = (k.numel(),) if D == 1 else (k.numel(), D)
            val = values(shape, dt)
            val[-pads:] = 0
            compare(f"flat D={D}", fcol, frow, val, (M, N), runs + 5)
        compare("flat D=8, cut at out_capacity", fcol, frow,
                values((k.numel(), 8), dt), (M, N), runs // 2)
    # grids: unsorted (K5 sorts, F <= F_MAX), sorted, and wider than F_MAX
    for R, F, Ng, sort in ((20_000, 64, 40, False), (20_000, 64, 40, True),
                           (200, 1500, 300, True)):
        key = torch.randint(0, Ng, (R, F), generator=gen, device=dev,
                            dtype=torch.int32)
        key[:, -3:] = Ng                                  # pads
        if sort:
            key = key.sort(dim=1).values.contiguous()
        rows = torch.arange(R, dtype=torch.int32, device=dev)
        for dt in dtypes:
            val = values((R, F), dt)
            compare(f"grid ({R}, {F}) {'sorted' if sort else 'unsorted'}",
                    key, rows, val, (R, Ng), int((key < Ng).sum()),
                    rows_sorted=sort)
    refused = False
    try:
        compact_runs_cuda(key, rows, values((R, F, 2), torch.float32),
                          (R, Ng), 10)
    except ValueError:
        refused = True
    check(refused, "K5 took trailing dims on a grid")
    return worst


# H100 SXM FP64 outside the tensor cores (NVIDIA's data sheet), for the f64
# kernels' operation bound; f16 and bf16 are summed in f32 registers
F64_FLOPS_PER_S = 34e12
# the f16 step's fixed loss scale: torch.amp.GradScaler's default initial
# scale, so that grads of a mean over 2.4M nodes stay in f16's normal range
LOSS_SCALE = 2.0 ** 16
# the f64 step against the f32 one, per tensor, relative to its max |x|:
# f32 sums over up to 2.4M terms (the weight grads' GEMMs) in another order
F32_STEP_REL = 1e-3
# the f16 step against the f64 step from the same f16 state (weights,
# features and values rounded to f16, then promoted), per tensor, relative
# to its max |x|: every layer's activations and grads rounded to f16
# (2**-11 each) and compounded over 3 layers forward and back
F16_STEP_REL = 5e-2


def _flops_per_s(dtype):
    return F64_FLOPS_PER_S if dtype == torch.float64 else F32_FLOPS_PER_S


def _scaled_step(model, adj, x, y, scale=1.0):
    """One SGD step of ``gcn_loss`` (lr LR): ``(loss, grads)``, the grads
    (of every parameter, then of ``adj.value``) as the backward left them.
    With a ``scale`` (the f16 step), as mixed precision runs it: the loss
    taken in f32 from the f16 logits (autocast's rule for log_softmax; an
    f16 loss times 2**16 would overflow f16), multiplied by ``scale``
    before the backward, the grads divided by it before the update (they
    are returned still scaled)."""
    from paddle_sparse_tpu_torch import gcn_loss
    model.zero_grad(set_to_none=True)
    adj.value.grad = None
    if scale == 1.0:
        loss = gcn_loss(model, adj, x, y)
    else:
        logp = torch.log_softmax(model(adj, x).float(), dim=-1)
        loss = -logp.gather(1, y[:, None]).mean()
    (loss * scale).backward()
    with torch.no_grad():
        for p in model.parameters():
            p -= LR * (p.grad / scale)
    return loss.detach(), [p.grad for p in model.parameters()] + [
        adj.value.grad]


def _rel_err(got, ref):
    """``||got - ref|| / ||ref||`` (2-norms, in f64): a tensor's error as a
    whole. A few pre-activations that sit at relu's kink and take the other
    side in another precision change whole terms of the grads below them,
    so an entrywise max measures those few, and no precision."""
    ref = ref.double()
    return float((got.double() - ref).norm() / ref.norm().clamp(
        min=1e-300))


def phase13b_gcn(dev, card, adj, x, model):
    """Phase 5's GCN train step at ogbn-products width (K1 3, K2 1 and the
    fused CSC backward 2 a step, d value on) from one state in f32, f64
    and f16: the f64 step's loss and grads against the f32 step's
    (F32_STEP_REL); the f16 step's (loss in f32 from f16 logits, scaled by
    LOSS_SCALE, grads unscaled) against an f64 step from the same state
    rounded to f16 (F16_STEP_REL); f64 and f16 1 warm-up + 3 timed steps,
    peak memory and exact launches. Then K1, K2 and the
    fused CSC backward alone at K=256 on layer 1's input in f16 and f64:
    kernel vs plain in turns, bounds, library calls."""
    import copy

    from paddle_sparse_tpu_torch import (sddmm_csr_cuda, sddmm_csr_reference,
                                         spmm_csr_cuda, spmm_csr_reference,
                                         spmm_sddmm_csc_reference)
    n = PRODUCTS_NODES
    y = torch.randint(0, GCN_DIMS[2], (n,), generator=torch.Generator(
        device=dev).manual_seed(5), device=dev)
    s = adj.structure()
    value32 = adj.value.detach()
    firsts, stats = {}, {}
    f16_state = "f64 from the f16 state"
    for dt in (torch.float32, torch.float64, f16_state, torch.float16):
        via = torch.float16 if dt == f16_state else torch.float32
        dt_ = torch.float64 if dt == f16_state else dt
        m = copy.deepcopy(model).to(via).to(dt_)
        a = adj.with_value(value32.to(via).to(dt_))
        a.value.requires_grad_()
        xd = x.to(via).to(dt_)
        scale = LOSS_SCALE if dt == torch.float16 else 1.0
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _zero_launch_counts()
        times = []
        for i in range(4 if dt in (torch.float64, torch.float16) else 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, grads = _scaled_step(m, a, xd, y, scale)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            if i == 0:
                finite = all(bool(torch.isfinite(g).all()) for g in grads)
                top = max(float(g.abs().max()) for g in grads)
                firsts[dt] = (float(loss), [g.double() / scale
                                            for g in grads])
        counts = _launch_counts()
        peak = torch.cuda.max_memory_allocated() / 1e9
        steps = len(times)
        check(finite, f"{dt} step: grads not finite (largest scaled grad "
                      f"{top:.3e})")
        check(counts["spmm_csr"] == 3 * steps
              and counts["sddmm_csr"] == steps
              and counts["spmm_sddmm_csc"] == 2 * steps
              and counts["fold_pieces"] == 0
              and sum(counts.values()) == 6 * steps,
              f"{dt} step launches {counts}, expected K1 3, K2 1 and the "
              f"fused CSC backward 2 a step")
        if len(times) == 1:
            print(f"phase 13b {dt} step from phase 5's first state: loss "
                  f"{firsts[dt][0]:.6f}, {times[0]:.3f} ms; launches K1 3, "
                  f"K2 1, spmm_sddmm_csc 2 {card}", flush=True)
            del m, a, xd, grads
            continue
        step_ms = sum(times[1:]) / 3
        stats[str(dt)[6:]] = {"step_ms": step_ms, "warm_up_ms": times[0],
                              "peak_gb": peak, "counts": counts,
                              "loss_scale": scale}
        print(f"phase 13b {dt} step (loss scale {scale:g}, largest scaled "
              f"grad {top:.3e}): warm-up {times[0]:.3f} ms, timed "
              f"{' '.join(f'{t:.3f}' for t in times[1:])} (mean "
              f"{step_ms:.3f}); peak mem {peak:.2f} GB; launches in "
              f"{steps} steps K1 {counts['spmm_csr']}, K2 "
              f"{counts['sddmm_csr']}, spmm_sddmm_csc "
              f"{counts['spmm_sddmm_csc']}, nothing else {card}",
              flush=True)
        if dt == torch.float64:      # layer 1's input, for the kernels
            h64 = m, a, xd
        else:
            h16 = m, a, xd
        del grads
    names = [f"weight {i}" for i in range(len(model.weight))] + [
        f"bias {i}" for i in range(len(model.bias))] + ["d value"]
    for dt, ref_dt, rel in ((torch.float64, torch.float32, F32_STEP_REL),
                            (torch.float16, f16_state, F16_STEP_REL)):
        (l_got, g_got), (l_ref, g_ref) = firsts[dt], firsts[ref_dt]
        errs = {nm: _rel_err(g, r) for nm, g, r in zip(names, g_got, g_ref)}
        l_err = abs(l_got - l_ref) / abs(l_ref)
        ok = l_err <= rel and all(e <= rel for e in errs.values())
        stats[str(dt)[6:]].update(
            loss=l_got, vs=str(ref_dt).replace("torch.", ""),
            loss_rel_err=l_err, grad_rel_err=max(errs.values()),
            tolerance=rel)
        print(f"phase 13b {dt} first step vs the {ref_dt} step from the "
              f"same state: loss {l_got:.6f} vs {l_ref:.6f} (rel "
              f"{l_err:.3e}); grads' max |err| / max |ref|: "
              + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
              + f" (tolerance {rel:g}) {'ok' if ok else 'FAIL'}",
              flush=True)
        check(ok, f"the {dt} step disagrees with the {ref_dt} step")
    stats["float32_loss"] = firsts[torch.float32][0]
    del firsts

    # the kernels alone at K=256, on layer 1's input in each dtype
    rowptr, col, nnz = adj.rowptr(), adj.col, adj.nnz
    kernels = {}
    for tag, (m, a, xd) in (("float16", h16), ("float64", h64)):
        dt = xd.dtype
        with torch.no_grad():
            h = torch.relu(a.spmm(xd) @ m.weight[0] + m.bias[0]).contiguous()
        v = a.value.detach()
        g = torch.randn(h.shape, generator=torch.Generator(
            device=dev).manual_seed(13), device=dev).to(dt)
        rate = _flops_per_s(dt)
        out = {}

        def entry(name, plain, kernel, moved, flops, lib_name, lib,
                  compare):
            p1, k1, k2, p2, out_p, out_k = in_turns(plain, kernel, 1, 5)
            err = compare(out_k, out_p)
            lib_ms, lib_err = library_timed(lib_name, lib, 3)
            bound, by = bound_ms(moved, 0.0)
            t_ops = flops / rate * 1e3
            if t_ops > bound:
                bound, by = t_ops, "operations"
            out[name] = {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
                         "max_abs_err": err, "bound_ms": bound,
                         "bound_by": by, "library_ms": lib_ms,
                         "library": lib_name}
            print(f"phase 13b {name} K=256 {dt}: kernel {k1:.3f} / "
                  f"{k2:.3f} ms, plain {p1:.3f} / {p2:.3f} ms, bound "
                  f"{bound:.3f} ms ({by}), {lib_name} {lib_ms} ms; kernel "
                  f"vs plain max_abs_err {err:.3e} {card}", flush=True)
            del out_p, out_k
            torch.cuda.empty_cache()

        def max_err(tol_rel):
            def cmp(k, p):
                if isinstance(k, tuple):
                    return max(cmp(a_, b_) for a_, b_ in zip(k, p))
                e = float((k.double() - p.double()).abs().max())
                scale_ = float(p.double().abs().max())
                check(e <= tol_rel * scale_, f"kernel vs plain at scale: "
                                             f"{e:.3e} of {scale_:.3e}")
                return e
            return cmp
        tol = 1e-12 if dt == torch.float64 else 2.0 ** -10
        csr = torch.sparse_csr_tensor(rowptr, col[:nnz], v[:nnz], (n, n))
        with torch.no_grad():
            entry("spmm_csr",
                  lambda: spmm_csr_reference(rowptr, col, v, h),
                  lambda: spmm_csr_cuda(rowptr, col, v, h, split=None),
                  nbytes(rowptr, col[:nnz], v[:nnz], h, h), 2 * nnz * 256,
                  "torch.sparse.mm on the CSR",
                  lambda: torch.sparse.mm(csr, h), max_err(tol))
            h_t = h.t().contiguous()
            entry("sddmm_csr",
                  lambda: sddmm_csr_reference(rowptr, col, g, h, dt),
                  lambda: sddmm_csr_cuda(rowptr, col, g, h, dt, split=None),
                  nbytes(rowptr, col[:nnz], g, h, v[:nnz]), 2 * nnz * 256,
                  "torch.sparse.sampled_addmm on the CSR",
                  lambda: torch.sparse.sampled_addmm(csr, g, h_t, beta=0.0),
                  max_err(tol))
            del h_t, csr
            csr_t = torch.sparse_csr_tensor(
                s.colptr, s.col_t[:nnz], v[s.perm[:nnz].long()], (n, n))
            entry("spmm_sddmm_csc",
                  lambda: spmm_sddmm_csc_reference(s.colptr, s.col_t, s.perm,
                                                   v, g, h, dt, s.inv_perm),
                  lambda: fused_kernel(a, v, g, h, dt),
                  nbytes(s.colptr, s.col_t[:nnz], s.perm[:nnz], v[:nnz], g,
                         h, h, v[:nnz]), 4 * nnz * 256,
                  "torch.sparse.mm of the transpose's CSR (d x only)",
                  lambda: torch.sparse.mm(csr_t, g), max_err(tol))
            del csr_t
        for k_ in out.values():
            k_["gather_bound_ms"] = (nnz * 256 * h.element_size()
                                     / HBM_BYTES_PER_S * 1e3)
        kernels[tag] = out
        del h, g, v
        torch.cuda.empty_cache()
    stats["kernels"] = kernels
    return stats


def phase13_gcn(dev, card, phase5_loss):
    """Phase 4's graph, features and model rebuilt from their seeds: the
    state phase 5's first step starts from (its f32 loss must come out
    again), then :func:`phase13b_gcn`."""
    from paddle_sparse_tpu_torch import gcn_normalize, init_gcn
    raw, x = products_graph(dev)
    adj = gcn_normalize(raw)
    del raw
    model = init_gcn(torch.Generator().manual_seed(0), *GCN_DIMS,
                     num_layers=3, device=dev)
    stats = phase13b_gcn(dev, card, adj, x, model)
    rel = abs(stats["float32_loss"] - phase5_loss) / abs(phase5_loss)
    print(f"phase 13b f32 loss {stats['float32_loss']:.9f} vs phase 5's "
          f"first step {phase5_loss:.9f} (rel {rel:.2e}): the same state",
          flush=True)
    check(rel <= 1e-6, "phase 13b did not start from phase 5's state")
    del adj, x, model
    torch.cuda.empty_cache()
    return stats


def phase13c_a_at_a(dev, card):
    """A @ A on phase 6c's 10M-nnz operand through spspmm_rowsorted with bf16
    and f16 values: C's structure equal to the f32 run's, its values within
    5 half-ulps of the narrow dtype of the f32 C (each operand rounded, the
    product rounded, the f32 sum rounded once; all terms positive; plus
    4 * F16_TINY for f16's subnormal products), K5 once
    a call (its row sort too), 1 warm-up + 3 timed calls; then K5 alone on
    the call's own compress input, kernel vs plain in turns, its bound and
    its library call ``torch.sparse_coo_tensor(...).coalesce()`` in the same
    dtype."""
    from paddle_sparse_tpu_torch import (compact_runs_cuda,
                                         compact_runs_reference,
                                         plan_spgemm_rows, spspmm_rowsorted)
    A = spgemm_operand(dev, 625_000, 16)
    F, oc = plan_spgemm_rows(A, A)
    with torch.inference_mode():
        C32 = spspmm_rowsorted(A, A, F, oc).matrix
    out = {}
    for dt, half_ulp in ((torch.bfloat16, BF16_HALF_ULP),
                         (torch.float16, F16_HALF_ULP)):
        Ad = A.with_value(A.value.to(dt))
        _zero_launch_counts()
        times = []
        with torch.inference_mode():
            for _ in range(4):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = spspmm_rowsorted(Ad, Ad, F, oc)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
        counts = _launch_counts()
        C = res.matrix
        n = C.nnz
        err = (C.value[:n].double() - C32.value[:n].double()).abs()
        tiny = 4 * F16_TINY if dt == torch.float16 else 0.0  # subnormals
        ok = (not res.overflowed and n == C32.nnz and C.value.dtype == dt
              and torch.equal(C.row, C32.row) and torch.equal(C.col, C32.col)
              and bool((err <= 5 * half_ulp * C32.value[:n].double()
                        + tiny + 1e-30).all()))
        check(counts["segcompact"] == 4
              and counts["segcompact_row_sorted"] == 4,
              f"{dt} A @ A: K5 launches {counts}")
        ms = sum(times[1:]) / 3
        print(f"phase 13c A @ A, 10M nnz, {dt} values: c_nnz {n}, ms per "
              f"call warm-up {times[0]:.3f}, timed "
              f"{' '.join(f'{t:.3f}' for t in times[1:])} (mean {ms:.3f}); "
              f"K5 4 in 4 calls (rows sorted by K5 4); vs the f32 C: "
              f"structure equal, values max_abs_err {float(err.max()):.3e} "
              f"{'ok' if ok else 'FAIL'} {card}", flush=True)
        check(ok, f"{dt} A @ A disagrees with the f32 run")
        with _RecordCompress() as calls, torch.inference_mode():
            spspmm_rowsorted(Ad, Ad, F, oc)
        args, kw = calls[0]
        kw = dict(kw, seg=False)
        with torch.inference_mode():
            p1, k1, k2, p2, out_p, out_k = in_turns(
                lambda: compact_runs_reference(*args, **kw),
                lambda: compact_runs_cuda(*args, **kw), 1, 5)
        m = int(out_k.count)
        k_err = float((out_k.value[:m].double()
                       - out_p.value[:m].double()).abs().max())
        check(torch.equal(out_k.row, out_p.row)
              and torch.equal(out_k.col, out_p.col)
              and k_err <= 2 * half_ulp * float(out_p.value[:m].double()
                                                .abs().max()),
              f"{dt} K5 vs plain at scale ({k_err:.3e})")
        col, rows, value = args[:3]
        cap = int(args[4])
        bound, by = bound_ms(nbytes(col, rows, value)
                             + cap * (8 + value.element_size()), 0.0)
        lib_ms, _, lib_err = k5_library(f"13c {dt}", card, args, kw, out_k)
        out[str(dt)[6:]] = {
            "ms_per_call": ms, "launches": counts, "c_nnz": n,
            "max_abs_err_vs_f32": float(err.max()),
            "k5": {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
                   "max_abs_err": k_err, "bound_ms": bound, "bound_by": by,
                   "library_ms": lib_ms, "library_max_abs_err": lib_err}}
        print(f"phase 13c K5 alone {dt} on the call's ({col.shape[0]}, "
              f"{col.shape[1]}) grid: kernel {k1:.3f} / {k2:.3f} ms, plain "
              f"{p1:.3f} / {p2:.3f} ms, bound {bound:.3f} ms ({by}), "
              f"library {lib_ms} ms; max_abs_err vs plain {k_err:.3e} "
              f"{card}", flush=True)
        del res, C, Ad, calls, args, out_p, out_k
        torch.cuda.empty_cache()
    return out


def phase13d_coalesce(dev, card):
    """``PaddedCOO.coalesce`` of phase 4's 122,451,450 coordinates, sorted
    by (row, col), with every 10th coordinate made a duplicate of the one
    before it: once with (capacity, 8) f32 values (ogbn-proteins' 8 edge
    features, 3.9 GB), once with (capacity,) bf16 values. Each: the
    whole call 1 warm-up + 3 timed, K5 once a call, the result against the
    plain version in f64 (structure exact; values within 1e-6 of each
    entry's sum of |terms| plus half an ulp of the output dtype); K5
    alone against the plain version in turns, its bound, and its library
    call ``torch.sparse_coo_tensor(...).coalesce()`` with the same values
    (a hybrid tensor with a dense dim of 8 for the vectors)."""
    from paddle_sparse_tpu_torch import (PaddedCOO, compact_runs_cuda,
                                         compact_runs_reference)
    n, L = PRODUCTS_NODES, PRODUCTS_NODES * PRODUCTS_DEG
    g = torch.Generator(device=dev).manual_seed(0)
    key = (torch.arange(n, device=dev).repeat_interleave(PRODUCTS_DEG)
           * (n + 1) + torch.randint(0, n, (L,), generator=g, device=dev))
    key = key.sort().values
    key[9::10] = key[8::10][:key[9::10].numel()]
    row, col = (key // (n + 1)).int(), (key % (n + 1)).int()
    del key
    out = {}
    for tag, shape, dt, half_ulp in (
            ("f32 (capacity, 8)", (L, 8), torch.float32, 0.0),
            ("bf16 (capacity,)", (L,), torch.bfloat16, BF16_HALF_ULP)):
        val = torch.randn(shape, generator=g, device=dev).to(dt)
        A = PaddedCOO.from_arrays(row, col, val, (n, n))
        _zero_launch_counts()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        times = []
        with torch.inference_mode():
            for _ in range(4):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                C = A.coalesce()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated() / 1e9
        counts = _launch_counts()
        check(counts["segcompact"] == 4 and sum(counts.values()) == 4,
              f"coalesce {tag}: launches {counts}")
        args = (A.col, A.row, A.value, A.shape, A.capacity)
        with torch.inference_mode():
            p1, k1, k2, p2, out_p, out_k = in_turns(
                lambda: compact_runs_reference(*args),
                lambda: compact_runs_cuda(*args), 1, 3)
            del out_p
            ref = compact_runs_reference(A.col, A.row, A.value.double(),
                                         A.shape, A.capacity)
            scale = compact_runs_reference(A.col, A.row,
                                           A.value.abs().double(), A.shape,
                                           A.capacity).value
        m = int(ref.count)
        err = (C.value.double() - ref.value).abs()
        ok = (C.nnz == m and m <= L - L // 10
              and torch.equal(C.row, ref.row) and torch.equal(C.col, ref.col)
              and C.value.dtype == dt and C.value.shape == ref.value.shape
              and bool((err <= 1e-6 * scale + half_ulp * ref.value.abs()
                        + 1e-30).all())
              and torch.equal(out_k.value, C.value))
        ms = sum(times[1:]) / 3
        print(f"phase 13d coalesce {tag}: {L} entries, {m} unique; ms "
              f"warm-up {times[0]:.3f}, timed "
              f"{' '.join(f'{t:.3f}' for t in times[1:])} (mean {ms:.3f}); "
              f"peak mem {peak:.2f} GB; K5 4 in 4 calls; vs plain f64 "
              f"max_abs_err {float(err.max()):.3e} "
              f"{'ok' if ok else 'FAIL'} {card}", flush=True)
        check(ok, f"coalesce {tag} disagrees with plain f64")
        del ref, scale, err
        bound, by = bound_ms(nbytes(A.col, A.row, A.value, C.row, C.col,
                                    C.value), 0.0)
        idx = torch.stack([A.row, A.col]).long()
        with torch.inference_mode():
            lib_ms, lib_err = library_timed(
                "torch.sparse_coo_tensor(...).coalesce()",
                lambda: torch.sparse_coo_tensor(
                    idx, A.value, (n, n) + tuple(A.value.shape[1:])
                ).coalesce(), 3,
                out_k.value[:m])
        del idx
        out[tag] = {"ms": ms, "launches": counts, "peak_gb": peak,
                    "k5": {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
                           "max_abs_err": float((out_k.value.double()
                                                 - C.value.double()).abs()
                                                .max()),
                           "bound_ms": bound, "bound_by": by,
                           "library_ms": lib_ms,
                           "library_max_abs_err": lib_err}}
        print(f"phase 13d K5 alone {tag}: kernel {k1:.3f} / {k2:.3f} ms, "
              f"plain {p1:.3f} / {p2:.3f} ms, bound {bound:.3f} ms ({by}), "
              f"torch.sparse_coo_tensor(...).coalesce() {lib_ms} ms (vs "
              f"kernel max_abs_err {lib_err}) {card}", flush=True)
        del A, C, val, out_k
        torch.cuda.empty_cache()
    return out


# ---- phase 14: integer operands and the double backward ---------------------

INT_WRAP = 2 ** 32


def _int_k1_stats(name, card, adj, x, want_dtype):
    """K1 on an integer ``x`` (structural ``adj``) on the main path
    (``PaddedCOO.spmm``, one launch), then exactly against its plain
    version on the card, timed in turns, beside its bound and
    ``torch.sparse.mm`` on the same operands (or that it refuses)."""
    from paddle_sparse_tpu_torch import spmm_csr_cuda, spmm_csr_reference
    rowptr, col, nnz = adj.rowptr(), adj.col, adj.nnz
    _zero_launch_counts()
    out = adj.spmm(x)
    torch.cuda.synchronize()
    launches = _launch_counts()["spmm_csr"]
    check(launches == 1 and out.dtype == want_dtype,
          f"{name}: {launches} K1 launches, dtype {out.dtype}")
    p1, k1, k2, p2, out_p, out_k = in_turns(
        lambda: spmm_csr_reference(rowptr, col, None, x),
        lambda: spmm_csr_cuda(rowptr, col, None, x, split=adj.row_split()),
        1, 5)
    exact = bool(torch.equal(out, out_p)) and bool(torch.equal(out_k, out_p))
    err = float((out.double() - out_p.double()).abs().max())
    check(exact, f"{name}: K1 differs from its plain version by {err}")
    bound, by = bound_ms(nbytes(rowptr, col[:nnz], x, out), nnz * x.shape[1])
    csr = torch.sparse_csr_tensor(rowptr, col[:nnz], torch.ones(
        nnz, dtype=x.dtype, device=x.device), adj.shape)
    lib_ms, lib_err = library_timed(f"torch.sparse.mm ({name})",
                                    lambda: torch.sparse.mm(csr, x), 3, out)
    del csr
    print(f"phase 14a {name}: K1 {k1:.3f} / {k2:.3f} ms in turns with the "
          f"plain version {p1:.3f} / {p2:.3f} ms, exact {exact}; bound "
          f"{bound:.3f} ms ({by}); torch.sparse.mm "
          f"{'refuses' if lib_ms is None else f'{lib_ms:.3f} ms'} {card}",
          flush=True)
    return out, {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
                 "bound_ms": bound, "bound_by": by, "library_ms": lib_ms,
                 "library_max_abs_err": lib_err, "max_abs_err": err,
                 "exact": exact, "launches": launches, "K": x.shape[1],
                 "dtype": str(x.dtype)[6:]}


def phase14a_ints(dev, card):
    """Integer operands through K1 at full width: on phase 4's graph as a
    structural ``A`` (no value), ``A @ onehot(labels)`` with 47 int32
    classes (each node's neighbour-label counts) and the two-hop path
    counts ``A @ (A @ 1)`` in int64, each exactly against the plain version
    on the card; then int32 values and x of +-2**30 on a small graph with a
    hub row cut into pieces, whose sums wrap past 2**31."""
    from paddle_sparse_tpu_torch import (CAP, PaddedCOO, spmm_csr_cuda,
                                         spmm_csr_reference)
    n = PRODUCTS_NODES
    raw, _ = products_graph(dev)
    adj = PaddedCOO.from_arrays(raw.row, raw.col, None, raw.shape)
    del raw
    labels = torch.randint(0, GCN_DIMS[2], (n,), generator=torch.Generator(
        device=dev).manual_seed(14), device=dev)
    onehot = torch.nn.functional.one_hot(labels, GCN_DIMS[2]).to(torch.int32)
    counts, lab = _int_k1_stats("neighbour-label counts int32 K=47", card,
                                adj, onehot, torch.int32)
    check(bool((counts.sum(1) == PRODUCTS_DEG).all()),
          "a node's neighbour-label counts do not sum to its degree")
    del counts, onehot
    ones = torch.ones(n, 1, dtype=torch.int64, device=dev)
    deg, _ = _int_k1_stats("degree int64 K=1", card, adj, ones, torch.int64)
    check(bool((deg == PRODUCTS_DEG).all()), "A @ 1 is not the degree")
    two_hop, hop = _int_k1_stats("two-hop path counts int64 K=1", card, adj,
                                 deg, torch.int64)
    check(bool((two_hop == PRODUCTS_DEG ** 2).all()),
          "A @ (A @ 1) is not degree squared on the uniform-degree graph")
    del deg, two_hop, ones, adj
    torch.cuda.empty_cache()

    # int32 sums past 2**31 that wrap, with a hub row cut into pieces
    gen = torch.Generator(device=dev).manual_seed(141)
    rowptr, col, _ = random_csr(gen, dev, 5000, 3000, 40)
    deg = torch.diff(rowptr)
    deg[2500] = 3 * CAP + 7
    rowptr = torch.zeros_like(rowptr)
    rowptr[1:] = deg.cumsum(0)
    col = torch.randint(0, 3000, (int(rowptr[-1]),), generator=gen,
                        device=dev, dtype=torch.int32)
    lo, hi = -2 ** 30, 2 ** 30
    value = torch.randint(lo, hi, (col.numel(),), generator=gen, device=dev,
                          dtype=torch.int32)
    wrap = {}
    for K in (1, 7, 64):
        x = torch.randint(lo, hi, (3000, K), generator=gen, device=dev,
                          dtype=torch.int32)
        _zero_launch_counts()
        out = spmm_csr_cuda(rowptr, col, value, x)
        folds = _launch_counts()["fold_pieces"]
        ref = spmm_csr_reference(rowptr, col, value, x)
        wide = spmm_csr_reference(rowptr, col, value.long(), x.long())
        wrapped = int((wide != out.long()).sum())
        ok = bool(torch.equal(out, ref)) and out.dtype == torch.int32
        print(f"phase 14a int32 value x int32 x K={K}, hub row of "
              f"{3 * CAP + 7} edges in pieces (fold launches {folds}): "
              f"kernel equal to plain {ok}; {wrapped} of {out.numel()} "
              f"sums wrapped past 2**31", flush=True)
        check(ok and folds == 1 and wrapped > 0,
              f"int32 K={K}: exact {ok}, folds {folds}, wrapped {wrapped}")
        wrap[f"K={K}"] = {"exact": ok, "wrapped": wrapped}
    return {"label_counts": lab, "two_hop": hop, "wrap": wrap}


def _penalty_value(model, adj, x, y, lam):
    """``CE + lam * |d CE / d x|^2`` (no graph kept)."""
    x = x.detach().requires_grad_()
    logp = torch.log_softmax(model(adj, x), dim=-1)
    ce = -logp.gather(1, y[:, None]).mean()
    gx, = torch.autograd.grad(ce, x)
    return float(ce) + lam * float(gx.square().sum())


def phase14b_penalty(dev, card, phase5):
    """Phase 5's GCN (100 -> 256 -> 256 -> 47, f32, d value on) with the
    input-gradient penalty ``CE + lam * |d CE / d x|^2`` at ogbn-products
    width: 1 warm-up + 3 timed steps (forward, ``d CE / d x`` under
    ``create_graph``, backward through it, SGD) beside phase 5's step,
    peak memory, exact launches a step (``PENALTY_LAUNCHES``); then the
    step's gradient along three unit directions of the last layer's
    parameters (the gradient's own, a random one and the penalty's own
    share, the gradient less CE's) against a central difference of the
    penalty loss in f64 on the same graph, within 1e-5 of |g|, each beside
    CE's own directional derivative; the penalty's share along its own
    direction must exceed ten times that tolerance. Only the last
    layer: moving earlier weights moves pre-activations across relu's kink,
    which turns the penalty's ``d x`` on and off there, so its difference
    quotient is not the derivative."""
    from paddle_sparse_tpu_torch import GCN, gcn_normalize, init_gcn
    n = PRODUCTS_NODES
    raw, x = products_graph(dev)
    adj = gcn_normalize(raw)
    del raw
    y = torch.randint(0, GCN_DIMS[2], (n,), generator=torch.Generator(
        device=dev).manual_seed(5), device=dev)
    state0 = init_gcn(torch.Generator().manual_seed(0), *GCN_DIMS,
                      num_layers=3, device=dev).state_dict()

    def model(dtype=torch.float32):
        m = GCN(*GCN_DIMS, num_layers=3, device=dev)
        m.load_state_dict(state0)
        return m.to(dtype)

    lam = penalty_lambda(model(), adj, x, y)
    adj.value.requires_grad_()
    torch.cuda.empty_cache()
    m = model()
    torch.cuda.reset_peak_memory_stats()
    _zero_launch_counts()
    times, losses = [], []
    for i in range(4):
        adj.value.grad = None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = penalty_step(m, adj, x, y, n, lam)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append((float(res["loss"]), float(res["penalty"])))
    counts = _launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_ms = sum(times[1:]) / 3
    print(f"phase 14b GCN penalty step (lam {lam:.6e}) ms: warm-up "
          f"{times[0]:.3f}, timed {' '.join(f'{t:.3f}' for t in times[1:])} "
          f"(mean {step_ms:.3f}), peak mem {peak_gb:.2f} GB, beside phase "
          f"5's first-order step {phase5['step_ms']:.3f} ms, "
          f"{phase5['peak_gb']:.2f} GB; (loss, penalty) "
          + " ".join(f"({a:.6f}, {b:.6f})" for a, b in losses)
          + f" {card}", flush=True)
    want = {k: 0 for k in counts}
    want.update({k: 4 * v for k, v in PENALTY_LAUNCHES.items()})
    print("phase 14b launches in 4 penalty steps: "
          + ", ".join(f"{k} {v}" for k, v in counts.items() if v),
          flush=True)
    check(counts == want, f"penalty step: expected launches {want}, "
                          f"counted {counts}")
    check(all(a == a and b > 0 for a, b in losses),
          "penalty step loss not finite or penalty 0")
    del m, res

    # the gradient at the initial state in f32, its last layer
    m = model()
    adj.value.grad = None
    res = penalty_step(m, adj, x, y, n, lam)
    last = [k for k in res["grads"] if k.endswith(f".{len(m.weight) - 1}")]
    g32 = torch.cat([res["grads"][k].double().reshape(-1) for k in last])
    del m, res
    # CE's own gradient there (first order), so that each direction shows
    # the penalty's share of the derivative beside the check's tolerance
    m = model()
    logp = torch.log_softmax(m(adj, x), dim=-1)
    ce = -logp.gather(1, y[:, None]).mean()
    gce = torch.autograd.grad(ce, [p for k, p in m.named_parameters()
                                   if k in last])
    gce32 = torch.cat([t.double().reshape(-1) for t in gce])
    del m, logp, ce, gce
    adj.value.grad = None
    adj.value.requires_grad_(False)
    torch.cuda.empty_cache()
    # the penalty loss in f64 on the same graph, moved along unit
    # directions of the last layer
    adj64 = adj.with_value(adj.value.detach().double())
    x64 = x.double()
    del x
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(142)
    dirs = {"gradient": g32 / g32.norm(),
            "random": (lambda r: r / r.norm())(torch.randn(
                g32.numel(), generator=gen, device=dev,
                dtype=torch.float64)),
            "penalty": (g32 - gce32) / (g32 - gce32).norm()}
    eps = 1e-4
    tol = 1e-5                     # of |g| (the directions are unit)
    fd = {}
    for name, d in dirs.items():
        vals = []
        for sign in (1.0, -1.0):
            m64 = model(torch.float64)
            with torch.no_grad():
                off = 0
                for k, prm in m64.named_parameters():
                    if k in last:
                        prm += sign * eps * d[off:off + prm.numel()].view(
                            prm.shape)
                        off += prm.numel()
            vals.append(_penalty_value(m64, adj64, x64, y, lam))
            del m64
            torch.cuda.empty_cache()
        diff = (vals[0] - vals[1]) / (2 * eps)
        dot = float(g32 @ d)
        dot_ce = float(gce32 @ d)
        err = abs(diff - dot) / float(g32.norm())
        share = abs(dot - dot_ce) / float(g32.norm())
        print(f"phase 14b penalty gradient along the last layer's {name} "
              f"direction: f32 step {dot:.9e} (CE alone {dot_ce:.9e}, the "
              f"penalty's share {share:.3e} of |g|), f64 central difference "
              f"(eps {eps:g}) {diff:.9e}; |diff| / |g| {err:.3e} "
              f"(tolerance {tol:g}) {card}", flush=True)
        check(err <= tol, f"penalty gradient along {name}: off the f64 "
                          f"central difference by {err:.3e} of |g|")
        fd[name] = {"step": dot, "ce_alone": dot_ce, "penalty_share": share,
                    "central_difference": diff, "rel_err": err}
    # the check can see the second derivative: along the penalty's own
    # gradient, leaving it out would miss by more than the tolerance
    check(fd["penalty"]["penalty_share"] > 10 * tol,
          f"the penalty's share of the gradient, "
          f"{fd['penalty']['penalty_share']:.3e} of |g|, is not above ten "
          f"times the check's tolerance {tol:g}")
    return {"lam": lam, "step_ms": step_ms, "warmup_ms": times[0],
            "peak_gb": peak_gb, "phase5_step_ms": phase5["step_ms"],
            "phase5_peak_gb": phase5["peak_gb"], "counts": counts,
            "directional": fd, "losses": losses}


def phase14c_small(dev):
    """On a small graph with a hub row and a hub column in pieces, in f64:
    HVPs of ``spmm`` with value and x both requiring grad, card against the
    CPU's plain versions, and against the bilinear identity (the mixed
    second derivative of ``<G, A(v) x>`` along ``(dv, dx)`` is ``<G, A(dv)
    dx>``, one forward K1); SpGEMM values' HVP card against CPU."""
    from paddle_sparse_tpu_torch import (CAP, PaddedCOO, plan_spgemm_rows,
                                         spgemm_entry, spspmm_rowsorted)
    g = torch.Generator().manual_seed(143)
    M_, N_ = 900, 700
    row = torch.cat([torch.randint(0, M_, (12000,), generator=g),
                     torch.full((2 * CAP + 9,), 321),
                     torch.randint(0, M_, (2 * CAP + 9,), generator=g)])
    col = torch.cat([torch.randint(0, N_, (12000,), generator=g),
                     torch.randint(0, N_, (2 * CAP + 9,), generator=g),
                     torch.full((2 * CAP + 9,), 55)])
    order = torch.argsort(row * N_ + col, stable=True)
    row, col = row[order].int(), col[order].int()
    v = torch.randn(row.numel(), generator=g, dtype=torch.float64)
    x = torch.randn(N_, 33, generator=g, dtype=torch.float64)
    w = torch.randn(M_, 33, generator=g, dtype=torch.float64)
    dv = torch.randn(v.shape, generator=g, dtype=torch.float64)
    dx = torch.randn(x.shape, generator=g, dtype=torch.float64)

    def hvp(d):
        A = PaddedCOO.from_arrays(row.to(d), col.to(d), None, (M_, N_))
        tv, tx = v.to(d).requires_grad_(), x.to(d).requires_grad_()
        f = (w.to(d) * A.with_value(tv).spmm(tx) ** 2).sum()
        gv, gx = torch.autograd.grad(f, (tv, tx), create_graph=True)
        hv, hx = torch.autograd.grad(
            (gv * dv.to(d)).sum() + (gx * dx.to(d)).sum(), (tv, tx))
        # bilinear: d/dx <d f_lin / d v, dv> along dx = <w, A(dv) dx>
        lin = (w.to(d) * A.with_value(tv).spmm(tx)).sum()
        gl, = torch.autograd.grad(lin, tv, create_graph=True)
        mx, = torch.autograd.grad((gl * dv.to(d)).sum(), tx)
        once = (w.to(d) * A.with_value(dv.to(d)).spmm(dx.to(d))).sum()
        return hv.cpu(), hx.cpu(), float((mx * dx.to(d)).sum()), float(once)

    card_hvp, cpu_hvp = hvp(dev), hvp(torch.device("cpu"))
    errs = []
    for a, b in zip(card_hvp[:2], cpu_hvp[:2]):
        err = float((a - b).abs().max()) / float(b.abs().max())
        errs.append(err)
        check(err <= F64_REL * 100, f"spmm HVP card vs CPU: {err:.3e}")
    bil = abs(card_hvp[2] - card_hvp[3]) / abs(card_hvp[3])
    check(bil <= 1e-11, f"bilinear identity off by {bil:.3e}")
    B = spgemm_entry(dev)
    Bc = spgemm_entry("cpu")
    F, oc = plan_spgemm_rows(Bc, Bc)
    hs = []
    for Mx in (B, Bc):
        val = Mx.value.double().requires_grad_()
        Mi = Mx.with_value(val)
        C = spspmm_rowsorted(Mi, Mi, F, oc).matrix.value
        G = torch.linspace(-1, 1, C.numel(), dtype=torch.float64,
                           device=C.device)
        gg, = torch.autograd.grad((G * C ** 2).sum(), val, create_graph=True)
        u = torch.cos(torch.arange(gg.numel(), dtype=torch.float64,
                                   device=gg.device))
        h, = torch.autograd.grad((gg * u).sum(), val)
        hs.append(h.cpu())
    sp_err = float((hs[0] - hs[1]).abs().max()) / float(hs[1].abs().max())
    check(sp_err <= F64_REL * 100, f"SpGEMM value HVP card vs CPU: "
                                   f"{sp_err:.3e}")
    print(f"phase 14c f64 HVPs, card vs CPU (max diff over max): spmm d "
          f"value {errs[0]:.3e}, d x {errs[1]:.3e}; bilinear identity "
          f"{bil:.3e}; SpGEMM values {sp_err:.3e} (tolerance "
          f"{F64_REL * 100:g}; identity 1e-11)", flush=True)
    return {"spmm_hvp_rel": errs, "bilinear_rel": bil, "spgemm_hvp_rel":
            sp_err}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible "
              "(torch.cuda.is_available() is False); nothing was run",
              file=sys.stderr)
        return 1

    from paddle_sparse_tpu_torch.ops.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False   # full-f32 h @ w
    torch.backends.cudnn.allow_tf32 = False
    # phase 13b's f16 GEMMs sum in f32, split-K reductions too
    torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t_start = time.perf_counter()

    def stamp(done):
        print(f"elapsed {time.perf_counter() - t_start:.1f} s after {done}",
              flush=True)

    # ---- phase 1: device and build ---------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    card = f"[{smi}]"
    print(f"phase 1 device: {smi} | torch {torch.__version__} | CUDA "
          f"{torch.version.cuda} | {torch.cuda.get_device_name(0)} | "
          f"count {torch.cuda.device_count()}", flush=True)
    t0 = time.perf_counter()
    so = _build.build_library(_build.sources(), _build.BUILD_DIR)
    _build.load_library()
    build_s = time.perf_counter() - t0
    print(f"phase 1 build: {so.name} from {len(_build.sources())} source(s) "
          f"with nvcc for sm_90a in {build_s:.2f} s {card}", flush=True)

    # ---- phases 2-3b: kernels vs plain, toy slices -----------------------
    gen = torch.Generator(device=dev).manual_seed(1)
    phase2_spmm(gen, dev)
    phase2b_sddmm(gen, dev)
    phase2c_fused(gen, dev)
    phase3_toy(dev)
    phase3b_toy_train(dev)

    stamp("phases 1-3b")

    # ---- phases 4-5: GCN inference and train step at scale ---------------
    adj, x, model, fwd = phase4_forward(dev, card)
    torch.cuda.empty_cache()
    train = phase5_train(dev, card, adj, x, model)
    del adj, x, model
    torch.cuda.empty_cache()

    stamp("phases 4-5")

    # ---- phase 4c: K1 on the clustered graph -----------------------------
    adj, x = clustered_graph(dev)
    walk = phase4c_register_walk(dev, card, adj, x)
    gcn = phase4c_gcn(dev, card, adj, x)
    del adj, x
    torch.cuda.empty_cache()
    print("phase 4c summary " + json.dumps(
        {"register_walk": walk,
         "gcn_forward": {k: gcn[k] for k in ("ms", "layer_ms")}}),
          flush=True)

    stamp("phase 4c")

    # ---- phase 6: run compaction (K5) and SpGEMM --------------------------
    phase6a_segcompact(gen, dev)
    phase6b_toy_spgemm(dev)
    spgemm = phase6c_spgemm(dev, card)
    k5 = spgemm["spgemm_10M_rowsorted"]["k5"]

    stamp("phase 6")

    # ---- phase 7: packed-layout SpMMs (seg2, seg3, split) -----------------
    spans = phase7a_spans(gen, dev, card)
    stamp("phase 7a without the split")
    spans["split_max_abs_err"] = phase7a_long_rows(gen, dev, card)
    stamp("phase 7a's split")
    spans["fused_max_abs_err"] = phase7a_fused(gen, dev, card)
    stamp("phase 7a's fused span backward")
    phase7b_toy(dev)
    packed_paths, span_k = phase7c_scale(dev, card)
    stamp("phase 7c")
    full = packed_paths["seg2_zipf_full_bf16"]["launches"]
    check(full["fold_pieces"] > 0 and full["spmm_spans"] > 0
          and full["spmm_sddmm_spans"] > 0,
          f"full-scale zipf did not run the split kernels: {full}")
    print("phase 7c summary " + json.dumps(
        {p: {k: v for k, v in st.items() if k != "launches"}
         for p, st in packed_paths.items()}), flush=True)

    # ---- phase 8: SpMM mean/min/max and the other model families ---------
    reductions = phase8a_reductions(gen, dev)
    minmax_scale = phase8a_scale(dev, card)
    phase8b_toy_models(dev)
    stamp("phases 8a-8b")
    models = {"sage": phase8c_sage(dev, card, fwd["fwd_ms"],
                                   train["step_ms"])}
    stamp("phase 8c")
    models.update(phase8d_models(dev, card))
    stamp("phase 8d")
    print("phase 8 summary " + json.dumps(
        {"minmax_1_8": minmax_scale, **{k: {"forward_ms": v["forward"]["ms"],
             "train_step_ms": v["train_step"]["ms"],
             "peak_gb": v["train_step"]["peak_gb"],
             **{e: v[e] for e in ("rows_max_abs_err", "d_value_max_abs_err")
                if e in v}}
         for k, v in models.items()}}), flush=True)

    # ---- phase 9: the eager SparseTensor facade ---------------------------
    phase9a_toy_facade(dev)
    row, col, x = facade_graph(dev)
    adj_t, facade = phase9b_gcn_norm(dev, card, row, col, x)
    del row, col, x
    facade["structural_ms"] = phase9c_structural(dev, card, adj_t)
    del adj_t
    torch.cuda.empty_cache()
    facade["a_at_a_10M"] = phase9d_a_at_a(dev, card)
    stamp("phase 9")
    print("phase 9 summary " + json.dumps(
        {**{k: v for k, v in facade.items() if k != "launches"},
         "a_at_a_10M": {k: v for k, v in facade["a_at_a_10M"].items()
                        if k != "launches"},
         "gcn_forward_ms_phase4": fwd["fwd_ms"],
         "gcn_train_step_ms_phase5": train["step_ms"]}), flush=True)

    # ---- phase 10: sampling, walks, partitioning, plan-holding SpMMs -----
    phase10a_toy(dev)
    stamp("phase 10a")
    adj, row, col, val, x = sampling_graph(dev)
    minibatch = phase10b_minibatch(dev, card, adj, row, col, val, x)
    adj_f = adj.set_value(val[adj.storage.value()], layout="coo")
    del adj, row, col, val, x
    torch.cuda.empty_cache()
    stamp("phase 10b")
    sampling = {"minibatch": minibatch, **phase10c_walks(dev, card, adj_f),
                **phase10c_rcm(dev, card, adj_f)}
    stamp("phase 10c's walks, GraphSAINT and RCM")
    th, box = partition_in_thread(adj_f)
    entry_points, timed_until = phase10d_entry_points(dev, card)
    stamp("phase 10d")
    sampling.update(phase10c_partition(dev, card, adj_f, th, box,
                                       timed_until))
    del adj_f
    torch.cuda.empty_cache()
    stamp("phase 10")
    print("phase 10 summary " + json.dumps(
        {"sampling": {k: v for k, v in sampling.items()
                      if k != "minibatch"},
         "minibatch_hops": [{k: v for k, v in h.items() if k != "launches"}
                            for h in minibatch["hops"]],
         "minibatch_padded_ms": {k: v for k, v in minibatch.items()
                                 if k != "hops"},
         "entry_points": {k: {m: v for m, v in st.items()
                              if not m.startswith("launches")}
                          for k, st in entry_points.items()}}), flush=True)

    # ---- phase 11: the experiments/ probes ----------------------------------
    probes = phase11_probes(gen, dev, card)
    stamp("phase 11")

    # ---- phase 12: parallel/ at world size 1 on NCCL ------------------------
    parallel = phase12_parallel(dev, card, train["step_ms"],
                                packed_paths["seg2_uniform_f32"]["fwd_bwd_ms"])
    stamp("phase 12")
    print("phase 12 summary " + json.dumps(
        {k: {m: v for m, v in st.items() if m != "launches"}
         for k, st in parallel.items() if k != "launches"}), flush=True)

    # ---- phase 13: f16 and f64 on the card ---------------------------------
    dtypes = {"kernel_max_abs_err": phase13a_kernels(gen, dev),
              "public_path_launches": phase13a_public_path(gen, dev),
              "segcompact_max_abs_err": phase13a_segcompact(gen, dev)}
    stamp("phase 13a")
    dtypes["gcn"] = phase13_gcn(dev, card, train["losses"][0])
    stamp("phase 13b")
    dtypes["a_at_a_10M"] = phase13c_a_at_a(dev, card)
    stamp("phase 13c")
    dtypes["coalesce_122M"] = phase13d_coalesce(dev, card)
    stamp("phase 13d")
    print("phase 13 summary " + json.dumps(
        {"gcn": {k: v for k, v in dtypes["gcn"].items() if k != "kernels"},
         "a_at_a_10M": dtypes["a_at_a_10M"],
         "coalesce_122M": dtypes["coalesce_122M"]}), flush=True)

    # ---- phase 14: integer operands and the double backward ---------------
    ints = phase14a_ints(dev, card)
    torch.cuda.empty_cache()
    stamp("phase 14a")
    penalty = phase14b_penalty(dev, card, train)
    torch.cuda.empty_cache()
    stamp("phase 14b")
    small = phase14c_small(dev)
    stamp("phase 14c")
    print("phase 14 summary " + json.dumps(
        {"ints": ints, "penalty": {k: v for k, v in penalty.items()
                                   if k != "counts"},
         "penalty_world1": parallel["gcn"]["penalty"], "small": small}),
        flush=True)

    launches = {"gcn_forward": fwd["counts"],
                "gcn_train_step": train["counts"],
                **{p: v["launches"] for p, v in spgemm.items()},
                **{p: v["launches"] for p, v in packed_paths.items()},
                **{f"spmm_{r}": v["launches"] for r, v in reductions.items()},
                **{f"{k}_{part}": v[part]["launches"]
                   for k, v in models.items()
                   for part in ("forward", "train_step")},
                **facade["launches"],
                "facade_a_at_a": facade["a_at_a_10M"]["launches"],
                **{f"sample_hop{i}_k1": h["launches"]
                   for i, h in enumerate(minibatch["hops"], 1)},
                **{f"{k}_4_fwd": v["launches_fwd"]
                   for k, v in entry_points.items()},
                **{f"{k}_4_fwd_bwd": v["launches"]
                   for k, v in entry_points.items()},
                "probes": {k: probes["counts"][k]
                           for k in _launch_counts()},
                **parallel["launches"],
                **{f"gcn_train_step_{dt}": dtypes["gcn"][dt]["counts"]
                   for dt in ("float64", "float16")},
                **{f"a_at_a_10M_{dt}": v["launches"]
                   for dt, v in dtypes["a_at_a_10M"].items()},
                **{f"coalesce_122M_{dt}": v["launches"]
                   for dt, v in dtypes["coalesce_122M"].items()},
                "gcn_penalty_step": penalty["counts"]}

    def by_path(kernel):
        return {p: c[kernel] for p, c in launches.items()}

    def by_dtype(kernel):
        """Phase 13b's K=256 times of ``kernel`` in f16 and f64, with the
        launches of that dtype's 4 train steps."""
        return {dt: {**st[kernel], "launches": dtypes["gcn"][dt]["counts"][
            kernel], "at": "GCN layer 1's input, K=256, 2,449,029 nodes"}
            for dt, st in dtypes["gcn"]["kernels"].items()}

    k5_dtypes = {
        **{f"{dt} A @ A 10M grid": {**v["k5"], "launches": v["launches"][
            "segcompact"]} for dt, v in dtypes["a_at_a_10M"].items()},
        **{f"coalesce 122M {tag}": {**v["k5"], "launches": v["launches"][
            "segcompact"]} for tag, v in dtypes["coalesce_122M"].items()}}

    k256 = train["sddmm"][256]
    ga = models["sage"]["attention"]["4x128"]
    fused = train["fused"]
    sp, sd = span_k["spmm_spans"], span_k["sddmm_spans"]
    fs = span_k["spmm_sddmm_spans"]
    zipf = span_k["zipf"]
    fold = zipf["fold_pieces"]

    def zipf_1_8(kernel):
        """The kernel alone on zipf 1/8 in f32 and bf16, beside its
        library call in the same dtype."""
        return {"hub_edges": zipf["hub_edges"], "K": 256,
                **{dt: {**zipf[dt][kernel],
                        "gather_bound_ms": zipf[dt]["gather_bound_ms"]}
                   for dt in ("float32", "bfloat16")}}
    print(json.dumps({"kernels": [
        {"name": "spmm_csr", "route": "cuda",
         "source": "paddle_sparse_tpu_torch/csrc/spmm_spans.cu",
         "source_note": "the multi-span kernel at S = 1 over the CSR "
                        "pointer, through spmm_csr_cuda",
         "replaces": "paddle_sparse_tpu/ops/kernels/spmm_pallas.py:45",
         "launches": train["spmm_launches"],
         "launches_by_path": by_path("spmm_csr"),
         "dtypes": by_dtype("spmm_csr"),
         "ints": {"int32 K=47": ints["label_counts"],
                  "int64 K=1": ints["two_hop"],
                  "at": "phase 4's graph as a structural A, 2,449,029 "
                        "nodes, 122,451,450 nnz"},
         "max_abs_err": fwd["max_abs_err"], "ms": fwd["ms"],
         "plain_ms": fwd["plain_ms"], "bound_ms": fwd["bound_ms"],
         "bound_by": fwd["bound_by"], "library_ms": fwd["library_ms"],
         "library": "torch.sparse.mm on the CSR",
         "gather_bound_ms": fwd["gather_bound_ms"], "K": 256,
         "ms_on_seg2_graph": sp["k1_same_graph_ms"],
         "zipf_1_8": zipf_1_8("spmm_csr"),
         "clustered": walk},
        {"name": "sddmm_csr", "route": "cuda",
         "source": "paddle_sparse_tpu_torch/csrc/sddmm_spans.cu",
         "source_note": "the span SDDMM at S = 1 over the CSR pointer, "
                        "through sddmm_csr_cuda",
         "replaces": "paddle_sparse_tpu/ops/kernels/spmm_pallas.py:877",
         "replaces_note": "K2 as ops/spmm_seg2.py:559 calls it; on the JAX "
                          "GCN train path d value is an XLA gather-dot "
                          "(ops/spmm.py:102-105, spmm_pallas.py:564-566); "
                          "its span form is sddmm_spans",
         "launches": train["sddmm_launches"],
         "launches_by_path": by_path("sddmm_csr"),
         "dtypes": by_dtype("sddmm_csr"),
         "max_abs_err": k256["max_abs_err"], "ms": k256["ms"],
         "plain_ms": k256["plain_ms"], "bound_ms": k256["bound_ms"],
         "bound_by": k256["bound_by"], "library_ms": k256["library_ms"],
         "library": "torch.sparse.sampled_addmm on the CSR",
         "gather_bound_ms": k256["gather_bound_ms"], "K": 256,
         "ms_K100": train["sddmm"][100]["ms"],
         "plain_ms_K100": train["sddmm"][100]["plain_ms"],
         "zipf_1_8": zipf_1_8("sddmm_csr")},
        {"name": "spmm_sddmm_csc", "route": "cuda",
         "source": "paddle_sparse_tpu_torch/csrc/spmm_sddmm_csc.cu",
         "source_note": "the fused CSC backward, through "
                        "spmm_sddmm_csc_cuda: d x and d value from one "
                        "gather of g, where the backward ran K2, "
                        "value[perm] and K1 over the CSC view",
         "replaces": "paddle_sparse_tpu/ops/kernels/spmm_pallas.py:877",
         "replaces_also": ["paddle_sparse_tpu/ops/kernels/spmm_pallas.py:45"],
         "replaces_note": "K2 redesigned as the counterpart of "
                          "spmm_sddmm_chunked (spmm_pallas.py:481), the JAX "
                          "package's fused chunked backward, whose "
                          "pallas_call is K1's _reduce_kernel",
         "launches": train["fused_launches"],
         "launches_by_path": by_path("spmm_sddmm_csc"),
         "dtypes": by_dtype("spmm_sddmm_csc"),
         "max_abs_err": fused["max_abs_err"], "ms": fused["ms"],
         "plain_ms": fused["plain_ms"], "bound_ms": fused["bound_ms"],
         "bound_by": fused["bound_by"], "library_ms": fused["library_ms"],
         "library": "torch.sparse.mm of the transpose's CSR for d x; "
                    "sampled_addmm for d value in library_d_value_ms",
         "library_d_value_ms": fused["library_d_value_ms"],
         "pair_ms": fused["pair_ms"],
         "ms_note": "as the backward runs it: the two relays around the "
                    "launch, whose own time is launch_ms",
         "launch_ms": fused["launch_ms"],
         "value_relay_ms": fused["value_relay_ms"],
         "d_value_relay_ms": fused["d_value_relay_ms"],
         "gather_bound_ms": fused["gather_bound_ms"], "K": 256,
         "at": "GCN layer 1's backward (K=256 f32, 2,449,029 nodes), "
               "uniform graph",
         "zipf_1_8": {"hub_edges": zipf["hub_edges"],
                      **zipf["spmm_sddmm_csc"]}},
        {"name": "segcompact", "route": "cuda",
         "source": "paddle_sparse_tpu_torch/csrc/segcompact.cu",
         "replaces": "paddle_sparse_tpu/ops/kernels/segcompact.py:42",
         "replaces_note": "the JAX package runs K5 only under "
                          "PSP_SPGEMM_COMPRESS=kernel "
                          "(core/spgemm.py:363-386); its default compress "
                          "is XLA segment ops, which "
                          "this kernel also stands for, as it does for "
                          "spspmm_padded, spspmm_rowblocked and coalesce",
         "launches": sum(v["launches"]["segcompact"]
                         for v in spgemm.values()),
         "launches_by_path": by_path("segcompact"),
         "dtypes": k5_dtypes,
         "launches_row_sorted_by_path": by_path("segcompact_row_sorted"),
         "max_abs_err": k5["max_abs_err"], "ms": k5["ms"],
         "plain_ms": k5["plain_ms"], "bound_ms": k5["bound_ms"],
         "bound_by": k5["bound_by"], "library_ms": k5["library_ms"],
         "library": "torch.sparse_coo_tensor(...).coalesce() on K5's input "
                    "stream",
         "at": "10M-nnz A @ A rowsorted grid, rows sorted by K5",
         "old_sort_gather_k5_ms": k5["old_sort_gather_k5_ms"],
         "by_path": {p: v["k5"] for p, v in spgemm.items()},
         "a_at_a_stages_ms": {p: v["stages_ms"] for p, v in spgemm.items()}},
        {"name": "spmm_spans", "route": "cuda",
         "source": "paddle_sparse_tpu_torch/csrc/spmm_spans.cu",
         "replaces": "paddle_sparse_tpu/ops/kernels/spmm_pallas.py:708",
         "replaces_also": ["paddle_sparse_tpu/ops/kernels/spmm_pallas.py:601"],
         "replaces_note": "K3 through tilespan_call, K4 through "
                          "band_reduce_call, and the windowed _reduce_call "
                          "passes of ops/spmm_seg2.py::_seg_pass",
         "launches": packed_paths["seg2_uniform_f32"]["launches"][
             "spmm_spans"],
         "launches_by_path": by_path("spmm_spans"),
         "max_abs_err": sp["max_abs_err"], "ms": sp["ms"],
         "plain_ms": sp["plain_ms"], "bound_ms": sp["bound_ms"],
         "bound_by": sp["bound_by"], "library_ms": sp["library_ms"],
         "library": "torch.sparse.mm on the CSR of the same matrix",
         "gather_bound_ms": sp["gather_bound_ms"], "K": 256,
         "at": "seg2 forward, uniform 2,449,029 nodes, f32",
         "ms_bf16_x": sp["ms_bf16"], "zipf_1_8": zipf_1_8("spmm_spans"),
         "k1_same_graph_ms": sp["k1_same_graph_ms"],
         "band_reduce_r4_sizes": spans["band_reduce"],
         "max_abs_err_vs_f64_sweep": spans["max_abs_err"]},
        {"name": "sddmm_spans", "route": "cuda",
         "source": "paddle_sparse_tpu_torch/csrc/sddmm_spans.cu",
         "replaces": "paddle_sparse_tpu/ops/kernels/spmm_pallas.py:877",
         "replaces_note": "K2 at its one JAX call site, "
                          "ops/spmm_seg2.py:559 (_sddmm_pass)",
         "launches": packed_paths["seg2_uniform_f32"]["launches"][
             "sddmm_spans"],
         "launches_by_path": by_path("sddmm_spans"),
         "max_abs_err": sd["max_abs_err"], "ms": sd["ms"],
         "plain_ms": sd["plain_ms"], "bound_ms": sd["bound_ms"],
         "bound_by": sd["bound_by"], "library_ms": sd["library_ms"],
         "library": "torch.sparse.sampled_addmm on the CSR",
         "gather_bound_ms": sd["gather_bound_ms"], "K": 256,
         "at": "seg2 backward, uniform 2,449,029 nodes, f32",
         "zipf_1_8": zipf_1_8("sddmm_spans"),
         "split_max_abs_err_vs_f64": spans["split_max_abs_err"]},
        {"name": "spmm_sddmm_spans", "route": "cuda",
         "source": "paddle_sparse_tpu_torch/csrc/spmm_sddmm_csc.cu",
         "source_note": "the fused backward's span form, through "
                        "spmm_sddmm_spans_cuda: d x and d value of every "
                        "packed SpMM (seg2, seg3, split, spmm_seg) from one "
                        "gather of g over the transpose layout, where the "
                        "backward ran the spans SpMM over the transpose "
                        "and the span SDDMM over the forward layout",
         "replaces": "paddle_sparse_tpu/ops/kernels/spmm_pallas.py:192",
         "replaces_also": ["paddle_sparse_tpu/ops/kernels/spmm_pallas.py:901"],
         "replaces_note": "K1's pallas_call as ops/spmm_seg2.py::_seg_pass "
                          "(:439) runs it over the transpose layout for d x "
                          "in _spmm_seg2_bwd (:601); its d value is "
                          "_sddmm_pass (:503, XLA; K2's mul_rowsum_call "
                          "only under an opt-in switch)",
         "launches": packed_paths["seg2_uniform_f32"]["launches"][
             "spmm_sddmm_spans"],
         "launches_by_path": by_path("spmm_sddmm_spans"),
         "max_abs_err": fs["max_abs_err"], "ms": fs["ms"],
         "ms_note": "the launch alone, on values already in the "
                    "transpose's order; routed_ms adds the two gathers "
                    "through relay_ft and relay_tf, as the backward runs it",
         "routed_ms": fs["routed_ms"], "pair_ms": fs["pair_ms"],
         "plain_ms": fs["plain_ms"], "bound_ms": fs["bound_ms"],
         "bound_by": fs["bound_by"], "library_ms": fs["library_ms"],
         "library": "torch.sparse.mm of the transpose's CSR for d x + "
                    "sampled_addmm for d value",
         "library_d_x_ms": fs["library_d_x_ms"],
         "library_d_value_ms": fs["library_d_value_ms"],
         "gather_bound_ms": fs["gather_bound_ms"], "K": 256,
         "at": "seg2 backward, uniform 2,449,029 nodes, f32",
         "zipf_1_8": zipf["spmm_sddmm_spans"],
         "max_abs_err_vs_f64_sweep": spans["fused_max_abs_err"]},
        {"name": "fold_pieces", "route": "cuda",
         "source": "paddle_sparse_tpu_torch/csrc/spmm_spans.cu",
         "source_note": "fold_pieces_kernel, the second pass of a split "
                        "spans launch (K1, K3, K4) over split rows' "
                        "partials, through row_split.fold_pieces_cuda",
         "replaces": "paddle_sparse_tpu/ops/spmm.py:293",
         "replaces_note": "_fold_rows, an XLA segment_sum over the pseudo-"
                          "rows of _split_long_rows; no pallas_call of its "
                          "own",
         "launches": packed_paths["seg2_zipf_full_bf16"]["launches"][
             "fold_pieces"],
         "launches_by_path": by_path("fold_pieces"),
         "max_abs_err": fold["max_abs_err"], "ms": fold["ms"],
         "plain_ms": fold["plain_ms"], "bound_ms": fold["bound_ms"],
         "bound_by": fold["bound_by"], "library_ms": fold["library_ms"],
         "library": "index_add_ of the partials into their rows",
         "at": f"zipf 1/8 forward's {fold['rows']} split rows, "
               f"{fold['slots']} partials, K=256 f32"},
        {"name": "gat_attention", "route": "cuda",
         "source": "paddle_sparse_tpu_torch/csrc/gat_attention.cu",
         "source_note": "gat_node_scores_kernel, then gat_edge_softmax_"
                        "kernel (with split rows gat_fold_kernel and a "
                        "write pass), through gat_attention_cuda",
         "replaces": None,
         "replaces_note": "XLA fuses the JAX GAT's scores and edge_softmax "
                          "(paddle_sparse_tpu/models/gcn.py); no "
                          "pallas_call",
         "launches": models["gat"]["train_step"]["launches"][
             "gat_attention"],
         "launches_by_path": by_path("gat_attention"),
         **{k: ga[k] for k in ("ms", "plain_ms", "bound_ms",
                               "max_abs_err", "parts_ms")},
         "bound_by": "bytes once over 3.35 TB/s",
         "library": None, "library_note": "no PyTorch call computes the "
                                          "edge softmax",
         "at": "gat-products.eval's hidden layer, 4 x 128 f32, on phase 4's "
               "graph (2,449,029 nodes, 122,451,450 entries)",
         "shapes": {**{f"products {k}": v
                       for k, v in models["sage"]["attention"].items()},
                    **{f"zipf 1/8 {k}": v
                       for k, v in models["gat"]["attention"].items()}}},
        *probe_kernels(probes)]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

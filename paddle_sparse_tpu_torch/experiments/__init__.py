"""The TPU probes of ``experiments/`` asked of the card.

Each module here has the file name, command-line arguments, defaults and
printed fields of its counterpart under ``experiments/`` and runs the same
function through a hand-written kernel of ``csrc/probes.cu`` (or K1/K4 of
``csrc/spmm_spans.cu``):

* ``bisect_pallas``: ``2 * x``, chunk sums staged through one or two
  shared-memory slots, and ``segment_rows_matmul`` (K1);
* ``r4_dma_issue``: the cost of issuing one async copy of a span per step;
* ``r4_band_cost``: K4 at the probe's sizes and its cost bisect;
* ``r5_vmem_expand``: a row gather served from a slice held on chip against
  ``index_select`` from a 64 MB source.

Run one on the card with ``python -m paddle_sparse_tpu_torch.experiments.
<name> [args]``. Every entry point takes ``device="cuda"`` by default and
raises without a card; ``device="cpu"`` runs the plain versions. No module
reads ``sys.argv`` when it is imported: only ``main`` does.
"""

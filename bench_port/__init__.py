"""The benchmark of ``paddle_sparse_tpu_torch`` on one NVIDIA H100.

``run.py`` runs one cell once; ``BENCHMARK.json`` at the checkout's root
names the cells. Everything that decides a run's numbers lives here, apart
from the program: the generators (``graphs.py``), the work counted from
shapes (``work.py``), the card's peaks (``peaks.py``), the reading of the
profiler's trace (``devtrace.py``), the plain reference (``reference/``)
and the comparison that decides ``correct`` (``compare.py``, with each
cell's limits in ``limits/``). Nothing here imports ``jax`` or the JAX
package.
"""

"""The port's ``profiling`` module: ``scope`` names a range that
torch.profiler records, ``trace`` writes a Chrome trace into ``log_dir``,
``time_fn`` calls the function ``warmup + iters`` times and returns seconds
per call, and ``SpmmRoofline`` is the JAX package's byte model, equal to
it exactly."""
import json

import pytest
import torch

from paddle_sparse_tpu.profiling import SpmmRoofline as JRoofline
from paddle_sparse_tpu_torch import profiling


def test_scope_is_recorded_in_a_trace(tmp_path):
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.scope("psp_spmm_block"):
            torch.ones(8, 8) @ torch.ones(8, 8)
    names = {e.key for e in prof.key_averages()}
    assert "psp_spmm_block" in names
    events = json.loads((tmp_path / "trace.json").read_text())
    events = events["traceEvents"] if isinstance(events, dict) else events
    assert any(e.get("name") == "psp_spmm_block" for e in events)


def test_scope_without_a_profiler_runs_the_block():
    ran = []
    with profiling.scope("outside"):
        ran.append(1)
    assert ran == [1]


def test_time_fn_counts_calls():
    calls = []
    s = profiling.time_fn(lambda a: calls.append(a), 3, iters=5, warmup=2)
    assert calls == [3] * 7 and s >= 0.0


@pytest.mark.parametrize("nnz,rows,dim,ib,vb", [(100, 10, 8, 4, 4),
                                                (122_451_450, 2_449_029,
                                                 256, 4, 2)])
def test_roofline_matches_jax(nnz, rows, dim, ib, vb):
    t, j = (R(nnz, rows, dim, ib, vb) for R in (profiling.SpmmRoofline,
                                                JRoofline))
    assert t.bytes_moved == j.bytes_moved
    assert t.fraction(0.05, 3350.0) == j.fraction(0.05, 3350.0)

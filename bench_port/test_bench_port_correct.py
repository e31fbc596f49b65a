"""What decides ``correct``, on the CPU at a size a test run holds.

* A run of each cell, the card check skipped and the program's plain
  path underneath, comes out correct; with each fault the cell can have
  planted under the harness (``faults.py``: a step that leaves the state
  unchanged, half the batch left out with the mean over the rest, one row
  of an SpMM's answer altered where it is made) it comes out not correct.
* The control, the reference in the program's place in TF32 (the
  precision below the configuration's full f32), fails a limit of every
  cell.
* The import check compares top-level names whole, and a run loads
  neither ``jax`` nor the JAX package; the reference loads nothing of the
  program; a folder holding only the benchmark prints no result.
"""
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest

from bench_port import faults, run, spec

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
TINY = {"num_nodes": 2000, "degree": 10}
SEED = 2**31 + 77


def _run(workload, seed=SEED):
    return run.run_cell(workload, seed, 0.2, False, device="cpu",
                        sizes=TINY, t0=time.perf_counter())


def _cases():
    for w in CELLS:
        mode = spec.load_cell(ROOT, w).traffic["mode"]
        for f in (None,) + faults.FAULTS[mode]:
            yield w, f


@pytest.mark.parametrize("workload,fault", list(_cases()))
def test_correct_only_without_a_fault(workload, fault):
    import paddle_sparse_tpu_torch as psp
    if fault is None:
        res = _run(workload)
        assert res["correct"], res["checks"]
        assert res["attempted"] > 0 and res["failed"] == 0
        return
    with faults.planted(fault, psp):
        res = _run(workload)
    assert not res["correct"], res["checks"]
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_a_limit(workload):
    cell = spec.load_cell(ROOT, workload)
    cell = cell._replace(config={**cell.config, **TINY})
    model, refmod = spec.model_module(cell), spec.reference_module(cell)
    drv = spec.driver_module(cell)
    ref = drv.reference_readings(cell, model, refmod, SEED, "cpu")
    ctl = drv.control_readings(cell, drv.reference_readings(
        cell, model, refmod, SEED, "cpu", control=True))
    from bench_port import compare
    held = compare.held(drv.numbers(cell, ctl, ref), cell.limits)
    assert not all(ok for *_, ok in held), held


def test_result_line_keys_and_order():
    res = _run("gcn-products.eval")
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert set(res["metrics"]) == {"forward_ms", "peak_mem_gb", "setup_s"}
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"}


def test_forbidden_names_compared_whole():
    assert run.forbidden_modules(["paddle_sparse_tpu_torch",
                                  "paddle_sparse_tpu_torch.ops",
                                  "jaxtyping", "flaxen", "torch"]) == []
    assert run.forbidden_modules(["jax.numpy", "jaxlib.xla_client",
                                  "flax", "paddle_sparse_tpu.ops"]) == [
        "flax", "jax", "jaxlib", "paddle_sparse_tpu"]


def _python(code, cwd=ROOT):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd,
                          capture_output=True, text=True, timeout=600)


def test_a_run_loads_no_jax():
    code = ("import sys, time; sys.path.insert(0, '.');"
            "from bench_port import run;"
            "r = run.run_cell('gcn-products.train-edgegrad', 3, 0.1, True,"
            " device='cpu', sizes={'num_nodes': 500, 'degree': 4});"
            "print(r['correct'], run.forbidden_modules())")
    out = _python(code)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split()[-2:] == ["True", "[]"]


def test_the_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, '.');"
            "import bench_port.reference.gcn, bench_port.reference.sage,"
            " bench_port.reference.train, bench_port.compare,"
            " bench_port.graphs;"
            "print(sorted({m.split('.')[0] for m in sys.modules}"
            " & {'paddle_sparse_tpu_torch', 'paddle_sparse_tpu', 'jax'}))")
    out = _python(code)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"


def test_only_the_benchmark_prints_no_result(tmp_path):
    shutil.copytree(BENCH, tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run(
        [sys.executable, "bench_port/run.py", "--workload",
         "gcn-products.eval", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=600)
    assert out.returncode != 0
    assert "correct" not in out.stdout
    # and the program, asked for from there, is not found
    code = ("import sys; sys.path.insert(0, '.');"
            "from bench_port.run import import_program;"
            "from pathlib import Path; import_program(Path('.').resolve())")
    out = _python(code, cwd=tmp_path)
    assert out.returncode != 0 and "ModuleNotFoundError" in out.stderr


def test_calibrate_runs_on_the_cpu(tmp_path, capsys):
    """``calibrate.py`` end to end at a small size: the program's readings
    within every limit, the control and each fault beyond one."""
    from bench_port import calibrate
    out = tmp_path / "calib.jsonl"
    assert calibrate.main([
        "--workload", "sage-products.train", "--seeds", "2",
        "--first-seed", str(SEED), "--control", "1", "--faults", "1",
        "--device", "cpu", "--num-nodes", "1000", "--out", str(out)]) == 0
    summary = json.loads(out.read_text().splitlines()[-1])["summary"]
    limits = spec.load_cell(ROOT, "sage-products.train").limits
    assert set(summary) == {"program", "control", "unchanged", "half_batch"}
    for k, lim in limits.items():
        assert summary["program"][k] <= lim["limit"], k
    for what in ("control", "unchanged", "half_batch"):
        assert any(summary[what][k] > lim["limit"]
                   for k, lim in limits.items()), what

"""Discovery by name, and ``BENCHMARK.json`` against the benchmark's rules.

Every cell's configuration, traffic mix, limits, model, reference and
driver are found by the names ``BENCHMARK.json`` gives; each per-layer
metric by its own file. A cell and a metric added as new files in a copy of
the folder (no file edited) are found and reported by a run on the CPU."""
import json
import re
import shutil
import time
from pathlib import Path

import pytest

from bench_port import spec

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TINY = {"num_nodes": 600, "degree": 6}


def test_benchmark_json_keys_and_names():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "bench_port/run.py"]
    assert SPEC["paths"] == ["bench_port"]
    assert 1 <= SPEC["run_seconds"] <= 51
    names = [c["name"] for c in SPEC["configs"]] + \
        [w["name"] for w in SPEC["workloads"]] + \
        [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in SPEC["workloads"]]:
        assert NAME.match(n), n
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("bench_port/")
        assert set(c["reduced"]) <= set(json.loads(
            (ROOT / c["file"]).read_text()))
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["moves"] in [e["name"] for e in SPEC["end_to_end"]]
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for text in [c["why"] for c in SPEC["configs"]] + \
            [c["source"] for c in SPEC["configs"]] + \
            [m["layer"] for m in SPEC["per_layer"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_each_cell_finds_its_files(workload):
    cell = spec.load_cell(ROOT, workload)
    assert cell.config["model"] in ("gcn", "sage")
    assert set(cell.limits) >= {"grad", "grad_diff", "change_diff"} or \
        set(cell.limits) == {"logits"}
    assert spec.model_module(cell).REFERENCE == cell.config["model"]
    assert hasattr(spec.reference_module(cell), "forward")
    assert hasattr(spec.driver_module(cell), "run")
    readers = spec.metric_readers(cell)
    assert readers and all(callable(r.read) for r in readers.values())
    # every cell reports setup_s, another end-to-end metric and a
    # per-layer one
    e2e = [m["name"] for m in cell.end_to_end]
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in e2e


def test_every_metric_and_config_file_is_used():
    metric_files = {p.name[:-3] for p in (BENCH / "metrics").glob("*.py")}
    assert metric_files == {m["name"] for m in SPEC["per_layer"]}
    config_files = {p.name for p in (BENCH / "configs").glob("*.json")}
    assert config_files == {Path(c["file"]).name for c in SPEC["configs"]}


def test_a_new_cell_and_metric_need_no_edit(tmp_path):
    """Copy the folder, add a traffic mix, a limits file and a metric
    reader as new files and a cell in BENCHMARK.json: a CPU run of the new
    cell reports the new metric."""
    bench = tmp_path / "bench_port"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns(
        "__pycache__"))
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    (bench / "traffic" / "eval-clustered.json").write_text(json.dumps({
        "driver": "fullbatch", "mode": "eval", "graph": "clustered",
        "graph_args": {"community": 64, "p_in": 0.8},
        "value_grad": False, "why": "a new mix"}))
    (bench / "limits" / "gcn-products.eval-clustered.json").write_text(
        (bench / "limits" / "gcn-products.eval.json").read_text())
    (bench / "metrics" / "steps_seen.py").write_text(
        "def read(ctx):\n    return float(ctx.steps)\n")
    new = json.loads(json.dumps(SPEC))
    new["workloads"].append({"name": "gcn-products.eval-clustered",
                             "config": "gcn-products",
                             "traffic": "eval-clustered", "chips": 1,
                             "why": "test"})
    new["per_layer"].append({"name": "steps_seen", "unit": "count",
                             "better": "higher", "source": "host_clock",
                             "layer": "test", "moves": "forward_ms",
                             "workloads": ["gcn-products.eval-clustered"]})
    for m in new["end_to_end"] + new["per_layer"]:
        if "gcn-products.eval" in m.get("workloads", []):
            m["workloads"].append("gcn-products.eval-clustered")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(new))
    after = {p: p.read_bytes() for p in before}
    assert after == before                     # nothing edited

    cell = spec.load_cell(tmp_path, "gcn-products.eval-clustered", bench)
    assert cell.traffic["graph"] == "clustered"
    assert "steps_seen" in spec.metric_readers(cell)
    from bench_port import run
    res = run.run_cell("gcn-products.eval-clustered", 5, 0.2, True,
                       device="cpu", spec_root=tmp_path, bench=bench,
                       sizes=TINY, t0=time.perf_counter())
    assert res["correct"]
    assert res["metrics"]["steps_seen"]["value"] == res["attempted"] > 0
    assert "structure_s" in res["metrics"]
    # and the cells already there are untouched by the addition
    assert spec.load_cell(tmp_path, "gcn-products.eval", bench).traffic == \
        spec.load_cell(ROOT, "gcn-products.eval").traffic


def test_unknown_workload_names_the_cells():
    with pytest.raises(KeyError, match="gcn-products.eval"):
        spec.load_cell(ROOT, "no-such-cell")


PATHS = {  # launches a step (or a forward): K1, K2, K2', fold
    "gcn-products.train-edgegrad": (3, 1, 2, 0),
    "sage-products.train": (5, 0, 0, 0),
    "sage-products.train-clustered": (5, 0, 0, 0),
    "gcn-products.eval": (3, 0, 0, 0),
}


@pytest.mark.parametrize("workload", sorted(PATHS))
def test_each_cell_expects_its_path(workload):
    from bench_port.drivers import fullbatch
    cell = spec.load_cell(ROOT, workload)
    model = spec.model_module(cell)
    keys = ("spmm_csr", "sddmm_csr", "spmm_sddmm_csc", "fold_pieces")
    assert fullbatch.expected_launches(cell, model) == dict(
        zip(keys, PATHS[workload]))
    # a traffic file may state its own, where the rule does not hold
    own = dict(zip(keys, (5, 0, 0, 2)))
    cell = cell._replace(traffic={**cell.traffic, "launches": own})
    assert fullbatch.expected_launches(cell, model) == own

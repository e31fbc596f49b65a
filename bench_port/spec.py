"""What a cell is made of, found by name under the benchmark's folder.

``BENCHMARK.json`` at the checkout's root names each cell's configuration
and traffic mix. The rest is looked up by name, so a later cell or metric
is a new file and never an edit:

* ``configs/<config>.json``: the model and its sizes (the file that
  ``BENCHMARK.json``'s ``configs[].file`` names);
* ``traffic/<traffic>.json``: the graph, train or eval, value grads, the
  launches of the path where the rule for it does not hold, and the
  ``driver`` that runs it (``drivers/<driver>.py``);
* ``models/<model>.py`` and ``reference/<model>.py``: how the program
  builds the configuration's model and the work of its equations, and its
  plain reference;
* ``limits/<workload>.json``: each compared number's limit, with the
  readings it was set from (a cell without one cannot be judged);
* ``metrics/<metric>.py``: one reader per per-layer metric.
"""
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List, NamedTuple

BENCH_DIR = Path(__file__).resolve().parent


class Cell(NamedTuple):
    name: str
    bench: Path           # the benchmark's folder
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]     # the end-to-end metrics this cell reports
    per_layer: List[dict]      # the per-layer metrics this cell reports


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str) -> ModuleType:
    """A module from a file, under a private name (metric files have dots
    in their names)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reports(metric: dict, cell: str, e2e_names: List[str]) -> bool:
    """An end-to-end metric without ``workloads`` is every cell's; a
    per-layer one, every cell that reports the metric it ``moves``."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_names


def load_cell(root: Path, workload: str, bench: Path = BENCH_DIR) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json``, its files read
    from ``bench``."""
    spec = read_json(Path(root) / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; have "
                       f"{sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    config = read_json(Path(root) / configs[w["config"]]["file"])
    traffic = read_json(bench / "traffic" / f"{w['traffic']}.json")
    lim = bench / "limits" / f"{workload}.json"
    limits = read_json(lim) if lim.exists() else {}
    e2e = [m for m in spec["end_to_end"] if _reports(m, workload, [])]
    e2e_names = [m["name"] for m in e2e]
    per_layer = [m for m in spec["per_layer"]
                 if _reports(m, workload, e2e_names)]
    return Cell(workload, bench, int(w["chips"]), config, traffic, limits,
                e2e, per_layer)


def metric_readers(cell: Cell) -> Dict[str, ModuleType]:
    """Each per-layer metric's reader, ``metrics/<name>.py``."""
    return {m["name"]: load_module(cell.bench / "metrics" / f"{m['name']}.py",
                                   f"bench_port_metric_{i}")
            for i, m in enumerate(cell.per_layer)}


def model_module(cell: Cell) -> ModuleType:
    """``models/<model>.py`` of the configuration's ``model``."""
    return importlib.import_module(f"bench_port.models.{cell.config['model']}")


def reference_module(cell: Cell) -> ModuleType:
    """``reference/<model>.py``: the plain reference the model module
    names."""
    return importlib.import_module(
        f"bench_port.reference.{model_module(cell).REFERENCE}")


def driver_module(cell: Cell) -> ModuleType:
    """``drivers/<driver>.py`` of the traffic's ``driver``."""
    return importlib.import_module(
        f"bench_port.drivers.{cell.traffic['driver']}")

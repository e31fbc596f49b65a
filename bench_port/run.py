"""Run one cell of the benchmark of ``paddle_sparse_tpu_torch`` once.

    python3 bench_port/run.py --workload <name> --seed <n> \\
        --seconds <run_seconds> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, this folder and
the program. The run makes its inputs on the card from ``--seed``, sets the
program up and warms it (``setup_s``: from the first line of this file to
the first timed step, the kernels' build included), measures for
``--seconds``, then checks what the timed path produced against the plain
reference (``reference/``), and prints one JSON line last: ``correct``,
``attempted``, ``failed``, the cell's end-to-end metrics (``--trace 0``) or
its per-layer metrics (``--trace 1``, from the profiler's trace of the
window), ``device``, with ``--trace 1`` a ``breakdown``, and last
``checks``, each compared number with its limit; those also close standard
error.

It exits non-zero and prints no result without a card (or with fewer than
the cell asks for), without the program beside it, or when ``jax``,
``jaxlib``, ``flax`` or the JAX package ``paddle_sparse_tpu`` is loaded in
this process once the window has closed (names compared whole: the port's
own name begins with the JAX package's).

It keeps Python's bytecode under ``.bench_port_cache/`` in the checkout, so
that only a checkout's first run compiles torch's modules.
"""
import time

T0 = time.perf_counter()

import argparse      # noqa: E402
import importlib     # noqa: E402
import json          # noqa: E402
import subprocess    # noqa: E402
import sys           # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

PROGRAM = "paddle_sparse_tpu_torch"
PYCACHE = ".bench_port_cache/pycache"     # under the checkout, git-ignored
FORBIDDEN = ("jax", "jaxlib", "flax", "paddle_sparse_tpu")


def log(msg: str) -> None:
    print(f"bench: {msg}", file=sys.stderr, flush=True)


def forbidden_modules(names=None):
    """The forbidden top-level names among ``names`` (default: the loaded
    modules), each module's name cut at its first dot and compared
    whole."""
    names = sys.modules if names is None else names
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def import_program(root: Path):
    """The program from ``root``, never from another installation."""
    if str(root) not in sys.path:
        sys.path.insert(0, str(root))
    psp = importlib.import_module(PROGRAM)
    where = Path(psp.__file__).resolve()
    if not where.is_relative_to(Path(root).resolve()):
        raise ImportError(f"{PROGRAM} was imported from {where}, not from "
                          f"the checkout {root}")
    return psp


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", spec_root: Path = ROOT,
             bench: Path = None, sizes: dict = None,
             t0: float = None) -> dict:
    """One run of ``workload``: the result dict that :func:`main` prints.
    The card check and the import check are :func:`main`'s. Tests pass
    another ``spec_root`` (where ``BENCHMARK.json`` lies) and ``bench``
    folder, and ``sizes`` over the configuration's, to run on the CPU."""
    import torch
    from bench_port import compare, devtrace, peaks, spec

    t0 = T0 if t0 is None else t0
    log(f"imports done at {time.perf_counter() - t0:.3f} s")
    cell = spec.load_cell(spec_root, workload, bench or spec.BENCH_DIR)
    if sizes:
        cell = cell._replace(config={**cell.config, **sizes})
    model, refmod = spec.model_module(cell), spec.reference_module(cell)
    driver = spec.driver_module(cell)
    cfg = cell.config
    # float32 throughout, the GEMMs in full f32 (the driver runs no other)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    psp = import_program(ROOT)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        from paddle_sparse_tpu_torch.ops.kernels import _build
        t = time.perf_counter()
        _build.load_library()
        log(f"kernels built or loaded in {time.perf_counter() - t:.3f} s"
            f" (at {time.perf_counter() - t0:.3f} s)")
    res = driver.run(cell, psp, model, refmod, seed, seconds, trace, device,
                     t0, log)
    checks = compare.held(res["numbers"], cell.limits)
    if res["path_off"] is not None:
        checks.append(("launches_off", float(res["path_off"]), 0.0,
                       res["path_off"] == 0))
    kind = torch.cuda.get_device_name(0) if cuda else "cpu"
    dev = {"platform": "gpu" if cuda else "cpu", "kind": kind,
           "count": cell.chips, "memory_peak_bytes": res["memory_peak_bytes"]}
    out = {"correct": all(ok for *_, ok in checks) and res["failed"] == 0,
           "attempted": res["attempted"], "failed": res["failed"]}
    if not trace:
        out["metrics"] = {m["name"]: {"value": res["e2e"][m["name"]],
                                      "unit": m["unit"]}
                          for m in cell.end_to_end}
    else:
        tr = res["trace"]
        ctx = SimpleNamespace(
            cell=cell, config=cfg, traffic=cell.traffic, train=res["train"],
            model=model, n=res["n"], nnz=res["nnz"], steps=res["attempted"],
            trace=tr, window_s=devtrace.window_seconds(tr),
            busy_s=devtrace.busy_seconds(tr),
            port=devtrace.matcher(devtrace.kernel_names(
                Path(psp.__file__).parent / "csrc")),
            peak=peaks.peak(kind), itemsize=peaks.FLOAT32_BYTES,
            spans=res["spans"], launches=res["launches"])
        readers = spec.metric_readers(cell)
        out["metrics"] = {}
        for m in cell.per_layer:
            v = readers[m["name"]].read(ctx)
            if v is not None:
                out["metrics"][m["name"]] = {"value": float(v),
                                             "unit": m["unit"]}
        dev["busy_s"] = ctx.busy_s
        dev["window_s"] = ctx.window_s
        out["breakdown"] = {"device_ops": devtrace.top_ops(tr),
                            "idle_gaps": devtrace.top_gaps(tr)}
    out["device"] = dev
    if "breakdown" in out:
        out["breakdown"] = out.pop("breakdown")
    out["checks"] = {name: {"value": v, "limit": lim}
                     for name, v, lim, _ in checks}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from bench_port import spec
    cell = spec.load_cell(ROOT, args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        log(f"needs {cell.chips} CUDA card(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    torch.set_num_threads(4)
    res = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    log(f"{args.workload} seed {args.seed}: {card_line()}")
    bad = forbidden_modules()
    if bad:
        log(f"forbidden modules loaded in this process: {bad}")
        return 3
    for name, c in res["checks"].items():
        ok = c["value"] <= c["limit"]
        print(f"check {name} {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if ok else 'FAIL'}", file=sys.stderr, flush=True)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    # Python's bytecode of torch and of the checkout, kept inside the
    # checkout: an installation without it (and with the writing of it
    # turned off) compiles every module of torch in every run
    sys.dont_write_bytecode = False
    sys.pycache_prefix = str(ROOT / PYCACHE)
    sys.exit(main())

"""The readings that a cell's limits are set from, on the card at the
cell's own size, in one process:

    python3 bench_port/calibrate.py --workload <name> --seeds <n> \\
        --first-seed <s> [--control <k>] [--faults <k>] [--out <file>]

* the program, on ``--seeds`` seeds from ``--first-seed``: set up as a run
  sets it up, its first steps (training) or ten forwards (inference),
  compared with the float64 reference: the lower readings;
* the control, on the first ``--control`` of those seeds: the reference
  itself in the program's place, in float32 with TF32 GEMMs (the nearest
  precision below the configuration's full f32), compared the same way:
  the upper readings;
* each fault the cell can have (``faults.py``), planted in the program, on
  the first ``--faults`` seeds.

Each reading is one JSON line (on standard output, and appended to
``--out``); the last line gives each number's largest program reading and
the smallest control and fault readings. A run of the benchmark never runs
this.
"""
import argparse
import contextlib
import json
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

EVAL_FORWARDS = 10


def program_readings(drv, cell, psp, model, seed, device):
    import torch
    st = drv.prepare(cell, psp, model, seed, device, {})
    if drv.is_train(cell):
        prog = drv.first_steps(st)
    else:
        for _ in range(drv.WARM_FORWARDS):
            out = drv.forward(st)
        stash = torch.empty(EVAL_FORWARDS, st.rows.numel(),
                            cell.config["out_channels"], device=device)
        for i in range(EVAL_FORWARDS):
            out = drv.forward(st)
            torch.index_select(out, 0, st.rows, out=stash[i])
        prog = {"out": out, "samples": stash}
    del st
    drv.free(device)
    return prog


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first-seed", type=int, required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--faults", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    ap.add_argument("--num-nodes", type=int, help="a smaller graph (tests)")
    args = ap.parse_args(argv)

    import torch
    from bench_port import faults, spec
    from bench_port.run import import_program
    cell = spec.load_cell(ROOT, args.workload)
    if args.num_nodes:
        cell = cell._replace(config={**cell.config,
                                     "num_nodes": args.num_nodes})
    model, refmod = spec.model_module(cell), spec.reference_module(cell)
    drv = spec.driver_module(cell)
    psp = import_program(ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    seeds = [args.first_seed + i for i in range(args.seeds)]
    mode = cell.traffic["mode"]
    table = {}

    def emit(what, seed, nums, t):
        rec = {"workload": args.workload, "what": what, "seed": seed,
               "numbers": nums, "seconds": time.perf_counter() - t}
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        for k, v in nums.items():
            table.setdefault(what, {}).setdefault(k, []).append(v)

    for i, seed in enumerate(seeds):
        plans = [("program", None)]
        if i < args.faults:
            plans += [(f, f) for f in faults.FAULTS[mode]]
        refs = drv.reference_readings(cell, model, refmod, seed, args.device)
        for what, fault in plans:
            t = time.perf_counter()
            with (faults.planted(fault, psp) if fault
                  else contextlib.nullcontext()):
                prog = program_readings(drv, cell, psp, model, seed,
                                        args.device)
            nums = drv.numbers(cell, prog, refs)
            del prog
            drv.free(args.device)
            emit(what, seed, nums, t)
        if i < args.control:
            t = time.perf_counter()
            ctl = drv.control_readings(cell, drv.reference_readings(
                cell, model, refmod, seed, args.device, control=True))
            nums = drv.numbers(cell, ctl, refs)
            emit("control", seed, nums, t)
            del ctl
        del refs
        drv.free(args.device)

    summary = {"workload": args.workload, "summary": {
        what: {k: (max(v) if what == "program" else min(v))
               for k, v in nums.items()}
        for what, nums in table.items()}}
    line = json.dumps(summary, default=lambda v: None if math.isnan(v)
                      else v)
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

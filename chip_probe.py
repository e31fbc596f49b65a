"""Measurements of paddle_sparse_tpu_torch on one NVIDIA GPU (written for an
H100) that ``chip_smoke.py`` does not take on every run. Run from the
repository root:

    python3 chip_probe.py sweep        # the long-row cap sweep
    python3 chip_probe.py ab PARENT    # this tree against another, in turns

``sweep``: the span kernels, K1 and K2 alone at K=256 on the bench's zipf
graph at 1/8 scale (``chip_smoke.bench_graph``) for each piece size ``cap``
in 512 ... 16384, each timed with CUDA events after a warm-up, in f32 and
bf16, and on the uniform graph, which no cap in that range splits. One JSON
line per cap.

``ab PARENT``: the uniform GCN forward (phase 4), train step (phase 5) and
seg2 f32 forward and forward+backward (phase 7c) of ``chip_smoke.py``, run
from ``PARENT`` (another checkout, e.g. ``git archive`` of the parent
commit) and from this tree in turns: parent, this, this, parent, each in a
process of its own. One JSON line per run, then their summary.

Both print the card's ``nvidia-smi`` name and power limit and exit non-zero
without a card.
"""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import torch

CAPS = (512, 1024, 2048, 4096, 8192, 16384)
REPS = 5

# the phases one A/B run takes, from the checkout it runs in
AB_RUN = r"""
import json, torch, chip_smoke as c
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda", 0)
adj, x, model, _ = c.phase4_forward(dev, "")
torch.cuda.empty_cache()
c.phase5_train(dev, "", adj, x, model)
del adj, x, model
torch.cuda.empty_cache()
graph = c.bench_graph(dev, "uniform", 1.0, 256)
st = c.phase7c_path(dev, "", "seg2 uniform f32", "seg2", graph, "f32")
print("AB_SEG2 " + json.dumps({k: st["stats"][k]
                               for k in ("fwd_ms", "fwd_bwd_ms")}))
"""


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def sweep() -> None:
    import chip_smoke as c
    from paddle_sparse_tpu_torch import (ind2ptr, make_seg2_plan,
                                         pack_values, sddmm_csr_cuda,
                                         sddmm_spans_cuda, spmm_csr_cuda,
                                         spmm_spans_cuda, split_rows)
    dev = torch.device("cuda", 0)
    card = card_line()
    for kind, scale in (("zipf", 0.125), ("uniform", 1.0)):
        row, col, val, x = c.bench_graph(dev, kind, scale, 256)
        n, K = x.shape
        plan, s = make_seg2_plan(row, col, n, n, feat_dim=K)
        packed = pack_values(s, val)
        st, en = s.rp_f[:, :n], s.rp_f[:, 1:n + 1]
        rowptr = ind2ptr(row, n).to(torch.int32)
        g = torch.randn(n, K, generator=torch.Generator(
            device=dev).manual_seed(12), device=dev)
        longest = int(torch.diff(rowptr).max())
        for cap in CAPS:
            t_sp = split_rows(st, en, cap)
            t_csr = split_rows(rowptr[None, :-1], rowptr[None, 1:], cap)
            res = {"graph": f"{kind} {scale}", "nnz": row.numel(),
                   "longest_row": longest, "cap": cap,
                   "split_rows": 0 if t_sp is None
                   else t_sp.fold_row.numel(),
                   "pieces": 0 if t_sp is None else t_sp.num_slots}
            with torch.inference_mode():
                for dt in (torch.float32, torch.bfloat16):
                    xd, gd, pd, vd = x.to(dt), g.to(dt), packed.to(dt), \
                        val.to(dt)
                    name = str(dt)[6:]
                    res[f"spmm_spans_{name}"] = c.timed(
                        lambda: spmm_spans_cuda(st, en, s.col_f, pd,
                                                s.sbase_f, xd, out_dtype=dt,
                                                split=t_sp), REPS)[0]
                    res[f"sddmm_spans_{name}"] = c.timed(
                        lambda: sddmm_spans_cuda(st, en, s.col_f, s.sbase_f,
                                                 gd, xd, split=t_sp),
                        REPS)[0]
                    res[f"spmm_csr_{name}"] = c.timed(
                        lambda: spmm_csr_cuda(rowptr, col, vd, xd,
                                              split=t_csr), REPS)[0]
                    res[f"sddmm_csr_{name}"] = c.timed(
                        lambda: sddmm_csr_cuda(rowptr, col, gd, xd,
                                               split=t_csr), REPS)[0]
                    del xd, gd, pd, vd
            print("SWEEP " + json.dumps(res) + f" [{card}]", flush=True)
            if t_sp is None and t_csr is None and cap != CAPS[0]:
                break       # nothing splits from here on: the same launches
        del row, col, val, x, plan, s, packed, g
        torch.cuda.empty_cache()


def _ab_run(where: Path) -> dict:
    env = dict(os.environ, PYTHONPATH=str(where))
    out = subprocess.run([sys.executable, "-c", AB_RUN], cwd=where, env=env,
                         capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"A/B run in {where} failed:\n{out.stdout[-3000:]}"
                           f"\n{out.stderr[-3000:]}")

    def mean(pattern):
        return float(re.search(pattern + r".*?\(mean ([0-9.]+)",
                               out.stdout).group(1))
    seg2 = json.loads(re.search(r"^AB_SEG2 (.*)$", out.stdout,
                                re.M).group(1))
    return {"tree": str(where), "gcn_forward_ms": mean(r"phase 4 forward ms"),
            "gcn_train_step_ms": mean(r"phase 5 train step ms"),
            "seg2_f32_fwd_ms": seg2["fwd_ms"],
            "seg2_f32_fwd_bwd_ms": seg2["fwd_bwd_ms"]}


def ab(parent: Path) -> None:
    here = Path(__file__).resolve().parent
    card = card_line()
    runs = []
    for where in (parent, here, here, parent):
        r = _ab_run(where.resolve())
        r["side"] = "parent" if where == parent else "change"
        runs.append(r)
        print("AB " + json.dumps(r) + f" [{card}]", flush=True)
    summary = {}
    for k in ("gcn_forward_ms", "gcn_train_step_ms", "seg2_f32_fwd_ms",
              "seg2_f32_fwd_bwd_ms"):
        p = [r[k] for r in runs if r["side"] == "parent"]
        c = [r[k] for r in runs if r["side"] == "change"]
        summary[k] = {"parent": p, "change": c,
                      "change_vs_parent_pct":
                      100 * (sum(c) / sum(p) - 1)}
    print("AB_SUMMARY " + json.dumps(summary) + f" [{card}]", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_probe: no CUDA device visible", file=sys.stderr)
        return 1
    if len(sys.argv) >= 2 and sys.argv[1] == "sweep":
        sweep()
    elif len(sys.argv) == 3 and sys.argv[1] == "ab":
        ab(Path(sys.argv[2]))
    else:
        print(__doc__, file=sys.stderr)
        return 2
    print(card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())

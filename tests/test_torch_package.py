"""Package-level guarantees of paddle_sparse_tpu_torch: it never imports
JAX, it imports and runs its plain path without nvcc, its kernel build raises
instead of falling back, and chip_smoke.py refuses to pass without a card."""
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from paddle_sparse_tpu_torch.ops.kernels import _build

REPO = Path(__file__).resolve().parents[1]


def _run(code_or_args, cwd=REPO, env=None, timeout=120):
    args = (["-c", code_or_args] if isinstance(code_or_args, str)
            else code_or_args)
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_port_never_imports_jax():
    """With ``jax`` blocked, the package imports and the toy forward, one
    toy train step, the toy A @ A and a toy ``spmm_seg2`` forward and
    backward run; neither jax nor the JAX package is loaded."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import torch, paddle_sparse_tpu_torch as p\n"
        "model, adj, x = p.entry('cpu')\n"
        "with torch.inference_mode():\n"
        "    out = model(adj, x)\n"
        "assert out.shape == (256, 8) and bool(torch.isfinite(out).all())\n"
        "model, adj, x, y = p.train_entry('cpu')\n"
        "loss = p.train_step(model, adj, x, y, 0.1)\n"
        "assert bool(torch.isfinite(loss)) and loss.dim() == 0\n"
        "A = p.spgemm_entry('cpu')\n"
        "F, cap = p.plan_spgemm_rows(A, A)\n"
        "res = p.spspmm_rowsorted(A, A, F, cap)\n"
        "assert not res.overflowed and res.matrix.nnz > A.nnz\n"
        "plan, s, packed, x = p.spmm_entry('seg2', 'cpu')\n"
        "x.requires_grad_()\n"
        "out = p.spmm_seg2(plan, s, packed.requires_grad_(), x)\n"
        "out.sum().backward()\n"
        "assert out.shape == (256, 32) and x.grad.shape == (256, 32)\n"
        "assert bool(torch.isfinite(packed.grad).all())\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'paddle_sparse_tpu') and sys.modules[m]]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_entry_points_default_to_the_card(monkeypatch):
    """Every entry point defaults to ``device="cuda"`` and, without a card,
    raises naming the missing device instead of running on the CPU."""
    import inspect

    import torch

    import paddle_sparse_tpu_torch as p
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn, args in ((p.entry, ()), (p.train_entry, ()),
                     (p.spgemm_entry, ()), (p.spmm_entry, ("seg2",))):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(*args)
    with pytest.raises(ValueError, match="unknown SpMM backend"):
        p.spmm_entry("sell", "cpu")


def test_kernel_module_imports_without_nvcc(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "CUDA_HOME"}
    env["PATH"] = str(tmp_path)          # no nvcc on PATH
    code = (
        "import torch\n"
        "from paddle_sparse_tpu_torch.ops.kernels import spmm_cuda\n"
        "rowptr = torch.tensor([0, 2, 3], dtype=torch.int32)\n"
        "col = torch.tensor([0, 1, 1], dtype=torch.int32)\n"
        "out = spmm_cuda.spmm_csr_cuda(rowptr, col, None, torch.eye(2))\n"
        "assert out.tolist() == [[1.0, 1.0], [0.0, 1.0]], out\n"
        "assert spmm_cuda.spmm_csr_cuda.launches == 0\n")
    proc = _run(code, env=env)
    assert proc.returncode == 0, proc.stderr


def test_build_raises_without_nvcc(tmp_path, monkeypatch):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "DEFAULT_NVCC", str(tmp_path / "no_nvcc"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_library(_build.sources(), tmp_path / "build")
    assert not (tmp_path / "build" / _build.LIB_NAME).exists()


def _fake_cuda_home(tmp_path, script):
    bin_dir = tmp_path / "cuda" / "bin"
    bin_dir.mkdir(parents=True)
    nvcc = bin_dir / "nvcc"
    nvcc.write_text("#!/bin/sh\n" + script)
    nvcc.chmod(0o755)
    return tmp_path / "cuda"


def test_build_failure_raises_with_compiler_stderr(tmp_path, monkeypatch):
    home = _fake_cuda_home(tmp_path, "echo 'spmm_csr.cu(1): error: boom' >&2\n"
                                     "exit 2\n")
    monkeypatch.setenv("CUDA_HOME", str(home))
    with pytest.raises(RuntimeError, match="(?s)exit 2.*error: boom"):
        _build.build_library(_build.sources(), tmp_path / "build")
    assert not list((tmp_path / "build").iterdir())   # no partial library


def test_build_reruns_only_when_a_source_is_newer(tmp_path, monkeypatch):
    """nvcc is called with the sm_90a flags, once, and again after a source
    changes (the mtime rule)."""
    log = tmp_path / "calls.log"
    # the fake compiler logs its arguments and writes the -o target
    home = _fake_cuda_home(
        tmp_path, f'echo "$@" >> {log}\n'
                  'while [ "$1" != "-o" ]; do shift; done\n'
                  'echo lib > "$2"\n')
    monkeypatch.setenv("CUDA_HOME", str(home))
    src = tmp_path / "k.cu"
    shutil.copy(_build.sources()[0], src)
    so = _build.build_library([src], tmp_path / "build")
    assert so.read_text() == "lib\n"
    _build.build_library([src], tmp_path / "build")
    calls = log.read_text().splitlines()
    assert len(calls) == 2                    # compile, link
    assert "arch=compute_90a,code=sm_90a" in calls[0] and "-c" in calls[0]
    assert "-shared" in calls[1]
    assert [p.name for p in (tmp_path / "build").iterdir()] == [so.name]
    later = so.stat().st_mtime + 10
    os.utime(src, (later, later))
    _build.build_library([src], tmp_path / "build")
    assert len(log.read_text().splitlines()) == 4
    header = tmp_path / "k.cuh"               # a header beside the source
    header.write_text("")
    os.utime(header, (later + 10, later + 10))
    _build.build_library([src], tmp_path / "build")
    assert len(log.read_text().splitlines()) == 6


def test_build_compiles_sources_in_parallel(tmp_path, monkeypatch):
    """Every source gets its own nvcc, all running at once: each fake
    compile waits until all have started."""
    log = tmp_path / "calls.log"
    n = 3
    home = _fake_cuda_home(
        tmp_path, f'echo "$@" >> {log}\n'
                  'case "$*" in *" -c "*)\n'
                  f'  touch {tmp_path}/started.$$\n'
                  f'  i=0; while [ $(ls {tmp_path} | grep -c started)'
                  f' -lt {n} ]; do\n'
                  '    i=$((i+1)); [ $i -gt 200 ] && exit 3; sleep 0.05\n'
                  '  done;;\n'
                  'esac\n'
                  'while [ "$1" != "-o" ]; do shift; done\n'
                  'echo lib > "$2"\n')
    monkeypatch.setenv("CUDA_HOME", str(home))
    srcs = []
    for i in range(n):
        srcs.append(tmp_path / f"k{i}.cu")
        shutil.copy(_build.sources()[0], srcs[-1])
    so = _build.build_library(srcs, tmp_path / "build")
    assert so.read_text() == "lib\n"
    assert len(log.read_text().splitlines()) == n + 1


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_cuda(tmp_path, where):
    """No card: chip_smoke.py exits non-zero with a clear message and prints
    no result line; a copy of the script alone fails too."""
    if where == "alone":
        shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd = tmp_path
    else:
        cwd = REPO
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = _run(["chip_smoke.py"], cwd=cwd, env=env)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert '"ok"' not in proc.stdout

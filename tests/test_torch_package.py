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
    toy train step, the toy A @ A, a toy ``spmm_seg2`` forward and
    backward, a train step of each other model family, a segment
    reduction and the facade path (a ``SparseTensor``, ``fill_diag``,
    ``sum``, ``mul``, ``@`` and its backward, ``A @ A``), sampling, a walk,
    a partition, RCM, the host runtime and ``spmm_seg``, ``spmm_sell`` and
    ``spmm_chunked`` run, and so do the probes of ``experiments/``
    (``paddle_sparse_tpu_torch.experiments``: the bisect's stages, a span
    column sum, a band variant, a slice gather), every module of
    ``parallel/`` imports and the dry run runs at 2 ranks on gloo (rank 0
    prints its six lines); every
    name of ``__all__`` exists, the facade's and ``parallel``'s among them;
    neither jax nor the JAX package nor ``experiments/`` is loaded. (The
    spawned ranks of the parallel tests assert that they load no jax.)"""
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
        "for kind in ('sage', 'gin', 'appnp', 'gat'):\n"
        "    model, adj, x, y = p.model_entry(kind, 'cpu')\n"
        "    loss = p.train_step(model, adj, x, y, 0.1)\n"
        "    assert bool(torch.isfinite(loss))\n"
        "assert p.segment_csr(torch.ones(3), torch.tensor([0, 3]), 'max')"
        ".tolist() == [1.0]\n"
        "adj = p.SparseTensor(row=torch.tensor([2, 0, 1, 1]),\n"
        "                     col=torch.tensor([0, 1, 2, 1]),\n"
        "                     sparse_sizes=(3, 3))\n"
        "adj = p.fill_diag(adj, 1.0)\n"
        "deg = p.sum(adj, dim=1)\n"
        "adj = p.mul(adj, deg.pow(-0.5).view(-1, 1))\n"
        "adj.requires_grad_()\n"
        "x = torch.ones(3, 2, requires_grad=True)\n"
        "(adj @ x).sum().backward()\n"
        "assert deg.tolist() == [2.0, 2.0, 2.0], deg\n"
        "assert adj.storage.value().grad.shape == (6,)\n"
        "assert x.grad.shape == (3, 2) and (adj @ adj).nnz() > 0\n"
        "adj, seeds = p.sample_entry('cpu')\n"
        "sub, n_id = p.sample_adj(adj, seeds, 3)\n"
        "assert sub.sparse_size(0) == 16 and n_id[:16].tolist() == "
        "seeds.tolist()\n"
        "assert p.sample(adj, 2, seeds).shape == (16, 2)\n"
        "assert p.saint_subgraph(adj, seeds)[0].sparse_size(0) == 16\n"
        "assert p.random_walk(adj, seeds, 4).shape == (16, 5)\n"
        "out, partptr, perm = p.partition(adj, 4)\n"
        "assert int(partptr[-1]) == 256 and out.nnz() == adj.nnz()\n"
        "assert sorted(p.reverse_cuthill_mckee(adj).tolist()) == "
        "list(range(256))\n"
        "assert p.runtime.compat_check()['native_runtime']\n"
        "for b, fn in (('seg', p.spmm_seg), ('sell', p.spmm_sell), "
        "('chunked', p.spmm_chunked)):\n"
        "    plan, s, packed, x = p.spmm_entry(b, 'cpu')\n"
        "    x.requires_grad_()\n"
        "    fn(plan, s, packed.requires_grad_(), x).sum().backward()\n"
        "    assert bool(torch.isfinite(packed.grad).all())\n"
        "from paddle_sparse_tpu_torch.experiments import (bisect_pallas, "
        "r4_band_cost, r4_dma_issue, r5_vmem_expand)\n"
        "import contextlib, io\n"
        "with contextlib.redirect_stdout(io.StringIO()) as printed:\n"
        "    stages = bisect_pallas.main([], device='cpu')\n"
        "assert set(stages) == {'trivial', 'dma1', 'dma2', 'spmm'}\n"
        "assert printed.getvalue().count(': ok in ') == 4\n"
        "st, e0, sd = r4_dma_issue.make_inputs(2, 32, steps=9, nstream=512, "
        "device='cpu')\n"
        "assert r4_dma_issue.run(st, e0, sd, NS=2, CAP=32, steps=9).shape "
        "== (1024, 256)\n"
        "tb = r4_band_cost.tables(S=2, BAND=384, E=128, K=128, CAP=512, "
        "device='cpu')\n"
        "r4_band_cost.check_schedule(tb)\n"
        "assert r4_band_cost.variant_call('nosel', tb).shape == (512, 128)\n"
        "fs, cols, x = r5_vmem_expand.make_inputs(2, 'cpu')\n"
        "assert r5_vmem_expand.make_call('onehot_reduce')(fs, cols, x)"
        ".shape == (16, 256)\n"
        "import importlib, pkgutil\n"
        "import paddle_sparse_tpu_torch.parallel as par\n"
        "for m in pkgutil.iter_modules(par.__path__):\n"
        "    importlib.import_module(f'{par.__name__}.{m.name}')\n"
        "missing = [n for n in par.__all__ if not hasattr(par, n)]\n"
        "assert not missing, missing\n"
        "res = p.dryrun_multichip(2, 'cpu')\n"
        "assert float(res['gcn_step']['loss']) > 0\n"
        "missing = [n for n in p.__all__ if not hasattr(p, n)]\n"
        "assert not missing, missing\n"
        "facade = {'SparseTensor', 'SparseStorage', 'matmul', 'spspmm', "
        "'fill_diag', 'sum', 'cat', 'to_torch_sparse', 'load_npz', "
        "'sparse_tensor_from_jax', 'facade_entry', 'gcn_norm', "
        "'__narrow_diag__', 'spadd', 'seed', 'sample', 'sample_adj', "
        "'saint_subgraph', 'random_walk', 'partition', "
        "'reverse_cuthill_mckee'}\n"
        "assert facade <= set(p.__all__), facade - set(p.__all__)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'paddle_sparse_tpu', 'experiments') "
        "and sys.modules[m]]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert lines[-1] == "ok"
    # rank 0 of the spawned dry run prints its six lines
    assert sum(ln.startswith("dryrun_multichip(2): ") for ln in lines) == 6


def test_entry_points_default_to_the_card(monkeypatch):
    """Every entry point, the probes' of ``experiments/`` among them,
    defaults to ``device="cuda"`` and, without a card, raises naming the
    missing device instead of running on the CPU."""
    import inspect

    import torch

    import paddle_sparse_tpu_torch as p
    from paddle_sparse_tpu_torch.experiments import (bisect_pallas as bp,
                                                     r4_band_cost as rb,
                                                     r4_dma_issue as rd,
                                                     r5_vmem_expand as rv)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn, args in ((p.entry, ()), (p.train_entry, ()),
                     (p.spgemm_entry, ()), (p.spmm_entry, ("seg2",)),
                     (p.model_entry, ("gat",)), (p.facade_entry, ()),
                     (p.sample_entry, ()), (bp.main, ([],)),
                     (p.dryrun_multichip, (2,)),
                     (bp.trivial, ()), (bp.dma_copy, (True,)),
                     (bp.spmm, ()), (rd.main, ([],)),
                     (rd.make_inputs, (19, 384)), (rb.main, ()),
                     (rb.variants, ()), (rb.tables, ()), (rv.main, ([],)),
                     (rv.make_inputs, (3,))):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(*args)
    with pytest.raises(ValueError, match="unknown SpMM backend"):
        p.spmm_entry("cusparse", "cpu")


def test_probe_modules_read_no_argv_at_import():
    """Importing the probes of ``paddle_sparse_tpu_torch.experiments`` reads
    no ``sys.argv`` (only their ``main`` does): every read of it raises."""
    code = (
        "import sys\n"
        "class NoArgv(list):\n"
        "    def _no(self, *a, **k):\n"
        "        raise AssertionError('sys.argv read at import')\n"
        "    __getitem__ = __len__ = __iter__ = __bool__ = _no\n"
        "sys.argv = NoArgv()\n"
        "import paddle_sparse_tpu_torch.experiments.timing\n"
        "from paddle_sparse_tpu_torch.experiments import (bisect_pallas, "
        "r4_band_cost, r4_dma_issue, r5_vmem_expand)\n"
        "assert r4_dma_issue.STEPS == 2048 and r5_vmem_expand.R == 512\n"
        "print('ok')\n")
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


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

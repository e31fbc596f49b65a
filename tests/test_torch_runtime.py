"""The port's C++ host runtime (``paddle_sparse_tpu_torch/runtime``): built
with g++ from its own copy of the JAX package's source, into a temporary
file moved into place; a failed build raises with the compiler's stderr and
nothing falls back; the wrappers against numpy, the port's torch
conversions and the JAX package's build of the same source (exact)."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_sparse_tpu_torch as tsp
from paddle_sparse_tpu import runtime as jrt
from paddle_sparse_tpu_torch import runtime as trt
from paddle_sparse_tpu_torch.ops.convert import ind2ptr, ptr2ind

REPO = Path(__file__).resolve().parents[1]


def test_source_is_the_jax_packages_copy():
    jax_src = (REPO / "paddle_sparse_tpu" / "runtime" / "cpp"
               / "psp_runtime.cpp")
    assert trt.SRC.read_bytes() == jax_src.read_bytes()


def _fake_cxx(tmp_path, script):
    cxx = tmp_path / "fake-g++"
    cxx.write_text("#!/bin/sh\n" + script)
    cxx.chmod(0o755)
    return cxx


def test_build_lands_in_a_temp_path(tmp_path, monkeypatch):
    """The compiler writes into a temporary directory inside the build
    directory; the library is then moved into place, and nothing else is
    left; a second call with an up-to-date library compiles nothing."""
    log = tmp_path / "calls.log"
    cxx = _fake_cxx(tmp_path, f'echo "$@" >> {log}\n'
                              'while [ "$1" != "-o" ]; do shift; done\n'
                              'echo lib > "$2"\n')
    monkeypatch.setenv("CXX", str(cxx))
    build = tmp_path / "build"
    so = trt.build_library(trt.SRC, build)
    assert so == build / trt.LIB_NAME and so.read_text() == "lib\n"
    args = log.read_text().split()
    out = Path(args[args.index("-o") + 1])
    assert out.parent.parent == build and out != so
    for flag in ("-O3", "-std=c++17", "-shared", "-fPIC"):
        assert flag in args
    assert [p.name for p in build.iterdir()] == [trt.LIB_NAME]
    trt.build_library(trt.SRC, build)
    assert len(log.read_text().splitlines()) == 1


def test_failed_build_raises_with_stderr(tmp_path, monkeypatch):
    cxx = _fake_cxx(tmp_path, "echo 'psp_runtime.cpp:1: error: boom' >&2\n"
                              "exit 4\n")
    monkeypatch.setenv("CXX", str(cxx))
    with pytest.raises(RuntimeError, match="(?s)exit 4.*error: boom"):
        trt.build_library(trt.SRC, tmp_path / "build")
    assert not list((tmp_path / "build").iterdir())


def test_missing_compiler_raises(tmp_path, monkeypatch):
    monkeypatch.delenv("CXX", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        trt.build_library(trt.SRC, tmp_path / "build")


def test_load_failure_raises_and_nothing_falls_back(monkeypatch):
    """A failed build: ``available()`` is False, ``build_error()`` holds the
    message, and the sampler, partitioner and RCM raise instead of running
    a plain version."""
    def fail(*_):
        raise RuntimeError("g++ failed (exit 1): boom")
    monkeypatch.setattr(trt, "_lib", None)
    monkeypatch.setattr(trt, "_build_error", None)
    monkeypatch.setattr(trt, "build_library", fail)
    assert not trt.available()
    assert "boom" in trt.build_error()
    A = tsp.SparseTensor.from_dense(torch.eye(4) + torch.ones(4, 4))
    with pytest.raises(RuntimeError, match="boom"):
        tsp.sample_adj(A, torch.tensor([0, 1]), 2)
    with pytest.raises(RuntimeError, match="boom"):
        tsp.partition(A, 2)
    with pytest.raises(RuntimeError, match="boom"):
        tsp.reverse_cuthill_mckee(A)


def test_concurrent_builds_each_load_a_whole_library(tmp_path):
    """Two processes build into one empty directory at once (as two test
    workers can): both load and run the library."""
    code = ("import sys, ctypes, numpy as np\n"
            "from pathlib import Path\n"
            "from paddle_sparse_tpu_torch import runtime as r\n"
            "so = r.build_library(r.SRC, Path(sys.argv[1]))\n"
            "lib = ctypes.CDLL(str(so))\n"
            "print('ok')\n")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    assert all(o[0].strip() == "ok" for o in outs)
    assert [p.name for p in tmp_path.iterdir()] == [trt.LIB_NAME]


def test_lexsort_rowcol():
    rng = np.random.default_rng(1)
    row, col = rng.integers(0, 50, 500), rng.integers(0, 50, 500)
    perm = trt.lexsort_rowcol(row, col)
    np.testing.assert_array_equal(perm, np.lexsort((col, row)))
    np.testing.assert_array_equal(perm, jrt.lexsort_rowcol(row, col))
    np.testing.assert_array_equal(
        perm, tsp.utils.lexsort_rowcol(torch.from_numpy(row),
                                       torch.from_numpy(col)).numpy())


@pytest.mark.parametrize("M", [0, 1, 7, 60])
def test_ind2ptr_ptr2ind(M):
    rng = np.random.default_rng(M)
    row = np.sort(rng.integers(0, max(M, 1), 3 * M))
    ptr = trt.ind2ptr(row, M)
    np.testing.assert_array_equal(ptr, ind2ptr(torch.from_numpy(row),
                                               M).numpy())
    np.testing.assert_array_equal(trt.ptr2ind(ptr, len(row)), row)
    np.testing.assert_array_equal(
        trt.ptr2ind(ptr, len(row)),
        ptr2ind(torch.from_numpy(ptr), len(row)).numpy())


def test_native_sample_adj_golden():
    """The reference's golden case (``tests/test_runtime.py``)."""
    rowptr = np.array([0, 3, 5, 9, 10, 12, 14])
    col = np.array([1, 2, 3, 0, 2, 0, 1, 4, 5, 0, 2, 5, 2, 4])
    r_ptr, r_col, r_eid, r_nid = trt.sample_adj(rowptr, col, np.arange(2, 6),
                                                -1, False, 0)
    assert r_nid.tolist() == [2, 3, 4, 5, 0, 1]
    assert r_ptr.tolist() == [0, 4, 5, 7, 9]
    assert r_col.tolist() == [2, 3, 4, 5, 4, 0, 3, 0, 2]
    assert r_eid.tolist() == [7, 8, 5, 6, 9, 10, 11, 12, 13]
    with pytest.raises(ValueError, match="subset out of range"):
        trt.sample_adj(rowptr, col, np.array([6]), 2, False, 0)


def test_native_rcm_and_partition_match_jax():
    rng = np.random.default_rng(3)
    N = 64
    dense = (rng.random((N, N)) < 0.1).astype(int)
    dense = np.maximum(dense, dense.T)
    np.fill_diagonal(dense, 0)
    indptr = np.concatenate([[0], np.cumsum((dense != 0).sum(1))])
    indices = np.nonzero(dense)[1]
    np.testing.assert_array_equal(trt.rcm(indptr, indices),
                                  jrt.rcm(indptr, indices))
    cl = trt.partition_clusters(indptr, indices, 4)
    np.testing.assert_array_equal(
        cl, jrt.partition_clusters(indptr, indices, 4))
    assert np.bincount(cl).max() <= N // 4 + 2


def test_compat_check():
    info = trt.compat_check()
    assert set(info) == {"torch", "cuda", "backend", "device", "nvcc", "gxx",
                         "cuda_kernels", "native_runtime"}
    assert info["torch"] == torch.__version__
    assert info["native_runtime"] is True and info["gxx"]
    if not torch.cuda.is_available():
        assert info["backend"] == "cpu" and info["device"] == "cpu"
        assert info["cuda_kernels"] is False
    # the keys the JAX package's report shares mean the same thing
    jinfo = jrt.compat_check()
    assert {"backend", "native_runtime"} <= set(jinfo)
    assert os.path.isfile(info["gxx"])

"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Every ``csrc/*.cu`` file of the package is compiled, at first use, into one
shared library with a plain C interface (no PyTorch headers, so the build
takes seconds). The sources compile in parallel, one ``nvcc`` each, and are
then linked:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler \
         -fPIC -c -o <tmp>/<name>.o csrc/<name>.cu          # each, together
    nvcc -shared -o build/libpsp_torch_kernels.so <tmp>/*.o

The library lands in the package's git-ignored ``build/`` directory and is
rebuilt when a source, or a ``*.cuh`` header beside one, is newer than it.
There is no fallback: a missing ``nvcc`` or a failed build raises with the
compiler's message.
"""
import ctypes
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Sequence

_PKG = Path(__file__).resolve().parents[2]
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
LIB_NAME = "libpsp_torch_kernels.so"
DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"   # the CUDA toolkit's default
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on ``PATH``, else the CUDA
    toolkit's default install location; raises if none exists."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates += [shutil.which("nvcc"), DEFAULT_NVCC]
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        f"nvcc not found (looked in $CUDA_HOME/bin, on PATH and at "
        f"{DEFAULT_NVCC}): the CUDA kernels of paddle_sparse_tpu_torch "
        f"cannot be built")


def sources() -> Sequence[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _run_all(cmds: Sequence[Sequence[str]]) -> None:
    """Start every command at once, wait for all, and raise with the stderr
    of the first that failed."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.DEVNULL,
                              stderr=subprocess.PIPE, text=True)
             for cmd in cmds]
    errs = [p.communicate()[1] for p in procs]
    for cmd, p, err in zip(cmds, procs, errs):
        if p.returncode != 0:
            raise RuntimeError(
                f"nvcc failed (exit {p.returncode}): {' '.join(cmd)}\n{err}")


def build_library(srcs: Sequence[Path], build_dir: Path) -> Path:
    """Compile ``srcs`` into ``build_dir/LIB_NAME`` unless it is newer than
    every source and every ``*.cuh`` beside them. Raises ``RuntimeError``
    with nvcc's stderr on failure, leaving nothing behind in ``build_dir``."""
    build_dir = Path(build_dir)
    so = build_dir / LIB_NAME
    deps = {Path(s) for s in srcs}
    deps |= {h for s in srcs for h in Path(s).parent.glob("*.cuh")}
    if so.exists() and all(so.stat().st_mtime >= d.stat().st_mtime
                           for d in deps):
        return so
    nvcc = find_nvcc()
    build_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        objs = [Path(tmp) / f"{i}_{Path(s).stem}.o"
                for i, s in enumerate(srcs)]
        _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)]
                  for s, o in zip(srcs, objs)])
        lib = Path(tmp) / LIB_NAME
        _run_all([[nvcc, "-shared", "-o", str(lib), *map(str, objs)]])
        os.replace(lib, so)   # atomic: a concurrent loader sees old or new
    return so


def load_library() -> ctypes.CDLL:
    """Build if needed, load once, and declare the C entry points."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_library(sources(), BUILD_DIR)))
            p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
            # ..., piece table: row, piece, P, cap (row NULL: none), ...
            lib.psp_spmm_spans.argtypes = [p, p, i64, p, p, p, p, p, i64,
                                           i64, i64, i32, i32, p, p, i64, i64,
                                           p, p, p]
            lib.psp_spmm_spans.restype = ctypes.c_int
            lib.psp_fold_pieces.argtypes = [p, p, p, p, i64, i64, i32, p]
            lib.psp_fold_pieces.restype = ctypes.c_int
            lib.psp_sddmm_spans.argtypes = [p, p, i64, p, p, p, p, p, i64,
                                            i64, i64, i32, i32, p, p, i64,
                                            i64, p]
            lib.psp_sddmm_spans.restype = ctypes.c_int
            lib.psp_segcompact_tile.argtypes = []
            lib.psp_segcompact_tile.restype = i64
            lib.psp_segcompact_count.argtypes = [p, p, i64, i64, i64, i64, p,
                                                 p]
            lib.psp_segcompact_count.restype = ctypes.c_int
            lib.psp_segcompact_write.argtypes = [p, p, i64, i64, i64, i64, p,
                                                 i32, p, i64, p, p, p, p, p]
            lib.psp_segcompact_write.restype = ctypes.c_int
            _lib = lib
        return _lib

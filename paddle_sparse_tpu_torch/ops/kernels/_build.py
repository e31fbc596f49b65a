"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Every ``csrc/*.cu`` file of the package is compiled, at first use, into one
shared library with a plain C interface (no PyTorch headers, so the build
takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/libpsp_torch_kernels.so csrc/*.cu

The library lands in the package's git-ignored ``build/`` directory and is
rebuilt when a source is newer than it. There is no fallback: a missing
``nvcc`` or a failed build raises with the compiler's message.
"""
import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

_PKG = Path(__file__).resolve().parents[2]
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
LIB_NAME = "libpsp_torch_kernels.so"
DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"   # the CUDA toolkit's default
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

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


def build_library(srcs: Sequence[Path], build_dir: Path) -> Path:
    """Compile ``srcs`` into ``build_dir/LIB_NAME`` unless it is newer than
    every source. Raises ``RuntimeError`` with nvcc's stderr on failure."""
    build_dir = Path(build_dir)
    so = build_dir / LIB_NAME
    if so.exists() and all(so.stat().st_mtime >= Path(s).stat().st_mtime
                           for s in srcs):
        return so
    nvcc = find_nvcc()
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = build_dir / f"{LIB_NAME}.{os.getpid()}.tmp"
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, srcs)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stderr}")
    os.replace(tmp, so)   # atomic: a concurrent loader sees old or new
    return so


def load_library() -> ctypes.CDLL:
    """Build if needed, load once, and declare the C entry points."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_library(sources(), BUILD_DIR)))
            p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
            lib.psp_spmm_csr.argtypes = [p, p, p, p, p, i64, i64, i32, i32, p]
            lib.psp_spmm_csr.restype = ctypes.c_int
            _lib = lib
        return _lib

"""The C++ host runtime: neighbour sampling, canonical sorts, RCM and the
partitioner on int64 numpy arrays, loaded with ctypes.

Port of ``paddle_sparse_tpu/runtime/__init__.py``. The source,
``cpp/psp_runtime.cpp``, is the JAX package's file copied unchanged (plain C
interface, no framework), so both builds give the same bits from the same
seed (``std::mt19937_64``). It is built at first use:

    g++ -O3 -std=c++17 -shared -fPIC cpp/psp_runtime.cpp -o <tmp>
    mv <tmp> build/libpsp_runtime.so

into the package's git-ignored ``build/`` directory, and rebuilt when the
source is newer than the library. The library is written to a temporary file
first and moved into place, so two processes building at once each load a
whole library. There is no fallback: a missing ``g++`` or a failed build
raises with the compiler's message. The numpy and pure-Python versions of
what it computes are the plain references, reachable by name
(``sample.sample_adj(..., rng=...)``,
``partition.partition_clusters_reference``,
``partition.reverse_cuthill_mckee_reference``).
"""
import ctypes
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SRC = Path(__file__).resolve().parent / "cpp" / "psp_runtime.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build"
LIB_NAME = "libpsp_runtime.so"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None

_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")


def find_cxx() -> str:
    """``$CXX``, else ``g++`` on ``PATH``; raises if neither exists."""
    for c in (os.environ.get("CXX"), shutil.which("g++")):
        if c and shutil.which(c):
            return shutil.which(c)
    raise RuntimeError("g++ not found ($CXX unset or missing, none on PATH): "
                       "the host runtime of paddle_sparse_tpu_torch cannot "
                       "be built")


def build_library(src: Path = SRC, build_dir: Path = BUILD_DIR) -> Path:
    """Compile ``src`` into ``build_dir/LIB_NAME`` unless the library is
    newer than the source. Raises ``RuntimeError`` with the compiler's
    stderr on failure, leaving nothing behind in ``build_dir``."""
    src, build_dir = Path(src), Path(build_dir)
    so = build_dir / LIB_NAME
    if so.exists() and so.stat().st_mtime >= src.stat().st_mtime:
        return so
    cxx = find_cxx()
    build_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        out = Path(tmp) / LIB_NAME
        cmd = [cxx, *CXX_FLAGS, str(src), "-o", str(out)]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed (exit {proc.returncode}): "
                               f"{' '.join(cmd)}\n{proc.stderr}")
        os.replace(out, so)   # atomic: a concurrent loader sees old or new
    return so


def load_library() -> ctypes.CDLL:
    """Build if needed, load once, and declare the C entry points. A failed
    build raises now and on every later call (:func:`build_error`)."""
    global _lib, _build_error
    with _lock:
        if _lib is None:
            try:
                lib = ctypes.CDLL(str(build_library()))
            except (RuntimeError, OSError) as e:
                _build_error = str(e)
                raise
            i64 = ctypes.c_int64
            lib.psp_ind2ptr.argtypes = [_i64p, i64, i64, _i64p]
            lib.psp_ind2ptr.restype = None
            lib.psp_ptr2ind.argtypes = [_i64p, i64, _i64p]
            lib.psp_ptr2ind.restype = None
            lib.psp_lexsort_rowcol.argtypes = [_i64p, _i64p, i64, _i64p]
            lib.psp_lexsort_rowcol.restype = None
            lib.psp_sample_adj.argtypes = [
                _i64p, _i64p, _i64p, i64, i64, ctypes.c_int32,
                ctypes.c_uint64, _i64p, _i64p, _i64p, _i64p,
                ctypes.POINTER(i64)]
            lib.psp_sample_adj.restype = i64
            lib.psp_rcm.argtypes = [_i64p, _i64p, i64, _i64p]
            lib.psp_rcm.restype = None
            lib.psp_partition.argtypes = [_i64p, _i64p, i64, i64, _i64p]
            lib.psp_partition.restype = None
            _lib, _build_error = lib, None
        return _lib


def available() -> bool:
    """Whether the runtime builds and loads here (it is built if needed).
    A probe for :func:`compat_check`: the functions below raise instead."""
    try:
        load_library()
    except (RuntimeError, OSError):
        return False
    return True


def build_error() -> Optional[str]:
    """The compiler's message of the last failed build, None otherwise."""
    return _build_error


def _i64(a) -> np.ndarray:
    return np.ascontiguousarray(a, np.int64)


# ---------------------------------------------------------------------------
# numpy-facing wrappers
# ---------------------------------------------------------------------------
def sample_adj(rowptr: np.ndarray, col: np.ndarray, subset: np.ndarray,
               num_neighbors: int, replace: bool, seed: int):
    """Native sampler; returns ``(rowptr, col, e_id, n_id)`` int64 arrays:
    the sampled rows of ``subset`` with local column ids, the sampled
    edges' positions and the global ids of the local nodes (seeds first,
    then neighbours in first-seen order)."""
    lib = load_library()
    rowptr, col, subset = _i64(rowptr), _i64(col), _i64(subset)
    S = len(subset)
    if S and (int(subset.min()) < 0 or int(subset.max()) >= len(rowptr) - 1):
        raise ValueError(f"subset out of range for {len(rowptr) - 1} rows")
    deg = rowptr[subset + 1] - rowptr[subset]
    if num_neighbors < 0:
        capacity = int(deg.sum())
    elif replace:
        capacity = S * num_neighbors
    else:
        capacity = int(np.minimum(deg, num_neighbors).sum())
    capacity = max(capacity, 1)

    out_rowptr = np.zeros(S + 1, np.int64)
    out_col = np.zeros(capacity, np.int64)
    out_eid = np.zeros(capacity, np.int64)
    out_nid = np.zeros(S + capacity, np.int64)
    num_nodes = ctypes.c_int64(0)
    n_edges = lib.psp_sample_adj(rowptr, col, subset, S, num_neighbors,
                                 int(replace), seed, out_rowptr, out_col,
                                 out_eid, out_nid, ctypes.byref(num_nodes))
    return (out_rowptr, out_col[:n_edges], out_eid[:n_edges],
            out_nid[:num_nodes.value])


def lexsort_rowcol(row: np.ndarray, col: np.ndarray) -> np.ndarray:
    """Stable (row, col) argsort, as ``np.lexsort((col, row))``."""
    lib = load_library()
    row, col = _i64(row), _i64(col)
    if row.shape != col.shape:
        raise ValueError(f"row {row.shape} and col {col.shape} differ")
    perm = np.zeros(len(row), np.int64)
    lib.psp_lexsort_rowcol(row, col, len(row), perm)
    return perm


def ind2ptr(row: np.ndarray, M: int) -> np.ndarray:
    """Sorted COO rows -> CSR pointer of ``M + 1`` entries."""
    lib = load_library()
    row = _i64(row)
    ptr = np.zeros(M + 1, np.int64)
    lib.psp_ind2ptr(row, len(row), M, ptr)
    return ptr


def ptr2ind(ptr: np.ndarray, E: int) -> np.ndarray:
    """CSR pointer (``ptr[0] == 0``, ``ptr[-1] == E``) -> COO rows."""
    lib = load_library()
    ptr = _i64(ptr)
    if len(ptr) < 1 or int(ptr[0]) != 0 or int(ptr[-1]) != E:
        raise ValueError(f"ptr must run from 0 to E={E}")
    row = np.zeros(E, np.int64)
    lib.psp_ptr2ind(ptr, len(ptr) - 1, row)
    return row


def rcm(rowptr: np.ndarray, col: np.ndarray) -> np.ndarray:
    """Reverse Cuthill-McKee permutation of a symmetric CSR structure."""
    lib = load_library()
    rowptr, col = _i64(rowptr), _i64(col)
    N = len(rowptr) - 1
    perm = np.zeros(N, np.int64)
    lib.psp_rcm(rowptr, col, N, perm)
    return perm


def partition_clusters(rowptr: np.ndarray, col: np.ndarray,
                       num_parts: int) -> np.ndarray:
    """A cluster id in ``[0, num_parts)`` per node: BFS-grown regions and
    one greedy refinement sweep."""
    lib = load_library()
    rowptr, col = _i64(rowptr), _i64(col)
    N = len(rowptr) - 1
    cluster = np.zeros(N, np.int64)
    lib.psp_partition(rowptr, col, N, num_parts, cluster)
    return cluster


def compat_check(verbose: bool = False) -> dict:
    """What backs each subsystem here, the counterpart of the JAX package's
    ``compat_check`` (same keys where they mean the same thing):

    * ``torch``, ``cuda`` (``torch.version.cuda``, None on a CPU build),
      ``backend`` (``"cuda"`` when a card is visible, else ``"cpu"``) and
      ``device`` (the card's name, or ``"cpu"``);
    * ``nvcc`` and ``gxx``: the compilers found, or None;
    * ``cuda_kernels``: whether the CUDA kernels built and loaded (False
      without a card or nvcc, where nothing is attempted);
    * ``native_runtime``: whether this host runtime built and loaded.

    It builds what it reports on and raises nothing."""
    import torch

    from ..ops.kernels import _build
    has_card = torch.cuda.is_available()
    try:
        nvcc = _build.find_nvcc()
    except RuntimeError:
        nvcc = None
    try:
        gxx = find_cxx()
    except RuntimeError:
        gxx = None
    kernels = False
    if has_card and nvcc:
        try:
            _build.load_library()
            kernels = True
        except (RuntimeError, OSError):
            pass
    info = {
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "backend": "cuda" if has_card else "cpu",
        "device": torch.cuda.get_device_name(0) if has_card else "cpu",
        "nvcc": nvcc,
        "gxx": gxx,
        "cuda_kernels": kernels,
        "native_runtime": available(),
    }
    if verbose:
        for k, v in info.items():
            print(f"{k}: {v}")
    return info

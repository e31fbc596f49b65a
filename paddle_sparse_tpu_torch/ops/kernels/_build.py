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

Every kernel of the port launches through :func:`launch`, on PyTorch's
current stream of the tensors' device: the one place that reads the stream,
switches the device when it must, and raises on a refused launch.
"""
import ctypes
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Sequence

import torch

_PKG = Path(__file__).resolve().parents[2]
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
LIB_NAME = "libpsp_torch_kernels.so"
DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"   # the CUDA toolkit's default
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

# the dtype codes of the C entry points (csrc/vec_load.cuh::psp::DType, and
# csrc/segcompact.cuh's value codes past it)
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
              torch.float64: 3, torch.int32: 4, torch.int64: 5}
# the float dtypes the SpMM/SDDMM kernels read and write
FLOAT_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.float64)


def dtype_code(dtype: torch.dtype) -> int:
    """The C entry points' code of ``dtype``; raises ``TypeError`` for a
    dtype no kernel takes."""
    try:
        return DTYPE_CODE[dtype]
    except KeyError:
        raise TypeError(f"no kernel of paddle_sparse_tpu_torch takes "
                        f"{dtype}") from None


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
    """Build if needed, load once, and declare the C entry points. Once
    loaded, the handle is returned without taking the lock."""
    global _lib
    lib = _lib
    if lib is not None:
        return lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_library(sources(), BUILD_DIR)))
            p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
            # start, end, stride, idx, value, value code, base, src, out, S,
            # M, K, src and out row strides, src code, out code, piece
            # table: row, piece, P, cap (row NULL: none), slot; ws, stream
            lib.psp_spmm_spans.argtypes = [p, p, i64, p, p, i32, p, p, p, i64,
                                           i64, i64, i64, i64, i32, i32, p, p,
                                           i64, i64, p, p, p]
            lib.psp_spmm_spans.restype = ctypes.c_int
            # fold row, fold ptr, ws, out, R, K, out row stride, out code,
            # stream
            lib.psp_fold_pieces.argtypes = [p, p, p, p, i64, i64, i64, i32,
                                            p]
            lib.psp_fold_pieces.restype = ctypes.c_int
            # start, end, stride, col, base, g, x, dv, S, M, K, g code,
            # x code, dv code, piece table: row, piece, P, cap; stream
            lib.psp_sddmm_spans.argtypes = [p, p, i64, p, p, p, p, p, i64,
                                            i64, i64, i32, i32, i32, p, p,
                                            i64, i64, p]
            lib.psp_sddmm_spans.restype = ctypes.c_int
            # colptr, col_t, value, value code, g, x, dx, dv (value and dv
            # in CSC order), N, K, codes of g, x, dx and dv, piece table:
            # col, piece, P, cap, slot; ws, stream
            lib.psp_spmm_sddmm_csc.argtypes = [p, p, p, i32, p, p, p, p,
                                               i64, i64, i32, i32, i32, i32,
                                               p, p, i64, i64, p, p, p]
            lib.psp_spmm_sddmm_csc.restype = ctypes.c_int
            # start, end, stride, col_t, base, value, value code, g, x, dx,
            # dv, S, N, K, codes of g, x, dx and dv, piece table: row,
            # piece, P, cap, slot; ws, stream
            lib.psp_spmm_sddmm_spans.argtypes = [p, p, i64, p, p, p, i32, p,
                                                 p, p, p, i64, i64, i64, i32,
                                                 i32, i32, i32, p, p, i64,
                                                 i64, p, p, p]
            lib.psp_spmm_sddmm_spans.restype = ctypes.c_int
            # hw, a_src, a_dst, s_src, s_dst, N, H, D, code, stream
            lib.psp_gat_node_scores.argtypes = [p, p, p, p, p, i64, i64, i64,
                                                i32, p]
            lib.psp_gat_node_scores.restype = ctypes.c_int
            # rowptr, col, s_dst, s_src, out, ld, M, H, slope, code, piece
            # table: row, piece, slot, P, cap, fold_ptr, R (row NULL:
            # none); ws, stream
            lib.psp_gat_edge_softmax.argtypes = [p, p, p, p, p, i64, i64,
                                                 i64, ctypes.c_double, i32,
                                                 p, p, p, i64, i64, p, i64,
                                                 p, p]
            lib.psp_gat_edge_softmax.restype = ctypes.c_int
            lib.psp_segcompact_f_max.argtypes = []
            lib.psp_segcompact_f_max.restype = i64
            lib.psp_segcompact_tiles.argtypes = [i64, i64, i64, i32]
            lib.psp_segcompact_tiles.restype = i64
            # col, rows, R, F, M, N, value, value code, sort, cap, outs,
            # seg, count, ws, stream
            lib.psp_segcompact_rows.argtypes = [p, p, i64, i64, i64, i64, p,
                                                i32, i32, i64, p, p, p, p, p,
                                                p, p]
            lib.psp_segcompact_rows.restype = ctypes.c_int
            # col, rows, row_div, L, M, N, value, value code, D, cap, outs,
            # seg, count, ws, meta, part, stream
            lib.psp_segcompact_stream.argtypes = [p, p, i64, i64, i64, i64, p,
                                                  i32, i64, i64, p, p, p, p,
                                                  p, p, p, p, p]
            lib.psp_segcompact_stream.restype = ctypes.c_int
            # the probes of experiments/ (csrc/probes.cu), stream last
            lib.psp_scale2.argtypes = [p, p, i64, p]
            lib.psp_chunk_sum.argtypes = [p, p, p, i64, i64, i32, p]
            lib.psp_span_colsum_staged.argtypes = [p, p, p, i64, i64, i64,
                                                   i64, p]
            # stream, piece row, len, total, npieces_max, span first, last,
            # piece sums, out, steps, NS, K
            lib.psp_span_colsum.argtypes = [p, p, p, p, i64, p, p, p, p, i64,
                                            i64, i64, p]
            # e0, n, cap, end_bit, prow, plen, total, first, last, ws,
            # ws_bytes
            lib.psp_span_plan.argtypes = [p, i64, i64, i64, p, p, p, p, p, p,
                                          i64, p]
            # fs, n, end_bit, order, sf, istart, n_items, ws, ws_bytes
            lib.psp_slice_plan.argtypes = [p, i64, i64, p, p, p, p, p, i64, p]
            # span (1) or slice (0) plan, n, end_bit: the workspace's bytes
            lib.psp_plan_ws_bytes.argtypes = [i32, i64, i64]
            lib.psp_plan_ws_bytes.restype = i64
            # mode, tile_ptr, visit_chunk, chunk_span, bst, ben, BR_pad,
            # stream, colsum, out, ntiles, K, E
            lib.psp_band_ablate.argtypes = [i32, p, p, p, p, p, i64, p, p, p,
                                            i64, i64, i64, p]
            # fs, cols, x, out, nch, R, E, K
            lib.psp_slice_gather.argtypes = [p, p, p, p, i64, i64, i64, i64,
                                             p]
            # order, sf, istart, n_items, cols, x, out, nch, N, R, E, K
            lib.psp_slice_reduce.argtypes = [p, p, p, p, p, p, p, i64, i64,
                                             i64, i64, i64, p]
            for fn in (lib.psp_scale2, lib.psp_chunk_sum,
                       lib.psp_span_plan, lib.psp_slice_plan,
                       lib.psp_span_colsum_staged, lib.psp_span_colsum,
                       lib.psp_band_ablate, lib.psp_slice_gather,
                       lib.psp_slice_reduce):
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def launch(name: str, cfn, device: torch.device, *args) -> None:
    """``cfn(*args, stream)``: a C launcher of the library called on
    PyTorch's current stream of ``device`` (so ``torch.cuda.stream`` and
    CUDA-graph capture hold), with ``device`` made the current device for
    the call only when it is not already. No synchronize. Raises
    ``RuntimeError`` naming the kernel when the launcher returns non-zero
    (the launch was refused) or when this PyTorch has no CUDA stream API.

    The stream is the raw ``cudaStream_t`` that
    ``torch._C._cuda_getCurrentRawStream`` gives (as Triton's launcher reads
    it), looked up here at each call: the CPU build lacks it."""
    C = torch._C
    try:
        raw_stream, current = C._cuda_getCurrentRawStream, C._cuda_getDevice
    except AttributeError:
        raise RuntimeError(f"{name} kernel cannot launch: this PyTorch has "
                           f"no CUDA stream API") from None
    index, here = device.index, current()
    if index is None or index == here:
        err = cfn(*args, raw_stream(here))
    else:
        with torch.cuda.device(index):
            err = cfn(*args, raw_stream(index))
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")

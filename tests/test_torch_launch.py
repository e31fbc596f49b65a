"""The launch layer of paddle_sparse_tpu_torch's CUDA kernels, on the CPU:
``ops/kernels/_build.launch``, the one path from a wrapper to a C launcher
(the current stream of the tensors' device, a device switch only when it is
needed, a raise on a refused launch), the library loaded once, and the rule
that every kernel launch of ``ops/kernels/`` goes through ``launch``. No
kernel runs here: a fake C function and patched stream and device getters
stand in for the card; the card tests (``test_torch_cuda.py``) run the
launches themselves."""
import ast
import contextlib
import threading
import types
from pathlib import Path

import pytest
import torch

from paddle_sparse_tpu_torch.ops.kernels import _build
from paddle_sparse_tpu_torch.ops.kernels import probes_cuda as pc

KERNELS_DIR = Path(_build.__file__).resolve().parent
# the modules that launch kernels, each through _build.launch
LAUNCH_MODULES = ("gat_attention_cuda", "probes_cuda", "row_split",
                  "segcompact_cuda", "spmm_sddmm_cuda")
# C functions of the library that run on the host only and launch nothing
HOST_ONLY = {"psp_segcompact_tiles", "psp_segcompact_f_max",
             "psp_plan_ws_bytes"}


class FakeC:
    """A C launcher that records its arguments and returns ``err``."""

    def __init__(self, err=0):
        self.err = err
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)
        return self.err


@pytest.fixture
def card(monkeypatch):
    """The CUDA API ``launch`` reads, patched: current device 0, the raw
    stream of device ``i`` is ``1000 + i``; records each stream asked for
    and each device guard entered."""
    log = {"streams": [], "guards": []}

    def raw_stream(i):
        log["streams"].append(i)
        return 1000 + i

    @contextlib.contextmanager
    def guard(i):
        log["guards"].append(("enter", i))
        yield
        log["guards"].append(("exit", i))

    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", raw_stream,
                        raising=False)
    monkeypatch.setattr(torch._C, "_cuda_getDevice", lambda: 0,
                        raising=False)
    monkeypatch.setattr(torch.cuda, "device", guard)
    return log


def test_launch_passes_stream_last_and_returns_on_zero(card):
    cfn = FakeC()
    assert _build.launch("fake", cfn, torch.device("cuda", 0), 7, None,
                         2 ** 40) is None
    assert cfn.calls == [(7, None, 2 ** 40, 1000)]
    assert card["streams"] == [0] and card["guards"] == []


def test_launch_raises_naming_kernel_and_code(card):
    cfn = FakeC(err=700)
    with pytest.raises(RuntimeError,
                       match=r"^fake kernel launch failed: CUDA error 700$"):
        _build.launch("fake", cfn, torch.device("cuda", 0), 1)
    assert len(cfn.calls) == 1


def test_launch_switches_device_only_when_needed(card):
    cfn = FakeC()
    _build.launch("fake", cfn, torch.device("cuda", 1), 5)
    assert cfn.calls == [(5, 1001)]
    assert card["guards"] == [("enter", 1), ("exit", 1)]
    assert card["streams"] == [1]
    # an index-less device is the current one: no switch
    _build.launch("fake", cfn, torch.device("cuda"), 6)
    assert cfn.calls[-1] == (6, 1000) and len(card["guards"]) == 2


def test_launch_restores_device_when_refused(card):
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        _build.launch("fake", FakeC(err=1), torch.device("cuda", 3))
    assert card["guards"] == [("enter", 3), ("exit", 3)]


def test_launch_without_stream_api_raises(monkeypatch):
    monkeypatch.delattr(torch._C, "_cuda_getCurrentRawStream",
                        raising=False)
    cfn = FakeC()
    with pytest.raises(RuntimeError, match="fake kernel cannot launch"):
        _build.launch("fake", cfn, torch.device("cuda", 0))
    assert cfn.calls == []


class FakeLib:
    """Stands in for the loaded CDLL: any attribute is a settable object."""

    def __getattr__(self, name):
        fn = types.SimpleNamespace()
        setattr(self, name, fn)
        return fn


class CountingLock:
    def __init__(self):
        self.lock = threading.Lock()
        self.taken = 0

    def __enter__(self):
        self.lock.acquire()
        self.taken += 1

    def __exit__(self, *exc):
        self.lock.release()


def test_library_builds_once_and_then_takes_no_lock(monkeypatch, tmp_path):
    builds = []

    def build(srcs, build_dir):
        builds.append(build_dir)
        return tmp_path / _build.LIB_NAME

    lock = CountingLock()
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "_lock", lock)
    monkeypatch.setattr(_build, "build_library", build)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: FakeLib())
    libs = []
    threads = [threading.Thread(
        target=lambda: libs.extend(_build.load_library() for _ in range(50)))
        for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(builds) == 1 and len(libs) == 400
    assert all(lib is libs[0] for lib in libs)
    assert libs[0].psp_scale2.argtypes is not None
    taken = lock.taken
    for _ in range(100):
        assert _build.load_library() is libs[0]
    assert lock.taken == taken


# ---- every launch of ops/kernels/ goes through _build.launch ---------------

def _source(module):
    return (KERNELS_DIR / f"{module}.py").read_text()


def _is_build_launch(node):
    f = node.func
    return (isinstance(f, ast.Attribute) and f.attr == "launch"
            and isinstance(f.value, ast.Name) and f.value.id == "_build")


@pytest.mark.parametrize("module", LAUNCH_MODULES)
def test_every_c_launch_goes_through_build_launch(module):
    tree = ast.parse(_source(module))
    launched = {id(call.args[1]) for call in ast.walk(tree)
                if isinstance(call, ast.Call) and _is_build_launch(call)
                and len(call.args) >= 3}
    assert launched, f"{module} launches nothing through _build.launch"
    for node in ast.walk(tree):
        if (isinstance(node, ast.Attribute) and node.attr.startswith("psp_")
                and node.attr not in HOST_ONLY):
            assert id(node) in launched, (
                f"{module}:{node.lineno} calls {node.attr} outside "
                f"_build.launch")


@pytest.mark.parametrize("module", sorted(
    p.stem for p in KERNELS_DIR.glob("*.py") if p.stem != "_build"))
def test_no_stream_or_device_guard_outside_build(module):
    src = _source(module)
    for banned in ("current_stream(", "torch.cuda.device(", "cuda_stream"):
        assert banned not in src, f"{module} uses {banned}"


# ---- P1 and P2's wrappers: no dead dispatcher work, the checks kept ---------

def test_index32_returns_a_flat_int32_tensor_as_it_is():
    t = torch.arange(9, dtype=torch.int32)
    assert pc._index32("f", "ptr", t) is t
    for u in (t.long(), t.reshape(3, 3), t[::2]):
        got = pc._index32("f", "ptr", u)
        assert (got.dtype == torch.int32 and got.dim() == 1
                and got.is_contiguous())
        assert torch.equal(got, u.reshape(-1).int())
    with pytest.raises(TypeError, match="ptr must be int32 or int64"):
        pc._index32("f", "ptr", t.float())


def test_same_device_check_names_the_tensor():
    a = torch.zeros(2)
    pc._check_same_device("f", a.device, ptr=a, e0=None)
    with pytest.raises(ValueError, match="f: e0 is on meta, not cpu"):
        pc._check_same_device("f", a.device, ptr=a,
                              e0=torch.zeros(2, device="meta"))


def test_probe_wrappers_on_cpu_launch_nothing(monkeypatch):
    def no_launch(*args):
        raise AssertionError("a CPU tensor reached _build.launch")
    monkeypatch.setattr(_build, "launch", no_launch)
    x = torch.randn(5, 7)
    assert torch.equal(pc.scale2_cuda(x.t()), x.t() * 2)
    ptr = torch.tensor([0, 2, 3])
    src = torch.randn(12, 4)
    assert torch.equal(pc.chunk_sum_cuda(ptr, src, 4, True),
                       pc.chunk_sum_reference(ptr, src, 4))
    with pytest.raises(ValueError, match="runs on cpu or cuda, not meta"):
        pc.scale2_cuda(torch.zeros(3, device="meta"))

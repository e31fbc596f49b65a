"""Process meshes for the sharded kernels: one process per rank, and a
``torch.distributed`` process group per mesh axis.

Port of ``paddle_sparse_tpu/parallel/mesh.py``. The JAX package lays each
array over a named ``Mesh`` of devices and runs ``shard_map`` over it. Here
every rank is a process of its own that holds its block of each sharded
array on its device, and the mesh's axes are process groups
(``torch.distributed.device_mesh.DeviceMesh``, one group per named axis). So
the JAX placement helpers become "my rank's block, on my device":

* :func:`make_mesh`: a 1-D ``DeviceMesh`` named ``("x",)`` over every rank
  of the default process group;
* :func:`shard_rows`: one rank's contiguous block of rows of a full array;
* :func:`replicate`: a broadcast from rank 0 of the group, so that every rank
  holds rank 0's values;
* :func:`spawn`: runs ``fn(rank, world, *args)`` in ``world`` processes and
  returns each rank's result to the caller as numpy.

The backend follows the device and nothing else: NCCL for ``"cuda"`` (one
rank per card), gloo for ``"cpu"``. A mesh's device type is its default
group's: no tensor is moved between devices to suit a backend, and a CUDA
tensor under a group that cannot take it raises in ``torch.distributed``.
"""
import os
import pickle
import tempfile
from typing import Any, Callable, List, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

_DEVICE_OF_BACKEND = {"nccl": "cuda", "gloo": "cpu"}
_BACKEND_OF_DEVICE = {v: k for k, v in _DEVICE_OF_BACKEND.items()}


def mesh_device_type() -> str:
    """``"cuda"`` under an NCCL default group, ``"cpu"`` under gloo; raises
    under any other backend or without an initialized process group."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call "
                           "torch.distributed.init_process_group first (or "
                           "run under parallel.spawn)")
    backend = dist.get_backend()
    if backend not in _DEVICE_OF_BACKEND:
        raise RuntimeError(f"backend {backend!r}: the sharded kernels run "
                           f"under nccl (cuda) or gloo (cpu)")
    return _DEVICE_OF_BACKEND[backend]


def make_mesh(n_devices: Optional[int] = None,
              axis_name: str = "x") -> DeviceMesh:
    """1-D mesh named ``(axis_name,)`` over every rank of the default
    process group; ``n_devices``, when given, must be its world size."""
    device_type = mesh_device_type()
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"a mesh of {n_devices} ranks needs a process group "
                         f"of {n_devices}, not {world}")
    return init_device_mesh(device_type, (world,),
                            mesh_dim_names=(axis_name,))


def axis_rank(mesh: DeviceMesh, axis_name: str = "x"):
    """``(group, rank, size)`` of this process along ``axis_name``."""
    group = mesh.get_group(axis_name)
    return group, dist.get_rank(group), dist.get_world_size(group)


def shard_rows(array: torch.Tensor, n_shards: int, rank: int,
               device=None) -> torch.Tensor:
    """Rank ``rank``'s block of ``array``'s rows split into ``n_shards``
    equal contiguous blocks, on ``device`` (default: where it is)."""
    if array.shape[0] % n_shards:
        raise ValueError(f"{array.shape[0]} rows do not divide into "
                         f"{n_shards} shards")
    blk = array.shape[0] // n_shards
    return array[rank * blk:(rank + 1) * blk].to(device)


def replicate(tensor: torch.Tensor, group=None) -> torch.Tensor:
    """Broadcast ``tensor`` in place from rank 0 of ``group`` (default: the
    default group) to every rank; returns it."""
    src = dist.get_global_rank(group, 0) if group is not None else 0
    dist.broadcast(tensor, src, group=group)
    return tensor


def to_numpy(obj: Any) -> Any:
    """Tensors (on any device) as numpy arrays, inside dicts, lists and
    tuples (a named tuple keeps its type); everything else as it is."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: to_numpy(v) for k, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(to_numpy(v) for v in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_numpy(v) for v in obj)
    return obj


def _rank_main(rank: int, world: int, device_type: str, tmp: str,
               fn: Callable, args: tuple) -> None:
    """One spawned rank: join the group through the file store in ``tmp``,
    run ``fn``, write its result (as numpy) beside the store."""
    torch.set_num_threads(1)
    if device_type == "cuda":
        torch.cuda.set_device(rank)
    dist.init_process_group(_BACKEND_OF_DEVICE[device_type],
                            init_method=f"file://{os.path.join(tmp, 'store')}",
                            rank=rank, world_size=world)
    try:
        out = to_numpy(fn(rank, world, *args))
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def spawn(fn: Callable, world: int, *args, device) -> List[Any]:
    """Run ``fn(rank, world, *args)`` in ``world`` processes
    (``torch.multiprocessing.spawn``), each in a process group of ``world``
    ranks initialized from a ``file://`` store in a fresh temporary
    directory (no TCP port, so concurrent callers cannot collide): NCCL with
    one card per rank for ``device="cuda"``, gloo for ``"cpu"`` (no
    default: the caller names the device); each worker
    runs one CPU thread. ``fn`` and ``args`` are pickled, so ``fn`` must be
    importable by name. Returns each rank's result, in rank order, with its
    tensors as numpy arrays; raises here if any rank fails."""
    device_type = torch.device(device).type
    if device_type not in _BACKEND_OF_DEVICE:
        raise ValueError(f"device {device!r}: 'cuda' (nccl) or 'cpu' (gloo)")
    if device_type == "cuda":
        count = torch.cuda.device_count()
        if world > count:
            raise RuntimeError(
                f"NCCL takes one rank per card: {world} ranks need {world} "
                f"CUDA devices, {count} visible")
    with tempfile.TemporaryDirectory() as tmp:
        torch.multiprocessing.spawn(_rank_main,
                                    args=(world, device_type, tmp, fn, args),
                                    nprocs=world, join=True)
        results = []
        for rank in range(world):
            with open(os.path.join(tmp, f"rank{rank}.pkl"), "rb") as f:
                results.append(pickle.load(f))
    return results


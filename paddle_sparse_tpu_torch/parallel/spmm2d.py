"""2-D block-partitioned SpMM with a reduce-scatter over the column axis.

Port of ``paddle_sparse_tpu/parallel/spmm2d.py``. A is split into a (Dr x
Dc) grid of blocks; the dense operand's rows are sharded over the ``dc``
axis (and replicated over ``dr``); each rank computes its block's partial
``A[i, j] @ x[j]``. The partials are summed over ``dc`` by a reduce-scatter,
which also splits the output rows over ``dc``: each rank ends with M/(Dr*Dc)
fully reduced rows, in row order, and no rank holds a full row block.

Rank ``r`` sits at grid position ``(r // Dc, r % Dc)``, as ``make_mesh_2d``
lays the ranks out.
"""
from typing import NamedTuple, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..ops.spmm import spmm_coo
from .collectives import reduce_scatter
from .mesh import mesh_device_type
from .spmm import _take, block_grid


class Sharded2DMatrix(NamedTuple):
    """(Dr, Dc) grid of COO blocks with a common padded capacity.

    ``row`` block-local in [0, M/Dr] (pad = M/Dr); ``col`` block-local in
    [0, N/Dc) (pad = 0, value 0). Rows ascending within each block, pads
    last. A rank's block (:func:`device_put_2d`) has the fields without the
    two grid axes.
    """
    row: torch.Tensor     # (Dr, Dc, C)
    col: torch.Tensor     # (Dr, Dc, C)
    value: torch.Tensor   # (Dr, Dc, C)
    shape: Tuple[int, int]
    grid: Tuple[int, int]


def make_mesh_2d(dr: int, dc: int, axis_names=("dr", "dc")) -> DeviceMesh:
    """(dr x dc) mesh over every rank of the default process group (whose
    size must be ``dr * dc``), ranks laid out row-major."""
    device_type = mesh_device_type()
    world = dist.get_world_size()
    if world != dr * dc:
        raise ValueError(f"a {dr}x{dc} grid needs {dr * dc} ranks, the "
                         f"process group has {world}")
    return init_device_mesh(device_type, (dr, dc),
                            mesh_dim_names=tuple(axis_names))


def shard_2d(tensor, dr: int, dc: int, index_dtype=torch.int32,
             ) -> Sharded2DMatrix:
    """Split into a (dr x dc) block grid (padded capacity = the largest
    block; permute power-law graphs first to balance), O(nnz) on the
    tensor's device."""
    row, col, value, shape = block_grid(tensor, dr, dc, index_dtype)
    return Sharded2DMatrix(row=row, col=col, value=value, shape=shape,
                           grid=(dr, dc))


def device_put_2d(mat: Sharded2DMatrix, rank: int,
                  device=None) -> Sharded2DMatrix:
    """Rank ``rank``'s block, grid position ``divmod(rank, Dc)``, on
    ``device``."""
    i, j = divmod(rank, mat.grid[1])
    return _take(_take(mat, i, None), j, device)


def spmm_2d(mesh: DeviceMesh, mat: Sharded2DMatrix, x: torch.Tensor,
            axes=("dr", "dc"), reduce: str = "sum") -> torch.Tensor:
    """``A @ x`` on the 2-D grid. ``mat``: this rank's block; ``x``: the
    (N/Dc, K) rows of its column block ``j``. Returns this rank's M/(Dr*Dc)
    fully reduced output rows, in row order (rank ``r`` holds rows ``r *
    M/(Dr*Dc)`` on). Only ``reduce='sum'`` distributes over the column-block
    partials."""
    if reduce not in ("sum", "add"):
        raise ValueError("spmm_2d supports reduce='sum' only")
    dr, dc = mat.grid
    rb = mat.shape[0] // dr
    if rb % dc:
        raise ValueError(f"row block {rb} must divide over {dc} ranks for "
                         f"the reduce-scatter")
    part = spmm_coo(mat.row, mat.col, mat.value, x, rb, "sum")
    return reduce_scatter(part, mesh.get_group(axes[1]))

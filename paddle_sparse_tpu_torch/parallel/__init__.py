"""Multi-rank distribution: meshes of processes and the row-sharded sparse
kernels, over ``torch.distributed``.

Port of ``paddle_sparse_tpu/parallel/``: 1-D row-partitioned SpMM with an
all-gather of the dense operand, a ring of ``x`` blocks or a deduplicated
halo all-to-all; the 2-D grid with a reduce-scatter; the row-sharded packed
SpMM (seg2) and SpGEMM; the scaling estimator. One process per rank (NCCL on
the card, gloo on the CPU), each holding its blocks on its device; every
collective is an autograd Function whose backward is its JAX transpose
(``collectives.py``).
"""
from .collectives import all_gather, all_to_all, reduce_scatter, ring_shift
from .mesh import make_mesh, replicate, shard_rows, spawn
from .scaling import ScalingEstimate, estimate_scaling, scaling_report
from .spgemm import (RowBlocks, allgather_padded, device_put_blocks,
                     gather_blocks, shard_padded_rows, spgemm_rowsharded,
                     stack_blocks)
from .spmm import (HaloShardedMatrix, RingShardedMatrix, RowShardedAdjacency,
                   RowShardedMatrix, device_put_halo, device_put_ring,
                   device_put_sharded_matrix, shard_halo, shard_padded_coo,
                   shard_ring_buckets, spmm_allgather, spmm_halo, spmm_ring,
                   spmm_ring_bucketed)
from .spmm2d import (Sharded2DMatrix, device_put_2d, make_mesh_2d, shard_2d,
                     spmm_2d)
from .spmm_seg2 import (Seg2Shard, ShardedSeg2, device_put_sharded_seg2,
                        make_seg2_halo_plan, make_seg2_plan_sharded,
                        pack_values_sharded, spmm_seg2_allgather,
                        spmm_seg2_halo)

__all__ = ["make_mesh", "shard_rows", "RowShardedMatrix",
           "RingShardedMatrix", "HaloShardedMatrix", "Sharded2DMatrix",
           "spmm_allgather", "spmm_ring", "spmm_ring_bucketed",
           "spmm_halo", "spmm_2d", "shard_padded_coo",
           "shard_ring_buckets", "shard_halo", "shard_2d",
           "device_put_ring", "device_put_halo", "device_put_2d",
           "shard_padded_rows", "device_put_blocks", "spgemm_rowsharded",
           "gather_blocks", "estimate_scaling", "ScalingEstimate",
           # the port's own, and the JAX package's names outside its __all__
           "replicate", "spawn", "all_gather", "all_to_all",
           "reduce_scatter", "ring_shift", "make_mesh_2d",
           "device_put_sharded_matrix", "RowShardedAdjacency", "RowBlocks",
           "allgather_padded", "stack_blocks", "scaling_report",
           "ShardedSeg2", "Seg2Shard", "make_seg2_plan_sharded",
           "pack_values_sharded", "device_put_sharded_seg2",
           "spmm_seg2_allgather", "make_seg2_halo_plan", "spmm_seg2_halo"]

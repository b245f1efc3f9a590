"""The row-partitioned solve on ``torch.distributed``: one process per
rank, an explicit process group (NCCL for one GPU a rank, gloo for ranks
that share a card and for the CPU).  Counterpart of
``cpkrylov_tpu/parallel`` without the mesh."""
from . import bootstrap
from .bootstrap import init_process_group
from .comm import Comm
from .cpminres import dist_cpminres
from .halo import HaloBlock, halo_extend, halo_matvec, plan_halo_block
from .mixed import build_dist_precond, dist_solve_mixed
from .partition import (PartitionedBlocks, partition_blocks, shard_vector,
                        unshard_vector)
from .schur import SchurFactor, plan_schur_precond
from .solve import DistPlan, dist_solve, plan_dist

__all__ = [
    "bootstrap", "init_process_group", "Comm",
    "PartitionedBlocks", "partition_blocks", "shard_vector",
    "unshard_vector", "dist_cpminres",
    "HaloBlock", "plan_halo_block", "halo_extend", "halo_matvec",
    "DistPlan", "plan_dist", "dist_solve",
    "build_dist_precond", "dist_solve_mixed",
    "SchurFactor", "plan_schur_precond",
]

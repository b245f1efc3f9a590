"""Process-group bootstrap for the row-partitioned solve.

Counterpart of ``cpkrylov_tpu/parallel/bootstrap.py``.  One process runs
each rank; :func:`init_process_group` joins it to an explicit
``torch.distributed`` group and returns the :class:`~.comm.Comm` that the
distributed entry points take.  There is no mesh: the rank's device is an
argument, ``cuda:<local_rank>`` by default.

The backend is explicit: ``"nccl"`` when each rank has a GPU of its own,
``"gloo"`` for CPU tensors and for ranks that share one card (NCCL refuses
two ranks on one GPU).  Nothing in a cluster tells a rank its address, so
the caller gives ``init_method`` (``tcp://host:port``), the world size and
the rank.

Typical multi-process entry::

    from cpkrylov_tpu_torch.parallel import bootstrap
    comm = bootstrap.init_process_group("nccl", rank, world_size,
                                        "tcp://10.0.0.1:29500")
    res, x1, x2 = dist_solve(comm, "cpminres", b, A, B, C, G)
"""
from __future__ import annotations

import datetime

import torch
import torch.distributed as dist

from ..utils.device import resolve_device
from .comm import Comm

# How long a collective waits for the other ranks before it fails.
TIMEOUT_S = 600.0


def init_process_group(backend: str, rank: int, world_size: int,
                       init_method: str, *, device=None,
                       local_rank: int | None = None) -> Comm:
    """Join this process to the default process group as ``rank`` of
    ``world_size`` and return its :class:`Comm`.

    ``device`` is where this rank's tensors live: ``cuda:<local_rank>``
    when None (``local_rank`` defaults to ``rank``), ``"cuda:0"`` when
    ranks share a card, ``"cpu"`` on request.  A failed init raises."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', not "
                         f"{backend!r}")
    if device is None:
        device = torch.device("cuda", rank if local_rank is None
                              else local_rank)
    device = resolve_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend=backend, init_method=init_method, rank=rank,
        world_size=world_size,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return Comm(device=device)


def local_row_range(n: int, ndev: int, device_index: int) -> tuple[int, int]:
    """Global row interval [r0, r1) owned by ``device_index`` under the
    uniform 1-D row partition of ``partition.partition_blocks``."""
    n_loc = -(-n // ndev)
    r0 = min(n, device_index * n_loc)
    return r0, min(n, r0 + n_loc)

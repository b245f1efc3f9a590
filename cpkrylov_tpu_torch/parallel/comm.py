"""Collectives of the row-partitioned solve over a ``torch.distributed``
process group.

What the JAX package spells ``lax.psum`` / ``lax.all_gather`` /
``lax.ppermute`` inside ``shard_map`` becomes three methods of
:class:`Comm`, which pairs a process group with the device of this rank's
tensors:

* :meth:`Comm.allreduce_sum` — the psum of the fused dot products, of the
  Schur interface residual and of the Schur complement's parts;
* :meth:`Comm.all_gather_vec` — the full vector from every rank's slice
  (SpMV operands without a halo plan, the replicated preconditioner);
* :meth:`Comm.neighbor_exchange` — the halo edges to and from the ranks
  either side (``halo.py``).

The backend is the caller's choice and is never switched silently.  Under
NCCL device tensors go straight to the collective.  Under gloo they are
copied to host buffers and back: scalars, halo edges of tens of entries and
the Schur interface of size s (all-gathers move a whole vector).  gloo is
the backend for CPU tensors and for ranks that share one card, where NCCL
refuses to run.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


class Comm:
    """The default process group and this rank's device."""

    def __init__(self, device=None):
        from ..utils.device import resolve_device

        self.rank = dist.get_rank()
        self.size = dist.get_world_size()
        self.backend = str(dist.get_backend()).lower()
        self.device = resolve_device(device)
        if self.backend == "nccl" and self.device.type != "cuda":
            raise ValueError(f"the nccl backend needs CUDA tensors, not "
                             f"{self.device}")
        if self.backend not in ("nccl", "gloo"):
            raise ValueError(f"unsupported backend {self.backend!r}")
        self._on_host = self.backend == "gloo"
        # collectives this Comm has issued, by kind
        self.calls = {"allreduce": 0, "all_gather": 0, "exchange": 0}

    def __repr__(self) -> str:
        return (f"Comm(rank={self.rank}, size={self.size}, "
                f"backend={self.backend!r}, device={self.device})")

    def _send_buf(self, t: torch.Tensor) -> torch.Tensor:
        """A contiguous copy of ``t`` where the backend takes it: on the
        host under gloo, on this rank's device under NCCL.  The collective
        writes into it, never into ``t``."""
        where = "cpu" if self._on_host else self.device
        return t.detach().to(where, copy=True).contiguous()

    def allreduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the ranks, on ``t``'s device."""
        buf = self._send_buf(t.reshape(-1))
        dist.all_reduce(buf)
        self.calls["allreduce"] += 1
        return buf.to(t.device).reshape(t.shape)

    def all_gather_vec(self, v: torch.Tensor,
                       size: int | None = None) -> torch.Tensor:
        """The concatenation of every rank's equally long vector ``v``, cut
        to ``size`` entries (the unpadded length)."""
        buf = self._send_buf(v)
        parts = [torch.empty_like(buf) for _ in range(self.size)]
        dist.all_gather(parts, buf)
        self.calls["all_gather"] += 1
        full = torch.cat(parts).to(v.device)
        return full if size is None else full[:size]

    def neighbor_exchange(self, left_edge: torch.Tensor,
                          right_edge: torch.Tensor):
        """Send ``left_edge`` to rank - 1 and ``right_edge`` to rank + 1.

        Returns ``(from_left, from_right)``: the ``right_edge`` of rank - 1
        and the ``left_edge`` of rank + 1, zeros at the ends of the row of
        ranks.  Every rank passes edges of the same lengths."""
        from_left = torch.zeros_like(right_edge)
        from_right = torch.zeros_like(left_edge)
        if self.size == 1:
            return from_left, from_right
        ops = []
        recv_l = recv_r = None
        if self.rank > 0:
            recv_l = self._send_buf(from_left)
            ops += [dist.P2POp(dist.isend, self._send_buf(left_edge),
                               self.rank - 1),
                    dist.P2POp(dist.irecv, recv_l, self.rank - 1)]
        if self.rank < self.size - 1:
            recv_r = self._send_buf(from_right)
            ops += [dist.P2POp(dist.isend, self._send_buf(right_edge),
                               self.rank + 1),
                    dist.P2POp(dist.irecv, recv_r, self.rank + 1)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        self.calls["exchange"] += 1
        if recv_l is not None:
            from_left = recv_l.to(right_edge.device)
        if recv_r is not None:
            from_right = recv_r.to(left_edge.device)
        return from_left, from_right

    def close(self) -> None:
        """Destroy the process group."""
        dist.destroy_process_group()

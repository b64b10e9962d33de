"""The collectives of tensor, data and pipeline parallelism, with a tally.

The JAX package gets its collectives from GSPMD (XLA inserts them from the
parameter shardings); the port places them by hand, as Megatron does, at the
boundaries of each column/row pair:

* :func:`copy_to_tp` (f): identity forward, all-reduce of the gradient
  backward: the input of a column-parallel layer, replicated over tp;
* :func:`reduce_from_tp` (g): all-reduce forward, identity backward: the
  partial products of a row-parallel layer. Its backward is the identity
  because every tp rank then uses the whole sum (an all-reduce there, as
  ``torch.distributed.nn.functional.all_reduce`` does, would give tp times
  the gradient);
* :func:`gather_from_tp`: all-gather on the last axis, slicing backward: the
  output of a column-parallel layer whose consumer needs it whole;
* :func:`split_batch` / :func:`gather_batch`: the leading axis over dp.

All-reduces sum in fp32 and cast back. Each call adds its count and result
bytes to :data:`TALLY`, which parallel/diagnostics.py reads; a backward
collective counts when it runs.

Gloo takes CUDA tensors for all-reduce, all-gather and broadcast, but not
for point-to-point send and receive: those go through host memory when the
group's backend is gloo (two ranks sharing one card, which NCCL refuses).
The compute stays on the card.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.distributed as dist


# {op: [count, bytes]} over every group, the ops named as the JAX package's
# HLO collectives (all-reduce, all-gather, collective-permute,
# collective-broadcast)
TALLY: Dict[str, List[int]] = {}


def _tally(op: str, nbytes: int) -> None:
    entry = TALLY.setdefault(op, [0, 0])
    entry[0] += 1
    entry[1] += int(nbytes)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``, taken in fp32, in x's dtype (a new
    tensor; x is left as it is)."""
    y = x.float().clone() if x.dtype == torch.float32 else x.float()
    dist.all_reduce(y, group=group)
    _tally("all-reduce", _nbytes(y))
    return y.to(x.dtype)


def all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in rank order."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    out = torch.cat(parts, dim=dim)
    _tally("all-gather", _nbytes(out))
    return out


def _chunk(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n, r = dist.get_world_size(group), dist.get_rank(group)
    return x.chunk(n, dim=dim)[r].contiguous()


def broadcast(x: torch.Tensor, src: int, group) -> torch.Tensor:
    """``x`` of the group's rank ``src`` (its index in the group) on every
    rank, in place."""
    dist.broadcast(x, src=dist.get_global_rank(group, src), group=group)
    _tally("collective-broadcast", _nbytes(x))
    return x


def _host_staged(group, t: torch.Tensor) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def send(tensors: Sequence[torch.Tensor], dst: int, group) -> tuple:
    """Start sending ``tensors`` to the group's rank ``dst``; returns the
    pending (work, the buffers it reads), for :func:`wait`."""
    bufs = [t.cpu() if _host_staged(group, t) else t.contiguous() for t in tensors]
    peer = dist.get_global_rank(group, dst)
    works = dist.batch_isend_irecv([dist.P2POp(dist.isend, b, peer, group) for b in bufs])
    for b in bufs:
        _tally("collective-permute", _nbytes(b))
    return works, bufs


def recv(like: Sequence[torch.Tensor], src: int, group) -> List[torch.Tensor]:
    """Receive tensors shaped as ``like`` from the group's rank ``src``."""
    bufs = [torch.empty(t.shape, dtype=t.dtype,
                        device="cpu" if _host_staged(group, t) else t.device) for t in like]
    peer = dist.get_global_rank(group, src)
    for w in dist.batch_isend_irecv([dist.P2POp(dist.irecv, b, peer, group) for b in bufs]):
        w.wait()
    return [b.to(t.device) for b, t in zip(bufs, like)]


def wait(pending: Sequence[tuple]) -> None:
    """Wait for sends started by :func:`send`."""
    for works, _ in pending:
        for w in works:
            w.wait()


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_gather(x, group, dim=-1)

    @staticmethod
    def backward(ctx, g):
        return _chunk(g, ctx.group, -1), None


class _SplitBatch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _chunk(x, group, 0)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.group, dim=0), None


class _GatherBatch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_gather(x, group, dim=0)

    @staticmethod
    def backward(ctx, g):
        return _chunk(g, ctx.group, 0), None


def copy_to_tp(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyToTP.apply(x, group)


def reduce_from_tp(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFromTP.apply(x, group)


def gather_from_tp(x: torch.Tensor, group) -> torch.Tensor:
    return _GatherFromTP.apply(x, group)


def split_batch(x: torch.Tensor, group) -> torch.Tensor:
    """This rank's 1/n of the leading axis (n must divide it)."""
    return _SplitBatch.apply(x, group)


def gather_batch(x: torch.Tensor, group) -> torch.Tensor:
    return _GatherBatch.apply(x, group)

"""Pipeline parallelism (pp) for the DiT's block stacks (port of
hunyuan3d2_tpu/parallel/pipeline.py).

Each stage holds ``depth // pp`` consecutive double blocks and
``depth_single_blocks // pp`` single blocks; microbatches flow stage to
stage in a GPipe schedule of n_micro + pp − 1 ticks: stage s works on
microbatch k − s at tick k, receiving its activations from stage s − 1 and
sending them to stage s + 1 point to point (``batch_isend_irecv``). The
schedule is the JAX package's, with its masked edge ticks left out: a stage
blocks on its receive instead. As there:

* the timestep and guidance embeddings are recomputed per stage from the
  replicated inputs (one small MLP buys one fewer transfer a tick);
* the last stage banks the finished microbatches, then broadcasts them;
* the double-stream phase and the single-stream phase over
  concat(txt, img) run as two pipelines back to back, and the final adaLN
  head runs replicated.

The bubble is (pp − 1)/(n_micro + pp − 1): pick n_micro ≥ 2·pp.

The mesh (:func:`make_pp_mesh`) is ("dp", "pp") over every rank: the
pipeline runs along "pp", and each "dp" row is an independent replica.
"""

from __future__ import annotations

import copy
from typing import List, Optional

import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh

from hunyuan3d2_tpu_torch.parallel import collectives as C
from hunyuan3d2_tpu_torch.parallel.mesh import group_size


def make_pp_mesh(pp: int, device: str = "cuda") -> DeviceMesh:
    """A ("dp", "pp") mesh over every rank of the process group: pipelines of
    ``pp`` consecutive ranks, world // pp of them."""
    world = group_size(device)
    if pp > world or world % pp:
        raise RuntimeError(f"make_pp_mesh: pp={pp} does not divide the {world} ranks of the "
                           "process group")
    return DeviceMesh(device, torch.arange(world).reshape(world // pp, pp),
                      mesh_dim_names=("dp", "pp"))


class Stage(nn.Module):
    """One stage's blocks, numbered from 0 (``double_blocks``,
    ``single_blocks``)."""

    def __init__(self, double: list, single: list):
        super().__init__()
        self.double_blocks = nn.ModuleList(double)
        self.single_blocks = nn.ModuleList(single)


def split_stages(model: nn.Module, pp: int) -> List[Stage]:
    """The DiT's block stacks in ``pp`` stages of consecutive blocks (the same
    modules, not copies)."""
    cfg = model.cfg
    d, ds = cfg.depth, cfg.depth_single_blocks
    if d % pp or ds % pp:
        raise ValueError(f"pp={pp} must divide depth={d} and depth_single_blocks={ds}")
    return [Stage(list(model.double_blocks)[s * d // pp:(s + 1) * d // pp],
                  list(model.single_blocks)[s * ds // pp:(s + 1) * ds // pp])
            for s in range(pp)]


class PipelinedDiT:
    """A DiT run as a pipeline over the mesh's "pp" axis: built once, then
    called like the model, ``(x, t, cond, guidance=None)`` on every rank of
    the pipeline with the same (replicated) inputs, for inference; returns
    the whole output on every rank. This rank keeps its stage's blocks, the
    embeddings and the final layer (``self.model``); the caller may drop the
    whole model."""

    def __init__(self, model: nn.Module, mesh: DeviceMesh, n_micro: int = 4):
        self.cfg = model.cfg
        self.n_micro = n_micro
        self.group = mesh.get_group("pp")
        self.pp = mesh.size(mesh.mesh_dim_names.index("pp"))
        self.stage = mesh.get_local_rank("pp")
        stage = split_stages(model, self.pp)[self.stage]
        self.model = copy.copy(model)   # the same modules, this stage's blocks only
        self.model._modules = dict(model._modules, double_blocks=stage.double_blocks,
                                   single_blocks=stage.single_blocks)

    def _phase(self, inputs: List[list], blocks, like: list, vecs: list) -> list:
        """One pipeline over ``blocks``: microbatch i enters stage 0 as
        ``inputs[i]`` (stage 0 only) and the last stage's outputs are
        broadcast; returns, per microbatch, the list of its tensors."""
        s, pp, g = self.stage, self.pp, self.group
        pending, done = [], []
        for i in range(self.n_micro):
            acts = inputs[i] if s == 0 else C.recv(like, s - 1, g)
            for blk in blocks:
                acts = blk(*acts, vecs[i])
                acts = list(acts) if isinstance(acts, tuple) else [acts]
            if s < pp - 1:
                pending.append(C.send(acts, s + 1, g))
            else:
                done.append(acts)
        C.wait(pending)
        if s == pp - 1:
            out = [torch.stack(parts) for parts in zip(*done)]
        else:
            out = [torch.empty((self.n_micro,) + tuple(t.shape), dtype=t.dtype, device=t.device)
                   for t in like]
        for t in out:
            C.broadcast(t, pp - 1, g)
        return [[t[i] for t in out] for i in range(self.n_micro)]

    @torch.no_grad()
    def __call__(self, x: torch.Tensor, t: torch.Tensor, cond: torch.Tensor,
                 guidance: Optional[torch.Tensor] = None) -> torch.Tensor:
        n, m = self.n_micro, self.model
        b = x.shape[0]
        if b % n:
            raise ValueError(f"batch {b} must divide into {n} microbatches")
        cond = cond.to(x.dtype)
        mb, h = b // n, self.cfg.hidden_size
        xm, tm, cm = x.chunk(n), t.chunk(n), cond.chunk(n)
        gm = guidance.chunk(n) if guidance is not None else [None] * n
        vecs = [m.embed_vec(tm[i], gm[i], x.dtype) for i in range(n)]
        l, lc = x.shape[1], cond.shape[1]
        first = [[m.latent_in(xm[i]), m.cond_in(cm[i])] if self.stage == 0 else None
                 for i in range(n)]
        like = [torch.empty(mb, l, h, dtype=x.dtype, device=x.device),
                torch.empty(mb, lc, h, dtype=x.dtype, device=x.device)]
        pairs = self._phase(first, m.double_blocks, like, vecs)
        cat = [[torch.cat([txt, img], dim=1)] for img, txt in pairs]
        like = [torch.empty(mb, lc + l, h, dtype=x.dtype, device=x.device)]
        outs = self._phase(cat, m.single_blocks, like, vecs)
        return torch.cat([m.final_layer(o[0][:, lc:], vecs[i]) for i, o in enumerate(outs)])


def pp_apply(model: nn.Module, mesh: DeviceMesh, x: torch.Tensor, t: torch.Tensor,
             cond: torch.Tensor, n_micro: int = 4, guidance=None) -> torch.Tensor:
    """Pipeline-parallel forward of ``model`` (the DiT): the same function,
    its blocks staged over the mesh's "pp" axis, the batch in ``n_micro``
    microbatches. x [B, L, C] · t [B] · cond [B, Lc, D]; n_micro divides B.
    One-shot; a loop holds a :class:`PipelinedDiT`."""
    return PipelinedDiT(model, mesh, n_micro)(x, t, cond, guidance)

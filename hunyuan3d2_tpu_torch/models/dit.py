"""Hunyuan3D-DiT, the FLUX-style latent-set diffusion transformer (port of
hunyuan3d2_tpu/models/dit.py).

Modules carry the reference checkpoint's names (double_blocks.N.img_attn.qkv,
single_blocks.N.linear1, final_layer.adaLN_modulation.1, ...). The block
stacks run as Python loops where the JAX package scans. The fused qkv layout
is (3, H, D); joint attention runs over [txt | img] tokens; the timestep
embedding uses max_period == time_factor == 1000 (reference
hunyuan3ddit.py:392 passes time_factor positionally into max_period).

On the card an inference forward replays a CUDA graph of itself
(``Hunyuan3DDiT.forward``, through utils/cuda_graphs.py): the eager body's
~3,300 launches a FULL forward become one, with the same kernels, dtypes and
arithmetic.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
from typing import Optional

import torch
from torch import nn

from hunyuan3d2_tpu_torch.ops.attention import attention, merge_heads, split_qkv_fused
from hunyuan3d2_tpu_torch.ops.embeddings import timestep_embedding
from hunyuan3d2_tpu_torch.ops.nn import Linear, RMSNorm, gelu_tanh, layer_norm, silu
from hunyuan3d2_tpu_torch.utils import timer
from hunyuan3d2_tpu_torch.utils.cuda_graphs import GraphPool, graphable

GRAPHS = 2                  # captured forwards a module keeps, the least recently used dropped
_GRAPH_LOCK = threading.Lock()


@dataclasses.dataclass(frozen=True)
class DiTConfig:
    in_channels: int = 64
    context_in_dim: int = 1536
    hidden_size: int = 1024
    mlp_ratio: float = 4.0
    num_heads: int = 16
    depth: int = 16
    depth_single_blocks: int = 32
    qkv_bias: bool = True
    time_factor: float = 1000.0
    guidance_embed: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def mlp_hidden(self) -> int:
        return int(self.hidden_size * self.mlp_ratio)


MINI = DiTConfig(depth=8, depth_single_blocks=16)
FULL = DiTConfig(depth=16, depth_single_blocks=32)
TINY = DiTConfig(hidden_size=128, num_heads=4, depth=2, depth_single_blocks=2,
                 context_in_dim=1536)


class MLPEmbedder(nn.Module):
    def __init__(self, in_dim: int, hidden: int):
        super().__init__()
        self.in_layer = Linear(in_dim, hidden)
        self.out_layer = Linear(hidden, hidden)

    def forward(self, x):
        return self.out_layer(silu(self.in_layer(x)))


class Modulation(nn.Module):
    def __init__(self, dim: int, n: int):
        super().__init__()
        self.n = n
        self.lin = Linear(dim, n * dim)

    def forward(self, vec):
        """SiLU → Linear → n chunks of [B, 1, H]."""
        return self.lin(silu(vec))[:, None, :].chunk(self.n, dim=-1)


class QKNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.query_norm = RMSNorm(dim)
        self.key_norm = RMSNorm(dim)


class SelfAttention(nn.Module):
    def __init__(self, cfg: DiTConfig):
        super().__init__()
        h = cfg.hidden_size
        self.qkv = Linear(h, 3 * h, bias=cfg.qkv_bias)
        self.norm = QKNorm(cfg.head_dim)
        self.proj = Linear(h, h)


def _mlp(cfg: DiTConfig) -> nn.Sequential:
    # reference names img_mlp.0 / img_mlp.2 (index 1 is the GELU)
    return nn.Sequential(Linear(cfg.hidden_size, cfg.mlp_hidden), nn.Identity(),
                         Linear(cfg.mlp_hidden, cfg.hidden_size))


class DoubleStreamBlock(nn.Module):
    def __init__(self, cfg: DiTConfig):
        super().__init__()
        self.num_heads = cfg.num_heads
        h = cfg.hidden_size
        self.img_mod = Modulation(h, 6)
        self.img_attn = SelfAttention(cfg)
        self.img_mlp = _mlp(cfg)
        self.txt_mod = Modulation(h, 6)
        self.txt_attn = SelfAttention(cfg)
        self.txt_mlp = _mlp(cfg)

    def _qkv(self, attn: SelfAttention, x_mod):
        q, k, v = split_qkv_fused(attn.qkv(x_mod), self.num_heads)
        return attn.norm.query_norm(q), attn.norm.key_norm(k), v

    def forward(self, img, txt, vec):
        im = self.img_mod(vec)
        tm = self.txt_mod(vec)
        iq, ik, iv = self._qkv(self.img_attn, (1.0 + im[1]) * layer_norm(img) + im[0])
        tq, tk, tv = self._qkv(self.txt_attn, (1.0 + tm[1]) * layer_norm(txt) + tm[0])
        q = torch.cat([tq, iq], dim=2)
        k = torch.cat([tk, ik], dim=2)
        v = torch.cat([tv, iv], dim=2)
        attn = merge_heads(attention(q, k, v))
        txt_attn, img_attn = attn[:, :txt.shape[1]], attn[:, txt.shape[1]:]

        img = img + im[2] * self.img_attn.proj(img_attn)
        img = img + im[5] * self.img_mlp[2](
            gelu_tanh(self.img_mlp[0]((1.0 + im[4]) * layer_norm(img) + im[3])))
        txt = txt + tm[2] * self.txt_attn.proj(txt_attn)
        txt = txt + tm[5] * self.txt_mlp[2](
            gelu_tanh(self.txt_mlp[0]((1.0 + tm[4]) * layer_norm(txt) + tm[3])))
        return img, txt


class SingleStreamBlock(nn.Module):
    def __init__(self, cfg: DiTConfig):
        super().__init__()
        h = cfg.hidden_size
        self.hidden_size, self.num_heads = h, cfg.num_heads
        self.linear1 = Linear(h, 3 * h + cfg.mlp_hidden)
        self.linear2 = Linear(h + cfg.mlp_hidden, h)
        self.norm = QKNorm(cfg.head_dim)
        self.modulation = Modulation(h, 3)

    def forward(self, x, vec):
        shift, scale, gate = self.modulation(vec)
        hcat = self.linear1((1.0 + scale) * layer_norm(x) + shift)
        qkv, mlp = hcat[..., :3 * self.hidden_size], hcat[..., 3 * self.hidden_size:]
        q, k, v = split_qkv_fused(qkv, self.num_heads)
        q, k = self.norm.query_norm(q), self.norm.key_norm(k)
        attn = merge_heads(attention(q, k, v))
        return x + gate * self.linear2(torch.cat([attn, gelu_tanh(mlp)], dim=-1))


class LastLayer(nn.Module):
    def __init__(self, cfg: DiTConfig):
        super().__init__()
        h = cfg.hidden_size
        self.adaLN_modulation = nn.Sequential(nn.SiLU(), Linear(h, 2 * h))
        self.linear = Linear(h, cfg.in_channels)

    def forward(self, x, vec):
        shift, scale = self.adaLN_modulation[1](silu(vec)).chunk(2, dim=-1)
        return self.linear((1.0 + scale[:, None]) * layer_norm(x) + shift[:, None])


class Hunyuan3DDiT(nn.Module):
    def __init__(self, cfg: DiTConfig = FULL):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        self.latent_in = Linear(cfg.in_channels, h)
        self.time_in = MLPEmbedder(256, h)
        if cfg.guidance_embed:
            self.guidance_in = MLPEmbedder(256, h)
        self.cond_in = Linear(cfg.context_in_dim, h)
        self.double_blocks = nn.ModuleList([DoubleStreamBlock(cfg) for _ in range(cfg.depth)])
        self.single_blocks = nn.ModuleList(
            [SingleStreamBlock(cfg) for _ in range(cfg.depth_single_blocks)])
        self.final_layer = LastLayer(cfg)
        self._graph_pool = GraphPool()      # the memory pool its graphs share
        self._drop_graphs()

    def _drop_graphs(self):
        self._graphs = collections.OrderedDict()   # key → cuda_graphs.Graph, oldest first
        self._graph_pool.drop()

    def _apply(self, fn, recurse=True):
        # .to(), .cuda(), to_empty(), the pipeline's offload and restore: the
        # tensors may move, and a graph reads them where they were captured
        self._drop_graphs()
        return super()._apply(fn, recurse)

    def load_state_dict(self, state_dict, strict: bool = True, assign: bool = False):
        """In place (the default) the parameters keep their addresses and a
        captured graph reads the new values; ``assign`` replaces the tensors,
        so it drops the graphs."""
        if assign:
            self._drop_graphs()
        return super().load_state_dict(state_dict, strict=strict, assign=assign)

    def embed_vec(self, t: torch.Tensor, guidance: Optional[torch.Tensor],
                  dtype: torch.dtype) -> torch.Tensor:
        """The modulation vector [B, hidden] from t [B] (and the guidance
        strength [B] of a guidance-distilled model) in ``dtype``."""
        cfg = self.cfg
        vec = self.time_in(timestep_embedding(
            t, 256, max_period=cfg.time_factor, time_factor=cfg.time_factor).to(dtype))
        if cfg.guidance_embed:
            if guidance is None:
                raise ValueError("guidance strength required for a guidance-distilled model")
            vec = vec + self.guidance_in(timestep_embedding(
                guidance, 256, max_period=cfg.time_factor, time_factor=cfg.time_factor).to(dtype))
        return vec

    def forward(self, x: torch.Tensor, t: torch.Tensor, cond: torch.Tensor,
                guidance: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [B, L, in_channels], t [B] in [0, 1], cond [B, Lc, context_in_dim]
        → velocity [B, L, in_channels] in x.dtype.

        A call that passes ``utils/cuda_graphs.py``'s gate (the mechanism is
        that module's), on a module not moved between calls
        (``moved_each_call``, set by the pipeline's
        ``enable_model_cpu_offload``), replays a CUDA graph of the eager body.
        The key: the inputs' shapes and dtypes and x's device; ``GRAPHS``
        kept, the least recently used dropped. Calls that share the module
        take turns from copying their inputs in to copying the output out;
        each replay adds 1 to the request's "DiT/graph_replays". Moving the
        module's tensors drops the graphs; an in-place ``load_state_dict``
        keeps them."""
        args = (x, t, cond, guidance)
        if (graphable(self, *(a for a in args if a is not None))
                and not getattr(self, "moved_each_call", False)):
            return self._replay(args)
        return self._forward(*args)

    def _replay(self, args) -> torch.Tensor:
        key = tuple(None if a is None else (tuple(a.shape), a.dtype) for a in args)
        key += (args[0].device,)
        with _GRAPH_LOCK:
            graph = self._graphs.get(key)
            if graph is None:
                inputs = tuple(None if a is None else a.clone() for a in args)
                # the short warm-up: the first 8 latent and cond tokens
                short = tuple(a if a is None or a.dim() < 3 else a[:, :8] for a in inputs)
                graph = self._graphs[key] = self._graph_pool.capture(self._forward, inputs,
                                                                     short, key)
                if len(self._graphs) > GRAPHS:
                    self._graphs.popitem(last=False)
            else:
                self._graphs.move_to_end(key)
            for static, a in zip(graph.args, args):
                if a is not None:
                    static.copy_(a)
            out = graph.replay().clone()
        timer.add("DiT/graph_replays", 1)
        return out

    def _forward(self, x, t, cond, guidance):
        """The eager body of :meth:`forward`."""
        cond = cond.to(x.dtype)
        latent = self.latent_in(x)
        vec = self.embed_vec(t, guidance, latent.dtype)
        cond = self.cond_in(cond)
        for blk in self.double_blocks:
            latent, cond = blk(latent, cond, vec)
        xcat = torch.cat([cond, latent], dim=1)
        for blk in self.single_blocks:
            xcat = blk(xcat, vec)
        return self.final_layer(xcat[:, cond.shape[1]:], vec)

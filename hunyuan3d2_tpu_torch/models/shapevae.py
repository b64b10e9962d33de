"""ShapeVAE, the decoder-only vector-set VAE (port of
hunyuan3d2_tpu/models/shapevae.py).

Modules carry the reference checkpoint's names (post_kl,
transformer.resblocks.N.attn.c_qkv, geo_decoder.cross_attn_decoder.*, ...).
The latent transformer and the cross-attention K/V run in fp32; the geo
decoder takes the K/V in bf16, except the pruned decode, which stays fp32.
The self-attention qkv layout is interleaved per head, (H, 3·hd) — not the
DiT's (3, H, D).

The FlashVDM decode function is chosen from the config's shape alone, as the
JAX package chooses it on its TPU (shapevae.py:258-306): the streamed decode
(ops/geo_decoder.py, the flash kernel and the MLP-tail kernel on the card)
where its gate passes; the K/V-pruned decode (:func:`decode_queries_pruned`)
for a config of >= 2048 latents that the stream's gate refuses; the fused
decoder kernel where its gate passes (<= 1024 latents); the dense plain
decode for a config that no kernel takes. The vanilla and hierarchical
decoders decode with the dense fp32 decode (:meth:`ShapeVAE.decode_queries`
on fp32 K/V), as the JAX package's grid decode does for them; its attention
goes through ``ops.attention.attention``, so on the card kernel 1 takes it
where the gate admits it, as the JAX decode reaches the flash kernel.
Every module is differentiable (the kernels without a gradient refuse
inputs that need one), so the decode trains (volume/diff_surface.py).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
from torch import nn

from hunyuan3d2_tpu_torch.ops.attention import attention, merge_heads
from hunyuan3d2_tpu_torch.ops.embeddings import fourier_embed, fourier_out_dim
from hunyuan3d2_tpu_torch.ops.geo_decoder import (
    decode_queries_plain,
    fused_geo_decode,
    fused_geo_decode_stream,
    fused_geo_stream_supported,
    fused_geo_supported,
)
from hunyuan3d2_tpu_torch.ops.nn import LayerNorm, Linear, build, gelu_exact, layer_norm
from hunyuan3d2_tpu_torch.utils import timer
from hunyuan3d2_tpu_torch.utils.logger import get_logger

logger = get_logger("hunyuan3d2_tpu_torch.shapevae")


@dataclasses.dataclass(frozen=True)
class ShapeVAEConfig:
    num_latents: int = 512
    embed_dim: int = 64
    width: int = 1024
    heads: int = 16
    num_decoder_layers: int = 16
    num_freqs: int = 8
    include_pi: bool = False
    scale_factor: float = 1.0188137142395404
    geo_decoder_mlp_expand_ratio: int = 4
    out_channels: int = 1
    qkv_bias: bool = False
    ln_eps: float = 1e-6

    @property
    def head_dim(self) -> int:
        return self.width // self.heads


MINI = ShapeVAEConfig(num_latents=512)
FULL = ShapeVAEConfig(num_latents=3072)
TINY = ShapeVAEConfig(num_latents=64, width=128, heads=4, num_decoder_layers=2)


class _Module(nn.Module):
    """Attribute bag for the checkpoint's intermediate name levels."""


class MLP(nn.Module):
    def __init__(self, width: int, hidden: int):
        super().__init__()
        self.c_fc = Linear(width, hidden)
        self.c_proj = Linear(hidden, width)

    def forward(self, x):
        return self.c_proj(gelu_exact(self.c_fc(x)))


def _qk_norms(cfg: ShapeVAEConfig) -> nn.Module:
    m = _Module()
    m.q_norm = LayerNorm(cfg.head_dim, cfg.ln_eps)
    m.k_norm = LayerNorm(cfg.head_dim, cfg.ln_eps)
    return m


class ResidualAttentionBlock(nn.Module):
    def __init__(self, cfg: ShapeVAEConfig):
        super().__init__()
        w = cfg.width
        self.cfg = cfg
        self.heads = cfg.heads  # this rank's share once tp shards it (parallel/sharding.py)
        self.ln_1 = LayerNorm(w, cfg.ln_eps)
        self.attn = _Module()
        self.attn.c_qkv = Linear(w, 3 * w, bias=cfg.qkv_bias)
        self.attn.c_proj = Linear(w, w)
        self.attn.attention = _qk_norms(cfg)
        self.ln_2 = LayerNorm(w, cfg.ln_eps)
        self.mlp = MLP(w, 4 * w)

    def forward(self, x):
        cfg = self.cfg
        qkv = self.attn.c_qkv(self.ln_1(x))
        b, l, _ = qkv.shape
        q, k, v = qkv.reshape(b, l, self.heads, 3 * cfg.head_dim).chunk(3, dim=-1)
        q = self.attn.attention.q_norm(q)
        k = self.attn.attention.k_norm(k)
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
        x = x + self.attn.c_proj(merge_heads(attention(q, k, v)))
        return x + self.mlp(self.ln_2(x))


class Transformer(nn.Module):
    def __init__(self, cfg: ShapeVAEConfig):
        super().__init__()
        self.resblocks = nn.ModuleList(
            [ResidualAttentionBlock(cfg) for _ in range(cfg.num_decoder_layers)])


class CrossAttentionDecoderBlock(nn.Module):
    def __init__(self, cfg: ShapeVAEConfig):
        super().__init__()
        w = cfg.width
        self.ln_1 = LayerNorm(w, cfg.ln_eps)
        self.ln_2 = LayerNorm(w, cfg.ln_eps)
        self.ln_3 = LayerNorm(w, cfg.ln_eps)
        self.attn = _Module()
        self.attn.c_q = Linear(w, w, bias=cfg.qkv_bias)
        self.attn.c_kv = Linear(w, 2 * w, bias=cfg.qkv_bias)
        self.attn.c_proj = Linear(w, w)
        self.attn.attention = _qk_norms(cfg)
        self.mlp = MLP(w, cfg.geo_decoder_mlp_expand_ratio * w)


class GeoDecoder(nn.Module):
    def __init__(self, cfg: ShapeVAEConfig):
        super().__init__()
        w = cfg.width
        self.query_proj = Linear(fourier_out_dim(3, cfg.num_freqs), w)
        self.cross_attn_decoder = CrossAttentionDecoderBlock(cfg)
        self.ln_post = LayerNorm(w)
        self.output_proj = Linear(w, cfg.out_channels)


def active_capacity(octree_resolution: int) -> int:
    """Static budget for compacted active cells (6·R², ~4× a sphere)."""
    return max(1 << 18, 6 * (octree_resolution + 1) ** 2)


def face_capacity(octree_resolution: int) -> int:
    """Static quad budget of the surface-nets emission (1.5× the cells)."""
    return (3 * active_capacity(octree_resolution)) // 2


def pruned_k_top(num_latents: int) -> int:
    """Keys kept per group by the pruned decode: the reference's rule, 1024
    of 3072, 256 of 512, else a third."""
    return {3072: 1024, 512: 256}.get(num_latents, num_latents // 3)


def decode_queries_pruned(vae: "ShapeVAE", queries: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, k_top: int, group_size: int = 512,
                          mode: str = "mean") -> torch.Tensor:
    """FlashVDM decode with the latent K/V pruned per group of ``group_size``
    queries (port of hunyuan3d2_tpu/models/shapevae.py:356-439), in k's
    dtype (fp32 on the FlashVDM path). queries [B, P, 3] with P divisible by
    ``group_size``; k/v [B, H, L, D] → [B, P] logits.

    * ``mean``: each key is scored with the mean of the group's ::50
      subsampled queries, and each head keeps its own top-k.
    * ``merge``: the ::30 subsampled queries score the keys with an
      unscaled softmax over keys, the mean over heads and the max over the
      queries; one top-k is shared by the heads, and a kept key whose score
      is not above 1e-6 is masked out of the final softmax.
    Top-k ties go to the lowest index, as ``jax.lax.top_k`` breaks them."""
    from hunyuan3d2_tpu_torch.volume.decoders import stable_topk

    if mode not in ("mean", "merge"):
        raise ValueError(f"mode must be 'mean' or 'merge', got {mode!r}")
    cfg = vae.cfg
    g = vae.geo_decoder
    blk = g.cross_attn_decoder
    b, heads, lk, hd = k.shape
    x = g.query_proj(fourier_embed(queries, cfg.num_freqs, cfg.include_pi).to(k.dtype))
    q = blk.attn.c_q(blk.ln_1(x))
    bq, p, _ = q.shape
    q = blk.attn.attention.q_norm(q.reshape(bq, p, heads, hd))
    ng = p // group_size
    k_top = min(k_top, lk)
    qg = q.reshape(bq, ng, group_size, heads, hd)
    valid = None
    if mode == "merge":
        sim = torch.einsum("bgqhd,bhld->bghql", qg[:, :, ::30].float(), k.float())
        act = torch.softmax(sim, dim=-1).mean(dim=2).amax(dim=2)        # [B, ng, L]
        idx = stable_topk(act, k_top)                                   # [B, ng, k]
        valid = act.gather(-1, idx) > 1e-6
        idx = idx[:, :, None].expand(b, ng, heads, k_top)
    else:
        qbar = qg[:, :, ::50].mean(dim=2)                               # [B, ng, H, D]
        scores = torch.einsum("bghd,bhld->bghl", qbar.float(), k.float())
        idx = stable_topk(scores, k_top)                                # [B, ng, H, k]
    gidx = idx[..., None].expand(b, ng, heads, k_top, hd)
    k_sel = torch.gather(k[:, None].expand(b, ng, heads, lk, hd), 3, gidx)
    v_sel = torch.gather(v[:, None].expand(b, ng, heads, lk, hd), 3, gidx)

    qh = qg.permute(0, 1, 3, 2, 4)                                      # [B, ng, H, G, D]
    logits = torch.einsum("bghqd,bghkd->bghqk", qh.float(), k_sel.float()) * hd ** -0.5
    if valid is not None:
        logits = logits.masked_fill(~valid[:, :, None, None, :], float("-inf"))
    w = torch.softmax(logits, dim=-1).to(qh.dtype)
    o = torch.einsum("bghqk,bghkd->bghqd", w.float(), v_sel.float()).to(x.dtype)
    x = x + blk.attn.c_proj(o.permute(0, 1, 3, 2, 4).reshape(bq, p, heads * hd))
    x = x + blk.mlp(blk.ln_3(x))
    x = layer_norm(x, g.ln_post.weight, g.ln_post.bias)
    return g.output_proj(x)[..., 0]


def decode_queries_topk(vae: "ShapeVAE", queries: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor, k_top: int, group_size: int = 512) -> torch.Tensor:
    """The pruned decode's 'mean' mode, under the name the JAX package keeps
    for it."""
    return decode_queries_pruned(vae, queries, k, v, k_top, group_size, mode="mean")


class ShapeVAE(nn.Module):
    """Reference public surface: ``__call__`` (latents → hidden tokens),
    ``enable_flashvdm_decoder``, ``latents2mesh``, ``decode_grid``."""

    def __init__(self, cfg: ShapeVAEConfig = MINI):
        super().__init__()
        self.cfg = cfg
        self.post_kl = Linear(cfg.embed_dim, cfg.width)
        self.transformer = Transformer(cfg)
        self.geo_decoder = GeoDecoder(cfg)
        self.volume_decoder = None
        self.surface_extractor = None

    @classmethod
    def init_random(cls, cfg: ShapeVAEConfig = MINI, device=None, generator=None):
        return build(cls, cfg, device=device, generator=generator)

    @property
    def device(self) -> torch.device:
        return self.post_kl.weight.device

    def drop_device_caches(self):
        """Forget the geo decoder's kernel operands (device copies of its
        weights, see ``ops/geo_decoder.py``); the next decode builds them."""
        self._geo_operands = None
        return self

    # -- the pure pieces ----------------------------------------------------
    def forward(self, latents: torch.Tensor) -> torch.Tensor:
        return self.decode_latents(latents)

    def decode_latents(self, latents: torch.Tensor) -> torch.Tensor:
        """[B, L, embed_dim] → [B, L, width] hidden tokens, fp32, including
        the 1/scale_factor rescale."""
        x = self.post_kl(latents.float() / self.cfg.scale_factor)
        for blk in self.transformer.resblocks:
            x = blk(x)
        return x

    def compute_kv(self, hidden: torch.Tensor):
        """hidden [B, L, width] → (k, v) each [B, heads, L, head_dim], k
        LayerNorm applied, in hidden's dtype."""
        cfg = self.cfg
        blk = self.geo_decoder.cross_attn_decoder
        kv = blk.attn.c_kv(blk.ln_2(hidden))
        b, l, _ = kv.shape
        k, v = kv.reshape(b, l, cfg.heads, 2 * cfg.head_dim).chunk(2, dim=-1)
        k = blk.attn.attention.k_norm(k)
        return k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()

    def decode_queries(self, queries: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
        """Occupancy logits [B, P] for xyz queries [B, P, 3]: the dense
        decode, its attention through kernel 1 where the gate admits it (JAX
        models/shapevae.py:179). ``decode_queries_plain`` is its plain twin."""
        return decode_queries_plain(self, queries, k, v, attend=attention)

    def query_decoder(self, k: torch.Tensor, v: torch.Tensor):
        """The FlashVDM decode function for fp32 K/V [1, H, L, D], chosen as
        the module notes say: pts [1, P, 3] fp32 → [1, P] fp32 logits."""
        cfg = self.cfg
        k16, v16 = k.to(torch.bfloat16).contiguous(), v.to(torch.bfloat16).contiguous()
        if fused_geo_stream_supported(cfg):
            return lambda pts: fused_geo_decode_stream(self, pts.contiguous(), k16, v16)
        if cfg.num_latents >= 2048:
            k_top = pruned_k_top(cfg.num_latents)
            mode = getattr(self.volume_decoder, "topk_mode", "mean")

            def decode_pruned(pts):
                p = pts.shape[1]
                gp = min(512, p)
                pts = torch.nn.functional.pad(pts, (0, 0, 0, (-p) % gp))
                return decode_queries_pruned(self, pts, k, v, k_top, gp, mode)[:, :p]
            return decode_pruned
        if fused_geo_supported(cfg):
            return lambda pts: fused_geo_decode(self, pts.contiguous(), k16, v16)
        return lambda pts: self.decode_queries(pts, k16, v16).float()

    # -- volume decode and meshing ------------------------------------------
    def enable_flashvdm_decoder(self, enabled: bool = True, topk_mode: str = "mean",
                                mc_algo: str = "mc", adaptive_kv_selection=True):
        """``enabled``: the FlashVDM decoder (``adaptive_kv_selection``) or
        the hierarchical one, with ``SurfaceExtractors[mc_algo]``; disabled:
        the vanilla decoder with marching cubes (reference model.py:112-129).
        ``topk_mode`` is the K/V pruning mode of the pruned decode."""
        from hunyuan3d2_tpu_torch.volume import decoders, surface

        if enabled:
            if adaptive_kv_selection:
                self.volume_decoder = decoders.FlashVDMVolumeDecoding(topk_mode)
            else:
                self.volume_decoder = decoders.HierarchicalVolumeDecoding()
            if mc_algo not in surface.SurfaceExtractors:
                raise ValueError(f"Unsupported mc_algo {mc_algo}, available: "
                                 f"{list(surface.SurfaceExtractors)}")
            self.surface_extractor = surface.SurfaceExtractors[mc_algo]()
        else:
            self.volume_decoder = decoders.VanillaVolumeDecoder()
            self.surface_extractor = surface.SurfaceExtractors["mc"]()

    def _decode_fn(self, k: torch.Tensor, v: torch.Tensor):
        """The FlashVDM decoder's decode (:meth:`query_decoder`); the dense
        fp32 decode (:meth:`decode_queries`) for the vanilla and hierarchical
        decoders. Each call is a "Geo Decode" span that adds the queries it
        sends to the request's "Volume Decoding/queries_sent"."""
        from hunyuan3d2_tpu_torch.volume import decoders

        if isinstance(self.volume_decoder, decoders.FlashVDMVolumeDecoding):
            fn = self.query_decoder(k, v)
        else:
            def fn(pts):
                return self.decode_queries(pts, k, v)

        def decode(pts):
            with timer.span("Geo Decode"):
                timer.add("Volume Decoding/queries_sent", pts.shape[0] * pts.shape[1])
                return fn(pts)
        return decode

    def _decode_sparse(self, latents, octree_resolution, num_chunks, box_v, mc_level):
        """A block-sparse decoder's (coarse16, blk_idx, fine16) for latents
        [1, L, C]."""
        with timer.span("VAE Trunk"):
            k, v = self.compute_kv(self.decode_latents(latents))
        return self.volume_decoder.decode_sparse(
            self._decode_fn(k, v), 1, octree_resolution, num_chunks, box_v, mc_level,
            device=self.device)

    def decode_grid(self, latents: torch.Tensor, octree_resolution: int = 384,
                    num_chunks: int = 65536, box_v: float = 1.01, mc_level: float = 0.0,
                    to_host: bool = False):
        """latents [B, L, C] → dense logit grid [B, R, R, R]: fp32 on the
        device, or with ``to_host`` a numpy grid (a block-sparse decoder's
        refined blocks over the nearest-neighbour coarse grid, f16; the
        vanilla grid rounded to f16, as f32)."""
        from hunyuan3d2_tpu_torch.volume import decoders

        if self.volume_decoder is None:
            self.volume_decoder = decoders.VanillaVolumeDecoder()
        dec = self.volume_decoder
        if isinstance(dec, decoders.HierarchicalVolumeDecoding):
            sparse = self._decode_sparse(latents, octree_resolution, num_chunks, box_v,
                                         mc_level)
            if to_host:
                return decoders.assemble_sparse_grid(*sparse, octree_resolution, dec.block,
                                                     dec.coarse_factor)
            return dec.densify(*sparse, octree_resolution)
        with timer.span("VAE Trunk"):
            k, v = self.compute_kv(self.decode_latents(latents))
        grid = dec(self._decode_fn(k, v), batch_size=latents.shape[0],
                   octree_resolution=octree_resolution, num_chunks=num_chunks, box_v=box_v,
                   mc_level=mc_level, device=self.device)
        return grid.half().cpu().numpy().astype(np.float32) if to_host else grid

    def latents2mesh(self, latents: torch.Tensor, octree_resolution: int = 384,
                     mc_level: float = 0.0, num_chunks: int = 65536, mc_algo: str = "mc",
                     box_v: float = 1.01, **kwargs):
        """latents [B, L, C] → a Latent2MeshOutput (or None) per item.

        ``mc_algo`` picks the extractor only when none is set yet. A
        block-sparse decoder decodes on the device; surface nets are then
        emitted there (``surface_nets_from_grid``), and the other extractors
        run on the host from the compacted active cells
        (``extract_active_cells``). When a fixed buffer overflows,
        HY3D_CAP_ACTIVES=1 keeps the capped buffers (the stable truncation);
        otherwise surface nets retry from the active cells, and an overflow
        of those falls back to the host-assembled grid and a dense host
        extraction (as does the vanilla decoder)."""
        from hunyuan3d2_tpu_torch.volume import decoders, surface

        if self.volume_decoder is None:
            self.volume_decoder = decoders.VanillaVolumeDecoder()
        if self.surface_extractor is None:
            self.surface_extractor = surface.SurfaceExtractors[mc_algo]()
        dec, extractor = self.volume_decoder, self.surface_extractor
        if not isinstance(dec, decoders.HierarchicalVolumeDecoding):
            grid = self.decode_grid(latents, octree_resolution, num_chunks, box_v, mc_level,
                                    to_host=True)
            return extractor(grid, mc_level=mc_level, box_v=box_v)
        if latents.shape[0] > 1:
            return [m for i in range(latents.shape[0]) for m in self.latents2mesh(
                latents[i:i + 1], octree_resolution, mc_level, num_chunks, mc_algo, box_v)]
        sparse = self._decode_sparse(latents, octree_resolution, num_chunks, box_v, mc_level)
        if hasattr(extractor, "from_actives"):
            with timer.span("Surface"):
                mesh = self._mesh_on_device(dec.densify(*sparse, octree_resolution), extractor,
                                            octree_resolution, mc_level, box_v)
            if mesh is not None:
                return [mesh]
        grid = decoders.assemble_sparse_grid(*sparse, octree_resolution, dec.block,
                                             dec.coarse_factor)
        return extractor(grid, mc_level=mc_level, box_v=box_v)

    def _mesh_on_device(self, grid, extractor, octree_resolution, mc_level, box_v):
        """The mesh from a device grid, or None when its active cells
        overflow the fixed buffer and HY3D_CAP_ACTIVES is not set."""
        from hunyuan3d2_tpu_torch.volume import decoders, surface

        capped = os.environ.get("HY3D_CAP_ACTIVES", "0") == "1"
        capacity = active_capacity(octree_resolution)
        if isinstance(extractor, surface.SurfaceNetsExtractor):
            verts, quads, nq, count, ok = decoders.surface_nets_from_grid(
                grid, mc_level, box_v, capacity, face_capacity(octree_resolution))
            nq, count, ok = int(nq), int(count), bool(ok)
            if ok or capped:
                if not ok:
                    logger.warning("surface overflow (%d actives / %d quads): capping to "
                                   "device buffers %d/%d (HY3D_CAP_ACTIVES)", count, nq,
                                   verts.shape[0], quads.shape[0])
                    count = min(count, int(verts.shape[0]))
                    nq = min(nq, int(quads.shape[0]))
                q = quads[:nq].cpu().numpy()
                if not ok:
                    # stage-A overflow can leave unreferenced pad rows below
                    # the capacity: trim to the last referenced vertex
                    count = min(count, int(q.max()) + 1 if q.size else 0)
                v = verts[:count].cpu().numpy().astype(np.float32)
                return surface.Latent2MeshOutput(
                    v, decoders.quads_to_tris(q).astype(np.int32))
        cell_flat, vals, count = decoders.extract_active_cells(grid, mc_level, capacity)
        count = int(count)
        if count > capacity:
            if not capped:
                logger.warning("active cells %d > capacity %d: host-assembled fallback",
                               count, capacity)
                return None
            logger.warning("active cells %d > capacity %d: capping (HY3D_CAP_ACTIVES)",
                           count, capacity)
            count = capacity
        return extractor.from_actives(cell_flat, vals, count, octree_resolution + 1, mc_level,
                                      box_v)

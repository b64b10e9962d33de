"""Analytic FLOP counts of the shape stages, and the card's peak rates (the
port of bench.py's MFU accounting, bench.py:382-437).

The paint models count themselves (models/paint_unet.py ``flops`` /
``apply_flops``, models/sd_vae.py ``flops``). The counts here are matmul
work (2 FLOPs a multiply-add) plus attention counted dense (4·T·S·d); norms
and elementwise work are left out. Each equals, or lies within 1 % of,
``torch.utils.flop_counter.FlopCounterMode``'s count of the port's own
module on the CPU (tests/test_torch_flops.py).

The DiT is counted as it runs: each token-wise linear times the tokens it
sees, each per-sample linear (the adaLN modulations, the time and guidance
embedders) once a sample. bench.py:400 charges every parameter to every
joint token (``2·params·T``), which overcounts the mini DiT's CFG pass
1.65× and the FULL DiT's 1.49×.

The configs are duck-typed (the port's ``DiTConfig``, ``DinoConfig``,
``ShapeVAEConfig``), so the module imports no model.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet: dense tensor-core rates, the CUDA cores' fp32
# rate and the HBM3 bandwidth
PEAK_BF16 = 989e12
PEAK_TF32 = 495e12
PEAK_FP32 = 67e12
HBM_BYTES_PER_S = 3.35e12


def mfu(flops: float, seconds: float, peak: float = PEAK_BF16) -> float:
    """The share of ``peak`` that ``flops`` in ``seconds`` achieve."""
    return flops / seconds / peak


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def dit_forward_flops(cfg, latent_tokens: int, cond_tokens: int, batch: int) -> float:
    """One Hunyuan3D-DiT forward over ``batch`` samples (2 under CFG, 1 for
    a guidance-embedded model) of ``latent_tokens`` latents and
    ``cond_tokens`` conditioner tokens. A denoise of ``steps`` steps is
    ``steps`` such passes."""
    h, m = cfg.hidden_size, cfg.mlp_hidden
    lat, cond = latent_tokens, cond_tokens
    t = lat + cond

    def lin(cin, cout, rows):
        return 2.0 * cin * cout * rows

    f = lin(cfg.in_channels, h, lat) + lin(cfg.context_in_dim, h, cond)    # latent_in, cond_in
    f += (2 if cfg.guidance_embed else 1) * (lin(256, h, 1) + lin(h, h, 1))  # time, guidance
    attn = 4.0 * t * t * h
    double = (2 * lin(h, 6 * h, 1)                                   # img_mod, txt_mod
              + lin(h, 3 * h, t) + lin(h, h, t)                      # qkv, proj (both streams)
              + lin(h, m, t) + lin(m, h, t) + attn)                  # MLPs
    single = lin(h, 3 * h, 1) + lin(h, 3 * h + m, t) + lin(h + m, h, t) + attn
    f += cfg.depth * double + cfg.depth_single_blocks * single
    f += lin(h, 2 * h, 1) + lin(h, cfg.in_channels, lat)             # final layer
    return batch * f


def dino_params(cfg) -> int:
    """The parameter count of a DINOv2 tower (models/dinov2.py) at ``cfg``."""
    h = cfg.hidden_size
    if cfg.use_swiglu_ffn:
        s = cfg.swiglu_hidden
        ffn = h * 2 * s + 2 * s + s * h + h
    else:
        r = cfg.mlp_ratio * h
        ffn = h * r + r + r * h + h
    layer = 4 * (h * h + h) + ffn + 6 * h        # q, k, v, dense; FFN; 2 norms, 2 scales
    embed = h * cfg.num_channels * cfg.patch_size ** 2 + h + h + cfg.seq_len * h
    return embed + cfg.num_layers * layer + 2 * h


def dino_encode_flops(cfg, images: int = 1) -> float:
    """DINOv2 encodes of ``images`` images at ``cfg``'s resolution,
    bench.py's ``2·params·T + 4·T²·hidden·layers``: every parameter is
    charged to every token (the position table and the CLS token too), so
    it overcounts the matmul work slightly (0.24 % at giant, 0.48 % at
    large). CFG's unconditional tokens are zeros, not an encode."""
    t = cfg.seq_len
    return images * (2.0 * dino_params(cfg) * t + 4.0 * t * t * cfg.hidden_size * cfg.num_layers)


def geo_query_flops(cfg) -> float:
    """One query through the ShapeVAE geo decoder at ``cfg``: its
    query-side linears (query_proj over the Fourier features, c_q, c_proj,
    the MLP, output_proj) and the cross-attention over ``num_latents``
    keys. The latents' K/V projection runs once a decode, not a query."""
    w = cfg.width
    fourier = 3 * (2 * cfg.num_freqs + 1)
    hidden = cfg.geo_decoder_mlp_expand_ratio * w
    weights = fourier * w + 2 * w * w + 2 * w * hidden + w * cfg.out_channels
    return 2.0 * weights + 4.0 * cfg.num_latents * w


def volume_decode_queries(decoder, octree_resolution: int, num_chunks: int) -> int:
    """The queries that one mesh's volume decode sends through the geo
    decoder (volume/decoders.py): a block-sparse decoder's coarse pass, its
    tail chunk padded, plus its chosen fine blocks, padded to whole chunks
    of blocks; the vanilla decoder's (res+1)³ lattice, its tail chunk
    padded."""
    res = octree_resolution + 1
    if not hasattr(decoder, "block"):
        chunk = min(num_chunks, res ** 3)
        return _cdiv(res ** 3, chunk) * chunk
    block = decoder.block
    nb = _cdiv(res, block)
    ncp = nb * decoder.coarse_factor + 1
    chunk = min(num_chunks, ncp ** 3)
    coarse = _cdiv(ncp ** 3, chunk) * chunk
    k = max(1, min(int(nb ** 3 * decoder.capacity_frac), nb ** 3))
    blocks_per_chunk = max(1, num_chunks // block ** 3)
    return coarse + _cdiv(k, blocks_per_chunk) * blocks_per_chunk * block ** 3


def volume_decode_flops(cfg, queries: int) -> float:
    """``queries`` queries through the geo decoder at ``cfg``."""
    return queries * geo_query_flops(cfg)

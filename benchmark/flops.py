"""The yardstick's arithmetic, frozen here so that no change to the program
moves it: analytic operation counts, the bytes a call must move, and the
card's peaks.

Counts are matmul work (2 FLOPs a multiply-add) plus attention counted
dense (4·B·H·Lq·Lk·D); norms and elementwise work are left out. They were
copied from the port's ``utils/flops.py`` (which copied bench.py's MFU
accounting and fixed its DiT overcount) and are held equal to it at full
width by ``tests/test_bench_flops.py``; ``vae_trunk_flops`` is new here.
Configurations are the dicts of ``configs/*.json``.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet: dense tensor-core rates, and the HBM3
# bandwidth. An fp32 attention product is held to a third of the TF32 rate:
# the data sheet's TF32 rate rounds operands to a 10-bit mantissa, and the
# card's fastest way to fp32 accuracy on tensor cores is three TF32
# products a pair (3xTF32); the fp32 CUDA-core rate (67 TFLOP/s) is below
# what such a kernel reaches, so a share of it could pass 100 %.
PEAK_BF16 = 989e12
PEAK_TF32 = 495e12
PEAK_FP32_3XTF32 = PEAK_TF32 / 3
HBM_BYTES_PER_S = 3.35e12
PEAK_BY_DTYPE = {"bfloat16": PEAK_BF16, "float16": PEAK_BF16, "float32": PEAK_FP32_3XTF32}
BYTES_BY_DTYPE = {"bfloat16": 2, "float16": 2, "float32": 4}


def bound_s(ops: float, nbytes: float, peak: float) -> float:
    """The least time the card could take: the larger of the operations
    over the peak rate and the bytes over the HBM bandwidth."""
    return max(ops / peak, nbytes / HBM_BYTES_PER_S)


def _lin(cin, cout, rows):
    return 2.0 * cin * cout * rows


def dit_forward_flops(dit: dict, latent_tokens: int, cond_tokens: int, batch: int) -> float:
    """One Hunyuan3D-DiT forward over ``batch`` samples: each token-wise
    linear times the tokens it sees, each per-sample linear (adaLN
    modulations, time and guidance embedders) once a sample."""
    h = dit["hidden_size"]
    m = int(h * dit["mlp_ratio"])
    lat, cond = latent_tokens, cond_tokens
    t = lat + cond
    f = _lin(dit["in_channels"], h, lat) + _lin(dit["context_in_dim"], h, cond)
    f += (2 if dit["guidance_embed"] else 1) * (_lin(256, h, 1) + _lin(h, h, 1))
    attn = 4.0 * t * t * h
    double = (2 * _lin(h, 6 * h, 1) + _lin(h, 3 * h, t) + _lin(h, h, t)
              + _lin(h, m, t) + _lin(m, h, t) + attn)
    single = _lin(h, 3 * h, 1) + _lin(h, 3 * h + m, t) + _lin(h + m, h, t) + attn
    f += dit["depth"] * double + dit["depth_single_blocks"] * single
    f += _lin(h, 2 * h, 1) + _lin(h, dit["in_channels"], lat)
    return batch * f


def dino_seq_len(dino: dict) -> int:
    return (dino["image_size"] // dino["patch_size"]) ** 2 + 1


def dino_params(dino: dict) -> int:
    """The parameter count of a DINOv2 tower."""
    h = dino["hidden_size"]
    if dino["use_swiglu_ffn"]:
        s = dino["swiglu_hidden"]
        ffn = h * 2 * s + 2 * s + s * h + h
    else:
        r = dino["mlp_ratio"] * h
        ffn = h * r + r + r * h + h
    layer = 4 * (h * h + h) + ffn + 6 * h
    embed = h * dino["num_channels"] * dino["patch_size"] ** 2 + h + h + dino_seq_len(dino) * h
    return embed + dino["num_layers"] * layer + 2 * h


def dino_encode_flops(dino: dict, images: int = 1) -> float:
    """DINOv2 encodes of ``images`` images: ``2·params·T + 4·T²·hidden·layers``
    (every parameter charged to every token: 0.24 % over the matmul work at
    giant)."""
    t = dino_seq_len(dino)
    return images * (2.0 * dino_params(dino) * t
                     + 4.0 * t * t * dino["hidden_size"] * dino["num_layers"])


def vae_trunk_flops(vae: dict, batch: int = 1) -> float:
    """The ShapeVAE's latent trunk and the geo decoder's K/V projection over
    ``num_latents`` latents: post_kl, each layer's qkv, proj, 4× MLP and
    self-attention, then c_kv."""
    w, n = vae["width"], vae["num_latents"]
    layer = (_lin(w, 3 * w, n) + _lin(w, w, n) + _lin(w, 4 * w, n) + _lin(4 * w, w, n)
             + 4.0 * n * n * w)
    return batch * (_lin(vae["embed_dim"], w, n) + vae["num_decoder_layers"] * layer
                    + _lin(w, 2 * w, n))


def geo_query_flops(vae: dict) -> float:
    """One query through the geo decoder: query_proj over the Fourier
    features, c_q, c_proj, the MLP, output_proj, and the cross-attention
    over ``num_latents`` keys."""
    w = vae["width"]
    fourier = 3 * (2 * vae["num_freqs"] + 1)
    hidden = vae["geo_decoder_mlp_expand_ratio"] * w
    weights = fourier * w + 2 * w * w + 2 * w * hidden + w * vae["out_channels"]
    return 2.0 * weights + 4.0 * vae["num_latents"] * w


def geo_decode_bytes(vae: dict, queries: int, calls: int = 1) -> float:
    """The bytes ``calls`` decode calls over ``queries`` queries in all must
    move: the fp32 points in and logits out, and in each call the bf16 K/V
    of the latents and the bf16 weights, once."""
    w = vae["width"]
    fourier = 3 * (2 * vae["num_freqs"] + 1)
    hidden = vae["geo_decoder_mlp_expand_ratio"] * w
    weights = fourier * w + 2 * w * w + 2 * w * hidden + w * vae["out_channels"]
    return queries * (3 * 4 + 4) + calls * (2 * vae["num_latents"] * w * 2 + weights * 2)


def attention_flops(b: int, h: int, lq: int, lk: int, d: int) -> float:
    return 4.0 * b * h * lq * lk * d


def attention_bytes(b: int, h: int, lq: int, lk: int, d: int, itemsize: int) -> float:
    """q and o [B, H, Lq, D], k and v [B, H, Lk, D], each moved once."""
    return itemsize * b * h * d * (2 * lq + 2 * lk)

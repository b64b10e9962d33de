"""The plain reference of the ``v20fast`` configuration (Hunyuan3D-DiT
v2-0 Fast: DINOv2-giant conditioner, the FULL DiT with the guidance
embedding, a 5-step flow-matching Euler sampler, the 3072-latent ShapeVAE
and its geo decoder), in plain PyTorch, fp32, TF32 off.

It follows the published Hunyuan3D-2 code (hy3dgen/shapegen: preprocessors,
conditioner, hunyuan3ddit, schedulers, autoencoders) and reads the weights
by its checkpoint names. It imports nothing of the program: it makes the
image transform, the sampler's draws and the K/V itself from the request,
and reads the program's outputs only to judge them.

``precision="fp8"`` is the control: every matmul and attention product takes
its operands rounded to float8 e4m3 (one scale a tensor), the step below the
bf16 the configuration serves in.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

# each compared number's limit, set on the card at the cells' sizes
# (benchmark/control.py, 28 seeds over both cells) between the largest
# reading of the program and the smallest of the fp8 control, nearer the
# control: cond 0.01443 / 0.0638, latents 0.00353 / 0.0202, logits
# 0.00491 / 0.0407. The mesh's own faults need no reference: none.
LIMITS = {"cond_err": 0.040, "latents_err": 0.012, "logits_err": 0.024, "mesh_faults": 0}

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class Arith:
    """The products' precision: ``fp32`` (the reference) or ``fp8`` (the
    control)."""

    def __init__(self, precision: str):
        if precision not in ("fp32", "fp8"):
            raise ValueError(f"precision must be fp32 or fp8, got {precision!r}")
        self.fp8 = precision == "fp8"

    def operand(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if not self.fp8:
            return x
        s = x.abs().amax().clamp(min=1e-30) / 448.0
        return (x / s).to(torch.float8_e4m3fn).float() * s

    def linear(self, x, w, b=None):
        y = self.operand(x) @ self.operand(w).reshape(w.shape[0], -1).T
        return y if b is None else y + b.float()

    def attention(self, q, k, v, chunk: int = 4096):
        """Softmax attention, [B, H, L, D] fp32, in query chunks."""
        q, k, v = self.operand(q), self.operand(k), self.operand(v)
        scale = q.shape[-1] ** -0.5
        out = []
        for i in range(0, q.shape[2], chunk):
            p = torch.softmax(q[:, :, i:i + chunk] @ k.transpose(-1, -2) * scale, dim=-1)
            out.append(self.operand(p) @ v)
        return torch.cat(out, dim=2)


def layer_norm(x, w=None, b=None, eps=1e-6):
    return F.layer_norm(x.float(), x.shape[-1:], None if w is None else w.float(),
                        None if b is None else b.float(), eps)


def rms_norm(x, scale, eps=1e-6):
    x = x.float()
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale.float()


def heads(x, n):
    b, l, w = x.shape
    return x.reshape(b, l, n, w // n).transpose(1, 2)


def merge(x):
    b, h, l, d = x.shape
    return x.transpose(1, 2).reshape(b, l, h * d)


# -- the image transform (preprocessors.py ImageProcessorV2, conditioner.py) --
def preprocess(rgba: np.ndarray, size: int = 512, border_ratio: float = 0.15,
               image_size: int = 518) -> np.ndarray:
    """uint8 RGBA → the DINOv2 input [1, image_size, image_size, 3]: the
    object recentred by its alpha bbox to (1 - border_ratio) of a ``size``
    canvas, composited on white, to [-1, 1]; then to [0, 1], bilinear to
    ``image_size`` on the short side, centre-cropped, ImageNet-normalised."""
    from PIL import Image

    ys, xs = np.nonzero(rgba[..., 3] > 0)
    crop = rgba[ys.min():ys.max() + 1, xs.min():xs.max() + 1]
    h, w = crop.shape[:2]
    scale = int(size * (1 - border_ratio)) / max(h, w)
    nh, nw = max(1, int(round(h * scale))), max(1, int(round(w * scale)))
    canvas = np.zeros((size, size, 4), np.uint8)
    oy, ox = (size - nh) // 2, (size - nw) // 2
    canvas[oy:oy + nh, ox:ox + nw] = np.asarray(
        Image.fromarray(crop).resize((nw, nh), Image.BILINEAR))
    rgb = canvas[..., :3].astype(np.float32) / 255.0
    alpha = canvas[..., 3:4].astype(np.float32) / 255.0
    m11 = (rgb * alpha + (1.0 - alpha)) * 2.0 - 1.0
    x = (m11 + 1.0) / 2.0
    s = int(round(size * image_size / size))
    im = Image.fromarray((np.clip(x, 0, 1) * 255).astype(np.uint8)).resize((s, s), Image.BILINEAR)
    arr = np.asarray(im).astype(np.float32) / 255.0
    o = (s - image_size) // 2
    arr = arr[o:o + image_size, o:o + image_size]
    out = (arr - np.asarray(IMAGENET_MEAN, np.float32)) / np.asarray(IMAGENET_STD, np.float32)
    return out[None]


# -- DINOv2 (HF Dinov2Model with SwiGLU FFN and LayerScale) -------------------
def dinov2(W, A: Arith, cfg: dict, pixels: torch.Tensor) -> torch.Tensor:
    """pixels [B, H, W, 3] → last_hidden_state [B, 1 + patches, hidden]."""
    p, h = cfg["patch_size"], cfg["hidden_size"]
    pre = "conditioner.model."
    b, hh, ww, c = pixels.shape
    patches = pixels.reshape(b, hh // p, p, ww // p, p, c).permute(0, 1, 3, 5, 2, 4)
    patches = patches.reshape(b, (hh // p) * (ww // p), c * p * p)
    x = A.linear(patches, W[pre + "embeddings.patch_embeddings.projection.weight"],
                 W[pre + "embeddings.patch_embeddings.projection.bias"])
    cls = W[pre + "embeddings.cls_token"].float().expand(b, 1, h)
    x = torch.cat([cls, x], dim=1) + W[pre + "embeddings.position_embeddings"].float()
    for i in range(cfg["num_layers"]):
        L = f"{pre}encoder.layer.{i}."
        y = layer_norm(x, W[L + "norm1.weight"], W[L + "norm1.bias"])
        q, k, v = (heads(A.linear(y, W[f"{L}attention.attention.{n}.weight"],
                                  W[f"{L}attention.attention.{n}.bias"]), cfg["num_heads"])
                   for n in ("query", "key", "value"))
        a = A.linear(merge(A.attention(q, k, v)), W[L + "attention.output.dense.weight"],
                     W[L + "attention.output.dense.bias"])
        x = x + a * W[L + "layer_scale1.lambda1"].float()
        y = layer_norm(x, W[L + "norm2.weight"], W[L + "norm2.bias"])
        x1, x2 = A.linear(y, W[L + "mlp.weights_in.weight"], W[L + "mlp.weights_in.bias"]).chunk(2, -1)
        y = A.linear(F.silu(x1) * x2, W[L + "mlp.weights_out.weight"], W[L + "mlp.weights_out.bias"])
        x = x + y * W[L + "layer_scale2.lambda1"].float()
    return layer_norm(x, W[pre + "layernorm.weight"], W[pre + "layernorm.bias"])


# -- Hunyuan3D-DiT (hunyuan3ddit.py) -----------------------------------------
def timestep_embedding(t: torch.Tensor, dim: int = 256, max_period: float = 1000.0,
                       time_factor: float = 1000.0) -> torch.Tensor:
    """The published embedding with its quirk: the DiT passes time_factor
    (1000) as max_period. Layout [cos | sin]."""
    t = t.float() * time_factor
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(half, dtype=torch.float32,
                                                           device=t.device) / half)
    args = t[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def dit(W, A: Arith, cfg: dict, x, t, cond, guidance):
    """x [B, L, C] latents, t [B], cond [B, Lc, context] → velocity."""
    h, nh = cfg["hidden_size"], cfg["num_heads"]
    lin = lambda y, n: A.linear(y, W[f"model.{n}.weight"], W.get(f"model.{n}.bias"))

    def embed(v, n):
        e = timestep_embedding(v, 256, cfg["time_factor"], cfg["time_factor"])
        return lin(F.silu(lin(e, f"{n}.in_layer")), f"{n}.out_layer")

    def mod(vec, n, k):
        return lin(F.silu(vec), n)[:, None, :].chunk(k, dim=-1)

    def qkv(y, norm):
        b, l, _ = y.shape
        y = y.reshape(b, l, 3, nh, h // nh)
        q, k, v = (y[:, :, i].transpose(1, 2) for i in range(3))
        return (rms_norm(q, W[f"model.{norm}.query_norm.scale"]),
                rms_norm(k, W[f"model.{norm}.key_norm.scale"]), v)

    img = lin(x, "latent_in")
    vec = embed(t, "time_in")
    if cfg["guidance_embed"]:
        vec = vec + embed(guidance, "guidance_in")
    txt = lin(cond, "cond_in")
    for i in range(cfg["depth"]):
        B = f"double_blocks.{i}."
        im, tm = mod(vec, B + "img_mod.lin", 6), mod(vec, B + "txt_mod.lin", 6)
        iq, ik, iv = qkv(lin((1 + im[1]) * layer_norm(img) + im[0], B + "img_attn.qkv"),
                         B + "img_attn.norm")
        tq, tk, tv = qkv(lin((1 + tm[1]) * layer_norm(txt) + tm[0], B + "txt_attn.qkv"),
                         B + "txt_attn.norm")
        a = merge(A.attention(torch.cat([tq, iq], 2), torch.cat([tk, ik], 2),
                              torch.cat([tv, iv], 2)))
        ta, ia = a[:, :txt.shape[1]], a[:, txt.shape[1]:]
        img = img + im[2] * lin(ia, B + "img_attn.proj")
        img = img + im[5] * lin(F.gelu(lin((1 + im[4]) * layer_norm(img) + im[3],
                                           B + "img_mlp.0"), approximate="tanh"), B + "img_mlp.2")
        txt = txt + tm[2] * lin(ta, B + "txt_attn.proj")
        txt = txt + tm[5] * lin(F.gelu(lin((1 + tm[4]) * layer_norm(txt) + tm[3],
                                           B + "txt_mlp.0"), approximate="tanh"), B + "txt_mlp.2")
    xs = torch.cat([txt, img], dim=1)
    for i in range(cfg["depth_single_blocks"]):
        B = f"single_blocks.{i}."
        shift, scale, gate = mod(vec, B + "modulation.lin", 3)
        y = lin((1 + scale) * layer_norm(xs) + shift, B + "linear1")
        q, k, v = qkv(y[..., :3 * h], B + "norm")
        a = merge(A.attention(q, k, v))
        xs = xs + gate * lin(torch.cat([a, F.gelu(y[..., 3 * h:], approximate="tanh")], -1),
                             B + "linear2")
    shift, scale = lin(F.silu(vec), "final_layer.adaLN_modulation.1").chunk(2, dim=-1)
    y = (1 + scale[:, None]) * layer_norm(xs[:, txt.shape[1]:]) + shift[:, None]
    return lin(y, "final_layer.linear")


def sample(W, A: Arith, cfg: dict, cond, seed: int, steps: int, guidance_scale: float):
    """The flow-matching Euler loop from σ = 0 to 1 on the latents drawn
    with ``torch.randn`` from a generator seeded with ``seed`` on the
    device (the draw a request's seed stands for)."""
    if not cfg["dit"]["guidance_embed"]:
        raise ValueError("this reference samples a guidance-embedded DiT; CFG is not written")
    vae = cfg["vae"]
    gen = torch.Generator(device=cond.device).manual_seed(seed)
    lat = torch.randn((1, vae["num_latents"], vae["embed_dim"]), generator=gen,
                      device=cond.device, dtype=torch.float32)
    sig = np.concatenate([np.linspace(0.0, 1.0, steps), [1.0]]).astype(np.float32)
    g = torch.full((1,), guidance_scale, device=cond.device)
    for i in range(steps):
        t = torch.full((1,), float(sig[i]), dtype=torch.float32, device=cond.device)
        v = dit(W, A, cfg["dit"], lat, t, cond, g)
        lat = lat + float(sig[i + 1] - sig[i]) * v
    return lat


# -- ShapeVAE trunk and geo decoder (autoencoders) ---------------------------
def vae_kv(W, A: Arith, cfg: dict, latents):
    """latents → the geo decoder's K, V [B, H, L, D] (k normed)."""
    nh, eps = cfg["heads"], cfg["ln_eps"]
    hd = cfg["width"] // nh
    lin = lambda y, n: A.linear(y, W[f"vae.{n}.weight"], W.get(f"vae.{n}.bias"))
    ln = lambda y, n, e=eps: layer_norm(y, W[f"vae.{n}.weight"], W[f"vae.{n}.bias"], e)
    x = lin(latents.float() / cfg["scale_factor"], "post_kl")
    for i in range(cfg["num_decoder_layers"]):
        B = f"transformer.resblocks.{i}."
        y = lin(ln(x, B + "ln_1"), B + "attn.c_qkv")
        b, l, _ = y.shape
        q, k, v = y.reshape(b, l, nh, 3 * hd).chunk(3, dim=-1)
        q, k = ln(q, B + "attn.attention.q_norm"), ln(k, B + "attn.attention.k_norm")
        x = x + lin(merge(A.attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))),
                    B + "attn.c_proj")
        x = x + lin(F.gelu(lin(ln(x, B + "ln_2"), B + "mlp.c_fc")), B + "mlp.c_proj")
    D = "geo_decoder.cross_attn_decoder."
    kv = lin(ln(x, D + "ln_2"), D + "attn.c_kv")
    b, l, _ = kv.shape
    k, v = kv.reshape(b, l, nh, 2 * hd).chunk(2, dim=-1)
    k = ln(k, D + "attn.attention.k_norm")
    return k.transpose(1, 2), v.transpose(1, 2)


def geo_decode(W, A: Arith, cfg: dict, pts, k, v):
    """pts [P, 3] → occupancy logits [P]."""
    nh, eps = cfg["heads"], cfg["ln_eps"]
    lin = lambda y, n: A.linear(y, W[f"vae.geo_decoder.{n}.weight"],
                                W.get(f"vae.geo_decoder.{n}.bias"))
    ln = lambda y, n, e=eps: layer_norm(y, W[f"vae.geo_decoder.{n}.weight"],
                                        W[f"vae.geo_decoder.{n}.bias"], e)
    pts = pts.float()[None]
    freqs = 2.0 ** torch.arange(cfg["num_freqs"], dtype=torch.float32, device=pts.device)
    if cfg["include_pi"]:
        freqs = freqs * math.pi
    e = (pts[..., None] * freqs).reshape(*pts.shape[:-1], -1)
    x = lin(torch.cat([pts, torch.sin(e), torch.cos(e)], -1), "query_proj")
    D = "cross_attn_decoder."
    q = heads(lin(ln(x, D + "ln_1"), D + "attn.c_q"), nh).transpose(1, 2)
    q = ln(q, D + "attn.attention.q_norm").transpose(1, 2)
    x = x + lin(merge(A.attention(q, k, v)), D + "attn.c_proj")
    x = x + lin(F.gelu(lin(ln(x, D + "ln_3"), D + "mlp.c_fc")), D + "mlp.c_proj")
    return lin(ln(x, "ln_post", 1e-6), "output_proj")[0, :, 0]


@torch.no_grad()
def run(config: dict, W: dict, request: dict, kept: dict, precision: str = "fp32"):
    """The reference's outputs for one request: the conditioner tokens, the
    denoised latents and the logits at the points [P, 3] that the capture
    drew (``kept["points"]``; the program's own outputs in ``kept`` are
    not read)."""
    points = kept["points"]
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        A = Arith(precision)
        dev = points.device
        pix = torch.from_numpy(preprocess(request["image"],
                                          image_size=config["dino"]["image_size"])).to(dev)
        cond = dinov2(W, A, config["dino"], pix)
        call = request["call"]
        lat = sample(W, A, config, cond, request["seed"], call["num_inference_steps"],
                     call["guidance_scale"])
        k, v = vae_kv(W, A, config["vae"], lat)
        logits = geo_decode(W, A, config["vae"], points, k, v)
        return {"cond": cond, "latents": lat, "logits": logits}
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def rel_err(a: torch.Tensor, ref: torch.Tensor) -> float:
    """‖a − ref‖ / ‖ref‖ over all elements."""
    a, ref = a.float().flatten(), ref.float().flatten()
    return float(torch.linalg.vector_norm(a - ref) / torch.linalg.vector_norm(ref))


def mesh_faults(meshes, box_v: float) -> int:
    """Faults of a returned mesh that need no reference: no mesh, no face, a
    non-finite vertex, a vertex outside the box, a face index out of range."""
    if not meshes or meshes[0] is None:
        return 1
    v, f = np.asarray(meshes[0].vertices), np.asarray(meshes[0].faces)
    return int((len(f) == 0) + (~np.isfinite(v)).sum() + (np.abs(v) > box_v + 1e-4).sum()
               + ((f < 0) | (f >= len(v))).sum())


def compare(out: dict, ref: dict, request: dict) -> dict:
    """The compared numbers of one request: each output's relative error
    against the reference's, and the returned mesh's faults where ``out``
    holds the call's return value (the control's outputs hold none)."""
    numbers = {"cond_err": rel_err(out["cond"], ref["cond"]),
               "latents_err": rel_err(out["latents"], ref["latents"]),
               "logits_err": rel_err(out["logits"], ref["logits"])}
    if "output" in out:
        numbers["mesh_faults"] = mesh_faults(out["output"], request["call"]["box_v"])
    return numbers

"""Small models on the card against the CPU, with the same weights, inputs
and draws on both devices.

The secondary image pipelines at TINY size: each function builds one
pipeline on the CPU and one on the card holding the CPU's weights, runs
both on the same seeded inputs and draws, and returns both outputs;
:func:`image_agreement` compares them (limits: image corr ≥ 0.99 and mean
|Δ| ≤ 3 levels). Training: :func:`train_step_pair` runs one flow-matching
step of a DiT whose attention passes kernel 1's gate, and
:func:`train_agreement` compares loss, gradients and weights.
The differentiable surface: :func:`diff_surface_pair` decodes a 17³ grid
through a VAE whose decode passes the gate, extracts the surface and
backpropagates a mesh-space loss; :func:`diff_surface_agreement` compares
grid, topology, grid gradient and the geo decoder's gradients. The limits
are held by ``chip_smoke.py`` (which logs the numbers) and by
``tests/test_torch_cuda.py``. Needs a CUDA device:

    python -m pytest -m cuda tests/test_torch_cuda.py -k "delight or upscale or align or agree"
"""

from __future__ import annotations

import numpy as np
import torch

# the head-64 upscaler's kernel-1 launches on the card: 2 steps × (self +
# cross) × 4 transformer layers at its 32² level (down 1, mid 1, up 2)
UPSCALE_FLASH_LAUNCHES = 2 * 2 * 4


def copy_to(card, cpu):
    """``card`` with ``cpu``'s module weights and tensors."""
    for name, value in vars(cpu).items():
        if isinstance(value, torch.nn.Module):
            getattr(card, name).load_state_dict(value.state_dict())
        elif isinstance(value, torch.Tensor):
            setattr(card, name, value.to(card.device))
    return card


def image_agreement(a, b):
    """Two images (PIL / uint8, or floats in [0, 1]) → (corr, mean |Δ| in
    8-bit levels, std of ``a`` in levels)."""
    x, y = (np.asarray(i, np.float64) * (1.0 if np.asarray(i).dtype == np.uint8 else 255.0)
            for i in (a, b))
    return np.corrcoef(x.ravel(), y.ravel())[0, 1], np.abs(x - y).mean(), x.std()


def agrees(a, b) -> bool:
    corr, mad, std = image_agreement(a, b)
    return std > 1.0 and corr >= 0.99 and mad <= 3.0


def delight_images():
    """The TINY delight pipeline (32², 3 steps, triple CFG; head sizes 16
    and 32 take the plain attention) → (card rgb01, CPU rgb01)."""
    from hunyuan3d2_tpu_torch.pipelines.delight import DelightPipeline

    def make(device):
        return DelightPipeline.init_random(resolution=32, num_inference_steps=3, device=device,
                                           seed=1)

    cpu = make("cpu")
    card = copy_to(make("cuda"), cpu)
    rs = np.random.RandomState(0)
    rgb = rs.rand(40, 48, 3).astype(np.float32)
    init = rs.randn(1, 16, 16, 4).astype(np.float32)
    noises = [rs.randn(1, 16, 16, 4).astype(np.float32) for _ in range(3)]
    return tuple(p(rgb, init_latents=init, step_noises=noises) for p in (card, cpu))


def upscale_images():
    """A head-64 TINY upscaler (channels (64, 128), 2 heads; 64² → 256², 2
    steps): its 32² level's self and cross attention (1024 queries) go
    through kernel 1 on the card → (card image, CPU image, the card call's
    ``flash_attention`` launches)."""
    import dataclasses

    from PIL import Image

    from hunyuan3d2_tpu_torch.models import paint_unet, sd_vae
    from hunyuan3d2_tpu_torch.ops.flash_attention import flash_attention
    from hunyuan3d2_tpu_torch.ops.nn import build
    from hunyuan3d2_tpu_torch.pipelines import upscale

    ucfg = dataclasses.replace(upscale.X4_UNET_TINY, block_out_channels=(64, 128))
    rs = np.random.RandomState(1)
    text = rs.randn(77, ucfg.cross_attention_dim).astype(np.float32)

    def make(device):
        return upscale.UpscalePipeline(
            build(paint_unet.plain_unet, ucfg, device=device),
            build(sd_vae.AutoencoderKL, upscale.X4_VAE_TINY, device=device), text,
            num_inference_steps=2, device=device)

    cpu = make("cpu")
    card = copy_to(make("cuda"), cpu)
    img = Image.fromarray(rs.randint(0, 256, (64, 64, 3)).astype(np.uint8))
    lowres = rs.randn(1, 64, 64, 3).astype(np.float32)
    init = rs.randn(1, 64, 64, 4).astype(np.float32)
    before = flash_attention.launches
    a = card(img, lowres_noise=lowres, init_latents=init)
    launches = flash_attention.launches - before
    return a, cpu(img, lowres_noise=lowres, init_latents=init), launches


def align_images(strengths=(1.0, 0.5)):
    """The TINY ControlNet + IP-Adapter pipeline (32², 4 steps; the adapter's
    ``to_k_ip`` / ``to_v_ip`` and the zero convs seeded non-zero, seeded
    image tokens), text-to-image and img2img → [(strength, card image, CPU
    image), ...]."""
    from PIL import Image

    from hunyuan3d2_tpu_torch.pipelines.align import ControlNetSDPipeline

    def make(device):
        pipe = ControlNetSDPipeline.init_random(resolution=32, device=device, seed=2)
        pipe.image_encoder = lambda image: np.random.RandomState(3).randn(1, 8, 48)
        return pipe

    cpu = make("cpu")
    g = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for name, p in (list(cpu.unet.named_parameters())
                        + list(cpu.controlnet.named_parameters())):
            if "_ip." in name or name.startswith(("controlnet_down", "controlnet_mid")):
                p.copy_(torch.randn(p.shape, generator=g) * 0.1)
    card = copy_to(make("cuda"), cpu)
    rs = np.random.RandomState(5)
    depth, ip_img = (Image.fromarray(rs.randint(0, 256, (32, 32, 3)).astype(np.uint8))
                     for _ in range(2))
    init = rs.randn(1, 16, 16, 4).astype(np.float32)
    noises = [rs.randn(1, 16, 16, 4).astype(np.float32) for _ in range(4)]
    return [(s, *(p(control_image=depth, ip_adapter_image=ip_img, init_image=ip_img,
                    strength=s, num_inference_steps=4, init_noise=init, step_noises=noises)
                  for p in (card, cpu)))
            for s in strengths]


# ---------------------------------------------------------------------------
# training and the differentiable surface
# ---------------------------------------------------------------------------
# a DiT whose joint attention (512 latents + 77 cond tokens, 2 heads of 64)
# passes kernel 1's gate: one launch per block in the forward
TRAIN_DIT = dict(in_channels=64, context_in_dim=1536, hidden_size=128, num_heads=2, depth=1,
                 depth_single_blocks=1)
TRAIN_FLASH_LAUNCHES = 2
LR = 1e-4


def _grads_close(ref: dict, out: dict) -> dict:
    """Per tensor, max |out - ref| over ref's largest value and the
    correlation (the DiT parity rule: within 5 % and above 0.999), the
    worst of each; a tensor whose reference gradient is rounding noise
    (below 1e-4 of the largest over all tensors: the softmax cancels a
    k-norm bias) is held to that noise level instead."""
    scale = max(float(r.abs().max()) for r in ref.values())
    frac, corr, noise = 0.0, 1.0, 0.0
    for name, r in ref.items():
        o = out[name]
        if float(r.abs().max()) < 1e-4 * scale:
            noise = max(noise, float(o.abs().max()) / scale)
            continue
        frac = max(frac, float((o - r).abs().max() / r.abs().max()))
        if r.numel() > 1:
            corr = min(corr, float(np.corrcoef(o.numpy().ravel(), r.numpy().ravel())[0, 1]))
    return dict(grad_frac=frac, grad_corr=corr, grad_noise=noise)


def train_step_pair(seed: int = 0) -> dict:
    """One ``make_train_step`` step (AdamW at its defaults) of the
    :data:`TRAIN_DIT` DiT on the CPU and on the card, the same bf16 weights,
    latents [2, 512, 64], cond [2, 77, 1536], x0 and sigma →
    {device: {loss, grads, before, after, launches}} (tensors on the CPU in
    fp32, keyed by parameter name)."""
    from hunyuan3d2_tpu_torch.models import dit
    from hunyuan3d2_tpu_torch.ops.flash_attention import flash_attention
    from hunyuan3d2_tpu_torch.ops.nn import build
    from hunyuan3d2_tpu_torch.training import make_train_step

    cfg = dit.DiTConfig(**TRAIN_DIT)
    cpu = build(dit.Hunyuan3DDiT, cfg, device="cpu",
                generator=torch.Generator().manual_seed(seed))
    card = build(dit.Hunyuan3DDiT, cfg, device="cuda")
    card.load_state_dict(cpu.state_dict())
    rs = np.random.RandomState(seed)
    data = [torch.from_numpy(rs.randn(*s).astype(np.float32))
            for s in ((2, 512, 64), (2, 77, 1536), (2, 512, 64))]
    data.append(torch.from_numpy(rs.rand(2).astype(np.float32)))
    out = {}
    for name, model in (("cpu", cpu), ("card", card)):
        dev = next(model.parameters()).device
        lat, cond, x0, sigma = (t.to(dev) for t in data)
        before = {n: p.detach().float().cpu() for n, p in model.named_parameters()}
        _, step = make_train_step(model)
        launches = flash_attention.launches
        loss = step(lat, cond.bfloat16(), x0=x0, sigma=sigma)
        out[name] = dict(
            loss=float(loss), launches=flash_attention.launches - launches, before=before,
            grads={n: p.grad.float().cpu() for n, p in model.named_parameters()},
            after={n: p.detach().float().cpu() for n, p in model.named_parameters()},
            dtypes={n: p.dtype for n, p in model.named_parameters()})
    return out


def train_agreement(pair: dict) -> dict:
    """:func:`train_step_pair`'s two steps compared: the loss's relative
    difference; the gradients by :func:`_grads_close`; the share of weight
    elements that disagree (a bf16 weight beyond one bf16 ulp of the CPU's,
    an fp32 weight whose update differs by more than lr/4: Adam's first
    step is sign(g)·lr, so an element whose gradient lies within the two
    devices' rounding noise of zero may step the other way, and a bf16
    update near a rounding tie may round the other way) and the largest
    excess over one ulp, in units of lr."""
    cpu, card = pair["cpu"], pair["card"]
    stats = dict(loss_cpu=cpu["loss"], loss_card=card["loss"],
                 loss_rel=abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"]),
                 launches_card=card["launches"], launches_cpu=cpu["launches"],
                 **_grads_close(cpu["grads"], card["grads"]))
    total = bad = 0
    excess = 0.0
    for name, ref in cpu["after"].items():
        out = card["after"][name]
        if pair["cpu"]["dtypes"][name] == torch.bfloat16:
            ulp = 2.0 ** (torch.floor(torch.log2(ref.abs().clamp_min(1e-30))) - 7)
            wrong = (out - ref).abs() > ulp
        else:
            ulp = torch.zeros_like(ref)
            wrong = ((out - card["before"][name]) - (ref - cpu["before"][name])).abs() > LR / 4
        total += ref.numel()
        bad += int(wrong.sum())
        excess = max(excess, float(((out - ref).abs() - ulp).max()) / LR)
    stats.update(weights_disagree_share=bad / total, weights_excess_lr=excess)
    return stats


def train_agrees(s: dict) -> bool:
    """Limits: loss within 1e-2 relative (the card's GEMMs round their bf16
    outputs where the CPU's round fp32 sums), gradients within 5 % and
    correlated above 0.999, noise gradients below 1e-3 of the scale, at
    most 2 % of the weight elements disagreeing and none by more than one
    ulp plus 4·lr, and kernel 1 launched once a block on the card only."""
    return (s["loss_rel"] <= 1e-2 and s["grad_frac"] <= 0.05 and s["grad_corr"] >= 0.999
            and s["grad_noise"] <= 1e-3 and s["weights_disagree_share"] <= 0.02
            and s["weights_excess_lr"] <= 4.0 and s["launches_card"] == TRAIN_FLASH_LAUNCHES
            and s["launches_cpu"] == 0)


# a VAE whose dense decode of a 17³ grid (4913 queries, 2 heads of 64)
# passes kernel 1's gate: one launch per decode
DIFF_VAE = dict(num_latents=64, width=128, heads=2, num_decoder_layers=2)
DIFF_RES = 17
DIFF_CAP = (DIFF_RES - 1) ** 3      # every cell: the buffers never overflow


def diff_surface_pair(seed: int = 0) -> dict:
    """The mesh-space loss of tests/test_diff_surface.py (the surface pulled
    toward z = 0.2) through the :data:`DIFF_VAE` VAE's decode (decode_latents
    → compute_kv → decode_queries over a 17³ grid) and
    differentiable_surface_nets, backpropagated into the geo decoder, on
    the CPU and on the card with the same weights and latents →
    {device: {loss, grid, grid_grad, n_verts, n_quads, grads, launches}}."""
    from hunyuan3d2_tpu_torch.models import shapevae
    from hunyuan3d2_tpu_torch.ops.flash_attention import flash_attention
    from hunyuan3d2_tpu_torch.volume.decoders import grid_coords_from_flat
    from hunyuan3d2_tpu_torch.volume.diff_surface import differentiable_surface_nets

    cfg = shapevae.ShapeVAEConfig(**DIFF_VAE)
    cpu = shapevae.ShapeVAE.init_random(cfg, device="cpu",
                                        generator=torch.Generator().manual_seed(seed))
    card = shapevae.ShapeVAE.init_random(cfg, device="cuda")
    card.load_state_dict(cpu.state_dict())
    lat = torch.from_numpy(
        (np.random.RandomState(seed).randn(1, cfg.num_latents, cfg.embed_dim) * 0.5)
        .astype(np.float32))
    out = {}
    for name, vae in (("cpu", cpu), ("card", card)):
        dev = vae.device
        vae.geo_decoder.requires_grad_(True)
        launches = flash_attention.launches
        with torch.no_grad():
            hidden = vae.decode_latents(lat.to(dev))
        k, v = vae.compute_kv(hidden)
        pts = grid_coords_from_flat(torch.arange(DIFF_RES ** 3, device=dev), DIFF_RES, 1.01)
        grid = vae.decode_queries(pts[None], k, v).reshape(DIFF_RES, DIFF_RES, DIFF_RES)
        grid.retain_grad()
        verts, _, nq, count = differentiable_surface_nets(grid, capacity=DIFF_CAP,
                                                          face_capacity=3 * DIFF_CAP)
        mask = torch.arange(verts.shape[0], device=dev) < count
        loss = (((verts[:, 2] - 0.2) ** 2) * mask).sum()
        loss.backward()
        out[name] = dict(
            loss=float(loss.detach()), n_verts=int(count), n_quads=int(nq),
            launches=flash_attention.launches - launches, grid=grid.detach().cpu(),
            grid_grad=grid.grad.cpu(),
            grads={n: p.grad.float().cpu() for n, p in vae.geo_decoder.named_parameters()})
    return out


def diff_surface_agreement(pair: dict) -> dict:
    """:func:`diff_surface_pair`'s two runs compared: the grids (max |Δ| over
    the largest value), the topology (vertex and quad counts), the loss,
    the grid gradient (max |Δ| over its largest value) and the geo
    decoder's gradients (:func:`_grads_close`)."""
    cpu, card = pair["cpu"], pair["card"]
    g = cpu["grid_grad"]
    return dict(
        grid_rel=float((card["grid"] - cpu["grid"]).abs().max() / cpu["grid"].abs().max()),
        counts_cpu=(cpu["n_verts"], cpu["n_quads"]), counts_card=(card["n_verts"],
                                                                  card["n_quads"]),
        loss_cpu=cpu["loss"], loss_card=card["loss"],
        loss_rel=abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"]),
        grid_grad_rel=float((card["grid_grad"] - g).abs().max() / g.abs().max()),
        launches_card=card["launches"], launches_cpu=cpu["launches"],
        **_grads_close(cpu["grads"], card["grads"]))


def diff_surface_agrees(s: dict) -> bool:
    """Limits: grids within 1e-4 of the largest value (fp32 on both, kernel
    1's 3xTF32 products on the card), the same topology, the loss within
    1e-3, the grid gradient within 2e-3 of its largest value (both pass the
    cotangent through the f16 corner gather: 2^-11 relative), the geo
    decoder's gradients within 5 % and correlated above 0.999, and kernel 1
    launched once, on the card only."""
    return (s["grid_rel"] <= 1e-4 and s["counts_cpu"] == s["counts_card"]
            and s["counts_cpu"][0] > 0 and s["loss_rel"] <= 1e-3 and s["grid_grad_rel"] <= 2e-3
            and s["grad_frac"] <= 0.05 and s["grad_corr"] >= 0.999 and s["grad_noise"] <= 1e-3
            and s["launches_card"] == 1 and s["launches_cpu"] == 0)

"""The paint stage's frozen yardstick arithmetic: the matmul and conv FLOPs
of the 2.5D UNet's passes and of the SD VAE, from the configuration's
``unet`` and ``vae`` groups (``configs/paint_turbo.json``).

Copied from the port's ``models/paint_unet.py`` ``flops`` / ``apply_flops``
and ``models/sd_vae.py`` ``flops`` (themselves held to the JAX package's
floats and ``torch.utils.flop_counter``), so that a later change to the
program cannot move the yardstick; ``benchmark/tests`` holds them equal to
the port's at the configuration's sizes. Norms and elementwise work are
not counted; attention is counted dense (4·T·S·d), the masked multiview
attention's skipped pairs too.
"""

from __future__ import annotations

TEXT_TOKENS = 77


def _is_cross(cfg: dict, i: int, down: bool) -> bool:
    n = len(cfg["block_out_channels"])
    if cfg.get("down_cross") is not None:
        return cfg["down_cross"][i if down else n - 1 - i]
    return (i < n - 1) if down else (i > 0)


def dual(cfg: dict) -> dict:
    """The dual (reference) copy of the UNet: a 4-channel conv_in and none
    of the 2.5D attentions or the camera embedding."""
    return dict(cfg, in_channels=4, use_multiview_attention=False,
                use_reference_attention=False, use_camera_embedding=False,
                use_dual_stream=False)


def unet_flops(cfg: dict, h: int, w: int, num_views: int = 6, num_ref: int = 1,
               batch: int = 1, mode: str = "r") -> float:
    """One UNet pass over ``batch · num_views`` samples at latent (h, w):
    2·k²·c_in·c_out a pixel per conv, 2·c_in·c_out a row per linear,
    4·T·S·d per attention; the reference and multiview attentions in 'r'
    mode only."""
    bn = batch * num_views
    chs = cfg["block_out_channels"]
    ted = chs[0] * 4

    def conv(cin, cout, k, pix):
        return 2.0 * k * k * cin * cout * pix * bn

    def lin(cin, cout, tokens_total):
        return 2.0 * cin * cout * tokens_total

    def res(cin, cout, pix):
        r = conv(cin, cout, 3, pix) + conv(cout, cout, 3, pix) + lin(ted, cout, bn)
        if cin != cout:
            r += conv(cin, cout, 1, pix)
        return r

    def t2d(ch, hh, ww):
        t = hh * ww
        tt = t * bn
        x = 2 * lin(ch, ch, tt)                                   # proj_in, proj_out
        x += 4 * lin(ch, ch, tt) + 4.0 * t * t * ch * bn          # attn1
        x += 2 * lin(ch, ch, tt)                                  # attn2 q, out
        x += 2 * lin(cfg["cross_attention_dim"], ch, TEXT_TOKENS * bn)
        x += 4.0 * t * TEXT_TOKENS * ch * bn
        if mode == "r" and cfg["use_reference_attention"]:
            s = num_ref * t
            x += 2 * lin(ch, ch, tt) + 2 * lin(ch, ch, s * bn)
            x += 4.0 * t * s * ch * bn
        if mode == "r" and cfg["use_multiview_attention"] and num_views > 1:
            seq = num_views * t
            x += 4 * lin(ch, ch, seq * batch) + 4.0 * seq * seq * ch * batch
        x += lin(ch, 8 * ch, tt) + lin(4 * ch, ch, tt)            # GEGLU feed-forward
        return x

    n = len(chs)
    hh, ww = h, w
    f = conv(cfg["in_channels"], chs[0], 3, hh * ww)
    f += lin(chs[0], ted, bn) + lin(ted, ted, bn)                 # time MLP
    c_in = chs[0]
    for i, c_out in enumerate(chs):
        for j in range(cfg["layers_per_block"]):
            f += res(c_in if j == 0 else c_out, c_out, hh * ww)
            if _is_cross(cfg, i, down=True):
                f += t2d(c_out, hh, ww)
        if i < n - 1:
            hh, ww = hh // 2, ww // 2
            f += conv(c_out, c_out, 3, hh * ww)                   # stride-2 downsample
        c_in = c_out
    f += 2 * res(chs[-1], chs[-1], hh * ww) + t2d(chs[-1], hh, ww)
    rev = list(reversed(chs))
    for i, c_out in enumerate(rev):
        prev = rev[max(i - 1, 0)]
        skip_src = rev[min(i + 1, n - 1)]
        for j in range(cfg["layers_per_block"] + 1):
            res_skip = prev if j == 0 else c_out
            skip_ch = c_out if j < cfg["layers_per_block"] else skip_src
            f += res(res_skip + skip_ch, c_out, hh * ww)
            if _is_cross(cfg, i, down=False):
                f += t2d(c_out, hh, ww)
        if i < n - 1:
            hh, ww = hh * 2, ww * 2
            f += conv(c_out, c_out, 3, hh * ww)                   # post-upsample conv
    f += conv(chs[0], cfg["out_channels"], 3, hh * ww)
    return f


def cache_flops(cfg: dict, h: int, w: int, num_ref: int = 1, batch: int = 1) -> float:
    """The 'w' pass that fills the reference cache once a call: the dual
    copy's pass over the reference latents (the main UNet's, single-stream)."""
    if not cfg["use_reference_attention"]:
        return 0.0
    core = dual(cfg) if cfg["use_dual_stream"] else cfg
    return unet_flops(core, h, w, num_ref, num_ref, batch, mode="w")


def vae_flops(cfg: dict, h: int, w: int, batch: int = 1, direction: str = "encode") -> float:
    """One SD-VAE encode (h, w the image size) or decode (h, w the latent
    size) of ``batch`` images: 2·k²·c_in·c_out a pixel per conv, 4·T²·c for
    the single-head mid attention."""
    chs = cfg["block_out_channels"]
    n = len(chs)
    lc = cfg["latent_channels"]

    def conv(cin, cout, k, pix):
        return 2.0 * k * k * cin * cout * pix * batch

    def res(cin, cout, pix):
        r = conv(cin, cout, 3, pix) + conv(cout, cout, 3, pix)
        if cin != cout:
            r += conv(cin, cout, 1, pix)
        return r

    def attn(c, pix):
        return 4 * conv(c, c, 1, pix) + 4.0 * pix * pix * c * batch

    pix = h * w
    if direction == "encode":
        f = conv(cfg["in_channels"], chs[0], 3, pix)
        c_in = chs[0]
        for i, c_out in enumerate(chs):
            for j in range(cfg["layers_per_block"]):
                f += res(c_in if j == 0 else c_out, c_out, pix)
            if i < n - 1:
                pix //= 4
                f += conv(c_out, c_out, 3, pix)
            c_in = c_out
        f += 2 * res(c_in, c_in, pix) + attn(c_in, pix)
        f += conv(c_in, 2 * lc, 3, pix) + conv(2 * lc, 2 * lc, 1, pix)
        return f
    f = conv(lc, lc, 1, pix) + conv(lc, chs[-1], 3, pix)
    f += 2 * res(chs[-1], chs[-1], pix) + attn(chs[-1], pix)
    c_in = chs[-1]
    for i, c_out in enumerate(reversed(chs)):
        for j in range(cfg["layers_per_block"] + 1):
            f += res(c_in if j == 0 else c_out, c_out, pix)
        if i < n - 1:
            pix *= 4
            f += conv(c_out, c_out, 3, pix)
        c_in = c_out
    return f + conv(c_in, cfg["in_channels"], 3, pix)


def diffusion_flops(config: dict, counts: dict) -> float:
    """The "Multiview Diffusion" stage's work from the shapes a window's
    calls took (``systems/paint.py`` ``instrument``): every 'r' pass
    ([B, views, h, w]), every 'w' pass ([B, references, h, w]), every VAE
    encode ([B, H, W]) and decode ([B, h, w])."""
    ucfg, vcfg = config["unet"], config["vae"]
    n_ref = counts["unet_w"][0][1] if counts["unet_w"] else 1
    return (sum(unet_flops(ucfg, h, w, n, n_ref, b, "r") for b, n, h, w in counts["unet_r"])
            + sum(cache_flops(ucfg, h, w, n, b) for b, n, h, w in counts["unet_w"])
            + sum(vae_flops(vcfg, h, w, b, "encode") for b, h, w in counts["vae_encode"])
            + sum(vae_flops(vcfg, h, w, b, "decode") for b, h, w in counts["vae_decode"]))

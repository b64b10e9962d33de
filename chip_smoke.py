#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (hunyuan3d2_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. the card's name and power limit (nvidia-smi);
  2. the build of every kernel from csrc/ (one nvcc per source, in parallel;
     csrc/flash_attention_bwd.cu is kernel 1's backward), with ptxas's
     registers for each instance of the backward and of the fp32 forward,
     unmasked (kernel 1) and masked (kernel 2), and the wgmma / mma.sync
     instructions of their SASS (cuobjdump); one that spills or whose wgmma
     ptxas serialises (C7514), or an fp32 one with no HGMMA or any HMMA,
     fails it;
  3. each kernel against its plain PyTorch twin at the shapes of the three
     paths, with its time, the plain time, the time of one library call
     where one computes the same function, and its bound on the card: flash
     attention (DINOv2, DiT, VAE, the paint UNet's shapes with and without
     CFG's batch 2, the v2-0 Fast DiT and the streamed geo decode's
     attention; each row's inputs from a generator seeded by its name; the
     fp32 rows also against an fp64 evaluation, within the bound of the
     kernel's arithmetic; bound against 3xTF32 on the TF32 tensor cores,
     the CUDA cores' fp32 rate beside it), the fused geo decoder
     (kernel 3's chain) and the streamed decode's MLP tail (kernel 4's
     chain) on x2 from the v2-0 VAE, each kernel of their chain (LN rows,
     the GEMM's epilogues, ln_post) at the coarse pass and a fine chunk of
     both decodes with a breakdown of the chain's time (then the whole
     streamed decode against the plain decode), the masked flash
     attention under voxel masks built from the test sphere's cond maps
     (with the share of key tiles it skips) in bf16 and in fp32 (held to an
     fp64 evaluation under the mask; SDPA with the bool mask beside it),
     and the rasterizer (the whole
     call, its face setup in the kernel, its records held to face_setup's
     bit for bit) on that sphere (a 512² view and the 2048² UV raster), on
     screen-sized faces and on ties, degenerate, NaN, w = 0 and off-screen
     faces;
  3b. the flash kernel's tile-configuration sweep (kernel 6, the port of
     scripts/profile_flash_variants.py) at the paint multiview shape
     (1, 5, 24576, 64) bf16, each variant held against the plain twin;
  4. slice 1 at full width: image → mesh with DINOv2-giant, the mini DiT
     (5 steps, CFG 5.0) and the mini ShapeVAE (FlashVDM decode at octree 256,
     capped surface buffers), random weights from a seed, run cold and warm;
     the kernels' launch counts are read from the warm run, and the GLB is
     written under tmp/; then the decode against the plain decode on a small
     grid; then one warm run each of the 'mc' and 'mt' extractors at octree
     256 and of the vanilla and hierarchical decoders (the dense fp32
     decode, its attention through kernel 1, whose launches in the decode
     are counted; dense or host marching cubes) at octree 64, the 'mc' GLB
     written under tmp/; then the stack is freed;
  5. slice 3 at full width: image → mesh on the v2-0 stack (DINOv2-giant,
     the FULL DiT with the guidance embedding, 5 steps at guidance 5.0, the
     3072-latent FULL ShapeVAE through the streamed decode at octree 380 and
     num_chunks 200,000), run cold and warm, the GLB written and read back;
     its decode against the plain decode on a small grid; then one warm run
     of the multiview variant (3 views through DinoImageEncoderMV and
     MVImageProcessorV2 on the same stack); then the stack is freed;
  6. slice 2 at full width: mesh + image → textured GLB through the paint
     stack (2.5D UNet DEFAULT with its dual copy, SD VAE DEFAULT, 6 views at
     512², render 2048, texture 2048, bake exponent 4), random weights from
     a seed, on a ~40k-face sphere from the port's surface nets: first with
     the paint-turbo sampler (LCM 10 steps), then on the same stack with the
     standard one (EulerAncestral 30 steps, CFG 2.0: the path
     textured_glb_standard), each run cold and warm; stage times (the UV
     unwrap's as "UV Unwrap (overlaps denoise)", the host worker process's
     own time, and "UV Unwrap (wait)", the call's wait for it), launch
     counts and peak memory; every textured call must have run its unwrap
     in the host worker (its pid is not this process's); each textured GLB
     is written under tmp/ and read back; after each sampler's runs, one
     call on given init_latents / step_noises must equal the public stages
     run by hand in the serial order (cond maps → multiview net →
     mesh_uv_wrap → upload → bake → inpaint) bit for bit (texture, UVs,
     faces, vertices); then (path textured_glb_fp32) the same DEFAULT stack written
     as a paint-turbo checkpoint under tmp/ and loaded back by
     load_paint_pipeline(dtype="fp32"): one turbo GLB, cold and warm, in
     which every attention launch is fp32 and the masked fp32 kernel runs
     100 times a run;
  7. slice 2 at a small size on the card against the same stack on the CPU
     (plain twins), with the same weights and noise, through each sampler,
     at a head size and sequence lengths that send the UNet through flash
     attention (both samplers) and the masked kernel (turbo, in bf16 and
     with the stack in fp32); then the plain-MLP DINOv2 at DINOv2-L's widths
     (24 layers, 1024 wide, 518²) through the conditioner on the card (24
     kernel-1 launches) against the CPU;
  8. the served path at full width: checkpoints written from random weights
     (rounded to fp16) in the published layouts under tmp/ (the mini shape
     stack with DINOv2-giant as config.yaml + model.fp16.safetensors, the
     paint-turbo stack as unet/ and vae/ with config.json), loaded back with
     from_pretrained (every tensor bit for bit, one image → mesh call equal
     to the in-memory pipeline's), then the port's API server, in-process on
     a localhost port, answers /generate (octree 256, the app's 'mc'),
     /generate with texture (postprocess, then paint-turbo at 6 × 512²
     views, render and texture 2048), /send + /status and /generate with
     text (the tiny random-weight t2i pipeline the app builds, then the
     mini stack); each GLB is read back; the shape stack is offloaded to the
     host between the first two requests and the drop in device memory
     checked; the checkpoints are deleted at the end;
  9. text → image → mesh at full width (path text_to_mesh): the front end
     utils/text2image.HunyuanDiTPipeline over HunyuanDiT v1.1 (1408 wide,
     16 heads of 88, 40 blocks, PAG on 16-19; random weights, pseudo text
     embeddings), the t2i SD VAE, 1024², 25 DDPM steps at CFG 5.0 and PAG
     1.3, then rembg and the mini shape stack at octree 256, cold and warm,
     stage times, peak memory, the warm run's launches (kernels 1 and 3),
     the GLB written and read back; one timing of its head-88 self-attention
     [2,16,4096,88] through the port's sdpa beside
     F.scaled_dot_product_attention; then the TINY t2i pipeline at 64² on
     the card against the same pipeline on the CPU;
 10. the secondary image pipelines at full width, each cold and warm with
     stage times, peak memory and the warm run's launches: delight
     (Light_Shadow_Remover over the InstructPix2Pix UNet, 512², 50 steps;
     path delight), x4 upscale (Image_Super_Net over the x4 UNet, 128² →
     512², 5 DDIM steps at CFG 9.0; path upscale, where kernel 1 takes the
     64² and 32² levels' attention: 100 launches a call), and align
     (Img2img_Control_Ip_adapter, 20 steps at CFG 8.0 with the SD1.5
     ControlNet and the IP-Adapter-plus resampler, then HesModel img2img at
     strength 0.8 over 40 steps; path align); one timing of the delight
     UNet's head-40 self-attention [3,8,4096,40] through the port's sdpa
     beside F.scaled_dot_product_attention; then the three TINY pipelines
     on the card against the CPU (the upscaler at head size 64, so that
     kernel 1 runs in it);
 12. the gradients and the training path:
     12a. kernel 1's gradient (the kernel's lse-keeping forward and the
          backward kernel, csrc/flash_attention_bwd.cu) at the DiT training
          shape [2,16,1882,64] bf16, the VAE's [1,16,512,64] fp32, a
          differentiable-surface decode chunk [1,16,65536,64] fp32 over 512
          keys and [1,8,4096,128] bf16 (off path): one forward and one
          backward launch a call and no plain twin in that window; dq, dk
          and dv against the plain twin's autograd (bf16) and an fp64
          evaluation (within 8x max abs and 4x RMS of the plain autograd's
          own error); the kernel against flash_attention_backward_plain on
          the same o and lse, two calls bit for bit; forward + backward time
          and the backward's alone beside the plain twin's and
          F.scaled_dot_product_attention's (fp32 rows bound against 3xTF32
          on the TF32 tensor cores, the CUDA cores' rate beside it); each
          pass's device time (pre-pass, dK/dV, dQ; torch.profiler) and its
          TFLOP/s (the bf16 tile sweep is
          tools/profile_flash_bwd_variants.py);
     12b. training at full width (path train): the mini DiT (8 + 16 blocks,
          1024 wide, 16 heads of 64) with random bf16 weights, latents
          [2,512,64], cond [2,1370,1536], AdamW, 10 steps; at step 5 the
          weights and the optimizer state go through save_pytree, are
          loaded into a fresh model and optimizer, and its last 5 steps
          must give the unbroken run's weights (1e-5); finite losses, 24
          kernel-1 forward and 24 backward launches a step, ms a step and
          peak memory; the resumed run's last step under
          utils.profiling.trace (the top device operations, the device's
          busy share, device_memory_stats);
     12c. one training step of a small DiT that passes kernel 1's gate on
          the card against the CPU (tools/card_agreement.py);
     12d. the differentiable surface at full width (path diff_surface):
          the mini ShapeVAE's decode of a 64³ grid in chunks of 65,536
          queries through kernel 1, differentiable_surface_nets, a
          mesh-space loss and its gradient into the geo decoder's weights
          (one backward launch a chunk);
          then a 17³ grid on the card against the CPU;
 14. parallelism (hunyuan3d2_tpu_torch/parallel):
     14a. on a one-rank NCCL process group, the mini stack of phase 4 and
          the paint-turbo stack of phase 6 through their entry points, each
          unsharded, then after shard(make_mesh(1)): the latents and the
          texture equal the unsharded runs' bit for bit, and kernels 1 and
          3 (mini) and 1, 2 and 5 (turbo) launch as often as in phases 4
          and 6 (paths parallel_image_to_mesh, parallel_textured_glb);
     14b. two gloo ranks sharing the card (parallel.mesh.spawn; NCCL
          refuses two ranks on one device), through
          hunyuan3d2_tpu_torch/tools/parallel_check.py: the mini DiT at full
          width on x [2,512,64], cond [2,1370,1536] bf16 at tp = 2, dp = 2
          and pp = 2 (n_micro 2), each against the single-process forward
          (the DiT parity rule: 5 % of the largest output, corr 0.999) with
          24 kernel-1 launches a rank ([2,8,1882,64] at tp = 2), one tp = 2
          train step against the single-process step (loss 2e-3), and the
          mini shape stack's latents after shard(make_mesh(2)) (5e-2); each
          run's collective stats, held to assert_no_full_param_gather; the
          times are two ranks on one card, not a scaling figure;
 15. a JSON line with every kernel's numbers, then the result line.
Without a CUDA device it exits 1 and prints no result.
"""

import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
# dense tensor-core bf16; fp32 on the CUDA cores (no tensor cores); the fp32
# kernels' own floor, 3xTF32 on the TF32 tensor cores (495 TFLOP/s, three
# products a pair)
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12, "tf32x3": 495e12 / 3}
VIEWS = [(0, 0), (0, 90), (0, 180), (0, 270), (90, 0), (-90, 180)]   # (elev, azim)


# the kernels of the geo decoder's chain (csrc/geo_decode.cu), and the
# launches of each per decode call (kernel 3's or kernel 4's chain)
CHAIN_KERNELS = ("ln_rows", "gemm_residual", "gemm_head_ln", "gemm_gelu", "ln_dot_rows")
CHAIN_PER_CALL = {"ln_rows": 2, "gemm_residual": 3, "gemm_head_ln": 1, "gemm_gelu": 1,
                  "ln_dot_rows": 1}


def log(msg):
    print(msg, flush=True)


def check(ok, msg):
    if not ok:
        raise RuntimeError(msg)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters):
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms_by_kernel(fn, iters):
    """Device time per call of each kernel (and memset) that ``fn`` runs,
    from a torch.profiler trace of ``iters`` calls; {} when the trace holds
    no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
        if us > 0:
            short = e.key.replace("(anonymous namespace)::", "").split("(")[0].split("<")[0]
            name = short.split("::")[-1].split()[-1] if short.strip() else e.key
            out[name] = out.get(name, 0.0) + us / iters / 1e3
    return out


def attention_check(name, out, ref, tol):
    """An attention kernel's output against its plain twin's. bf16 rows are
    held to two bf16 ulps at the largest output value (2^-6 of it), and to at
    most ``tol``: the output's scale falls as 1/sqrt(Lk) under random
    inputs, so a fixed absolute tolerance would pass a dropped key tile at
    long Lk. The relative RMS error must stay within 1e-2, which dropping one
    64-key tile exceeds (by about sqrt(64/Lk): 5 % at Lk = 24576).
    Returns (max abs err, max rel err, relative RMS err, the tolerance)."""
    import torch

    check(torch.isfinite(out).all().item(), f"{name}: non-finite output")
    diff = out.float() - ref.float()
    ref_max = ref.float().abs().max().item()
    if out.dtype == torch.bfloat16:
        tol = min(tol, 2.0 ** -6 * ref_max)
    err = diff.abs().max().item()
    rms = (diff.norm() / ref.float().norm()).item()
    check(err <= tol and rms <= 1e-2,
          f"{name}: max abs err {err} (tol {tol}), relative RMS err {rms} (tol 1e-2)")
    return err, err / ref_max, rms, tol


def bound(flops, nbytes, kind):
    t_ops = flops / PEAK_FLOPS[kind] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def row_bounds(flops, nbytes, dtype):
    """A row's bound keys: bf16 against the bf16 tensor cores; fp32 against
    its kernels' own floor, 3xTF32 on the TF32 tensor cores (``bound_ms``),
    with the CUDA cores' fp32 rate under ``bound_cuda_core_ms``."""
    import torch

    if dtype == torch.bfloat16:
        ms, by = bound(flops, nbytes, "bf16")
        return dict(bound_ms=ms, bound_by=by)
    ms, by = bound(flops, nbytes, "tf32x3")
    return dict(bound_ms=ms, bound_by=by, bound_cuda_core_ms=bound(flops, nbytes, "fp32")[0])


def fp32_check(name, q, k, v, out, plain, mask=None):
    """An fp32 row against an fp64 evaluation of the kernel's function
    (under ``mask`` for the masked kernel: a fully masked row must be 0):
    every element within the bound that the kernel's arithmetic allows
    (hunyuan3d2_tpu_torch/tools/flash_fp32_error.py: 3xTF32 products, each
    64-key tile summed apart, fp32 softmax); a max abs error within 8x the
    plain twin's (fp32 GEMMs) on the same inputs, so that an error confined
    to a few elements fails too (0.37-3.3x measured over 7 shapes x 8 seeds,
    4.1x once at [1,4,1000,333,128]; a tensor-core sum carried across all
    key tiles gave 9.5-14x at 3072 keys); and a relative RMS error within 4x
    the twin's (0.5-2.2x measured; the carried sum gave 8x at 512 keys and
    21x at 3072).
    Returns (max abs err, its largest share of the bound, the largest bound,
    the twin's max abs err, the two relative RMS errors)."""
    import torch

    from hunyuan3d2_tpu_torch.tools.flash_fp32_error import check_against_fp64, fp32_error_bound

    check(torch.isfinite(out).all().item(), f"{name}: non-finite output")
    ref, bound = fp32_error_bound(q, k, v, mask=mask)
    c, t = check_against_fp64(out, ref, bound), check_against_fp64(plain, ref, bound)
    rms, twin_rms = ((x.double() - ref).norm().item() / ref.norm().item() for x in (out, plain))
    check(c["within"] and c["max_abs_err"] <= 8 * t["max_abs_err"] and rms <= 4 * twin_rms,
          f"{name}: max abs err {c['max_abs_err']} against fp64 (twin {t['max_abs_err']}, "
          f"limit 8x), {c['max_share_of_bound']} of its bound; relative RMS err {rms} "
          f"(twin {twin_rms}, limit 4x)")
    return c["max_abs_err"], c["max_share_of_bound"], c["max_bound"], t["max_abs_err"], rms, \
        twin_rms


def flash_phase():
    import zlib

    import torch
    import torch.nn.functional as F

    from hunyuan3d2_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain

    rows = []
    # (name, (B, H, Lq, Lk, D), dtype, ceiling on max |kernel - plain|, see
    # attention_check): bf16 output is rounded once and P is rounded before
    # P.V in both, at other block boundaries. fp32 rows (3xTF32 products)
    # are held to an fp64 evaluation (fp32_check). Each row draws its inputs
    # from a generator seeded by its name. The "d128" rows are off the
    # product paths: the second head size the kernel takes. The paint rows
    # are the UNet's multiview attention at 64² latents (6 views), its
    # reference attention and its cross-attention (77 keys);
    # the "paint cfg" rows the standard loop's CFG batch 2 (multiview at the
    # 64² and 32² levels, self and reference attention at 64²);
    # "dit full fast" is the v2-0 Fast DiT (3072 latents + 1370 cond tokens,
    # batch 1), "vae full" the v2-0 VAE's self-attention, "geo stream" one
    # fine chunk of the streamed decode at octree 380 (390 blocks of 8³
    # queries) over the 3072 latents; "clip" the Dual conditioner's CLIP
    # ViT-L/14 tower at 224² (257 tokens); the "upscale" rows the x4
    # upscaler's UNet at CFG batch 2 on a 128² image: self-attention and
    # cross-attention (77 keys) at its 64² and 32² levels.
    for name, (b, h, lq, lk, d), dt, tol in (
            ("dinov2", (1, 24, 1370, 1370, 64), torch.bfloat16, 2e-2),
            ("clip", (1, 16, 257, 257, 64), torch.bfloat16, 2e-2),
            ("dit", (2, 16, 1882, 1882, 64), torch.bfloat16, 2e-2),
            ("vae", (1, 16, 512, 512, 64), torch.float32, None),
            ("paint multiview", (1, 5, 24576, 24576, 64), torch.bfloat16, 2e-2),
            ("paint reference", (6, 5, 4096, 4096, 64), torch.bfloat16, 2e-2),
            ("paint cross", (6, 5, 4096, 77, 64), torch.bfloat16, 2e-2),
            ("dit full fast", (1, 16, 4442, 4442, 64), torch.bfloat16, 2e-2),
            ("vae full", (1, 16, 3072, 3072, 64), torch.float32, None),
            ("geo stream", (1, 16, 199680, 3072, 64), torch.bfloat16, 2e-2),
            ("d128", (1, 8, 4096, 4096, 128), torch.bfloat16, 2e-2),
            ("d128 fp32", (1, 8, 1024, 1024, 128), torch.float32, None),
            ("paint cfg multiview", (2, 5, 24576, 24576, 64), torch.bfloat16, 2e-2),
            ("paint cfg multiview 32", (2, 10, 6144, 6144, 64), torch.bfloat16, 2e-2),
            ("paint cfg reference", (12, 5, 4096, 4096, 64), torch.bfloat16, 2e-2),
            ("upscale self 64", (2, 8, 4096, 4096, 64), torch.bfloat16, 2e-2),
            ("upscale cross 64", (2, 8, 4096, 77, 64), torch.bfloat16, 2e-2),
            ("upscale self 32", (2, 8, 1024, 1024, 64), torch.bfloat16, 2e-2),
            ("upscale cross 32", (2, 8, 1024, 77, 64), torch.bfloat16, 2e-2)):
        gen = torch.Generator(device="cuda").manual_seed(zlib.crc32(name.encode()))
        q = torch.randn(b, h, lq, d, generator=gen, device="cuda").to(dt)
        k, v = (torch.randn(b, h, lk, d, generator=gen, device="cuda").to(dt) for _ in range(2))

        def plain():  # row chunks of 4096 queries keep the fp32 scores in memory
            return torch.cat([flash_attention_plain(q[:, :, i:i + 4096], k, v)
                              for i in range(0, lq, 4096)], dim=2)

        out = flash_attention(q, k, v)
        ref = plain()
        torch.cuda.synchronize()
        extra = {}
        if dt == torch.float32:
            err, share, tol, twin_err, rms, twin_rms = fp32_check(
                f"flash_attention {name}", q, k, v, out, ref)
            rel = err / ref.abs().max().item()
            extra = dict(against="fp64", share_of_bound=share, twin_max_abs_err=twin_err,
                         twin_rel_rms_err=twin_rms)
        else:
            err, rel, rms, tol = attention_check(f"flash_attention {name}", out, ref, tol)
        scale = d ** -0.5
        ms = time_ms(lambda: flash_attention(q, k, v), 20)
        plain_ms = time_ms(plain, 3)
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=scale), 20)
        flops = 4.0 * b * h * lq * lk * d
        nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
        row = dict(shape=f"{name} q {[b, h, lq, d]} k {[b, h, lk, d]} {str(dt).split('.')[-1]}",
                   max_abs_err=err, max_rel_err=rel, rel_rms_err=rms, tol=tol, **extra, ms=ms,
                   plain_ms=plain_ms, library_ms=lib_ms, **row_bounds(flops, nbytes, dt))
        log("flash_attention " + json.dumps(row))
        rows.append(row)
        del q, k, v, out, ref
    return rows


def geo_phase(gen):
    """Kernel 3 (the chain of the fused decoder) on the mini VAE at the
    coarse pass (34³ corners) and one fine chunk (128 blocks of 8³) of
    octree 256, against its plain twin geo_decode_plain (the Pallas
    kernel's function, fp32 residual); then each kernel of its chain."""
    import torch

    from hunyuan3d2_tpu_torch.models import shapevae as sv
    from hunyuan3d2_tpu_torch.ops.geo_decoder import fused_geo_decode, geo_decode_plain

    cfg = sv.MINI
    vae = sv.ShapeVAE.init_random(cfg, device="cuda", generator=gen)
    lat = torch.randn(1, cfg.num_latents, cfg.embed_dim, generator=gen, device="cuda")
    k, v = vae.compute_kv(vae.decode_latents(lat))
    k16, v16 = k.to(torch.bfloat16).contiguous(), v.to(torch.bfloat16).contiguous()
    w, l, m = cfg.width, cfg.num_latents, cfg.geo_decoder_mlp_expand_ratio * cfg.width
    macs_per_query = 51 * w + 2 * w * w + 2 * l * w + 2 * w * m + w
    weight_bytes = 2 * (64 * w + 2 * w * w + 2 * w * m + w) + 2 * k16.numel() * 2
    rows, chain_rows, breakdowns = [], [], []
    for p in (39304, 65536):
        pts = (torch.rand(1, p, 3, generator=gen, device="cuda") * 2.02 - 1.01).contiguous()
        out = fused_geo_decode(vae, pts, k16, v16)
        ref = geo_decode_plain(vae, pts, k16, v16)
        torch.cuda.synchronize()
        check(torch.isfinite(out).all().item(), f"fused_geo_decode P={p}: non-finite output")
        err = (out - ref).abs().max().item()
        tol = 1e-2 * max(1.0, ref.abs().max().item())
        corr = torch.corrcoef(torch.stack([out.ravel(), ref.ravel()]))[0, 1].item()
        # the twin keeps the fp32 residual as the chain does: they differ in
        # the order of fp32 sums, erff, and kernel 1's online softmax (p
        # rounded to bf16 before it is normalised), so a bf16 rounding of an
        # LN, q, p or GELU value may flip by one ulp
        check(err <= tol and corr >= 0.9999,
              f"fused_geo_decode P={p}: max abs err {err} (tol {tol}), corr {corr}")
        ms = time_ms(lambda: fused_geo_decode(vae, pts, k16, v16), 10)
        plain_ms = time_ms(lambda: geo_decode_plain(vae, pts, k16, v16), 3)
        bound_ms, by = bound(2.0 * macs_per_query * p, 16 * p + weight_bytes, "bf16")
        row = dict(shape=f"P={p} W={w} H={cfg.heads} L={l} bf16 K/V", max_abs_err=err,
                   max_rel_err=err / ref.abs().max().item(), tol=tol, corr=corr, ms=ms,
                   plain_ms=plain_ms, library_ms=None, bound_ms=bound_ms, bound_by=by)
        log("fused_geo_decode " + json.dumps(row))
        rows.append(row)
        del out, ref
        steps, parts = chain_phase(vae, pts, k16, v16, torch.float32,
                                   lambda: fused_geo_decode(vae, pts, k16, v16))
        chain_rows += steps
        breakdowns.append(parts)
    del vae
    return rows, chain_rows, breakdowns


def chain_phase(vae, pts, k16, v16, x2_dtype, whole):
    """Each kernel of the decode chain (ops/geo_decoder.py: the front, kernel
    1, the tail) at the queries ``pts``, on the inputs the chain gives it,
    against its plain twin on the same inputs, with its time, the plain
    time, the time of the bf16 ``F.linear`` of the GEMM's shape (product
    and bias in one call; the port never calls it) and its bound. Then the
    chain's breakdown: every step timed alone, ``whole`` (the wrapper's
    call) timed, and the rest (host work, allocation, gaps)."""
    import torch
    import torch.nn.functional as F

    from hunyuan3d2_tpu_torch.ops import geo_decoder as g
    from hunyuan3d2_tpu_torch.ops.embeddings import fourier_embed
    from hunyuan3d2_tpu_torch.ops.flash_attention import flash_attention

    cfg = vae.cfg
    o = g._operands(vae, pts.device)
    eps, hd = cfg.ln_eps, cfg.head_dim
    p, w, m, e = pts.shape[1], cfg.width, cfg.geo_decoder_mlp_expand_ratio * cfg.width, g.EMB_PAD
    x2b = 2 if x2_dtype == torch.bfloat16 else 4
    b16 = {n: o[n].to(torch.bfloat16) for n in ("bqp", "bcq", "bcp", "bfc", "bpj")}

    def embed():
        qe = fourier_embed(pts[0], cfg.num_freqs, cfg.include_pi).to(torch.bfloat16)
        return F.pad(qe, (0, e - qe.shape[1]))

    qe = embed()
    x = g.gemm_residual(qe, o["wqp"], o["bqp"])
    h1 = g.ln_rows(x, o["ln1s"], o["ln1b"], eps)
    q = g.gemm_head_ln(h1, o["wcq"], o["bcq"], o["qns"], o["qnb"], hd, eps)
    att = flash_attention(q[None], k16, v16)[0]
    att2d = att.transpose(0, 1).reshape(p, w).contiguous()   # for F.linear alone
    x2 = g.gemm_residual(att, o["wcp"], o["bcp"], resid=x, out_dtype=x2_dtype)
    h = g.ln_rows(x2, o["ln3s"], o["ln3b"], eps)
    t = g.gemm_gelu(h, o["wfc"], o["bfc"])
    y = g.gemm_residual(t, o["wpj"], o["bpj"], resid=x2)
    # (kernel, step, kernel call, plain call, operations and their type,
    # bytes (each input read once, each output written once), library call)
    steps = [
        ("gemm_residual", "front: x = qe Wqp^T + bqp",
         lambda: g.gemm_residual(qe, o["wqp"], o["bqp"]),
         lambda: g.gemm_residual_plain(qe, o["wqp"], o["bqp"]),
         2.0 * p * e * w, "bf16", 2 * p * e + 2 * w * e + 4 * w + 4 * p * w,
         lambda: F.linear(qe, o["wqp"], b16["bqp"])),
        ("ln_rows", "LN1 (fp32 x)",
         lambda: g.ln_rows(x, o["ln1s"], o["ln1b"], eps),
         lambda: g.ln_rows_plain(x, o["ln1s"], o["ln1b"], eps),
         8.0 * p * w, "fp32", 4 * p * w + 2 * p * w + 8 * w, None),
        ("gemm_head_ln", "c_q + per-head q LN -> [H, P, D]",
         lambda: g.gemm_head_ln(h1, o["wcq"], o["bcq"], o["qns"], o["qnb"], hd, eps),
         lambda: g.gemm_head_ln_plain(h1, o["wcq"], o["bcq"], o["qns"], o["qnb"], hd, eps),
         2.0 * p * w * w, "bf16", 2 * p * w + 2 * w * w + 4 * w + 8 * hd + 2 * p * w,
         lambda: F.linear(h1, o["wcq"], b16["bcq"])),
        ("gemm_residual", f"c_proj + x (A per head) -> x2 {str(x2_dtype).split('.')[-1]}",
         lambda: g.gemm_residual(att, o["wcp"], o["bcp"], resid=x, out_dtype=x2_dtype),
         lambda: g.gemm_residual_plain(att, o["wcp"], o["bcp"], resid=x, out_dtype=x2_dtype),
         2.0 * p * w * w, "bf16", 2 * p * w + 2 * w * w + 4 * w + 4 * p * w + x2b * p * w,
         lambda: F.linear(att2d, o["wcp"], b16["bcp"])),
        ("ln_rows", f"LN3 ({str(x2_dtype).split('.')[-1]} x2)",
         lambda: g.ln_rows(x2, o["ln3s"], o["ln3b"], eps),
         lambda: g.ln_rows_plain(x2, o["ln3s"], o["ln3b"], eps),
         8.0 * p * w, "fp32", x2b * p * w + 2 * p * w + 8 * w, None),
        ("gemm_gelu", "MLP fc + GELU",
         lambda: g.gemm_gelu(h, o["wfc"], o["bfc"]),
         lambda: g.gemm_gelu_plain(h, o["wfc"], o["bfc"]),
         2.0 * p * w * m, "bf16", 2 * p * w + 2 * w * m + 4 * m + 2 * p * m,
         lambda: F.linear(h, o["wfc"], b16["bfc"])),
        ("gemm_residual", "MLP proj + x2 + bpj",
         lambda: g.gemm_residual(t, o["wpj"], o["bpj"], resid=x2),
         lambda: g.gemm_residual_plain(t, o["wpj"], o["bpj"], resid=x2),
         2.0 * p * w * m, "bf16", 2 * p * m + 2 * w * m + 4 * w + x2b * p * w + 4 * p * w,
         lambda: F.linear(t, o["wpj"], b16["bpj"])),
        ("ln_dot_rows", "ln_post + output dot",
         lambda: g.ln_dot_rows(y, o["lnps"], o["lnpb"], o["wout"], o["bout"], eps),
         lambda: g.ln_dot_rows_plain(y, o["lnps"], o["lnpb"], o["wout"], o["bout"], eps),
         10.0 * p * w, "fp32", 4 * p * w + 4 * p + 10 * w + 4, None),
    ]
    rows = []
    for kernel, step, fn, plain, flops, kind, nbytes, lib in steps:
        out, ref = fn(), plain()
        torch.cuda.synchronize()
        check(torch.isfinite(out.float()).all().item(), f"{kernel} ({step}): non-finite output")
        diff = (out.float() - ref.float()).abs()
        err = diff.max().item()
        scale = max(1.0, ref.float().abs().max().item())
        if out.dtype == torch.bfloat16:
            # one fp32 value summed in another order: equal or one bf16 ulp
            # apart, plus the fp32 order error where a sum cancels to near 0
            ok = bool((diff <= 2.0 ** -7 * ref.float().abs() + 1e-4).all().item())
            tol = "one bf16 ulp + 1e-4"
        elif kernel == "ln_dot_rows":
            # an LN output one ulp apart moves the dot by ~2^-8 of a term
            tol = 1e-2 * scale
            ok = err <= tol
        else:
            tol = 1e-4 * scale
            ok = err <= tol
        check(ok, f"{kernel} ({step}) P={p}: max abs err {err} (tol {tol})")
        bound_ms, by = bound(flops, nbytes, kind)
        row = dict(kernel=kernel, step=step, P=p, shape=f"{step}: P={p}, W={w}, M={m}",
                   max_abs_err=err, tol=tol, ms=time_ms(fn, 10), plain_ms=time_ms(plain, 2),
                   library_ms=None if lib is None else time_ms(lib, 10), bound_ms=bound_ms,
                   bound_by=by)
        log(f"{kernel} " + json.dumps(row))
        rows.append(row)
        del out, ref, diff
    parts = {"P": p, "embed (plain torch)": time_ms(embed, 10)}
    for r in rows:
        parts[r["step"]] = r["ms"]
    parts["flash_attention"] = time_ms(lambda: flash_attention(q[None], k16, v16), 10)
    parts["whole call"] = time_ms(whole, 5)
    parts["rest"] = parts["whole call"] - sum(v for n, v in parts.items()
                                              if n not in ("P", "whole call"))
    log("decode chain breakdown (ms) " + json.dumps(parts))
    return rows, parts


def plain_decode(vae, pts, k16, v16, chunk=8192):
    """The plain decode in query chunks, which keeps sdpa's fp32 scores
    [1, H, chunk, L] in memory at 3072 latents."""
    import torch

    from hunyuan3d2_tpu_torch.ops.geo_decoder import decode_queries_plain

    return torch.cat([decode_queries_plain(vae, pts[:, i:i + chunk], k16, v16).float()
                      for i in range(0, pts.shape[1], chunk)], dim=1)


def stream_phase(gen):
    """Kernel 4 (the MLP tail's chain) on x2 made by the streamed decode of
    the FULL (v2-0) VAE, at the coarse pass (49³ = 117,649 queries) and one
    fine chunk (390 blocks of 8³ = 199,680) of octree 380, against its
    plain twin; each kernel of the stream's chain there; then the whole
    streamed decode against the plain decode at P = 65,536."""
    import torch

    from hunyuan3d2_tpu_torch.models import shapevae as sv
    from hunyuan3d2_tpu_torch.ops.geo_decoder import (
        fused_geo_decode_stream,
        geo_mlp_tail,
        geo_mlp_tail_plain,
        geo_stream_x2,
    )

    cfg = sv.FULL
    vae = sv.ShapeVAE.init_random(cfg, device="cuda", generator=gen)
    lat = torch.randn(1, cfg.num_latents, cfg.embed_dim, generator=gen, device="cuda")
    k, v = vae.compute_kv(vae.decode_latents(lat))
    k16, v16 = k.to(torch.bfloat16).contiguous(), v.to(torch.bfloat16).contiguous()
    w, m = cfg.width, cfg.geo_decoder_mlp_expand_ratio * cfg.width
    rows, chain_rows, breakdowns = [], [], []
    for p in (117649, 199680):
        pts = (torch.rand(1, p, 3, generator=gen, device="cuda") * 2.02 - 1.01).contiguous()
        x2 = geo_stream_x2(vae, pts, k16, v16)
        out = geo_mlp_tail(vae, x2)
        ref = geo_mlp_tail_plain(vae, x2)
        torch.cuda.synchronize()
        check(torch.isfinite(out).all().item(), f"geo_mlp_tail P={p}: non-finite output")
        err = (out - ref).abs().max().item()
        ref_max = ref.abs().max().item()
        tol = 1e-2 * max(1.0, ref_max)
        corr = torch.corrcoef(torch.stack([out.ravel(), ref.ravel()]))[0, 1].item()
        # the twin keeps the fp32 residual as the kernel does: only the order
        # of fp32 sums (and erff) differ, so an LN or GELU output may round
        # to the neighbouring bf16 value
        check(err <= tol and corr >= 0.9999,
              f"geo_mlp_tail P={p}: max abs err {err} (tol {tol}), corr {corr}")
        ms = time_ms(lambda: geo_mlp_tail(vae, x2), 10)
        plain_ms = time_ms(lambda: geo_mlp_tail_plain(vae, x2), 2)
        # the two MLP products and the output dot; x2 read once, logits
        # written once, the MLP weights (bf16) and vectors (fp32) read once
        flops = 4.0 * w * m * p + 2.0 * w * p
        nbytes = 2 * w * p + 4 * p + 2 * 2 * w * m + 4 * (m + 6 * w)
        bound_ms, by = bound(flops, nbytes, "bf16")
        row = dict(shape=f"x2 [1, {p}, {w}] bf16, MLP {m}", max_abs_err=err,
                   max_rel_err=err / ref_max, tol=tol, corr=corr, ms=ms, plain_ms=plain_ms,
                   library_ms=None, bound_ms=bound_ms, bound_by=by)
        log("geo_mlp_tail " + json.dumps(row))
        rows.append(row)
        del x2, out, ref
        steps, parts = chain_phase(vae, pts, k16, v16, torch.bfloat16,
                                   lambda: fused_geo_decode_stream(vae, pts, k16, v16))
        chain_rows += steps
        breakdowns.append(parts)
        del pts
    p = 65536
    pts = (torch.rand(1, p, 3, generator=gen, device="cuda") * 2.02 - 1.01).contiguous()
    out = fused_geo_decode_stream(vae, pts, k16, v16)
    ref = plain_decode(vae, pts, k16, v16)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    scale = ref.abs().max().item()
    corr = torch.corrcoef(torch.stack([out.ravel(), ref.ravel()]))[0, 1].item()
    log(f"stream decode check (P={p}, 3072 latents): max abs err {err:.5f} of scale "
        f"{scale:.3f}, corr {corr:.7f}")
    # the plain decode keeps the residual in bf16 where the stream keeps fp32
    check(math.isfinite(err) and err <= 0.05 * max(1.0, scale) and corr > 0.9999,
          "stream decode check: the streamed decode disagrees with the plain decode")
    del vae
    return rows, chain_rows, breakdowns


def test_image():
    import numpy as np
    from PIL import Image

    rs = np.random.RandomState(0)
    img = np.zeros((512, 512, 4), np.uint8)
    yy, xx = np.mgrid[:512, :512]
    blob = (yy - 256) ** 2 / 180 ** 2 + (xx - 256) ** 2 / 120 ** 2 < 1
    img[blob, :3] = rs.randint(40, 220, (int(blob.sum()), 3))
    img[blob, 3] = 255
    return Image.fromarray(img)


def shape_run(name, pipe, image, runs, must_launch, must_not_launch=(), **call):
    """Drive ``pipe(image, **call)`` once per run name with the kernels'
    counts set to 0 just before; log stage times, launches and peak memory,
    check the mesh, and return (the last run's mesh, its launch counts)."""
    import numpy as np
    import torch

    from hunyuan3d2_tpu_torch.utils.timer import LAST_TIMINGS

    counters = _kernel_counters()
    for run in runs:
        torch.cuda.reset_peak_memory_stats()
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        meshes = pipe(image, seed=1234, **call)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        launches = {n: fn.launches for n, fn in counters.items()}
        mesh = meshes[0]
        stages = {k: round(LAST_TIMINGS[k], 4) for k in
                  ("Preprocess", "Encode Cond", "Diffusion Sampling", "Volume Decoding")}
        log(f"{name} {run}: {elapsed:.3f} s, stages {json.dumps(stages)}, "
            f"{len(mesh.vertices)} vertices, {len(mesh.faces)} faces, launches "
            f"{json.dumps(launches)}, peak memory "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
        check(len(mesh.vertices) > 0 and len(mesh.faces) > 0, f"{name}: empty mesh")
        check(np.isfinite(mesh.vertices).all(), f"{name}: non-finite vertices")
        check(np.abs(mesh.vertices).max() <= 1.01 + 1e-4, f"{name}: vertices outside the box")
        check(mesh.faces.min() >= 0 and mesh.faces.max() < len(mesh.vertices),
              f"{name}: face index out of range")
    for n in must_launch:
        check(launches[n] > 0, f"{name}: kernel {n} was never launched")
    for n in must_not_launch:
        check(launches[n] == 0, f"{name}: kernel {n} was launched off its path")
    # every decode call (kernel 3's or kernel 4's) ran the whole chain
    calls = launches["fused_geo_decode"] + launches["geo_mlp_tail"]
    for n, per in CHAIN_PER_CALL.items():
        check(launches[n] == per * calls, f"{name}: {launches[n]} {n} launches for {calls} "
              f"decode calls ({per} each)")
    return mesh, launches


def write_glb(name, mesh, filename):
    import numpy as np

    from hunyuan3d2_tpu_torch.geometry.mesh import Mesh

    os.makedirs(os.path.join(ROOT, "tmp"), exist_ok=True)
    path = os.path.join(ROOT, "tmp", filename)
    mesh.export(path)
    back = Mesh.load(path)
    check(np.array_equal(back.faces, mesh.faces) and np.array_equal(back.vertices, mesh.vertices),
          f"{name}: GLB round trip differs")
    log(f"{name}: wrote {os.path.relpath(path, ROOT)} ({os.path.getsize(path)} bytes), read back")


def main_path():
    import torch

    from hunyuan3d2_tpu_torch.pipelines.shapegen import Hunyuan3DDiTFlowMatchingPipeline

    os.environ["HY3D_CAP_ACTIVES"] = "1"
    t0 = time.perf_counter()
    pipe = Hunyuan3DDiTFlowMatchingPipeline.init_random(size="mini", dino="giant",
                                                        device="cuda", seed=0)
    pipe.enable_flashvdm(mc_algo="dmc")
    torch.cuda.synchronize()
    log(f"main path: stack up in {time.perf_counter() - t0:.2f} s "
        f"(DINOv2-giant, mini DiT, mini ShapeVAE, random weights, seed 0)")
    mesh, launches = shape_run("main path", pipe, test_image(), ("cold", "warm"),
                               ("flash_attention", "fused_geo_decode", *CHAIN_KERNELS),
                               ("geo_mlp_tail",),
                               num_inference_steps=5, guidance_scale=5.0,
                               octree_resolution=256, num_chunks=65536)
    write_glb("main path", mesh, "chip_smoke.glb")
    return pipe, launches


def extractor_runs(pipe):
    """The mini stack's other decoders and extractors through the user's
    entry points, one warm run each with its time and mesh size: FlashVDM
    with marching cubes ('mc') and marching tetrahedra ('mt') at octree 256
    (capped active cells, extracted on the host from the device's compacted
    cells), then at octree 64 the vanilla decode with dense marching cubes
    (``enable_flashvdm(enabled=False)``) and the hierarchical decode without
    adaptive K/V (``enable_flashvdm_decoder(adaptive_kv_selection=False)``),
    both through the dense fp32 decode (``ShapeVAE.decode_queries``), whose
    attention goes through kernel 1: its launches in the decode (those of
    the run less those of the same call up to the latents) must exceed the
    latent transformer's, one a layer. The 'mc' mesh is written under
    tmp/."""
    os.environ["HY3D_CAP_ACTIVES"] = "1"
    image = test_image()
    call = dict(num_inference_steps=5, guidance_scale=5.0, num_chunks=65536)
    launches = {}
    for name, octree, enable in (
            ("mc", 256, lambda: pipe.enable_flashvdm(mc_algo="mc")),
            ("mt", 256, lambda: pipe.enable_flashvdm(mc_algo="mt")),
            ("vanilla + mc", 64, lambda: pipe.enable_flashvdm(enabled=False)),
            ("hierarchical + mc", 64,
             lambda: pipe.vae.enable_flashvdm_decoder(mc_algo="mc",
                                                      adaptive_kv_selection=False))):
        enable()
        flashvdm = octree == 256
        mesh, launches[name] = shape_run(
            f"mini {name} (octree {octree})", pipe, image, ("warm",),
            ("flash_attention", "fused_geo_decode") if flashvdm else ("flash_attention",),
            ("geo_mlp_tail",) if flashvdm else ("fused_geo_decode", "geo_mlp_tail"),
            octree_resolution=octree, **call)
        if name == "mc":
            write_glb("mini mc", mesh, "chip_smoke_mc.glb")
        if not flashvdm:
            from hunyuan3d2_tpu_torch.ops.flash_attention import flash_attention

            flash_attention.launches = 0
            pipe(image, seed=1234, output_type="latents", octree_resolution=octree, **call)
            front = flash_attention.launches
            decode = launches[name]["flash_attention"] - front
            layers = pipe.vae.cfg.num_decoder_layers
            log(f"mini {name} (octree {octree}): kernel 1 launches {decode} in the volume "
                f"decode ({layers} in the latent transformer, {decode - layers} in the dense "
                f"decode), {front} in the conditioner and the DiT")
            check(decode > layers, f"mini {name}: the dense decode never launched kernel 1")
            if name.startswith("vanilla"):
                chunks = -(-(octree + 1) ** 3 // call["num_chunks"])
                check(decode == layers + chunks, f"mini {name}: {decode - layers} kernel-1 "
                      f"launches in the dense decode, {chunks} chunks expected")
    pipe.enable_flashvdm(mc_algo="dmc")
    return launches


def v20_path():
    """Slice 3: the v2-0 Fast stack at full width through the user's entry
    points, with the settings of the reference's
    examples/fast_shape_gen_with_flashvdm.py (5 steps, octree 380,
    num_chunks 200,000)."""
    import torch

    from hunyuan3d2_tpu_torch.pipelines.shapegen import Hunyuan3DDiTFlowMatchingPipeline

    os.environ["HY3D_CAP_ACTIVES"] = "1"
    t0 = time.perf_counter()
    pipe = Hunyuan3DDiTFlowMatchingPipeline.init_random(size="full", guidance_embed=True,
                                                        dino="giant", device="cuda", seed=0)
    pipe.enable_flashvdm(mc_algo="dmc")
    torch.cuda.synchronize()
    log(f"v2-0 path: stack up in {time.perf_counter() - t0:.2f} s (DINOv2-giant, FULL DiT "
        f"16 + 32 blocks with the guidance embedding, FULL ShapeVAE 3072 latents, random "
        f"weights, seed 0)")
    mesh, launches = shape_run("v2-0 path", pipe, test_image(), ("cold", "warm"),
                               ("flash_attention", "geo_mlp_tail", *CHAIN_KERNELS), ("fused_geo_decode",),
                               num_inference_steps=5, guidance_scale=5.0,
                               octree_resolution=380, num_chunks=200000)
    write_glb("v2-0 path", mesh, "chip_smoke_v20.glb")
    return pipe, launches


def v20_decode_breakdown(pipe, gen):
    """Volume Decoding of the v2-0 path in its parts (host clock around
    synchronised calls, one warm call each): the VAE trunk and K/V, the
    block-sparse decode through the streamed decode (19 calls of the decode
    function), and the surface nets on the 381³ grid."""
    import torch

    from hunyuan3d2_tpu_torch.models.shapevae import active_capacity, face_capacity
    from hunyuan3d2_tpu_torch.volume.decoders import surface_nets_from_grid

    vae = pipe.vae
    lat = torch.randn(1, vae.cfg.num_latents, vae.cfg.embed_dim, generator=gen, device="cuda")

    def timed(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    with torch.no_grad():
        (k, v), t_trunk = timed(lambda: vae.compute_kv(vae.decode_latents(lat)))
        decode = vae.query_decoder(k, v)
        grid, t_grid = timed(lambda: vae.volume_decoder(decode, 1, 380, num_chunks=200000,
                                                        device=vae.device))
        _, t_surf = timed(lambda: surface_nets_from_grid(grid, 0.0, 1.01, active_capacity(380),
                                                         face_capacity(380)))
    log(f"v2-0 Volume Decoding parts: VAE trunk + K/V {t_trunk:.4f} s, block-sparse decode "
        f"{t_grid:.4f} s, surface nets {t_surf:.4f} s")


def multiview_run(pipe):
    """The multiview variant on the v2-0 stack: the same DINOv2 tower behind
    DinoImageEncoderMV, three views (front, left, back) through
    MVImageProcessorV2; a first run, then the warm one."""
    from PIL import Image

    from hunyuan3d2_tpu_torch.models.conditioner import DinoImageEncoderMV, SingleImageEncoder
    from hunyuan3d2_tpu_torch.utils.imageproc import MVImageProcessorV2

    main = pipe.conditioner.main
    pipe.conditioner = SingleImageEncoder(DinoImageEncoderMV(main.cfg, model=main.model))
    pipe.image_processor = MVImageProcessorV2()
    img = test_image()
    views = {"front": img, "left": img.transpose(Image.ROTATE_90),
             "back": img.transpose(Image.FLIP_LEFT_RIGHT)}
    _, launches = shape_run("multiview (3 views) path", pipe, views, ("first", "warm"),
                            ("flash_attention", "geo_mlp_tail", *CHAIN_KERNELS), ("fused_geo_decode",),
                            num_inference_steps=5, guidance_scale=5.0,
                            octree_resolution=380, num_chunks=200000)
    return launches


def decode_agreement(pipe, gen):
    """The path's decode (the kernels) against the plain decode on a small
    grid, from fresh latents through the path's VAE."""
    import torch

    vae = pipe.vae
    lat = torch.randn(1, vae.cfg.num_latents, vae.cfg.embed_dim, generator=gen, device="cuda")
    with torch.no_grad():
        k, v = vae.compute_kv(vae.decode_latents(lat))
        k16, v16 = k.to(torch.bfloat16).contiguous(), v.to(torch.bfloat16).contiguous()
        grid = vae.decode_grid(lat, octree_resolution=64)
        plain = vae.volume_decoder(lambda p: plain_decode(vae, p, k16, v16), 1, 64,
                                   device=vae.device)
    err = (grid - plain).abs().max().item()
    scale = plain.abs().max().item()
    same_sign = ((grid > 0) == (plain > 0)).float().mean().item()
    log(f"decode check ({vae.cfg.num_latents} latents, octree 64): max abs err {err:.5f} of "
        f"scale {scale:.3f}, sign agreement {same_sign:.6f}")
    check(math.isfinite(err) and err <= 0.05 * max(1.0, scale) and same_sign >= 0.99,
          "decode check: kernel grid disagrees with the plain decode")


def sphere_mesh(resolution: int = 110):
    """The analytic test mesh of the texture path: surface nets of a radius
    0.6 sphere on a (resolution+1)³ grid over [-1.01, 1.01]³ (110 → 40,284
    faces), emitted by the port's on-device surface nets. Random shape
    weights decode noise, so the texture path takes this instead."""
    import torch

    from hunyuan3d2_tpu_torch.geometry.mesh import Mesh
    from hunyuan3d2_tpu_torch.volume.decoders import quads_to_tris, surface_nets_from_grid

    lin = torch.linspace(-1.01, 1.01, resolution + 1, device="cuda")
    r = torch.sqrt(lin[:, None, None] ** 2 + lin[None, :, None] ** 2 + lin[None, None, :] ** 2)
    verts, quads, nq, count, ok = surface_nets_from_grid(0.6 - r, 0.0, 1.01, capacity=1 << 18,
                                                         face_capacity=1 << 18)
    check(bool(ok), "sphere mesh: surface buffers overflowed")
    return Mesh(verts[:int(count)].cpu().numpy(), quads_to_tris(quads[:int(nq)].cpu()))


def _views(render):
    import numpy as np
    import torch

    mats = [render._mvp(e, a) for e, a in VIEWS]
    return (torch.from_numpy(np.stack([m[0] for m in mats])).cuda(),
            torch.from_numpy(np.stack([m[1] for m in mats])).cuda())


# The masked fp32 rows' time under the kernel this tree replaced (3xTF32 on
# mma.sync, 4-warp CTAs, cp.async double buffering), at the same voxel
# masks: the median of the parent tree's six 20-call timings in
# `python -m hunyuan3d2_tpu_torch.tools.masked_flash_ab --roots PARENT . .
# PARENT` on NVIDIA H100 80GB HBM3, 700 W (this kernel: 1.3903 and 0.2216
# ms). Logged beside each fp32 row as "before_ms"; not measured by this
# script, so it stays out of the kernels line.
MASKED_F32_BEFORE_MS = {32: 3.8212, 16: 0.5035}


def masked_phase(gen, sphere):
    """The masked kernel at the paint UNet's masked multiview shapes, under
    the voxel masks that the paint path builds from the sphere's 512²
    position maps (grid 32 → 6144 tokens, grid 16 → 1536), in bf16 and in
    fp32 (an fp32 paint stack's; held to an fp64 evaluation, bound against
    3xTF32)."""
    import torch
    import torch.nn.functional as F

    from hunyuan3d2_tpu_torch.geometry.render import MeshRender
    from hunyuan3d2_tpu_torch.geometry.render_device import cond_maps, upload_mesh
    from hunyuan3d2_tpu_torch.models.paint_unet import compute_voxel_grid_mask
    from hunyuan3d2_tpu_torch.ops.flash_attention import (
        default_config,
        flash_attention_masked,
        flash_attention_masked_plain,
        tile_map,
    )

    render = MeshRender(default_resolution=2048, texture_size=2048)
    render.load_mesh(sphere)
    _, position = cond_maps(upload_mesh(render, "cuda"), _views(render)[1], 512)
    pos = position[None].float() / 255.0
    rows = []
    for dt in (torch.bfloat16, torch.float32):
        for g, h, tol in ((32, 10, 2e-2), (16, 20, 2e-2)):
            mask = compute_voxel_grid_mask(pos, g)
            b, lq, lk = mask.shape
            d = 64
            q, k, v = (torch.randn(b, h, lq, d, generator=gen, device="cuda").to(dt)
                       for _ in range(3))
            out = flash_attention_masked(q, k, v, mask)
            ref = flash_attention_masked_plain(q, k, v, mask)
            torch.cuda.synchronize()
            name = f"masked flash g={g} {str(dt)[6:]}"
            extra = {}
            if dt == torch.bfloat16:
                err, rel, rms, tol = attention_check(name, out, ref, tol)
                extra = dict(max_rel_err=rel, rel_rms_err=rms, tol=tol)
            else:
                check(bool((out[:, :, ~mask[0].any(-1)] == 0).all()),
                      f"{name}: a fully masked row is not 0")
                err, share, bnd, twin_err, rms, twin_rms = fp32_check(name, q, k, v, out, ref,
                                                                      mask)
                extra = dict(share_of_fp64_bound=share, fp64_bound=bnd, twin_max_abs_err=twin_err,
                             rel_rms_err=rms, twin_rel_rms_err=twin_rms, tol="fp64 rule")
            # the share of (q, 64 or 128 key) tiles the kernel skips; its ms
            # includes building the occupancy map
            bq, bk, _ = default_config(b, h, lq, lk, d, q.dtype, masked=True)
            skipped = 1.0 - tile_map(mask, bq, bk).float().mean().item()
            ms = time_ms(lambda: flash_attention_masked(q, k, v, mask), 20)
            plain_ms = time_ms(lambda: flash_attention_masked_plain(q, k, v, mask), 3)
            lib_ms = time_ms(lambda: F.scaled_dot_product_attention(q, k, v,
                                                                    attn_mask=mask[:, None]), 20)
            allowed = mask.sum().item()
            # the work these inputs need: the allowed (query, key) pairs only
            bounds = row_bounds(4.0 * h * d * allowed, 4 * q.numel() * q.element_size()
                                + mask.numel(), dt)
            row = dict(shape=f"voxel grid {g}: q/k/v {[b, h, lq, d]} {str(dt)[6:]}, mask "
                             f"{[b, lq, lk]} density {allowed / mask.numel():.4f}",
                       tiles=[bq, bk], tiles_skipped=skipped, max_abs_err=err, **extra, ms=ms,
                       plain_ms=plain_ms, library_ms=lib_ms, **bounds)
            before = {} if dt == torch.bfloat16 else dict(
                before_ms=MASKED_F32_BEFORE_MS[g],
                before_from="the parent's mma.sync kernel (tools/masked_flash_ab.py)")
            log("flash_attention_masked " + json.dumps({**row, **before}))
            rows.append(row)
    return rows


def sweep_phase():
    """Kernel 6: the tile-configuration sweep of the bf16 flash kernel at the
    paint UNet's multiview shape, every variant held against the plain twin
    (attention_check). Its launches are counted as the sweep's own path."""
    from hunyuan3d2_tpu_torch.tools.profile_flash_variants import flash_attention_variant, sweep

    flash_attention_variant.launches = 0
    res = sweep((1, 5, 24576, 64), iters=20,
                check=lambda name, out, ref: attention_check(f"flash variant {name}", out, ref,
                                                             2e-2)[0])
    launches = {"flash_variants": flash_attention_variant.launches}
    rows = []
    for r in res["rows"] + [res["default"]]:
        log(f"flash sweep {r['name']}: {r['ms']:.4f} ms, {r['tflops']:.1f} TFLOP/s, bound "
            f"{r['bound_ms']:.4f} ms, max abs err {r['max_abs_err']}")
    for r in res["rows"]:
        rows.append(dict(shape=f"{r['name']} q/k/v {res['shape']} bf16", variant=r["name"],
                         max_abs_err=r["max_abs_err"], ms=r["ms"], tflops=r["tflops"],
                         plain_ms=res["plain_ms"], library_ms=res["sdpa_ms"],
                         bound_ms=r["bound_ms"], bound_by="operations"))
    log(f"flash sweep: best {res['best']['name']} {res['best']['ms']:.4f} ms, default "
        f"{res['default']['name']} {res['default']['ms']:.4f} ms, SDPA {res['sdpa_ms']:.4f} ms, "
        f"plain {res['plain_ms']:.2f} ms, launches {launches['flash_variants']}")
    best = min(range(len(rows)), key=lambda i: rows[i]["ms"])
    return rows, best, launches


def raster_phase(sphere):
    """The rasterizer on the sphere: the front view at 512² (orthographic, as
    the cond maps) and the unwrapped mesh in UV space at 2048² (as the bake's
    UV raster); then screen-sized triangles at 2048² (the wide list), and
    random faces with exact duplicates, reversed windings, degenerate, NaN,
    w = 0 and off-screen faces at 512². The kernel's records and bbox must
    equal face_setup's bit for bit; face ids must agree with the plain twin
    on ≥ 99.99 % of pixels and, where they agree, barycentrics within 1e-5
    and depth within 1e-6. ms is the whole rasterize() call, face setup
    included; kernels_ms its memset and two kernels alone (no wrapper, no
    allocation); plain_ms is face_setup + rasterize_plain."""
    import torch

    from hunyuan3d2_tpu_torch.geometry.render import MeshRender
    from hunyuan3d2_tpu_torch.geometry.uv import mesh_uv_wrap
    from hunyuan3d2_tpu_torch.ops.rasterize import (
        _launch,
        _workspace,
        face_setup,
        rasterize,
        rasterize_cuda,
        rasterize_plain,
    )

    render = MeshRender(default_resolution=2048, texture_size=2048)
    render.load_mesh(sphere)
    verts = torch.from_numpy(render.vtx_pos).cuda()
    faces = torch.from_numpy(render.pos_idx).cuda()
    vh = torch.cat([verts, torch.ones_like(verts[:, :1])], 1)
    cases = [("view 512", vh @ _views(render)[1][0].T, faces, 512)]
    wrapped = mesh_uv_wrap(sphere)
    render.load_mesh(wrapped)
    uvc = torch.from_numpy(render.vtx_uv).cuda() * 2.0 - 1.0
    zeros = torch.zeros_like(uvc[:, 0])
    cases.append(("uv 2048", torch.stack([uvc[:, 0], -uvc[:, 1], zeros, zeros + 1.0], 1),
                  torch.from_numpy(render.pos_idx).cuda(), 2048))
    # off the path: 256 random screen-sized triangles, all in the wide list
    g = torch.Generator(device="cuda").manual_seed(1)
    big = torch.rand(768, 4, generator=g, device="cuda") * 2.0 - 1.0
    big[:, 3] = 1.0
    cases.append(("big faces 2048", big,
                  torch.arange(768, device="cuda", dtype=torch.int32).reshape(256, 3), 2048))
    # 4000 random faces, their first 500 again in reversed winding (exact
    # depth ties: the lower id wins), degenerate, NaN, w = 0 and off-screen
    # vertices and faces
    tv = torch.rand(12000, 4, generator=g, device="cuda") * 2.2 - 1.1
    tv[:, 3] = 1.0
    tv[0::97, 3] = 0.0
    tv[1::89, 0] = float("nan")
    tv[2::83] += 5.0
    tf = torch.arange(12000, device="cuda", dtype=torch.int32).reshape(4000, 3)
    tf[3::79, 1] = tf[3::79, 0]
    cases.append(("ties and degenerate 512", tv, torch.cat([tf, tf[:500].flip(1)]), 512))
    rows = []
    for name, clip, f, res in cases:
        out, recs, bbox = rasterize_cuda(clip, f, res, res)
        ref_recs, ref_bbox = face_setup(clip, f, res, res)
        ref = rasterize_plain(ref_recs, ref_bbox, res, res)
        torch.cuda.synchronize()
        finite = torch.isfinite(ref_recs)
        same_recs = (torch.equal(bbox, ref_bbox)
                     and torch.equal(finite, torch.isfinite(recs))
                     and torch.equal(torch.isnan(recs), torch.isnan(ref_recs))
                     and torch.equal(recs.view(torch.int32)[finite],
                                     ref_recs.view(torch.int32)[finite]))
        check(same_recs, f"rasterize {name}: the kernel's records or bbox differ from "
              "face_setup's")
        same = out.face_id == ref.face_id
        n_diff = int((~same).sum().item())
        agree = 1.0 - n_diff / same.numel()
        bary_err = (out.bary - ref.bary)[same].abs().max().item()
        depth_err = (out.depth - ref.depth)[same].abs().max().item()
        log(f"rasterize {name}: records and bbox equal face_setup's, face_id differs on "
            f"{n_diff} of {same.numel()} pixels, bary err {bary_err}, depth err {depth_err}, "
            f"coverage {(out.face_id >= 0).float().mean().item():.4f}")
        check(agree >= 0.9999 and bary_err <= 1e-5 and depth_err <= 1e-6,
              f"rasterize {name}: kernel disagrees with the plain twin")
        ms = time_ms(lambda: rasterize(clip, f, res, res), 50)
        # the memset and the two kernels alone, on buffers allocated once
        ws, cap = _workspace(f.shape[0], res, res, clip.device)

        def kernels():
            _launch(clip, f, res, res, ws, cap, out.face_id, out.bary, out.depth)

        kernels_ms = time_ms(kernels, 50)
        by_kernel = device_ms_by_kernel(kernels, 20)
        plain_ms = time_ms(lambda: rasterize_plain(*face_setup(clip, f, res, res), res, res), 3)
        setup_ms = time_ms(lambda: face_setup(clip, f, res, res), 20)
        nx = (bbox[:, 1] - bbox[:, 0] + 1).clamp_min(0).double()
        ny = (bbox[:, 3] - bbox[:, 2] + 1).clamp_min(0).double()
        pairs = (nx * ny).sum().item()     # (face, bbox pixel) tests these inputs need
        # ~20 fp32 operations per test; bytes: verts and faces read, face_id,
        # bary and depth written
        nbytes = clip.numel() * 4 + f.numel() * 4 + res * res * 20
        bound_ms, by = bound(20.0 * pairs, nbytes, "fp32")
        row = dict(shape=f"{name}: {f.shape[0]} faces, {res}x{res}, {int(pairs)} bbox pixels",
                   max_abs_err=max(bary_err, depth_err), face_id_differs=n_diff, ms=ms,
                   kernels_ms=kernels_ms, device_ms_by_kernel=by_kernel, plain_ms=plain_ms, plain_face_setup_ms=setup_ms, library_ms=None,
                   bound_ms=bound_ms, bound_by=by)
        log("rasterize " + json.dumps(row))
        rows.append(row)
    return rows


def _kernel_counters():
    from hunyuan3d2_tpu_torch.ops import geo_decoder as g
    from hunyuan3d2_tpu_torch.ops.flash_attention import (flash_attention,
                                                          flash_attention_backward,
                                                          flash_attention_masked)
    from hunyuan3d2_tpu_torch.ops.rasterize import rasterize
    from hunyuan3d2_tpu_torch.tools.profile_flash_variants import flash_attention_variant

    return {"flash_attention": flash_attention,
            "flash_attention_backward": flash_attention_backward,
            "flash_attention_masked": flash_attention_masked,
            "fused_geo_decode": g.fused_geo_decode, "geo_mlp_tail": g.geo_mlp_tail,
            "rasterize": rasterize, "flash_variants": flash_attention_variant,
            **{n: getattr(g, n) for n in CHAIN_KERNELS}}


# the textured call's unwrap: the worker's own time, overlapped with the
# device's cond maps and diffusion, then the request's wait for it
UNWRAP_STAGES = ("UV Unwrap (overlaps denoise)", "UV Unwrap (wait)")


def unwrap_ran_in_worker(name, pipe):
    """Fail unless the last textured call's unwrap ran in the host worker
    process, not in this one."""
    check(pipe.unwrap_pid is not None and pipe.unwrap_pid != os.getpid(),
          f"{name}: the unwrap ran in process {pipe.unwrap_pid}, not in the host worker "
          f"(this process is {os.getpid()})")


def textured_runs(name, pipe, sphere, image, denoise_stage, glb):
    """Drive ``pipe(sphere, image)`` cold and warm with the kernels' counts
    set to 0 just before each run; log stage times, launch counts and peak
    memory, check the textured mesh, write it under tmp/ and read it back.
    Returns the warm run's launch counts."""
    import numpy as np
    import torch

    from hunyuan3d2_tpu_torch.geometry.mesh import Mesh
    from hunyuan3d2_tpu_torch.utils.timer import LAST_TIMINGS

    counters = _kernel_counters()
    for run in ("cold", "warm"):
        torch.cuda.reset_peak_memory_stats()
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        out = pipe(sphere, image)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        launches = {n: fn.launches for n, fn in counters.items()}
        stages = {k: round(LAST_TIMINGS[k], 4) for k in (
            "Cond Maps (device)", "Paint VAE Encode", denoise_stage,
            "Multiview Diffusion (device)", *UNWRAP_STAGES, "Bake Geometry (device)",
            "Texture Baking (device)", "Texture Inpaint")}
        log(f"{name} {run}: {elapsed:.3f} s, stages {json.dumps(stages)}, "
            f"{len(out.vertices)} vertices, {len(out.faces)} faces, launches "
            f"{json.dumps(launches)}, peak memory "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
        check(out.texture is not None and out.texture.shape == (2048, 2048, 3)
              and out.texture.dtype == np.uint8, f"{name}: no 2048² RGB texture")
        check(out.uv is not None and out.uv.shape == (len(out.vertices), 2)
              and np.isfinite(out.uv).all() and out.uv.min() >= -1e-4
              and out.uv.max() <= 1 + 1e-4, f"{name}: bad UVs")
        check(out.faces.min() >= 0 and out.faces.max() < len(out.vertices),
              f"{name}: face index out of range")
        check(float(out.texture.std()) > 1.0, f"{name}: flat texture")
        # 6 cond views, the UV raster and 6 bake views
        check(launches["rasterize"] == 13, f"{name}: {launches['rasterize']} rasterize "
              "launches, 13 expected")
        check(launches["flash_attention"] > 0, f"{name}: flash_attention was never launched")
        unwrap_ran_in_worker(name, pipe)
    os.makedirs(os.path.join(ROOT, "tmp"), exist_ok=True)
    path = os.path.join(ROOT, "tmp", glb)
    out.export(path)
    back = Mesh.load(path)
    check(back.uv is not None and np.allclose(back.uv, out.uv, atol=1e-6)
          and back.texture is not None and np.array_equal(back.texture, out.texture)
          and np.array_equal(back.faces, out.faces), f"{name}: textured GLB round trip differs")
    log(f"{name}: wrote {os.path.relpath(path, ROOT)} ({os.path.getsize(path)} bytes), "
        f"uv and texture read back")
    return launches


def serial_check(name, pipe, sphere, image):
    """The overlapped call (the unwrap in the host worker while the device
    denoises) against the public stages run by hand in the serial order
    (tools/texgen_overlap_ab.serial_texture: cond maps → multiview net →
    mesh_uv_wrap in this process → upload → bake → inpaint) on the same
    init_latents and step_noises: texture, UVs, faces and vertices bit for
    bit."""
    import numpy as np
    import torch

    from hunyuan3d2_tpu_torch.tools.texgen_overlap_ab import serial_texture

    mv_net = pipe.models["multiview_model"]
    lat = mv_net.view_size >> (len(mv_net.pipeline.vae.cfg.block_out_channels) - 1)
    gen = torch.Generator(device="cuda").manual_seed(17)
    shape = (1, len(pipe.config.candidate_camera_azims), lat, lat, 4)
    init = torch.randn(shape, generator=gen, device="cuda")
    noises = [torch.randn(shape, generator=gen, device="cuda")
              for _ in range(mv_net.num_inference_steps)]
    t0 = time.perf_counter()
    out = pipe(sphere, image, init_latents=init, step_noises=noises)
    t_overlap = time.perf_counter() - t0
    unwrap_ran_in_worker(name, pipe)
    t0 = time.perf_counter()
    ref = serial_texture(pipe, sphere, image, init_latents=init, step_noises=noises)
    t_serial = time.perf_counter() - t0
    same = {k: bool(np.array_equal(getattr(out, k), getattr(ref, k)))
            for k in ("texture", "uv", "faces", "vertices")}
    check(all(same.values()), f"{name}: the overlapped call differs from the serial stages "
          f"({json.dumps(same)})")
    log(f"{name}: overlapped call equals the serial stages bit for bit (texture, uv, faces, "
        f"vertices; {len(out.faces)} faces); {t_overlap:.3f} s overlapped, {t_serial:.3f} s "
        f"serial by hand, the unwrap in worker pid {pipe.unwrap_pid}")


def texture_paths(sphere):
    """Slice 2 at full width through the user's entry points, on one random
    paint stack: the paint-turbo sampler (LCM 10 steps), then the standard
    one (set_turbo(False): EulerAncestral 30 steps at CFG 2.0). Returns the
    launch counts of each path's warm run."""
    import torch

    from hunyuan3d2_tpu_torch import Hunyuan3DPaintPipeline

    t0 = time.perf_counter()
    pipe = Hunyuan3DPaintPipeline.init_random(size="default", view_size=512, render_size=2048,
                                              texture_size=2048, device="cuda", seed=0)
    torch.cuda.synchronize()
    log(f"texture paths: stack up in {time.perf_counter() - t0:.2f} s (paint UNet DEFAULT + "
        f"dual, SD VAE DEFAULT, random weights, seed 0); mesh {len(sphere.vertices)} vertices, "
        f"{len(sphere.faces)} faces")
    from hunyuan3d2_tpu_torch.utils import host_worker

    log(f"texture paths: the unwrap's host worker runs {host_worker.THREADS} threads; this host "
        f"has {os.cpu_count()} CPUs")
    image = test_image()
    turbo = textured_runs("texture path", pipe.set_turbo(), sphere, image,
                          "Paint Denoising (turbo)", "chip_smoke_textured.glb")
    check(turbo["flash_attention_masked"] > 0, "texture path: the masked kernel never ran")
    serial_check("texture path", pipe, sphere, image)
    standard = textured_runs("texture path standard", pipe.set_turbo(False), sphere, image,
                             "Paint Denoising", "chip_smoke_textured_standard.glb")
    serial_check("texture path standard", pipe, sphere, image)
    # the standard loop builds no voxel masks
    check(standard["flash_attention_masked"] == 0,
          "texture path standard: the masked kernel was launched off its path")
    del pipe
    return turbo, standard


def texture_fp32_path(sphere):
    """6b. The paint-turbo stack at full width loaded in fp32 (path
    textured_glb_fp32): the DEFAULT stack of texture_paths (same seed)
    written in the published layout (rounded to fp16) under tmp/, loaded by
    load_paint_pipeline(..., dtype="fp32") and wrapped by the texture
    pipeline's classes; one textured GLB, cold and warm. Every attention
    launch in it must be fp32 (kernel 1's fp32 instances, the masked fp32
    kernel 100 times a run). Returns the warm run's launch counts."""
    import torch

    from hunyuan3d2_tpu_torch import Hunyuan3DPaintPipeline
    from hunyuan3d2_tpu_torch.io.checkpoints import load_paint_pipeline
    from hunyuan3d2_tpu_torch.ops import flash_attention as fa
    from hunyuan3d2_tpu_torch.pipelines.multiview import Multiview_Diffusion_Net
    from hunyuan3d2_tpu_torch.pipelines.texgen import Hunyuan3DTexGenConfig

    root = os.path.join(ROOT, "tmp", "fp32_paint_checkpoint")
    shutil.rmtree(root, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        src = Hunyuan3DPaintPipeline.init_random(size="default", view_size=512, device="cuda",
                                                 seed=0)
        nbytes = _write_paint_checkpoint(root, src.models["multiview_model"].pipeline)
        del src
        gc.collect()
        torch.cuda.empty_cache()
        written = time.perf_counter() - t0
        t0 = time.perf_counter()
        inner = load_paint_pipeline(root, "hunyuan3d-paint-v2-0-turbo", view_size=512,
                                    device="cuda", dtype="fp32")
        torch.cuda.synchronize()
        loaded = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    check(inner.dtype == torch.float32
          and all(p.dtype == torch.float32 for m in (inner.unet, inner.vae)
                  for p in m.parameters()), "texture path fp32: a loaded parameter is not fp32")
    log(f"texture path fp32: checkpoint {nbytes / 2 ** 30:.2f} GiB written in {written:.2f} s, "
        f"loaded in fp32 in {loaded:.2f} s")
    inner.set_turbo()
    pipe = Hunyuan3DPaintPipeline({"multiview_model": Multiview_Diffusion_Net(inner)},
                                  Hunyuan3DTexGenConfig(), "cuda")   # render, texture 2048
    # the dtypes the flash launcher sees: every attention of the fp32 stack
    # must run an fp32 instance
    dtypes = {}
    launch = fa._launch

    def tally(q, k, v, mask, scale):
        key = f"{'masked' if mask is not None else 'flash'} {str(q.dtype)[6:]}"
        dtypes[key] = dtypes.get(key, 0) + 1
        return launch(q, k, v, mask, scale)

    fa._launch = tally
    try:
        launches = textured_runs("texture path fp32", pipe, sphere, test_image(),
                                 "Paint Denoising (turbo)", "chip_smoke_textured_fp32.glb")
    finally:
        fa._launch = launch
    log(f"texture path fp32: flash launches by kind and dtype (both runs) {json.dumps(dtypes)}")
    check(launches["flash_attention_masked"] == 100,
          f"texture path fp32: {launches['flash_attention_masked']} masked launches, 100 expected")
    check(set(dtypes) == {"flash float32", "masked float32"},
          f"texture path fp32: attention ran {sorted(dtypes)}, fp32 only expected")
    del pipe, inner
    return launches


def texture_agreement(turbo: bool, fp32: bool = False):
    """Slice 2 at a small size on the card (kernels, cuDNN) against the same
    stack on the CPU (plain twins), same weights, same noise, through either
    sampler. The UNet keeps the paint UNet's head size (64) at narrow
    channels (64, 128), and 64² views give 32² latents through the tiny VAE,
    so the kernels' gates admit it as they admit the full-width UNet: flash
    attention for the 32² level's self, reference and cross attention and
    (standard loop) its 6144-token multiview attention at CFG batch 2; the
    turbo loop's masked kernel for that multiview attention under the
    grid-32 voxel mask and the 16² level's 1536 tokens under the grid-16
    mask. With ``fp32`` the stack (UNet and VAE, on both devices) is fp32,
    as load_paint_pipeline(dtype="fp32") builds it, so the kernels' fp32
    instances run. The check fails unless the path's kernels ran on the
    card."""
    import dataclasses

    import numpy as np
    import torch

    from hunyuan3d2_tpu_torch import Hunyuan3DPaintPipeline
    from hunyuan3d2_tpu_torch.models import paint_unet
    from hunyuan3d2_tpu_torch.ops.nn import build

    view, steps = 64, 2
    ucfg = dataclasses.replace(paint_unet.TINY, block_out_channels=(64, 128),
                               attention_head_dim=64)
    rs = np.random.RandomState(0)
    lat = (1, 6, view // 2, view // 2, 4)  # the tiny VAE downsamples by 2
    init = rs.randn(*lat).astype(np.float32)
    noises = [rs.randn(*lat).astype(np.float32) for _ in range(steps)]
    mesh = sphere_mesh(32)
    pipes = {dev: Hunyuan3DPaintPipeline.init_random(size="tiny", view_size=view,
                                                     render_size=256, texture_size=128,
                                                     num_inference_steps=steps, device=dev,
                                                     seed=1).set_turbo(turbo)
             for dev in ("cpu", "cuda")}
    a, b = (pipes[dev].models["multiview_model"].pipeline for dev in ("cpu", "cuda"))
    a.unet = build(paint_unet.UNet2p5D, ucfg, device="cpu",
                   generator=torch.Generator().manual_seed(2))
    b.unet = build(paint_unet.UNet2p5D, ucfg, device="cuda")
    b.unet.load_state_dict(a.unet.state_dict())
    b.vae.load_state_dict(a.vae.state_dict())
    if fp32:
        for inner in (a, b):
            inner.unet.float()
            inner.vae.float()
    counters = _kernel_counters()
    outs = {}
    for dev, pipe in pipes.items():
        for fn in counters.values():
            fn.launches = 0
        outs[dev] = pipe(mesh, test_image(), init_latents=init, step_noises=noises)
    launches = {name: fn.launches for name, fn in counters.items()}
    x = outs["cuda"].texture.astype(np.float64)
    y = outs["cpu"].texture.astype(np.float64)
    corr = np.corrcoef(x.ravel(), y.ravel())[0, 1]
    mad = np.abs(x - y).mean()
    name = ("texture check" if turbo else "texture check standard") + (" fp32" if fp32 else "")
    log(f"{name} (UNet {ucfg.block_out_channels} head 64, {view}² views, 128² "
        f"texture, {'LCM' if turbo else 'EulerAncestral + CFG 2.0'} {steps} steps): card vs "
        f"CPU texture corr {corr:.6f}, mean |diff| {mad:.3f} levels, card launches "
        f"{json.dumps(launches)}")
    for kernel in ("flash_attention", "rasterize") + (("flash_attention_masked",) if turbo
                                                      else ()):
        check(launches[kernel] > 0, f"{name}: kernel {kernel} did not run on the card")
    check(np.array_equal(outs["cuda"].uv, outs["cpu"].uv) and corr >= 0.99 and mad <= 3.0,
          f"{name}: the card's textured mesh disagrees with the CPU's")


def dinov2_large_check():
    """The plain-MLP DINOv2 at DINOv2-L's published widths (1024 wide, 24
    layers, 16 heads of 64, fc1 → exact GELU → fc2 at 4096, 518² → 1370
    tokens; random bf16 weights from a seed) through the conditioner's
    encode_image on the card, where its attention launches kernel 1 once a
    layer, against the same weights on the CPU (plain twins)."""
    import numpy as np
    import torch

    from hunyuan3d2_tpu_torch.models import conditioner as cond_lib
    from hunyuan3d2_tpu_torch.models import dinov2
    from hunyuan3d2_tpu_torch.ops.flash_attention import flash_attention
    from hunyuan3d2_tpu_torch.ops.nn import build

    cfg = cond_lib.DinoEncoderConfig(
        dino=dinov2.DinoConfig(hidden_size=1024, num_layers=24, num_heads=16,
                               use_swiglu_ffn=False, mlp_ratio=4), image_size=518)
    encoders = {dev: cond_lib.SingleImageEncoder(build(cond_lib.DinoImageEncoder, cfg, device=dev))
                for dev in ("cuda", "cpu")}
    encoders["cpu"].load_state_dict(encoders["cuda"].state_dict())
    img = np.asarray(test_image().convert("RGB")).astype(np.float32)[None] / 127.5 - 1.0
    with torch.no_grad():
        encoders["cuda"].encode_image(img)            # warm
        torch.cuda.synchronize()
        flash_attention.launches = 0
        t0 = time.perf_counter()
        card = encoders["cuda"].encode_image(img)["main"]
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = flash_attention.launches
        cpu = encoders["cpu"].encode_image(img)["main"]
    x, y = card.float().cpu().numpy(), cpu.float().numpy()
    corr = np.corrcoef(x.ravel(), y.ravel())[0, 1]
    err = np.abs(x - y).max() / np.abs(y).max()
    log(f"dinov2-L check (plain MLP, 1024 wide, 24 layers, 16 heads, 518²): tokens "
        f"{list(card.shape)}, card {ms:.2f} ms, {launches} kernel-1 launches, card vs CPU corr "
        f"{corr:.6f}, max |diff| {err:.4f} of the largest")
    check(tuple(card.shape) == (1, 1370, 1024) and np.isfinite(x).all(),
          "dinov2-L check: bad tokens")
    check(launches == 24, f"dinov2-L check: {launches} kernel-1 launches, 24 expected")
    check(corr >= 0.99, f"dinov2-L check: card vs CPU corr {corr}")


def _round_to_fp16(modules):
    """Round every tensor of ``modules`` ({top: module}) through fp16 in place
    and return the fp16 tensors under their checkpoint keys (on the host):
    what a model.fp16.safetensors holds, and what loading it gives back."""
    import torch

    sd = {}
    with torch.no_grad():
        for top, module in modules.items():
            for k, t in module.state_dict().items():
                h = t.half()
                t.copy_(h)
                sd[f"{top}.{k}" if top else k] = h.cpu().contiguous()
    return sd


def _same_tensors(name, loaded, source):
    """Every tensor of ``loaded`` equals ``source``'s bit for bit (dtype too)."""
    import torch

    a, b = loaded.state_dict(), source.state_dict()
    check(a.keys() == b.keys(), f"{name}: the loaded module's keys differ")
    for k in a:
        check(a[k].dtype == b[k].dtype and a[k].is_cuda and torch.equal(a[k], b[k]),
              f"{name}: {k} differs from the written checkpoint")
    return len(a)


def _write_checkpoints(root, shape, paint):
    """The published layouts under ``root``: the shape stack's config.yaml and
    model.fp16.safetensors, the paint stack's unet/ and vae/ with their
    config.json and diffusion_pytorch_model.safetensors. Returns bytes
    written per stack."""
    import safetensors.torch
    import yaml

    def save(tensors, path):
        safetensors.torch.save_file(tensors, path)
        return os.path.getsize(path)

    sub = os.path.join(root, "hunyuan3d-dit-v2-mini")
    os.makedirs(sub)
    c, v = shape.model_cfg, shape.vae.cfg
    d = shape.conditioner.main.cfg
    config = {
        "name": "hunyuan3d-dit-v2-mini",
        "model": {"target": "hy3dgen.shapegen.models.Hunyuan3DDiT", "params": {
            "in_channels": c.in_channels, "context_in_dim": c.context_in_dim,
            "hidden_size": c.hidden_size, "mlp_ratio": c.mlp_ratio, "num_heads": c.num_heads,
            "depth": c.depth, "depth_single_blocks": c.depth_single_blocks, "axes_dim": [64],
            "theta": 10000, "qkv_bias": c.qkv_bias, "guidance_embed": c.guidance_embed}},
        "vae": {"target": "hy3dgen.shapegen.models.ShapeVAE", "params": {
            "num_latents": v.num_latents, "embed_dim": v.embed_dim, "num_freqs": v.num_freqs,
            "include_pi": v.include_pi, "heads": v.heads, "width": v.width,
            "num_decoder_layers": v.num_decoder_layers, "qkv_bias": v.qkv_bias,
            "qk_norm": True, "scale_factor": v.scale_factor}},
        "conditioner": {"target": "hy3dgen.shapegen.models.conditioner.SingleImageEncoder",
                        "params": {"main_image_encoder": {"type": "DinoImageEncoder", "kwargs": {
                            "config": {"hidden_size": d.dino.hidden_size,
                                       "num_hidden_layers": d.dino.num_layers,
                                       "num_attention_heads": d.dino.num_heads,
                                       "patch_size": d.dino.patch_size, "use_swiglu_ffn": True},
                            "image_size": d.image_size}}}},
        "scheduler": {"target": "hy3dgen.shapegen.schedulers.FlowMatchEulerDiscreteScheduler",
                      "params": {"num_train_timesteps": 1000}},
        "image_processor": {"target": "hy3dgen.shapegen.preprocessors.ImageProcessorV2",
                            "params": {"size": 512, "border_ratio": 0.15}},
    }
    with open(os.path.join(sub, "config.yaml"), "w") as fh:
        yaml.safe_dump(config, fh)
    sizes = {"shape": save(
        _round_to_fp16({"model": shape.model, "vae": shape.vae,
                        "conditioner": shape.conditioner}),
        os.path.join(sub, "model.fp16.safetensors"))}
    sizes["paint"] = _write_paint_checkpoint(root, paint.models["multiview_model"].pipeline)
    return sizes


def _write_paint_checkpoint(root, inner):
    """The paint stack ``inner`` (a HunyuanPaintPipeline) as the published
    paint-turbo layout under ``root``: unet/ and vae/, each a config.json
    and a diffusion_pytorch_model.safetensors rounded to fp16. Returns the
    bytes written."""
    import safetensors.torch

    u, s = inner.unet.cfg, inner.vae.cfg
    parts = {"unet": (inner.unet, {"block_out_channels": list(u.block_out_channels),
                                   "layers_per_block": u.layers_per_block,
                                   "cross_attention_dim": u.cross_attention_dim,
                                   "out_channels": u.out_channels,
                                   "norm_num_groups": u.norm_num_groups}),
             "vae": (inner.vae, {"block_out_channels": list(s.block_out_channels),
                                 "layers_per_block": s.layers_per_block,
                                 "latent_channels": s.latent_channels,
                                 "scaling_factor": s.scaling_factor})}
    total = 0
    for part, (module, cfg) in parts.items():
        d = os.path.join(root, "hunyuan3d-paint-v2-0-turbo", part)
        os.makedirs(d)
        with open(os.path.join(d, "config.json"), "w") as fh:
            json.dump(cfg, fh)
        path = os.path.join(d, "diffusion_pytorch_model.safetensors")
        safetensors.torch.save_file(_round_to_fp16({"": module}), path)
        total += os.path.getsize(path)
    return total


def _log_postprocess(stages):
    """Log faces in and out of each postprocess stage the server runs."""
    from hunyuan3d2_tpu_torch.geometry import postprocess

    for name in ("FloaterRemover", "DegenerateFaceRemover", "FaceReducer"):
        cls = getattr(postprocess, name)
        orig = cls.__call__

        def call(self, mesh, *args, _orig=orig, _name=name, **kwargs):
            out = _orig(self, mesh, *args, **kwargs)
            stages.append((_name, len(mesh.faces), len(out.faces)))
            return out

        cls.__call__ = call


def _post(url, payload, timeout=600):
    import urllib.request

    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.read()


def _glb_back(name, data, filename):
    """Write a served GLB under tmp/, read it back and check it."""
    import numpy as np

    from hunyuan3d2_tpu_torch.geometry.mesh import Mesh

    check(data[:4] == b"glTF", f"{name}: the answer is not a GLB")
    path = os.path.join(ROOT, "tmp", filename)
    with open(path, "wb") as fh:
        fh.write(data)
    mesh = Mesh.load(path)
    check(len(mesh.faces) > 0 and mesh.faces.min() >= 0
          and mesh.faces.max() < len(mesh.vertices) and np.isfinite(mesh.vertices).all(),
          f"{name}: the GLB does not read back as a mesh")
    return mesh


def served_path():
    """Checkpoints on disk → from_pretrained → the API server → four
    requests, at full width, through the user's entry points."""
    import base64
    import io
    import threading
    import urllib.request

    import numpy as np
    import torch

    from hunyuan3d2_tpu_torch import Hunyuan3DDiTFlowMatchingPipeline, Hunyuan3DPaintPipeline
    from hunyuan3d2_tpu_torch.apps import api_server
    from hunyuan3d2_tpu_torch.utils.timer import LAST_TIMINGS

    root = os.path.join(ROOT, "tmp", "served_checkpoints")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(os.path.join(ROOT, "tmp"), exist_ok=True)
    try:
        src = Hunyuan3DDiTFlowMatchingPipeline.init_random(size="mini", dino="giant",
                                                           device="cuda", seed=7)
        src_paint = Hunyuan3DPaintPipeline.init_random(size="default", view_size=512,
                                                       render_size=2048, texture_size=2048,
                                                       device="cuda", seed=7)
        t0 = time.perf_counter()
        sizes = _write_checkpoints(root, src, src_paint)
        log(f"served: wrote the checkpoints in {time.perf_counter() - t0:.2f} s: "
            f"hunyuan3d-dit-v2-mini {sizes['shape']} bytes, hunyuan3d-paint-v2-0-turbo "
            f"{sizes['paint']} bytes (random weights, seed 7, rounded to fp16)")

        t0 = time.perf_counter()
        pipe = Hunyuan3DDiTFlowMatchingPipeline.from_pretrained(
            root, subfolder="hunyuan3d-dit-v2-mini", device="cuda")
        torch.cuda.synchronize()
        t_shape = time.perf_counter() - t0
        t0 = time.perf_counter()
        paint = Hunyuan3DPaintPipeline.from_pretrained(
            root, subfolder="hunyuan3d-paint-v2-0-turbo", device="cuda")
        torch.cuda.synchronize()
        t_paint = time.perf_counter() - t0
        n = sum(_same_tensors(name, a, b) for name, a, b in (
            ("model", pipe.model, src.model), ("vae", pipe.vae, src.vae),
            ("conditioner", pipe.conditioner, src.conditioner),
            ("unet", paint.models["multiview_model"].pipeline.unet,
             src_paint.models["multiview_model"].pipeline.unet),
            ("paint vae", paint.models["multiview_model"].pipeline.vae,
             src_paint.models["multiview_model"].pipeline.vae)))
        check(paint.models["multiview_model"].pipeline.is_turbo, "served: paint not turbo")
        log(f"served: from_pretrained {t_shape:.2f} s (shape), {t_paint:.2f} s (paint); "
            f"{n} tensors equal bit for bit to the written ones")
        del src_paint

        # one image → mesh call, loaded against in-memory (same fp16-rounded weights)
        meshes = {}
        for name, p in (("in-memory", src), ("loaded", pipe)):
            p.enable_flashvdm(mc_algo="dmc")
            meshes[name] = p(test_image(), seed=1234, num_inference_steps=5,
                             guidance_scale=5.0, octree_resolution=256, num_chunks=65536)[0]
        a, b = meshes["loaded"], meshes["in-memory"]
        check(len(a.faces) == len(b.faces) and a.vertices.shape == b.vertices.shape
              and np.abs(a.vertices - b.vertices).max() <= 1e-5,
              "served: the loaded pipeline's mesh differs from the in-memory one's")
        log(f"served: loaded vs in-memory image → mesh: {len(a.faces)} faces each, max vertex "
            f"diff {np.abs(a.vertices - b.vertices).max():.3g}")
        del src, meshes, a, b
        gc.collect()
        torch.cuda.empty_cache()

        worker = api_server.ModelWorker.from_pipelines(pipe, paint, random_weights=True)
        server = api_server.serve(worker, "127.0.0.1", 0)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        base = f"http://127.0.0.1:{server.server_address[1]}"
        buf = io.BytesIO()
        test_image().save(buf, format="PNG")
        req = {"image": base64.b64encode(buf.getvalue()).decode(), "seed": 1234,
               "octree_resolution": 256, "num_inference_steps": 5, "guidance_scale": 5.0}
        stages = []
        _log_postprocess(stages)
        counters = _kernel_counters()
        try:
            torch.cuda.reset_peak_memory_stats()
            for fn in counters.values():
                fn.launches = 0
            # (a) image → mesh
            t0 = time.perf_counter()
            mesh = _glb_back("served (a)", _post(base + "/generate", req), "chip_smoke_served.glb")
            log(f"served (a) /generate: {time.perf_counter() - t0:.3f} s, {len(mesh.faces)} "
                f"faces, stages {json.dumps({k: round(LAST_TIMINGS[k], 4) for k in ('Preprocess', 'Encode Cond', 'Diffusion Sampling', 'Volume Decoding')})}")

            # the shape stack to the host and back
            stack = sum(t.numel() * t.element_size() for m in (pipe.model, pipe.vae,
                                                                pipe.conditioner)
                        for t in m.state_dict().values())
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            pipe.offload_to_host()
            torch.cuda.synchronize()
            offloaded = torch.cuda.memory_allocated()
            pipe.restore_to_device()
            torch.cuda.synchronize()
            restored = torch.cuda.memory_allocated()
            log(f"served: offload_to_host: device memory {before / 2 ** 30:.3f} → "
                f"{offloaded / 2 ** 30:.3f} GiB (shape stack {stack / 2 ** 30:.3f} GiB); "
                f"restore_to_device → {restored / 2 ** 30:.3f} GiB")
            check(before - offloaded >= stack, "served: offload freed less than the shape stack")

            # (b) image → postprocess → paint-turbo → textured GLB
            t0 = time.perf_counter()
            tex = _glb_back("served (b)", _post(base + "/generate", {**req, "texture": True}),
                            "chip_smoke_served_textured.glb")
            check(tex.uv is not None and tex.texture is not None
                  and tex.texture.shape == (2048, 2048, 3), "served (b): no 2048² texture")
            log(f"served (b) /generate texture: {time.perf_counter() - t0:.3f} s, "
                f"{len(tex.faces)} faces; postprocess (stage, faces in, faces out) "
                f"{json.dumps(stages)}; stages {json.dumps({k: round(LAST_TIMINGS[k], 4) for k in ('Diffusion Sampling', 'Volume Decoding', 'FloaterRemover', 'DegenerateFaceRemover', 'FaceReducer', 'Cond Maps (device)', 'Multiview Diffusion (device)', *UNWRAP_STAGES, 'Bake Geometry (device)', 'Texture Baking (device)', 'Texture Inpaint')})}")
            unwrap_ran_in_worker("served (b)", paint)

            # (c) /send, then /status until done
            t0 = time.perf_counter()
            uid = json.loads(_post(base + "/send", req))["uid"]
            while True:
                with urllib.request.urlopen(f"{base}/status/{uid}", timeout=60) as r:
                    st = json.loads(r.read())
                if st["status"] != "processing":
                    break
                time.sleep(0.05)
            check(st["status"] == "completed", f"served (c): job {uid} ended {st}")
            sent = _glb_back("served (c)", base64.b64decode(st["model_base64"]),
                             "chip_smoke_served_sent.glb")
            log(f"served (c) /send + /status: {time.perf_counter() - t0:.3f} s, "
                f"{len(sent.faces)} faces")
            # (d) text → image (the tiny random-weight t2i the app builds) → mesh
            t0 = time.perf_counter()
            text = _glb_back("served (d)", _post(base + "/generate", {
                "text": "a wooden chair", "seed": 5, "octree_resolution": 256,
                "num_inference_steps": 5, "guidance_scale": 5.0}), "chip_smoke_served_text.glb")
            built = worker.pipeline_t2i.backend.pipe
            check(built.resolution == 64 and built.device.type == "cuda",
                  "served (d): not the tiny random-weight t2i pipeline on the card")
            stages_d = {k: round(LAST_TIMINGS[k], 4) for k in (
                "T2I Text States", "T2I Denoising", "T2I VAE Decode", "Diffusion Sampling",
                "Volume Decoding")}
            log(f"served (d) /generate text: {time.perf_counter() - t0:.3f} s, "
                f"{len(text.faces)} faces, stages {json.dumps(stages_d)}")
            launches = {name: fn.launches for name, fn in counters.items()}
            log(f"served: launches {json.dumps(launches)}, peak memory "
                f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=60)
        for name in ("flash_attention", "flash_attention_masked", "fused_geo_decode",
                     "rasterize"):
            check(launches[name] > 0, f"served: kernel {name} was never launched")
        del worker, pipe, paint
        gc.collect()
        torch.cuda.empty_cache()
        return launches
    finally:
        shutil.rmtree(root, ignore_errors=True)


def text_to_mesh_path():
    """Text → image → mesh at full width through the user's entry points:
    utils/text2image.HunyuanDiTPipeline over the port's HunyuanDiT v1.1
    pipeline (FULL without style/meta conditioning: 1408 wide, 16 heads of
    88, 40 blocks, PAG on blocks 16-19; the t2i SD VAE, scaling 0.13025;
    1024², 25 DDPM steps, CFG 5.0, PAG 1.3; random weights from seed 0 and
    the pseudo text embeddings), then rembg and the mini shape stack
    (DINOv2-giant, 5 steps, FlashVDM at octree 256). Run cold and warm;
    stage times, peak memory and the warm run's launch counts; the image is
    checked and the GLB written and read back. Returns the warm launches."""
    import numpy as np
    import torch

    from hunyuan3d2_tpu_torch.pipelines.shapegen import Hunyuan3DDiTFlowMatchingPipeline
    from hunyuan3d2_tpu_torch.pipelines.t2i import HunyuanDiTTorchPipeline
    from hunyuan3d2_tpu_torch.utils.rembg import BackgroundRemover
    from hunyuan3d2_tpu_torch.utils.text2image import HunyuanDiTPipeline
    from hunyuan3d2_tpu_torch.utils.timer import LAST_TIMINGS

    os.environ["HY3D_CAP_ACTIVES"] = "1"
    t0 = time.perf_counter()
    t2i = HunyuanDiTTorchPipeline.init_random(size="full", resolution=1024,
                                              num_inference_steps=25, device="cuda", seed=0)

    def backend(prompt, negative_prompt, seed):
        return t2i(prompt, seed=seed, negative_prompt=negative_prompt)

    front = HunyuanDiTPipeline(backend=backend, device="cuda")
    shape = Hunyuan3DDiTFlowMatchingPipeline.init_random(size="mini", dino="giant",
                                                         device="cuda", seed=0)
    shape.enable_flashvdm(mc_algo="dmc")
    rembg = BackgroundRemover()
    torch.cuda.synchronize()
    n = sum(p.numel() for p in t2i.transformer.parameters())
    log(f"text_to_mesh: stacks up in {time.perf_counter() - t0:.2f} s (HunyuanDiT v1.1 "
        f"{n} parameters, t2i SD VAE, DINOv2-giant, mini DiT, mini ShapeVAE; random weights, "
        f"seed 0)")
    counters = _kernel_counters()
    for run in ("cold", "warm"):
        torch.cuda.reset_peak_memory_stats()
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        image = front("一只可爱的猫", seed=0)
        torch.cuda.synchronize()
        t_image = time.perf_counter() - t0
        stages = {k: round(LAST_TIMINGS[k], 4)
                  for k in ("T2I Text States", "T2I Denoising", "T2I VAE Decode")}
        t1 = time.perf_counter()
        cut = rembg(image)
        t_rembg = time.perf_counter() - t1
        t1 = time.perf_counter()
        mesh = shape(cut, seed=1234, num_inference_steps=5, guidance_scale=5.0,
                     octree_resolution=256, num_chunks=65536)[0]
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        stages.update({"rembg": round(t_rembg, 4), "shape": round(time.perf_counter() - t1, 4)})
        launches = {k: fn.launches for k, fn in counters.items()}
        arr = np.asarray(image)
        step_ms = 1e3 * LAST_TIMINGS["T2I Denoising"] / t2i.num_inference_steps
        log(f"text_to_mesh {run}: {elapsed:.3f} s (image {t_image:.3f} s, denoise "
            f"{step_ms:.1f} ms a step), stages "
            f"{json.dumps(stages)}, image {image.size} mean {arr.mean():.2f} std "
            f"{arr.std():.2f}, {len(mesh.faces)} faces, launches {json.dumps(launches)}, peak "
            f"memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
        check(image.size == (1024, 1024) and arr.shape == (1024, 1024, 3),
              "text_to_mesh: not a 1024² RGB image")
        check(arr.std() > 1.0 and len(np.unique(arr.reshape(-1, 3), axis=0)) > 16,
              "text_to_mesh: the image is constant")
        check(len(mesh.faces) > 0 and np.isfinite(mesh.vertices).all(), "text_to_mesh: bad mesh")
    for name in ("flash_attention", "fused_geo_decode"):
        check(launches[name] > 0, f"text_to_mesh: kernel {name} was never launched")
    write_glb("text_to_mesh", mesh, "chip_smoke_text.glb")
    del t2i, front, shape
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def t2i_agreement():
    """The TINY t2i pipeline at 64² on the card against the same pipeline on
    the CPU: the same weights (drawn on the CPU), the same pseudo text
    embeddings and the same injected noise; image corr ≥ 0.99, mean |Δ|
    ≤ 3 levels, and finite latents."""
    import numpy as np
    import torch

    from hunyuan3d2_tpu_torch.pipelines.t2i import HunyuanDiTTorchPipeline

    steps = 4
    cpu = HunyuanDiTTorchPipeline.init_random(resolution=64, num_inference_steps=steps,
                                              device="cpu", seed=3)
    card = HunyuanDiTTorchPipeline.init_random(resolution=64, num_inference_steps=steps,
                                               device="cuda", seed=4)
    card.transformer.load_state_dict(cpu.transformer.state_dict())
    card.vae.load_state_dict(cpu.vae.state_dict())
    rs = np.random.RandomState(0)
    init = rs.randn(1, 32, 32, 4).astype(np.float32)
    noises = [rs.randn(1, 32, 32, 4).astype(np.float32) for _ in range(steps)]
    ctx, pooled = card.context("a teapot")
    lat = card.denoise(ctx, pooled, 32, 32, init, noises)
    check(bool(torch.isfinite(lat).all().item()), "t2i check: non-finite latents on the card")
    x, y = (np.asarray(p("a teapot", seed=0, init_latents=init, step_noises=noises),
                       np.float64) for p in (card, cpu))
    corr = np.corrcoef(x.ravel(), y.ravel())[0, 1]
    mad = np.abs(x - y).mean()
    log(f"t2i check (TINY HunyuanDiT + TINY VAE, 64², {steps} DDPM steps, CFG + PAG): card vs "
        f"CPU image corr {corr:.6f}, mean |diff| {mad:.3f} levels, image std {x.std():.2f}")
    check(x.std() > 1.0 and corr >= 0.99 and mad <= 3.0,
          "t2i check: the card's image disagrees with the CPU's")


def image_runs(name, fn, stage, steps, expect):
    """Drive ``fn()`` cold and warm with the kernels' counts set to 0 just
    before each run; log the time, the denoise stage's time a step, peak
    memory and the launches; check the output image (PIL) against
    ``expect`` = (width, height). Returns (the warm image, its launches)."""
    import numpy as np
    import torch

    from hunyuan3d2_tpu_torch.utils.timer import LAST_TIMINGS

    counters = _kernel_counters()
    for run in ("cold", "warm"):
        torch.cuda.reset_peak_memory_stats()
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        image = fn()
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        launches = {n: c.launches for n, c in counters.items()}
        arr = np.asarray(image)
        log(f"{name} {run}: {elapsed:.3f} s ({stage} {LAST_TIMINGS[stage]:.3f} s, "
            f"{1e3 * LAST_TIMINGS[stage] / steps:.1f} ms a step), image {image.size} mean "
            f"{arr.mean():.2f} std {arr.std():.2f}, launches {json.dumps(launches)}, peak memory "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
        check(image.size == expect and arr.shape == (expect[1], expect[0], 3)
              and arr.dtype == np.uint8, f"{name}: not a {expect} RGB image")
        check(arr.std() > 1.0 and len(np.unique(arr.reshape(-1, 3), axis=0)) > 16,
              f"{name}: the image is constant")
    return image, launches


def delight_path():
    """The delight stage at full width (path delight): utils/dehighlight's
    Light_Shadow_Remover over DelightPipeline(size="full") (IP2P_UNET, SD1.5
    geometry with an 8-channel conv_in and 8 heads of 40/80/160 channels,
    ≈ 0.86 B parameters; SD VAE DEFAULT; random weights from seed 0) on one
    512² RGBA image, 50 EulerAncestral steps at guidance 1.0 / image
    guidance 1.5 (the reference's call). Returns the warm launches."""
    import numpy as np
    import torch

    from hunyuan3d2_tpu_torch.pipelines.delight import DelightPipeline
    from hunyuan3d2_tpu_torch.utils.dehighlight import Light_Shadow_Remover

    t0 = time.perf_counter()
    pipe = DelightPipeline.init_random(size="full", resolution=512, num_inference_steps=50,
                                       device="cuda", seed=0)
    remover = Light_Shadow_Remover(pipeline=pipe)
    torch.cuda.synchronize()
    n = sum(p.numel() for p in pipe.unet.parameters())
    log(f"delight: stack up in {time.perf_counter() - t0:.2f} s (IP2P UNet {n} parameters, "
        f"SD VAE DEFAULT, random weights, seed 0)")
    image = test_image()
    out, launches = image_runs("delight", lambda: remover(image), "Delight Denoising", 50,
                               (512, 512))
    arr, alpha = np.asarray(out), np.asarray(image)[..., 3]
    check((arr[alpha == 0] == 255).all(), "delight: the background is not composited on white")
    del pipe, remover
    return launches


def upscale_path():
    """The x4 upscale stage at full width (path upscale): utils/imagesuper's
    Image_Super_Net over UpscalePipeline(size="full") (X4_UNET: 256/512/512/
    1024 channels, 8 heads, cross 1024, 7-channel conv_in, noise-level class
    table; X4_VAE f = 4; random weights from seed 0) on one 128² image → 512²,
    5 DDIM steps at CFG 9.0, noise level 20 (the reference's call). Kernel 1
    takes the 64² and 32² levels' self and cross attention (head size 64):
    10 transformer blocks × 2 a UNet call, 5 calls. Returns the warm
    launches."""
    import torch
    from PIL import Image

    from hunyuan3d2_tpu_torch.pipelines.upscale import UpscalePipeline
    from hunyuan3d2_tpu_torch.utils.imagesuper import Image_Super_Net

    t0 = time.perf_counter()
    pipe = UpscalePipeline.init_random(size="full", num_inference_steps=5, device="cuda", seed=0)
    net = Image_Super_Net(pipeline=pipe)
    torch.cuda.synchronize()
    n = sum(p.numel() for p in pipe.unet.parameters())
    log(f"upscale: stack up in {time.perf_counter() - t0:.2f} s (x4 UNet {n} parameters, "
        f"X4_VAE, random weights, seed 0)")
    image = test_image().convert("RGB").resize((128, 128), Image.LANCZOS)
    _, launches = image_runs("upscale", lambda: net(image), "Upscale Denoising", 5, (512, 512))
    check(launches["flash_attention"] == 100,
          f"upscale: {launches['flash_attention']} flash_attention launches, 100 expected")
    del pipe, net
    return launches


def align_path():
    """The align helpers at full width (path align): ControlNetSDPipeline
    (size="full", 512²: the SD1.5 UNet, the SD1.5 ControlNet, the PLUS_SD15
    resampler; random weights from seed 0, the adapter's to_k_ip / to_v_ip
    and the ControlNet's zero convs then seeded non-zero, and an image
    encoder that returns seeded [1, 257, 1280] states), driven through
    Img2img_Control_Ip_adapter (20 steps, CFG 8.0, IP scale 0.7) and then
    HesModel (img2img at strength 0.8 over 40 steps), each cold and warm.
    Returns the warm launches of both calls together."""
    import numpy as np
    import torch
    from PIL import Image

    from hunyuan3d2_tpu_torch.pipelines.align import ControlNetSDPipeline, HesModel
    from hunyuan3d2_tpu_torch.utils.align_img4tex import Img2img_Control_Ip_adapter

    t0 = time.perf_counter()
    pipe = ControlNetSDPipeline.init_random(size="full", resolution=512, device="cuda", seed=0)
    gen = torch.Generator(device="cuda").manual_seed(7)
    with torch.no_grad():
        for name, p in (list(pipe.unet.named_parameters())
                        + list(pipe.controlnet.named_parameters())):
            if "_ip." in name or name.startswith(("controlnet_down", "controlnet_mid")):
                p.copy_(torch.randn(p.shape, generator=gen, device="cuda") * 0.02)
    states = np.random.RandomState(8).randn(1, 257, 1280).astype(np.float32)
    pipe.image_encoder = lambda image: states
    torch.cuda.synchronize()
    n = sum(p.numel() for m in (pipe.unet, pipe.controlnet, pipe.resampler)
            for p in m.parameters())
    log(f"align: stack up in {time.perf_counter() - t0:.2f} s (SD1.5 UNet + ControlNet + "
        f"PLUS_SD15 resampler, {n} parameters; random weights, seed 0, adapter and zero convs "
        f"seeded non-zero)")
    image = test_image().convert("RGB")
    depth = Image.fromarray(np.asarray(image.convert("L")))
    aligner, hes = Img2img_Control_Ip_adapter(pipeline=pipe), HesModel(pipeline=pipe)
    _, first = image_runs("align", lambda: aligner("a chair", depth, image, "", height=512,
                                                   width=512, num_inference_steps=20),
                          "Align Denoising", 20, (512, 512))
    # img2img at strength 0.8 runs int(40 · 0.8) = 32 of the 40 steps
    _, second = image_runs("align HesModel", lambda: hes(image, depth, image), "Align Denoising",
                           32, (512, 512))
    del pipe, aligner, hes
    return {k: first[k] + second[k] for k in first}


def sdpa_yardstick(name, shape, dtype):
    """One timing of the port's plain sdpa (fp32 products and softmax) at
    an attention shape the flash kernel's gate refuses, beside
    F.scaled_dot_product_attention, with the bound."""
    import torch
    import torch.nn.functional as F

    from hunyuan3d2_tpu_torch.ops.attention import attention

    b, h, l, d = shape
    gen = torch.Generator(device="cuda").manual_seed(d)
    q, k, v = (torch.randn(b, h, l, d, generator=gen, device="cuda").to(dtype)
               for _ in range(3))
    ms = time_ms(lambda: attention(q, k, v), 5)
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(q, k, v), 20)
    flops = 4.0 * b * h * l * l * d
    kind = "bf16" if dtype == torch.bfloat16 else "fp32"
    bound_ms, by = bound(flops, 4 * q.numel() * q.element_size(), kind)
    log(f"{name} " + json.dumps(dict(
        shape=f"{list(shape)} {kind}", route="ops.attention.sdpa (fp32 products and softmax)",
        ms=ms, library_ms=lib_ms, bound_ms=bound_ms, bound_by=by,
        fp32_bound_ms=bound(flops, 0, "fp32")[0])))
    return dict(ms=ms, library_ms=lib_ms, bound_ms=bound_ms)


def secondary_agreement():
    """The three TINY pipelines on the card against the same weights and
    draws on the CPU (tools/card_agreement.py, which the card tests share),
    image corr ≥ 0.99 and mean |Δ| ≤ 3 levels: delight (32², 3 steps), the
    upscaler at head size 64 (channels (64, 128), 2 heads, a 64² image:
    kernel 1 takes its 32² level's and mid block's attention, which is
    checked), and align (text-to-image and img2img at strength 0.5, the
    adapter and the zero convs non-zero)."""
    from hunyuan3d2_tpu_torch.tools import card_agreement as ca

    def agree(name, a, b, extra=""):
        corr, mad, std = ca.image_agreement(a, b)
        log(f"{name}: card vs CPU image corr {corr:.6f}, mean |diff| {mad:.3f} levels, image "
            f"std {std:.2f}{extra}")
        check(ca.agrees(a, b), f"{name}: the card's image disagrees with the CPU's")

    agree("delight check (TINY, 32², 3 steps)", *ca.delight_images())
    a, b, launches = ca.upscale_images()
    agree("upscale check (head-64 TINY (64, 128), 64² → 256², 2 steps)", a, b,
          f", flash_attention launches {launches}")
    check(launches == ca.UPSCALE_FLASH_LAUNCHES,
          f"upscale check: {launches} flash_attention launches, "
          f"{ca.UPSCALE_FLASH_LAUNCHES} expected")
    for strength, a, b in ca.align_images():
        agree(f"align check (TINY, 32², 4 steps, strength {strength})", a, b)


def _err(g, r):
    """(max abs err, relative RMS err) of ``g`` against ``r``."""
    diff = g.double() - r.double()
    return diff.abs().max().item(), (diff.norm() / r.double().norm()).item()


def flash_grad_phase():
    """12a. Kernel 1's gradient: under autograd, the kernel's lse-keeping
    forward and the backward kernel (csrc/flash_attention_bwd.cu), each row's
    inputs from a generator seeded by its name. Rows: the DiT training shape
    [2,16,1882,64] bf16, the VAE's [1,16,512,64] fp32, a differentiable-
    surface decode chunk [1,16,65536,64] fp32 over 512 keys, and
    [1,8,4096,128] bf16 (off path, the second head size). Per row:
      * one forward and one backward launch per call, and no call of
        flash_attention_plain while they run;
      * dq, dk and dv against the plain twin's autograd (bf16:
        attention_check) and, on every row, against an fp64 evaluation of
        the gradient (tools/flash_fp32_error.attention_grad_fp64): the
        kernel's max abs error within 8x and its relative RMS error within
        4x the plain autograd's own (the forward's fp32 rule);
      * the kernel alone on the forward's o and lse against
        flash_attention_backward_plain on the same inputs (bf16:
        attention_check; fp32: 1e-4 of the largest value and a relative RMS
        of 1e-5), its lse against flash_attention_lse_plain's (1e-4: fp32
        logits summed in another order), and two calls bit for bit (no
        atomics);
      * forward + backward time beside the plain twin's and
        F.scaled_dot_product_attention's (bound: the 12·B·H·Lq·Lk·D
        operations of a forward and a backward that keep no scores, q, k, v,
        dO read and o, dq, dk, dv written once); the backward alone beside
        flash_attention_backward_plain and SDPA's backward (autograd.grad on
        its retained graph; bound: 10·B·H·Lq·Lk·D, a backward that keeps no
        scores recomputes S once); fp32 bounds at 3xTF32 on the TF32 tensor
        cores (bound_ms) and on the CUDA cores (bound_cuda_core_ms);
      * each pass's device time and TFLOP/s (pass_times).
    Returns (the forward + backward rows, the backward rows)."""
    import zlib

    import torch
    import torch.nn.functional as F

    from hunyuan3d2_tpu_torch.ops import flash_attention as fa
    from hunyuan3d2_tpu_torch.tools.flash_fp32_error import attention_grad_fp64
    from hunyuan3d2_tpu_torch.tools.profile_flash_bwd_variants import pass_times

    rows, bwd_rows = [], []
    for name, (b, h, lq, lk, d), dt in (
            ("dit train", (2, 16, 1882, 1882, 64), torch.bfloat16),
            ("vae", (1, 16, 512, 512, 64), torch.float32),
            ("diff surface chunk", (1, 16, 65536, 512, 64), torch.float32),
            ("d128", (1, 8, 4096, 4096, 128), torch.bfloat16)):
        gen = torch.Generator(device="cuda").manual_seed(zlib.crc32(name.encode()))
        q = torch.randn(b, h, lq, d, generator=gen, device="cuda").to(dt)
        k, v = (torch.randn(b, h, lk, d, generator=gen, device="cuda").to(dt) for _ in range(2))
        dout = torch.randn(b, h, lq, d, generator=gen, device="cuda").to(dt)
        scale = d ** -0.5
        label = f"flash_attention grad {name}"

        def run(fn):
            leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
            return torch.autograd.grad(fn(*leaves), leaves, dout)

        def sdpa(a, c, e):
            return F.scaled_dot_product_attention(a, c, e, scale=scale)

        plain_calls = []
        real_plain = fa.flash_attention_plain

        def counted(*args, **kwargs):
            plain_calls.append(1)
            return real_plain(*args, **kwargs)

        fa.flash_attention_plain = counted
        before, before_bwd = fa.flash_attention.launches, fa.flash_attention_backward.launches
        try:
            got = run(fa.flash_attention)
            torch.cuda.synchronize()
        finally:
            fa.flash_attention_plain = real_plain
        fwd_n = fa.flash_attention.launches - before
        bwd_n = fa.flash_attention_backward.launches - before_bwd
        check(fwd_n == 1 and bwd_n == 1 and not plain_calls,
              f"{label}: {fwd_n} forward and {bwd_n} backward launches, flash_attention_plain "
              f"called {len(plain_calls)} times")
        ref = run(real_plain)
        ref64 = attention_grad_fp64(q, k, v, dout, scale)
        torch.cuda.synchronize()
        errs = {}
        for gname, g, r, x64 in zip(("dq", "dk", "dv"), got, ref, ref64):
            check(torch.isfinite(g).all().item(), f"{label} {gname}: non-finite gradient")
            if dt == torch.bfloat16:
                err, _, rms, tol = attention_check(f"{label} {gname}", g, r, 2e-2)
            else:
                (err, rms), tol = _err(g, r), None
            (e64, r64), (t64, tr64) = _err(g, x64), _err(r, x64)
            check(e64 <= 8 * t64 and r64 <= 4 * tr64,
                  f"{label} {gname}: against fp64 max abs err {e64} (the plain autograd's "
                  f"{t64}, limit 8x), relative RMS err {r64} (the plain autograd's {tr64}, "
                  "limit 4x)")
            errs[gname] = dict(max_abs_err=err, rel_rms_err=rms, tol=tol,
                               fp64_max_abs_err=e64, fp64_rel_rms_err=r64,
                               plain_fp64_max_abs_err=t64, plain_fp64_rel_rms_err=tr64)
        del got, ref, ref64

        # the kernels alone: the lse-keeping forward and the backward on its o, lse
        o, lse = fa._launch_lse(q, k, v, scale)
        lse_ref = fa.flash_attention_lse_plain(q, k, v, scale)[1]
        lse_err = (lse - lse_ref).abs().max().item()
        check(lse_err <= 1e-4, f"{label}: lse max abs err {lse_err} (tol 1e-4)")
        del lse_ref
        first = fa.flash_attention_backward(q, k, v, o, lse, dout, scale)
        second = fa.flash_attention_backward(q, k, v, o, lse, dout, scale)
        twin = fa.flash_attention_backward_plain(q, k, v, o, lse, dout, scale)
        torch.cuda.synchronize()
        check(all(torch.equal(x, y) for x, y in zip(first, second)),
              f"{label}: two backward calls on the same inputs differ")
        twin_errs = {}
        for gname, g, r in zip(("dq", "dk", "dv"), first, twin):
            if dt == torch.bfloat16:
                err, _, rms, tol = attention_check(f"{label} {gname} (kernel vs twin)", g, r, 2e-2)
            else:
                (err, rms), tol = _err(g, r), 1e-4 * r.abs().max().item()
                check(err <= tol and rms <= 1e-5, f"{label} {gname} (kernel vs twin): max abs "
                      f"err {err} (tol {tol}), relative RMS err {rms} (tol 1e-5)")
            twin_errs[gname] = dict(max_abs_err=err, rel_rms_err=rms, tol=tol)
        del first, second, twin
        # the device time a call of each pass, with its TFLOP/s (fp32: of its
        # fp32-grade operations, against 165 TFLOP/s of 3xTF32)
        passes = pass_times(lambda: fa.flash_attention_backward(q, k, v, o, lse, dout, scale),
                            1.0 * b * h * lq * lk * d)
        log(f"{label} backward passes " + json.dumps(passes))

        # 20 calls a timing: forward + backward runs eager autograd, whose host
        # time can exceed the device's at these sizes; a longer loop averages
        # the host's jitter
        before = fa.flash_attention.launches
        ms = time_ms(lambda: run(fa.flash_attention), 20)
        per_call = (fa.flash_attention.launches - before) / 21
        plain_ms = time_ms(lambda: run(real_plain), 3)
        lib_ms = time_ms(lambda: run(sdpa), 20)
        bwd_ms = time_ms(lambda: fa.flash_attention_backward(q, k, v, o, lse, dout, scale), 20)
        bwd_plain_ms = time_ms(lambda: fa.flash_attention_backward_plain(q, k, v, o, lse, dout,
                                                                         scale), 3)
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        lib_out = sdpa(*leaves)
        bwd_lib_ms = time_ms(lambda: torch.autograd.grad(lib_out, leaves, dout,
                                                         retain_graph=True), 20)
        del lib_out, leaves
        work = 1.0 * b * h * lq * lk * d
        nbytes = 4 * (q.numel() + k.numel()) * q.element_size()
        bounds = row_bounds(12 * work, nbytes, dt)
        bwd_bounds = row_bounds(10 * work, nbytes + 4 * lse.numel(), dt)
        shape = f"{name} q {[b, h, lq, d]} k {[b, h, lk, d]} {str(dt).split('.')[-1]}"
        row = dict(shape=shape, what="forward + backward",
                   max_abs_err=max(e["max_abs_err"] for e in errs.values()), grads=errs,
                   launches_per_call=per_call, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                   **bounds)
        check(per_call == 1, f"{label}: {per_call} forward launches a call")
        bwd_row = dict(shape=shape, what="backward (q, k, v, o, lse, dO → dq, dk, dv)",
                       max_abs_err=max(e["max_abs_err"] for e in twin_errs.values()),
                       grads=twin_errs, lse_max_abs_err=lse_err, deterministic=True, ms=bwd_ms,
                       plain_ms=bwd_plain_ms, library_ms=bwd_lib_ms, passes=passes, **bwd_bounds)
        log("flash_attention grad " + json.dumps(row))
        log("flash_attention_backward " + json.dumps(bwd_row))
        rows.append(row)
        bwd_rows.append(bwd_row)
        del q, k, v, dout, o, lse
        torch.cuda.empty_cache()
    return rows, bwd_rows


# kernel 1's forward and backward instances by pass, dtype and template
# numbers; kernel 2's fp32 forward is flash_f32_kernel's kMask instance
# (template numbers ..., kLse 0, kMask 1), so the gate takes it too
KERNEL1 = re.compile(r"(flash|dkdv|dq)_(bf16|f32)_kernel(I(?:L[ib]\d+E)+)")


def kernel1_instance(mangled):
    """(pass, dtype, template numbers) of an instance of kernel 1 named by
    its mangled name, or None."""
    m = KERNEL1.search(mangled)
    if not m:
        return None
    return m.group(1), m.group(2), tuple(int(x) for x in re.findall(r"L[ib](\d+)E", m.group(3)))


def ptxas_instances(text):
    """Each kernel of an ``nvcc -Xptxas -v`` log: {mangled name:
    {"registers", "spill_stores", "spill_loads", "serialized"}};
    ``serialized`` is set by a C7514 warning (ptxas serialised the
    function's wgmma) that names the function or, where it names none,
    follows the function's "Compiling entry function" line."""
    out, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$.]+)'?", line)
        if m:
            cur = m.group(1)
            out.setdefault(cur, dict(registers=None, spill_stores=0, spill_loads=0,
                                     serialized=False))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and cur:
            out[cur]["spill_stores"], out[cur]["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            out[cur]["registers"] = int(m.group(1))
        if "C7514" in line:
            m = re.search(r"function '([\w$.]+)'", line)
            name = m.group(1) if m else cur
            out.setdefault(name, dict(registers=None, spill_stores=0, spill_loads=0,
                                      serialized=False))["serialized"] = True
    return out


def sass_mma_counts(library):
    """{mangled name: (HGMMA, HMMA)}: the wgmma and mma.sync instructions of
    each function in a library's SASS (cuobjdump -sass)."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    out = subprocess.run([tool, "-sass", library], capture_output=True, text=True, check=True,
                         timeout=600).stdout
    counts = {}
    for chunk in re.split(r"\n\s*Function : ", out)[1:]:
        name, _, body = chunk.partition("\n")
        counts[name.strip()] = (len(re.findall(r"\bHGMMA\b", body)),
                                len(re.findall(r"\bHMMA\b", body)))
    return counts


def kernel1_build_gate():
    """Phase 2's gate on kernels 1 and 2: ptxas's registers of each instance
    of kernel 1's backward passes (bf16 and fp32) and of the fp32 forward,
    unmasked (kernel 1) and masked (kernel 2), from the build logs beside
    the libraries, with each instance's wgmma (HGMMA) and mma.sync (HMMA)
    instructions in its SASS; a failure where one of them spills or has its
    wgmma serialised (C7514), or where an fp32 instance issues no HGMMA or
    any HMMA. The bf16 forwards are not gated."""
    from hunyuan3d2_tpu_torch.utils import cuda_build

    seen = masked = 0
    for library, gated in (("flash_attention_bwd", ("dkdv", "dq")), ("flash_attention", ("flash",))):
        path = cuda_build.library_path(library)
        with open(path + ".log") as fh:
            found = ptxas_instances(fh.read())
        sass = sass_mma_counts(path)
        for mangled, info in sorted(found.items()):
            inst = kernel1_instance(mangled)
            if inst is None or inst[0] not in gated or (inst[0] == "flash" and inst[1] != "f32"):
                continue
            seen += 1
            masked += inst[0] == "flash" and inst[2][-1] == 1 and len(inst[2]) == 6
            label = f"{inst[0]}_{inst[1]}_kernel<{', '.join(map(str, inst[2]))}>"
            hgmma, hmma = sass.get(mangled, (0, 0))
            log(f"  {library} ptxas: {label} {json.dumps(info)}, SASS: {hgmma} HGMMA, "
                f"{hmma} HMMA")
            check(info["spill_stores"] == 0 and info["spill_loads"] == 0,
                  f"{label}: ptxas spills ({info})")
            check(not info["serialized"], f"{label}: ptxas serialised its wgmma (C7514)")
            if inst[1] == "f32":
                check(hgmma > 0 and hmma == 0,
                      f"{label}: {hgmma} HGMMA and {hmma} HMMA in its SASS (wgmma only)")
    check(seen > 0, "the build logs name no instance of kernel 1's passes")
    check(masked == 2, f"{masked} masked fp32 instances in the build log, 2 expected (D = 64, 128)")


def _zero_counters():
    counters = _kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    return counters


def train_path():
    """12b. The mini DiT at full width trained through the user's entry
    points (training.make_train_step, io.pytree_io) with random bf16
    weights (seed 0): 10 AdamW steps; the weights and optimizer state saved
    at step 5 and loaded into a fresh model and optimizer, whose last 5
    steps must give the unbroken run's weights within 1e-5; the resumed
    run's last step traced. Returns the path's launches (both runs)."""
    import statistics

    import torch

    from hunyuan3d2_tpu_torch.io.pytree_io import load_pytree, save_pytree
    from hunyuan3d2_tpu_torch.models import dit
    from hunyuan3d2_tpu_torch.ops.nn import build
    from hunyuan3d2_tpu_torch.training import make_train_step
    from hunyuan3d2_tpu_torch.utils import profiling

    gen = torch.Generator(device="cuda").manual_seed(11)
    lat = torch.randn(2, 512, 64, generator=gen, device="cuda")
    cond = torch.randn(2, 1370, 1536, generator=gen, device="cuda").to(torch.bfloat16)
    draws = [(torch.randn(2, 512, 64, generator=gen, device="cuda"),
              torch.rand(2, generator=gen, device="cuda")) for _ in range(10)]

    def model(seed):
        return build(dit.Hunyuan3DDiT, dit.MINI, device="cuda",
                     generator=torch.Generator(device="cuda").manual_seed(seed))

    counters = _zero_counters()
    torch.cuda.reset_peak_memory_stats()
    unbroken = model(0)
    opt, step = make_train_step(unbroken)
    n_params = sum(p.numel() for p in unbroken.parameters())
    ckpt = os.path.join(ROOT, "tmp", "train_ckpt.safetensors")
    os.makedirs(os.path.dirname(ckpt), exist_ok=True)
    times, losses = [], []
    for i in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = float(step(lat, cond, *draws[i]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss)
        if i == 4:
            t1 = time.perf_counter()
            save_pytree(ckpt, {"params": unbroken.state_dict(), "opt": opt.state_dict()})
            save_s = time.perf_counter() - t1
    launches_unbroken = counters["flash_attention"].launches
    backward_unbroken = counters["flash_attention_backward"].launches
    peak = torch.cuda.max_memory_allocated()
    check(all(math.isfinite(x) for x in losses), f"train: non-finite loss in {losses}")
    check(launches_unbroken == 24 * 10 and backward_unbroken == 24 * 10,
          f"train: {launches_unbroken} flash_attention and {backward_unbroken} "
          "flash_attention_backward launches in 10 steps, 24 each a step expected")
    warm_ms = 1e3 * statistics.median(times[1:])
    log(f"train: mini DiT ({n_params / 1e6:.1f} M parameters, bf16), latents [2,512,64], "
        f"cond [2,1370,1536], AdamW: losses {[round(x, 5) for x in losses]}, step 1 "
        f"{1e3 * times[0]:.1f} ms, warm steps median {warm_ms:.2f} ms (min "
        f"{1e3 * min(times[1:]):.2f}, max {1e3 * max(times[1:]):.2f}), peak memory "
        f"{peak / 2 ** 30:.2f} GiB, flash_attention launches {launches_unbroken} "
        f"({launches_unbroken // 10} a step), flash_attention_backward launches "
        f"{backward_unbroken} ({backward_unbroken // 10} a step), checkpoint {os.path.getsize(ckpt) / 2 ** 30:.2f} "
        f"GiB saved in {save_s:.2f} s")

    resumed = model(1)
    opt2, step2 = make_train_step(resumed)
    t1 = time.perf_counter()
    restored = load_pytree(ckpt, target={"params": resumed.state_dict(),
                                         "opt": opt2.state_dict()})
    resumed.load_state_dict(restored["params"])
    opt2.load_state_dict(restored["opt"])
    del restored
    load_s = time.perf_counter() - t1
    os.unlink(ckpt)
    for i in range(5, 9):
        check(abs(float(step2(lat, cond, *draws[i])) - losses[i]) <= 1e-5 * abs(losses[i]),
              f"train: the resumed run's loss at step {i + 1} differs")
    torch.cuda.synchronize()
    trace_dir = os.path.join(ROOT, "tmp", "train_trace")
    t1 = time.perf_counter()
    with profiling.trace(trace_dir) as tr:
        step2(lat, cond, *draws[9])
    traced_ms = 1e3 * (time.perf_counter() - t1)
    worst = 0.0
    for (name, a), b in zip(unbroken.state_dict().items(), resumed.state_dict().values()):
        a, b = a.float(), b.float()
        worst = max(worst, ((a - b).abs() / (1e-5 + 1e-5 * b.abs())).max().item())
    check(worst <= 1.0, f"train: the resumed weights differ from the unbroken run's "
          f"({worst:.3g} of the 1e-5 tolerance)")
    top = profiling.top_device_ops(tr.path, 12)
    busy = profiling.device_busy(tr.path)
    spans = {}
    for e in tr.profile.key_averages():
        if e.key in ("loss", "backward", "optimizer"):
            us = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
            spans[e.key] = dict(host_ms=e.cpu_time_total / 1e3, device_ms=us / 1e3)
    log(f"train: resumed after step 5 (load {load_s:.2f} s): the weights after step 10 equal "
        f"the unbroken run's within 1e-5 ({worst:.3g} of the tolerance)")
    log("train trace " + json.dumps(dict(
        step_ms_traced=traced_ms, device_busy_ms=busy["busy_ms"], span_ms=busy["span_ms"],
        device_busy_share=busy["busy_ms"] / busy["span_ms"] if busy["span_ms"] else None,
        spans=spans, top_device_ops=top,
        device_memory_stats=profiling.device_memory_stats())))
    check(top, "train: the trace holds no device operation")
    launches = {n: fn.launches for n, fn in counters.items()}
    for n in ("flash_attention", "flash_attention_backward"):
        check(launches[n] == 24 * 15, f"train: {launches[n]} {n} launches in 15 steps")
    for n, c in launches.items():
        check(n in ("flash_attention", "flash_attention_backward") or c == 0,
              f"train: kernel {n} was launched off its path")
    del unbroken, resumed, opt, opt2
    return launches


def train_agreement_phase():
    """12c. One training step of a small DiT that passes kernel 1's gate
    (hidden 128 = 2 heads of 64, 1 + 1 blocks, latents [2,512,64], cond
    [2,77,1536]) on the card against the CPU, the same weights, data and
    draws (tools/card_agreement.py, which the card tests share)."""
    from hunyuan3d2_tpu_torch.tools import card_agreement as ca

    stats = ca.train_agreement(ca.train_step_pair())
    log("train check (card vs CPU, one step) " + json.dumps(stats))
    check(ca.train_agrees(stats), "train check: the card's step disagrees with the CPU's")


def diff_surface_path():
    """12d. The differentiable surface at full width through the user's
    entry points: the mini ShapeVAE (512 latents, 16 heads of 64; random
    weights, seed 3), decode_latents → compute_kv → decode_queries over a
    64³ grid in chunks of 65,536 queries (kernel 1, fp32), then
    differentiable_surface_nets and the mesh-space loss of
    tests/test_diff_surface.py (the surface toward z = 0.2), backpropagated
    into the geo decoder's weights; then a 17³ grid on the card against the
    CPU (tools/card_agreement.py). Returns the path's launches."""
    import numpy as np
    import torch

    from hunyuan3d2_tpu_torch.models import shapevae
    from hunyuan3d2_tpu_torch.tools import card_agreement as ca
    from hunyuan3d2_tpu_torch.volume.decoders import grid_coords_from_flat
    from hunyuan3d2_tpu_torch.volume.diff_surface import differentiable_surface_nets

    res, chunk = 64, 65536
    vae = shapevae.ShapeVAE.init_random(
        shapevae.MINI, device="cuda", generator=torch.Generator(device="cuda").manual_seed(3))
    vae.geo_decoder.requires_grad_(True)
    lat = torch.from_numpy((np.random.RandomState(3).randn(1, 512, 64) * 0.5)
                           .astype(np.float32)).cuda()
    pts = grid_coords_from_flat(torch.arange(res ** 3, device="cuda"), res, 1.01)[None]
    cap = shapevae.active_capacity(res - 1)
    counters = _zero_counters()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        hidden = vae.decode_latents(lat)
    k, v = vae.compute_kv(hidden)
    grid = torch.cat([vae.decode_queries(pts[:, i:i + chunk], k, v)
                      for i in range(0, res ** 3, chunk)], 1).reshape(res, res, res)
    verts, _, nq, count = differentiable_surface_nets(grid, capacity=cap,
                                                      face_capacity=shapevae.face_capacity(res - 1))
    mask = torch.arange(verts.shape[0], device="cuda") < count
    loss = (((verts[:, 2] - 0.2) ** 2) * mask).sum()
    torch.cuda.synchronize()
    fwd_s = time.perf_counter() - t0
    loss.backward()
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = {n: fn.launches for n, fn in counters.items()}
    grads = [p.grad for p in vae.geo_decoder.parameters()]
    gsum = sum(float(g.float().abs().sum()) for g in grads if g is not None)
    n, q = int(count), int(nq)
    log(f"diff_surface: mini VAE, {res}³ grid in {-(-res ** 3 // chunk)} chunks: {n} vertices, "
        f"{q} quads, loss {float(loss.detach()):.6g}, forward {1e3 * fwd_s:.1f} ms, forward + "
        f"backward {1e3 * total_s:.1f} ms, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB, geo-decoder |grad| sum "
        f"{gsum:.6g}, launches {json.dumps(launches)}")
    check(math.isfinite(float(loss.detach())), "diff_surface: non-finite loss")
    check(0 < n <= cap and q > 0, f"diff_surface: {n} vertices, {q} quads (capacity {cap})")
    check(all(g is not None and torch.isfinite(g).all().item() for g in grads),
          "diff_surface: a geo-decoder weight has no finite gradient")
    check(gsum > 0, "diff_surface: no gradient reached the geo-decoder weights")
    expected = shapevae.MINI.num_decoder_layers + -(-res ** 3 // chunk)
    check(launches["flash_attention"] == expected, f"diff_surface: "
          f"{launches['flash_attention']} flash_attention launches, {expected} expected")
    # the decode's chunks take a gradient; the latent transformer (no_grad) does not
    check(launches["flash_attention_backward"] == -(-res ** 3 // chunk), f"diff_surface: "
          f"{launches['flash_attention_backward']} flash_attention_backward launches, "
          f"{-(-res ** 3 // chunk)} expected")
    del vae, grid, verts, loss, k, v, hidden
    torch.cuda.empty_cache()
    stats = ca.diff_surface_agreement(ca.diff_surface_pair())
    log("diff_surface check (17³, card vs CPU) " + json.dumps(stats))
    check(ca.diff_surface_agrees(stats), "diff_surface check: the card disagrees with the CPU")
    return launches


def parallel_world_one(launches_mesh, launches_tex, sphere):
    """14a. The main path through its normal entry point on a one-rank NCCL
    process group: the mini stack at full width and the paint-turbo stack,
    each run unsharded, then after ``shard(make_mesh(1))``; the latents and
    the texture must equal the unsharded runs' bit for bit, and the kernels
    launch as often as on the unsharded paths (the warm runs of phases 4 and
    6). Returns the sharded runs' launches."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from hunyuan3d2_tpu_torch import Hunyuan3DPaintPipeline
    from hunyuan3d2_tpu_torch.parallel import make_mesh
    from hunyuan3d2_tpu_torch.parallel.mesh import init_process_group
    from hunyuan3d2_tpu_torch.pipelines.shapegen import Hunyuan3DDiTFlowMatchingPipeline
    from hunyuan3d2_tpu_torch.utils.timer import LAST_TIMINGS

    image = test_image()
    call = dict(num_inference_steps=5, guidance_scale=5.0)   # the main path's, seed 1234
    init_process_group("nccl", "cuda")
    try:
        pipe = Hunyuan3DDiTFlowMatchingPipeline.init_random(size="mini", dino="giant",
                                                            device="cuda", seed=0)
        pipe.enable_flashvdm(mc_algo="dmc")
        whole = pipe(image, output_type="latents", seed=1234, **call)
        check(pipe.shard(make_mesh(1)) is pipe, "parallel: shard() did not return the pipeline")
        lat = pipe(image, output_type="latents", seed=1234, **call)
        check(torch.equal(lat, whole), "parallel 14a: the sharded latents differ from the "
              f"unsharded run's (max |diff| {(lat - whole).abs().max().item()})")
        _, shape_launches = shape_run("parallel 14a image to mesh, make_mesh(1)", pipe, image,
                                      ("warm",), ("flash_attention", "fused_geo_decode"),
                                      octree_resolution=256, num_chunks=65536, **call)
        for n in ("flash_attention", "fused_geo_decode"):
            check(shape_launches[n] == launches_mesh[n], f"parallel 14a: {shape_launches[n]} {n} "
                  f"launches, the unsharded path {launches_mesh[n]}")
        log(f"parallel 14a: mini stack on a one-rank nccl group, latents equal the unsharded "
            f"run's bit for bit; launches {shape_launches['flash_attention']} flash_attention, "
            f"{shape_launches['fused_geo_decode']} fused_geo_decode (unsharded path "
            f"{launches_mesh['flash_attention']}, {launches_mesh['fused_geo_decode']})")
        del pipe
        gc.collect()
        torch.cuda.empty_cache()

        paint = Hunyuan3DPaintPipeline.init_random(size="default", view_size=512,
                                                   render_size=2048, texture_size=2048,
                                                   device="cuda", seed=0).set_turbo()
        textures = [paint(sphere, image).texture for _ in range(2)]
        check(paint.shard(make_mesh(1)) is paint, "parallel: shard() did not return the pipeline")
        counters = _zero_counters()
        out = paint(sphere, image)
        torch.cuda.synchronize()
        tex_launches = {n: fn.launches for n, fn in counters.items()}
        unwrap_ran_in_worker("parallel 14a textured", paint)
        log(f"parallel 14a textured: stages "
            f"{json.dumps({k: round(LAST_TIMINGS[k], 4) for k in UNWRAP_STAGES})}")
        check(np.array_equal(out.texture, textures[1]), "parallel 14a: the sharded texture "
              "differs from the unsharded run's (the two unsharded runs "
              f"{'agree' if np.array_equal(*textures) else 'differ too'})")
        for n in ("flash_attention", "flash_attention_masked", "rasterize"):
            check(tex_launches[n] == launches_tex[n], f"parallel 14a textured: {tex_launches[n]} "
                  f"{n} launches, the unsharded path {launches_tex[n]}")
        log(f"parallel 14a: paint-turbo stack, make_mesh(1): texture equals the unsharded run's "
            f"bit for bit; launches {json.dumps(tex_launches)}")
        del paint
    finally:
        dist.destroy_process_group()
    return shape_launches, tex_launches


def parallel_two_ranks(card):
    """14b. Two gloo ranks sharing the card (parallel.mesh.spawn, CUDA
    tensors; NCCL refuses two ranks on one device) through
    tools/parallel_check.py ``rank_checks``: the mini DiT at tp = 2, dp = 2
    and pp = 2, a tp = 2 train step and the sharded shape pipeline, each
    against one process; each rank's checks raise in the rank. Logs each
    run."""
    from hunyuan3d2_tpu_torch.parallel.mesh import spawn
    from hunyuan3d2_tpu_torch.tools.parallel_check import rank_checks

    t0 = time.perf_counter()
    ranks = spawn(rank_checks, 2, backend="gloo", device="cuda", args=(2,))
    log(f"parallel 14b: two gloo ranks sharing one card ({card}) in "
        f"{time.perf_counter() - t0:.1f} s; times are two ranks on one card, not a scaling "
        "figure")
    for r, res in enumerate(ranks):
        log(f"parallel 14b rank {r} " + json.dumps(res))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from hunyuan3d2_tpu_torch.utils import cuda_build

    os.environ["HF_HUB_OFFLINE"] = "1"   # nothing here may reach a model hub
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full fp32
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    logs = cuda_build.build(["flash_attention", "flash_attention_bwd", "flash_variants",
                             "geo_decode", "rasterize"])
    log(f"build: {time.perf_counter() - t0:.2f} s for {sorted(logs)} "
        f"into {os.path.relpath(cuda_build.BUILD_DIR, ROOT)}")
    for name, text in logs.items():
        for line in text.splitlines():
            if any(w in line for w in ("registers", "spill", "Compiling", "arning", "C75")):
                log(f"  {name}: {line.strip()}")
    kernel1_build_gate()

    gen = torch.Generator(device="cuda").manual_seed(0)
    sphere = sphere_mesh()
    with torch.no_grad():
        flash_rows = flash_phase()
        geo_rows, chain_mini, parts_mini = geo_phase(gen)
        tail_rows, chain_v20, parts_v20 = stream_phase(gen)
        masked_rows = masked_phase(gen, sphere)
        sweep_rows, sweep_best, launches_sweep = sweep_phase()
        raster_rows = raster_phase(sphere)
    pipe, launches_mesh = main_path()
    decode_agreement(pipe, gen)
    extractor_runs(pipe)
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    pipe, launches_v20 = v20_path()
    v20_decode_breakdown(pipe, gen)
    decode_agreement(pipe, gen)
    launches_mv = multiview_run(pipe)
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    launches_tex, launches_std = texture_paths(sphere)
    gc.collect()
    torch.cuda.empty_cache()
    launches_tex32 = texture_fp32_path(sphere)
    gc.collect()
    torch.cuda.empty_cache()
    texture_agreement(turbo=True)
    texture_agreement(turbo=True, fp32=True)
    texture_agreement(turbo=False)
    dinov2_large_check()
    gc.collect()
    torch.cuda.empty_cache()
    launches_served = served_path()
    gc.collect()
    torch.cuda.empty_cache()
    launches_text = text_to_mesh_path()
    with torch.no_grad():
        # HunyuanDiT's self-attention at 1024² CFG: head size 88, refused by
        # the flash kernel's gate
        sdpa_yardstick("hunyuan_dit self-attention", (2, 16, 4096, 88), torch.bfloat16)
    t2i_agreement()
    gc.collect()
    torch.cuda.empty_cache()
    launches_delight = delight_path()
    gc.collect()
    torch.cuda.empty_cache()
    launches_upscale = upscale_path()
    gc.collect()
    torch.cuda.empty_cache()
    launches_align = align_path()
    gc.collect()
    torch.cuda.empty_cache()
    with torch.no_grad():
        # the delight UNet's first level: CFG batch 3, 8 heads of 40 at 64²
        sdpa_yardstick("delight self-attention", (3, 8, 4096, 40), torch.bfloat16)
    secondary_agreement()
    gc.collect()
    torch.cuda.empty_cache()
    grad_rows, bwd_rows = flash_grad_phase()
    launches_train = train_path()
    gc.collect()
    torch.cuda.empty_cache()
    train_agreement_phase()
    launches_diff = diff_surface_path()
    gc.collect()
    torch.cuda.empty_cache()
    launches_par_mesh, launches_par_tex = parallel_world_one(launches_mesh, launches_tex, sphere)
    gc.collect()
    torch.cuda.empty_cache()
    parallel_two_ranks(card)
    by_path = {"image_to_mesh": launches_mesh, "image_to_mesh_v2_0_fast": launches_v20,
               "image_to_mesh_v2_0_multiview": launches_mv, "textured_glb": launches_tex,
               "textured_glb_standard": launches_std, "textured_glb_fp32": launches_tex32,
               "flash_sweep": launches_sweep,
               "served": launches_served, "text_to_mesh": launches_text,
               "delight": launches_delight, "upscale": launches_upscale,
               "align": launches_align, "train": launches_train,
               "diff_surface": launches_diff, "parallel_image_to_mesh": launches_par_mesh,
               "parallel_textured_glb": launches_par_tex}

    def entry(name, source, replaces, rows, main_row, path):
        """``launches`` is the count from ``path``'s warm run; every path's
        count is listed beside it."""
        r = rows[main_row]
        launches = by_path[path][name]
        check(launches > 0, f"kernel {name} was not launched on {path}")
        return dict(name=name, route="cuda", source=source, replaces=replaces,
                    launches=launches, launches_path=path,
                    launches_by_path={p: c.get(name, 0) for p, c in by_path.items()},
                    max_abs_err=max(x["max_abs_err"] for x in rows),
                    ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                    bound_by=r["bound_by"], library_ms=r["library_ms"], shape=r["shape"],
                    shapes=rows)

    kernels = [
        dict(entry("flash_attention", "hunyuan3d2_tpu_torch/csrc/flash_attention.cu",
                   "hunyuan3d2_tpu/ops/flash_attention.py:221", flash_rows, 4, "textured_glb"),
             grad_shapes=grad_rows),
        dict(entry("flash_attention_backward", "hunyuan3d2_tpu_torch/csrc/flash_attention_bwd.cu",
                   "hunyuan3d2_tpu/ops/flash_attention.py:221", bwd_rows, 0, "train"),
             note="the gradient of kernel 1's function; the TPU kernel had no backward (the "
                  "JAX package differentiates the plain attention, "
                  "hunyuan3d2_tpu/ops/attention.py:21)"),
        entry("flash_attention_masked", "hunyuan3d2_tpu_torch/csrc/flash_attention.cu",
              "hunyuan3d2_tpu/ops/flash_attention.py:159", masked_rows, 0, "textured_glb"),
        entry("fused_geo_decode", "hunyuan3d2_tpu_torch/csrc/geo_decode.cu",
              "hunyuan3d2_tpu/ops/geo_decoder_pallas.py:221", geo_rows, 1, "image_to_mesh"),
        entry("geo_mlp_tail", "hunyuan3d2_tpu_torch/csrc/geo_decode.cu",
              "hunyuan3d2_tpu/ops/geo_decoder_pallas.py:377", tail_rows, 1,
              "image_to_mesh_v2_0_fast"),
        entry("rasterize", "hunyuan3d2_tpu_torch/csrc/rasterize.cu",
              "hunyuan3d2_tpu/ops/rasterize_tpu.py:301", raster_rows, 1, "textured_glb"),
        entry("flash_variants", "hunyuan3d2_tpu_torch/csrc/flash_variants.cu",
              "scripts/profile_flash_variants.py:72", sweep_rows, sweep_best, "flash_sweep"),
    ]
    # the chain's kernels: every shape of both decodes, the main row at the
    # v2-0 fine chunk (the tail's instance where a kernel runs twice)
    chain_rows = chain_v20 + chain_mini
    for name, step, replaces in (
            ("ln_rows", "LN3", ":377"), ("gemm_gelu", "MLP fc", ":377"),
            ("gemm_residual", "MLP proj", ":377"), ("ln_dot_rows", "ln_post", ":377"),
            ("gemm_head_ln", "c_q", ":221")):
        rows = [r for r in chain_rows if r["kernel"] == name]
        main_row = next(i for i, r in enumerate(rows)
                        if r["P"] == 199680 and r["step"].startswith(step))
        kernels.append(entry(name, "hunyuan3d2_tpu_torch/csrc/geo_decode.cu",
                             "hunyuan3d2_tpu/ops/geo_decoder_pallas.py" + replaces, rows,
                             main_row, "image_to_mesh_v2_0_fast"))

    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

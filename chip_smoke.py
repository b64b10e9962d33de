#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (hunyuan3d2_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. the card's name and power limit (nvidia-smi);
  2. the build of every kernel from csrc/ (one nvcc per source, in parallel);
  3. each kernel against its plain PyTorch twin at the shapes of the main
     path, with its time, the plain time, the time of one library call where
     one computes the same function, and its bound on the card;
  4. the main path at full width: image → mesh with DINOv2-giant, the mini
     DiT (5 steps, CFG 5.0) and the mini ShapeVAE (FlashVDM decode at octree
     256, capped surface buffers), random weights from a seed, run cold and
     warm; each kernel's launch count is read from the warm run, and the
     GLB is written under tmp/;
  5. a check of the main path's decode against the plain decode on a small
     grid;
  6. a JSON line with every kernel's numbers, then the result line.
Without a CUDA device it exits 1 and prints no result.
"""

import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}  # dense tensor-core bf16; fp32 without tensor cores


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


def bound(flops, nbytes, kind):
    t_ops = flops / PEAK_FLOPS[kind] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def flash_phase(gen):
    import torch
    import torch.nn.functional as F

    from hunyuan3d2_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain

    rows = []
    # (name, shape, dtype, tolerance on max |kernel - plain|): bf16 output is
    # rounded once (ulp 2^-8 at 1) and P is rounded before P.V in both, at
    # other block boundaries; fp32 differs only in summation order
    for name, shape, dt, tol in (("dinov2", (1, 24, 1370, 64), torch.bfloat16, 2e-2),
                                 ("dit", (2, 16, 1882, 64), torch.bfloat16, 2e-2),
                                 ("vae", (1, 16, 512, 64), torch.float32, 1e-4)):
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dt) for _ in range(3))
        out = flash_attention(q, k, v)
        ref = flash_attention_plain(q, k, v)
        torch.cuda.synchronize()
        check(torch.isfinite(out).all().item(), f"flash_attention {name}: non-finite output")
        err = (out.float() - ref.float()).abs().max().item()
        rel = err / ref.float().abs().max().item()
        check(err <= tol, f"flash_attention {name}: max abs err {err} > {tol}")
        scale = shape[-1] ** -0.5
        ms = time_ms(lambda: flash_attention(q, k, v), 20)
        plain_ms = time_ms(lambda: flash_attention_plain(q, k, v), 5)
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=scale), 20)
        b, h, l, d = shape
        flops = 4.0 * b * h * l * l * d
        nbytes = 4 * q.numel() * q.element_size()
        bound_ms, by = bound(flops, nbytes, "bf16" if dt == torch.bfloat16 else "fp32")
        row = dict(shape=f"{name} {list(shape)} {str(dt).split('.')[-1]}", max_abs_err=err,
                   max_rel_err=rel, tol=tol, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                   bound_ms=bound_ms, bound_by=by)
        log("flash_attention " + json.dumps(row))
        rows.append(row)
    return rows


def geo_phase(gen):
    import torch

    from hunyuan3d2_tpu_torch.models import shapevae as sv
    from hunyuan3d2_tpu_torch.ops.geo_decoder import decode_queries_plain, fused_geo_decode

    cfg = sv.MINI
    vae = sv.ShapeVAE.init_random(cfg, device="cuda", generator=gen)
    lat = torch.randn(1, cfg.num_latents, cfg.embed_dim, generator=gen, device="cuda")
    k, v = vae.compute_kv(vae.decode_latents(lat))
    k16, v16 = k.to(torch.bfloat16).contiguous(), v.to(torch.bfloat16).contiguous()
    w, l, m = cfg.width, cfg.num_latents, cfg.geo_decoder_mlp_expand_ratio * cfg.width
    macs_per_query = 51 * w + 2 * w * w + 2 * l * w + 2 * w * m + w
    weight_bytes = 2 * (64 * w + 2 * w * w + 2 * w * m + w) + 2 * k16.numel() * 2
    rows = []
    # coarse pass (34³ corners) and one fine chunk (128 blocks of 8³) at octree 256
    for p in (39304, 65536):
        pts = (torch.rand(1, p, 3, generator=gen, device="cuda") * 2.02 - 1.01).contiguous()
        out = fused_geo_decode(vae, pts, k16, v16)
        ref = decode_queries_plain(vae, pts, k16, v16).float()
        torch.cuda.synchronize()
        check(torch.isfinite(out).all().item(), f"fused_geo_decode P={p}: non-finite output")
        err = (out - ref).abs().max().item()
        tol = 0.05 * max(1.0, ref.abs().max().item())
        corr = torch.corrcoef(torch.stack([out.ravel(), ref.ravel()]))[0, 1].item()
        # the plain decode keeps the residual in bf16 where the kernel keeps fp32
        check(err <= tol and corr > 0.9999,
              f"fused_geo_decode P={p}: max abs err {err} (tol {tol}), corr {corr}")
        ms = time_ms(lambda: fused_geo_decode(vae, pts, k16, v16), 5)
        plain_ms = time_ms(lambda: decode_queries_plain(vae, pts, k16, v16), 3)
        bound_ms, by = bound(2.0 * macs_per_query * p, 16 * p + weight_bytes, "bf16")
        row = dict(shape=f"P={p} W={w} H={cfg.heads} L={l} bf16 K/V", max_abs_err=err,
                   max_rel_err=err / ref.abs().max().item(), tol=tol, corr=corr, ms=ms,
                   plain_ms=plain_ms, library_ms=None, bound_ms=bound_ms, bound_by=by)
        log("fused_geo_decode " + json.dumps(row))
        rows.append(row)
    del vae
    return rows


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


def main_path():
    import numpy as np
    import torch

    from hunyuan3d2_tpu_torch.geometry.mesh import Mesh
    from hunyuan3d2_tpu_torch.ops.flash_attention import flash_attention
    from hunyuan3d2_tpu_torch.ops.geo_decoder import fused_geo_decode
    from hunyuan3d2_tpu_torch.pipelines.shapegen import Hunyuan3DDiTFlowMatchingPipeline
    from hunyuan3d2_tpu_torch.utils.timer import LAST_TIMINGS

    os.environ["HY3D_CAP_ACTIVES"] = "1"
    t0 = time.perf_counter()
    pipe = Hunyuan3DDiTFlowMatchingPipeline.init_random(size="mini", dino="giant",
                                                        device="cuda", seed=0)
    pipe.enable_flashvdm(mc_algo="dmc")
    torch.cuda.synchronize()
    log(f"main path: stack up in {time.perf_counter() - t0:.2f} s "
        f"(DINOv2-giant, mini DiT, mini ShapeVAE, random weights, seed 0)")
    image = test_image()
    launches = {}
    for run in ("cold", "warm"):
        torch.cuda.reset_peak_memory_stats()
        flash_attention.launches = 0
        fused_geo_decode.launches = 0
        t0 = time.perf_counter()
        meshes = pipe(image, num_inference_steps=5, guidance_scale=5.0, octree_resolution=256,
                      num_chunks=65536, seed=1234)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        launches = {"flash_attention": flash_attention.launches,
                    "fused_geo_decode": fused_geo_decode.launches}
        mesh = meshes[0]
        stages = {k: round(LAST_TIMINGS[k], 4) for k in
                  ("Preprocess", "Encode Cond", "Diffusion Sampling", "Volume Decoding")}
        log(f"main path {run}: {elapsed:.3f} s, stages {json.dumps(stages)}, "
            f"{len(mesh.vertices)} vertices, {len(mesh.faces)} faces, launches "
            f"{json.dumps(launches)}, peak memory "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
        check(len(mesh.vertices) > 0 and len(mesh.faces) > 0, "main path: empty mesh")
        check(np.isfinite(mesh.vertices).all(), "main path: non-finite vertices")
        check(np.abs(mesh.vertices).max() <= 1.01 + 1e-4, "main path: vertices outside the box")
        check(mesh.faces.min() >= 0 and mesh.faces.max() < len(mesh.vertices),
              "main path: face index out of range")
    for name, n in launches.items():
        check(n > 0, f"main path: kernel {name} was never launched")
    os.makedirs(os.path.join(ROOT, "tmp"), exist_ok=True)
    path = os.path.join(ROOT, "tmp", "chip_smoke.glb")
    mesh.export(path)
    back = Mesh.load(path)
    check(np.array_equal(back.faces, mesh.faces) and np.array_equal(back.vertices, mesh.vertices),
          "GLB round trip differs")
    log(f"main path: wrote {os.path.relpath(path, ROOT)} ({os.path.getsize(path)} bytes)")
    return pipe, launches


def decode_agreement(pipe, gen):
    """The main path's decode (fused kernel) against the plain decode on a
    small grid, from fresh latents through the mini VAE."""
    import torch

    from hunyuan3d2_tpu_torch.ops.geo_decoder import decode_queries_plain

    vae = pipe.vae
    lat = torch.randn(1, vae.cfg.num_latents, vae.cfg.embed_dim, generator=gen, device="cuda")
    with torch.no_grad():
        k, v = vae.compute_kv(vae.decode_latents(lat))
        k16, v16 = k.to(torch.bfloat16).contiguous(), v.to(torch.bfloat16).contiguous()
        grid = vae.decode_grid(lat, octree_resolution=64)
        plain = vae.volume_decoder(lambda p: decode_queries_plain(vae, p, k16, v16).float(), 1,
                                   64, device=vae.device)
    err = (grid - plain).abs().max().item()
    scale = plain.abs().max().item()
    same_sign = ((grid > 0) == (plain > 0)).float().mean().item()
    log(f"decode check (octree 64): max abs err {err:.5f} of scale {scale:.3f}, "
        f"sign agreement {same_sign:.6f}")
    check(math.isfinite(err) and err <= 0.05 * max(1.0, scale) and same_sign >= 0.99,
          "decode check: kernel grid disagrees with the plain decode")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from hunyuan3d2_tpu_torch.utils import cuda_build

    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full fp32
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    logs = cuda_build.build(["flash_attention", "geo_decode"])
    log(f"build: {time.perf_counter() - t0:.2f} s for {sorted(logs)} "
        f"into {os.path.relpath(cuda_build.BUILD_DIR, ROOT)}")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    gen = torch.Generator(device="cuda").manual_seed(0)
    with torch.no_grad():
        flash_rows = flash_phase(gen)
        geo_rows = geo_phase(gen)
    pipe, launches = main_path()
    decode_agreement(pipe, gen)

    def entry(name, source, replaces, rows, main_row):
        r = rows[main_row]
        return dict(name=name, route="cuda", source=source, replaces=replaces,
                    launches=launches[name], max_abs_err=max(x["max_abs_err"] for x in rows),
                    ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                    bound_by=r["bound_by"], library_ms=r["library_ms"], shape=r["shape"],
                    shapes=rows)

    kernels = [
        entry("flash_attention", "hunyuan3d2_tpu_torch/csrc/flash_attention.cu",
              "hunyuan3d2_tpu/ops/flash_attention.py:221", flash_rows, 1),
        entry("fused_geo_decode", "hunyuan3d2_tpu_torch/csrc/geo_decode.cu",
              "hunyuan3d2_tpu/ops/geo_decoder_pallas.py:221", geo_rows, 1),
    ]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

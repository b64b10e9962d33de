"""The textured path of one or more checkouts, timed in turns on the card,
and the serial order of its stages that the overlapped call must equal.

    python -m hunyuan3d2_tpu_torch.tools.texgen_overlap_ab --roots OLD . . OLD [--runs 5]

Each root (a checkout of this repository; OLD e.g. an unpacked
``git archive`` of the parent commit) is measured in a fresh process that
puts that checkout first on ``sys.path``, so its own package and its own
kernel build run; roots are measured in the order given (parent, change,
change, parent compares two versions on one card). ``ROOT@N`` sets the
checkout's host worker to N threads (``utils/host_worker.THREADS``), for a
sweep of the cap. In each: chip_smoke.py's textured stack (paint UNet
DEFAULT, 6 × 512² views, render and texture 2048, random weights from seed
0) on its 40,284-face sphere, one cold call and ``--runs`` warm calls of the
turbo sampler, then of the standard one; one JSON line a root and sampler
with each warm call's wall time (host clock around a synchronised call) and
stage times, and their medians; then the unwrap alone with the device idle,
three times in that process and (where the checkout has it) three times in
the host worker, then a fresh worker's start and first unwrap. The card's
name and power limit come first.

``serial_texture`` runs the textured call's public stages one after another
in the order the pipeline ran them before the unwrap overlapped the denoise
(chip_smoke.py and tests/test_torch_texgen_overlap.py hold the pipeline's
output to it bit for bit).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys


def serial_texture(pipe, mesh, image, init_latents=None, step_noises=None):
    """``pipe(mesh, image, init_latents, step_noises)`` stage by stage in
    the serial order: cond maps → multiview net → ``mesh_uv_wrap`` (in this
    process) → upload → bake geometry → bake → inpaint → the textured
    mesh."""
    import numpy as np
    import torch

    from hunyuan3d2_tpu_torch.geometry.render_device import (bake_prepared, cond_maps,
                                                              prepare_bake, upload_mesh)
    from hunyuan3d2_tpu_torch.geometry.uv import mesh_uv_wrap
    from hunyuan3d2_tpu_torch.pipelines.texgen import camera_info_index

    cfg, render, dev = pipe.config, pipe.render, pipe.device
    mv_net = pipe.models["multiview_model"]
    elevs, azims = cfg.candidate_camera_elevs, cfg.candidate_camera_azims
    with torch.no_grad():
        render.load_mesh(mesh)
        mats = [render._mvp(e, a) for e, a in zip(elevs, azims)]
        mvs, mvps = (torch.from_numpy(np.stack([m[i] for m in mats]).astype(np.float32)).to(dev)
                     for i in (0, 1))
        cond = cond_maps(upload_mesh(render, dev), mvps, mv_net.view_size)
        views = mv_net([pipe.recenter_image(image)], cond,
                       [camera_info_index(a, e) for a, e in zip(azims, elevs)],
                       output_type="device", init_latents=init_latents,
                       step_noises=step_noises)
        del cond
        render.load_mesh(mesh_uv_wrap(mesh))
        render_res, tex_res = max(render.default_resolution), render.texture_size[0]
        up_res = min(render_res, 4 * mv_net.view_size)
        geom = prepare_bake(upload_mesh(render, dev, need_uv=True), mvs, mvps,
                            cfg.candidate_view_weights, render_res=render_res, tex_res=tex_res,
                            up_res=up_res, exp=float(cfg.bake_exp))
        texture, trust = bake_prepared(geom, views, tex_res, up_res)
        mask = ((trust > 1e-8).cpu().numpy() * 255).astype(np.uint8)
        render.set_texture(pipe.texture_inpaint(texture.cpu().numpy(), mask))
    return render.save_mesh()


# run in the child, with the checkout's root, the worker's thread cap ("" for
# its default) and the warm runs as argv[1:4]
_CHILD = r"""
import json, os, statistics, sys, time
root, threads, runs = sys.argv[1], sys.argv[2], int(sys.argv[3])
sys.path.insert(0, root)
import torch
import chip_smoke as c
from hunyuan3d2_tpu_torch import Hunyuan3DPaintPipeline
from hunyuan3d2_tpu_torch.utils import cuda_build
from hunyuan3d2_tpu_torch.utils.timer import LAST_TIMINGS
try:
    from hunyuan3d2_tpu_torch.utils import host_worker
except ImportError:   # a checkout from before the overlap
    host_worker = None
if threads:
    host_worker.THREADS = int(threads)
cuda_build.build(["flash_attention", "rasterize"])
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
KEYS = ("UV Unwrap", "UV Unwrap (overlaps denoise)", "UV Unwrap (wait)", "Cond Maps (device)",
        "Paint VAE Encode", "Paint Denoising (turbo)", "Paint Denoising",
        "Multiview Diffusion (device)", "Bake Geometry (device)", "Texture Baking (device)",
        "Texture Inpaint")
sphere, image = c.sphere_mesh(), c.test_image()
pipe = Hunyuan3DPaintPipeline.init_random(size="default", view_size=512, render_size=2048,
                                          texture_size=2048, device="cuda", seed=0)
for sampler, turbo in (("turbo", True), ("standard", False)):
    pipe.set_turbo(turbo)
    calls = []
    for run in range(runs + 1):
        t0 = time.perf_counter()
        pipe(sphere, image)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        calls.append(dict(wall=wall, **{k: LAST_TIMINGS[k] for k in KEYS if k in LAST_TIMINGS}))
        LAST_TIMINGS.clear()
    warm = calls[1:]
    med = {k: statistics.median(x[k] for x in warm) for k in warm[0]}
    print(json.dumps(dict(root=root, sampler=sampler, cpu_count=os.cpu_count(),
                          worker_threads=host_worker.THREADS if host_worker else None,
                          cold=calls[0], median=med, warm=warm)), flush=True)
# the unwrap alone, the device idle: in this process, then in the worker
from hunyuan3d2_tpu_torch.geometry import uv
alone = {"in_process": []}
for _ in range(3):
    t0 = time.perf_counter()
    uv.mesh_uv_wrap(sphere)
    alone["in_process"].append(time.perf_counter() - t0)
start = None
if host_worker:
    alone["worker"] = [host_worker.submit(uv.mesh_uv_wrap_arrays, sphere.vertices,
                                          sphere.faces).result()[1] for _ in range(3)]
    # a fresh worker: its start (spawn to a first result), then its first
    # unwrap (the imports and the native library's load included)
    host_worker.shutdown()
    t0 = time.perf_counter()
    host_worker.submit(os.getpid).result()
    t1 = time.perf_counter()
    first = host_worker.submit(uv.mesh_uv_wrap_arrays, sphere.vertices, sphere.faces).result()[1]
    start = dict(spawn=t1 - t0, first_unwrap=first, first_unwrap_wall=time.perf_counter() - t1)
print(json.dumps(dict(root=root, unwrap_alone=alone, worker_start=start)), flush=True)
"""


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--roots", nargs="+", default=["."],
                    help="checkouts, each as ROOT or ROOT@THREADS")
    ap.add_argument("--runs", type=int, default=5, help="warm calls a sampler")
    args = ap.parse_args(argv)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    for spec in args.roots:
        root, _, threads = spec.partition("@")
        subprocess.run([sys.executable, "-c", _CHILD, os.path.abspath(root), threads,
                        str(args.runs)], check=True)


if __name__ == "__main__":
    main()

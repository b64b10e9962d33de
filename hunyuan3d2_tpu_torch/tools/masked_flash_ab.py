"""The masked flash kernel of one or more checkouts, timed in turns on the
card at chip_smoke.py's voxel-grid shapes.

    python -m hunyuan3d2_tpu_torch.tools.masked_flash_ab --roots OLD . . OLD [--dtype float32]

Each root (a checkout of this repository; OLD e.g. an unpacked
``git archive`` of the parent commit) is measured in a fresh process that
puts that checkout first on ``sys.path``, so its own package and its own
kernel build run; roots are measured in the order given (parent, change,
change, parent compares two versions on one card). In each: the voxel
masks that the paint path builds from chip_smoke's test sphere at 512²
(grid 32 → [1, 10, 6144, 64], grid 16 → [1, 20, 1536, 64]), q, k, v from a
seeded generator, the kernel's max abs difference from its plain twin, and
three timings of 20 calls (CUDA events). Prints one JSON line a root and
shape, with the card's name and power limit first. chip_smoke.py's
``MASKED_F32_BEFORE_MS`` (the masked fp32 rows' time under the kernel the
current one replaced) is the median of the parent's timings of one such run.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

# run in the child, with the checkout's root as argv[1] and the dtype as argv[2]
_CHILD = r"""
import json, sys
root, dtype = sys.argv[1], sys.argv[2]
sys.path.insert(0, root)
import torch
import chip_smoke as c
from hunyuan3d2_tpu_torch.utils import cuda_build
cuda_build.build(["flash_attention", "rasterize"])
from hunyuan3d2_tpu_torch.geometry.render import MeshRender
from hunyuan3d2_tpu_torch.geometry.render_device import cond_maps, upload_mesh
from hunyuan3d2_tpu_torch.models.paint_unet import compute_voxel_grid_mask
from hunyuan3d2_tpu_torch.ops.flash_attention import (flash_attention_masked,
                                                      flash_attention_masked_plain)
torch.backends.cuda.matmul.allow_tf32 = False
dt = getattr(torch, dtype)
with torch.no_grad():
    sphere = c.sphere_mesh()
    render = MeshRender(default_resolution=2048, texture_size=2048)
    render.load_mesh(sphere)
    _, position = cond_maps(upload_mesh(render, "cuda"), c._views(render)[1], 512)
    pos = position[None].float() / 255.0
    gen = torch.Generator(device="cuda").manual_seed(16)
    for g, h in ((32, 10), (16, 20)):
        mask = compute_voxel_grid_mask(pos, g)
        b, lq, lk = mask.shape
        q, k, v = (torch.randn(b, h, lq, 64, generator=gen, device="cuda").to(dt)
                   for _ in range(3))
        err = (flash_attention_masked(q, k, v, mask).float()
               - flash_attention_masked_plain(q, k, v, mask).float()).abs().max().item()
        ms = [c.time_ms(lambda: flash_attention_masked(q, k, v, mask), 20) for _ in range(3)]
        print(json.dumps(dict(root=root, grid=g, shape=[b, h, lq, 64], dtype=dtype, ms=ms,
                              max_abs_diff_vs_twin=err)), flush=True)
"""


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--roots", nargs="+", default=["."])
    ap.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32")
    args = ap.parse_args(argv)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    for root in args.roots:
        subprocess.run([sys.executable, "-c", _CHILD, os.path.abspath(root), args.dtype],
                       check=True)


if __name__ == "__main__":
    main()

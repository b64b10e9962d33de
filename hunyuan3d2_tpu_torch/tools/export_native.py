"""Export a shape pipeline (DINOv2 + DiT + ShapeVAE) to the flat weight file
of the standalone C++ driver (hunyuan3d2_tpu/native/standalone/).

Port of scripts/export_native.py; the same file format, byte for byte
(little-endian):

    magic   "HY3DW001" (8 bytes)
    count   int64
    per tensor:
        name_len int32, name bytes (utf-8, '/'-separated tree path)
        dtype    int32 (0 = float32)
        ndim     int32, dims int64[ndim]
        data     float32[prod(dims)]

Tensors carry the JAX package's tree paths (``dino/…``, ``dit/…``,
``vae/…``): the port's state dicts are taken to the JAX trees by
io/convert.py (``dinov2_tree``, ``dit_tree``, ``shapevae_tree``), per-layer
parameters stacked on a leading axis, and written in the sorted order of
their path components (the order of a jit-built JAX tree). ``cfg/dino``,
``cfg/dit`` and ``cfg/vae`` hold the integer hyper-parameters. A pipeline
loaded with ``dtype=torch.float32`` writes the checkpoint's values
unrounded, as the JAX exporter does from ``dtype=np.float32``.

    python -m hunyuan3d2_tpu_torch.tools.export_native --out model.hy3dw [--size tiny|mini|full]
        [--dino tiny|giant] [--from-pretrained PATH SUBFOLDER]

(random weights from seed 0 on the CPU, or a checkpoint loaded in fp32).
"""

from __future__ import annotations

import argparse
import os
import struct

import numpy as np


def flatten(tree, prefix: str = "") -> dict:
    """Nested dicts (and lists) → {'a/b/c': float32 array}, dict keys in
    sorted order."""
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(flatten(tree[k], f"{prefix}/{k}" if prefix else str(k)))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flatten(v, f"{prefix}/{i}"))
    else:
        out[prefix] = np.asarray(tree, np.float32)
    return out


def write_weights(path: str, tensors: dict):
    with open(path, "wb") as fh:
        fh.write(b"HY3DW001")
        fh.write(struct.pack("<q", len(tensors)))
        for name, arr in tensors.items():
            arr = np.ascontiguousarray(arr, np.float32)
            nb = name.encode("utf-8")
            fh.write(struct.pack("<i", len(nb)))
            fh.write(nb)
            fh.write(struct.pack("<i", 0))
            fh.write(struct.pack("<i", arr.ndim))
            fh.write(struct.pack(f"<{arr.ndim}q", *arr.shape))
            fh.write(arr.tobytes())


def export_pipeline(pipe, path: str) -> dict:
    """Hunyuan3DDiTPipeline (the port's) → the flat weight file at ``path``;
    returns the tensors written."""
    from hunyuan3d2_tpu_torch.io.convert import dinov2_tree, dit_tree, shapevae_tree

    main = pipe.conditioner.main
    dcfg, mcfg, vcfg = main.cfg.dino, pipe.model.cfg, pipe.vae.cfg
    tensors = {}
    tensors.update(flatten(dinov2_tree(main.model.state_dict(), dcfg), "dino"))
    tensors.update(flatten(dit_tree(pipe.model.state_dict(), mcfg), "dit"))
    tensors.update(flatten(shapevae_tree(pipe.vae.state_dict(), vcfg), "vae"))
    tensors["cfg/dino"] = np.asarray(
        [dcfg.hidden_size, dcfg.num_layers, dcfg.num_heads, dcfg.patch_size,
         dcfg.image_size, dcfg.swiglu_hidden, 1], np.float32)   # the SwiGLU FFN
    tensors["cfg/dit"] = np.asarray(
        [mcfg.in_channels, mcfg.context_in_dim, mcfg.hidden_size, mcfg.num_heads, mcfg.depth,
         mcfg.depth_single_blocks, int(mcfg.guidance_embed), mcfg.mlp_hidden], np.float32)
    tensors["cfg/vae"] = np.asarray(
        [vcfg.num_latents, vcfg.embed_dim, vcfg.width, vcfg.heads, vcfg.num_decoder_layers,
         vcfg.num_freqs, int(vcfg.include_pi), vcfg.scale_factor], np.float32)
    write_weights(path, tensors)
    return tensors


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--size", default="tiny", choices=["tiny", "mini", "full"])
    ap.add_argument("--dino", default="tiny", choices=["tiny", "giant"])
    ap.add_argument("--from-pretrained", nargs=2, metavar=("PATH", "SUBFOLDER"))
    args = ap.parse_args(argv)

    import torch

    from hunyuan3d2_tpu_torch.pipelines.shapegen import Hunyuan3DDiTFlowMatchingPipeline

    if args.from_pretrained:
        pipe = Hunyuan3DDiTFlowMatchingPipeline.from_pretrained(
            *args.from_pretrained, device="cpu", dtype=torch.float32)
    else:
        pipe = Hunyuan3DDiTFlowMatchingPipeline.init_random(size=args.size, dino=args.dino,
                                                            device="cpu")
    tensors = export_pipeline(pipe, args.out)
    print(f"wrote {len(tensors)} tensors to {args.out} "
          f"({os.path.getsize(args.out) / 1e6:.1f} MB)")


if __name__ == "__main__":
    main()

"""The system under test for a mesh → textured mesh configuration: the port's
``Hunyuan3DPaintPipeline`` (cond maps, the 2.5D UNet's multiview diffusion,
the UV unwrap in the host worker process, the bake and the inpaint), built
from the configuration's sizes with the benchmark's weights, called as a
user calls it: ``pipe(mesh, image)``.

The published pipeline seeds its sampler with 0 on every call; each request
passes ``init_latents`` of its own, drawn from its noise seed, so that no
two requests of a run are alike. The per-step noise stays the pipeline's
own draw from seed 0.

The taps (tracing.patched) sit on the program's objects, never in its
source: ``instrument`` counts the work at each layer's entry (and, in the
traced requests, opens a ``bench.<layer>`` span around it); ``capture``
keeps what a checked request produced for the reference.
"""

from __future__ import annotations

import contextlib
import io
import json
import struct

import numpy as np
import torch

from benchmark import tracing, weights


class System:
    def __init__(self, config: dict, seed: int, device):
        from hunyuan3d2_tpu_torch.geometry.uv import mesh_uv_wrap_arrays
        from hunyuan3d2_tpu_torch.models import paint_unet, sd_vae
        from hunyuan3d2_tpu_torch.pipelines import texgen
        from hunyuan3d2_tpu_torch.pipelines.hunyuanpaint import HunyuanPaintPipeline
        from hunyuan3d2_tpu_torch.pipelines.multiview import Multiview_Diffusion_Net
        from hunyuan3d2_tpu_torch.utils import host_worker

        self.device = torch.device(device)
        ucfg = paint_unet.PaintUNetConfig(**_tuples(config["unet"]))
        vcfg = sd_vae.SDVAEConfig(**_tuples(config["vae"]))
        with torch.device("meta"):
            unet = paint_unet.UNet2p5D(ucfg)
            vae = sd_vae.AutoencoderKL(vcfg)
        modules = {"unet": unet.unet, "vae": vae}
        if ucfg.use_dual_stream:
            modules["unet_dual"] = unet.unet_dual
        self.weights = weights.fill(modules, seed, self.device)
        views = config["views"]
        paint = HunyuanPaintPipeline(unet.eval(), vae.eval(), view_size=views["size"],
                                     device=self.device)
        tex = texgen.Hunyuan3DTexGenConfig()
        tex.candidate_camera_azims = list(views["azims"])
        tex.candidate_camera_elevs = list(views["elevs"])
        tex.candidate_view_weights = list(views["weights"])
        tex.render_size, tex.texture_size = config["render_size"], config["texture_size"]
        tex.bake_exp = config["bake_exp"]
        mv = Multiview_Diffusion_Net(paint, views["size"], config["sampler"]["steps"])
        self.pipe = texgen.Hunyuan3DPaintPipeline({"multiview_model": mv}, tex, self.device)
        self.pipe.set_turbo(config["sampler"]["turbo"])
        self.latent = views["size"] >> (len(vcfg.block_out_channels) - 1)
        self.views = len(views["azims"])
        self._timings = None
        # the unwrap's host worker starts here and finishes one unwrap (an
        # octahedron), so set-up holds the worker's start
        octa = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]],
                        np.float32)
        faces = np.array([[0, 2, 4], [2, 1, 4], [1, 3, 4], [3, 0, 4], [2, 0, 5], [1, 2, 5],
                          [3, 1, 5], [0, 3, 5]], np.int32)
        host_worker.submit(mesh_uv_wrap_arrays, octa, faces).result()

    @staticmethod
    def prepare(request: dict) -> dict:
        """What the entry call takes, made before the window: the mesh (no
        UVs) and the image as a PIL image."""
        from PIL import Image

        from hunyuan3d2_tpu_torch.geometry.mesh import Mesh

        vertices, faces = request["mesh"]
        return {**request, "mesh_in": Mesh(vertices, faces),
                "pil": Image.fromarray(request["image"])}

    def __call__(self, request: dict):
        gen = torch.Generator(device=self.device).manual_seed(request["seed"])
        init = torch.randn((1, self.views, self.latent, self.latent, 4), generator=gen,
                           device=self.device)
        out = self.pipe(request["mesh_in"], request["pil"], init_latents=init)
        if self._timings is not None:
            self._timings.append(self.timings())
        return out

    @staticmethod
    def timings() -> dict:
        """The program's stage times and counters of the last call (its
        ``timed_scope`` spans: host clock, device drained at both ends; the
        request's flat view)."""
        from hunyuan3d2_tpu_torch.utils.timer import LAST_TIMINGS

        return dict(LAST_TIMINGS)

    @contextlib.contextmanager
    def instrument(self, counts: dict, spans: bool):
        """Taps that append, for every call into a layer, its work to
        ``counts``: the 2.5D UNet's 'r' passes ([B, views, h, w]) and 'w'
        passes ([B, references, h, w]), the VAE's encodes ([B, H, W]) and
        decodes ([B, h, w]), and the attention calls that the flash kernels
        take (``ops/attention.py``'s gate), dense and masked (B, H, Lq, Lk,
        D, dtype); and each call's program timings (``timings``). With
        ``spans`` each call also runs inside its ``bench.<layer>`` span: the
        cond maps, the paint stack's encode, 'w' pass, 'r' passes and
        decode, the bake and the inpaint, and the kernel calls of attention
        and masked attention (the plain calls the gate turns away run
        outside them)."""
        from hunyuan3d2_tpu_torch.models import paint_unet
        from hunyuan3d2_tpu_torch.ops.attention import use_flash
        from hunyuan3d2_tpu_torch.pipelines import texgen

        mv = self.pipe.models["multiview_model"].pipeline
        for key in ("unet_r", "unet_w", "vae_encode", "vae_decode", "attention",
                    "masked_attention", "timings"):
            counts.setdefault(key, [])

        def layer(name, key=None, shape_of=None):
            def wrap(fn):
                inner = tracing.span(name)(fn) if spans else fn

                def call(*args, **kwargs):
                    if key is not None:
                        counts[key].append(shape_of(*args))
                    return inner(*args, **kwargs)
                return call
            return wrap

        def kernel(name):
            def wrap(fn):
                inner = tracing.span(name)(fn) if spans else fn

                def call(q, k, v, *rest, **kwargs):
                    if not use_flash(q):
                        return fn(q, k, v, *rest, **kwargs)
                    counts[name].append((q.shape[0], q.shape[1], q.shape[2], k.shape[2],
                                         q.shape[3], str(q.dtype).split(".")[-1]))
                    return inner(q, k, v, *rest, **kwargs)
                return call
            return wrap

        taps = [
            (mv.unet, "forward", layer("paint_unet", "unet_r", lambda x, *r: tuple(x.shape[:4]))),
            (mv.unet, "write_cache", layer("paint_cache", "unet_w",
                                           lambda x, *r: tuple(x.shape[:4]))),
            (mv.vae, "encode", layer("paint_encode", "vae_encode", lambda x: tuple(x.shape[:3]))),
            (mv.vae, "decode", layer("paint_decode", "vae_decode", lambda x: tuple(x.shape[:3]))),
            (paint_unet, "attention", kernel("attention")),
            (paint_unet, "masked_attention", kernel("masked_attention")),
        ]
        if spans:
            taps += [(texgen, "cond_maps", layer("cond_maps")),
                     (texgen, "prepare_bake", layer("bake")),
                     (texgen, "bake_prepared", layer("bake")),
                     (self.pipe, "texture_inpaint", layer("inpaint"))]
        self._timings = counts["timings"]
        try:
            with tracing.patched(taps):
                yield
        finally:
            self._timings = None

    @contextlib.contextmanager
    def capture(self, out: dict, seed: int, check: dict):
        """Keep what the call produces for the reference: the cond maps
        (``cond_maps``: normal and position, uint8 [N, size, size, 3]), the
        voxel mask the masked multiview attention was called with at each
        token count (``masks``), the denoised latents, the decoded views
        before quantisation (``views``, [N, H, W, 3] in [-1, 1]) and after
        (``views_u8``), and the bake's
        texture before inpaint with its trust (``texture``, ``trust``); the
        caller adds the call's return value, the unwrapped and textured mesh,
        as ``out["output"]``. ``out["glb"]`` writes that mesh's GLB with the
        program's writer and reads it back (:func:`read_glb`), when the check
        calls it after the window."""
        from hunyuan3d2_tpu_torch.models import paint_unet
        from hunyuan3d2_tpu_torch.pipelines import texgen

        mv = self.pipe.models["multiview_model"].pipeline
        decoded = []

        def keep(key):
            def wrap(fn):
                def call(*args, **kwargs):
                    y = fn(*args, **kwargs)
                    out[key] = tuple(t.detach().clone() for t in y)
                    return y
                return call
            return wrap

        def decode(fn):
            def call(z):
                y = fn(z)
                decoded.append(y.detach().float().clone())
                return y
            return call

        def decode_views(fn):
            def call(latents):
                out["latents"] = latents.detach().float().clone()
                y = fn(latents)
                out["views_u8"] = y.detach().clone()
                return y
            return call

        def masked(fn):
            def call(q, k, v, mask, *args, **kwargs):
                out["masks"].setdefault(mask.shape[1], mask)
                return fn(q, k, v, mask, *args, **kwargs)
            return call

        out["masks"] = {}
        with tracing.patched([(texgen, "cond_maps", keep("cond_maps")),
                              (paint_unet, "masked_attention", masked),
                              (mv, "_decode_views", decode_views),
                              (mv.vae, "decode", decode),
                              (texgen, "bake_prepared", keep("bake"))]):
            yield out
        out["views"] = torch.cat(decoded)
        out["texture"], out["trust"] = out.pop("bake")
        mesh = out["output"]
        out["glb"] = lambda: read_glb(mesh.to_glb_bytes())

    def close(self):
        """Drop the program's objects; the weights stay for the reference."""
        del self.pipe


def _tuples(cfg: dict) -> dict:
    """A configuration group with its lists as tuples (the port's frozen
    dataclasses hold tuples)."""
    return {k: tuple(v) if isinstance(v, list) else v for k, v in cfg.items()}


def read_glb(data: bytes) -> dict:
    """A binary glTF 2.0 asset's first primitive, read with the format's
    own rules and nothing of the program: positions, faces, uv (to the
    bottom-left origin) and the base-colour texture. Raises ValueError
    where the bytes are no such asset (OSError where its image is none)."""
    try:
        return _read_glb(data)
    except (struct.error, KeyError, IndexError, TypeError, json.JSONDecodeError) as e:
        raise ValueError(f"not a GLB the reader can read: {e!r}") from e


def _read_glb(data: bytes) -> dict:
    from PIL import Image

    magic, version, total = struct.unpack("<4sII", data[:12])
    if magic != b"glTF" or version != 2 or total != len(data):
        raise ValueError("not a GLB")
    chunks, off = {}, 12
    while off < len(data):
        n, kind = struct.unpack("<I4s", data[off:off + 8])
        chunks[kind] = data[off + 8:off + 8 + n]
        off += 8 + n
    g, blob = json.loads(chunks[b"JSON"]), chunks[b"BIN\x00"]

    def accessor(i):
        a = g["accessors"][i]
        bv = g["bufferViews"][a["bufferView"]]
        width = {"SCALAR": 1, "VEC2": 2, "VEC3": 3}[a["type"]]
        dtype = {5125: "<u4", 5126: "<f4"}[a["componentType"]]
        arr = np.frombuffer(blob, dtype, a["count"] * width, bv.get("byteOffset", 0))
        return arr.reshape(a["count"], width)

    prim = g["meshes"][0]["primitives"][0]
    uv = accessor(prim["attributes"]["TEXCOORD_0"]).astype(np.float32)
    image = g["images"][0]
    bv = g["bufferViews"][image["bufferView"]]
    png = blob[bv.get("byteOffset", 0):bv.get("byteOffset", 0) + bv["byteLength"]]
    return {"vertices": accessor(prim["attributes"]["POSITION"]),
            "faces": accessor(prim["indices"]).reshape(-1, 3).astype(np.int64),
            "uv": np.stack([uv[:, 0], 1.0 - uv[:, 1]], 1),
            "texture": np.asarray(Image.open(io.BytesIO(png)).convert("RGB"))}

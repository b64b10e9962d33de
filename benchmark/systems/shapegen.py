"""The system under test for an image → mesh configuration: the port's
``Hunyuan3DDiTFlowMatchingPipeline``, built from the configuration's sizes
with the benchmark's weights, called as a user calls it.

The taps (tracing.patched) sit on the program's objects, never in its
source: ``instrument`` counts the work at each layer's entry (and, in the
traced requests, opens a ``bench.<layer>`` span around it); ``capture``
keeps what a checked request produced for the reference.
"""

from __future__ import annotations

import contextlib
import logging

import torch

from benchmark import tracing, weights

# the modules whose ``attention`` (ops/attention.py's entry) the image →
# mesh path calls; the streamed geo decode calls the flash kernel directly
ATTENTION_USERS = ("models.dit", "models.dinov2", "models.shapevae")


class System:
    def __init__(self, config: dict, seed: int, device):
        from hunyuan3d2_tpu_torch.models import conditioner, dinov2, dit, shapevae
        from hunyuan3d2_tpu_torch.pipelines import schedulers, shapegen

        self.device = torch.device(device)
        dino_cfg = dinov2.DinoConfig(**config["dino"])
        with torch.device("meta"):
            model = dit.Hunyuan3DDiT(dit.DiTConfig(**config["dit"]))
            vae = shapevae.ShapeVAE(shapevae.ShapeVAEConfig(**config["vae"]))
            encoder = conditioner.DinoImageEncoder(conditioner.DinoEncoderConfig(
                dino=dino_cfg, image_size=dino_cfg.image_size))
        self.weights = weights.fill({"model": model, "vae": vae, "conditioner": encoder},
                                    seed, self.device)
        self.pipe = shapegen.Hunyuan3DDiTFlowMatchingPipeline(
            vae=vae.eval(), model=model.eval(),
            scheduler=schedulers.FlowMatchEulerDiscreteScheduler(),
            conditioner=conditioner.SingleImageEncoder(encoder).eval(), device=self.device)
        # random weights decode a noise surface larger than the capped buffers
        # (the configuration's HY3D_CAP_ACTIVES): the program warns on each call
        logging.getLogger("hunyuan3d2_tpu_torch.shapevae").setLevel(logging.ERROR)
        decode = config["decode"]
        self.pipe.enable_flashvdm(enabled=decode["flashvdm"], mc_algo=decode["mc_algo"],
                                  topk_mode=decode["topk_mode"])

    @staticmethod
    def prepare(request: dict) -> dict:
        """What the entry call takes, made before the window: the image as a
        PIL image."""
        from PIL import Image

        return {**request, "pil": Image.fromarray(request["image"])}

    def __call__(self, request: dict):
        gen = torch.Generator(device=self.device).manual_seed(request["seed"])
        return self.pipe(request["pil"], generator=gen, **request["call"])

    @staticmethod
    def timings() -> dict:
        """The program's stage times of the last call (its ``timed_scope``
        spans: host clock, device drained at both ends)."""
        from hunyuan3d2_tpu_torch.utils.timer import LAST_TIMINGS

        return dict(LAST_TIMINGS)

    def instrument(self, counts: dict, spans: bool):
        """Taps that append, for every call into a layer, its work to
        ``counts`` (DiT forwards' (batch, latent tokens, cond tokens),
        DINOv2 images, VAE trunk batches, decode calls' queries as sent,
        each volume decode's (queries it needs, decode calls), attention
        calls' (B, H, Lq, Lk, D, dtype)); with ``spans`` each call also runs
        inside its ``bench.<layer>`` span.

        A volume decode needs the coarse points and the chosen blocks'
        points (what its block selection returns); the decode calls send
        more, since the last chunk of a pass is padded to the chunk's size.
        The work counts take the points needed, so padding counts as time
        and not as work."""
        import importlib

        pipe = self.pipe
        for key in ("dit", "dino", "vae_trunk", "geo_decode", "volume_decode", "attention"):
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

        def decode_fn(make):
            def make_counted(k, v):
                return layer("geo_decode", "geo_decode", lambda pts: pts.shape[0] * pts.shape[1])(
                    make(k, v))
            return make_counted

        def decode_sparse(fn):
            def call(*args, **kwargs):
                calls = len(counts["geo_decode"])
                coarse, blocks, fine = out = fn(*args, **kwargs)
                counts["volume_decode"].append((coarse.numel() + fine.numel(),
                                                len(counts["geo_decode"]) - calls))
                return out
            return call

        taps = [
            (pipe.model, "forward", layer("dit", "dit", lambda x, t, c, *r: (
                x.shape[0], x.shape[1], c.shape[1]))),
            (pipe.conditioner.main.model, "forward", layer("dino", "dino",
                                                           lambda px: px.shape[0])),
            (pipe.vae, "decode_latents", layer("vae_trunk", "vae_trunk",
                                               lambda lat: lat.shape[0])),
            (pipe.vae, "_decode_fn", decode_fn),
            (pipe.vae, "_decode_sparse", decode_sparse),
        ]
        if spans:
            taps += [(pipe, "encode_cond", layer("encode_cond")),
                     (pipe, "sample", layer("diffusion_sampling")),
                     (pipe, "_export", layer("volume_decoding")),
                     (pipe.vae, "_mesh_on_device", layer("surface"))]
        for mod in ATTENTION_USERS:
            m = importlib.import_module("hunyuan3d2_tpu_torch." + mod)
            taps.append((m, "attention", layer("attention", "attention", lambda q, k, v, *r: (
                q.shape[0], q.shape[1], q.shape[2], k.shape[2], q.shape[3],
                str(q.dtype).split(".")[-1]))))
        return tracing.patched(taps)

    @contextlib.contextmanager
    def capture(self, out: dict, seed: int, check: dict):
        """Keep what the call produces for the reference: the conditioner
        tokens, the denoised latents and, from every decode call, the logits
        at the traffic's ``check["points_per_call"]`` points drawn from
        ``seed`` (with the points); the caller adds the call's return value
        as ``out["output"]``."""
        points_per_call = check["points_per_call"]
        gen = torch.Generator(device=self.device).manual_seed(seed)
        pts_seen, logits_seen = [], []

        def keep(key):
            def wrap(fn):
                def call(*args, **kwargs):
                    y = fn(*args, **kwargs)
                    out[key] = y.detach().clone()
                    return y
                return call
            return wrap

        def decode_fn(make):
            def make_kept(k, v):
                fn = make(k, v)

                def decode(pts):
                    y = fn(pts)
                    idx = torch.randint(0, pts.shape[1], (points_per_call,), generator=gen,
                                        device=pts.device)
                    pts_seen.append(pts[0, idx].clone())
                    logits_seen.append(y[0, idx].float().clone())
                    return y
                return decode
            return make_kept

        with tracing.patched([(self.pipe, "encode_cond", keep("cond")),
                              (self.pipe, "sample", keep("latents")),
                              (self.pipe.vae, "_decode_fn", decode_fn)]):
            yield out
        out["points"] = torch.cat(pts_seen)
        out["logits"] = torch.cat(logits_seen)

    def close(self):
        """Drop the program's objects; the weights stay for the reference."""
        del self.pipe

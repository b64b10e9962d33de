"""Shape-generation pipelines, image → mesh (port of
hunyuan3d2_tpu/pipelines/shapegen.py).

The flow-matching loop starts from σ=0 and integrates the velocity to σ=1;
the model sees t = σ. CFG doubles the batch as [cond | uncond]; a
guidance-distilled model takes the guidance as an embedding instead.
Latents stay fp32 in the integrator and the model runs in bf16. The denoise
loop is a Python loop (the JAX package scans). Randomness comes from an
explicit ``torch.Generator`` (``seed``), not a global state.
"""

from __future__ import annotations

import numpy as np
import torch

from hunyuan3d2_tpu_torch.models import conditioner as conditioner_lib
from hunyuan3d2_tpu_torch.models import dinov2
from hunyuan3d2_tpu_torch.models import dit as dit_lib
from hunyuan3d2_tpu_torch.models import shapevae as vae_lib
from hunyuan3d2_tpu_torch.ops.nn import build
from hunyuan3d2_tpu_torch.pipelines import schedulers as sched_lib
from hunyuan3d2_tpu_torch.utils.imageproc import ImageProcessorV2
from hunyuan3d2_tpu_torch.utils.timer import timed_scope


def export_to_trimesh(mesh_outputs):
    """Latent2MeshOutput(s) → Mesh(es); the extractor already emits the
    outward winding."""
    if isinstance(mesh_outputs, list):
        return [None if m is None else m.to_mesh() for m in mesh_outputs]
    return None if mesh_outputs is None else mesh_outputs.to_mesh()


def dino_config(dino: str) -> conditioner_lib.DinoEncoderConfig:
    """'giant' is production; 'tiny' is a two-layer 112-pixel tower at the
    giant width for tests (the JAX package's init_random choice)."""
    if dino == "giant":
        return conditioner_lib.DinoEncoderConfig()
    if dino != "tiny":
        raise ValueError(f"dino must be 'giant' or 'tiny', got {dino!r}")
    return conditioner_lib.DinoEncoderConfig(
        dino=dinov2.DinoConfig(hidden_size=1536, num_layers=2, num_heads=24, patch_size=14,
                               image_size=112, swiglu_hidden=256),
        image_size=112)


class Hunyuan3DDiTPipeline:
    """Holds the DiT, the ShapeVAE, the conditioner, the scheduler and the
    image processor, all on ``device``."""

    def __init__(self, vae: vae_lib.ShapeVAE, model: dit_lib.Hunyuan3DDiT, scheduler,
                 conditioner: conditioner_lib.SingleImageEncoder, image_processor=None,
                 device=None, **kwargs):
        self.vae = vae
        self.model = model
        self.scheduler = scheduler
        self.conditioner = conditioner
        self.image_processor = image_processor or ImageProcessorV2()
        self.device = torch.device(device if device is not None else "cuda")
        self.kwargs = kwargs

    @property
    def model_cfg(self) -> dit_lib.DiTConfig:
        return self.model.cfg

    @classmethod
    def from_pretrained(cls, model_path: str, subfolder: str = "hunyuan3d-dit-v2-0",
                        variant: str = "fp16", device=None, **kwargs):
        """The pipeline of the checkpoint ``{model_path}/{subfolder}`` (a local
        directory, or one under ``$HY3DGEN_MODELS``): config.yaml and
        ``model.{variant}.safetensors`` (or ``.ckpt``), loaded onto
        ``device`` (``cuda`` unless the caller passes another). ``dtype``
        (bf16 by default, or fp32) is the dtype of the Linear weights, as
        the JAX loader's; other keywords go to the pipeline."""
        from hunyuan3d2_tpu_torch.io import checkpoints

        return checkpoints.load_pipeline(cls, model_path, subfolder, variant, device=device,
                                         **kwargs)

    @classmethod
    def from_single_file(cls, ckpt_path: str, config_path: str, device=None, **kwargs):
        """The pipeline of one multi-model checkpoint file and its config.yaml."""
        from hunyuan3d2_tpu_torch.io import checkpoints

        return checkpoints.load_pipeline_single_file(cls, ckpt_path, config_path,
                                                     device=device, **kwargs)

    @classmethod
    def init_random(cls, size: str = "mini", guidance_embed: bool = False, dino: str = "tiny",
                    device=None, seed: int = 0):
        """Random-weight pipeline at the named sizes, built on ``device``
        (``cuda`` unless the caller passes another), weights drawn from
        torch Generators seeded from ``seed``."""
        device = torch.device(device if device is not None else "cuda")
        # "full" is the v2-0 stack: 16 + 32 DiT blocks, the 3072-latent VAE
        dit_cfg = {"tiny": dit_lib.TINY, "mini": dit_lib.MINI, "full": dit_lib.FULL}[size]
        if guidance_embed:
            dit_cfg = dit_lib.DiTConfig(**{**dit_cfg.__dict__, "guidance_embed": True})
        vae_cfg = {"tiny": vae_lib.TINY, "mini": vae_lib.MINI, "full": vae_lib.FULL}[size]

        def gen(i):
            return torch.Generator(device=device).manual_seed(seed * 3 + i)

        return cls(
            vae=build(vae_lib.ShapeVAE, vae_cfg, device=device, generator=gen(1)),
            model=build(dit_lib.Hunyuan3DDiT, dit_cfg, device=device, generator=gen(0)),
            scheduler=sched_lib.FlowMatchEulerDiscreteScheduler(),
            conditioner=conditioner_lib.SingleImageEncoder(build(
                conditioner_lib.DinoImageEncoder, dino_config(dino), device=device,
                generator=gen(2))),
            device=device,
        )

    def enable_flashvdm(self, enabled: bool = True, adaptive_kv_selection=True,
                        topk_mode="mean", mc_algo="dmc", replace_vae: bool = False):
        """The block-sparse decoder with ``SurfaceExtractors[mc_algo]``, or
        the vanilla decoder with marching cubes when not ``enabled``. As in
        the JAX package, only ``enabled``, ``topk_mode`` and ``mc_algo``
        reach the VAE (``adaptive_kv_selection`` and ``replace_vae`` are
        accepted for the reference's signature)."""
        self.vae.enable_flashvdm_decoder(enabled=enabled, topk_mode=topk_mode, mc_algo=mc_algo)
        return self

    def _modules(self):
        return (self.model, self.vae, self.conditioner)

    def offload_to_host(self):
        """Move every weight of the DiT, the ShapeVAE and the conditioner to
        host memory, freeing the device's, e.g. to make room for the paint
        stack."""
        for m in self._modules():
            m.to("cpu")
        self.vae.drop_device_caches()
        return self

    def restore_to_device(self):
        """Move the weights back to the pipeline's device."""
        for m in self._modules():
            m.to(self.device)
        return self

    def enable_model_cpu_offload(self, *args, **kwargs):
        """Keep the weights in host memory between calls: each call moves
        them to the device first and back to the host after."""
        self._auto_offload = True
        return self

    def compile(self):
        """The reference's torch.compile opt-in; the port runs eagerly with
        its own kernels, so this returns the pipeline unchanged, as the JAX
        package's does."""
        return self

    def prepare_image(self, image, mask=None) -> dict:
        """The conditioner's input; ``mask`` is accepted for the
        reference's signature (the processor takes the image's alpha)."""
        return self.image_processor(image)

    def encode_cond(self, image_nhwc: np.ndarray, do_cfg: bool, view_idxs=None) -> torch.Tensor:
        """[-1,1] NHWC image → conditioner tokens; with CFG the zero-token
        uncond is appended, [cond | uncond]. With ``view_idxs`` (a multiview
        processor's ``[[...]]``) the image is [B, V, H, W, 3], the views are
        encoded into one sequence, and the uncond has V views' tokens."""
        streams = self.conditioner.encode_image(image_nhwc, view_idxs)
        if do_cfg:
            num_views = len(view_idxs[0]) if view_idxs is not None else 1
            uncond = self.conditioner.unconditional(streams["main"].shape[0], num_views)
            streams = {k: torch.cat([v, uncond[k].to(v.dtype)]) for k, v in streams.items()}
        self.last_cond_streams = streams  # the DiT reads "main"; a Dual encoder adds more
        return streams["main"]

    def prepare_latents(self, batch_size: int, generator: torch.Generator) -> torch.Tensor:
        shape = (batch_size, self.vae.cfg.num_latents, self.vae.cfg.embed_dim)
        return torch.randn(shape, generator=generator, device=self.device, dtype=torch.float32)

    def sample(self, latents: torch.Tensor, cond: torch.Tensor, sigmas: np.ndarray,
               guidance_scale: float, do_cfg: bool) -> torch.Tensor:
        """The denoise loop: fp32 latents, bf16 model, Euler steps."""
        latents = latents.float()
        guidance = None
        if self.model_cfg.guidance_embed:
            guidance = torch.full((cond.shape[0],), guidance_scale, device=self.device)
        for i in range(len(sigmas) - 1):
            # np.float32 scalars: the step size is taken in fp32, as in the JAX loop
            sigma, sigma_next = np.float32(sigmas[i]), np.float32(sigmas[i + 1])
            inp = torch.cat([latents, latents]) if do_cfg else latents
            t = torch.full((inp.shape[0],), float(sigma), dtype=torch.float32, device=self.device)
            v = self.model(inp.to(torch.bfloat16), t, cond, guidance).float()
            if do_cfg:
                v_cond, v_uncond = v.chunk(2)
                v = v_uncond + guidance_scale * (v_cond - v_uncond)
            latents = self.scheduler.step(latents, v, sigma, sigma_next)
        return latents

    def _export(self, latents, output_type="trimesh", box_v=1.01, mc_level=0.0,
                num_chunks=65536, octree_resolution=256, mc_algo="mc", enable_pbar=True):
        if output_type == "latents":
            return latents
        with timed_scope("Volume Decoding"):
            outputs = self.vae.latents2mesh(latents, octree_resolution=octree_resolution,
                                            mc_level=mc_level, num_chunks=num_chunks,
                                            mc_algo=mc_algo, box_v=box_v)
        if output_type == "raw":
            return outputs
        return export_to_trimesh(outputs)


class Hunyuan3DDiTFlowMatchingPipeline(Hunyuan3DDiTPipeline):
    """The image → mesh entry point."""

    @torch.no_grad()
    def __call__(self, image=None, num_inference_steps: int = 50, guidance_scale: float = 5.0,
                 sigmas=None, octree_resolution: int = 384, mc_level: float = 0.0,
                 mc_algo: str = "mc", num_chunks: int = 65536, box_v: float = 1.01,
                 seed: int = 0, generator: torch.Generator = None, output_type: str = "trimesh",
                 enable_pbar: bool = True, **kwargs):
        """image → [Mesh] (or latents / raw extractor outputs). ``mc_algo``
        picks the extractor when ``enable_flashvdm`` set none; ``enable_pbar``
        and extra keywords are accepted for the reference's signature."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(seed)
        auto_offload = getattr(self, "_auto_offload", False)
        if auto_offload:
            self.restore_to_device()
        do_cfg = guidance_scale >= 0 and not self.model_cfg.guidance_embed

        with timed_scope("Preprocess"):
            cond_inputs = self.prepare_image(image)
            img = cond_inputs["image"]
            view_idxs = cond_inputs.get("view_idxs")
        with timed_scope("Encode Cond"):
            cond = self.encode_cond(img, do_cfg, view_idxs)
        sigma_ladder = self.scheduler.make_sigmas(num_inference_steps, sigmas)
        latents = self.prepare_latents(img.shape[0] if view_idxs is None else 1, generator)
        with timed_scope("Diffusion Sampling"):
            latents = self.sample(latents, cond, sigma_ladder, guidance_scale, do_cfg)
        out = self._export(latents, output_type, box_v, mc_level, num_chunks, octree_resolution,
                           mc_algo, enable_pbar)
        if auto_offload:
            self.offload_to_host()
        return out

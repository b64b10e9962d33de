"""Text → image front end of the text-to-3D path (port of
hunyuan3d2_tpu/utils/text2image.py).

The reference's hy3dgen/text2image.py ``HunyuanDiTPipeline``: the prompt
cut to 60 characters plus a fixed positive suffix, a fixed negative
prompt, HunyuanDiT v1.1 with PAG, 25 steps, 1024², a seeded generator.

Backends, tried in this order:
  1. an explicit ``backend`` callable(prompt, negative_prompt, seed) → PIL;
  2. a local diffusers directory with ``transformer/`` at ``model_path``:
     the port's pipeline (pipelines/t2i.py) on ``device``;
  3. diffusers' ``AutoPipelineForText2Image`` when importable (the
     reference's construction: PAG on blocks 16-19, fp16 on the card);
  4. the ``HY3D_T2I_CMD`` hook, an external command run as
     ``$HY3D_T2I_CMD <prompt_file> <out.png>``;
  5. ``HY3D_RANDOM_WEIGHTS=1``: the port's pipeline at its tiny
     random-weight config (64², 4 steps).
With none of them the constructor raises.
"""

from __future__ import annotations

import os

POSITIVE_SUFFIX = "白色背景,3D风格,最佳质量"  # white background, 3D style, best quality
NEGATIVE_PROMPT = (
    "文本,特写,裁剪,出框,最差质量,低质量,JPEG伪影,PGLY,重复,病态,"
    "残缺,多余的手指,变异的手,画得不好的手,画得不好的脸,变异,畸形,"
    "模糊,脱水,糟糕的解剖学,糟糕的比例,多余的肢体,克隆的脸,毁容,"
    "恶心的比例,畸形的肢体,缺失的手臂,缺失的腿,额外的手臂,额外的腿,"
    "融合的手指,手指太多,长脖子"
)


def _diffusers_backend(model_path: str, device: str):
    import torch
    from diffusers import AutoPipelineForText2Image

    cuda = str(device).startswith("cuda")
    pipe = AutoPipelineForText2Image.from_pretrained(
        model_path, torch_dtype=torch.float16 if cuda else torch.float32, enable_pag=True,
        pag_applied_layers=["blocks.(16|17|18|19)"]).to(device)

    @torch.no_grad()
    def run(prompt, negative_prompt, seed):
        generator = torch.Generator(device=pipe.device).manual_seed(int(seed))
        return pipe(prompt=prompt, negative_prompt=negative_prompt, num_inference_steps=25,
                    pag_scale=1.3, width=1024, height=1024, generator=generator,
                    return_dict=False)[0][0]

    run.pipe = pipe
    return run


def port_backend(ckpt_path=None, device="cuda"):
    """The port's HunyuanDiT pipeline as a backend: from a diffusers
    directory, or (no path) the tiny random-weight pipeline (64², 4
    steps)."""
    from hunyuan3d2_tpu_torch.pipelines.t2i import HunyuanDiTTorchPipeline

    if ckpt_path:
        pipe = HunyuanDiTTorchPipeline.from_pretrained(str(ckpt_path), device=device)
    else:
        pipe = HunyuanDiTTorchPipeline.init_random(resolution=64, num_inference_steps=4,
                                                   device=device)

    def run(prompt, negative_prompt, seed):
        return pipe(prompt, seed=seed, negative_prompt=negative_prompt)

    run.pipe = pipe
    return run


def _command_backend(cmd: str):
    import subprocess
    import tempfile

    from PIL import Image

    def run(prompt, negative_prompt, seed):
        with tempfile.TemporaryDirectory() as td:
            pf, out = os.path.join(td, "prompt.txt"), os.path.join(td, "out.png")
            with open(pf, "w") as fh:
                fh.write(f"{prompt}\n---negative---\n{negative_prompt}\n---seed---\n{seed}\n")
            subprocess.run([*cmd.split(), pf, out], check=True)
            return Image.open(out).convert("RGBA")

    return run


class HunyuanDiTPipeline:
    """``pipe(prompt, seed) → PIL.Image`` through the first backend available
    (module docstring), on ``device`` (``cuda`` unless the caller passes
    another)."""

    def __init__(self, model_path: str = "Tencent-Hunyuan/HunyuanDiT-v1.1-Diffusers-Distilled",
                 backend=None, device: str = "cuda"):
        self.model_path = model_path
        self.pos_txt = "," + POSITIVE_SUFFIX
        self.neg_txt = NEGATIVE_PROMPT
        if backend is None and os.path.isdir(os.path.join(str(model_path), "transformer")):
            backend = port_backend(model_path, device)
        if backend is None:
            try:
                backend = _diffusers_backend(model_path, device)
            except ImportError:
                cmd = os.environ.get("HY3D_T2I_CMD", "")
                if cmd:
                    backend = _command_backend(cmd)
        if backend is None and os.environ.get("HY3D_RANDOM_WEIGHTS") == "1":
            backend = port_backend(None, device)
        if backend is None:
            raise RuntimeError(
                "No text-to-image backend available: no diffusers HunyuanDiT directory "
                "(transformer/, vae/) at model_path for the port's pipeline "
                "(hunyuan3d2_tpu_torch/pipelines/t2i.py), diffusers is not installed, "
                "HY3D_T2I_CMD is unset, and no backend callable was passed. Pass "
                "`backend=callable(prompt, negative_prompt, seed) -> PIL.Image` or a "
                "checkpoint directory, or set HY3D_RANDOM_WEIGHTS=1 for a random-weight "
                "pipeline.")
        self.backend = backend

    def __call__(self, prompt: str, seed: int = 0):
        # the reference: the prompt cut to 60 characters, then the suffix
        return self.backend(prompt[:60] + self.pos_txt, negative_prompt=self.neg_txt, seed=seed)

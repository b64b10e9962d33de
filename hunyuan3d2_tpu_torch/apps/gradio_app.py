"""Gradio UI on the PyTorch port: image, text or multiview → 3D (port of
apps/gradio_app.py).

Tabs for an image, a text prompt (with ``--enable_t23d``: text → image
through utils/text2image.HunyuanDiTPipeline, the tiny random-weight one
under ``--random-weights``) and up to four views; options for steps,
guidance, seed and octree resolution; export as glb, obj, ply or stl with
an optional face budget; per-stage timings shown beside the result. ``GradioWorker`` holds
the pipelines and does the work; ``build_ui`` lays out the page. gradio is
imported only by ``build_ui`` and ``main``.

    python -m hunyuan3d2_tpu_torch.apps.gradio_app --random-weights --device cpu
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time
import uuid

EXPORT_TYPES = ("glb", "obj", "ply", "stl")

HTML_VIEWER = """<!DOCTYPE html>
<html><head>
<script type="module" src="https://ajax.googleapis.com/ajax/libs/model-viewer/3.1.1/model-viewer.min.js"></script>
<style>html,body{{margin:0;height:100%;background:#1b1b1f}}
model-viewer{{width:100%;height:100%}}</style></head>
<body><model-viewer src="{src}" camera-controls auto-rotate shadow-intensity="1"
exposure="0.9" ar></model-viewer></body></html>
"""


class GradioWorker:
    """The pipelines behind the UI, on ``args.device`` (``cuda`` unless the
    arguments name another)."""

    def __init__(self, args):
        from hunyuan3d2_tpu_torch import Hunyuan3DDiTFlowMatchingPipeline, Hunyuan3DPaintPipeline
        from hunyuan3d2_tpu_torch.utils.rembg import BackgroundRemover

        device = getattr(args, "device", None)
        self.args = args
        self.rembg = BackgroundRemover()
        if args.random_weights:
            self.shape_pipe = Hunyuan3DDiTFlowMatchingPipeline.init_random(
                size=os.environ.get("HY3D_RANDOM_SIZE", "mini"), dino="tiny", device=device)
        else:
            self.shape_pipe = Hunyuan3DDiTFlowMatchingPipeline.from_pretrained(
                args.model_path, subfolder=args.subfolder, device=device)
        if args.enable_flashvdm:
            self.shape_pipe.enable_flashvdm(True, mc_algo=args.mc_algo)
        if args.low_vram_mode:  # the shape stack's weights wait on the host between calls
            self.shape_pipe.enable_model_cpu_offload()
        self.tex_pipe = None
        if not args.disable_tex:
            if args.random_weights:
                self.tex_pipe = Hunyuan3DPaintPipeline.init_random(device=device)
            else:
                self.tex_pipe = Hunyuan3DPaintPipeline.from_pretrained(args.texgen_model_path,
                                                                       device=device)
        self.t2i = None
        if args.enable_t23d:
            from hunyuan3d2_tpu_torch.utils.text2image import HunyuanDiTPipeline, port_backend

            device = self.shape_pipe.device
            self.t2i = HunyuanDiTPipeline(
                backend=port_backend(None, device) if args.random_weights else None,
                device=device)

    def text_to_image(self, prompt, seed=0):
        if self.t2i is None:
            raise RuntimeError("text-to-image is disabled; launch with --enable_t23d")
        return self.t2i(prompt, seed=seed)

    def _prepare_input(self, image=None, mv_images=None, prompt=None, seed=1234):
        from hunyuan3d2_tpu_torch.utils.imageproc import ImageProcessorV2, MVImageProcessorV2

        if prompt is not None and image is None and mv_images is None:
            image = self.text_to_image(prompt, seed=seed)
        if mv_images is not None:
            views = {k: self.rembg(v) for k, v in mv_images.items() if v is not None}
            if not views:
                raise ValueError("provide at least one view")
            self.shape_pipe.image_processor = MVImageProcessorV2()
            main = self.shape_pipe.conditioner.main
            if not hasattr(main, "encode_views"):
                # the single-view tower as the multiview encoder: the same
                # weights, plus the sin-cos view embeddings
                from hunyuan3d2_tpu_torch.models.conditioner import DinoImageEncoderMV

                self.shape_pipe.conditioner.main_image_encoder = DinoImageEncoderMV(
                    main.cfg, model=main.model)
            return views, views.get("front") or next(iter(views.values()))
        image = self.rembg(image)
        if type(self.shape_pipe.image_processor) is not ImageProcessorV2:
            self.shape_pipe.image_processor = ImageProcessorV2()
        return image, image

    def gen_shape(self, image=None, mv_images=None, prompt=None, steps=30, guidance_scale=5.0,
                  seed=1234, octree_resolution=256, num_chunks=200000):
        from hunyuan3d2_tpu_torch.utils.timer import LAST_TIMINGS

        stats = {}
        t0 = time.time()
        cond_input, ref_image = self._prepare_input(image, mv_images, prompt, seed)
        stats["preprocess"] = time.time() - t0
        t1 = time.time()
        mesh = self.shape_pipe(image=cond_input, num_inference_steps=steps,
                               guidance_scale=guidance_scale, seed=seed,
                               octree_resolution=octree_resolution, num_chunks=num_chunks,
                               mc_algo=self.args.mc_algo)[0]
        stats["shape_gen_total"] = time.time() - t1
        stats.update(LAST_TIMINGS)
        mesh.metadata["stats"] = stats
        return mesh, ref_image

    def generation_all(self, image=None, mv_images=None, prompt=None, **kwargs):
        from hunyuan3d2_tpu_torch.geometry.postprocess import (
            DegenerateFaceRemover,
            FaceReducer,
            FloaterRemover,
        )

        mesh, ref_image = self.gen_shape(image, mv_images, prompt, **kwargs)
        t0 = time.time()
        mesh = FloaterRemover()(mesh)
        mesh = DegenerateFaceRemover()(mesh)
        mesh = FaceReducer()(mesh)
        textured = self.tex_pipe(mesh, ref_image)
        textured.metadata.update(mesh.metadata)
        textured.metadata.setdefault("stats", {})["texture_total"] = time.time() - t0
        return textured

    def export(self, mesh, file_type="glb", reduce_faces=None):
        from hunyuan3d2_tpu_torch.geometry.postprocess import FaceReducer

        if file_type not in EXPORT_TYPES:
            raise ValueError(f"file_type must be one of {EXPORT_TYPES}")
        if reduce_faces:
            mesh = FaceReducer()(mesh, max_facenum=int(reduce_faces))
        path = os.path.join(tempfile.gettempdir(), f"hy3d_{uuid.uuid4().hex[:8]}.{file_type}")
        mesh.export(path)
        return path

    def html_viewer(self, glb_path):
        """Write a <model-viewer> page for the GLB beside it."""
        out = os.path.splitext(glb_path)[0] + ".html"
        with open(out, "w") as fh:
            fh.write(HTML_VIEWER.format(src=os.path.basename(glb_path)))
        return out


def _stats_markdown(mesh):
    stats = mesh.metadata.get("stats", {})
    lines = ["| stage | seconds |", "|---|---|"]
    lines += [f"| {k} | {v:.2f} |" for k, v in stats.items() if isinstance(v, (int, float))]
    return "\n".join(lines)


def build_ui(worker):
    import gradio as gr

    with gr.Blocks(title="Hunyuan3D-2 (PyTorch)") as demo:
        with gr.Row():
            with gr.Column(scale=1):
                with gr.Tabs():
                    with gr.Tab("Image to 3D"):
                        image = gr.Image(type="pil", label="Input image", image_mode="RGBA")
                    with gr.Tab("Text to 3D"):
                        prompt = gr.Textbox(label="Prompt", interactive=worker.t2i is not None,
                                            placeholder="launch with --enable_t23d"
                                            if worker.t2i is None else "a prompt")
                    with gr.Tab("MultiView to 3D"):
                        mv_front = gr.Image(type="pil", label="front", image_mode="RGBA")
                        mv_left = gr.Image(type="pil", label="left", image_mode="RGBA")
                        mv_back = gr.Image(type="pil", label="back", image_mode="RGBA")
                        mv_right = gr.Image(type="pil", label="right", image_mode="RGBA")
                with gr.Accordion("Options", open=True):
                    steps = gr.Slider(1, 100, value=30, step=1, label="Steps")
                    guidance = gr.Slider(0, 15, value=5.0, label="Guidance scale")
                    seed = gr.Number(value=1234, label="Seed")
                    octree = gr.Slider(64, 512, value=256, step=16, label="Octree resolution")
                with gr.Accordion("Export", open=False):
                    ftype = gr.Dropdown(list(EXPORT_TYPES), value="glb", label="File type")
                    reduce = gr.Checkbox(value=False, label="Reduce faces")
                    reduce_to = gr.Slider(1000, 200000, value=10000, step=1000,
                                          label="Target face count")
                btn_shape = gr.Button("Generate shape", variant="primary")
                btn_all = gr.Button("Generate shape + texture",
                                    interactive=worker.tex_pipe is not None)
            with gr.Column(scale=2):
                out = gr.Model3D(label="Result")
                html = gr.File(label="HTML viewer")
                stats_md = gr.Markdown(label="Stats")

        def _inputs(img, pr, f, l, b, r):
            mv = {k: v for k, v in {"front": f, "left": l, "back": b, "right": r}.items() if v}
            if mv:
                return dict(mv_images=mv)
            if img is None and pr:
                return dict(prompt=pr)
            return dict(image=img)

        def _finish(mesh, ftype, reduce, reduce_to):
            path = worker.export(mesh, ftype, int(reduce_to) if reduce else None)
            viewer = worker.html_viewer(path) if ftype == "glb" else None
            return path, viewer, _stats_markdown(mesh)

        def _shape(img, pr, f, l, b, r, steps, guidance, seed, octree, ftype, reduce, reduce_to):
            mesh, _ = worker.gen_shape(**_inputs(img, pr, f, l, b, r), steps=int(steps),
                                       guidance_scale=float(guidance), seed=int(seed),
                                       octree_resolution=int(octree))
            return _finish(mesh, ftype, reduce, reduce_to)

        def _all(img, pr, f, l, b, r, steps, guidance, seed, octree, ftype, reduce, reduce_to):
            mesh = worker.generation_all(**_inputs(img, pr, f, l, b, r), steps=int(steps),
                                         guidance_scale=float(guidance), seed=int(seed),
                                         octree_resolution=int(octree))
            return _finish(mesh, ftype, reduce, reduce_to)

        ins = [image, prompt, mv_front, mv_left, mv_back, mv_right, steps, guidance, seed,
               octree, ftype, reduce, reduce_to]
        outs = [out, html, stats_md]
        btn_shape.click(_shape, ins, outs)
        btn_all.click(_all, ins, outs)
    return demo


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model_path", default="tencent/Hunyuan3D-2")
    ap.add_argument("--subfolder", default="hunyuan3d-dit-v2-0")
    ap.add_argument("--texgen_model_path", default="tencent/Hunyuan3D-2")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--enable_t23d", action="store_true")
    ap.add_argument("--disable_tex", action="store_true")
    ap.add_argument("--enable_flashvdm", action="store_true")
    ap.add_argument("--mc_algo", default="mc")
    ap.add_argument("--low_vram_mode", action="store_true",
                    help="keep the shape stack's weights on the host between calls")
    ap.add_argument("--random-weights", dest="random_weights", action="store_true")
    args = ap.parse_args(argv)
    try:
        import gradio  # noqa: F401
    except ImportError:
        print("gradio is not installed; the UI cannot launch. The same backend serves HTTP: "
              "python -m hunyuan3d2_tpu_torch.apps.api_server", file=sys.stderr)
        sys.exit(2)
    worker = GradioWorker(args)
    build_ui(worker).launch(server_name=args.host, server_port=args.port)


if __name__ == "__main__":
    main()

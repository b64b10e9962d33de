"""HTTP model server on the PyTorch port: image or text → (textured) mesh
file (port of apps/api_server.py).

Routes, with the reference server's JSON contracts: POST /generate answers
with the file; POST /send starts the job and answers ``{"uid"}``; GET
/status/<uid> answers ``{"status": "processing" | "error", ...}`` or
``{"status": "completed", "model_base64"}``; GET /healthz. Request fields:
``image`` (base64), ``seed``, ``octree_resolution``, ``num_inference_steps``,
``guidance_scale``, ``mc_algo``, ``texture``, ``face_count`` and ``type``
(glb, obj, ply or stl). A ``text`` request (no ``image``) first makes the
image with utils/text2image.HunyuanDiTPipeline, built at the first such
request from ``$HY3D_T2I_MODEL`` (with random weights: the tiny
random-weight pipeline). A textured request runs the mesh postprocess
(floaters, degenerate faces, a face budget) before the paint stack.

    python -m hunyuan3d2_tpu_torch.apps.api_server --random-weights --device cpu
    python -m hunyuan3d2_tpu_torch.apps.api_server --model_path <dir> --enable_tex
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import logging
import logging.handlers
import os
import tempfile
import threading
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

SAVE_DIR = tempfile.gettempdir()
OUTPUT_TYPES = ("glb", "obj", "ply", "stl")
logger = logging.getLogger("hy3d_api")


def build_logger(log_dir: str = None):
    fmt = logging.Formatter("[%(asctime)s] %(levelname)s %(message)s")
    logger.setLevel(logging.INFO)
    sh = logging.StreamHandler()
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        fh = logging.handlers.TimedRotatingFileHandler(os.path.join(log_dir, "api_server.log"),
                                                       when="D", utc=True)
        fh.setFormatter(fmt)
        logger.addHandler(fh)


class ModelWorker:
    """The shape pipeline (FlashVDM decode, ``mc`` extraction) and, with
    ``enable_tex``, the paint pipeline, on ``device`` (``cuda`` unless the
    caller passes another). Up to ``limit_model_concurrency`` requests are
    admitted at once; they take the pipelines one at a time."""

    def __init__(self, model_path="tencent/Hunyuan3D-2", subfolder="hunyuan3d-dit-v2-0",
                 enable_tex=False, random_weights=False, tex_model_path=None,
                 limit_model_concurrency: int = 5, device=None):
        from hunyuan3d2_tpu_torch import Hunyuan3DDiTFlowMatchingPipeline, Hunyuan3DPaintPipeline

        if random_weights:
            pipeline = Hunyuan3DDiTFlowMatchingPipeline.init_random(
                size=os.environ.get("HY3D_RANDOM_SIZE", "mini"), dino="tiny", device=device)
        else:
            pipeline = Hunyuan3DDiTFlowMatchingPipeline.from_pretrained(
                model_path, subfolder=subfolder, device=device)
        pipeline_tex = None
        if enable_tex:
            if random_weights:
                pipeline_tex = Hunyuan3DPaintPipeline.init_random(device=device)
            else:
                pipeline_tex = Hunyuan3DPaintPipeline.from_pretrained(
                    tex_model_path or model_path, device=device)
        self._setup(pipeline, pipeline_tex, limit_model_concurrency, random_weights)

    @classmethod
    def from_pipelines(cls, pipeline, pipeline_tex=None, limit_model_concurrency: int = 5,
                       random_weights: bool = False):
        """A worker serving pipelines the caller already holds. The text →
        image pipeline is built at the first text request: the tiny
        random-weight one with ``random_weights``."""
        worker = cls.__new__(cls)
        worker._setup(pipeline, pipeline_tex, limit_model_concurrency, random_weights)
        return worker

    def _setup(self, pipeline, pipeline_tex, limit_model_concurrency, random_weights=False):
        from hunyuan3d2_tpu_torch.utils.rembg import BackgroundRemover

        self.worker_id = str(uuid.uuid4())[:6]
        self.model_semaphore = threading.Semaphore(limit_model_concurrency)
        self._pipeline_lock = threading.Lock()
        self._t2i_lock = threading.Lock()
        self.rembg = BackgroundRemover()
        self.pipeline = pipeline
        self.pipeline.enable_flashvdm(True, mc_algo="mc")
        self.pipeline_tex = pipeline_tex
        self.pipeline_t2i = None
        self.random_weights = random_weights

    def text_to_image(self, text: str, seed: int = 0):
        """The prompt's image, from the t2i pipeline built at the first call
        (under a lock: concurrent requests would each load it)."""
        with self._t2i_lock:
            if self.pipeline_t2i is None:
                from hunyuan3d2_tpu_torch.utils.text2image import HunyuanDiTPipeline, port_backend

                device = self.pipeline.device
                self.pipeline_t2i = HunyuanDiTPipeline(
                    model_path=os.environ.get(
                        "HY3D_T2I_MODEL", "Tencent-Hunyuan/HunyuanDiT-v1.1-Diffusers-Distilled"),
                    backend=port_backend(None, device) if self.random_weights else None,
                    device=device)
        return self.pipeline_t2i(text, seed=seed)

    def generate(self, uid: str, params: dict) -> str:
        """Run one request; returns the written file's path. Bad input raises
        ValueError."""
        with self.model_semaphore:
            return self._generate(uid, params)

    def _generate(self, uid: str, params: dict) -> str:
        from PIL import Image, UnidentifiedImageError

        from hunyuan3d2_tpu_torch.geometry.postprocess import (
            DegenerateFaceRemover,
            FaceReducer,
            FloaterRemover,
        )

        out_type = params.get("type", "glb")
        if out_type not in OUTPUT_TYPES:
            raise ValueError(f"type must be one of {OUTPUT_TYPES}, got {out_type!r}")
        if "image" in params:
            try:
                image = Image.open(io.BytesIO(base64.b64decode(params["image"])))
                image.load()
            except (ValueError, UnidentifiedImageError) as e:
                raise ValueError(f"image is not a base64-encoded image: {e}") from e
        elif "text" in params:
            image = self.text_to_image(str(params["text"]), seed=params.get("seed", 0))
        else:
            raise ValueError("No input image or text provided")
        image = self.rembg(image)
        with self._pipeline_lock:
            mesh = self.pipeline(
                image=image, seed=params.get("seed", 1234),
                octree_resolution=params.get("octree_resolution", 128),
                num_inference_steps=params.get("num_inference_steps", 5),
                guidance_scale=params.get("guidance_scale", 5.0),
                mc_algo=params.get("mc_algo", "mc"))[0]
            if mesh is None:
                raise RuntimeError("no surface was extracted")
            if params.get("texture", False) and self.pipeline_tex is not None:
                mesh = FloaterRemover()(mesh)
                mesh = DegenerateFaceRemover()(mesh)
                mesh = FaceReducer()(mesh, max_facenum=params.get("face_count", 40000))
                mesh = self.pipeline_tex(mesh, image)
        path = os.path.join(SAVE_DIR, f"{uid}.{out_type}")
        mesh.export(path)
        return path


def make_handler(worker: ModelWorker):
    """The request handler class serving ``worker``, with its own job table."""
    status = {}   # uid → {"status": ..., "path" | "message": ...}

    def run_job(uid: str, params: dict):
        try:
            status[uid] = {"status": "completed", "path": worker.generate(uid, params)}
        except Exception as e:  # noqa: BLE001 — a failed job is reported, the server goes on
            logger.exception("generation failed")
            status[uid] = {"status": "error", "message": str(e)}

    class Handler(BaseHTTPRequestHandler):
        def _json(self, code: int, obj: dict):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _file(self, path: str):
            with open(path, "rb") as fh:
                data = fh.read()
            self.send_response(200)
            self.send_header("Content-Type", "model/gltf-binary")
            self.send_header("Content-Disposition",
                             f'attachment; filename="{os.path.basename(path)}"')
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def log_message(self, fmt, *args):
            logger.info("%s " + fmt, self.address_string(), *args)

        def do_GET(self):
            if self.path.startswith("/status/"):
                st = status.get(self.path.split("/status/", 1)[1])
                if st is None:
                    return self._json(404, {"status": "not_found"})
                if st["status"] == "completed":
                    with open(st["path"], "rb") as fh:
                        b64 = base64.b64encode(fh.read()).decode()
                    return self._json(200, {"status": "completed", "model_base64": b64})
                return self._json(200, st)
            if self.path == "/healthz":
                return self._json(200, {"status": "ok", "worker_id": worker.worker_id})
            return self._json(404, {"error": "unknown route"})

        def do_POST(self):
            length = int(self.headers.get("Content-Length", 0))
            try:
                params = json.loads(self.rfile.read(length) or b"{}")
            except json.JSONDecodeError:
                return self._json(400, {"error": "invalid json"})
            if not isinstance(params, dict):
                return self._json(400, {"error": "the request body must be a JSON object"})
            uid = str(uuid.uuid4())
            if self.path == "/generate":
                try:
                    return self._file(worker.generate(uid, params))
                except ValueError as e:
                    return self._json(400, {"error": str(e)})
                except Exception as e:  # noqa: BLE001 — answer 500 and keep serving
                    logger.exception("generate failed")
                    return self._json(500, {"error": str(e)})
            if self.path == "/send":
                # Entered before the answer, so a /status poll never misses the job.
                status[uid] = {"status": "processing"}
                threading.Thread(target=run_job, args=(uid, params), daemon=True).start()
                return self._json(200, {"uid": uid})
            return self._json(404, {"error": "unknown route"})

    return Handler


def serve(worker: ModelWorker, host: str = "0.0.0.0", port: int = 8081) -> ThreadingHTTPServer:
    """A bound server for ``worker``; the caller runs ``serve_forever`` and
    ends it with ``shutdown`` and ``server_close``."""
    return ThreadingHTTPServer((host, port), make_handler(worker))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8081)
    ap.add_argument("--model_path", default="tencent/Hunyuan3D-2")
    ap.add_argument("--subfolder", default="hunyuan3d-dit-v2-0")
    ap.add_argument("--tex_model_path", default=None,
                    help="paint checkpoint path (defaults to --model_path)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--limit-model-concurrency", type=int, default=5)
    ap.add_argument("--enable_tex", action="store_true")
    ap.add_argument("--random-weights", action="store_true",
                    help="random weights from a seed (no checkpoint)")
    ap.add_argument("--log_dir", default=None)
    args = ap.parse_args(argv)

    build_logger(args.log_dir)
    worker = ModelWorker(args.model_path, args.subfolder, args.enable_tex, args.random_weights,
                         tex_model_path=args.tex_model_path,
                         limit_model_concurrency=args.limit_model_concurrency,
                         device=args.device)
    server = serve(worker, args.host, args.port)
    logger.info("serving on %s:%d (worker %s)", args.host, args.port, worker.worker_id)
    try:
        server.serve_forever()
    finally:
        server.server_close()


if __name__ == "__main__":
    main()

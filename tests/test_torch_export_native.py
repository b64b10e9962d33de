"""The port's native exporter (hunyuan3d2_tpu_torch/tools/export_native.py)
against scripts/export_native.py: the same HY3DW001 file, byte for byte,
from the same tiny random weights; the same tensors from the same
checkpoint loaded in fp32 by both packages; and (slow, as
tests/test_native_driver.py) the standalone C++ driver run on the port's
file, its stage stats against the port's own pipeline."""

import filecmp
import os
import re
import struct
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from hunyuan3d2_tpu.pipelines.shapegen import Hunyuan3DDiTFlowMatchingPipeline as JPipe
from hunyuan3d2_tpu_torch.io import convert
from hunyuan3d2_tpu_torch.pipelines.shapegen import Hunyuan3DDiTFlowMatchingPipeline as TPipe
from hunyuan3d2_tpu_torch.tools import export_native
from tests.test_torch_loading import SUB, _config, _published_sd, _write

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
import export_native as jax_export  # noqa: E402  (scripts/export_native.py)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def read_weights(path) -> dict:
    """A HY3DW001 file → {name: float32 array}, in file order."""
    out = {}
    with open(path, "rb") as fh:
        assert fh.read(8) == b"HY3DW001"
        (count,) = struct.unpack("<q", fh.read(8))
        for _ in range(count):
            (n,) = struct.unpack("<i", fh.read(4))
            name = fh.read(n).decode()
            dtype, ndim = struct.unpack("<ii", fh.read(8))
            assert dtype == 0
            dims = struct.unpack(f"<{ndim}q", fh.read(8 * ndim))
            size = int(np.prod(dims)) if ndim else 1
            out[name] = np.frombuffer(fh.read(4 * size), np.float32).reshape(dims)
    return out


@pytest.fixture(scope="module")
def pair():
    """The JAX tiny pipeline (init_random, dino 'tiny') and the port's with
    its weights."""
    jp = JPipe.init_random(jax.random.PRNGKey(0), size="tiny", dino="tiny")
    tp = TPipe.init_random(size="tiny", dino="tiny", device="cpu")
    convert.load_numpy_state_dict(tp.model, convert.dit_state_dict(
        jax.device_get(jp.model_params), jp.model_cfg))
    convert.load_numpy_state_dict(tp.vae, convert.shapevae_state_dict(
        jax.device_get(jp.vae.params), jp.vae.cfg))
    convert.load_numpy_state_dict(tp.conditioner.main.model, convert.dinov2_state_dict(
        jax.device_get(jp.conditioner.main.params), jp.conditioner.main.cfg.dino, prefix=""))
    return jp, tp


def test_export_equals_the_jax_exporter_byte_for_byte(pair, tmp_path):
    jp, tp = pair
    jax_export.export_pipeline(jp, str(tmp_path / "jax.hy3dw"))
    tensors = export_native.export_pipeline(tp, str(tmp_path / "port.hy3dw"))
    assert filecmp.cmp(str(tmp_path / "jax.hy3dw"), str(tmp_path / "port.hy3dw"), shallow=False)
    assert list(tensors)[-3:] == ["cfg/dino", "cfg/dit", "cfg/vae"]
    # per-layer parameters stacked on a leading axis, Linear weights [in, out]
    assert tensors["dit/double_blocks/img_qkv/w"].shape == (
        tp.model.cfg.depth, tp.model.cfg.hidden_size, 3 * tp.model.cfg.hidden_size)


def test_trees_invert_the_state_dict_maps(pair):
    """io/convert.py's dit_tree / shapevae_tree / dinov2_tree are the inverse
    of its *_state_dict maps."""
    jp, tp = pair
    for tree_fn, sd_fn, module, params, cfg in (
            (convert.dit_tree, convert.dit_state_dict, tp.model, jp.model_params, jp.model_cfg),
            (convert.shapevae_tree, convert.shapevae_state_dict, tp.vae, jp.vae.params,
             jp.vae.cfg),
            (convert.dinov2_tree, lambda p, c: convert.dinov2_state_dict(p, c, prefix=""),
             tp.conditioner.main.model, jp.conditioner.main.params,
             jp.conditioner.main.cfg.dino)):
        tree = tree_fn(module.state_dict(), cfg)
        ref = jax.tree_util.tree_leaves_with_path(jax.device_get(params))
        got = jax.tree_util.tree_leaves_with_path(tree)
        assert [p for p, _ in got] == [p for p, _ in ref]
        for (path, a), (_, b) in zip(got, ref):
            np.testing.assert_array_equal(a, np.asarray(b, np.float32), err_msg=str(path))
        back = sd_fn(tree, cfg)
        assert sorted(back) == sorted(module.state_dict())


def test_export_from_a_checkpoint_in_fp32(pair, tmp_path):
    """Both packages load one fp16 checkpoint with fp32 weights: the two
    files hold the same tensors, bit for bit (the JAX exporter writes a
    loaded tree in its loader's order, the port in sorted order). One entry
    differs: the SwiGLU width in cfg/dino, which the JAX loader takes from
    its DinoConfig default (4096, the giant tower's) and the port's loader
    from the checkpoint's FFN weights (256 in this tiny tower)."""
    jp, _ = pair
    _write(str(tmp_path), _published_sd(jp), _config(jp), "safetensors")
    jl = JPipe.from_pretrained(str(tmp_path), subfolder=SUB, dtype=np.float32)
    tl = TPipe.from_pretrained(str(tmp_path), subfolder=SUB, device="cpu", dtype=torch.float32)
    jax_export.export_pipeline(jl, str(tmp_path / "jax.hy3dw"))
    export_native.export_pipeline(tl, str(tmp_path / "port.hy3dw"))
    a, b = read_weights(tmp_path / "jax.hy3dw"), read_weights(tmp_path / "port.hy3dw")
    a["cfg/dino"] = a["cfg/dino"].copy()
    assert sorted(a) == sorted(b)
    ffn = b["dino/layers/ffn_out/w"].shape[1]
    assert (a["cfg/dino"][5], b["cfg/dino"][5]) == (4096, ffn) and ffn == 256
    a["cfg/dino"][5] = ffn
    for name in a:
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)
    assert list(b) == sorted(b, key=lambda n: (n.startswith("cfg/"), n.split("/")[0] != "dino",
                                               n.split("/")[0] != "dit", n))


def test_command_line_writes_the_file(tmp_path):
    out = str(tmp_path / "m.hy3dw")
    export_native.main(["--out", out, "--size", "tiny", "--dino", "tiny"])
    names = read_weights(out)
    assert names["cfg/dino"].tolist() == [1536, 2, 24, 14, 112, 256, 1]
    assert names["cfg/vae"][0] == 64


def _parse_stats(stdout: str) -> dict:
    out = {}
    for m in re.finditer(r"\[stats\] (\S+)\s+\[[\d,]+\] min: (\S+) max: (\S+) mean: (\S+)",
                         stdout):
        out[m.group(1)] = tuple(float(m.group(i)) for i in (2, 3, 4))
    return out


@pytest.mark.slow
@pytest.mark.filterwarnings("ignore")
def test_standalone_driver_runs_the_port_export(pair, tmp_path):
    """tests/test_native_driver.py on the port's file: the driver is built
    with its Makefile's flags into the test's directory, run on the export
    with fixed initial latents, and its stats held to the port's pipeline
    with that test's tolerances."""
    from PIL import Image

    src = os.path.join(REPO, "hunyuan3d2_tpu", "native", "standalone")
    binary = str(tmp_path / "hy3d_infer")
    subprocess.run(["g++", "-O3", "-march=native", "-std=c++17", "-fopenmp", "-Wall",
                    os.path.join(src, "main.cpp"), os.path.join(src, "..", "hy3dnative.cpp"),
                    "-o", binary], check=True, capture_output=True)
    _, tp = pair
    wfile = str(tmp_path / "model.hy3dw")
    export_native.export_pipeline(tp, wfile)
    im = np.full((512, 512, 3), 255, np.uint8)
    im[100:412, 100:412] = [90, 120, 220]
    ppm = str(tmp_path / "in.ppm")
    with open(ppm, "wb") as fh:
        fh.write(b"P6\n512 512\n255\n")
        fh.write(im.tobytes())
    lat = np.random.RandomState(7).randn(tp.vae.cfg.num_latents,
                                         tp.vae.cfg.embed_dim).astype(np.float32)
    latf = str(tmp_path / "init.f32")
    lat.tofile(latf)
    obj = str(tmp_path / "mesh.obj")
    r = subprocess.run([binary, "--weights", wfile, "--image", ppm, "--latents", latf,
                        "--steps", "3", "--guidance", "5.0", "--octree", "32", "--output", obj],
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stderr[-2000:]
    stats = _parse_stats(r.stdout)
    assert {"pixels", "cond", "latents", "vae_hidden", "grid_logits"} <= set(stats)

    alpha = np.where((im == 255).all(-1, keepdims=True), 0, 255).astype(np.uint8)
    img = Image.fromarray(np.concatenate([im, alpha], axis=-1), "RGBA")
    tp.prepare_latents = lambda batch_size, generator: torch.from_numpy(lat[None])
    with torch.no_grad():
        la = tp(img, num_inference_steps=3, guidance_scale=5.0, output_type="latents").numpy()
        grid = tp.vae.decode_grid(torch.from_numpy(la), octree_resolution=32,
                                  num_chunks=65536).numpy()
    got = stats["latents"]
    assert abs(got[0] - la.min()) < 0.05 and abs(got[1] - la.max()) < 0.05
    assert abs(got[2] - la.mean()) < 0.01
    gg = stats["grid_logits"]
    assert abs(gg[0] - grid.min()) < 0.1 and abs(gg[1] - grid.max()) < 0.1
    assert abs(gg[2] - grid.mean()) < 0.02

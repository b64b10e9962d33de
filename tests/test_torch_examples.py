"""The port's examples (hunyuan3d2_tpu_torch/examples/), one per
examples/*.py with the same name and the same output files, each run on the
CPU through ``main(device="cpu")`` with ``HY3D_RANDOM_WEIGHTS=1`` (tiny
random-weight pipelines); every artifact must read back as a mesh. The
textured examples run here at a test size (``_cut_to_test_size``)."""

import importlib
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples")
PORT_EXAMPLES = os.path.join(REPO, "hunyuan3d2_tpu_torch", "examples")

# script → artifact paths, relative to the working directory (the JAX
# package's tests/test_examples.py CASES; text_to_3d is given its directory)
CASES = {
    "shape_gen.py": ["shape_gen.glb"],
    "shape_gen_mini.py": ["demo_mini.glb"],
    "shape_gen_mv.py": ["shape_gen_mv.glb"],
    "shape_gen_multiview.py": ["demo_mv.glb"],
    "fast_shape_gen_with_flashvdm.py": ["fast_shape_gen.glb"],
    "fast_shape_gen_multiview.py": ["demo_mv3.glb"],
    "faster_shape_gen_with_flashvdm_mini_turbo.py": [
        "tmp/results/run_0.glb", "tmp/results/run_1.glb"],
    "fast_texture_gen_multiview.py": ["fast_texture_gen.glb"],
    "text_to_3d.py": ["tmp/results/text_to_3d.glb"],
    "textured_shape_gen.py": ["textured_shape_gen.glb"],
    "textured_shape_gen_mini.py": ["demo_mini.glb", "demo_textured_mini.glb"],
    "textured_shape_gen_multiview.py": ["demo_white_mesh_mv.glb", "demo_textured_mv.glb"],
}
TEXTURED = {"fast_texture_gen.glb", "textured_shape_gen.glb", "demo_textured_mini.glb",
            "demo_textured_mv.glb"}


def _cut_to_test_size(monkeypatch):
    """The examples' random branches keep the JAX examples' sizes: octree 64
    and 64² views painted into a 256² texture. Here the shape pipeline
    decodes at octree 16 (the noise mesh at 64 has ~227k faces, whose host
    UV unwrap alone takes ~26 s on the CPU; at 16, ~5k) and the paint stack
    takes 32² views into a 64² texture."""
    from hunyuan3d2_tpu_torch.pipelines.shapegen import Hunyuan3DDiTFlowMatchingPipeline
    from hunyuan3d2_tpu_torch.pipelines.texgen import Hunyuan3DPaintPipeline

    init = Hunyuan3DPaintPipeline.init_random.__func__
    call = Hunyuan3DDiTFlowMatchingPipeline.__call__
    monkeypatch.setattr(Hunyuan3DPaintPipeline, "init_random", classmethod(
        lambda cls, **kw: init(cls, **{**kw, "view_size": 32, "render_size": 64,
                                       "texture_size": 64})))
    monkeypatch.setattr(Hunyuan3DDiTFlowMatchingPipeline, "__call__",
                        lambda self, *a, **kw: call(self, *a, **{**kw, "octree_resolution": 16}))


def test_port_examples_cover_the_examples():
    """One port example per examples/*.py, by name, and a case for each."""
    ported = {f for f in os.listdir(PORT_EXAMPLES) if f.endswith(".py") and not f.startswith("_")}
    originals = {f for f in os.listdir(EXAMPLES) if f.endswith(".py")}
    assert ported == originals == set(CASES)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread a test: the suite runs several workers on the
    host's cores, and torch's many small CPU calls slow down many times over
    when every worker spins up a thread per core."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("script", sorted(CASES))
def test_port_example_runs_and_exports(script, tmp_path, monkeypatch):
    from hunyuan3d2_tpu_torch.geometry.mesh import Mesh

    artifacts = [str(tmp_path / a) for a in CASES[script]]
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("HY3D_RANDOM_WEIGHTS", "1")
    monkeypatch.delenv("HY3D_T2I_MODEL", raising=False)
    if TEXTURED.intersection(map(os.path.basename, artifacts)):
        _cut_to_test_size(monkeypatch)
    module = importlib.import_module(f"hunyuan3d2_tpu_torch.examples.{script[:-3]}")
    # text_to_3d writes under the repository by default (as the JAX example)
    kwargs = {"out_dir": str(tmp_path / "tmp" / "results")} if script == "text_to_3d.py" else {}
    module.main(device="cpu", **kwargs)
    for a in artifacts:
        assert os.path.getsize(a) > 100, f"{script}: empty artifact {a}"
        mesh = Mesh.load(a)
        assert len(mesh.vertices) > 0 and len(mesh.faces) > 0, f"{script}: {a} loaded empty"
        if os.path.basename(a) in TEXTURED:
            assert mesh.texture is not None and mesh.uv is not None, f"{script}: {a} untextured"

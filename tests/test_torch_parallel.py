"""The port's tensor and data parallelism (hunyuan3d2_tpu_torch/parallel: mesh,
collectives, sharding, diagnostics; the sharded train step; the shape
pipeline's shard()) against the JAX package's (hunyuan3d2_tpu/parallel), on
the CPU.

The port's side runs once, on 4 gloo ranks spawned by a module-scoped
fixture (tests/torch_parallel_cases.py, which imports no JAX); the ranks
return numpy arrays that the parametrised tests below hold. The JAX side
runs in this process on the virtual 8-device CPU mesh that
tests/conftest.py sets up. Weights come from the JAX package's init,
carried across by io/convert.py; inputs from np.random.RandomState.

Tolerances are those of the JAX package's own tests of the same functions:
the dp2×tp2 forward within 2e-2 of the single-device JAX forward and of
the JAX forward sharded dp2×tp2 (tests/test_parallel.py), the sharded shape pipeline's latents
within 5e-2 of the unsharded ones (tests/test_pipeline_sharded.py); the
sharded train step against the single-process port step within
tests/test_torch_training.py's (loss 2e-3 relative; gradients within 5 % of
their largest value and correlated above 0.999; at most 0.5 % of the bf16
weights more than one ulp apart after one step).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from hunyuan3d2_tpu.models import clip_vit as jclip
from hunyuan3d2_tpu.models import dinov2 as jdino
from hunyuan3d2_tpu.models import dit as jdit
from hunyuan3d2_tpu.models import paint_unet as jpu
from hunyuan3d2_tpu.models import sd_vae as jvae
from hunyuan3d2_tpu.models import shapevae as jsv
from hunyuan3d2_tpu.parallel import make_mesh as jax_make_mesh
from hunyuan3d2_tpu.parallel import shard_batch as jax_shard_batch
from hunyuan3d2_tpu.parallel import shard_params as jax_shard_params
from hunyuan3d2_tpu.parallel.sharding import dit_param_spec as jax_param_spec
from hunyuan3d2_tpu_torch.io import convert
from hunyuan3d2_tpu_torch.models import clip_vit, dinov2, dit, paint_unet, sd_vae, shapevae
from hunyuan3d2_tpu_torch.ops.nn import build
from hunyuan3d2_tpu_torch.parallel import diagnostics, dit_param_spec, mesh
from hunyuan3d2_tpu_torch.training import make_train_step
from tests import torch_parallel_cases as cases

# tests/test_parallel.py's config
CFG = jdit.DiTConfig(in_channels=16, context_in_dim=32, hidden_size=128, num_heads=8, depth=2,
                     depth_single_blocks=2)


def _inputs():
    rs = np.random.RandomState(0)
    return (rs.randn(4, 8, 16).astype(np.float32), rs.rand(4).astype(np.float32),
            rs.randn(4, 12, 32).astype(np.float32))


def _train_inputs():
    x, _, cond = _inputs()
    rs = np.random.RandomState(1)
    return x, cond, rs.randn(*x.shape).astype(np.float32), rs.rand(4).astype(np.float32)


@pytest.fixture(scope="module")
def params():
    return jax.device_get(jax.jit(jdit.init, static_argnums=1)(jax.random.PRNGKey(0), CFG))


@pytest.fixture(scope="module")
def ranks(params, tmp_path_factory):
    return cases.spawn_once(tmp_path_factory, "parallel_cases", cases.parallel_cases, 4,
                            lambda: (convert.dit_state_dict(params, CFG),
                                     dataclasses.asdict(CFG), _inputs(), _train_inputs(),
                                     str(tmp_path_factory.mktemp("traces"))))


@pytest.fixture(scope="module")
def jax_forwards(params):
    """JAX's single-device forward and its sharded forward at the port's
    layout, dp = 2 × tp = 2 (4 virtual devices: XLA:CPU runs a partition a
    thread and aborts when one misses its collective rendezvous window,
    which 8 partitions did under the suite's load)."""
    x, t, cond = (jnp.asarray(a) for a in _inputs())
    single = np.asarray(jdit.apply(params, CFG, x, t, cond), np.float32)
    jmesh = jax_make_mesh(4)
    sp = jax_shard_params(params, jmesh)
    sx, scond = jax_shard_batch((x, cond), jmesh)
    st = jax.device_put(t, NamedSharding(jmesh, P("dp")))
    with jmesh:
        sharded = jax.jit(lambda p, a, b, c: jdit.apply(p, CFG, a, b, c))(sp, sx, st, scond)
    return {"single": single, "sharded": np.asarray(sharded, np.float32)}


# ---------------------------------------------------------------------------
# (viii) the mesh
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8])
def test_mesh_shape_rule_matches_jax(n):
    assert mesh.mesh_shape(n) == tuple(jax_make_mesh(n).shape.values())


def test_make_mesh_on_ranks(ranks):
    r = ranks[0]["mesh"]
    assert r["default"] == (2, 2) and r["names"] == ("dp", "tp") and r["dp1"] == (1, 4)
    assert "8 ranks requested but only 4" in ranks[0]["too_few"]


@pytest.mark.parametrize("call", ["init_process_group", "make_mesh_cuda", "make_mesh_cpu",
                                  "pipeline_shard"])
def test_no_silent_fallback(call, monkeypatch):
    """NCCL on cuda is the default; without a card (or without a process
    group) these raise instead of falling back to gloo or the CPU."""
    from hunyuan3d2_tpu_torch.pipelines.hunyuanpaint import HunyuanPaintPipeline

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fn = {"init_process_group": mesh.init_process_group,
          "make_mesh_cuda": mesh.make_mesh,
          "make_mesh_cpu": lambda: mesh.make_mesh(device="cpu"),
          "pipeline_shard": lambda: HunyuanPaintPipeline.init_random(device="cpu").shard()}[call]
    with pytest.raises(RuntimeError, match="cuda|process group"):
        fn()


@pytest.mark.parametrize("call", ["make_mesh", "shard_params", "shard_batch"])
def test_unknown_axis_names_raise(call):
    """A mesh whose axes are not ("dp", "tp") (or ("dp", "pp")) raises, where
    looking its axes up by name would find none and leave the model whole
    on every rank."""
    import types

    from hunyuan3d2_tpu_torch.parallel import sharding

    foreign = types.SimpleNamespace(mesh_dim_names=("data", "model"))
    fn = {"make_mesh": lambda: mesh.make_mesh(axis_names=("data", "model"), device="cpu"),
          "shard_params": lambda: sharding.shard_params(torch.nn.Linear(2, 2), foreign),
          "shard_batch": lambda: sharding.shard_batch(torch.ones(2, 3), foreign)}[call]
    with pytest.raises(ValueError, match="dp"):
        fn()


# ---------------------------------------------------------------------------
# (i) the parameter classes
# ---------------------------------------------------------------------------
def _codes(shapes):
    """A tree of arrays shaped as ``shapes`` holding the JAX spec's class of
    each leaf: 1 column-parallel (last axis on tp), 2 row-parallel (the one
    before), 0 replicated."""

    def code(leaf, spec):
        s = list(spec)
        c = 1 if s and s[-1] == "tp" else 2 if len(s) >= 2 and s[-2] == "tp" else 0
        return np.full(leaf.shape, c, np.float32)

    return jax.tree.map(code, shapes, jax_param_spec(shapes))


def _port_cfg(cls, jcfg):
    return cls(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(cls)})


_DINO = jdino.DinoConfig(hidden_size=64, num_layers=2, num_heads=4, image_size=28,
                         swiglu_hidden=96)
_MODELS = {
    "dit": (lambda: jdit.init(jax.random.PRNGKey(0), CFG),
            lambda p: convert.dit_state_dict(p, CFG),
            lambda: dit.Hunyuan3DDiT(_port_cfg(dit.DiTConfig, CFG))),
    "dinov2": (lambda: jdino.init(jax.random.PRNGKey(0), _DINO),
               lambda p: convert.dinov2_state_dict(p, _DINO, prefix=""),
               lambda: dinov2.Dinov2Model(_port_cfg(dinov2.DinoConfig, _DINO))),
    "clip": (lambda: jclip.init(jax.random.PRNGKey(0), jclip.TINY),
             lambda p: convert.clip_vit_state_dict(p, jclip.TINY, prefix=""),
             lambda: clip_vit.CLIPVisionModel(_port_cfg(clip_vit.CLIPVisionConfig, jclip.TINY))),
    "shapevae": (lambda: jsv.init(jax.random.PRNGKey(0), jsv.TINY),
                 lambda p: convert.shapevae_state_dict(p, jsv.TINY),
                 lambda: shapevae.ShapeVAE(_port_cfg(shapevae.ShapeVAEConfig, jsv.TINY))),
    "paint_unet": (lambda: jpu.init(jax.random.PRNGKey(0), jpu.TINY),
                   convert.paint_unet_state_dict,
                   lambda: paint_unet.UNet2p5D(paint_unet.TINY)),
    "sd_vae": (lambda: jvae.init(jax.random.PRNGKey(0), jvae.TINY),
               convert.sd_vae_state_dict,
               lambda: sd_vae.AutoencoderKL(sd_vae.TINY)),
}


@pytest.mark.parametrize("model", sorted(_MODELS))
def test_param_spec_matches_jax(model):
    """Every weight of the port's module gets the class that the JAX spec
    gives the matching leaf (the leaf carried across by io/convert.py)."""
    jinit, to_sd, port = _MODELS[model]
    codes = to_sd(_codes(jax.eval_shape(jinit)))
    with torch.device("meta"):
        spec = dit_param_spec(port())
    assert sorted(spec) == sorted(codes)
    names = {0: "rep", 1: "col", 2: "row"}
    for name, cls in spec.items():
        vals = np.unique(codes[name])
        assert len(vals) == 1 and names[int(vals[0])] == cls, (name, vals, cls)
    assert {"col", "row"} <= set(spec.values())


# ---------------------------------------------------------------------------
# (ii) the dp2×tp2 forward, (vii) the collectives it moved
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("ref", ["single", "sharded"])
def test_sharded_forward_matches_jax(ranks, jax_forwards, ref):
    out = ranks[0]["forward"]
    assert out.shape == jax_forwards[ref].shape
    np.testing.assert_allclose(out, jax_forwards[ref], atol=2e-2, rtol=2e-2)


def test_sharded_forward_is_replicated_and_sharded(ranks):
    """Every rank ends with the same whole output; each holds its shards
    (the replicated embeddings and norms aside, well under 60 % of the
    weights at tp = 2)."""
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["forward"], ranks[0]["forward"])
    assert ranks[0]["local_param_bytes"] < 0.6 * ranks[0]["param_bytes"]


def test_collective_tally_and_trace(ranks):
    """One forward: an all-reduce per row-parallel layer (4 a double block, 1
    a single block), an all-gather per adaLN modulation (2 a double block, 1
    a single block, 1 final) and one for the dp gather of the output; the
    trace's gloo events count the same, and carry no bytes, so the bound
    refuses them. The tally's all-gather bytes are the gathered result's
    (two ranks' [3, 5] fp32: 120 bytes), as the JAX HLO stats count them."""
    stats = ranks[0]["forward_stats"]
    assert stats["all-reduce"][0] == 2 * 4 + 2 * 1
    assert stats["all-gather"][0] == 2 * 2 + 2 * 1 + 1 + 1
    trace = ranks[0]["forward_trace_stats"]
    assert {k: v[0] for k, v in trace.items()} == {k: v[0] for k, v in stats.items()}
    assert all(v[1] is None for v in trace.values())
    with pytest.raises(ValueError, match="no bytes"):
        diagnostics.assert_no_full_param_gather(trace, ranks[0]["param_bytes"], "trace")
    assert diagnostics.format_stats(stats).startswith("all-gather n=8 ")
    assert ranks[0]["gather_probe_stats"] == {"all-gather": (1, 2 * 3 * 5 * 4)}


@pytest.mark.parametrize("run", ["forward", "gathered"])
def test_no_full_param_gather(ranks, run):
    r = ranks[0]
    if run == "forward":
        diagnostics.assert_no_full_param_gather(r["forward_stats"], r["param_bytes"], run)
    else:
        # full_state_dict re-gathers every shard: exactly the weights, and
        # the bound sees it
        assert r["gathered_equal"]
        with pytest.raises(AssertionError, match="re-gathered"):
            diagnostics.assert_no_full_param_gather(r["gathered_stats"], r["param_bytes"], run)


# ---------------------------------------------------------------------------
# (iii) the sharded train step
# ---------------------------------------------------------------------------
def test_sharded_train_step_runs_and_decreases_loss(ranks):
    losses = ranks[0]["losses"]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    for r in ranks[1:]:
        assert r["losses"] == losses


@pytest.fixture(scope="module")
def single_step(params):
    model = convert.load_numpy_state_dict(
        build(dit.Hunyuan3DDiT, _port_cfg(dit.DiTConfig, CFG), device="cpu"),
        convert.dit_state_dict(params, CFG))
    _, step = make_train_step(model)
    lat, cond, x0, sigma = (torch.from_numpy(a) for a in _train_inputs())
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        loss = float(step(lat, cond, x0=x0, sigma=sigma))
    finally:
        torch.set_num_threads(n)
    return loss, {k: p.grad.float().numpy() for k, p in model.named_parameters()}, \
        {k: p.detach().float().numpy() for k, p in model.named_parameters()}


@pytest.mark.parametrize("what", ["loss", "gradients", "weights"])
def test_sharded_train_step_matches_single_process(ranks, single_step, what):
    loss, grads, weights = single_step
    r = ranks[0]
    if what == "loss":
        assert abs(r["losses"][0] - loss) <= 2e-3 * abs(loss), (r["losses"][0], loss)
    elif what == "gradients":
        assert sorted(r["grads"]) == sorted(grads)
        for name, ref in grads.items():
            out = r["grads"][name]
            err = np.abs(out - ref).max()
            assert err <= 0.05 * np.abs(ref).max(), (name, err)
            if ref.size > 1:
                assert np.corrcoef(out.ravel(), ref.ravel())[0, 1] > 0.999, name
    else:
        total = bad = 0
        for name, ref in weights.items():
            ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)
            bad += int((np.abs(r["weights_1"][name] - ref) > ulp).sum())
            total += ref.size
        assert bad <= 0.005 * total, (bad, total)


# ---------------------------------------------------------------------------
# (vi) the shape pipeline's shard()
# ---------------------------------------------------------------------------
def test_sharded_shape_pipeline_matches_unsharded(ranks):
    r = ranks[0]
    assert r["pipe_mesh"] == (2, 2)
    # the tiny DiT's 4 heads, the tiny DINOv2's 24 and the tiny VAE's 4, halved
    assert r["pipe_local_heads"] == (2, 12, 2)
    ref, lat = r["pipe_latents"]
    assert lat.shape == ref.shape and np.isfinite(lat).all()
    np.testing.assert_allclose(lat, ref, atol=5e-2, rtol=5e-2)
    assert r["pipe_mesh_faces"] >= 0

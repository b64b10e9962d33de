"""The port's text → image path against the JAX package on the CPU:
HunyuanDiT (models/hunyuan_dit.py), the DDPM functions and the pipeline
(pipelines/t2i.py), the diffusers-layout loader (io/checkpoints.py) and the
front end (utils/text2image.py).

TINY configs with the same weights (the JAX pytree carried over by
io/convert.hunyuan_dit_state_dict) and the same inputs, made with numpy from
a seed. The pipelines draw noise differently, so the JAX draws (key 0 split
once for the initial latents, then once per step) are replayed outside the
jit and injected into the port's loop. Tolerances: the transformer in bf16
within 5 % of the output scale (with correlation ≥ 0.999); fp32 text
context and pool 1e-5; DDPM tables equal, a step within 1e-6; images
correlation ≥ 0.99 and mean |Δ| ≤ 3 levels.
"""

import dataclasses
import json
import logging
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hunyuan3d2_tpu.models import hunyuan_dit as jdit
from hunyuan3d2_tpu.models import sd_vae as jvae
from hunyuan3d2_tpu.pipelines import t2i as jt2i
from hunyuan3d2_tpu_torch.io.convert import (
    hunyuan_dit_state_dict,
    load_numpy_state_dict,
    sd_vae_state_dict,
)
from hunyuan3d2_tpu_torch.models import hunyuan_dit as tdit
from hunyuan3d2_tpu_torch.models import sd_vae as tvae
from hunyuan3d2_tpu_torch.ops.nn import build
from hunyuan3d2_tpu_torch.pipelines import t2i as tt2i

RES, STEPS = 64, 4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread a test: the suite runs several workers on the
    host's cores, and torch's many small CPU calls slow down many times over
    when every worker spins up a thread per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(style_meta: bool):
    # depth 6: two skip blocks, so the order in which they take the skips shows
    jcfg = dataclasses.replace(jdit.TINY, depth=6, use_style_meta=style_meta)
    return jcfg, tdit.HunyuanDiTConfig(**dataclasses.asdict(jcfg))


@pytest.fixture(scope="module", params=[True, False], ids=["v1.0", "v1.1"])
def dit_pair(request):
    """(JAX params, JAX config, the port's module with those weights)."""
    jcfg, tcfg = _cfgs(request.param)
    params = jax.tree.map(np.asarray, jax.jit(jdit.init, static_argnums=1)(
        jax.random.PRNGKey(1), jcfg))
    module = build(tdit.HunyuanDiT2DModel, tcfg, device="cpu")
    load_numpy_state_dict(module, hunyuan_dit_state_dict(params, jcfg))
    return params, jcfg, module


def _text_states(cfg, seed, batch=1):
    rs = np.random.RandomState(seed)
    clip = rs.randn(batch, cfg.text_len, cfg.text_dim).astype(np.float32)
    t5 = rs.randn(batch, cfg.t5_len, cfg.t5_dim).astype(np.float32)
    cm = (rs.rand(batch, cfg.text_len) > 0.3).astype(np.float32)
    tm = (rs.rand(batch, cfg.t5_len) > 0.3).astype(np.float32)
    return clip, cm, t5, tm


def test_build_context_and_attention_pool_match_jax(dit_pair):
    params, cfg, module = dit_pair
    states = _text_states(cfg, 0, batch=2)
    ctx_j, pooled_j = jdit.build_context(params, cfg, *states)
    with torch.no_grad():
        ctx_t, pooled_t = module.build_context(*(torch.from_numpy(a) for a in states))
    assert ctx_t.dtype == pooled_t.dtype == torch.float32
    assert ctx_t.shape == (2, cfg.text_len + cfg.t5_len, cfg.text_dim)
    np.testing.assert_allclose(ctx_t.numpy(), np.asarray(ctx_j), atol=1e-5, rtol=0)
    np.testing.assert_allclose(pooled_t.numpy(), np.asarray(pooled_j), atol=1e-5, rtol=0)
    # masked rows are the learned padding rows
    mask = np.concatenate(states[1:4:2], axis=1)[0] == 0
    np.testing.assert_array_equal(ctx_t.numpy()[0][mask], params["text_embedding_padding"][mask])


@pytest.mark.parametrize("pag", [False, True])
def test_hunyuan_dit_forward_matches_jax(dit_pair, pag):
    params, cfg, module = dit_pair
    rs = np.random.RandomState(2)
    x = rs.randn(2, 8, 8, 4).astype(np.float32)
    t = np.array([999.0, 481.0], np.float32)
    meta = np.tile(np.array([[64, 64, 64, 64, 0, 0]], np.float32), (2, 1))
    ctx, pooled = jdit.build_context(params, cfg, *_text_states(cfg, 3, batch=2))
    ref = np.asarray(jdit.apply(params, cfg, jnp.asarray(x, jnp.bfloat16), jnp.asarray(t), ctx,
                                pooled, jnp.asarray(meta), pag=pag).astype(jnp.float32))
    with torch.no_grad():
        out = module(torch.from_numpy(x).bfloat16(), torch.from_numpy(t),
                     torch.from_numpy(np.asarray(ctx)), torch.from_numpy(np.asarray(pooled)),
                     torch.from_numpy(meta), pag=pag)
    assert out.dtype == torch.bfloat16 and out.shape == (2, 8, 8, cfg.out_channels)
    out = out.float().numpy()
    assert np.abs(out - ref).max() <= 0.05 * np.abs(ref).max()
    assert np.corrcoef(out.ravel(), ref.ravel())[0, 1] >= 0.999


def test_pag_branch_changes_only_the_pag_layers(dit_pair):
    """The perturbed branch differs from the plain one (layer 1 replaces its
    self-attention by V), and equals it when no layer is perturbed."""
    _, cfg, module = dit_pair
    rs = np.random.RandomState(4)
    x = torch.from_numpy(rs.randn(1, 8, 8, 4).astype(np.float32)).bfloat16()
    ctx, pooled = module.build_context(*(torch.from_numpy(a) for a in _text_states(cfg, 5)))
    t = torch.tensor([500.0])
    with torch.no_grad():
        plain, perturbed = (module(x, t, ctx, pooled, pag=p) for p in (False, True))
        module.cfg = dataclasses.replace(cfg, pag_layers=())
        try:
            none = module(x, t, ctx, pooled, pag=True)
        finally:
            module.cfg = cfg
    assert not torch.equal(plain, perturbed) and torch.equal(plain, none)


def test_rope_2d_and_apply_rope_match_jax():
    cos_j, sin_j = jdit.rope_2d(44, 6, 5)
    cos_t, sin_t = tdit.rope_2d(44, 6, 5)
    np.testing.assert_allclose(cos_t.numpy(), np.asarray(cos_j), atol=1e-6, rtol=0)
    np.testing.assert_allclose(sin_t.numpy(), np.asarray(sin_j), atol=1e-6, rtol=0)
    x = np.random.RandomState(6).randn(1, 2, 30, 44).astype(np.float32)
    ref = np.asarray(jdit._apply_rope(jnp.asarray(x), cos_j, sin_j))
    np.testing.assert_allclose(tdit.apply_rope(torch.from_numpy(x), cos_t, sin_t).numpy(), ref,
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("n", [1, 4, 25, 50])
def test_ddpm_tables_match_jax(n):
    jcfg, tcfg = jt2i.DDPMConfig(), tt2i.DDPMConfig()
    np.testing.assert_array_equal(tt2i.ddpm_timesteps(tcfg, n), jt2i.ddpm_timesteps(jcfg, n))
    np.testing.assert_array_equal(tt2i.ddpm_alphas_cumprod(tcfg), jt2i.ddpm_alphas_cumprod(jcfg))


@pytest.mark.parametrize("pred_type", ["v_prediction", "epsilon"])
@pytest.mark.parametrize("t,t_prev", [(961, 921), (41, 1), (1, -1)])
def test_ddpm_step_matches_jax(pred_type, t, t_prev):
    rs = np.random.RandomState(t)
    pred, sample, noise = (rs.randn(1, 8, 8, 4).astype(np.float32) for _ in range(3))
    acp = jt2i.ddpm_alphas_cumprod(jt2i.DDPMConfig())
    ref = np.asarray(jt2i.ddpm_step(jnp.asarray(pred), t, t_prev, jnp.asarray(sample),
                                    jnp.asarray(acp), jnp.asarray(noise), pred_type))
    out = tt2i.ddpm_step(torch.from_numpy(pred), t, t_prev, torch.from_numpy(sample),
                         torch.from_numpy(acp), torch.from_numpy(noise), pred_type)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6, rtol=0)


def _jax_draws(seed, gh, gw, steps):
    """The JAX loop's draws: key(seed) split once for x_T, then once per step."""
    key = jax.random.PRNGKey(seed)
    key, k0 = jax.random.split(key)
    init = np.asarray(jax.random.normal(k0, (1, gh, gw, 4), jnp.float32))
    noises = []
    for _ in range(steps):
        key, kn = jax.random.split(key)
        noises.append(np.asarray(jax.random.normal(kn, (1, gh, gw, 4), jnp.float32)))
    return init, noises


def _encode_text(cfg):
    def encode(prompt, negative):
        return _text_states(cfg, 7), _text_states(cfg, 8)
    return encode


def _image_agreement(a, b):
    x, y = (np.asarray(i, np.float64) for i in (a, b))
    assert x.shape == y.shape == (RES, RES, 3)
    assert x.std() > 1.0, "a flat image says nothing"
    return np.corrcoef(x.ravel(), y.ravel())[0, 1], np.abs(x - y).mean()


@pytest.fixture(scope="module")
def pipelines():
    """The JAX TINY pipeline and the port's with the same weights."""
    jpipe = jt2i.HunyuanDiTJAXPipeline.init_random(jax.random.PRNGKey(9), resolution=RES,
                                                   num_inference_steps=STEPS)
    jpipe.encode_text = _encode_text(jpipe.dit_cfg)
    cfg = jpipe.dit_cfg
    transformer = build(tdit.HunyuanDiT2DModel, tdit.HunyuanDiTConfig(**dataclasses.asdict(cfg)),
                        device="cpu")
    load_numpy_state_dict(transformer, hunyuan_dit_state_dict(
        jax.tree.map(np.asarray, jpipe.dit_params), cfg))
    vae = build(tvae.AutoencoderKL, tvae.TINY, device="cpu")
    load_numpy_state_dict(vae, sd_vae_state_dict(jax.tree.map(np.asarray, jpipe.vae_params)))
    tpipe = tt2i.HunyuanDiTTorchPipeline(transformer, vae, encode_text=_encode_text(cfg),
                                         resolution=RES, num_inference_steps=STEPS, device="cpu")
    return jpipe, tpipe


def test_t2i_pipeline_matches_jax(pipelines):
    jpipe, tpipe = pipelines
    gh = RES // 2   # the TINY VAE has two levels
    init, noises = _jax_draws(11, gh, gh, STEPS)
    ref = jpipe("a chair", seed=11, negative_prompt="ugly")
    out = tpipe("a chair", seed=11, negative_prompt="ugly", init_latents=init,
                step_noises=noises)
    assert out.size == ref.size == (RES, RES) and out.mode == "RGB"
    corr, mad = _image_agreement(out, ref)
    assert corr >= 0.99 and mad <= 3.0, (corr, mad)


def test_t2i_pipeline_uses_its_generator_and_pseudo_embeddings():
    """Without injected draws the seed decides the image; without a text
    encoder the prompt seeds the pseudo-embeddings (the same each call)."""
    pipe = tt2i.HunyuanDiTTorchPipeline.init_random(device="cpu", num_inference_steps=2)
    a, b, c = pipe("x", seed=1), pipe("x", seed=1), pipe("x", seed=2)
    assert np.array_equal(np.asarray(a), np.asarray(b))
    assert not np.array_equal(np.asarray(a), np.asarray(c))
    ctx_x, _ = pipe.context("x")
    ctx_y, _ = pipe.context("y")
    assert torch.equal(ctx_x[0], ctx_y[0]) and not torch.equal(ctx_x[1], ctx_y[1])
    assert torch.equal(ctx_x[1], ctx_x[2])


def test_full_v11_config_sizes():
    cfg = tdit.V1_1
    assert (cfg.hidden_size, cfg.num_heads, cfg.head_dim, cfg.depth) == (1408, 16, 88, 40)
    assert not cfg.use_style_meta and cfg.pag_layers == (16, 17, 18, 19)
    with torch.device("meta"):
        module = tdit.HunyuanDiT2DModel(cfg)
    n = sum(p.numel() for p in module.parameters())
    assert 1.4e9 < n < 1.6e9


def _zero_views(tree):
    """A params tree of zero-stride float32 arrays of the given shapes (no memory)."""
    return jax.tree.map(lambda s: np.broadcast_to(np.zeros((), np.float32), s.shape), tree)


class _Reads(dict):
    """A state dict that records the keys read from it."""

    def __init__(self, *a):
        super().__init__(*a)
        self.read = set()

    def __getitem__(self, k):
        self.read.add(k)
        return super().__getitem__(k)


def test_module_keys_match_map_hunyuan_dit():
    """map_hunyuan_dit reads exactly the keys export_hunyuan_dit writes (at
    TINY, both stacks), and the FULL v1.1 module's keys and shapes on
    ``meta`` are export_hunyuan_dit's at that config."""
    from hunyuan3d2_tpu.io import diffusers_maps as dm

    for style in (True, False):
        jcfg, tcfg = _cfgs(style)
        params = jax.tree.map(np.asarray, jdit.init(jax.random.PRNGKey(0), jcfg))
        sd = _Reads(dm.export_hunyuan_dit(params, jcfg))
        dm.map_hunyuan_dit(sd, jcfg)
        assert sd.read == set(sd)
        with torch.device("meta"):
            module = tdit.HunyuanDiT2DModel(tcfg)
        assert set(module.state_dict()) == set(sd)
    jcfg = dataclasses.replace(jdit.FULL, use_style_meta=False)
    shapes = jax.eval_shape(lambda k: jdit.init(k, jcfg), jax.random.PRNGKey(0))
    exported = dm.export_hunyuan_dit(_zero_views(shapes), jcfg)
    with torch.device("meta"):
        module = tdit.HunyuanDiT2DModel(tdit.V1_1)
    own = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    assert own == {k: tuple(v.shape) for k, v in exported.items()}


# ---------------------------------------------------------------------------
# loading a diffusers directory
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def t2i_dir(tmp_path_factory, pipelines):
    """A diffusers HunyuanDiT directory written from the JAX pipeline's
    weights: transformer/ and vae/, each config.json + safetensors."""
    import safetensors.numpy

    from hunyuan3d2_tpu.io import diffusers_maps as dm

    jpipe, _ = pipelines
    root = tmp_path_factory.mktemp("hunyuan_dit")
    c, v = jpipe.dit_cfg, jpipe.vae_cfg
    parts = {
        "transformer": (dm.export_hunyuan_dit(jax.tree.map(np.asarray, jpipe.dit_params), c), {
            "attention_head_dim": c.head_dim, "num_attention_heads": c.num_heads,
            "num_layers": c.depth, "in_channels": c.in_channels, "mlp_ratio": c.mlp_ratio,
            "cross_attention_dim": c.text_dim, "cross_attention_dim_t5": c.t5_dim,
            "text_len": c.text_len, "text_len_t5": c.t5_len, "pooled_projection_dim": c.pooled_dim,
            "use_style_cond_and_image_meta_size": c.use_style_meta}),
        "vae": (dm.export_sd_vae(jax.tree.map(np.asarray, jpipe.vae_params)), {
            "block_out_channels": list(v.block_out_channels),
            "layers_per_block": v.layers_per_block, "latent_channels": v.latent_channels,
            "scaling_factor": v.scaling_factor})}
    for part, (sd, config) in parts.items():
        os.makedirs(root / part)
        (root / part / "config.json").write_text(json.dumps(config))
        safetensors.numpy.save_file({k: np.ascontiguousarray(a, np.float32) for k, a in sd.items()},
                                    str(root / part / "diffusion_pytorch_model.safetensors"))
    return str(root)


def test_both_packages_load_the_same_image(t2i_dir, pipelines):
    jpipe, _ = pipelines
    enc = _encode_text(jpipe.dit_cfg)
    jl = jt2i.HunyuanDiTJAXPipeline.from_pretrained(t2i_dir, resolution=RES,
                                                    num_inference_steps=STEPS, encode_text=enc)
    tl = tt2i.HunyuanDiTTorchPipeline.from_pretrained(t2i_dir, device="cpu", resolution=RES,
                                                      num_inference_steps=STEPS, encode_text=enc)
    assert tl.from_checkpoint and tl.dit_cfg.pag_layers == () and tl.dit_cfg.depth == 4
    assert tl.vae.cfg.scaling_factor == jpipe.vae_cfg.scaling_factor
    assert next(tl.transformer.parameters()).device.type == "cpu"
    init, noises = _jax_draws(5, RES // 2, RES // 2, STEPS)
    corr, mad = _image_agreement(
        tl("a lamp", seed=5, init_latents=init, step_noises=noises), jl("a lamp", seed=5))
    assert corr >= 0.99 and mad <= 3.0, (corr, mad)


def test_loaded_without_text_encoders_warns(t2i_dir):
    pipe = tt2i.HunyuanDiTTorchPipeline.from_pretrained(t2i_dir, device="cpu", resolution=RES,
                                                        num_inference_steps=1)
    assert pipe.encode_text is None   # no text_encoder/ directories
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    logger = logging.getLogger("hunyuan3d2_tpu_torch.t2i")
    logger.addHandler(handler)
    try:
        pipe.context("a cup")
    finally:
        logger.removeHandler(handler)
    assert any("PSEUDO-RANDOM" in r.getMessage() for r in records)


def test_text_encoders_load_through_transformers(t2i_dir, tmp_path, monkeypatch):
    """text_encoder/ (BERT) and text_encoder_2/ (T5 encoder) with their
    tokenizers, tiny and written here, load through ``transformers`` in both
    packages: the prompt then steers the context, and the two packages give
    the same image."""
    import shutil

    for var, value in (("USE_TF", "0"), ("USE_FLAX", "0"), ("HF_HUB_OFFLINE", "1")):
        monkeypatch.setenv(var, value)
    tf = pytest.importorskip("transformers")
    root = tmp_path / "with_encoders"
    shutil.copytree(t2i_dir, root)
    cfg = tdit.TINY
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", *"abcdefghijklmnopqrstuvwxyz",
             *"一只猫白色背景"]
    for name in ("tokenizer", "tokenizer_2"):
        os.makedirs(root / name)
        (root / name / "vocab.txt").write_text("\n".join(vocab))
        tf.BertTokenizer(str(root / name / "vocab.txt")).save_pretrained(str(root / name))
    torch.manual_seed(0)
    tf.BertModel(tf.BertConfig(vocab_size=len(vocab), hidden_size=cfg.text_dim,
                               num_hidden_layers=1, num_attention_heads=2, intermediate_size=64,
                               max_position_embeddings=32)).save_pretrained(
        str(root / "text_encoder"))
    tf.T5EncoderModel(tf.T5Config(vocab_size=len(vocab), d_model=cfg.t5_dim, d_kv=8, d_ff=64,
                                  num_layers=1, num_heads=2)).save_pretrained(
        str(root / "text_encoder_2"))
    jl = jt2i.HunyuanDiTJAXPipeline.from_pretrained(str(root), resolution=RES,
                                                    num_inference_steps=STEPS)
    tl = tt2i.HunyuanDiTTorchPipeline.from_pretrained(str(root), device="cpu", resolution=RES,
                                                      num_inference_steps=STEPS)
    assert tl.encode_text is not None
    (neg, pos), (jneg, jpos) = tl.encode_text("一只猫", ""), jl.encode_text("一只猫", "")
    for a, b in zip(neg + pos, jneg + jpos):
        np.testing.assert_array_equal(a, b)
    assert pos[0].shape == (1, cfg.text_len, cfg.text_dim) and pos[2].shape == (1, cfg.t5_len,
                                                                                 cfg.t5_dim)
    assert 0 < pos[1].sum() < cfg.text_len   # padded to text_len, the mask marks the prompt
    ctx_a, _ = tl.context("一只猫")
    ctx_b, _ = tl.context("白色背景")
    assert not torch.equal(ctx_a[1], ctx_b[1])
    init, noises = _jax_draws(6, RES // 2, RES // 2, STEPS)
    corr, mad = _image_agreement(
        tl("一只猫", seed=6, init_latents=init, step_noises=noises), jl("一只猫", seed=6))
    assert corr >= 0.99 and mad <= 3.0, (corr, mad)


def test_loader_refuses_a_key_mismatch(t2i_dir, tmp_path):
    import shutil

    import safetensors.numpy

    bad = tmp_path / "bad"
    shutil.copytree(t2i_dir, bad)
    path = str(bad / "transformer" / "diffusion_pytorch_model.safetensors")
    sd = safetensors.numpy.load_file(path)
    sd.pop("proj_out.bias")
    safetensors.numpy.save_file(sd, path)
    with pytest.raises(KeyError, match="proj_out.bias"):
        tt2i.HunyuanDiTTorchPipeline.from_pretrained(str(bad), device="cpu")


# ---------------------------------------------------------------------------
# utils/text2image
# ---------------------------------------------------------------------------
def test_text2image_templates_match_jax():
    from hunyuan3d2_tpu.utils import text2image as jt
    from hunyuan3d2_tpu_torch.utils import text2image as tt

    assert tt.POSITIVE_SUFFIX == jt.POSITIVE_SUFFIX and tt.NEGATIVE_PROMPT == jt.NEGATIVE_PROMPT
    calls = []

    def backend(prompt, negative_prompt, seed):
        calls.append((prompt, negative_prompt, seed))
        return "image"

    long = "一只猫" * 30
    for mod in (jt, tt):
        assert mod.HunyuanDiTPipeline(backend=backend)(long, seed=4) == "image"
    assert calls[0] == calls[1] == (long[:60] + "," + jt.POSITIVE_SUFFIX, jt.NEGATIVE_PROMPT, 4)


@pytest.fixture
def no_backends(monkeypatch):
    """No diffusers, no HY3D_T2I_CMD, no HY3D_RANDOM_WEIGHTS."""
    monkeypatch.setitem(sys.modules, "diffusers", None)
    monkeypatch.delenv("HY3D_T2I_CMD", raising=False)
    monkeypatch.delenv("HY3D_RANDOM_WEIGHTS", raising=False)
    return monkeypatch


def test_text2image_local_directory_comes_first(no_backends, t2i_dir):
    from hunyuan3d2_tpu_torch.utils.text2image import HunyuanDiTPipeline

    no_backends.setenv("HY3D_RANDOM_WEIGHTS", "1")
    pipe = HunyuanDiTPipeline(model_path=t2i_dir, device="cpu")
    assert isinstance(pipe.backend.pipe, tt2i.HunyuanDiTTorchPipeline)
    assert pipe.backend.pipe.from_checkpoint and pipe.backend.pipe.resolution == 1024


def test_text2image_diffusers_before_command_and_random(no_backends):
    from hunyuan3d2_tpu_torch.utils.text2image import HunyuanDiTPipeline

    made = []

    class FakePipe:
        device = torch.device("cpu")

        @classmethod
        def from_pretrained(cls, path, **kw):
            made.append((path, kw))
            return cls()

        def to(self, device):
            return self

    no_backends.setitem(sys.modules, "diffusers",
                        types.SimpleNamespace(AutoPipelineForText2Image=FakePipe))
    no_backends.setenv("HY3D_T2I_CMD", "false")
    no_backends.setenv("HY3D_RANDOM_WEIGHTS", "1")
    pipe = HunyuanDiTPipeline(model_path="some/model", device="cpu")
    assert isinstance(pipe.backend.pipe, FakePipe)
    assert made == [("some/model", {"torch_dtype": torch.float32, "enable_pag": True,
                                    "pag_applied_layers": ["blocks.(16|17|18|19)"]})]


def test_text2image_command_before_random(no_backends, tmp_path):
    from PIL import Image

    from hunyuan3d2_tpu_torch.utils.text2image import HunyuanDiTPipeline

    script = tmp_path / "t2i.py"
    script.write_text("import sys\nfrom PIL import Image\n"
                      "open(sys.argv[2] + '.txt', 'w').write(open(sys.argv[1]).read())\n"
                      "Image.new('RGB', (8, 8), (10, 20, 30)).save(sys.argv[2])\n")
    no_backends.setenv("HY3D_T2I_CMD", f"{sys.executable} {script}")
    no_backends.setenv("HY3D_RANDOM_WEIGHTS", "1")
    image = HunyuanDiTPipeline(device="cpu")("a bowl", seed=9)
    assert isinstance(image, Image.Image) and image.size == (8, 8) and image.mode == "RGBA"


def test_text2image_random_weights_last(no_backends):
    from hunyuan3d2_tpu_torch.utils.text2image import HunyuanDiTPipeline

    with pytest.raises(RuntimeError, match="No text-to-image backend"):
        HunyuanDiTPipeline(device="cpu")
    no_backends.setenv("HY3D_RANDOM_WEIGHTS", "1")
    pipe = HunyuanDiTPipeline(device="cpu")
    inner = pipe.backend.pipe
    assert isinstance(inner, tt2i.HunyuanDiTTorchPipeline)
    assert (inner.resolution, inner.num_inference_steps, inner.dit_cfg) == (64, 4, tdit.TINY)
    assert pipe("a vase", seed=0).size == (64, 64)

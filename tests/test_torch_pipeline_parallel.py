"""The port's pipeline parallelism (hunyuan3d2_tpu_torch/parallel/pipeline.py)
against the JAX package's (hunyuan3d2_tpu/parallel/pipeline.py), on the CPU.

The port's pp_apply runs once per case on 4 gloo ranks spawned by a
module-scoped fixture (tests/torch_parallel_cases.py, which imports no JAX);
the JAX pp_apply runs in this process on the virtual CPU devices. The
configs, weights and inputs are tests/test_pipeline_parallel.py's, carried
across by io/convert.py, and the tolerance is that test's: 2e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hunyuan3d2_tpu.models import dit as jdit
from hunyuan3d2_tpu.parallel.pipeline import make_pp_mesh as jax_pp_mesh
from hunyuan3d2_tpu.parallel.pipeline import pp_apply as jax_pp_apply
from hunyuan3d2_tpu_torch.io import convert
from hunyuan3d2_tpu_torch.models import dit
from hunyuan3d2_tpu_torch.ops.nn import build
from hunyuan3d2_tpu_torch.parallel.pipeline import split_stages
from tests import torch_parallel_cases as cases_mod

CFG = jdit.DiTConfig(in_channels=8, context_in_dim=16, hidden_size=64, num_heads=4, depth=4,
                     depth_single_blocks=4)
GUIDED = jdit.DiTConfig(in_channels=8, context_in_dim=16, hidden_size=64, num_heads=4, depth=2,
                        depth_single_blocks=2, guidance_embed=True)
PP_CASES = [(2, 2), (2, 4), (4, 4)]


def _inputs(b=4):
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(7), 3)
    return (np.asarray(jax.random.normal(k1, (b, 6, CFG.in_channels), jnp.float32)),
            np.asarray(jax.random.uniform(k2, (b,))),
            np.asarray(jax.random.normal(k3, (b, 5, CFG.context_in_dim), jnp.float32)))


def _params(cfg, seed):
    return jax.device_get(jax.jit(jdit.init, static_argnums=1)(jax.random.PRNGKey(seed), cfg))


@pytest.fixture(scope="module")
def cases():
    """{name: (params, cfg, pp, n_micro, x, t, cond, guidance)}."""
    params, gparams = _params(CFG, 0), _params(GUIDED, 1)
    x, t, cond = _inputs(4)
    out = {f"pp{pp}_micro{m}": (params, CFG, pp, m, x, t, cond, None) for pp, m in PP_CASES}
    out["guidance"] = (gparams, GUIDED, 2, 2, *_inputs(2), np.full((2,), 5.0, np.float32))
    return out


@pytest.fixture(scope="module")
def ranks(cases, tmp_path_factory):
    """{name: the port's pp_apply output} of every rank."""
    def args():
        return ([(name, convert.dit_state_dict(p, cfg), dataclasses.asdict(cfg), *rest)
                 for name, (p, cfg, *rest) in cases.items()],)

    return cases_mod.spawn_once(tmp_path_factory, "pipeline_cases", cases_mod.pipeline_cases,
                                4, args)


def test_split_stages_roundtrip():
    with torch.device("meta"):
        model = dit.Hunyuan3DDiT(dit.DiTConfig(**dataclasses.asdict(CFG)))
    stages = split_stages(model, 2)
    assert [len(s.double_blocks) for s in stages] == [2, 2]
    assert [len(s.single_blocks) for s in stages] == [2, 2]
    back = [b for s in stages for b in s.double_blocks]
    assert all(a is b for a, b in zip(back, model.double_blocks)) and len(back) == 4
    # a stage numbers its blocks from 0: stage 1's first is the model's third
    assert stages[1].get_parameter("double_blocks.0.img_attn.qkv.weight") is \
        model.get_parameter("double_blocks.2.img_attn.qkv.weight")
    with pytest.raises(ValueError, match="must divide"):
        split_stages(model, 3)


@pytest.mark.parametrize("name", [f"pp{pp}_micro{m}" for pp, m in PP_CASES] + ["guidance"])
def test_pp_apply_matches_jax(ranks, cases, name):
    params, cfg, pp, n_micro, x, t, cond, g = cases[name]
    ref = np.asarray(jax_pp_apply(params, cfg, jax_pp_mesh(pp), x, t, cond, n_micro=n_micro,
                                  guidance=None if g is None else jnp.asarray(g)))
    for r in ranks:  # every rank returns the whole output
        assert r[name].shape == ref.shape
        np.testing.assert_allclose(r[name], ref, atol=2e-4, rtol=2e-4)


def test_pp_apply_matches_the_port_forward(ranks, cases):
    """The pipeline computes the unstaged model's function."""
    name = "pp2_micro2"
    params, cfg, _, _, x, t, cond, _ = cases[name]
    model = convert.load_numpy_state_dict(
        build(dit.Hunyuan3DDiT, dit.DiTConfig(**dataclasses.asdict(cfg)), device="cpu"),
        convert.dit_state_dict(params, cfg))
    with torch.no_grad():
        ref = model(*(torch.from_numpy(np.array(a)) for a in (x, t, cond))).numpy()
    np.testing.assert_allclose(ranks[0][name], ref, atol=2e-4, rtol=2e-4)

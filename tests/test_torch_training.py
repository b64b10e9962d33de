"""Flow-matching training in the port (hunyuan3d2_tpu_torch/training,
io/pytree_io.py) against the JAX package's (training/flow_match.py with
optax ``adamw``), on the CPU, on the JAX resume test's DiT config
(tests/test_train_resume.py), with the JAX parameters carried across by
io/convert.py and the JAX draws of x0 and sigma replayed as numpy arrays.

Tolerances. The loss agrees to 2e-3 relative (measured 1.4e-4 at the same
weights, 5e-4 after the trajectories part). Gradients and the AdamW moments
are held as the DiT parity tests hold activations: within 5 % of the
tensor's largest value and correlated above 0.999 (measured: 1.9 % and
0.99994 for gradients; 3.3 % and 0.9997 for the moments after 4 steps):
both packages multiply bf16 weights in fp32 but sum in other orders, and
the moments are bf16 in both (optax keeps them in the parameters' dtype,
as torch does).

Weights: a step of 1e-4 is below one bf16 ulp for every weight above
~0.03, so most bf16 weights do not move, and a weight whose exact update
lands near a rounding tie may round the other way in the two packages.
Adam's first step is sign(g)·lr, so an element whose gradient lies within
the two packages' rounding noise of zero may step the other way. An
element agrees when its bf16 weights are within one bf16 ulp, or its fp32
weight's update (new − old) is within lr/4 of the JAX one; at most 0.5 % of
the elements may disagree after one step (measured 0.09 %) and 1 % after
four (measured 0.3 %), and none by more than one ulp plus 4·lr a step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hunyuan3d2_tpu.models import dit as jdit
from hunyuan3d2_tpu.training.flow_match import flow_match_loss as jax_loss
from hunyuan3d2_tpu.training.flow_match import make_train_step as jax_make_train_step
from hunyuan3d2_tpu_torch.io import convert
from hunyuan3d2_tpu_torch.io.pytree_io import load_pytree, save_pytree
from hunyuan3d2_tpu_torch.models import dit as tdit
from hunyuan3d2_tpu_torch.ops.nn import build
from hunyuan3d2_tpu_torch.training import flow_match_loss, make_train_step

CFG = jdit.DiTConfig(in_channels=8, context_in_dim=16, hidden_size=32, num_heads=2, depth=1,
                     depth_single_blocks=1)
LR = 1e-4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread a test: the suite runs several workers on the
    host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    return jax.device_get(jax.jit(jdit.init, static_argnums=1)(jax.random.PRNGKey(0), CFG))


def _port(params):
    model = build(tdit.Hunyuan3DDiT, tdit.DiTConfig(**CFG.__dict__), device="cpu")
    return convert.load_numpy_state_dict(model, convert.dit_state_dict(params, CFG))


def _batch(i):
    """The JAX resume test's batch i (latents fp32, cond bf16), as numpy."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(100 + i))
    return (np.asarray(jax.random.normal(k1, (2, 4, CFG.in_channels))),
            np.asarray(jax.random.normal(k2, (2, 6, CFG.context_in_dim)).astype(jnp.bfloat16)))


def _draws(i, shape):
    """x0 and sigma as the JAX loss draws them from PRNGKey(i)."""
    kn, kt = jax.random.split(jax.random.PRNGKey(i))
    return (np.asarray(jax.random.normal(kn, shape, jnp.float32)),
            np.asarray(jax.random.uniform(kt, (shape[0],), jnp.float32)))


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x, np.float32)).to(dtype)


def _port_step_args(i):
    lat, cond = _batch(i)
    x0, sigma = _draws(i, lat.shape)
    return _t(lat), _t(cond, torch.bfloat16), _t(x0), _t(sigma)


def assert_close(out, ref, frac, what=""):
    """The DiT parity rule (tests/test_torch_models.py): max |out - ref|
    within ``frac`` of the reference's largest value, correlation > 0.999."""
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    assert out.shape == ref.shape, what
    assert np.isfinite(out).all(), what
    err = np.abs(out - ref).max()
    assert err <= frac * np.abs(ref).max(), (what, err, np.abs(ref).max())
    if out.size > 1:
        assert np.corrcoef(out.ravel(), ref.ravel())[0, 1] > 0.999, what


def _bf16_ulp(x):
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(x), 1e-30))) - 7)


@pytest.mark.parametrize("i", [0, 3])
def test_loss_matches_jax(params, i):
    lat, cond = _batch(i)
    ref = float(jax_loss(params, CFG, jax.random.PRNGKey(i), jnp.asarray(lat), jnp.asarray(cond)))
    lat_t, cond_t, x0, sigma = _port_step_args(i)
    with torch.no_grad():
        out = float(flow_match_loss(_port(params), lat_t, cond_t, x0=x0, sigma=sigma))
    assert abs(out - ref) <= 2e-3 * abs(ref), (out, ref)


def test_loss_draws_from_the_generator(params):
    """Without x0 / sigma the loss draws them from the generator: the same
    seed gives the same loss, another seed another."""
    model = _port(params)
    lat, cond = (_t(x) for x in _batch(0))
    with torch.no_grad():
        a, b, c = (float(flow_match_loss(model, lat, cond.bfloat16(),
                                         generator=torch.Generator().manual_seed(s)))
                   for s in (5, 5, 6))
    assert a == b and a != c and np.isfinite(a)


def test_gradients_match_jax_grad(params):
    lat, cond = _batch(0)
    grads = jax.grad(lambda p: jax_loss(p, CFG, jax.random.PRNGKey(0), jnp.asarray(lat),
                                        jnp.asarray(cond)))(params)
    ref = convert.dit_state_dict(jax.device_get(grads), CFG)
    model = _port(params).requires_grad_(True)
    lat_t, cond_t, x0, sigma = _port_step_args(0)
    flow_match_loss(model, lat_t, cond_t, x0=x0, sigma=sigma).backward()
    names = dict(model.named_parameters())
    assert sorted(names) == sorted(ref)
    for name, p in names.items():
        assert p.grad is not None and p.grad.dtype == p.dtype, name
        assert_close(p.grad.float().numpy(), ref[name], 0.05, name)


def _run_both(params, steps):
    """``steps`` AdamW steps in both packages from the same weights →
    (JAX params, JAX Adam state, port model, port optimizer, weights before
    the last step in each)."""
    optimizer, train_step = jax_make_train_step(CFG)
    jp = jax.tree.map(jnp.asarray, params)
    jo = optimizer.init(jp)
    model = _port(params)
    topt, port_step = make_train_step(model)
    assert isinstance(topt, torch.optim.AdamW)
    g = topt.param_groups[0]
    assert (g["lr"], g["betas"], g["eps"], g["weight_decay"]) == (LR, (0.9, 0.999), 1e-8, 0.01)
    for i in range(steps):
        lat, cond = _batch(i)
        j_before = convert.dit_state_dict(jax.device_get(jp), CFG)
        t_before = {n: p.detach().float().numpy().copy() for n, p in model.named_parameters()}
        jp, jo, jl = train_step(jp, jo, jax.random.PRNGKey(i), jnp.asarray(lat), jnp.asarray(cond))
        tl = port_step(*_port_step_args(i))
        assert abs(float(tl) - float(jl)) <= 2e-3 * abs(float(jl)), (i, float(tl), float(jl))
    return jax.device_get(jp), jax.device_get(jo), model, topt, j_before, t_before


@pytest.mark.parametrize("steps,share", [(1, 0.005), (4, 0.01)])
def test_adamw_steps_match_optax(params, steps, share):
    jp, jo, model, topt, j_before, t_before = _run_both(params, steps)
    adam = jo[0]
    assert int(adam.count) == steps
    ref_w = convert.dit_state_dict(jp, CFG)
    ref_mu = convert.dit_state_dict(adam.mu, CFG)
    ref_nu = convert.dit_state_dict(adam.nu, CFG)
    total = disagree = 0
    for name, p in model.named_parameters():
        state = topt.state[p]
        assert int(state["step"]) == steps
        assert state["exp_avg"].dtype == p.dtype
        assert_close(state["exp_avg"].float().numpy(), ref_mu[name], 0.05, name + " exp_avg")
        assert_close(state["exp_avg_sq"].float().numpy(), ref_nu[name], 0.05,
                     name + " exp_avg_sq")
        w, ref = p.detach().float().numpy(), ref_w[name]
        if p.dtype == torch.bfloat16:
            ulp = _bf16_ulp(ref)
            bad = np.abs(w - ref) > ulp
        else:
            ulp = 0.0
            bad = np.abs((w - t_before[name]) - (ref - j_before[name])) > LR / 4
        assert (np.abs(w - ref) <= ulp + 4 * LR * steps).all(), name
        total += w.size
        disagree += int(bad.sum())
    assert disagree <= share * total, (disagree, total)


def _port_run(model, optimizer, train_step, steps, start=0):
    loss = None
    for i in range(start, start + steps):
        loss = train_step(*_port_step_args(i))
    return loss


def test_train_checkpoint_resume_equivalence(params, tmp_path):
    """tests/test_train_resume.py on the port: 4 steps straight equal 2
    steps, a save_pytree of the weights and the optimizer state, a
    load_pytree into a fresh model and optimizer, and 2 more steps."""
    model = _port(params)
    opt, step = make_train_step(model)
    loss_ref = _port_run(model, opt, step, 4)

    mid = _port(params)
    opt_mid, step_mid = make_train_step(mid)
    _port_run(mid, opt_mid, step_mid, 2)
    path = save_pytree(str(tmp_path / "ckpt.safetensors"),
                       {"params": mid.state_dict(), "opt": opt_mid.state_dict()})

    fresh = build(tdit.Hunyuan3DDiT, tdit.DiTConfig(**CFG.__dict__), device="cpu",
                  generator=torch.Generator().manual_seed(99))
    opt_res, step_res = make_train_step(fresh)
    restored = load_pytree(path, target={"params": fresh.state_dict(),
                                         "opt": opt_res.state_dict()})
    fresh.load_state_dict(restored["params"])
    opt_res.load_state_dict(restored["opt"])
    loss_res = _port_run(fresh, opt_res, step_res, 2, start=2)

    for (name, a), b in zip(model.state_dict().items(), fresh.state_dict().values()):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(), atol=1e-5, rtol=1e-5,
                                   err_msg=name)
    np.testing.assert_allclose(float(loss_ref), float(loss_res), atol=1e-5)


def test_pytree_round_trip_is_bit_exact(tmp_path):
    """A nested tree with an optimizer's state: tensors of every dtype bit
    for bit, int dict keys, tuples, None and numbers as they were; a target
    restores dtypes."""
    lin = torch.nn.Linear(4, 3).to(torch.bfloat16)
    opt = torch.optim.AdamW(lin.parameters(), lr=1e-3)
    lin(torch.randn(2, 4, generator=torch.Generator().manual_seed(0)).bfloat16()).sum().backward()
    opt.step()
    tree = {"model": lin.state_dict(), "opt": opt.state_dict(),
            "extra": {"ints": torch.arange(5, dtype=torch.int32), 3: (1.5, None, "s", True),
                      "scalar": torch.tensor(2.0, dtype=torch.float64), "list": [torch.ones(2)]}}
    path = save_pytree(str(tmp_path / "tree.safetensors"), tree)
    back = load_pytree(path)

    def same(a, b):
        assert type(a) is type(b) or isinstance(a, dict) and isinstance(b, dict), (a, b)
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b)
        elif isinstance(a, dict):
            assert list(a) == list(b)
            for k in a:
                same(a[k], b[k])
        elif isinstance(a, (list, tuple)):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                same(x, y)
        else:
            assert a == b

    same(tree, back)
    as_fp32 = load_pytree(path, target={"model": {k: v.float()
                                                  for k, v in lin.state_dict().items()}})
    assert all(v.dtype == torch.float32 for v in as_fp32["model"].values())
    with pytest.raises(ValueError, match="in the target"):
        load_pytree(path, target={"model": {"weight": torch.zeros(2, 2)}})

"""The port's differentiable surface nets (volume/diff_surface.py,
volume/decoders.surface_nets_device) against the JAX package's
(volume/diff_surface.py), on the CPU, mirroring tests/test_diff_surface.py:
the forward against the port's inference surface nets and the JAX one, the
grid gradient against finite differences and against
``jax.value_and_grad``, and the gradient through the TINY ShapeVAE's decode
into its geo decoder's weights against JAX's.

Tolerances. Counts and connectivity are integers: exact. Vertices: 1e-5
(the same fp32 lerp of the same f16 corner values). Grid gradients: both
packages pass the cotangent through the f16 corner gather, so they agree
to f16 rounding (2^-11 relative) of each value: 2e-3 of the largest
magnitude. Finite differences: the JAX test's 5e-3 + 0.05·|fd|. The
geo-decoder gradients: the DiT parity rule (5 % of the largest value,
correlation > 0.999), since the decode multiplies bf16 weights and sums in
other orders than XLA.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hunyuan3d2_tpu.models import shapevae as jsv
from hunyuan3d2_tpu.volume import decoders as jdec
from hunyuan3d2_tpu.volume import diff_surface as jdiff
from hunyuan3d2_tpu_torch.io import convert
from hunyuan3d2_tpu_torch.models import shapevae as tsv
from hunyuan3d2_tpu_torch.volume import decoders as tdec
from hunyuan3d2_tpu_torch.volume.diff_surface import (
    differentiable_surface_nets,
    vertex_loss_and_grad,
)
from tests.test_torch_training import assert_close

CAP, FCAP = 8192, 12288
WEIGHTS = (0.3, -0.2, 0.5)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sphere(res=24, radius=0.6, box_v=1.01):
    lin = np.linspace(-box_v, box_v, res, dtype=np.float32)
    x, y, z = np.meshgrid(lin, lin, lin, indexing="ij")
    return (radius - np.sqrt(x * x + y * y + z * z)).astype(np.float32)


def _port_loss(verts, count):
    return (verts * torch.tensor(WEIGHTS)).sum()


def _jax_loss(verts, count):
    return jnp.sum(verts * jnp.asarray(WEIGHTS))


def test_forward_matches_jax_and_the_inference_surface_nets():
    g = _sphere()
    verts, tris, nq, count = differentiable_surface_nets(torch.from_numpy(g), capacity=CAP,
                                                         face_capacity=FCAP)
    jv, jt, jnq, jcount = (np.asarray(x) for x in jdiff.differentiable_surface_nets(
        jnp.asarray(g), capacity=CAP, face_capacity=FCAP))
    n, q = int(count), int(nq)
    assert (n, q) == (int(jcount), int(jnq))
    assert 100 < n <= CAP and 100 < q <= FCAP
    assert verts.shape == (CAP, 3) and tris.shape == (2 * FCAP, 3) and tris.dtype == torch.int32
    np.testing.assert_allclose(verts[:n].numpy(), jv[:n], atol=1e-5)
    np.testing.assert_array_equal(tris[:2 * q].numpy(), jt[:2 * q])
    assert (tris[2 * q:] == -1).all()
    r = np.linalg.norm(verts[:n].numpy(), axis=1)
    assert np.abs(r - 0.6).max() < 0.1
    # the inference path's surface nets (blocked compaction, fp32 corner
    # values) on the same grid: the same vertices within the f16 rounding
    # of the corners, and the same quads once its vertex order is mapped
    # onto this one (their compaction orders differ)
    iv, iq, inq, icount, ok = tdec.surface_nets_from_grid(torch.from_numpy(g), 0.0, 1.01, CAP,
                                                          FCAP)
    assert bool(ok) and (int(icount), int(inq)) == (n, q)
    dist = torch.cdist(iv[:n], verts[:n])
    near = dist.argmin(1)
    assert float(dist.min(1).values.max()) < 1e-3
    assert sorted(near.tolist()) == list(range(n))
    quads = tris[:2 * q].numpy().reshape(q, 2, 3)
    quads = np.concatenate([quads[:, 0], quads[:, 1, 2:]], axis=1)
    assert sorted(map(tuple, near[iq[:q].long()].tolist())) == sorted(map(tuple, quads.tolist()))


def test_gradient_matches_jax_value_and_grad():
    g = _sphere()
    val, grad = vertex_loss_and_grad(torch.from_numpy(g), _port_loss, capacity=CAP,
                                     face_capacity=FCAP)
    jval, jgrad = jdiff.vertex_loss_and_grad(jnp.asarray(g), _jax_loss, capacity=CAP,
                                             face_capacity=FCAP)
    jgrad = np.asarray(jgrad)
    assert abs(float(val) - float(jval)) <= 1e-4 * max(1.0, abs(float(jval)))
    assert grad.shape == g.shape and torch.isfinite(grad).all()
    assert np.abs(jgrad).max() > 0
    np.testing.assert_allclose(grad.numpy(), jgrad, atol=2e-3 * np.abs(jgrad).max())


def test_gradient_matches_finite_differences():
    """tests/test_diff_surface.py's check on the port: grid points with a
    nonzero gradient, far enough from the level that ±eps keeps the
    topology."""
    g0 = _sphere()
    val, grad = vertex_loss_and_grad(torch.from_numpy(g0), _port_loss, capacity=CAP,
                                     face_capacity=FCAP)
    grad = grad.numpy()
    assert np.isfinite(float(val)) and np.isfinite(grad).all() and np.abs(grad).max() > 0
    eps = 1e-3
    cand = (np.abs(grad) > np.abs(grad).max() * 0.05) & (np.abs(g0) > 0.02)
    idxs = np.argwhere(cand)[:4]
    assert len(idxs) > 0
    for i, j, k in idxs:
        gp, gm = g0.copy(), g0.copy()
        gp[i, j, k] += eps
        gm[i, j, k] -= eps
        vp, _ = vertex_loss_and_grad(torch.from_numpy(gp), _port_loss, capacity=CAP,
                                     face_capacity=FCAP)
        vm, _ = vertex_loss_and_grad(torch.from_numpy(gm), _port_loss, capacity=CAP,
                                     face_capacity=FCAP)
        fd = (float(vp) - float(vm)) / (2 * eps)
        assert abs(fd - grad[i, j, k]) < 5e-3 + 0.05 * abs(fd), ((i, j, k), fd, grad[i, j, k])


def test_gradient_flows_into_decoder_params_as_in_jax():
    """Mesh-space loss → SDF values from the TINY VAE's decode
    (decode_latents → compute_kv → decode_queries, the attention through
    ops.attention) → the geo decoder's weights, against the same chain's
    jax.value_and_grad with the same weights and latents."""
    cfg = jsv.TINY
    params = jax.device_get(jax.jit(jsv.init, static_argnums=1)(jax.random.PRNGKey(0), cfg))
    lat = np.asarray(jax.random.normal(jax.random.PRNGKey(1),
                                       (1, cfg.num_latents, cfg.embed_dim)) * 0.5)
    res = 17

    def jax_loss_fn(p):
        hidden = jsv.decode_latents(p, cfg, jnp.asarray(lat))
        kv = jsv.compute_kv(p, cfg, hidden)
        pts = jdec.grid_coords_from_flat(jnp.arange(res ** 3), res, 1.01)[None]
        grid = jsv.decode_queries(p, cfg, pts, kv).reshape(res, res, res)
        verts, _, _, count = jdiff.differentiable_surface_nets(grid, capacity=2048,
                                                               face_capacity=3072)
        mask = (jnp.arange(verts.shape[0]) < count)[:, None]
        return jnp.sum(((verts[:, 2] - 0.2) ** 2) * mask[:, 0])

    jval, jgrads = jax.value_and_grad(jax_loss_fn)(params)
    ref = convert.shapevae_state_dict(jax.device_get(jgrads), cfg)

    vae = tsv.ShapeVAE.init_random(tsv.ShapeVAEConfig(**cfg.__dict__), device="cpu")
    convert.load_numpy_state_dict(vae, convert.shapevae_state_dict(params, cfg))
    vae.geo_decoder.requires_grad_(True)
    k, v = vae.compute_kv(vae.decode_latents(torch.from_numpy(lat.copy())))
    pts = tdec.grid_coords_from_flat(torch.arange(res ** 3), res, 1.01)[None]
    grid = vae.decode_queries(pts, k, v).reshape(res, res, res)
    verts, _, _, count = differentiable_surface_nets(grid, capacity=2048, face_capacity=3072)
    mask = torch.arange(verts.shape[0]) < count
    loss = (((verts[:, 2] - 0.2) ** 2) * mask).sum()
    loss.backward()
    assert np.isfinite(float(loss.detach()))
    assert abs(float(loss.detach()) - float(jval)) <= 1e-3 * abs(float(jval))
    # k_norm's bias shifts every logit of a query by the same amount, which
    # the softmax cancels: its gradient is 0 up to rounding in both
    # packages, so it is held to that noise level instead of to the pattern
    scale = max(np.abs(ref["geo_decoder." + n]).max() for n, _ in
                vae.geo_decoder.named_parameters())
    gnorm = 0.0
    for name, p in vae.geo_decoder.named_parameters():
        assert p.grad is not None, name
        grad, want = p.grad.float().numpy(), ref["geo_decoder." + name]
        gnorm += float(np.abs(grad).sum())
        if np.abs(want).max() < 1e-4 * scale:
            assert np.abs(grad).max() < 1e-4 * scale, name
        else:
            assert_close(grad, want, 0.05, name)
    assert gnorm > 0, "no gradient reached the geo-decoder weights"

"""The plain reference of ``paint_turbo`` against the port at TINY size on the
CPU, stage by stage, on seeded random weights (``benchmark/weights.py``):
the SD VAE's encode and decode, the 2.5D UNet's reference pass ('w') and
denoise pass ('r') with and without the voxel masks, the LCM loop, the cond
maps and the bake of the same views onto the same unwrapped mesh. Both
sides compute in fp32 here (the port's modules cast to fp32), so that the
arithmetic is compared and not the rounding; the harness's runs below
compare the bf16 program with the fp32 reference as the card does."""

import time

import numpy as np
import pytest
import torch
from paint_tiny import paint_tiny_spec

from benchmark import control, harness, weights

SEED = 2 ** 31 + 7


@pytest.fixture(scope="module")
def stack():
    """(config, the port's UNet2p5D and AutoencoderKL in fp32, the
    reference's weights by the checkpoint's names, the reference module)."""
    from hunyuan3d2_tpu_torch.models import paint_unet, sd_vae

    cfg = paint_tiny_spec()["config"]
    with torch.device("meta"):
        unet = paint_unet.UNet2p5D(paint_unet.TINY)
        vae = sd_vae.AutoencoderKL(sd_vae.TINY)
    weights.fill({"unet": unet.unet, "unet_dual": unet.unet_dual, "vae": vae}, SEED, "cpu")
    unet, vae = unet.float().eval(), vae.float().eval()
    W = {f"{prefix}.{n}": p for prefix, m in (("unet", unet.unet), ("unet_dual", unet.unet_dual),
                                               ("vae", vae))
         for n, p in m.named_parameters()}
    return cfg, unet, vae, W, harness.load_file("reference", "paint_turbo")


def _rel(a, b):
    return float(torch.linalg.vector_norm(a.float() - b.float()) / torch.linalg.vector_norm(b))


def _position_maps(cfg, seed=0):
    """The reference's position and normal cond maps of a TINY bumpy sphere."""
    ref = harness.load_file("reference", "paint_turbo")
    gen = harness.load_file("generators", "bumpy_spheres")
    v, f = gen.pool(paint_tiny_spec()["traffic"], seed, count=1)[0]["mesh"]
    verts = torch.from_numpy(ref.render_frame(v))
    normals = torch.from_numpy(ref.vertex_normals(verts.numpy(), f))
    mvps = [m for _, m in ref.cameras(cfg["views"], "cpu")]
    return ref.cond_maps(ref.Arith("fp32"), verts, torch.from_numpy(f.astype(np.int64)), normals,
                         mvps, cfg["views"]["size"]), (v, f)


def test_vae_encode_and_decode(stack):
    cfg, _, vae, W, ref = stack
    A = ref.Arith("fp32")
    gen = torch.Generator().manual_seed(1)
    u8 = torch.randint(0, 256, (3, 32, 32, 3), generator=gen, dtype=torch.uint8)
    with torch.no_grad():
        port = vae.encode(u8.float() / 255.0 * 2.0 - 1.0)
        z = torch.randn(2, 16, 16, 4, generator=gen)
        port_dec = vae.decode(z)
    assert _rel(port, ref.vae_encode(W, A, cfg["vae"], u8)) < 1e-5
    assert _rel(port_dec, ref.vae_decode(W, A, cfg["vae"], z)) < 1e-5


@pytest.mark.parametrize("masked", [False, True])
def test_unet_reference_and_denoise_passes(stack, masked):
    from hunyuan3d2_tpu_torch.models import paint_unet

    cfg, unet, _, W, ref = stack
    A = ref.Arith("fp32")
    gen = torch.Generator().manual_seed(2)
    h, n = 16, 6
    ref_lat = torch.randn(1, 1, h, h, 4, generator=gen)
    lat, normal, position = (torch.randn(1, n, h, h, 4, generator=gen) for _ in range(3))
    cams = torch.arange(n)[None] * 7 % 40
    with torch.no_grad():
        cache = unet.write_cache(ref_lat)
    mine = ref.reference_cache(W, A, cfg["unet"], ref_lat[:, 0])
    assert set(mine) == set(cache) and len(cache) == 4     # down_0_0, mid_0, up_1_0, up_1_1
    for k in cache:
        assert _rel(cache[k], mine[k]) < 1e-5, k
    masks = {}
    if masked:
        (_, pos_u8), _ = _position_maps(cfg)
        port_masks = paint_unet.compute_multi_resolution_mask(pos_u8[None].float() / 255.0,
                                                              (32, 16, 8))
        masks = ref.voxel_masks(pos_u8, cfg["views"]["size"])
        assert set(masks) == set(port_masks) == {6 * 1024, 6 * 256, 6 * 64}
        for k in masks:
            assert (masks[k] == port_masks[k]).float().mean() > 0.999
            # the cells of the 32 and 16 grids hold fewer than 5 pixels at 32² views
            assert bool(masks[k].all()) is (k != 6 * 64)
    with torch.no_grad():
        port = unet(lat, 500.0, normal, position, cams, cache, mva_masks=masks or None)
    x = torch.cat([lat[0], normal[0], position[0]], -1).permute(0, 3, 1, 2)
    mine = ref.unet(W, A, cfg["unet"], "unet", x, torch.full((n,), 500.0),
                    W["unet.learned_text_clip_gen"].float().expand(n, -1, -1), cams[0] + 5, "r",
                    n, mine, masks).permute(0, 2, 3, 1)
    assert _rel(port[0], mine) < 1e-4
    if masked:   # the mask is live: the dense pass differs
        dense = ref.unet(W, A, cfg["unet"], "unet", x, torch.full((n,), 500.0),
                         W["unet.learned_text_clip_gen"].float().expand(n, -1, -1), cams[0] + 5,
                         "r", n, ref.reference_cache(W, A, cfg["unet"], ref_lat[:, 0]), {})
        assert _rel(dense.permute(0, 2, 3, 1), mine) > 1e-3


def test_lcm_loop(stack, monkeypatch):
    from hunyuan3d2_tpu_torch.pipelines.hunyuanpaint import HunyuanPaintPipeline

    cfg, unet, vae, W, ref = stack
    A = ref.Arith("fp32")
    (normal_u8, pos_u8), _ = _position_maps(cfg, 3)
    gen = torch.Generator().manual_seed(3)
    ref_lat = torch.randn(1, 1, 16, 16, 4, generator=gen)
    normal, position = (torch.randn(1, 6, 16, 16, 4, generator=gen) for _ in range(2))
    pipe = HunyuanPaintPipeline(unet, vae, view_size=32, device="cpu")
    pipe.set_turbo()
    monkeypatch.setattr(pipe, "_decode_views", lambda latents: latents)
    steps = cfg["sampler"]["steps"]
    timesteps, ac = pipe.scheduler.make_tables(steps)
    mine_t, mine_ac = ref.lcm_tables(steps)
    assert mine_t == [int(t) for t in timesteps] and np.array_equal(mine_ac, ac)
    init = torch.randn((1, 6, 16, 16, 4), generator=torch.Generator().manual_seed(SEED))
    vw = cfg["views"]
    cams = torch.tensor([[ref.camera_index(a, e) for a, e in zip(vw["azims"], vw["elevs"])]])
    port = pipe.denoise_lcm(ref_lat, normal, position, cams, timesteps, ac,
                            pos_u8[None], (32, 16, 8), init_latents=init,
                            generator=torch.Generator().manual_seed(0))
    cache = ref.reference_cache(W, A, cfg["unet"], ref_lat[:, 0])
    mine = ref.sample(W, A, cfg, cache, ref.voxel_masks(pos_u8, 32), normal[0], position[0],
                      SEED)
    assert _rel(port, mine) < 1e-4


def test_cond_maps(stack):
    from hunyuan3d2_tpu_torch.geometry.mesh import Mesh
    from hunyuan3d2_tpu_torch.geometry.render import MeshRender
    from hunyuan3d2_tpu_torch.geometry.render_device import cond_maps, upload_mesh

    cfg, *_, ref = stack
    (normal, position), (v, f) = _position_maps(cfg, 5)
    render = MeshRender(default_resolution=256, texture_size=256)
    render.load_mesh(Mesh(v, f))
    vw = cfg["views"]
    mats = [render._mvp(e, a) for e, a in zip(vw["elevs"], vw["azims"])]
    for (mv, mvp), (rmv, rmvp) in zip(mats, ref.cameras(vw, "cpu")):
        assert np.array_equal(mv, rmv.numpy()) and np.array_equal(mvp, rmvp.numpy())
    assert np.allclose(ref.render_frame(v), render.vtx_pos, atol=1e-6)
    mvps = torch.from_numpy(np.stack([m[1] for m in mats]))
    pn, pp = cond_maps(upload_mesh(render, "cpu"), mvps, vw["size"])
    differ = ((pn.int() - normal.int()).abs().amax(-1) > 1) | (
        (pp.int() - position.int()).abs().amax(-1) > 1)
    assert float(differ.float().mean()) < 1e-3
    assert (position != 255).any(-1).float().mean() > 0.2       # the object fills the views


def test_bake(stack):
    from hunyuan3d2_tpu_torch.geometry.mesh import Mesh
    from hunyuan3d2_tpu_torch.geometry.render import MeshRender
    from hunyuan3d2_tpu_torch.geometry.render_device import bake_prepared, prepare_bake, upload_mesh
    from hunyuan3d2_tpu_torch.geometry.uv import mesh_uv_wrap

    cfg, *_, ref = stack
    _, (v, f) = _position_maps(cfg, 6)
    render = MeshRender(default_resolution=256, texture_size=256)
    render.load_mesh(mesh_uv_wrap(Mesh(v, f)))
    vw = cfg["views"]
    mats = [render._mvp(e, a) for e, a in zip(vw["elevs"], vw["azims"])]
    mvs, mvps = (torch.from_numpy(np.stack([m[i] for m in mats])) for i in (0, 1))
    gen = torch.Generator().manual_seed(6)
    views = torch.randint(0, 256, (6, 32, 32, 3), generator=gen, dtype=torch.uint8)
    geom = prepare_bake(upload_mesh(render, "cpu", need_uv=True), mvs, mvps, vw["weights"],
                        render_res=256, tex_res=256, up_res=128, exp=4.0)
    port_tex, port_trust = bake_prepared(geom, views, 256, 128)
    rv, rf, ruv, _ = render.get_mesh()          # the returned mesh's frame
    A = ref.Arith("fp32")
    assert np.array_equal(ref.render_axes(rv), render.vtx_pos)
    tex, trust = ref.bake(A, torch.from_numpy(ref.render_axes(rv)),
                          torch.from_numpy(rf.astype(np.int64)),
                          torch.from_numpy(ruv * [1, -1] + [0, 1]).float(), views,
                          ref.cameras(vw, "cpu"), vw["weights"], render=256, tex=256, exp=4.0)
    both = (port_trust > 1e-8) & (trust > 1e-8)
    assert both.float().mean() > 0.1
    assert _rel(port_tex[both], tex[both]) < 1e-3
    assert float(((port_trust > 1e-8) ^ (trust > 1e-8)).float().mean()) < 1e-3


@pytest.mark.parametrize("seed", [2 ** 31 + 101, 3_000_000_007])
def test_the_port_matches_the_reference(seed):
    spec = paint_tiny_spec()
    result = harness.run_cell(spec, seed, 0.5, False, "cpu", time.perf_counter(),
                              log=lambda *a, **k: None)
    assert result["correct"], result["checks"]
    for name, check in result["checks"].items():
        assert check["value"] <= check["limit"] / 2, (name, check)
    assert result["attempted"] >= 1 and result["failed"] == 0


def test_the_control_fails():
    spec = paint_tiny_spec("paint_turbo.f40k")
    limits = harness.load_file("reference", "paint_turbo").LIMITS
    r = control.readings(spec, 2 ** 31 + 3, 1, "cpu")
    assert all(r["program"][k] <= limits[k] for k in r["program"]), r
    assert any(r["control"][k] > limits[k] for k in r["control"]), r


def test_the_faults_need_no_reference():
    """A UV outside [0, 1], a face index out of range, a non-finite texel
    and a GLB that does not read back as the returned mesh are each
    counted."""
    from hunyuan3d2_tpu_torch.geometry.mesh import Mesh

    ref = harness.load_file("reference", "paint_turbo")
    read_glb = harness.load_file("systems", "paint").read_glb
    v = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    f = np.array([[0, 1, 2]], np.int32)
    uv = np.array([[0, 0], [1, 0], [0, 1]], np.float32)
    tex = np.full((4, 4, 3), 100, np.uint8)
    mesh = Mesh(v, f, uv=uv, texture=tex)
    texels = torch.zeros(4, 4, 3)
    assert ref.mesh_faults(mesh) == 0
    assert ref.texture_faults(texels, mesh, lambda: read_glb(mesh.to_glb_bytes())) == 0
    assert ref.mesh_faults(Mesh(v, f, uv=uv + 1.5)) == 6
    assert ref.mesh_faults(Mesh(v, f + 1, uv=uv)) == 1
    texels[0, 0, 0] = float("nan")
    assert ref.texture_faults(texels, mesh, lambda: read_glb(mesh.to_glb_bytes())) == 1
    other = Mesh(v, f, uv=uv, texture=tex + 1)
    assert ref.texture_faults(torch.zeros(4, 4, 3), mesh,
                              lambda: read_glb(other.to_glb_bytes())) == 1
    assert ref.texture_faults(torch.zeros(4, 4, 3), mesh,
                              lambda: read_glb(mesh.to_glb_bytes()[:-8])) == 1

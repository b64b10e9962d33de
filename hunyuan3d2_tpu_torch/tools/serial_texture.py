"""The textured call's public stages run one after another in the serial
order, before the unwrap overlapped the denoise: the reference that
chip_smoke.py and tests/test_torch_texgen_overlap.py hold the pipeline's
overlapped call to, bit for bit."""

from __future__ import annotations


def serial_texture(pipe, mesh, image, init_latents=None, step_noises=None):
    """``pipe(mesh, image, init_latents, step_noises)`` stage by stage in
    the serial order: cond maps → multiview net → ``mesh_uv_wrap`` (in this
    process) → upload → bake geometry → bake → inpaint → the textured
    mesh."""
    import numpy as np
    import torch

    from hunyuan3d2_tpu_torch.geometry.render_device import (bake_prepared, cond_maps,
                                                              prepare_bake, upload_mesh)
    from hunyuan3d2_tpu_torch.geometry.uv import mesh_uv_wrap
    from hunyuan3d2_tpu_torch.pipelines.texgen import camera_info_index

    cfg, render, dev = pipe.config, pipe.render, pipe.device
    mv_net = pipe.models["multiview_model"]
    elevs, azims = cfg.candidate_camera_elevs, cfg.candidate_camera_azims
    with torch.no_grad():
        render.load_mesh(mesh)
        mats = [render._mvp(e, a) for e, a in zip(elevs, azims)]
        mvs, mvps = (torch.from_numpy(np.stack([m[i] for m in mats]).astype(np.float32)).to(dev)
                     for i in (0, 1))
        cond = cond_maps(upload_mesh(render, dev), mvps, mv_net.view_size)
        views = mv_net([pipe.recenter_image(image)], cond,
                       [camera_info_index(a, e) for a, e in zip(azims, elevs)],
                       output_type="device", init_latents=init_latents,
                       step_noises=step_noises)
        del cond
        render.load_mesh(mesh_uv_wrap(mesh))
        render_res, tex_res = max(render.default_resolution), render.texture_size[0]
        up_res = min(render_res, 4 * mv_net.view_size)
        geom = prepare_bake(upload_mesh(render, dev, need_uv=True), mvs, mvps,
                            cfg.candidate_view_weights, render_res=render_res, tex_res=tex_res,
                            up_res=up_res, exp=float(cfg.bake_exp))
        texture, trust = bake_prepared(geom, views, tex_res, up_res)
        mask = ((trust > 1e-8).cpu().numpy() * 255).astype(np.uint8)
        render.set_texture(pipe.texture_inpaint(texture.cpu().numpy(), mask))
    return render.save_mesh()

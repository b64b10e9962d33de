"""Rank functions for the port's parallel tests (hunyuan3d2_tpu_torch/parallel).

Each function runs on every rank of a process group that
``parallel.mesh.spawn`` started, and returns numpy arrays and plain values
for the test process to assert on. This module imports only torch, numpy
and the port: the spawned ranks must not import JAX. Each rank uses one
intra-op thread at a lower priority (the suite's other workers share the
host's cores).
"""

import os

import numpy as np
import torch

from hunyuan3d2_tpu_torch.io import convert
from hunyuan3d2_tpu_torch.models import dit, paint_unet
from hunyuan3d2_tpu_torch.ops.nn import build
from hunyuan3d2_tpu_torch.parallel import diagnostics, make_mesh, mesh, shard_params, sharding


def spawn_once(tmp_path_factory, name, fn, world_size, make_args):
    """``mesh.spawn(fn, world_size)`` on gloo ranks, once per test run: under
    pytest-xdist each worker that runs a test of the module sets up its
    module-scoped fixture, so the first computes the ranks' results and the
    others load them (a file lock in the run's shared temporary directory).
    ``make_args()`` gives fn's arguments."""
    from filelock import FileLock

    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent
    path = root / f"{name}.pt"
    with FileLock(str(path) + ".lock"):
        if not path.exists():
            torch.save(mesh.spawn(fn, world_size, backend="gloo", device="cpu",
                                  args=make_args()), path)
        return torch.load(path, weights_only=False)


def _np(x):
    return x.detach().float().cpu().numpy()


def _one_background_thread():
    """One intra-op thread at a lower priority: the ranks share the host's
    cores with the suite's other workers, some of whose tests hold a
    wall-clock budget."""
    os.nice(10)
    torch.set_num_threads(1)


def _dit(sd, cfg, device="cpu"):
    return convert.load_numpy_state_dict(build(dit.Hunyuan3DDiT, cfg, device=device), sd)


def _param_bytes(module):
    return sum(p.numel() * p.element_size() for p in module.parameters())


def _image():
    from PIL import Image

    arr = np.zeros((128, 128, 4), np.uint8)
    arr[32:96, 32:96] = [200, 90, 90, 255]
    return Image.fromarray(arr)


def full_state_dict(module, tensors=None):
    """{name: whole tensor} of a sharded module: each shard all-gathered over
    tp and put back in its rows or columns. ``tensors`` (default the
    parameters) are this rank's tensors under the parameters' names, e.g.
    their gradients. Every tp rank must call it."""
    from hunyuan3d2_tpu_torch.parallel import collectives

    tensors = dict(module.named_parameters()) if tensors is None else tensors
    shards = {n: m for n, m in module.named_modules() if isinstance(m, sharding.ShardedLinear)}
    out = {}
    for name, t in tensors.items():
        owner, _, leaf = name.rpartition(".")
        m = shards.get(owner)
        t = t.detach()
        if m is None or (leaf == "bias" and m.dim == 1):
            out[name] = t
            continue
        dim = m.dim if leaf == "weight" else 0
        parts = collectives.all_gather(t, m.group, dim)
        index = collectives.all_gather(m.index, m.group, 0)
        out[name] = torch.empty_like(parts).index_copy_(dim, index, parts)
    return out


def parallel_cases(rank, sd, cfg_kwargs, inputs, train, trace_dir):
    """The (dp, tp) cases on 4 ranks: the mesh rule, the dp2×tp2 forward with
    its collective stats (tally and trace), a deliberately gathered tree,
    the sharded train step, and the tiny shape pipeline's shard()."""
    from hunyuan3d2_tpu_torch.pipelines.shapegen import Hunyuan3DDiTFlowMatchingPipeline
    from hunyuan3d2_tpu_torch.training import make_train_step
    from hunyuan3d2_tpu_torch.utils import profiling

    _one_background_thread()
    out = {}
    mesh = make_mesh(4, device="cpu")
    out["mesh"] = {"default": tuple(mesh.shape), "names": tuple(mesh.mesh_dim_names),
                   "dp1": tuple(make_mesh(4, dp=1, device="cpu").shape)}
    try:
        make_mesh(8, device="cpu")
        out["too_few"] = None
    except RuntimeError as e:
        out["too_few"] = str(e)

    cfg = dit.DiTConfig(**cfg_kwargs)
    x, t, cond = (torch.from_numpy(a) for a in inputs)
    model = _dit(sd, cfg)
    out["param_bytes"] = _param_bytes(model)
    shard_params(model, mesh)
    out["local_param_bytes"] = _param_bytes(model)
    diagnostics.reset_collective_stats()
    with torch.no_grad(), profiling.trace(f"{trace_dir}/rank{rank}") as tr:
        xs, ts, cs = sharding.shard_batch((x, t, cond), mesh)
        out["forward"] = _np(sharding.gather_batch(model(xs, ts, cs), mesh, x.shape[0]))
    out["forward_stats"] = diagnostics.collective_stats()
    out["forward_trace_stats"] = diagnostics.collective_stats(tr.path)
    diagnostics.reset_collective_stats()
    sharding.C.all_gather(torch.ones(3, 5), mesh.get_group("tp"), 0)
    out["gather_probe_stats"] = diagnostics.collective_stats()
    diagnostics.reset_collective_stats()
    full = full_state_dict(model)
    out["gathered_stats"] = diagnostics.collective_stats()
    out["gathered_equal"] = all(torch.equal(full[k].float(), torch.from_numpy(v).float())
                                for k, v in sd.items())

    lat, tcond, x0, sigma = (torch.from_numpy(a) for a in train)
    model = shard_params(_dit(sd, cfg), mesh)
    _, step = make_train_step(model)
    losses = []
    for i in range(3):
        losses.append(float(step(lat, tcond, x0=x0, sigma=sigma)))
        if i == 0:
            grads = full_state_dict(model, {n: p.grad for n, p in
                                                     model.named_parameters()})
            out["grads"] = {k: _np(v) for k, v in grads.items()}
            out["weights_1"] = {k: _np(v) for k, v in full_state_dict(model).items()}
    out["losses"] = losses

    pipe = Hunyuan3DDiTFlowMatchingPipeline.init_random(size="tiny", dino="tiny", device="cpu")
    img = _image()
    ref = pipe(image=img, num_inference_steps=2, output_type="latents", seed=3)
    assert pipe.shard(make_mesh(4, device="cpu")) is pipe
    out["pipe_mesh"] = tuple(pipe.mesh.shape)
    out["pipe_local_heads"] = (pipe.model.double_blocks[0].num_heads,
                               pipe.conditioner.main.model.encoder.layer[0].num_heads,
                               pipe.vae.transformer.resblocks[0].heads)
    out["pipe_latents"] = (_np(ref), _np(pipe(image=img, num_inference_steps=2,
                                              output_type="latents", seed=3)))
    mesh_out = pipe(image=img, num_inference_steps=2, octree_resolution=16, seed=3)[0]
    out["pipe_mesh_faces"] = -1 if mesh_out is None else len(mesh_out.faces)
    return out if rank == 0 else {"forward": out["forward"], "losses": losses}


def pipeline_cases(rank, cases):
    """pp_apply for each (name, sd, cfg kwargs, pp, n_micro, x, t, cond,
    guidance) on 4 ranks; returns {name: output}."""
    from hunyuan3d2_tpu_torch.parallel import make_pp_mesh, pp_apply

    _one_background_thread()
    out = {}
    for name, sd, cfg_kwargs, pp, n_micro, x, t, cond, g in cases:
        model = _dit(sd, dit.DiTConfig(**cfg_kwargs))
        args = [torch.from_numpy(a) for a in (x, t, cond)]
        guidance = None if g is None else torch.from_numpy(g)
        out[name] = _np(pp_apply(model, make_pp_mesh(pp, device="cpu"), *args,
                                 n_micro=n_micro, guidance=guidance))
    return out


def paint_cases(rank, sd, cfg_kwargs, inputs):
    """The paint UNet at dp2×tp4 on 8 ranks (write then read, as
    ``paint_unet.apply``), the modes its attentions took, and the standard
    sampler of the tiny paint pipeline before and after shard()."""
    from hunyuan3d2_tpu_torch.pipelines.hunyuanpaint import HunyuanPaintPipeline
    from hunyuan3d2_tpu_torch.pipelines.texgen import Hunyuan3DPaintPipeline

    _one_background_thread()
    cfg = paint_unet.PaintUNetConfig(**cfg_kwargs)
    unet = convert.load_numpy_state_dict(build(paint_unet.UNet2p5D, cfg, device="cpu"), sd)
    mesh = make_mesh(8, device="cpu")
    shard_params(unet, mesh)
    sample, normal, position, ref, cam_gen, cam_ref = sharding.shard_batch(
        tuple(torch.from_numpy(a) for a in inputs), mesh)
    with torch.no_grad():
        cache = unet.write_cache(ref, cam_ref)
        pred = unet(sample, 200.0, normal, position, cam_gen, cache)
    out = {"unet": _np(sharding.gather_batch(pred, mesh, inputs[0].shape[0])),
           "modes": {n: m.mode for n, m in unet.named_modules()
                     if isinstance(m, sharding.ShardedLinear)}}

    rs = np.random.RandomState(5)
    image = _image()
    maps = [torch.from_numpy(rs.randint(0, 256, (2, 32, 32, 3)).astype(np.uint8))
            for _ in range(2)]
    call = dict(normal_imgs=maps[0], position_imgs=maps[1], camera_info_gen=[[0, 1]],
                num_inference_steps=2, output_type="np")
    paint = HunyuanPaintPipeline.init_random(size="tiny", view_size=32, device="cpu")
    whole = paint(image, **call).images
    assert paint.shard(make_mesh(8, device="cpu")) is paint
    out["paint"] = (whole, paint(image, **call).images)
    tex = Hunyuan3DPaintPipeline.init_random(size="tiny", view_size=32, render_size=48,
                                             texture_size=48, num_inference_steps=1,
                                             device="cpu")
    assert tex.shard(make_mesh(8, device="cpu")) is tex
    out["texgen_mesh"] = tuple(tex.models["multiview_model"].pipeline.mesh.shape)
    return out if rank == 0 else {"unet": out["unet"]}


def world_one_shape_case(rank, size, device):
    """shard(make_mesh(1)) on a one-rank group: the shape pipeline's latents
    (the DiT at ``size``, the tiny DINOv2) and kernel-1 launches before and
    after."""
    from hunyuan3d2_tpu_torch.ops.flash_attention import flash_attention
    from hunyuan3d2_tpu_torch.pipelines.shapegen import Hunyuan3DDiTFlowMatchingPipeline

    pipe = Hunyuan3DDiTFlowMatchingPipeline.init_random(size=size, dino="tiny", device=device)
    runs = []
    for shard in (False, True):
        if shard:
            pipe.shard(make_mesh(1, device=device))
        flash_attention.launches = 0
        lat = pipe(image=_image(), num_inference_steps=2, output_type="latents", seed=3)
        runs.append((_np(lat), flash_attention.launches))
    return runs

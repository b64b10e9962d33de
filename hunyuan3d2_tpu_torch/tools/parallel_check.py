"""The port's parallelism on the card, each run against one process.

:func:`rank_checks` runs on every rank of an ``N``-rank process group
(parallel/mesh.py ``spawn``) and raises on a failed check:

* the mini DiT at full width (1024 wide, 16 heads of 64, 8 + 16 blocks) on
  x [2,512,64], cond [2,1370,1536] bf16: the single-process forward, then
  tp = N (``make_mesh(N, dp=1)``), dp = 2 (``make_mesh(N, dp=2)``: tp = N/2)
  and pp = N (n_micro 2), each one warm-up and one timed forward with the
  kernel counts set to 0 just before. Each is held to the single-process
  forward by the DiT parity rule of tests/test_torch_models.py (bf16 through
  24 blocks, summed in other orders: within 5 % of the largest output,
  correlation above 0.999), and kernel 1 launches 24 times a rank at tp and
  dp (48/N at pp: a stage runs 24/N blocks for each of 2 microbatches);
* one tp = N training step against the single-process step (loss within
  tests/test_torch_training.py's 2e-3);
* the shape pipeline at full width (DINOv2-giant, the mini DiT, 5 steps at
  CFG 5.0) after ``shard(make_mesh(N))`` against its unsharded latents,
  within tests/test_pipeline_sharded.py's 5e-2;
* each run's collective stats, held to ``assert_no_full_param_gather``.

chip_smoke.py's phase 14b runs it on two gloo ranks sharing one card (NCCL
refuses two ranks on one device); on N cards:

    python -m hunyuan3d2_tpu_torch.tools.parallel_check --ranks 4

prints the card's name and power limit and one JSON line per rank.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import time

import numpy as np
import torch


def _check(ok, msg):
    if not ok:
        raise RuntimeError(msg)


def _image():
    from PIL import Image

    rs = np.random.RandomState(0)
    img = np.zeros((512, 512, 4), np.uint8)
    yy, xx = np.mgrid[:512, :512]
    blob = (yy - 256) ** 2 / 180 ** 2 + (xx - 256) ** 2 / 120 ** 2 < 1
    img[blob, :3] = rs.randint(40, 220, (int(blob.sum()), 3))
    img[blob, 3] = 255
    return Image.fromarray(img)


def rank_checks(rank: int, world: int) -> dict:
    """The checks above on this rank of ``world``; returns each run's times
    (host clock around a synchronised call), launches, kernel-1 shapes,
    errors and collective stats."""
    import hunyuan3d2_tpu_torch.ops.attention as attention_mod
    from hunyuan3d2_tpu_torch.models import dit
    from hunyuan3d2_tpu_torch.ops.flash_attention import flash_attention
    from hunyuan3d2_tpu_torch.ops.nn import build
    from hunyuan3d2_tpu_torch.parallel import diagnostics, make_mesh, make_pp_mesh, sharding
    from hunyuan3d2_tpu_torch.parallel.pipeline import PipelinedDiT
    from hunyuan3d2_tpu_torch.pipelines.shapegen import Hunyuan3DDiTFlowMatchingPipeline
    from hunyuan3d2_tpu_torch.training import make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(21)
    x = torch.randn(2, 512, 64, generator=gen, device="cuda").to(torch.bfloat16)
    t = torch.rand(2, generator=gen, device="cuda")
    cond = torch.randn(2, 1370, 1536, generator=gen, device="cuda").to(torch.bfloat16)
    lat = torch.randn(2, 512, 64, generator=gen, device="cuda")
    x0 = torch.randn(2, 512, 64, generator=gen, device="cuda")
    sigma = torch.rand(2, generator=gen, device="cuda")

    def model():
        return build(dit.Hunyuan3DDiT, dit.MINI, device="cuda",
                     generator=torch.Generator(device="cuda").manual_seed(0))

    shapes = set()

    def recorded(q, k, v, scale=None):
        shapes.add(tuple(q.shape))
        return flash_attention(q, k, v, scale=scale)

    attention_mod.flash_attention = recorded

    def timed(fn):
        fn()
        torch.cuda.synchronize()
        flash_attention.launches = 0
        shapes.clear()
        diagnostics.reset_collective_stats()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t0)

    res = {}
    with torch.no_grad():
        m = model()
        param_bytes = sum(p.numel() * p.element_size() for p in m.parameters())
        ref, ms = timed(lambda: m(x, t, cond))
        res["single"] = dict(ms=ms, launches=flash_attention.launches, shapes=sorted(shapes))
        del m
        for name in ("tp", "dp", "pp"):
            if name == "pp":
                fwd = PipelinedDiT(model(), make_pp_mesh(world), n_micro=2)
                held = fwd.model
            else:
                mesh = make_mesh(world, dp=2 if name == "dp" else 1)
                held = sharding.shard_params(model(), mesh)

                def fwd(x, t, cond, m=held, mesh=mesh):
                    xs, ts, cs = sharding.shard_batch((x, t, cond), mesh)
                    return sharding.gather_batch(m(xs, ts, cs), mesh, x.shape[0])
            out, ms = timed(lambda: fwd(x, t, cond))
            stats = diagnostics.collective_stats()
            err = (out.float() - ref.float()).abs().max().item()
            scale = ref.float().abs().max().item()
            corr = torch.corrcoef(torch.stack([out.float().ravel(), ref.float().ravel()]))[0, 1]
            res[name] = dict(ms=ms, launches=flash_attention.launches, shapes=sorted(shapes),
                             max_abs_err=err, ref_max=scale, corr=corr.item(),
                             stats=diagnostics.format_stats(stats),
                             local_param_bytes=sum(p.numel() * p.element_size()
                                                   for p in held.parameters()))
            _check(out.shape == ref.shape and err <= 0.05 * scale and corr > 0.999,
                   f"{name}: max |diff| {err} (limit {0.05 * scale}), corr {corr}")
            want = 48 // world if name == "pp" else 24
            _check(flash_attention.launches == want,
                   f"{name}: {flash_attention.launches} flash_attention launches, {want} expected")
            diagnostics.assert_no_full_param_gather(stats, param_bytes, name)
            del fwd, held, out
            torch.cuda.empty_cache()
    want = [(2, 16 // world, 1882, 64)]
    _check(res["tp"]["shapes"] == want, f"tp: kernel 1 shapes {res['tp']['shapes']}, {want} "
           "expected")

    losses = {}
    for name in ("single", "tp"):
        m = model()
        if name == "tp":
            sharding.shard_params(m, make_mesh(world, dp=1))
        _, step = make_train_step(m)
        diagnostics.reset_collective_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses[name] = float(step(lat, cond, x0=x0, sigma=sigma))
        torch.cuda.synchronize()
        stats = diagnostics.collective_stats()
        res[f"train_{name}"] = dict(ms=1e3 * (time.perf_counter() - t0), loss=losses[name],
                                    stats=diagnostics.format_stats(stats))
        diagnostics.assert_no_full_param_gather(stats, param_bytes, f"train {name}")
        del m, step
        torch.cuda.empty_cache()
    _check(math.isfinite(losses["tp"])
           and abs(losses["tp"] - losses["single"]) <= 2e-3 * abs(losses["single"]),
           f"train: tp loss {losses['tp']}, single-process {losses['single']}")

    pipe = Hunyuan3DDiTFlowMatchingPipeline.init_random(size="mini", dino="giant",
                                                        device="cuda", seed=0)
    call = dict(image=_image(), output_type="latents", seed=1234, num_inference_steps=5,
                guidance_scale=5.0)
    whole, whole_ms = timed(lambda: pipe(**call))
    pipe.shard(make_mesh(world))
    sharded, ms = timed(lambda: pipe(**call))
    err = (sharded - whole).abs().max().item()
    res["pipeline"] = dict(ms=ms, unsharded_ms=whole_ms, launches=flash_attention.launches,
                           mesh=list(pipe.mesh.shape), max_abs_err=err,
                           ref_max=whole.abs().max().item(),
                           stats=diagnostics.format_stats(diagnostics.collective_stats()))
    _check(torch.allclose(sharded, whole, atol=5e-2, rtol=5e-2),
           f"pipeline: sharded latents max |diff| {err} from the unsharded run's")
    res["param_bytes"] = param_bytes
    return res


def main(argv=None):
    from hunyuan3d2_tpu_torch.parallel.mesh import spawn

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=torch.cuda.device_count(),
                    help="ranks, one a card with nccl (default: every card)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("parallel_check: no CUDA device; this tool runs on the card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip().splitlines()
    print(f"cards: {card}", flush=True)
    from hunyuan3d2_tpu_torch.utils import cuda_build

    cuda_build.build(["flash_attention"])   # once, before the ranks load it
    t0 = time.perf_counter()
    ranks = spawn(rank_checks, args.ranks, backend="nccl", device="cuda", args=(args.ranks,))
    print(f"{args.ranks} nccl ranks in {time.perf_counter() - t0:.1f} s", flush=True)
    for r, res in enumerate(ranks):
        print(f"rank {r} " + json.dumps(res), flush=True)


if __name__ == "__main__":
    main()

"""A TINY cut of a paint cell that the harness runs on the CPU in seconds:
the port's ``paint_unet.TINY`` and ``sd_vae.TINY`` widths, 32² views,
render and texture 256, two LCM steps, meshes of ~600 faces, a pool of
three requests."""

import copy
import dataclasses
import os

from conftest import ROOT


def paint_tiny_spec(workload: str = "paint_turbo.f10k") -> dict:
    from benchmark import harness
    from hunyuan3d2_tpu_torch.models import paint_unet, sd_vae

    spec = copy.deepcopy(harness.cell_spec(
        harness.load_json(os.path.join(ROOT, "BENCHMARK.json")), workload))
    cfg, traffic = spec["config"], spec["traffic"]
    cfg["unet"] = {k: list(v) if isinstance(v, tuple) else v
                   for k, v in dataclasses.asdict(paint_unet.TINY).items()}
    cfg["vae"] = {k: list(v) if isinstance(v, tuple) else v
                  for k, v in dataclasses.asdict(sd_vae.TINY).items()}
    cfg["views"]["size"] = 32
    cfg["render_size"] = cfg["texture_size"] = 256
    cfg["sampler"]["steps"] = 2
    traffic["mesh"]["faces"] = 600
    traffic["image"]["size"] = 64
    traffic["pool"] = 3
    traffic["check"]["requests"] = 2
    traffic["trace"]["requests"] = 1
    return spec

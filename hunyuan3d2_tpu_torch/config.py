"""Config registry: a checkpoint config's ``target`` / ``params`` → the port's
classes (copy of hunyuan3d2_tpu/config.py).

Every Hunyuan3D-2 checkpoint's config.yaml names its classes by the
reference's module paths (``hy3dgen.shapegen...``); REGISTRY maps those
names onto the port's classes, so an unchanged config resolves here. A
``hy3dgen.`` path that REGISTRY does not list (the reference exports each
class from more than one module) resolves by its class name. The checkpoint
loader (``io/checkpoints.py``) finds every tower's class here.
"""

from __future__ import annotations

import importlib

REGISTRY = {
    "hy3dgen.shapegen.models.Hunyuan3DDiT": "hunyuan3d2_tpu_torch.models.dit.Hunyuan3DDiT",
    "hy3dgen.shapegen.models.ShapeVAE": "hunyuan3d2_tpu_torch.models.shapevae.ShapeVAE",
    "hy3dgen.shapegen.models.denoisers.Hunyuan3DDiT": "hunyuan3d2_tpu_torch.models.dit.Hunyuan3DDiT",
    "hy3dgen.shapegen.models.autoencoders.ShapeVAE": "hunyuan3d2_tpu_torch.models.shapevae.ShapeVAE",
    "hy3dgen.shapegen.models.conditioner.SingleImageEncoder":
        "hunyuan3d2_tpu_torch.models.conditioner.SingleImageEncoder",
    "hy3dgen.shapegen.models.conditioner.DualImageEncoder":
        "hunyuan3d2_tpu_torch.models.conditioner.DualImageEncoder",
    "hy3dgen.shapegen.models.conditioner.DinoImageEncoder":
        "hunyuan3d2_tpu_torch.models.conditioner.DinoImageEncoder",
    "hy3dgen.shapegen.models.conditioner.DinoImageEncoderMV":
        "hunyuan3d2_tpu_torch.models.conditioner.DinoImageEncoderMV",
    "hy3dgen.shapegen.schedulers.FlowMatchEulerDiscreteScheduler":
        "hunyuan3d2_tpu_torch.pipelines.schedulers.FlowMatchEulerDiscreteScheduler",
    "hy3dgen.shapegen.schedulers.ConsistencyFlowMatchEulerDiscreteScheduler":
        "hunyuan3d2_tpu_torch.pipelines.schedulers.ConsistencyFlowMatchEulerDiscreteScheduler",
    "hy3dgen.shapegen.preprocessors.ImageProcessorV2":
        "hunyuan3d2_tpu_torch.utils.imageproc.ImageProcessorV2",
    "hy3dgen.shapegen.preprocessors.MVImageProcessorV2":
        "hunyuan3d2_tpu_torch.utils.imageproc.MVImageProcessorV2",
}


_BY_NAME = {path.rsplit(".", 1)[1]: path for path in REGISTRY.values()}


def get_obj_from_str(string: str, reload: bool = False):
    if string in REGISTRY:
        string = REGISTRY[string]
    elif string.startswith("hy3dgen."):
        name = string.rsplit(".", 1)[-1]
        if name not in _BY_NAME:
            raise KeyError(f"{string}: the port has no class of that name")
        string = _BY_NAME[name]
    module, cls = string.rsplit(".", 1)
    mod = importlib.import_module(module)
    if reload:
        importlib.reload(mod)
    return getattr(mod, cls)


def instantiate_from_config(config: dict, **kwargs):
    """``cls(**params, **kwargs)`` for the class that ``config["target"]`` names."""
    if "target" not in config:
        raise KeyError("Expected key `target` to instantiate.")
    cls = get_obj_from_str(config["target"])
    params = dict(config.get("params", {}) or {})
    params.update(kwargs)
    return cls(**params)

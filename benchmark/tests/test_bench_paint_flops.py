"""The paint stage's frozen yardstick (``benchmark/paint_flops.py``) equals
the port's own FLOP accounting (``models/paint_unet.py`` ``flops`` /
``apply_flops``, ``models/sd_vae.py`` ``flops``, held to the JAX package's
floats and ``FlopCounterMode``) at the configuration's full width."""

import dataclasses
import os

import pytest
from conftest import ROOT

from benchmark import harness, paint_flops
from hunyuan3d2_tpu_torch.models import paint_unet, sd_vae


def config():
    return harness.load_json(os.path.join(ROOT, "benchmark", "configs", "paint_turbo.json"))


def test_the_configuration_is_the_ports_default():
    cfg = config()
    assert cfg["unet"] == {k: list(v) if isinstance(v, tuple) else v
                           for k, v in dataclasses.asdict(paint_unet.DEFAULT).items()}
    assert cfg["vae"] == {k: list(v) if isinstance(v, tuple) else v
                          for k, v in dataclasses.asdict(sd_vae.DEFAULT).items()}


@pytest.mark.parametrize("views,batch,mode", [(6, 1, "r"), (6, 2, "r"), (1, 1, "w"), (4, 1, "r")])
def test_unet_pass_equals_the_ports(views, batch, mode):
    assert paint_flops.unet_flops(config()["unet"], 64, 64, views, 1, batch, mode) == \
        paint_unet.flops(paint_unet.DEFAULT, 64, 64, views, 1, batch, mode)


@pytest.mark.parametrize("batch", [1, 2])
def test_cache_pass_equals_the_ports(batch):
    assert paint_flops.cache_flops(config()["unet"], 64, 64, 1, batch) == \
        paint_unet.apply_flops(paint_unet.DEFAULT, 64, 64, 6, 1, batch)[1]


@pytest.mark.parametrize("direction,size,batch", [("encode", 512, 13), ("encode", 512, 1),
                                                  ("decode", 64, 1), ("decode", 64, 6)])
def test_vae_equals_the_ports(direction, size, batch):
    assert paint_flops.vae_flops(config()["vae"], size, size, batch, direction) == \
        sd_vae.flops(sd_vae.DEFAULT, size, size, batch, direction)


def test_a_requests_diffusion_work():
    """A turbo request: 10 'r' passes of 6 views at 64², one 'w' pass, 13
    images encoded (1 + 6 + 6, in three calls), 6 views decoded one by one:
    ~136 TFLOP, the stage's work as the issue of the cells counted it."""
    counts = {"unet_r": [(1, 6, 64, 64)] * 10, "unet_w": [(1, 1, 64, 64)],
              "vae_encode": [(1, 512, 512), (6, 512, 512), (6, 512, 512)],
              "vae_decode": [(1, 64, 64)] * 6}
    work = paint_flops.diffusion_flops(config(), counts)
    ucfg, vcfg = paint_unet.DEFAULT, sd_vae.DEFAULT
    assert work == pytest.approx(10 * paint_unet.flops(ucfg, 64, 64, 6, 1, 1, "r")
                                 + paint_unet.apply_flops(ucfg, 64, 64, 6, 1, 1)[1]
                                 + sd_vae.flops(vcfg, 512, 512, 13, "encode")
                                 + sd_vae.flops(vcfg, 64, 64, 6, "decode"), rel=1e-12)
    assert 135e12 < work < 137.5e12

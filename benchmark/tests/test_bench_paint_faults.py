"""A run of the harness on a TINY paint cell with the textured path broken
underneath comes out not correct, once for each fault the cell can have: a
sampler step that returns its state unchanged, the multiview attention's
voxel mask dropped, the views altered where they are decoded, the texture
altered where it is baked, and the UVs pushed outside [0, 1] where the
unwrapped mesh is made. The cell has a batch of one and one chip, so no
fault leaves half a batch or an exchange between chips out."""

import time

import pytest
from paint_tiny import paint_tiny_spec

from benchmark import harness


def _step_unchanged(monkeypatch):
    from hunyuan3d2_tpu_torch.pipelines import paint_schedulers

    monkeypatch.setattr(paint_schedulers.LCMScheduler, "step",
                        lambda self, out, sample, *a: (sample, sample))


def _mask_dropped(monkeypatch):
    from hunyuan3d2_tpu_torch.models import paint_unet

    monkeypatch.setattr(paint_unet, "compute_multi_resolution_mask", lambda *a, **k: {})


def _views_altered(monkeypatch):
    from hunyuan3d2_tpu_torch.models import sd_vae

    decode = sd_vae.AutoencoderKL.decode
    monkeypatch.setattr(sd_vae.AutoencoderKL, "decode", lambda self, z: decode(self, z) * 0.8)


def _texture_altered(monkeypatch):
    from hunyuan3d2_tpu_torch.pipelines import texgen

    bake = texgen.bake_prepared

    def broken(*args, **kwargs):
        texture, trust = bake(*args, **kwargs)
        return texture * 0.8, trust
    monkeypatch.setattr(texgen, "bake_prepared", broken)


def _uvs_outside(monkeypatch):
    from hunyuan3d2_tpu_torch.pipelines import texgen

    mesh = texgen.Mesh
    monkeypatch.setattr(texgen, "Mesh", lambda v, f, uv=None: mesh(v, f, uv=uv * 1.5 - 0.25))


FAULTS = {"step_unchanged": _step_unchanged, "mask_dropped": _mask_dropped,
          "views_altered": _views_altered, "texture_altered": _texture_altered,
          "uvs_outside": _uvs_outside}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_path_is_not_correct(monkeypatch, fault):
    FAULTS[fault](monkeypatch)
    result = harness.run_cell(paint_tiny_spec(), 2 ** 31 + 29, 0.5, False, "cpu",
                              time.perf_counter(), log=lambda *a, **k: None)
    assert result["correct"] is False, result["checks"]
    assert result["failed"] == 0

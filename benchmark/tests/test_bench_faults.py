"""A run of the harness with the timed path broken underneath comes out
not correct, once for each fault the image → mesh cell can have: a step
that returns its state unchanged, and an answer altered where it is
produced (the conditioner's tokens, the denoiser's velocity, the decoder's
logits, the mesh). The cell has a batch of one and one chip, so no fault
leaves half a batch or an exchange between chips out."""

import time

import numpy as np
import pytest

from benchmark import harness


def _step_unchanged(monkeypatch):
    from hunyuan3d2_tpu_torch.pipelines import schedulers

    monkeypatch.setattr(schedulers.FlowMatchEulerDiscreteScheduler, "step",
                        staticmethod(lambda sample, velocity, sigma, sigma_next: sample))


def _tokens_altered(monkeypatch):
    from hunyuan3d2_tpu_torch.models import conditioner

    encode = conditioner.DinoImageEncoder.encode
    monkeypatch.setattr(conditioner.DinoImageEncoder, "encode",
                        lambda self, px: encode(self, px) * 1.1)


def _velocity_altered(monkeypatch):
    from hunyuan3d2_tpu_torch.models import dit

    forward = dit.Hunyuan3DDiT.forward
    monkeypatch.setattr(dit.Hunyuan3DDiT, "forward", lambda self, *a: forward(self, *a) * 1.1)


def _logits_altered(monkeypatch):
    from hunyuan3d2_tpu_torch.models import shapevae

    make = shapevae.ShapeVAE._decode_fn
    monkeypatch.setattr(shapevae.ShapeVAE, "_decode_fn",
                        lambda self, k, v: (lambda fn: lambda pts: fn(pts) * 1.1)(make(self, k, v)))


def _mesh_altered(monkeypatch):
    from hunyuan3d2_tpu_torch.volume import surface

    to_mesh = surface.Latent2MeshOutput.to_mesh

    def broken(self):
        mesh = to_mesh(self)
        mesh.vertices = np.asarray(mesh.vertices) * 2.0
        return mesh
    monkeypatch.setattr(surface.Latent2MeshOutput, "to_mesh", broken)


FAULTS = {"step_unchanged": _step_unchanged, "tokens_altered": _tokens_altered,
          "velocity_altered": _velocity_altered, "logits_altered": _logits_altered,
          "mesh_altered": _mesh_altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_path_is_not_correct(tiny, monkeypatch, fault):
    FAULTS[fault](monkeypatch)
    result = harness.run_cell(tiny, 2 ** 31 + 29, 0.5, False, "cpu", time.perf_counter(),
                              log=lambda *a, **k: None)
    assert result["correct"] is False, result["checks"]
    assert result["failed"] == 0

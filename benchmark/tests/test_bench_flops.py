"""The frozen yardstick arithmetic equals the port's own FLOP accounting
(``hunyuan3d2_tpu_torch/utils/flops.py``, held to ``FlopCounterMode``) at
full width, and its new VAE-trunk count equals ``FlopCounterMode``'s count
of the plain reference."""

import math

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import flops, harness
from hunyuan3d2_tpu_torch.models import dinov2, dit, shapevae
from hunyuan3d2_tpu_torch.models.shapevae import ShapeVAE
from hunyuan3d2_tpu_torch.utils import flops as port_flops
from hunyuan3d2_tpu_torch.volume.decoders import FlashVDMVolumeDecoding

from conftest import ROOT, tiny_spec


def config():
    import os

    return harness.load_json(os.path.join(ROOT, "benchmark", "configs", "v20fast.json"))


@pytest.mark.parametrize("batch,cond", [(1, 1370), (2, 1370), (1, 4110)])
def test_dit_count_equals_the_ports(batch, cond):
    cfg = config()
    port = dit.DiTConfig(**cfg["dit"])
    assert flops.dit_forward_flops(cfg["dit"], 3072, cond, batch) == \
        port_flops.dit_forward_flops(port, 3072, cond, batch)


def test_dino_and_geo_counts_equal_the_ports():
    cfg = config()
    dino = dinov2.DinoConfig(**cfg["dino"])
    vae = shapevae.ShapeVAEConfig(**cfg["vae"])
    assert flops.dino_seq_len(cfg["dino"]) == dino.seq_len == 1370
    assert flops.dino_params(cfg["dino"]) == port_flops.dino_params(dino)
    assert flops.dino_encode_flops(cfg["dino"], 3) == port_flops.dino_encode_flops(dino, 3)
    assert flops.geo_query_flops(cfg["vae"]) == port_flops.geo_query_flops(vae)


@pytest.mark.parametrize("octree,queries", [(380, 3_711_889), (256, 1_237_384)])
def test_query_counts_of_the_cells(octree, queries):
    """The queries a v20fast request's decode sends (what the harness counts
    at the decode function's entry), from the port's decoder arithmetic."""
    assert port_flops.volume_decode_queries(FlashVDMVolumeDecoding(), octree, 200_000) == queries


def test_vae_trunk_count_equals_flop_counter_of_the_reference():
    ref = harness.load_file("reference", "v20fast")
    vae = dict(config()["vae"], num_latents=96, width=64, heads=4, num_decoder_layers=2)
    spec = tiny_spec()
    cfg = dict(spec["config"], vae=vae)
    gen = torch.Generator().manual_seed(0)
    with torch.device("meta"):
        module = ShapeVAE(shapevae.ShapeVAEConfig(**vae))
    weights = {f"vae.{n}": torch.randn(p.shape, generator=gen) for n, p in
               module.named_parameters()}
    lat = torch.randn(1, vae["num_latents"], vae["embed_dim"], generator=gen)
    with FlopCounterMode(display=False) as counter:
        ref.vae_kv(weights, ref.Arith("fp32"), cfg["vae"], lat)
    assert flops.vae_trunk_flops(vae) == counter.get_total_flops()


def test_attention_and_bound_arithmetic():
    assert flops.attention_flops(1, 16, 4442, 4442, 64) == 4 * 16 * 4442 ** 2 * 64
    assert flops.attention_bytes(1, 16, 4442, 4442, 64, 2) == 2 * 16 * 64 * 4 * 4442
    ops, nbytes = 1e12, 1e9
    assert flops.bound_s(ops, nbytes, flops.PEAK_BF16) == ops / 989e12
    assert flops.bound_s(1.0, nbytes, flops.PEAK_BF16) == nbytes / 3.35e12
    assert math.isclose(flops.PEAK_BY_DTYPE["float32"], 165e12)


def test_the_work_counts_take_the_queries_a_decode_needs():
    """At TINY size (octree 32: 6³ coarse points and 7 chosen blocks of 8³),
    the count at the decoder's block selection holds the queries the decode
    needs, and the decode calls send those and the padding of a chunk."""
    spec = tiny_spec()
    cfg, traffic = spec["config"], spec["traffic"]
    system = harness.load_file("systems", cfg["system"]).System(cfg, 3, "cpu")
    gen = harness.load_file("generators", traffic["generator"])
    pool = [system.prepare(r) for r in gen.pool(traffic, 3, count=1)]
    counts = {}
    with system.instrument(counts, spans=False):
        system(gen.request(traffic, pool, 3, 0, 0))
    coarse, blocks = 6 ** 3, int(5 ** 3 * 0.06)
    assert counts["volume_decode"] == [(coarse + blocks * 8 ** 3, len(counts["geo_decode"]))]
    assert sum(counts["geo_decode"]) >= coarse + blocks * 8 ** 3

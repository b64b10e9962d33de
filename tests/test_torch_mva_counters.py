"""The paint-turbo loop's counters of the masked multiview attention
(pipelines/hunyuanpaint.py ``denoise_lcm``), on the CPU at TINY size: for
each voxel-mask grid, the pairs its mask allows and all its pairs, times the
calls that used it, equal a dense count of the masks the multiview attention
was called with; the allowed pairs stay on the device until the request
ends, so reading them adds no host sync inside the loop; and the walk that
counts a forward's multiview calls (``paint_unet.multiview_calls``) is the
modules' own."""

import numpy as np
import pytest
import torch

from hunyuan3d2_tpu_torch.models import paint_unet
from hunyuan3d2_tpu_torch.pipelines.hunyuanpaint import MVA_COUNTER, HunyuanPaintPipeline
from hunyuan3d2_tpu_torch.utils import timer
from hunyuan3d2_tpu_torch.utils.timer import LAST_TIMINGS

VIEW, VIEWS, STEPS = 32, 6, 2


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pipeline(seed: int) -> HunyuanPaintPipeline:
    p = HunyuanPaintPipeline.init_random(size="tiny", view_size=VIEW, device="cpu", seed=seed)
    p.set_turbo()
    return p


def _maps(seed: int):
    """Seeded normal and position cond maps [VIEWS, VIEW, VIEW, 3] uint8: a
    disc of smooth positions a view on a white ground."""
    rng = np.random.default_rng(seed)
    g = (np.arange(VIEW) + 0.5) / VIEW
    yy, xx = np.meshgrid(g, g, indexing="ij")
    pos = np.full((VIEWS, VIEW, VIEW, 3), 255, np.uint8)
    for v in range(VIEWS):
        inside = (yy - 0.5) ** 2 + (xx - 0.5) ** 2 < rng.uniform(0.08, 0.2)
        planes = np.stack([xx, yy, 0.5 + 0.3 * np.sin(3 * xx + v)], -1)
        pos[v][inside] = np.clip(planes[inside] * 255, 0, 254).astype(np.uint8)
    normal = np.where(pos == 255, 255, 255 - pos).astype(np.uint8)
    return torch.from_numpy(normal), torch.from_numpy(pos)


def _call(pipeline, seed: int):
    from PIL import Image

    normal, position = _maps(seed)
    ref = Image.fromarray(np.full((VIEW, VIEW, 3), 90 + seed, np.uint8))
    return pipeline(ref, normal_imgs=normal, position_imgs=position,
                    camera_info_gen=[[0, 1, 2, 3, 4, 5]], num_inference_steps=STEPS,
                    output_type="device")


def test_the_walk_counts_the_forwards_multiview_calls(monkeypatch):
    """``multiview_calls`` equals the multiview attention calls a TINY and a
    DEFAULT-shaped 'r' pass make, by sequence length."""
    assert paint_unet.multiview_calls(paint_unet.DEFAULT, 64, 64, 6) == {
        6 * 64 * 64: 5, 6 * 32 * 32: 5, 6 * 16 * 16: 5, 6 * 8 * 8: 1}
    assert paint_unet.multiview_calls(paint_unet.DEFAULT, 64, 64, 1) == {}
    net = _pipeline(0).unet
    seen = {}
    forward = paint_unet.Attention.forward

    def count(self, x, kv, heads, mask=None, **kw):
        if self in multiview:
            seen[x.shape[1]] = seen.get(x.shape[1], 0) + 1
        return forward(self, x, kv, heads, mask=mask, **kw)

    multiview = {m.attn_multiview for m in net.modules()
                 if isinstance(m, paint_unet.Basic2p5DTransformerBlock)}
    monkeypatch.setattr(paint_unet.Attention, "forward", count)
    h = VIEW // 2                               # the TINY VAE halves the view
    lat = torch.zeros(1, VIEWS, h, h, 4, dtype=torch.bfloat16)
    cache = net.write_cache(torch.zeros(1, 1, h, h, 4, dtype=torch.bfloat16))
    net(lat, 500.0, lat, lat, torch.zeros(1, VIEWS, dtype=torch.long), cache)
    assert seen == paint_unet.multiview_calls(net.cfg, h, h, VIEWS) and seen


def test_counters_equal_a_dense_count_of_the_masks(monkeypatch):
    pipeline = _pipeline(3)
    used = []
    masked = paint_unet.masked_attention

    def spy(q, k, v, mask, scale=None):
        used.append(mask)
        return masked(q, k, v, mask, scale)

    monkeypatch.setattr(paint_unet, "masked_attention", spy)
    timer.request("Probe")(_call)(pipeline, 1)
    assert used, "the loop made no masked multiview call"
    live, total = {}, {}
    for m in used:
        tokens = m.shape[1]
        live[tokens] = live.get(tokens, 0) + int(m.sum())
        total[tokens] = total.get(tokens, 0) + m.numel()
    for tokens in live:
        assert LAST_TIMINGS[f"{MVA_COUNTER}/mva_pairs_live/{tokens}"] == live[tokens]
        assert LAST_TIMINGS[f"{MVA_COUNTER}/mva_pairs_masked_total/{tokens}"] == total[tokens]
        assert 0 < live[tokens] <= total[tokens]
    assert any(live[t] < total[t] for t in live), "no grid masked a pair"
    counted = {int(k.rsplit("/", 1)[1]) for k in LAST_TIMINGS
               if k.startswith(f"{MVA_COUNTER}/mva_pairs_live/")}
    assert counted == set(live)
    assert all(type(LAST_TIMINGS[f"{MVA_COUNTER}/mva_pairs_live/{t}"]) is int for t in live)


def test_reading_the_counters_adds_no_sync_inside_the_loop(monkeypatch):
    """Inside the denoise no tensor is read on the host; the counters are
    still device tensors when the loop returns, and become numbers only
    when the request ends."""
    pipeline = _pipeline(4)
    inside = {"on": False, "reads": 0, "totals": None}
    denoise = HunyuanPaintPipeline.denoise_lcm

    def watched(self, *args, **kwargs):
        inside["on"] = True
        try:
            return denoise(self, *args, **kwargs)
        finally:
            inside["on"] = False
            inside["totals"] = dict(timer._current.get().request.totals)

    def reader(name):
        original = getattr(torch.Tensor, name)

        def read(self, *args, **kwargs):
            inside["reads"] += inside["on"]
            return original(self, *args, **kwargs)
        return read

    monkeypatch.setattr(HunyuanPaintPipeline, "denoise_lcm", watched)
    for name in ("item", "tolist", "__int__", "__float__", "__bool__", "cpu", "numpy"):
        monkeypatch.setattr(torch.Tensor, name, reader(name))
    timer.request("Probe")(_call)(pipeline, 2)
    assert inside["reads"] == 0
    pending = {k: v for k, v in inside["totals"].items() if "/mva_pairs_live/" in k}
    assert pending and all(isinstance(v, torch.Tensor) for v in pending.values())
    assert all(type(LAST_TIMINGS[k]) is int for k in pending)

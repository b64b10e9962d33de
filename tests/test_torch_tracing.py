"""The request recorder of the port (hunyuan3d2_tpu_torch/utils/timer.py)
on the CPU at TINY sizes: one request id a call on every span, the span
tree of image → mesh with each child inside its parent, self times, the
stage keys of ``LAST_TIMINGS`` written at each scope's exit and the flat
view beside them, the decode's query counters at their source, the
``hy3d.*`` ranges under a profiler on the records' clock and no range
without one, the ring of records, threads kept apart, the markers'
arithmetic (with stand-in events: the CPU has none), and the textured
path's unwrap span inside its request and over its paint steps, its key
kept by the requests after it."""

import functools
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from hunyuan3d2_tpu_torch.pipelines.shapegen import Hunyuan3DDiTFlowMatchingPipeline
from hunyuan3d2_tpu_torch.utils import flops, host_worker, timer
from hunyuan3d2_tpu_torch.utils.timer import LAST_TIMINGS

STEPS, OCTREE, CHUNKS = 3, 32, 3000   # the fine pass pads 7 blocks to 10
STAGES = ("Preprocess", "Encode Cond", "Diffusion Sampling", "Volume Decoding")
TREE = {"Image to Mesh": None, "Preprocess": "Image to Mesh", "Encode Cond": "Image to Mesh",
        "Diffusion Sampling": "Image to Mesh", "DiT Step": "Diffusion Sampling",
        "Volume Decoding": "Image to Mesh", "VAE Trunk": "Volume Decoding",
        "Geo Decode": "Volume Decoding", "Surface": "Volume Decoding",
        "Export": "Image to Mesh"}


@pytest.fixture(autouse=True)
def _one_thread():
    # the suite's other workers share the host's cores
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pipe():
    p = Hunyuan3DDiTFlowMatchingPipeline.init_random(size="tiny", dino="tiny", device="cpu")
    return p.enable_flashvdm(mc_algo="dmc")


@pytest.fixture(scope="module")
def image():
    from PIL import Image

    img = np.zeros((64, 64, 4), np.uint8)
    img[14:50, 18:46, :3] = [180, 60, 40]
    img[14:50, 18:46, 3] = 255
    return Image.fromarray(img)


def _call(pipe, image, seed=0):
    return pipe(image, num_inference_steps=STEPS, octree_resolution=OCTREE, num_chunks=CHUNKS,
                seed=seed)


def _decode_calls(pipe, log):
    """An instance tap on ``_decode_fn`` that appends each decode call's
    points to ``log`` (the benchmark's tap pattern)."""
    make = pipe.vae._decode_fn

    def make_logged(k, v):
        fn = make(k, v)

        def decode(pts):
            log.append(pts.shape[0] * pts.shape[1])
            return fn(pts)
        return decode
    return make_logged


def test_one_request_id_a_call(pipe, image):
    _call(pipe, image)
    first = timer.last_request()
    _call(pipe, image, seed=1)
    second = timer.last_request()
    assert first is not second and first.id != second.id
    for rec in (first, second):
        assert rec.name == "Image to Mesh" and rec.root.parent is None
        assert {s.request_id for s in rec.spans} == {rec.id}
    assert timer.requests()[-2:] == [first, second]


def test_span_tree_intervals_and_self_time(pipe, image, monkeypatch):
    decodes = []
    monkeypatch.setattr(pipe.vae, "_decode_fn", _decode_calls(pipe, decodes), raising=False)
    _call(pipe, image)
    rec = timer.last_request()
    assert {s.name for s in rec.spans} == set(TREE)
    for s in rec.spans:
        want = TREE[s.name]
        assert (s.parent.name if s.parent else None) == want, s
        assert s.start_ns <= s.end_ns
        if s.parent is not None:
            assert s.parent.start_ns <= s.start_ns and s.end_ns <= s.parent.end_ns, s
        kids = [k for k in rec.spans if k.parent is s]
        assert rec.self_s(s) == pytest.approx(s.seconds - sum(k.seconds for k in kids),
                                              abs=1e-9)
        assert rec.self_s(s) >= 0
    assert [s.stage for s in rec.spans if s.name in STAGES] == [True] * len(STAGES)
    flat = timer.LAST_TIMINGS
    assert flat["DiT Step/n"] == STEPS
    assert flat["Geo Decode/n"] == len(decodes) >= 2
    assert flat["VAE Trunk/n"] == flat["Surface/n"] == flat["Export/n"] == 1
    assert "Image to Mesh/n" not in flat
    for name in ("Image to Mesh", "DiT Step", "Geo Decode", "Surface", "Export"):
        assert flat[name] == pytest.approx(sum(s.seconds for s in rec.spans if s.name == name))
    # the CPU has no markers
    assert not any(k.endswith("/device_s") for k in flat)
    assert all(s.device_s is None for s in rec.spans)


def test_stage_keys_are_written_at_each_scope_exit(pipe, image, monkeypatch):
    seen = {}
    sample = pipe.sample

    def spy(*args, **kwargs):
        seen.update(LAST_TIMINGS)
        return sample(*args, **kwargs)

    LAST_TIMINGS.clear()
    monkeypatch.setattr(pipe, "sample", spy)
    _call(pipe, image)
    rec = timer.last_request()
    # inside "Diffusion Sampling": the two stages before it are written, the
    # request's flat view is not yet
    assert {"Preprocess", "Encode Cond"} <= set(seen)
    assert "Diffusion Sampling" not in seen and "Image to Mesh" not in seen
    for name in STAGES:
        (s,) = [s for s in rec.spans if s.name == name]
        assert LAST_TIMINGS[name] == pytest.approx(s.seconds, abs=2e-3)


def test_flat_view_drops_the_last_requests_keys(pipe, image):
    _call(pipe, image)
    assert "DiT Step" in LAST_TIMINGS

    @timer.request("Other")
    def other():
        with timer.span("Inner"):
            pass

    other()
    assert LAST_TIMINGS["Inner/n"] == 1 and "Other" in LAST_TIMINGS
    for k in ("DiT Step", "DiT Step/n", "Image to Mesh", "Volume Decoding/queries_sent"):
        assert k not in LAST_TIMINGS
    assert set(STAGES) <= set(LAST_TIMINGS)     # stage keys stay


def test_query_counts_at_their_source(pipe, image, monkeypatch):
    sparse = []
    decode_sparse = pipe.vae._decode_sparse

    def tap(*args, **kwargs):
        out = decode_sparse(*args, **kwargs)
        sparse.append(out)
        return out

    decodes = []
    monkeypatch.setattr(pipe.vae, "_decode_fn", _decode_calls(pipe, decodes), raising=False)
    monkeypatch.setattr(pipe.vae, "_decode_sparse", tap, raising=False)
    _call(pipe, image)
    rec = timer.last_request()
    ((coarse, blk_idx, fine),) = sparse
    sent = rec.totals["Volume Decoding/queries_sent"]
    needed = rec.totals["Volume Decoding/queries_needed"]
    assert sent == flops.volume_decode_queries(pipe.vae.volume_decoder, OCTREE, CHUNKS)
    assert sent == sum(decodes)
    assert needed == coarse.numel() + blk_idx.numel() * 8 ** 3 == coarse.numel() + fine.numel()
    assert 0 < needed < sent
    assert LAST_TIMINGS["Volume Decoding/queries_sent"] == sent
    assert LAST_TIMINGS["Volume Decoding/queries_needed"] == needed


def test_worker_span_keeps_its_key(pipe, image):
    """Work from another process is a stage span: its key is written in or
    out of a request, and the flat view of a following request keeps it."""
    LAST_TIMINGS.pop("Elsewhere", None)
    t0 = time.perf_counter_ns()
    timer.record_span("Elsewhere", t0, t0 + 5_000_000)
    assert LAST_TIMINGS["Elsewhere"] == pytest.approx(0.005)

    @timer.request("Host")
    def host():
        timer.record_span("Elsewhere", t0, t0 + 7_000_000)

    host()
    (s,) = timer.last_request().spans[1:]
    assert s.stage and s.parent is timer.last_request().root
    assert s.seconds == pytest.approx(0.007)
    assert "Elsewhere/n" not in LAST_TIMINGS
    _call(pipe, image)
    assert LAST_TIMINGS["Elsewhere"] == pytest.approx(0.007)


def _trace_ranges(path):
    with open(path) as fh:
        trace = json.load(fh)
    base = trace.get("baseTimeNanoseconds", 0)
    return [(e["name"], e["ts"] * 1e3 + base) for e in trace["traceEvents"]
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"], base


def test_spans_appear_as_ranges_under_a_profiler(pipe, image, tmp_path):
    from torch.profiler import ProfilerActivity, profile

    _call(pipe, image)                                    # warm
    path = str(tmp_path / "trace.json")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _call(pipe, image)
    prof.export_chrome_trace(path)
    rec = timer.last_request()
    ranges, base = _trace_ranges(path)
    if not base:
        pytest.skip("this torch writes no baseTimeNanoseconds in a chrome trace")
    ours = [(n, ts) for n, ts in ranges if n.startswith(timer.PROFILER_PREFIX)]
    assert not [n for n, _ in ranges if n.startswith("bench.")]
    assert len(ours) == len(rec.spans)
    for s in rec.spans:
        starts = [ts for n, ts in ours if n == timer.PROFILER_PREFIX + s.name]
        assert min(abs(ts - timer.wall_ns(s.start_ns)) for ts in starts) < 1e6, s


def test_no_profiler_enters_no_range(pipe, image, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    _call(pipe, image)
    assert timer.last_request().name == "Image to Mesh"


def test_the_ring_keeps_64_requests():
    @timer.request("Tiny")
    def tiny():
        with timer.span("Inner"):
            timer.add("things", 1)

    for _ in range(timer.RING + 6):
        tiny()
    recs = timer.requests()
    assert len(recs) == timer.RING == 64
    assert [r.id for r in recs] == list(range(recs[0].id, recs[0].id + 64))
    assert recs[-1] is timer.last_request() and recs[-1].totals == {"things": 1}


def test_spans_on_two_threads_do_not_mix():
    barrier = threading.Barrier(2)
    out = {}

    @timer.request("Threaded")
    def work(tag):
        for i in range(3):
            with timer.span(f"{tag} outer"):
                barrier.wait()
                with timer.span(f"{tag} inner"):
                    timer.add(tag, 1 << i)
                    barrier.wait()
        out[tag] = timer._current.get().request

    threads = [threading.Thread(target=work, args=(t,)) for t in ("a", "b")]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    a, b = out["a"], out["b"]
    assert a.id != b.id
    for rec, tag in ((a, "a"), (b, "b")):
        assert {s.request_id for s in rec.spans} == {rec.id}
        assert rec.totals == {tag: 0b111}
        names = [s.name for s in rec.spans]
        assert names == ["Threaded"] + [f"{tag} outer", f"{tag} inner"] * 3
        for s in rec.spans[1:]:
            assert s.parent.name == ("Threaded" if s.name.endswith("outer") else f"{tag} outer")


def test_many_threads_keep_their_records(monkeypatch):
    """More threads than cores, a short switch interval: every request keeps
    its own spans and counters, and every pooled event comes back once."""
    import sys

    _Event.made = 0
    monkeypatch.setattr(timer, "_events", [])
    monkeypatch.setattr(timer, "_event", _pooled_event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: None)
    card = torch.device("cuda")
    errors, done = [], []

    @timer.request("Stress")
    def work(tag):
        for i in range(3):
            with timer.span("Step", device=card):
                timer.add(f"t{tag}", 1)
        done.append((tag, timer._current.get().request))

    def loop(tag):
        try:
            for _ in range(20):
                work(tag)
        except Exception as e:   # reported by the assertion below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=loop, args=(t,)) for t in range(4 * os.cpu_count())]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not errors and not any(t.is_alive() for t in threads)
    assert len(done) == 20 * len(threads) and len({r.id for _, r in done}) == len(done)
    for tag, rec in done:
        assert {s.request_id for s in rec.spans} == {rec.id}
        assert rec.totals == {f"t{tag}": 3}
        assert all(s.device_s is not None for s in rec.spans[1:])
    assert len(timer._events) == _Event.made and len({id(e) for e in timer._events}) == _Event.made


class _Event:
    """A stand-in for a CUDA timing event: its "device" time is the host's
    ``perf_counter_ns`` at ``record`` plus a fixed queue lag."""

    LAG_NS = 3_000_000
    made = 0
    lock = threading.Lock()

    def __init__(self):
        with self.lock:
            type(self).made += 1
        self.t = None

    pending = False

    def record(self, stream=None):
        self.t = None if self.pending else time.perf_counter_ns() + self.LAG_NS

    def elapsed_time(self, other):
        if self.t is None or other.t is None:
            raise RuntimeError("device not ready")
        return (other.t - self.t) / 1e6


def _pooled_event():
    try:
        return timer._events.pop()
    except IndexError:
        return _Event()


def test_markers_give_device_seconds_from_pooled_events(monkeypatch):
    _Event.made = 0
    monkeypatch.setattr(timer, "_event", _pooled_event)
    monkeypatch.setattr(timer, "_events", [])
    monkeypatch.setattr(timer, "_device_sync", lambda: None)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: None)
    card = torch.device("cuda")

    @timer.request("Marked")
    def run():
        with timer.timed_scope("Stage"):
            for _ in range(2):
                with timer.span("Step", device=card):
                    time.sleep(0.002)
            with timer.span("Host only"):
                pass

    run()
    rec = timer.last_request()
    steps = [s for s in rec.spans if s.name == "Step"]
    (stage,) = [s for s in rec.spans if s.name == "Stage"]
    for s in steps:
        assert s.device_s == pytest.approx(s.seconds, abs=5e-4)
    host = [s for s in rec.spans if s.name == "Host only"][0]
    assert host.device_s is None and rec.root.device_s is None and stage.device_s is None
    assert LAST_TIMINGS["Step/device_s"] == pytest.approx(sum(s.device_s for s in steps))
    assert LAST_TIMINGS["Step/n"] == 2 and "Host only/device_s" not in LAST_TIMINGS
    # 4 markers, all back in the pool; a second request reuses them
    assert _Event.made == 4 and len(timer._events) == 4
    run()
    assert _Event.made == 4 and len(timer._events) == 4

    # a marker that has not completed is left unread, and its events freed
    @timer.request("Pending")
    def pending():
        with timer.span("Step", device=card):
            monkeypatch.setattr(_Event, "pending", True)

    pending()
    (step,) = [s for s in timer.last_request().spans if s.name == "Step"]
    assert step.device_s is None
    assert "Step/device_s" not in LAST_TIMINGS and LAST_TIMINGS["Step/n"] == 1
    assert len(timer._events) == 4


def test_worker_result_carries_the_interval():
    before = time.perf_counter_ns()
    value, seconds, pid, (start_ns, end_ns) = host_worker.submit(time.sleep, 0.05).result()
    after = time.perf_counter_ns()
    assert value is None and pid != os.getpid()
    assert before <= start_ns < end_ns <= after
    assert seconds == pytest.approx((end_ns - start_ns) * 1e-9)
    assert seconds >= 0.05


def _sphere_mesh():
    from hunyuan3d2_tpu_torch.geometry.mesh import Mesh
    from hunyuan3d2_tpu_torch.volume.decoders import quads_to_tris, surface_nets_from_grid

    lin = torch.linspace(-1.01, 1.01, 17)
    r = torch.sqrt(lin[:, None, None] ** 2 + lin[None, :, None] ** 2 + lin[None, None, :] ** 2)
    v, q, nq, count, ok = surface_nets_from_grid(0.6 - r, 0.0, 1.01, capacity=1 << 14,
                                                 face_capacity=1 << 14)
    assert bool(ok)
    return Mesh(v[:int(count)].numpy(), quads_to_tris(q[:int(nq)]))


def test_unwrap_span_covers_the_paint_steps(pipe, image, tmp_path, monkeypatch):
    """The textured call's unwrap, held open by the worker until the
    denoise returns, is a span of the "Mesh to Texture" request over every
    "Paint Step" span; its key outlives a following shape request."""
    from PIL import Image

    from hunyuan3d2_tpu_torch.pipelines import multiview, texgen
    from tests import torch_overlap_cases as cases

    paint = texgen.Hunyuan3DPaintPipeline.init_random(
        size="tiny", view_size=32, render_size=64, texture_size=64, num_inference_steps=2,
        device="cpu").set_turbo()
    host_worker.submit(os.getpid).result()               # the worker is up
    monkeypatch.setattr(texgen, "mesh_uv_wrap_arrays",
                        functools.partial(cases.gated_unwrap, str(tmp_path)))
    call = multiview.Multiview_Diffusion_Net.__call__

    def denoise(self, *args, **kwargs):
        deadline = time.monotonic() + 60
        while not (tmp_path / "started").exists():
            assert time.monotonic() < deadline, "the unwrap never started"
            time.sleep(0.005)
        out = call(self, *args, **kwargs)
        (tmp_path / "denoised").touch()
        return out

    monkeypatch.setattr(multiview.Multiview_Diffusion_Net, "__call__", denoise)
    img = np.zeros((64, 64, 4), np.uint8)
    img[12:52, 20:44] = [200, 30, 30, 255]
    paint(_sphere_mesh(), Image.fromarray(img))
    rec = timer.last_request()
    assert rec.name == "Mesh to Texture"
    (unwrap,) = [s for s in rec.spans if s.name == "UV Unwrap (overlaps denoise)"]
    steps = [s for s in rec.spans if s.name == "Paint Step"]
    assert len(steps) == 2 and unwrap.parent is rec.root
    assert rec.root.start_ns <= unwrap.start_ns and unwrap.end_ns <= rec.root.end_ns
    assert all(unwrap.start_ns <= s.start_ns and s.end_ns <= unwrap.end_ns for s in steps)
    assert LAST_TIMINGS["UV Unwrap (overlaps denoise)"] == pytest.approx(unwrap.seconds)
    assert LAST_TIMINGS["Paint Step/n"] == 2
    _call(pipe, image)
    assert "Paint Step/n" not in LAST_TIMINGS
    assert LAST_TIMINGS["UV Unwrap (overlaps denoise)"] == pytest.approx(unwrap.seconds)

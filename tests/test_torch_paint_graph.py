"""The 2.5D UNet's step graphs (models/paint_unet.py ``UNet2p5D.forward``
inside ``step_graphs``) on the CPU, under the stand-in for ``torch.cuda``'s
graph calls of tests/torch_graph_standin.py. The module's ``attention`` and
``masked_attention`` are replaced by plain attention that counts its calls,
since the flash kernels run only on the card.

Held here, at a size whose top level passes the flash gate (64-wide heads,
576 tokens a view, 1152 multiview tokens) and whose second does not: one
capture a scope, then replays (the capturing call's pass too), each pass
equal to the eager body bit for bit; a new capture when a request-constant
input's address or shape changes, and none when only the sample or the
timestep does; each gated call reaching the module's attention once a pass,
and never while a graph captures; the sub-gate calls inside the pieces; the
eager body on the CPU, under grad, during a capture, on a mesh, with an
input off the card and outside the scope; a move of the module's tensors
and the scope's exit dropping the pieces; one memory pool a module across
scopes, held by its anchor; the request's replay and capture counters; the
ops' launch counters counting a replayed pass as an eager one and nothing
for the capture, a counted launch inside a piece once at every replay; and
both denoise loops opening the scope, the turbo loop's latents equal to its
eager run's."""

import contextlib
import gc
import os
import sys
import threading
import types
import weakref

import pytest
import torch

from hunyuan3d2_tpu_torch.models import paint_unet
from hunyuan3d2_tpu_torch.ops.attention import sdpa, use_flash
from hunyuan3d2_tpu_torch.ops.nn import build
from hunyuan3d2_tpu_torch.utils import cuda_graphs, timer
from tests import torch_graph_standin as standin

REPLAYS, CAPTURES = paint_unet.GRAPH_REPLAYS, paint_unet.GRAPH_CAPTURES
CFG = paint_unet.PaintUNetConfig(block_out_channels=(64, 128), layers_per_block=1,
                                 cross_attention_dim=32, attention_head_dim=64,
                                 norm_num_groups=8)
SIZE, VIEWS = 24, 2
# a pass's calls that pass the gate: self, reference, cross and multiview
# attention in the top level's three transformer blocks (one down, two up);
# the mid block's (144 tokens a view) do not
GATED = 12
GATED_MASKED = 3


class Calls:
    """The module's ``attention`` / ``masked_attention`` as plain attention,
    each call recorded: (masked, passed the gate, during a capture)."""

    def __init__(self, card):
        self.card, self.log = card, []

    def attention(self, q, k, v, scale=None):
        self.log.append((False, use_flash(q), self.card.here_capturing()))
        return sdpa(q, k, v, scale=scale)

    def masked_attention(self, q, k, v, mask, scale=None):
        self.log.append((True, use_flash(q), self.card.here_capturing()))
        return sdpa(q, k, v, scale=scale, mask=mask[:, None])

    def gated(self, masked=None):
        return sum(g for m, g, _ in self.log if masked is None or m == masked)


@pytest.fixture(autouse=True)
def _one_thread():
    # the suite's other workers share the host's cores
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card(monkeypatch):
    return standin.install(monkeypatch)


@pytest.fixture
def calls(card, monkeypatch):
    c = Calls(card)
    monkeypatch.setattr(paint_unet, "attention", c.attention)
    monkeypatch.setattr(paint_unet, "masked_attention", c.masked_attention)
    return c


def _model():
    return build(paint_unet.UNet2p5D, CFG, device="cpu", generator=torch.Generator().manual_seed(0))


def _card(x):
    return x.as_subclass(standin.OnCard)


def _masks(seed, size=SIZE):
    """Voxel-style masks for the top level's multiview tokens (gated) and
    the second level's (not): each token allowed itself and a seeded third
    of the others."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for tokens in (VIEWS * size * size, VIEWS * (size // 2) ** 2):
        m = torch.rand(1, tokens, tokens, generator=g) < 0.3
        out[tokens] = _card(m | torch.eye(tokens, dtype=torch.bool)[None])
    return out


def _request(model, seed, size=SIZE, batch=1):
    """The request-constant inputs of a turbo loop's 'r' passes, on the
    card: normal and position latents, the cameras, the reference cache and
    the voxel masks."""
    g = torch.Generator().manual_seed(seed)

    def lat(views=VIEWS):
        return _card(torch.randn(batch, views, size, size, 4, generator=g).to(torch.bfloat16))

    normal, position, ref = lat(), lat(), lat(1)
    with torch.no_grad():
        cache = model.write_cache(ref)
    cams = _card(torch.arange(VIEWS).repeat(batch, 1))
    return dict(normal_latents=normal, position_latents=position, camera_info_gen=cams,
                cache=cache, mva_masks=_masks(seed, size))


def _sample(seed, size=SIZE, batch=1):
    g = torch.Generator().manual_seed(1000 + seed)
    return _card(torch.randn(batch, VIEWS, size, size, 4, generator=g).to(torch.bfloat16))


def _eager(model, sample, t, req):
    """The eager body on the same inputs."""
    with torch.no_grad():
        return model._forward(sample, torch.tensor([float(t)]), req["normal_latents"],
                              req["position_latents"], req["camera_info_gen"], req["cache"],
                              1.0, 1.0, req["mva_masks"])


def _step(model, sample, t, req):
    with torch.no_grad():
        return model(sample, t, **req)


def _pieces(model):
    return model._steps.graph.pieces


def test_one_capture_a_scope_then_replays_each_equal_to_the_eager_body(card, calls):
    m = _model()
    req = _request(m, 0)
    with m.step_graphs():
        for i, t in enumerate((999, 759, 499)):
            x = _sample(i)
            out = _step(m, x, t, req)
            assert torch.equal(out, _eager(m, x, t, req))
            assert card.piece_captures == len(_pieces(m))
            assert card.replayed == (i + 1) * len(_pieces(m))
        # one piece a gated call, and one after the last; the capturing call
        # replayed them too
        assert len(_pieces(m)) == GATED + 1
        assert [g.replays for g, _ in _pieces(m)] == [3] * (GATED + 1)
        assert [c is None for _, c in _pieces(m)] == [False] * GATED + [True]
    # every capture ran on the one side stream, into the module's one pool
    stream = cuda_graphs._CAPTURE_STREAMS[torch.device("cpu")]
    assert {c for c in card.captures} == {(stream, "thread_local", (0, 1))}
    assert len(card.pools) == 1


def test_the_result_is_a_fresh_tensor(card, calls):
    m = _model()
    req = _request(m, 1)
    with m.step_graphs():
        first = _step(m, _sample(0), 999, req)
        kept = first.clone()
        second = _step(m, _sample(1), 759, req)
        out = m._steps.graph.output
    for r in (first, second):
        assert r.data_ptr() != out.data_ptr()
    assert torch.equal(first, kept) and not torch.equal(first, second)


@pytest.mark.parametrize("change", ["normal_address", "cache_address", "masks_address",
                                    "cameras_address", "shape", "ref_scale"])
def test_a_new_request_constant_input_captures_again(card, calls, change):
    m = _model()
    req = _request(m, 2)
    size = SIZE
    with m.step_graphs():
        _step(m, _sample(0), 999, req)
        held = m._steps.graph
        captures = len(card.captures)
        # the sample and the timestep alone change nothing
        _step(m, _sample(1), 500, req)
        assert m._steps.graph is held and len(card.captures) == captures
        if change == "normal_address":
            req["normal_latents"] = req["normal_latents"].clone()
        elif change == "cache_address":
            layer = next(iter(req["cache"]))
            req["cache"] = {**req["cache"], layer: req["cache"][layer].clone()}
        elif change == "masks_address":
            req["mva_masks"] = _masks(2)
        elif change == "cameras_address":
            req["camera_info_gen"] = req["camera_info_gen"].clone()
        elif change == "ref_scale":
            req["ref_scale"] = 0.5
        else:
            size = 16
            req = _request(m, 2, size=size)
        x = _sample(2, size=size)
        out = _step(m, x, 250, req)
        assert m._steps.graph is not held and len(card.captures) > captures
        with torch.no_grad():
            want = m._forward(x, torch.tensor([250.0]), req["normal_latents"],
                              req["position_latents"], req["camera_info_gen"], req["cache"],
                              req.get("ref_scale", 1.0), 1.0, req["mva_masks"])
        assert torch.equal(out, want)


def test_gated_calls_reach_the_module_once_a_pass_and_never_at_capture(card, calls):
    m = _model()
    with m.step_graphs():           # the shapes' first capture runs the warm-up passes
        _step(m, _sample(0), 999, _request(m, 3))
    req = _request(m, 4)
    calls.log.clear()
    with m.step_graphs():
        _step(m, _sample(1), 999, req)          # a capture, then its replay
        assert calls.gated() == GATED and calls.gated(masked=True) == GATED_MASKED
        assert not any(g and capturing for _, g, capturing in calls.log)
        # the calls under the gate ran once, inside the pieces' capture
        sub = [(masked, capturing) for masked, g, capturing in calls.log if not g]
        assert sub and all(capturing for _, capturing in sub)
        assert any(masked for masked, _ in sub)     # the second level's masked multiview
        calls.log.clear()
        _step(m, _sample(2), 759, req)          # a replay: the gated calls alone
    assert [(masked, g) for masked, g, _ in calls.log] == (
        [(masked, True) for masked, _, _ in calls.log])
    assert calls.gated() == GATED and len(calls.log) == GATED


def test_the_gated_calls_get_the_pieces_static_tensors_and_the_requests_mask(card, calls):
    m = _model()
    req = _request(m, 5)
    seen = []
    inner = calls.masked_attention

    def masked(q, k, v, mask, scale=None):
        seen.append((q, mask))
        return inner(q, k, v, mask, scale)

    paint_unet.masked_attention = masked
    with m.step_graphs():
        _step(m, _sample(0), 999, req)
        seen.clear()
        _step(m, _sample(1), 759, req)
        statics = [c[1][0] for _, c in _pieces(m) if c is not None and c[1][3] is not None]
    top = VIEWS * SIZE * SIZE
    assert [mask is req["mva_masks"][top] for _, mask in seen] == [True] * GATED_MASKED
    assert [q is s for (q, _), s in zip(seen, statics)] == [True] * GATED_MASKED


@pytest.mark.parametrize("case", ["cpu", "grad", "capturing", "mesh", "off_card",
                                  "outside_scope"])
def test_the_eager_body_runs_where_no_graph_may(card, calls, case):
    m = _model()
    req = _request(m, 6)
    x = _sample(0)
    if case == "cpu":
        x = x.as_subclass(torch.Tensor)
    if case == "mesh":
        m.parallel_mesh = object()
    if case == "off_card":
        req["camera_info_gen"] = req["camera_info_gen"].as_subclass(torch.Tensor)
    scope = contextlib.nullcontext() if case == "outside_scope" else m.step_graphs()
    grad = torch.enable_grad() if case == "grad" else torch.no_grad()
    with scope, grad:
        card.capturing = threading.get_ident() if case == "capturing" else None
        out = m(x, 999, **req)
        card.capturing = None
        assert m._steps is None or m._steps.graph is None
    assert torch.equal(out, _eager(m, x, 999, req))
    assert card.captures == [] and card.pools == []


def test_the_scopes_exit_drops_the_pieces_and_the_pool_stays(card, calls):
    m = _model()
    with m.step_graphs():
        _step(m, _sample(0), 999, _request(m, 7))
        graphs = [weakref.ref(g) for g, _ in _pieces(m)]
        outs = [weakref.ref(c[2]) for _, c in _pieces(m) if c is not None]
    assert m._steps is None
    gc.collect()
    assert all(r() is None for r in graphs + outs)
    # the pool's anchor alone stays
    assert card.live_graphs == [m._graph_pool.pool[1]]
    # the next scope captures into the same pool
    with m.step_graphs():
        _step(m, _sample(1), 999, _request(m, 8))
    assert len(card.pools) == 1 and {c[2] for c in card.captures} == {(0, 1)}


@pytest.mark.parametrize("move", ["to", "cpu", "to_empty"])
def test_moving_the_tensors_drops_the_pieces(card, calls, move):
    m = _model()
    with m.step_graphs():
        _step(m, _sample(0), 999, _request(m, 9))
        assert m._steps.graph is not None
        if move == "to":
            m.to(torch.device("cpu"))
        elif move == "cpu":
            m.cpu()
        else:
            m.to_empty(device="cpu")
        assert m._steps.graph is None and m._graph_pool.pool is None
        if move != "to_empty":       # to_empty leaves the weights uninitialised
            req = _request(m, 10)
            x = _sample(1)
            assert torch.equal(_step(m, x, 999, req), _eager(m, x, 999, req))
            # the new capture is made into a new pool
            assert [c[2] for c in card.captures][-1] == (0, 2)


def test_a_scope_inside_another_adds_nothing(card, calls):
    m, other = _model(), _model()
    with m.step_graphs():
        steps = m._steps
        with other.step_graphs():
            assert other._steps is None
        assert m._steps is steps
    assert m._steps is None


def test_threads_sharing_the_module_get_their_own_results(card, calls):
    """One thread at a time holds the step graphs; the others' loops run the
    eager body meanwhile. A scope or a graph that leaked to another thread
    would hand it another request's noise prediction."""
    m = _model()
    size, calls_each = 8, 2
    threads_n = 2 * os.cpu_count()
    reqs = [_request(m, 100 + k, size=size) for k in range(threads_n)]
    results, errors = {}, []

    def worker(k):
        try:
            with m.step_graphs():
                for i in range(calls_each):
                    x = _sample(10 * k + i, size=size)
                    results[k, i] = (_step(m, x, 999 - i, reqs[k]), x)
        except Exception as e:  # reported by the assertion below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(k,)) for k in range(threads_n)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=240)
    finally:
        sys.setswitchinterval(interval)
    assert not errors and not any(th.is_alive() for th in threads)
    assert len(results) == threads_n * calls_each and m._steps is None
    for (k, i), (out, x) in results.items():
        assert torch.equal(out, _eager(m, x, 999 - i, reqs[k]))
    assert card.replayed > 0


def test_the_request_counts_its_replays_and_captures(card, calls):
    m = _model()

    @timer.request("Mesh to Texture")
    def request(seed, steps, on_card=True):
        req = _request(m, seed)
        with m.step_graphs():
            for i in range(steps):
                x = _sample(i)
                _step(m, x if on_card else x.as_subclass(torch.Tensor), 999 - i, req)

    request(12, 3)
    assert timer.last_request().totals[REPLAYS] == 3
    assert timer.last_request().totals[CAPTURES] == 1
    assert timer.LAST_TIMINGS[REPLAYS] == 3 and timer.LAST_TIMINGS[CAPTURES] == 1
    # eager calls count nothing, and the keys leave the flat view
    request(13, 2, on_card=False)
    assert REPLAYS not in timer.last_request().totals
    assert REPLAYS not in timer.LAST_TIMINGS and CAPTURES not in timer.LAST_TIMINGS


@pytest.fixture
def counted(calls, monkeypatch):
    """The module's ``attention`` as an op with a launch counter (one launch
    a call the gate admits), in a module of the port's ops."""
    mod = types.ModuleType("hunyuan3d2_tpu_torch.ops._counted_stand_in")
    inner = calls.attention

    def attention(q, k, v, scale=None):
        attention.launches += use_flash(q)
        return inner(q, k, v, scale)

    attention.launches = 0
    mod.attention = attention
    monkeypatch.setitem(sys.modules, mod.__name__, mod)
    monkeypatch.setattr(paint_unet, "attention", attention)
    return attention


def test_the_launch_counters_count_a_replay_as_an_eager_pass(card, counted):
    m = _model()
    req = _request(m, 14)
    counted.launches = 0
    with torch.no_grad():
        m._forward(_sample(0), torch.tensor([999.0]), req["normal_latents"],
                   req["position_latents"], req["camera_info_gen"], req["cache"], 1.0, 1.0,
                   req["mva_masks"])
    per_pass = counted.launches
    assert per_pass == GATED - GATED_MASKED
    counted.launches = 0
    with m.step_graphs():
        for i in range(3):
            _step(m, _sample(i), 999 - i, req)
            # the first call's warm-ups and capture count nothing; its replay does
            assert counted.launches == (i + 1) * per_pass


def test_a_capture_that_would_hold_a_counted_launch_is_refused(card, counted):
    """The capture is not refused: a counted launch inside a piece (here the
    calls under the gate, which the pieces hold) counts once at every
    replay, as in an eager pass; the gated calls count their own as they
    run."""
    m = _model()
    req = _request(m, 15)
    inner = paint_unet.attention

    def attention(q, k, v, scale=None):
        attention.launches += 1          # counts the calls under the gate too
        return inner(q, k, v, scale)

    attention.launches = 0
    sys.modules["hunyuan3d2_tpu_torch.ops._counted_stand_in"].attention = attention
    paint_unet.attention = attention
    with torch.no_grad():
        m._forward(_sample(0), torch.tensor([999.0]), req["normal_latents"],
                   req["position_latents"], req["camera_info_gen"], req["cache"], 1.0, 1.0,
                   req["mva_masks"])
    per_pass = attention.launches
    assert per_pass > GATED - GATED_MASKED       # the gated calls and those under the gate
    attention.launches = 0
    with m.step_graphs():
        for i in range(3):
            _step(m, _sample(i), 999 - i, req)
            assert attention.launches == (i + 1) * per_pass
        held = m._steps.graph.launches
    assert held == ((attention, per_pass - (GATED - GATED_MASKED)),)
    assert card.capturing is None and card.piece_captures == GATED + 1


def test_the_cfg_batch_replays_equal_to_the_eager_body(card, calls):
    """The standard loop's 'r' pass: [uncond | cond] on the batch axis, a
    reference scale a row on the card, no masks."""
    m = _model()
    req = _request(m, 16, batch=2)
    req["mva_masks"] = None
    req["ref_scale"] = _card(torch.tensor([0.0, 1.0]))
    with m.step_graphs():
        for i in range(2):
            x = _sample(i, batch=2)
            out = _step(m, x, 999 - i, req)
            with torch.no_grad():
                want = m._forward(x, torch.tensor([999.0 - i]), req["normal_latents"],
                                  req["position_latents"], req["camera_info_gen"],
                                  req["cache"], req["ref_scale"], 1.0, None)
            assert torch.equal(out, want)
    # unmasked, the multiview calls take the dense kernel: as many pieces
    assert len({c[2] for c in card.captures}) == 1 and card.piece_captures == GATED + 1


@pytest.mark.parametrize("loop", ["turbo", "standard"])
def test_the_denoise_loops_run_inside_the_scope(card, calls, monkeypatch, loop):
    """Both loops call the UNet inside its scope, and leave it; the turbo
    loop on the card's tensors replays every step, and its latents equal
    those of the same loop without the scope (the standard loop's reference
    scale lies on the pipeline's device, the CPU here, so it runs
    eagerly)."""
    from hunyuan3d2_tpu_torch.pipelines.hunyuanpaint import HunyuanPaintPipeline

    pipe = HunyuanPaintPipeline(_model(), None, view_size=2 * SIZE, device="cpu")
    monkeypatch.setattr(pipe, "_decode_views", lambda latents: latents)
    forward, scoped = pipe.unet.forward, []

    def watched(*args, **kwargs):
        scoped.append(pipe.unet._steps is not None)
        return forward(*args, **kwargs)

    monkeypatch.setattr(pipe.unet, "forward", watched)
    g = torch.Generator().manual_seed(17)
    ref = torch.randn(1, 1, SIZE, SIZE, 4, generator=g).to(torch.bfloat16)
    normal = torch.randn(1, VIEWS, SIZE, SIZE, 4, generator=g).to(torch.bfloat16)
    position = torch.randn(1, VIEWS, SIZE, SIZE, 4, generator=g).to(torch.bfloat16)
    cams = torch.arange(VIEWS)[None]
    init = torch.randn(1, VIEWS, SIZE, SIZE, 4, generator=g)
    noises = torch.randn(3, 1, VIEWS, SIZE, SIZE, 4, generator=g)
    # a position map whose voxel grids give the top level's and the second
    # level's multiview tokens
    pos_u8 = torch.randint(0, 255, (1, VIEWS, 2 * SIZE, 2 * SIZE, 3), generator=g,
                           dtype=torch.uint8)
    pos_u8[:, :, :, :SIZE] = 255

    def run(f):
        if loop == "turbo":
            pipe.set_turbo()
            ts, ac = pipe.scheduler.make_tables(3)
            return pipe.denoise_lcm(f(ref), f(normal), f(position), f(cams), ts, ac, f(pos_u8),
                                    (SIZE, SIZE // 2), f(init), [f(n) for n in noises])
        pipe.set_turbo(False)
        ts, sigmas = pipe.scheduler.make_tables(3)
        return pipe.denoise(f(ref), f(normal), f(position), f(cams),
                            f(torch.zeros(1, 1, dtype=torch.long)), ts, sigmas, 2.0, f(init),
                            [f(n) for n in noises])

    graphed = run(_card)
    assert scoped == [True] * 3 and pipe.unet._steps is None
    if loop == "turbo":
        assert card.piece_captures == GATED + 1 and card.replayed == 3 * (GATED + 1)
    else:
        assert card.captures == []
    monkeypatch.setattr(pipe.unet, "step_graphs", contextlib.nullcontext)
    assert torch.equal(graphed, run(_card))
    assert card.piece_captures == (GATED + 1 if loop == "turbo" else 0)

"""The DiT forward's CUDA graph cache (models/dit.py ``Hunyuan3DDiT.forward``)
on the CPU, under the stand-in for ``torch.cuda``'s graph calls of
tests/torch_graph_standin.py.

Held here: one capture a key, then replays only; the inputs copied into the
static buffers at every call; a fresh tensor returned; the eager body on
the CPU, under grad, during a capture, on a sharded module and on one the
pipeline moves at every call (``enable_model_cpu_offload``); the cache
dropped when the module's tensors move (``.to()``, the pipeline's offload
and restore, an assigning ``load_state_dict``) and kept by an in-place
load; at most ``GRAPHS`` graphs, all in one memory pool a module; threads
kept apart by the lock; the request's replay counter equal to the
replays; and the ops' launch counters counting a replayed forward's
kernels as an eager one's, and nothing for the capture."""

import dataclasses
import os
import sys
import threading
import types

import pytest
import torch

from hunyuan3d2_tpu_torch.models import dit
from hunyuan3d2_tpu_torch.ops.nn import build
from hunyuan3d2_tpu_torch.utils import cuda_graphs, timer
from tests import torch_graph_standin as standin

REPLAYS = "DiT/graph_replays"
LATENTS, COND = 16, 8


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


def _model(guidance_embed=True):
    cfg = dataclasses.replace(dit.TINY, guidance_embed=guidance_embed)
    return build(dit.Hunyuan3DDiT, cfg, device="cpu", generator=torch.Generator().manual_seed(0))


def _inputs(seed, latents=LATENTS, cond=COND, batch=1, guidance=True, on_card=True):
    g = torch.Generator().manual_seed(seed)
    args = (torch.randn(batch, latents, 64, generator=g).to(torch.bfloat16),
            torch.rand(batch, generator=g),
            torch.randn(batch, cond, 1536, generator=g).to(torch.bfloat16),
            torch.full((batch,), 5.0) if guidance else None)
    if on_card:
        args = tuple(None if a is None else a.as_subclass(standin.OnCard) for a in args)
    return args


def _entry(model):
    (entry,) = model._graphs.values()
    return entry


@pytest.mark.parametrize("guidance_embed", [True, False])
def test_one_capture_a_key_then_replays(card, guidance_embed):
    m = _model(guidance_embed)
    with torch.no_grad():
        for i in range(3):
            args = _inputs(i, guidance=guidance_embed)
            out = m(*args)
            assert torch.equal(out, m._forward(*args))
            assert card.piece_captures == 1 and card.replayed == i + 1
        # a new key (another latent count) is one more capture
        args = _inputs(7, latents=2 * LATENTS, guidance=guidance_embed)
        assert torch.equal(m(*args), m._forward(*args))
    assert card.piece_captures == len(m._graphs) == 2
    # each graph one piece (the body has no cut), replayed at each of its calls
    assert [[g.replays for g, _ in e.pieces] for e in m._graphs.values()] == [[3], [1]]
    # every capture ran on the one side stream, keeping other threads' work
    # out, into the module's one pool (its anchor's capture first)
    stream = cuda_graphs._CAPTURE_STREAMS[torch.device("cpu")]
    assert card.captures == [(stream, "thread_local", (0, 1))] * 3 and len(card.pools) == 1


def test_inputs_go_into_the_static_buffers_at_every_call(card):
    m = _model()
    with torch.no_grad():
        for i in range(3):
            args = _inputs(10 + i)
            m(*args)
            entry = _entry(m)
            for static, a in zip(entry.args, args):
                assert static is not a and static.data_ptr() != a.data_ptr()
                assert torch.equal(static, a)


def test_the_result_is_a_fresh_tensor(card):
    m = _model()
    with torch.no_grad():
        first = m(*_inputs(1))
        kept = first.clone()
        second = m(*_inputs(2))
    out = _entry(m).output
    for r in (first, second):
        assert r is not out and r.data_ptr() != out.data_ptr()
    # the next replay leaves an earlier result as it was
    assert torch.equal(first, kept) and not torch.equal(first, second)


@pytest.mark.parametrize("case", ["cpu", "grad", "capturing", "sharded", "moved_each_call"])
def test_the_eager_body_runs_where_no_graph_may(card, case):
    m = _model()
    args = _inputs(3, on_card=case != "cpu")
    if case == "sharded":
        m.parallel_mesh = object()
    if case == "moved_each_call":
        m.moved_each_call = True
    grad = torch.enable_grad() if case == "grad" else torch.no_grad()
    with grad:
        card.capturing = threading.get_ident() if case == "capturing" else None
        out = m(*args)
        card.capturing = None
        want = m._forward(*args)
    assert torch.equal(out, want)
    assert card.graphs == [] and card.captures == [] and card.pools == [] and not m._graphs


@pytest.mark.parametrize("move", ["to", "cpu", "to_empty", "assign_load"])
def test_moving_the_tensors_drops_the_graphs(card, move):
    m = _model()
    with torch.no_grad():
        m(*_inputs(1))
    assert len(m._graphs) == 1
    if move == "to":
        m.to(torch.device("cpu"))
    elif move == "cpu":
        m.cpu()
    elif move == "to_empty":
        m.to_empty(device="cpu")
    else:
        m.load_state_dict({k: v.clone() for k, v in m.state_dict().items()}, assign=True)
    assert not m._graphs and m._graph_pool.pool is None
    with torch.no_grad():
        args = _inputs(2)
        # to_empty leaves the weights uninitialised: NaN where the eager body has NaN
        torch.testing.assert_close(m(*args), m._forward(*args), rtol=0, atol=0, equal_nan=True)
    # the new graph is captured into a new pool (each pool's anchor first)
    assert [c[2] for c in card.captures] == [(0, 1)] * 2 + [(0, 2)] * 2


def test_an_in_place_load_keeps_the_graph_and_it_reads_the_new_weights(card):
    m, other = _model(), _model()
    with torch.no_grad():
        for p in other.parameters():
            p.mul_(0.5)
        args = _inputs(4)
        m(*args)
        entry = _entry(m)
        m.load_state_dict(other.state_dict())
        assert _entry(m) is entry
        out = m(*args)
    assert torch.equal(out, other._forward(*args))
    assert card.piece_captures == 1


def test_the_pipelines_offload_and_restore_drop_the_graphs(card):
    from hunyuan3d2_tpu_torch.pipelines.shapegen import Hunyuan3DDiTFlowMatchingPipeline

    pipe = Hunyuan3DDiTFlowMatchingPipeline.init_random(size="tiny", dino="tiny", device="cpu")
    m = pipe.model
    guided = m.cfg.guidance_embed
    with torch.no_grad():
        m(*_inputs(1, guidance=guided))
        assert len(m._graphs) == 1
        pipe.offload_to_host()
        assert not m._graphs
        m(*_inputs(2, guidance=guided))
        assert len(m._graphs) == 1
        pipe.restore_to_device()
        assert not m._graphs
    assert card.piece_captures == 2


def test_a_pipeline_that_offloads_every_call_runs_the_eager_body(card):
    from hunyuan3d2_tpu_torch.pipelines.shapegen import Hunyuan3DDiTFlowMatchingPipeline

    pipe = Hunyuan3DDiTFlowMatchingPipeline.init_random(size="tiny", dino="tiny", device="cpu")
    m = pipe.model
    args = _inputs(1, guidance=m.cfg.guidance_embed)
    with torch.no_grad():
        m(*args)
        assert len(m._graphs) == 1
        pipe.enable_model_cpu_offload()
        out = m(*args)
        assert torch.equal(out, m._forward(*args))
    assert m.moved_each_call and card.piece_captures == 1 and card.replayed == 1


def test_at_most_graphs_kept_the_least_recently_used_dropped(card):
    m = _model()
    sizes = [LATENTS + 8 * i for i in range(dit.GRAPHS + 1)]
    with torch.no_grad():
        for n in sizes[:dit.GRAPHS]:
            m(*_inputs(n, latents=n))
        m(*_inputs(0, latents=sizes[0]))          # the first key is used again
        m(*_inputs(1, latents=sizes[-1]))         # one key too many: the second goes
    kept = [key[0][0][1] for key in m._graphs]
    assert kept == sizes[2:dit.GRAPHS] + [sizes[0], sizes[-1]]
    assert card.piece_captures == dit.GRAPHS + 1
    assert {c[2] for c in card.captures} == {(0, 1)}


def test_threads_sharing_the_module_get_their_own_results(card):
    m = _model()
    threads_n, calls = 2 * os.cpu_count(), 3
    results, errors = {}, []

    def worker(k):
        try:
            with torch.no_grad():
                for i in range(calls):
                    args = _inputs(100 * k + i)
                    results[k, i] = (m(*args), args)
        except Exception as e:  # reported by the assertion below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(k,)) for k in range(threads_n)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not errors and not any(th.is_alive() for th in threads)
    assert len(results) == threads_n * calls
    # a copy or a replay of another thread inside one's section would hand
    # it another input's velocity
    with torch.no_grad():
        for out, args in results.values():
            assert torch.equal(out, m._forward(*args))
    assert card.piece_captures == 1 and card.replayed == threads_n * calls


def test_the_request_counts_its_replays(card):
    m = _model()

    @timer.request("Image to Mesh")
    def request(calls):
        with torch.no_grad():
            for args in calls:
                m(*args)

    request([_inputs(i) for i in range(5)])
    assert timer.last_request().totals[REPLAYS] == card.replayed == 5
    assert timer.LAST_TIMINGS[REPLAYS] == 5
    # eager calls count nothing, and the key leaves the flat view
    request([_inputs(i, on_card=False) for i in range(2)])
    assert REPLAYS not in timer.last_request().totals
    assert REPLAYS not in timer.LAST_TIMINGS
    assert card.replayed == 5


@pytest.fixture
def counted_op(monkeypatch):
    """The DiT's ``layer_norm`` as an op with a launch counter, in a module
    of the port's ops."""
    mod = types.ModuleType("hunyuan3d2_tpu_torch.ops._counted_stand_in")
    inner = dit.layer_norm

    def layer_norm(*args, **kwargs):
        layer_norm.launches += 1
        return inner(*args, **kwargs)

    layer_norm.launches = 0
    mod.layer_norm = layer_norm
    monkeypatch.setitem(sys.modules, mod.__name__, mod)
    monkeypatch.setattr(dit, "layer_norm", layer_norm)
    return layer_norm


@pytest.mark.parametrize("calls", [1, 3])
def test_the_launch_counters_count_a_replay_as_an_eager_call(card, counted_op, calls):
    m = _model()
    with torch.no_grad():
        m._forward(*_inputs(0))
        per_forward = counted_op.launches
        assert per_forward > 0
        counted_op.launches = 0
        for i in range(calls):
            m(*_inputs(i))
            # the first call's warm-up and capture count nothing; its replay does
            assert counted_op.launches == (i + 1) * per_forward
    assert card.replayed == calls and card.piece_captures == 1
    assert _entry(m).launches == ((counted_op, per_forward),)

"""utils/cuda_graphs.py's capture and replay on their own, under the
stand-in for ``torch.cuda``'s graph calls of tests/torch_graph_standin.py:
a body is cut into one piece more than its ``cut`` calls (one piece with
none, as the DiT's forward), each cut call runs eagerly between the pieces
at every replay and never at capture, a replay equals the eager body on
the new inputs, and the first-use passes run once per key shape."""

import pytest
import torch

from hunyuan3d2_tpu_torch.utils import cuda_graphs
from tests import torch_graph_standin as standin


@pytest.mark.parametrize("cuts", [0, 2])
def test_a_body_is_one_piece_more_than_its_cuts(monkeypatch, cuts):
    card = standin.install(monkeypatch)
    ran = []            # for each call of the cut function: whether this thread captured

    def between(y):
        ran.append(card.here_capturing())
        return y * 2

    def body(x):
        y = x + 1
        for _ in range(cuts):
            y = (cuda_graphs.cut(between, y, like=y) if cuda_graphs.capturing()
                 else between(y)) + 1
        return y * 3

    x = torch.arange(8.0).as_subclass(standin.OnCard)
    pool = cuda_graphs.GraphPool()
    graph = pool.capture(body, (x,), (x[:2],), "key")
    # the eager pass and the short one ran the cut function; the capture did not
    assert ran == [False] * 2 * cuts
    assert len(graph.pieces) == cuts + 1 and card.piece_captures == cuts + 1
    assert [call is None for _, call in graph.pieces] == [False] * cuts + [True]
    for seed in range(2):
        x.copy_(torch.randn(8, generator=torch.Generator().manual_seed(seed)))
        assert torch.equal(graph.replay(), body(x.as_subclass(torch.Tensor)))
    assert card.replayed == 2 * (cuts + 1)
    # a second capture of the key's shapes runs no first-use pass
    ran.clear()
    pool.capture(body, (x,), (x[:2],), "key")
    assert ran == [] and len(card.pools) == 1

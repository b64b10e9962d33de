"""Collective diagnostics (port of hunyuan3d2_tpu/parallel/diagnostics.py).

The JAX package tallies the collectives of a compiled program's optimized
HLO; the port places its collectives itself and tallies each call
(parallel/collectives.py), or reads them back from a ``torch.profiler``
trace (utils/profiling.py ``trace``), whose events are named ``nccl:*`` or
``gloo:*``. Either gives {op: (count, bytes)} under the HLO names
(all-reduce, all-gather, collective-permute, collective-broadcast), and
:func:`assert_no_full_param_gather` holds the tally to the same efficiency
bound:
tensor-parallel weights stay sharded (activations move, weights don't), so a
broken rule that re-gathers the parameters shows up as all-gather bytes at
the parameter footprint.

The tally's bytes are each collective's result footprint (for an all-gather
the gathered size, the quantity the bound cares about). A trace's events
carry no sizes (``utils/profiling.trace`` records no shapes, and an input's
size is not the result's), so a trace gives counts only, its bytes None, and
the bound refuses it.
"""

from __future__ import annotations

import json
from typing import Dict, Optional, Tuple

from hunyuan3d2_tpu_torch.parallel.collectives import TALLY

_TRACE_OPS = {"all_reduce": "all-reduce", "allreduce": "all-reduce",
              "all_gather": "all-gather", "allgather": "all-gather",
              "_allgather_base": "all-gather", "all_gather_into_tensor": "all-gather",
              "send": "collective-permute", "broadcast": "collective-broadcast",
              "reduce_scatter": "reduce-scatter", "all_to_all": "all-to-all"}


def collective_stats(trace_path: Optional[str] = None) -> Dict[str, Tuple[int, Optional[int]]]:
    """{collective: (count, summed result bytes)}: this process's tally
    since the last :func:`reset_collective_stats`; or, from the
    ``nccl:*``/``gloo:*`` events of the trace file ``trace_path``,
    {collective: (count, None)}."""
    if trace_path is None:
        return {op: (cnt, byt) for op, (cnt, byt) in TALLY.items()}
    with open(trace_path) as fh:
        events = json.load(fh).get("traceEvents", [])
    counts: Dict[str, int] = {}
    for e in events:
        backend, _, name = e.get("name", "").partition(":")
        if backend in ("nccl", "gloo") and name in _TRACE_OPS:
            counts[_TRACE_OPS[name]] = counts.get(_TRACE_OPS[name], 0) + 1
    return {op: (cnt, None) for op, cnt in counts.items()}


def reset_collective_stats() -> None:
    TALLY.clear()


def format_stats(stats: Dict[str, Tuple[int, int]]) -> str:
    if not stats:
        return "no collectives"
    return ", ".join(f"{op} n={cnt}" + ("" if byt is None else f" {byt / 1e6:.2f}MB")
                     for op, (cnt, byt) in sorted(stats.items()))


def assert_no_full_param_gather(stats, param_bytes: int, tag: str,
                                frac: float = 0.75) -> None:
    """Efficiency bound: the all-gather volume must stay well below the full
    parameter footprint. A broken sharding rule that re-gathers the weights
    shows up as all-gather bytes ≥ param bytes. ``stats`` is the tally's
    (a trace's counts carry no bytes, and are refused)."""
    cnt, byt = stats.get("all-gather", (0, 0))
    if byt is None:
        raise ValueError(f"{tag}: these stats carry no bytes (a trace's); hold the bound "
                         "to collective_stats() of the tally")
    if byt >= frac * param_bytes:
        raise AssertionError(
            f"{tag}: all-gather volume {byt / 1e6:.1f}MB ≥ {frac:.0%} of the "
            f"param footprint {param_bytes / 1e6:.1f}MB — params are being "
            f"re-gathered ({cnt} calls)")

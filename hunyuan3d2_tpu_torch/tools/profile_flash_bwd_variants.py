"""Tile sweep of kernel 1's bf16 backward on the card.

    python -m hunyuan3d2_tpu_torch.tools.profile_flash_bwd_variants [--shape B H Lq Lk D] [--iters N]

Times each tile of the backward's two passes that csrc/flash_bwd_variants.cu
compiles, and the port's own launch (``ops.flash_attention._launch_backward``,
csrc/flash_attention_bwd.cu, whose tiles are each pass's fastest here), at
the DiT training row [2,16,1882,1882,64] and at [1,8,4096,4096,128] unless
``--shape`` names one. Each variant's gradients are held against
``flash_attention_backward_plain`` on the same o and lse. The two passes are
timed apart (:func:`pass_times`), so the two tile lists are paired in order
and every tile of each pass runs at least once. Prints one JSON line per row.
Needs a CUDA device.

The TPU kernel had no backward, so this sweep has no Pallas counterpart; it
is the backward's side of ``tools/profile_flash_variants.py``.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
import os
import re
import statistics
from typing import Callable, Optional

import torch

from hunyuan3d2_tpu_torch.ops import flash_attention as fa

# (keys a CTA, q rows a step, stages) of the dK/dV pass and (q rows a CTA,
# keys a step, stages) of the dQ pass, per head size, as compiled in
# csrc/flash_bwd_variants.cu
KV_VARIANTS = {64: ((64, 64, 2), (64, 64, 3), (128, 64, 2), (128, 64, 3), (128, 128, 2)),
               128: ((64, 64, 2), (128, 64, 2))}
Q_VARIANTS = {64: ((64, 128, 2), (128, 64, 2), (128, 128, 2), (128, 128, 3), (128, 128, 4)),
              128: ((64, 64, 2), (128, 64, 2), (128, 64, 3), (128, 64, 4))}
SHAPES = ((2, 16, 1882, 1882, 64), (1, 8, 4096, 4096, 128))
_KERNEL = re.compile(r"(?:fbwd|flash)::(prep|split|dkdv|reduce|dq)_\w*kernel")


@functools.lru_cache(maxsize=None)
def _lib():
    from hunyuan3d2_tpu_torch.utils import cuda_build

    fn = cuda_build.load("flash_bwd_variants").hy3d_flash_bwd_variant
    fn.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 5 + [ctypes.c_float]
                   + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def flash_attention_backward_variant(q, k, v, o, lse, dout, scale: float, kv: tuple, qt: tuple):
    """Kernel 1's bf16 gradient (as :func:`fa.flash_attention_backward`)
    with the dK/dV pass at tile ``kv`` and the dQ pass at tile ``qt``, each
    a compiled variant of its head size. A CPU tensor gets the plain twin."""
    d = q.shape[-1]
    if tuple(kv) not in KV_VARIANTS.get(d, ()) or tuple(qt) not in Q_VARIANTS.get(d, ()):
        raise ValueError(f"backward variant {kv}, {qt} is not compiled for D = {d}")
    fa._check(q, k, v)
    fa._check_backward(q, o, lse, dout)
    fa.refuse_grad("flash_attention_backward_variant", q, k, v, o, dout)
    if not q.is_cuda:
        return fa.flash_attention_backward_plain(q, k, v, o, lse, dout, scale)
    if q.dtype != torch.bfloat16:
        raise TypeError(f"the backward variants take bf16, got {q.dtype}")
    b, h, lq, _ = q.shape
    lk, n = k.shape[2], b * h
    # resident CTAs an SM: two of one consumer warpgroup (64 keys), one of two
    splits = fa.bwd_splits(n, lq, lk, kv[0], kv[1], 2 if kv[0] == 64 else 1)
    pad = max(kv[1], qt[0])
    lq_pad = -(-lq // pad) * pad
    qs = torch.empty_like(q)
    stats = torch.empty(2, n, lq_pad, dtype=torch.float32, device=q.device)
    part = (torch.empty(2, splits, n, lk, d, dtype=torch.float32, device=q.device)
            if splits > 1 else None)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), dout.data_ptr(),
                 lse.data_ptr(), qs.data_ptr(), stats[0].data_ptr(), stats[1].data_ptr(),
                 None if part is None else part.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                 dv.data_ptr(), n, lq, lk, lq_pad, d, float(scale), *kv, *qt, splits,
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash backward variant launch failed: cudaError {err}")
    flash_attention_backward_variant.launches += 1
    return dq, dk, dv


flash_attention_backward_variant.launches = 0


def _time_ms(fn: Callable[[], object], iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def pass_times(call: Callable[[], object], work: float, iters: int = 10) -> dict:
    """Device ms a call of the backward's pre-pass (fp32: with its four
    operand splits), dK/dV pass (with its ordered reduction where the q
    range is split) and dQ pass: the median of each kernel's launches in a
    ``utils.profiling`` trace of ``iters`` calls (a long process's trace can
    drop launches, and ``key_averages`` then misreads their totals; the
    splits, four launches a call of other sizes, by their total over
    ``iters``), with each pass's TFLOP/s of its own operations (dK/dV
    8·``work``, dQ 6·``work``; ``work`` = B·H·Lq·Lk·D)."""
    from hunyuan3d2_tpu_torch.utils import profiling

    call()
    with profiling.trace() as tr:
        for _ in range(iters):
            call()
    with open(tr.path) as fh:
        events = json.load(fh).get("traceEvents", [])
    os.remove(tr.path)
    durs = {}
    for e in events:
        m = _KERNEL.search(e.get("name", ""))
        if e.get("ph") == "X" and e.get("cat") == "kernel" and m:
            durs.setdefault(m.group(1), []).append(e["dur"] / 1e3)
    by = {k: statistics.median(v) for k, v in durs.items()}
    kv_ms = by.get("dkdv", 0) + by.get("reduce", 0)
    q_ms = by.get("dq", 0)
    prep_ms = by.get("prep")
    if prep_ms is not None and "split" in durs:
        prep_ms += sum(durs["split"]) / iters
    return dict(prep_ms=prep_ms, dkdv_ms=kv_ms or None, dq_ms=q_ms or None,
                dkdv_tflops=8 * work / kv_ms / 1e9 if kv_ms else None,
                dq_tflops=6 * work / q_ms / 1e9 if q_ms else None,
                traced_launches={k: len(v) for k, v in durs.items()})


def sweep(shape=SHAPES[0], iters: int = 20, seed: int = 0,
          check: Optional[Callable] = None) -> dict:
    """Every paired variant and the port's launch at ``shape`` (B, H, Lq,
    Lk, D; bf16) on the card: each row holds its tiles, the whole call's ms
    (CUDA events, ``iters`` calls), :func:`pass_times` and its max abs error
    against the plain twin. ``check(name, got, ref)`` may hold each of dq,
    dk, dv to a rule (and raise); it returns the max abs error. Returns
    {"shape", "rows", "default"}."""
    if not torch.cuda.is_available():
        raise RuntimeError("the flash backward sweep runs on a CUDA device")
    b, h, lq, lk, d = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, dout = (torch.randn(b, h, n, d, generator=gen, device="cuda").to(torch.bfloat16)
                     for n in (lq, lk, lk, lq))
    scale = d ** -0.5
    o, lse = fa._launch_lse(q, k, v, scale)
    twin = fa.flash_attention_backward_plain(q, k, v, o, lse, dout, scale)
    work = 1.0 * b * h * lq * lk * d

    def row(name, call, **tiles):
        got = call()
        torch.cuda.synchronize()
        errs = [check(f"{name} {g}", x, r) if check else (x.float() - r.float()).abs().max().item()
                for g, x, r in zip(("dq", "dk", "dv"), got, twin)]
        del got
        return dict(name=name, **tiles, call_ms=_time_ms(call, iters),
                    **pass_times(call, work), max_abs_err=max(errs))

    kvs, qts = KV_VARIANTS[d], Q_VARIANTS[d]
    rows = []
    for i in range(max(len(kvs), len(qts))):
        kv, qt = kvs[i % len(kvs)], qts[i % len(qts)]
        rows.append(row(f"kv={kv} q={qt}", functools.partial(
            flash_attention_backward_variant, q, k, v, o, lse, dout, scale, kv, qt),
            kv_tile=list(kv), q_tile=list(qt)))
    default = row("default", functools.partial(fa._launch_backward, q, k, v, o, lse, dout, scale))
    return dict(shape=list(shape), rows=rows, default=default)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shape", type=int, nargs=5, default=None,
                    metavar=("B", "H", "LQ", "LK", "D"))
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    for shape in [tuple(args.shape)] if args.shape else SHAPES:
        res = sweep(shape, args.iters)
        for r in res["rows"] + [res["default"]]:
            print(json.dumps(dict(shape=res["shape"], **r)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

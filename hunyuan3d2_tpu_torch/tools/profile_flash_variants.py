"""Tile-configuration sweep of the bf16 flash-attention kernel on the card.

    python -m hunyuan3d2_tpu_torch.tools.profile_flash_variants [--shape B H L D] [--iters N]

The counterpart of scripts/profile_flash_variants.py, whose Pallas kernel
(``flash_v`` → ``make_kernel``, the pallas_call at :72) is an A/B sweep of
the TPU flash kernel's block sizes at the paint UNet's multiview shape
(5, 24576, 64) bf16; the JAX package's default blocks came out of it. Its
variants map to the Hopper kernel (csrc/flash_variants.cu) as follows:

- block sizes (bq, bk) → the compiled tile configurations ``VARIANTS``:
  (q rows, keys, stages of the TMA K/V ring) per CTA;
- fold-scale: always on, as ``flash_v`` asserts; the kernel scales its q
  tile in place;
- elided column mask: the kernel masks padded key columns only on a ragged
  last key tile, so where lk % BK == 0 the mask never runs;
- ``dimension_semantics``: no counterpart, every CUDA grid dimension runs
  in parallel.

``sweep`` times every variant, the product kernel at its default
configuration (``ops.flash_attention.default_config``, chosen from this
sweep's result) and ``scaled_dot_product_attention`` as the yardstick (the
port never calls it) with CUDA events, and holds each variant against the
plain twin. Prints one JSON line per row. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
from typing import Callable, Optional

import torch

from hunyuan3d2_tpu_torch.ops.flash_attention import (
    _check,
    default_config,
    flash_attention,
    flash_attention_plain,
    refuse_grad,
)

# (q rows, keys, stages) per CTA, as compiled in csrc/flash_variants.cu
VARIANTS = ((64, 128, 2), (64, 128, 3), (128, 64, 3), (128, 128, 2), (128, 128, 3))
PEAK_BF16 = 989e12       # H100 SXM, dense bf16 tensor cores
HBM_BYTES_PER_S = 3.35e12


@functools.lru_cache(maxsize=None)
def _lib():
    from hunyuan3d2_tpu_torch.utils import cuda_build

    fn = cuda_build.load("flash_variants").hy3d_flash_variant
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_float]
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def flash_attention_variant(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                            bq: int, bk: int, stages: int) -> torch.Tensor:
    """Kernel 1's function (scale folded into q) at one compiled tile
    configuration; q [B, H, Lq, D], k/v [B, H, Lk, D] bf16 on the card. A
    CPU tensor gets the plain twin."""
    if (bq, bk, stages) not in VARIANTS:
        raise ValueError(f"flash variant (bq={bq}, bk={bk}, stages={stages}) is not compiled; "
                         f"compiled: {VARIANTS}")
    _check(q, k, v)
    refuse_grad("flash_attention_variant", q, k, v)
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, scale)
    if q.dtype != torch.bfloat16:
        raise TypeError(f"the flash variants take bf16, got {q.dtype}")
    b, h, lq, d = q.shape
    out = torch.empty_like(q)
    err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b * h, lq,
                 k.shape[2], d, float(scale), bq, bk, stages,
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash variant kernel launch failed: cudaError {err}")
    flash_attention_variant.launches += 1
    return out


flash_attention_variant.launches = 0


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


def sweep(shape=(1, 5, 24576, 64), iters: int = 20, seed: int = 0,
          check: Optional[Callable] = None) -> dict:
    """Time every variant, the default kernel and SDPA at ``shape`` (B, H,
    L, D; self-attention, bf16) on the card. ``check(name, out, ref)``
    returns the max abs error of a variant's output against the plain twin
    (and raises where it is out of tolerance); without it the max abs error
    is taken as it is. Returns {"shape", "rows", "default", "plain_ms",
    "sdpa_ms", "best"}; each row holds ms, TFLOP/s, bound_ms and
    max_abs_err."""
    if not torch.cuda.is_available():
        raise RuntimeError("the flash sweep runs on a CUDA device")
    import torch.nn.functional as F

    b, h, l, d = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(b, h, l, d, generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    scale = d ** -0.5

    def plain():  # row chunks of 4096 queries keep the fp32 scores in memory
        return torch.cat([flash_attention_plain(q[:, :, i:i + 4096], k, v, scale)
                          for i in range(0, l, 4096)], dim=2)

    ref = plain()
    flops = 4.0 * b * h * l * l * d
    bound_ms = max(flops / PEAK_BF16, 4 * q.numel() * 2 / HBM_BYTES_PER_S) * 1e3

    def row(name, cfg, fn):
        out = fn()
        torch.cuda.synchronize()
        err = check(name, out, ref) if check else (out.float() - ref.float()).abs().max().item()
        ms = _time_ms(fn, iters)
        return dict(name=name, bq=cfg[0], bk=cfg[1], stages=cfg[2], ms=ms,
                    tflops=flops / ms * 1e-9, bound_ms=bound_ms, max_abs_err=err)

    rows = [row(f"bq={bq} bk={bk} stages={st}", (bq, bk, st),
                lambda bq=bq, bk=bk, st=st: flash_attention_variant(q, k, v, scale, bq, bk, st))
            for bq, bk, st in VARIANTS]
    cfg = default_config(b, h, l, l, d, torch.bfloat16)
    default = row(f"default {cfg}", cfg, lambda: flash_attention(q, k, v, scale))
    plain_ms = _time_ms(plain, 2)
    sdpa_ms = _time_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=scale), iters)
    best = min(rows, key=lambda r: r["ms"])
    return dict(shape=[b, h, l, d], rows=rows, default=default, plain_ms=plain_ms,
                sdpa_ms=sdpa_ms, best=best)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shape", type=int, nargs=4, default=(1, 5, 24576, 64),
                    metavar=("B", "H", "L", "D"))
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    res = sweep(tuple(args.shape), args.iters)
    for r in res["rows"] + [res["default"]]:
        print(json.dumps(r), flush=True)
    print(json.dumps(dict(shape=res["shape"], plain_ms=res["plain_ms"], sdpa_ms=res["sdpa_ms"],
                          best=res["best"]["name"])), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""The flash kernels' fp32 paths (kernel 1, and kernel 2 under its mask)
against an fp64 evaluation of their function, with the error bound that
their arithmetic allows.

    python -m hunyuan3d2_tpu_torch.tools.flash_fp32_error [--seeds 8]

The function (ops/flash_attention.py): q̂ = fp32(q · scale), s = q̂ kᵀ,
p = exp(s - max s), o = (p v) / Σ p. :func:`attention_fp64` evaluates it in
fp64 from the fp32 q̂, k, v. :func:`fp32_error_bound` bounds, per output
element, how far an fp32 evaluation by the kernel's algorithm may lie from
it. With u = 2^-24 (fp32 unit roundoff):

* A 3xTF32 product (x = big + small, big rounded to nearest TF32, small =
  x - big exact in fp32, which the tensor cores truncate to TF32 when they
  read it; the small·small term dropped) errs by at most ε_split = 5·2^-22
  of |x y|: |small| ≤ 2^-11 |x|, its truncation loses < 2^-10 of it
  (2^-21 |x|), so big·small and small·big each err by 2^-21 (1 + 2^-11)
  |x y| and the dropped term is ≤ 2^-22 |x y|. TF32 products are exact in
  fp32. The masked kernel splits so too, from the same pre-pass (its
  mma.sync design rounded small to nearest TF32, 3·2^-22).
* Each ``wgmma`` k step adds 8 products
  to its accumulator. Tensor cores may align the terms to the largest and
  truncate, so each such step is allowed two ulps (4u) of the sum of the
  magnitudes it has taken in; a chain of n steps on one accumulator errs
  by at most 4u·n·Σ|terms|. 3xTF32 takes three steps per 8 products.
* Logits, over D: |δs_ij| ≤ ε_s · Σ_d |q̂_id k_jd|, with
  ε_s = ε_split + 4u (3 D/8 + 1).
* p_j = exp(s_j - m): the argument rounds once (u |s_j - m|) and expf errs
  by at most 2 ulps (4u). A common factor of all p cancels in o, so each
  p_j carries a relative error η ≤ ε_s max_j Σ_d |q̂ k_j| + u R + 4u with
  R = m - min_j s_j, and o moves by at most η Σ_j p_j |v_j - o| / l
  ≤ η (T + |o|), T = Σ_j p_j |v_j| / l.
* P·V, over Lk in tiles of 64 keys: each tile is summed in fresh
  accumulators (24 steps, 4u·24 of the tile's Σ p|v|) and added to the
  running sum by one round-to-nearest FMA, acc·exp(m_old - m_new) + tile
  (u of the running Σ p|v|): ε_pv = ε_split + 96u + u⌈Lk/64⌉, times T.
  The rescale factor's own error multiplies acc and l alike and cancels.
  (Summed on the tensor cores across all tiles, the chain would need
  4u·24⌈Lk/64⌉, 30x more at Lk = 3072, and its error grows so with Lk.)
* l, per thread 16 sums, one rescale and one add a tile, then two
  shuffle adds; the final division, a reciprocal refined by Newton's step
  and one corrected quotient (within 1 ulp, 2u): (u (18 ⌈Lk/64⌉ + 3) + 2u)
  |o|. The masked kernel divides so too (its mma.sync design divided in
  IEEE, u).
* Under a [B, Lq, Lk] mask (the masked kernel, kernel 2): masked logits
  get no weight (p = 0 exactly), so Σ, A, R and T run over a row's allowed
  keys only; the kernel visits only the key tiles holding an allowed pair,
  at most ⌈Lk/64⌉, so the terms above stay upper bounds. A fully masked row
  has o = T = 0 and a bound of 0: the kernel must give exactly 0 there.

The bound is first order; a factor 1 + 2^-10 covers the rest. cuBLAS's
fp32 GEMM (the plain twin on the card, and on the CPU) sums with round to
nearest in an order of its own, within the same bound. Plain TF32 (one
product per pair, error 2^-11 |x y|) would exceed it wherever the logits'
share dominates, which this tool also measures (the "tf32" columns).
"""

from __future__ import annotations

import argparse
import json
import math
import zlib

import torch

U = 2.0 ** -24
EPS_SPLIT = 5 * 2.0 ** -22


def _chunks(lq: int, rows: int):
    return [(i, min(lq, i + rows)) for i in range(0, lq, rows)]


def attention_fp64(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   scale: float = None, rows: int = 1024, mask: torch.Tensor = None):
    """The kernel's function in fp64 (q̂ rounded to q's dtype first), and the
    terms of the bound: (o, T, A, R), o and T [B, H, Lq, D], A and R
    [B, H, Lq, 1], all fp64 on q's device. ``mask`` [B, Lq, Lk] bool (True =
    attend, shared across heads): each row over its allowed keys only, and
    o = T = A = R = 0 on a row with none. Computed in row chunks, which keep
    the fp64 scores of ``rows`` queries in memory."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    qs = (q.float() * scale).to(q.dtype).double()
    k64, v64 = k.double(), v.double()
    ka, va = k64.abs(), v64.abs()
    outs = {n: [] for n in ("o", "t", "a", "r")}
    for i0, i1 in _chunks(q.shape[2], rows):
        s = torch.einsum("bhqd,bhkd->bhqk", qs[:, :, i0:i1], k64)
        a = torch.einsum("bhqd,bhkd->bhqk", qs[:, :, i0:i1].abs(), ka)
        if mask is None:
            allowed = torch.ones((), dtype=torch.bool, device=q.device)
        else:
            allowed = mask[:, None, i0:i1].to(q.device)
        any_key = allowed.any(-1, keepdim=True)
        m = torch.where(allowed, s, -math.inf).amax(-1, keepdim=True)
        m = torch.where(any_key, m, 0.0)
        p = torch.where(allowed, torch.exp(s - m), 0.0)
        l = torch.where(any_key, p.sum(-1, keepdim=True), 1.0)
        outs["o"].append(torch.einsum("bhqk,bhkd->bhqd", p, v64) / l)
        outs["t"].append(torch.einsum("bhqk,bhkd->bhqd", p, va) / l)
        low = torch.where(allowed, s, math.inf).amin(-1, keepdim=True)
        outs["r"].append(torch.where(any_key, m - low, 0.0))
        outs["a"].append(torch.where(allowed, a, 0.0).amax(-1, keepdim=True))
        del s, p, a
    return tuple(torch.cat(outs[n], dim=2) for n in ("o", "t", "a", "r"))


def attention_grad_fp64(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        dout: torch.Tensor, scale: float = None, rows: int = 1024):
    """The gradient (dq, dk, dv) of the kernel's function at q, k, v for the
    output gradient ``dout``, in fp64 on q's device: q̂ rounded to q's dtype
    first, as the function does, then exact arithmetic (softmax, o, δ = Σ dO∘o,
    dS = P∘(dP - δ)); dq = scale·(dS·k), straight through that rounding, as
    the plain autograd and the backward kernel take it. Row chunks keep the
    fp64 scores of ``rows`` queries in memory."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    qs = (q.float() * scale).to(q.dtype).double()
    k64, v64, do = k.double(), v.double(), dout.double()
    dq = torch.empty_like(qs)
    dk, dv = torch.zeros_like(k64), torch.zeros_like(v64)
    for i0, i1 in _chunks(q.shape[2], rows):
        p = torch.softmax(torch.einsum("bhqd,bhkd->bhqk", qs[:, :, i0:i1], k64), dim=-1)
        dc = do[:, :, i0:i1]
        delta = (dc * torch.einsum("bhqk,bhkd->bhqd", p, v64)).sum(-1, keepdim=True)
        dv += torch.einsum("bhqk,bhqd->bhkd", p, dc)
        ds = p * (torch.einsum("bhqd,bhkd->bhqk", dc, v64) - delta)
        del p
        dq[:, :, i0:i1] = scale * torch.einsum("bhqk,bhkd->bhqd", ds, k64)
        dk += torch.einsum("bhqk,bhqd->bhkd", ds, qs[:, :, i0:i1])
    return dq, dk, dv


def error_bound(t, a, r, o, lk: int, d: int) -> torch.Tensor:
    """Per-element bound on |fp32 result - fp64 result| (module docstring)."""
    tiles = math.ceil(lk / 64)
    eps_s = EPS_SPLIT + 4 * U * (3 * math.ceil(d / 8) + 1)
    eta = eps_s * a + U * r + 4 * U
    eps_pv = EPS_SPLIT + 4 * U * 24 + U * tiles
    eps_l = U * (18 * tiles + 3) + 2 * U
    return (eta * (t + o.abs()) + eps_pv * t + eps_l * o.abs()) * (1 + 2.0 ** -10)


def fp32_error_bound(q, k, v, scale=None, rows: int = 1024, mask=None):
    """(fp64 result, its per-element error bound) for fp32 q, k, v, under
    ``mask`` where one is given (:func:`attention_fp64`); a row with no
    allowed key has a bound of 0."""
    o, t, a, r = attention_fp64(q, k, v, scale, rows, mask)
    bound = error_bound(t, a, r, o, k.shape[2], q.shape[-1])
    if mask is not None:
        bound = bound * mask.any(-1)[:, None, :, None].to(q.device)
    return o, bound


def check_against_fp64(out: torch.Tensor, ref: torch.Tensor, bound: torch.Tensor) -> dict:
    """Max |out - ref|, the largest share of the bound it takes (an error
    where the bound is 0 takes an infinite share, none takes 0), and
    whether every element lies within its bound."""
    err = (out.double() - ref).abs()
    share = torch.where(bound > 0, err / bound, torch.where(err > 0, math.inf, 0.0))
    return {"max_abs_err": err.max().item(), "max_share_of_bound": share.max().item(),
            "max_bound": bound.max().item(), "within": bool((err <= bound).all().item())}


def _time_ms(fn, iters: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def measure(shape, seeds, dev="cuda") -> list:
    """Kernel, plain twin (full fp32) and plain twin in TF32 against fp64 at
    ``shape`` = (B, H, Lq, Lk, D) for each seed; on the card, the kernel's
    time (CUDA events, 20 calls) at the first seed."""
    from hunyuan3d2_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain

    b, h, lq, lk, d = shape
    rows = []
    for seed in seeds:
        gen = torch.Generator(device=dev).manual_seed(seed)
        q = torch.randn(b, h, lq, d, generator=gen, device=dev)
        k, v = (torch.randn(b, h, lk, d, generator=gen, device=dev) for _ in range(2))
        ref, bound = fp32_error_bound(q, k, v)
        out = flash_attention(q, k, v)
        torch.backends.cuda.matmul.allow_tf32 = False
        twin = flash_attention_plain(q, k, v)
        torch.backends.cuda.matmul.allow_tf32 = True
        twin_tf32 = flash_attention_plain(q, k, v)
        torch.backends.cuda.matmul.allow_tf32 = False
        row = {"shape": [b, h, lq, lk, d], "seed": seed}
        for name, x in (("kernel", out), ("twin", twin), ("twin_tf32", twin_tf32)):
            c = check_against_fp64(x, ref, bound)
            row[name] = {**c, "rms_err": ((x.double() - ref).norm() / ref.norm()).item(),
                         # sign(o)·error: negative when results lean toward 0
                         "mean_signed_err": ((x.double() - ref) * ref.sign()).mean().item()}
        row["kernel_vs_twin"] = (out - twin).abs().max().item()
        if dev == "cuda" and seed == seeds[0]:
            row["kernel_ms"] = _time_ms(lambda: flash_attention(q, k, v))
        rows.append(row)
        del q, k, v, ref, bound, out, twin, twin_tf32
    return rows


SHAPES = ((1, 16, 3072, 3072, 64),   # the v2-0 VAE's self-attention
          (1, 16, 512, 512, 64),     # the mini VAE's
          (1, 8, 1024, 1024, 128),   # the second head size
          (1, 16, 1024, 512, 64), (1, 16, 1024, 1536, 64), (1, 16, 1024, 6144, 64),
          (1, 16, 1024, 12288, 64))  # error against Lk


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=8)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("flash_fp32_error: needs a CUDA device")
    import subprocess

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    for shape in SHAPES:
        seeds = [zlib.crc32(f"{shape}:{i}".encode()) for i in range(args.seeds)]
        for row in measure(shape, seeds):
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()

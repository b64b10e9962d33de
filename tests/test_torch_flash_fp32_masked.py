"""The fp64 yardstick of the masked fp32 kernel (kernel 2's fp32 instance),
on the CPU: hunyuan3d2_tpu_torch/tools/flash_fp32_error.py under a mask
against the JAX package's ``flash_attention_masked`` (the Pallas kernel in
interpret mode, fp32, as tests/test_torch_paint.py runs it) and the port's
plain twin. The kernel itself runs only on the card (tests/test_torch_cuda.py,
chip_smoke.py's masked rows).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hunyuan3d2_tpu_torch.ops.flash_attention import flash_attention_masked_plain
from hunyuan3d2_tpu_torch.tools.flash_fp32_error import (
    attention_fp64,
    check_against_fp64,
    fp32_error_bound,
)
from tests.test_torch_paint import _pallas_masked


def _case(lq, lk, d, seed):
    """q, k, v [2, 3, L, d] fp32 and a [2, lq, lk] mask with the kernel's
    hard rows: 0 fully masked, 1 masked through its first 64-key tile, 2
    with one allowed key in the ragged last tile."""
    rs = np.random.RandomState(seed)
    q = rs.randn(2, 3, lq, d).astype(np.float32)
    k, v = (rs.randn(2, 3, lk, d).astype(np.float32) for _ in range(2))
    mask = rs.rand(2, lq, lk) < 0.3
    mask[:, 0] = False
    mask[:, 1, :64] = False
    mask[:, 2] = False
    mask[:, 2, lk - 1] = True
    return q, k, v, mask


@pytest.mark.parametrize("lq,lk,d", [(130, 200, 64), (128, 333, 64), (70, 77, 128)])
def test_masked_fp64_yardstick_covers_jax_and_twin(lq, lk, d):
    q, k, v, mask = _case(lq, lk, d, lq + lk + d)
    tq, tk, tv, tm = (torch.from_numpy(a) for a in (q, k, v, mask))
    ref, bound = fp32_error_bound(tq, tk, tv, mask=tm)
    jax_out = torch.from_numpy(np.asarray(_pallas_masked(
        *(jnp.asarray(a) for a in (q, k, v)), jnp.asarray(mask), 128, 128), np.float32))
    twin = flash_attention_masked_plain(tq, tk, tv, tm)
    live = torch.from_numpy(mask.any(-1))[:, None, :, None].expand_as(ref)
    # the fp64 evaluation is the masked function: the JAX kernel agrees with
    # it wherever a row has an allowed key (fp32 summation only)
    torch.testing.assert_close(jax_out.double()[live], ref[live], atol=2e-5, rtol=2e-5)
    for out in (jax_out, twin):
        c = check_against_fp64(out, ref, bound)
        assert c["within"] and c["max_share_of_bound"] < 0.5, c
    # the analysed bound is fp32-grade: far below the values it bounds
    assert (bound[live] <= 1e-3 * ref.abs().amax()).all()
    # a fully masked row: o = T = 0, a bound of 0, and the twin's exact 0
    assert (ref[:, :, 0] == 0).all() and (bound[:, :, 0] == 0).all()
    assert (twin[:, :, 0] == 0).all()
    o, t, a, r = attention_fp64(tq, tk, tv, mask=tm)
    assert (t[:, :, 0] == 0).all() and (a[:, :, 0] == 0).all() and (r[:, :, 0] == 0).all()
    # the one-key row is that key's value
    torch.testing.assert_close(ref[:, :, 2], tv[:, :, lk - 1].double(), atol=1e-12, rtol=0)


def test_masked_yardstick_sees_a_leak():
    """A kernel that let masked keys through (exp(0) = 1 while a row's
    running max is still -1e30) or gave a fully masked row anything but 0
    falls outside the bound."""
    q, k, v, mask = _case(130, 200, 64, 1)
    tq, tk, tv, tm = (torch.from_numpy(a) for a in (q, k, v, mask))
    ref, bound = fp32_error_bound(tq, tk, tv, mask=tm)
    leaky = mask.copy()
    leaky[:, 1, :64] = True                     # row 1's first tile let through
    bad = flash_attention_masked_plain(tq, tk, tv, torch.from_numpy(leaky))
    c = check_against_fp64(bad, ref, bound)
    assert not c["within"]
    nonzero = flash_attention_masked_plain(tq, tk, tv, tm)
    nonzero[:, :, 0] = 1e-30
    c = check_against_fp64(nonzero, ref, bound)
    assert not c["within"] and c["max_share_of_bound"] == float("inf")


def test_unmasked_yardstick_is_unchanged_by_an_all_true_mask():
    rs = np.random.RandomState(3)
    q, k, v = (torch.from_numpy(rs.randn(1, 2, n, 64).astype(np.float32))
               for n in (100, 150, 150))
    ref, bound = fp32_error_bound(q, k, v)
    ref_m, bound_m = fp32_error_bound(q, k, v, mask=torch.ones(1, 100, 150, dtype=torch.bool))
    torch.testing.assert_close(ref_m, ref, atol=0, rtol=0)
    torch.testing.assert_close(bound_m, bound, atol=0, rtol=0)

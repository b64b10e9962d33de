"""The fp32 kernels' operand pre-pass in its plain twin (CPU): the TF32 split
x = big + small (ops/flash_attention.py ``tf32_split_plain``, the twin of
csrc/hopper.cuh ``split_tf32_exact``) against an independent numpy
evaluation, bit for bit, and the split operands' layouts
(``split_operand_plain``: rows as they are, and transposed with each group
of 8 columns permuted). The kernel against the twin: tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from hunyuan3d2_tpu_torch.ops import flash_attention as fa


def _numpy_split(x: np.ndarray):
    """big = x rounded to 10 mantissa bits, to nearest with ties away from
    zero (cvt.rna.tf32.f32), truncated where rounding would overflow; small
    = x - big, 0 of x's sign where big is x (and for inf, NaN, where big is
    x): by value, in float64, not by bit manipulation."""
    x = np.asarray(x, np.float32)
    finite = np.isfinite(x)
    xf = np.where(finite, x, np.float32(1)).astype(np.float64)  # inf, NaN: by their bits below
    ax = np.abs(xf)
    _, ex = np.frexp(np.where(ax > 0, ax, 1.0))
    ulp = np.ldexp(1.0, np.maximum(ex - 1, -126) - 10)
    r = np.floor(ax / ulp + 0.5) * ulp
    r = np.where(r >= 2.0 ** 128, np.floor(ax / ulp) * ulp, r)
    big = np.where(finite, np.copysign(r, xf).astype(np.float32).view(np.uint32),
                   x.view(np.uint32)).view(np.float32)
    same = big.view(np.uint32) == x.view(np.uint32)
    zero = (x.view(np.uint32) & np.uint32(0x80000000)).view(np.float32)
    rest = (xf - np.where(finite, big, np.float32(0)).astype(np.float64)).astype(np.float32)
    small = np.where(same | ~finite, zero.view(np.uint32), rest.view(np.uint32))
    return big, small.view(np.float32)


def _bits(*words):
    return np.array(words, np.uint32).view(np.float32)


VALUES = {
    # low 13 bits exactly half an ulp (ties: away from zero), one below, one above
    "ties": _bits(0x3F801000, 0x3F803000, 0xBF801000, 0x3F800FFF, 0x3F801001, 0x4049F000,
                  0x00001000, 0x80003000),
    "zeros": _bits(0x00000000, 0x80000000, 0x3F800000, 0xBF800000),
    "specials": _bits(0x7F800000, 0xFF800000, 0x7FC00000, 0xFFC00001, 0x7FA00000),
    "subnormals": _bits(0x00000001, 0x00000FFF, 0x00001000, 0x00001FFF, 0x007FFFFF, 0x807FF000,
                        0x80000001, 0x00800000),
    # the largest finite values: rounding would overflow, so they truncate
    "overflow": _bits(0x7F7FFFFF, 0xFF7FFFFF, 0x7F7FF000, 0x7F7FEFFF, 0x7F7FF001),
    "random": np.random.RandomState(15).randint(0, 2 ** 32, 4096, dtype=np.uint64)
    .astype(np.uint32).view(np.float32),
}


@pytest.mark.parametrize("name", sorted(VALUES))
def test_tf32_split_matches_numpy_bit_for_bit(name):
    x = VALUES[name].copy()
    big, small = fa.tf32_split_plain(torch.from_numpy(x))
    ref_big, ref_small = _numpy_split(x)
    np.testing.assert_array_equal(big.numpy().view(np.uint32), ref_big.view(np.uint32))
    np.testing.assert_array_equal(small.numpy().view(np.uint32), ref_small.view(np.uint32))
    # big is TF32 (its low 13 bits clear) unless x is inf or NaN, and big +
    # small gives x back bit for bit (NaN: a NaN)
    finite = np.isfinite(x)
    assert (big.numpy().view(np.uint32)[finite] & 0x1FFF == 0).all()
    back = (big + small).numpy()
    nan = np.isnan(x)
    np.testing.assert_array_equal(back[~nan].view(np.uint32), x[~nan].view(np.uint32))
    assert np.isnan(back[nan]).all()


@pytest.mark.parametrize("n,rows,d,cols", [(1, 5, 64, 8), (2, 100, 64, 128), (3, 37, 128, 64)])
def test_split_operand_layouts(n, rows, d, cols):
    """direct [2, n, rows, D]: the halves of x·scale; transposed [2, n, D,
    cols]: column c holds row 8⌊c/8⌋ + (p < 4 ? 2p : 2(p - 4) + 1), p = c
    mod 8, or 0 past ``rows``."""
    rs = np.random.RandomState(rows)
    x = rs.randn(n, rows, d).astype(np.float32)
    scale = 0.125 if d == 64 else 0.088
    direct, trans = fa.split_operand_plain(torch.from_numpy(x), scale, cols)
    y = x * np.float32(scale)
    big, small = _numpy_split(y)
    np.testing.assert_array_equal(direct.numpy(), np.stack([big, small]))
    assert trans.shape == (2, n, d, cols)
    for c in range(cols):
        p = c % 8
        r = c - p + (2 * p if p < 4 else 2 * (p - 4) + 1)
        want = (np.stack([big[:, r], small[:, r]]) if r < rows
                else np.zeros((2, n, d), np.float32))
        np.testing.assert_array_equal(trans[:, :, :, c].numpy(), want)
    assert fa.split_operand_plain(torch.from_numpy(x), scale)[1] is None


def test_split_operand_wrapper_takes_the_twin_on_the_cpu_and_checks_its_inputs():
    x = torch.randn(2, 40, 64)
    got = fa.split_operand(x, 0.5, 48)
    ref = fa.split_operand_plain(x, 0.5, 48)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    with pytest.raises(ValueError, match="multiple of 8"):
        fa.split_operand(x, 1.0, 44)
    with pytest.raises(ValueError, match="multiple of 8"):
        fa.split_operand(x, 1.0, 32)
    with pytest.raises(ValueError, match="fp32"):
        fa.split_operand(x.bfloat16())
    with pytest.raises(ValueError, match="fp32"):
        fa.split_operand(torch.randn(2, 40, 96))

"""Kernel 1's gradient on the CPU: the plain twins of the lse-keeping forward
and of the backward kernel, and the autograd wrapper's routing.

* ``flash_attention_lse_plain``: o is ``flash_attention_plain``'s, and lse
  the log-sum-exp of the fp32 logits (against an fp64 evaluation).
* ``flash_attention_backward_plain`` (the backward kernel's algorithm step
  by step) against ``torch.autograd.grad`` of ``flash_attention_plain``, for
  every subset of the inputs that need a gradient, and in fp32 against
  ``jax.vjp`` of the JAX package's ``ops.attention.sdpa`` (the attention
  its training differentiates) on the same numpy inputs.
* ``_FlashAttentionFn`` with its launchers replaced by the twins: the
  lse-keeping forward runs only under a gradient; the backward hands the
  saved o and lse to the backward launcher and never calls
  ``flash_attention_plain``; gradients come back in the inputs' dtype,
  None where none is needed.
* ``backward_config``: its splits and padding of the statistics follow the
  kernel's rules, at the shapes the port's paths give it (a table written
  from the tiles ``csrc/flash_attention_bwd.cu`` launches); the tile
  sweep's launcher takes the twin on CPU tensors.

The kernels themselves run on the card: tests/test_torch_cuda.py.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hunyuan3d2_tpu.ops.attention import sdpa as jax_sdpa
from hunyuan3d2_tpu_torch.ops import attention as att
from hunyuan3d2_tpu_torch.ops import flash_attention as fa

# (B, H, Lq, Lk, D): ragged lengths (no multiple of a tile), both head sizes
SHAPES = [(2, 3, 40, 56, 64), (1, 2, 37, 91, 128)]
SUBSETS = [s for s in itertools.product((True, False), repeat=3) if any(s)]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _numpy_inputs(shape, seed=0):
    b, h, lq, lk, d = shape
    rs = np.random.RandomState(seed)
    return [rs.randn(b, h, n, d).astype(np.float32) for n in (lq, lk, lk, lq)]


def _inputs(shape, dtype, seed=0):
    """q, k, v, dout from numpy with a seed, in ``dtype``."""
    return [torch.from_numpy(x).to(dtype) for x in _numpy_inputs(shape, seed)]


def _bf16_close(got, ref):
    """bf16: within 2^-6 of the largest gradient and a relative RMS of 1e-2
    (chip_smoke's attention rule): the gradients are rounded to bf16 once,
    and the twin rounds dS where the autograd rounds dP (~0.5 % of the
    largest value apart on these shapes)."""
    diff = got.float() - ref.float()
    assert diff.abs().max() <= 2.0 ** -6 * ref.float().abs().max()
    assert diff.norm() <= 1e-2 * ref.float().norm()


def _fp32_close(got, ref):
    """fp32: within 1e-5 of the largest gradient (the same fp32 arithmetic
    in another order: δ from dO·o rather than from dP·P, P from the lse
    rather than the softmax; ~7e-7 apart on these shapes)."""
    torch.testing.assert_close(got, ref, atol=1e-5 * float(ref.abs().max()), rtol=0)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES, ids=["d64", "d128"])
def test_lse_plain_is_the_logsumexp_of_the_logits(shape, dt):
    q, k, v, _ = _inputs(shape, dt)
    scale = shape[-1] ** -0.5
    o, lse = fa.flash_attention_lse_plain(q, k, v)
    assert o.dtype == dt and lse.dtype == torch.float32 and lse.shape == shape[:3]
    torch.testing.assert_close(o, fa.flash_attention_plain(q, k, v), atol=0, rtol=0)
    # the logits of the kernel's function (q·scale rounded to dt) in fp64;
    # fp32 logits and logsumexp: a few fp32 ulps of lse
    qs = (q.float() * scale).to(dt).double()
    ref = torch.logsumexp(qs @ k.double().transpose(-1, -2), dim=-1)
    torch.testing.assert_close(lse.double(), ref, atol=1e-6 * float(ref.abs().max()), rtol=0)
    # P = exp(logits - lse) sums to 1 over the keys
    p = torch.exp(qs.float() @ k.float().transpose(-1, -2) - lse[..., None])
    torch.testing.assert_close(p.sum(-1), torch.ones_like(lse), atol=1e-5, rtol=0)


@pytest.mark.parametrize("needs", SUBSETS, ids=lambda s: "".join("qkv"[i] for i in range(3) if s[i]))
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES, ids=["d64", "d128"])
def test_backward_plain_matches_the_plain_autograd(shape, dt, needs):
    q, k, v, dout = _inputs(shape, dt, seed=1)
    o, lse = fa.flash_attention_lse_plain(q, k, v)
    got = fa.flash_attention_backward_plain(q, k, v, o, lse, dout)
    leaves = [t.clone().requires_grad_(n) for t, n in zip((q, k, v), needs)]
    wanted = [t for t in leaves if t.requires_grad]
    refs = iter(torch.autograd.grad(fa.flash_attention_plain(*leaves), wanted, dout))
    for g, n in zip(got, needs):
        assert g.dtype == dt
        if n:
            (_fp32_close if dt == torch.float32 else _bf16_close)(g, next(refs))


@pytest.mark.parametrize("shape", SHAPES, ids=["d64", "d128"])
def test_backward_plain_matches_jax_vjp_of_sdpa(shape):
    """fp32 on both sides, the same numpy inputs. The JAX sdpa scales the
    logits, the port folds the scale into q first (exact at D = 64, one
    rounding of q apart at D = 128): within 1e-5 of the largest gradient."""
    qn, kn, vn, dn = _numpy_inputs(shape, seed=2)
    _, vjp = jax.vjp(jax_sdpa, jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn))
    refs = vjp(jnp.asarray(dn))
    q, k, v, dout = (torch.from_numpy(x) for x in (qn, kn, vn, dn))
    o, lse = fa.flash_attention_lse_plain(q, k, v)
    got = fa.flash_attention_backward_plain(q, k, v, o, lse, dout)
    for g, r in zip(got, refs):
        _fp32_close(g, torch.from_numpy(np.array(r)))


@pytest.fixture
def launchers(monkeypatch):
    """The card branch's three launchers replaced by the twins, recording
    their calls; ``flash_attention_plain`` refuses to run."""
    calls = {"forward": [], "lse": [], "backward": []}
    plain = fa.flash_attention_plain

    def launch(q, k, v, mask, scale):
        assert mask is None
        calls["forward"].append(tuple(q.shape))
        return plain(q, k, v, scale)

    def launch_lse(q, k, v, scale):
        calls["lse"].append(tuple(q.shape))
        return fa.flash_attention_lse_plain(q, k, v, scale)

    def launch_backward(q, k, v, o, lse, dout, scale):   # counts, as the launcher does
        calls["backward"].append((o.detach().clone(), lse.clone()))
        fa.flash_attention_backward.launches += 1
        return fa.flash_attention_backward_plain(q, k, v, o, lse, dout, scale)

    def refuse(*args, **kwargs):
        raise AssertionError("flash_attention_plain ran on the card branch")

    monkeypatch.setattr(fa, "_launch", launch)
    monkeypatch.setattr(fa, "_launch_lse", launch_lse)
    monkeypatch.setattr(fa, "_launch_backward", launch_backward)
    monkeypatch.setattr(fa, "flash_attention_plain", refuse)
    calls["plain"] = plain
    return calls


@pytest.mark.parametrize("needs", SUBSETS, ids=lambda s: "".join("qkv"[i] for i in range(3) if s[i]))
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_card_branch_keeps_lse_and_launches_the_backward(launchers, dt, needs):
    shape = SHAPES[0]
    q, k, v, dout = _inputs(shape, dt, seed=3)
    q, k, v = (t.requires_grad_(n) for t, n in zip((q, k, v), needs))
    before, before_bwd = fa.flash_attention.launches, fa.flash_attention_backward.launches
    out = fa._on_card(q, k, v, shape[-1] ** -0.5)
    assert launchers["lse"] == [tuple(q.shape)] and launchers["forward"] == []
    assert fa.flash_attention.launches == before + 1
    grads = out.grad_fn.apply(dout)
    assert len(launchers["backward"]) == 1
    assert fa.flash_attention_backward.launches == before_bwd + 1
    o_saved, lse_saved = launchers["backward"][0]
    o_ref, lse_ref = fa.flash_attention_lse_plain(q.detach(), k.detach(), v.detach())
    assert torch.equal(o_saved, out.detach()) and torch.equal(o_saved, o_ref)
    assert torch.equal(lse_saved, lse_ref)
    assert grads[3:] == (None, None)
    leaves = [t.detach().clone().requires_grad_(n) for t, n in zip((q, k, v), needs)]
    refs = iter(torch.autograd.grad(launchers["plain"](*leaves),
                                    [t for t in leaves if t.requires_grad], dout))
    for g, n in zip(grads[:3], needs):
        if not n:
            assert g is None
            continue
        assert g.dtype == dt
        (_fp32_close if dt == torch.float32 else _bf16_close)(g, next(refs))


def test_card_branch_without_a_gradient_keeps_no_lse(launchers):
    q, k, v, _ = _inputs(SHAPES[0], torch.float32)
    with torch.no_grad():
        out = fa._on_card(q.requires_grad_(True), k, v, 0.125)
    assert out.grad_fn is None and launchers["lse"] == []
    out = fa._on_card(q.detach(), k, v, 0.125)          # grad mode on, nothing requires grad
    assert out.grad_fn is None and launchers["lse"] == []
    assert launchers["forward"] == [tuple(q.shape)] * 2 and launchers["backward"] == []


def test_attention_trains_through_the_backward_launcher(launchers, monkeypatch):
    """``ops.attention.attention``'s gate sends the call to the card branch
    (as for a CUDA tensor); a loss's backward reaches the backward launcher
    once and gives the plain autograd's gradients."""
    monkeypatch.setattr(att, "use_flash", lambda q: True)
    monkeypatch.setattr(att, "flash_attention",
                        lambda q, k, v, scale=None: fa._on_card(q, k, v, q.shape[-1] ** -0.5))
    q, k, v, dout = (t.requires_grad_(i < 3) for i, t in
                     enumerate(_inputs(SHAPES[1], torch.float32, seed=4)))
    (att.attention(q, k, v) * dout).sum().backward()
    assert len(launchers["backward"]) == 1 and len(launchers["lse"]) == 1
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    refs = torch.autograd.grad(launchers["plain"](*leaves), leaves, dout)
    for t, r in zip((q, k, v), refs):
        _fp32_close(t.grad, r)


def test_backward_wrapper_takes_the_twin_on_the_cpu_and_checks_its_inputs():
    q, k, v, dout = _inputs(SHAPES[0], torch.float32, seed=5)
    o, lse = fa.flash_attention_lse_plain(q, k, v)
    before = fa.flash_attention_backward.launches
    got = fa.flash_attention_backward(q, k, v, o, lse, dout)
    for g, r in zip(got, fa.flash_attention_backward_plain(q, k, v, o, lse, dout)):
        assert torch.equal(g, r)
    assert fa.flash_attention_backward.launches == before   # no kernel ran
    with pytest.raises(ValueError, match="lse"):
        fa.flash_attention_backward(q, k, v, o, lse[..., :-1], dout)
    with pytest.raises(ValueError, match="dout"):
        fa.flash_attention_backward(q, k, v, o, lse, dout.bfloat16())
    with pytest.raises(RuntimeError, match="flash_attention_backward has no gradient"):
        fa.flash_attention_backward(q.requires_grad_(True), k, v, o, lse, dout)


# (B, H, Lq, Lk, D, dtype) → BackwardConfig (q rows a step of the dK/dV pass,
# splits, lq_pad), written from csrc/flash_attention_bwd.cu's tiles (bf16:
# 64-key CTAs, two an SM, 64 q rows a step, the dQ pass's 128 q rows a CTA;
# fp32: 64-key CTAs, one an SM, 32 q rows a step, dQ CTAs of 128 q rows at
# D = 64 and 64 at D = 128): the DiT
# training row, D = 128, the VAE, v2-0 VAE and decode-chunk rows (fp32), the
# fp32 D = 128 row, ragged and split shapes
BF16, F32 = torch.bfloat16, torch.float32
CONFIG_TABLE = {
    "dit train": ((2, 16, 1882, 1882, 64, BF16), (64, 1, 1920)),
    "d128": ((1, 8, 4096, 4096, 128, BF16), (64, 1, 4096)),
    "vae fp32": ((1, 16, 512, 512, 64, F32), (32, 2, 512)),
    "vae full fp32": ((1, 16, 3072, 3072, 64, F32), (32, 1, 3072)),
    "chunk fp32": ((1, 16, 65536, 512, 64, F32), (32, 2, 65536)),
    "d128 fp32": ((1, 8, 1024, 1024, 128, F32), (32, 2, 1024)),
    "split fp32 d128": ((1, 2, 3000, 100, 128, F32), (32, 32, 3008)),
    "ragged d128": ((2, 3, 130, 200, 128, BF16), (64, 3, 256)),
    "ragged d64": ((1, 4, 700, 333, 64, BF16), (64, 11, 768)),
    "lk below 64": ((2, 2, 300, 40, 64, BF16), (64, 5, 384)),
    "split bf16": ((1, 2, 3000, 100, 64, BF16), (64, 47, 3072)),
    "ragged fp32": ((2, 3, 130, 200, 64, F32), (32, 5, 256)),
}


@pytest.mark.parametrize("name", sorted(CONFIG_TABLE))
def test_backward_config_table(name):
    shape, want = CONFIG_TABLE[name]
    assert fa.backward_config(*shape) == fa.BackwardConfig(*want)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("dt", [F32, BF16], ids=["fp32", "bf16"])
def test_backward_config_splits_and_padding(d, dt):
    """Over many shapes: the splits cover the q tiles with none empty (the
    kernel refuses more splits than q tiles), the statistics cover every
    row either pass reads (the last q tile of the dK/dV pass, the last CTA
    of the dQ pass), and the q range is split only where the key ranges
    leave SMs idle."""
    keys, _, pad, per_sm = fa._BWD_TILES[dt, d]
    rs = np.random.RandomState(d)
    for _ in range(60):
        b, h = rs.randint(1, 4), rs.randint(1, 17)
        lq, lk = rs.randint(1, 5000), rs.randint(1, 5000)
        cfg = fa.backward_config(b, h, lq, lk, d, dt)
        n_qt = -(-lq // cfg.rows)
        per = -(-n_qt // cfg.splits)
        assert (cfg.splits - 1) * per < n_qt <= cfg.splits * per
        assert cfg.lq_pad >= lq and cfg.lq_pad - lq < pad and cfg.lq_pad % pad == 0
        assert cfg.lq_pad >= n_qt * cfg.rows
        if b * h * -(-lk // keys) >= per_sm * fa.SM_COUNT:
            assert cfg.splits == 1


def test_backward_variant_takes_the_twin_on_the_cpu_and_refuses_other_tiles():
    """The tile sweep's launcher: a compiled tile of each pass on CPU
    tensors gives flash_attention_backward_plain's gradients; a tile that
    csrc/flash_bwd_variants.cu does not compile, or an input that requires
    a gradient, is refused."""
    from hunyuan3d2_tpu_torch.tools import profile_flash_bwd_variants as pv

    q, k, v, dout = _inputs((1, 2, 70, 90, 64), BF16, seed=5)
    o, lse = fa.flash_attention_lse_plain(q, k, v, 0.125)
    got = pv.flash_attention_backward_variant(q, k, v, o, lse, dout, 0.125, (64, 64, 3),
                                              (128, 128, 3))
    ref = fa.flash_attention_backward_plain(q, k, v, o, lse, dout, 0.125)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    for d, kv, qt in ((128, (128, 128, 2), (128, 64, 3)), (64, (64, 64, 3), (128, 64, 3))):
        assert kv not in pv.KV_VARIANTS[d] or qt not in pv.Q_VARIANTS[d]
        x = torch.zeros(1, 1, 8, d, dtype=BF16)
        with pytest.raises(ValueError, match="not compiled"):
            pv.flash_attention_backward_variant(x, x, x, x, torch.zeros(1, 1, 8), x, 1.0, kv, qt)
    with pytest.raises(RuntimeError, match="has no gradient"):
        pv.flash_attention_backward_variant(q.requires_grad_(True), k, v, o, lse, dout, 0.125,
                                            (64, 64, 3), (128, 128, 3))


PTXAS_LOG = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_14fbwd16dkdv_bf16_kernelILi64ELi128ELi64ELi2EEEv14CUtensorMap_stPKf' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_14fbwd16dkdv_bf16_kernelILi64ELi128ELi64ELi2EEEv14CUtensorMap_stPKf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 560 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_14fbwd13dq_f32_kernelILi128EEEvPKfPfiiiif' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_14fbwd13dq_f32_kernelILi128EEEvPKfPfiiiif
    36 bytes stack frame, 36 bytes spill stores, 40 bytes spill loads
ptxas info    : Used 255 registers
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_14fbwd14dq_bf16_kernelILi64ELi128ELi128ELi2EEEv14CUtensorMap_stPKfiiiif' for 'sm_90a'
ptxas warning : (C7514) Potential Performance Loss: wgmma.mma_async instructions are serialized due to the presence of Extern calls in the function '_ZN12_GLOBAL__N_14fbwd14dq_bf16_kernelILi64ELi128ELi128ELi2EEEv14CUtensorMap_stPKfiiiif'.
ptxas info    : Used 90 registers
"""


def test_chip_smoke_reads_ptxas_spills_and_serialised_wgmma():
    """chip_smoke's build gate on the backward: registers, spills and C7514
    per instance, each instance named by its pass, dtype and tiles."""
    import chip_smoke

    found = chip_smoke.ptxas_instances(PTXAS_LOG)
    assert len(found) == 3
    by_label = {chip_smoke.kernel1_instance(mangled): info for mangled, info in found.items()}
    assert by_label[("dkdv", "bf16", (64, 128, 64, 2))] == dict(
        registers=168, spill_stores=0, spill_loads=0, serialized=False)
    assert by_label[("dq", "f32", (128,))] == dict(
        registers=255, spill_stores=36, spill_loads=40, serialized=False)
    assert by_label[("dq", "bf16", (64, 128, 128, 2))] == dict(
        registers=90, spill_stores=0, spill_loads=0, serialized=True)
    # the forward's instances (bool template arguments too), the masked fp32
    # one (kernel 2: kLse 0, kMask 1) among them; the bf16 masked forward is
    # named so too, and the gate skips bf16 forwards
    assert chip_smoke.kernel1_instance(
        "_ZN5flash16flash_f32_kernelILi64ELi128ELi64ELi4ELb1ELb0EEEv14CUtensorMap_st") == (
        "flash", "f32", (64, 128, 64, 4, 1, 0))
    assert chip_smoke.kernel1_instance(
        "_ZN5flash16flash_f32_kernelILi64ELi128ELi64ELi4ELb0ELb1EEEv14CUtensorMap_st") == (
        "flash", "f32", (64, 128, 64, 4, 0, 1))
    assert chip_smoke.kernel1_instance("_ZN5flash23flash_f32_masked_kernelILi64EEEvPKf") is None

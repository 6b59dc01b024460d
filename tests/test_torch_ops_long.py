"""The long-clip and long-prompt attention kernels of the port vs the JAX package.

`attn_fwd_v2_plain` (the plain version of the blocked-KV kernel) is held
against `flash_attention_v2` in interpret mode, and `attn_fwd_bias_plain`
against `flash_attention(..., bias=)`, on the same numpy inputs, at the JAX
kernel tests' limits (tests/test_flash_attention.py): f32 atol 2e-5 /
rtol 1e-4, bf16 3e-2 (`test_flash_bf16`). Then the dispatch of
`multi_head_attention`: which kernel route a call takes, against JAX's rule,
with the outputs and gradients of JAX's `multi_head_attention`; and the
kernels' shape limits, which the dispatch asks before it picks a kernel.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tango_tpu.ops.attention as jattn
import tango_tpu.ops.flash_attention as jfa
from tango_tpu.ops.attention import _xla_attention
from tango_tpu_torch.ops import attention as tattn
from tango_tpu_torch.ops import basic as tbasic
from tango_tpu_torch.ops import flash_attention as tfa
from tango_tpu_torch.ops import gn_silu as tgn

# One intra-op thread: pytest-xdist workers share the cores, and torch's
# pool of one thread per core then spends most of its time waiting.
torch.set_num_threads(1)


def _qkv(b, h, sq, skv, d, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, h, s, d).astype(np.float32) for s in (sq, skv, skv)]


def _flat(a, dtype=torch.float32):
    """(B, H, S, D) numpy -> (B*H, S, D) torch."""
    b, h, s, d = a.shape
    return torch.from_numpy(np.ascontiguousarray(a.reshape(b * h, s, d))).to(dtype)


def _unflat(t, b, h):
    out = t.float().numpy()
    return out.reshape(b, h, out.shape[1], out.shape[2])


def _mask_bias(b, rows, skv, keep):
    """The reference's padding bias: 0 for the first `keep` keys, -10000 after."""
    mask = np.ones((b, rows, skv), np.float32)
    mask[:, :, keep:] = 0.0
    return (1.0 - mask) * -10000.0


# ------------------------------------------------------------ attn_fwd_v2


@pytest.mark.parametrize(
    "shape,blocks",
    [
        ((1, 2, 512, 512, 64), dict(block_q=128, block_kv=128)),  # 4 x 4 blocks
        ((1, 1, 384, 640, 64), {}),  # lengths the default blocks do not divide
    ],
)
def test_attn_v2_plain_matches_pallas(shape, blocks):
    b, h, sq, skv, d = shape
    q, k, v = _qkv(b, h, sq, skv, d, 3)
    ref = jfa.flash_attention_v2(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=0.125,
                                 interpret=True, **blocks)
    out = tfa.attn_fwd_v2(_flat(q), _flat(k), _flat(v), 0.125)
    np.testing.assert_allclose(_unflat(out, b, h), np.asarray(ref), atol=2e-5, rtol=1e-4)


def test_attn_v2_plain_bf16_matches_pallas():
    q, k, v = _qkv(1, 2, 512, 512, 64, 4)
    qb, kb, vb = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    ref = jfa.flash_attention_v2(qb, kb, vb, scale=0.125, block_q=128, block_kv=128,
                                 interpret=True)
    rounded = [np.asarray(a, np.float32) for a in (qb, kb, vb)]
    out = tfa.attn_fwd_v2(*(_flat(a, torch.bfloat16) for a in rounded), 0.125)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(_unflat(out, 1, 2), np.asarray(ref, np.float32), atol=3e-2,
                               rtol=3e-2)


def _extreme_qk(ck_base, seed):
    """q rows ~ c*u, k rows ~ |g|*u (tests/test_flash_attention.py): every
    logit of a row is large and positive, with an O(1) spread."""
    rng = np.random.RandomState(seed)
    sq, skv, d = 128, 256, 64
    u = rng.randn(d)
    u /= np.linalg.norm(u)
    cq = 2.0 + 0.2 * rng.rand(sq, 1)
    ck = ck_base + 8.0 * rng.rand(skv, 1)
    q = (cq * u[None, :] + 0.01 * rng.randn(sq, d)).astype(np.float32)[None, None]
    k = (ck * u[None, :] + 0.01 * rng.randn(skv, d)).astype(np.float32)[None, None]
    v = rng.randn(1, 1, skv, d).astype(np.float32)
    return q, k, v


def test_attn_v2_is_exact_past_the_static_shift_window():
    """Row maxes near natural +100 (base 2: ~150, past the static-shift
    clamp at 116): the blocked-KV kernel's plain version matches JAX's v2
    kernel and the XLA softmax, and the static-shift kernel's does not, so
    the v2 route changes the function computed, not only its name."""
    q, k, v = _extreme_qk(380.0, 0)
    scale = 64**-0.5
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    logit_max = (q[0, 0] @ k[0, 0].T).max() * scale
    assert 95.0 < logit_max < 110.0
    j_v2 = np.asarray(jfa.flash_attention_v2(jq, jk, jv, scale=scale, block_q=128,
                                             block_kv=128, interpret=True))
    xla = np.asarray(_xla_attention(jq, jk, jv, bias=None, scale=scale, upcast=True))
    out = _unflat(tfa.attn_fwd_v2(_flat(q), _flat(k), _flat(v), scale), 1, 1)
    static = _unflat(tfa.attn_fwd(_flat(q), _flat(k), _flat(v), scale), 1, 1)
    assert np.all(np.isfinite(out))
    np.testing.assert_allclose(out, j_v2, atol=5e-5, rtol=1e-3)
    np.testing.assert_allclose(out, xla, atol=5e-5, rtol=1e-3)
    assert np.abs(static - xla).max() > 1e-2  # 200x the limit the v2 route keeps


# ---------------------------------------------------------- attn_fwd_bias


@pytest.mark.parametrize(
    "b,h,sq,skv,rows",
    [
        (2, 3, 256, 64, 1),      # test_flash_with_bias: one bias row for every query
        (2, 3, 256, 64, 256),    # a bias row for each query
        (2, 2, 256, 256, 1),     # Tango's masked cross-attention to a 256-token prompt
    ],
)
def test_attn_bias_plain_matches_pallas(b, h, sq, skv, rows):
    q, k, v = _qkv(b, h, sq, skv, 64, 1)
    bias = _mask_bias(b, rows, skv, skv // 2)
    ref = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              bias=jnp.asarray(bias)[:, None], scale=0.125, interpret=True)
    out = tfa.attn_fwd_bias(_flat(q), _flat(k), _flat(v), torch.from_numpy(bias), h, 0.125)
    np.testing.assert_allclose(_unflat(out, b, h), np.asarray(ref), atol=2e-5, rtol=1e-4)


def test_attn_bias_plain_bf16_matches_pallas():
    q, k, v = _qkv(2, 2, 256, 256, 64, 2)
    bias = _mask_bias(2, 1, 256, 3)
    qb, kb, vb = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    ref = jfa.flash_attention(qb, kb, vb, bias=jnp.asarray(bias)[:, None], scale=0.125,
                              interpret=True)
    rounded = [np.asarray(a, np.float32) for a in (qb, kb, vb)]
    out = tfa.attn_fwd_bias(*(_flat(a, torch.bfloat16) for a in rounded),
                            torch.from_numpy(bias), 2, 0.125)
    np.testing.assert_allclose(_unflat(out, 2, 2), np.asarray(ref, np.float32), atol=3e-2,
                               rtol=3e-2)


def test_attn_bias_all_masked_row_is_finite():
    """A batch row whose keys are all masked (-10000) stays finite, as in the
    max-subtracted JAX kernel. Its base-2 logits sit near -14427, where an
    f32 holds only 2^-10 of absolute precision, so p carries up to ~7e-4 of
    relative rounding in either implementation: that row is held at atol
    1e-3, the other batch row at the kernel tests' 2e-5 / 1e-4."""
    q, k, v = _qkv(2, 2, 256, 256, 64, 5)
    bias = _mask_bias(2, 1, 256, 4)
    bias[1] = -10000.0
    ref = np.asarray(jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                         bias=jnp.asarray(bias)[:, None], scale=0.125,
                                         interpret=True))
    out = _unflat(tfa.attn_fwd_bias(_flat(q), _flat(k), _flat(v), torch.from_numpy(bias), 2,
                                    0.125), 2, 2)
    assert np.all(np.isfinite(out))
    np.testing.assert_allclose(out[0], ref[0], atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(out[1], ref[1], atol=1e-3, rtol=0)


def test_attn_bias_wrapper_rejects_bad_bias():
    q = torch.zeros(4, 256, 64)
    with pytest.raises(ValueError):
        tfa.attn_fwd_bias(q, q, q, torch.zeros(3, 1, 256), 2, 0.125)  # 3 batch rows, BH 4
    with pytest.raises(ValueError):
        tfa.attn_fwd_bias(q, q, q, torch.zeros(2, 7, 256), 2, 0.125)  # rows neither 1 nor Sq
    with pytest.raises(TypeError):
        tfa.attn_fwd_bias(q, q, q, torch.zeros(2, 1, 256, dtype=torch.float64), 2, 0.125)
    with pytest.raises(RuntimeError):
        m = torch.empty(4, 256, 64, device="meta")
        tfa.attn_fwd_bias(m, m, m, torch.empty(2, 1, 256, device="meta"), 2, 0.125)


# ---------------------------------------------------------------- dispatch


def _spy(monkeypatch, names):
    """Replace tango_tpu_torch.ops.attention's kernel wrappers by counting
    pass-throughs; return the list of names called."""
    calls = []
    for name in names:
        fn = getattr(tattn, name)
        monkeypatch.setattr(tattn, name, lambda *a, _n=name, _f=fn, **kw:
                            calls.append(_n) or _f(*a, **kw))
    return calls


@pytest.mark.parametrize("tokens,v2", [(4608, True), (4224, False)])
def test_v2_route_follows_jax_rule(tokens, v2, monkeypatch):
    """4608 tokens (288 latent frames of 16 bins, 11.25 s) are over 4096 and a
    multiple of 512: the blocked-KV kernel. 4224 (264 frames, the latent
    length `generate(duration=10.24)` picks) are over 4096 but not a multiple
    of 512: the static-shift kernel. The same split as JAX's."""
    assert tfa.v2_route(tokens, tokens) == v2
    calls = _spy(monkeypatch, ("attn_fwd", "attn_fwd_v2"))
    rng = np.random.RandomState(9)
    q, k, v = (rng.randn(1, tokens, 16).astype(np.float32) for _ in range(3))
    out = tattn.multi_head_attention(*(torch.from_numpy(a) for a in (q, k, v)), heads=1)
    ref = jattn.multi_head_attention(*(jnp.asarray(a) for a in (q, k, v)), heads=1)
    assert calls == (["attn_fwd_v2"] if v2 else ["attn_fwd"])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=1e-4)


def test_grad_through_biased_route_matches_jax(monkeypatch):
    """Gradients through the bias route (kernel forward, plain backward) equal
    jax.grad through JAX's flash dispatch (Pallas forward in interpret mode,
    XLA backward), as tests/test_flash_attention.py checks for JAX alone."""
    monkeypatch.setattr(jattn, "_flash_available", lambda: True)
    monkeypatch.setattr(jfa, "flash_attention",
                        functools.partial(jfa.flash_attention, interpret=True))
    rng = np.random.RandomState(6)
    q = rng.randn(2, 256, 128).astype(np.float32)
    ctx = rng.randn(2, 256, 128).astype(np.float32)
    bias = _mask_bias(2, 1, 256, 100)

    def jloss(q, ctx):
        out = jattn.multi_head_attention(q, ctx, ctx, heads=2, bias=jnp.asarray(bias))
        return (out**2).sum()

    gq, gc = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(q), jnp.asarray(ctx))

    calls = _spy(monkeypatch, ("biased_flash_attention",))
    tq = torch.from_numpy(q).requires_grad_()
    tc = torch.from_numpy(ctx).requires_grad_()
    out = tattn.multi_head_attention(tq, tc, tc, heads=2, bias=torch.from_numpy(bias))
    (out**2).sum().backward()
    assert calls == ["biased_flash_attention"]
    np.testing.assert_allclose(tq.grad.numpy(), np.asarray(gq), atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(tc.grad.numpy(), np.asarray(gc), atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize("inner,heads", [(48, 2), (256, 1)])
def test_head_dims_the_kernels_lack_go_plain(inner, heads, monkeypatch):
    """D = 24 and D = 256 pass JAX's rule (D % 8 == 0) but no kernel is built
    for them: the dispatch sends them to plain_attention, which equals JAX's
    XLA attention, instead of handing a wrapper a shape it would refuse."""
    calls = _spy(monkeypatch, ("flash_attention", "biased_flash_attention"))
    rng = np.random.RandomState(10)
    q, k, v = (rng.randn(2, 256, inner).astype(np.float32) for _ in range(3))
    out = tattn.multi_head_attention(*(torch.from_numpy(a) for a in (q, k, v)), heads=heads)
    ref = jattn.multi_head_attention(*(jnp.asarray(a) for a in (q, k, v)), heads=heads)
    assert calls == []
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=1e-4)


def test_attention_kernel_limits():
    """The rule both the wrappers (on a card) and the dispatch ask: head dims
    16/32/64/128 only; BH past the old 65535 grid.y cap is fine, a block
    count of 2^31 or more is not."""
    assert tfa.KERNEL_HEAD_DIMS == (8, 16, 32, 64, 128)
    assert tfa.kernel_shape_ok(70000, 64, 64, 32)
    assert tfa.kernel_shape_ok(2 * 5, 8192, 8192, 64)
    assert not tfa.kernel_shape_ok(2, 256, 256, 24)
    assert not tfa.kernel_shape_ok(2**25, 4096, 4096, 64)


def test_group_norm_kernel_limits_agree_with_dispatch():
    """(70, 960, 256, 16), the UNet's two-stage site at 35 prompts, is past the
    old 65535-row cap of gn_apply and now takes the kernels; 2^31 elements and
    more take them too (64-bit offsets); only a dimension of 2^31 or more,
    which the kernels take as 32-bit, sends the call to the plain reference."""
    site = torch.empty(70, 960, 256, 16, device="meta")
    assert not tbasic.gn_single_pass_supported(site, 32)
    assert tbasic.gn_two_stage_supported(site, 32) and tgn.kernel_shape_ok(site, 32)
    vae = torch.empty(256, 128, 1024, 64, device="meta")  # 2^31 elements
    assert vae.numel() == 2**31
    assert tbasic.gn_two_stage_supported(vae, 32) and tgn.gn_bwd_supported(vae, 32)
    long_row = torch.empty(1, 1, 2**31, device="meta")
    assert not tbasic.gn_single_pass_supported(long_row, 1)
    assert not tbasic.gn_two_stage_supported(long_row, 1)
    assert not tgn.gn_bwd_supported(long_row, 1)

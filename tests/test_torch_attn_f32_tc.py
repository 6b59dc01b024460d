"""The f32 tensor-core attention bodies on the CPU: the forward of
csrc/attention_tc.cu (`attn_fwd`, `attn_fwd_v2` and `attn_fwd_bias` in f32
at head dim 64, and `attn_fwd` at AudioLDM's 32) and the gradient products
of csrc/attention_bwd_tc.cu, both on 3xTF32 products.

The CUDA bodies run only on the card (`chip_smoke.py` holds them against the
plain versions and float64 there). Here: `fwd_walk`, a plain-torch emulation
of the forward body (64-key tiles, q prescaled in f32, both products S = Qs
K^T and P V as 3xTF32 with round-to-nearest-away splits, the static shift or
the running max, f32 denominators), held to JAX's f32 forward limits (atol
2e-5, rtol 1e-4, tests/test_flash_attention.py) against
`flash_attention(interpret=True)` and, in its online form,
`flash_attention_v2(interpret=True)` at unit amplitude, JAX's extreme-logit
case, and against float64 with q and k at amplitude 3 (the static form at
head dims 64 and 32); in its biased form
(bias * log2 e added to the 3xTF32 logits before the running max) against
`flash_attention(bias=..., interpret=True)` with one bias row and a row a
query at ragged Sq and Skv, with a fully masked batch row, and against
float64 at amplitude 3 at the long prompt's shapes; two tests
that pin why both products take 3xTF32 (one-product TF32 misses the limits
at unit amplitude, split-bf16 P V at amplitude 3); and the backward's
3xTF32 gradient products (tests/test_torch_attn_bwd_tc.py's `bwd_walk`)
within 1.1x of exact f32 gradient products against float64 at amplitude 3,
where split bf16 took most of the margin.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tango_tpu.ops.flash_attention as jfa
from tango_tpu_torch.ops import flash_attention as tfa
from tests.test_torch_attn_bwd_tc import _inputs, _ratio, _worst_ratio, product
from tests.test_torch_ops_long import _extreme_qk

# One intra-op thread: pytest-xdist workers share the cores, and torch's
# pool of one thread per core then spends most of its time waiting.
torch.set_num_threads(1)

FWD_TOL = (2e-5, 1e-4)  # JAX's f32 forward limits
TILE = {64: 64, 32: 32}  # keys a K/V tile of the f32 forward body, by head dim


def fwd_walk(q, k, v, scale, logit="3xtf32", pv="3xtf32", online=False, bias=None, heads=1,
             tile=None):
    """The f32 forward body's arithmetic on (BH, S, D) f32 tensors: qs = q *
    qscale in f32, `tile`-key tiles (the body's, TILE[D], unless given: 64 at
    head dim 64, 32 at 32; the last one ragged), s = qs . k and acc +=
    p . v under the given product schemes (`product`: "3xtf32", "tf32",
    "split_bf16", "f32"), denominators of the f32 p. Static form: p =
    exp2(min(s - 20, 96)), a zero row where the denominator underflows.
    Online form (`attn_fwd_v2`): the running max m' = max(m, max s) from m =
    -1e30, acc and the denominators rescaled by exp2(m - m') before the
    tile's P V, p = exp2(s - m'), o = acc / denominator. Biased form
    (`attn_fwd_bias`, with `bias` (B, 1 | Sq, Skv) f32, head bh adding batch
    row bh // heads): s += (bias - c) * log2 e, c the row's largest bias,
    then the online form."""
    online = online or bias is not None
    if bias is not None:
        bias = bias.repeat_interleave(heads, 0)
        bias = (bias - bias.amax(-1, keepdim=True)) * torch.tensor(np.float32(tfa.LOG2_E))
    qs = q * tfa._qscale(scale)
    bh, sq, d = q.shape
    tile = tile or TILE[d]
    den = torch.zeros(bh, sq, 1)
    acc = torch.zeros(bh, sq, d)
    m = torch.full((bh, sq, 1), -1e30)
    for k0 in range(0, k.shape[1], tile):
        s = product(qs, k[:, k0:k0 + tile].transpose(-1, -2), logit)
        if bias is not None:
            s = s + bias[..., k0:k0 + tile]
        if online:
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.exp2(m - m_new)
            den, acc, m = alpha * den, alpha * acc, m_new
            p = torch.exp2(s - m)
        else:
            p = torch.exp2(torch.clamp(s - tfa.SOFTMAX_SHIFT, max=tfa.SOFTMAX_CLAMP))
        den = den + p.sum(-1, keepdim=True)
        acc = acc + product(p, v[:, k0:k0 + tile], pv)
    if online:
        return acc / den
    return acc / torch.where(den == 0.0, torch.ones_like(den), den)


def _float64_fwd(q, k, v, scale, bias=None, heads=1):
    q, k, v = (t.double() for t in (q, k, v))
    logits = q @ k.transpose(-1, -2) * scale
    if bias is not None:
        logits = logits + bias.double().repeat_interleave(heads, 0)
    return torch.softmax(logits, -1) @ v


def _fwd_ratio(tensors, logit="3xtf32", pv="3xtf32", online=False):
    """The walk's worst share of JAX's forward limits against float64."""
    q, k, v = tensors[:3]
    return _ratio(fwd_walk(q, k, v, 0.125, logit, pv, online).numpy(),
                  _float64_fwd(q, k, v, 0.125).numpy(), FWD_TOL)


@pytest.mark.parametrize("b,h,sq,skv,d", [(1, 2, 256, 256, 64), (2, 1, 256, 333, 64),
                                          (1, 2, 256, 256, 32), (2, 1, 256, 333, 32),
                                          (1, 4, 256, 1024, 32)])
def test_fwd_walk_matches_pallas(b, h, sq, skv, d):
    """The 3xTF32 walk within JAX's f32 limits of `_attn_kernel` in interpret
    mode, at unit amplitude (333 keys: a ragged last tile of 13 at head dim
    64, 64-key tiles; at AudioLDM's 32, 32-key tiles, of 13 too), at scale
    d^-0.5 (1024 keys: the FiLM UNet's ds = 2 level)."""
    arrays, tensors = _inputs(b, h, sq, skv, 1.0, 41, d=d)
    q, k, v = arrays[:3]
    scale = d**-0.5
    ref = np.asarray(jfa.flash_attention(q, k, v, scale=scale, interpret=True), np.float32)
    out = fwd_walk(*tensors[:3], scale).numpy().reshape(ref.shape)
    np.testing.assert_allclose(out, ref, atol=FWD_TOL[0], rtol=FWD_TOL[1])


@pytest.mark.parametrize("d", [64, 32])
def test_fwd_walk_matches_plain_version_ragged(d):
    """The walk against the port's plain attn_fwd, which the card holds the
    body against, at the smoke's ragged shape (200 queries, 333 keys) and
    limits (2e-5 / 1e-4), at head dims 64 and 32."""
    _, (q, k, v, _) = _inputs(1, 3, 200, 333, 1.0, 42, d=d)
    np.testing.assert_allclose(fwd_walk(q, k, v, d**-0.5).numpy(),
                               tfa.attn_fwd_plain(q, k, v, d**-0.5).numpy(),
                               atol=FWD_TOL[0], rtol=FWD_TOL[1])


@pytest.mark.parametrize("seed,d", [(27, 64), (41, 64), (27, 32), (41, 32)])
def test_fwd_walk_within_f32_limits_at_amplitude_3(seed, d):
    """With q and k at amplitude 3 (base-2 logits up to ~60) the walk stays
    within JAX's f32 limits against float64 (10 heads of 1024), at head dim
    64 as close as the plain f32 version, and at AudioLDM's 32 (scale
    d^-0.5, so the logits' spread is the same) within the limits. The plain
    version's own share there swings with the draw (0.30 at seed 27, 0.33 at
    41; 0.47-0.99 at head dim 64), and the walk reads 0.48 and 0.33, below
    its 0.47-0.59 at head dim 64."""
    _, tensors = _inputs(1, 10, 1024, 1024, 3.0, seed, d=d)
    q, k, v = tensors[:3]
    scale = d**-0.5
    exact = _float64_fwd(q, k, v, scale).numpy()
    walk = _ratio(fwd_walk(q, k, v, scale).numpy(), exact, FWD_TOL)
    plain = _ratio(tfa.attn_fwd_plain(q, k, v, scale).numpy(), exact, FWD_TOL)
    assert walk < 1.0, (walk, plain)
    if d == 64:
        assert walk < 1.5 * plain, (walk, plain)


@pytest.mark.parametrize("b,h,sq,skv", [(1, 2, 128, 4608), (2, 1, 128, 4200)])
def test_online_walk_matches_pallas_v2(b, h, sq, skv):
    """The online 3xTF32 walk (`attn_fwd_v2`'s f32 body) within JAX's f32
    limits of `_attn_kernel_v2` in interpret mode at unit amplitude: 4608
    keys take the v2 route (over 4096, a multiple of 512), 4200 keys end in a
    ragged tile of 40 (JAX takes them as one block)."""
    arrays, tensors = _inputs(b, h, sq, skv, 1.0, 44)
    q, k, v = arrays[:3]
    ref = np.asarray(jfa.flash_attention_v2(q, k, v, scale=0.125, interpret=True), np.float32)
    out = fwd_walk(*tensors[:3], 0.125, online=True).numpy().reshape(ref.shape)
    np.testing.assert_allclose(out, ref, atol=FWD_TOL[0], rtol=FWD_TOL[1])
    assert tfa.v2_route(sq, 4608) and not tfa.v2_route(sq, 4200)


def test_online_walk_matches_pallas_v2_at_extreme_logits():
    """JAX's extreme-logit case (row maxes near natural +100, past the static
    shift's window; tests/test_flash_attention.py): the online walk stays
    within the JAX test's limits (5e-5 / 1e-3) of `flash_attention_v2`."""
    q, k, v = _extreme_qk(380.0, 0)
    ref = np.asarray(jfa.flash_attention_v2(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                            scale=0.125, block_q=128, block_kv=128,
                                            interpret=True))
    out = fwd_walk(*(torch.from_numpy(a[0]) for a in (q, k, v)), 0.125, online=True)
    assert np.all(np.isfinite(out.numpy()))
    np.testing.assert_allclose(out.numpy()[None], ref, atol=5e-5, rtol=1e-3)


@pytest.mark.parametrize("seed", [27, 41])
def test_online_walk_within_f32_limits_at_amplitude_3(seed):
    """With q and k at amplitude 3 the online walk stays within JAX's f32
    limits against float64 (4 heads, 256 queries over 4608 keys), as close
    as the plain f32 version of attn_fwd_v2."""
    _, tensors = _inputs(1, 4, 256, 4608, 3.0, seed)
    walk = _fwd_ratio(tensors, online=True)
    q, k, v = tensors[:3]
    plain = _ratio(tfa.attn_fwd_v2_plain(q, k, v, 0.125).numpy(),
                   _float64_fwd(q, k, v, 0.125).numpy(), FWD_TOL)
    assert walk < 1.0 and walk < 1.5 * plain, (walk, plain)


def test_one_product_tf32_forward_misses_f32_limits():
    """One TF32 product each (operands rounded to 10 mantissa bits) misses
    JAX's f32 forward limits against float64 already at unit amplitude
    (several times over); 3xTF32 meets them with a wide margin on the same
    inputs."""
    _, tensors = _inputs(1, 2, 512, 512, 1.0, 43)
    assert _fwd_ratio(tensors, "tf32", "tf32") > 2.0
    assert _fwd_ratio(tensors) < 0.1


def test_split_bf16_pv_misses_f32_limits_at_amplitude_3():
    """3xTF32 logits with a split-bf16 P V product (hi + lo keep p and v to
    ~2^-17) miss JAX's f32 forward limits against float64 with q and k at
    amplitude 3 (10 heads of 1024, seed 27); 3xTF32 on both products meets
    them on the same inputs."""
    _, tensors = _inputs(1, 10, 1024, 1024, 3.0, 27)
    assert _fwd_ratio(tensors, "3xtf32", "split_bf16") > 1.0
    assert _fwd_ratio(tensors) < 1.0


@pytest.mark.parametrize("seed", [27, 28, 29])
def test_3xtf32_gradients_match_f32_gradients_at_amplitude_3(seed):
    """The backward body's 3xTF32 gradient products (with its 3xTF32 logits
    and tile walks) are within 1.1x of exact f32 gradient products against
    float64 with q and k at amplitude 3 (512 tokens), where split-bf16
    gradient products read more than 1.5x (tests/test_torch_attn_bwd_tc.py)."""
    _, tensors = _inputs(1, 2, 512, 512, 3.0, seed)
    tf32x3 = _worst_ratio("3xtf32", "3xtf32", tensors)
    assert tf32x3 <= 1.1 * _worst_ratio("3xtf32", "f32", tensors)
    assert tf32x3 < 0.5


# ----------------------------------------------------- the biased form (f32)

def _padding_bias(b, rows, skv, keep, seed, noise=True):
    """A bias (B, rows, Skv) f32: the reference's padding mask (0 for the
    first keep[i] keys of batch row i, -10000 after), plus unit noise where
    `noise`, so that the max moves from tile to tile."""
    bias = np.where(np.arange(skv)[None, None, :] < np.asarray(keep)[:, None, None], 0.0,
                    -10000.0)
    bias = np.broadcast_to(bias, (b, rows, skv))
    if noise:
        bias = bias + np.random.RandomState(seed).randn(b, rows, skv)
    return np.ascontiguousarray(bias, np.float32)


def _pallas_bias(arrays, bias):
    q, k, v = arrays[:3]
    return np.asarray(jfa.flash_attention(q, k, v, bias=jnp.asarray(bias)[:, None], scale=0.125,
                                          interpret=True), np.float32)


BIAS_CASES = {
    "one_row": (2, 2, 256, 256, 1, (200, 150)),
    "ragged": (2, 2, 200, 333, 1, (300, 20)),
    "ragged_sq_rows": (2, 1, 200, 333, 200, (333, 90)),
}


@pytest.mark.parametrize("case", sorted(BIAS_CASES))
def test_bias_walk_matches_pallas(case):
    """The biased 3xTF32 walk (`attn_fwd_bias`'s f32 body) within JAX's f32
    limits of `_attn_kernel_bias` in interpret mode at unit amplitude: one
    bias row and a row a query, ragged Sq and Skv (333 keys: a last tile of
    13)."""
    b, h, sq, skv, rows, keep = BIAS_CASES[case]
    arrays, tensors = _inputs(b, h, sq, skv, 1.0, 45)
    bias = _padding_bias(b, rows, skv, keep, 46)
    ref = _pallas_bias(arrays, bias)
    out = fwd_walk(*tensors[:3], 0.125, bias=torch.from_numpy(bias), heads=h)
    np.testing.assert_allclose(out.numpy().reshape(ref.shape), ref, atol=FWD_TOL[0],
                               rtol=FWD_TOL[1])


def test_bias_walk_with_a_fully_masked_batch_row():
    """A batch row whose keys are all masked (bias -10000 on every key)
    stays finite, as JAX's: JAX's base-2 logits sit near -14427, where an
    f32 keeps 2^-10 of absolute precision, so its p carries up to ~7e-4 of
    relative rounding (the walk's, shifted by the row's largest bias, none);
    atol 1e-3 on that row (chip_smoke.py's), JAX's f32 limits on the
    other."""
    arrays, tensors = _inputs(2, 2, 256, 256, 1.0, 47)
    bias = _padding_bias(2, 1, 256, (100, 0), 48, noise=False)
    ref = _pallas_bias(arrays, bias)
    out = fwd_walk(*tensors[:3], 0.125, bias=torch.from_numpy(bias), heads=2)
    out = out.numpy().reshape(ref.shape)
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out[0], ref[0], atol=FWD_TOL[0], rtol=FWD_TOL[1])
    np.testing.assert_allclose(out[1], ref[1], atol=1e-3, rtol=0.0)


@pytest.mark.parametrize("seed", [27, 41])
def test_bias_walk_within_f32_limits_at_amplitude_3(seed):
    """With q and k at amplitude 3 the biased walk stays within JAX's f32
    limits against float64 at the long prompt's shape at the UNet's first
    level, cut to 4 heads of 1024 queries (256 keys, one padding-mask row a
    batch row, 40 and 7 open keys), as close as the plain f32 version."""
    _, (q, k, v, _) = _inputs(2, 2, 1024, 256, 3.0, seed)
    bias = torch.from_numpy(_padding_bias(2, 1, 256, (40, 7), seed, noise=False))
    exact = _float64_fwd(q, k, v, 0.125, bias, 2).numpy()
    walk = _ratio(fwd_walk(q, k, v, 0.125, bias=bias, heads=2).numpy(), exact, FWD_TOL)
    plain = _ratio(tfa.attn_fwd_bias_plain(q, k, v, bias, 2, 0.125).numpy(), exact, FWD_TOL)
    assert walk < 1.0 and walk < 1.5 * plain, (walk, plain)

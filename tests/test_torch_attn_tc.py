"""The tensor-core attention body (csrc/attention_tc.cu) on the CPU.

The CUDA body itself runs only on the card (`chip_smoke.py` holds it against
the plain versions there). Here: the rule that picks it (`tc_body`, per
form: head dim 64 in every form, 32 in the static one; the biased form's and
the f32 body's own tests are tests/test_torch_attn_bias_tc.py and
tests/test_torch_attn_f32_tc.py), the attention head dims of the full-width
UNet and of AudioLDM's FiLM UNet, the wrappers' alignment check and counters
for it, the f32 prescale, and a plain-torch emulation of its key-tile walk
in bf16 (128-key tiles, p rounded to bf16 against the running max of the
tiles so far, f32 denominators of the unrounded p) against JAX's
`flash_attention_v2` and `flash_attention` in interpret mode on the same
numpy inputs, the static form at head dims 64 and 32: within one bf16 step
of the output, the bound the CUDA source's note states for its tile walk.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tango_tpu.ops.flash_attention as jfa
from tango_tpu_torch import configs
from tango_tpu_torch import ops
from tango_tpu_torch.models.audioldm_unet import AUDIOLDM_S_UNET, FilmUNet
from tango_tpu_torch.models.unet import Attention
from tango_tpu_torch.ops import flash_attention as tfa
from tests._torch_helpers import fake_kernel_library

# One intra-op thread: pytest-xdist workers share the cores, and torch's
# pool of one thread per core then spends most of its time waiting.
torch.set_num_threads(1)

TILE = 128  # keys a K/V tile of the tensor-core body


def _unet_head_dims(cfg):
    """Head dims of every attention of a UNet config: channels / heads."""
    return {ch // cfg.heads_for_level(i) for i, ch in enumerate(cfg.block_out_channels)}


@pytest.mark.parametrize("d", tfa.KERNEL_HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_tc_body_rule(dtype, d):
    """The forward rule by form, in bf16 and in f32 (held to JAX's f32 limits
    by 3xTF32): head dim 64 takes a tensor-core body in every form, head dim
    32 in the static form (attn_fwd) alone; every other head dim, and 32 in
    the online and biased forms, the CUDA-core one; a type the kernels do not
    take has no tensor-core body in any form."""
    assert tfa.tc_body(dtype, d, "static") == (d in (32, 64))
    assert tfa.tc_body(dtype, d, "online") == (d == 64)
    assert tfa.tc_body(dtype, d, "bias") == (d == 64)
    assert not any(tfa.tc_body(torch.float16, d, form) for form in tfa.FORMS)


def test_tc_body_names_a_form():
    """The rule takes the three forms of tt::AttnMode by name, and nothing
    else; each forward wrapper carries its own."""
    assert tfa.FORMS == ("static", "online", "bias")
    with pytest.raises(ValueError, match="form"):
        tfa.tc_body(torch.bfloat16, 64, "dynamic")
    assert [f.form for f in (tfa.attn_fwd, tfa.attn_fwd_v2, tfa.attn_fwd_bias)] == list(tfa.FORMS)


def test_tc_body_takes_every_full_width_unet_attention():
    """Every attention of the full-width UNet (heads 5, 10, 20 over 320, 640,
    1280 channels) has head dim 64: all of them take a tensor-core body, in
    bf16 and in f32 (the trainer's static form, clips over 10.24 s in the
    online form, long prompts in the biased form)."""
    dims = _unet_head_dims(configs.TANGO_UNET)
    assert dims == {64}
    assert all(tfa.tc_body(dt, d, form) for d in dims for dt in (torch.bfloat16, torch.float32)
               for form in tfa.FORMS)


def test_tc_body_takes_every_audioldm_attention():
    """Every attention of AudioLDM-S's FiLM UNet (AUDIOLDM_S_UNET, built on
    the meta device: heads of num_head_channels = 32 at the three attention
    levels, 256, 384 and 640 channels; 16 transformers of two attentions) has
    head dim 32, and all of them take
    attn_fwd's tensor-core body (the static form, the one the path launches)
    in f32, the type AudioLDM serves in, and in bf16."""
    with torch.device("meta"):
        unet = FilmUNet(AUDIOLDM_S_UNET)
    attns = [m for m in unet.modules() if isinstance(m, Attention)]
    dims = {m.to_out_0.in_features // m.heads for m in attns}
    assert len(attns) == 32 and dims == {AUDIOLDM_S_UNET.num_head_channels} == {32}
    assert all(tfa.tc_body(dt, d, "static") for d in dims
               for dt in (torch.float32, torch.bfloat16))


def _misaligned(shape, dtype=torch.bfloat16):
    """A contiguous view whose data starts one element (2 bytes) past a
    16-byte boundary."""
    base = torch.zeros(int(np.prod(shape)) + 1, dtype=dtype)
    view = base[1:].view(*shape)
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    return view


def test_check_tc_aligned():
    ok = torch.zeros(2, 128, 64, dtype=torch.bfloat16)
    tfa.check_tc_aligned("attn_fwd", ok, ok, ok, ok)
    with pytest.raises(ValueError, match="16-byte"):
        tfa.check_tc_aligned("attn_fwd", ok, _misaligned((2, 128, 64)), ok, ok)


@pytest.mark.parametrize("fn", [tfa.attn_fwd, tfa.attn_fwd_v2])
def test_launch_checks_alignment_and_counts_tc(fn, monkeypatch):
    """The wrappers' launch path (with the C library replaced by a recorder
    that reports the body a C entry point would launch): a misaligned view
    at a tensor-core head dim (64; and 32 for attn_fwd, AudioLDM's) raises
    before any launch in bf16 and in f32 (the 3xTF32 bodies; attn_fwd_bias's
    own test is in tests/test_torch_attn_bias_tc.py); an aligned one
    launches and counts the reported tensor-core launch; a CUDA-core head
    dim (16 for attn_fwd, 32 for attn_fwd_v2) launches with no alignment
    demand and no tc count; reset_counters zeroes tc_launches."""
    tc_dims = (64, 32) if fn is tfa.attn_fwd else (64,)
    tc_cases = [(d, dt) for d in tc_dims for dt in (torch.bfloat16, torch.float32)]
    core_d = 16 if fn is tfa.attn_fwd else 32
    core = [_misaligned((2, 128, core_d)), _misaligned((2, 128, core_d), torch.float32)]
    assert all(tfa.tc_body(dt, d, fn.form) for d, dt in tc_cases)
    assert not tfa.tc_body(torch.float32, core_d, fn.form)
    calls = fake_kernel_library(monkeypatch, [ops.TC_LAUNCHED] * len(tc_cases) + [0] * len(core))
    ops.reset_counters()
    for d, dt in tc_cases:
        good = torch.zeros(2, 128, d, dtype=dt)
        with pytest.raises(ValueError, match="16-byte"):
            tfa._launch_fwd(fn, _misaligned((2, 128, d), dt), good, good, 0.125)
        with pytest.raises(ValueError, match="16-byte"):
            tfa._launch_fwd(fn, good, good, _misaligned((2, 128, d), dt), 0.125)
    assert calls == [] and fn.tc_launches == 0
    for d, dt in tc_cases:
        good = torch.zeros(2, 128, d, dtype=dt)
        tfa._launch_fwd(fn, good, good, good, 0.125)
    n = len(tc_cases)
    assert fn.launches == n and fn.tc_launches == n
    for t in core:
        tfa._launch_fwd(fn, t, t, t, 0.125)
    assert fn.launches == n + len(core) and fn.tc_launches == n
    assert calls == [f"tt_{fn.__name__}"] * (n + len(core))
    ops.reset_counters()
    assert fn.launches == 0 and fn.tc_launches == 0


@pytest.mark.parametrize("d", sorted({8, 16, 24, 32, 40, 64, 80, 128, 160}))
def test_qscale_rounds_as_a_float32_tensor(d):
    """The prescale scale*log2(e), rounded to f32 by numpy, equals the f32
    tensor rounding it replaced, for the UNet's head dim 64 and others."""
    scale = d**-0.5
    assert tfa._qscale(scale) == float(torch.tensor(scale * tfa.LOG2_E, dtype=torch.float32))


# ------------------------------------------------ the key-tile walk in bf16


def _bf16(x):
    return x.to(torch.bfloat16).float()


def tc_walk(q, k, v, scale, online):
    """The tensor-core body's arithmetic on (BH, S, D) f32 tensors that hold
    bf16 values: 128-key tiles, f32 logits, p rounded to bf16 for the PV
    product, f32 denominators of the unrounded p; the static form with its
    fixed shift, the online form with the running max of the tiles so far."""
    qs = _bf16(q * tfa._qscale(scale))
    bh, sq, d = q.shape
    m = torch.full((bh, sq, 1), -1e30)
    den = torch.zeros(bh, sq, 1)
    acc = torch.zeros(bh, sq, d)
    for k0 in range(0, k.shape[1], TILE):
        s = torch.matmul(qs, k[:, k0:k0 + TILE].transpose(-1, -2))
        if online:
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(s - m_new)
            den = alpha * den + p.sum(-1, keepdim=True)
            acc = alpha * acc + torch.matmul(_bf16(p), v[:, k0:k0 + TILE])
            m = m_new
        else:
            p = torch.exp2(torch.clamp(s - tfa.SOFTMAX_SHIFT, max=tfa.SOFTMAX_CLAMP))
            den = den + p.sum(-1, keepdim=True)
            acc = acc + torch.matmul(_bf16(p), v[:, k0:k0 + TILE])
    if not online:
        den = torch.where(den == 0.0, torch.ones_like(den), den)
    return _bf16(acc / den)


def _bf16_inputs(b, h, sq, skv, seed, d=64):
    """numpy q, k, v (B, H, S, d) rounded to bf16, as JAX bf16 arrays and as
    (B*H, S, d) f32 torch tensors holding the same values."""
    rng = np.random.RandomState(seed)
    arrays = [jnp.asarray(rng.randn(b, h, s, d).astype(np.float32), jnp.bfloat16)
              for s in (sq, skv, skv)]
    flat = [torch.from_numpy(np.asarray(a, np.float32).reshape(b * h, a.shape[2], d))
            for a in arrays]
    return arrays, flat


def _one_bf16_step(ref):
    """The spacing of bf16 values at the output's largest magnitude."""
    return 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)


def _assert_within_one_step(out, ref):
    step = _one_bf16_step(ref)
    err = np.abs(out - ref).max()
    assert err <= step, f"max abs error {err} > one bf16 step {step}"


@pytest.mark.parametrize("b,h,sq,skv", [(1, 2, 256, 1024), (1, 1, 128, 2048)])
def test_tc_walk_online_matches_pallas_v2(b, h, sq, skv):
    """JAX's blocked-KV kernel takes the max over 1024-key blocks, the walk
    over 128-key tiles: bf16 p is rounded against different maxes, and the
    outputs stay within one bf16 step."""
    (qj, kj, vj), (q, k, v) = _bf16_inputs(b, h, sq, skv, 11)
    ref = np.asarray(jfa.flash_attention_v2(qj, kj, vj, scale=0.125, block_q=128,
                                            block_kv=1024, interpret=True), np.float32)
    out = tc_walk(q, k, v, 0.125, online=True).numpy().reshape(ref.shape)
    _assert_within_one_step(out, ref)


@pytest.mark.parametrize("b,h,sq,skv,d", [(1, 2, 256, 384, 64), (2, 1, 256, 333, 64),
                                          (1, 2, 256, 384, 32), (2, 1, 256, 333, 32),
                                          (1, 4, 256, 1024, 32)])
def test_tc_walk_static_matches_pallas(b, h, sq, skv, d):
    """JAX's static-shift kernel sums over the whole key set at once, the
    walk over 128-key tiles (333 keys: a ragged last tile of 77): with a
    fixed shift that changes only the f32 summation order. At head dim 64
    and at AudioLDM's 32 (scale 32^-0.5, over up to 1024 keys, the FiLM
    UNet's ds = 2 level)."""
    (qj, kj, vj), (q, k, v) = _bf16_inputs(b, h, sq, skv, 12, d)
    scale = 0.125 if d == 64 else d**-0.5
    ref = np.asarray(jfa.flash_attention(qj, kj, vj, scale=scale, interpret=True), np.float32)
    out = tc_walk(q, k, v, scale, online=False).numpy().reshape(ref.shape)
    _assert_within_one_step(out, ref)


@pytest.mark.parametrize("online,d", [(False, 64), (True, 64), (False, 32)])
def test_tc_walk_matches_plain_versions(online, d):
    """The walk against the port's plain versions in bf16, which the card
    holds the tensor-core body against (atol 4e-3, rtol 1e-2): within one
    bf16 step, at a ragged key count (the smoke's ragged shape; at head dim
    32 the static form alone has the tensor-core body)."""
    _, (q, k, v) = _bf16_inputs(1, 2, 200, 333, 13, d)
    plain = tfa.attn_fwd_v2_plain if online else tfa.attn_fwd_plain
    scale = d**-0.5
    ref = plain(*(t.to(torch.bfloat16) for t in (q, k, v)), scale).float().numpy()
    out = tc_walk(q, k, v, scale, online).numpy()
    _assert_within_one_step(out, ref)

"""Multi-head attention core with additive bias (port of tango_tpu/ops/attention.py).

Semantics: scale = dim_head ** -0.5; an optional additive f32 bias of shape
(B, Skv), (B, 1, Skv) or (B, Sq, Skv), broadcast over heads; with `upcast`
the logits and softmax are f32.

Dispatch keeps the JAX eligibility rule (tango_tpu/ops/attention.py:55-65):
Sq >= 256, D % 8 == 0, and no bias or Skv >= 256; the port adds the
kernels' own limits (`kernel_shape_ok`: D in {8, 16, 32, 64, 128}, the grid's
32-bit block count), so that a wrapper is never handed a shape it raises on.
An eligible call goes through an autograd Function, as `_flash_with_vjp` of
tango_tpu/ops/attention.py:82-119:
  * bias-free: the forward is `attn_fwd_v2` where JAX takes
    `flash_attention_v2` (`v2_route`: Skv > 4096, Skv % 512 == 0,
    Sq % 128 == 0), else `attn_fwd`; it saves q, k and v only, and its
    backward runs the `attn_bwd_dq` and `attn_bwd_dkv` kernels where
    `flash_bwd_supported` holds, else autograd through `plain_attention`, as
    JAX falls back to the XLA VJP;
  * biased (a padded text context of 256 tokens or more): the forward is
    `attn_fwd_bias`, and the backward is autograd through `plain_attention`
    with the bias, with no gradient for the bias, as JAX's `_flash_bwd` sends
    every biased call to the XLA VJP.
Everything else is `plain_attention`, as it is XLA in JAX: cross-attention to
128 text tokens and the 64-token mid level.

Under sequence parallelism a rank's queries are one slab of the tokens and
k, v hold every token: the rule reads the whole sequence's query count
(`global_queries`), as JAX's rule sees the unsharded shape, and `v2_route`
the slab's queries against every key.
"""

from __future__ import annotations

import torch

from tango_tpu_torch.ops.flash_attention import (
    attn_fwd,
    attn_fwd_bias,
    attn_fwd_v2,
    flash_attention_bwd,
    flash_bwd_supported,
    kernel_shape_ok,
    v2_route,
)


def multi_head_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    heads: int,
    bias: torch.Tensor | None = None,
    upcast: bool = True,
    global_queries: int | None = None,
) -> torch.Tensor:
    """Attention over flat (B, S, heads*D) projections -> (B, Sq, heads*D).
    `global_queries`: the query count of the whole sequence where q is a
    slab of it (sequence parallelism), for the dispatch rule."""
    b, sq, inner = q.shape
    skv = k.shape[1]
    d = inner // heads
    scale = d**-0.5

    if bias is not None:
        if bias.dim() == 2:  # (B, Skv)
            bias = bias[:, None, None, :]
        elif bias.dim() == 3:  # (B, 1|Sq, Skv)
            bias = bias[:, None, :, :]
        bias = bias.float()

    use_flash = ((global_queries or sq) >= 256 and d % 8 == 0 and (bias is None or skv >= 256)
                 and kernel_shape_ok(b * heads, sq, skv, d))

    qh = q.reshape(b, sq, heads, d).transpose(1, 2)
    kh = k.reshape(b, skv, heads, d).transpose(1, 2)
    vh = v.reshape(b, skv, heads, d).transpose(1, 2)
    if use_flash and bias is None:
        out = flash_attention(qh, kh, vh, scale=scale)
    elif use_flash:
        out = biased_flash_attention(qh, kh, vh, bias, scale=scale)
    else:
        out = plain_attention(qh, kh, vh, bias=bias, scale=scale, upcast=upcast)
    return out.transpose(1, 2).reshape(b, sq, inner)


class _FlashWithVJP(torch.autograd.Function):
    """The attention kernels with their backward (heads flattened to BH)."""

    @staticmethod
    def forward(ctx, qh, kh, vh, scale):
        b, h, sq, d = qh.shape
        q, k, v = (t.reshape(b * h, t.shape[2], d).contiguous() for t in (qh, kh, vh))
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        fwd = attn_fwd_v2 if v2_route(sq, k.shape[1]) else attn_fwd
        return fwd(q, k, v, scale).reshape(b, h, sq, d)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        bh, sq, d = q.shape
        skv = k.shape[1]
        shape4 = g.shape[:2]
        # the incoming gradient is a view of a transpose: make it contiguous
        do = g.reshape(bh, sq, d).to(q.dtype).contiguous()
        if flash_bwd_supported(sq, skv, d):
            dq, dk, dv = flash_attention_bwd(q, k, v, do, ctx.scale)
        else:
            with torch.enable_grad():
                qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
                out = plain_attention(qq, kk, vv, bias=None, scale=ctx.scale, upcast=True)
                dq, dk, dv = torch.autograd.grad(out, (qq, kk, vv), do)
        return (dq.reshape(*shape4, sq, d), dk.reshape(*shape4, skv, d),
                dv.reshape(*shape4, skv, d), None)


def flash_attention(qh: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor, *, scale: float):
    """q (B, H, Sq, D), k/v (B, H, Skv, D) -> (B, H, Sq, D), bias-free, through
    the attention kernels forward and backward."""
    return _FlashWithVJP.apply(qh, kh, vh, scale)


class _BiasedFlash(torch.autograd.Function):
    """attn_fwd_bias forward; plain autograd backward with the bias (no bias
    gradient), as `_flash_bwd` of tango_tpu/ops/attention.py:96-116."""

    @staticmethod
    def forward(ctx, qh, kh, vh, bias, scale):
        b, h, sq, d = qh.shape
        q, k, v = (t.reshape(b * h, t.shape[2], d).contiguous() for t in (qh, kh, vh))
        # (B, 1, 1|Sq, Skv) -> (B, 1|Sq, Skv), one row set a batch row
        bias3 = bias[:, 0].expand(b, -1, -1).contiguous()
        ctx.save_for_backward(qh, kh, vh, bias)
        ctx.scale = scale
        return attn_fwd_bias(q, k, v, bias3, h, scale).reshape(b, h, sq, d)

    @staticmethod
    def backward(ctx, g):
        qh, kh, vh, bias = ctx.saved_tensors
        with torch.enable_grad():
            qq, kk, vv = (t.detach().requires_grad_() for t in (qh, kh, vh))
            out = plain_attention(qq, kk, vv, bias=bias, scale=ctx.scale, upcast=True)
            dq, dk, dv = torch.autograd.grad(out, (qq, kk, vv), g)
        return dq, dk, dv, None, None


def biased_flash_attention(qh, kh, vh, bias, *, scale: float):
    """q (B, H, Sq, D), k/v (B, H, Skv, D), bias (B, 1, 1|Sq, Skv) f32 ->
    (B, H, Sq, D) through the attn_fwd_bias kernel."""
    return _BiasedFlash.apply(qh, kh, vh, bias, scale)


def plain_attention(qh, kh, vh, *, bias, scale, upcast):
    """Max-subtracted softmax attention (`_xla_attention`, attention.py:122-129)."""
    acc_t = torch.float32 if upcast else qh.dtype
    logits = torch.matmul(qh.to(acc_t), kh.to(acc_t).transpose(-1, -2)) * scale
    if bias is not None:
        logits = logits + bias
    probs = torch.softmax(logits.float(), dim=-1).to(qh.dtype)
    return torch.matmul(probs.to(acc_t), vh.to(acc_t)).to(qh.dtype)

"""Bias-free attention kernel (`attn_fwd`, csrc/attention.cu) and its plain version.

Replaces `_attn_kernel` (tango_tpu/ops/flash_attention.py:56), the static-shift
exp2 softmax with deferred division: q is prescaled by scale*log2(e) and
rounded to the storage type, p = exp2(min(l - 20, 96)), the PV product takes
p rounded to the storage type, and a row whose denominator underflows to 0 is
a zero row, never NaN. The exactness window and its edges are documented in
the JAX file. Bound on the H100: operations (see the CUDA file's note).

Layout: q (BH, Sq, D), k and v (BH, Skv, D), contiguous, f32 or bf16;
D in {16, 32, 64, 128}. The wrapper launches the kernel for CUDA tensors and
runs the plain version for CPU tensors; any other device raises.
"""

from __future__ import annotations

import torch

from tango_tpu_torch.ops import _build, kernel_wrapper

LOG2_E = 1.4426950408889634
SOFTMAX_SHIFT = 20.0
SOFTMAX_CLAMP = 96.0
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128)


def attn_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float):
    """Plain version of attn_fwd: the same static-shift softmax, in f32."""
    qs = (q.float() * torch.tensor(scale * LOG2_E, dtype=torch.float32)).to(q.dtype)
    logits = torch.matmul(qs.float(), k.float().transpose(-1, -2))
    p = torch.exp2(torch.clamp(logits - SOFTMAX_SHIFT, max=SOFTMAX_CLAMP))
    denom = p.sum(-1, keepdim=True)
    acc = torch.matmul(p.to(v.dtype).float(), v.float())
    return (acc / torch.where(denom == 0.0, torch.ones_like(denom), denom)).to(q.dtype)


@kernel_wrapper("tango_tpu_torch/csrc/attention.cu", "tango_tpu/ops/flash_attention.py:56")
def attn_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float):
    """softmax(q k^T * scale) v over (BH, S, D) heads, static-shift form."""
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("attn_fwd: q, k, v must be (BH, S, D)")
    bh, sq, d = q.shape
    skv = k.shape[1]
    if k.shape != (bh, skv, d) or v.shape != (bh, skv, d):
        raise ValueError(f"attn_fwd: shapes {tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"attn_fwd: dtypes {q.dtype} {k.dtype} {v.dtype} (float32 or bfloat16)")
    if not (q.device == k.device == v.device):
        raise ValueError("attn_fwd: q, k, v on different devices")
    if q.device.type == "cpu":
        return attn_fwd_plain(q, k, v, scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"attn_fwd: no kernel for device {q.device}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"attn_fwd: head dim {d} not in {_HEAD_DIMS}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("attn_fwd: q, k, v must be contiguous")
    if bh > 65535 or max(sq, skv) * d * bh >= 2**31:
        raise ValueError(f"attn_fwd: BH={bh}, S={max(sq, skv)} exceed the kernel's indexing")
    lib = _build.load()
    o = torch.empty_like(q)
    qscale = float(torch.tensor(scale * LOG2_E, dtype=torch.float32))
    code = lib.tt_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), bh, sq, skv, d, qscale,
        _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib, code, "attn_fwd")
    attn_fwd.launches += 1
    attn_fwd.shapes.add((tuple(q.shape), tuple(k.shape)))
    return o


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, scale: float):
    """q (B, H, Sq, D), k/v (B, H, Skv, D) -> (B, H, Sq, D), bias-free."""
    b, h, sq, d = q.shape
    out = attn_fwd(
        q.reshape(b * h, sq, d).contiguous(),
        k.reshape(b * h, k.shape[2], d).contiguous(),
        v.reshape(b * h, v.shape[2], d).contiguous(),
        scale,
    )
    return out.reshape(b, h, sq, d)

"""Attention kernels and their plain versions.

Forward, three kernels of one tile loop in csrc/attention.cu (the
CUDA-core body), and tensor-core (wgmma) bodies of the same arithmetic in
csrc/attention_tc.cu (f32: 3xTF32 products) where `tc_body` holds: f32 and
bf16 at head dim 64 in all three forms, and at head dim 32 (AudioLDM's) in
the static form of `attn_fwd`; `attn_fwd_v2` and `attn_fwd_bias` keep the
CUDA-core body at 32, where no path launches them:
  * `attn_fwd` replaces `_attn_kernel` (tango_tpu/ops/flash_attention.py:56),
    the static-shift exp2 softmax with deferred division: q is prescaled by
    scale*log2(e) and rounded to the storage type, p = exp2(min(l - 20, 96)),
    the PV product takes p rounded to the storage type, and a row whose
    denominator underflows to 0 is a zero row, never NaN. The exactness
    window and its edges are documented in the JAX file.
  * `attn_fwd_v2` replaces `_attn_kernel_v2` (:103), the blocked-KV online
    softmax that JAX takes for long bias-free calls (`v2_route`): the same
    prescaled q, but max-subtracted, so it has no window.
  * `attn_fwd_bias` replaces `_attn_kernel_bias` (:84): max-subtracted, with
    an additive f32 bias (B, 1 | Sq, Skv) scaled by log2(e), shared by the
    heads of a batch row.

Backward, `attn_bwd_dq` and `attn_bwd_dkv` replace `_bwd_dq_kernel` and
`_bwd_dkv_kernel` (:231, 259): the gradient of the exact max-subtracted
softmax, recomputed from q, k and v, with JAX's roundings (ds to the storage
type before both products that take it, p to dO's type before dV = p^T dO).
dq also writes the per-row lse and delta that dkv reads, as (BH, Sq) f32. In
f32 and bf16 at head dim 64 (`bwd_tc_body`) both run the tensor-core body of
csrc/attention_bwd_tc.cu (f32: 3xTF32 products), other head dims the
CUDA-core body of csrc/attention_bwd.cu.
Bound on the H100: operations (see the CUDA files' notes).

Layout: q and do (BH, Sq, D), k and v (BH, Skv, D), contiguous, f32 or bf16.
The kernels take D in `KERNEL_HEAD_DIMS` and any BH and S whose
(b*h, 64-row tile) block count fits 32 bits (`kernel_shape_ok`); the dispatch
in ops/attention.py asks that before it picks a kernel. Each wrapper launches
its kernel for CUDA tensors and runs its plain version for CPU tensors; any
other device raises. Where a tensor-core body runs, every input and output
must also be 16-byte aligned (its 16-byte copies). The C entry point
reports which body it launched, and the wrapper's `tc_launches` counts the
tensor-core ones beside `launches`.
"""

from __future__ import annotations

import numpy as np
import torch

from tango_tpu_torch.ops import _build, check_tc_aligned, count_tc, kernel_wrapper, reported_tc

LOG2_E = 1.4426950408889634
SOFTMAX_SHIFT = 20.0
SOFTMAX_CLAMP = 96.0
KERNEL_HEAD_DIMS = (8, 16, 32, 64, 128)
TC_HEAD_DIM = 64
STATIC_TC_HEAD_DIMS = (32, 64)  # the static form's tensor-core head dims
FORMS = ("static", "online", "bias")  # attn_fwd, attn_fwd_v2, attn_fwd_bias (tt::AttnMode)
_SRC = "tango_tpu_torch/csrc/attention.cu"
_TC_SRC = "tango_tpu_torch/csrc/attention_tc.cu"  # f32 and bf16: D = 64, and 32 (static)
_BWD_SRC = "tango_tpu_torch/csrc/attention_bwd.cu"
_BWD_TC_SRC = "tango_tpu_torch/csrc/attention_bwd_tc.cu"  # f32 and bf16 at D = 64, training's
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ROWS = 64  # query (or key) rows a block


def kernel_shape_ok(bh: int, sq: int, skv: int, d: int) -> bool:
    """Whether the attention kernels, forward and backward, take these heads:
    D is one they are built for, and the (b*h, 64-row tile) blocks of either
    sequence axis fit grid.x (element offsets are 64-bit)."""
    return d in KERNEL_HEAD_DIMS and bh * -(-max(sq, skv) // _ROWS) < 2**31


def v2_route(sq: int, skv: int) -> bool:
    """JAX's rule for the blocked-KV kernel (flash_attention.py:423), applied
    to bias-free calls: a key set over 4096 that 512 divides, Sq a multiple of
    128. Everything else bias-free takes the static-shift kernel."""
    return skv > 4096 and skv % 512 == 0 and sq % 128 == 0


def tc_body(dtype: torch.dtype, d: int, form: str) -> bool:
    """Whether a forward attention kernel of `form` (FORMS: attn_fwd
    "static", attn_fwd_v2 "online", attn_fwd_bias "bias") runs on its
    tensor-core body (csrc/attention_tc.cu) rather than the CUDA-core one:
    f32 or bf16 (f32 on 3xTF32 products, within JAX's f32 limits; the
    trainer's f32 included), at head dim 64, the width of every attention of
    the full-width UNet, in every form, and at head dim 32, AudioLDM's, in
    the static form, the one its path launches. The C entry points apply the
    same rule (`tc_body` in csrc/common.cuh); here it decides the alignment
    check."""
    if form not in FORMS:
        raise ValueError(f"tc_body: form {form!r} (one of {FORMS})")
    dims = STATIC_TC_HEAD_DIMS if form == "static" else (TC_HEAD_DIM,)
    return d in dims and dtype in (torch.float32, torch.bfloat16)


def bwd_tc_body(dtype: torch.dtype, d: int) -> bool:
    """Whether the backward kernels (attn_bwd_dq, attn_bwd_dkv) run on their
    tensor-core body (csrc/attention_bwd_tc.cu): head dim 64 in f32 or bf16
    (`bwd_tc_body` in csrc/common.cuh)."""
    return d == TC_HEAD_DIM and dtype in (torch.float32, torch.bfloat16)


def _check(name: str, q, k, v, *like_q) -> bool:
    """Validate (BH, S, D) heads (and tensors shaped like q); True for the
    kernel (CUDA), False for the plain version (CPU)."""
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError(f"{name}: q, k, v must be (BH, S, D)")
    bh, sq, d = q.shape
    skv = k.shape[1]
    if (k.shape != (bh, skv, d) or v.shape != (bh, skv, d)
            or any(t.shape != q.shape for t in like_q)):
        raise ValueError(f"{name}: shapes {[tuple(t.shape) for t in (q, k, v, *like_q)]}")
    if any(t.dtype != q.dtype for t in (k, v, *like_q)) or q.dtype not in _DTYPES:
        raise TypeError(f"{name}: dtypes {[t.dtype for t in (q, k, v, *like_q)]} "
                        "(float32 or bfloat16)")
    if any(t.device != q.device for t in (k, v, *like_q)):
        raise ValueError(f"{name}: inputs on different devices")
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for device {q.device}")
    if not kernel_shape_ok(bh, sq, skv, d):
        raise ValueError(f"{name}: BH={bh}, Sq={sq}, Skv={skv}, D={d} not taken by the kernel "
                         f"(D in {KERNEL_HEAD_DIMS}, BH*tiles < 2^31)")
    if not all(t.is_contiguous() for t in (q, k, v, *like_q)):
        raise ValueError(f"{name}: inputs must be contiguous")
    return True


def _dims(q, k) -> tuple[int, int, int, int]:
    """(BH, Sq, Skv, D), the C entry points' dimension arguments."""
    return q.shape[0], q.shape[1], k.shape[1], q.shape[2]


def _qscale(scale: float) -> float:
    """scale*log2(e) rounded to f32, as the Pallas kernels' prescale."""
    return float(np.float32(scale * LOG2_E))


def _prescaled_logits(q, k, scale):
    """(q*scale*log2 e rounded to q's type) . k^T in f32: base-2 logits."""
    qs = (q.float() * _qscale(scale)).to(q.dtype)
    return torch.matmul(qs.float(), k.float().transpose(-1, -2))


def _max_subtracted(logits, v, dtype):
    """exp2 softmax with the row max subtracted, deferred division."""
    p = torch.exp2(logits - logits.amax(-1, keepdim=True))
    acc = torch.matmul(p.to(v.dtype).float(), v.float())
    return (acc / p.sum(-1, keepdim=True)).to(dtype)


def _launch(fn, inputs, *args) -> bool:
    """Call fn's C entry point tt_<name>(*args, dtype, stream) on the stream of
    inputs[0], raise on a CUDA error, count the launch and record the inputs'
    shapes; True where the entry point reports a tensor-core launch."""
    q = inputs[0]
    lib = _build.load()
    code = getattr(lib, f"tt_{fn.__name__}")(
        *args, _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    tc = reported_tc(lib, code, fn.__name__)
    fn.launches += 1
    fn.shapes.add(tuple(tuple(t.shape) for t in inputs))
    return tc


def attn_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float):
    """Plain version of attn_fwd: the same static-shift softmax, in f32."""
    logits = _prescaled_logits(q, k, scale)
    p = torch.exp2(torch.clamp(logits - SOFTMAX_SHIFT, max=SOFTMAX_CLAMP))
    denom = p.sum(-1, keepdim=True)
    acc = torch.matmul(p.to(v.dtype).float(), v.float())
    return (acc / torch.where(denom == 0.0, torch.ones_like(denom), denom)).to(q.dtype)


def _launch_fwd(fn, q, k, v, scale, bias=None, heads=1):
    """Launch attn_fwd, attn_fwd_v2 or (with a bias) attn_fwd_bias (fn) into
    a new output; the C entry point picks the body by `tc_body` for fn's
    form, and fn.tc_launches counts the tensor-core ones it reports."""
    o = torch.empty_like(q)
    tc = tc_body(q.dtype, q.shape[2], fn.form)
    if tc:
        check_tc_aligned(fn.__name__, q, k, v, *(() if bias is None else (bias,)), o)
    if bias is None:
        ran = _launch(fn, (q, k), q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                      *_dims(q, k), _qscale(scale))
    else:
        ran = _launch(fn, (q, k, bias), q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      bias.data_ptr(), o.data_ptr(), *_dims(q, k), heads, bias.shape[1],
                      _qscale(scale))
    count_tc(fn, tc, ran)
    return o


@kernel_wrapper(_TC_SRC, "tango_tpu/ops/flash_attention.py:56")
def attn_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float):
    """softmax(q k^T * scale) v over (BH, S, D) heads, static-shift form."""
    if not _check("attn_fwd", q, k, v):
        return attn_fwd_plain(q, k, v, scale)
    return _launch_fwd(attn_fwd, q, k, v, scale)


def attn_fwd_v2_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float):
    """Plain version of attn_fwd_v2: the max-subtracted softmax in f32, the
    row max in one pass."""
    return _max_subtracted(_prescaled_logits(q, k, scale), v, q.dtype)


@kernel_wrapper(_TC_SRC, "tango_tpu/ops/flash_attention.py:103")
def attn_fwd_v2(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float):
    """softmax(q k^T * scale) v over (BH, S, D) heads, online max-subtracted form."""
    if not _check("attn_fwd_v2", q, k, v):
        return attn_fwd_v2_plain(q, k, v, scale)
    return _launch_fwd(attn_fwd_v2, q, k, v, scale)


attn_fwd.tc_launches = attn_fwd_v2.tc_launches = 0
attn_fwd.form, attn_fwd_v2.form = "static", "online"
# the CUDA-core body: attn_fwd at D 8, 16, 128; attn_fwd_v2 at every D but 64
attn_fwd.core_source = attn_fwd_v2.core_source = _SRC


def attn_fwd_bias_plain(q, k, v, bias, heads: int, scale: float):
    """Plain version of attn_fwd_bias: base-2 logits plus bias*log2(e) (head bh
    reads batch row bh // heads), the max-subtracted softmax in f32."""
    log2e = torch.tensor(LOG2_E, dtype=torch.float32)
    logits = _prescaled_logits(q, k, scale) + bias.repeat_interleave(heads, 0) * log2e
    return _max_subtracted(logits, v, q.dtype)


@kernel_wrapper(_TC_SRC, "tango_tpu/ops/flash_attention.py:84")
def attn_fwd_bias(q, k, v, bias, heads: int, scale: float):
    """softmax(q k^T * scale + bias) v over (BH, S, D) heads; bias is f32
    (B, 1 | Sq, Skv) with B * heads == BH, and head bh adds row bh // heads."""
    use_kernel = _check("attn_fwd_bias", q, k, v)
    bh, sq, _ = q.shape
    skv = k.shape[1]
    if (heads < 1 or bh % heads or bias.dim() != 3
            or bias.shape[0] != bh // heads or bias.shape[1] not in (1, sq)
            or bias.shape[2] != skv):
        raise ValueError(f"attn_fwd_bias: bias {tuple(bias.shape)} for {heads} heads of "
                         f"q {tuple(q.shape)}, k {tuple(k.shape)}; expected (BH/heads, 1|Sq, Skv)")
    if bias.dtype != torch.float32:
        raise TypeError(f"attn_fwd_bias: bias dtype {bias.dtype} (float32)")
    if bias.device != q.device:
        raise ValueError("attn_fwd_bias: bias on another device than q")
    if not use_kernel:
        return attn_fwd_bias_plain(q, k, v, bias, heads, scale)
    if not bias.is_contiguous():
        raise ValueError("attn_fwd_bias: bias must be contiguous")
    return _launch_fwd(attn_fwd_bias, q, k, v, scale, bias, heads)


attn_fwd_bias.tc_launches = 0
attn_fwd_bias.form = "bias"
attn_fwd_bias.core_source = _SRC  # the CUDA-core body, every D but 64


def attn_bwd_dq_plain(q, k, v, do, scale: float):
    """Plain version of attn_bwd_dq: (dq, lse, delta), the arithmetic of
    _bwd_dq_kernel in f32."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    denom = p.sum(-1, keepdim=True)
    p = p / denom
    lse = m + torch.log(denom)
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    delta = (p * dp).sum(-1, keepdim=True)
    ds = (p * (dp - delta) * scale).to(q.dtype)
    dq = torch.matmul(ds.float(), k.float())
    return dq.to(q.dtype), lse[..., 0], delta[..., 0]


@kernel_wrapper(_BWD_TC_SRC, "tango_tpu/ops/flash_attention.py:231", backward=True)
def attn_bwd_dq(q, k, v, do, scale: float):
    """dq of softmax(q k^T * scale) v for the output gradient do, all
    (BH, S, D); also the per-row lse and delta, (BH, Sq) f32."""
    if not _check("attn_bwd_dq", q, k, v, do):
        return attn_bwd_dq_plain(q, k, v, do, scale)
    return _launch_dq(q, k, v, do, scale)


def _launch_dq(q, k, v, do, scale):
    """Launch attn_bwd_dq into new outputs; the C entry point picks the body
    by `bwd_tc_body`, and attn_bwd_dq.tc_launches counts the tensor-core
    ones it reports."""
    bh, sq, d = q.shape
    dq = torch.empty_like(q)
    lse = torch.empty((bh, sq), device=q.device, dtype=torch.float32)
    delta = torch.empty_like(lse)
    tc = bwd_tc_body(q.dtype, d)
    if tc:
        check_tc_aligned("attn_bwd_dq", q, k, v, do, dq)
    count_tc(attn_bwd_dq, tc, _launch(
        attn_bwd_dq, (q, k), q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        dq.data_ptr(), lse.data_ptr(), delta.data_ptr(), *_dims(q, k), float(scale)))
    return dq, lse, delta


def attn_bwd_dkv_plain(q, k, v, do, lse, delta, scale: float):
    """Plain version of attn_bwd_dkv: (dk, dv), the arithmetic of
    _bwd_dkv_kernel in f32."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale      # (BH, Sq, Skv)
    p = torch.exp(s - lse[..., None])
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), do.float())
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    ds = (p * (dp - delta[..., None]) * scale).to(q.dtype)
    dk = torch.matmul(ds.float().transpose(-1, -2), q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


@kernel_wrapper(_BWD_TC_SRC, "tango_tpu/ops/flash_attention.py:259", backward=True)
def attn_bwd_dkv(q, k, v, do, lse, delta, scale: float):
    """dk, dv of softmax(q k^T * scale) v from the lse and delta of attn_bwd_dq."""
    use_kernel = _check("attn_bwd_dkv", q, k, v, do)
    bh, sq, _ = q.shape
    for t in (lse, delta):
        if t.shape != (bh, sq) or t.dtype != torch.float32 or t.device != q.device:
            raise ValueError("attn_bwd_dkv: lse and delta must be (BH, Sq) float32 on q's device")
    if not use_kernel:
        return attn_bwd_dkv_plain(q, k, v, do, lse, delta, scale)
    if not (lse.is_contiguous() and delta.is_contiguous()):
        raise ValueError("attn_bwd_dkv: lse and delta must be contiguous")
    return _launch_dkv(q, k, v, do, lse, delta, scale)


def _launch_dkv(q, k, v, do, lse, delta, scale):
    """Launch attn_bwd_dkv into new outputs; the C entry point picks the body
    by `bwd_tc_body`, and attn_bwd_dkv.tc_launches counts the tensor-core
    ones it reports."""
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    tc = bwd_tc_body(q.dtype, q.shape[2])
    if tc:
        check_tc_aligned("attn_bwd_dkv", q, k, v, do, dk, dv)
    count_tc(attn_bwd_dkv, tc, _launch(
        attn_bwd_dkv, (q, k), q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), *_dims(q, k),
        float(scale)))
    return dk, dv


attn_bwd_dq.tc_launches = attn_bwd_dkv.tc_launches = 0
attn_bwd_dq.core_source = attn_bwd_dkv.core_source = _BWD_SRC  # other head dims


def flash_bwd_supported(sq: int, skv: int, d: int) -> bool:
    """flash_bwd_supported of the JAX package (flash_attention.py:286-293),
    kept as the dispatch rule so that both packages take the kernels for the
    same shapes: both sequence axes tile by 128, D % 8 == 0, S*D*2 <= 2 MB."""
    return (sq % 128 == 0 and skv % 128 == 0 and d % 8 == 0
            and skv * d * 2 <= 2 * 1024 * 1024 and sq * d * 2 <= 2 * 1024 * 1024)


def flash_attention_bwd(q, k, v, do, scale: float):
    """(dq, dk, dv) over (BH, S, D) heads: attn_bwd_dq, then attn_bwd_dkv on the
    same stream, reading the lse and delta that dq wrote."""
    dq, lse, delta = attn_bwd_dq(q, k, v, do, scale)
    dk, dv = attn_bwd_dkv(q, k, v, do, lse, delta, scale)
    return dq, dk, dv

"""Sequence parallelism in the port (parallel/mesh.py's `shard_latents_seq`
and its collectives, `latent_sharder=` in the UNet and in AudioDiffusion,
SP training) against JAX's meshless functions on the same numpy weights and
inputs, as JAX's own test holds its SP forward and gradients
(tests/test_parallel.py:203-251):

  * on 2 and 4 CPU ranks over gloo (tests/_torch_mesh_child.py): the
    forward of JAX's SP configuration (T = 64) at model = 2 and 4, a DP x SP
    2 x 2 mesh, a three-level UNet at T = 36 whose second level's slab is
    odd and whose third level 'model' does not divide (both run whole),
    `downsample_padding=0`, and a tiny Mustango-stream UNet (two extra
    streams), each at JAX's atol 2e-5, and the gradients of the mean of its
    square (the parameters' and the input's) against `jax.grad` at JAX's
    rtol 2e-4 / atol 1e-6; `AudioDiffusion(latent_sharder=).sample` fed
    JAX's `noise_override` against JAX's sampler at
    tests/test_torch_pipeline.py's atol 2e-4 / rtol 1e-3; a DP x SP 2 x 2
    `SFTTrainer` step (remat) against JAX's meshless step fed the same
    draws (loss rtol 2e-5, every updated parameter within 1e-4: JAX's dry
    run's bounds), every rank's loss the same; every rank's result the
    same, and each evaluation's and step's collectives counted by kind;
  * in one process, P threads as the model ranks exchanging through a local
    all-gather and reduce-scatter: each kind of halo convolution (stride 1,
    the upsample's, the downsample's at padding 1 and 0) against the module
    on the whole, the SP GroupNorm against gn_stats_plain / gn_apply_plain
    on the whole, the slab's self-attention against the whole's; and the
    backward of each (the halo, the gather, the output rule, group_norm(sp=))
    against autograd on the whole;
  * the dispatch rule on the whole sequence's query count, the placement
    rule, draw_latents' rows on the model ranks, the dry run's SP half on 4
    CPU ranks, and the refusals: TP + SP, int8 (#10d), a sharder the port
    cannot read.

Each launch of ranks has its own time limit, and each rank's process group
a 120 s timeout.
"""

import collections
import copy
import dataclasses
import functools
import os
import pathlib
import sys
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tango_tpu import configs as JC
from tango_tpu.models.diffusion import AudioDiffusion as JAudioDiffusion
from tango_tpu.models.unet import UNet2DConditionModel as JUNet
from tango_tpu_torch import configs as TC
from tango_tpu_torch.models import unet as punet
from tango_tpu_torch.models.diffusion import AudioDiffusion
from tango_tpu_torch.ops import attention as pattn
from tango_tpu_torch.ops.basic import group_norm
from tango_tpu_torch.ops.gn_silu import gn_apply_plain, gn_stats_plain, n_chunks
from tango_tpu_torch.ops.int8_gemm import quantize_rows
from tango_tpu_torch.ops import quant
from tango_tpu_torch.ops.quant import quantize_unet_
from tango_tpu_torch.parallel import mesh as pmesh
from tango_tpu_torch.parallel.launch import check, launch
from tango_tpu_torch.utils.convert import from_jax_params
from tango_tpu_torch.utils.init import init_random_

from tests._torch_helpers import random_jax_params
from tests.test_torch_parallel import DPO_LR, PAR_UNET, PAR_VAE as PAR_VAE_KW, _close_params
from tests.test_torch_parallel import _dpo_job, _dpo_meshless, _sft_case
from tests.test_torch_pipeline_music import MUSIC_KW

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
CHILD = str(REPO / "tests" / "_torch_mesh_child.py")
LAUNCH_TIMEOUT_S = 240

# JAX's SP configuration (tests/test_parallel.py:213-221)
SP_UNET = dict(in_channels=4, out_channels=4,
               down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
               up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"),
               block_out_channels=(16, 32), layers_per_block=1, cross_attention_dim=16,
               attention_head_dim=(2, 4), norm_num_groups=8)
THREE_LEVELS = dict(SP_UNET, down_block_types=("CrossAttnDownBlock2D",) * 2 + ("DownBlock2D",),
                    up_block_types=("UpBlock2D",) + ("CrossAttnUpBlock2D",) * 2,
                    block_out_channels=(16, 32, 32), attention_head_dim=(2, 4, 4))
SAMPLE_LATENT = (64, 4)
SAMPLE_STEPS = 2


# ------------------------------------------------------------------ the jobs

def _forward_case(kw, t_len, model, data=1, seed=0):
    """A forward-and-backward job at latent length t_len, and its JAX
    reference: the output, and `jax.grad` of the mean of its square as to
    the parameters and the input."""
    cfg = JC.UNetConfig(**kw)
    streams = 1 + cfg.extra_cond_streams
    rng = np.random.RandomState(seed)
    x = rng.randn(2, t_len, 4, cfg.in_channels).astype(np.float32)
    t = np.array([5, 500])
    c = [rng.randn(2, 6 + j, cfg.cross_attention_dim).astype(np.float32) for j in range(streams)]
    mask = [np.ones((2, 6 + j), np.int64) for j in range(streams)]
    for j, m in enumerate(mask):
        m[1, 4 + j:] = 0
    jc, jm = (c, mask) if streams > 1 else (c[0], mask[0])
    params = random_jax_params(lambda k: JUNet(cfg).init(
        k, jnp.asarray(x), jnp.asarray(t), jc, jm)["params"], seed + 1)
    tensors = lambda a: [torch.from_numpy(v) for v in a] if streams > 1 \
        else torch.from_numpy(a)  # noqa: E731
    job = dict(cfg=TC.UNetConfig(**kw), sd=from_jax_params(params), x=torch.from_numpy(x),
               t=torch.from_numpy(t), c=tensors(jc), mask=tensors(jm), model=model, data=data)

    def reference():
        def loss(p, xx):
            out = JUNet(cfg).apply({"params": p}, xx, t, jc, jm)
            return jnp.mean(jnp.square(out)), out

        (_, out), (grads, x_grad) = jax.jit(jax.value_and_grad(loss, (0, 1), has_aux=True))(
            params, jnp.asarray(x))
        return {"out": np.asarray(out), "grads": from_jax_params(jax.device_get(grads)),
                "x_grad": np.asarray(x_grad)}
    return job, reference


def _int8_forward_case(t_len, model, seed=12):
    """A forward job of the quantized ("all") UNet of JAX's SP configuration
    on gloo ranks, and JAX's meshless int8 output (quantize_tree, as
    tests/test_torch_quant.py builds it)."""
    from tango_tpu.ops import quant as jq

    job, _ = _forward_case(SP_UNET, t_len, model, seed=seed)
    cfg = JC.UNetConfig(**SP_UNET)
    x, t, c, mask = (job[k].numpy() for k in ("x", "t", "c", "mask"))
    params = random_jax_params(lambda k: JUNet(cfg).init(
        k, jnp.asarray(x), jnp.asarray(t), c, mask)["params"], seed + 1)
    qparams = jq.quantize_tree(params)
    job.update(cfg=TC.UNetConfig(**SP_UNET, quant_int8=True), sd=from_jax_params(qparams),
               forward_only=True)

    def reference():
        jcfg = dataclasses.replace(cfg, quant_int8=True)
        return {"out": np.asarray(jax.jit(JUNet(jcfg).apply)(
            {"params": qparams}, jnp.asarray(x), jnp.asarray(t), c, mask))}
    return job, reference


def _sample_case():
    """The sampler job on JAX's SP configuration, and JAX's sampler."""
    cfg = JC.UNetConfig(**SP_UNET)
    diff = JAudioDiffusion(cfg, latent_t_size=SAMPLE_LATENT[0], latent_f_size=SAMPLE_LATENT[1])
    rng = np.random.RandomState(7)
    cond = rng.randn(1, 6, 16).astype(np.float32)
    uncond = rng.randn(1, 6, 16).astype(np.float32)
    mask = np.array([[1, 1, 1, 1, 0, 0]])
    umask = np.ones((1, 6), np.int64)
    init = rng.randn(1, *SAMPLE_LATENT, 4).astype(np.float32)
    noises = rng.randn(SAMPLE_STEPS, 1, *SAMPLE_LATENT, 4).astype(np.float32)
    params = random_jax_params(lambda k: diff.unet.init(
        k, jnp.zeros((1, *SAMPLE_LATENT, 4)), jnp.zeros((1,), jnp.int32),
        jnp.zeros((1, 6, 16)))["params"], 8)
    t = torch.from_numpy
    job = dict(cfg=TC.UNetConfig(**SP_UNET), sd=from_jax_params(params), latent=SAMPLE_LATENT,
               cond=t(cond), mask=t(mask), uncond=t(uncond), umask=t(umask),
               noise=(t(init), t(noises)), steps=SAMPLE_STEPS, model=2)

    def reference():
        return np.asarray(diff.sample(params, cond, mask, jax.random.PRNGKey(0),
                                      num_steps=SAMPLE_STEPS, guidance_scale=3.0,
                                      uncond_embeds=uncond, uncond_mask=umask,
                                      noise_override=(init, noises)))
    return job, reference


LAUNCHES = {2: ["sp_forward-jax2", "sp_forward-odd", "sp_forward-pad0", "sp_forward-music",
                "sp_forward-int8", "sp_sample", "dpo_step-sp"],
            4: ["sp_forward-jax4", "sp_forward-dp", "sft_step-sp"]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case's job written once; the 2-rank cases in one launch and the
    4-rank ones in another, in a thread while this process computes JAX's
    references; each case's rank-0 result and its reference."""
    root = tmp_path_factory.mktemp("sp")
    job, reference = {}, {}
    job["sp_forward-jax2"], reference["jax"] = _forward_case(SP_UNET, 64, 2)
    job["sp_forward-jax4"] = dict(job["sp_forward-jax2"], model=4)
    job["sp_forward-dp"] = dict(job["sp_forward-jax2"], data=2)
    job["sp_forward-odd"], reference["odd"] = _forward_case(THREE_LEVELS, 36, 2, seed=3)
    job["sp_forward-pad0"], reference["pad0"] = _forward_case(
        dict(SP_UNET, downsample_padding=0), 64, 2, seed=5)
    job["sp_forward-music"], reference["music"] = _forward_case(MUSIC_KW, 64, 2, seed=9)
    job["sp_forward-int8"], reference["int8"] = _int8_forward_case(64, 2)
    job["sp_sample"], reference["sample"] = _sample_case()
    # tests/test_torch_parallel.py's DP x TP step at DP x SP: T = 8 makes
    # slabs of 4 and 2 rows at its two levels
    job["sft_step-sp"], reference["sft"] = _sft_case()
    job["sft_step-sp"]["seq"] = True
    # tests/test_torch_parallel.py's DPO step at SP = 2 (32 latent frames:
    # slabs of 16 and 8), its reference UNet a copy of the SP one
    job["dpo_step-sp"] = dict(_dpo_job(), seq=True, model=2)
    reference["dpo"] = lambda: _dpo_meshless(job["dpo_step-sp"])
    torch.save(job, root / "job.pt")
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(REPO))
    launched = {}

    def run():
        for world, cases in LAUNCHES.items():
            launched[world] = launch(
                [sys.executable, CHILD, str(root / "job.pt"), str(root), *cases], world,
                LAUNCH_TIMEOUT_S, env=env, cwd=str(REPO))

    thread = threading.Thread(target=run)
    thread.start()
    try:
        refs = {case: fn() for case, fn in reference.items()}
    finally:
        thread.join()
    for world in LAUNCHES:
        check(launched[world], f"{world}-rank launch")
    got = {c: torch.load(root / f"{c}.pt", weights_only=False) for c in job}
    return got, refs


@pytest.mark.parametrize("case", ["jax2", "jax4", "dp"])
def test_sp_forward_matches_jax(runs, case):
    """JAX's SP configuration at model = 2 and 4, and at DP x SP 2 x 2."""
    got, refs = runs
    out = got[f"sp_forward-{case}"]
    np.testing.assert_allclose(out["out"].numpy(), refs["jax"]["out"], atol=2e-5)
    assert out["same_on_every_rank"]


@pytest.mark.parametrize("case", ["odd", "pad0", "music"])
def test_sp_forward_edge_cases_match_jax(runs, case):
    got, refs = runs
    out = got[f"sp_forward-{case}"]
    np.testing.assert_allclose(out["out"].numpy(), refs[case]["out"], atol=2e-5)
    assert out["same_on_every_rank"]


def _assert_grads(out, ref):
    """The parameters' and the input's gradients at JAX's SP bounds
    (tests/test_parallel.py:251)."""
    assert set(out["grads"]) == set(ref["grads"])
    for name, want in ref["grads"].items():
        np.testing.assert_allclose(out["grads"][name].numpy(), want.numpy(), rtol=2e-4,
                                   atol=1e-6, err_msg=f"grad {name}")
    np.testing.assert_allclose(out["x_grad"].numpy(), ref["x_grad"], rtol=2e-4, atol=1e-6)


@pytest.mark.parametrize("case", ["jax2", "jax4", "dp"])
def test_sp_grads_match_jax(runs, case):
    """The SP backward (halos, gathers, GroupNorm, the output rule, the
    gradient reduction) at model = 2 and 4 and at DP x SP 2 x 2."""
    got, refs = runs
    out = got[f"sp_forward-{case}"]
    _assert_grads(out, refs["jax"])
    assert out["same_on_every_rank"]


@pytest.mark.parametrize("case", ["odd", "pad0", "music"])
def test_sp_grads_edge_cases_match_jax(runs, case):
    """Whole levels (the 'level' gather's backward), the one-sided halo of
    padding 0, and the extra streams' cross-attentions."""
    got, refs = runs
    out = got[f"sp_forward-{case}"]
    _assert_grads(out, refs[case])
    assert out["same_on_every_rank"]


@pytest.mark.parametrize("case", ["jax2", "dp", "odd", "pad0", "music"])
def test_sp_backward_mirrors_the_forward_exchanges(runs, case):
    """Without remat every exchange of the forward has one backward
    exchange of its kind ("<kind>_grad"), and nothing else runs."""
    out = runs[0][f"sp_forward-{case}"]
    fwd = {k: v for k, v in out["stats"].items() if "_bytes" not in k}
    bwd = {k: v for k, v in out["grad_stats"].items() if "_bytes" not in k}
    assert bwd == {f"{k}_grad": v for k, v in fwd.items()}
    assert all(out["grad_stats"][f"{k}_bytes"] > 0 for k in bwd)


def test_dp_sp_sft_step_matches_jax(runs):
    """One SFTTrainer step at DP x SP 2 x 2 (remat, parameters replicated,
    gradients summed over 'model') against JAX's meshless step fed the same
    draws: the loss within 2e-5, every updated parameter within 1e-4 (JAX's
    dry run's bounds; Adam's first step moves a parameter by about lr =
    3e-5, so a flipped sign stays inside), the gradients at the DP x TP
    test's bounds; every rank's loss the same."""
    got, refs = runs
    g, r = got["sft_step-sp"], refs["sft"]
    np.testing.assert_allclose(g["loss"], r["loss"], rtol=2e-5)
    assert len(set(g["losses"])) == 1
    assert set(g["grads"]) == set(r["grads"]) == set(g["params"])
    for name, v in r["grads"].items():
        np.testing.assert_allclose(g["grads"][name].numpy(), v.numpy(), rtol=2e-4, atol=1e-5,
                                   err_msg=f"grad {name}")
    for name, v in r["params"].items():
        np.testing.assert_allclose(g["params"][name].numpy(), v.numpy(), rtol=0, atol=1e-4,
                                   err_msg=f"updated param {name}")


def test_dpo_step_under_sp_matches_meshless(runs):
    """DPOTrainer at SP = 2 (its reference UNet copied from the SP UNet, so
    it runs on the slabs too) against the meshless step, at the DP DPO
    test's bounds (tests/test_torch_parallel.py)."""
    got, refs = runs
    g, r = got["dpo_step-sp"], refs["dpo"]
    np.testing.assert_allclose(g["loss"], r["loss"], rtol=1e-4)
    assert g["metrics"]["implicit_acc"] == r["metrics"]["implicit_acc"]
    for k in ("raw_model_loss", "raw_ref_loss"):
        np.testing.assert_allclose(g["metrics"][k], r["metrics"][k], rtol=1e-5)
    _close_params(g["params"], r["params"], DPO_LR, "DPO param")


def test_dp_sp_sft_step_replays_block_exchanges_under_remat(runs):
    """A remat'd step: the forward's exchanges once, those inside the down,
    mid and up blocks once more when the backward recomputes each block,
    and each exchange's backward once."""
    stats = {k: v for k, v in runs[0]["sft_step-sp"]["stats"].items() if "_bytes" not in k}
    fwd = _collectives(TC.UNetConfig(**PAR_UNET), whole_levels=0)
    outside = {"halo": 1, "group_norm": 1, "output": 1}  # conv_norm_out, conv_out, the output
    assert stats == {**{k: 2 * v - outside.get(k, 0) for k, v in fwd.items()},
                     **{f"{k}_grad": v for k, v in fwd.items()}}


def test_sp_sample_matches_jax(runs):
    got, refs = runs
    out = got["sp_sample"]
    np.testing.assert_allclose(out["latents"].numpy(), refs["sample"], atol=2e-4, rtol=1e-3)
    assert out["same_on_every_rank"]
    # two CFG evaluations: twice one forward's collectives
    assert {k: v // SAMPLE_STEPS for k, v in out["stats"].items() if "_bytes" not in k} == \
        _collectives(TC.UNetConfig(**SP_UNET), whole_levels=0)


def _collectives(cfg, whole_levels):
    """The collectives of one SP evaluation by kind: a halo for every 3x3
    stride-1 convolution but conv_in and for every resampler (float or
    int8), a GroupNorm all-reduce for every GroupNorm, one gather a
    self-attention and one of the output, an amax all-reduce for every
    QConv2d, on a UNet whose levels all run on slabs except the lowest
    `whole_levels` (one gather where the slabs stop)."""
    unet = punet.UNet2DConditionModel(cfg)
    levels = len(cfg.block_out_channels)
    slab = lambda name: not any(name.startswith(p) for p in _whole_prefixes(  # noqa: E731
        levels, whole_levels))
    halo = sum(slab(n) for n, m in unet.named_modules()
               if isinstance(m, (torch.nn.Conv2d, quant.QConv2d))
               and m.weight.shape[-2:] == (3, 3) and n != "conv_in"
               and not n.endswith("downsamplers_0.conv") and not n.endswith("upsamplers_0.conv"))
    halo += sum(slab(n) for n, m in unet.named_modules()
                if isinstance(m, (punet.Downsample2D, punet.Upsample2D)))
    norms = sum(slab(n) for n, m in unet.named_modules()
                if type(m).__name__ == "GroupNorm")
    attn = sum(slab(n) for n, m in unet.named_modules() if n.endswith("attn1"))
    out = {"halo": halo, "group_norm": norms, "kv": attn, "output": 1}
    amax = sum(slab(n) for n, m in unet.named_modules() if isinstance(m, quant.QConv2d))
    if amax:
        out["int8_amax"] = amax
    if whole_levels:
        out["level"] = 1
    return out


def _whole_prefixes(levels, whole_levels):
    """Module name prefixes of the lowest `whole_levels` levels."""
    lows = range(levels - whole_levels, levels)
    return tuple([f"down_blocks_{lv}." for lv in lows]
                 + [f"up_blocks_{levels - 1 - lv}." for lv in lows]
                 + (["mid_block."] if whole_levels else []))


def test_sp_int8_forward_on_gloo_ranks_matches_jax(runs):
    """The quantized UNet at SP = 2 on gloo ranks (the amax all-reduced by
    torch.distributed's MAX) within JAX's 0.05 of JAX's meshless int8
    UNet (tests/test_torch_quant.py's end-to-end bar), every rank the
    same."""
    got, refs = runs
    out = got["sp_forward-int8"]
    ref = refs["int8"]["out"]
    assert np.linalg.norm(out["out"].numpy() - ref) / np.linalg.norm(ref) < 0.05
    assert out["same_on_every_rank"]


@pytest.mark.parametrize("case,cfg,whole", [
    ("jax2", SP_UNET, 0), ("pad0", dict(SP_UNET, downsample_padding=0), 0),
    ("music", MUSIC_KW, 0), ("odd", THREE_LEVELS, 2),
    ("int8", dict(SP_UNET, quant_int8=True), 0)])
def test_sp_collectives_an_evaluation(runs, case, cfg, whole):
    """One evaluation's collectives by kind; at T = 36 the two lowest levels
    run whole: no exchange there, one gather where the slabs stop (after
    the first level's downsampler, which runs on the slabs); the int8 UNet
    one amax all-reduce a QConv2d besides (a convolution that skipped it
    would quantize its slab with the slab's own amax)."""
    stats = runs[0][f"sp_forward-{case}"]["stats"]
    want = _collectives(TC.UNetConfig(**cfg), whole)
    assert {k: v for k, v in stats.items() if "_bytes" not in k} == want
    assert all(stats[f"{k}_bytes"] > 0 for k in want)


# ---------------------------------------------------- one process, P threads

class ThreadRanks:
    """`parts` threads of this process as the model ranks of one mesh: the
    collectives of parallel.mesh go through a local exchange (a barrier and
    a slot a rank) in place of torch.distributed."""

    def __init__(self, parts: int):
        self.parts = parts
        self.barrier = threading.Barrier(parts, timeout=60)
        self.slots = [None] * parts
        self.local = threading.local()

    def all_gather(self, out, x, group=None):
        self.slots[self.local.rank] = x.clone()
        self.barrier.wait()
        for o, s in zip(out, self.slots):
            o.copy_(s)
        self.barrier.wait()

    def all_reduce(self, t, op=torch.distributed.ReduceOp.SUM, group=None):
        parts = [torch.empty_like(t) for _ in range(self.parts)]
        self.all_gather(parts, t)
        whole = torch.stack(parts)
        if op == torch.distributed.ReduceOp.MAX:
            t.copy_(whole.amax(0))
        else:
            assert op == torch.distributed.ReduceOp.SUM, op
            t.copy_(whole.sum(0))

    def reduce_scatter_tensor(self, out, src, group=None):
        parts = [torch.empty_like(src) for _ in range(self.parts)]
        self.all_gather(parts, src)
        out.copy_(torch.stack(parts).sum(0).chunk(self.parts)[self.local.rank])

    def run(self, monkeypatch, fn, grad=False):
        """fn(mesh) on every rank, each in its thread, without gradients
        unless `grad` (a thread does not inherit the caller's grad mode); the
        results in rank order."""
        monkeypatch.setattr(pmesh, "dist", types.SimpleNamespace(
            all_gather=self.all_gather, all_reduce=self.all_reduce,
            reduce_scatter_tensor=self.reduce_scatter_tensor, ReduceOp=torch.distributed.ReduceOp))
        results, errors = [None] * self.parts, []

        def body(r):
            self.local.rank = r
            mesh = pmesh.Mesh(pmesh.rank_grid(self.parts, 1, self.parts), r,
                              torch.device("cpu"), "gloo", None, self)
            try:
                with torch.set_grad_enabled(grad):
                    results[r] = fn(mesh)
            except BaseException as e:  # reported below, after every thread ended
                errors.append(e)
                self.barrier.abort()

        threads = [threading.Thread(target=body, args=(r,)) for r in range(self.parts)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        if errors:
            raise errors[0]
        return results


def _slab(x, mesh, dim=2):
    n = x.shape[dim] // mesh.shape["model"]
    return x.narrow(dim, mesh.model_index * n, n).contiguous()


@pytest.mark.parametrize("parts", [2, 4])
@pytest.mark.parametrize("kind", ["conv3x3", "upsample", "down_pad1", "down_pad0"])
def test_halo_convolution_matches_whole(monkeypatch, kind, parts):
    torch.manual_seed(0)
    x = torch.randn(2, 8, 16, 6)
    if kind == "conv3x3":
        conv = torch.nn.Conv2d(8, 8, 3, padding=1)
        mod = lambda a, sp=None: punet.seq_conv(conv, a, sp)  # noqa: E731
    elif kind == "upsample":
        mod = punet.Upsample2D(8)
    else:
        mod = punet.Downsample2D(8, padding=1 if kind == "down_pad1" else 0)
    with torch.no_grad():
        want = mod(x)
        got = ThreadRanks(parts).run(monkeypatch, lambda m: mod(_slab(x, m), m))
    np.testing.assert_allclose(torch.cat(got, 2).numpy(), want.numpy(), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("parts,act", [(2, "silu"), (4, None)])
def test_seq_group_norm_matches_plain_versions_on_the_whole(monkeypatch, parts, act):
    torch.manual_seed(1)
    x = torch.randn(2, 32, 16, 6) * 2.0 + 0.5
    g, b = torch.randn(32) * 0.2 + 1.0, torch.randn(32) * 0.1
    groups, eps = 8, 1e-5
    # the two plain stages on the whole, the combine between them
    sums = gn_stats_plain(x, groups, n_chunks(16 * 6)).sum(2)
    n = 16 * 6 * 32 // groups
    mean = sums[..., 0] / n
    inv = torch.rsqrt(sums[..., 1] / n - mean * mean + eps)
    a = inv.repeat_interleave(32 // groups, 1) * g
    want = gn_apply_plain(x, a, b - mean.repeat_interleave(32 // groups, 1) * a, act)
    got = ThreadRanks(parts).run(
        monkeypatch, lambda m: group_norm(_slab(x, m), g, b, groups, eps, act, sp=m))
    np.testing.assert_allclose(torch.cat(got, 2).numpy(), want.numpy(), atol=1e-5, rtol=1e-5)
    ref = F.group_norm(x, groups, g, b, eps)
    np.testing.assert_allclose(torch.cat(got, 2).numpy(),
                               (F.silu(ref) if act else ref).numpy(), atol=1e-5, rtol=1e-5)


def _grads(out, w, inputs):
    """The gradients of sum(out * w) as to each of `inputs`."""
    return torch.autograd.grad((out * w).sum(), inputs)


@pytest.mark.parametrize("parts", [2, 4])
@pytest.mark.parametrize("kind", ["conv3x3", "upsample", "down_pad1", "down_pad0"])
def test_halo_convolution_grads_match_whole(monkeypatch, kind, parts):
    """The halo exchange's backward: each rank's input gradient is its slab
    of the whole's (the halo rows' gradients added on their owners), and
    the weights' partial gradients sum over the ranks to the whole's."""
    torch.manual_seed(3)
    x = torch.randn(2, 8, 16, 6)
    if kind == "conv3x3":
        conv = torch.nn.Conv2d(8, 8, 3, padding=1)
        mod = lambda a, sp=None: punet.seq_conv(conv, a, sp)  # noqa: E731
        params = list(conv.parameters())
    else:
        mod = punet.Upsample2D(8) if kind == "upsample" else \
            punet.Downsample2D(8, padding=1 if kind == "down_pad1" else 0)
        params = list(mod.parameters())
    xw = x.clone().requires_grad_()
    out = mod(xw)
    w = torch.randn(out.shape)
    want = _grads(out, w, [xw, *params])

    def rank(m):
        xs = _slab(x, m).requires_grad_()
        return _grads(mod(xs, m), _slab(w, m), [xs, *params])

    got = ThreadRanks(parts).run(monkeypatch, rank, grad=True)
    np.testing.assert_allclose(torch.cat([g[0] for g in got], 2).numpy(), want[0].numpy(),
                               atol=1e-5, rtol=1e-5)
    # the weights' gradients reach ~40, sums of ~800 products taken in
    # another order on each rank: f32 rounding of ~1e-6 of their size
    for i, p in enumerate(want[1:], 1):
        np.testing.assert_allclose(sum(g[i] for g in got).numpy(), p.numpy(), atol=1e-4,
                                   rtol=1e-4)


@pytest.mark.parametrize("parts", [2, 4])
def test_gather_backward_is_a_reduce_scatter(monkeypatch, parts):
    """Each rank's partial gradient of the whole: the slabs' gradients are
    the sums over the ranks, each rank's own slab; counted as "kv_grad"."""
    torch.manual_seed(4)
    x = torch.randn(2, 12 * parts, 5)
    ws = torch.randn(parts, *x.shape)

    def rank(m):
        xs = _slab(x, m, 1).requires_grad_()
        (g,) = _grads(pmesh.gather_seq(xs, m, 1, "kv"), ws[m.model_index], [xs])
        return g, dict(m.seq_stats)

    got = ThreadRanks(parts).run(monkeypatch, rank, grad=True)
    np.testing.assert_allclose(torch.cat([g for g, _ in got], 1).numpy(), ws.sum(0).numpy(),
                               atol=1e-6)
    n = x.numel() // parts * 4
    assert all(st == {"kv": 1, "kv_bytes": (parts - 1) * n, "kv_grad": 1,
                      "kv_grad_bytes": (parts - 1) * n} for _, st in got)


@pytest.mark.parametrize("parts", [2, 4])
def test_output_rule_makes_the_gradient_partial(monkeypatch, parts):
    """The UNet's output: the same loss on every rank from the gathered
    whole; the identity before the gather divides its gradient by 'model',
    so each slab's gradient is the whole's slab, not `parts` times it; on a
    whole tensor each rank's gradient is the whole's over `parts`."""
    torch.manual_seed(5)
    x = torch.randn(1, 3, 8 * parts, 4)
    w = torch.randn(x.shape)

    def rank(m):
        xs = _slab(x, m).requires_grad_()
        xw = x.clone().requires_grad_()
        out = pmesh.gather_seq(pmesh.partial_grad(xs, m), m, 2, "output")
        return _grads(out, w, [xs])[0], _grads(pmesh.partial_grad(xw, m), w, [xw])[0]

    got = ThreadRanks(parts).run(monkeypatch, rank, grad=True)
    np.testing.assert_allclose(torch.cat([g for g, _ in got], 2).numpy(), w.numpy(), atol=1e-6)
    np.testing.assert_allclose(sum(g for _, g in got).numpy(), w.numpy(), atol=1e-6)


@pytest.mark.parametrize("parts,act", [(1, "silu"), (2, "silu"), (4, None)])
def test_seq_group_norm_grads_match_whole(monkeypatch, parts, act):
    """group_norm(sp=)'s backward (gn_bwd_stats, the sums all-reduced,
    gn_bwd_apply) against autograd through F.group_norm(+SiLU) on the whole:
    dx slab by slab, dgamma and dbeta summed over the ranks; the forward's
    and the backward's all-reduce counted once each."""
    torch.manual_seed(6)
    x = torch.randn(2, 32, 16, 6) * 2.0 + 0.5
    g, b = torch.randn(32) * 0.2 + 1.0, torch.randn(32) * 0.1
    groups, eps = 8, 1e-5
    xw, gw, bw = (t.clone().requires_grad_() for t in (x, g, b))
    out = F.group_norm(xw, groups, gw, bw, eps)
    out = F.silu(out) if act else out
    w = torch.randn(out.shape)
    want = _grads(out, w, [xw, gw, bw])

    def rank(m):
        xs, gs, bs = _slab(x, m).requires_grad_(), g.clone().requires_grad_(), \
            b.clone().requires_grad_()
        got = _grads(group_norm(xs, gs, bs, groups, eps, act, sp=m), _slab(w, m), [xs, gs, bs])
        return got, dict(m.seq_stats)

    got = ThreadRanks(parts).run(monkeypatch, rank, grad=True)
    np.testing.assert_allclose(torch.cat([r[0][0] for r in got], 2).numpy(), want[0].numpy(),
                               atol=2e-5, rtol=1e-4)
    for i in (1, 2):
        np.testing.assert_allclose(sum(r[0][i] for r in got).numpy(), want[i].numpy(),
                                   atol=2e-5, rtol=1e-4)
    assert all(st["group_norm"] == st["group_norm_grad"] == 1 for _, st in got)


def test_seq_self_attention_matches_whole(monkeypatch):
    """A slab's queries against every token's keys and values: 512 tokens,
    128 a rank at P = 4, which the rule sends to attn_fwd as it does the
    whole."""
    torch.manual_seed(2)
    attn = punet.Attention(32, 2, 16, 32, upcast=True, fuse="qkv")
    x = torch.randn(2, 512, 32)
    with torch.no_grad():
        want = attn(x)
        got = ThreadRanks(4).run(monkeypatch, lambda m: attn(_slab(x, m, 1), sp=m))
    np.testing.assert_allclose(torch.cat(got, 1).numpy(), want.numpy(), atol=2e-6, rtol=1e-5)


def test_dispatch_keys_the_whole_sequence(monkeypatch):
    """The rule reads `global_queries` (JAX sees the unsharded shape), and
    `v2_route` the slab's queries against every key: 128 of 256 queries take
    attn_fwd, 4096 of 8192 with 8192 keys take attn_fwd_v2."""
    called = []

    def recorder(name):
        def fn(q, k, v, scale):
            called.append((name, q.shape[1], k.shape[1]))
            return torch.zeros_like(q)
        return fn

    monkeypatch.setattr(pattn, "attn_fwd", recorder("attn_fwd"))
    monkeypatch.setattr(pattn, "attn_fwd_v2", recorder("attn_fwd_v2"))
    for sq, skv, whole in ((128, 256, 256), (4096, 8192, 8192)):
        q, kv = torch.zeros(1, sq, 64), torch.zeros(1, skv, 64)
        pattn.multi_head_attention(q, kv, kv, heads=1, global_queries=whole)
    # a slab of a short sequence stays plain, as the whole does
    pattn.multi_head_attention(torch.zeros(1, 64, 64), torch.zeros(1, 128, 64),
                               torch.zeros(1, 128, 64), heads=1, global_queries=128)
    assert called == [("attn_fwd", 128, 256), ("attn_fwd_v2", 4096, 8192)]
    # without the global count the slab's 128 queries would go plain
    pattn.multi_head_attention(torch.zeros(1, 128, 64), torch.zeros(1, 256, 64),
                               torch.zeros(1, 256, 64), heads=1)
    assert len(called) == 2


# ------------------------------------------- int8 under sequence parallelism

def _int8_input(seed, shape=(2, 8, 16, 6)):
    """Activations whose per-sample amax lies in another slab for each
    sample (the last slab for sample 0, the first for sample 1): a slab
    quantized with its own amax, not the whole's, comes out different."""
    torch.manual_seed(seed)
    x = torch.randn(shape)
    x[0, 3, -2, 1] = 9.0
    x[1, 5, 1, 0] = -7.5
    return x


def _int8_module(kind):
    """(module called as mod(x, sp=None), its int8 conv): quantize_unet_'s
    QConv2d.from_float of a 3x3, a 1x1 (conv_shortcut's), and the
    resamplers' convs."""
    torch.manual_seed(20)
    if kind in ("conv3x3", "conv1x1"):
        conv = quant.QConv2d.from_float(
            torch.nn.Conv2d(8, 8, 3, padding=1) if kind == "conv3x3" else torch.nn.Conv2d(8, 12, 1))
        return (lambda a, sp=None: punet.seq_conv(conv, a, sp)), conv  # noqa: E731
    mod = punet.Upsample2D(8) if kind == "upsample" else \
        punet.Downsample2D(8, padding=1 if kind == "down_pad1" else 0)
    quantize_unet_(mod, "conv")
    return mod, mod.conv


@pytest.mark.parametrize("parts", [2, 4])
@pytest.mark.parametrize("kind", ["conv3x3", "conv1x1", "upsample", "down_pad1", "down_pad0"])
def test_int8_halo_convolution_bit_equal_to_whole(monkeypatch, kind, parts):
    """Each int8 convolution path of a T-slab (its amax the largest over the
    ranks, the halo and the pads quantized with it) against the meshless
    QConv2d on the whole tensor: bit-equal, since the amax is exact, the
    integer GEMM exact (float64 on the CPU) and the dequantize elementwise;
    one `int8_amax` all-reduce of a (B, 1, 1, 1) f32 amax a rank."""
    mod, conv = _int8_module(kind)
    assert isinstance(conv, quant.QConv2d)
    x = _int8_input(21)
    with torch.no_grad():
        want = mod(x)
        got = ThreadRanks(parts).run(monkeypatch, lambda m: (mod(_slab(x, m), m),
                                                             dict(m.seq_stats)))
    np.testing.assert_array_equal(torch.cat([g for g, _ in got], 2).numpy(), want.numpy())
    halo = {} if kind == "conv1x1" else {"halo": 1}
    for _, st in got:
        assert {k: v for k, v in st.items() if "_bytes" not in k} == {"int8_amax": 1, **halo}
        assert st["int8_amax_bytes"] == (parts - 1) * 2 * 4


@pytest.mark.parametrize("parts", [2, 4])
def test_all_max_over_model_is_the_largest_of_every_rank(monkeypatch, parts):
    """The max all-reduce beside the sum: every rank ends with the largest
    over the model ranks, counted as `int8_amax` with the bytes received."""
    vals = torch.randn(parts, 3, 1, 1, 1)
    got = ThreadRanks(parts).run(monkeypatch, lambda m: (
        pmesh.all_max_over_model_(vals[m.model_index].clone(), m), dict(m.seq_stats)))
    for t, st in got:
        assert torch.equal(t, vals.amax(0))
        assert st == {"int8_amax": 1, "int8_amax_bytes": (parts - 1) * 3 * 4}


def _quantized(x, conv, amax=None):
    """x's int8 values and the quantize's scaled input x / scale, as the
    layer computes them: per sample for a convolution (`amax` the whole's
    under SP), per token for a dense layer."""
    if conv:
        q, scale = quant._quantize_act(x, (1, 2, 3), amax)
    else:
        q, scale = quantize_rows(x.reshape(-1, x.shape[-1]))
        x = x.reshape(-1, x.shape[-1])
    return q, x.float() / scale


def _int8_trace(monkeypatch, unet, args, parts):
    """The quantized UNet meshless and on `parts` ThreadRanks (a copy a rank
    with the rank's sharder), every quantized layer's input recorded in
    both: (each rank's output, each rank's exchanges, the meshless output,
    [(layer, conv, the meshless input, the slabs' input reassembled in rank
    order, the amax the slabs all-reduced)] in the meshless call order). A
    convolution's slab input is the one `_slab_amax` sees, before its halo
    (before the upsampler's nearest-2x, the padding-0 downsampler's pad);
    to_qkv, which SP runs as two row blocks, is left out."""
    whole = collections.OrderedDict()
    layers = {n: m for n, m in unet.named_modules()
              if isinstance(m, (quant.QConv2d, quant.QLinear)) and not n.endswith("to_qkv")}
    hooks = [m.register_forward_pre_hook(
        lambda mod, inp, n=n: whole.__setitem__(n, inp[0].detach().clone()))
        for n, m in layers.items()]
    with torch.no_grad():
        want = unet(*args)
    for h in hooks:
        h.remove()
    seen, names = collections.defaultdict(dict), {}
    copies = [copy.deepcopy(unet) for _ in range(parts)]
    for r, c in enumerate(copies):
        for n, m in c.named_modules():
            names[id(m)] = n
            if n in layers and isinstance(m, quant.QLinear):
                m.register_forward_pre_hook(lambda mod, inp, n=n, r=r: seen[n].__setitem__(
                    r, (inp[0].detach().clone(), None)))
    slab_amax = punet._slab_amax

    def recorded(conv, x, sp):
        amax = slab_amax(conv, x, sp)
        if amax is not None:
            seen[names[id(conv)]][sp.model_index] = (x.detach().clone(), amax)
        return amax

    monkeypatch.setattr(punet, "_slab_amax", recorded)

    def rank(m):
        c = copies[m.model_index]
        c.latent_sharder = functools.partial(pmesh.shard_latents_seq, mesh=m)
        return c(*args), dict(m.seq_stats)

    got = ThreadRanks(parts).run(monkeypatch, rank)
    trace = []
    for n, x in whole.items():
        conv = isinstance(layers[n], quant.QConv2d)
        slabs = [seen[n][r] for r in range(parts)]
        sp_x = slabs[0][0] if slabs[0][0].shape == x.shape else \
            torch.cat([a for a, _ in slabs], 2 if conv else 1)
        if n.endswith("upsamplers_0.conv"):
            x = x[:, :, ::2, ::2]  # the nearest-2x's rows and columns, once each
        trace.append((n, conv, x[:, :, :sp_x.shape[2], :sp_x.shape[3]] if conv else x, sp_x,
                      slabs[0][1]))
    return [g for g, _ in got], [st for _, st in got], want, trace


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def int8_unets():
    """SP_UNET's JAX parameters, quantized by `quantize_tree` in each scope,
    JAX's meshless int8 output on them, and the port's int8 UNet loaded from
    the converted tree (as tests/test_torch_quant.py builds both)."""
    from tango_tpu.ops import quant as jq

    rng = np.random.RandomState(30)
    x = rng.randn(2, 32, 4, 4).astype(np.float32)
    t = np.array([5, 500])
    c = rng.randn(2, 6, 16).astype(np.float32)
    mask = np.ones((2, 6), np.int64)
    mask[1, 4:] = 0
    cfg = JC.UNetConfig(**SP_UNET)
    params = random_jax_params(lambda k: JUNet(cfg).init(
        k, jnp.asarray(x), jnp.asarray(t), c, mask)["params"], 31)
    out = {}
    for scope in ("conv", "all"):
        qparams = jq.quantize_tree(params, scope=scope)
        jcfg = dataclasses.replace(cfg, quant_int8=True, quant_scope=scope)
        ref = np.asarray(jax.jit(JUNet(jcfg).apply)({"params": qparams}, jnp.asarray(x),
                                                   jnp.asarray(t), c, mask))
        unet = punet.UNet2DConditionModel(
            TC.UNetConfig(**SP_UNET, quant_int8=True, quant_scope=scope)).eval()
        unet.load_state_dict(from_jax_params(qparams))
        out[scope] = (unet, ref)
    args = tuple(torch.from_numpy(a) for a in (x, t, c, mask))
    return out, args


@pytest.mark.parametrize("parts", [2, 4])
@pytest.mark.parametrize("scope", ["conv", "all"])
def test_int8_unet_under_sp_matches_meshless(monkeypatch, int8_unets, scope, parts):
    """The quantized UNet at SP = 2 and 4, in f32, against the port's
    meshless int8 UNet, layer by layer in call order: each quantized layer's
    input on the slabs agrees with the meshless one within f32 noise (1e-5
    of its largest magnitude; only GroupNorm's and attention's summation
    orders differ) up to the first layer where an int8 value differs, and
    every value that differs there sits within f32 noise of a rounding
    boundary (1e-3 of an int8 step). Without such a flip the output is
    within 1e-3 relative L2; after one, every later layer quantizes inputs
    that differ by that step (tests/test_torch_quant.py's account: one flip
    re-draws the quantization noise downstream), and the bar is JAX's for
    the mode, 0.05. Within 0.05 of JAX's meshless int8 UNet; every rank
    the same; one `int8_amax` a QConv2d on the slabs beside the float
    UNet's exchanges."""
    cases, args = int8_unets
    unet, ref = cases[scope]
    outs, stats, want, trace = _int8_trace(monkeypatch, unet, args, parts)
    assert all(torch.equal(o, outs[0]) for o in outs)
    flips, first = [], None
    for name, conv, x, sp_x, amax in trace:
        q, v = _quantized(x, conv)
        sp_q, _ = _quantized(sp_x, conv, amax)
        differ = q != sp_q
        flips.append(int(differ.sum()))
        if first is None:
            drift = float((sp_x - x).abs().max() / x.abs().max())
            assert drift < 1e-5, f"{name}: input {drift} from the meshless one's"
            if flips[-1]:
                first = name
                edge = ((v - v.floor() - 0.5).abs() * 2).reshape(differ.shape)[differ]
                assert float(edge.max()) < 1e-3, f"{name}: a flip {float(edge.max())} from a .5"
    msg = (f"{sum(flips)} int8 values of {len(trace)} layers' inputs differ, the first at "
           f"{first}")
    rel = _rel_l2(outs[0].numpy(), want.numpy())
    assert rel < (1e-3 if first is None else 0.05), f"{rel}: {msg}"
    assert _rel_l2(outs[0].numpy(), ref) < 0.05, msg
    want_stats = _collectives(unet.cfg, whole_levels=0)
    assert all({k: v for k, v in st.items() if "_bytes" not in k} == want_stats for st in stats)
    assert want_stats["int8_amax"] == sum(isinstance(m, quant.QConv2d) for m in unet.modules())


def test_int8_seq_self_attention_matches_whole(monkeypatch):
    """A slab's self-attention with an int8 to_qkv (quantize_unet_'s
    "dense"): q through its first row block on the slab's tokens, k and v
    through the rest on every token, each token quantized alone, so q, k
    and v are the fused projection's; the attention against the whole's at
    the float test's bounds."""
    torch.manual_seed(2)
    attn = punet.Attention(32, 2, 16, 32, upcast=True, fuse="qkv")
    quantize_unet_(attn, "dense")
    assert isinstance(attn.to_qkv, quant.QLinear)
    x = torch.randn(2, 512, 32)
    with torch.no_grad():
        q, k, v = attn.to_qkv(x).chunk(3, dim=-1)
        want = pattn.multi_head_attention(q, k, v, heads=2, upcast=True)
        got = ThreadRanks(4).run(monkeypatch, lambda m: attn._seq_self_attention(
            _slab(x, m, 1), m))
    np.testing.assert_allclose(torch.cat(got, 1).numpy(), want.numpy(), atol=2e-6, rtol=1e-5)


def test_int8_sample_under_sp_matches_meshless(monkeypatch):
    """AudioDiffusion(latent_sharder=).sample of an int8 UNet ("all") with
    noise_override at SP = 2 against the meshless sample of the same
    pipeline (the sampler test's bounds, tests/test_torch_pipeline.py)."""
    torch.manual_seed(40)
    cfg = TC.UNetConfig(**SP_UNET, quant_int8=True)
    diff = AudioDiffusion(cfg, latent_t_size=16, latent_f_size=4, device="cpu")
    float_unet = punet.UNet2DConditionModel(TC.UNetConfig(**SP_UNET))
    init_random_(float_unet, torch.Generator().manual_seed(41))
    diff.unet.load_state_dict(quantize_unet_(float_unet, "all").state_dict())
    cond, uncond = torch.randn(1, 6, 16), torch.randn(1, 6, 16)
    mask, umask = torch.tensor([[1, 1, 1, 1, 0, 0]]), torch.ones(1, 6, dtype=torch.long)
    noise = (torch.randn(1, 16, 4, 4), torch.randn(2, 1, 16, 4, 4))
    kw = dict(num_steps=2, guidance_scale=3.0, uncond_embeds=uncond, uncond_mask=umask,
              noise_override=noise)
    with torch.no_grad():
        want = diff.sample(cond, mask, **kw)
    copies = [copy.deepcopy(diff) for _ in range(2)]

    def rank(m):
        d = copies[m.model_index]
        d.unet.latent_sharder = functools.partial(pmesh.shard_latents_seq, mesh=m)
        return d.sample(cond, mask, **kw), dict(m.seq_stats)

    got = ThreadRanks(2).run(monkeypatch, rank)
    assert torch.equal(got[0][0], got[1][0])
    np.testing.assert_allclose(got[0][0].numpy(), want.numpy(), atol=2e-4, rtol=1e-3)
    n_conv = sum(isinstance(m, quant.QConv2d) for m in diff.unet.modules())
    assert got[0][1]["int8_amax"] == 2 * n_conv  # two CFG evaluations


# ------------------------------------------------------ placement, refusals

def _mesh(model, rank=0, data=1):
    return pmesh.Mesh(pmesh.rank_grid(data * model, data, model), rank, torch.device("cpu"),
                      "gloo")


def test_shard_latents_seq_places_slabs():
    x = torch.arange(2 * 12 * 3, dtype=torch.float32).reshape(2, 12, 3)
    assert pmesh.shard_latents_seq(x) is x
    assert pmesh.shard_latents_seq(x, _mesh(1)) is x
    for model in (2, 3, 4):
        slabs = [pmesh.shard_latents_seq(x, _mesh(model, r)) for r in range(model)]
        assert all(s.shape == (2, 12 // model, 3) for s in slabs)
        assert torch.equal(torch.cat(slabs, 1), x)
    # T = 12 over 5: whole; the data rank does not move the slab
    assert pmesh.shard_latents_seq(x, _mesh(5, 3)) is x
    assert torch.equal(pmesh.shard_latents_seq(x, _mesh(2, 3, data=2)), x[:, 6:])


def test_draw_latents_gives_model_ranks_the_same_rows():
    """Under DP x SP every model rank of a data rank draws the posterior
    noise, timesteps, noise and drop mask of the same rows (so they compute
    one loss), and the data ranks' rows are the meshless draw's."""
    from tango_tpu_torch.models.vae import AutoencoderKL
    from tango_tpu_torch.train.sft import draw_latents

    vae = init_random_(AutoencoderKL(TC.VAEConfig(**PAR_VAE_KW), with_encoder=True),
                       torch.Generator().manual_seed(0)).eval()
    diff = AudioDiffusion(TC.UNetConfig(**SP_UNET), uncondition=True, device="cpu")
    fbank = torch.randn(4, 16, 8)

    def draw(mesh, rows):
        lat, d = draw_latents(vae, diff, mesh, [fbank[rows]], torch.Generator().manual_seed(7),
                              False)
        return [lat[0]] + [d[k] for k in ("posterior", "timesteps", "noise", "drop")]

    whole = draw(None, slice(0, 4))
    for r in range(4):
        mesh = _mesh(2, r, data=2)
        rows = pmesh.process_local_batch_slice(mesh, 4)
        for got, want in zip(draw(mesh, rows), whole):
            assert torch.equal(got, want[rows])


def test_dryrun_sp_half_on_cpu_ranks(monkeypatch):
    """`python -m tango_tpu_torch.parallel.dryrun --n 4`: the DP x TP and the
    DP x SP (2 x 2) steps of the tiny config against the meshless step at
    JAX's bounds, on 4 CPU ranks; the SP step's exchanges, the backward's
    included."""
    from tango_tpu_torch.parallel.dryrun import LOSS_RTOL, PARAM_ATOL, dryrun_multichip

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.chdir(REPO)
    rec = dryrun_multichip(4, device="cpu", timeout=LAUNCH_TIMEOUT_S)
    assert rec["ok"] and rec["mesh"] == {"data": 2, "model": 2}
    assert rec["sp_loss_rel_err"] <= LOSS_RTOL and rec["sp_param_max_drift"] <= PARAM_ATOL
    kinds = {"halo", "group_norm", "kv", "output"}
    assert set(rec["sp_collectives"]) == kinds | {f"{k}_grad" for k in kinds}


def _sp_unet(model=2, **kw):
    unet = punet.UNet2DConditionModel(
        TC.UNetConfig(**dict(SP_UNET, **kw)),
        latent_sharder=functools.partial(pmesh.shard_latents_seq, mesh=_mesh(model)))
    init_random_(unet, torch.Generator().manual_seed(0))
    return unet


def _inputs():
    return torch.randn(1, 16, 4, 4), torch.tensor([5]), torch.randn(1, 6, 16)


def test_sp_refuses_tensor_parallelism():
    unet = _sp_unet()
    unet.down_blocks_0.attentions_0.transformer_blocks_0.attn1.tp_mesh = _mesh(2)
    with torch.no_grad(), pytest.raises(ValueError, match="SP and TP"):
        unet(*_inputs())


def test_sp_sharder_forms():
    """JAX's form, its mesh read back; a 'model' axis of 1 is no SP (the
    meshless forward, no collective); another callable is refused."""
    mesh = _mesh(2)
    assert pmesh.seq_mesh(functools.partial(pmesh.shard_latents_seq, mesh=mesh)) is mesh
    assert pmesh.seq_mesh(functools.partial(pmesh.shard_latents_seq)) is None
    assert pmesh.seq_mesh(None) is None
    one = _sp_unet(model=1)
    x, t, c = _inputs()
    with torch.no_grad():
        got = one(x, t, c)
        one.latent_sharder = None
        np.testing.assert_array_equal(got.numpy(), one(x, t, c).numpy())
    with pytest.raises(TypeError, match="shard_latents_seq"):
        punet.UNet2DConditionModel(TC.UNetConfig(**SP_UNET), latent_sharder=lambda x: x)
    diff = AudioDiffusion(TC.UNetConfig(**SP_UNET), latent_sharder=functools.partial(
        pmesh.shard_latents_seq, mesh=mesh), device="cpu")
    assert diff.unet.latent_sharder.keywords["mesh"] is mesh
    given = AudioDiffusion(one, latent_sharder=functools.partial(pmesh.shard_latents_seq,
                                                                 mesh=mesh), device="cpu")
    assert given.unet is one and pmesh.seq_mesh(one.latent_sharder) is mesh
    assert dataclasses.fields(AudioDiffusion)[-2].name == "latent_sharder"

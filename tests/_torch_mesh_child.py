"""One rank of the port's multi-process mesh tests (tests/test_torch_parallel.py,
tests/test_torch_sp.py).

    python tests/_torch_mesh_child.py JOB OUT_DIR CASE [CASE ...]

launched by `tango_tpu_torch.parallel.launch.launch` with torchrun's
variables, one process a rank, all on the CPU over gloo. JOB is a
`torch.save`d dict, one entry a case (configs, state dicts, inputs); a
case is named by its function, or as <function>-<tag> where several cases
share one; each case builds its mesh, runs the port under it and rank 0
saves what it got as OUT_DIR/<case>.pt. The test process holds those results to JAX's meshless
functions, or to the port's meshless run. Imports no JAX: the JAX side runs
in the test process.
"""

import datetime
import functools
import sys

import torch

torch.set_num_threads(1)


class FixedConditioner:
    """AudioLDM's conditioner with given embeddings: the hash stub's are
    salted per process, so ranks and the test process would disagree."""

    def __init__(self, film, uncond):
        self.film, self.uncond = film, uncond

    def text_embed(self, prompts):
        return self.film.repeat(len(prompts), 0)

    def unconditional_embed(self, batch):
        return self.uncond.repeat(batch, 0)


def tp_forward(j, pmesh):
    """The UNet forward with its heads over every rank (model = world)."""
    from tango_tpu_torch.models.unet import UNet2DConditionModel

    mesh = pmesh.make_mesh(data=1, model=j["model"], device="cpu")
    unet = UNet2DConditionModel(j["cfg"])
    unet.load_state_dict(j["sd"])
    pmesh.shard_params(unet, mesh)
    heads = [None] * mesh.size
    torch.distributed.all_gather_object(
        heads, [m.local_heads for m in unet.modules() if hasattr(m, "local_heads")])
    with torch.no_grad():
        out = unet(j["x"], j["t"], j["c"])
    full = pmesh.full_state_dict(unet, mesh)
    return {"out": out, "local_heads": heads,
            "gathered_equal": all(torch.equal(full[k], v) for k, v in j["sd"].items())
            and set(full) == set(j["sd"])}


def sft_step(j, pmesh):
    """One SFTTrainer step on a (data, model) mesh with the global batch's
    draws given, the UNet TP-sharded over 'model' or, with j["seq"],
    sequence-parallel over it (its latent time axis split); the gradients as
    AdamW sees them, gathered whole, every rank's loss, and the step's SP
    exchanges by kind."""
    from tango_tpu_torch.configs import TrainConfig
    from tango_tpu_torch.models.diffusion import AudioDiffusion
    from tango_tpu_torch.models.vae import AutoencoderKL
    from tango_tpu_torch.train.sft import SFTTrainer

    mesh = pmesh.make_mesh(data=j["data"], model=j["model"], device="cpu")
    sharder = functools.partial(pmesh.shard_latents_seq, mesh=mesh) if j.get("seq") else None
    diffusion = AudioDiffusion(j["cfg"], snr_gamma=j["snr_gamma"], latent_t_size=8,
                               latent_f_size=4, remat=True, latent_sharder=sharder, device="cpu")
    vae = AutoencoderKL(j["vae_cfg"], with_encoder=True)
    vae.load_state_dict(j["vae_sd"])
    trainer = SFTTrainer(diffusion, vae.eval(), TrainConfig(gradient_accumulation_steps=1,
                                                            learning_rate=j["lr"]),
                         total_steps=10, mesh=mesh)
    state = trainer.init_state(params=j["sd"])
    names = [n for n, p in state.params.named_parameters()]
    seen = {}
    adamw = state.opt_state.opt.step

    def capture(*a, **kw):
        seen.update({n: p.grad.clone() for n, p in zip(names, state.opt_state.params)})
        return adamw(*a, **kw)

    state.opt_state.opt.step = capture
    state, loss = trainer.train_step(state, pmesh.shard_batch(j["batch"], mesh),
                                     draws=j["draws"])
    params = {k: v.clone() for k, v in trainer.state_dict(state).items()}
    # the gradients gathered as the parameters are: held in the parameters
    with torch.no_grad():
        for n, p in state.params.named_parameters():
            p.copy_(seen[n])
    losses = [None] * mesh.size
    torch.distributed.all_gather_object(losses, float(loss))
    return {"loss": float(loss), "grads": trainer.state_dict(state), "params": params,
            "losses": losses, "stats": dict(mesh.seq_stats)}


def generate(j, pmesh):
    """Tango at DP over every rank: a padded tail chunk, and a batch-1
    generate that replicates."""
    from tango_tpu_torch.pipeline import Tango

    mesh = pmesh.make_mesh(data=-1, model=1, device="cpu")
    tango = Tango.from_components(**j["kwargs"], mesh=mesh, device="cpu")
    outs = tango.generate_for_batch(j["prompts"], steps=j["steps"], batch_size=j["batch_size"],
                                    seed=j["seed"])
    single = tango.generate(j["prompts"][0], steps=j["steps"], seed=j["seed"])
    return {"waveforms": outs, "single": single}


def mustango(j, pmesh):
    """Mustango with its UNet over every rank (TP), explicit features."""
    from tango_tpu_torch.pipeline_music import Mustango

    mesh = pmesh.make_mesh(data=1, model=j["model"], device="cpu")
    m = Mustango.from_components(**j["kwargs"], mesh=mesh, device="cpu")
    return {"waveforms": m.generate_for_batch(**j["call"])}


def audioldm(j, pmesh):
    """AudioLDM with its rows over every rank (DP), a batch of 3 padded to 4."""
    from tango_tpu_torch.audioldm import pipeline as pl

    mesh = pmesh.make_mesh(data=-1, model=1, device="cpu")
    pipe = pl.AudioLDMPipeline(**j["kwargs"], mesh=mesh, device="cpu")
    return {"waveforms": pl.text_to_audio(pipe, **j["call"])}


def dpo_step(j, pmesh):
    """One DPOTrainer step at DP over every rank, or with j["seq"] DP x SP
    (j["model"] ranks splitting the latent time axis); the reference whole,
    or sequence-parallel too (a copy of the trained UNet)."""
    from tango_tpu_torch.configs import DPOConfig
    from tango_tpu_torch.models.dpo import DPOAudioDiffusion, make_reference
    from tango_tpu_torch.models.vae import AutoencoderKL
    from tango_tpu_torch.train.dpo import DPOTrainer

    mesh = pmesh.make_mesh(data=-1, model=j.get("model", 1), device="cpu")
    sharder = functools.partial(pmesh.shard_latents_seq, mesh=mesh) if j.get("seq") else None
    diff = DPOAudioDiffusion(j["cfg"], remat=True, beta_dpo=j["beta"], uncondition=True,
                             latent_sharder=sharder, device="cpu")
    diff.unet.load_state_dict(j["sd"])
    vae = AutoencoderKL(j["vae_cfg"], with_encoder=True)
    vae.load_state_dict(j["vae_sd"])
    trainer = DPOTrainer(diff, vae.eval(), DPOConfig(gradient_accumulation_steps=1,
                                                     learning_rate=j["lr"]), total_steps=4,
                         mesh=mesh)
    ref = make_reference(diff.unet)
    state = trainer.init_state()
    state, loss, metrics = trainer.dpo_step(state, ref, pmesh.shard_batch(j["batch"], mesh),
                                            torch.Generator().manual_seed(j["seed"]))
    return {"loss": float(loss), "metrics": {k: float(v) for k, v in metrics.items()},
            "params": pmesh.full_state_dict(state.params, mesh)}


def t5(j, pmesh):
    """The T5 encoder with its heads over every rank (TP), its weights first
    made rank 0's by `replicated` (rank 1's perturbed before)."""
    from tango_tpu_torch.models.t5 import T5Encoder

    mesh = pmesh.make_mesh(data=1, model=j["model"], device="cpu")
    enc = T5Encoder(j["cfg"])
    enc.load_state_dict(j["sd"])
    if mesh.rank:
        with torch.no_grad():
            for p in enc.parameters():
                p.add_(1.0)
    pmesh.replicated(enc, mesh)
    pmesh.shard_params(enc, mesh)
    with torch.no_grad():
        return {"out": enc(j["ids"], j["mask"])}


def _sp_mesh(j, pmesh):
    mesh = pmesh.make_mesh(data=j.get("data", 1), model=j["model"], device="cpu")
    return mesh, functools.partial(pmesh.shard_latents_seq, mesh=mesh)


def _same_on_every_rank(t) -> bool:
    got = [None] * torch.distributed.get_world_size()
    torch.distributed.all_gather_object(got, t)
    return all(torch.equal(g, t) for g in got)


def sp_forward(j, pmesh):
    """The UNet forward sequence-parallel over 'model' (JAX's
    `latent_sharder=partial(shard_latents_seq, mesh=mesh)`), each data rank
    on its rows, and the gradients of the mean of its square: the output
    gathered over 'data'; the parameters' gradients summed over 'model' and
    averaged over 'data' (`all_reduce_grads(seq=True)`, the trainers'
    reduction), the input's summed over 'model' (every model rank holds the
    whole input, so its gradient is partial) and gathered over 'data'; each
    the same on every rank; the forward's and the backward's exchanges by
    kind. A `forward_only` job (an int8 UNet) stops after the forward."""
    from tango_tpu_torch.models.unet import UNet2DConditionModel

    mesh, sharder = _sp_mesh(j, pmesh)
    unet = UNet2DConditionModel(j["cfg"], latent_sharder=sharder)
    unet.load_state_dict(j["sd"])
    x, *args = pmesh.shard_batch_or_replicate([j[k] for k in ("x", "t", "c", "mask") if k in j],
                                              mesh)
    x = x.clone().requires_grad_()
    if j.get("forward_only"):  # an int8 UNet: no backward
        with torch.no_grad():
            out = pmesh.gather_rows(unet(x, *args), mesh, len(j["x"]))
        return {"out": out, "stats": dict(mesh.seq_stats),
                "same_on_every_rank": _same_on_every_rank(out)}
    out = unet(x, *args)
    stats = dict(mesh.seq_stats)
    mesh.seq_stats.clear()
    out.square().mean().backward()
    pmesh.all_reduce_grads(list(unet.parameters()), mesh, seq=True)
    torch.distributed.all_reduce(x.grad, group=mesh.model_group)
    n = len(j["x"])
    out = pmesh.gather_rows(out.detach(), mesh, n)
    x_grad = pmesh.gather_rows(x.grad / mesh.shape["data"], mesh, n)
    grads = {name: p.grad for name, p in unet.named_parameters()}
    flat = torch.cat([t.reshape(-1) for t in (out, x_grad, *grads.values())])
    return {"out": out, "x_grad": x_grad, "grads": grads, "stats": stats,
            "grad_stats": dict(mesh.seq_stats), "same_on_every_rank": _same_on_every_rank(flat)}


def sp_sample(j, pmesh):
    """AudioDiffusion(latent_sharder=...).sample with the given noise: the
    final latents, the same on every rank."""
    from tango_tpu_torch.models.diffusion import AudioDiffusion

    mesh, sharder = _sp_mesh(j, pmesh)
    diff = AudioDiffusion(j["cfg"], latent_t_size=j["latent"][0], latent_f_size=j["latent"][1],
                          latent_sharder=sharder, device="cpu")
    diff.unet.load_state_dict(j["sd"])
    lat = diff.sample(j["cond"], j["mask"], num_steps=j["steps"], guidance_scale=3.0,
                      uncond_embeds=j["uncond"], uncond_mask=j["umask"],
                      noise_override=j["noise"])
    return {"latents": lat, "same_on_every_rank": _same_on_every_rank(lat),
            "stats": dict(mesh.seq_stats)}


CASES = {f.__name__: f for f in (tp_forward, sft_step, generate, mustango, audioldm, dpo_step,
                                 t5, sp_forward, sp_sample)}


def main():
    job_path, out_dir, *cases = sys.argv[1:]
    from tango_tpu_torch.parallel import mesh as pmesh

    rank, _, _ = pmesh.init_distributed("cpu", timeout=datetime.timedelta(seconds=120))
    job = torch.load(job_path, weights_only=False)
    for case in cases:
        out = CASES[case.split("-")[0]](job[case], pmesh)
        if rank == 0:
            torch.save(out, f"{out_dir}/{case}.pt")


if __name__ == "__main__":
    main()

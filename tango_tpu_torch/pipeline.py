"""Tango, the text-to-audio pipeline: port of tango_tpu/pipeline.py.

`Tango(snapshot_dir).generate(prompt)` returns an int16 16 kHz waveform;
`generate_for_batch` chunks a prompt list. `Tango(path)` loads a
reference-format snapshot directory (utils/checkpoint.py) and downloads
nothing; `Tango.from_components(...)` builds from configs and state dicts,
or seeded random weights. Both go through one build. The path: tokenize, T5
encode the prompts and "" (padded to `max_text_length`), the CFG DDPM loop
over the UNet, the VAE decode to a mel, HiFi-GAN, int16.

Runs on CUDA unless the caller passes `device="cpu"`; the compute dtype is
bf16 on the card and f32 on the CPU, scheduler math f32 always.

Noise: every row of a batch draws its initial latents and its per-step noise
from its own generator, seeded from (seed, chunk, row). So batch row 0 equals
the single-prompt output at the same seed, padding a tail chunk leaves the
real rows unchanged, and each chunk of a seeded call gets distinct noise.

int8 serving: `quant="conv" | "dense" | "all"` quantizes the UNet once at
build time, in JAX's order (tango_tpu/pipeline.py `_build`): with
`cast_params=False` (`from_components`' default, as JAX's) the f32 weights
are quantized and the float remainder cast to the compute dtype after; with
`cast_params=True` (`Tango()`'s default) the weights are cast first, so on
the card the bf16 ones are quantized. The scales stay f32 either way. The
scope's Linear layers then run the `w8a8_matmul` kernel, its Conv2d layers
the int8 convolution (ops/quant.py). The T5 encoder, the VAE and HiFi-GAN
stay in the compute dtype.

The tokenizer: the caller's, or `WordHashTokenizer` (FLAN-T5's
SentencePiece tokenizer needs `transformers`, which the port does not use;
`Tango(path)` warns when it falls back to the word hash).

The device mesh (`mesh=`, parallel.mesh, one process a device): the UNet
is sharded over 'model' by the TP rules and the T5, the VAE and HiFi-GAN
are replicated. A batch whose rows (prompts x samples) divide 'data' is
spread over it: each data rank samples its rows with the same per-row
seeds, so its noise is the meshless run's, decodes them, and the waveforms
are all-gathered, so every rank returns the full list. `generate_for_batch`
pads each chunk until its rows divide 'data'; a batch that does not divide
(`generate` at batch 1) is computed whole on every rank.
"""

from __future__ import annotations

import dataclasses
import os
import warnings
from typing import List, Optional, Sequence

import numpy as np
import torch

from tango_tpu_torch import configs as C
from tango_tpu_torch.models.diffusion import AudioDiffusion
from tango_tpu_torch.models.hifigan import HiFiGANGenerator, waveform_to_int16
from tango_tpu_torch.models.t5 import T5Encoder
from tango_tpu_torch.models.unet import UNet2DConditionModel
from tango_tpu_torch.models.vae import AutoencoderKL
from tango_tpu_torch.ops.quant import SCOPES, QConv2d, QLinear, quantize_unet_
from tango_tpu_torch.parallel import mesh as pmesh
from tango_tpu_torch.tokenizer import WordHashTokenizer
from tango_tpu_torch.utils.checkpoint import load_native, load_tango_snapshot
from tango_tpu_torch.utils.init import init_random_


def _row_seed(base: int, chunk: int, row: int) -> int:
    state = np.random.SeedSequence([base, chunk, row]).generate_state(1, dtype=np.uint64)
    return int(state[0]) & (2**63 - 1)


def build_module(make, params, device, dtype: torch.dtype, seed: int) -> torch.nn.Module:
    """Module `make()` on `device` in `dtype`, for inference, from state dict
    `params` (strict) or, where it is None, seeded random weights
    (utils.init) drawn on the device from `seed`."""
    with torch.device("meta"):
        m = make()
    m = m.to_empty(device=device).to(dtype=dtype)
    if params is None:
        init_random_(m, torch.Generator(device=device).manual_seed(seed))
    else:
        m.load_state_dict(params)
    return m.eval().requires_grad_(False)


def _cast_float_(module: torch.nn.Module, dtype: torch.dtype) -> None:
    """Cast a quantized module's float parameters and buffers to dtype in
    place, keeping its int8 layers' f32 `weight_scale`."""
    scales = {m: m.weight_scale for m in module.modules() if isinstance(m, (QLinear, QConv2d))}
    module.to(dtype=dtype)
    for m, scale in scales.items():
        m.weight_scale = scale


class Tango:
    """Text -> 16 kHz audio (reference tango.py:9-64)."""

    def __init__(self, name_or_path: Optional[str] = None, tokenizer=None,
                 dtype: Optional[torch.dtype] = None, max_text_length: int = 128,
                 rng_seed: int = 0, cast_params: bool = True, mesh=None,
                 quant: Optional[str] = None, unet_ckpt: Optional[str] = None, device=None):
        """Load the reference-format snapshot directory `name_or_path` (or,
        with None, an empty pipeline for `from_components`). `unet_ckpt`, a
        directory that `utils.checkpoint.save_native` wrote (as
        `SFTTrainer.fit` does), replaces the snapshot's UNet weights: a
        natively trained UNet over the snapshot's VAE, T5 and vocoder.
        `mesh`, a `parallel.mesh.make_mesh()`, shards the UNet over 'model'
        and the batches over 'data'. The parameters are JAX's, in its order;
        `device`, the port's own, comes last."""
        if quant not in (None, False, *SCOPES):
            # a typo must not serve an unquantized pipeline
            raise ValueError(f"quant must be one of None/'conv'/'dense'/'all', got {quant!r}")
        self.quant = quant or None
        self.cast_params = cast_params
        self.mesh = mesh
        self.device = C.resolve_device(device)
        self.dtype = dtype or C.default_dtype(self.device)
        self.max_text_length = max_text_length
        self.tokenizer = tokenizer
        self._rng = np.random.default_rng(rng_seed)
        self.model = self.vae = self.t5 = self.vocoder = None
        self.stft_config, self.main_config = C.TANGO_STFT, None
        if name_or_path is None:
            if unet_ckpt is not None:
                raise ValueError("unet_ckpt replaces a snapshot's UNet: give the snapshot too")
            return
        if not os.path.isdir(name_or_path):
            raise FileNotFoundError(
                f"{name_or_path!r} is not a directory. The port downloads nothing: pass a local "
                "reference-format snapshot directory (main_config.json, vae_config.json, "
                "pytorch_model_main.bin, pytorch_model_vae.bin)")
        loaded = load_tango_snapshot(name_or_path)
        if unet_ckpt is not None:
            loaded["unet_params"], _ = load_native(unet_ckpt)
        t5_config = loaded["t5_config"] or C.FLAN_T5_LARGE
        if self.tokenizer is None:
            warnings.warn(
                "no tokenizer given: prompts go through WordHashTokenizer, not FLAN-T5's "
                "SentencePiece tokenizer, so they are not tokenized as the released model was "
                "trained; pass tokenizer= to use the real one", UserWarning, stacklevel=2)
            self.tokenizer = WordHashTokenizer(t5_config.vocab_size)
        self._build(
            unet_config=loaded["unet_config"], vae_config=loaded["vae_config"],
            unet_params=loaded["unet_params"], vae_params=loaded["vae_params"],
            # a component missing from the snapshot is not built: no random weights
            t5_config=t5_config if loaded["t5_params"] is not None else None,
            t5_params=loaded["t5_params"],
            hifigan_config=loaded["hifigan_config"], hifigan_params=loaded["hifigan_params"],
            scheduler_config=loaded["scheduler_config"])
        self.stft_config, self.main_config = loaded["stft_config"], loaded["main_config"]

    @classmethod
    def from_components(
        cls,
        *,
        unet_config: C.UNetConfig,
        vae_config: C.VAEConfig,
        unet_params=None,
        vae_params=None,
        t5_config: Optional[C.T5Config] = None,
        t5_params=None,
        hifigan_config: Optional[C.HiFiGANConfig] = None,
        hifigan_params=None,
        stft_config: Optional[C.StftConfig] = None,
        scheduler_config: Optional[C.SchedulerConfig] = None,
        tokenizer=None,
        dtype: Optional[torch.dtype] = None,
        latent_t_size: int = 256,
        latent_f_size: int = 16,
        cast_params: bool = False,
        mesh=None,
        quant: Optional[str] = None,
        device=None,
        max_text_length: int = 128,
        init_seed: int = 0,
    ) -> "Tango":
        """Build from configs and state dicts of this package's modules
        (`utils.convert` makes them from reference state dicts and from JAX
        trees). A component whose params are None gets seeded random weights
        drawn on the device from `init_seed`. T5 and HiFi-GAN are built when
        their config is given; the tokenizer defaults to WordHashTokenizer.
        With `quant`, `unet_params` is still the float UNet's: it is
        quantized here. `stft_config` (default TANGO_STFT) is kept as
        `self.stft_config`, as `Tango(path)` keeps the snapshot's. The
        parameters are JAX's, in its order; the port's own (`device`,
        `max_text_length`, `init_seed`) come last, and the params default to
        None (random weights) where JAX requires them.

        `cast_params` (JAX's flag, False here as in JAX's `from_components`)
        decides the int8 quantize order only: False builds (or draws) the
        UNet in f32, quantizes it, then casts the float remainder to the
        compute dtype, so the int8 weights and f32 scales come from the f32
        weights, as JAX quantizes its uncast tree; True casts first, as
        `Tango()` does. Without `quant` it changes nothing: the modules store
        the compute dtype either way, which is where JAX casts its uncast
        weights at use."""
        self = cls(None, tokenizer=tokenizer, device=device, dtype=dtype,
                   max_text_length=max_text_length, cast_params=cast_params, mesh=mesh,
                   quant=quant)
        if self.tokenizer is None and t5_config is not None:
            self.tokenizer = WordHashTokenizer(t5_config.vocab_size)
        self._build(unet_config=unet_config, vae_config=vae_config, unet_params=unet_params,
                    vae_params=vae_params, t5_config=t5_config, t5_params=t5_params,
                    hifigan_config=hifigan_config, hifigan_params=hifigan_params,
                    scheduler_config=scheduler_config, latent_t_size=latent_t_size,
                    latent_f_size=latent_f_size, init_seed=init_seed)
        self.stft_config = stft_config or C.TANGO_STFT
        return self

    def _build(self, *, unet_config, vae_config, unet_params, vae_params, t5_config, t5_params,
               hifigan_config, hifigan_params, scheduler_config, latent_t_size: int = 256,
               latent_f_size: int = 16, init_seed: int = 0) -> None:
        """The modules on the device in the compute dtype, from state dicts
        or, where one is None, seeded random weights; the UNet quantized in
        `cast_params`' order, then sharded over the mesh's 'model' axis (the
        rest replicated: every rank builds the same weights)."""

        def build(k: int, make, params, dtype=self.dtype):
            return build_module(make, params, self.device, dtype, init_seed * 16 + k)

        quant_f32 = self.quant is not None and not self.cast_params
        unet = build(0, lambda: UNet2DConditionModel(unet_config), unet_params,
                     torch.float32 if quant_f32 else self.dtype)
        if self.quant:
            quantize_unet_(unet, self.quant)
            if quant_f32:
                _cast_float_(unet, self.dtype)
            unet.cfg = dataclasses.replace(unet_config, quant_int8=True, quant_scope=self.quant)
        if self.mesh is not None:
            pmesh.shard_params(unet, self.mesh)
        self.model = AudioDiffusion(unet, scheduler_config or C.SD21_SCHEDULER,
                                    latent_t_size=latent_t_size, latent_f_size=latent_f_size)
        self.vae = build(1, lambda: AutoencoderKL(vae_config), vae_params)
        if t5_config is not None:
            self.t5 = build(2, lambda: T5Encoder(t5_config), t5_params)
        if hifigan_config is not None:
            self.vocoder = build(3, lambda: HiFiGANGenerator(hifigan_config), hifigan_params)

    # ------------------------------------------------------------- text side
    @torch.inference_mode()
    def encode_text(self, prompts: Sequence[str]):
        """Tokenize (host) + T5 encode (device) -> (embeds (B, S, D), mask (B, S))."""
        if self.tokenizer is None or self.t5 is None:
            raise RuntimeError("text encoding needs a tokenizer and a T5 encoder")
        batch = self.tokenizer(list(prompts), max_length=self.max_text_length,
                               padding="max_length", truncation=True, return_tensors="np")
        ids = torch.as_tensor(np.asarray(batch["input_ids"]), dtype=torch.long,
                              device=self.device)
        mask = torch.as_tensor(np.asarray(batch["attention_mask"]), dtype=torch.long,
                               device=self.device)
        return self.t5(ids, mask), mask

    # ------------------------------------------------------------ public API
    def generate(self, prompt: str, steps: int = 100, guidance: float = 3.0, samples: int = 1,
                 disable_progress: bool = True, seed: Optional[int] = None,
                 duration: Optional[float] = None):
        """Single prompt -> int16 waveform (T_wav,); with samples > 1 all
        `samples` waveforms (B, T_wav), a deliberate deviation from the
        reference kept from JAX. `duration` in seconds sets the latent length
        (25.6 frames a second, rounded to the UNet's downsampling factor).
        `disable_progress` is accepted, as JAX's is, and changes nothing: the
        port shows no progress bar."""
        latent_t = None
        if duration is not None:
            factor = 2 ** (len(self.model.unet_config.block_out_channels) - 1)
            latent_t = max(int(round(duration * 25.6 / factor)) * factor, factor)
        base = self._base_seed(seed)
        wav = self._generate_batch([prompt], steps, guidance, samples, base, 0, latent_t)
        return wav[0] if samples == 1 else wav[:samples]

    def generate_for_batch(self, prompts: Sequence[str], steps: int = 100,
                           guidance: float = 3.0, samples: int = 1, batch_size: int = 8,
                           disable_progress: bool = True,
                           seed: Optional[int] = None) -> List[np.ndarray]:
        """Prompt list -> list of int16 waveforms (reference tango.py:51-64).
        `disable_progress` is accepted and changes nothing, as in `generate`.

        A short tail chunk is padded up to batch_size, by cycling its prompts,
        whenever a full chunk exists, and under a mesh until its rows divide
        'data'; the padded rows are dropped."""
        base = self._base_seed(seed)
        n_data = 1 if self.mesh is None else self.mesh.shape["data"]
        outputs = []
        for ci, k in enumerate(range(0, len(prompts), batch_size)):
            chunk = list(prompts[k:k + batch_size])
            n_real = len(chunk)
            target = batch_size if len(prompts) > batch_size else n_real
            while len(chunk) < target or (len(chunk) * samples) % n_data:
                chunk.append(chunk[len(chunk) % n_real])
            wavs = self._generate_batch(chunk, steps, guidance, samples, base, ci)
            outputs += list(wavs[: n_real * samples])
        if samples == 1:
            return outputs
        return [outputs[i:i + samples] for i in range(0, len(outputs), samples)]

    def _base_seed(self, seed: Optional[int]) -> int:
        return int(seed) if seed is not None else int(self._rng.integers(2**62))

    def _generate_batch(self, prompts, steps, guidance, samples, base_seed: int, chunk: int,
                        latent_t: Optional[int] = None) -> np.ndarray:
        n = len(prompts) * samples
        rows = pmesh.local_rows(self.mesh, n)
        latents = self.sample_latents(prompts, steps, guidance, samples, base_seed, chunk,
                                      latent_t, rows=rows)
        wavs = self.decode_to_waveform(latents)
        return pmesh.gather_rows(torch.from_numpy(wavs), self.mesh, n).numpy()

    @torch.inference_mode()
    def sample_latents(self, prompts, steps, guidance, samples, base_seed: int, chunk: int = 0,
                       latent_t: Optional[int] = None, rows: Optional[slice] = None
                       ) -> torch.Tensor:
        """Text -> latents (B*samples, T, F, C) f32, row r seeded from
        (base_seed, chunk, r); with `rows`, only those rows of the batch."""
        cond, cond_mask = self.encode_text(prompts)
        if samples > 1:
            cond = cond.repeat_interleave(samples, 0)
            cond_mask = cond_mask.repeat_interleave(samples, 0)
        uncond = uncond_mask = None
        if guidance > 1.0:
            uncond, uncond_mask = self.encode_text([""] * len(prompts))
            if samples > 1:
                uncond = uncond.repeat_interleave(samples, 0)
                uncond_mask = uncond_mask.repeat_interleave(samples, 0)
        rows = rows or slice(None)
        index = range(cond.shape[0])[rows]
        cond, cond_mask = cond[rows], cond_mask[rows]
        if uncond is not None:
            uncond, uncond_mask = uncond[rows], uncond_mask[rows]
        gens = [torch.Generator(device=self.device).manual_seed(_row_seed(base_seed, chunk, r))
                for r in index]
        return self.model.sample(cond, cond_mask, gens, num_steps=steps,
                                 guidance_scale=guidance, uncond_embeds=uncond,
                                 uncond_mask=uncond_mask, latent_t_size=latent_t)

    @torch.inference_mode()
    def decode(self, latents: torch.Tensor):
        """latents (B, T, F, C) -> (mel (B, T', F', 1), float waveform (B, T_wav))."""
        if self.vocoder is None:
            raise RuntimeError("no vocoder: build Tango with a hifigan_config")
        mel = self.vae.decode_first_stage(latents.to(self.device))
        return mel, self.vocoder(mel[..., 0])

    def decode_to_waveform(self, latents: torch.Tensor) -> np.ndarray:
        """latents (B, T, F, C) -> int16 waveforms (B, T_wav)."""
        _, wav = self.decode(latents)
        return waveform_to_int16(wav)

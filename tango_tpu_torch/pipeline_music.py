"""Mustango, music generation: port of tango_tpu/pipeline_music.py.

`Mustango(snapshot_dir).generate(prompt)` predicts beats (a DeBERTa-v3 token
head) and chords (a FLAN-T5 seq2seq with beam search) from the caption,
runs the triple-stream CFG sampler (text, beats, chords) over the music
UNet, decodes with the VAE and HiFi-GAN and returns an int16 16 kHz
waveform. The caller may pass the features instead
(`generate(..., beats=, chords=, chords_times=)`), which skips the
predictors. `generate_for_batch` chunks a prompt list.

The snapshot is the released layout: `configs/` (vae_config.json,
music_diffusion_model_config.json), `vae/pytorch_model_vae.bin` (the VAE and
the vocoder), `ldm/pytorch_model_ldm.bin` (the UNet, the T5 text encoder and
the music conditioner) and, for the predictors,
`beats/microsoft-deberta-v3-large.pt` and `chords/flan-t5-large.bin`. A
snapshot without the last two has no predictor (`predictor is None`), as in
JAX; one whose predictor files are there but do not load raises. The T5 and
vocoder widths come from the tensors. Nothing is downloaded.

JAX runs the path as one jitted program; here the same stages run eagerly:
tokenize (host) -> T5 encode the prompts and "" -> embed the beats and
chords -> the CFG DDPM loop -> VAE decode -> HiFi-GAN -> int16. On the card
the UNet's self-attention and GroupNorms run the port's kernels, as Tango's
do; the predictors, the conditioner and the cross-attention to the 50 beat
and 20 chord tokens are plain PyTorch, as they are XLA in JAX. Runs on CUDA
unless the caller passes `device="cpu"`; the compute dtype is bf16 on the
card and f32 on the CPU, the predictors f32 on both (JAX's are f32 too).

Noise, as in `Tango`: every row draws from its own generator seeded from
(seed, chunk, row), so batch row 0 equals `generate` at the same seed and a
padded tail leaves the real rows unchanged.

Tokenizers are the caller's: `tokenizer=` (FLAN-T5's, for the text encoder),
and the predictor's `beats_tokenizer=` (DeBERTa-v3's) and
`chords_tokenizer=` (FLAN-T5's). Without them the word-hash fallbacks of
`tokenizer.py` are used, with a warning: the real ones need `transformers`,
which the port does not use.

The device mesh (`mesh=`, parallel.mesh), as `Tango`'s: the UNet is
sharded over 'model' by the TP rules (its three streams' transformers
alike), a batch whose rows divide 'data' is spread over it with the same
per-row seeds and its waveforms all-gathered, `generate_for_batch` pads
each chunk until its rows divide 'data', and the predictors, the text
encoder, the conditioner, the VAE and HiFi-GAN run replicated.
"""

from __future__ import annotations

import dataclasses
import json
import os
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tango_tpu_torch import configs as C
from tango_tpu_torch.models.deberta import DebertaV2ForBeats, convert_deberta_beats
from tango_tpu_torch.models.hifigan import HiFiGANGenerator, waveform_to_int16
from tango_tpu_torch.models.layers import frozen
from tango_tpu_torch.models.music import (MusicAudioDiffusion, MusicConditioner,
                                          convert_music_conditioner)
from tango_tpu_torch.models.t5 import (T5Encoder, T5Seq2Seq, convert_t5_encoder,
                                       convert_t5_seq2seq, t5_config_from_state_dict,
                                       t5_seq2seq_config_from_state_dict)
from tango_tpu_torch.models.unet import UNet2DConditionModel
from tango_tpu_torch.models.vae import AutoencoderKL
from tango_tpu_torch.ops.quant import SCOPES, quantize_unet_
from tango_tpu_torch.parallel import mesh as pmesh
from tango_tpu_torch.pipeline import _cast_float_, _row_seed, build_module
from tango_tpu_torch.tokenizer import WordHashTokenizer, deberta_word_hash
from tango_tpu_torch.utils import convert as conv

BEATS_FILE = os.path.join("beats", "microsoft-deberta-v3-large.pt")
CHORDS_FILE = os.path.join("chords", "flan-t5-large.bin")
# the predictors' tokenizer length (JAX pads to it: one shape for any prompt)
PREDICTOR_MAX_LENGTH = 512


def _fallback_tokenizer(what: str, make):
    warnings.warn(
        f"no {what} tokenizer given: the prompt goes through a word-hash tokenizer, not the "
        f"released model's, so it is not tokenized as the model was trained; pass the real "
        f"one", UserWarning, stacklevel=3)
    return make()


class MusicFeaturePredictor:
    """Caption -> (beats, chords, chord_times).

    Post-processing is the reference's: the beat intervals rounded in f32 and
    summed in float64, cut at the first time >= 10 s and at 50 beats, beat
    counts cycling 1..max_beat; chords decoded as "<chord> at <time>" items
    joined by " n ". `beats_fn` / `chords_fn` replace the models (a test's
    stubs); with `path` and no `beats_fn` the models load from the
    snapshot's `beats/` and `chords/` checkpoints on `device`, in f32.
    `beats_config` (DEBERTA_V3_LARGE by default: its heads are not in the
    tensors) and `chords_config` (from the tensors by default) set their
    geometry."""

    def __init__(self, path: Optional[str] = None, device=None, beats_fn=None, chords_fn=None,
                 *, beats_tokenizer=None, chords_tokenizer=None,
                 beats_config: Optional[C.DebertaConfig] = None,
                 chords_config: Optional[C.T5Config] = None):
        self._beats_fn, self._chords_fn = beats_fn, chords_fn
        self.beats_model = self.chords_model = None
        if path is not None and beats_fn is None:
            self._load(path, C.resolve_device(device), beats_tokenizer, chords_tokenizer,
                       beats_config or C.DEBERTA_V3_LARGE, chords_config)

    def _load(self, path, device, beats_tokenizer, chords_tokenizer, beats_config,
              chords_config):
        beats_sd = conv.load_torch_bin(os.path.join(path, BEATS_FILE))
        chords_sd = conv.load_torch_bin(os.path.join(path, CHORDS_FILE))
        chords_config = chords_config or t5_seq2seq_config_from_state_dict(chords_sd)
        self.beats_tokenizer = beats_tokenizer or _fallback_tokenizer(
            "DeBERTa-v3", lambda: deberta_word_hash(beats_config.vocab_size))
        self.chords_tokenizer = chords_tokenizer or _fallback_tokenizer(
            "FLAN-T5", lambda: WordHashTokenizer(chords_config.vocab_size))
        self.beats_model = frozen(lambda: DebertaV2ForBeats(beats_config),
                                  convert_deberta_beats(beats_sd), device)
        self.chords_model = frozen(lambda: T5Seq2Seq(chords_config),
                                   convert_t5_seq2seq(chords_sd), device)
        del beats_sd, chords_sd

        def tokenize(tok, text):
            batch = tok([text], max_length=PREDICTOR_MAX_LENGTH, padding="max_length",
                        truncation=True, return_tensors="np")
            return (torch.as_tensor(np.asarray(batch["input_ids"]), dtype=torch.long,
                                    device=device),
                    torch.as_tensor(np.asarray(batch["attention_mask"]), dtype=torch.long,
                                    device=device))

        @torch.inference_mode()
        def beats_fn(prompt: str):
            ids, mask = tokenize(self.beats_tokenizer, prompt)
            logits, values = self.beats_model(ids, mask)
            n = int(mask[0].sum())
            return logits[0, 0].float().cpu().numpy(), values[0, :n, 0].float().cpu().numpy()

        def chords_fn(cprompt: str):
            ids, mask = tokenize(self.chords_tokenizer, cprompt)
            out = self.chords_model.generate(ids, mask, num_beams=5, min_length=8,
                                             max_length=128, early_stopping=True)
            return self.chords_tokenizer.decode(out, skip_special_tokens=True,
                                                clean_up_tokenization_spaces=True)

        self._beats_fn, self._chords_fn = beats_fn, chords_fn

    @staticmethod
    def postprocess_beats(logits_first_token: np.ndarray, intervals: np.ndarray):
        """(num_classes,), (L,) -> (max_beat, beat_times, beats)."""
        max_beat = int(1 + np.argmax(logits_first_token))
        # the reference rounds in f32 and sums in float64 (Python floats)
        cums = np.cumsum(np.round(intervals.astype(np.float32), 4).astype(np.float64))
        # a break, not a filter: negative intervals can bring the sum back
        # under 10 s, and those later beats are not kept
        beat_times = []
        for t in cums:
            if t >= 10:
                break
            beat_times.append(round(float(t), 2))
        beat_times = beat_times[:50]
        if not beat_times:
            return max_beat, [], [[], []]
        counts = [float(1.0 + np.mod(i, max_beat)) for i in range(len(beat_times))]
        return max_beat, beat_times, [[beat_times, counts]]

    @staticmethod
    def chords_prompt(prompt: str, beat_times: Sequence[float], max_beat: int) -> str:
        return "Caption: {} \\n Timestamps: {} \\n Max Beat: {}".format(
            prompt, " , ".join(str(round(t, 2)) for t in beat_times), max_beat)

    @staticmethod
    def parse_chords(decoded: str) -> Tuple[List[str], List[float]]:
        """"Gm at 0.46 n Eb at 1.39" -> (["Gm", "Eb"], [0.46, 1.39]); malformed
        items (not one " at ", or a time that is not a number) are skipped."""
        chords, times = [], []
        for item in decoded.split(" n "):
            parts = item.split(" at ")
            if len(parts) != 2:
                continue
            c, ct = parts
            try:
                times.append(float(ct))
            except ValueError:
                continue
            chords.append(c.strip())
        return chords, times

    def generate(self, prompt: str):
        if self._beats_fn is None or self._chords_fn is None:
            raise RuntimeError("No music predictors available; pass beats explicitly")
        logits, intervals = self._beats_fn(prompt)
        max_beat, beat_times, beats = self.postprocess_beats(np.asarray(logits),
                                                             np.asarray(intervals))
        decoded = self._chords_fn(self.chords_prompt(prompt, beat_times, max_beat))
        chords, chord_times = self.parse_chords(decoded)
        return beats, chords, chord_times


def convert_mustango_ldm(sd) -> Dict[str, Optional[dict]]:
    """pytorch_model_ldm.bin -> {unet_params, t5_params, conditioner_params}
    state dicts of the port's modules (None where the bin has no such keys)."""
    unet_sd = {k[len("unet."):]: v for k, v in sd.items() if k.startswith("unet.")}
    text_sd = {k[len("text_encoder."):]: v for k, v in sd.items()
               if k.startswith("text_encoder.")}
    music_sd = {k: v for k, v in sd.items()
                if k.startswith(("FME.", "beat_embedding_layer.", "chord_embedding_layer."))}
    return {
        "unet_params": conv.convert_unet(unet_sd),
        "t5_params": convert_t5_encoder(text_sd) if text_sd else None,
        "conditioner_params": convert_music_conditioner(music_sd) if music_sd else None,
    }


def _read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_mustango_snapshot(path: str, with_encoder: bool = False) -> dict:
    """A released-layout Mustango snapshot -> {unet_config, vae_config,
    t5_config (or None), hifigan_config (or None), unet_params, t5_params,
    conditioner_params, vae_params, hifigan_params}: configs of this package
    and state dicts of f32 CPU tensors (the VAE's decode side, and with
    `with_encoder` its encoder too). The widths of T5 and the vocoder come
    from the tensors."""
    vae_sd = conv.load_torch_bin(os.path.join(path, "vae", "pytorch_model_vae.bin"))
    voc_sd = {k[len("vocoder."):]: v for k, v in vae_sd.items() if k.startswith("vocoder.")}
    hifigan_config = None
    if voc_sd:
        w = voc_sd.get("conv_pre.weight_v", voc_sd.get("conv_pre.weight"))
        hifigan_config = dataclasses.replace(
            C.TANGO_HIFIGAN, upsample_initial_channel=int(w.shape[0]), num_mels=int(w.shape[1]))
    out = {
        "vae_config": C.VAEConfig.from_dict(
            _read_json(os.path.join(path, "configs", "vae_config.json"))),
        "unet_config": C.UNetConfig.from_dict(
            _read_json(os.path.join(path, "configs", "music_diffusion_model_config.json"))),
        "vae_params": conv.convert_vae(vae_sd, with_encoder=with_encoder),
        "hifigan_params": conv.convert_hifigan(voc_sd) if voc_sd else None,
        "hifigan_config": hifigan_config,
    }
    del vae_sd, voc_sd
    ldm_sd = conv.load_torch_bin(os.path.join(path, "ldm", "pytorch_model_ldm.bin"))
    text_sd = {k[len("text_encoder."):]: v for k, v in ldm_sd.items()
               if k.startswith("text_encoder.")}
    out["t5_config"] = t5_config_from_state_dict(text_sd) if text_sd else None
    out.update(convert_mustango_ldm(ldm_sd))
    return out


class Mustango:
    """Text -> 16 kHz music (reference mustango/mustango.py:135-204)."""

    def __init__(self, name_or_path: Optional[str] = None, tokenizer=None,
                 dtype: Optional[torch.dtype] = None,
                 predictor: Optional[MusicFeaturePredictor] = None, quant: Optional[str] = None,
                 mesh=None, device=None):
        """Load the released-layout snapshot directory `name_or_path` (or,
        with None, an empty pipeline for `from_components`). The parameters
        are JAX's, in its order; `device`, the port's own, comes last."""
        if quant not in (None, False, *SCOPES):
            raise ValueError(f"quant must be one of None/'conv'/'dense'/'all', got {quant!r}")
        self.quant = quant or None
        self.mesh = mesh
        self.device = C.resolve_device(device)
        self.dtype = dtype or C.default_dtype(self.device)
        self.tokenizer = tokenizer
        self.predictor = predictor
        self.max_text_length = 128
        self._rng = np.random.default_rng(0)
        self.model = self.vae = self.t5 = self.vocoder = None
        if name_or_path is None:
            return
        if not os.path.isdir(name_or_path):
            raise FileNotFoundError(
                f"{name_or_path!r} is not a directory. The port downloads nothing: pass a local "
                "released-layout Mustango snapshot (configs/, vae/, ldm/, and beats/ and "
                "chords/ for the predictors)")
        self._load_snapshot(name_or_path)

    def _load_snapshot(self, path: str) -> None:
        loaded = load_mustango_snapshot(path)
        t5_config = loaded["t5_config"] or C.FLAN_T5_LARGE
        self._build(loaded["unet_config"], loaded["vae_config"],
                    unet_params=loaded["unet_params"], vae_params=loaded["vae_params"],
                    conditioner_params=loaded["conditioner_params"],
                    t5_params=loaded["t5_params"],
                    t5_config=t5_config if loaded["t5_params"] is not None else None,
                    hifigan_config=loaded["hifigan_config"],
                    hifigan_params=loaded["hifigan_params"])
        del loaded
        # no predictor checkpoints: no predictor, as in JAX; checkpoints that
        # are there but do not load raise
        if self.predictor is None and all(
                os.path.exists(os.path.join(path, f)) for f in (BEATS_FILE, CHORDS_FILE)):
            self.predictor = MusicFeaturePredictor(path, device=self.device)
        if self.tokenizer is None:
            self.tokenizer = _fallback_tokenizer(
                "FLAN-T5", lambda: WordHashTokenizer(t5_config.vocab_size))

    @classmethod
    def from_components(cls, *, unet_config: C.UNetConfig, vae_config: C.VAEConfig,
                        unet_params=None, vae_params=None, conditioner_params=None,
                        t5_config: Optional[C.T5Config] = None, t5_params=None,
                        hifigan_config: Optional[C.HiFiGANConfig] = None, hifigan_params=None,
                        tokenizer=None, predictor: Optional[MusicFeaturePredictor] = None,
                        dtype: Optional[torch.dtype] = None, latent_t_size: int = 256,
                        latent_f_size: int = 16, d_music: Optional[int] = None,
                        quant: Optional[str] = None, mesh=None, device=None,
                        init_seed: int = 0) -> "Mustango":
        """Build from configs and state dicts of this package's modules. A
        component whose params are None gets seeded random weights drawn on
        the device from `init_seed` (JAX requires the params); T5 and
        HiFi-GAN are built when their config or params are given. With
        `quant`, `unet_params` is the float UNet's: it is quantized here from
        f32, as JAX quantizes its f32 tree. The parameters are JAX's, in its
        order; the port's own (`device`, `init_seed`) come last."""
        self = cls(None, tokenizer=tokenizer, dtype=dtype, predictor=predictor, quant=quant,
                   mesh=mesh, device=device)
        if self.tokenizer is None and t5_config is not None:
            self.tokenizer = WordHashTokenizer(t5_config.vocab_size)
        self._build(unet_config, vae_config, unet_params=unet_params, vae_params=vae_params,
                    conditioner_params=conditioner_params, t5_params=t5_params,
                    t5_config=t5_config, hifigan_config=hifigan_config,
                    hifigan_params=hifigan_params, latent_t_size=latent_t_size,
                    latent_f_size=latent_f_size, d_music=d_music, init_seed=init_seed)
        return self

    def _build(self, unet_cfg, vae_cfg, *, unet_params, vae_params, conditioner_params,
               t5_params=None, t5_config=None, hifigan_config=None, hifigan_params=None,
               latent_t_size: int = 256, latent_f_size: int = 16, d_music=None,
               init_seed: int = 0) -> None:

        def build(k: int, make, params, dtype=self.dtype):
            return build_module(make, params, self.device, dtype, init_seed * 16 + k)

        # int8: the f32 weights quantized, the float remainder cast after
        unet = build(0, lambda: UNet2DConditionModel(unet_cfg), unet_params,
                     torch.float32 if self.quant else self.dtype)
        if self.quant:
            quantize_unet_(unet, self.quant)
            _cast_float_(unet, self.dtype)
            unet.cfg = dataclasses.replace(unet_cfg, quant_int8=True, quant_scope=self.quant)
        if self.mesh is not None:
            pmesh.shard_params(unet, self.mesh)
        d_music = d_music or unet_cfg.cross_attention_dim
        cond = build(4, lambda: MusicConditioner(d_model=d_music), conditioner_params)
        self.model = MusicAudioDiffusion(unet, C.SD21_SCHEDULER, latent_t_size=latent_t_size,
                                         latent_f_size=latent_f_size, d_music=d_music,
                                         conditioner=cond)
        self.vae = build(1, lambda: AutoencoderKL(vae_cfg), vae_params)
        if t5_config is not None or t5_params is not None:
            self.t5 = build(2, lambda: T5Encoder(t5_config or C.FLAN_T5_LARGE), t5_params)
        if hifigan_config is not None or hifigan_params is not None:
            self.vocoder = build(3, lambda: HiFiGANGenerator(hifigan_config or C.TANGO_HIFIGAN),
                                 hifigan_params)

    # ------------------------------------------------------------- text side
    @torch.inference_mode()
    def encode_text(self, prompts: Sequence[str], max_length: int = 128):
        """Tokenize (host) + T5 encode (device) -> (embeds (B, S, D), mask (B, S))."""
        if self.tokenizer is None or self.t5 is None:
            raise RuntimeError("text encoding needs a tokenizer and a T5 encoder")
        batch = self.tokenizer(list(prompts), max_length=max_length, padding="max_length",
                               truncation=True, return_tensors="np")
        ids = torch.as_tensor(np.asarray(batch["input_ids"]), dtype=torch.long,
                              device=self.device)
        mask = torch.as_tensor(np.asarray(batch["attention_mask"]), dtype=torch.long,
                               device=self.device)
        return self.t5(ids, mask), mask

    # ------------------------------------------------------------ public API
    def generate(self, prompt: str, steps: int = 100, guidance: float = 3.0, samples: int = 1,
                 disable_progress: bool = True, beats=None, chords=None, chords_times=None,
                 seed: Optional[int] = None) -> np.ndarray:
        """Single prompt -> int16 waveform (T_wav,). Without `beats` the
        predictor makes the features. `samples` and `disable_progress` are
        accepted, as JAX's are, and change nothing: one waveform comes back,
        and there is no progress bar."""
        if beats is None:
            assert self.predictor is not None, "no music predictor; pass beats/chords"
            beats, chords, chords_times = self.predictor.generate(prompt)
        b_struct = beats[0] if beats and beats[0] else [[], []]
        return self._generate_batch([prompt], [b_struct], [chords], [chords_times], steps,
                                    guidance, self._base_seed(seed), 0)[0]

    def generate_for_batch(self, prompts: Sequence[str], steps: int = 100,
                           guidance: float = 3.0, batch_size: int = 4, beats=None, chords=None,
                           chords_times=None, seed: Optional[int] = None,
                           disable_progress: bool = True) -> List[np.ndarray]:
        """Prompt list -> list of int16 waveforms, one padded batch a chunk.

        Without features the predictors run once for each distinct prompt;
        otherwise beats, chords and chords_times are per-prompt lists. A
        short tail chunk is padded up to batch_size, by cycling its prompts,
        whenever a full chunk exists, and under a mesh until its rows divide
        'data'; the padded rows are dropped."""
        prompts = list(prompts)
        if not prompts:
            return []
        if beats is None:
            assert self.predictor is not None, "no music predictor; pass beats/chords"
            feats = {}
            for p in prompts:  # the predictors are deterministic
                if p not in feats:
                    feats[p] = self.predictor.generate(p)
            beats = [feats[p][0] for p in prompts]
            chords = [feats[p][1] for p in prompts]
            chords_times = [feats[p][2] for p in prompts]
        if chords is None or chords_times is None:
            raise ValueError("beats/chords/chords_times must be passed together (per-prompt "
                             "lists) or all left None to run the predictors")
        assert len(beats) == len(chords) == len(chords_times) == len(prompts), (
            "beats/chords/chords_times must be per-prompt lists")
        base = self._base_seed(seed)
        n_data = 1 if self.mesh is None else self.mesh.shape["data"]
        outputs: List[np.ndarray] = []
        n = len(prompts)
        for ci, k in enumerate(range(0, n, batch_size)):
            idx = list(range(k, min(k + batch_size, n)))
            n_real = len(idx)
            target = batch_size if n > batch_size else n_real
            while len(idx) < target or len(idx) % n_data:
                idx.append(idx[len(idx) % n_real])
            b_struct = [beats[i][0] if beats[i] and beats[i][0] else [[], []] for i in idx]
            wavs = self._generate_batch([prompts[i] for i in idx], b_struct,
                                        [chords[i] for i in idx],
                                        [chords_times[i] for i in idx], steps, guidance, base, ci)
            outputs += list(wavs[:n_real])
        return outputs

    def _base_seed(self, seed: Optional[int]) -> int:
        return int(seed) if seed is not None else int(self._rng.integers(2**62))

    def _generate_batch(self, prompts, beats, chords, chords_times, steps, guidance,
                        base_seed: int, chunk: int) -> np.ndarray:
        n = len(prompts)
        rows = pmesh.local_rows(self.mesh, n)
        latents = self.sample_latents(prompts, beats, chords, chords_times, steps, guidance,
                                      base_seed, chunk, rows=rows)
        wavs = self.decode_to_waveform(latents)
        return pmesh.gather_rows(torch.from_numpy(wavs), self.mesh, n).numpy()

    @torch.inference_mode()
    def sample_latents(self, prompts, beats, chords, chords_times, steps, guidance,
                       base_seed: int, chunk: int = 0, rows: Optional[slice] = None
                       ) -> torch.Tensor:
        """Prompts and per-row features (one [[times], [types]] a row) ->
        latents (B, T, F, C) f32, row r seeded from (base_seed, chunk, r);
        with `rows`, only those rows of the batch."""
        rows = rows or slice(None)
        index = range(len(prompts))[rows]
        cond, cond_mask = self.encode_text(list(prompts)[rows], self.max_text_length)
        uncond, uncond_mask = self.encode_text([""] * len(index), self.max_text_length)
        m = self.model
        beat_emb, beat_mask, chord_emb, chord_mask = m.encode_music(
            list(beats)[rows], list(chords)[rows], list(chords_times)[rows])
        gens = [torch.Generator(device=self.device).manual_seed(_row_seed(base_seed, chunk, r))
                for r in index]
        return m.music_sample(cond, cond_mask, gens, beat_emb, beat_mask, chord_emb, chord_mask,
                              num_steps=steps, guidance_scale=guidance, uncond_embeds=uncond,
                              uncond_mask=uncond_mask, conditioner=m.conditioner)

    @torch.inference_mode()
    def decode(self, latents: torch.Tensor):
        """latents (B, T, F, C) -> (mel (B, T', F', 1), float waveform (B, T_wav))."""
        if self.vocoder is None:
            raise RuntimeError("no vocoder: build Mustango with a hifigan_config")
        mel = self.vae.decode_first_stage(latents.to(self.device))
        return mel, self.vocoder(mel[..., 0])

    def decode_to_waveform(self, latents: torch.Tensor) -> np.ndarray:
        """latents (B, T, F, C) -> int16 waveforms (B, T_wav)."""
        _, wav = self.decode(latents)
        return waveform_to_int16(wav)

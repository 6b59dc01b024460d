"""Mustango's music conditioning, port of tango_tpu/models/music.py.

  * host tokenizers: chords ("Gm7/Bb" -> root, type, inversion ids) and
    beats (type ids), padded to fixed lengths (beats 50, chords 20);
  * `fme_encode`, the Fundamental Music Embedding: sin at even and cos at
    odd dims of value * base^(-2*(i//2)/d), the rates in float64 numpy and
    then cast to f32, as JAX computes them;
  * `MusicConditioner`: a beat embedding (one-hot type ++ FME of the time ->
    Linear) and a chord embedding (FME of the root + a trained translation
    bias ++ one-hot type ++ one-hot inversion ++ FME of the time -> Linear);
  * `MusicAudioDiffusion`: AudioDiffusion over the triple-stream UNet (text,
    beats, chords; `UNetConfig.extra_cond_streams = 2`). Its CFG
    unconditional half embeds tokenized-empty beats and chords with their
    own masks, as the reference does, when given the conditioner.

These are small host-side and plain-PyTorch pieces, XLA in JAX: no kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tango_tpu_torch.models.diffusion import AudioDiffusion, Generators

# ------------------------------------------------------- host-side tokenizers

PITCH_DICT = {
    "pad": 0, "None": 1, "N": 1, "A": 2, "A#": 3, "Bb": 3, "B": 4, "Cb": 4,
    "B#": 5, "C": 5, "C#": 6, "Db": 6, "D": 7, "D#": 8, "Eb": 8, "E": 9,
    "Fb": 9, "E#": 10, "F": 10, "F#": 11, "Gb": 11, "G": 12, "G#": 13, "Ab": 13,
}
CHORD_TYPE_DICT = {
    "pad": 0, "None": 1, "N": 1, "maj": 2, "maj7": 3, "m": 4, "m6": 5,
    "m7": 6, "m7b5": 7, "6": 8, "7": 9, "aug": 10, "dim": 11,
}
CHORD_INV_DICT = {"pad": 0, "None": 1, "N": 1, "inv": 2, "no_inv": 3}
BEAT_DICT = {"pad": 0, "None": 1, 1.0: 2, 2.0: 3, 3.0: 4, 4.0: 5, 5.0: 6, 6.0: 7, 7.0: 8}


def parse_chord(chord: str) -> Tuple[str, str, str]:
    """"Gm7/Bb" -> (root, type, inversion)."""
    if chord == "pad":
        return "pad", "pad", "pad"
    if chord == "N":
        return "N", "N", "N"
    inv = "inv" if len(chord.split("/")) > 1 else "no_inv"
    body = chord.split("/")[0]
    root = body[:2] if len(body) > 1 and body[1] in "#b" else body[0]
    ctype = body[len(root):] if len(body) > len(root) else "maj"
    return root, ctype, inv


def tokenize_chords(chords: Sequence[str], chord_times: Sequence[float], seq_len: int = 20):
    """One sample -> (root, type, inv, time, mask) lists padded to seq_len. No
    chords is one "N" chord at 0 s."""
    chords, chord_times = list(chords), list(chord_times)
    if not chords:
        chords, chord_times = ["N"], [0.0]
    chords, chord_times = chords[:seq_len], chord_times[:seq_len]
    pad = seq_len - len(chords)
    mask = [1] * len(chords) + [0] * pad
    chords = chords + ["pad"] * pad
    chord_times = chord_times + [chord_times[-1]] * pad
    roots, types, invs = [], [], []
    for ch in chords:
        r, t, i = parse_chord(ch)
        roots.append(PITCH_DICT[r])
        types.append(CHORD_TYPE_DICT[t])
        invs.append(CHORD_INV_DICT[i])
    return roots, types, invs, chord_times, mask


def tokenize_beats(beats, seq_len: int = 50):
    """One sample [[times], [types]] -> (type ids, times, mask), truncated or
    padded to seq_len. Beat types 6.0 and 7.0 give ids past the one-hot
    depth of 7 and raise, as the reference's F.one_hot does."""
    times, types = list(beats[0]), list(beats[1])
    if not times:
        return [0] * seq_len, [0.0] * seq_len, [0] * seq_len
    times, types = times[:seq_len], types[:seq_len]
    pad = seq_len - len(times)
    mask = [1] * len(times) + [0] * pad
    times = times + [times[-1]] * pad
    type_ids = [BEAT_DICT[float(x)] for x in types] + [0] * pad
    if max(type_ids) >= 7:
        raise ValueError("beat type ids >= 7 overflow the one-hot depth")
    return type_ids, times, mask


def batch_tokenize_beats(batch_beats, seq_len: int = 50):
    """-> (ids, times f32, mask) numpy arrays (B, seq_len)."""
    ids, times, masks = zip(*(tokenize_beats(b, seq_len) for b in batch_beats))
    return np.asarray(ids), np.asarray(times, np.float32), np.asarray(masks)


def batch_tokenize_chords(batch_chords, batch_times, seq_len: int = 20):
    """-> (roots, types, invs, times f32, mask) numpy arrays (B, seq_len)."""
    rows = [tokenize_chords(c, t, seq_len) for c, t in zip(batch_chords, batch_times)]
    roots, types, invs, times, masks = zip(*rows)
    return (np.asarray(roots), np.asarray(types), np.asarray(invs),
            np.asarray(times, np.float32), np.asarray(masks))


# -------------------------------------------------------------- device modules

def fme_encode(values: torch.Tensor, d_model: int, base: float) -> torch.Tensor:
    """(B, L) values -> (B, L, d_model) f32, without the translation bias."""
    i = np.arange(d_model)
    rates = (1.0 / np.power(base, (2 * (i // 2)) / d_model)).astype(np.float32)
    ang = values[..., None].float() * torch.from_numpy(rates).to(values.device)
    out = torch.empty_like(ang)
    out[..., 0::2] = torch.sin(ang[..., 0::2])
    out[..., 1::2] = torch.cos(ang[..., 1::2])
    return out


class MusicConditioner(nn.Module):
    """Beat and chord embedders (the trained parts: the FME translation bias
    and the two Linears). Inputs are the tokenizers' arrays as tensors."""

    def __init__(self, d_model: int = 1024, fme_base: float = 1.0, time_base: float = 10001.0,
                 d_oh_beat_type: int = 7, d_oh_chord_type: int = 12, d_oh_inv: int = 4):
        super().__init__()
        self.d_model, self.fme_base, self.time_base = d_model, fme_base, time_base
        self.d_oh_beat_type, self.d_oh_chord_type, self.d_oh_inv = (
            d_oh_beat_type, d_oh_chord_type, d_oh_inv)
        self.fme_translation_bias = nn.Parameter(torch.zeros(1, d_model))
        self.beat_ffn = nn.Linear(d_oh_beat_type + d_model, d_model)
        self.chord_ffn = nn.Linear(2 * d_model + d_oh_chord_type + d_oh_inv, d_model)

    def embed_beats(self, beat_ids, beat_times):
        """(B, L) ids and times -> (B, L, d)."""
        oh = F.one_hot(beat_ids.long(), self.d_oh_beat_type).float()
        time_emb = fme_encode(beat_times, self.d_model, self.time_base)
        merged = torch.cat([oh, time_emb], dim=-1).to(self.beat_ffn.weight.dtype)
        return self.beat_ffn(merged)

    def embed_chords(self, roots, types, invs, times):
        """(B, L) roots, types, inversions and times -> (B, L, d)."""
        root_emb = (fme_encode(roots.float(), self.d_model, self.fme_base)
                    + self.fme_translation_bias.float())
        type_oh = F.one_hot(types.long(), self.d_oh_chord_type).float()
        inv_oh = F.one_hot(invs.long(), self.d_oh_inv).float()
        time_emb = fme_encode(times, self.d_model, self.time_base)
        merged = torch.cat([root_emb, type_oh, inv_oh, time_emb], dim=-1)
        return self.chord_ffn(merged.to(self.chord_ffn.weight.dtype))

    def forward(self, beat_ids, beat_times, roots, types, invs, chord_times):
        return (self.embed_beats(beat_ids, beat_times),
                self.embed_chords(roots, types, invs, chord_times))


@dataclasses.dataclass(eq=False)
class MusicAudioDiffusion(AudioDiffusion):
    """AudioDiffusion with the beat and chord streams. The UNet must have
    `extra_cond_streams == 2`; `conditioner` is a MusicConditioner of width
    `d_music`, built beside the UNet (weights uninitialised) when None."""

    beat_len: int = 50
    chord_len: int = 20
    d_music: int = 1024
    conditioner: Optional[MusicConditioner] = None

    def __post_init__(self):
        super().__post_init__()
        assert self.unet_config.extra_cond_streams == 2, "music UNet needs 2 extra streams"
        if self.conditioner is None:
            w = self.unet.conv_in.weight
            with torch.device("meta"):
                cond = MusicConditioner(d_model=self.d_music)
            self.conditioner = cond.to_empty(device=w.device).to(w.dtype)

    def encode_music(self, beats, chords, chords_time, conditioner=None):
        """Host tokenize + device embed -> (beat_emb, beat_mask, chord_emb,
        chord_mask), the masks long tensors. `beats` is one [[times], [types]]
        a sample."""
        cond = self.conditioner if conditioner is None else conditioner
        device = cond.beat_ffn.weight.device
        b_ids, b_times, b_mask = batch_tokenize_beats(beats, self.beat_len)
        c_roots, c_types, c_invs, c_times, c_mask = batch_tokenize_chords(
            chords, chords_time, self.chord_len)
        t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
        beat_emb, chord_emb = cond(t(b_ids), t(b_times), t(c_roots), t(c_types), t(c_invs),
                                   t(c_times))
        return beat_emb, t(b_mask).long(), chord_emb, t(c_mask).long()

    def music_loss(self, latents, text_embeds, text_mask, generator, beat_emb, beat_mask,
                   chord_emb, chord_mask, validation_mode: bool = False, **draws):
        """The training loss with the music streams; `draws` are `loss`'s
        `timesteps=`, `noise=`, `drop=`."""
        return self.loss(latents, text_embeds, text_mask, generator, validation_mode,
                         extra_contexts=(beat_emb, chord_emb),
                         extra_masks=(beat_mask, chord_mask), **draws)

    @torch.no_grad()
    def music_sample(self, cond_embeds, cond_mask, generator: Generators, beat_emb, beat_mask,
                     chord_emb, chord_mask, num_steps: int = 200, guidance_scale: float = 3.0,
                     uncond_embeds=None, uncond_mask=None,
                     conditioner: Optional[MusicConditioner] = None,
                     noise_override=None, latent_t_size: Optional[int] = None):
        """CFG sampling with the music streams. With `conditioner` (JAX's
        `cond_params`) the unconditional half embeds tokenized-empty beats
        (all padding, mask all 0) and chords (one "N" token, mask [1, 0, ...])
        with their own masks, as the reference does; without it the
        unconditional streams are zeros under the conditional masks."""
        if conditioner is not None:
            n = beat_emb.shape[0]
            ub_emb, ub_mask, uc_emb, uc_mask = self.encode_music(
                [[[], []]] * n, [[]] * n, [[]] * n, conditioner)
            uncond_extras, uncond_extra_masks = (ub_emb, uc_emb), (ub_mask, uc_mask)
        else:
            uncond_extras = (torch.zeros_like(beat_emb), torch.zeros_like(chord_emb))
            uncond_extra_masks = ()
        return self.sample(cond_embeds, cond_mask, generator, num_steps=num_steps,
                           guidance_scale=guidance_scale, uncond_embeds=uncond_embeds,
                           uncond_mask=uncond_mask, extra_contexts=(beat_emb, chord_emb),
                           extra_masks=(beat_mask, chord_mask),
                           uncond_extra_contexts=uncond_extras,
                           uncond_extra_masks=uncond_extra_masks,
                           noise_override=noise_override, latent_t_size=latent_t_size)


def convert_music_conditioner(sd: Mapping[str, torch.Tensor]) -> dict:
    """The music layers of Mustango's ldm bin (`FME.translation_bias`,
    `beat_embedding_layer.beat_ffn.*`, `chord_embedding_layer.chord_ffn.*`)
    -> the MusicConditioner's state dict."""
    return {
        "fme_translation_bias": sd["FME.translation_bias"],
        "beat_ffn.weight": sd["beat_embedding_layer.beat_ffn.weight"],
        "beat_ffn.bias": sd["beat_embedding_layer.beat_ffn.bias"],
        "chord_ffn.weight": sd["chord_embedding_layer.chord_ffn.weight"],
        "chord_ffn.bias": sd["chord_embedding_layer.chord_ffn.bias"],
    }

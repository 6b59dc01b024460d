"""PANN-14 CLAP audio tower, the alternative to HTSAT: port of
tango_tpu/models/pann.py.

The trunk is the evaluation's Cnn14 (eval/panns.py: the same module names,
bn0 / conv_block1..6 / fc1 / fc_audioset); this module adds CLAP's 48 kHz
frontend config (PANN-14.json: window 1024, hop 480, 64 mels in [50, 14000]
Hz, joint dim 2048), the projection head and the `audio_branch.` /
`audio_projection.` converter.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import torch
import torch.nn as nn
import torch.nn.functional as F

from tango_tpu_torch.eval.panns import Cnn14, convert_cnn14, logmel_frontend
from tango_tpu_torch.models.htsat import convert_projection, l2_normalize
from tango_tpu_torch.utils.convert import StateDict


@dataclasses.dataclass(frozen=True)
class PANNAudioConfig:
    """model_configs/PANN-14.json audio_cfg + joint embed dim."""

    sample_rate: int = 48000
    clip_samples: int = 480000
    stft_window_size: int = 1024
    hop_size: int = 480
    mel_bins: int = 64
    fmin: float = 50.0
    fmax: float = 14000.0
    class_num: int = 527
    joint_embed_dim: int = 2048  # PANN-14.json embed_dim


PANN_14 = PANNAudioConfig()


def pann_logmel(wav48k: torch.Tensor, cfg: PANNAudioConfig = PANN_14) -> torch.Tensor:
    """(B, L) 48 kHz waveform -> (B, T, 64) log-mel, torchlibrosa semantics."""
    return logmel_frontend(wav48k, sr=cfg.sample_rate, n_fft=cfg.stft_window_size,
                           hop=cfg.hop_size, n_mels=cfg.mel_bins, fmin=cfg.fmin, fmax=cfg.fmax)


class ClapPannAudioEncoder(nn.Module):
    """(B, T, 64) log-mel -> L2-normalized joint-space embedding; the
    interface of htsat.ClapAudioEncoder, so that `Clap` can swap towers."""

    def __init__(self, cfg: PANNAudioConfig = PANN_14):
        super().__init__()
        self.cfg = cfg
        self.cnn14 = Cnn14(classes_num=cfg.class_num)
        self.proj_0 = nn.Linear(2048, cfg.joint_embed_dim)
        self.proj_2 = nn.Linear(cfg.joint_embed_dim, cfg.joint_embed_dim)

    def forward(self, logmel: torch.Tensor) -> torch.Tensor:
        e = self.cnn14(logmel)["2048"]  # relu(fc1(.)), the reference's embedding
        return l2_normalize(self.proj_2(F.relu(self.proj_0(e))))


def convert_clap_pann(sd: Mapping, prefix: str = "") -> StateDict:
    """CLAP's audio side for the PANN tower, {prefix}audio_branch.* (Cnn14's
    names) and {prefix}audio_projection.{0,2}.* -> ClapPannAudioEncoder's."""
    ab = prefix + "audio_branch."
    trunk = convert_cnn14({k[len(ab):]: v for k, v in sd.items() if k.startswith(ab)})
    out = {f"cnn14.{k}": v for k, v in trunk.items()}
    out.update(convert_projection(sd, prefix + "audio_projection"))
    return out

"""EvaluationHelper, which runs the metrics over two WAV directories: port of
tango_tpu/eval/evaluator.py, with the reference's API and result keys
(audioldm_eval/eval.py:21-325).

The same-name pairing gate; FD (Cnn14's 2048-d embedding), FAD (VGGish),
KL softmax / sigmoid, IS and KID (Cnn14's logits), LSD / SSIM of the STFT
and PSNR / SSIM of paired mels; `<gen_dir>_evaluation_results.json` with
the same keys. Cnn14 and VGGish run on the helper's device (the card unless
`device` names another), in batches: files are bucketed by length and the
last batch of a bucket is padded by repetition, as JAX pads to one compiled
shape, so the numbers are JAX's. Their weights load from the released torch
checkpoints (`cnn14_ckpt`, `vggish_ckpt`); a metric whose extractor has no
weights is NaN.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from tango_tpu_torch.audio.stft import MelSpectrogram
from tango_tpu_torch.audio.wav import read_wav, resample_poly
from tango_tpu_torch.configs import StftConfig, resolve_device
from tango_tpu_torch.eval import metrics as M
from tango_tpu_torch.eval.panns import Cnn14, convert_cnn14, logmel_frontend
from tango_tpu_torch.eval.vggish import VGGish, convert_vggish, waveform_to_examples
from tango_tpu_torch.models.layers import frozen


def _decimate_or_resample(wav: np.ndarray, sr: int, target_sr: int) -> np.ndarray:
    """The reference loaders' rate conversion: plain ::2 / ::3 decimation
    for 32 / 48 kHz -> 16 kHz, a resample otherwise (load_mel.py:165-173)."""
    if sr == target_sr:
        return wav
    if target_sr == 16000 and sr == 32000:
        return wav[::2]
    if target_sr == 16000 and sr == 48000:
        return wav[::3]
    return resample_poly(wav, sr, target_sr)


def _read_wave_dataset(path: str, target_sr: int) -> np.ndarray:
    """WaveDataset.read_from_file (load_mel.py:160-175): the first channel,
    mean-subtracted, decimated or resampled, zero-padded to >= 32000
    samples. No amplitude normalisation: Cnn14's log-mel is not scale
    invariant."""
    wav, sr = read_wav(path)
    if wav.ndim > 1:
        wav = wav[:, 0]
    wav = wav.astype(np.float32)
    wav = wav - wav.mean()
    wav = _decimate_or_resample(wav, sr, target_sr)
    if len(wav) < 32000:
        wav = np.pad(wav, (0, 32000 - len(wav)))
    return wav.astype(np.float32)


def _read_fad(path: str, target_sr: int) -> np.ndarray:
    """The FAD loader (metrics/fad.py:21-41): int16 / 32768, stereo by the
    channels' MEAN, 32 kHz decimated ::2 else resampled; no padding, no mean
    subtraction, no normalisation."""
    wav, sr = read_wav(path)
    if wav.ndim > 1:
        wav = wav.mean(axis=1)
    wav = wav.astype(np.float32)
    if sr != target_sr:
        wav = (wav[::2] if (target_sr == 16000 and sr == 32000)
               else resample_poly(wav, sr, target_sr))
    return wav.astype(np.float32)


def _read_paired(path: str, target_sr: int) -> np.ndarray:
    """MelPairedDataset's audio (load_mel.py:88-105): the first channel,
    mean-subtracted, resampled; no padding."""
    wav, sr = read_wav(path)
    if wav.ndim > 1:
        wav = wav[:, 0]
    wav = wav.astype(np.float32)
    wav = wav - wav.mean()
    if sr != target_sr:
        wav = resample_poly(wav, sr, target_sr)
    return wav.astype(np.float32)


class EvaluationHelper:
    # extraction batch: Cnn14 takes this many clips of one length a call,
    # VGGish four times as many examples
    batch_size: int = 16

    def __init__(self, sampling_rate: int = 16000, device=None, backbone: str = "cnn14",
                 cnn14_ckpt: Optional[str] = None, vggish_ckpt: Optional[str] = None):
        if sampling_rate != 16000:
            raise ValueError("16 kHz evaluation only (the reference also supports 32k)")
        from tango_tpu_torch.utils.convert import load_torch_bin

        self.sampling_rate = sampling_rate
        self.device = resolve_device(device)
        self.cnn14 = self.vggish = None
        if cnn14_ckpt and os.path.exists(cnn14_ckpt):
            params = convert_cnn14(load_torch_bin(cnn14_ckpt))
            self.cnn14 = frozen(Cnn14, params, self.device)
        if vggish_ckpt and os.path.exists(vggish_ckpt):
            params = convert_vggish(load_torch_bin(vggish_ckpt))
            self.vggish = frozen(VGGish, params, self.device)
        # paired-mel frontend: TacotronSTFT(512, 160, 512, 64, 16000, 50, 8000)
        # (eval.py:63-64), on the host
        self.paired_stft = MelSpectrogram(
            StftConfig(filter_length=512, hop_length=160, win_length=512,
                       n_mel_channels=64, mel_fmin=50, mel_fmax=8000))

    # ------------------------------------------------------------- file logic
    def get_filename_intersection_ratio(self, dir1, dir2, threshold=0.99) -> bool:
        keys1 = {os.path.splitext(os.path.basename(x))[0] for x in os.listdir(dir1)}
        keys2 = {os.path.splitext(os.path.basename(x))[0] for x in os.listdir(dir2)}
        inter = keys1 & keys2
        return (len(inter) / max(len(keys1), 1) > threshold
                and len(inter) / max(len(keys2), 1) > threshold)

    def _wav_files(self, d: str, limit_num=None) -> List[str]:
        fs = sorted(os.path.join(d, x) for x in os.listdir(d) if x.lower().endswith(".wav"))
        # limit_num=0 means zero files, like the reference's datalist[:0]
        return fs if limit_num is None else fs[:limit_num]

    # ---------------------------------------------------------------- features
    def cnn14_features(self, files: List[str]) -> Dict[str, np.ndarray]:
        """{"2048", "logits", "file_path_"} of each file, in batches of
        `batch_size` clips of one length (the log-mel frontend on the
        device too)."""
        if self.cnn14 is None:
            raise RuntimeError("Cnn14 weights not loaded")
        wavs = [_read_wave_dataset(f, self.sampling_rate) for f in files]
        feats_2048 = [None] * len(files)
        logits = [None] * len(files)
        buckets: Dict[int, List[int]] = {}
        for i, w in enumerate(wavs):
            buckets.setdefault(len(w), []).append(i)
        bs = self.batch_size
        for _, idxs in sorted(buckets.items()):
            for k in range(0, len(idxs), bs):
                chunk = idxs[k: k + bs]
                batch = np.stack([wavs[i] for i in chunk] + [wavs[chunk[0]]] * (bs - len(chunk)))
                with torch.inference_mode():
                    out = self.cnn14(logmel_frontend(torch.from_numpy(batch).to(self.device)))
                    f2048, lg = out["2048"].cpu().numpy(), out["logits"].cpu().numpy()
                for j, i in enumerate(chunk):
                    feats_2048[i] = f2048[j]
                    logits[i] = lg[j]
        return {"2048": np.stack(feats_2048), "logits": np.stack(logits),
                "file_path_": list(files)}

    def vggish_embeddings(self, files: List[str]) -> np.ndarray:
        """Every example of every file, concatenated (metrics/fad.py), in
        batches of 4 x `batch_size` examples -> (N, 128)."""
        if self.vggish is None:
            raise RuntimeError("VGGish weights not loaded")
        examples = []
        for f in files:
            ex = waveform_to_examples(_read_fad(f, self.sampling_rate), self.sampling_rate)
            if len(ex):
                examples.append(ex)
        if not examples:
            return np.zeros((0, 128), np.float32)
        allex = np.concatenate(examples, 0)
        bs = max(self.batch_size * 4, 1)
        outs = []
        for k in range(0, len(allex), bs):
            chunk = allex[k: k + bs]
            pad = bs - len(chunk)
            if pad:
                chunk = np.concatenate([chunk, np.repeat(chunk[-1:], pad, 0)], 0)
            with torch.inference_mode():
                o = self.vggish(torch.from_numpy(chunk).to(self.device)).cpu().numpy()
            outs.append(o if not pad else o[:-pad])
        return np.concatenate(outs, 0)

    # ------------------------------------------------------------------- main
    def main(self, generate_files_path: str, groundtruth_path: str, limit_num=None) -> dict:
        for d in (generate_files_path, groundtruth_path):
            if not os.path.exists(d):
                raise FileNotFoundError(d)
        same_name = self.get_filename_intersection_ratio(generate_files_path, groundtruth_path)
        return self.calculate_metrics(generate_files_path, groundtruth_path, same_name, limit_num)

    def calculate_metrics(self, gen_dir, ref_dir, same_name, limit_num=None) -> dict:
        gen_files = self._wav_files(gen_dir, limit_num)
        ref_files = self._wav_files(ref_dir, limit_num)
        out: dict = {}
        out.update(self.calculate_lsd(gen_files, ref_files, same_name))
        out.update(self.calculate_psnr_ssim(gen_files, ref_files, same_name))
        if self.cnn14 is not None:
            fd_gen = self.cnn14_features(gen_files)
            fd_ref = self.cnn14_features(ref_files)
            kl, _, _ = M.calculate_kl(fd_gen, fd_ref, "logits", same_name)
            out.update(kl)
            out.update(M.calculate_isc(fd_gen, "logits", rng_seed=2020, samples_shuffle=True,
                                       splits=10))
            out.update(M.calculate_fid(fd_gen, fd_ref, "2048"))
            out.update(M.calculate_kid(fd_gen, fd_ref, "2048", subsets=100, subset_size=1000,
                                       degree=3, gamma=None, coef0=1, rng_seed=2020))
        if self.vggish is not None:
            out["frechet_audio_distance"] = M.frechet_distance(
                self.vggish_embeddings(gen_files), self.vggish_embeddings(ref_files))
        nan = float("nan")
        result = {
            "frechet_distance": out.get("frechet_distance", nan),
            "frechet_audio_distance": out.get("frechet_audio_distance", nan),
            "kl_sigmoid": out.get("kullback_leibler_divergence_sigmoid", nan),
            "kl_softmax": out.get("kullback_leibler_divergence_softmax", nan),
            "lsd": out.get("lsd", nan),
            "psnr": out.get("psnr", nan),
            "ssim": out.get("ssim", nan),
            "ssim_stft": out.get("ssim_stft", nan),
            "is_mean": out.get("inception_score_mean", nan),
            "is_std": out.get("inception_score_std", nan),
            "kid_mean": out.get("kernel_inception_distance_mean", nan),
            "kid_std": out.get("kernel_inception_distance_std", nan),
        }
        result = {k: round(v, 4) if np.isfinite(v) else v for k, v in result.items()}
        with open(gen_dir + "_evaluation_results.json", "w") as f:
            json.dump(result, f, indent=4)
        return result

    # --------------------------------------------------------- paired metrics
    def _paired(self, gen_files, ref_files):
        by_name = {os.path.splitext(os.path.basename(f))[0]: f for f in ref_files}
        for g in gen_files:
            key = os.path.splitext(os.path.basename(g))[0]
            if key in by_name:
                yield g, by_name[key]

    def calculate_lsd(self, gen_files, ref_files, same_name, time_offset=160 * 7) -> dict:
        if not same_name:
            return {"lsd": -1, "ssim_stft": -1}
        lsds, ssims = [], []
        for g, r in self._paired(gen_files, ref_files):
            a1 = _read_paired(g, self.sampling_rate)
            a2 = _read_paired(r, self.sampling_rate)
            # HiFi-GAN's 7-frame offset (eval.py:136-151)
            a1 = a1[time_offset:]
            a1 = a1 - a1.mean()
            a2 = a2 - a2.mean()
            a1 = a1 / max(np.abs(a1).max(), 1e-8)
            a2 = a2 / max(np.abs(a2).max(), 1e-8)
            n = min(len(a1), len(a2))
            res = M.log_spectral_distance(a1[:n], a2[:n])
            if np.isfinite(res["lsd"]):
                lsds.append(res["lsd"])
                ssims.append(res["ssim"])
        return {"lsd": float(np.mean(lsds)) if lsds else -1,
                "ssim_stft": float(np.mean(ssims)) if ssims else -1}

    def calculate_psnr_ssim(self, gen_files, ref_files, same_name) -> dict:
        if not same_name:
            return {"psnr": -1, "ssim": -1}
        psnrs, ssims = [], []
        for g, r in self._paired(gen_files, ref_files):
            m1 = self._mel(g)
            m2 = self._mel(r)
            n = min(len(m1), len(m2))
            # skimage's float semantics on [0, 1] mels: psnr data_range 1.0,
            # ssim data_range 2.0 (the dtype range (-1, 1))
            p = M.psnr(m1[:n], m2[:n], data_range=1.0)
            if np.isinf(p):
                continue
            psnrs.append(p)
            ssims.append(M.ssim(m1[:n], m2[:n], data_range=2.0))
        return {"psnr": float(np.mean(psnrs)) if psnrs else -1,
                "ssim": float(np.mean(ssims)) if ssims else -1}

    def _mel(self, path: str) -> np.ndarray:
        """MelPairedDataset's mel (load_mel.py:88-115)."""
        return self._mel_from_wav(_read_paired(path, self.sampling_rate))

    def _mel_from_wav(self, wav: np.ndarray) -> np.ndarray:
        """16 kHz mono wav -> normalized paired mel (load_mel.py:106-115):
        clip to [-1, 1], log10 mel, SpecVQGAN's scaling (x 20 - 20), then
        (mel + 100) / 100 clipped to [0, 1]."""
        wav = np.clip(wav, -1.0, 1.0)
        mel_ln, _ = self.paired_stft.mel_spectrogram(wav[None, :])
        mel10 = mel_ln.numpy()[0] / np.log(10.0)  # ln -> log10
        return np.clip((mel10 * 20.0 - 20.0 + 100.0) / 100.0, 0.0, 1.0)

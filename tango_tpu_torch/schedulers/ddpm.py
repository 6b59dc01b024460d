"""DDPM scheduler, port of tango_tpu/schedulers/ddpm.py.

Coefficient tables are f32 and every step's arithmetic is f32, whatever the
model's dtype. `t` is a Python int or an integer tensor of per-sample
timesteps; `prev_t = t - N // num_steps` as in diffusers.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from tango_tpu_torch.configs import SchedulerConfig


def make_betas(config: SchedulerConfig) -> np.ndarray:
    """The beta schedule table (f32)."""
    n = config.num_train_timesteps
    if config.trained_betas is not None:
        return np.asarray(config.trained_betas, dtype=np.float32)
    if config.beta_schedule == "linear":
        return np.linspace(config.beta_start, config.beta_end, n, dtype=np.float32)
    if config.beta_schedule == "scaled_linear":
        return np.linspace(config.beta_start**0.5, config.beta_end**0.5, n,
                           dtype=np.float32) ** 2
    if config.beta_schedule == "squaredcos_cap_v2":
        def alpha_bar(t):
            return np.cos((t + 0.008) / 1.008 * np.pi / 2) ** 2

        ts = np.arange(n, dtype=np.float64)
        return np.minimum(1.0 - alpha_bar((ts + 1) / n) / alpha_bar(ts / n),
                          0.999).astype(np.float32)
    if config.beta_schedule == "sigmoid":
        x = np.linspace(-6, 6, n)
        return (1.0 / (1.0 + np.exp(-x)) * (config.beta_end - config.beta_start)
                + config.beta_start).astype(np.float32)
    raise NotImplementedError(f"beta_schedule {config.beta_schedule}")


def _bcast(coef: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Right-broadcast a scalar or per-sample coefficient to like's rank."""
    return coef.reshape(coef.shape + (1,) * (like.dim() - coef.dim()))


def threshold_sample(sample: torch.Tensor, ratio: float, max_value: float) -> torch.Tensor:
    """Dynamic thresholding of predicted x0 (per-sample |x| quantile)."""
    flat = sample.reshape(sample.shape[0], -1).abs()
    s = torch.quantile(flat, ratio, dim=1).clamp(min=max_value)
    s = s.reshape((-1,) + (1,) * (sample.dim() - 1))
    return torch.clamp(sample, -s, s) / s


@dataclasses.dataclass(frozen=True)
class DDPMScheduler:
    config: SchedulerConfig
    betas: torch.Tensor            # (N,) f32, CPU
    alphas_cumprod: torch.Tensor   # (N,) f32, CPU

    @classmethod
    def create(cls, config: Optional[SchedulerConfig] = None, **overrides) -> "DDPMScheduler":
        config = config or SchedulerConfig()
        if overrides:
            config = dataclasses.replace(config, **overrides)
        betas = make_betas(config)
        ac = np.cumprod(1.0 - betas, dtype=np.float64).astype(np.float32)
        return cls(config, torch.from_numpy(betas), torch.from_numpy(ac))

    @property
    def init_noise_sigma(self) -> float:
        return 1.0

    def timesteps(self, num_inference_steps: int) -> np.ndarray:
        """Stride-subsampled reversed grid."""
        n = self.config.num_train_timesteps
        if num_inference_steps > n:
            raise ValueError(f"num_inference_steps {num_inference_steps} > {n}")
        ratio = n // num_inference_steps
        return (np.arange(0, num_inference_steps) * ratio).round()[::-1].copy().astype(np.int64)

    def scale_model_input(self, sample: torch.Tensor, t=None) -> torch.Tensor:
        return sample

    # -- tables ----------------------------------------------------------
    def _gather(self, table: torch.Tensor, t, like: torch.Tensor) -> torch.Tensor:
        idx = torch.as_tensor(t, dtype=torch.long)
        return table[idx.cpu()].to(like.device)

    def _ac(self, t, like):
        return self._gather(self.alphas_cumprod, t, like)

    def _ac_prev(self, prev_t, like):
        """alphas_cumprod[prev_t], with 1.0 where prev_t < 0."""
        prev = torch.as_tensor(prev_t, dtype=torch.long)
        vals = self.alphas_cumprod[prev.clamp(min=0).cpu()]
        return torch.where(prev.cpu() >= 0, vals, torch.ones_like(vals)).to(like.device)

    # -- forward process -------------------------------------------------
    def add_noise(self, original, noise, t):
        ac = self._ac(t, original)
        out = (_bcast(torch.sqrt(ac), original) * original.float()
               + _bcast(torch.sqrt(1.0 - ac), original) * noise.float())
        return out.to(original.dtype)

    def get_velocity(self, sample, noise, t):
        ac = self._ac(t, sample)
        out = (_bcast(torch.sqrt(ac), sample) * noise.float()
               - _bcast(torch.sqrt(1.0 - ac), sample) * sample.float())
        return out.to(sample.dtype)

    def snr(self, t):
        ac = self.alphas_cumprod[torch.as_tensor(t, dtype=torch.long)]
        return ac / (1.0 - ac)

    # -- reverse process -------------------------------------------------
    def predict_x0(self, model_output, sample, t):
        ac = _bcast(self._ac(t, sample), sample)
        beta_prod = 1.0 - ac
        sample = sample.float()
        model_output = model_output.float()
        p = self.config.prediction_type
        if p == "epsilon":
            x0 = (sample - torch.sqrt(beta_prod) * model_output) / torch.sqrt(ac)
        elif p == "sample":
            x0 = model_output
        elif p == "v_prediction":
            x0 = torch.sqrt(ac) * sample - torch.sqrt(beta_prod) * model_output
        else:
            raise ValueError(f"prediction_type {p}")
        if self.config.clip_sample:
            r = self.config.clip_sample_range
            x0 = x0.clamp(-r, r)
        if self.config.thresholding:
            x0 = threshold_sample(x0, self.config.dynamic_thresholding_ratio,
                                  self.config.sample_max_value)
        return x0

    def variance(self, t, prev_t, like, predicted_variance=None):
        """Posterior variance per variance_type; a LOG variance for
        learned_range and a std for fixed_small_log, as in JAX."""
        ac_t = self._ac(t, like)
        ac_prev = self._ac_prev(prev_t, like)
        current_beta = 1.0 - ac_t / ac_prev
        var = (1.0 - ac_prev) / (1.0 - ac_t) * current_beta
        vt = self.config.variance_type
        if vt in ("learned", "learned_range") and predicted_variance is None:
            raise ValueError(f"variance_type {vt!r} needs the model's variance channels")
        if vt == "fixed_small":
            return var.clamp(min=1e-20)
        if vt == "fixed_small_log":
            return torch.exp(0.5 * torch.log(var.clamp(min=1e-20)))
        if vt == "fixed_large":
            return current_beta
        if vt == "fixed_large_log":
            return torch.log(current_beta)
        if vt == "learned":
            return predicted_variance
        if vt == "learned_range":
            min_log = _bcast(torch.log(var), predicted_variance)
            max_log = _bcast(torch.log(self._gather(self.betas, t, like)), predicted_variance)
            frac = (predicted_variance + 1.0) / 2.0
            return frac * max_log + (1.0 - frac) * min_log
        raise NotImplementedError(f"variance_type {vt}")

    def step(self, model_output, t, sample, noise, num_inference_steps: int):
        """One reverse step x_t -> x_{t-k}; returns (prev_sample, x0), f32 math.

        `noise` is used only where t > 0. Learned-variance models emit twice
        the channels, [prediction | variance], on the LAST axis (NHWC)."""
        dtype_in = sample.dtype
        t_arr = torch.as_tensor(t, dtype=torch.long)
        prev_t = t_arr - self.config.num_train_timesteps // num_inference_steps
        vt = self.config.variance_type
        predicted_variance = None
        if vt in ("learned", "learned_range") and model_output.shape[-1] == 2 * sample.shape[-1]:
            model_output, predicted_variance = model_output.chunk(2, dim=-1)
            predicted_variance = predicted_variance.float()

        ac_t = _bcast(self._ac(t_arr, sample), sample)
        ac_prev = _bcast(self._ac_prev(prev_t, sample), sample)
        beta_prod_t = 1.0 - ac_t
        beta_prod_prev = 1.0 - ac_prev
        current_alpha = ac_t / ac_prev
        current_beta = 1.0 - current_alpha

        x0 = self.predict_x0(model_output, sample, t_arr)
        x0_coeff = torch.sqrt(ac_prev) * current_beta / beta_prod_t
        xt_coeff = torch.sqrt(current_alpha) * beta_prod_prev / beta_prod_t
        prev = x0_coeff * x0 + xt_coeff * sample.float()

        var = _bcast(self.variance(t_arr, prev_t, sample, predicted_variance), sample)
        if vt == "fixed_small_log":
            std = var
        elif vt == "learned_range":
            std = torch.exp(0.5 * var)
        else:
            std = torch.sqrt(var)
        positive = _bcast((t_arr > 0).to(sample.device), sample)
        prev = prev + torch.where(positive, std * noise.float(), torch.zeros((), device=sample.device))
        return prev.to(dtype_in), x0

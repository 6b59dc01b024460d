"""DDIM scheduler, port of tango_tpu/schedulers/ddim.py.

Deterministic (eta = 0) or stochastic fast sampling with diffusers'
DDIMScheduler semantics: the `steps_offset`-shifted stride grid, and
`set_alpha_to_one` for the step past the last. The tables are built as JAX
builds them (`make_betas`, a float64 cumprod cast to f32) and every step's
arithmetic is f32, whatever the model's dtype.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from tango_tpu_torch.configs import SchedulerConfig
from tango_tpu_torch.schedulers.ddpm import _bcast, make_betas, threshold_sample


@dataclasses.dataclass(frozen=True)
class DDIMScheduler:
    config: SchedulerConfig
    betas: torch.Tensor                # (N,) f32, CPU
    alphas_cumprod: torch.Tensor       # (N,) f32, CPU
    final_alpha_cumprod: torch.Tensor  # () f32, CPU

    @classmethod
    def create(cls, config: Optional[SchedulerConfig] = None, **overrides) -> "DDIMScheduler":
        config = config or SchedulerConfig()
        if overrides:
            config = dataclasses.replace(config, **overrides)
        betas = make_betas(config)
        ac = np.cumprod(1.0 - betas, dtype=np.float64).astype(np.float32)
        final = np.float32(1.0) if config.set_alpha_to_one else ac[0]
        return cls(config, torch.from_numpy(betas), torch.from_numpy(ac),
                   torch.tensor(final, dtype=torch.float32))

    @property
    def init_noise_sigma(self) -> float:
        return 1.0

    def timesteps(self, num_inference_steps: int) -> np.ndarray:
        """The stride grid, descending, shifted by `steps_offset`."""
        n = self.config.num_train_timesteps
        if num_inference_steps > n:
            # diffusers' loud failure: past it the steps_offset=1 grid tops out
            # at n, and the gather would read past the table
            raise ValueError(f"num_inference_steps ({num_inference_steps}) > "
                             f"num_train_timesteps ({n})")
        ratio = n // num_inference_steps
        ts = (np.arange(0, num_inference_steps) * ratio).round()[::-1].copy().astype(np.int64)
        return ts + self.config.steps_offset

    def scale_model_input(self, sample: torch.Tensor, t=None) -> torch.Tensor:
        return sample

    def _ac(self, t, like: torch.Tensor) -> torch.Tensor:
        idx = torch.as_tensor(t, dtype=torch.long).cpu()
        return self.alphas_cumprod[idx].to(like.device)

    def _alpha_prod_prev(self, prev_t, like: torch.Tensor) -> torch.Tensor:
        """alphas_cumprod[prev_t], and `final_alpha_cumprod` where prev_t < 0."""
        prev = torch.as_tensor(prev_t, dtype=torch.long).cpu()
        vals = self.alphas_cumprod[prev.clamp(min=0)]
        return torch.where(prev >= 0, vals, self.final_alpha_cumprod).to(like.device)

    def add_noise(self, original, noise, t):
        ac = self._ac(t, original)
        out = (_bcast(torch.sqrt(ac), original) * original.float()
               + _bcast(torch.sqrt(1.0 - ac), original) * noise.float())
        return out.to(original.dtype)

    def step(self, model_output, t, sample, noise, num_inference_steps: int, eta: float = 0.0):
        """One DDIM reverse step; returns (prev_sample, pred_x0), f32 math.
        `noise` is read only where eta > 0."""
        dtype_in = sample.dtype
        t_arr = torch.as_tensor(t, dtype=torch.long)
        prev_t = t_arr - self.config.num_train_timesteps // num_inference_steps
        ac_t = _bcast(self._ac(t_arr, sample), sample)
        ac_prev = _bcast(self._alpha_prod_prev(prev_t, sample), sample)
        beta_prod_t = 1.0 - ac_t
        sample32, out32 = sample.float(), model_output.float()

        p = self.config.prediction_type
        if p == "epsilon":
            x0 = (sample32 - torch.sqrt(beta_prod_t) * out32) / torch.sqrt(ac_t)
            eps = out32
        elif p == "sample":
            x0 = out32
            eps = (sample32 - torch.sqrt(ac_t) * x0) / torch.sqrt(beta_prod_t)
        elif p == "v_prediction":
            x0 = torch.sqrt(ac_t) * sample32 - torch.sqrt(beta_prod_t) * out32
            eps = torch.sqrt(ac_t) * out32 + torch.sqrt(beta_prod_t) * sample32
        else:
            raise ValueError(f"prediction_type {p}")

        # as the reference, eps is not derived again after clipping or
        # thresholding (use_clipped_model_output, which no config sets)
        if self.config.clip_sample:
            r = self.config.clip_sample_range
            x0 = x0.clamp(-r, r)
        if self.config.thresholding:
            x0 = threshold_sample(x0, self.config.dynamic_thresholding_ratio,
                                  self.config.sample_max_value)

        variance = (1.0 - ac_prev) / (1.0 - ac_t) * (1.0 - ac_t / ac_prev)
        std = eta * torch.sqrt(variance)
        prev = torch.sqrt(ac_prev) * x0 + torch.sqrt(1.0 - ac_prev - std**2) * eps
        if eta > 0:
            prev = prev + std * noise.float()
        return prev.to(dtype_in), x0

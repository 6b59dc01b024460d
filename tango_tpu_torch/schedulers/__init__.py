"""Noise schedulers of the port."""

from tango_tpu_torch.schedulers.ddim import DDIMScheduler
from tango_tpu_torch.schedulers.ddpm import DDPMScheduler

__all__ = ["DDPMScheduler", "DDIMScheduler"]

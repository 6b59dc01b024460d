"""The objective evaluation (FD, FAD, KL, IS, KID, LSD, PSNR, SSIM): port of
tango_tpu/eval."""

from tango_tpu_torch.eval.metrics import (
    calculate_fid,
    calculate_isc,
    calculate_kid,
    calculate_kl,
    frechet_distance,
)
from tango_tpu_torch.eval.evaluator import EvaluationHelper

__all__ = [
    "EvaluationHelper",
    "calculate_fid",
    "calculate_isc",
    "calculate_kid",
    "calculate_kl",
    "frechet_distance",
]

"""AudioLDM in the port: the pipeline (pipeline.py) and its CLI (cli.py,
`python -m tango_tpu_torch.audioldm`)."""

from tango_tpu_torch.audioldm.pipeline import (
    AudioLDMPipeline,
    build_model,
    duration_to_latent_t_size,
    style_transfer,
    super_resolution_and_inpainting,
    text_to_audio,
)

__all__ = [
    "AudioLDMPipeline",
    "build_model",
    "duration_to_latent_t_size",
    "style_transfer",
    "super_resolution_and_inpainting",
    "text_to_audio",
]

"""Configuration dataclasses of the port and the dtype rule.

A copy of the fields of tango_tpu/configs.py, tango_tpu/models/t5.py and
tango_tpu/models/deberta.py that the ported paths read, with the same names
and defaults, so that `from_dict(jax_config.to_dict())` rebuilds a JAX config
here (unknown keys are ignored), and so does a reference snapshot's JSON.
A JSON that asks for geometry the port's modules lack raises instead of
building another model.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Optional, Tuple, Union

import torch


class _FromDict:
    """Construct from a dict, ignoring unknown keys."""

    @classmethod
    def from_dict(cls, d: dict):
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _tup(x) -> tuple:
    return tuple(x) if isinstance(x, (list, tuple)) else (x,)


_UNET_DEFAULT_ONLY = {
    "act_fn": "silu",
    "only_cross_attention": False,
    "dual_cross_attention": False,
    "num_class_embeds": None,
    "resnet_time_scale_shift": "default",
    "mid_block_scale_factor": 1.0,
}


@dataclass(frozen=True)
class UNetConfig(_FromDict):
    """UNet2DConditionModel config; `attention_head_dim` is the NUMBER of heads
    per level, as in diffusers' JSON (head width = channels / heads)."""

    in_channels: int = 8
    out_channels: int = 8
    center_input_sample: bool = False
    flip_sin_to_cos: bool = True
    freq_shift: int = 0
    down_block_types: Tuple[str, ...] = (
        "CrossAttnDownBlock2D",
        "CrossAttnDownBlock2D",
        "CrossAttnDownBlock2D",
        "DownBlock2D",
    )
    mid_block_type: Optional[str] = "UNetMidBlock2DCrossAttn"
    up_block_types: Tuple[str, ...] = (
        "UpBlock2D",
        "CrossAttnUpBlock2D",
        "CrossAttnUpBlock2D",
        "CrossAttnUpBlock2D",
    )
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    downsample_padding: int = 1
    norm_num_groups: int = 32
    norm_eps: float = 1e-5
    cross_attention_dim: int = 1024
    attention_head_dim: Union[int, Tuple[int, ...]] = (5, 10, 20, 20)
    use_linear_projection: bool = True
    upcast_attention: bool = True
    conv_in_kernel: int = 3
    conv_out_kernel: int = 3
    # conditioning streams beside the text: 0 for Tango, 2 for Mustango's
    # beats and chords, each with its own cross-attention transformer after
    # the text's in every cross-attention layer
    extra_cond_streams: int = 0
    extra_cond_dims: Tuple[int, ...] = ()
    # int8 W8A8 serving mode (ops/quant.py): the scope's Linear / Conv2d
    # modules hold int8 weights and f32 scales; "all" | "dense" (attention,
    # feed-forward and projection GEMMs) | "conv" (resnet and resampler convs)
    quant_int8: bool = False
    quant_scope: str = "all"

    @property
    def quant_dense(self) -> bool:
        return self.quant_int8 and self.quant_scope in ("all", "dense")

    @property
    def quant_conv(self) -> bool:
        return self.quant_int8 and self.quant_scope in ("all", "conv")

    @classmethod
    def from_dict(cls, d: dict):
        # diffusers knobs no shipped Tango config moves off its default and
        # the UNet does not implement (tango_tpu/configs.py UNetConfig)
        bad = {k: d[k] for k, dflt in _UNET_DEFAULT_ONLY.items() if k in d and d[k] != dflt}
        if bad:
            raise NotImplementedError(f"UNetConfig fields not supported off-default: {bad}")
        return super().from_dict(d)

    def __post_init__(self):
        down, up = _tup(self.down_block_types), _tup(self.up_block_types)
        mid = self.mid_block_type
        # Mustango's JSON names its triple cross-attention blocks with a
        # "Music" suffix; here they are the same blocks with 2 extra streams
        # (beats and chords) as wide as the text's
        if any("Music" in b for b in down + up) or (mid and "Music" in mid):
            down = tuple(b.replace("Music", "") for b in down)
            up = tuple(b.replace("Music", "") for b in up)
            mid = mid.replace("Music", "") if mid else mid
            if self.extra_cond_streams == 0:
                object.__setattr__(self, "extra_cond_streams", 2)
                object.__setattr__(self, "extra_cond_dims",
                                   (self.cross_attention_dim, self.cross_attention_dim))
        object.__setattr__(self, "down_block_types", down)
        object.__setattr__(self, "up_block_types", up)
        object.__setattr__(self, "mid_block_type", mid)
        object.__setattr__(self, "block_out_channels", _tup(self.block_out_channels))
        object.__setattr__(self, "extra_cond_dims",
                           _tup(self.extra_cond_dims) if self.extra_cond_dims else ())
        if len(self.extra_cond_dims) != self.extra_cond_streams:
            raise ValueError(f"{self.extra_cond_streams} extra streams with widths "
                             f"{self.extra_cond_dims}")
        if isinstance(self.attention_head_dim, (list, tuple)):
            object.__setattr__(self, "attention_head_dim", _tup(self.attention_head_dim))

    def heads_for_level(self, level: int) -> int:
        if isinstance(self.attention_head_dim, int):
            return self.attention_head_dim
        return self.attention_head_dim[level]


@dataclass(frozen=True)
class VAEConfig(_FromDict):
    """AudioLDM AutoencoderKL config: `first_stage_config.params` with its
    `ddconfig` block flattened, as a reference `vae_config.json` nests it."""

    embed_dim: int = 8
    scale_factor: float = 1.0
    double_z: bool = True
    z_channels: int = 8
    resolution: int = 256
    in_channels: int = 1
    out_ch: int = 1
    ch: int = 128
    ch_mult: Tuple[int, ...] = (1, 2, 4)
    num_res_blocks: int = 2
    attn_resolutions: Tuple[int, ...] = ()

    @classmethod
    def from_dict(cls, d: dict):
        d = dict(d)
        d.update(d.pop("ddconfig", None) or {})
        if d.get("downsample_time_stride4_levels"):
            # the stride-4 time downsampling variant: JAX's VAE has none
            # either (tango_tpu/models/vae.py:103 asserts), and no shipped
            # AudioLDM or Tango config uses it
            raise NotImplementedError(
                "downsample_time_stride4_levels: the stride-4 VAE variant is implemented "
                "neither here nor in the JAX package")
        return super().from_dict(d)

    def __post_init__(self):
        object.__setattr__(self, "ch_mult", _tup(self.ch_mult))
        object.__setattr__(
            self, "attn_resolutions", _tup(self.attn_resolutions) if self.attn_resolutions else ()
        )


@dataclass(frozen=True)
class HiFiGANConfig(_FromDict):
    """HiFi-GAN generator config (HIFIGAN_16K_64)."""

    num_mels: int = 64
    upsample_rates: Tuple[int, ...] = (5, 4, 2, 2, 2)
    upsample_kernel_sizes: Tuple[int, ...] = (16, 16, 8, 4, 4)
    upsample_initial_channel: int = 1024
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = ((1, 3, 5), (1, 3, 5), (1, 3, 5))

    def __post_init__(self):
        object.__setattr__(self, "upsample_rates", _tup(self.upsample_rates))
        object.__setattr__(self, "upsample_kernel_sizes", _tup(self.upsample_kernel_sizes))
        object.__setattr__(self, "resblock_kernel_sizes", _tup(self.resblock_kernel_sizes))
        object.__setattr__(
            self, "resblock_dilation_sizes", tuple(_tup(d) for d in self.resblock_dilation_sizes)
        )


@dataclass(frozen=True)
class StftConfig(_FromDict):
    """TacotronSTFT config (mel frontend of the training data)."""

    filter_length: int = 1024
    hop_length: int = 160
    win_length: int = 1024
    n_mel_channels: int = 64
    sampling_rate: int = 16000
    mel_fmin: float = 0.0
    mel_fmax: float = 8000.0


@dataclass(frozen=True)
class SchedulerConfig(_FromDict):
    """DDPM and DDIM scheduler config; defaults are the stable-diffusion-2-1
    scheduler. The last two fields are read by DDIM alone."""

    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"
    trained_betas: Optional[List[float]] = None
    variance_type: str = "fixed_small"
    clip_sample: bool = False
    clip_sample_range: float = 1.0
    prediction_type: str = "v_prediction"
    thresholding: bool = False
    dynamic_thresholding_ratio: float = 0.995
    sample_max_value: float = 1.0
    set_alpha_to_one: bool = False
    steps_offset: int = 1


@dataclass(frozen=True)
class DiffusionConfig(_FromDict):
    """A snapshot's `main_config.json` (tango_tpu/configs.py DiffusionConfig)."""

    text_encoder_name: str = "google/flan-t5-large"
    scheduler_name: str = "stabilityai/stable-diffusion-2-1"
    unet_model_name: Optional[str] = None
    unet_model_config_path: Optional[str] = None
    snr_gamma: Optional[float] = None
    freeze_text_encoder: bool = True
    uncondition: bool = False
    latent_t_size: int = 256
    latent_f_size: int = 16


@dataclass(frozen=True)
class T5Config(_FromDict):
    """T5 config; defaults are FLAN-T5-Large. `tie_word_embeddings` is the
    seq2seq head's: tied, the decoder's output scaled by d_model^-0.5 goes
    through the embedding table; untied (FLAN-T5), through `lm_head`."""

    vocab_size: int = 32128
    d_model: int = 1024
    d_kv: int = 64
    d_ff: int = 2816
    num_layers: int = 24
    num_heads: int = 16
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6
    feed_forward_proj: str = "gated-gelu"
    tie_word_embeddings: bool = False

    @property
    def is_gated(self) -> bool:
        return "gated" in self.feed_forward_proj

    @property
    def act(self) -> str:
        return self.feed_forward_proj.replace("gated-", "")


@dataclass(frozen=True)
class DebertaConfig(_FromDict):
    """DeBERTa-v2/v3 encoder config (tango_tpu/models/deberta.py); defaults are
    DeBERTa-v3-large with Mustango's beat head (4 labels): relative positions
    in 256 log buckets, position projections shared with the content ones,
    c2p and p2c terms, a layer-normed relative table, no absolute positions."""

    vocab_size: int = 128100
    hidden_size: int = 1024
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    intermediate_size: int = 4096
    max_position_embeddings: int = 512
    position_buckets: int = 256
    layer_norm_eps: float = 1e-7
    share_att_key: bool = True
    pos_att_type: Tuple[str, ...] = ("p2c", "c2p")
    norm_rel_ebd: str = "layer_norm"
    position_biased_input: bool = False
    num_labels: int = 4

    def __post_init__(self):
        object.__setattr__(self, "pos_att_type", _tup(self.pos_att_type))
        if self.position_biased_input:
            raise NotImplementedError("position_biased_input (DeBERTa-v2's absolute "
                                      "positions) is not supported; v3 has none")


@dataclass(frozen=True)
class TrainConfig(_FromDict):
    """SFT training recipe (tango_tpu/configs.py TrainConfig, the reference's
    train.sh). `weight_decay` is the reference's effective AdamW decay, its
    --adam_weight_decay."""

    learning_rate: float = 3e-5
    weight_decay: float = 1e-2
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_epsilon: float = 1e-8
    num_train_epochs: int = 40
    # cap on optimizer updates; None lets the epochs decide
    max_train_steps: Optional[int] = None
    per_device_train_batch_size: int = 2
    per_device_eval_batch_size: int = 2
    gradient_accumulation_steps: int = 4
    lr_scheduler_type: str = "linear"
    num_warmup_steps: int = 0
    snr_gamma: Optional[float] = 5.0
    uncondition: bool = False
    augment: bool = True
    target_length: int = 1024
    seed: Optional[int] = None
    checkpointing_steps: str = "best"
    # "best" mode also saves epoch_N every save_every epochs
    save_every: int = 5


@dataclass(frozen=True)
class DPOConfig(_FromDict):
    """Tango 2's DPO recipe (tango_tpu/configs.py DPOConfig; the reference's
    README.md:155-166, tango2/tango2-train.py:35-224). `weight_decay` is the
    reference's effective AdamW decay, its --adam_weight_decay; post-SFT
    epoch states are saved every `save_every` epochs."""

    learning_rate: float = 9.6e-7
    beta_dpo: float = 2000.0
    num_train_epochs: int = 5
    per_device_train_batch_size: int = 4
    gradient_accumulation_steps: int = 4
    sft_first_epochs: int = 1
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_epsilon: float = 1e-8
    weight_decay: float = 1e-2
    save_every: int = 5
    max_train_steps: Optional[int] = None


TANGO_UNET = UNetConfig()
# Tango-XL: the same UNet under FLAN-T5-XL's 2048-wide text states
TANGO_UNET_XL = dataclasses.replace(TANGO_UNET, cross_attention_dim=2048)
TANGO_VAE = VAEConfig()
TANGO_STFT = StftConfig()
TANGO_HIFIGAN = HiFiGANConfig()
SD21_SCHEDULER = SchedulerConfig()
FLAN_T5_LARGE = T5Config()
DEBERTA_V3_LARGE = DebertaConfig()


def resolve_device(device=None) -> torch.device:
    """The device entry points run on: CUDA unless the caller names another.

    With no device given and no CUDA card present this raises instead of
    quietly running the plain versions on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the port's plain "
            "PyTorch versions on the CPU"
        )
    return torch.device("cuda")


def default_dtype(device: torch.device) -> torch.dtype:
    """Model compute dtype (tango_tpu/pipeline.py:35-41): bf16 on the card,
    f32 on the CPU. Scheduler math is f32 regardless."""
    return torch.bfloat16 if torch.device(device).type == "cuda" else torch.float32

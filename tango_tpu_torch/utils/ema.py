"""Exponential moving average of parameters, port of tango_tpu/utils/ema.py
(AudioLDM's LitEma semantics).

The shadow is a state dict of tensors, updated as
`shadow -= (1 - d) * (shadow - param)` in f32 with the warmup decay
`d = min(decay, (1 + n) / (10 + n))` after n updates; a state made with
`use_num_updates=False` (num_updates -1) keeps `d = decay`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping

import torch


@dataclasses.dataclass
class EmaState:
    shadow: Dict[str, torch.Tensor]
    num_updates: int  # < 0 disables the warmup schedule


def ema_init(params: Mapping[str, torch.Tensor], use_num_updates: bool = True) -> EmaState:
    """Shadow = a copy of params."""
    shadow = {k: v.detach().clone() for k, v in params.items()}
    return EmaState(shadow, 0 if use_num_updates else -1)


def ema_update(state: EmaState, params: Mapping[str, torch.Tensor],
               decay: float = 0.9999) -> EmaState:
    """One EMA step with the reference's warmup schedule; a new state."""
    n = state.num_updates + 1 if state.num_updates >= 0 else state.num_updates
    # JAX computes d in f32: the f32 decay against (1 + n) / (10 + n) in f32
    d32 = torch.tensor(decay, dtype=torch.float32)
    if n >= 0:
        warm = torch.tensor(1.0 + n, dtype=torch.float32) / torch.tensor(10.0 + n,
                                                                          dtype=torch.float32)
        d32 = torch.minimum(d32, warm)
    one_minus = 1.0 - d32
    shadow = {}
    for k, s in state.shadow.items():
        s32 = s.float()
        upd = s32 - one_minus.to(s.device) * (s32 - params[k].detach().to(s.device).float())
        shadow[k] = upd.to(s.dtype)
    return EmaState(shadow, n)


def ema_params(state: EmaState) -> Dict[str, torch.Tensor]:
    """The averaged parameters."""
    return state.shadow

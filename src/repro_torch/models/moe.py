"""Channel MLPs.

Port of the dense part of :mod:`repro.models.moe`: the SwiGLU MLP (and
the audio family's 2-matrix GELU MLP).  The routed mixture-of-experts
(``moe_init``/``moe_apply``) is not ported yet (ROADMAP Queue 1, item 13).
"""

from __future__ import annotations

import torch

from .config import ModelConfig
from .layers import Axes, dense_init, swiglu

_MOE = "the routed MoE is not ported yet (ROADMAP Queue 1, item 13)"


def mlp_init(generator: torch.Generator, cfg: ModelConfig,
             d_ff: int | None = None, device=None) -> dict:
    D = cfg.d_model
    F = d_ff if d_ff is not None else cfg.d_ff
    if cfg.family == "audio":  # hubert: classic 2-matrix GELU MLP
        return {
            "up": dense_init(generator, (D, F), cfg.pdtype, device=device),
            "down": dense_init(generator, (F, D), cfg.pdtype, device=device),
        }
    return {
        "gate": dense_init(generator, (D, F), cfg.pdtype, device=device),
        "up": dense_init(generator, (D, F), cfg.pdtype, device=device),
        "down": dense_init(generator, (F, D), cfg.pdtype, device=device),
    }


def mlp_apply(p, x, cfg: ModelConfig, ax: Axes):
    dt = cfg.adtype
    if "gate" in p:
        h = swiglu(x @ p["gate"].to(dt), x @ p["up"].to(dt))
    else:
        h = torch.nn.functional.gelu(x @ p["up"].to(dt), approximate="tanh")
    h = ax.act_btf(h)
    return ax.act_btd(h @ p["down"].to(dt))


def moe_init(*args, **kwargs):
    raise NotImplementedError(_MOE)


def moe_apply(*args, **kwargs):
    raise NotImplementedError(_MOE)

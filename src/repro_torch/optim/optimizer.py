"""AdamW with a cosine schedule and global-norm clipping.

Port of :mod:`repro.optim.optimizer` as functions on dicts of tensors
(``{name: tensor}``), with the reference's arithmetic in the same order.
The reference decays the leaves of its stacked tree with ``ndim >= 2``;
here the caller passes ``decay`` (``{name: bool}``, see
:func:`repro_torch.models.lm.decayed`), and without it the same
``ndim >= 2`` rule applies to the dict as given.  Updates return new
tensors; nothing is changed in place.

>>> p = {"w": torch.ones((2, 2)), "b": torch.ones(2)}
>>> g = {"w": torch.full((2, 2), 0.5), "b": torch.full((2,), 0.5)}
>>> cfg = OptConfig(lr=0.1, warmup_steps=0, total_steps=10, clip_norm=0.0)
>>> new, st, m = adamw_update(g, adamw_init(p, cfg), p, cfg)
>>> round(new["w"][0, 0].item(), 6), round(new["b"][0].item(), 6), int(st["step"])
(0.89, 0.9, 1)
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    state_dtype: str = "float32"


def lr_at(cfg: OptConfig, step) -> torch.Tensor:
    """Linear warmup + cosine decay to ``min_lr_frac`` (f32, as the
    reference computes it)."""
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = cfg.lr * torch.clamp(
        (step + 1) / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
        0, 1)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (1 + torch.cos(math.pi * t))
    return torch.where(step < cfg.warmup_steps, warm, cfg.lr * cos)


def adamw_init(params: dict, cfg: OptConfig) -> dict:
    dt = _DTYPES[cfg.state_dtype]
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)  # noqa: E731
    return {
        "m": {k: zeros(p) for k, p in params.items()},
        "v": {k: zeros(p) for k, p in params.items()},
        "step": torch.zeros((), dtype=torch.int32),
    }


def clip_by_global_norm(grads: dict, max_norm: float):
    """``(clipped grads, global norm)``; the norm is 0 when clipping is off."""
    if not max_norm:
        ref = next(iter(grads.values()))
        return grads, torch.zeros((), dtype=torch.float32, device=ref.device)
    sq = sum(torch.sum(torch.square(g.float())) for g in grads.values())
    norm = torch.sqrt(sq)
    scale = torch.clamp(max_norm / torch.clamp_min(norm, 1e-9), max=1.0)
    return {k: (g.float() * scale).to(g.dtype) for k, g in grads.items()}, norm


def adamw_update(grads: dict, state: dict, params: dict, cfg: OptConfig,
                 decay: dict | None = None):
    """Returns ``(new_params, new_state, {"lr", "grad_norm"})``."""
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    step = state["step"] + 1
    lr = lr_at(cfg, state["step"])
    b1, b2 = cfg.beta1, cfg.beta2
    c1 = 1 - b1 ** step.float()
    c2 = 1 - b2 ** step.float()
    dev = next(iter(params.values())).device
    lr_d, c1, c2 = (t.to(dev) for t in (lr, c1, c2))  # one copy each
    new_p, new_m, new_v = {}, {}, {}
    for name, p in params.items():
        g, m, v = grads[name], state["m"][name], state["v"][name]
        gf = g.float()
        mf = b1 * m.float() + (1 - b1) * gf
        vf = b2 * v.float() + (1 - b2) * gf * gf
        mh = mf / c1
        vh = vf / c2
        upd = mh / (torch.sqrt(vh) + cfg.eps)
        pf = p.float()
        if (decay[name] if decay is not None else p.dim() >= 2):
            upd = upd + cfg.weight_decay * pf  # decoupled weight decay
        new_p[name] = (pf - lr_d * upd).to(p.dtype)
        new_m[name] = mf.to(m.dtype)
        new_v[name] = vf.to(v.dtype)
    return (new_p, {"m": new_m, "v": new_v, "step": step},
            {"lr": lr, "grad_norm": gnorm})

"""Primitive layers: init helpers, RMSNorm, SwiGLU, RoPE.

Port of :mod:`repro.models.layers`.  The reference threads an ``Axes``
context through the model for GSPMD sharding constraints; the port runs on
one card, so :class:`Axes` keeps only the axis sizes and its ``act_*``
constraints are identities.  Normalisation, the SiLU of SwiGLU and the
rotary embedding compute in float32 and cast back to the input's dtype, as
the reference does.

>>> x = torch.ones((1, 2, 4))
>>> [round(v, 4) for v in rmsnorm(x, torch.full((4,), 2.0))[0, 0].tolist()]
[2.0, 2.0, 2.0, 2.0]
>>> apply_rope(torch.ones((1, 1, 1, 4)), torch.zeros(1), 1e4).tolist()
[[[[1.0, 1.0, 1.0, 1.0]]]]
"""

from __future__ import annotations

from typing import Sequence

import torch


class Axes:
    """Named axis sizes of the (simulated) mesh.  On one card there is no
    sharding to constrain, so the activation hooks return their input."""

    def __init__(self, data=("data",), model=None, sizes: dict | None = None):
        self.data = tuple(data)
        self.model = model
        self.sizes = dict(sizes or {})

    def act_btd(self, x):
        return x

    act_bthd = act_btf = act_btv = act_btd


NO_SHARD = Axes()


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------


def _trunc_normal(shape, generator: torch.Generator, device) -> torch.Tensor:
    out = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    return torch.nn.init.trunc_normal_(out, 0.0, 1.0, -3.0, 3.0,
                                       generator=generator)


def dense_init(generator: torch.Generator, shape: Sequence[int], dtype,
               fan_in: int | None = None, device=None) -> torch.Tensor:
    """Truncated normal in [-3, 3] scaled by 1/sqrt(fan_in) (the last-but-one
    dim).  Draws from ``generator``; the numbers differ from the reference's
    PRNG, so parity tests load converted weights instead."""
    fan = fan_in if fan_in is not None else shape[-2] if len(shape) >= 2 else shape[-1]
    return (_trunc_normal(shape, generator, device) * fan**-0.5).to(dtype)


def embed_init(generator: torch.Generator, shape, dtype, device=None):
    return (_trunc_normal(shape, generator, device) * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# Norms / activations
# ---------------------------------------------------------------------------


def rmsnorm(x, weight, eps: float = 1e-5):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * weight.float()).to(x.dtype)


def swiglu(gate, up):
    return torch.nn.functional.silu(gate.float()).to(gate.dtype) * up


# ---------------------------------------------------------------------------
# Rotary position embeddings (rotate-half convention)
# ---------------------------------------------------------------------------


def rope_freqs(hd: int, theta: float, device=None) -> torch.Tensor:
    return theta ** (-torch.arange(0, hd // 2, dtype=torch.float32,
                                   device=device) / (hd // 2))


def apply_rope(x, positions, theta: float):
    """x: [B, T, H, hd]; positions: [T] or [B, T] absolute positions."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)  # [hd/2]
    positions = positions.to(x.device)
    if positions.ndim == 1:
        ang = positions[:, None].float() * freqs[None, :]  # [T, hd/2]
        ang = ang[None, :, None, :]  # [1, T, 1, hd/2]
    else:
        ang = positions[..., None].float() * freqs  # [B, T, hd/2]
        ang = ang[:, :, None, :]
    sin, cos = torch.sin(ang), torch.cos(ang)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)

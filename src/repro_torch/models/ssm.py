"""Recurrent mixers: xLSTM (mLSTM + sLSTM) and SSD heads (hymba).

Port of :mod:`repro.models.ssm`, train/prefill branch only (``state is
None``).  The decode branches (one step against a carried state) and the
``*_init_state`` helpers belong to the decode caches and raise, naming
ROADMAP Queue 1, item 14.

* **mLSTM** (matrix memory): chunk-parallel through the port's
  ``kernels.gla_scan`` (normalize=True) — on the card the hand-written
  Hopper kernels, forward and backward.  The reference replaces the
  paper's running-max stabilizer by clipping the exponential input gate's
  pre-activation; the port keeps that.
* **sLSTM** (scalar memory, recurrent ``R``): sequential, a Python loop
  over T as the reference's ``lax.scan`` (it has no kernel there either).
* **SSD** (mamba-2-style scalar decay): hymba's second head set, through
  ``kernels.gla_scan`` with normalize=False.

Parameters are nested dicts of tensors (``conv`` holds ``{"w"}``), as the
reference's; the apply functions read them with ``p[name]``.

>>> from repro_torch.models.config import ModelConfig, SSMCfg
>>> cfg = ModelConfig(name="t", family="ssm", n_layers=4, d_model=32,
...                   n_heads=2, n_kv_heads=2, d_ff=0, vocab_size=64,
...                   dtype="float32", ssm=SSMCfg(slstm_every=4))
>>> g = torch.Generator().manual_seed(0)
>>> x = torch.zeros((1, 5, 32))
>>> y, st = mlstm_apply(mlstm_init(g, cfg), x, cfg, None)
>>> tuple(y.shape), tuple(st["C"].shape)
((1, 5, 32), (1, 2, 32, 33))
>>> tuple(slstm_apply(slstm_init(g, cfg), x, cfg, None)[0].shape)
(1, 5, 32)
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import ops
from .config import ModelConfig
from .layers import dense_init, rmsnorm

_DECODE = ("the recurrent decode state of models/ssm.py is not ported yet "
           "(ROADMAP Queue 1, item 14)")


# ---------------------------------------------------------------------------
# causal conv1d (shared helper; kernel k, per-channel)
# ---------------------------------------------------------------------------


def conv1d_init(generator: torch.Generator, channels: int, k: int, dtype,
                device=None) -> dict:
    return {"w": dense_init(generator, (k, channels), dtype, fan_in=k,
                            device=device)}


def conv1d_apply(p, x, state=None):
    """x: ``[B, T, C]`` causal depthwise conv.  Returns ``(y, tail)`` with
    ``tail`` the last ``k-1`` inputs (the decode carry)."""
    if state is not None:
        raise NotImplementedError(_DECODE)
    w = p["w"].to(x.dtype)  # [k, C]
    k = w.shape[0]
    T = x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    tail = xp[:, -(k - 1):, :] if k > 1 else None
    y = 0
    for i in range(k):  # the reference's sum, in its order
        y = y + xp[:, i:i + T, :] * w[i]
    return y, tail


# ---------------------------------------------------------------------------
# mLSTM block (xLSTM)
# ---------------------------------------------------------------------------


def mlstm_init(generator: torch.Generator, cfg: ModelConfig, device=None) -> dict:
    D = cfg.d_model
    s = cfg.ssm
    di = int(s.proj_factor * D)
    H = cfg.n_heads
    dt = cfg.pdtype

    def dense(shape, **kw):
        return dense_init(generator, shape, dt, device=device, **kw)

    return {
        "norm": torch.ones((D,), dtype=dt, device=device),
        "up": dense((D, 2 * di)),
        "conv": conv1d_init(generator, di, s.conv_kernel, dt, device),
        "wq": dense((di, di)),
        "wk": dense((di, di)),
        "wv": dense((di, di)),
        "wif": dense((di, 2 * H)),
        "out_norm": torch.ones((di,), dtype=dt, device=device),
        "down": dense((di, D)),
    }


def _mlstm_gates(pre, H: int):
    """pre: ``[B, T, 2H]`` → ``(log_f [B, H, T], i [B, H, T])`` f32,
    stabilized by clipping the input gate's pre-activation."""
    f_pre, i_pre = pre[..., :H], pre[..., H:]
    log_f = F.logsigmoid(f_pre.float())
    i_gate = torch.exp(torch.clamp(i_pre.float(), -10.0, 2.0))
    return (log_f.transpose(1, 2).contiguous(),
            i_gate.transpose(1, 2).contiguous())


def _heads(y, B: int, T: int, H: int, d: int):
    """``[B, T, H*d]`` → contiguous ``[B, H, T, d]``."""
    return y.reshape(B, T, H, d).transpose(1, 2).contiguous()


def mlstm_apply(p, x, cfg: ModelConfig, ax, state=None):
    """x: ``[B, T, D]`` → ``(x + y, {"C": final state, "conv": tail})``."""
    if state is not None:
        raise NotImplementedError(_DECODE)
    s = cfg.ssm
    B, T, D = x.shape
    H = cfg.n_heads
    di = int(s.proj_factor * D)
    dk = di // H
    dt = cfg.adtype

    h = rmsnorm(x, p["norm"], cfg.norm_eps)
    up = h @ p["up"].to(dt)
    xm, z = up[..., :di], up[..., di:]
    xc, new_conv = conv1d_apply(p["conv"], xm)
    xc = F.silu(xc.float()).to(dt)
    q = _heads(xc @ p["wq"].to(dt), B, T, H, dk)
    k = _heads(xc @ p["wk"].to(dt), B, T, H, dk)
    v = _heads(xm @ p["wv"].to(dt), B, T, H, dk)
    log_f, i_gate = _mlstm_gates(xm @ p["wif"].to(dt), H)
    out, C = ops.gla_scan(q, k, v, log_f, i_gate, normalize=True)

    out = out.transpose(1, 2).reshape(B, T, di)
    out = rmsnorm(out, p["out_norm"], cfg.norm_eps)
    out = out * F.silu(z.float()).to(dt)
    y = out @ p["down"].to(dt)
    return x + y, {"C": C, "conv": new_conv}


def mlstm_init_state(cfg: ModelConfig, batch: int):
    raise NotImplementedError(_DECODE)


# ---------------------------------------------------------------------------
# sLSTM block (xLSTM) — sequential over T
# ---------------------------------------------------------------------------


def slstm_init(generator: torch.Generator, cfg: ModelConfig, device=None) -> dict:
    D = cfg.d_model
    H = cfg.n_heads
    dh = D // H
    ffd = max(1, int(4 / 3 * D))
    dt = cfg.pdtype

    def dense(shape, **kw):
        return dense_init(generator, shape, dt, device=device, **kw)

    return {
        "norm": torch.ones((D,), dtype=dt, device=device),
        "wx": dense((D, 4 * D)),  # i, f, z, o pre-activations
        "r": dense((H, dh, 4 * dh), fan_in=dh),
        "ffn_up": dense((D, ffd)),
        "ffn_down": dense((ffd, D)),
        "ffn_norm": torch.ones((D,), dtype=dt, device=device),
    }


def slstm_step(r, cfg: ModelConfig, carry, wx_t):
    """carry: ``(h [B, D], c, n, m)``; ``wx_t [B, 4D]`` the input
    pre-activations; ``r [H, dh, 4dh]`` already in h's dtype."""
    H, D = cfg.n_heads, cfg.d_model
    dh = D // H
    h, c, n, m = carry
    rh = torch.bmm(h.reshape(-1, H, dh).transpose(0, 1), r).transpose(0, 1)
    pre = (wx_t.reshape(-1, H, 4 * dh) + rh).float()
    i_p, f_p, z_p, o_p = pre.split(dh, dim=-1)
    m_new = torch.maximum(f_p + m, i_p)  # per-unit stabilizer
    i = torch.exp(i_p - m_new)
    f = torch.exp(f_p + m - m_new)
    c = f * c + i * torch.tanh(z_p)
    n = f * n + i
    h_new = torch.sigmoid(o_p) * c / torch.clamp_min(n, 1.0)
    return (h_new.reshape(-1, D).to(h.dtype), c, n, m_new)


def slstm_apply(p, x, cfg: ModelConfig, ax, state=None):
    """x: ``[B, T, D]``; a Python loop over T.  Returns ``(x', (h, c, n,
    m))``."""
    if state is not None:
        raise NotImplementedError(_DECODE)
    B, T, D = x.shape
    H = cfg.n_heads
    dh = D // H
    dt = cfg.adtype
    h0 = rmsnorm(x, p["norm"], cfg.norm_eps)
    wx = h0 @ p["wx"].to(dt)  # [B, T, 4D]
    f32 = dict(dtype=torch.float32, device=x.device)
    carry = (torch.zeros((B, D), dtype=dt, device=x.device),
             torch.zeros((B, H, dh), **f32), torch.zeros((B, H, dh), **f32),
             torch.full((B, H, dh), -1e30, **f32))
    r = p["r"].to(dt)
    hs = []
    for t in range(T):
        carry = slstm_step(r, cfg, carry, wx[:, t])
        hs.append(carry[0])
    x = x + torch.stack(hs, dim=1)
    # post-FFN (proj factor 4/3, tanh-approximated gelu as jax.nn.gelu)
    f = rmsnorm(x, p["ffn_norm"], cfg.norm_eps)
    f = F.gelu((f @ p["ffn_up"].to(dt)).float(), approximate="tanh").to(dt)
    x = x + f @ p["ffn_down"].to(dt)
    return x, carry


def slstm_init_state(cfg: ModelConfig, batch: int):
    raise NotImplementedError(_DECODE)


# ---------------------------------------------------------------------------
# SSD heads (hymba): mamba-2-style scalar-decay state space
# ---------------------------------------------------------------------------


def ssd_init(generator: torch.Generator, cfg: ModelConfig, device=None) -> dict:
    D = cfg.d_model
    s = cfg.ssm
    H = s.n_ssm_heads
    hd = D // H
    N = s.state_size
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "in_proj": dense_init(generator, (D, H * (hd + 2 * N + 1) + H * hd),
                              cfg.pdtype, device=device),
        "conv": conv1d_init(generator, H * (hd + 2 * N), s.conv_kernel,
                            cfg.pdtype, device),
        "A_log": torch.zeros((H,), **f32),
        "D_skip": torch.ones((H,), **f32),
        "dt_bias": torch.zeros((H,), **f32),
        "out_norm": torch.ones((H * hd,), dtype=cfg.pdtype, device=device),
    }


def ssd_apply(p, x, cfg: ModelConfig, ax, state=None):
    """Returns ``(y [B, T, H*hd], {"C": final state, "conv": tail})``."""
    if state is not None:
        raise NotImplementedError(_DECODE)
    s = cfg.ssm
    B, T, D = x.shape
    H = s.n_ssm_heads
    hd = D // H
    N = s.state_size
    dt = cfg.adtype

    proj = x @ p["in_proj"].to(dt)
    width = H * (hd + 2 * N)
    core, z, dt_pre = (proj[..., :width], proj[..., width:width + H * hd],
                       proj[..., -H:])
    core, new_conv = conv1d_apply(p["conv"], core)
    core = F.silu(core.float()).to(dt).reshape(B, T, H, hd + 2 * N)
    v = core[..., :hd].transpose(1, 2).contiguous()  # [B, H, T, hd]
    k = core[..., hd:hd + N].transpose(1, 2).contiguous()  # B_ssm
    q = core[..., hd + N:].transpose(1, 2).contiguous()  # C_ssm

    delta = F.softplus(dt_pre.float() + p["dt_bias"])  # [B, T, H]
    delta = delta.transpose(1, 2).contiguous()  # [B, H, T]
    A = torch.exp(p["A_log"])[None, :, None]  # [1, H, 1] > 0
    log_f = -delta * A
    i_gate = delta
    out, C = ops.gla_scan(q, k, v, log_f, i_gate, normalize=False)

    out = out + p["D_skip"].to(dt)[None, :, None, None] * v
    y = out.transpose(1, 2).reshape(B, T, H * hd)
    y = rmsnorm(y, p["out_norm"], cfg.norm_eps)
    y = y * F.silu(z.float()).to(dt)
    return y, {"C": C, "conv": new_conv}


def ssd_init_state(cfg: ModelConfig, batch: int):
    raise NotImplementedError(_DECODE)

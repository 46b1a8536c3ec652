"""GQA self-attention for training and prefill.

Port of :mod:`repro.models.attention` (``attn_init``, ``_qkv`` and the
train/prefill branch of ``attn_apply``): projections in the compute dtype,
optional per-head RMSNorm on q/k (``qk_norm``), rotate-half RoPE, and
attention through :func:`repro_torch.kernels.ops.flash_attention` — the
Hopper kernels on the card, forward and backward.  The KV caches of the
decode path (``init_cache``, ``_full_cache_attend``, ``_ring_attend``) are
not ported yet (ROADMAP Queue 1, item 12): passing a cache raises.
"""

from __future__ import annotations

import torch

from ..kernels import ops
from .config import ModelConfig
from .layers import Axes, apply_rope, dense_init, rmsnorm


def attn_init(generator: torch.Generator, cfg: ModelConfig, device=None) -> dict:
    D, Hq, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    p = {
        "wq": dense_init(generator, (D, Hq * hd), cfg.pdtype, device=device),
        "wk": dense_init(generator, (D, Hkv * hd), cfg.pdtype, device=device),
        "wv": dense_init(generator, (D, Hkv * hd), cfg.pdtype, device=device),
        "wo": dense_init(generator, (Hq * hd, D), cfg.pdtype, device=device),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=cfg.pdtype, device=device)
        p["k_norm"] = torch.ones((hd,), dtype=cfg.pdtype, device=device)
    return p


def _split_heads(x, n, hd):
    return x.reshape(x.shape[:-1] + (n, hd))


def _qkv(p, cfg: ModelConfig, x, positions):
    Hq, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dt = cfg.adtype
    q = _split_heads(x @ p["wq"].to(dt), Hq, hd)
    k = _split_heads(x @ p["wk"].to(dt), Hkv, hd)
    v = _split_heads(x @ p["wv"].to(dt), Hkv, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attn_apply(p, x, cfg: ModelConfig, ax: Axes, *, positions=None,
               cache=None):
    """``x [B, T, D]`` → ``(out [B, T, D], None)``: causal (or
    bidirectional) self-attention with the config's sliding window."""
    if cache is not None:
        raise NotImplementedError(
            "KV caches (decode) are not ported yet (ROADMAP Queue 1, item 12)")
    B, T, D = x.shape
    if positions is None:
        positions = torch.arange(T, device=x.device)
    q, k, v = _qkv(p, cfg, x, positions)
    out = ops.flash_attention(
        q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
        v.transpose(1, 2).contiguous(), causal=cfg.causal,
        window=cfg.sliding_window, q_offset=0)
    out = out.transpose(1, 2).reshape(B, T, cfg.n_heads * cfg.hd)
    out = out @ p["wo"].to(cfg.adtype)
    return ax.act_btd(out), None

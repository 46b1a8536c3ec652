"""Model configuration schema for the architecture zoo.

Port of :mod:`repro.models.config`: the same records and fields, with
``adtype``/``pdtype`` as torch dtypes.  One block structure covers every
architecture of the zoo::

    x -> norm -> MIXER(s) -> +residual -> norm -> CHANNEL-MLP -> +residual

The port builds the dense family (:mod:`repro_torch.models.lm`); the other
families' records are here so that every configuration of
:mod:`repro_torch.configs` loads.

>>> cfg = ModelConfig(name="t", family="dense", n_layers=2, d_model=64,
...                   n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256)
>>> cfg.hd, cfg.adtype, cfg.reduced().adtype
(16, torch.bfloat16, torch.float32)
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0  # shared experts (deepseek-v2 style), each d_ff_expert wide
    capacity_factor: float = 1.25
    router_softmax: bool = True  # False -> sigmoid scores (llama4-style)
    every_k: int = 1  # MoE on every k-th layer (llama4 interleaves dense/MoE)
    dispatch: str = "fmi"  # fmi (shard_map EP) | scatter | einsum (GShard)


@dataclass(frozen=True)
class MLACfg:
    kv_lora: int = 512
    q_lora: int = 1536
    qk_nope: int = 128
    qk_rope: int = 64
    v_dim: int = 128


@dataclass(frozen=True)
class SSMCfg:
    kind: str = "mlstm"  # 'mlstm' (xlstm) | 'ssd' (mamba-2 style, hymba heads)
    proj_factor: float = 2.0  # d_inner = proj_factor * d_model (mlstm)
    conv_kernel: int = 4
    state_size: int = 16  # ssd state per head
    slstm_every: int = 4  # xlstm: every k-th block is an sLSTM block
    n_ssm_heads: int = 0  # hymba: SSD heads running parallel to attention


@dataclass(frozen=True)
class VLMCfg:
    cross_every: int = 5  # every 5th layer is a cross-attention layer
    n_vision_tokens: int = 1601  # stub frontend supplies [B, n_vis, d_model]


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | vlm | ssm | hybrid | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    qk_norm: bool = False
    causal: bool = True  # False: encoder-only (hubert)
    sliding_window: int = 0  # 0 = full attention
    rope_theta: float = 500_000.0
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    moe: Optional[MoECfg] = None
    mla: Optional[MLACfg] = None
    ssm: Optional[SSMCfg] = None
    vlm: Optional[VLMCfg] = None
    # numerics
    dtype: str = "bfloat16"  # activation/compute dtype
    param_dtype: str = "float32"  # stored parameter dtype
    # training details
    remat: bool = True
    scan_layers: bool = True

    # ---- derived ----
    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def group_size(self) -> int:
        """Layers per scan group of the reference's stacked layout."""
        if self.family == "vlm" and self.vlm:
            return self.vlm.cross_every
        if self.family == "ssm" and self.ssm and self.ssm.kind == "mlstm":
            return self.ssm.slstm_every
        if self.family == "moe" and self.moe:
            return self.moe.every_k
        return 1

    @property
    def n_groups(self) -> int:
        assert self.n_layers % self.group_size == 0, (
            f"{self.name}: n_layers={self.n_layers} % group={self.group_size}"
        )
        return self.n_layers // self.group_size

    @property
    def adtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @property
    def pdtype(self) -> torch.dtype:
        return _DTYPES[self.param_dtype]

    @property
    def has_attention(self) -> bool:
        return self.family != "ssm"

    @property
    def supports_decode(self) -> bool:
        return self.causal  # encoder-only archs have no autoregressive step

    @property
    def subquadratic(self) -> bool:
        """Can this arch serve 500k-token contexts with bounded state?"""
        if self.family == "ssm":
            return True
        if self.family == "hybrid":
            return self.sliding_window > 0
        return False

    def reduced(self, **over) -> "ModelConfig":
        """Smoke-test-sized variant of the same family (CPU-runnable)."""
        kw: dict = dict(
            n_layers=min(self.n_layers, 2 * self.group_size),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2),
            d_ff=256,
            vocab_size=512,
            head_dim=32,
        )
        if self.moe:
            kw["moe"] = replace(
                self.moe, n_experts=8, top_k=min(self.moe.top_k, 2), d_ff_expert=64
            )
        if self.mla:
            kw["mla"] = MLACfg(kv_lora=32, q_lora=64, qk_nope=32, qk_rope=16, v_dim=32)
        if self.ssm:
            kw["ssm"] = replace(self.ssm, state_size=8,
                                n_ssm_heads=2 if self.ssm.n_ssm_heads else 0)
        if self.vlm:
            kw["vlm"] = replace(self.vlm, n_vision_tokens=16)
        if self.sliding_window:
            kw["sliding_window"] = 32
        kw["param_dtype"] = "float32"
        kw["dtype"] = "float32"
        kw.update(over)
        return replace(self, **kw)

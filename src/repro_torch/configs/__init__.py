"""Architecture registry: ``get(name)`` returns the full ModelConfig;
``get_reduced(name)`` the CPU-smoke-sized variant of the same family.

Assigned architectures (public-literature configs; sources in each file):
yi-6b, qwen3-1.7b, llama3.2-1b, granite-3-8b, llama-3.2-vision-90b,
deepseek-v2-236b, llama4-maverick-400b-a17b, xlstm-125m, hymba-1.5b,
hubert-xlarge — plus the paper's own case-study config (distributed
K-Means, see examples/distributed_kmeans.py).
"""

from __future__ import annotations

import importlib

from ..models.config import ModelConfig

ARCH_IDS = [
    "yi_6b",
    "qwen3_1_7b",
    "llama3_2_1b",
    "granite_3_8b",
    "llama3_2_vision_90b",
    "deepseek_v2_236b",
    "llama4_maverick_400b",
    "xlstm_125m",
    "hymba_1_5b",
    "hubert_xlarge",
]

_ALIASES = {
    "yi-6b": "yi_6b",
    "qwen3-1.7b": "qwen3_1_7b",
    "llama3.2-1b": "llama3_2_1b",
    "granite-3-8b": "granite_3_8b",
    "llama-3.2-vision-90b": "llama3_2_vision_90b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b",
    "xlstm-125m": "xlstm_125m",
    "hymba-1.5b": "hymba_1_5b",
    "hubert-xlarge": "hubert_xlarge",
}


def canonical(name: str) -> str:
    name = name.replace("-", "_").replace(".", "_")
    for alias, mod in _ALIASES.items():
        if name == alias.replace("-", "_").replace(".", "_"):
            return mod
    if name in ARCH_IDS:
        return name
    raise KeyError(f"unknown architecture {name!r}; known: {ARCH_IDS}")


def get(name: str) -> ModelConfig:
    mod = importlib.import_module(f".{canonical(name)}", __package__)
    return mod.CONFIG


def get_reduced(name: str, **over) -> ModelConfig:
    return get(name).reduced(**over)


# ---------------------------------------------------------------------------
# shape set (assigned; per-arch applicability encoded in runnable_cells)
# ---------------------------------------------------------------------------

SHAPES = {
    "train_4k": dict(kind="train", seq_len=4096, global_batch=256),
    "prefill_32k": dict(kind="prefill", seq_len=32768, global_batch=32),
    "decode_32k": dict(kind="decode", seq_len=32768, global_batch=128),
    "long_500k": dict(kind="decode", seq_len=524288, global_batch=1),
}


def cell_status(cfg: ModelConfig, shape_name: str) -> str:
    """'run' or a documented skip reason for one (arch x shape) cell."""
    s = SHAPES[shape_name]
    if s["kind"] == "decode" and not cfg.supports_decode:
        return "SKIP: encoder-only arch has no autoregressive decode step"
    if shape_name == "long_500k" and not cfg.subquadratic:
        return "SKIP: 500k decode requires sub-quadratic attention/state (full-attention arch)"
    return "run"

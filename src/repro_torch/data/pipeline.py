"""Deterministic synthetic training data.

Port of :mod:`repro.data.pipeline` (``DataConfig``, ``_rng``,
``synthetic_tokens``, ``synthetic_batch``): numpy code that gives the
reference's arrays bit for bit.  Batch contents are a pure function of
``(seed, step, data_rank)``, so a restart resumes exactly.  The memmap
source and the prefetching ``Pipeline`` are not ported yet (ROADMAP
Queue 1, item 15).

>>> from repro_torch.models.config import ModelConfig
>>> cfg = ModelConfig(name="t", family="dense", n_layers=1, d_model=8,
...                   n_heads=2, n_kv_heads=1, d_ff=8, vocab_size=50)
>>> b = synthetic_batch(DataConfig(), cfg, batch=2, seq=16, step=0)
>>> b["tokens"].shape, b["labels"].dtype.name, bool((b["tokens"][:, 1:] == b["labels"][:, :-1]).all())
((2, 16), 'int32', True)
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..models.config import ModelConfig


@dataclass(frozen=True)
class DataConfig:
    seed: int = 1234
    source: str = "synthetic"  # 'synthetic' ('memmap' is not ported yet)
    memmap_path: str = ""
    prefetch: int = 2
    mask_rate: float = 0.3  # audio masked-prediction rate


def _rng(cfg: DataConfig, step: int, rank: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([cfg.seed, int(step), int(rank)])
    )


def synthetic_tokens(cfg: DataConfig, vocab: int, batch: int, seq: int,
                     step: int, rank: int = 0) -> np.ndarray:
    """Learnable pseudo-text: Zipfian unigrams + injected repeating n-grams."""
    rng = _rng(cfg, step, rank)
    ranks = rng.zipf(1.3, size=(batch, seq)).astype(np.int64)
    toks = (ranks - 1) % vocab
    # repeat a sampled 8-gram a few times per row -> in-context structure
    for b in range(batch):
        gram = rng.integers(0, vocab, 8)
        for _ in range(max(1, seq // 64)):
            at = int(rng.integers(0, max(1, seq - 8)))
            toks[b, at : at + 8] = gram
    return toks.astype(np.int32)


def synthetic_batch(cfg: DataConfig, mcfg: ModelConfig, batch: int, seq: int,
                    step: int, rank: int = 0) -> dict[str, np.ndarray]:
    """One host batch for any architecture family."""
    rng = _rng(cfg, step, rank)
    if mcfg.family == "audio":
        feats = rng.normal(size=(batch, seq, mcfg.d_model)).astype(np.float32)
        mask = rng.random((batch, seq)) < cfg.mask_rate
        labels = rng.integers(0, mcfg.vocab_size, (batch, seq)).astype(np.int32)
        labels = np.where(mask, labels, -1)  # loss only on masked frames
        return {"features": feats, "mask": mask, "labels": labels}
    toks = synthetic_tokens(cfg, mcfg.vocab_size, batch, seq + 1, step, rank)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
    if mcfg.family == "vlm":
        out["vision"] = rng.normal(
            size=(batch, mcfg.vlm.n_vision_tokens, mcfg.d_model)
        ).astype(np.float32)
    return out

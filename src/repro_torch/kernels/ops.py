"""Entry points for the port's kernels (port of :mod:`repro.kernels.ops`).

The reference picks the Pallas kernel on a TPU and its XLA twin elsewhere;
here each wrapper dispatches on the tensor's device (a CPU tensor runs the
plain PyTorch version, a CUDA tensor the hand-written Hopper kernel).
"""

from __future__ import annotations

import torch

from . import flash_attention as _fa
from .gla_scan import gla_scan
from .paged_attention import paged_attention
from .quantize import (dequantize_blockwise, dequantize_page,
                       quantize_blockwise, quantize_page)

__all__ = ["dequantize_blockwise", "dequantize_page", "flash_attention",
           "gla_scan", "paged_attention", "quantize_blockwise",
           "quantize_page"]


def flash_attention(q, k, v, causal: bool = True, window: int = 0,
                    q_offset: int = 0):
    """GQA flash attention: q ``[B,Hq,T,d]``, k ``[B,Hkv,S,d]``, v
    ``[B,Hkv,S,dv]`` → ``[B,Hq,T,dv]``.  ``q_offset`` is static (a Python int): the dynamic
    offset of the reference's decode path belongs to the decode slice."""
    if isinstance(q_offset, torch.Tensor):
        raise NotImplementedError(
            "a dynamic q_offset (decode) is not ported yet (ROADMAP Queue 1, "
            "item 14)")
    return _fa.flash_attention(q, k, v, causal, window, q_offset)

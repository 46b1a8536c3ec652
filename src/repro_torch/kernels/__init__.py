"""Hand-written GPU kernels of the port, each beside its plain PyTorch
version.  Nothing is compiled when this package is imported: a kernel's
shared library is built from ``csrc/`` on its first CUDA launch."""

from __future__ import annotations

import torch


def empty_for_kernel(shape, dtype, device) -> torch.Tensor:
    """``torch.empty`` for a buffer a kernel writes in full.  Under
    deterministic mode PyTorch fills fresh memory with NaN, which would
    only add a launch per call, so the fill is skipped here."""
    fill = torch.utils.deterministic.fill_uninitialized_memory
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        return torch.empty(tuple(shape), dtype=dtype, device=device)
    finally:
        torch.utils.deterministic.fill_uninitialized_memory = fill


def stream_of(t: torch.Tensor) -> int:
    """The raw handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream

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


def check_aligned(**tensors: torch.Tensor) -> None:
    """Raise on a tensor whose base address is not on a 16-byte boundary:
    the bf16 kernels load their tiles in 16-byte pieces (TMA, ``cp.async``).
    Row strides need no check where every row is a multiple of 16 bytes, as
    the wrappers' shape checks make it."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary for "
                             f"the bf16 kernels; got address "
                             f"{t.data_ptr():#x}")


def stream_of(t: torch.Tensor) -> int:
    """The raw handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream

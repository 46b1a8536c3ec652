"""Where the port's tensors live.

Every entry point of :mod:`repro_torch` runs on the card unless the caller
asks for another device: ``device=None`` means CUDA, and with no CUDA
device it raises instead of falling back to the CPU.  Tests and CPU runs
pass ``device="cpu"`` explicitly.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an object should hold its tensors on.

    >>> resolve_device("cpu")
    device(type='cpu')
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU")
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not "
                           "available")
    return device


def true_div(x: torch.Tensor, divisor: float) -> torch.Tensor:
    """``x / divisor`` rounded as IEEE division, on every device.  PyTorch's
    CUDA kernel multiplies by the reciprocal of a host scalar, which differs
    from the quotient in the last bit for some inputs (``x / 127`` for ~5%
    of f32 values); a divisor on ``x``'s own device keeps the division.

    >>> true_div(torch.tensor([254.0, 1.0]), 127).tolist()
    [2.0, 0.007874015718698502]
    """
    return x / torch.full((), divisor, dtype=x.dtype, device=x.device)


def to_device(array, device: torch.device) -> torch.Tensor:
    """A host array (indices, tokens, page tables) as a tensor on
    ``device``.  To a CUDA device it goes from pinned memory without
    blocking, so building an index never waits for the work already queued
    on the card (a plain host-to-device copy synchronizes the stream).

    >>> to_device(np.arange(3), torch.device("cpu")).tolist()
    [0, 1, 2]
    """
    host = torch.from_numpy(np.array(array, copy=True, order="C"))
    if device.type != "cuda":
        return host
    return host.pin_memory().to(device, non_blocking=True)

"""Entry points for the port's kernels (port of :mod:`repro.kernels.ops`,
``paged_attention`` only).

The reference picks the Pallas kernel on a TPU and its XLA twin elsewhere;
here the wrapper itself dispatches on the tensor's device (a CPU tensor runs
the plain PyTorch version, a CUDA tensor the hand-written Hopper kernel), so
this module only re-exports it.  The other reference kernels
(``flash_attention``, ``gla_scan``, the quantizers) are not ported yet
(ROADMAP Queue 2).
"""

from __future__ import annotations

from .paged_attention import paged_attention

__all__ = ["paged_attention"]

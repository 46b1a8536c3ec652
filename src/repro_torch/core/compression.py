"""Compressed collectives — cheap messages for expensive links.

Port of :mod:`repro.core.compression`: the int8 ring allreduce (every hop
carries int8 payload + per-``block`` f32 max-abs scales; accumulation
stays f32), its error-feedback wrapper, and the wire-byte / α-β models.
The codec is the port's :mod:`repro_torch.kernels.quantize` wrappers in
place of the reference's ``xp`` functions: on the card each call is one
launch of the Hopper kernel over the stacked ``[P, c]`` chunk, on the CPU
the plain version; the arithmetic is the reference's (max-abs / 127,
divide by the scale, round half to even, clip ±127), bit for bit.

Doctest — quantize/dequantize round-trip bounds and the wire-byte model::

    >>> import torch
    >>> x = torch.linspace(-1.0, 1.0, 512)[None]
    >>> q, scale = quantize_blockwise(x, block=256)
    >>> q.dtype, tuple(scale.shape)
    (torch.int8, (1, 2))
    >>> y = dequantize_blockwise(q, scale, block=256)
    >>> bool((x - y).abs().max() <= x.abs().max() / 127.0)
    True
    >>> compressed_hop_bytes(1024, block=256)   # int8 payload + f32 scales
    1040.0
    >>> int(1024 * 4 / compressed_hop_bytes(1024, 256))  # ~4x f32 reduction
    3
    >>> ring = compressed_ring_time(4e6, P=4, alpha=1e-5, beta=1/6.25e9)
    >>> bool(0 < ring < 2 * (4 - 1) * (2e-5 + 1e6 * 4 / 6.25e9))
    True
"""

from __future__ import annotations

from ..devices import true_div
from ..kernels import quantize as _qz
from .transport import Transport, resolve_op


def quantize_blockwise(x, block: int = 256):
    """``x``: stacked ``[P, ..., n]`` with ``n % block == 0`` → (int8
    ``[P, ..., n]``, f32 scales ``[P, ..., n/block]``), one kernel launch
    on the card."""
    return _qz.quantize_blockwise(x.contiguous(), block)


def dequantize_blockwise(q, scale, block: int = 256):
    return _qz.dequantize_blockwise(q.contiguous(), scale.contiguous(), block)


def compressed_ring_allreduce(t: Transport, x, op="add", block: int = 256,
                              mean: bool = False):
    """Quantized ring allreduce on a stacked transport.

    ``x``: logical flat ``[n]`` (physically ``[P, n]``) with
    ``n % (P*block) == 0`` (callers pad).  Payload on the wire is int8 +
    per-block f32 scales; the running partial sums stay f32."""
    opf = resolve_op(op)
    P = t.size
    if P == 1:
        return x
    n = t.lshape(x)[0]
    if n % (P * block):
        raise ValueError(f"size {n} must be divisible by P*block = {P * block}")
    c = n // P
    chunks = t.reshape(x, (P, c))
    r = t.rank()
    ring = [(i, (i + 1) % P) for i in range(P)]

    # --- reduce-scatter with quantize-on-wire ---
    for i in range(P - 1):
        send_idx = (r - i) % P
        recv_idx = (r - i - 1) % P
        send = t.dynslice(chunks, send_idx, 1, axis=0)  # [1, c]
        q, s = quantize_blockwise(send, block)
        # fmi-lint: disable=FMI004 -- port core/ module (lint roots core/ at repro/)
        q_r = t.ppermute(q, ring)
        # fmi-lint: disable=FMI004 -- port core/ module (lint roots core/ at repro/)
        s_r = t.ppermute(s, ring)
        recv = dequantize_blockwise(q_r, s_r, block)
        cur = t.dynslice(chunks, recv_idx, 1, axis=0)
        chunks = t.dynupdate(chunks, opf(cur, recv), recv_idx, axis=0)

    # --- allgather of the owned (fully reduced) chunk, quantized once ---
    own_idx = (r + 1) % P
    own = t.dynslice(chunks, own_idx, 1, axis=0)
    if mean:
        own = true_div(own, P)
    q_own, s_own = quantize_blockwise(own, block)
    out = t.zeros((P, c), x.dtype)
    out = t.dynupdate(out, dequantize_blockwise(q_own, s_own, block), own_idx,
                      axis=0)
    q_cur, s_cur = q_own, s_own
    for i in range(P - 1):
        # fmi-lint: disable=FMI004 -- port core/ module (lint roots core/ at repro/)
        q_cur = t.ppermute(q_cur, ring)
        # fmi-lint: disable=FMI004 -- port core/ module (lint roots core/ at repro/)
        s_cur = t.ppermute(s_cur, ring)
        recv_idx = (own_idx - i - 1) % P
        out = t.dynupdate(out, dequantize_blockwise(q_cur, s_cur, block),
                          recv_idx, axis=0)
    return t.reshape(out, (n,))


def compressed_allreduce_with_ef(t: Transport, x, residual, op="add",
                                 block: int = 256, mean: bool = False):
    """Error-feedback wrapper: quantization residual of the *input* is added
    back next step (EF-SGD).  Returns (allreduced, new_residual)."""
    e = x + residual
    q, s = quantize_blockwise(e, block)
    deq = dequantize_blockwise(q, s, block)
    new_residual = e - deq
    out = compressed_ring_allreduce(t, deq, op=op, block=block, mean=mean)
    return out, new_residual


def compressed_hop_bytes(c: int, block: int, in_itemsize: int = 4) -> float:
    """Wire bytes of one compressed hop for a chunk of ``c`` elements
    (int8 payload + f32 scales) vs ``c*in_itemsize`` uncompressed."""
    return c * 1.0 + (c / block) * 4.0


def compressed_ring_time(nbytes: float, P: int, alpha: float, beta: float,
                         block: int = 256, itemsize: int = 4) -> float:
    """α-β model: 2(P−1) rounds × 2 messages (payload + scales) of the
    compressed chunk."""
    n_elems = nbytes / itemsize
    c = n_elems / P
    hop = compressed_hop_bytes(c, block)
    return 2 * (P - 1) * (2 * alpha + hop * beta)

"""Blockwise int8 quantize / dequantize (per-``block`` max-abs f32 scales).

Port of the Pallas TPU kernels :mod:`repro.kernels.quantize`
(``quantize_blockwise``, ``dequantize_blockwise``), the codec under the
compressed gradient allreduce (:mod:`repro_torch.core.compression`).  The
per-(page, head) KV variants ``quantize_page``/``dequantize_page`` are not
ported yet (ROADMAP Queue 2).

* :func:`quantize_blockwise` / :func:`dequantize_blockwise` — the
  wrappers.  CUDA tensors launch the Hopper kernels of ``csrc/quantize.cu``
  (counted in ``<wrapper>.launches``); CPU tensors run the plain versions.
  Nothing falls back: a CUDA call the kernel does not take raises.
* :func:`quantize_blockwise_plain` / :func:`dequantize_blockwise_plain` —
  the plain PyTorch versions, the port of ``repro.kernels.ref``'s.
* the contract, bit-exact with the reference: over ``[..., N]`` with
  ``N % block == 0``, ``scale = amax / 127`` (1 where ``amax == 0``),
  ``q = clip(rint(x / scale), -127, 127)`` as int8 (an IEEE division and
  round-half-to-even), and ``x' = q * scale``.

>>> x = torch.tensor([[0.5, -1.0, 0.25, 0.0]])
>>> q, s = quantize_blockwise(x, block=2)
>>> q.tolist(), s.tolist()
([[64, -127, 127, 0]], [[0.007874015718698502, 0.0019685039296746254]])
>>> dequantize_blockwise(q, s, block=2).tolist()
[[0.5039370059967041, -1.0, 0.25, 0.0]]
"""

from __future__ import annotations

import ctypes

import torch

from ..devices import true_div
from . import empty_for_kernel, stream_of

_IN_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _blocks(shape, block: int):
    if block < 1 or shape[-1] % block:
        raise ValueError(f"last dim {shape[-1]} not a multiple of block={block}")
    return tuple(shape[:-1]) + (shape[-1] // block, block)


def quantize_blockwise_plain(x, block: int = 256):
    """``[..., n]`` → (int8 ``[..., n]``, f32 scales ``[..., n/block]``)."""
    xb = x.reshape(_blocks(x.shape, block)).float()
    amax = xb.abs().amax(dim=-1)
    scale = torch.where(amax > 0, true_div(amax, 127), torch.ones_like(amax))
    q = torch.clamp(torch.round(xb / scale[..., None]), -127, 127)
    return q.to(torch.int8).reshape(x.shape), scale


def dequantize_blockwise_plain(q, scale, block: int = 256,
                               out_dtype=torch.float32):
    qb = q.reshape(_blocks(q.shape, block)).float()
    return (qb * scale[..., None]).reshape(q.shape).to(out_dtype)


def _lib():
    from . import _build

    lib = _build.load("quantize")
    if lib.quantize_blockwise_launch.argtypes is None:
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.quantize_blockwise_launch.argtypes = [p, p, p, i64, i64, i, i, p]
        lib.quantize_blockwise_launch.restype = i
        lib.dequantize_blockwise_launch.argtypes = [p, p, p, i64, i64, i, i, p]
        lib.dequantize_blockwise_launch.restype = i
    return lib


def _check_cuda(name, t, dtypes):
    if t.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {t.device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} takes {sorted(map(str, dtypes))}, not {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: input must be contiguous")


def quantize_blockwise(x, block: int = 256):
    """``[..., n]`` f32/bf16 (``n % block == 0``) → (int8 ``[..., n]``, f32
    scales ``[..., n/block]``).  CPU: plain version; CUDA: the kernel."""
    if x.device.type == "cpu":
        return quantize_blockwise_plain(x, block)
    _check_cuda("quantize_blockwise", x, _IN_CODE)
    lead = _blocks(x.shape, block)[:-1]
    n = x.shape[-1]
    rows = x.numel() // n if n else 0
    q = empty_for_kernel(x.shape, torch.int8, x.device)
    scale = empty_for_kernel(lead, torch.float32, x.device)
    with torch.cuda.device(x.device):
        err = _lib().quantize_blockwise_launch(
            x.data_ptr(), q.data_ptr(), scale.data_ptr(), rows, n, block,
            _IN_CODE[x.dtype], stream_of(x))
    if err != 0:
        raise RuntimeError(f"quantize_blockwise launch failed: cudaError_t {err}")
    quantize_blockwise.launches += 1
    return q, scale


def dequantize_blockwise(q, scale, block: int = 256, out_dtype=torch.float32):
    """Inverse of :func:`quantize_blockwise`: ``q * scale`` in
    ``out_dtype`` (f32 or bf16).  CPU: plain version; CUDA: the kernel."""
    if q.device.type == "cpu":
        return dequantize_blockwise_plain(q, scale, block, out_dtype)
    _check_cuda("dequantize_blockwise", q, {torch.int8})
    _check_cuda("dequantize_blockwise", scale, {torch.float32})
    if out_dtype not in _IN_CODE:
        raise TypeError(f"out_dtype must be float32 or bfloat16, not {out_dtype}")
    lead = _blocks(q.shape, block)[:-1]
    if tuple(scale.shape) != lead or scale.device != q.device:
        raise ValueError(f"scale must be {lead} on {q.device}, got "
                         f"{tuple(scale.shape)} on {scale.device}")
    n = q.shape[-1]
    rows = q.numel() // n if n else 0
    out = empty_for_kernel(q.shape, out_dtype, q.device)
    with torch.cuda.device(q.device):
        err = _lib().dequantize_blockwise_launch(
            q.data_ptr(), scale.data_ptr(), out.data_ptr(), rows, n, block,
            _IN_CODE[out_dtype], stream_of(q))
    if err != 0:
        raise RuntimeError(f"dequantize_blockwise launch failed: "
                           f"cudaError_t {err}")
    dequantize_blockwise.launches += 1
    return out


#: Kernel launches since the process started (CUDA calls only).
quantize_blockwise.launches = 0
dequantize_blockwise.launches = 0

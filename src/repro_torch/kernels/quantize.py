"""Int8 quantize / dequantize: blockwise (per-``block`` max-abs f32 scales)
and per-(page, head) over KV pages.

Port of the Pallas TPU kernels :mod:`repro.kernels.quantize`
(``quantize_blockwise``, ``dequantize_blockwise``, the codec under the
compressed gradient allreduce of :mod:`repro_torch.core.compression`;
``quantize_page``, ``dequantize_page``, one scale per page and head of a
``[n_pages, ps, H, d]`` pool, which no path of either package calls: the
KV cache quantizes with its own write-once policy).

* :func:`quantize_blockwise` / :func:`dequantize_blockwise` — the
  wrappers.  CUDA tensors launch the Hopper kernels of ``csrc/quantize.cu``
  (counted in ``<wrapper>.launches``); CPU tensors run the plain versions.
  Nothing falls back: a CUDA call the kernel does not take raises.
* :func:`quantize_blockwise_plain` / :func:`dequantize_blockwise_plain`,
  :func:`quantize_page_plain` / :func:`dequantize_page_plain` — the plain
  PyTorch versions, the port of ``repro.kernels.ref``'s.
* the contract, bit-exact with the reference: over ``[..., N]`` with
  ``N % block == 0``, ``scale = amax / 127`` (1 where ``amax == 0``),
  ``q = clip(rint(x / scale), -127, 127)`` as int8 (an IEEE division and
  round-half-to-even), and ``x' = q * scale``; the page pair the same
  over each ``[ps, d]`` block of a page and head.
* :func:`page_plan` — how the page kernels cut a pool: elements a unit
  (16 bytes' worth, or 1 where ``d`` or an address does not allow it),
  pages a block, and whether a quantize block stages its pages in shared
  memory.  The launchers of ``csrc/quantize.cu`` check what it gives them.

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
        lib.quantize_page_launch.argtypes = [p, p, p, i64, i, i, i, i, i, i,
                                             i, p]
        lib.quantize_page_launch.restype = i
        lib.dequantize_page_launch.argtypes = [p, p, p, i64, i, i, i, i, i, i,
                                               p]
        lib.dequantize_page_launch.restype = i
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


def quantize_page_plain(x):
    """KV pages ``[n_pages, ps, H, d]`` → (int8 pages, f32 scales
    ``[n_pages, H]``), one max-abs scale per (page, head)."""
    xf = x.float()
    amax = xf.abs().amax(dim=(1, 3))
    scale = torch.where(amax > 0, true_div(amax, 127), torch.ones_like(amax))
    q = torch.clamp(torch.round(xf / scale[:, None, :, None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_page_plain(q, scale, out_dtype=torch.float32):
    return (q.float() * scale[:, None, :, None]).to(out_dtype)


def _pages(name, t):
    if t.dim() != 4:
        raise ValueError(f"{name} takes pages [n_pages, ps, H, d], got "
                         f"{tuple(t.shape)}")
    return t.shape


#: Warps of a page-kernel block (``kWarps`` in ``csrc/quantize.cu``): a
#: quantize block takes pages enough for one (page, head) a warp.
PAGE_WARPS = 8
#: Bytes of input a quantize block takes at least (whole pages; at least
#: one), and int8 bytes a dequantize block takes.
PAGE_BLOCK_BYTES = 16384
#: The most a quantize block stages in shared memory (``kMaxStage`` in
#: ``csrc/quantize.cu``); a larger page is read twice from device memory.
PAGE_MAX_STAGE = 200 * 1024


def page_plan(kind: str, shape, dtype, *ptrs: int) -> dict:
    """How the page kernels cut ``[n_pages, ps, H, d]``.  ``"quantize"``
    (``dtype`` the input's, ``ptrs`` the input's and the int8 output's
    addresses): ``vec`` elements a unit (16 bytes: 4 f32 or 8 bf16; 1 where
    ``d`` is not a multiple or an address is not aligned), ``ppb`` pages a
    block (one (page, head) a warp, and at least ``PAGE_BLOCK_BYTES``) and
    ``staged`` (they fit in shared memory).  ``"dequantize"`` (``dtype``
    the output's, ``ptrs`` the int8 input's and the output's): ``unit``
    int8 a thread at a time, so that each writes one 16-byte store (4 for
    f32, 8 for bf16; else 1), and ``ppb``."""
    n_pages, ps, H, d = (int(v) for v in shape)
    page = max(1, ps * H * d)
    item = torch.empty((), dtype=dtype).element_size()
    if kind == "quantize":
        vec = 16 // item
        if d % vec or ptrs[0] % 16 or ptrs[1] % vec:
            vec = 1
        ppb = max(-(-PAGE_WARPS // max(1, H)),
                  PAGE_BLOCK_BYTES // (page * item))
        ppb = max(1, min(n_pages, ppb, PAGE_MAX_STAGE // (page * item)))
        return dict(vec=vec, ppb=ppb,
                    staged=ppb * page * item <= PAGE_MAX_STAGE)
    if kind == "dequantize":
        unit = 16 // item
        if d % unit or ptrs[0] % unit or ptrs[1] % 16:
            unit = 1
        return dict(unit=unit,
                    ppb=max(1, min(n_pages, PAGE_BLOCK_BYTES // page)))
    raise ValueError(f"kind is 'quantize' or 'dequantize', not {kind!r}")


def quantize_page(x):
    """KV pages ``[n_pages, ps, H, d]`` f32/bf16 → (int8 pages, f32 scales
    ``[n_pages, H]``).  CPU: plain version; CUDA: the kernel."""
    if x.device.type == "cpu":
        return quantize_page_plain(x)
    _check_cuda("quantize_page", x, _IN_CODE)
    n_pages, ps, H, d = _pages("quantize_page", x)
    q = empty_for_kernel(x.shape, torch.int8, x.device)
    scale = empty_for_kernel((n_pages, H), torch.float32, x.device)
    plan = page_plan("quantize", x.shape, x.dtype, x.data_ptr(), q.data_ptr())
    with torch.cuda.device(x.device):
        err = _lib().quantize_page_launch(
            x.data_ptr(), q.data_ptr(), scale.data_ptr(), n_pages, ps, H, d,
            _IN_CODE[x.dtype], plan["vec"], plan["ppb"], int(plan["staged"]),
            stream_of(x))
    if err != 0:
        raise RuntimeError(f"quantize_page launch failed: cudaError_t {err}")
    quantize_page.launches += 1
    return q, scale


def dequantize_page(q, scale, out_dtype=torch.float32):
    """Inverse of :func:`quantize_page`: ``q * scale`` per (page, head) in
    ``out_dtype`` (f32 or bf16).  CPU: plain version; CUDA: the kernel."""
    if q.device.type == "cpu":
        return dequantize_page_plain(q, scale, out_dtype)
    _check_cuda("dequantize_page", q, {torch.int8})
    _check_cuda("dequantize_page", scale, {torch.float32})
    if out_dtype not in _IN_CODE:
        raise TypeError(f"out_dtype must be float32 or bfloat16, not {out_dtype}")
    n_pages, ps, H, d = _pages("dequantize_page", q)
    if tuple(scale.shape) != (n_pages, H) or scale.device != q.device:
        raise ValueError(f"scale must be {(n_pages, H)} on {q.device}, got "
                         f"{tuple(scale.shape)} on {scale.device}")
    out = empty_for_kernel(q.shape, out_dtype, q.device)
    plan = page_plan("dequantize", q.shape, out_dtype, q.data_ptr(),
                     out.data_ptr())
    with torch.cuda.device(q.device):
        err = _lib().dequantize_page_launch(
            q.data_ptr(), scale.data_ptr(), out.data_ptr(), n_pages, ps, H, d,
            _IN_CODE[out_dtype], plan["unit"], plan["ppb"], stream_of(q))
    if err != 0:
        raise RuntimeError(f"dequantize_page launch failed: cudaError_t {err}")
    dequantize_page.launches += 1
    return out


#: Kernel launches since the process started (CUDA calls only).
quantize_blockwise.launches = 0
dequantize_blockwise.launches = 0
quantize_page.launches = 0
dequantize_page.launches = 0

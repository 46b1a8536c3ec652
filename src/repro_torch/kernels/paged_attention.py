"""Paged decode attention straight off the rank-sharded page pool.

Port of the Pallas TPU kernel :mod:`repro.kernels.paged_attention`.  Three
pieces, one contract:

* :func:`paged_attention` — the wrapper.  A CUDA tensor goes to the
  hand-written Hopper kernel ``csrc/paged_attention.cu`` (built by
  :mod:`repro_torch.kernels._build` on first use, launched on the current
  stream, counted in ``paged_attention.launches``); a CPU tensor goes to
  the plain version.  Nothing falls back: a CUDA call that the kernel does
  not take, or whose build or launch fails, raises.
* :func:`paged_attention_plain` — the plain PyTorch version, the port of
  the reference's vectorized twin ``repro.kernels.ops._xla_paged_attention``:
  gather the ``[B, Hq, npm, ps]`` K/V blocks through the page table, mask,
  one softmax.
* the layout contract, shared with the reference: ``q [B, Hq, d]`` f32;
  ``k_pages``/``v_pages [n_pages, ps, Hkv, d]`` in f32/bf16/int8/e4m3;
  ``table [B, npm]`` i32 page ids; ``lengths [B]`` i32 visible tokens (0
  gives an exact-zero row); per-(page, kv-head) f32 scales
  ``[n_pages, Hkv]`` (``None``: ones); ``kv_head [Hq]`` names the in-page
  KV head of each q head and ``page_offset [Hq]`` shifts its page ids
  (``None``: plain GQA, offset 0), which lets one call serve every rank's
  head shard of a stacked ``[P·n_pages, ...]`` pool.  Scores are
  ``dot(k, q) · (k_scale · sm_scale)``; values are ``(p @ v) · v_scale``.

Worked example — 3 tokens spread over 2 non-contiguous pages of 2 slots::

    >>> import torch
    >>> q = torch.ones((1, 2, 4))                          # [B=1, Hq=2, d=4]
    >>> kp = torch.ones((2, 2, 1, 4))                      # [pages, slots, Hkv, d]
    >>> vp = torch.arange(16.).reshape(2, 2, 1, 4)
    >>> table = torch.tensor([[1, 0]], dtype=torch.int32)  # page 1 then page 0
    >>> out = paged_attention(q, kp, vp, table, torch.tensor([3], dtype=torch.int32))
    >>> tuple(out.shape)
    (1, 2, 4)
    >>> out[0, 0].tolist()                                 # uniform over 3 slots
    [6.666666507720947, 7.666666507720947, 8.666666984558105, 9.666666984558105]
"""

from __future__ import annotations

import ctypes

import torch

from . import empty_for_kernel, stream_of

NEG_INF = -1e30

#: Storage dtypes the kernel reads, with its storage code.
_STORAGE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
                 torch.float8_e4m3fn: 3}
_MAX_DV = 512  # the kernel keeps at most 4 output lanes per thread of 128


def _defaults(q, k_pages, k_scale, v_scale, kv_head, page_offset, sm_scale):
    """Fill the optional arguments exactly as the reference does."""
    B, Hq, d = q.shape
    n_pages, _, Hkv, _ = k_pages.shape
    dev = q.device
    if sm_scale is None:
        sm_scale = d**-0.5
    if k_scale is None:
        k_scale = torch.ones((n_pages, Hkv), dtype=torch.float32, device=dev)
    if v_scale is None:
        v_scale = torch.ones((n_pages, Hkv), dtype=torch.float32, device=dev)
    if kv_head is None:
        if Hq % Hkv:
            raise ValueError(f"Hq={Hq} not a multiple of Hkv={Hkv}")
        kv_head = (torch.arange(Hq, device=dev) // (Hq // Hkv)).to(torch.int32)
    if page_offset is None:
        page_offset = torch.zeros((Hq,), dtype=torch.int32, device=dev)
    return k_scale, v_scale, kv_head, page_offset, float(sm_scale)


def paged_attention_plain(q, k_pages, v_pages, table, lengths, k_scale=None,
                          v_scale=None, kv_head=None, page_offset=None,
                          sm_scale=None):
    """Vectorized paged attention in plain PyTorch: gather the
    ``[B, Hq, npm, ps]`` K/V blocks through the page table, mask, one
    softmax.  Works on any device; the wrapper sends it CPU tensors."""
    k_scale, v_scale, kv_head, page_offset, sm_scale = _defaults(
        q, k_pages, k_scale, v_scale, kv_head, page_offset, sm_scale)
    B, Hq, d = q.shape
    n_pages, ps, Hkv, dv = v_pages.shape
    npm = table.shape[1]
    pages = table.long()[:, None, :] + page_offset.long()[None, :, None]
    hsel = kv_head.long()[None, :, None].expand(B, Hq, npm)
    kh = k_pages[pages, :, hsel].float()  # [B, Hq, npm, ps, d]
    vh = v_pages[pages, :, hsel].float()  # [B, Hq, npm, ps, dv]
    ks = k_scale[pages, hsel]  # [B, Hq, npm]
    vs = v_scale[pages, hsel]
    s = torch.einsum("bhd,bhpsd->bhps", q.float(), kh)
    s = s * (ks * sm_scale)[..., None]  # [B, Hq, npm, ps]
    slot = (torch.arange(npm, device=q.device) * ps)[:, None] + \
        torch.arange(ps, device=q.device)[None, :]
    visible = slot[None, None] < lengths.long()[:, None, None, None]
    s = torch.where(visible, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=(-2, -1), keepdim=True)
    p = torch.where(visible, torch.exp(s - m), torch.zeros_like(s))
    pv = torch.einsum("bhps,bhpsd->bhpd", p, vh)
    pv = (pv * vs[..., None]).sum(dim=2)  # [B, Hq, dv]
    l = p.sum(dim=(-2, -1))[..., None]
    return (pv / torch.clamp_min(l, 1e-30)).to(q.dtype)


def _check_cuda(q, k_pages, v_pages, table, lengths, k_scale, v_scale,
                kv_head, page_offset):
    """Raise on anything the kernel does not take."""
    dev = q.device
    named = dict(q=q, k_pages=k_pages, v_pages=v_pages, table=table,
                 lengths=lengths, k_scale=k_scale, v_scale=v_scale,
                 kv_head=kv_head, page_offset=page_offset)
    for name, t in named.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    B, Hq, d = q.shape
    if q.dtype != torch.float32:
        raise TypeError(f"q must be float32, got {q.dtype}")
    if k_pages.dim() != 4 or v_pages.dim() != 4:
        raise ValueError("k_pages/v_pages must be [n_pages, ps, Hkv, d]")
    n_pages, ps, Hkv, dk = k_pages.shape
    dv = v_pages.shape[3]
    if dk != d or tuple(v_pages.shape[:3]) != (n_pages, ps, Hkv):
        raise ValueError(f"page shapes {tuple(k_pages.shape)} / "
                         f"{tuple(v_pages.shape)} do not match q {tuple(q.shape)}")
    if k_pages.dtype != v_pages.dtype or k_pages.dtype not in _STORAGE_CODE:
        raise TypeError(f"page dtype {k_pages.dtype}/{v_pages.dtype} not in "
                        f"{sorted(map(str, _STORAGE_CODE))}")
    if dv > _MAX_DV:
        raise ValueError(f"dv={dv} exceeds the kernel's {_MAX_DV}")
    for name, t, shape in (("table", table, (B, table.shape[-1])),
                           ("lengths", lengths, (B,)),
                           ("kv_head", kv_head, (Hq,)),
                           ("page_offset", page_offset, (Hq,))):
        if t.dtype != torch.int32 or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be int32 {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
        if t.dtype != torch.float32 or tuple(t.shape) != (n_pages, Hkv):
            raise ValueError(f"{name} must be float32 {(n_pages, Hkv)}")
    return B, Hq, d, dv, ps, Hkv, table.shape[1]


def _kernel():
    from . import _build

    lib = _build.load("paged_attention")
    fn = lib.paged_attention_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + \
            [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def paged_attention(q, k_pages, v_pages, table, lengths, k_scale=None,
                    v_scale=None, kv_head=None, page_offset=None,
                    sm_scale=None):
    """Decode attention off the paged pool → ``[B, Hq, dv]`` in ``q.dtype``
    (see the module docstring for the layout).  CPU tensors run the plain
    version; CUDA tensors launch the Hopper kernel."""
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pages, v_pages, table, lengths,
                                     k_scale, v_scale, kv_head, page_offset,
                                     sm_scale)
    k_scale, v_scale, kv_head, page_offset, sm_scale = _defaults(
        q, k_pages, k_scale, v_scale, kv_head, page_offset, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on cpu or cuda, not {q.device}")
    B, Hq, d, dv, ps, Hkv, npm = _check_cuda(
        q, k_pages, v_pages, table, lengths, k_scale, v_scale, kv_head,
        page_offset)
    fn = _kernel()
    out = empty_for_kernel((B, Hq, dv), torch.float32, q.device)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                 table.data_ptr(), lengths.data_ptr(), k_scale.data_ptr(),
                 v_scale.data_ptr(), kv_head.data_ptr(),
                 page_offset.data_ptr(), out.data_ptr(), B, Hq, d, dv, ps,
                 Hkv, npm, sm_scale, _STORAGE_CODE[k_pages.dtype],
                 stream_of(q))
    if err != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: "
                           f"cudaError_t {err}")
    paged_attention.launches += 1
    return out


#: Kernel launches since the process started (CUDA calls only); callers
#: that need a window set it to 0 first.
paged_attention.launches = 0

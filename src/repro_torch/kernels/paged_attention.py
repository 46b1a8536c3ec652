"""Paged decode attention straight off the rank-sharded page pool.

Port of the Pallas TPU kernel :mod:`repro.kernels.paged_attention`.  Three
pieces, one contract:

* :func:`paged_attention` — the wrapper.  A CUDA tensor goes to the
  hand-written Hopper kernels of ``csrc/paged_attention.cu`` (built by
  :mod:`repro_torch.kernels._build` on first use, launched on the current
  stream, each call counted once in ``paged_attention.launches``): a
  split kernel, whose blocks take ``split`` tokens of a row each (see
  :func:`plan`), and, where some row could hold more than one split, a
  merge kernel that combines a row's splits in order.  A CPU tensor goes
  to the plain version.  Nothing falls back: a CUDA call that the kernel
  does not take (widths not multiples of 4, d past 256, dv past 512,
  pages too large for shared memory, a pool whose base is off the
  kernel's copy size), or whose build or launch fails, raises.
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
_MAX_D, _MAX_DV = 256, 512
_MAX_SMEM = 232448  # a block's shared memory on Hopper
_WARPS = 8  # warps of a block, each with its own online softmax
#: The kernel's constants (``kSplitTokens``, ``kChunkBytes``, ``kMaxChunk``,
#: ``kStages`` in ``csrc/paged_attention.cu``): tokens of a split, K and V
#: bytes of a chunk of one head, tokens of a chunk at most, chunks in the
#: shared-memory ring.
SPLIT_TOKENS, CHUNK_BYTES, MAX_CHUNK, STAGES = 256, 32768, 128, 3


def plan(ps: int, d: int, dv: int, elem: int) -> tuple[int, int]:
    """``(chunk, split)`` in tokens for pages of ``ps`` slots, widths d and
    dv stored in ``elem`` bytes: a chunk is the whole pages of CHUNK_BYTES
    (at most MAX_CHUNK tokens, at least one page), a split the whole chunks
    of SPLIT_TOKENS (at least one).  The kernel's ``make_plan`` is the
    same; a row of ``n`` tokens has ``ceil(n / split)`` splits."""
    pages = CHUNK_BYTES // ((d + dv) * elem * ps)
    pages = max(1, min(pages, MAX_CHUNK // ps))
    chunk = pages * ps
    return chunk, max(1, SPLIT_TOKENS // chunk) * chunk


def _smem(chunk: int, split: int, ps: int, d: int, dv: int, elem: int,
          group: int) -> int:
    """The split kernel's shared memory (``smem_bytes``): the ring, which
    the warps' states reuse at the end, q, the split's page ids and
    scales."""
    ring = max(STAGES * chunk * (d + dv) * elem, _WARPS * group * (dv + 2) * 4)
    return -(-ring // 16) * 16 + 4 * group * d + 12 * (split // ps)


def copy_bytes(d: int, dv: int, elem: int) -> int:
    """Bytes of one of the kernel's asynchronous copies (``copy_bytes``):
    the largest of 16, 8, 4 that divides a K row and a V row."""
    rows = (d * elem) | (dv * elem)
    return 16 if rows % 16 == 0 else 8 if rows % 8 == 0 else 4


def _cols(group: int) -> int:
    """Output columns a lane holds for each head (``kCols``)."""
    return 16 if group <= 2 else 32 // group


def block_group(Hq: int, Hkv: int, dv: int, grouped: bool) -> int:
    """q heads a block serves: in plain GQA the largest of 8, 4, 2 that
    divides the group ``Hq / Hkv`` and whose outputs fit a warp's lanes
    (``dv <= 32 * _cols(g)``), else 1; with explicit head maps 1."""
    if not grouped:
        return 1
    return next(g for g in (8, 4, 2, 1)
                if (Hq // Hkv) % g == 0 and dv <= 32 * _cols(g))


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
    if d % 4 or dv % 4 or not 0 < d <= _MAX_D or not 0 < dv <= _MAX_DV:
        raise ValueError(f"the kernel takes widths that are multiples of 4, "
                         f"d <= {_MAX_D} and dv <= {_MAX_DV}; got d={d}, "
                         f"dv={dv}")
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
    unit = copy_bytes(d, dv, k_pages.element_size())
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        if t.data_ptr() % unit:
            raise ValueError(f"{name} must start on a {unit}-byte boundary "
                             f"(the kernel's copies); got {t.data_ptr():#x}")
    return B, Hq, d, dv, ps, Hkv, table.shape[1]


def _lib():
    from . import _build

    lib = _build.load("paged_attention")
    if lib.paged_attention_launch.argtypes is None:
        i, p = ctypes.c_int, ctypes.c_void_p
        lib.paged_attention_launch.argtypes = [p] * 13 + [i] * 10 + \
            [ctypes.c_float, i, p]
        lib.paged_attention_launch.restype = i
        lib.paged_attention_plan.argtypes = [i] * 5 + [p]
        lib.paged_attention_plan.restype = i
    return lib


def kernel_plan(ps: int, d: int, dv: int, dtype: torch.dtype,
                group: int = 1) -> tuple[int, int, int]:
    """``(chunk, split, shared-memory bytes)`` as the built library plans
    them (needs the library, not a card); :func:`plan` must agree."""
    out = (ctypes.c_int * 3)()
    err = _lib().paged_attention_plan(ps, d, dv, _STORAGE_CODE[dtype], group,
                                      out)
    if err != 0:
        raise ValueError(f"paged_attention_plan refused {(ps, d, dv, dtype)}")
    return tuple(out)


def paged_attention(q, k_pages, v_pages, table, lengths, k_scale=None,
                    v_scale=None, kv_head=None, page_offset=None,
                    sm_scale=None):
    """Decode attention off the paged pool → ``[B, Hq, dv]`` in ``q.dtype``
    (see the module docstring for the layout).  CPU tensors run the plain
    version; CUDA tensors launch the Hopper kernels (one count a call)."""
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pages, v_pages, table, lengths,
                                     k_scale, v_scale, kv_head, page_offset,
                                     sm_scale)
    grouped = kv_head is None and page_offset is None
    k_scale, v_scale, kv_head, page_offset, sm_scale = _defaults(
        q, k_pages, k_scale, v_scale, kv_head, page_offset, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on cpu or cuda, not {q.device}")
    B, Hq, d, dv, ps, Hkv, npm = _check_cuda(
        q, k_pages, v_pages, table, lengths, k_scale, v_scale, kv_head,
        page_offset)
    group = block_group(Hq, Hkv, dv, grouped)
    elem = k_pages.element_size()
    chunk, split = plan(ps, d, dv, elem)
    if chunk > MAX_CHUNK or _smem(chunk, split, ps, d, dv, elem, group) > \
            _MAX_SMEM:
        raise ValueError(f"pages of {ps} slots at d={d}, dv={dv} do not fit "
                         f"the kernel's chunks (at most {MAX_CHUNK} tokens) "
                         f"or shared memory")
    n_splits = max(1, -(-npm * ps // split))
    out = empty_for_kernel((B, Hq, dv), torch.float32, q.device)
    parts = [None] * 3  # (m, l, acc) of each split, where a row may have two
    if n_splits > 1:
        parts = [empty_for_kernel(shape, torch.float32, q.device) for shape in
                 ((B, Hq, n_splits), (B, Hq, n_splits),
                  (B, Hq, n_splits, dv))]
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(q.device):
        err = _lib().paged_attention_launch(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            table.data_ptr(), lengths.data_ptr(), k_scale.data_ptr(),
            v_scale.data_ptr(), kv_head.data_ptr(), page_offset.data_ptr(),
            out.data_ptr(), *map(ptr, parts), B, Hq, d, dv, ps, Hkv, npm,
            group, n_splits, split, sm_scale, _STORAGE_CODE[k_pages.dtype],
            stream_of(q))
    if err != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: "
                           f"cudaError_t {err}")
    paged_attention.launches += 1
    return out


#: Kernel launches since the process started (CUDA calls only); callers
#: that need a window set it to 0 first.
paged_attention.launches = 0

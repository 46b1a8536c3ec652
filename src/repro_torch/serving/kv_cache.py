"""Rank-sharded paged KV cache for the tensor-parallel serving engine.

Port of :mod:`repro.serving.kv_cache`: the pools are tensors on the cache's
device, while the page bookkeeping (free list, page tables, lengths) stays
on the host.

* the **page pool** is a fixed tensor ``[layers, P, n_pages, page_size,
  heads_local, head_dim]`` — the leading ``P`` axis is the stacked-rank
  convention of the software transports, and ``heads_local = heads / P`` is
  the **tensor-parallel shard**: each rank stores the KV pages of its own
  attention heads only (page *tables* are replicated across ranks);
* a sequence **reserves its worst-case page budget at admission**
  (``prompt + max_new`` tokens, rounded up to whole pages).  Admission is
  the only operation that can fail with :class:`OutOfPages`, so a running
  decode step never preempts;
* :meth:`PagedKVCache.manifest_entry` exports the page accounting of one
  sequence — together with the engine's token log this forms the
  **KV-page manifest** the elastic runtime replays from after a rank dies
  mid-decode;
* pages can be stored **quantized** (``kv_dtype='int8'``, plus a ``'fp8'``
  scaffold and a ``'bf16'`` half-memory tier): int8 pages carry one
  per-(page, head) max-abs f32 scale in :attr:`PagedKVCache.k_scale` /
  :attr:`~PagedKVCache.v_scale`, set **once** by the page-opening token
  (later tokens clip to that grid).  The write-once policy keeps a
  quantized decode replayable: an incremental decode and a batched
  manifest re-prefill quantize every token against the *same* scale.

The tiers map to ``torch.float32``/``bfloat16``/``int8``/``float8_e4m3fn``.
Casts round to nearest even and give the reference's bytes for every
input: :func:`to_e4m3` maps values beyond ±464 (and ±inf) to e4m3 NaN, as
``ml_dtypes`` does, where PyTorch's own cast saturates to ±448.

Example — two sequences through one pool::

    >>> kv = PagedKVCache(layers=1, n_pages=4, page_size=8, heads_local=2,
    ...                   head_dim=4, world=1, device="cpu")
    >>> kv.alloc(7, capacity=12)        # 12 tokens -> 2 pages
    (0, 1)
    >>> kv.alloc(9, capacity=8)
    (2,)
    >>> kv.free_pages, kv.pages_in_use
    (1, 3)
    >>> k = torch.ones((3, 1, 2, 4))               # [T=3, P, Hl, hd]
    >>> kv.write_rows(0, [0, 0, 0], [0, 1, 2], k, k)   # prefill 3 tokens
    >>> kv.advance(7, 3), kv.capacity(7)
    (3, 12)
    >>> tuple(kv.gather(7, pad=True)[0].shape)  # padded to the reservation
    (1, 1, 16, 2, 4)
    >>> kv.table(7, width=3)            # page-table row (padded with id 0)
    array([0, 1, 0], dtype=int32)
    >>> kv.free(7)
    2
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from ..analysis.sanitizer import get_active as _sanitizer
from ..devices import resolve_device, to_device, true_div

#: Bytes per stored element of each tier a pool can hold.
KV_ITEMSIZE = {"f32": 4, "bf16": 2, "int8": 1, "fp8": 1}

_STORAGE = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8,
            "fp8": torch.float8_e4m3fn}


def kv_storage_dtype(kv_dtype: str) -> torch.dtype:
    """The torch dtype backing one ``kv_dtype`` tier."""
    try:
        return _STORAGE[kv_dtype]
    except KeyError:
        raise ValueError(f"unknown kv_dtype {kv_dtype!r} "
                         f"(expected one of {sorted(KV_ITEMSIZE)})") from None


def _absmax_scale(x: torch.Tensor) -> torch.Tensor:
    """Per-(…, head) int8 scale over the trailing head_dim axis: max-abs
    over the vector, mapped to the int8 grid (zero vectors get scale 1.0 so
    they stay exact zeros).  The one definition every write path uses."""
    amax = x.float().abs().amax(dim=-1)
    return torch.where(amax > 0, true_div(amax, 127), torch.ones_like(amax))


def to_e4m3(x: torch.Tensor) -> torch.Tensor:
    """Cast to ``float8_e4m3fn`` as ``ml_dtypes`` does: round to nearest
    even, and NaN (with the input's sign) for ``|x| > 464`` and ±inf, the
    values that round past the format's ±448; PyTorch's cast saturates
    those instead.

    >>> to_e4m3(torch.tensor([448.0, 464.0, 465.0, -1e4])).view(torch.uint8).tolist()
    [126, 126, 127, 255]
    """
    xf = x.float()
    nan = torch.copysign(torch.full_like(xf, float("nan")), xf)
    return torch.where(xf.abs() > 464.0, nan, xf).to(torch.float8_e4m3fn)


def _cast(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return to_e4m3(x) if dtype == torch.float8_e4m3fn else x.to(dtype)


def _quant_i8(x: torch.Tensor, scale) -> torch.Tensor:
    """Snap values to an already-fixed int8 grid: divide by the scale,
    round half to even, clip."""
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


class OutOfPages(RuntimeError):
    """Admission failed: the page pool cannot cover the sequence's
    worst-case (prompt + max_new) reservation."""


def pages_needed(tokens: int, page_size: int) -> int:
    """Pages covering ``tokens`` (at least one) — the single definition of
    the rounding policy behind every reservation.

    >>> pages_needed(17, 8)
    3
    """
    return max(1, -(-int(tokens) // int(page_size)))


@dataclass
class _Seq:
    pages: tuple[int, ...]
    capacity: int  # reserved tokens (pages * page_size covers this)
    length: int = 0  # tokens actually written


@dataclass
class KVPageManifest:
    """What survives a rank failure: enough to rebuild every live sequence.

    ``seqs`` maps sequence id to ``{"tokens", "n_prompt", "max_new",
    "pages", "length"}`` — the full token history (prompt + generated so
    far) plus the page accounting at failure time.  The pages themselves
    are *not* carried; the elastic heal re-prefills ``tokens`` into a
    fresh :class:`PagedKVCache` at the regrouped world size."""

    world: int
    generation: int
    seqs: dict[int, dict[str, Any]] = field(default_factory=dict)

    @property
    def live(self) -> tuple[int, ...]:
        return tuple(sorted(self.seqs))


class PagedKVCache:
    """Paged, rank-sharded KV storage on ``device`` (see module docstring).

    ``world`` is the stacked-rank axis of the pools; ``heads_local`` the
    per-rank head shard.
    """

    def __init__(self, layers: int, n_pages: int, page_size: int,
                 heads_local: int, head_dim: int, world: int,
                 kv_dtype: str = "f32", device: str | None = None):
        if n_pages <= 0 or page_size <= 0:
            raise ValueError("n_pages and page_size must be positive")
        self.layers = int(layers)
        self.n_pages = int(n_pages)
        self.page_size = int(page_size)
        self.heads_local = int(heads_local)
        self.head_dim = int(head_dim)
        self.world = int(world)
        self.kv_dtype = str(kv_dtype)
        storage = kv_storage_dtype(self.kv_dtype)
        self.device = resolve_device(device)
        shape = (self.layers, self.world, self.n_pages, self.page_size,
                 self.heads_local, self.head_dim)
        self.k_pool = torch.zeros(shape, dtype=storage, device=self.device)
        self.v_pool = torch.zeros(shape, dtype=storage, device=self.device)
        # per-(layer, rank, page, head) dequant scales — unit for the
        # unquantized tiers so every consumer can multiply unconditionally
        sshape = (self.layers, self.world, self.n_pages, self.heads_local)
        self.k_scale = torch.ones(sshape, dtype=torch.float32,
                                  device=self.device)
        self.v_scale = torch.ones(sshape, dtype=torch.float32,
                                  device=self.device)
        self._free: list[int] = list(range(self.n_pages))
        self._seqs: dict[int, _Seq] = {}
        # accounting the admit/evict invariant tests pin down
        self.allocs = 0
        self.frees = 0
        self.peak_in_use = 0

    @property
    def quantized(self) -> bool:
        """True for the integer-grid tiers (int8/fp8)."""
        return self.kv_dtype in ("int8", "fp8")

    @property
    def itemsize(self) -> int:
        """Bytes per stored K/V element."""
        return KV_ITEMSIZE[self.kv_dtype]

    @property
    def page_nbytes(self) -> int:
        """Per-rank bytes of one page's K+V storage (plus its scale rows
        when quantized)."""
        data = 2 * self.page_size * self.heads_local * self.head_dim * \
            self.itemsize
        scales = 2 * self.heads_local * 4 if self.quantized else 0
        return data + scales

    # -- allocation ---------------------------------------------------------
    def pages_for(self, tokens: int) -> int:
        """Pages covering ``tokens`` (at least one)."""
        return pages_needed(tokens, self.page_size)

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return self.n_pages - len(self._free)

    @property
    def live_seqs(self) -> tuple[int, ...]:
        return tuple(sorted(self._seqs))

    def alloc(self, seq_id: int, capacity: int) -> tuple[int, ...]:
        """Reserve pages for ``capacity`` tokens.  Raises :class:`OutOfPages`
        when the pool cannot cover the reservation (the admission gate)."""
        if seq_id in self._seqs:
            raise ValueError(f"seq {seq_id} already allocated")
        need = self.pages_for(capacity)
        if need > len(self._free):
            raise OutOfPages(
                f"seq {seq_id} needs {need} page(s), {len(self._free)} free "
                f"(pool of {self.n_pages})"
            )
        pages = tuple(self._free[:need])
        del self._free[:need]
        self._seqs[seq_id] = _Seq(pages=pages, capacity=int(capacity))
        self.allocs += 1
        self.peak_in_use = max(self.peak_in_use, self.pages_in_use)
        s = _sanitizer()
        if s is not None:
            s.on_kv_alloc(self, seq_id, pages)
        return pages

    def free(self, seq_id: int) -> int:
        """Evict: return the sequence's pages to the pool (zeroed so a later
        reuse never sees stale keys).  Returns the number of pages freed."""
        seq = self._seqs.pop(seq_id)
        idx = self._index(seq.pages)
        self.k_pool[:, :, idx] = 0
        self.v_pool[:, :, idx] = 0
        self.k_scale[:, :, idx] = 1.0
        self.v_scale[:, :, idx] = 1.0
        self._free.extend(seq.pages)
        self.frees += 1
        s = _sanitizer()
        if s is not None:
            s.on_kv_free(self, seq_id, len(seq.pages))
        return len(seq.pages)

    # -- data path ----------------------------------------------------------
    def _index(self, ids) -> torch.Tensor:
        """Host page ids / offsets as an index tensor on the pool's device."""
        return to_device(np.asarray(ids, np.int64), self.device)

    def write_rows(self, layer: int, pages, offs, k: torch.Tensor,
                   v: torch.Tensor) -> None:
        """Write ``n`` tokens' K/V for one layer, every head at once — the
        TP forward's entry point (the reference writes per (rank, head) with
        ``write_kv``; the bits are the same).  ``k``/``v`` are
        ``[n, P, Hl, hd]`` and token ``i`` lands at ``(pages[i], offs[i])``
        (host integers; the ``n`` slots must be distinct).  Storage policy:
        f32 exact; bf16/fp8 round-to-nearest casts (unit scales); int8:
        every page-opening token (offset 0) fixes its page's per-head
        scales first, then every token snaps to its page's grid, so an
        incremental decode and a batched replay store the same bytes."""
        pages = np.asarray(pages, np.int64)
        offs = np.asarray(offs, np.int64)
        pg, of = self._index(pages), self._index(offs)
        kp, vp = self.k_pool[layer], self.v_pool[layer]  # [P, np, ps, Hl, hd]
        if self.kv_dtype == "int8":
            ks, vs = self.k_scale[layer], self.v_scale[layer]  # [P, np, Hl]
            opening = np.flatnonzero(offs == 0)
            if opening.size:
                o = self._index(opening)
                po = self._index(pages[opening])
                ks[:, po] = _absmax_scale(k[o]).transpose(0, 1)
                vs[:, po] = _absmax_scale(v[o]).transpose(0, 1)
            kq = _quant_i8(k, ks[:, pg].transpose(0, 1)[..., None])
            vq = _quant_i8(v, vs[:, pg].transpose(0, 1)[..., None])
            kp[:, pg, of] = kq.transpose(0, 1)
            vp[:, pg, of] = vq.transpose(0, 1)
        else:
            kp[:, pg, of] = _cast(k.transpose(0, 1), kp.dtype)
            vp[:, pg, of] = _cast(v.transpose(0, 1), vp.dtype)

    def gather(self, seq_id: int, layer: int | None = None,
               pad: bool = False):
        """The sequence's K and V off the page table.

        ``pad=False`` (default): **zero-copy views** — a pair of tuples,
        one raw-storage-dtype view per page (``[P, page_size, Hl, hd]`` for
        one ``layer``, ``[L, P, ...]`` for all).

        ``pad=True``: contiguous **dequantized f32** tensors
        ``[P, pages*page_size, Hl, hd]`` (or ``[L, P, ...]``), padded to the
        full page reservation.  Positions beyond :meth:`length` are exact
        zeros — the attention mask (not the gather) excludes them, and the
        fixed page-aligned padding keeps the reduction shape identical
        between an incremental decode and a manifest replay.
        """
        seq = self._seqs[seq_id]
        if not pad:
            if layer is None:
                return (tuple(self.k_pool[:, :, p] for p in seq.pages),
                        tuple(self.v_pool[:, :, p] for p in seq.pages))
            return (tuple(self.k_pool[layer][:, p] for p in seq.pages),
                    tuple(self.v_pool[layer][:, p] for p in seq.pages))
        idx = self._index(seq.pages)
        n = len(seq.pages) * self.page_size

        def dequant(pool, scale):
            if layer is None:  # [L, P, np, ps, Hl, hd] * [L, P, np, 1, Hl, 1]
                out = pool[:, :, idx].float() * scale[:, :, idx][:, :, :, None,
                                                                 :, None]
                return out.reshape(self.layers, self.world, n,
                                   self.heads_local, self.head_dim)
            out = pool[layer][:, idx].float() * scale[layer][:, idx][:, :, None,
                                                                     :, None]
            return out.reshape(self.world, n, self.heads_local, self.head_dim)

        return (dequant(self.k_pool, self.k_scale),
                dequant(self.v_pool, self.v_scale))

    def table(self, seq_id: int, width: int | None = None) -> np.ndarray:
        """The sequence's page-id row ``[width] i32`` (host) for the
        paged-attention kernel, padded with page id 0 (pad columns lie past
        the row's length and are never read)."""
        pages = self._seqs[seq_id].pages
        width = len(pages) if width is None else int(width)
        if width < len(pages):
            raise ValueError(f"width {width} < {len(pages)} pages")
        out = np.zeros(width, np.int32)
        out[:len(pages)] = pages
        return out

    def slot(self, seq_id: int, position: int) -> tuple[int, int]:
        """``(page, offset)`` of an absolute token ``position`` within the
        sequence's reservation (the TP forward writes K/V through this)."""
        seq = self._seqs[seq_id]
        if not 0 <= position < len(seq.pages) * self.page_size:
            raise IndexError(
                f"position {position} outside seq {seq_id}'s reservation"
            )
        return seq.pages[position // self.page_size], position % self.page_size

    def advance(self, seq_id: int, n: int = 1) -> int:
        """Commit ``n`` newly written tokens (the engine calls this after a
        forward pass wrote their K/V at the absolute slots).  Returns the
        new length."""
        seq = self._seqs[seq_id]
        if seq.length + n > seq.capacity:
            raise ValueError(
                f"seq {seq_id}: advance past capacity {seq.capacity}"
            )
        seq.length += n
        return seq.length

    def length(self, seq_id: int) -> int:
        return self._seqs[seq_id].length

    def capacity(self, seq_id: int) -> int:
        return self._seqs[seq_id].capacity

    def padded_len(self, seq_id: int) -> int:
        return len(self._seqs[seq_id].pages) * self.page_size

    def manifest_entry(self, seq_id: int) -> dict[str, Any]:
        """Page accounting of one sequence for the KV-page manifest."""
        seq = self._seqs[seq_id]
        return {"pages": seq.pages, "length": seq.length,
                "capacity": seq.capacity}

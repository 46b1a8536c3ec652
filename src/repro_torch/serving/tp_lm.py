"""Tensor-parallel decoder LM over the FMI software channel, on PyTorch.

Port of :mod:`repro.serving.tp_lm`.  A small transformer (MHA, learned
positions, ReLU MLP, RMS norm) whose tensor-parallel collectives are issued
*explicitly* through :mod:`repro_torch.core.requests` on a stacked
:class:`~repro_torch.core.transport.SimTransport`:

* **attention** is head-sharded: rank ``r`` owns heads ``[r·H/P,
  (r+1)·H/P)`` and stores only their KV pages; the output projection is
  row-parallel, so every rank contributes a partial ``[B, T, D]`` that an
  **allreduce of TP partials** combines;
* the **MLP** is column-parallel up and row-parallel down over a fixed
  ``ff_chunks`` grid (second partial allreduce per layer);
* the **logits head** is vocab-sharded: each rank emits ``[B, V/P]`` and an
  **allgather of logits shards** rebuilds the full distribution (or, under
  ``logits_mode='local-argmax'``, each rank ships only its shard's
  ``(max, argmax)`` pair).

Activations, weights, KV pools and logits live on the model's device as
torch tensors.  Indices — ranks, slots, page tables, lengths — stay host
``numpy``/Python integers, so no step reads the device back to compute one.

Weights are **fused**: one tensor per weight (``wq [D, H·hd]``, ``wo [H, hd,
D]``, ``w_down [C, F/C, D]``, ...), and a head or chunk is a view, never a
copy.

Determinism contract
--------------------
The reference pins summation order twice over; the port keeps both pins
while batching its contractions:

1. **Fixed-shape operands.**  Every row-wise contraction, normalization and
   reduction runs on tiles of exactly :data:`ROW_TILE` rows (the last tile
   zero-padded), and the attention of one sequence runs on its fixed page
   reservation.  Operand shapes therefore depend only on the model config
   and the sequence's reservation — never on the world size, the batch
   composition or the prompt length — so a decode row, a prefill row and a
   replayed row of the same token go through the same kernels on the same
   shapes.
2. **Fixed reduction trees.**  Row-parallel partials are combined as a
   balanced pairwise tree over the fixed chunk grid (heads for attention,
   ``ff_chunks`` for the MLP): :func:`tree_sum` folds each rank's
   contiguous chunks as ``x[0::2] + x[1::2]``, and ``recursive_doubling``
   folds the rank partials — the same global tree at every power-of-two
   ``P``.

Hence ``P = 1`` and any pow2 ``P | heads`` produce bit-identical logits.
Against the reference (per-vector numpy gemv) the port agrees to f32
roundoff, not bitwise: the summation order inside a dot product differs.

Example — the same prefill at world 1 and 2 is bit-exact::

    >>> from repro_torch.core.communicator import Communicator
    >>> cfg = TPServeConfig(vocab_size=64, d_model=16, n_heads=4, head_dim=4,
    ...                     d_ff=32, n_layers=1, max_len=8, ff_chunks=4)
    >>> weights = init_params(cfg, seed=0, device="cpu")
    >>> toks = np.array([[5, 9, 2]])
    >>> outs = {}
    >>> for P in (1, 2):
    ...     comm = Communicator(axes=("data",), sizes=(P,), channel="sim",
    ...                         device="cpu")
    ...     outs[P] = prefill_logits(weights, cfg, comm, toks)
    >>> bool(torch.equal(outs[1][0], outs[2][0]))
    True
"""

from __future__ import annotations

import time as _time
from dataclasses import dataclass

import numpy as np
import torch

from ..core.communicator import Communicator
from ..core.requests import Request
from ..devices import resolve_device, to_device
from .kv_cache import to_e4m3

#: Rows per contraction tile (see the determinism contract).
ROW_TILE = 16


@dataclass(frozen=True)
class TPServeConfig:
    """Shape of the TP serving model.  ``n_heads``, ``ff_chunks`` and
    ``vocab_size`` must be divisible by every world size served;
    ``ff_chunks`` is the *fixed* partial-sum granularity of the
    row-parallel MLP and of the vocab-sharded head."""

    vocab_size: int = 256
    d_model: int = 32
    n_heads: int = 4
    head_dim: int = 8
    d_ff: int = 64
    n_layers: int = 2
    max_len: int = 64
    ff_chunks: int = 4

    def validate_world(self, P: int) -> None:
        if P < 1 or P & (P - 1):
            raise ValueError(f"world {P} must be a power of two")
        for dim, name in ((self.n_heads, "n_heads"),
                          (self.ff_chunks, "ff_chunks"),
                          (self.vocab_size, "vocab_size")):
            if dim % P:
                raise ValueError(f"world {P} does not divide {name}={dim}")
        if self.d_ff % self.ff_chunks or self.vocab_size % self.ff_chunks:
            raise ValueError("ff_chunks must divide d_ff and vocab_size")

    @property
    def flops_per_token(self) -> float:
        """2·params matmul FLOPs per token (serve_plan's compute term)."""
        D, H, hd, F = self.d_model, self.n_heads, self.head_dim, self.d_ff
        per_layer = 4 * D * H * hd + 2 * D * F  # qkv+wo, up+down
        return 2.0 * (self.n_layers * per_layer + D * self.vocab_size)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def _fuse(cfg: TPServeConfig, embed, pos, head, layers) -> dict:
    """Lay out one set of logical weights in the port's fused form."""
    D, H, hd, F, C = (cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff,
                      cfg.ff_chunks)
    return {
        "embed": embed, "pos": pos, "head": head,
        "layers": [{
            "wq": l["wq"].reshape(D, H * hd), "wk": l["wk"].reshape(D, H * hd),
            "wv": l["wv"].reshape(D, H * hd), "wo": l["wo"],  # [H, hd, D]
            "w_up": l["w_up"],  # [D, F]
            "w_down": l["w_down"].reshape(C, F // C, D),
        } for l in layers],
    }


def init_params(cfg: TPServeConfig, seed: int = 0, device=None) -> dict:
    """Random weights drawn on ``device`` from a seeded ``torch.Generator``
    (N(0, 1)·0.08, the reference's scale).  The draws differ from the
    reference's numpy ones; for parity use :func:`weights_from_reference`."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    D, H, hd, F, V = (cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff,
                      cfg.vocab_size)

    def w(*shape):
        x = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
        return x.mul_(0.08)

    layers = [{"wq": w(D, H, hd), "wk": w(D, H, hd), "wv": w(D, H, hd),
               "wo": w(H, hd, D), "w_up": w(D, F), "w_down": w(F, D)}
              for _ in range(cfg.n_layers)]
    return _fuse(cfg, w(V, D), w(cfg.max_len, D), w(D, V), layers)


def weights_from_reference(logical: dict, cfg: TPServeConfig,
                           device=None) -> dict:
    """The port's weights from the reference's ``tp_lm.init_params`` dict
    (numpy float32 arrays), as device tensors — both packages then compute
    the same model."""
    dev = resolve_device(device)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32),
                               device=dev)

    layers = [{k: t(l[k]) for k in ("wq", "wk", "wv", "wo", "w_up",
                                     "w_down")}
              for l in logical["layers"]]
    return _fuse(cfg, t(logical["embed"]), t(logical["pos"]),
                 t(logical["head"]), layers)


# ---------------------------------------------------------------------------
# Deterministic numerics helpers
# ---------------------------------------------------------------------------


def tree_sum(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Balanced pairwise sum over a power-of-two axis ``dim`` — repeated
    ``x[0::2] + x[1::2]``, the reduction tree of ``recursive_doubling``
    allreduce, so local-chunk folding composes with the cross-rank fold into
    one fixed global tree.

    >>> xs = torch.tensor([0.1, 0.2, 0.3, 0.4])
    >>> bool(tree_sum(xs) == (xs[0] + xs[1]) + (xs[2] + xs[3]))
    True
    """
    x = x.movedim(dim, 0)
    while x.shape[0] > 1:
        x = x[0::2] + x[1::2]
    return x[0]


def _tiled(fn, *rows: torch.Tensor, dim: int = 0):
    """Apply ``fn`` to tiles of exactly :data:`ROW_TILE` rows of the row
    tensors (the last tile zero-padded) and concatenate its outputs along
    their row axis ``dim``, cut back to the real rows."""
    n = rows[0].shape[0]
    pad = (-n) % ROW_TILE
    if pad:
        rows = tuple(torch.cat([r, r.new_zeros((pad,) + tuple(r.shape[1:]))])
                     for r in rows)
    outs = [fn(*(r[i:i + ROW_TILE] for r in rows))
            for i in range(0, n + pad, ROW_TILE)]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(o, dim=dim).narrow(dim, 0, n)
                     for o in zip(*outs))
    return torch.cat(outs, dim=dim).narrow(dim, 0, n)


def _norm(x: torch.Tensor) -> torch.Tensor:
    """RMS-normalize rows ``[n, D]`` (a fixed-shape reduction per tile)."""
    ms = (x * x).sum(dim=-1, keepdim=True) / x.shape[-1]
    return x / torch.sqrt(ms + 1e-6)


# ---------------------------------------------------------------------------
# The TP forward pass (shared by prefill and decode)
# ---------------------------------------------------------------------------


def _attend_gather(kv, layer: int, q: torch.Tensor, seq_ids,
                   positions: np.ndarray) -> torch.Tensor:
    """Attention of every (token, head) of ``q [B, T, H, hd]`` over each
    sequence's K/V gathered and padded to its page reservation.  Masked
    slots score ``-inf`` (``exp`` → exact ``+0.0``); the reservation length
    ``Tc`` is fixed per sequence, so every execution reduces over the same
    shape."""
    B, T, H, hd = q.shape
    out = torch.empty_like(q)
    scale = 1.0 / float(np.sqrt(hd))
    for b in range(B):
        gk, gv = kv.gather(seq_ids[b], layer=layer, pad=True)  # [P, Tc, Hl, hd]
        Tc = gk.shape[1]
        kh = gk.permute(0, 2, 1, 3).reshape(H, Tc, hd)  # head h = (h//Hl, h%Hl)
        vh = gv.permute(0, 2, 1, 3).reshape(H, Tc, hd)
        slots = torch.arange(Tc, device=q.device)
        pos = to_device(np.asarray(positions[b], np.int64), q.device)

        def attend(qt, pt):  # qt [tile, H, hd], pt [tile]
            s = torch.bmm(qt.transpose(0, 1), kh.transpose(1, 2)) * scale
            visible = slots[None, None, :] <= pt[None, :, None]
            s = torch.where(visible, s, torch.full_like(s, -torch.inf))
            w = torch.exp(s - s.amax(dim=-1, keepdim=True))
            w = w / w.sum(dim=-1, keepdim=True)
            return torch.bmm(w, vh).transpose(0, 1)  # [tile, H, hd]

        out[b] = _tiled(attend, q[b], pos)
    return out


def _attend_kernel(kv, layer: int, q: torch.Tensor, seq_ids,
                   positions: np.ndarray) -> torch.Tensor:
    """Every (token, head) attention output of one layer in **one**
    paged-attention call straight off the stacked page pool.

    The pool reshape ``[P, n_pages, ...] -> [P·n_pages, ...]`` is a view,
    and head ``h`` carries ``page_offset = (h // Hl)·n_pages`` with in-page
    head ``h % Hl`` — so each global head reads exactly its owning rank's
    pool region and the single call is bitwise identical to ``P`` per-rank
    calls.  Tables and lengths are built on the host."""
    from ..kernels import ops

    B, T, H, hd = q.shape
    P, Hl, ps = kv.world, kv.heads_local, kv.page_size
    n = B * T
    npm = max(kv.padded_len(s) // ps for s in seq_ids)
    tables = np.zeros((n, npm), np.int32)
    lengths = np.zeros(n, np.int32)
    for b in range(B):
        row_tbl = kv.table(seq_ids[b], width=npm)
        for j in range(T):
            tables[b * T + j] = row_tbl
            lengths[b * T + j] = int(positions[b, j]) + 1
    dev = q.device
    heads = np.arange(H, dtype=np.int32)

    def i32(a):
        return to_device(np.asarray(a, np.int32), dev)

    def stack(pool):
        return pool[layer].reshape(P * kv.n_pages, ps, Hl, kv.head_dim)

    out = ops.paged_attention(
        q.reshape(n, H, hd).contiguous(), stack(kv.k_pool), stack(kv.v_pool),
        i32(tables), i32(lengths),
        k_scale=kv.k_scale[layer].reshape(P * kv.n_pages, Hl),
        v_scale=kv.v_scale[layer].reshape(P * kv.n_pages, Hl),
        kv_head=i32(heads % Hl), page_offset=i32((heads // Hl) * kv.n_pages),
    )
    return out.reshape(B, T, H, hd)


def forward_tokens(weights, cfg: TPServeConfig, comm: Communicator, kv,
                   seq_ids, tokens: np.ndarray, positions: np.ndarray,
                   queue=None, comm_log: list | None = None,
                   attn_backend: str = "gather") -> torch.Tensor:
    """Run ``tokens [B, T]`` (T=1 for decode, T=prompt length for prefill)
    through the TP stack, writing each position's K/V into the paged cache
    at its absolute slot, and return the **local logits shard**
    ``[P, B, V/P]`` of the last position (a tensor on the cache's device).

    ``attn_backend`` selects how decode attention reads the cache:
    ``"gather"`` copies each sequence's pages into a padded buffer;
    ``"kernel"`` runs :func:`repro_torch.kernels.ops.paged_attention` in
    place over the page pool — the CUDA kernel on the card.  Prefill
    (``T > 1``) always takes the gather path, as in the reference.
    """
    P = comm.size
    cfg.validate_world(P)
    if attn_backend not in ("gather", "kernel"):
        raise ValueError(f"unknown attn_backend {attn_backend!r}")
    tokens = np.asarray(tokens)
    positions = np.asarray(positions)
    B, T = tokens.shape
    H, hd, D = cfg.n_heads, cfg.head_dim, cfg.d_model
    Hl = H // P
    cpr = cfg.ff_chunks // P  # MLP / vocab chunks per rank
    dev = weights["embed"].device
    n = B * T

    def waited(stacked_partial):
        req = comm.iallreduce(stacked_partial, algorithm="recursive_doubling")
        if queue is not None:
            queue.push(req)
        t0 = _time.perf_counter()
        out = req.wait()
        if comm_log is not None:
            comm_log.append((req.op, req.nbytes,
                             _time.perf_counter() - t0))
        return out[0]  # rank slices are bit-identical (commutative tree)

    def as_partial(rows_by_rank):  # [P, n, D] -> stacked [P, B, T, D]
        return rows_by_rank.reshape(P, B, T, D)

    tok = to_device(tokens.reshape(-1).astype(np.int64), dev)
    pos = to_device(positions.reshape(-1).astype(np.int64), dev)
    x = weights["embed"][tok] + weights["pos"][pos]  # [n, D]
    slots = [kv.slot(seq_ids[b], int(positions[b, j]))
             for b in range(B) for j in range(T)]
    pages = np.array([p for p, _ in slots], np.int64)
    offs = np.array([o for _, o in slots], np.int64)

    for li, lw in enumerate(weights["layers"]):
        # -- qkv projections + cache write --------------------------------
        def qkv(xt):
            h = _norm(xt)
            return h @ lw["wq"], h @ lw["wk"], h @ lw["wv"]

        q, k, v = _tiled(qkv, x)  # [n, H*hd] each
        kv.write_rows(li, pages, offs, k.reshape(n, P, Hl, hd),
                      v.reshape(n, P, Hl, hd))
        q = q.reshape(B, T, H, hd)
        # -- attention + row-parallel output projection --------------------
        if attn_backend == "kernel" and T == 1:
            att = _attend_kernel(kv, li, q, seq_ids, positions)
        else:
            att = _attend_gather(kv, li, q, seq_ids, positions)

        def out_proj(at):  # [tile, H, hd] -> [P, tile, D]
            outs = torch.bmm(at.transpose(0, 1), lw["wo"])  # [H, tile, D]
            return tree_sum(outs.reshape(P, Hl, -1, D), dim=1)

        x = x + waited(as_partial(_tiled(out_proj, att.reshape(n, H, hd),
                                         dim=1))).reshape(n, D)

        # -- MLP: column-parallel up, row-parallel down over ff_chunks -----
        def mlp(xt):  # [tile, D] -> [P, tile, D]
            up = torch.relu(_norm(xt) @ lw["w_up"])  # [tile, F]
            C = cfg.ff_chunks
            downs = torch.bmm(up.reshape(-1, C, cfg.d_ff // C).transpose(0, 1),
                              lw["w_down"])  # [C, tile, D]
            return tree_sum(downs.reshape(P, cpr, -1, D), dim=1)

        x = x + waited(as_partial(_tiled(mlp, x, dim=1))).reshape(n, D)

    # -- vocab-sharded logits head (column-parallel: no reduction) ---------
    last = x.reshape(B, T, D)[:, -1]

    def head(xt):
        return _norm(xt) @ weights["head"]  # [tile, V]

    logits = _tiled(head, last)  # [B, V]
    Vl = cfg.vocab_size // P
    return logits.reshape(B, P, Vl).transpose(0, 1).contiguous()


@dataclass
class TPDecoder:
    """The decode-side model bundle: weights + config + attention backend,
    with :meth:`forward` as the one entry point the serving engine calls
    (the engine rebuilds its cache on heal but keeps the same decoder)."""

    weights: dict
    cfg: TPServeConfig
    attn_backend: str = "gather"

    def __post_init__(self):
        if self.attn_backend not in ("gather", "kernel"):
            raise ValueError(f"unknown attn_backend {self.attn_backend!r}")

    def forward(self, comm: Communicator, kv, seq_ids, tokens: np.ndarray,
                positions: np.ndarray, queue=None,
                comm_log: list | None = None) -> torch.Tensor:
        """:func:`forward_tokens` under this decoder's backend."""
        return forward_tokens(self.weights, self.cfg, comm, kv, seq_ids,
                              tokens, positions, queue=queue,
                              comm_log=comm_log,
                              attn_backend=self.attn_backend)


# ---------------------------------------------------------------------------
# Token emission: gather the logits shards, or ship only local argmaxes
# ---------------------------------------------------------------------------


#: Static int8 wire grid for quantized logits-shard emission: steps of
#: 1/16, range ±127/16.  A *constant* scale quantizes every logit
#: identically at any world size ``P`` (see the reference).
WIRE_I8_STEP = 16.0

_WIRE_DTYPES = {"bf16": torch.bfloat16}


def _wire_codec(wire: str):
    """(encode, decode) for one emission wire dtype.  ``encode`` maps an
    f32 tensor to what crosses the wire; ``decode`` maps wire elements back
    to f32 (elementwise, so it commutes with the allgather reshapes)."""
    if wire == "f32":
        return (lambda x: x), (lambda x: x)
    if wire == "fp8":  # NaN past ±464, as the reference's ml_dtypes cast
        return to_e4m3, (lambda x: x.float())
    if wire in _WIRE_DTYPES:
        dt = _WIRE_DTYPES[wire]
        return (lambda x: x.to(dt)), (lambda x: x.float())
    if wire == "int8":
        return (lambda x: torch.clamp(torch.round(x * WIRE_I8_STEP), -127,
                                      127).to(torch.int8),
                lambda x: x.float() / WIRE_I8_STEP)
    raise ValueError(f"unknown wire dtype {wire!r}")


def gather_logits(comm: Communicator, shard: torch.Tensor,
                  queue=None, wire: str = "f32") -> Request:
    """Issue the allgather of logits shards nonblockingly.  The finalized
    result is the full ``[P, B, V]`` distribution in natural vocab order.
    ``wire`` quantizes the shards on the wire (also at ``P = 1``, so every
    world argmaxes the same array)."""
    P, B, Vl = shard.shape
    enc, dec = _wire_codec(wire)
    wired = enc(shard)

    def rebuild(flat):
        if P == 1:
            return dec(wired).reshape(P, B, Vl)
        g = dec(flat).reshape(P, P, B, Vl)  # [holder, contributor, B, Vl]
        return g.movedim(1, 2).reshape(P, B, P * Vl)

    from ..core import requests as R

    req = R.iallgather(wired, comm, algorithm="auto", finalize=rebuild)
    if queue is not None:
        queue.push(req)
    return req


def local_argmax(comm: Communicator, shard: torch.Tensor,
                 queue=None) -> Request:
    """The cheap-message alternative to :func:`gather_logits`: each rank
    reduces its shard to ``(max, argmax)`` and only those ``[2]``-vectors
    cross the wire.  The finalize recovers exactly the argmax of the full
    distribution (first max wins, as ``torch.argmax`` does, because shards
    are in vocab order)."""
    P, B, Vl = shard.shape
    packed = torch.stack([shard.amax(dim=-1),
                          shard.argmax(dim=-1).float()],
                         dim=-1).reshape(P, B * 2)

    def rebuild(flat):
        g = (packed.reshape(1, 1, B, 2) if P == 1
             else flat.reshape(P, P, B, 2))
        maxes = g[..., 0].movedim(1, 2)  # [P, B, contributor]
        args = g[..., 1].movedim(1, 2)
        win = torch.argmax(maxes, dim=-1)  # first max wins (vocab order)
        picked = torch.gather(args, -1, win[..., None])[..., 0]
        return win * Vl + picked.long()  # [P, B]

    from ..core import requests as R

    req = R.iallgather(packed, comm, algorithm="auto", finalize=rebuild)
    if queue is not None:
        queue.push(req)
    return req


def prefill_logits(weights, cfg: TPServeConfig, comm: Communicator,
                   tokens: np.ndarray, kv=None, seq_id: int = 0,
                   page_size: int = 8, queue=None, comm_log=None):
    """Single-sequence prefill convenience: builds a throwaway cache on the
    weights' device when none is given, runs :func:`forward_tokens` over the
    whole prompt, and returns the gathered ``[P, B, V]`` logits."""
    from .kv_cache import PagedKVCache, pages_needed

    P = comm.size
    B, T = np.asarray(tokens).shape
    if kv is None:
        kv = PagedKVCache(cfg.n_layers, n_pages=pages_needed(T, page_size),
                          page_size=page_size,
                          heads_local=cfg.n_heads // P,
                          head_dim=cfg.head_dim, world=P,
                          device=weights["embed"].device)
        kv.alloc(seq_id, capacity=T)
    shard = forward_tokens(weights, cfg, comm, kv, [seq_id] * B, tokens,
                           np.broadcast_to(np.arange(T), (B, T)),
                           queue=queue, comm_log=comm_log)
    return gather_logits(comm, shard, queue).wait()

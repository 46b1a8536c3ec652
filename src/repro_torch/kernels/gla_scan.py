"""Chunked gated-linear-attention scan (mLSTM / SSD), forward and backward.

Port of the Pallas TPU kernel :mod:`repro.kernels.ssm_scan`.  Per batch and
head, with ``v̂ = [v | 1]`` (the extra column carries the normalizer)::

    C_t = f_t C_{t-1} + i_t k_t v̂_tᵀ              (state, [dk, dv+1], f32)
    o_t = q_tᵀ C_t / max(|q_tᵀ C_t[:, dv]|, 1)    (normalize=True, mLSTM)
    o_t = (q_tᵀ C_t)[:dv]                          (normalize=False, SSD)

with ``q`` scaled by ``dk**-0.5`` in f32, computed in chunks of ``L =
min(chunk, T)`` steps: inside a chunk two products over a causal decay
mask ``exp(b_t - b_s) i_s`` (``b`` the within-chunk cumulative sum of
``log_f``), across chunks only the state.  Steps past ``T`` are padded
with the identity transition (``log_f = 0``, ``i = 0``, ``k = v = 0``).
The reference has no backward kernel: it trains through ``jax.grad`` of
its XLA twin.  On the card the gradient is a hand-written kernel too.
Pieces:

* :func:`gla_scan` — the wrapper.  A CUDA tensor goes through
  :class:`GlaScanFn`, whose forward launches the kernels of
  ``csrc/gla_scan.cu`` (one call of :func:`gla_scan_fwd`, counted in
  ``gla_scan.launches``) and whose backward launches the backward kernels
  (one call of :func:`gla_scan_bwd`, counted in
  ``gla_scan_bwd.launches``); a CPU tensor goes to the plain version.
  The route is chosen by dtype alone: bf16 runs the tensor-core kernels
  (``wgmma``, the chunks in parallel; also counted in
  ``gla_scan.tc_launches`` / ``gla_scan_bwd.tc_launches``), f32 the SIMT
  kernels.  Nothing falls back: a CUDA call that its route does not take
  raises.
* :func:`gla_scan_plain` — the plain PyTorch version, the port of the
  reference's ``repro.kernels.ops._xla_gla_scan``.  Autograd through it
  is the gradient the backward kernel is held against.
* the layout: ``q``/``k [B, H, T, dk]``, ``v [B, H, T, dv]`` in f32 or
  bf16, ``log_f``/``i_gate [B, H, T]`` f32.  Returns ``(out [B, H, T, dv]``
  in q's dtype, ``state [B, H, dk, dv+1]`` f32).  The state is not
  differentiable on the card: a gradient on it (the decode caches) raises.

>>> q = torch.ones((1, 1, 3, 4)); v = torch.arange(3.).reshape(1, 1, 3, 1)
>>> lf = torch.zeros((1, 1, 3)); ig = torch.ones((1, 1, 3))
>>> out, state = gla_scan(q, q, v, lf, ig)
>>> [round(x, 4) for x in out[0, 0, :, 0].tolist()], tuple(state.shape)
([0.0, 0.5, 1.0], (1, 1, 4, 2))
"""

from __future__ import annotations

import ctypes

import torch

from . import check_aligned, empty_for_kernel, stream_of

#: The kernels' limits: ``dk`` and ``dv`` are multiples of 16, ``dk`` at
#: most 384 (the f32 route keeps a value tile's state slice in shared
#: memory), the chunk at most 128 steps.
DK_MAX, CHUNK_MAX = 384, 128
#: Value columns per thread block of the f32 route (``csrc/gla_scan.cu``:
#: ``kTile``).
TILE = 32
#: Columns of a tile of the bf16 route (dk and dv are cut into 64s).
TC_TILE = 64
_STATE_GRAD = ("a gradient on the scan's final state (the recurrent decode "
               "state) is not ported yet (ROADMAP Queue 1, item 14)")


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------


def gla_scan_plain(q, k, v, log_f, i_gate, normalize: bool = True,
                   chunk: int = 128):
    """Chunked GLA in plain PyTorch (port of the reference's XLA twin):
    ``(out [B, H, T, dv]`` in q's dtype, ``state [B, H, dk, dv+1]`` f32).
    Works on any device and under autograd."""
    B, H, T, dk = q.shape
    dv = v.shape[-1]
    L = min(chunk, T)
    nc = -(-T // L)
    pad = nc * L - T

    def padt(x):
        if not pad:
            return x
        width = [0, 0] * (x.dim() - 3) + [0, pad]
        return torch.nn.functional.pad(x, width)

    qf = padt(q).float() * (dk**-0.5)
    kf = padt(k).float()
    vf = padt(v).float()
    lf = padt(log_f).float()
    ig = padt(i_gate).float()
    if pad:
        valid = torch.arange(nc * L, device=q.device) < T
        lf = torch.where(valid, lf, 0.0)
        ig = torch.where(valid, ig, 0.0)

    def split(x):  # [B, H, nc*L, ...] -> [B, H, nc, L, ...]
        return x.reshape(x.shape[:2] + (nc, L) + x.shape[3:])

    qs, ks, vs, lfs, igs = map(split, (qf, kf, vf, lf, ig))
    ones = torch.ones((B, H, L, 1), dtype=torch.float32, device=q.device)
    causal = torch.ones((L, L), dtype=torch.bool, device=q.device).tril()
    C = torch.zeros((B, H, dk, dv + 1), dtype=torch.float32, device=q.device)
    nums = []
    for c in range(nc):
        qc, kc, vc = qs[:, :, c], ks[:, :, c], vs[:, :, c]
        lfc, igc = lfs[:, :, c], igs[:, :, c]
        v_aug = torch.cat([vc, ones], dim=-1)
        b = torch.cumsum(lfc, dim=-1)  # [B, H, L]
        # select before the exp: exp(b_t - b_s) for s > t can overflow, and
        # a 0/1 mask times inf (or its gradient) would be NaN
        diff = torch.where(causal, b[..., :, None] - b[..., None, :],
                           float("-inf"))
        decay = torch.exp(diff) * igc[..., None, :]
        s = qc @ kc.transpose(-1, -2)
        intra = (s * decay) @ v_aug
        inter = torch.exp(b)[..., None] * (qc @ C)
        nums.append(intra + inter)
        b_last = b[..., -1]
        w = torch.exp(b_last[..., None] - b) * igc
        C = torch.exp(b_last)[..., None, None] * C + \
            (kc * w[..., None]).transpose(-1, -2) @ v_aug
    num = torch.cat(nums, dim=2)[:, :, :T]
    if normalize:
        den = torch.clamp_min(num[..., dv:].abs(), 1.0)
        out = num[..., :dv] / den
    else:
        out = num[..., :dv]
    return out.to(q.dtype), C


# ---------------------------------------------------------------------------
# the CUDA kernels
# ---------------------------------------------------------------------------


def _check_cuda(q, k, v, log_f, i_gate, chunk):
    """Raise on anything the kernels do not take; returns the sizes."""
    for name, t in (("q", q), ("k", k), ("v", v), ("log_f", log_f),
                    ("i_gate", i_gate)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"gla_scan takes float32 or bfloat16, not {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share a dtype: {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if log_f.dtype != torch.float32 or i_gate.dtype != torch.float32:
        raise TypeError("log_f and i_gate must be float32")
    if q.dim() != 4:
        raise ValueError(f"q must be [B, H, T, dk], got {tuple(q.shape)}")
    B, H, T, dk = q.shape
    dv = v.shape[-1]
    if tuple(k.shape) != (B, H, T, dk) or tuple(v.shape) != (B, H, T, dv) \
            or tuple(log_f.shape) != (B, H, T) \
            or tuple(i_gate.shape) != (B, H, T):
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}, log_f {tuple(log_f.shape)}, "
                         f"i_gate {tuple(i_gate.shape)} do not match")
    if dk % 16 or not 16 <= dk <= DK_MAX:
        raise ValueError(f"dk={dk}: the kernel takes multiples of 16 up to "
                         f"{DK_MAX}")
    if dv % 16 or dv < 16:
        raise ValueError(f"dv={dv}: the kernel takes multiples of 16")
    if T < 1 or not 1 <= chunk <= CHUNK_MAX:
        raise ValueError(f"T={T}, chunk={chunk}: the kernel takes T >= 1 and "
                         f"chunks of at most {CHUNK_MAX}")
    L = min(chunk, T)
    return B, H, T, dk, dv, L, -(-T // L)


def _lib():
    from . import _build

    lib = _build.load("gla_scan")
    if lib.gla_scan_fwd_launch.argtypes is None:
        i, p, f = ctypes.c_int, ctypes.c_void_p, ctypes.c_float
        lib.gla_scan_fwd_launch.argtypes = [p] * 10 + [i] * 7 + [f, p]
        lib.gla_scan_fwd_launch.restype = i
        lib.gla_scan_bwd_launch.argtypes = [p] * 20 + [i] * 7 + [f, p]
        lib.gla_scan_bwd_launch.restype = i
        lib.gla_scan_tc_fwd_launch.argtypes = [p] * 10 + [i] * 7 + [f, p]
        lib.gla_scan_tc_fwd_launch.restype = i
        lib.gla_scan_tc_bwd_launch.argtypes = [p] * 22 + [i] * 7 + [f, p]
        lib.gla_scan_tc_bwd_launch.restype = i
    return lib


def _n_tiles(dv: int) -> int:
    return -(-dv // TILE)


def gla_scan_fwd(q, k, v, log_f, i_gate, normalize: bool = True,
                 chunk: int = 128, save: bool = False):
    """Launch the forward kernels on CUDA tensors → ``(out, state, saved)``.
    With ``save``, ``saved`` is what :func:`gla_scan_bwd` takes: on the f32
    route ``(states, norms)``, the f32 state entering every chunk ``[B, H,
    nc, dk, dv+1]`` and the f32 normalizer ``q_tᵀ C_t[:, dv]`` of every step
    ``[B, H, T]``; on the bf16 route ``(tiles, tiles_n, norms)``, the same
    states as hi/lo bf16 panel pairs and their f32 normalizer column
    (:func:`_tc_state_buffers`); else ``None``."""
    B, H, T, dk, dv, L, nc = _check_cuda(q, k, v, log_f, i_gate, chunk)
    dev = q.device
    tc = q.dtype == torch.bfloat16
    f32 = torch.float32
    out = empty_for_kernel((B, H, T, dv), q.dtype, dev)
    state = empty_for_kernel((B, H, dk, dv + 1), f32, dev)
    norms = empty_for_kernel((B, H, T), f32, dev) if save else None
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(dev):
        if tc:  # the output pass reads the chunk states in any case
            check_aligned(q=q, k=k, v=v)
            tiles, tiles_n = _tc_state_buffers(B * H, nc, dk, dv, dev)
            saved = (tiles, tiles_n, norms)
            err = _lib().gla_scan_tc_fwd_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), log_f.data_ptr(),
                i_gate.data_ptr(), out.data_ptr(), state.data_ptr(),
                tiles.data_ptr(), tiles_n.data_ptr(), ptr(norms), B * H, T,
                dk, dv, L, nc, int(bool(normalize)), dk**-0.5, stream_of(q))
        else:
            states = None
            if save:
                states = empty_for_kernel((B, H, nc, dk, dv + 1), f32, dev)
            saved = (states, norms)
            scores = empty_for_kernel((B * H, nc, L, L), f32, dev)
            err = _lib().gla_scan_fwd_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), log_f.data_ptr(),
                i_gate.data_ptr(), out.data_ptr(), state.data_ptr(),
                scores.data_ptr(), ptr(states), ptr(norms), B * H, T, dk, dv,
                L, nc, int(bool(normalize)), dk**-0.5, stream_of(q))
    if err != 0:
        raise RuntimeError(f"gla_scan kernel launch failed: cudaError_t {err}")
    gla_scan.launches += 1
    gla_scan.tc_launches += tc
    return out, state, (saved if save else None)


def _tc_state_buffers(BH, nc, dk, dv, dev):
    """The bf16 route's chunk states (or their gradients): hi/lo bf16 panel
    pairs ``[BH, nc, ceil(dk/64), ceil(dv/64), 2, 64, 64]`` and the f32
    normalizer column ``[BH, nc, dk]``."""
    tiles = empty_for_kernel((BH, nc, -(-dk // TC_TILE), -(-dv // TC_TILE), 2,
                              TC_TILE, TC_TILE), torch.bfloat16, dev)
    return tiles, empty_for_kernel((BH, nc, dk), torch.float32, dev)


def gla_scan_bwd(q, k, v, log_f, i_gate, out, dout, saved,
                 normalize: bool = True, chunk: int = 128):
    """Launch the backward kernels on CUDA tensors → ``(dq, dk, dv, dlog_f,
    di_gate)``, dq/dk/dv in the inputs' dtype and the gate gradients f32.
    ``saved`` is the forward's (:func:`gla_scan_fwd`).  Deterministic,
    no atomics: the f32 route adds per-value-tile partials in a fixed
    order; the bf16 route writes dq and dk once and adds its small
    cross-block terms in a fixed order."""
    B, H, T, dk, dv, L, nc = _check_cuda(q, k, v, log_f, i_gate, chunk)
    dev, f32 = q.device, torch.float32
    tc = q.dtype == torch.bfloat16
    if tc:
        tiles, tiles_n, norms = saved
        want = [("tiles", tiles, torch.bfloat16, (B * H, nc, -(-dk // TC_TILE),
                                                  -(-dv // TC_TILE), 2,
                                                  TC_TILE, TC_TILE)),
                ("tiles_n", tiles_n, f32, (B * H, nc, dk))]
    else:
        states, norms = saved
        want = [("states", states, f32, (B, H, nc, dk, dv + 1))]
    for name, t, dt, shape in want + [
            ("out", out, q.dtype, (B, H, T, dv)),
            ("dout", dout, q.dtype, (B, H, T, dv)),
            ("norms", norms, f32, (B, H, T))]:
        if t is None or t.device != dev or t.dtype != dt \
                or not t.is_contiguous() or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be a contiguous {dt} tensor "
                             f"{shape} on {dev}")
    if tc:
        return _tc_bwd(q, k, v, log_f, i_gate, out, dout, saved, normalize,
                       (B, H, T, dk, dv, L, nc))
    nt = _n_tiles(dv)
    scores = empty_for_kernel((B * H, nc, L, L), f32, dev)
    g = empty_for_kernel((B * H, T), f32, dev)
    dq_part = empty_for_kernel((nt, B * H, T, dk), f32, dev)
    dk_part = empty_for_kernel((nt, B * H, T, dk), f32, dev)
    dlf_part = empty_for_kernel((nt, B * H, T), f32, dev)
    dig_part = empty_for_kernel((nt, B * H, T), f32, dev)
    dq = empty_for_kernel(q.shape, q.dtype, dev)
    dk_ = empty_for_kernel(k.shape, k.dtype, dev)
    dv_ = empty_for_kernel(v.shape, v.dtype, dev)
    dlf = empty_for_kernel(log_f.shape, f32, dev)
    dig = empty_for_kernel(i_gate.shape, f32, dev)
    with torch.cuda.device(dev):
        err = _lib().gla_scan_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), log_f.data_ptr(),
            i_gate.data_ptr(), out.data_ptr(), dout.data_ptr(),
            states.data_ptr(), norms.data_ptr(), scores.data_ptr(),
            g.data_ptr(), dq_part.data_ptr(), dk_part.data_ptr(),
            dlf_part.data_ptr(), dig_part.data_ptr(), dq.data_ptr(),
            dk_.data_ptr(), dv_.data_ptr(), dlf.data_ptr(), dig.data_ptr(),
            B * H, T, dk, dv, L, nc, int(bool(normalize)), dk**-0.5,
            stream_of(q))
    if err != 0:
        raise RuntimeError(f"gla_scan backward launch failed: cudaError_t "
                           f"{err}")
    gla_scan_bwd.launches += 1
    return dq, dk_, dv_, dlf, dig


def _tc_bwd(q, k, v, log_f, i_gate, out, dout, saved, normalize, dims):
    """The bf16 route of :func:`gla_scan_bwd` (checked by it)."""
    B, H, T, dk, dv, L, nc = dims
    dev, f32 = q.device, torch.float32
    tiles, tiles_n, norms = saved
    check_aligned(q=q, k=k, v=v, out=out, dout=dout)
    g, dbq, dbk, dww = (empty_for_kernel((B * H, T), f32, dev)
                        for _ in range(4))
    dtiles, dtiles_n = _tc_state_buffers(B * H, nc, dk, dv, dev)
    dcc = empty_for_kernel((B * H, nc, tiles.shape[2] * tiles.shape[3]), f32,
                           dev)
    dq = empty_for_kernel(q.shape, q.dtype, dev)
    dk_ = empty_for_kernel(k.shape, k.dtype, dev)
    dv_ = empty_for_kernel(v.shape, v.dtype, dev)
    dlf = empty_for_kernel(log_f.shape, f32, dev)
    dig = empty_for_kernel(i_gate.shape, f32, dev)
    with torch.cuda.device(dev):
        err = _lib().gla_scan_tc_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), log_f.data_ptr(),
            i_gate.data_ptr(), out.data_ptr(), dout.data_ptr(),
            tiles.data_ptr(), tiles_n.data_ptr(), norms.data_ptr(),
            g.data_ptr(), dtiles.data_ptr(), dtiles_n.data_ptr(),
            dcc.data_ptr(), dbq.data_ptr(), dbk.data_ptr(), dww.data_ptr(),
            dq.data_ptr(), dk_.data_ptr(), dv_.data_ptr(), dlf.data_ptr(),
            dig.data_ptr(), B * H, T, dk, dv, L, nc, int(bool(normalize)),
            dk**-0.5, stream_of(q))
    if err != 0:
        raise RuntimeError(f"gla_scan backward launch failed: cudaError_t "
                           f"{err}")
    gla_scan_bwd.launches += 1
    gla_scan_bwd.tc_launches += 1
    return dq, dk_, dv_, dlf, dig


class GlaScanFn(torch.autograd.Function):
    """Autograd tie of the forward and backward kernels.  The forward
    saves the inputs, the output, the chunk-start states and the
    normalizers; ``torch.utils.checkpoint`` re-runs the forward on
    recompute.  The final state is not differentiable."""

    @staticmethod
    def forward(ctx, q, k, v, log_f, i_gate, normalize, chunk):
        save = any(ctx.needs_input_grad[:5])
        out, state, saved = gla_scan_fwd(q, k, v, log_f, i_gate, normalize,
                                         chunk, save=save)
        ctx.mark_non_differentiable(state)
        ctx.set_materialize_grads(False)
        if save:
            ctx.save_for_backward(q, k, v, log_f, i_gate, out, *saved)
        ctx.opts = (normalize, chunk)
        return out, state

    @staticmethod
    def backward(ctx, dout, dstate):
        if dstate is not None:
            raise NotImplementedError(_STATE_GRAD)
        if dout is None:
            return (None,) * 7
        q, k, v, log_f, i_gate, out, *saved = ctx.saved_tensors
        grads = gla_scan_bwd(q, k, v, log_f, i_gate, out, dout.contiguous(),
                             tuple(saved), *ctx.opts)
        return (*grads, None, None)


def gla_scan(q, k, v, log_f, i_gate, normalize: bool = True, chunk: int = 128):
    """Chunked GLA / mLSTM scan → ``(out [B, H, T, dv], state [B, H, dk,
    dv+1])`` (see the module docstring).  CPU tensors run the plain
    version; CUDA tensors run the Hopper kernels, forward and backward."""
    if q.device.type == "cpu":
        return gla_scan_plain(q, k, v, log_f, i_gate, normalize, chunk)
    if q.device.type != "cuda":
        raise ValueError(f"gla_scan runs on cpu or cuda, not {q.device}")
    return GlaScanFn.apply(q, k, v, log_f, i_gate, normalize, chunk)


#: Kernel launches since the process started (CUDA calls only), and those
#: of them that took the bf16 tensor-core route; callers that need a
#: window set them to 0 first.
gla_scan.launches = 0
gla_scan_bwd.launches = 0
gla_scan.tc_launches = 0
gla_scan_bwd.tc_launches = 0

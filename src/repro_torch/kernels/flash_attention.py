"""GQA flash attention (causal / sliding window / static ``q_offset``),
forward and backward.

Port of the Pallas TPU kernel :mod:`repro.kernels.flash_attention`.  The
reference has no backward kernel: it differentiates its XLA twin, whose
per-block ``jax.checkpoint`` recomputes the score tiles.  On the card the
gradient of the same function is a hand-written kernel too.  Pieces:

* :func:`flash_attention` — the wrapper.  A CUDA tensor goes through
  :class:`FlashAttentionFn`, whose forward launches the Hopper kernel of
  ``csrc/flash_attention.cu`` (counted in ``flash_attention.launches``) and
  whose backward launches its backward kernels (one call of
  :func:`flash_attention_bwd`, counted in ``flash_attention_bwd.launches``);
  a CPU tensor goes to the plain version.  The route is chosen by dtype
  alone: bf16 runs on the tensor cores (``wgmma`` on tiles that TMA brings
  into shared memory), f32 on the SIMT kernels.  Nothing falls back: a CUDA
  call that the kernel does not take (for bf16 also a base address off 16
  bytes), or whose build or launch fails, raises.
* :func:`flash_attention_plain` — the plain PyTorch version, the port of
  the reference's ``repro.kernels.ops._xla_flash_attention`` (chunked
  online softmax over kv blocks of 512, each block's step checkpointed so
  autograd recomputes its score tile, as the reference does).
* the layout: ``q [B, Hq, T, d]``, ``k [B, Hkv, S, d]``, ``v [B, Hkv, S,
  dv]`` in f32 or bf16, ``Hq % Hkv == 0``; the output is ``[B, Hq, T, dv]``
  in q's dtype, scores ``(q . k) d^-0.5``; scores and accumulators f32,
  masked scores -1e30.  The kernels take the (d, dv) pairs of
  :data:`SHAPES`, every pair a config of the zoo reaches.  A q row at absolute position
  ``q_offset + t`` sees key ``s`` when ``s < S`` and, if ``causal``,
  ``s <= q_offset + t`` and, if ``window``, ``s > q_offset + t - window``.
  A row that sees no key is exact 0.

>>> q = torch.ones((1, 2, 3, 16)); kv = torch.arange(3.).reshape(1, 1, 3, 1)
>>> out = flash_attention(q, kv.expand(1, 1, 3, 16), kv.expand(1, 1, 3, 16))
>>> [round(x, 4) for x in out[0, 0, :, 0].tolist()]   # causal averages
[0.0, 0.982, 1.9814]
"""

from __future__ import annotations

import ctypes

import torch
from torch.utils.checkpoint import checkpoint

from . import check_aligned, empty_for_kernel, stream_of

NEG_INF = -1e30
#: (d, dv) pairs the kernels are compiled for (``FA_SHAPES`` in
#: ``csrc/flash_attention.cu``): the q/k width and the v width.  Beside 16,
#: 32, 64 and 128: (48, 32), the reduced MLA config (qk_nope 32 + qk_rope
#: 16, v 32); (80, 80), hubert-xlarge; (192, 128), deepseek-v2's MLA
#: (qk_nope 128 + qk_rope 64, v 128).
SHAPES = ((16, 16), (32, 32), (48, 32), (64, 64), (80, 80), (128, 128),
          (192, 128))
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------


def _block_step(q, kb, vb, m, l, acc, k0: int, S: int, q_pos, causal: bool,
                window: int, scale: float):
    """One kv block of the online softmax (the reference's ``step``)."""
    bk = kb.shape[2]
    s = torch.matmul(q.float(), kb.float().transpose(-1, -2)) * scale
    k_pos = k0 + torch.arange(bk, device=q.device)
    mask = (k_pos[None, :] < S) & torch.ones((q_pos.shape[0], 1), dtype=torch.bool,
                                             device=q.device)
    if causal:
        mask = mask & (k_pos[None, :] <= q_pos[:, None])
    if window:
        mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    p = torch.where(mask, p, torch.zeros_like(p))
    alpha = torch.exp(m - m_new)
    l = l * alpha + p.sum(dim=-1)
    pv = torch.matmul(p.to(q.dtype).float(), vb.float())
    acc = acc * alpha[..., None] + pv
    return m_new, l, acc


def flash_attention_plain(q, k, v, causal: bool = True, window: int = 0,
                          q_offset: int = 0, bk: int = 512):
    """Chunked online-softmax attention in plain PyTorch (port of the
    reference's XLA twin).  Works on any device and under autograd."""
    B, Hq, T, d = q.shape
    _, Hkv, S, dv = v.shape
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} not a multiple of Hkv={Hkv}")
    group = Hq // Hkv
    bk = min(bk, S) if S else 1
    nk = -(-S // bk)
    scale = d**-0.5
    q_pos = torch.arange(T, device=q.device) + q_offset
    m = torch.full((B, Hq, T), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, Hq, T), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Hq, T, dv), dtype=torch.float32, device=q.device)
    recompute = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    for ki in range(nk):
        k0 = ki * bk
        kb = k[:, :, k0:k0 + bk].repeat_interleave(group, dim=1)
        vb = v[:, :, k0:k0 + bk].repeat_interleave(group, dim=1)
        args = (q, kb, vb, m, l, acc, k0, S, q_pos, causal, window, scale)
        if recompute:  # backward recomputes the [T, bk] tile
            m, l, acc = checkpoint(_block_step, *args, use_reentrant=False)
        else:
            m, l, acc = _block_step(*args)
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# the CUDA kernels
# ---------------------------------------------------------------------------


def _check_cuda(q, k, v, window, q_offset):
    """Raise on anything the kernel does not take."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.dim() != 4:
            raise ValueError(f"{name} must be 4-D, got {tuple(t.shape)}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash_attention takes float32 or bfloat16, not {q.dtype}")
    B, Hq, T, d = q.shape
    Bk, Hkv, S, dk = k.shape
    dv = v.shape[3]
    if Bk != B or dk != d or tuple(v.shape[:3]) != (B, Hkv, S):
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match (q, k [B, H, T|S, "
                         f"d], v [B, Hkv, S, dv])")
    if (d, dv) not in SHAPES:
        raise ValueError(f"head dims (d, dv) = {(d, dv)} not in the kernels' "
                         f"SHAPES {SHAPES}")
    if Hkv < 1 or Hq % Hkv:
        raise ValueError(f"Hq={Hq} not a multiple of Hkv={Hkv}")
    if isinstance(q_offset, torch.Tensor) or int(q_offset) != q_offset \
            or q_offset < 0:
        raise ValueError("the kernel takes a static q_offset >= 0 (a Python "
                         "int); a dynamic offset does not arise in training")
    if int(window) < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if q.dtype == torch.bfloat16:
        check_aligned(q=q, k=k, v=v)
    return B, Hq, Hkv, T, S, d, dv


def _lib():
    from . import _build

    lib = _build.load("flash_attention")
    if lib.flash_attention_fwd_launch.argtypes is None:
        i, p, f = ctypes.c_int, ctypes.c_void_p, ctypes.c_float
        lib.flash_attention_fwd_launch.argtypes = [p] * 5 + [i] * 10 + [f, i, p]
        lib.flash_attention_fwd_launch.restype = i
        lib.flash_attention_bwd_launch.argtypes = [p] * 10 + [i] * 10 + [f, i, p]
        lib.flash_attention_bwd_launch.restype = i
        lib.flash_attention_tile_plan.argtypes = [i] * 7 + [p] * 4
        lib.flash_attention_tile_plan.restype = i
    return lib


def tile_plan(T: int, S: int, d: int, dv: int, causal: bool, window: int,
              q_offset: int) -> dict:
    """The bf16 kernels' skip ranges and tile classes at head dims (d, dv),
    computed on the host by the same functions the kernels run (it needs
    the built library, not a card).  Returns ``kv [n_q_blocks, 2]``: [lo, hi) of each 64-row q
    block's 64-key tiles (forward and dQ kernels); ``kv_full [n_q_blocks,
    n_kv_tiles]``: which of them take no element mask; ``qt``, ``q_full``:
    the same for the dK/dV kernel's q tiles of ``bq`` rows in each 64-key
    block; and ``bq``."""
    lib, cdiv = _lib(), lambda a, b: -(-a // b)
    args = (T, S, d, dv, int(bool(causal)), int(window), int(q_offset))
    bq = lib.flash_attention_tile_plan(*args, None, None, None, None)
    if bq < 0:
        raise ValueError(f"head dims {(d, dv)} not in SHAPES {SHAPES}")
    kv = torch.zeros((cdiv(T, 64), 2), dtype=torch.int32)
    kv_full = torch.zeros((cdiv(T, 64), cdiv(S, 64)), dtype=torch.uint8)
    qt = torch.zeros((cdiv(S, 64), 2), dtype=torch.int32)
    q_full = torch.zeros((cdiv(S, 64), cdiv(T, bq)), dtype=torch.uint8)
    lib.flash_attention_tile_plan(*args, *(t.data_ptr() for t in
                                           (kv, kv_full, qt, q_full)))
    return {"kv": kv, "kv_full": kv_full.bool(), "qt": qt,
            "q_full": q_full.bool(), "bq": bq}


def flash_attention_fwd(q, k, v, causal: bool = True, window: int = 0,
                        q_offset: int = 0):
    """Launch the forward kernel on CUDA tensors → ``(out, lse)``, with
    ``lse [B, Hq, T]`` f32 the per-row log-sum-exp the backward takes;
    ``out`` is ``[B, Hq, T, dv]``."""
    B, Hq, Hkv, T, S, d, dv = _check_cuda(q, k, v, window, q_offset)
    out = empty_for_kernel((B, Hq, T, dv), q.dtype, q.device)
    lse = empty_for_kernel((B, Hq, T), torch.float32, q.device)
    with torch.cuda.device(q.device):
        err = _lib().flash_attention_fwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), B, Hq, Hkv, T, S, d, dv, int(bool(causal)),
            int(window), int(q_offset), d**-0.5, _DTYPE_CODE[q.dtype],
            stream_of(q))
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"cudaError_t {err}")
    flash_attention.launches += 1
    return out, lse


def flash_attention_bwd(q, k, v, out, dout, lse, causal: bool = True,
                        window: int = 0, q_offset: int = 0):
    """Launch the backward kernels on CUDA tensors → ``(dq, dk, dv)`` in
    the inputs' dtype (``dv [B, Hkv, S, dv]`` as v).  Deterministic: the
    same inputs give the same bits."""
    B, Hq, Hkv, T, S, d, dv_ = _check_cuda(q, k, v, window, q_offset)
    for name, t, dt in (("out", out, q.dtype), ("dout", dout, q.dtype),
                        ("lse", lse, torch.float32)):
        if t.device != q.device or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dt} tensor on "
                             f"{q.device}")
    if tuple(out.shape) != (B, Hq, T, dv_) or tuple(dout.shape) != \
            (B, Hq, T, dv_) or tuple(lse.shape) != (B, Hq, T):
        raise ValueError(f"out/dout must be [B, Hq, T, dv] = "
                         f"{(B, Hq, T, dv_)} and lse [B, Hq, T]")
    if q.dtype == torch.bfloat16:
        check_aligned(dout=dout)
    delta = empty_for_kernel((B, Hq, T), torch.float32, q.device)
    dq = empty_for_kernel(q.shape, q.dtype, q.device)
    dk = empty_for_kernel(k.shape, k.dtype, k.device)
    dv = empty_for_kernel(v.shape, v.dtype, v.device)
    with torch.cuda.device(q.device):
        err = _lib().flash_attention_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), B, Hq, Hkv, T, S, d, dv_,
            int(bool(causal)), int(window), int(q_offset), d**-0.5,
            _DTYPE_CODE[q.dtype], stream_of(q))
    if err != 0:
        raise RuntimeError(f"flash_attention backward launch failed: "
                           f"cudaError_t {err}")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """Autograd tie of the forward and backward kernels: the forward saves
    q, k, v, out and the log-sum-exp; the backward recomputes p from them.
    ``torch.utils.checkpoint`` re-runs the forward on recompute."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset):
        out, lse = flash_attention_fwd(q, k, v, causal, window, q_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = (causal, window, q_offset)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout.contiguous(), lse,
                                         *ctx.mask)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, causal: bool = True, window: int = 0,
                    q_offset: int = 0):
    """GQA flash attention ``q [B, Hq, T, d]``, ``v [B, Hkv, S, dv]`` →
    ``[B, Hq, T, dv]`` in q's dtype (see the module docstring).  CPU tensors run the plain version;
    CUDA tensors run the Hopper kernels, forward and backward."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, window, q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not {q.device}")
    return FlashAttentionFn.apply(q, k, v, causal, window, q_offset)


#: Kernel launches since the process started (CUDA calls only); callers
#: that need a window set them to 0 first.
flash_attention.launches = 0
flash_attention_bwd.launches = 0

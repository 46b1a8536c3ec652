"""The language model of the dense family, for training.

Port of :mod:`repro.models.lm` (``padded_vocab``, ``init_params``,
``_dense_block``, ``forward`` without a cache, ``loss_fn``,
``count_params``).  The reference stacks each parameter of the layers on a
leading group axis and scans over it; here the parameters live in an
``nn.Module`` (:class:`LM`) with one submodule per layer, and
``cfg.remat`` becomes ``torch.utils.checkpoint`` per layer
(``use_reentrant=False``: backward recomputes the layer, saving only its
input — the reference's ``nothing_saveable`` policy per group).  The other
families (moe, vlm, ssm, hybrid, audio) raise, naming their ROADMAP item.

Parameter names follow the reference's tree: ``embed``, ``head`` (untied
only), ``final_norm`` and ``layers.<g>.{ln1, ln2, attn.<w>, mlp.<w>}`` for
``groups/<...>[g]``.  :func:`params_from_reference` converts the
reference's ``init_params`` tree (nested dicts of numpy arrays) into them,
and :func:`decayed` names the leaves the reference's AdamW decays.

>>> from repro_torch.models.config import ModelConfig
>>> cfg = ModelConfig(name="t", family="dense", n_layers=2, d_model=16,
...                   n_heads=2, n_kv_heads=1, d_ff=32, vocab_size=100,
...                   head_dim=8, tie_embeddings=True, dtype="float32")
>>> padded_vocab(cfg), count_params(cfg)
(128, 6736)
>>> model = init_params(cfg, seed=0, device="cpu")
>>> logits, aux, _ = forward(model, cfg, None, {"tokens": torch.zeros((1, 4), dtype=torch.long)})
>>> tuple(logits.shape), decayed("layers.0.ln1", model.layers[0].ln1)
((1, 4, 128), True)
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from . import attention as ATT
from . import moe as MOE
from .config import ModelConfig
from .layers import NO_SHARD, Axes, dense_init, embed_init, rmsnorm

_FAMILIES = {
    "moe": "the moe family is not ported yet (ROADMAP Queue 1, item 13)",
    "vlm": "the vlm family is not ported yet (ROADMAP Queue 1, item 14)",
    "ssm": "the ssm family is not ported yet (ROADMAP Queue 1, item 13)",
    "hybrid": "the hybrid family is not ported yet (ROADMAP Queue 1, item 13)",
    "audio": "the audio family is not ported yet (ROADMAP Queue 1, item 14)",
}


def padded_vocab(cfg: ModelConfig) -> int:
    return -(-cfg.vocab_size // 128) * 128


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(_FAMILIES.get(
            cfg.family, f"unknown family {cfg.family!r}"))


# ---------------------------------------------------------------------------
# the module
# ---------------------------------------------------------------------------


class DenseBlock(nn.Module):
    """One layer: ``x + attn(rmsnorm(x)) -> + mlp(rmsnorm(.))``."""

    def __init__(self, p: dict):
        super().__init__()
        self.ln1 = nn.Parameter(p["ln1"])
        self.attn = nn.ParameterDict(p["attn"])
        self.ln2 = nn.Parameter(p["ln2"])
        self.mlp = nn.ParameterDict(p["mlp"])

    def forward(self, x, cfg: ModelConfig, ax: Axes, positions):
        return _dense_block(self, x, cfg, ax, positions)


def _dense_block(p, x, cfg, ax, positions):
    h = rmsnorm(x, p.ln1, cfg.norm_eps)
    a, _ = ATT.attn_apply(p.attn, h, cfg, ax, positions=positions)
    x = x + a
    h = rmsnorm(x, p.ln2, cfg.norm_eps)
    x = x + MOE.mlp_apply(p.mlp, h, cfg, ax)
    return ax.act_btd(x)


class LM(nn.Module):
    """The dense LM's parameters (see the module docstring for names)."""

    def __init__(self, cfg: ModelConfig, tensors: dict):
        super().__init__()
        _check_family(cfg)
        self.cfg = cfg
        self.embed = nn.Parameter(tensors["embed"])
        if not cfg.tie_embeddings:
            self.head = nn.Parameter(tensors["head"])
        self.final_norm = nn.Parameter(tensors["final_norm"])
        self.layers = nn.ModuleList(DenseBlock(g) for g in tensors["layers"])

    def forward(self, tokens, ax: Axes = NO_SHARD):
        """``tokens [B, T]`` → logits ``[B, T, Vp]`` in the compute dtype."""
        cfg = self.cfg
        dt = cfg.adtype
        x = nn.functional.embedding(tokens.long(), self.embed).to(dt)
        positions = torch.arange(x.shape[1], device=x.device)
        remat = cfg.remat and torch.is_grad_enabled()
        for layer in self.layers:
            if remat:
                x = checkpoint(layer, x, cfg, ax, positions,
                               use_reentrant=False)
            else:
                x = layer(x, cfg, ax, positions)
        x = rmsnorm(x, self.final_norm, cfg.norm_eps)
        if cfg.tie_embeddings:
            logits = x @ self.embed.to(dt).t()
        else:
            logits = x @ self.head.to(dt)
        return ax.act_btv(logits)


def _tensors(cfg: ModelConfig, generator: torch.Generator, device) -> dict:
    D = cfg.d_model
    ones = lambda: torch.ones((D,), dtype=cfg.pdtype, device=device)  # noqa: E731
    layers = [{"ln1": ones(), "attn": ATT.attn_init(generator, cfg, device),
               "ln2": ones(), "mlp": MOE.mlp_init(generator, cfg, device=device)}
              for _ in range(cfg.n_layers)]
    out = {"layers": layers, "final_norm": ones(),
           "embed": embed_init(generator, (padded_vocab(cfg), D), cfg.pdtype,
                               device=device)}
    if not cfg.tie_embeddings:
        out["head"] = dense_init(generator, (D, padded_vocab(cfg)), cfg.pdtype,
                                 device=device)
    return out


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> LM:
    """A freshly initialised :class:`LM` on ``device``, drawn from a
    ``torch.Generator`` seeded with ``seed`` (on the device itself, so a
    full-size model is drawn where it lives)."""
    from ..devices import resolve_device

    _check_family(cfg)
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    with torch.no_grad():
        return LM(cfg, _tensors(cfg, gen, device))


def params_from_reference(tree: dict, cfg: ModelConfig, device=None) -> LM:
    """The reference's ``lm.init_params`` tree (nested dicts of numpy
    arrays, the ``groups`` leaves stacked on a leading G axis) as an
    :class:`LM` on ``device``; the values are copied, never re-drawn."""
    from ..devices import resolve_device

    _check_family(cfg)
    device = resolve_device(device)

    def t(a, g=None):
        a = a if g is None else a[g]
        return torch.tensor(a, device=device).to(cfg.pdtype)

    groups = tree["groups"]
    layers = [{"ln1": t(groups["ln1"], g), "ln2": t(groups["ln2"], g),
               "attn": {k: t(a, g) for k, a in groups["attn"].items()},
               "mlp": {k: t(a, g) for k, a in groups["mlp"].items()}}
              for g in range(cfg.n_groups)]
    tensors = {"layers": layers, "final_norm": t(tree["final_norm"]),
               "embed": t(tree["embed"])}
    if "head" in tree:
        tensors["head"] = t(tree["head"])
    with torch.no_grad():
        return LM(cfg, tensors)


def reference_path(name: str) -> tuple:
    """The reference tree path of a port parameter name, with the group
    index of a layer leaf last: ``layers.3.attn.wq`` → ``('groups',
    'attn', 'wq', 3)``."""
    parts = name.split(".")
    if parts[0] != "layers":
        return tuple(parts)
    return ("groups", *parts[2:], int(parts[1]))


def decayed(name: str, p: torch.Tensor) -> bool:
    """Whether the reference's AdamW decays this leaf.  It decays leaves
    with ``ndim >= 2`` of its stacked tree, and every layer leaf is stacked
    on the group axis: so the per-layer norms (``ln1``, ``ln2``,
    ``q_norm``, ``k_norm``) are decayed and ``final_norm`` is not."""
    return p.dim() + (1 if name.startswith("layers.") else 0) >= 2


# ---------------------------------------------------------------------------
# forward / loss
# ---------------------------------------------------------------------------


def forward(model: LM, cfg: ModelConfig, ax: Axes | None, batch: dict,
            cache=None):
    """Returns ``(logits [B,T,Vp], aux_loss, None)`` (train/prefill only)."""
    if cache is not None:
        raise NotImplementedError(
            "decode caches are not ported yet (ROADMAP Queue 1, item 14)")
    logits = model(batch["tokens"], ax or NO_SHARD)
    return logits, torch.zeros((), dtype=torch.float32, device=logits.device), None


def _chunk_stats(lg, lb, vocab: int):
    lf = lg.float()
    iota = torch.arange(lf.shape[-1], device=lf.device)
    if lf.shape[-1] != vocab:  # mask vocab padding out of the softmax
        lf = torch.where(iota < vocab, lf, -1e30)
    lse = torch.logsumexp(lf, dim=-1)
    # the label's logit by an iota compare, not a gather: no scatter in
    # the backward, so it runs under deterministic mode on the card
    pick = torch.where(iota == lb[..., None], lf, 0.0).sum(-1)
    mask = (lb >= 0).float()
    return torch.stack([((lse - pick) * mask).sum(),
                        (lse.square() * mask).sum(), mask.sum()])


def loss_fn(logits, labels, cfg: ModelConfig, aux=0.0, z_loss: float = 1e-4,
            aux_weight: float = 1e-2, chunk: int = 512):
    """Cross-entropy with the label picked by an iota compare, z-loss and
    MoE aux loss; ``labels < 0`` are masked out.  Computed in sequence
    chunks, each recomputed in the backward, so the f32 view of the logits
    exists for one ``[B, chunk, V]`` slice at a time.  Returns
    ``(loss, ce)``."""
    B, S, Vp = logits.shape
    c = min(chunk, S)
    if S % c:
        c = S  # odd lengths: single chunk
    recompute = torch.is_grad_enabled() and logits.requires_grad
    stats = []
    for lg, lb in zip(logits.split(c, dim=1), labels.split(c, dim=1)):
        if recompute:
            stats.append(checkpoint(_chunk_stats, lg, lb, cfg.vocab_size,
                                    use_reentrant=False))
        else:
            stats.append(_chunk_stats(lg, lb, cfg.vocab_size))
    ce_sum, zl_sum, n = torch.stack(stats).sum(dim=0)
    n = torch.clamp_min(n, 1.0)
    ce = ce_sum / n
    zl = zl_sum / n
    return ce + z_loss * zl + aux_weight * aux, ce


# ---------------------------------------------------------------------------
# parameter counting
# ---------------------------------------------------------------------------


def count_params(cfg: ModelConfig, active_only: bool = False) -> int:
    """Total parameters of the dense family, from the shapes alone."""
    _check_family(cfg)
    D, F, hd = cfg.d_model, cfg.d_ff, cfg.hd
    attn = D * cfg.n_heads * hd * 2 + D * cfg.n_kv_heads * hd * 2
    if cfg.qk_norm:
        attn += 2 * hd
    layer = 2 * D + attn + 3 * D * F
    Vp = padded_vocab(cfg)
    total = cfg.n_layers * layer + D + Vp * D
    if not cfg.tie_embeddings:
        total += D * Vp
    return int(total)


__all__ = ["LM", "count_params", "decayed", "forward", "init_params",
           "loss_fn", "padded_vocab", "params_from_reference"]

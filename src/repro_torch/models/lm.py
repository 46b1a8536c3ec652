"""The language model of the dense and ssm families, for training.

Port of :mod:`repro.models.lm` (``padded_vocab``, ``init_params``, the
dense and ssm group bodies, ``forward`` without a cache, ``loss_fn``,
``count_params``).  The reference stacks each parameter of a scan group on
a leading group axis and scans over it; here the parameters live in an
``nn.Module`` (:class:`LM`) with one submodule per group, and
``cfg.remat`` becomes ``torch.utils.checkpoint`` per group
(``use_reentrant=False``: backward recomputes the group, saving only its
input — the reference's ``nothing_saveable`` policy per group body).  A
dense group is one layer (attention, MLP); an ssm group (xLSTM) is
``slstm_every - 1`` mLSTM blocks and one sLSTM block
(:mod:`repro_torch.models.ssm`).  The other families (moe, vlm, hybrid,
audio) raise, naming their ROADMAP item.

Parameter names follow the reference's tree: ``embed``, ``head`` (untied
only), ``final_norm``, and ``layers.<g>.{ln1, ln2, attn.<w>, mlp.<w>}``
(dense) or ``layers.<g>.mlstm.<i>.<w>`` and ``layers.<g>.slstm.<w>``
(ssm) for ``groups/<...>[g]`` (``[g, i]`` for the mLSTM leaves, which the
reference stacks ``[G, slstm_every - 1, ...]``).
:func:`params_from_reference` converts the reference's ``init_params``
tree (nested dicts of numpy arrays) into them, and :func:`decayed` names
the leaves the reference's AdamW decays.

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
from . import ssm as SSM
from .config import ModelConfig
from .layers import NO_SHARD, Axes, dense_init, embed_init, rmsnorm

_PORTED = ("dense", "ssm")
_FAMILIES = {
    "moe": "the moe family is not ported yet (ROADMAP Queue 1, item 13)",
    "vlm": "the vlm family is not ported yet (ROADMAP Queue 1, item 14)",
    "hybrid": "the hybrid family is not ported yet (ROADMAP Queue 1, item "
              "13; slice 4)",
    "audio": "the audio family is not ported yet (ROADMAP Queue 1, item 14)",
}


def padded_vocab(cfg: ModelConfig) -> int:
    return -(-cfg.vocab_size // 128) * 128


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in _PORTED:
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


class ParamTree(nn.Module):
    """A nested dict of tensors as parameters and submodules, read back
    with ``p[name]`` as the reference reads its dicts."""

    def __init__(self, tree: dict):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, ParamTree(v))
            else:
                self.register_parameter(k, nn.Parameter(v))

    def __getitem__(self, name):
        return getattr(self, name)


class XLSTMGroup(nn.Module):
    """One ssm group: ``slstm_every - 1`` mLSTM blocks, then one sLSTM
    block (each carries its own residual)."""

    def __init__(self, p: dict):
        super().__init__()
        self.mlstm = nn.ModuleList(ParamTree(m) for m in p["mlstm"])
        self.slstm = ParamTree(p["slstm"])

    def forward(self, x, cfg: ModelConfig, ax: Axes, positions):
        for m in self.mlstm:
            x, _ = SSM.mlstm_apply(m, x, cfg, ax)
        x, _ = SSM.slstm_apply(self.slstm, x, cfg, ax)
        return x


_GROUP = {"dense": DenseBlock, "ssm": XLSTMGroup}


class LM(nn.Module):
    """The LM's parameters (see the module docstring for names)."""

    def __init__(self, cfg: ModelConfig, tensors: dict):
        super().__init__()
        _check_family(cfg)
        self.cfg = cfg
        self.embed = nn.Parameter(tensors["embed"])
        if not cfg.tie_embeddings:
            self.head = nn.Parameter(tensors["head"])
        self.final_norm = nn.Parameter(tensors["final_norm"])
        group = _GROUP[cfg.family]
        self.layers = nn.ModuleList(group(g) for g in tensors["layers"])

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


def _group_tensors(cfg: ModelConfig, generator: torch.Generator, device) -> dict:
    """The tensors of one group, drawn in the reference's order."""
    if cfg.family == "ssm":
        n_m = cfg.ssm.slstm_every - 1
        return {"mlstm": [SSM.mlstm_init(generator, cfg, device)
                          for _ in range(n_m)],
                "slstm": SSM.slstm_init(generator, cfg, device)}
    ones = lambda: torch.ones((cfg.d_model,), dtype=cfg.pdtype, device=device)  # noqa: E731
    return {"ln1": ones(), "attn": ATT.attn_init(generator, cfg, device),
            "ln2": ones(), "mlp": MOE.mlp_init(generator, cfg, device=device)}


def _tensors(cfg: ModelConfig, generator: torch.Generator, device) -> dict:
    D = cfg.d_model
    ones = lambda: torch.ones((D,), dtype=cfg.pdtype, device=device)  # noqa: E731
    layers = [_group_tensors(cfg, generator, device)
              for _ in range(cfg.n_groups)]
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

    def sub(node, g):  # the [g] slice of a (nested) stacked subtree
        if isinstance(node, dict):
            return {k: sub(a, g) for k, a in node.items()}
        return t(node, g)

    groups = tree["groups"]
    if cfg.family == "ssm":
        n_m = cfg.ssm.slstm_every - 1
        layers = [{"mlstm": [sub(groups["mlstm"], (g, i)) for i in range(n_m)],
                   "slstm": sub(groups["slstm"], g)}
                  for g in range(cfg.n_groups)]
    else:
        layers = [sub(groups, g) for g in range(cfg.n_groups)]
    tensors = {"layers": layers, "final_norm": t(tree["final_norm"]),
               "embed": t(tree["embed"])}
    if "head" in tree:
        tensors["head"] = t(tree["head"])
    with torch.no_grad():
        return LM(cfg, tensors)


def reference_path(name: str) -> tuple:
    """The reference tree path of a port parameter name, with the index of
    a layer leaf into its stacked array last: ``layers.3.attn.wq`` →
    ``('groups', 'attn', 'wq', 3)``, ``layers.1.mlstm.2.conv.w`` →
    ``('groups', 'mlstm', 'conv', 'w', (1, 2))``."""
    parts = name.split(".")
    if parts[0] != "layers":
        return tuple(parts)
    if parts[2] == "mlstm":
        return ("groups", "mlstm", *parts[4:], (int(parts[1]), int(parts[3])))
    return ("groups", *parts[2:], int(parts[1]))


def _stack_axes(name: str) -> int:
    """Leading axes the reference's stacked tree puts before this leaf:
    the group axis for a layer leaf, and the block axis too for mLSTM."""
    if not name.startswith("layers."):
        return 0
    return 2 if name.split(".")[2] == "mlstm" else 1


def decayed(name: str, p: torch.Tensor) -> bool:
    """Whether the reference's AdamW decays this leaf.  It decays leaves
    with ``ndim >= 2`` of its stacked tree, and every layer leaf is stacked
    on the group axis (mLSTM leaves on the block axis too): so the
    per-layer norms (``ln1``, ``ln2``, ``q_norm``, ``k_norm``, the mLSTM's
    ``norm``/``out_norm``, the sLSTM's ``norm``/``ffn_norm``) are decayed
    and ``final_norm`` is not."""
    return p.dim() + _stack_axes(name) >= 2


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


def _group_params(cfg: ModelConfig) -> int:
    D = cfg.d_model
    if cfg.family == "ssm":
        s, H = cfg.ssm, cfg.n_heads
        di = int(s.proj_factor * D)
        mlstm = (D + D * 2 * di + s.conv_kernel * di + 3 * di * di
                 + di * 2 * H + di + di * D)
        dh, ffd = D // H, max(1, int(4 / 3 * D))
        slstm = D + D * 4 * D + H * dh * 4 * dh + 2 * D * ffd + D
        return (s.slstm_every - 1) * mlstm + slstm
    F, hd = cfg.d_ff, cfg.hd
    attn = D * cfg.n_heads * hd * 2 + D * cfg.n_kv_heads * hd * 2
    if cfg.qk_norm:
        attn += 2 * hd
    return 2 * D + attn + 3 * D * F


def count_params(cfg: ModelConfig, active_only: bool = False) -> int:
    """Total parameters of the dense and ssm families, from the shapes
    alone."""
    _check_family(cfg)
    D = cfg.d_model
    Vp = padded_vocab(cfg)
    total = cfg.n_groups * _group_params(cfg) + D + Vp * D
    if not cfg.tie_embeddings:
        total += D * Vp
    return int(total)


__all__ = ["LM", "count_params", "decayed", "forward", "init_params",
           "loss_fn", "padded_vocab", "params_from_reference"]

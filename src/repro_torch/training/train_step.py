"""Training step builders — the two distribution modes the paper contrasts.

Port of :mod:`repro.training.train_step`.

``mode='xla'``: one replica over the global batch.  This is what the
reference's GSPMD program computes; on one card it needs no collective.

``mode='fmi'`` (the paper's technique): P data-parallel ranks simulated on
one device.  Rank r takes rows ``[r·B/P, (r+1)·B/P)`` of the global batch,
as the reference's ``shard_map`` splits it, and computes its own gradients
into row r of a stacked ``[P, ...]`` buffer.  The buffer is averaged by an
**explicit FMI collective** on the port's stacked ``sim`` channel —
``allreduce_tree`` with the configured algorithm, or the int8-compressed
ring allreduce (``compression='int8'``, the codec a Hopper kernel pair on
the card).  Loss and ce are averaged over ranks with recursive doubling.
Every rank then holds the same reduced gradients, so ``adamw_update`` runs
once on them.  ZeRO-1, the hierarchical (pod) reduction and the bucketed
schedule are not ported yet (ROADMAP Queue 1, items 15 and 4) and raise.

The parameters live in the model (:class:`repro_torch.models.lm.LM`); a
step computes the new values with the reference's functional AdamW and
copies them into the model's parameters.  ``microbatches > 1`` accumulates
loss and gradients over slices of each rank's batch before the sync.

>>> from repro_torch import configs
>>> from repro_torch.launch.mesh import make_host_mesh
>>> from repro_torch.models import lm
>>> cfg = configs.get_reduced("llama3.2-1b", n_layers=1, d_model=32, n_heads=2,
...                           n_kv_heads=1, d_ff=64, vocab_size=64, head_dim=16)
>>> tcfg = TrainConfig(mode="fmi", allreduce="ring")
>>> step, ax, _ = make_train_step(cfg, tcfg, make_host_mesh(2), device="cpu")
>>> model = lm.init_params(cfg, seed=0, device="cpu")
>>> opt = init_opt_state(cfg, tcfg, model)
>>> tokens = torch.randint(0, 64, (4, 17), generator=torch.Generator().manual_seed(0))
>>> model, opt, m = step(model, opt, {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]})
>>> sorted(m), bool(torch.isfinite(m["loss"])), int(opt["step"])
(['ce', 'grad_norm', 'loss', 'lr'], True, 1)
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..core import collectives as C
from ..core import compression as COMP
from ..core.communicator import Communicator
from ..devices import resolve_device
from ..models import lm
from ..models.config import ModelConfig
from ..models.layers import Axes
from ..optim.optimizer import OptConfig, adamw_init, adamw_update
from . import zero1


@dataclass(frozen=True)
class TrainConfig:
    mode: str = "xla"  # 'xla' | 'fmi'
    microbatches: int = 1
    optimizer: OptConfig = field(default_factory=OptConfig)
    # fmi-mode knobs
    allreduce: str = "auto"  # auto|ring|recursive_doubling|rabenseifner
    hierarchical: bool = False  # two-level (pod=DCN, data=ICI): not ported
    compression: str = "none"  # none | int8
    zero1: bool = False  # explicit ZeRO-1 over the data axis: not ported
    schedule: str = "blocking"  # 'blocking' ('bucketed' is not ported)


def _loss(model, cfg: ModelConfig, ax: Axes, batch):
    logits, aux, _ = lm.forward(model, cfg, ax, batch)
    return lm.loss_fn(logits, batch["labels"], cfg, aux)


def _grad_accum(model, cfg, ax, batch, microbatches: int):
    """Mean loss/ce/grads over ``microbatches`` slices of the batch's rows;
    ``grads`` is ``{name: tensor}`` in the model's parameter order."""
    names, params = zip(*model.named_parameters())

    def one(b):
        loss, ce = _loss(model, cfg, ax, b)
        grads = torch.autograd.grad(loss, params)
        return loss.detach(), ce.detach(), dict(zip(names, grads))

    if microbatches == 1:
        return one(batch)
    mb = batch["tokens"].shape[0] // microbatches
    loss_a = ce_a = torch.zeros((), device=params[0].device)
    g_a = {n: torch.zeros_like(p) for n, p in zip(names, params)}
    for i in range(microbatches):
        loss, ce, g = one({k: v[i * mb:(i + 1) * mb] for k, v in batch.items()})
        loss_a, ce_a = loss_a + loss, ce_a + ce
        g_a = {n: g_a[n] + g[n] for n in names}
        del g
    inv = 1.0 / microbatches
    return loss_a * inv, ce_a * inv, {n: g * inv for n, g in g_a.items()}


def _to_device(batch: dict, device) -> dict:
    return {k: (torch.as_tensor(np.asarray(v)) if not isinstance(v, torch.Tensor)
                else v).to(device) for k, v in batch.items()}


def _apply(model, opt_state, grads, tcfg: TrainConfig):
    """AdamW on the model's parameters with the reference's decay set; the
    new values are copied into the model."""
    params = dict(model.named_parameters())
    decay = {n: lm.decayed(n, p) for n, p in params.items()}
    new_p, new_opt, om = adamw_update(grads, opt_state, params,
                                      tcfg.optimizer, decay)
    del grads
    with torch.no_grad():
        for n, p in params.items():
            p.copy_(new_p.pop(n))
    return new_opt, om


def init_opt_state(cfg: ModelConfig, tcfg: TrainConfig, model) -> dict:
    return adamw_init(dict(model.named_parameters()), tcfg.optimizer)


# ---------------------------------------------------------------------------
# xla mode
# ---------------------------------------------------------------------------


def make_train_step_xla(cfg: ModelConfig, tcfg: TrainConfig, mesh,
                        multi_pod: bool = False, global_batch: int | None = None,
                        device=None):
    """One replica over the global batch.  Returns ``(step, ax, None)``;
    ``step(model, opt_state, batch) -> (model, opt_state, metrics)``."""
    from ..launch.policy import axes_for

    lm._check_family(cfg)
    ax = axes_for(cfg, mesh, multi_pod, "train", global_batch)
    device = resolve_device(device)

    def step(model, opt_state, batch):
        batch = _to_device(batch, device)
        loss, ce, grads = _grad_accum(model, cfg, ax, batch, tcfg.microbatches)
        new_opt, om = _apply(model, opt_state, grads, tcfg)
        return model, new_opt, {"loss": loss, "ce": ce, **om}

    return step, ax, None


# ---------------------------------------------------------------------------
# fmi mode
# ---------------------------------------------------------------------------


def make_train_step_fmi(cfg: ModelConfig, tcfg: TrainConfig, mesh,
                        multi_pod: bool = False, global_batch: int | None = None,
                        device=None):
    """P data-parallel ranks stacked on one device with explicit FMI
    gradient collectives.  Returns ``(step, ax, comm)``."""
    from ..launch.policy import plan

    lm._check_family(cfg)
    if tcfg.zero1:
        raise NotImplementedError(zero1._ZERO1)
    if tcfg.hierarchical or multi_pod:
        raise NotImplementedError("the hierarchical (pod) gradient reduction "
                                  "is not ported yet (ROADMAP Queue 1, item 15)")
    if tcfg.schedule != "blocking":
        raise NotImplementedError("schedule='bucketed' (CommScheduler) is not "
                                  "ported yet (ROADMAP Queue 1, item 4)")
    if tcfg.compression not in ("none", "int8"):
        raise ValueError(f"unknown compression {tcfg.compression!r}")
    sizes = mesh.sizes
    pol = plan(cfg, mesh, multi_pod, "train", global_batch=global_batch)
    if pol.model is not None:
        raise NotImplementedError(f"{cfg.name} trains tensor-parallel; TP "
                                  "training is not ported yet (ROADMAP Queue 1, "
                                  "item 15)")
    device = resolve_device(device)
    comm = Communicator(axes=pol.data, sizes=tuple(sizes[a] for a in pol.data),
                        channel="sim", device=str(device))
    P = comm.size
    ax_in = Axes(data=(), model=None, sizes=sizes)

    def reduce_grads(bufs: list) -> list:
        """Average the stacked ``[P, n]`` gradient buffers (one per dtype)."""
        if tcfg.compression == "int8":
            t = comm.transport()
            out = []
            for f in bufs:
                n = f.shape[1]
                pad = (-n) % (P * 256)
                f2 = torch.cat([f, f.new_zeros((P, pad))], dim=1) if pad else f
                r = COMP.compressed_ring_allreduce(t, f2.float(), op="add",
                                                   block=256, mean=True)
                out.append(r[:, :n].to(f.dtype))
            return out
        return C.allreduce_tree(bufs, comm, op="add", algorithm=tcfg.allreduce,
                                mean=True)

    def step(model, opt_state, batch):
        batch = _to_device(batch, device)
        B = batch["tokens"].shape[0]
        if B % P:
            raise ValueError(f"global batch {B} not divisible by {P} data ranks")
        rows = B // P
        # the stacked gradients are one [P, n] buffer per dtype, laid out as
        # the fused payload of the gradient sync, so it needs no copy
        lay = zero1.make_layout(dict(model.named_parameters()), 1)
        bufs = [torch.empty((P, n), dtype=dt, device=device)
                for dt, n in zip(lay.dtypes, lay.group_size)]
        stacked = zero1.unflatten_groups(bufs, lay, stacked=P)  # views
        losses = torch.empty((P, 1), dtype=torch.float32, device=device)
        ces = torch.empty((P, 1), dtype=torch.float32, device=device)
        for r in range(P):  # rank r's shard of the global batch
            shard = {k: v[r * rows:(r + 1) * rows] for k, v in batch.items()}
            loss, ce, grads = _grad_accum(model, cfg, ax_in, shard,
                                          tcfg.microbatches)
            for n, g in grads.items():
                stacked[n][r].copy_(g)
            del grads
            losses[r, 0], ces[r, 0] = loss, ce
        del stacked
        reduced = zero1.unflatten_groups(reduce_grads(bufs), lay, stacked=P)
        del bufs
        # every rank holds the same reduced gradients: row 0 is each rank's
        new_opt, om = _apply(model, opt_state,
                             {n: g[0] for n, g in reduced.items()}, tcfg)
        del reduced
        inv = 1.0 / P
        loss = C.allreduce(losses, comm, algorithm="recursive_doubling")[0, 0]
        ce = C.allreduce(ces, comm, algorithm="recursive_doubling")[0, 0]
        return model, new_opt, {"loss": loss * inv, "ce": ce * inv, **om}

    return step, Axes(data=pol.data, model=None, sizes=sizes), comm


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, mesh,
                    multi_pod: bool = False, global_batch: int | None = None,
                    device=None):
    if tcfg.mode == "xla":
        return make_train_step_xla(cfg, tcfg, mesh, multi_pod, global_batch,
                                   device)
    if tcfg.mode == "fmi":
        return make_train_step_fmi(cfg, tcfg, mesh, multi_pod, global_batch,
                                   device)
    raise ValueError(f"unknown mode {tcfg.mode!r}")

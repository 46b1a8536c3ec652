"""Per-architecture parallelism policy.

Port of :mod:`repro.launch.policy` (``plan``, ``axes_for``): small dense
and recurrent models train **pure data-parallel** (the batch over every
mesh axis); only the archs of :data:`TP_TRAIN` keep tensor/expert
parallelism for training.  The port's mesh is a record of axis sizes
(:mod:`repro_torch.launch.mesh`); tensor-parallel training is not ported
yet, so the train step raises for an arch whose plan has a model axis.

>>> from repro_torch import configs
>>> from repro_torch.launch.mesh import make_host_mesh
>>> plan(configs.get("llama3.2-1b"), make_host_mesh(2), False)
Parallelism(data=('data', 'model'), model=None, fsdp=('data', 'model'), seq=None)
"""

from __future__ import annotations

from dataclasses import dataclass

from ..models.config import ModelConfig
from ..models.layers import Axes

# archs that keep tensor/expert parallelism for TRAINING (the reference's
# list): only where weights/optimizer cannot live replicated over 'model'
TP_TRAIN = {
    "llama-3.2-vision-90b",
    "deepseek-v2-236b",
    "llama4-maverick-400b-a17b",
}


@dataclass(frozen=True)
class Parallelism:
    data: tuple  # batch axes
    model: str | None  # TP/EP axis (None = pure DP)
    fsdp: tuple  # weight-sharding axes
    seq: str | None = None  # sequence-parallel axis for residual activations


def plan(cfg: ModelConfig, mesh, multi_pod: bool, kind: str = "train",
         global_batch: int | None = None) -> Parallelism:
    sizes = mesh.sizes
    if kind == "train":
        tp = cfg.name in TP_TRAIN
    else:
        tp = cfg.family in ("dense", "moe", "vlm")
    pod = ("pod",) if multi_pod else ()

    if tp:
        data = pod + ("data",)
        model = "model"
        fsdp = ("data",)
        seq = "model" if kind == "train" else None
    else:
        data = pod + ("data", "model")
        model = None
        fsdp = ("data", "model")
        seq = None

    if global_batch is not None:
        # shrink batch axes (drop rightmost) until the product divides B
        while data and global_batch % _prod(sizes, data) != 0:
            data = data[:-1]
    return Parallelism(data=data, model=model, fsdp=fsdp, seq=seq)


def _prod(sizes: dict, axes: tuple) -> int:
    out = 1
    for a in axes:
        out *= sizes.get(a, 1)
    return out


def axes_for(cfg: ModelConfig, mesh, multi_pod: bool, kind: str = "train",
             global_batch: int | None = None) -> Axes:
    p = plan(cfg, mesh, multi_pod, kind, global_batch)
    return Axes(data=p.data, model=p.model, sizes=mesh.sizes)

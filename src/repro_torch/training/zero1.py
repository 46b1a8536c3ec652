"""Flat per-dtype layout of a parameter dict.

Port of the layout helpers of :mod:`repro.training.zero1`
(``make_layout``, ``flatten_groups``, ``unflatten_groups``), which the
int8-compressed gradient sync uses to fuse every leaf of one dtype into
one flat payload.  ZeRO-1 itself (``zero1_init``/``zero1_update``: reduce-
scatter, sharded AdamW, allgather) is not ported yet (ROADMAP Queue 1,
item 15).

``stacked=P`` flattens leaves that carry a leading rank axis ``[P, ...]``
(the stacked software channel's convention) into ``[P, n]`` payloads.

>>> import torch
>>> tree = {"w": torch.ones((2, 3)), "b": torch.zeros(3)}
>>> lay = make_layout(tree, 4)
>>> lay.group_size, [f.tolist() for f in flatten_groups(tree, lay)]
((12,), [[1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0]])
>>> {k: tuple(v.shape) for k, v in unflatten_groups(flatten_groups(tree, lay), lay).items()}
{'w': (2, 3), 'b': (3,)}
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

_ZERO1 = "ZeRO-1 is not ported yet (ROADMAP Queue 1, item 15)"


@dataclass(frozen=True)
class FlatLayout:
    """Static description of the per-dtype flattening of a dict."""

    names: tuple  # leaf names, in order
    dtypes: tuple  # group dtypes, in order
    group_leaf_idx: tuple  # tuple of tuples: leaf indices per group
    group_size: tuple  # padded flat length per group
    leaf_shapes: tuple
    leaf_sizes: tuple


def make_layout(tree: dict, P: int) -> FlatLayout:
    names = tuple(tree)
    leaves = [tree[n] for n in names]
    groups: dict = {}
    for i, leaf in enumerate(leaves):
        groups.setdefault(leaf.dtype, []).append(i)
    dtypes, gidx, gsize = [], [], []
    for dt, idxs in groups.items():
        n = sum(math.prod(leaves[i].shape) for i in idxs)
        pad = (-n) % P
        dtypes.append(dt)
        gidx.append(tuple(idxs))
        gsize.append(n + pad)
    return FlatLayout(
        names=names,
        dtypes=tuple(dtypes),
        group_leaf_idx=tuple(gidx),
        group_size=tuple(gsize),
        leaf_shapes=tuple(tuple(l.shape) for l in leaves),
        leaf_sizes=tuple(math.prod(l.shape) for l in leaves),
    )


def flatten_groups(tree: dict, layout: FlatLayout, stacked: int = 0) -> list:
    lead = (stacked,) if stacked else ()
    out = []
    for dt, idxs, size in zip(layout.dtypes, layout.group_leaf_idx,
                              layout.group_size):
        parts = [tree[layout.names[i]].reshape(lead + (-1,)).to(dt)
                 for i in idxs]
        n = sum(layout.leaf_sizes[i] for i in idxs)
        if size - n:
            parts.append(parts[0].new_zeros(lead + (size - n,)))
        out.append(torch.cat(parts, dim=-1))
    return out


def unflatten_groups(flats: list, layout: FlatLayout, stacked: int = 0) -> dict:
    lead = (stacked,) if stacked else ()
    leaves: list = [None] * len(layout.leaf_shapes)
    for flat, idxs in zip(flats, layout.group_leaf_idx):
        off = 0
        for i in idxs:
            n = layout.leaf_sizes[i]
            leaves[i] = flat[..., off:off + n].reshape(
                lead + layout.leaf_shapes[i])
            off += n
    return dict(zip(layout.names, leaves))


def zero1_init(*args, **kwargs):
    raise NotImplementedError(_ZERO1)


def zero1_update(*args, **kwargs):
    raise NotImplementedError(_ZERO1)

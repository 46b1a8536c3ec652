"""The host "mesh" of the port.

Port of :mod:`repro.launch.mesh` (``make_host_mesh``).  The reference
builds a JAX device mesh; the port simulates its ranks stacked on one card,
so its mesh is a record of axis sizes, ``{"data": P, "model": 1}``, that
the policy and the train step read.

>>> mesh = make_host_mesh(4)
>>> mesh.axis_names, mesh.shape, mesh.sizes
(('data', 'model'), (4, 1), {'data': 4, 'model': 1})
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class HostMesh:
    """Named axis sizes of ranks simulated on one device."""

    axis_names: tuple
    shape: tuple

    @property
    def sizes(self) -> dict:
        return dict(zip(self.axis_names, self.shape))


def make_host_mesh(data: int = 1, model: int = 1) -> HostMesh:
    """A ``(data, model)`` mesh of ranks stacked on one device."""
    if data < 1 or model < 1:
        raise ValueError(f"mesh axes must be >= 1, got data={data} model={model}")
    return HostMesh(("data", "model"), (int(data), int(model)))

"""FMI core on PyTorch: communicators, channels, collective algorithms,
cost models (port of :mod:`repro.core`).

    from repro_torch.core import Communicator

    comm = Communicator(axes=("data",), sizes=(4,), channel="sim",
                        device="cuda")
    y = comm.allreduce(x)          # x: stacked [4, ...] tensor
"""

from . import (
    algorithms,
    channels,
    collectives,
    hierarchical,
    models,
    pricing,
    requests,
    selector,
)
from .channels import Channel, get_channel, register_channel
from .communicator import Communicator
from .requests import Request, RequestQueue, waitall
from .transport import ChannelTrace, SimTransport, TransportRequest

__all__ = [
    "Communicator",
    "Channel",
    "get_channel",
    "register_channel",
    "SimTransport",
    "ChannelTrace",
    "TransportRequest",
    "Request",
    "RequestQueue",
    "waitall",
    "algorithms",
    "channels",
    "collectives",
    "hierarchical",
    "models",
    "pricing",
    "requests",
    "selector",
]

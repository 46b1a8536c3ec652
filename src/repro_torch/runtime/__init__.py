"""Elastic fault-tolerant runtime: membership timers and the elastic
controller (detect → quiesce → regroup → reshard → resume); port of
:mod:`repro.runtime`.  The straggler policy is not ported yet."""

from .elastic import ElasticController, pow2_floor
from .membership import GroupError, Membership

__all__ = [
    "Membership",
    "GroupError",
    "ElasticController",
    "pow2_floor",
]

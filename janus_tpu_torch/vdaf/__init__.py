"""Prio3 VDAF composition (CPU oracle), instance registry, ping-pong
topology and the CUDA prepare backend."""

from .prio3 import (
    Prio3,
    Prio3InputShare,
    Prio3PrepareShare,
    Prio3PrepareState,
    VdafError,
)
from .instances import (
    VDAF_INSTANCES,
    prio3_count,
    prio3_histogram,
    prio3_sum,
    prio3_sum_vec,
    vdaf_from_instance,
)

__all__ = [
    "Prio3",
    "Prio3InputShare",
    "Prio3PrepareShare",
    "Prio3PrepareState",
    "VdafError",
    "VDAF_INSTANCES",
    "prio3_count",
    "prio3_histogram",
    "prio3_sum",
    "prio3_sum_vec",
    "vdaf_from_instance",
]

"""Evaluation metrics and phase timing."""

from .metrics import (  # noqa: F401
    average_z_distance,
    compute_v2,
    point_mesh_distance,
)
from .timers import PhaseTimer, trace  # noqa: F401

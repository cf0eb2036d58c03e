"""Evaluation metrics."""

from .metrics import compute_v2, point_mesh_distance  # noqa: F401

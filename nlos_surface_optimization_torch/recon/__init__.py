"""Initialization: LCT (light-cone transform) reconstruction."""

from .lct import init_mesh_from_lct, lct_reconstruct  # noqa: F401

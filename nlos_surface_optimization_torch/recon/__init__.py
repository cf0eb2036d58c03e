"""Initialization: LCT (light-cone transform) reconstruction and space
carving."""

from .carving import (  # noqa: F401
    carve_mesh,
    space_carve_occupancy,
    space_carving_projection,
)
from .lct import init_mesh_from_lct, lct_reconstruct  # noqa: F401

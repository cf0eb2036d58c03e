"""Mesh and measurement I/O (numpy + scipy)."""

from .mat import (  # noqa: F401
    load_checkpoint,
    load_jitter_calibration,
    load_transient_shards,
    save_checkpoint,
)
from .obj import read_obj, write_obj  # noqa: F401

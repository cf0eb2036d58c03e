"""Mesh and measurement I/O (numpy + scipy)."""

from .mat import load_checkpoint, load_transient_shards, save_checkpoint  # noqa: F401
from .obj import read_obj, write_obj  # noqa: F401

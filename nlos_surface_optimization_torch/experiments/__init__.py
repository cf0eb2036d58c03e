"""Experiments: scene registry, GT generation, end-to-end runs."""

from .create_gt import create_gt  # noqa: F401
from .run import run_experiment  # noqa: F401
from .scenes import SCENES, SceneSpec  # noqa: F401

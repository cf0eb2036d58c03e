"""SPAD sensor simulation."""

from .spad import SpadParams, spad_model, spad_noisy_transients  # noqa: F401

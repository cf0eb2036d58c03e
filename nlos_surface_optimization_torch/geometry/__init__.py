"""Mesh containers, sampling, visibility and host-side topology."""

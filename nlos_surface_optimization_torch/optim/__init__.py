"""Optimizer and losses."""

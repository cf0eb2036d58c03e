"""Carry state across from the JAX package as numpy arrays.

Each function takes what the JAX side holds (a mesh's arrays, the words of
``jax.random.key_data(key)``, a RenderConfig's fields, a checkpoint's
``opt_step``/``opt_m``/``opt_v``) so both packages can run on the same
mesh, key and optimizer state.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config import RenderConfig
from .geometry.mesh import Mesh
from .geometry.sampling import key_from_data  # noqa: F401  (re-export)
from .optim.adam_modified import AdamModifiedState


def mesh_from_numpy(v, f, f_valid, vn, albedo, device="cuda") -> Mesh:
    """Mesh from the five padded arrays of a JAX-side Mesh."""
    def dev(x, dtype):
        return torch.as_tensor(np.array(x), dtype=dtype).to(device)

    return Mesh(v=dev(v, torch.float32), f=dev(f, torch.int64),
                f_valid=dev(f_valid, torch.bool),
                vn=dev(vn, torch.float32), albedo=dev(albedo, torch.float32))


def config_from_fields(fields: dict) -> RenderConfig:
    """RenderConfig from a field dict (e.g. ``dataclasses.asdict`` of the
    JAX package's config); unknown fields raise."""
    known = {f.name for f in dataclasses.fields(RenderConfig)}
    unknown = set(fields) - known
    if unknown:
        raise ValueError(f"unknown RenderConfig fields {sorted(unknown)}")
    return RenderConfig(**fields)


def adam_state_from_numpy(step, m, v, device="cuda") -> AdamModifiedState:
    """Optimizer state from a checkpoint's opt_step / opt_m / opt_v."""
    return AdamModifiedState(
        step=int(np.asarray(step).ravel()[0]),
        m=torch.as_tensor(np.array(m, np.float32).reshape(-1, 3)).to(device),
        v=torch.as_tensor(np.array(v, np.float32).reshape(-1, 3)).to(device))

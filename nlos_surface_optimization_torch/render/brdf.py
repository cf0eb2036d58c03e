"""Confocal GGX (Trowbridge-Reitz) microfacet BRDF and its derivatives.

On c = dot(normal, w), w the direction back to the source:
  eval  = D * G1^2 / 4
  D     = 1 / (pi a^2 ((1 + (1-c^2)/(a^2 c^2)) c^2)^2)
  G1    = 2 / (c + sqrt(a^2 + (1-a^2) c^2))
with closed-form derivatives with respect to alpha (``eval_adiff``) and to
c (``eval_cdiff``; the derivatives with respect to the normal and to w are
``eval_cdiff * w`` and ``eval_cdiff * normal``).

Branch-free, with the JAX package's guards (1e-30 floors, D*c < 1e-20 is
zero, the c >= 1 | c <= -1 cases).  ``alpha`` is a 0-dim tensor on c's
device in c's dtype: the products of alpha with itself are then rounded
as the JAX package rounds them for ``jnp.float32(alpha)``.
"""

from __future__ import annotations

import math

import torch

from ..geometry.mesh import sqrt_rn

_PI = math.pi


def _D(alpha, c):
    c2 = c * c
    a2 = alpha * alpha
    beck = (1.0 - c2) / torch.clamp(a2 * c2, min=1e-30)
    root = (1.0 + beck) * c2
    d = 1.0 / torch.clamp(_PI * a2 * root * root, min=1e-30)
    d = torch.where(d * c < 1e-20, 0.0, d)
    return torch.where(c > 0, d, 0.0)


def _G1(alpha, c):
    root = alpha * alpha + (1.0 - alpha * alpha) * c * c
    g = 2.0 / torch.clamp(c + sqrt_rn(torch.clamp(root, min=0.0)), min=1e-30)
    g = torch.where((c >= 1.0) | (c <= -1.0), 1.0, g)
    return torch.where(c > 0, g, 0.0)


def eval_scalar(alpha, c):
    """BRDF value given c = dot(normal, w): D*G1^2/4, 0 where c <= 0."""
    d = _D(alpha, c)
    g1 = _G1(alpha, c)
    val = d * g1 * g1 / 4.0
    return torch.where((c > 0) & (d > 0), val, 0.0)


def _D_adiff(alpha, c):
    c2 = c * c
    a2 = alpha * alpha
    val = a2 * c2 - c2 + 1.0
    out = -(2.0 * alpha * (a2 * c2 + c2 - 1.0)) / torch.clamp(
        _PI * val * val * val, min=1e-30)
    return torch.where(c > 0, out, 0.0)


def _G1_adiff(alpha, c):
    c2 = c * c
    val = sqrt_rn(torch.clamp(alpha * alpha - c2 * (alpha * alpha - 1.0),
                              min=1e-30))
    root = c + val
    out = 2.0 * alpha * (c2 - 1.0) / torch.clamp(val * root * root, min=1e-30)
    out = torch.where((c >= 1.0) | (c <= -1.0), 0.0, out)
    return torch.where(c > 0, out, 0.0)


def eval_adiff(alpha, c):
    """d(eval)/d(alpha)."""
    d = _D(alpha, c)
    g1 = _G1(alpha, c)
    dprime = _D_adiff(alpha, c)
    gprime = 2.0 * _G1_adiff(alpha, c) * g1
    out = (dprime * (g1 * g1) + gprime * d) / 4.0
    return torch.where((c > 0) & (d > 0), out, 0.0)


def _D_ndiff(alpha, c):
    c2 = c * c
    a2 = alpha * alpha
    root = (a2 - 1.0) * c2 + 1.0
    out = -(4.0 * a2 * c * (a2 - 1.0)) / torch.clamp(
        _PI * root * root * root, min=1e-30)
    return torch.where(c > 0, out, 0.0)


def _G1_ndiff(alpha, c):
    c2 = c * c
    a2 = alpha * alpha
    temp = sqrt_rn(torch.clamp(a2 - c2 * (a2 - 1.0), min=1e-30))
    root = c + temp
    out = -2.0 * (1.0 - (c * (a2 - 1.0)) / temp) / torch.clamp(root * root,
                                                              min=1e-30)
    out = torch.where((c >= 1.0) | (c <= -1.0), 0.0, out)
    return torch.where(c > 0, out, 0.0)


def eval_cdiff(alpha, c):
    """d(eval)/dc, c = dot(n, w)."""
    d = _D(alpha, c)
    g1 = _G1(alpha, c)
    gprime = 2.0 * _G1_ndiff(alpha, c) * g1
    dprime = _D_ndiff(alpha, c)
    out = (dprime * (g1 * g1) + gprime * d) / 4.0
    return torch.where((c > 0) & (d > 0), out, 0.0)

"""Component-SoA 3-vector math (counterpart of ``raytpu/ops/vec3.py``).

A ``Vec3`` is a tuple of three same-shape tensors (x, y, z); every helper
applies the JAX version's operations in the same order, so results agree to
the rounding of each op.
"""

from __future__ import annotations

from typing import Tuple

import torch

Vec3 = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def vec3(x, y, z) -> Vec3:
    return (x, y, z)


def splat(v, like: torch.Tensor) -> Vec3:
    """Broadcast a length-3 constant against a reference tensor."""
    return tuple(torch.full_like(like, float(c)) for c in v)


def from_array(a: torch.Tensor) -> Vec3:
    """(..., 3) -> components."""
    return (a[..., 0], a[..., 1], a[..., 2])


def to_array(v: Vec3) -> torch.Tensor:
    """Components -> (..., 3)."""
    return torch.stack(v, dim=-1)


def add(a: Vec3, b: Vec3) -> Vec3:
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def sub(a: Vec3, b: Vec3) -> Vec3:
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def scale(s, a: Vec3) -> Vec3:
    return (s * a[0], s * a[1], s * a[2])


def mul(a: Vec3, b: Vec3) -> Vec3:
    return (a[0] * b[0], a[1] * b[1], a[2] * b[2])


def neg(a: Vec3) -> Vec3:
    return (-a[0], -a[1], -a[2])


def dot(a: Vec3, b: Vec3) -> torch.Tensor:
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def cross(a: Vec3, b: Vec3) -> Vec3:
    return (
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    )


def norm(a: Vec3) -> torch.Tensor:
    return torch.sqrt(torch.clamp_min(dot(a, a), 0.0))


def normalize(a: Vec3, eps: float = 1e-30) -> Vec3:
    inv = 1.0 / torch.clamp_min(norm(a), eps)
    return scale(inv, a)


def where(mask: torch.Tensor, a: Vec3, b: Vec3) -> Vec3:
    return (
        torch.where(mask, a[0], b[0]),
        torch.where(mask, a[1], b[1]),
        torch.where(mask, a[2], b[2]),
    )


def affine_rows(m, p: Vec3) -> Vec3:
    """Apply a (3, 4) affine (point transform) row by row."""
    return (
        m[0][0] * p[0] + m[0][1] * p[1] + m[0][2] * p[2] + m[0][3],
        m[1][0] * p[0] + m[1][1] * p[1] + m[1][2] * p[2] + m[1][3],
        m[2][0] * p[0] + m[2][1] * p[1] + m[2][2] * p[2] + m[2][3],
    )


def linear_rows(m, v: Vec3) -> Vec3:
    """Linear part only (direction transform)."""
    return (
        m[0][0] * v[0] + m[0][1] * v[1] + m[0][2] * v[2],
        m[1][0] * v[0] + m[1][1] * v[1] + m[1][2] * v[2],
        m[2][0] * v[0] + m[2][1] * v[1] + m[2][2] * v[2],
    )


def linear_cols(m, v: Vec3) -> Vec3:
    """Row vector x matrix, ``v . M`` (the inverse-transpose normal
    transform when M is the world -> object linear part)."""
    return (
        m[0][0] * v[0] + m[1][0] * v[1] + m[2][0] * v[2],
        m[0][1] * v[0] + m[1][1] * v[1] + m[2][1] * v[2],
        m[0][2] * v[0] + m[1][2] * v[1] + m[2][2] * v[2],
    )

"""Component-SoA 3-vector math: a Vec3 is a tuple of three (N,) arrays.

Why not (N, 3)? Keeping each component a separate dense (N,) array gives
every elementwise kernel unit-stride, coalesced loads and stores without
relying on the layout assigner, and matches the Pallas kernel's SoA
operands exactly.

All functions broadcast over any common shape; "scalars" may be Python
floats or () arrays.
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp

Vec3 = Tuple  # (x, y, z) of same-shape arrays


def vec3(x, y, z) -> Vec3:
    return (x, y, z)


def splat(v, like) -> Vec3:
    """Constant 3-vector broadcast to the shape of ``like`` (an array)."""
    return tuple(jnp.full_like(like, c) for c in v)


def from_rows(a) -> Vec3:
    """(..., 3) array -> Vec3 of (...,) components."""
    return (a[..., 0], a[..., 1], a[..., 2])


def to_rows(v: Vec3):
    """Vec3 -> (..., 3) array (use only at pipeline boundaries)."""
    return jnp.stack(v, axis=-1)


def add(a: Vec3, b: Vec3) -> Vec3:
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def sub(a: Vec3, b: Vec3) -> Vec3:
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def mul(a: Vec3, b: Vec3) -> Vec3:
    return (a[0] * b[0], a[1] * b[1], a[2] * b[2])


def scale(a: Vec3, s) -> Vec3:
    return (a[0] * s, a[1] * s, a[2] * s)


def dot(a: Vec3, b: Vec3):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def cross(a: Vec3, b: Vec3) -> Vec3:
    return (a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def normalize(a: Vec3, eps: float = 1e-20) -> Vec3:
    inv = 1.0 / jnp.sqrt(jnp.maximum(dot(a, a), eps))
    return scale(a, inv)


def where(cond, a: Vec3, b: Vec3) -> Vec3:
    """Per-component select with a (N,) boolean (no trailing-dim broadcast)."""
    return (jnp.where(cond, a[0], b[0]),
            jnp.where(cond, a[1], b[1]),
            jnp.where(cond, a[2], b[2]))


def reflect(d: Vec3, n: Vec3) -> Vec3:
    """Mirror direction d about unit normal n (HLSL reflect)."""
    k = 2.0 * dot(d, n)
    return (d[0] - k * n[0], d[1] - k * n[1], d[2] - k * n[2])


def sdot(x: Vec3, y: Vec3, f=1.0):
    """Scaled saturated dot (reference sdot, RayTraceShader.compute:84)."""
    return jnp.clip(dot(x, y) * f, 0.0, 1.0)


def gather_rows(table, idx) -> Vec3:
    """Per-component gather from a (T, 3) table -> Vec3 of (N,).

    Three 1-D gathers keep both operands and results in dense layouts (a
    single (T,3)->(N,3) gather is what pins buffers to the padded layout).
    """
    return (table[:, 0][idx], table[:, 1][idx], table[:, 2][idx])

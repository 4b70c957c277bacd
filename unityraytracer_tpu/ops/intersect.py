"""Vectorized intersection primitives (pure jnp).

These are the correctness-reference implementations of the reference's device
intersectors (`RayTraceShader.compute:156-291`), written as dense batched ops:
rays are component-SoA (Vec3 tuples of (R,) arrays; ops/vec.py) broadcast
against ``(P,)`` primitive SoA arrays, returning ``(R, P)`` (or ``(R,)``)
results that the caller reduces. The Pallas kernel (ops/gpu_trace.py)
reuses the same math on register tiles.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..utils.math3d import INF, EPSILON
from .vec import Vec3


def intersect_ground(ro: Vec3, rd: Vec3):
    """Infinite plane y=0 (reference IntersectGroundPlane, compute:156-172).

    Returns t: (R,), +INF on miss.
    """
    dy = rd[1]
    safe_dy = jnp.where(jnp.abs(dy) < 1e-20, 1e-20, dy)
    t = -ro[1] / safe_dy
    return jnp.where(t > 0, t, INF)


def intersect_spheres(ro: Vec3, rd: Vec3, center, radius):
    """Batched ray-sphere (reference IntersectSphere, compute:175-196).

    Args:
      ro, rd: Vec3 of (R,) origins / unit directions.
      center: (S, 3), radius: (S,).
    Returns:
      t: (R, S), +INF where no positive hit.
    """
    cx, cy, cz = center[:, 0], center[:, 1], center[:, 2]
    ocx = ro[0][:, None] - cx[None, :]                        # (R, S)
    ocy = ro[1][:, None] - cy[None, :]
    ocz = ro[2][:, None] - cz[None, :]
    p1 = -(rd[0][:, None] * ocx + rd[1][:, None] * ocy + rd[2][:, None] * ocz)
    p2sqr = p1 * p1 - (ocx * ocx + ocy * ocy + ocz * ocz) \
        + (radius * radius)[None, :]
    p2 = jnp.sqrt(jnp.maximum(p2sqr, 0.0))
    t_near = p1 - p2
    t = jnp.where(t_near > 0, t_near, p1 + p2)
    return jnp.where((p2sqr >= 0) & (t > 0), t, INF)


def intersect_triangles(ro: Vec3, rd: Vec3, v0, v1, v2):
    """Batched Moller-Trumbore with backface culling
    (reference IntersectTriangle_MT97, compute:199-234).

    Args:
      ro, rd: Vec3 of (R,); v0/v1/v2: (T, 3) world-space.
    Returns:
      t, u, v: (R, T); t = +INF on miss.
    """
    e1 = v1 - v0                                              # (T, 3)
    e2 = v2 - v0
    rdx, rdy, rdz = (c[:, None] for c in rd)                  # (R, 1)
    rox, roy, roz = (c[:, None] for c in ro)
    e1x, e1y, e1z = e1[:, 0][None], e1[:, 1][None], e1[:, 2][None]  # (1, T)
    e2x, e2y, e2z = e2[:, 0][None], e2[:, 1][None], e2[:, 2][None]
    v0x, v0y, v0z = v0[:, 0][None], v0[:, 1][None], v0[:, 2][None]
    # pvec = rd x e2 -> (R, T)
    px = rdy * e2z - rdz * e2y
    py = rdz * e2x - rdx * e2z
    pz = rdx * e2y - rdy * e2x
    det = e1x * px + e1y * py + e1z * pz
    front = det >= EPSILON                                    # backface cull
    inv_det = 1.0 / jnp.where(front, det, 1.0)
    tx = rox - v0x
    ty = roy - v0y
    tz = roz - v0z
    u = (tx * px + ty * py + tz * pz) * inv_det
    # qvec = tvec x e1
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (rdx * qx + rdy * qy + rdz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    valid = front & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) & (t > 0)
    return jnp.where(valid, t, INF), u, v


def intersect_aabb(ro: Vec3, inv_rd: Vec3, vmin, vmax):
    """Batched slab test (correct version of IntersectBVHNode, compute:271-291).

    Unlike the reference we cull against positive t (the reference returns hits
    behind the ray; SURVEY.md defect list says implement the correct test).

    Args:
      ro, inv_rd: Vec3 of (R,) (inv_rd = safe reciprocal directions).
      vmin, vmax: (B, 3).
    Returns:
      (hit, t_enter): ((R, B) bool, (R, B) float32 entry distance >= 0).
    """
    t_min = jnp.full((ro[0].shape[0], vmin.shape[0]), -INF)
    t_max = jnp.full((ro[0].shape[0], vmin.shape[0]), INF)
    for a in range(3):
        t1 = (vmin[:, a][None, :] - ro[a][:, None]) * inv_rd[a][:, None]
        t2 = (vmax[:, a][None, :] - ro[a][:, None]) * inv_rd[a][:, None]
        t_min = jnp.maximum(t_min, jnp.minimum(t1, t2))
        t_max = jnp.minimum(t_max, jnp.maximum(t1, t2))
    hit = (t_max >= t_min) & (t_max > 0)
    return hit, jnp.maximum(t_min, 0.0)


def safe_inv_dir(rd: Vec3) -> Vec3:
    """Reciprocal direction guarded against division by zero (the reference
    adds EPSILON to the raw direction, compute:282-283; we clamp magnitude)."""
    return tuple(
        1.0 / jnp.where(jnp.abs(d) < 1e-12, jnp.where(d < 0, -1e-12, 1e-12), d)
        for d in rd)

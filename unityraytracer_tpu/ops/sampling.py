"""Monte-Carlo sampling: tangent frames, power-cosine hemisphere, lens disk.

The reference uses a sequential per-pixel ``frac(sin(...))`` hash RNG
(`RayTraceShader.compute:77-81`) whose stream advances by side effect — not
reproducible in a vectorized rebuild (SURVEY.md defect #8). We use JAX's
counter-based threefry keys; the estimator (hemisphere pdfs, roulette
weights) matches the reference exactly, so converged images agree even
though individual sample streams differ.

Directions are component-SoA Vec3 tuples (see ops/vec.py for why).
"""

from __future__ import annotations

import jax.numpy as jnp

from .vec import Vec3

PI = 3.14159265


def tangent_frame(n: Vec3):
    """Orthonormal (tangent, binormal) for unit normals — branchless
    Frisvad/Pixar construction (~12 elementwise ops, no crosses, no
    normalizes, no selects).

    The reference builds its frame from a helper axis + two cross products
    (GetTangentSpace, RayTraceShader.compute:89-100). Any orthonormal frame
    gives the SAME sampling distribution here (the azimuth angle is uniform,
    so the lobe's law is invariant to the azimuthal reference); this cheaper
    construction only changes which concrete direction a given uniform maps
    to — Monte-Carlo stream, not estimator.
    """
    s = jnp.where(n[2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + n[2])
    b = n[0] * n[1] * a
    tangent = (1.0 + s * n[0] * n[0] * a, s * b, -s * n[0])
    binormal = (b, s + n[1] * n[1] * a, -n[1])
    return tangent, binormal


def sample_hemisphere(u1, u2, axis: Vec3, alpha) -> Vec3:
    """Power-cosine hemisphere sample about ``axis``.

    cos(theta) = u1^(1/(alpha+1)) (SampleHemisphere, compute:102-111):
    alpha=0 uniform, alpha=1 cosine, large alpha = tight Phong lobe. May dip
    below the surface for lobes around a reflection vector; the caller's sdot
    clamp zeroes those, as in the reference.
    """
    cos_t = jnp.power(jnp.maximum(u1, 1e-12), 1.0 / (alpha + 1.0))
    sin_t = jnp.sqrt(jnp.maximum(1.0 - cos_t * cos_t, 0.0))
    phi = 2.0 * PI * u2
    tangent, binormal = tangent_frame(axis)
    ca, sa = jnp.cos(phi) * sin_t, jnp.sin(phi) * sin_t
    return (tangent[0] * ca + binormal[0] * sa + axis[0] * cos_t,
            tangent[1] * ca + binormal[1] * sa + axis[1] * cos_t,
            tangent[2] * ca + binormal[2] * sa + axis[2] * cos_t)


def sample_unit_disk(u1, u2):
    """Polar disk sample for thin-lens DoF: returns (dx, dy) components."""
    r = jnp.sqrt(u1)
    phi = 2.0 * PI * u2
    return r * jnp.cos(phi), r * jnp.sin(phi)

"""Closest-hit tracers: scene -> per-ray Hit records.

``trace_brute`` is the dense correctness reference (the analog of the
reference's Trace, RayTraceShader.compute:364-383, with BVHs replaced by
exhaustive tests). Acceleration-structure tracers live in ``traverse.py``
(pure-jnp LBVH) and ``gpu_trace.py`` (Triton kernel); all take/return
component-SoA rays (Vec3 tuples; ops/vec.py) and the same Hit SoA so the
renderer swaps them freely.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..scene import Scene
from ..utils.math3d import INF
from . import vec
from .vec import Vec3
from .intersect import intersect_ground, intersect_spheres, intersect_triangles
from .shade import Hit


def map_chunked(fn, ray_args, chunk: int):
    """Apply ``fn(*ray_args)`` over rays in fixed-size chunks via lax.map.

    Bounds the peak memory of (rays x primitives) intermediates. ``ray_args``
    is a pytree of (N, ...) arrays; ``fn`` must be shape-polymorphic in the
    leading ray dim.
    """
    leaves = jax.tree_util.tree_leaves(ray_args)
    R = leaves[0].shape[0]
    if R <= chunk:
        return fn(*ray_args)
    pad = (-R) % chunk
    n_chunks = (R + pad) // chunk

    def pad_reshape(a):
        if pad:
            a = jnp.concatenate([a, jnp.zeros((pad,) + a.shape[1:], a.dtype)])
        return a.reshape(n_chunks, chunk, *a.shape[1:])

    stacked = jax.tree_util.tree_map(pad_reshape, ray_args)
    out = jax.lax.map(lambda xs: fn(*xs), stacked)
    return jax.tree_util.tree_map(
        lambda a: a.reshape(n_chunks * chunk, *a.shape[2:])[:R], out)


def _empty_candidate(shape_like):
    z = jnp.zeros_like(shape_like)
    zv = (z, z, z)
    return dict(t=jnp.full_like(shape_like, INF), normal=zv, albedo=zv,
                specular=zv, emission=zv, smoothness=z)


def _material_splat(scene: Scene, mid_scalar, like):
    """Broadcast one material row (scalar id) — no per-ray gather."""
    mats = scene.materials

    def row3(tab):
        r = jax.lax.dynamic_slice_in_dim(tab, mid_scalar, 1, axis=0)[0]
        return tuple(jnp.full_like(like, r[k]) for k in range(3))

    smooth = jax.lax.dynamic_slice_in_dim(mats.smoothness, mid_scalar, 1)[0]
    return dict(albedo=row3(mats.albedo), specular=row3(mats.specular),
                emission=row3(mats.emission),
                smoothness=jnp.full_like(like, smooth))


def _ground_candidate(scene: Scene, ro: Vec3, rd: Vec3):
    t = intersect_ground(ro, rd)
    # ground_enabled==0 disables the built-in plane.
    t = jnp.where(scene.ground_enabled > 0, t, INF)
    zeros = jnp.zeros_like(t)
    n = (zeros, jnp.ones_like(t), zeros)
    mat = _material_splat(scene, scene.ground_material_id.astype(jnp.int32), t)
    return dict(t=t, normal=n, **mat)


def _sphere_candidate(scene: Scene, ro: Vec3, rd: Vec3):
    """Closest sphere hit: a dense (R, S) test (the reference needs a sphere
    BVH for this, RayTraceShader.compute:329-361; at Scene1's S=8 the dense
    test is noise next to the triangle pass), then one gather per attribute
    of the winning sphere."""
    sp = scene.spheres
    if sp.count == 0:
        return _empty_candidate(ro[0])
    ts = intersect_spheres(ro, rd, sp.center, sp.radius)  # (R, S)
    t = jnp.min(ts, axis=1)
    best = jnp.argmin(ts, axis=1)
    pos = vec.add(ro, vec.scale(rd, t))
    n = vec.normalize(vec.sub(pos, vec.gather_rows(sp.center, best)))
    return dict(t=t, normal=n, **materials_for(scene, sp.material_id[best]))


def materials_for(scene: Scene, mid):
    """Per-ray material params by id gather."""
    mats = scene.materials
    return dict(albedo=vec.gather_rows(mats.albedo, mid),
                specular=vec.gather_rows(mats.specular, mid),
                emission=vec.gather_rows(mats.emission, mid),
                smoothness=mats.smoothness[mid])


def _triangle_candidate(scene: Scene, ro: Vec3, rd: Vec3):
    tr = scene.triangles
    if tr.count == 0:
        return _empty_candidate(ro[0])
    tt, u, v = intersect_triangles(ro, rd, tr.v0, tr.v1, tr.v2)  # (R, T)
    best = jnp.argmin(tt, axis=1)
    take = lambda a: jnp.take_along_axis(a, best[:, None], axis=1)[:, 0]
    t, bu, bv = take(tt), take(u), take(v)
    # Barycentric smooth-normal blend (compute:263), world space (defect #4 fixed).
    w = 1.0 - bu - bv
    n0 = vec.gather_rows(tr.n0, best)
    n1 = vec.gather_rows(tr.n1, best)
    n2 = vec.gather_rows(tr.n2, best)
    n = vec.add(vec.add(vec.scale(n0, w), vec.scale(n1, bu)), vec.scale(n2, bv))
    return dict(t=t, normal=vec.normalize(n),
                **materials_for(scene, tr.material_id[best]))


def fold_candidate(best, c):
    """One strict nearest-wins fold step over full-material candidate
    dicts (the left-fold unit of ``combine_candidates``)."""
    closer = c["t"] < best["t"]
    return dict(
        t=jnp.where(closer, c["t"], best["t"]),
        normal=vec.where(closer, c["normal"], best["normal"]),
        albedo=vec.where(closer, c["albedo"], best["albedo"]),
        specular=vec.where(closer, c["specular"], best["specular"]),
        emission=vec.where(closer, c["emission"], best["emission"]),
        smoothness=jnp.where(closer, c["smoothness"], best["smoothness"]),
    )


def combine_candidates(scene: Scene, ro: Vec3, rd: Vec3, candidates) -> Hit:
    """Nearest-wins merge of full-material candidates (gather-free).

    A sequential where-chain (no stacking) keeps every buffer a dense (N,)
    array.
    """
    best = candidates[0]
    for c in candidates[1:]:
        best = fold_candidate(best, c)
    bt = best["t"]
    pos = vec.add(ro, vec.scale(rd, bt))
    return Hit(t=bt, position=pos, normal=best["normal"],
               albedo=best["albedo"], specular=best["specular"],
               emission=best["emission"], smoothness=best["smoothness"])


def trace_brute(scene: Scene, ro: Vec3, rd: Vec3, alive=None,
                chunk: int = 8192) -> Hit:
    """Exhaustive closest-hit over ground + spheres + triangles.

    ``alive`` is accepted for tracer-interface parity (the Pallas tracer
    skips dead rays); the dense oracle ignores it.
    """
    del alive

    def body(rox, roy, roz, rdx, rdy, rdz):
        ro_c = (rox, roy, roz)
        rd_c = (rdx, rdy, rdz)
        cands = [
            _ground_candidate(scene, ro_c, rd_c),
            _sphere_candidate(scene, ro_c, rd_c),
            _triangle_candidate(scene, ro_c, rd_c),
        ]
        return combine_candidates(scene, ro_c, rd_c, cands)

    return map_chunked(body, (*ro, *rd), chunk)


def make_brute_tracer(scene: Scene, chunk: int = 8192):
    return functools.partial(trace_brute, scene, chunk=chunk)

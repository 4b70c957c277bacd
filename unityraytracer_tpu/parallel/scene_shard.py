"""Cross-device SCENE sharding: each device holds 1/n of the triangles.

The rows/spp modes in ``sharding.py`` REPLICATE the scene — fine until one
device's memory can't hold the acceleration structure. This module is the
renderer's tensor-parallel analog (the "long-context" axis of SURVEY.md §5):

* **Host prep** (``shard_scene_accels``): triangles are pre-sorted by the
  Morton code of their centroid (so each shard is a spatially compact slab,
  keeping per-shard culling effective), split into ``n`` equal chunks
  (padded with far-away degenerate triangles that can never hit — det == 0
  is rejected by MT97, and their AABBs sit at 1e7 so no culling test ever
  admits them), and one equal-shape ``ClusterAccel`` is built per chunk.
  The per-chunk accels are stacked leaf-wise; ``jax.device_put`` with a
  ``P(AXIS)`` sharding then scatters shard k to device k — per-device accel
  memory scales 1/n with the mesh. Every accelerated tracer (the Triton
  kernel included) walks its device's chunk.

* **Device combine** (``allreduce_hit``): every device traces ALL rays
  against its sub-scene (plus the tiny replicated sphere/ground
  candidates — idempotent under min), then ONE packed all-reduce picks the
  global closest hit: ``pmin`` over t, a ``pmin`` tie-break on the device
  index, and a single stacked ``psum`` that selects the winner's 16
  attribute rows. Communication is O(rows x rays) per bounce over the
  device links — the price of scene parallelism, exactly like
  tensor-parallel matmul all-reduces.

Shading stays replicated (identical RNG streams on every device make every
device compute the identical image), so the result is bit-comparable to a
single-device render with the same key — the equivalence test in
tests/test_parallel.py asserts exactly that.

The reference has no analog (strictly single-GPU, SURVEY.md §2.4); this is
capability beyond it, not parity.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..ops.bvh import ClusterAccel, build_cluster_accel, morton_encode_3d
from ..ops.shade import Hit
from ..scene import Scene, Triangles

# Padding triangles park far outside every real scene (parked-ray
# convention, render.py): degenerate (det == 0, never hit) AND their
# point-AABBs never admit a culling test aimed at real geometry.
_FAR = 1.0e7


def _morton_sorted_soa(scene: Scene):
    """Triangle SoA arrays in Morton-centroid order (host numpy)."""
    v0 = np.asarray(scene.triangles.v0, np.float32)
    v1 = np.asarray(scene.triangles.v1, np.float32)
    v2 = np.asarray(scene.triangles.v2, np.float32)
    n0 = np.asarray(scene.triangles.n0, np.float32)
    n1 = np.asarray(scene.triangles.n1, np.float32)
    n2 = np.asarray(scene.triangles.n2, np.float32)
    mid = np.asarray(scene.triangles.material_id, np.int32)
    T = len(v0)
    if T:
        centroid = (v0 + v1 + v2) / 3.0
        lo = centroid.min(axis=0)
        extent = np.maximum(centroid.max(axis=0) - lo, 1e-12)
        order = np.argsort(morton_encode_3d((centroid - lo) / extent),
                           kind="stable")
        v0, v1, v2, n0, n1, n2, mid = (a[order]
                                       for a in (v0, v1, v2, n0, n1, n2, mid))
    return v0, v1, v2, n0, n1, n2, mid, T


def shard_scene_accels(scene: Scene, cfg, n_dev: int):
    """Split the scene's triangles into ``n_dev`` Morton-contiguous chunks
    and build one equal-shape ClusterAccel per chunk.

    Returns the accels stacked leaf-wise along a new leading device axis —
    ``jax.device_put`` with ``P(AXIS)`` scatters one shard per device.
    Host-side numpy (builders-return-host convention, CLAUDE.md).
    """
    v0, v1, v2, n0, n1, n2, mid, T = _morton_sorted_soa(scene)
    per = max(-(-T // n_dev), 1)

    def chunk(a, k, fill):
        part = a[k * per:(k + 1) * per]
        pad = per - len(part)
        if pad:
            shape = (pad,) + a.shape[1:]
            part = np.concatenate(
                [part, np.full(shape, fill, a.dtype)], axis=0)
        return part

    accels = []
    for k in range(n_dev):
        tris = Triangles(
            v0=chunk(v0, k, _FAR), v1=chunk(v1, k, _FAR),
            v2=chunk(v2, k, _FAR),
            n0=chunk(n0, k, 0.0), n1=chunk(n1, k, 0.0),
            n2=chunk(n2, k, 0.0),
            material_id=chunk(mid, k, 0))
        accels.append(build_cluster_accel(tris,
                                          cluster_size=cfg.cluster_size))
    return jax.tree_util.tree_map(lambda *xs: np.stack(xs), *accels)


def local_accel(stacked_accel) -> ClusterAccel:
    """Strip the leading device axis inside shard_map (local size 1)."""
    return jax.tree_util.tree_map(lambda a: a[0], stacked_accel)


def allreduce_hit(hit: Hit, axis: str, n_dev: int) -> Hit:
    """Global closest hit across the scene shards.

    Winner = min t, ties broken by lowest device index (deterministic; a
    cross-device tie means identical records — e.g. the replicated ground/
    sphere candidates — so any winner is the same record). All 16 attribute
    rows (position 3 + normal 3 + albedo 3 + specular 3 + emission 3 +
    smoothness 1) ride ONE stacked psum.
    """
    t = hit.t
    tmin = jax.lax.pmin(t, axis)
    dev = jax.lax.axis_index(axis)
    win = jax.lax.pmin(jnp.where(t <= tmin, dev, n_dev), axis)
    mine = (dev == win).astype(t.dtype)

    rows = jnp.stack([*hit.position, *hit.normal, *hit.albedo,
                      *hit.specular, *hit.emission, hit.smoothness], axis=0)
    sel = jax.lax.psum(rows * mine, axis)
    return Hit(t=tmin,
               position=(sel[0], sel[1], sel[2]),
               normal=(sel[3], sel[4], sel[5]),
               albedo=(sel[6], sel[7], sel[8]),
               specular=(sel[9], sel[10], sel[11]),
               emission=(sel[12], sel[13], sel[14]),
               smoothness=sel[15])


def make_scene_sharded_tracer(scene: Scene, accel_local: ClusterAccel, cfg,
                              axis: str, n_dev: int):
    """Local sub-scene tracer + cross-device closest-hit combine.

    Sphere/ground candidates are computed on every device (they are tiny
    and replicated); the min-combine is idempotent over identical records,
    so the global winner matches a single-device trace of the whole scene.
    """
    from ..ops.traverse import make_accel_tracer

    base = make_accel_tracer(scene, accel_local, cfg)

    def tracer(ro, rd, alive=None) -> Hit:
        return allreduce_hit(base(ro, rd, alive), axis, n_dev)

    return tracer

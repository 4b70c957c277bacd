"""Accelerated closest-hit tracers over the cluster LBVH.

Two pure-JAX strategies (the Triton kernel in ``gpu_trace.py`` is the
third), all taking/returning component-SoA rays and Hit records:

* ``trace_bvh``: classic per-ray stack traversal of the radix tree
  (the correct version of IntersectMeshBVH, RayTraceShader.compute:294-326),
  expressed as a single lock-step ``lax.while_loop`` over a (R,) batch with
  per-ray stacks (masked lanes instead of thread divergence).

* ``trace_cluster``: dense cluster culling — test all cluster AABBs per ray
  (vectorized slab test), sort clusters by entry distance, then sweep the
  sorted list in fixed-size rounds inside a ``while_loop`` that stops once
  every ray's best hit precedes the nearest unvisited cluster. Exact, fully
  vectorized.

All handle spheres and ground via the dense candidates (sphere counts are
tiny; the dense test is one fused op).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..scene import Scene
from ..utils.math3d import INF
from . import vec
from .vec import Vec3
from .bvh import ClusterAccel
from .intersect import intersect_aabb, safe_inv_dir
from .shade import Hit
from .trace import (_ground_candidate, _sphere_candidate, combine_candidates,
                    map_chunked)


def _cluster_triangle_hit(accel: ClusterAccel, ro: Vec3, rd: Vec3, cluster_ids):
    """MT97 of each ray against its own cluster's triangles.

    Args:
      ro, rd: Vec3 of (R,); cluster_ids: (R,) int32.
    Returns:
      (t, u, v, tri_idx): best per ray within the cluster; t (R,).
    """
    S = accel.cluster_size
    tr = accel.triangles
    tri_idx = cluster_ids[:, None] * S + jnp.arange(S)[None, :]  # (R, S)

    def g(tab, k):
        return tab[:, k][tri_idx]                                # (R, S)

    v0x, v0y, v0z = g(tr.v0, 0), g(tr.v0, 1), g(tr.v0, 2)
    e1x = g(tr.v1, 0) - v0x
    e1y = g(tr.v1, 1) - v0y
    e1z = g(tr.v1, 2) - v0z
    e2x = g(tr.v2, 0) - v0x
    e2y = g(tr.v2, 1) - v0y
    e2z = g(tr.v2, 2) - v0z
    rox, roy, roz = (c[:, None] for c in ro)                     # (R, 1)
    rdx, rdy, rdz = (c[:, None] for c in rd)
    px = rdy * e2z - rdz * e2y
    py = rdz * e2x - rdx * e2z
    pz = rdx * e2y - rdy * e2x
    det = e1x * px + e1y * py + e1z * pz
    front = det >= 1e-8
    inv_det = 1.0 / jnp.where(front, det, 1.0)
    tx = rox - v0x
    ty = roy - v0y
    tz = roz - v0z
    u = (tx * px + ty * py + tz * pz) * inv_det
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (rdx * qx + rdy * qy + rdz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    ok = front & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) & (t > 0)
    t = jnp.where(ok, t, INF)
    s_best = jnp.argmin(t, axis=1)
    take = lambda a: jnp.take_along_axis(a, s_best[:, None], axis=1)[:, 0]
    return (take(t), take(u), take(v),
            jnp.take_along_axis(tri_idx, s_best[:, None], 1)[:, 0])


def _finish_triangle_hit(scene, accel: ClusterAccel, t, u, v, tri_idx):
    """Assemble a full-material triangle candidate from the best (t, u, v, tri)."""
    from .trace import materials_for

    tr = accel.triangles
    w = 1.0 - u - v
    n0 = vec.gather_rows(tr.n0, tri_idx)
    n1 = vec.gather_rows(tr.n1, tri_idx)
    n2 = vec.gather_rows(tr.n2, tri_idx)
    n = vec.add(vec.add(vec.scale(n0, w), vec.scale(n1, u)), vec.scale(n2, v))
    return dict(t=t, normal=vec.normalize(n),
                **materials_for(scene, tr.material_id[tri_idx]))


# ---------------------------------------------------------------------------
# Strategy 1: per-ray stack traversal (lock-step while_loop)
# ---------------------------------------------------------------------------

STACK_DEPTH = 64  # fixed stack (reference pins 32, compute:73-74; LBVH depth
                  # over C clusters is <= ~2*log2(C), 64 covers C ~ 2^30)


def _aabb_single(ro: Vec3, inv: Vec3, bmin: Vec3, bmax: Vec3, best_t):
    """Per-ray slab test against per-ray boxes (all (R,) components)."""
    t_min = jnp.full_like(ro[0], -INF)
    t_max = jnp.full_like(ro[0], INF)
    for a in range(3):
        t1 = (bmin[a] - ro[a]) * inv[a]
        t2 = (bmax[a] - ro[a]) * inv[a]
        t_min = jnp.maximum(t_min, jnp.minimum(t1, t2))
        t_max = jnp.minimum(t_max, jnp.maximum(t1, t2))
    return (t_max >= t_min) & (t_max > 0) & (jnp.maximum(t_min, 0.0) < best_t)


def _triangle_bvh_candidate(scene, accel: ClusterAccel, ro: Vec3, rd: Vec3):
    """Closest triangle hit via masked stack traversal."""
    R = ro[0].shape[0]
    C = accel.num_clusters
    LEAF0 = C - 1 if C > 1 else 0
    inv_rd = safe_inv_dir(rd)

    stack = jnp.zeros((R, STACK_DEPTH), jnp.int32)  # root = node 0 pre-pushed
    sp = jnp.ones((R,), jnp.int32)
    best_t = jnp.full((R,), INF)
    best_u = jnp.zeros((R,))
    best_v = jnp.zeros((R,))
    best_tri = jnp.zeros((R,), jnp.int32)

    def cond(state):
        return jnp.any(state[1] > 0)

    def body(state):
        stack, sp, best_t, best_u, best_v, best_tri = state
        active = sp > 0
        top = jnp.maximum(sp - 1, 0)
        node = jnp.take_along_axis(stack, top[:, None], axis=1)[:, 0]
        node = jnp.where(active, node, 0)
        sp = jnp.where(active, sp - 1, sp)

        nvmin = vec.gather_rows(accel.node_vmin, node)
        nvmax = vec.gather_rows(accel.node_vmax, node)
        hit = _aabb_single(ro, inv_rd, nvmin, nvmax, best_t) & active

        is_leaf = accel.node_left[node] < 0
        # Leaf lanes: test the cluster's triangles (all lanes compute; masked).
        lt, lu, lv, ltri = _cluster_triangle_hit(
            accel, ro, rd, jnp.clip(node - LEAF0, 0, C - 1))
        take_leaf = hit & is_leaf & (lt < best_t)
        best_u = jnp.where(take_leaf, lu, best_u)
        best_v = jnp.where(take_leaf, lv, best_v)
        best_tri = jnp.where(take_leaf, ltri, best_tri)
        best_t = jnp.where(take_leaf, lt, best_t)

        # Internal lanes: push children.
        push = hit & ~is_leaf
        l = accel.node_left[node]
        r = accel.node_right[node]
        stack = _masked_push(stack, sp, l, push)
        sp = jnp.where(push, sp + 1, sp)
        stack = _masked_push(stack, sp, r, push)
        sp = jnp.where(push, sp + 1, sp)
        return stack, sp, best_t, best_u, best_v, best_tri

    state = (stack, sp, best_t, best_u, best_v, best_tri)
    _, _, best_t, best_u, best_v, best_tri = jax.lax.while_loop(
        cond, body, state)
    return _finish_triangle_hit(scene, accel, best_t, best_u, best_v, best_tri)


def _masked_push(stack, sp, value, mask):
    """stack[i, sp[i]] = value[i] where mask[i] (vectorized scatter)."""
    slot = jnp.clip(sp, 0, STACK_DEPTH - 1)
    onehot = jax.nn.one_hot(slot, STACK_DEPTH, dtype=stack.dtype)  # (R, D)
    keep = 1 - onehot * mask[:, None].astype(stack.dtype)
    return stack * keep + onehot * (value * mask)[:, None].astype(stack.dtype)


# ---------------------------------------------------------------------------
# Strategy 2: dense cluster culling with sorted rounds
# ---------------------------------------------------------------------------

def _triangle_cluster_candidate(scene, accel: ClusterAccel, ro: Vec3, rd: Vec3,
                                round_size: int = 8):
    """Closest triangle hit via sorted dense cluster sweep."""
    R = ro[0].shape[0]
    C = accel.num_clusters
    inv_rd = safe_inv_dir(rd)

    hit, t_enter = intersect_aabb(ro, inv_rd, accel.cluster_vmin,
                                  accel.cluster_vmax)          # (R, C)
    t_enter = jnp.where(hit, t_enter, INF)
    order = jnp.argsort(t_enter, axis=1)                       # nearest first
    t_sorted = jnp.take_along_axis(t_enter, order, axis=1)

    n_rounds = (C + round_size - 1) // round_size
    pad = n_rounds * round_size - C
    if pad:
        order = jnp.pad(order, ((0, 0), (0, pad)))
        t_sorted = jnp.pad(t_sorted, ((0, 0), (0, pad)), constant_values=INF)

    def cond(state):
        rnd, best_t, *_ = state
        # Continue while some ray's next unvisited cluster could beat its hit.
        next_t = jax.lax.dynamic_slice_in_dim(
            t_sorted, rnd * round_size, round_size, axis=1)[:, 0]
        return (rnd < n_rounds) & jnp.any(next_t < best_t)

    def body(state):
        rnd, best_t, best_u, best_v, best_tri = state
        ids = jax.lax.dynamic_slice_in_dim(order, rnd * round_size,
                                           round_size, axis=1)   # (R, K)
        ts = jax.lax.dynamic_slice_in_dim(t_sorted, rnd * round_size,
                                          round_size, axis=1)
        for k in range(round_size):
            useful = ts[:, k] < best_t
            lt, lu, lv, ltri = _cluster_triangle_hit(accel, ro, rd, ids[:, k])
            take = useful & (lt < best_t)
            best_u = jnp.where(take, lu, best_u)
            best_v = jnp.where(take, lv, best_v)
            best_tri = jnp.where(take, ltri, best_tri)
            best_t = jnp.where(take, lt, best_t)
        return rnd + 1, best_t, best_u, best_v, best_tri

    state = (jnp.int32(0), jnp.full((R,), INF), jnp.zeros((R,)),
             jnp.zeros((R,)), jnp.zeros((R,), jnp.int32))
    _, best_t, best_u, best_v, best_tri = jax.lax.while_loop(cond, body, state)
    return _finish_triangle_hit(scene, accel, best_t, best_u, best_v, best_tri)


# ---------------------------------------------------------------------------
# Tracer factory
# ---------------------------------------------------------------------------

def make_accel_tracer(scene: Scene, accel: ClusterAccel, cfg):
    """Build ``fn(ro, rd, alive=None) -> Hit`` for cfg.tracer in
    {bvh, cluster, pallas}. "pallas" traces triangles with the Triton kernel
    (``gpu_trace``) over all rays at once; the XLA tracers run in
    ``cfg.ray_chunk``-ray chunks."""
    # Builders hand out host-numpy pytrees; traced indexing needs jnp leaves
    # (no-op on tracers/device arrays).
    scene = jax.tree_util.tree_map(jnp.asarray, scene)
    accel = jax.tree_util.tree_map(jnp.asarray, accel)
    has_tris = scene.num_triangles > 0

    def candidates(ro: Vec3, rd: Vec3):
        return [_ground_candidate(scene, ro, rd),
                _sphere_candidate(scene, ro, rd)]

    if cfg.tracer == "pallas":
        from .gpu_trace import trace_triangles

        def tracer(ro: Vec3, rd: Vec3, alive=None) -> Hit:
            cands = candidates(ro, rd)
            if has_tris:
                t, u, v, tri = trace_triangles(accel, ro, rd, alive)
                cands.append(_finish_triangle_hit(scene, accel, t, u, v, tri))
            return combine_candidates(scene, ro, rd, cands)

        return tracer

    tri_fn = {"bvh": _triangle_bvh_candidate,
              "cluster": _triangle_cluster_candidate}[cfg.tracer]

    def tracer(ro: Vec3, rd: Vec3, alive=None) -> Hit:
        del alive  # dead rays are parked outside the scene (cfg.wavefront)

        def body(rox, roy, roz, rdx, rdy, rdz):
            ro_c = (rox, roy, roz)
            rd_c = (rdx, rdy, rdz)
            cands = candidates(ro_c, rd_c)
            if has_tris:
                cands.append(tri_fn(scene, accel, ro_c, rd_c))
            return combine_candidates(scene, ro_c, rd_c, cands)

        return map_chunked(body, (*ro, *rd), cfg.ray_chunk)

    return tracer

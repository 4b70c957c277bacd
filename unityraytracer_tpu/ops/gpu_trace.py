"""Closest-hit triangle trace as a Pallas kernel compiled through Triton.

One program owns a tile of ``tile`` rays and walks the cluster LBVH
(``ops/bvh.py``) with ONE node stack shared by the whole tile — the idea of
the reference's per-thread traversal (`RayTraceShader.compute:294-326`)
lifted from a thread to a tile of rays of neighbouring pixels (the
renderer's ray order keeps a tile's pixels adjacent):

* Pop a node. A leaf runs dense Moller-Trumbore of all ``tile`` rays against
  the cluster's triangles, ``tri_block`` triangles at a time, in registers,
  with the arithmetic of ``traverse._cluster_triangle_hit``.
* An internal node slab-tests both children against every ray's current
  best t and pushes the children some ray still hits, the one the tile
  reaches first on top. A child no ray hits is skipped with a scalar branch.
* The stack is a ``STACK_DEPTH`` int vector updated with one-hot writes
  (Triton has no per-program scalar arrays).
* Dead rays enter with best t = 0, so no box or triangle test admits them;
  a tile of dead rays pops the root and stops.

The kernel returns ``(t, u, v, triangle index)`` per ray; normals and
materials are gathered by XLA afterwards (``traverse._finish_triangle_hit``).
Spheres and the ground plane stay dense XLA candidates.

On a GPU the kernel always compiles through Triton; on the CPU it runs in the
Pallas interpreter (the only place that choice is made: ``_interpret``).
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .bvh import ClusterAccel
from .vec import Vec3

STACK_DEPTH = 64   # Karras-tree depth over 64-bit keys is < 64
# Rays per program, triangles per dense block inside a leaf, warps per
# program: the fastest of 128/64/32/16/8-ray tiles at 1-8 warps and 4/8/16
# triangle blocks on the flagship frame on an H100 (PERF.md). Smaller tiles
# win because deep bounces are incoherent: a tile visits the union of its
# rays' nodes.
TILE = 8
TRI_BLOCK = 8
NUM_WARPS = 1

_INF = float(jnp.finfo(jnp.float32).max)


def _interpret() -> bool:
    """Interpret mode on the CPU backend, Triton on a GPU, nothing else."""
    backend = jax.default_backend()
    if backend == "gpu":
        return False
    if backend == "cpu":
        return True
    raise RuntimeError(f"the Pallas tracer runs on gpu or cpu, not {backend!r}")


def pack_accel(accel: ClusterAccel):
    """Kernel layout of a ClusterAccel (jnp, so it also runs under jit).

    Returns ``(boxes, children, tris)``:
      boxes (Nn, 6) float32: node vmin xyz, vmax xyz;
      children (Nn, 2) int32: left, right (-1 on leaves);
      tris (9, C*S) float32 rows: v0 xyz, e1 = v1 - v0 xyz, e2 = v2 - v0 xyz.
    """
    boxes = jnp.concatenate([jnp.asarray(accel.node_vmin, jnp.float32),
                             jnp.asarray(accel.node_vmax, jnp.float32)], axis=1)
    children = jnp.stack([jnp.asarray(accel.node_left, jnp.int32),
                          jnp.asarray(accel.node_right, jnp.int32)], axis=1)
    tr = accel.triangles
    v0 = jnp.asarray(tr.v0, jnp.float32)
    e1 = jnp.asarray(tr.v1, jnp.float32) - v0
    e2 = jnp.asarray(tr.v2, jnp.float32) - v0
    tris = jnp.concatenate([v0.T, e1.T, e2.T], axis=0)
    return boxes, children, tris


def _trace_kernel(ox_ref, oy_ref, oz_ref, dx_ref, dy_ref, dz_ref, t0_ref,
                  box_ref, child_ref, tri_ref,
                  t_ref, u_ref, v_ref, id_ref,
                  *, tile: int, tri_block: int, cluster_size: int, leaf0: int):
    rays = pl.ds(pl.program_id(0) * tile, tile)
    o = (ox_ref[rays], oy_ref[rays], oz_ref[rays])
    d = (dx_ref[rays], dy_ref[rays], dz_ref[rays])
    # traverse/intersect.safe_inv_dir, elementwise.
    inv = tuple(1.0 / jnp.where(jnp.abs(c) < 1e-12,
                                jnp.where(c < 0, -1e-12, 1e-12), c) for c in d)

    def slab(node, best_t):
        """Per-ray slab test of one node box: (hit, entry distance)."""
        t_lo = jnp.full((tile,), -_INF, jnp.float32)
        t_hi = jnp.full((tile,), _INF, jnp.float32)
        for a in range(3):
            t1 = (box_ref[node, a] - o[a]) * inv[a]
            t2 = (box_ref[node, 3 + a] - o[a]) * inv[a]
            t_lo = jnp.maximum(t_lo, jnp.minimum(t1, t2))
            t_hi = jnp.minimum(t_hi, jnp.maximum(t1, t2))
        enter = jnp.maximum(t_lo, 0.0)
        return (t_hi >= t_lo) & (t_hi > 0) & (enter < best_t), enter

    def first_entry(hit, enter):
        """(any ray hits, nearest entry over the tile)."""
        return (jnp.max(hit.astype(jnp.int32)) > 0,
                jnp.min(jnp.where(hit, enter, _INF)))

    rox, roy, roz = (c[:, None] for c in o)
    rdx, rdy, rdz = (c[:, None] for c in d)
    col = jnp.arange(tri_block, dtype=jnp.int32)[None, :]

    def leaf(node, best):
        base0 = (node - leaf0) * cluster_size

        def block(j, best):
            best_t, best_u, best_v, best_id = best
            base = base0 + j * tri_block
            cols = pl.ds(base, tri_block)
            v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = (
                tri_ref[k, cols][None, :] for k in range(9))
            # Moller-Trumbore, as traverse._cluster_triangle_hit.
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
            ok = (front & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1)
                  & (t > 0))
            t = jnp.where(ok, t, _INF)
            t_min = jnp.min(t, axis=1)
            # First triangle of the block at the minimum (argmin order).
            k_min = jnp.min(jnp.where(t == t_min[:, None], col, tri_block),
                            axis=1)
            sel = col == k_min[:, None]
            u_min = jnp.sum(jnp.where(sel, u, 0.0), axis=1)
            v_min = jnp.sum(jnp.where(sel, v, 0.0), axis=1)
            take = t_min < best_t
            return (jnp.where(take, t_min, best_t),
                    jnp.where(take, u_min, best_u),
                    jnp.where(take, v_min, best_v),
                    jnp.where(take, base + k_min, best_id))

        return jax.lax.fori_loop(0, cluster_size // tri_block, block, best)

    slots = jnp.arange(STACK_DEPTH, dtype=jnp.int32)

    def push(stack, sp, node, do):
        stack = jnp.where((slots == sp) & do, node, stack)
        return stack, sp + do.astype(jnp.int32)

    def internal(node, stack, sp, best_t):
        left = child_ref[node, 0]
        right = child_ref[node, 1]
        hit_l, t_l = first_entry(*slab(left, best_t))
        hit_r, t_r = first_entry(*slab(right, best_t))
        left_first = t_l <= t_r
        # The child reached first goes on top (pushed last).
        stack, sp = push(stack, sp, jnp.where(left_first, right, left),
                         jnp.where(left_first, hit_r, hit_l))
        stack, sp = push(stack, sp, jnp.where(left_first, left, right),
                         jnp.where(left_first, hit_l, hit_r))
        return stack, sp

    def cond(carry):
        return carry[1] > 0

    def body(carry):
        stack, sp, best = carry
        sp = sp - 1
        node = jnp.sum(jnp.where(slots == sp, stack, 0))

        def at_leaf(stack, sp, best):
            hit, _ = first_entry(*slab(node, best[0]))
            best = jax.lax.cond(hit, lambda b: leaf(node, b), lambda b: b,
                                best)
            return stack, sp, best

        def at_internal(stack, sp, best):
            stack, sp = internal(node, stack, sp, best[0])
            return stack, sp, best

        return jax.lax.cond(child_ref[node, 0] < 0, at_leaf, at_internal,
                            stack, sp, best)

    best = (t0_ref[rays], jnp.zeros((tile,), jnp.float32),
            jnp.zeros((tile,), jnp.float32), jnp.zeros((tile,), jnp.int32))
    stack = jnp.zeros((STACK_DEPTH,), jnp.int32)     # root (node 0) on top
    _, _, (best_t, best_u, best_v, best_id) = jax.lax.while_loop(
        cond, body, (stack, jnp.int32(1), best))
    # Dead rays keep their zero seed: report them as misses.
    t_ref[rays] = jnp.where(best_t > 0, best_t, _INF)
    u_ref[rays] = best_u
    v_ref[rays] = best_v
    id_ref[rays] = best_id


def trace_triangles(accel: ClusterAccel, ro: Vec3, rd: Vec3, alive=None, *,
                    tile: int = TILE, tri_block: int = TRI_BLOCK,
                    num_warps: int = NUM_WARPS):
    """Closest triangle hit of every ray in ``accel``.

    Args:
      accel: a ClusterAccel (host or device leaves, traced under jit).
      ro, rd: Vec3 of (N,) ray origins and directions.
      alive: optional (N,) bool; dead rays report a miss.
    Returns:
      (t, u, v, tri): (N,) each; t = float32 max on a miss, ``tri`` indexes
      ``accel.triangles``.
    """
    n = ro[0].shape[0]
    n_pad = -(-n // tile) * tile
    size = accel.cluster_size
    tri_block = math.gcd(tri_block, size)   # a power of two dividing S
    t0 = jnp.full((n,), _INF, jnp.float32)
    if alive is not None:
        t0 = jnp.where(alive, t0, 0.0)

    def pad(a, fill=0.0):
        return jnp.pad(a.astype(jnp.float32), (0, n_pad - n),
                       constant_values=fill)

    # Padding rays are dead (best t = 0).
    ray_args = [pad(c) for c in (*ro, *rd)] + [pad(t0)]
    boxes, children, tris = pack_accel(accel)
    kernel = functools.partial(
        _trace_kernel, tile=tile, tri_block=tri_block, cluster_size=size,
        leaf0=max(accel.num_clusters - 1, 0))
    f32 = jax.ShapeDtypeStruct((n_pad,), jnp.float32)
    t, u, v, tri = pl.pallas_call(
        kernel,
        grid=(n_pad // tile,),
        out_shape=(f32, f32, f32, jax.ShapeDtypeStruct((n_pad,), jnp.int32)),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=1),
        interpret=_interpret(),
        name="gpu_trace_kernel",
    )(*ray_args, boxes, children, tris)
    return t[:n], u[:n], v[:n], tri[:n]

"""Triton closest-hit kernel (ops/gpu_trace.py), run in the Pallas
interpreter on the CPU, against the brute-force oracle."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from unityraytracer_tpu import Material, RenderConfig, SceneBuilder
from unityraytracer_tpu.models import fixtures
from unityraytracer_tpu.models import primitives as P
from unityraytracer_tpu.ops import gpu_trace
from unityraytracer_tpu.ops.bvh import build_cluster_accel
from unityraytracer_tpu.ops.intersect import intersect_triangles
from unityraytracer_tpu.ops.trace import trace_brute
from unityraytracer_tpu.ops.traverse import make_accel_tracer
from unityraytracer_tpu.utils.math3d import trs_matrix

MISS = np.finfo(np.float32).max


def _one_cluster_scene():
    b = SceneBuilder()
    v, f, n = P.cube()
    b.add_mesh(v, f, transform=trs_matrix((0, 1, 0), (0, 30, 0), 2.0),
               normals=n)
    b.set_skybox(np.ones((4, 8, 3), np.float32))
    return b.build()


def _no_triangle_scene():
    b = SceneBuilder()
    b.add_sphere((0, 1, 0), 1.0, Material())
    b.set_skybox(np.ones((4, 8, 3), np.float32))
    return b.build()


SCENES = {
    "scene1": fixtures.scene1,
    "sample_scene": fixtures.sample_scene,
    "one_cluster": _one_cluster_scene,
    "bench2000": lambda: fixtures.bench_scene(n_tris=2_000),
    "no_triangles": _no_triangle_scene,
}
_CACHE = {}


def _scene_accel(name, cluster_size=64):
    key = (name, cluster_size)
    if key not in _CACHE:
        scene = SCENES[name]()
        _CACHE[key] = (scene, build_cluster_accel(scene.triangles,
                                                  cluster_size=cluster_size))
    return _CACHE[key]


def _rays(scene, n, seed=0):
    """Rays aimed at the scene's triangles (or at the origin), some from
    random points inside its bounds in random directions."""
    rng = np.random.default_rng(seed)
    if scene.num_triangles:
        pts = np.concatenate([np.asarray(scene.triangles.v0),
                              np.asarray(scene.triangles.v1)])
    else:
        pts = np.zeros((1, 3), np.float32)
    lo, hi = pts.min(0) - 1.0, pts.max(0) + 1.0
    target = pts[rng.integers(0, len(pts), n)] + rng.normal(0, 0.3, (n, 3))
    ro = rng.uniform(lo, hi, (n, 3))
    ro[::2] = (lo + hi) / 2 + (hi - lo) * np.array([0.1, 1.5, -2.0])
    rd = target - ro
    rd[1::3] = rng.normal(size=(len(rd[1::3]), 3))
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return (tuple(jnp.asarray(ro[:, k], jnp.float32) for k in range(3)),
            tuple(jnp.asarray(rd[:, k], jnp.float32) for k in range(3)))


def _brute(scene, ro, rd):
    """Oracle (t, triangle index into scene.triangles) per ray."""
    if scene.num_triangles == 0:
        n = ro[0].shape[0]
        return np.full(n, MISS, np.float32), np.zeros(n, np.int64)
    tr = scene.triangles
    t, _, _ = intersect_triangles(ro, rd, jnp.asarray(tr.v0),
                                  jnp.asarray(tr.v1), jnp.asarray(tr.v2))
    t = np.asarray(t)
    return t.min(1), t.argmin(1)


def _check_against_brute(scene, accel, ro, rd, alive=None, **kw):
    t, u, v, tri = (np.asarray(a) for a in
                    gpu_trace.trace_triangles(accel, ro, rd, alive, **kw))
    bt, bi = _brute(scene, ro, rd)
    if alive is not None:
        bt = np.where(np.asarray(alive), bt, MISS)
    hit = t < MISS
    np.testing.assert_array_equal(hit, bt < MISS)
    np.testing.assert_allclose(t[hit], bt[hit], rtol=1e-5)
    # Same triangle: the kernel indexes the Morton-reordered accel soup.
    for name in ("v0", "v1", "v2"):
        got = np.asarray(getattr(accel.triangles, name))[tri[hit]]
        want = np.asarray(getattr(scene.triangles, name))[bi[hit]]
        np.testing.assert_array_equal(got, want)
    # Barycentrics of the winning triangle.
    w = 1.0 - u[hit] - v[hit]
    assert (u[hit] >= 0).all() and (v[hit] >= 0).all() and (w >= -1e-6).all()
    return t, tri


@pytest.mark.parametrize("n_rays", [100, 257, 1000])
@pytest.mark.parametrize("scene_name", list(SCENES))
def test_kernel_matches_brute(scene_name, n_rays):
    scene, accel = _scene_accel(scene_name)
    ro, rd = _rays(scene, n_rays, seed=n_rays)
    t, _ = _check_against_brute(scene, accel, ro, rd)
    if scene.num_triangles and n_rays >= 257:
        assert (t < MISS).sum() > n_rays // 10   # the rays do hit


@pytest.mark.parametrize("mode", ["all_dead", "partly_dead", "parked"])
def test_dead_and_parked_rays(mode):
    scene, accel = _scene_accel("bench2000")
    n = 300
    ro, rd = _rays(scene, n, seed=3)
    alive = None
    if mode == "all_dead":
        alive = jnp.zeros((n,), bool)
    elif mode == "partly_dead":
        alive = jnp.asarray(np.random.default_rng(1).uniform(size=n) > 0.4)
    else:
        # render.py's wavefront parking: far outside the scene, pointing up.
        park = np.arange(n) % 3 == 0
        ro = tuple(jnp.where(park, 1e7, c) for c in ro)
        rd = (jnp.where(park, 0.0, rd[0]), jnp.where(park, 1.0, rd[1]),
              jnp.where(park, 0.0, rd[2]))
    t, _ = _check_against_brute(scene, accel, ro, rd, alive)
    if mode == "all_dead":
        assert (t == MISS).all()
    if mode == "parked":
        assert (t[::3] == MISS).all()


@pytest.mark.parametrize("tile,tri_block,num_warps",
                         [(16, 1, 1), (32, 4, 1), (64, 8, 2), (128, 16, 4),
                          (64, 64, 2)])
def test_tile_and_block_sizes(tile, tri_block, num_warps):
    scene, accel = _scene_accel("scene1")
    ro, rd = _rays(scene, 200, seed=7)
    _check_against_brute(scene, accel, ro, rd, tile=tile,
                         tri_block=tri_block, num_warps=num_warps)


@pytest.mark.parametrize("n", [1, 63, 64, 65, 200])
def test_wrapper_padding_and_shapes(n):
    """Outputs are (n,) whatever the tile padding, and a ray's result does
    not depend on which tile or batch it lands in."""
    scene, accel = _scene_accel("scene1")
    ro, rd = _rays(scene, 200, seed=11)
    full = gpu_trace.trace_triangles(accel, ro, rd, tile=64)
    part = gpu_trace.trace_triangles(accel, tuple(c[:n] for c in ro),
                                     tuple(c[:n] for c in rd), tile=64)
    for a, b, dtype in zip(part, full, (jnp.float32, jnp.float32,
                                        jnp.float32, jnp.int32)):
        assert a.shape == (n,) and a.dtype == dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b)[:n])


@pytest.mark.parametrize("cluster_size,tri_block", [(16, 32), (32, 8)])
def test_tri_block_fits_cluster_size(cluster_size, tri_block):
    scene, accel = _scene_accel("scene1", cluster_size=cluster_size)
    ro, rd = _rays(scene, 150, seed=5)
    _check_against_brute(scene, accel, ro, rd, tri_block=tri_block)


def test_pack_accel_layout():
    scene, accel = _scene_accel("bench2000")
    boxes, children, tris = gpu_trace.pack_accel(accel)
    n_nodes = 2 * accel.num_clusters - 1
    assert boxes.shape == (n_nodes, 6) and children.shape == (n_nodes, 2)
    np.testing.assert_array_equal(np.asarray(boxes[:, :3]),
                                  np.asarray(accel.node_vmin))
    np.testing.assert_array_equal(np.asarray(children[:, 1]),
                                  np.asarray(accel.node_right))
    tr = accel.triangles
    assert tris.shape == (9, tr.count)
    np.testing.assert_allclose(np.asarray(tris[3:6]).T,
                               np.asarray(tr.v1) - np.asarray(tr.v0))


def test_kernel_under_jit_with_traced_accel():
    scene, accel = _scene_accel("one_cluster")
    ro, rd = _rays(scene, 128, seed=2)
    eager = gpu_trace.trace_triangles(accel, ro, rd)
    jitted = jax.jit(gpu_trace.trace_triangles)(accel, ro, rd)
    for a, b in zip(eager, jitted):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("scene_name", ["scene1", "bench2000"])
def test_pallas_tracer_hit_matches_brute(scene_name):
    """The full tracer (kernel + XLA attribute gathers + sphere/ground
    candidates) returns the oracle's Hit record."""
    scene, accel = _scene_accel(scene_name)
    ro, rd = _rays(scene, 300, seed=9)
    cfg = RenderConfig(tracer="pallas")
    hit = make_accel_tracer(scene, accel, cfg)(ro, rd)
    ref = trace_brute(jax.tree_util.tree_map(jnp.asarray, scene), ro, rd)
    np.testing.assert_allclose(np.asarray(hit.t), np.asarray(ref.t),
                               rtol=1e-5)
    for field in ("normal", "albedo", "emission"):
        for a, b in zip(getattr(hit, field), getattr(ref, field)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       atol=1e-4)


@pytest.mark.parametrize("backend,expect", [("gpu", False), ("cpu", True),
                                            ("rocm", None)])
def test_interpret_only_on_cpu(monkeypatch, backend, expect):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    if expect is None:
        with pytest.raises(RuntimeError, match="gpu or cpu"):
            gpu_trace._interpret()
    else:
        assert gpu_trace._interpret() is expect

"""Tracer-level unit tests: sphere candidate scaling + best-t seed semantics.

The sphere path is a dense (rays x spheres) test plus one gather per
attribute of the winner (O(1) graph size in sphere count — the stand-in for
the reference's IntersectSphereBVH, RayTraceShader.compute:329-361). These
tests pin its behavior against a straightforward per-ray numpy reference at
S=512.
"""

import numpy as np
import jax.numpy as jnp

from unityraytracer_tpu import Material, SceneBuilder
from unityraytracer_tpu.ops.trace import _sphere_candidate, trace_brute


def _to3(a):
    return tuple(jnp.asarray(a[:, k]) for k in range(3))


def _many_sphere_scene(S=512, seed=0):
    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    centers = rng.uniform(-20, 20, (S, 3)).astype(np.float32)
    centers[:, 1] = np.abs(centers[:, 1]) + 0.2
    radii = rng.uniform(0.1, 1.0, S).astype(np.float32)
    for i in range(S):
        b.add_sphere(centers[i], float(radii[i]),
                     Material(albedo=tuple(rng.uniform(0, 1, 3)),
                              specular=tuple(rng.uniform(0, 0.5, 3)),
                              emission=tuple(rng.uniform(0, 2, 3)),
                              smoothness=float(rng.uniform())))
    b.set_skybox(np.ones((2, 4, 3), np.float32))
    return b.build(), centers, radii


def _numpy_sphere_reference(scene, centers, radii, ro, rd):
    """Per-ray loop: nearest sphere + its material row (reference semantics:
    near root if positive else far root, RayTraceShader.compute:175-196)."""
    R = ro.shape[0]
    t = np.full(R, np.inf)
    idx = np.full(R, -1)
    for s in range(len(radii)):
        d = ro - centers[s]
        p1 = -np.sum(rd * d, axis=1)
        disc = p1 * p1 - (np.sum(d * d, axis=1) - radii[s] ** 2)
        ok = disc >= 0
        sq = np.sqrt(np.maximum(disc, 0))
        near, far = p1 - sq, p1 + sq
        ts = np.where(near > 0, near, np.where(far > 0, far, np.inf))
        ts = np.where(ok, ts, np.inf)
        better = ts < t
        t = np.where(better, ts, t)
        idx = np.where(better, s, idx)
    return t, idx


def test_sphere_candidate_matches_reference_at_512():
    scene, centers, radii = _many_sphere_scene(512)
    rng = np.random.default_rng(7)
    R = 256
    ro = rng.uniform(-25, 25, (R, 3)).astype(np.float32)
    rd = rng.normal(size=(R, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)

    cand = _sphere_candidate(scene, _to3(ro), _to3(rd))
    t_ref, idx_ref = _numpy_sphere_reference(scene, centers, radii, ro, rd)

    t = np.asarray(cand["t"])
    hit = np.isfinite(t_ref)
    assert hit.sum() > 20  # the scene is dense enough to be a real test
    np.testing.assert_allclose(t[hit], t_ref[hit], rtol=2e-4, atol=2e-4)
    # Winner attribution: albedo must be the winning sphere's material row.
    mats = np.asarray(scene.materials.albedo)
    mid = np.asarray(scene.spheres.material_id)
    want = mats[mid[idx_ref[hit]]]
    got = np.stack([np.asarray(cand["albedo"][k])[hit] for k in range(3)], -1)
    np.testing.assert_allclose(got, want, atol=1e-6)
    # Smoothness too (scalar channel goes through the same matmul).
    smo = np.asarray(scene.materials.smoothness)[mid[idx_ref[hit]]]
    np.testing.assert_allclose(np.asarray(cand["smoothness"])[hit], smo,
                               atol=1e-6)


def test_sphere_candidate_normals_point_outward():
    scene, centers, radii = _many_sphere_scene(64, seed=3)
    rng = np.random.default_rng(9)
    R = 128
    ro = rng.uniform(-25, 25, (R, 3)).astype(np.float32)
    rd = rng.normal(size=(R, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    cand = _sphere_candidate(scene, _to3(ro), _to3(rd))
    t = np.asarray(cand["t"])
    hit = t < 1e29
    n = np.stack([np.asarray(cand["normal"][k]) for k in range(3)], -1)
    lens = np.linalg.norm(n[hit], axis=1)
    np.testing.assert_allclose(lens, 1.0, atol=1e-4)


def test_trace_brute_ignores_alive_mask():
    scene, _, _ = _many_sphere_scene(8, seed=1)
    rng = np.random.default_rng(2)
    ro = rng.uniform(-5, 5, (64, 3)).astype(np.float32)
    rd = rng.normal(size=(64, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    alive = jnp.asarray(rng.uniform(size=64) > 0.5)
    ha = trace_brute(scene, _to3(ro), _to3(rd))
    hb = trace_brute(scene, _to3(ro), _to3(rd), alive)
    np.testing.assert_array_equal(np.asarray(ha.t), np.asarray(hb.t))

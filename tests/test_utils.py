"""Utility subsystem tests: logging, timing, image IO, debugviz, checkpoint."""

import os

import numpy as np
import jax
import pytest

from unityraytracer_tpu import Camera, Material, RenderConfig, Renderer, SceneBuilder
from unityraytracer_tpu.models import primitives as P
from unityraytracer_tpu.ops.bvh import build_cluster_accel
from unityraytracer_tpu.utils import debugviz, logging as urtlog, timing
from unityraytracer_tpu.utils.image import (linear_to_srgb, rmse, to_uint8,
                                            tonemap_aces, write_png)
from unityraytracer_tpu.utils.math3d import trs_matrix


def _scene():
    b = SceneBuilder()
    v, f, n = P.icosphere(2)
    b.add_mesh(v, f, transform=trs_matrix((0, 1, 0), (0, 0, 0), 2.0))
    b.add_sphere((2, 0.5, 0), 0.5, Material(albedo=(0.9, 0.1, 0.1)))
    b.set_skybox(np.ones((4, 8, 3), np.float32) * 0.7)
    return b.build()


def test_leveled_logger(tmp_path):
    log = urtlog.DebugLog("t", directory=str(tmp_path), level=urtlog.BASIC)
    log.log("basic message")
    log.detail("too detailed, filtered")
    log.warn("warned")
    log.close()
    text = open(log.path).read()
    assert "basic message" in text
    assert "too detailed" not in text
    assert "warned" in text
    assert "=== run" in text  # timestamped header


def test_stage_timer():
    t = timing.StageTimer(block=False)
    with t.stage("build"):
        pass
    with t.stage("build"):
        pass
    with t.stage("trace"):
        pass
    assert t.counts["build"] == 2
    rep = t.report()
    assert "build" in rep and "trace" in rep
    assert timing.mrays_per_sec(2_000_000, 0.02) == pytest.approx(100.0)


def test_image_roundtrip(tmp_path):
    img = np.random.default_rng(0).random((8, 16, 3)).astype(np.float32)
    path = write_png(str(tmp_path / "x.png"), img)
    assert os.path.getsize(path) > 100
    assert to_uint8(img).dtype == np.uint8
    assert (linear_to_srgb(img) >= 0).all() and (linear_to_srgb(img) <= 1).all()
    assert (tonemap_aces(img * 100) <= 1.0).all()
    assert rmse(img, img) == 0.0
    with pytest.raises(ValueError):
        rmse(img, img[:4])


def test_debugviz_stats_and_dump(tmp_path):
    scene = _scene()
    accel = build_cluster_accel(scene.triangles, cluster_size=16,
                                use_native=False)
    stats = debugviz.accel_stats(accel)
    assert stats["num_clusters"] > 1
    assert stats["max_depth"] >= 1
    assert stats["num_triangles"] == accel.triangles.count
    tree = debugviz.dump_tree(accel, max_nodes=16)
    assert "node 0" in tree and "leaf" in tree
    path = debugviz.export_aabbs_obj(accel, str(tmp_path / "boxes.obj"))
    text = open(path).read()
    assert text.count("v ") >= accel.num_clusters * 8
    report = debugviz.test_ray_report(accel, (0, 1, -5), (0, 0, 1))
    assert report["n_touched"] >= 1


def test_implicit_heap_layout():
    """The reference-compat complete-binary-heap export (JoinBVH,
    RayTraceMaster.cs:459-505): heap invariants + exact leaf coverage."""
    scene = _scene()
    accel = build_cluster_accel(scene.triangles, cluster_size=16,
                                use_native=False)
    hvmin, hvmax, hidx = debugviz.to_implicit_heap(accel)
    M = len(hidx)
    assert M & (M + 1) == 0                     # 2**d - 1 slots
    C = accel.num_clusters
    # Every cluster appears exactly once as a leaf; fillers/parents are -1.
    leaves = hidx[hidx >= 0]
    assert sorted(leaves.tolist()) == list(range(C))
    filler = (hidx < 0) & (np.abs(hvmin).sum(1) == 0) \
        & (np.abs(hvmax).sum(1) == 0)
    for i in range(M):
        li, ri = 2 * i + 1, 2 * i + 2
        if li >= M:
            break
        if hidx[i] >= 0 or filler[i]:
            # leaf or filler: entire subtree below must be filler
            assert filler[li] and filler[ri]
            continue
        # internal: children exist and parent AABB contains real children
        for ch in (li, ri):
            if not filler[ch]:
                assert (hvmin[i] <= hvmin[ch] + 1e-5).all()
                assert (hvmax[i] >= hvmax[ch] - 1e-5).all()
        # larger subtree goes left (cs:468-472): count real slots below
        def real_count(s):
            if s >= M or filler[s]:
                return 0
            return 1 + real_count(2 * s + 1) + real_count(2 * s + 2)
        assert real_count(li) >= real_count(ri)
    # Root AABB matches the LBVH root.
    np.testing.assert_allclose(hvmin[0], np.asarray(accel.node_vmin)[0])
    np.testing.assert_allclose(hvmax[0], np.asarray(accel.node_vmax)[0])


def test_checkpoint_resume(tmp_path):
    scene = _scene()
    cam = Camera.create(position=(0, 1.5, -6), look_at=(0, 1, 0),
                        fov_y_deg=60, aspect=1.0)
    cfg = RenderConfig(width=24, height=24, spp=1, bounces=2,
                       tracer="cluster", cluster_size=16, ray_chunk=576)
    r1 = Renderer(scene, cam, cfg, seed=7).step(2)
    ckpt = str(tmp_path / "state.npz")
    r1.save_state(ckpt)
    r1.step(2)

    r2 = Renderer(scene, cam, cfg, seed=0).load_state(ckpt)
    assert r2.sample_count == 2
    r2.step(2)
    # Resumed render continues the exact same stream -> identical images.
    np.testing.assert_allclose(r1.image, r2.image, atol=1e-6)


def test_screenshot(tmp_path):
    scene = _scene()
    cam = Camera.create(position=(0, 1.5, -6), look_at=(0, 1, 0),
                        fov_y_deg=60, aspect=1.0)
    cfg = RenderConfig(width=16, height=16, spp=1, bounces=2)
    r = Renderer(scene, cam, cfg, seed=0).step(1)
    path = r.save_screenshot(str(tmp_path / "shot.png"))
    assert os.path.getsize(path) > 100


def test_persistent_compile_cache(monkeypatch):
    """JAX_COMPILATION_CACHE_DIR unset: the fixed <checkout>/.cache/jax."""
    import jax

    from unityraytracer_tpu.utils import compcache

    prev_dir = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        used = compcache.enable_persistent_cache()
        assert used == compcache.DEFAULT_DIR
        assert os.path.isdir(used)
        assert jax.config.jax_compilation_cache_dir == used
    finally:
        jax.config.update("jax_compilation_cache_dir", prev_dir)


def test_persistent_compile_cache_env_dir(tmp_path, monkeypatch):
    """JAX_COMPILATION_CACHE_DIR set: that directory as given (JAX reads
    the variable itself), and the code points the cache nowhere else."""
    import jax

    from unityraytracer_tpu.utils import compcache

    prev_dir = jax.config.jax_compilation_cache_dir
    d = str(tmp_path / "jaxcache")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", d)
    try:
        jax.config.update("jax_compilation_cache_dir", d)
        assert compcache.enable_persistent_cache() == d
        assert jax.config.jax_compilation_cache_dir == d
    finally:
        jax.config.update("jax_compilation_cache_dir", prev_dir)


def test_compile_cache_default_is_the_checkout(monkeypatch):
    """The default path is fixed: <checkout>/.cache/jax, made from no
    temporary name, pid or time, so a rerun of the checkout finds it."""
    from unityraytracer_tpu.utils import compcache

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert compcache.DEFAULT_DIR == os.path.join(root, ".cache", "jax")
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert compcache.cache_dir() == compcache.DEFAULT_DIR
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere/cache")
    assert compcache.cache_dir() == "/elsewhere/cache"

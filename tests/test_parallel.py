"""Multi-chip sharding tests on an 8-virtual-device CPU mesh."""

import numpy as np
import jax
import pytest

from unityraytracer_tpu import Camera, Material, RenderConfig, SceneBuilder
from unityraytracer_tpu.render import Renderer
from unityraytracer_tpu.parallel.sharding import (ShardedRenderer,
                                                  create_sharded_state,
                                                  make_mesh, make_sharded_step)


def _scene():
    b = SceneBuilder()
    b.add_sphere((0, 1.0, 0), 1.0, Material(albedo=(0.8, 0.2, 0.2),
                                            specular=(0.1,) * 3))
    b.add_sphere((-2, 0.6, 1), 0.6, Material(albedo=(0.2, 0.7, 0.3),
                                             specular=(0, 0, 0)))
    b.set_skybox(np.ones((8, 16, 3), np.float32) * 0.7)
    return b.build()


SCENE = _scene()
CAM = Camera.create(position=(0, 1.5, -6), look_at=(0, 1, 0), fov_y_deg=60,
                    aspect=1.0)
CFG = RenderConfig(width=32, height=32, spp=1, bounces=2, tracer="brute",
                   ray_chunk=4096)


def test_mesh_has_8_devices():
    mesh = make_mesh()
    assert mesh.shape["devices"] == 8


def test_rows_sharding_matches_single_device_statistically():
    r8 = ShardedRenderer(SCENE, CAM, CFG, seed=0, mode="rows").step(6)
    r1 = Renderer(SCENE, CAM, CFG, seed=1).step(6)
    img8, img1 = r8.image, r1.image
    assert img8.shape == img1.shape
    assert np.isfinite(img8).all()
    # Different RNG streams -> not equal, but the same scene converges to the
    # same mean radiance.
    assert abs(img8.mean() - img1.mean()) < 0.03
    # Band boundaries must be seamless: adjacent-row mean jump across the
    # 8 shard boundaries is no larger than within-shard jumps.
    row_diff = np.abs(np.diff(img8.mean(axis=(1, 2))))
    h_local = CFG.height // 8
    boundary = row_diff[h_local - 1::h_local]
    assert boundary.mean() < row_diff.mean() * 3 + 0.05


def test_rows_band_equivalence_deterministic():
    """Band k of a sharded frame == the SAME band rendered single-device.

    By construction (make_sharded_step): frame key = fold_in(step_key,
    n_samples), band stream = fold_in(frame_key, device_index), band pixels
    = render_frame(row0=k*h_local, rows=h_local). Reconstructing that
    single-device must reproduce each band to float tolerance — a gross
    per-band bug (wrong row0, wrong key fold, swapped bands) fails exactly,
    unlike the statistical seam test above. Runs the Pallas path (the
    kernel that ships)."""
    from unityraytracer_tpu.models import primitives as prim
    from unityraytracer_tpu.render import render_frame
    from unityraytracer_tpu.utils.math3d import trs_matrix
    from unityraytracer_tpu.parallel.sharding import gather_image

    b = SceneBuilder()
    v, f, n = prim.icosphere(1)
    b.add_mesh(v, f, transform=trs_matrix((0, 1, 0), (0, 0, 0), 2.0))
    b.set_skybox(np.ones((4, 8, 3), np.float32) * 0.7)
    scene = b.build()
    cfg = CFG.replace(tracer="pallas", width=16, height=32, bounces=2)

    from unityraytracer_tpu.ops import bvh
    accel = bvh.build_accel(scene, cfg)
    scene_d, accel_d = jax.device_put(scene), jax.device_put(accel)

    mesh = make_mesh()
    n_dev = mesh.shape["devices"]
    h_local = cfg.height // n_dev
    step = make_sharded_step(cfg, mesh, mode="rows")
    state = create_sharded_state(cfg, mesh)
    key = jax.random.key(7)
    state = step(state, scene_d, CAM, accel_d, key, 1)
    img = gather_image(state)

    frame_key = jax.random.fold_in(key, 0)  # n_samples == 0 for frame 0
    for k in (0, 3, n_dev - 1):
        band_key = jax.random.fold_in(frame_key, k)
        band = np.asarray(render_frame(scene_d, cfg, CAM, band_key, accel_d,
                                       row0=k * h_local, rows=h_local))
        np.testing.assert_allclose(img[k * h_local:(k + 1) * h_local], band,
                                   atol=1e-6, rtol=1e-5)


def test_sharded_fused_step_and_stats():
    """n_frames in ONE dispatch (fori_loop) == n_frames unfused; stats
    published with Renderer.step parity."""
    cfg = CFG.replace(tracer="cluster", cluster_size=16, ray_chunk=1024)
    a = ShardedRenderer(SCENE, CAM, cfg, seed=11, mode="rows").step(
        3, fused=True)
    b = ShardedRenderer(SCENE, CAM, cfg, seed=11, mode="rows")
    b.step(1, fused=False).step(1, fused=False).step(1, fused=False)
    # Fused keys: ONE split keys the whole block (frames keyed by absolute
    # sample index), so one fused step(3) == one unfused step(3) from the
    # same seed only when the unfused path reuses its block key; compare
    # against the fused path's own invariants instead: sample count, finite,
    # and a second fused renderer bit-matches.
    c = ShardedRenderer(SCENE, CAM, cfg, seed=11, mode="rows").step(
        3, fused=True)
    assert a.sample_count == b.sample_count == 3
    np.testing.assert_array_equal(a.image, c.image)
    for r in (a, b):
        assert set(r.stats) >= {"frames", "seconds", "ms_per_frame",
                                "mrays_per_sec"}
        assert r.stats["mrays_per_sec"] > 0


def _mesh_scene(n_tris=900):
    from unityraytracer_tpu.models import fixtures
    return fixtures.bench_scene(n_tris=n_tris)


def test_sharded_preview_export_surface(tmp_path):
    """ShardedRenderer carries the FULL preview/export surface (watch /
    denoise / AOVs / multi-part EXR) via PreviewExportMixin — going
    multi-chip must not silently drop the Renderer tooling. Scene-sharded
    modes route AOVs through a lazily-built host LBVH (no single device
    holds the whole accel)."""
    import os

    r = ShardedRenderer(SCENE, CAM, CFG, seed=0, mode="rows").step(1)
    g = r.aovs()
    assert set(g) >= {"albedo", "normal", "depth", "emission", "hit"}
    d = r.denoised_image()
    assert d.shape == (CFG.height, CFG.width, 3) and np.isfinite(d).all()
    p = r.save_aovs(str(tmp_path / "aov.exr"))
    assert os.path.getsize(p) > 0
    prev = tmp_path / "prev.png"
    r.watch(path=str(prev), every=1, frames=2)
    assert prev.exists() and r.sample_count == 2

    scene = _mesh_scene()
    cfgp = CFG.replace(tracer="cluster", cluster_size=16, ray_chunk=1024)
    cam = Camera.create(position=(0, 10, -30), look_at=(0, 1, 0),
                        fov_y_deg=60, aspect=1.0)
    r2 = ShardedRenderer(scene, cam, cfgp, seed=0, mode="scene").step(1)
    g2 = r2.aovs()
    assert bool(np.asarray(g2["hit"]).any())


def test_rows_scene_composed_2d_mesh_matches_rows():
    """mode="rows_scene" on a 2x4 (rows, scene) mesh: framebuffer bands on
    the major axis, triangle shards + per-bounce closest-hit all-reduce on
    the minor. Band streams fold the ROW index only (all shards of a band
    must trace identical rays), so the composed render is stream-identical
    to plain 2-device rows mode — and the exact min-combine makes it match
    to float tolerance. Also checks the placement: accel sharded along
    "scene", accumulator along "rows"."""
    from unityraytracer_tpu.parallel.sharding import make_mesh2

    scene = _mesh_scene()
    cfg = CFG.replace(tracer="cluster", cluster_size=16, ray_chunk=1024,
                      bounces=3)
    cam = Camera.create(position=(0, 10, -30), look_at=(0, 1, 0),
                        fov_y_deg=60, aspect=1.0)
    mesh2 = make_mesh2(2, 4)
    r_2d = ShardedRenderer(scene, cam, cfg, mesh=mesh2, seed=4,
                           mode="rows_scene").step(2)
    r_rows = ShardedRenderer(scene, cam, cfg,
                             mesh=make_mesh(jax.devices()[:2]),
                             seed=4, mode="rows").step(2)
    assert np.isfinite(r_2d.image).all()
    assert r_2d.image.max() > 0.05
    np.testing.assert_allclose(r_2d.image, r_rows.image,
                               atol=2e-5, rtol=1e-4)
    accel_sh = {str(l.sharding)
                for l in jax.tree_util.tree_leaves(r_2d.accel)}
    assert any("scene" in s for s in accel_sh)
    assert "rows" in str(r_2d.state.accum.sharding)
    # Composed checkpoint/resume round-trip re-shards by rows.
    import tempfile, os
    with tempfile.TemporaryDirectory() as td:
        p = r_2d.save_state(os.path.join(td, "ck"))
        r_back = ShardedRenderer(scene, cam, cfg, mesh=mesh2, seed=4,
                                 mode="rows_scene").load_state(p)
        assert r_back.sample_count == r_2d.sample_count
        np.testing.assert_allclose(r_back.image, r_2d.image, atol=1e-6)


def test_scene_sharding_matches_single_device():
    """mode="scene" (1/n of the triangles per device, closest-hit
    all-reduce) must reproduce the single-device render of the SAME seed to
    float tolerance: RNG/shading replicate, only tracing is sharded, and
    the min-combine is exact."""
    scene = _mesh_scene()
    cfg = CFG.replace(tracer="cluster", cluster_size=16, ray_chunk=1024,
                      bounces=3)
    cam = Camera.create(position=(0, 10, -30), look_at=(0, 1, 0),
                        fov_y_deg=60, aspect=1.0)
    r_sh = ShardedRenderer(scene, cam, cfg, seed=4, mode="scene").step(2)
    r_1 = Renderer(scene, cam, cfg, seed=4).step(2)
    assert np.isfinite(r_sh.image).all()
    assert r_sh.image.max() > 0.05
    np.testing.assert_allclose(r_sh.image, r_1.image, atol=2e-5, rtol=1e-4)


def test_scene_sharding_accel_is_sharded_and_smaller():
    """Each device holds ~1/n of the triangles: the stacked accel leaves
    are sharded on the device axis and the per-shard triangle count is
    ceil(T/n)."""
    from unityraytracer_tpu.parallel.scene_shard import shard_scene_accels

    scene = _mesh_scene()
    cfg = CFG.replace(tracer="cluster", cluster_size=16)
    mesh = make_mesh()
    n = mesh.shape["devices"]
    stacked = shard_scene_accels(scene, cfg, n)
    assert stacked.triangles.v0.shape[0] == n
    per = stacked.triangles.v0.shape[1]
    assert per < scene.num_triangles  # strictly smaller than the whole
    assert per * n >= scene.num_triangles  # and they cover it

    r = ShardedRenderer(scene, CAM, cfg, seed=0, mode="scene")
    shardings = {str(l.sharding)
                 for l in jax.tree_util.tree_leaves(r.accel)}
    assert any("devices" in s for s in shardings)


def test_scene_sharding_pallas_matches_single_device():
    """mode="scene" + tracer="pallas": 1/n of the triangles per device
    through the Triton kernel, min-combined across the mesh after every
    bounce. The estimator is stream-identical
    to the single-device render, so the result must pass the cross-tracer
    RMSE gate against it."""
    from unityraytracer_tpu.utils.image import rmse

    scene = _mesh_scene()
    cfg = CFG.replace(tracer="pallas", bounces=3)
    cam = Camera.create(position=(0, 10, -30), look_at=(0, 1, 0),
                        fov_y_deg=60, aspect=1.0)
    r_sh = ShardedRenderer(scene, cam, cfg, seed=4, mode="scene").step(2)
    r_1 = Renderer(scene, cam, cfg, seed=4).step(2)
    assert np.isfinite(r_sh.image).all()
    assert r_sh.image.max() > 0.05
    assert rmse(r_sh.image, r_1.image) < 1e-3


def test_scene_sharding_pallas_accels_are_sharded():
    """mode="scene" + tracer="pallas": each device holds a ClusterAccel of
    its Morton chunk (leading device axis, sharded over the mesh), and the
    Triton kernel walking the chunks under shard_map, min-combined across
    the devices, returns the single-device tracer's closest hits."""
    from jax.sharding import PartitionSpec as P

    from unityraytracer_tpu.ops.bvh import ClusterAccel, build_accel
    from unityraytracer_tpu.ops.traverse import make_accel_tracer
    from unityraytracer_tpu.parallel.scene_shard import (
        local_accel, make_scene_sharded_tracer)
    from unityraytracer_tpu.parallel.sharding import AXIS

    scene = _mesh_scene()
    cfg = CFG.replace(tracer="pallas", cluster_size=16)
    mesh = make_mesh()
    n = mesh.shape[AXIS]
    r = ShardedRenderer(scene, CAM, cfg, seed=0, mode="scene")
    assert isinstance(r.accel, ClusterAccel)
    assert r.accel.triangles.v0.shape[0] == n
    assert any(AXIS in str(l.sharding)
               for l in jax.tree_util.tree_leaves(r.accel))

    rng = np.random.default_rng(0)
    n_rays = 256
    ro = tuple(jax.numpy.asarray(c) for c in
               rng.uniform([-12, 0.5, -30], [12, 12, -20], (n_rays, 3)).T
               .astype(np.float32))
    target = rng.uniform([-10, 0, -10], [10, 3, 10], (n_rays, 3))
    d = target - np.stack([np.asarray(c) for c in ro], 1)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rd = tuple(jax.numpy.asarray(c) for c in d.T.astype(np.float32))

    def local(accel):
        tr = make_scene_sharded_tracer(scene, local_accel(accel), cfg,
                                       AXIS, n)
        hit = tr(ro, rd)
        return hit.t, hit.normal
    t_sh, n_sh = jax.shard_map(local, mesh=mesh, in_specs=(P(AXIS),),
                               out_specs=P(), check_vma=False)(r.accel)
    ref = make_accel_tracer(scene, build_accel(scene, cfg), cfg)(ro, rd)
    hit = np.asarray(ref.t) < 1e30
    assert hit.mean() > 0.5
    np.testing.assert_allclose(np.asarray(t_sh), np.asarray(ref.t),
                               rtol=1e-5)
    for a, b in zip(n_sh, ref.normal):
        np.testing.assert_allclose(np.asarray(a)[hit], np.asarray(b)[hit],
                                   atol=1e-4)


def test_scene_sharding_rejects_brute():
    scene = _mesh_scene(100)
    with pytest.raises(ValueError, match="scene sharding"):
        ShardedRenderer(scene, CAM, CFG.replace(tracer="brute"),
                        seed=0, mode="scene").step(1)


def test_rows_state_is_sharded():
    mesh = make_mesh()
    state = create_sharded_state(CFG, mesh)
    shardings = {str(d.sharding) for d in [state.accum]}
    assert any("devices" in s for s in shardings)


def test_spp_mode_replicated_and_deterministic_shape():
    r = ShardedRenderer(SCENE, CAM, CFG, seed=3, mode="spp").step(2)
    assert r.sample_count == 2
    assert np.isfinite(r.image).all()


def test_spp_mode_lower_variance_than_single():
    # 8-way pmean per frame should be close to an 8-frame single-device mean.
    r_spp = ShardedRenderer(SCENE, CAM, CFG, seed=0, mode="spp").step(1)
    r_one = Renderer(SCENE, CAM, CFG, seed=0).step(8)
    assert abs(r_spp.image.mean() - r_one.image.mean()) < 0.04


def test_height_not_divisible_raises():
    mesh = make_mesh()
    bad = CFG.replace(height=30)
    with pytest.raises(ValueError):
        create_sharded_state(bad, mesh)


def test_accel_tracer_under_shard_map():
    cfg = CFG.replace(tracer="cluster", cluster_size=16, ray_chunk=1024)
    r = ShardedRenderer(SCENE, CAM, cfg, seed=0, mode="rows").step(2)
    assert np.isfinite(r.image).all()
    assert r.sample_count == 2


def test_sharded_checkpoint_roundtrip(tmp_path):
    # ShardedRenderer save/load: the gathered accumulator + key re-shard
    # onto the mesh, and stepping after resume matches an uninterrupted
    # run exactly (same key stream, same decisions).
    cfg = CFG.replace(tracer="cluster", cluster_size=16, ray_chunk=1024)
    a = ShardedRenderer(SCENE, CAM, cfg, seed=5, mode="rows").step(2)
    p = str(tmp_path / "shard_ckpt.npz")
    a.save_state(p)
    b = ShardedRenderer(SCENE, CAM, cfg, seed=99, mode="rows").load_state(p)
    assert b.sample_count == 2
    np.testing.assert_array_equal(a.image, b.image)
    np.testing.assert_array_equal(a.step(2).image, b.step(2).image)
    out = a.save_screenshot(str(tmp_path / "shard.png"))
    import os
    assert os.path.getsize(out) > 100


def test_rbg_rng_under_shard_map():
    # rng_impl="rbg" (XLA RngBitGenerator bits) must compose with shard_map
    # row bands: per-device fold_in on an rbg key, device-local draws, and
    # the usual finite/deterministic contract.
    cfg = CFG.replace(tracer="cluster", cluster_size=16, ray_chunk=1024,
                      rng_impl="rbg")
    r1 = ShardedRenderer(SCENE, CAM, cfg, seed=3, mode="rows").step(2)
    r2 = ShardedRenderer(SCENE, CAM, cfg, seed=3, mode="rows").step(2)
    assert np.isfinite(r1.image).all()
    np.testing.assert_array_equal(r1.image, r2.image)


def test_pallas_tracer_under_shard_map():
    # The fused-kernel path (interpret mode on CPU) must compose with
    # multi-chip row sharding.
    from unityraytracer_tpu.models import primitives as P
    from unityraytracer_tpu.utils.math3d import trs_matrix

    b = SceneBuilder()
    v, f, n = P.icosphere(2)
    b.add_mesh(v, f, transform=trs_matrix((0, 1, 0), (0, 0, 0), 2.0))
    b.set_skybox(np.ones((4, 8, 3), np.float32) * 0.7)
    scene = b.build()
    cfg = CFG.replace(tracer="pallas", width=32, height=32)
    r = ShardedRenderer(scene, CAM, cfg, seed=0, mode="rows").step(2)
    img = r.image
    assert img.shape == (32, 32, 3)
    assert np.isfinite(img).all()
    assert img.max() > 0.05


def test_graft_entry_and_dryrun():
    import __graft_entry__ as ge

    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out)
    assert np.isfinite(np.asarray(out.accum)).all()
    ge.dryrun_multichip(8)

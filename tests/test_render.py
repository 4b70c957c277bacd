"""End-to-end renderer tests: config[0] slice (3 spheres + ground, brute force)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from unityraytracer_tpu import (Camera, Material, RenderConfig, Renderer,
                                RenderState, SceneBuilder, progressive_step,
                                render_sample)
from unityraytracer_tpu.render import get_tracer


def three_sphere_scene():
    b = SceneBuilder()
    b.add_sphere((0, 1.0, 0), 1.0, Material(albedo=(0.8, 0.2, 0.2),
                                            specular=(0.1, 0.1, 0.1), smoothness=0.5))
    b.add_sphere((-2.5, 0.7, 1), 0.7, Material(albedo=(0.2, 0.8, 0.2),
                                               specular=(0, 0, 0), smoothness=0.2))
    b.add_sphere((2.5, 0.7, -1), 0.7, Material(albedo=(0.1, 0.1, 0.1),
                                               specular=(0.9, 0.9, 0.9), smoothness=0.95))
    H, W = 16, 32
    sky = (np.linspace(1.2, 0.1, H)[:, None, None]
           * np.array([0.5, 0.7, 1.0])).astype(np.float32)
    b.set_skybox(np.broadcast_to(sky, (H, W, 3)).copy())
    return b.build()


SCENE = three_sphere_scene()
CAM = Camera.create(position=(0, 1.5, -6), look_at=(0, 1, 0), fov_y_deg=60,
                    aspect=1.0)
CFG = RenderConfig(width=48, height=48, spp=1, bounces=4, tracer="brute")


def test_render_sample_finite_and_lit():
    tracer = get_tracer(SCENE, CFG)
    img = np.asarray(render_sample(SCENE, tracer, CAM, jax.random.key(0), CFG))
    assert img.shape == (48, 48, 3)
    assert np.isfinite(img).all()
    assert img.max() > 0.05
    # Sky at top, ground at bottom: top rows bluer than red, bottom brownish.
    top = img[:4].mean(axis=(0, 1))
    assert top[2] > top[0]


def test_render_deterministic_same_key():
    tracer = get_tracer(SCENE, CFG)
    a = np.asarray(render_sample(SCENE, tracer, CAM, jax.random.key(7), CFG))
    b = np.asarray(render_sample(SCENE, tracer, CAM, jax.random.key(7), CFG))
    np.testing.assert_array_equal(a, b)


def test_render_differs_across_keys():
    tracer = get_tracer(SCENE, CFG)
    a = np.asarray(render_sample(SCENE, tracer, CAM, jax.random.key(1), CFG))
    b = np.asarray(render_sample(SCENE, tracer, CAM, jax.random.key(2), CFG))
    assert np.abs(a - b).max() > 1e-4


def test_progressive_is_running_mean():
    state = RenderState.create(4, 4)
    frames = [jnp.full((4, 4, 3), float(i)) for i in range(5)]
    for f in frames:
        state = progressive_step(state, f)
    np.testing.assert_allclose(np.asarray(state.accum), 2.0, atol=1e-6)
    assert int(state.n_samples) == 5


def test_progressive_variance_shrinks():
    # The accumulated image over many frames is smoother than one frame.
    tracer = get_tracer(SCENE, CFG)
    state = RenderState.create(CFG.width, CFG.height)
    key = jax.random.key(3)
    frames = []
    for i in range(6):
        key, sub = jax.random.split(key)
        f = render_sample(SCENE, tracer, CAM, sub, CFG)
        frames.append(np.asarray(f))
        state = progressive_step(state, f)
    accum = np.asarray(state.accum)
    np.testing.assert_allclose(accum, np.mean(frames, axis=0), atol=1e-5)


def test_renderer_lifecycle_and_reset():
    r = Renderer(SCENE, CAM, CFG, seed=0)
    r.step(3)
    assert r.sample_count == 3
    img3 = r.image
    assert np.isfinite(img3).all()
    # Camera move resets accumulation (RayTraceMaster.cs:765-768).
    r.set_camera(Camera.create(position=(0, 2, -7), look_at=(0, 1, 0),
                               fov_y_deg=60, aspect=1.0))
    assert r.sample_count == 0
    r.step(1)
    assert r.sample_count == 1


def test_spp_mean_matches_manual_average():
    # One frame at spp=4 should have lower variance than spp=1 (sanity).
    cfg4 = CFG.replace(spp=4)
    tracer = get_tracer(SCENE, cfg4)
    img = np.asarray(render_sample(SCENE, tracer, CAM, jax.random.key(0), cfg4))
    assert np.isfinite(img).all()


def test_ground_disabled():
    b = SceneBuilder()
    b.add_sphere((0, 1.0, 0), 1.0)
    b.set_ground(False)
    b.set_skybox(np.ones((4, 8, 3), np.float32))
    scene = b.build()
    cfg = CFG.replace(bounces=1)
    tracer = get_tracer(scene, cfg)
    img = np.asarray(render_sample(scene, tracer, CAM, jax.random.key(0), cfg))
    # Bottom rows see sky (1.0-ish after 1 bounce), not brown ground.
    bottom = img[-3:].mean(axis=(0, 1))
    np.testing.assert_allclose(bottom, 1.0, atol=0.3)


def test_emissive_sphere_contributes():
    b = SceneBuilder()
    b.add_sphere((0, 1.0, 0), 1.0, Material(albedo=(0, 0, 0), specular=(0, 0, 0),
                                            emission=(5.0, 0.0, 2.0)))
    b.set_skybox(np.zeros((4, 8, 3), np.float32))
    scene = b.build()
    tracer = get_tracer(scene, CFG)
    img = np.asarray(render_sample(scene, tracer, CAM, jax.random.key(0), CFG))
    center = img[20:28, 20:28].mean(axis=(0, 1))
    assert center[0] > 1.0 and center[2] > 0.4 and center[1] < 0.2


def test_resize_resets_and_rerenders():
    r = Renderer(SCENE, CAM, CFG, seed=0).step(2)
    r.resize(32, 32)
    assert r.sample_count == 0
    r.step(1)
    assert r.image.shape == (32, 32, 3)
    assert "mrays_per_sec" in r.stats and r.stats["frames"] == 1


def test_golden_scene1_regression():
    """Golden-image regression at BASELINE.md fidelity (RMSE < 1e-3).

    Scene1 small render with a fixed seed must stay within 1e-3 per-pixel
    RMSE of the stored float32 reference for ALL THREE tracers — brute (the
    oracle that generated the golden), the cluster sweep, and the Triton
    kernel path (interpret mode) — guarding silent breakage of
    camera/shading/accumulation semantics AND of the kernel+tile-blocking+
    RGBE-sky integration across refactors. Same seed => same sampling
    decisions, so the only allowed drift is float op-order noise."""
    from unityraytracer_tpu.models import fixtures
    from unityraytracer_tpu.utils.image import rmse

    golden = np.load("tests/golden_scene1.npz")["image"].astype(np.float32)
    scene = fixtures.scene1()
    cam = fixtures.scene1_camera(aspect=64 / 48)
    cfg = RenderConfig(width=64, height=48, spp=2, bounces=3, tracer="brute",
                       ray_chunk=6144)
    for tracer_cfg in (cfg,
                       cfg.replace(tracer="cluster", cluster_size=32),
                       cfg.replace(tracer="pallas")):
        r = Renderer(scene, cam, tracer_cfg, seed=123).step(8)
        err = rmse(r.image, golden)
        assert err < 1e-3, (tracer_cfg.tracer, err)


@pytest.mark.parametrize("rr_group", ["ray", "step"])
def test_deep_bounce_rr_cross_path(rr_group):
    """Russian roulette actually FIRES (bounces=5 => RR active for b in
    {2, 3}) and the Pallas path (blocked ray layout, kernel dead-ray skip)
    matches the brute oracle on the same streams. rr_group="step"
    additionally covers the group-shared RR uniforms (one decision per
    (8, 128)-pixel group) across both ray layouts.

    A mesh is included so triangle hit -> RR -> further bounces runs through
    the Pallas kernel, not just sphere/ground candidates."""
    from unityraytracer_tpu.models import fixtures
    from unityraytracer_tpu.utils.image import rmse

    scene = fixtures.scene1()
    cam = fixtures.scene1_camera(aspect=48 / 32)
    cfg = RenderConfig(width=48, height=32, spp=1, bounces=5, tracer="brute",
                       ray_chunk=3072, russian_roulette=True,
                       rr_group=rr_group)
    assert cfg.russian_roulette and cfg.bounces >= 5
    imgs = {}
    for tag, tcfg in (("brute", cfg),
                      ("pallas", cfg.replace(tracer="pallas",
                                             wavefront=True))):
        r = Renderer(scene, cam, tcfg, seed=77).step(4)
        imgs[tag] = r.image
        assert np.isfinite(imgs[tag]).all()
    # Same seed => same RR decisions; only float op-order noise may differ.
    assert rmse(imgs["pallas"], imgs["brute"]) < 1e-3


def test_sample_scene_shipped_quality_settings():
    """SampleScene at its SHIPPED quality preset — numBounces=10,
    numRays=25 (SampleScene.unity:433-434) — end-to-end through brute and
    the Pallas path under the cross-tracer RMSE gate. spp=25 x 10 bounces is
    the stress corner of the blocked ray layout (8x16 blocking transposes
    over a 25-deep spp axis) that the golden gate (spp=2 x 3) and the bench
    (spp=1 x 8) never touch. Small resolution keeps the dense oracle
    tractable."""
    from unityraytracer_tpu.models import fixtures
    from unityraytracer_tpu.utils.image import rmse

    scene = fixtures.sample_scene()
    cam = fixtures.sample_scene_camera(aspect=1.0)
    cfg = RenderConfig(width=16, height=16, spp=25, bounces=10,
                       tracer="brute", ray_chunk=6400,
                       russian_roulette=True)
    img = {}
    for tag, tcfg in (("brute", cfg),
                      ("pallas", cfg.replace(tracer="pallas"))):
        r = Renderer(scene, cam, tcfg, seed=21).step(1)
        img[tag] = r.image
        assert np.isfinite(img[tag]).all()
    assert img["brute"].max() > 0.05  # the preset actually renders light
    assert rmse(img["pallas"], img["brute"]) < 1e-3


def test_spp_chunk_weighted_composition_and_cross_tracer():
    """cfg.spp_chunk renders a high-spp frame as sequential sub-frames
    under one jit (the memory cap for the reference's 25-rays/pixel quality
    preset — at 1080p an unchunked spp=25 dispatch stages 51.8M rays).
    Checks:
    (1) the chunked frame equals the EXACT spp-weighted mean of the
    manually rendered sub-frames (full chunks at fold_in(key, i), the
    remainder at fold_in(key, n_full)); (2) chunking sits above tracer
    dispatch, so cluster and brute stay stream-identical chunked."""
    from unityraytracer_tpu.models import fixtures
    from unityraytracer_tpu.render import render_frame
    from unityraytracer_tpu.utils.image import rmse

    from unityraytracer_tpu.ops.bvh import build_accel

    scene = fixtures.scene1()
    cam = fixtures.scene1_camera(aspect=1.0)
    key = jax.random.key(5)
    cfg = RenderConfig(width=16, height=16, spp=5, bounces=3,
                       tracer="cluster", ray_chunk=1280, spp_chunk=2)
    accel = build_accel(scene, cfg)
    img = np.asarray(render_frame(scene, cfg, cam, key, accel))
    # Manual composition: 2 full chunks of 2 spp + remainder of 1.
    sub2 = cfg.replace(spp=2, spp_chunk=None)
    sub1 = cfg.replace(spp=1, spp_chunk=None)
    parts = [np.asarray(render_frame(scene, sub2, cam,
                                     jax.random.fold_in(key, i),
                                     accel)) * (2 / 5)
             for i in range(2)]
    parts.append(np.asarray(render_frame(
        scene, sub1, cam, jax.random.fold_in(key, 2), accel)) * (1 / 5))
    # lax.map's in-graph sum reassociates float adds vs the host-side
    # composition — equality holds to op-order noise.
    np.testing.assert_allclose(img, np.sum(parts, axis=0),
                               rtol=1e-4, atol=5e-5)
    # Cross-tracer stream identity survives chunking.
    imgb = np.asarray(render_frame(scene, cfg.replace(tracer="brute"),
                                   cam, key))
    assert rmse(img, imgb) < 1e-4


def test_rng_impl_rbg_cross_tracer():
    """rng_impl="rbg" (XLA RngBitGenerator bits) keeps every invariant the
    gates rely on: streams are deterministic and identical across tracers
    for one key, so pallas must still match brute at float op-order noise;
    and the stream actually differs from threefry (same seed, different
    noise pattern — estimator unchanged)."""
    from unityraytracer_tpu.models import fixtures
    from unityraytracer_tpu.utils.image import rmse

    scene = fixtures.scene1()
    cam = fixtures.scene1_camera(aspect=48 / 32)
    cfg = RenderConfig(width=48, height=32, spp=1, bounces=3, tracer="brute",
                       ray_chunk=3072, rng_impl="rbg")
    img = {}
    for tag, tcfg in (("brute", cfg),
                      ("pallas", cfg.replace(tracer="pallas"))):
        r = Renderer(scene, cam, tcfg, seed=9).step(2)
        img[tag] = r.image
        assert np.isfinite(img[tag]).all()
    assert rmse(img["pallas"], img["brute"]) < 1e-3
    img_tf = Renderer(scene, cam, cfg.replace(rng_impl="threefry2x32"),
                      seed=9).step(2).image
    assert rmse(img_tf, img["brute"]) > 1e-4  # different stream, same light
    # Checkpoint round-trip preserves the impl'd key.
    import tempfile, os
    r = Renderer(scene, cam, cfg, seed=9).step(1)
    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, "st.npz")
        r.save_state(p)
        r2 = Renderer(scene, cam, cfg, seed=1).load_state(p)
        a = r.step(1).image
        b = r2.step(1).image
    assert rmse(a, b) < 1e-7


def test_cli_render_and_info(tmp_path, capsys):
    # python -m unityraytracer_tpu: the headless equivalent of driving the
    # reference from the editor (render -> PNG + AOV EXR; info).
    import os
    from unityraytracer_tpu.__main__ import main
    from unityraytracer_tpu.models.exr import load_exr

    assert main(["info", "--scene", "scene1"]) == 0
    out = capsys.readouterr().out
    assert "8 spheres" in out and "triangles" in out

    png = str(tmp_path / "cli.png")
    aovs = str(tmp_path / "cli_aovs.exr")
    rc = main(["render", "--scene", "scene1", "--width", "64", "--height",
               "48", "--bounces", "2", "--frames", "2", "--tracer",
               "cluster", "-o", png, "--aovs", aovs])
    assert rc == 0
    assert os.path.getsize(png) > 100
    assert load_exr(aovs, part="albedo").shape == (48, 64, 3)

    # Multi-chip CLI: one scene-sharded render across the virtual mesh.
    png2 = str(tmp_path / "cli_shard.png")
    rc = main(["render", "--scene", "scene1", "--width", "32", "--height",
               "32", "--bounces", "2", "--frames", "1", "--tracer",
               "cluster", "--shard", "scene", "-o", png2])
    assert rc == 0
    assert os.path.getsize(png2) > 100


def test_watch_progressive_preview(tmp_path):
    # Renderer.watch: the OnRenderImage display analog — progressive file
    # refresh with atomic replace + a local HTTP preview.
    import urllib.request

    out = str(tmp_path / "preview.png")
    cfg = CFG.replace(width=32, height=24, bounces=2)
    r = Renderer(SCENE, CAM, cfg, seed=0)
    ticks = []
    r.watch(out, every=2, frames=4, denoise=False, http_port=18631,
            on_update=lambda rr: ticks.append(rr.sample_count))
    assert ticks == [2, 4]
    assert r.sample_count == 4
    import os
    assert os.path.getsize(out) > 100
    page = urllib.request.urlopen(
        "http://127.0.0.1:18631/", timeout=5).read()
    assert b"preview.png" in page
    png = urllib.request.urlopen(
        "http://127.0.0.1:18631/preview.png", timeout=5).read()
    assert png[:4] == b"\x89PNG"
    r._preview_server.shutdown()


def test_dispatch_bands_composition_and_estimator():
    """cfg.dispatch_bands renders each frame as n separate horizontal-band
    dispatches + one accumulate dispatch — the knob that bounds
    single-dispatch device time and memory. Checks: (1) the banded frame
    is EXACTLY the manual composition of render_frame band calls under the
    documented key chain
    (fold_in(frame_key, band_index), the single-chip analog of mode="rows"
    sharding's per-device streams), including a ragged last band (height
    48 over 5 bands = 10x4+8); (2) determinism across renderer instances;
    (3) the banded estimator converges to the unbanded one (distributional
    match, like spp_chunk — per-band streams are not bitwise the unbanded
    draws)."""
    from unityraytracer_tpu.ops.bvh import build_accel
    from unityraytracer_tpu.render import render_frame
    from unityraytracer_tpu.utils.image import rmse

    cfg = CFG.replace(width=32, height=48, bounces=3, tracer="cluster",
                      ray_chunk=1536)
    bcfg = cfg.replace(dispatch_bands=5)
    accel = build_accel(SCENE, cfg)
    b = Renderer(SCENE, CAM, bcfg, seed=7, accel=accel).step(1)
    # (1) manual composition under the documented key chain.
    key = jax.random.key(7)
    _, sub = jax.random.split(key)
    fkey = jax.random.fold_in(sub, 0)
    # Jitted like the renderer's band fn (an eager render_frame fuses
    # differently and lands ~4e-5 away in op-order noise).
    import functools

    @functools.partial(jax.jit, static_argnums=(4,))
    def band(scene, camera, key, row0, rows, _accel=accel, _cfg=cfg):
        return render_frame(scene, _cfg, camera, key, _accel,
                            row0=row0, rows=rows)

    parts = [np.asarray(band(SCENE, CAM, jax.random.fold_in(fkey, bi),
                             jnp.int32(row0), min(10, 48 - row0)))
             for bi, row0 in enumerate(range(0, 48, 10))]
    np.testing.assert_array_equal(np.asarray(b.state.accum),
                                  np.concatenate(parts, axis=0))
    assert b.sample_count == 1
    # (2) determinism.
    b2 = Renderer(SCENE, CAM, bcfg, seed=7, accel=accel).step(1)
    np.testing.assert_array_equal(np.asarray(b.state.accum),
                                  np.asarray(b2.state.accum))
    # (3) estimator match: 24-frame averages agree within Monte-Carlo
    # noise of this scene/size (empirically ~1e-2; bound at 5e-2).
    bm = Renderer(SCENE, CAM, bcfg, seed=3, accel=accel).step(24)
    um = Renderer(SCENE, CAM, cfg, seed=3, accel=accel).step(24)
    assert rmse(bm.image, um.image) < 5e-2


@pytest.mark.parametrize("backend,expect", [("gpu", "pallas"),
                                            ("cpu", "cluster"),
                                            ("rocm", None), ("metal", None)])
def test_default_tracer_per_backend(backend, expect):
    from unityraytracer_tpu.render import default_tracer

    if expect is None:
        with pytest.raises(ValueError, match="no tracer for backend"):
            default_tracer(backend)
    else:
        assert default_tracer(backend) == expect


def test_default_tracer_reads_jax_backend(monkeypatch):
    from unityraytracer_tpu.render import default_tracer

    assert default_tracer() == "cluster"          # the tests run on the CPU
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert default_tracer() == "pallas"


def _pytree_examples():
    from unityraytracer_tpu.ops.bvh import build_cluster_accel
    from unityraytracer_tpu.ops.shade import Hit
    from unityraytracer_tpu.models import fixtures

    scene = fixtures.scene1()
    z = jnp.zeros((4,))
    return {
        "Scene": scene,
        "Camera": CAM,
        "ClusterAccel": build_cluster_accel(scene.triangles, cluster_size=16),
        "Hit": Hit(t=z, position=(z, z, z), normal=(z, z, z),
                   albedo=(z, z, z), specular=(z, z, z),
                   emission=(z, z, z), smoothness=z),
        "RenderState": RenderState.create(4, 2),
    }


@pytest.mark.parametrize("name", ["Scene", "Camera", "ClusterAccel", "Hit",
                                  "RenderState"])
def test_dataclass_pytree_roundtrip(name):
    """The frozen dataclasses are pytrees whose every field is a data leaf
    (no static fields): flatten/unflatten round-trips, and jit traces the
    fields instead of baking them in."""
    import dataclasses

    obj = _pytree_examples()[name]
    leaves, treedef = jax.tree_util.tree_flatten(obj)
    back = jax.tree_util.tree_unflatten(treedef, leaves)
    assert type(back) is type(obj)
    for a, b in zip(jax.tree_util.tree_leaves(back), leaves):
        assert a is b
    # Every field (recursively) contributes leaves; None contributes none.
    n_expected = 0
    stack = [obj]
    while stack:
        o = stack.pop()
        if dataclasses.is_dataclass(o):
            stack.extend(getattr(o, f.name) for f in dataclasses.fields(o))
        elif isinstance(o, tuple):
            stack.extend(o)
        elif o is not None:
            n_expected += 1
    assert len(leaves) == n_expected
    seen = []
    jax.jit(lambda t: seen.extend(jax.tree_util.tree_leaves(t)) or 0)(obj)
    assert len(seen) == n_expected
    assert all(isinstance(x, jax.core.Tracer) for x in seen)


def test_dataclass_pytrees_are_frozen():
    cam = _pytree_examples()["Camera"]
    import dataclasses

    with pytest.raises(dataclasses.FrozenInstanceError):
        cam.aspect = 2.0

"""Headline benchmark: Mrays/s at 1080p on a 100k-triangle LBVH scene.

Runs the progressive frame step (camera rays -> closest-hit trace -> roulette
shade, x bounces) through the backend's default tracer on a GPU and prints
ONE JSON line:
  {"metric": ..., "value": N, "unit": "Mrays/s", "device": {...}, ...}

Rays are counted as dispatched trace slots: width x height x spp x bounces
per frame; the JSON also carries ``effective_mrays`` — the alive-weighted
rate (miss termination and Russian roulette kill most slots by bounce 2).
Exits non-zero when JAX finds no GPU: a CPU number is not a device number.
"""

import functools
import json
import sys
import time

import numpy as np


def main() -> int:
    import jax

    if jax.default_backend() != "gpu":
        print(f"bench.py needs a GPU (backend: {jax.default_backend()})",
              file=sys.stderr)
        return 1

    from unityraytracer_tpu import Camera, RenderConfig, RenderState
    from unityraytracer_tpu.models import fixtures
    from unityraytracer_tpu.ops.bvh import build_accel
    from unityraytracer_tpu.render import (default_tracer, get_tracer,
                                           progressive_step, render_frame,
                                           render_sample)
    from unityraytracer_tpu.utils.compcache import enable_persistent_cache
    from unityraytracer_tpu.utils.image import rmse

    cache_dir = enable_persistent_cache()
    cfg = RenderConfig(width=1920, height=1080, spp=1, bounces=8,
                       tracer=default_tracer(), wavefront=True)
    iters = 8

    scene = fixtures.bench_scene(n_tris=100_000)
    camera_kw = dict(position=(0.0, 14.0, -42.0), look_at=(0.0, 2.0, 0.0),
                     fov_y_deg=60.0, aspect=cfg.width / cfg.height)
    camera = Camera.create(**camera_kw)
    t0 = time.perf_counter()
    accel = build_accel(scene, cfg)
    build_s = time.perf_counter() - t0
    scene = jax.device_put(scene)
    accel = jax.device_put(accel)

    @functools.partial(jax.jit, static_argnums=(5,))
    def step(state, scene, camera, accel, key, n_frames):
        def body(i, st):
            sub = jax.random.fold_in(key, st.n_samples)
            frame = render_frame(scene, cfg, camera, sub, accel)
            return progressive_step(st, frame)

        return jax.lax.fori_loop(0, n_frames, body, state)

    state = RenderState.create(cfg.width, cfg.height)
    key = jax.random.key(0, impl=cfg.rng_impl)

    t0 = time.perf_counter()
    compiled = step.lower(state, scene, camera, accel, key, iters).compile()
    compile_s = time.perf_counter() - t0

    def run(state, key):
        return jax.block_until_ready(
            compiled(state, scene, camera, accel, key))

    key, sub = jax.random.split(key)
    state = run(state, sub)                 # warm-up
    best = float("inf")
    for _ in range(5):
        key, sub = jax.random.split(key)
        t0 = time.perf_counter()
        state = run(state, sub)
        best = min(best, (time.perf_counter() - t0) / iters)
    img = np.asarray(state.accum)
    assert np.isfinite(img).all(), "benchmark produced non-finite pixels"

    rays_per_frame = cfg.width * cfg.height * cfg.spp * cfg.bounces
    mrays = rays_per_frame / best / 1e6

    # Fidelity gate: the timed path must match the brute-force oracle on THIS
    # scene (same threefry key => same estimator decisions, so the only
    # allowed difference is float op-order noise). bounces=4 makes Russian
    # roulette fire (active for 2 <= b < bounces-1). Both sides run on this
    # GPU with full-precision matmuls.
    ccfg = cfg.replace(width=192, height=96, bounces=4, spp=1)
    bcfg = ccfg.replace(tracer="brute", ray_chunk=1024)
    ckey = jax.random.key(42, impl=cfg.rng_impl)
    cam_small = Camera.create(**dict(camera_kw,
                                     aspect=ccfg.width / ccfg.height))
    with jax.default_matmul_precision("highest"):
        img_fast = np.asarray(jax.jit(
            lambda s, c, a, k: render_frame(s, ccfg, c, k, a))(
                scene, cam_small, accel, ckey))
        img_oracle = np.asarray(jax.jit(
            lambda s, c, k: render_sample(s, get_tracer(s, bcfg), c, k,
                                          bcfg))(scene, cam_small, ckey))
        # Alive fraction over the bench bounce count (estimator-identical
        # across tracers), measured at the gate resolution.
        acfg = ccfg.replace(bounces=cfg.bounces)
        alive_total = float(jax.jit(
            lambda s, c, a, k: render_sample(
                s, get_tracer(s, acfg, a), c, k, acfg,
                with_alive_count=True)[1])(scene, cam_small, accel, ckey))
    oracle_rmse = float(rmse(img_fast, img_oracle))
    assert oracle_rmse < 1e-3, (
        f"timed path diverged from the brute oracle: RMSE {oracle_rmse}")
    alive_frac = alive_total / (acfg.width * acfg.height * acfg.spp
                                * acfg.bounces)

    dev = jax.devices()[0]
    print(json.dumps({
        "metric": (f"Mrays/s @ {cfg.width}x{cfg.height}, "
                   f"{scene.num_triangles}-tri LBVH scene, "
                   f"{cfg.bounces} bounces, tracer={cfg.tracer}"),
        "value": mrays,
        "unit": "Mrays/s",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "ms_per_frame": best * 1000.0,
        "effective_mrays": mrays * alive_frac,
        "alive_fraction": alive_frac,
        "accel_build_s": build_s,
        "compile_s": compile_s,
        "compile_cache_dir": cache_dir,
        "oracle_rmse": oracle_rmse,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())

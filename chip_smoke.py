"""Smoke test of the path tracer on an NVIDIA GPU, through the public API.

    python chip_smoke.py           # one GPU: every single-device phase
    python chip_smoke.py --four    # four GPUs: the sharded modes only

Each phase prints one JSON line with its numbers and tolerances; a failed
check raises, and the script exits non-zero. The last line of a passing run
is ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
Without a GPU the script exits non-zero before any phase runs: a CPU number
is not a device number.

Single-GPU phases, on the flagship configuration (``bench_scene(100_000)``
at 1920x1080, 1 spp, 8 bounces, wavefront, Russian roulette, threefry):

1. flagship   Renderer.step through the backend's default tracer.
2. oracle_img 192x96, 4 bounces: default tracer vs the brute tracer.
3. oracle_hit 65,536 rays: kernel (t, triangle) vs brute force.
4. golden     scene1 vs tests/golden_scene1.npz (cluster and kernel).
5. cli        ``python -m unityraytracer_tpu render`` writes a PNG.
6. tracers    flagship ms/frame of pallas, cluster and bvh.
7. profile    Renderer.profile: the Triton kernel is a device stage.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
BENCH_CAMERA = dict(position=(0.0, 14.0, -42.0), look_at=(0.0, 2.0, 0.0),
                    fov_y_deg=60.0)
FLAGSHIP = dict(width=1920, height=1080, spp=1, bounces=8, wavefront=True,
                russian_roulette=True, rng_impl="threefry2x32")
ORACLE_RMSE = 1e-3     # the cross-tracer gate of bench.py and the tests
HIT_ID_FRAC = 0.999    # near-tie winners may flip under another FMA order
HIT_REL_T = 1e-5


def emit(**kw) -> None:
    print(json.dumps(kw), flush=True)


def gpu_name_and_power_limit() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def bench_camera(width: int, height: int):
    from unityraytracer_tpu import Camera

    return Camera.create(aspect=width / height, **BENCH_CAMERA)


def flagship_config():
    from unityraytracer_tpu import RenderConfig
    from unityraytracer_tpu.render import default_tracer

    return RenderConfig(tracer=default_tracer(), **FLAGSHIP)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


# -- phases ------------------------------------------------------------------

def phase_flagship(scene, cfg, frames: int = 4):
    """A warm-up step of ``frames`` frames (it compiles that block), then
    the timed one; returns the renderer (reused by the profile phase)."""
    import jax
    from unityraytracer_tpu import Renderer
    from unityraytracer_tpu.ops.bvh import build_accel
    from unityraytracer_tpu.render import get_tracer, render_sample

    cam = bench_camera(cfg.width, cfg.height)
    t0 = time.perf_counter()
    accel = build_accel(scene, cfg)
    build_s = time.perf_counter() - t0
    r = Renderer(scene, cam, cfg, accel=accel, seed=0)
    t0 = time.perf_counter()
    r.step(frames)
    first_s = time.perf_counter() - t0
    r.step(frames)
    ms = r.stats["ms_per_frame"]
    img = r.image
    check(bool(np.isfinite(img).all()), "flagship image has non-finite pixels")
    check(float(img.mean()) > 1e-2, f"flagship image is black ({img.mean()})")
    alive_total = float(jax.jit(lambda s, c, a, k: render_sample(
        s, get_tracer(s, cfg, a), c, k, cfg, with_alive_count=True)[1])(
            r.scene, r.camera, r.accel, jax.random.key(0)))
    alive = alive_total / (cfg.num_rays * cfg.bounces)
    check(0.0 < alive <= 1.0, f"alive fraction {alive}")
    emit(phase="flagship", tracer=cfg.tracer, width=cfg.width,
         height=cfg.height, spp=cfg.spp, bounces=cfg.bounces,
         triangles=scene.num_triangles, frames=frames, ms_per_frame=ms,
         mrays_per_sec=r.stats["mrays_per_sec"],
         compile_s=first_s - frames * ms / 1000.0, accel_build_s=build_s,
         alive_fraction=alive, image_mean=float(img.mean()))
    return r


def phase_oracle_image(scene, cfg, width: int = 192, height: int = 96,
                       bounces: int = 4):
    """Default tracer vs the brute tracer: same threefry key, so the same
    estimator decisions; only float op order differs."""
    import jax
    from unityraytracer_tpu.ops.bvh import build_accel
    from unityraytracer_tpu.render import get_tracer, render_frame, \
        render_sample
    from unityraytracer_tpu.utils.image import rmse

    ccfg = cfg.replace(width=width, height=height, bounces=bounces)
    bcfg = ccfg.replace(tracer="brute", ray_chunk=1024)
    cam = bench_camera(width, height)
    key = jax.random.key(42, impl=cfg.rng_impl)
    accel = build_accel(scene, ccfg)
    with jax.default_matmul_precision("highest"):
        fast = np.asarray(jax.jit(
            lambda s, c, a, k: render_frame(s, ccfg, c, k, a))(
                scene, cam, accel, key))
        oracle = np.asarray(jax.jit(
            lambda s, c, k: render_sample(s, get_tracer(s, bcfg), c, k,
                                          bcfg))(scene, cam, key))
    err = float(rmse(fast, oracle))
    emit(phase="oracle_img", tracer=ccfg.tracer, width=width, height=height,
         bounces=bounces, rmse=err, tol=ORACLE_RMSE)
    check(np.isfinite(fast).all() and err < ORACLE_RMSE,
          f"{ccfg.tracer} image vs brute: RMSE {err}")


def probe_rays(scene, n_camera: int, n_random: int, seed: int = 0):
    """Camera rays of the bench view plus rays from random points inside
    the scene bounds, two thirds aimed at random triangle centroids and one
    third in random directions, and an alive mask with ~10% dead rays.
    Host numpy, (N, 3) origins and directions."""
    from unityraytracer_tpu.camera import camera_rays_soa

    rng = np.random.default_rng(seed)
    w = int(np.sqrt(n_camera * 2))
    h = n_camera // w
    cam = bench_camera(w, h)
    px, py = np.meshgrid(np.arange(w), np.arange(h))
    u = ((px + 0.5) / w * 2 - 1).reshape(-1).astype(np.float32)
    v = ((h - 1 - py + 0.5) / h * 2 - 1).reshape(-1).astype(np.float32)
    z = np.zeros_like(u)
    ro_c, rd_c = camera_rays_soa(cam, u, v, z, z)
    tr = scene.triangles
    centroid = (np.asarray(tr.v0) + np.asarray(tr.v1)
                + np.asarray(tr.v2)) / 3.0
    lo, hi = centroid.min(0), centroid.max(0)
    ro_r = rng.uniform(lo, hi, (n_random, 3)).astype(np.float32)
    rd_r = centroid[rng.integers(0, len(centroid), n_random)] - ro_r
    rd_r[::3] = rng.normal(size=rd_r[::3].shape)
    rd_r = (rd_r / np.linalg.norm(rd_r, axis=1, keepdims=True)).astype(
        np.float32)
    ro = np.concatenate([np.stack([np.asarray(c) for c in ro_c], 1), ro_r])
    rd = np.concatenate([np.stack([np.asarray(c) for c in rd_c], 1), rd_r])
    alive = rng.uniform(size=len(ro)) > 0.1
    return ro, rd, alive


def brute_triangle_hits(scene, ro, rd, chunk: int = 256):
    """Closest triangle (t, index into scene.triangles) by testing every
    triangle: trace_brute's triangle candidate, without the attributes."""
    import jax
    import jax.numpy as jnp
    from unityraytracer_tpu.ops.intersect import intersect_triangles

    tr = jax.device_put(scene.triangles)
    n = len(ro)
    pad = -n % chunk

    def one(rays):
        t, _, _ = intersect_triangles(tuple(rays[:, k] for k in range(3)),
                                      tuple(rays[:, 3 + k] for k in range(3)),
                                      tr.v0, tr.v1, tr.v2)
        return jnp.min(t, 1), jnp.argmin(t, 1)

    rays = np.pad(np.concatenate([ro, rd], 1), ((0, pad), (0, 0)))
    t, i = jax.jit(lambda r: jax.lax.map(one, r))(
        rays.reshape(-1, chunk, 6).astype(np.float32))
    return np.asarray(t).reshape(-1)[:n], np.asarray(i).reshape(-1)[:n]


def compare_hits(scene, accel, kt, kid, bt, bid, alive):
    """Kernel vs brute hits: (hit/miss mismatches, same-id fraction among
    hits, max relative t error where the ids agree)."""
    miss = np.finfo(np.float32).max
    hk = kt < miss
    hb = (bt < miss) & alive
    both = hk & hb
    same = np.ones(int(both.sum()), bool)
    for name in ("v0", "v1", "v2"):
        got = np.asarray(getattr(accel.triangles, name))[kid[both]]
        want = np.asarray(getattr(scene.triangles, name))[bid[both]]
        same &= np.all(got == want, axis=1)
    rel = (np.abs(kt[both][same] - bt[both][same]) / bt[both][same])
    return (int((hk != hb).sum()), int(hb.sum()),
            float(same.mean()) if same.size else 1.0,
            float(rel.max()) if rel.size else 0.0)


def phase_oracle_hits(scene, cfg, n_camera: int = 32_768,
                      n_random: int = 32_768):
    import jax
    import jax.numpy as jnp
    from unityraytracer_tpu.ops import gpu_trace
    from unityraytracer_tpu.ops.bvh import build_accel

    accel = build_accel(scene, cfg)
    ro, rd, alive = probe_rays(scene, n_camera, n_random)
    soa = lambda a: tuple(jnp.asarray(a[:, k]) for k in range(3))
    t0 = time.perf_counter()
    kt, _, _, kid = jax.jit(gpu_trace.trace_triangles)(
        jax.device_put(accel), soa(ro), soa(rd), jnp.asarray(alive))
    kt, kid = np.asarray(kt), np.asarray(kid)
    kernel_s = time.perf_counter() - t0
    with jax.default_matmul_precision("highest"):
        bt, bid = brute_triangle_hits(scene, ro, rd)
    mismatch, hits, same, rel = compare_hits(scene, accel, kt, kid, bt, bid,
                                             alive)
    emit(phase="oracle_hit", rays=len(ro), dead=int((~alive).sum()),
         hits=hits, hit_miss_mismatch=mismatch, same_id_frac=same,
         same_id_tol=HIT_ID_FRAC, max_rel_t=rel, rel_t_tol=HIT_REL_T,
         kernel_first_call_s=kernel_s)
    check(hits > len(ro) // 4, f"only {hits} of {len(ro)} rays hit")
    check(mismatch == 0, f"{mismatch} rays differ in hit/miss")
    check(same >= HIT_ID_FRAC, f"same triangle on {same} of hits")
    check(rel <= HIT_REL_T, f"relative t error {rel}")


def phase_golden():
    from unityraytracer_tpu import RenderConfig, Renderer
    from unityraytracer_tpu.models import fixtures
    from unityraytracer_tpu.render import default_tracer
    from unityraytracer_tpu.utils.image import rmse

    golden = np.load(os.path.join(ROOT, "tests", "golden_scene1.npz"))
    golden = golden["image"].astype(np.float32)
    scene = fixtures.scene1()
    cam = fixtures.scene1_camera(aspect=64 / 48)
    cfg = RenderConfig(width=64, height=48, spp=2, bounces=3,
                       ray_chunk=6144, cluster_size=32)
    errs = {}
    for tracer in sorted({"cluster", default_tracer()}):
        r = Renderer(scene, cam, cfg.replace(tracer=tracer), seed=123)
        errs[tracer] = float(rmse(r.step(8).image, golden))
    emit(phase="golden", rmse=errs, tol=ORACLE_RMSE)
    for tracer, err in errs.items():
        check(err < ORACLE_RMSE, f"golden scene1 via {tracer}: RMSE {err}")


def phase_cli():
    from unityraytracer_tpu.__main__ import main

    out_dir = os.path.join(ROOT, ".cache", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, "scene1.png")
    if os.path.exists(out):
        os.remove(out)
    t0 = time.perf_counter()
    rc = main(["render", "--scene", "scene1", "--frames", "4",
               "--width", "320", "--height", "240", "-o", out])
    emit(phase="cli", rc=rc, png_bytes=os.path.getsize(out),
         seconds=time.perf_counter() - t0)
    check(rc == 0 and os.path.getsize(out) > 1000, "CLI wrote no PNG")


def phase_tracers(r):
    """Flagship ms/frame of each accelerated tracer, one-frame steps after a
    compiling one; the default (``r``'s tracer) has to be the fastest."""
    from unityraytracer_tpu import Renderer

    cfg = r.config
    ms = {}
    for tracer in (cfg.tracer, "cluster", "bvh"):
        rt = r if tracer == cfg.tracer else Renderer(
            r.scene, r.camera, cfg.replace(tracer=tracer), accel=r.accel)
        t0 = time.perf_counter()
        rt.step(1)
        first_s = time.perf_counter() - t0
        rt.step(1)
        ms[tracer] = rt.stats["ms_per_frame"]
        check(bool(np.isfinite(rt.image).all()), f"{tracer}: non-finite")
        emit(phase="tracers", tracer=tracer, ms_per_frame=ms[tracer],
             compile_s=first_s - ms[tracer] / 1000.0)
    check(min(ms, key=ms.get) == cfg.tracer,
          f"default tracer {cfg.tracer} is not the fastest: {ms}")


def phase_profile(r):
    prof = r.profile(1)
    kernel = prof.per_occurrence_ms.get("trace_kernel", [])
    emit(phase="profile", device_ms=prof.total_ms, stages_ms=prof.stages_ms,
         trace_kernel_per_bounce_ms=kernel, top_ops=prof.top_ops[:8])
    check(len(kernel) == r.config.bounces,
          f"{len(kernel)} trace-kernel launches, want {r.config.bounces}")
    check(prof.top_ops[0][0] == "gpu_trace_kernel",
          f"top device op is {prof.top_ops[0][0]}")


# -- four GPUs ----------------------------------------------------------------

def _timed_ms(step, state, scene, cam, accel, key, n: int = 4):
    """Wall ms per frame of ``n`` one-frame sharded steps (compiled)."""
    import jax

    t0 = time.perf_counter()
    for i in range(n):
        state = step(state, scene, cam, accel, jax.random.fold_in(key, i), 1)
    jax.block_until_ready(state)
    return (time.perf_counter() - t0) / n * 1000.0


def phase_four(scene, cfg, n_dev: int = 4, n_hit_rays: int = 65_536):
    """make_sharded_step modes rows/spp/scene over ``n_dev`` devices, each
    against the single-device render of the same random streams."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from unityraytracer_tpu import RenderState
    from unityraytracer_tpu.ops.bvh import build_accel
    from unityraytracer_tpu.ops.traverse import make_accel_tracer
    from unityraytracer_tpu.parallel.scene_shard import (
        local_accel, make_scene_sharded_tracer, shard_scene_accels)
    from unityraytracer_tpu.parallel.sharding import (
        AXIS, create_sharded_state, gather_image, make_mesh,
        make_sharded_step)
    from unityraytracer_tpu.render import get_tracer, render_frame, \
        render_sample
    from unityraytracer_tpu.utils.image import rmse

    devices = jax.devices()[:n_dev]
    check(len(devices) == n_dev, f"need {n_dev} devices, have {devices}")
    mesh = make_mesh(devices)
    rep = NamedSharding(mesh, P())
    cam = bench_camera(cfg.width, cfg.height)
    host_accel = build_accel(scene, cfg)
    scene_rep = jax.device_put(scene, rep)
    accel_rep = jax.device_put(host_accel, rep)
    scene_1 = jax.device_put(scene, devices[0])
    accel_1 = jax.device_put(host_accel, devices[0])
    key = jax.random.key(7, impl=cfg.rng_impl)
    frame_key = jax.random.fold_in(key, 0)    # frame 0: n_samples == 0
    rays_per_frame = cfg.num_rays * cfg.bounces   # spp mode: per device

    def fresh_state(mode):
        if mode == "rows":
            return create_sharded_state(cfg, mesh)
        return jax.device_put(RenderState.create(cfg.width, cfg.height), rep)

    single = jax.jit(lambda s, c, a, k, row0, rows: render_frame(
        s, cfg, c, k, a, row0=row0, rows=rows), static_argnums=(5,))
    for mode in ("rows", "spp"):
        step = make_sharded_step(cfg, mesh, mode=mode)
        t0 = time.perf_counter()
        img = gather_image(step(fresh_state(mode), scene_rep, cam, accel_rep,
                                key, 1))
        first_s = time.perf_counter() - t0
        h = cfg.height // n_dev if mode == "rows" else cfg.height
        errs = []
        ref = np.zeros_like(img)
        for k in range(n_dev):
            # Device k draws fold_in(frame_key, k): its band (rows) or its
            # whole-frame sample (spp, pmean over devices).
            part = np.asarray(single(scene_1, cam, accel_1,
                                     jax.random.fold_in(frame_key, k),
                                     k * h if mode == "rows" else 0, h))
            if mode == "rows":
                errs.append(float(rmse(img[k * h:(k + 1) * h], part)))
            else:
                ref += part / n_dev
        if mode == "spp":
            errs.append(float(rmse(img, ref)))
        ms = _timed_ms(step, fresh_state(mode), scene_rep, cam, accel_rep,
                       key)
        emit(phase="four", mode=mode, devices=n_dev, rmse_vs_single=errs,
             tol=ORACLE_RMSE, first_call_s=first_s, ms_per_frame=ms,
             mrays_per_sec=rays_per_frame * (n_dev if mode == "spp" else 1)
             / ms / 1e3)
        check(bool(np.isfinite(img).all()) and max(errs) < ORACLE_RMSE,
              f"{mode}: sharded frame vs single device, RMSE {errs}")

    # scene: 1/n of the triangles per device, closest-hit all-reduce.
    accel_sh = jax.device_put(shard_scene_accels(scene, cfg, n_dev),
                              NamedSharding(mesh, P(AXIS)))
    ro, rd, _ = probe_rays(scene, n_hit_rays // 2, n_hit_rays // 2, seed=1)
    soa = lambda a: tuple(jnp.asarray(a[:, k]) for k in range(3))
    ro, rd = soa(ro), soa(rd)

    def sharded_hits(acc):
        hit = make_scene_sharded_tracer(scene_rep, local_accel(acc), cfg,
                                        AXIS, n_dev)(ro, rd)
        return hit.t, hit.normal

    t_sh, n_sh = jax.jit(jax.shard_map(
        sharded_hits, mesh=mesh, in_specs=(P(AXIS),), out_specs=P(),
        check_vma=False))(accel_sh)
    ref = jax.jit(lambda a: make_accel_tracer(scene_1, a, cfg)(ro, rd))(
        accel_1)
    t_sh, t_1 = np.asarray(t_sh), np.asarray(ref.t)
    hit = t_1 < 1e30
    mismatch = int(((t_sh < 1e30) != hit).sum())
    rel = float(np.max(np.abs(t_sh[hit] - t_1[hit]) / t_1[hit]))
    same_n = float(np.mean(np.all(np.stack(
        [np.abs(np.asarray(a) - np.asarray(b))[hit] < 1e-4
         for a, b in zip(n_sh, ref.normal)]), 0)))
    step = make_sharded_step(cfg, mesh, mode="scene")
    img = gather_image(step(fresh_state("scene"), scene_rep, cam, accel_sh,
                            key, 1))
    one = np.asarray(jax.jit(lambda s, c, a, k: render_sample(
        s, get_tracer(s, cfg, a), c, k, cfg))(scene_1, cam, accel_1,
                                             frame_key))
    err = float(rmse(img, one))
    ms = _timed_ms(step, fresh_state("scene"), scene_rep, cam, accel_sh, key)
    emit(phase="four", mode="scene", devices=n_dev, rays=len(t_1),
         hits=int(hit.sum()), hit_miss_mismatch=mismatch, max_rel_t=rel,
         rel_t_tol=HIT_REL_T, same_normal_frac=same_n,
         same_normal_tol=HIT_ID_FRAC, rmse_vs_single=err, tol=ORACLE_RMSE,
         ms_per_frame=ms, mrays_per_sec=rays_per_frame / ms / 1e3)
    check(mismatch == 0, f"scene: {mismatch} rays differ in hit/miss")
    check(rel <= HIT_REL_T, f"scene: relative t error {rel}")
    check(same_n >= HIT_ID_FRAC, f"scene: same normal on {same_n} of hits")
    check(err < ORACLE_RMSE, f"scene: sharded frame vs single, RMSE {err}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU sharded modes")
    args = ap.parse_args(argv)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke.py needs a GPU; JAX found {dev.platform}",
              file=sys.stderr)
        return 1

    from unityraytracer_tpu.models import fixtures
    from unityraytracer_tpu.utils.compcache import enable_persistent_cache

    card = gpu_name_and_power_limit()
    print(card, flush=True)
    emit(gpu=card, jax=jax.__version__, devices=[str(d) for d in jax.devices()],
         compile_cache=enable_persistent_cache())
    scene = fixtures.bench_scene(n_tris=100_000)
    cfg = flagship_config()
    if args.four:
        phase_four(scene, cfg)
        count = 4
    else:
        r = phase_flagship(scene, cfg)
        phase_oracle_image(scene, cfg)
        phase_oracle_hits(scene, cfg)
        phase_golden()
        phase_cli()
        phase_tracers(r)
        phase_profile(r)
        count = 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

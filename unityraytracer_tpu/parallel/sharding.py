"""Multi-chip scaling: framebuffer tiling and sample parallelism.

The reference is strictly single-GPU (SURVEY.md 2.4): its only parallelism is
one thread per pixel within a dispatch. The scale-out axes here are:

* **Framebuffer ("rows") sharding** — each device owns a disjoint horizontal
  band of the image with an independent counter-based RNG stream; scene, BVH
  and camera are replicated. Rendering is embarrassingly parallel, so the
  only collective in the whole frame is the implicit all-gather when the
  sharded accumulator is read back.

* **Sample ("spp") sharding** — every device renders the full frame with a
  different key; a ``psum``-mean merges them. The renderer analog of
  data-parallel gradient averaging; useful when one frame's rays can't
  saturate the devices but spp is high (SampleScene runs 25 rays/pixel,
  SampleScene.unity:434).

* **Scene ("scene") sharding** — each device holds 1/n of the TRIANGLES
  (Morton-contiguous chunk; see parallel/scene_shard.py), traces all rays
  against its sub-scene, and one packed all-reduce per bounce picks the
  global closest hit. The tensor-parallel axis: per-device accel memory
  scales 1/n. Each device's chunk is a ClusterAccel that the Triton kernel
  ("pallas") or the XLA tracers (cluster/bvh) walk.

* **Composed ("rows_scene") sharding** — a 2-D ``(rows, scene)`` mesh:
  framebuffer bands on the major axis, triangle shards on the minor, so a
  mesh scales PIXELS and ACCEL MEMORY simultaneously. Each device traces
  its band against its sub-scene; the per-bounce closest-hit all-reduce
  stays within a band's shard group, and bands never communicate until
  readback.

All are expressed with ``jax.shard_map`` over a flat device mesh (every
GPU of a host reaches every other over NVLink, so the mesh follows the
algorithm alone), and the same step function jits on 1 GPU, 4 GPUs, or a
CPU mesh of virtual devices (how the tests validate multi-device runs
without hardware).
"""

from __future__ import annotations

import functools
from typing import Callable, Optional, Sequence

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..camera import Camera
from ..config import RenderConfig
from ..render import (PreviewExportMixin, RenderState, get_tracer,
                      render_frame, render_sample)
from ..scene import Scene

AXIS = "devices"
ROW_AXIS, SCENE_AXIS = "rows", "scene"   # 2-D composed mesh axes


def make_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """1-D device mesh over all (or the given) devices."""
    devices = list(devices) if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (AXIS,))


def make_mesh2(n_rows: int, n_scene: int,
               devices: Optional[Sequence] = None) -> Mesh:
    """2-D ``(rows, scene)`` mesh: framebuffer bands on one axis, triangle
    shards on the other (mode "rows_scene"). A shard group's per-bounce
    closest-hit all-reduce runs over the scene axis; row bands never
    communicate until readback."""
    devices = list(devices) if devices is not None else jax.devices()
    if len(devices) < n_rows * n_scene:
        raise ValueError(f"need {n_rows * n_scene} devices, "
                         f"have {len(devices)}")
    arr = np.asarray(devices[:n_rows * n_scene]).reshape(n_rows, n_scene)
    return Mesh(arr, (ROW_AXIS, SCENE_AXIS))


def create_sharded_state(cfg: RenderConfig, mesh: Mesh) -> RenderState:
    """RenderState with the accumulator sharded by rows over the mesh
    (1-D rows mode, or the rows axis of a 2-D composed mesh)."""
    axis = AXIS if AXIS in mesh.shape else ROW_AXIS
    n = mesh.shape[axis]
    if cfg.height % n:
        raise ValueError(f"height {cfg.height} not divisible by {n} devices")
    accum = jax.device_put(
        jnp.zeros((cfg.height, cfg.width, 3), jnp.float32),
        NamedSharding(mesh, P(axis, None, None)))
    n_samples = jax.device_put(jnp.int32(0), NamedSharding(mesh, P()))
    return RenderState(accum=accum, n_samples=n_samples)


def make_sharded_step(cfg: RenderConfig, mesh: Mesh,
                      mode: str = "rows") -> Callable:
    """Build a jitted progressive step over the device mesh.

    Returns ``step(state, scene, camera, accel, key, n_frames=1) -> state``
    where state.accum is row-sharded ("rows" mode) or replicated ("spp"
    mode). ``n_frames`` (static) runs the whole block inside ONE jit
    dispatch via ``lax.fori_loop`` — same amortization as ``Renderer``'s
    fused step (render.py).
    Frame i draws ``fold_in(key, n_samples + i)`` then ``fold_in(_, dev)``
    per device, so a band's stream is a pure function of (key, sample
    index, device index) — what the deterministic band-equivalence test
    reconstructs single-device (tests/test_parallel.py).
    """
    n_dev = mesh.shape.get(AXIS, 0)   # 1-D modes; absent on the 2-D mesh
    if mode == "rows":
        h_local = cfg.height // n_dev

        def local_step(accum, n_samples, scene, camera, accel, key):
            dev = jax.lax.axis_index(AXIS)
            key = jax.random.fold_in(key, dev)  # independent stream per tile
            frame = render_frame(scene, cfg, camera, key, accel,
                                 row0=dev * h_local, rows=h_local)
            n = n_samples.astype(jnp.float32)
            accum = accum * (n / (n + 1.0)) + frame / (n + 1.0)
            return accum, n_samples + 1

        state_specs = (P(AXIS, None, None), P())
    elif mode == "spp":
        def local_step(accum, n_samples, scene, camera, accel, key):
            dev = jax.lax.axis_index(AXIS)
            key = jax.random.fold_in(key, dev)
            frame = render_frame(scene, cfg, camera, key, accel)
            frame = jax.lax.pmean(frame, AXIS)  # the only collective
            n = n_samples.astype(jnp.float32)
            accum = accum * (n / (n + 1.0)) + frame / (n + 1.0)
            return accum, n_samples + 1

        state_specs = (P(), P())
    elif mode == "scene":
        from .scene_shard import local_accel, make_scene_sharded_tracer

        if cfg.tracer not in ("cluster", "bvh", "pallas"):
            raise ValueError(
                "scene sharding traces per-shard accels (got "
                f"tracer={cfg.tracer!r}); use pallas/cluster/bvh")

        def local_step(accum, n_samples, scene, camera, accel, key):
            # SAME key on every device: shading/RNG replicate, tracing is
            # sharded, so every device computes the identical full frame
            # after the closest-hit all-reduce.
            tracer = make_scene_sharded_tracer(scene, local_accel(accel),
                                               cfg, AXIS, n_dev)
            frame = render_sample(scene, tracer, camera, key, cfg)
            n = n_samples.astype(jnp.float32)
            accum = accum * (n / (n + 1.0)) + frame / (n + 1.0)
            return accum, n_samples + 1

        state_specs = (P(), P())
    elif mode == "rows_scene":
        # Composed 2-D sharding: each (row-band, triangle-shard) device
        # traces ITS band of rays against ITS 1/n_scene of the triangles;
        # the per-bounce closest-hit all-reduce runs over the scene axis
        # only (a band's shard group), and bands stay independent — pixels
        # and accel memory scale simultaneously. RNG folds the ROW index
        # only: every shard of a band must draw the identical stream (the
        # all-reduce assumes devices trace the same rays), and a band's
        # stream is then exactly the 1-D rows-mode stream, which is what
        # the equivalence test checks against.
        from .scene_shard import local_accel, make_scene_sharded_tracer

        if cfg.tracer not in ("cluster", "bvh", "pallas"):
            raise ValueError(
                f"rows_scene sharding traces per-shard accels (got "
                f"tracer={cfg.tracer!r}); use pallas/cluster/bvh")
        n_rows = mesh.shape[ROW_AXIS]
        n_sc = mesh.shape[SCENE_AXIS]
        h_local = cfg.height // n_rows

        def local_step(accum, n_samples, scene, camera, accel, key):
            dev = jax.lax.axis_index(ROW_AXIS)
            key = jax.random.fold_in(key, dev)
            tracer = make_scene_sharded_tracer(scene, local_accel(accel),
                                               cfg, SCENE_AXIS, n_sc)
            frame = render_sample(scene, tracer, camera, key, cfg,
                                  row0=dev * h_local, rows=h_local)
            n = n_samples.astype(jnp.float32)
            accum = accum * (n / (n + 1.0)) + frame / (n + 1.0)
            return accum, n_samples + 1

        state_specs = (P(ROW_AXIS, None, None), P())
    else:
        raise ValueError(f"unknown sharding mode {mode!r}")

    accel_spec = (P(AXIS) if mode == "scene"
                  else P(SCENE_AXIS) if mode == "rows_scene" else P())
    shmapped = jax.shard_map(
        local_step, mesh=mesh,
        in_specs=state_specs + (P(), P(), accel_spec, P()),
        out_specs=state_specs,
        check_vma=False,
    )

    @functools.partial(jax.jit, donate_argnums=(0,), static_argnums=(5,))
    def step(state: RenderState, scene: Scene, camera: Camera, accel, key,
             n_frames: int = 1):
        def body(_, st):
            sub = jax.random.fold_in(key, st.n_samples)
            accum, n_samples = shmapped(st.accum, st.n_samples, scene,
                                        camera, accel, sub)
            return RenderState(accum=accum, n_samples=n_samples)

        return jax.lax.fori_loop(0, n_frames, body, state)

    return step


def gather_image(state: RenderState) -> np.ndarray:
    """Explicit readback: all-gather the sharded accumulator to the host."""
    return np.asarray(jax.device_get(state.accum))


class ShardedRenderer(PreviewExportMixin):
    """Multi-chip progressive renderer (Renderer analog over a mesh) —
    the full preview/export surface (watch/denoise/AOVs/EXR) rides along
    via PreviewExportMixin."""

    def _aov_accel(self):
        # AOVs are a cheap single-bounce G-buffer trace through the plain
        # single-device path; scene-sharded modes have no full-scene accel
        # on any one device, so build (and cache) a host-side LBVH for it.
        if self.mode in ("scene", "rows_scene"):
            if getattr(self, "_aov_accel_cache", None) is None:
                from ..ops.bvh import build_cluster_accel
                self._aov_accel_cache = jax.device_put(build_cluster_accel(
                    self._host_scene.triangles,
                    cluster_size=self.config.cluster_size))
            return self._aov_accel_cache
        return self.accel

    def __init__(self, scene: Scene, camera: Camera, config: RenderConfig,
                 mesh: Optional[Mesh] = None, accel=None, seed: int = 0,
                 mode: str = "rows"):
        self.camera = camera
        self.config = config
        if mesh is None:
            mesh = (make_mesh() if mode != "rows_scene"
                    else make_mesh2(len(jax.devices()) // 2, 2))
        self.mesh = mesh
        rep = NamedSharding(self.mesh, P())
        if mode in ("scene", "rows_scene"):
            # Tensor-parallel axis: 1/n of the triangles (and accel) per
            # device (per scene-axis shard group on the composed 2-D
            # mesh). Host build -> ONE scatter device_put.
            from .scene_shard import shard_scene_accels
            axis = AXIS if mode == "scene" else SCENE_AXIS
            n_sc = self.mesh.shape[axis]
            if accel is None:
                accel = shard_scene_accels(scene, config, n_sc)
            self.accel = jax.device_put(accel,
                                        NamedSharding(self.mesh, P(axis)))
        else:
            if accel is None and config.tracer not in ("brute",):
                from ..ops import bvh
                accel = bvh.build_accel(scene, config)
            # Replicate the accel across the mesh once (host numpy ->
            # devices).
            self.accel = (jax.device_put(accel, rep)
                          if accel is not None else None)
        self._host_scene = scene      # pre-device copy (AOV accel builds)
        self.scene = jax.device_put(scene, rep)
        self.mode = mode
        self._key = jax.random.key(seed, impl=config.rng_impl)
        self._step = make_sharded_step(config, self.mesh, mode)
        self.state = (create_sharded_state(config, self.mesh)
                      if mode in ("rows", "rows_scene")
                      else RenderState.create(config.width, config.height))
        self.stats = {}

    def step(self, n_frames: int = 1, fused: bool = True) -> "ShardedRenderer":
        """Advance the progressive render; records wall-clock throughput in
        ``self.stats`` (Renderer.step parity — Mrays/s here counts slots
        across the WHOLE mesh: all devices trace their bands concurrently).

        ``fused=True`` advances all ``n_frames`` inside ONE jitted dispatch
        (one fori_loop; recompiles per distinct n_frames)."""
        import time as _time

        t0 = _time.perf_counter()
        if fused:
            self._key, sub = jax.random.split(self._key)
            self.state = self._step(self.state, self.scene, self.camera,
                                    self.accel, sub, n_frames)
        else:
            for _ in range(n_frames):
                self._key, sub = jax.random.split(self._key)
                self.state = self._step(self.state, self.scene, self.camera,
                                        self.accel, sub, 1)
        jax.block_until_ready(self.state)
        dt = _time.perf_counter() - t0
        rays = self.config.num_rays * self.config.bounces * n_frames
        self.stats = dict(frames=n_frames, seconds=dt,
                          ms_per_frame=dt / n_frames * 1000.0,
                          mrays_per_sec=rays / dt / 1e6)
        return self

    def profile(self, n_frames: int = 1):
        """Per-stage device-time breakdown of the sharded frame step
        (Renderer.profile parity; see utils/profiling.py)."""
        from ..utils.profiling import profile_stages

        def one_frame():
            self._key, sub = jax.random.split(self._key)
            self.state = self._step(self.state, self.scene, self.camera,
                                    self.accel, sub, 1)

        def run():
            for _ in range(n_frames):
                one_frame()
            return self.state

        # Warm the 1-frame jit cache outside the trace window (Renderer
        # .profile rationale: a cold compile inside the window hides the
        # device rows behind host seconds).
        one_frame()
        jax.block_until_ready(self.state)
        prof = profile_stages(run)
        self.stats["device"] = prof
        return prof

    @property
    def image(self) -> np.ndarray:
        return gather_image(self.state)

    @property
    def sample_count(self) -> int:
        return int(np.asarray(jax.device_get(self.state.n_samples)))

    # -- export / checkpoint (Renderer parity across the mesh) ---------------
    def save_screenshot(self, path=None, tonemap: bool = True) -> str:
        """PNG export of the gathered framebuffer (Renderer analog)."""
        import os
        import time as _time
        from ..utils.image import tonemap_aces, write_png

        if path is None:
            os.makedirs("Screenshots", exist_ok=True)
            path = os.path.join(
                "Screenshots", f"{int(_time.time())}-{self.sample_count}.png")
        img = self.image
        return write_png(path, tonemap_aces(img) if tonemap else img)

    def save_state(self, path: str) -> str:
        """Checkpoint the gathered accumulator + RNG key; resumable on any
        mesh shape (load re-shards by rows). Returns the REAL file written
        (np.savez appends ``.npz`` to names missing it)."""
        if not path.endswith(".npz"):
            path += ".npz"
        np.savez(path, accum=self.image,
                 n_samples=np.int32(self.sample_count),
                 key=np.asarray(jax.random.key_data(self._key)))
        return path

    def load_state(self, path: str) -> "ShardedRenderer":
        data = np.load(path)
        accum = jnp.asarray(data["accum"])
        n = jnp.int32(int(data["n_samples"]))
        if self.mode in ("rows", "rows_scene"):
            axis = AXIS if self.mode == "rows" else ROW_AXIS
            sharding = NamedSharding(self.mesh, P(axis, None, None))
            accum = jax.device_put(accum, sharding)
            n = jax.device_put(n, NamedSharding(self.mesh, P()))
        self.state = RenderState(accum=accum, n_samples=n)
        self._key = jax.random.wrap_key_data(
            jnp.asarray(data["key"]), impl=self.config.rng_impl)
        return self

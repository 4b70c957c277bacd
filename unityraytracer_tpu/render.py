"""Frame rendering: path-traced sample pass + progressive accumulation.

This reimagines the reference's host frame driver
(`RayTraceMaster.cs:751-866`) and device megakernel
(`RayTraceShader.compute:431-469`):

* ``render_sample``: one full frame of ``spp`` jittered camera rays per pixel,
  bounced ``bounces`` times — a single jitted function (the megakernel's two
  nested loops become a batched bounce loop over SoA ray arrays).
* ``progressive_step``: the AdditionShader running mean — frame N blended with
  weight 1/(N+1) (`AdditionShader.shader:40`), as explicit jit-carried state.
* ``Renderer``: convenience driver with reference reset semantics (camera
  moved / scene dirty / resize -> sample counter back to 0,
  `RayTraceMaster.cs:765-768,843,852`).
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import dataclasses
import numpy as np
import jax
import jax.numpy as jnp

from .camera import Camera, camera_rays_soa
from .config import RenderConfig
from .ops import vec as vec_ops
from .ops.shade import Hit, sample_skybox, sample_skybox_rgbe, shade
from .ops.sampling import sample_unit_disk
from .ops import trace as trace_ops
from .scene import Scene


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class RenderState:
    """Progressive accumulation state (the _converged texture + _currentSample)."""

    accum: jnp.ndarray      # (H, W, 3) running mean, linear radiance
    n_samples: jnp.ndarray  # () int32 frames accumulated

    @staticmethod
    def create(width: int, height: int) -> "RenderState":
        return RenderState(accum=jnp.zeros((height, width, 3), jnp.float32),
                           n_samples=jnp.int32(0))


def default_tracer(backend: Optional[str] = None) -> str:
    """The tracer to use on a backend (default: JAX's default backend).

    "pallas" (the Triton closest-hit kernel, ``ops/gpu_trace.py``) on a GPU;
    "cluster" on the CPU, where the kernel has no compiled form.
    """
    backend = backend or jax.default_backend()
    if backend == "gpu":
        return "pallas"
    if backend == "cpu":
        return "cluster"
    raise ValueError(f"no tracer for backend {backend!r} (gpu or cpu)")


def get_tracer(scene: Scene, cfg: RenderConfig, accel=None) -> Callable:
    """Resolve cfg.tracer to a ``fn(ro, rd) -> Hit`` closure.

    Scene/accel may arrive with host-numpy leaves (fresh from the builders);
    they are converted here so traced code can index them. Under jit the
    leaves are already tracers and the conversion is a no-op.
    """
    scene = jax.tree_util.tree_map(jnp.asarray, scene)
    if accel is not None:
        accel = jax.tree_util.tree_map(jnp.asarray, accel)
    if cfg.tracer == "brute":
        return trace_ops.make_brute_tracer(scene, chunk=cfg.ray_chunk)
    if cfg.tracer in ("bvh", "cluster", "pallas"):
        from .ops import traverse  # deferred: needs accel structures
        return traverse.make_accel_tracer(scene, accel, cfg)
    raise ValueError(f"unknown tracer {cfg.tracer!r}")


def _rr_uniform(key, cfg: RenderConfig, spp: int, h: int, W: int,
                row0: int, to_blocks: Callable) -> jnp.ndarray:
    """Russian-roulette uniforms, per ray or shared per (8, 128)-pixel
    group (cfg.rr_group == "step"). Groups are defined on ABSOLUTE output
    coordinates, so every tracer path and every sharded band draws identical
    decisions; the broadcast construction needs no gathers."""
    N = spp * h * W
    if cfg.rr_group != "step":
        return to_blocks(jax.random.uniform(key, (N,)))
    Hg = (cfg.height + 7) // 8
    Wg = (W + 127) // 128
    ug = jax.random.uniform(key, (spp, Hg, Wg))
    full = jnp.broadcast_to(ug[:, :, None, :, None],
                            (spp, Hg, 8, Wg, 128)) \
        .reshape(spp, Hg * 8, Wg * 128)
    # row0 is TRACED under shard_map (dev * h_local from axis_index) — a
    # Python slice would demand a static start; dynamic_slice keeps the
    # absolute-coordinate group property across sharded bands.
    band = jax.lax.dynamic_slice_in_dim(full, row0, h, axis=1)
    return to_blocks(band[:, :, :W].reshape(N))


def _ray_lattice(h: int, W: int, spp: int, blocked: bool):
    """Per-ray pixel coordinates (px, row-in-band) as flat (N,) int32 in
    RAY-LAYOUT order: 8x16 pixel-block order when ``blocked``, row-major
    pixel order otherwise. Pure iota arithmetic — it fuses into the
    camera-ray elementwise chain instead of six per-component ``to_blocks``
    transposes."""
    N = spp * h * W
    n = jnp.arange(N, dtype=jnp.int32)
    if blocked:
        w16 = W // 16
        px = (n // 128) % w16 * 16 + n % 16
        row = (n // (128 * w16)) % (h // 8) * 8 + (n // 16) % 8
    else:
        px = n % W
        row = (n // W) % h
    return px, row


def _draw_fn(h: int, W: int, spp: int, blocked: bool):
    """Canonical per-ray uniform assignment, shared by every tracer path.

    At sizes that tile into 8x16 pixel blocks, pixel p's draw is the flat
    threefry/rbg element at p's BLOCK slot — the Pallas tracer's native ray
    order — so the flagship path consumes every uniform row with ZERO
    relayout ops. The permute moves to the PIXEL-order paths (the
    brute/cluster/bvh tracers). Returns
    ``f(flat_draw) -> draw in ray-layout order``. Non-tiling sizes keep the
    pixel-order assignment everywhere. Either way the assignment is a
    bijection fixed by (h, W, spp) alone, so the estimator is unbiased and
    all tracers stay stream-identical (render_sample's ``uniform``
    rationale)."""
    N = spp * h * W
    if blocked or not (h % 8 == 0 and W % 16 == 0):
        return lambda a: a
    def to_pixel_order(a):
        # pixel p's value = flat_draw[block_slot(p)]
        return (a.reshape(spp, h // 8, W // 16, 8, 16)
                .transpose(0, 1, 3, 2, 4).reshape(N))
    return to_pixel_order


def _env_tap(scene: Scene, sky_d, su1, su2):
    """Once-per-frame environment resolve for the recorded miss directions:
    the stochastic RGBE tap (`ops/shade.py`), or the bilinear lookup when
    the frame draws no tap uniforms. Reference behavior: sky sampled at ray
    miss, ``RayTraceShader.compute:424-426``."""
    if su1 is None:
        return sample_skybox(scene.skybox, sky_d)
    return sample_skybox_rgbe(scene.skybox, sky_d, u1=su1, u2=su2,
                              packed=scene.skybox_rgbe)


def render_sample(scene: Scene, tracer: Callable, camera: Camera, key,
                  cfg: RenderConfig, row0: int = 0,
                  rows: Optional[int] = None,
                  with_alive_count: bool = False) -> jnp.ndarray:
    """Render one frame band: (rows, W, 3) linear radiance, mean over spp.

    Row 0 of the full output is the TOP of the image. ``row0``/``rows``
    select a horizontal band of the full cfg.height image — the unit of
    multi-chip framebuffer sharding (each device renders disjoint bands with
    its own RNG stream; see parallel/sharding.py).

    ``with_alive_count``: also return the summed per-bounce alive-ray count
    (rays ENTERING each bounce, after miss/energy/roulette termination of
    the previous one) — the honest "effective rays traced" denominator next
    to the dispatched-slot count W*H*spp*bounces (bench.py reports both;
    the estimator streams are tracer-identical, so this count measured on
    any tracer applies to all of them).
    """
    H, W, spp = cfg.height, cfg.width, cfg.spp
    h = H if rows is None else rows
    N = h * W * spp
    # Host-numpy scene leaves cannot be indexed by traced values.
    scene = jax.tree_util.tree_map(jnp.asarray, scene)

    k_jit, k_lens, k_bounce = jax.random.split(key, 3)

    # Tile coherence: the Pallas tracer walks the BVH once per 128-ray tile,
    # so 8x16 PIXEL blocks keep a tile's rays spatially compact (row-major
    # order would make 128x1 slivers that span the scene and defeat
    # culling). Rays are GENERATED in block order (lattice index math, no
    # permute op); radiance is un-permuted at the end.
    blocked = cfg.tracer == "pallas" and h % 8 == 0 and W % 16 == 0
    draw = _draw_fn(h, W, spp, blocked)

    # Pixel lattice: output row r (top-down) is pixel row py = H-1-r counted
    # bottom-up (NDC v points up). All ray state is component-SoA (N,) arrays
    # (see ops/vec.py).
    px, prow = _ray_lattice(h, W, spp, blocked)
    py = (H - 1) - (row0 + prow)
    jx = draw(jax.random.uniform(jax.random.fold_in(k_jit, 0), (N,)))
    jy = draw(jax.random.uniform(jax.random.fold_in(k_jit, 1), (N,)))
    u = (px.astype(jnp.float32) + jx) / W * 2.0 - 1.0
    v = (py.astype(jnp.float32) + jy) / H * 2.0 - 1.0

    # Thin-lens offsets are generated unconditionally (cheap) and are a no-op
    # when aperture == 0; keeps the traced graph static across camera params.
    lu1 = draw(jax.random.uniform(jax.random.fold_in(k_lens, 0), (N,)))
    lu2 = draw(jax.random.uniform(jax.random.fold_in(k_lens, 1), (N,)))
    lens_u, lens_v = sample_unit_disk(lu1, lu2)

    ro, rd = camera_rays_soa(camera, u, v, lens_u, lens_v)

    if blocked:
        # Layout permute (pixel order -> ray order), still used by
        # _rr_uniform's absolute-coordinate group construction.
        def to_blocks(a):
            return (a.reshape(spp, h // 8, 8, W // 16, 16)
                    .transpose(0, 1, 3, 2, 4).reshape(N))
    else:
        def to_blocks(a):
            return a

    def uniform(key_):
        # Every per-ray uniform follows the canonical _draw_fn assignment:
        # pixel p consumes the same random stream in every tracer and every
        # ray layout, so golden tests compare the Pallas path against the
        # brute oracle at float precision instead of Monte-Carlo noise.
        return draw(jax.random.uniform(key_, (N,)))

    one = jnp.ones((N,), jnp.float32)
    zero = jnp.zeros((N,), jnp.float32)
    energy = (one, one.copy(), one.copy())
    radiance = (zero, zero.copy(), zero.copy())
    # Deferred environment: record (direction, throughput) at each ray's
    # first miss; resolve the skybox ONCE after the bounce loop instead of
    # the reference's per-bounce sky sampling (compute:424-426).
    sky_e = (zero.copy(), zero.copy(), zero.copy())
    sky_d = (zero.copy(), one.copy(), zero.copy())

    # Bounce loop (compute:453-461). Static trip count; dead lanes carry zero
    # energy. The ``alive`` mask is handed to the tracer every bounce: the
    # Pallas tracer zero-seeds dead rays' best-t so every culling test fails,
    # and a tile of dead rays stops after one pop (the static-shape form of
    # the reference's per-thread early-out, compute:457-460).
    alive = jnp.ones((N,), bool)
    alive_total = jnp.zeros((), jnp.float32)
    for b in range(cfg.bounces):
        if with_alive_count:
            alive_total = alive_total + jnp.sum(alive.astype(jnp.float32))
        hit = tracer(ro, rd, alive)
        kb = jax.random.fold_in(k_bounce, b)
        uniforms = tuple(uniform(jax.random.fold_in(kb, i))
                         for i in range(3))
        energy_before = energy
        with jax.named_scope("shade"):
            ro, rd_new, energy, contrib, missed = shade(ro, rd, energy, hit,
                                                        uniforms)
        radiance = vec_ops.add(radiance, contrib)
        record = missed & alive
        sky_e = vec_ops.where(record, energy_before, sky_e)
        sky_d = vec_ops.where(record, rd, sky_d)
        rd = rd_new
        alive = alive & ~missed & ((energy[0] > 0) | (energy[1] > 0)
                                   | (energy[2] > 0))
        if cfg.russian_roulette and 2 <= b < cfg.bounces - 1:
            # Unbiased Russian roulette from bounce 3: kill with probability
            # 1 - max(energy), boost survivors by 1/p. Deep-bounce ray
            # populations collapse, and the wavefront parking below turns
            # that directly into skipped kernel tiles. (The reference never
            # terminates by throughput: its lobe chances are normalized to
            # sum to 1, compute:392-394 — rays only die by missing.)
            u_rr = _rr_uniform(jax.random.fold_in(kb, 3), cfg, spp, h, W,
                               row0, to_blocks)
            p_surv = jnp.clip(jnp.maximum(jnp.maximum(energy[0], energy[1]),
                                          energy[2]), 0.05, 1.0)
            keep = u_rr < p_surv
            boost = jnp.where(keep, 1.0 / p_surv, 0.0)
            energy = vec_ops.scale(energy, boost)
            alive = alive & keep
        if cfg.wavefront and b + 1 < cfg.bounces:
            # Park dead rays far outside every acceleration structure pointing
            # away from the scene — the XLA tracers (cluster sweep / stack
            # BVH) then cull them naturally. The Pallas tracer already skips
            # dead rays via the alive mask; parking is harmless there.
            ro = vec_ops.where(alive, ro, vec_ops.splat((1e7, 1e7, 1e7), ro[0]))
            rd = vec_ops.where(alive, rd, vec_ops.splat((0.0, 1.0, 0.0), rd[0]))

    if cfg.sky_rgbe:
        ks = jax.random.fold_in(k_bounce, cfg.bounces)
        su1 = uniform(jax.random.fold_in(ks, 0))
        su2 = uniform(jax.random.fold_in(ks, 1))
    else:
        su1 = su2 = None
    with jax.named_scope("env_lookup"):
        sky = _env_tap(scene, sky_d, su1, su2)
    radiance = vec_ops.add(radiance, vec_ops.mul(sky_e, sky))

    if blocked:
        def from_blocks(a):
            return (a.reshape(spp, h // 8, W // 16, 8, 16)
                    .transpose(0, 1, 3, 2, 4).reshape(spp, h, W))

        radiance = tuple(from_blocks(c) for c in radiance)
    # Stack to (h, W, 3) only at the very end (single boundary transpose).
    img = jnp.stack([c.reshape(spp, h, W).mean(axis=0) for c in radiance],
                    axis=-1)
    if with_alive_count:
        return img, alive_total
    return img


def render_frame(scene: Scene, cfg: RenderConfig, camera: Camera, key,
                 accel=None, row0: int = 0, rows: Optional[int] = None
                 ) -> jnp.ndarray:
    """One sample frame: ``render_sample`` through cfg's tracer.

    When ``cfg.spp_chunk`` caps the per-dispatch sample count, the frame
    renders as sequential sub-frames of ``spp_chunk`` samples (lax.map
    over independently folded keys — one traced body, no graph
    duplication) plus one remainder sub-frame, averaged with exact
    spp weights. See RenderConfig.spp_chunk for the estimator notes.
    """
    chunk = cfg.spp_chunk
    if chunk and cfg.spp > chunk:
        n_full, rem = divmod(cfg.spp, chunk)
        sub = cfg.replace(spp=chunk, spp_chunk=None)

        def one(k):
            return render_frame(scene, sub, camera, k, accel, row0, rows)

        keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(
            jnp.arange(n_full))
        img = jax.lax.map(one, keys).sum(axis=0) * (chunk / cfg.spp)
        if rem:
            subr = cfg.replace(spp=rem, spp_chunk=None)
            img = img + render_frame(
                scene, subr, camera, jax.random.fold_in(key, n_full),
                accel, row0, rows) * (rem / cfg.spp)
        return img

    tracer = get_tracer(scene, cfg, accel)
    return render_sample(scene, tracer, camera, key, cfg, row0=row0,
                         rows=rows)


def render_aovs(scene: Scene, cfg: RenderConfig, camera: Camera, accel=None):
    """First-hit G-buffer at pixel centers (no jitter, no DoF): albedo /
    normal / emission (H, W, 3), depth (H, W; 0 at misses), and a boolean
    hit mask. Deterministic (no RNG), so every tracer returns the same
    buffers. These are the guide inputs for the guided a-trous denoiser
    (utils/denoise.py) and the AOV export (`Renderer.save_aovs`) — a
    G-buffer the reference never surfaces (its RayHit lives only inside
    the kernel, compute:36-41)."""
    from .ops.shade import MISS_T

    scene = jax.tree_util.tree_map(jnp.asarray, scene)
    H, W = cfg.height, cfg.width
    N = H * W
    px = jnp.broadcast_to(jnp.arange(W)[None, :], (H, W))
    py = jnp.broadcast_to((H - 1 - jnp.arange(H))[:, None], (H, W))
    u = ((px.astype(jnp.float32) + 0.5) / W * 2.0 - 1.0).reshape(N)
    v = ((py.astype(jnp.float32) + 0.5) / H * 2.0 - 1.0).reshape(N)
    zero = jnp.zeros((N,), jnp.float32)
    ro, rd = camera_rays_soa(camera, u, v, zero, zero)
    tracer = get_tracer(scene, cfg, accel)
    hit = tracer(ro, rd)
    hitm = hit.t < MISS_T

    def img3(v3):
        return jnp.stack([jnp.where(hitm, c, 0.0).reshape(H, W)
                          for c in v3], axis=-1)

    return dict(albedo=img3(hit.albedo), normal=img3(hit.normal),
                emission=img3(hit.emission),
                depth=jnp.where(hitm, hit.t, 0.0).reshape(H, W),
                hit=hitm.reshape(H, W))


def progressive_step(state: RenderState, frame: jnp.ndarray) -> RenderState:
    """Running mean with weight 1/(N+1) (AdditionShader.shader:40)."""
    n = state.n_samples.astype(jnp.float32)
    accum = state.accum * (n / (n + 1.0)) + frame / (n + 1.0)
    return RenderState(accum=accum, n_samples=state.n_samples + 1)


class PreviewExportMixin:
    """Live preview, denoise, and AOV/EXR export, shared by ``Renderer``
    and ``parallel.sharding.ShardedRenderer`` (multi-chip runs keep the
    full preview/export surface). Hosts must provide ``step``, ``image``,
    ``sample_count``, ``state``, ``config``, ``scene``, ``camera``, and
    ``_aov_accel()`` (an accel usable by a plain single-device
    ``render_aovs`` trace — the default returns ``self.accel``)."""

    def _aov_accel(self):
        return self.accel

    def watch(self, path: str = "preview.png", every: int = 4,
              frames: Optional[int] = None, denoise: bool = True,
              guided: bool = False, http_port: Optional[int] = None,
              on_update: Optional[Callable] = None) -> "Renderer":
        """Progressive live preview — the reference's per-editor-frame
        display loop (`OnRenderImage`/`Graphics.Blit`,
        RayTraceMaster.cs:848-866) for a headless box: render ``every``
        frames per tick, write the (optionally denoised) tonemapped
        accumulator to ``path`` atomically, repeat until ``frames`` samples
        have accumulated (None = until KeyboardInterrupt).

        ``http_port`` serves the refreshing preview at
        ``http://localhost:<port>/`` from a daemon thread. ``on_update``
        (if given) is called with this renderer after every tick.
        """
        import os
        import tempfile
        from .utils.image import tonemap_aces, write_png

        if http_port is not None:
            self._serve_preview(path, http_port)
        try:
            while frames is None or self.sample_count < frames:
                n = every if frames is None \
                    else min(every, frames - self.sample_count)
                self.step(n)
                img = (self.denoised_image(guided=guided) if denoise
                       else self.image)
                fd, tmp = tempfile.mkstemp(
                    dir=os.path.dirname(os.path.abspath(path)) or ".",
                    suffix=".png")
                os.close(fd)
                write_png(tmp, tonemap_aces(img))
                os.replace(tmp, path)     # atomic: readers never see a torn file
                if on_update is not None:
                    on_update(self)
        except KeyboardInterrupt:
            pass
        return self

    def _serve_preview(self, path: str, port: int) -> None:
        """Daemon HTTP thread: / auto-refreshes, /preview.png is the file."""
        import http.server
        import threading

        html = (b"<html><head><meta http-equiv='refresh' content='2'>"
                b"<title>unityraytracer_tpu preview</title></head>"
                b"<body style='background:#111;margin:0'>"
                b"<img src='/preview.png' style='width:100%'></body></html>")

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(h):
                if h.path == "/preview.png":
                    try:
                        with open(path, "rb") as f:
                            data = f.read()
                    except OSError:
                        h.send_response(404)
                        h.end_headers()
                        return
                    h.send_response(200)
                    h.send_header("Content-Type", "image/png")
                    h.send_header("Cache-Control", "no-store")
                    h.end_headers()
                    h.wfile.write(data)
                else:
                    h.send_response(200)
                    h.send_header("Content-Type", "text/html")
                    h.end_headers()
                    h.wfile.write(html)

            def log_message(h, *a):      # quiet
                pass

        srv = http.server.ThreadingHTTPServer(("127.0.0.1", port), Handler)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        self._preview_server = srv

    def aovs(self) -> dict:
        """First-hit G-buffer (albedo/normal/emission/depth/hit) as device
        arrays; recomputed per call (cheap single-bounce trace), jitted
        once per config."""
        if getattr(self, "_aov_cfg", None) is not self.config:
            self._aov_cfg = self.config
            self._aov_fn = jax.jit(
                functools.partial(render_aovs, cfg=self.config))
        return self._aov_fn(self.scene, camera=self.camera, accel=self._aov_accel())

    def denoised_image(self, iterations: int = 3,
                       sigma_color: float = 0.1,
                       guided: bool = False) -> np.ndarray:
        """Edge-preserving a-trous denoise of the current accumulator
        (utils/denoise.py) — preview tool the reference lacks; the
        progressive mean itself stays untouched/unbiased. ``guided=True``
        adds albedo/normal edge-stopping from the first-hit G-buffer
        (texture detail survives aggressive color sigmas)."""
        from .utils.denoise import atrous_denoise

        kw = {}
        if guided:
            g = self.aovs()
            kw = dict(albedo=g["albedo"], normal=g["normal"])
        return np.asarray(jax.device_get(
            jax.jit(atrous_denoise, static_argnums=(1,))(
                self.state.accum, iterations, sigma_color, **kw)))

    def save_aovs(self, path: str, tonemapped_beauty: bool = False) -> str:
        """Write beauty + G-buffer AOVs as one multi-part EXR (parts:
        beauty, albedo, normal, depth, emission) — the multi-layer export
        path compositors expect."""
        from .models.exr import write_exr_multipart

        g = {k: np.asarray(jax.device_get(v)) for k, v in self.aovs().items()}
        beauty = self.image
        if tonemapped_beauty:
            from .utils.image import tonemap_aces
            beauty = tonemap_aces(beauty)
        write_exr_multipart(path, [
            ("beauty", beauty), ("albedo", g["albedo"]),
            ("normal", g["normal"]), ("depth", g["depth"]),
            ("emission", g["emission"])])
        return path


class Renderer(PreviewExportMixin):
    """Stateful convenience driver around the pure functions.

    Mirrors RayTraceMaster's lifecycle: holds (scene, camera, config), jits the
    frame step once, accumulates progressively, resets on invalidation.
    """

    def __init__(self, scene: Scene, camera: Camera, config: RenderConfig,
                 accel=None, seed: int = 0):
        self.camera = camera
        self.config = config
        if accel is None and config.tracer not in ("brute",):
            from .ops import bvh
            accel = bvh.build_accel(scene, config)
        # Scene/accel are built host-side (numpy leaves); move them to device
        # once so per-frame steps don't re-upload (the analog of the
        # reference's buffer upload at RayTraceMaster.cs:738-745).
        self.scene = jax.device_put(scene)
        self.accel = jax.device_put(accel) if accel is not None else None
        self._key = jax.random.key(seed, impl=config.rng_impl)
        self.state = RenderState.create(config.width, config.height)
        self.stats = {}
        self._compiled = self._build_step()

    def _build_step(self):
        cfg = self.config

        @functools.partial(jax.jit, donate_argnums=(0,), static_argnums=(5,))
        def step(state, scene, camera, accel, key, n_frames=1):
            def body(i, st):
                # Keyed by absolute sample index within the block.
                sub = jax.random.fold_in(key, st.n_samples)
                frame = render_frame(scene, cfg, camera, sub, accel)
                return progressive_step(st, frame)

            # n_frames > 1 runs the whole block INSIDE one jit dispatch
            # (lax.fori_loop), so per-frame host dispatch drops out of the
            # block (the reference re-dispatches per frame,
            # RayTraceMaster.cs:806-810).
            return jax.lax.fori_loop(0, n_frames, body, state)

        if cfg.dispatch_bands and cfg.dispatch_bands > 1:
            self._band_fn, self._band_accum = self._build_band_step()
        return step

    def _build_band_step(self):
        """Banded frame dispatch (cfg.dispatch_bands): one jitted band
        renderer (row0 traced, rows static — at most two compiles for a
        ragged last band) plus one accumulate dispatch. Each band folds
        the frame key by its band index — the single-chip analog of
        ``mode="rows"`` sharding's per-device streams (parallel/
        sharding.py:116-119) — so the result is deterministic and every
        band is an independent unbiased estimator; like spp_chunk, it
        matches the whole-frame dispatch in distribution, not bitwise.
        Only the per-dispatch device time shrinks (see
        RenderConfig.dispatch_bands)."""
        cfg = self.config

        @functools.partial(jax.jit, static_argnums=(5,))
        def band(scene, camera, accel, key, row0, rows):
            return render_frame(scene, cfg, camera, key, accel,
                                row0=row0, rows=rows)

        @functools.partial(jax.jit, donate_argnums=(0,))
        def accum(state, *bands):
            return progressive_step(state, jnp.concatenate(bands, axis=0))

        return band, accum

    def _step_banded(self, n_frames: int) -> None:
        cfg = self.config
        nb, H = cfg.dispatch_bands, cfg.height
        bh = -(-H // nb)
        for _ in range(n_frames):
            self._key, sub = jax.random.split(self._key)
            # Same frame key as the fused body: fold by absolute sample
            # index (one scalar read back to the host).
            n = int(np.asarray(jax.device_get(self.state.n_samples)))
            fkey = jax.random.fold_in(sub, n)
            bands = []
            for bi, row0 in enumerate(range(0, H, bh)):
                rows = min(bh, H - row0)
                bkey = jax.random.fold_in(fkey, bi)
                bands.append(self._band_fn(self.scene, self.camera,
                                           self.accel, bkey,
                                           jnp.int32(row0), rows))
            self.state = self._band_accum(self.state, *bands)

    # -- invalidation (RayTraceMaster.cs:765-768,852) -------------------------
    def reset(self):
        self.state = RenderState.create(self.config.width, self.config.height)

    def set_camera(self, camera: Camera):
        self.camera = camera
        self.reset()

    def resize(self, width: int, height: int):
        """Change the framebuffer size; recompiles the step and resets the
        accumulator (InitRenderTexture semantics, RayTraceMaster.cs:824-845)."""
        self.config = self.config.replace(width=width, height=height)
        self._compiled = self._build_step()
        self.reset()

    def set_scene(self, scene: Scene, accel=None):
        if accel is None and self.config.tracer not in ("brute",):
            from .ops import bvh
            accel = bvh.build_accel(scene, self.config)
        self.scene = jax.device_put(scene)
        self.accel = jax.device_put(accel) if accel is not None else None
        self.reset()

    # -- stepping --------------------------------------------------------------
    def step(self, n_frames: int = 1, fused: bool = True) -> "Renderer":
        """Advance the progressive render; records wall-clock throughput in
        ``self.stats`` (the per-frame Mrays/s counter the reference lacks).

        ``fused=True`` advances all ``n_frames`` inside ONE jitted dispatch
        (one fori_loop; recompiles per distinct n_frames)."""
        import time as _time

        t0 = _time.perf_counter()
        if self.config.dispatch_bands and self.config.dispatch_bands > 1:
            self._step_banded(n_frames)
        elif fused:
            self._key, sub = jax.random.split(self._key)
            self.state = self._compiled(self.state, self.scene, self.camera,
                                        self.accel, sub, n_frames)
        else:
            for _ in range(n_frames):
                self._key, sub = jax.random.split(self._key)
                self.state = self._compiled(self.state, self.scene,
                                            self.camera, self.accel, sub, 1)
        jax.block_until_ready(self.state)
        dt = _time.perf_counter() - t0
        rays = self.config.num_rays * self.config.bounces * n_frames
        self.stats = dict(frames=n_frames, seconds=dt,
                          ms_per_frame=dt / n_frames * 1000.0,
                          mrays_per_sec=rays / dt / 1e6)
        return self

    def profile(self, n_frames: int = 1):
        """Per-stage DEVICE-time breakdown of the frame step.

        Runs one WARM-UP frame (outside the trace window, so a cold 1-frame
        jit cache never hides the device work behind compile time), then
        ``n_frames`` compiled steps under ``jax.profiler``, and parses the
        device timeline (utils/profiling.py). The result lands in
        ``self.stats["device"]`` and is returned; the warm-up + profiled
        frames all advance the real accumulator. This is the observability
        the reference lacks entirely (its only logging:
        RayTraceDebug.cs:25-36).
        """
        from .utils.profiling import profile_stages

        def one_frame():
            self._key, sub = jax.random.split(self._key)
            self.state = self._compiled(self.state, self.scene,
                                        self.camera, self.accel, sub, 1)

        def run():
            for _ in range(n_frames):
                one_frame()
            return self.state

        # Warm the 1-frame jit cache OUTSIDE the trace window: step(n) users
        # compiled a different static n, and a retrace/compile inside the
        # window hides the device work behind seconds of host time.
        one_frame()
        jax.block_until_ready(self.state)
        prof = profile_stages(run)
        self.stats["device"] = prof
        return prof


    @property
    def image(self) -> np.ndarray:
        """Current converged image, (H, W, 3) linear float32, row 0 = top."""
        return np.asarray(jax.device_get(self.state.accum))


    @property
    def sample_count(self) -> int:
        return int(jax.device_get(self.state.n_samples))

    # -- export / checkpoint ---------------------------------------------------
    def save_screenshot(self, path: Optional[str] = None, tonemap: bool = True
                        ) -> str:
        """Write the converged image as a PNG (the F12 capture analog,
        RayTraceMaster.cs:761-763; default name mirrors its
        ``Screenshots/<time>-<sample>.png`` pattern)."""
        import os
        import time as _time
        from .utils.image import tonemap_aces, write_png

        if path is None:
            os.makedirs("Screenshots", exist_ok=True)
            path = os.path.join(
                "Screenshots", f"{int(_time.time())}-{self.sample_count}.png")
        img = self.image
        return write_png(path, tonemap_aces(img) if tonemap else img)

    def save_state(self, path: str) -> str:
        """Checkpoint the progressive accumulator (accum + sample count).

        The reference's only recovery story is its in-GPU running mean
        (SURVEY.md aux table); here the (accum, n_samples) pair is explicit
        jit-carried state, so a render can resume exactly after a restart.
        Returns the REAL file written (np.savez appends ``.npz`` to names
        missing it — the returned path always loads).
        """
        if not path.endswith(".npz"):
            path += ".npz"
        np.savez(path, accum=self.image,
                 n_samples=np.int32(self.sample_count),
                 key=np.asarray(jax.random.key_data(self._key)))
        return path

    def load_state(self, path: str) -> "Renderer":
        data = np.load(path)
        self.state = RenderState(accum=jnp.asarray(data["accum"]),
                                 n_samples=jnp.int32(int(data["n_samples"])))
        self._key = jax.random.wrap_key_data(jnp.asarray(data["key"]),
                                             impl=self.config.rng_impl)
        return self

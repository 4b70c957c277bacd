"""Shading: roulette BRDF bounce + equirect skybox (reference Shade,
RayTraceShader.compute:386-428), fully vectorized and branchless.

Per bounce the reference mutates the ray in place and returns the radiance
contribution; here the same update is a pure function over component-SoA
arrays (Vec3 tuples of (N,) — see ops/vec.py for the layout rationale):

  contribution = energy_before * (emission | skybox)
  energy_after = energy_before * lobe_weight          (0 on miss/terminate)

All three roulette branches are computed for every lane and selected with
``where`` — the branchless form of the reference's if/else chain, which
XLA fuses into one elementwise kernel.
"""

from __future__ import annotations

import dataclasses
import jax
import jax.numpy as jnp

from . import vec
from .vec import Vec3
from .sampling import sample_hemisphere, PI

MISS_T = 1e30  # distances >= this are misses (reference uses 1.#INF, compute:128)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Hit:
    """Per-ray hit record (RayHit analog, compute:36-41), component-SoA."""

    t: jnp.ndarray        # (N,)
    position: Vec3        # 3 x (N,)
    normal: Vec3          # 3 x (N,)
    albedo: Vec3          # 3 x (N,)
    specular: Vec3        # 3 x (N,)
    emission: Vec3        # 3 x (N,)
    smoothness: jnp.ndarray  # (N,)


def sample_skybox(skybox, rd: Vec3) -> Vec3:
    """Bilinear equirect environment lookup.

    Mapping matches the reference (compute:424-426) composed with Unity's
    repeat-wrap sampler and bottom-left uv origin; our arrays are row 0 = top
    (+y pole):  row01 = acos(y)/pi, col01 = (-atan2(x, -z)/(2*pi)) mod 1.

    Gathers are flat per-channel (dense layouts; see ops/vec.py).

    Args:
      skybox: (H, W, 3) float32.
      rd: Vec3 of (N,) unit direction components.
    Returns:
      Vec3 of (N,) radiance.
    """
    H, W = skybox.shape[0], skybox.shape[1]
    y = jnp.clip(rd[1], -1.0, 1.0)
    row01 = jnp.arccos(y) / PI
    col01 = jnp.mod(-jnp.arctan2(rd[0], -rd[2]) / (2.0 * PI), 1.0)

    fy = row01 * H - 0.5
    fx = col01 * W - 0.5
    y0f = jnp.floor(fy)
    x0f = jnp.floor(fx)
    wy = fy - y0f
    wx = fx - x0f
    # Clamp v (pole rows), wrap u (seam) — clamp both neighbors independently
    # so pole samples don't bleed into the adjacent row.
    y0 = jnp.clip(y0f.astype(jnp.int32), 0, H - 1)
    y1 = jnp.clip(y0f.astype(jnp.int32) + 1, 0, H - 1)
    x0 = jnp.mod(x0f.astype(jnp.int32), W)
    x1 = jnp.mod(x0f.astype(jnp.int32) + 1, W)

    i00 = y0 * W + x0
    i01 = y0 * W + x1
    i10 = y1 * W + x0
    i11 = y1 * W + x1
    out = []
    for ch in range(3):
        plane = skybox[:, :, ch].reshape(-1)
        top = plane[i00] * (1 - wx) + plane[i01] * wx
        bot = plane[i10] * (1 - wx) + plane[i11] * wx
        out.append(top * (1 - wy) + bot * wy)
    return tuple(out)


def pack_rgbe(skybox):
    """(H, W, 3) float -> (H*W,) uint32 shared-exponent RGBE texels.

    Packing a texel into one word makes a bilinear environment lookup 4
    gathers instead of 12 (~0.4% radiance quantization, far below
    Monte-Carlo noise).
    """
    m = jnp.max(skybox, axis=-1)
    exp = jnp.ceil(jnp.log2(jnp.maximum(m, 1e-30))).astype(jnp.int32) + 1
    scale = jnp.exp2(8.0 - exp.astype(jnp.float32))
    rgb = jnp.clip(skybox * scale[..., None], 0, 255).astype(jnp.uint32)
    e = jnp.where(m > 1e-30, exp + 128, 0).astype(jnp.uint32)
    word = ((e << 24) | (rgb[..., 0] << 16) | (rgb[..., 1] << 8) | rgb[..., 2])
    return word.reshape(-1)


def pack_rgbe_np(skybox):
    """Host-numpy twin of :func:`pack_rgbe` for scene-build time.

    The packed plane is baked into the Scene pytree ONCE at build (and
    device_put with the rest of the scene) so the per-frame jitted step never
    re-packs the environment map — for a 4K HDRI that is ~8M texels of
    redundant work per frame otherwise.
    """
    import numpy as _np

    skybox = _np.asarray(skybox, _np.float32)
    m = skybox.max(axis=-1)
    exp = _np.ceil(_np.log2(_np.maximum(m, 1e-30))).astype(_np.int32) + 1
    scale = _np.exp2(8.0 - exp.astype(_np.float32))
    rgb = _np.clip(skybox * scale[..., None], 0, 255).astype(_np.uint32)
    e = _np.where(m > 1e-30, exp + 128, 0).astype(_np.uint32)
    word = ((e << 24) | (rgb[..., 0] << 16) | (rgb[..., 1] << 8) | rgb[..., 2])
    return word.reshape(-1)


def _decode_rgbe(word) -> Vec3:
    e = (word >> 24).astype(jnp.int32)
    scale = jnp.where(e > 0, jnp.exp2(e.astype(jnp.float32) - 136.0), 0.0)
    return (((word >> 16) & 0xFF).astype(jnp.float32) * scale,
            ((word >> 8) & 0xFF).astype(jnp.float32) * scale,
            (word & 0xFF).astype(jnp.float32) * scale)


def _equirect_coords(skybox_hw, rd: Vec3):
    H, W = skybox_hw
    y = jnp.clip(rd[1], -1.0, 1.0)
    row01 = jnp.arccos(y) / PI
    col01 = jnp.mod(-jnp.arctan2(rd[0], -rd[2]) / (2.0 * PI), 1.0)
    fy = row01 * H - 0.5
    fx = col01 * W - 0.5
    y0f = jnp.floor(fy)
    x0f = jnp.floor(fx)
    y0 = jnp.clip(y0f.astype(jnp.int32), 0, H - 1)
    y1 = jnp.clip(y0f.astype(jnp.int32) + 1, 0, H - 1)
    x0 = jnp.mod(x0f.astype(jnp.int32), W)
    x1 = jnp.mod(x0f.astype(jnp.int32) + 1, W)
    return (y0, y1, x0, x1, fy - y0f, fx - x0f)


def sample_skybox_rgbe(skybox, rd: Vec3, bilinear: bool = True,
                       u1=None, u2=None, packed=None) -> Vec3:
    """Equirect lookup through a packed RGBE plane (4 gathers bilinear,
    1 gather nearest/stochastic). Same mapping as sample_skybox.

    With ``u1``/``u2`` (per-ray uniforms), a single STOCHASTIC tap picks each
    bilinear corner with probability equal to its weight — the expectation is
    exactly bilinear, so the progressive accumulator converges to the
    filtered result at a quarter of the gather cost. One extra dither of
    per-frame sky noise, well below path-tracing variance.

    ``packed``: optional prepacked (H*W,) uint32 RGBE plane (SceneBuilder
    bakes one at build so jitted frames skip the per-frame repack).
    """
    H, W = skybox.shape[0], skybox.shape[1]
    plane = pack_rgbe(skybox) if packed is None else packed
    y0, y1, x0, x1, wy, wx = _equirect_coords((H, W), rd)
    if u1 is not None:
        yn = jnp.where(u1 < wy, y1, y0)
        xn = jnp.where(u2 < wx, x1, x0)
        return _decode_rgbe(plane[yn * W + xn])
    if not bilinear:
        yn = jnp.where(wy > 0.5, y1, y0)
        xn = jnp.where(wx > 0.5, x1, x0)
        return _decode_rgbe(plane[yn * W + xn])
    c00 = _decode_rgbe(plane[y0 * W + x0])
    c01 = _decode_rgbe(plane[y0 * W + x1])
    c10 = _decode_rgbe(plane[y1 * W + x0])
    c11 = _decode_rgbe(plane[y1 * W + x1])
    out = []
    for k in range(3):
        top = c00[k] * (1 - wx) + c01[k] * wx
        bot = c10[k] * (1 - wx) + c11[k] * wx
        out.append(top * (1 - wy) + bot * wy)
    return tuple(out)


def shade(ro: Vec3, rd: Vec3, energy: Vec3, hit: Hit, uniforms):
    """One bounce of the reference BRDF (environment handled by the caller).

    The reference samples the skybox inside Shade on miss (compute:424-426);
    here the caller records (direction, throughput) at each ray's first miss
    and resolves the environment ONCE per frame — a ray can only miss with
    nonzero energy once.

    Args:
      ro, rd: Vec3 of (N,) current ray origins / unit directions.
      energy: Vec3 of (N,) path throughput before this bounce.
      hit: Hit SoA (t >= MISS_T marks skybox rays).
      uniforms: 3-tuple of (N,) independent U[0,1) samples (roulette, u1, u2).

    Returns:
      (new_ro, new_rd, new_energy, radiance, missed): radiance is this
      bounce's emission contribution ``energy * emission`` (zero on miss);
      new_energy is 0 for missed or terminated lanes; the caller adds
      ``energy_before * sky(rd)`` for missed lanes.
    """
    u_roulette, u1, u2 = uniforms
    missed = hit.t >= MISS_T
    n = hit.normal

    # Energy conservation clamp + lobe probabilities (compute:389-394).
    albedo = tuple(jnp.minimum(1.0 - s, a)
                   for s, a in zip(hit.specular, hit.albedo))
    spec_chance = (hit.specular[0] + hit.specular[1] + hit.specular[2]) / 3.0
    diff_chance = (albedo[0] + albedo[1] + albedo[2]) / 3.0
    total = spec_chance + diff_chance
    safe_total = jnp.where(total > 0, total, 1.0)
    spec_chance = spec_chance / safe_total
    diff_chance = diff_chance / safe_total

    is_spec = (total > 0) & (u_roulette < spec_chance)
    is_diff = (total > 0) & ~is_spec & (diff_chance > 0)

    # Specular lobe: Phong alpha = 1000^(s^2) (compute:399-406). Each lane
    # commits to ONE lobe, so the sample axis (reflection vs normal) and the
    # lobe exponent are where-BLENDED before a single hemisphere evaluation
    # — per lane this computes exactly the value the chosen lobe would
    # (diffuse = power-1 about the normal, compute:407-411), at half the
    # tangent-frame/trig work of evaluating both lobes.
    refl = vec.reflect(rd, n)
    axis = vec.where(is_spec, refl, n)
    alpha = jnp.power(1000.0, hit.smoothness * hit.smoothness)
    new_dir = sample_hemisphere(u1, u2, axis, jnp.where(is_spec, alpha, 1.0))
    f = (alpha + 2.0) / (alpha + 1.0)
    w_spec_s = vec.sdot(n, new_dir, f) / jnp.maximum(spec_chance, 1e-8)
    w_spec = vec.scale(hit.specular, w_spec_s)

    # Diffuse lobe weight (compute:407-411).
    w_diff = vec.scale(albedo, 1.0 / jnp.maximum(diff_chance, 1e-8))

    new_rd = new_dir
    lobe_w = vec.where(is_spec, w_spec,
                       vec.where(is_diff, w_diff, vec.splat((0., 0., 0.), u1)))
    # Bounce origin bias (compute:402,409).
    new_ro = vec.add(hit.position, vec.scale(n, 0.001))

    zero = vec.splat((0., 0., 0.), u1)
    radiance = vec.where(missed, zero, vec.mul(energy, hit.emission))
    new_energy = vec.where(missed, zero, vec.mul(energy, lobe_w))
    # Dead lanes keep their old ray (values are masked by zero energy anyway).
    new_ro = vec.where(missed, ro, new_ro)
    new_rd = vec.where(missed, rd, new_rd)
    return new_ro, new_rd, new_energy, radiance, missed

"""Camera model and primary-ray generation.

The reference builds rays on-device from two uniforms set by the host
(`RayTraceMaster.cs:773-775`): ``_CameraToWorld`` and
``_CameraInverseProjection``, then per pixel computes
``dir = normalize(R * (invP * (uv, 0, 1)))`` with jittered NDC uv
(`RayTraceShader.compute:142-153,448-450`). We keep the same math but store the
camera as a pytree: a cam-to-world rotation+translation plus the field-of-view
tangents (the only information the inverse projection contributes to a ray at
the near plane), extended with thin-lens depth of field (planned-but-missing in
the reference, README.md:10).

Conventions match the Unity scenes: left-handed, +y up, camera forward +z.
"""

from __future__ import annotations

import dataclasses
import numpy as np
import jax
import jax.numpy as jnp

from .utils.math3d import normalize


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Camera:
    """Pinhole/thin-lens camera.

    Attributes:
      cam_to_world: (4,4) rigid transform; column-major action on column
        vectors. Rotation columns are (right, up, forward).
      tan_half_fov: tan(vertical_fov / 2).
      aspect: width / height.
      aperture: lens radius; 0 disables depth of field.
      focus_dist: focal plane distance along forward.
    """

    cam_to_world: jnp.ndarray
    tan_half_fov: jnp.ndarray
    aspect: jnp.ndarray
    aperture: jnp.ndarray
    focus_dist: jnp.ndarray

    @staticmethod
    def create(position=(0.0, 0.0, 0.0), look_at=None, forward=None,
               up=(0.0, 1.0, 0.0), fov_y_deg: float = 60.0, aspect: float = 1.0,
               aperture: float = 0.0, focus_dist: float = 1.0,
               cam_to_world=None) -> "Camera":
        """Host-side constructor. Provide look_at/forward or a full matrix."""
        if cam_to_world is None:
            pos = np.asarray(position, np.float64)
            if forward is None:
                tgt = np.asarray(
                    look_at if look_at is not None else pos + np.array([0, 0, 1.0]),
                    np.float64)
                fwd = tgt - pos
            else:
                fwd = np.asarray(forward, np.float64)
            fwd = fwd / np.linalg.norm(fwd)
            upv = np.asarray(up, np.float64)
            # Left-handed basis: right = up x forward.
            right = np.cross(upv, fwd)
            right = right / np.linalg.norm(right)
            upv = np.cross(fwd, right)
            m = np.eye(4, dtype=np.float64)
            m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = right, upv, fwd, pos
            cam_to_world = m
        cam_to_world = jnp.asarray(cam_to_world, jnp.float32)
        return Camera(
            cam_to_world=cam_to_world,
            tan_half_fov=jnp.float32(np.tan(np.deg2rad(fov_y_deg) / 2.0)),
            aspect=jnp.float32(aspect),
            aperture=jnp.float32(aperture),
            focus_dist=jnp.float32(focus_dist),
        )

    @property
    def position(self):
        return self.cam_to_world[:3, 3]


def orbit(center, radius: float, azimuth_deg: float, elevation_deg: float,
          fov_y_deg: float = 60.0, aspect: float = 1.0, **kw) -> Camera:
    """Camera on a sphere around ``center``, looking at it.

    The reference gets interactive orbiting for free from the Unity editor
    camera (it only reacts via reset-on-move, RayTraceMaster.cs:765-768); a
    standalone framework needs the motion model itself. Azimuth 0 looks down
    +z -> camera sits at -z; elevation is degrees above the horizon.
    """
    c = np.asarray(center, np.float64)
    az = np.deg2rad(azimuth_deg)
    el = np.deg2rad(elevation_deg)
    offset = np.array([np.sin(az) * np.cos(el), np.sin(el),
                       -np.cos(az) * np.cos(el)]) * float(radius)
    return Camera.create(position=c + offset, look_at=c,
                         fov_y_deg=fov_y_deg, aspect=aspect, **kw)


def _quat_from_mat(r: np.ndarray) -> np.ndarray:
    """Rotation matrix -> unit quaternion (w, x, y, z), numerically safe."""
    t = np.trace(r)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array([0.25 * s, (r[2, 1] - r[1, 2]) / s,
                         (r[0, 2] - r[2, 0]) / s, (r[1, 0] - r[0, 1]) / s])
    i = int(np.argmax(np.diag(r)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(1.0 + r[i, i] - r[j, j] - r[k, k], 1e-12)) * 2
    q = np.empty(4)
    q[0] = (r[k, j] - r[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (r[j, i] + r[i, j]) / s
    q[1 + k] = (r[k, i] + r[i, k]) / s
    return q


def _mat_from_quat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def interpolate(a: Camera, b: Camera, t: float) -> Camera:
    """Smooth camera blend: slerp rotation, lerp position/fov/lens params.

    Building block for camera paths / animation (each keyframe pair gives a
    shot; feed the result to Renderer.set_camera per frame)."""
    ma = np.asarray(a.cam_to_world, np.float64)
    mb = np.asarray(b.cam_to_world, np.float64)
    qa, qb = _quat_from_mat(ma[:3, :3]), _quat_from_mat(mb[:3, :3])
    if np.dot(qa, qb) < 0:
        qb = -qb
    cos_o = float(np.clip(np.dot(qa, qb), -1.0, 1.0))
    if cos_o > 1.0 - 1e-9:
        q = qa * (1 - t) + qb * t
    else:
        o = np.arccos(cos_o)
        q = (np.sin((1 - t) * o) * qa + np.sin(t * o) * qb) / np.sin(o)
    m = np.eye(4)
    m[:3, :3] = _mat_from_quat(q)
    m[:3, 3] = (1 - t) * ma[:3, 3] + t * mb[:3, 3]

    def lerp(x, y):
        return float(np.asarray(x)) * (1 - t) + float(np.asarray(y)) * t

    fov = 2.0 * np.rad2deg(np.arctan(lerp(a.tan_half_fov, b.tan_half_fov)))
    return Camera.create(cam_to_world=m, fov_y_deg=fov,
                         aspect=lerp(a.aspect, b.aspect),
                         aperture=lerp(a.aperture, b.aperture),
                         focus_dist=lerp(a.focus_dist, b.focus_dist))


def turntable(center, radius: float, n_frames: int,
              elevation_deg: float = 15.0, **kw):
    """n_frames cameras orbiting ``center`` through a full revolution."""
    return [orbit(center, radius, 360.0 * i / n_frames, elevation_deg, **kw)
            for i in range(n_frames)]


def camera_rays_soa(camera: Camera, u, v, lens_u=None, lens_v=None):
    """Generate world-space rays for NDC coordinates, component-SoA.

    All ray math stays in separate per-component arrays (see ops/vec.py for
    the layout rationale).

    Args:
      camera: Camera pytree.
      u, v: (...,) normalized device coords in [-1, 1] (x right, y up),
        already jittered by the caller (the reference jitters with rand() +
        per-frame ``_PixelOffset``, RayTraceShader.compute:448-449).
      lens_u, lens_v: optional (...,) unit-disk samples for thin-lens DoF.

    Returns:
      (origin, direction): two 3-tuples of (...,) components, unit directions.
    """
    from .ops import vec

    m = camera.cam_to_world
    # View-space direction at the image plane (z=1): the full effect of the
    # reference's _CameraInverseProjection * (uv, 0, 1) followed by normalize.
    dx = u * (camera.tan_half_fov * camera.aspect)
    dy = v * camera.tan_half_fov
    # World = R @ (dx, dy, 1); R columns are (right, up, forward).
    d = (m[0, 0] * dx + m[0, 1] * dy + m[0, 2],
         m[1, 0] * dx + m[1, 1] * dy + m[1, 2],
         m[2, 0] * dx + m[2, 1] * dy + m[2, 2])
    d = vec.normalize(d)
    o = tuple(jnp.broadcast_to(m[k, 3], d[0].shape) for k in range(3))

    if lens_u is not None:
        # Thin lens: offset origin on the lens disk, refocus on the plane
        # perpendicular to forward at depth focus_dist.
        fwd = (m[0, 2], m[1, 2], m[2, 2])
        cos_fwd = vec.dot(d, fwd)
        focus_t = camera.focus_dist / jnp.maximum(cos_fwd, 1e-6)
        focal = vec.add(o, vec.scale(d, focus_t))
        lu = lens_u * camera.aperture
        lv = lens_v * camera.aperture
        o = (o[0] + m[0, 0] * lu + m[0, 1] * lv,
             o[1] + m[1, 0] * lu + m[1, 1] * lv,
             o[2] + m[2, 0] * lu + m[2, 1] * lv)
        d = vec.normalize(vec.sub(focal, o))
    return o, d


def camera_rays(camera: Camera, uv: jnp.ndarray, lens_uv=None):
    """Row-vector convenience wrapper: uv (..., 2) -> ((..., 3), (..., 3))."""
    lens_u = lens_uv[..., 0] if lens_uv is not None else None
    lens_v = lens_uv[..., 1] if lens_uv is not None else None
    o, d = camera_rays_soa(camera, uv[..., 0], uv[..., 1], lens_u, lens_v)
    return jnp.stack(o, axis=-1), jnp.stack(d, axis=-1)


def pixel_uv(px, py, jitter_xy, width: int, height: int):
    """NDC uv for pixel indices with sub-pixel jitter in [0,1).

    Mirrors ``(id.xy + rand2 + _PixelOffset) / wh * 2 - 1``
    (RayTraceShader.compute:449); py counts up from the bottom row.
    """
    u = (px.astype(jnp.float32) + jitter_xy[..., 0]) / width * 2.0 - 1.0
    v = (py.astype(jnp.float32) + jitter_xy[..., 1]) / height * 2.0 - 1.0
    return jnp.stack([u, v], axis=-1)

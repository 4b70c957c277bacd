"""Scene model: SoA pytrees + a host-side builder.

The reference keeps scene state in C# lists flattened per frame into 7 GPU
buffers (`RayTraceMaster.cs:262-336,738-745`): mesh records with a
localToWorld matrix + index ranges, shared vertex/index/normal pools, spheres,
and two BVH node arrays. This design differs in two deliberate ways:

* Geometry is **pre-transformed to world space at build time** — the reference
  re-multiplies every vertex by localToWorldMatrix inside the per-ray triangle
  loop (`RayTraceShader.compute:244-246`), which is pure waste; baking the
  transform once turns the hot loop into plain SoA reads.
* Everything is **padded to static shapes** (degenerate triangles with zero
  area are guaranteed misses under Moller-Trumbore's det test) so the whole
  frame step jits once.

Materials mirror ``RayTraceParams`` (`RayTraceMaster.cs:48-53`): albedo,
specular, emission float3 + smoothness. Defaults match ``RayTraceObject``
(`RayTraceObject.cs:12-15`).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import jax
import jax.numpy as jnp

from .utils.math3d import normal_matrix

# RayTraceObject.cs:12-15 defaults.
DEFAULT_ALBEDO = (0.0, 0.4, 1.0)
DEFAULT_SPECULAR = (0.7, 0.0, 1.0)
DEFAULT_EMISSION = (0.0, 0.0, 0.0)
DEFAULT_SMOOTHNESS = 0.69

# Hard-coded ground material, RayTraceShader.compute:167-170.
GROUND_ALBEDO = (0.5, 0.3, 0.15)
GROUND_SPECULAR = (0.0, 0.0, 0.0)
GROUND_SMOOTHNESS = 0.3
GROUND_EMISSION = (0.0, 0.0, 0.0)


@dataclasses.dataclass
class Material:
    """Host-side material description (RayTraceParams analog)."""

    albedo: Sequence[float] = DEFAULT_ALBEDO
    specular: Sequence[float] = DEFAULT_SPECULAR
    emission: Sequence[float] = DEFAULT_EMISSION
    smoothness: float = DEFAULT_SMOOTHNESS


GROUND_MATERIAL = Material(GROUND_ALBEDO, GROUND_SPECULAR, GROUND_EMISSION,
                           GROUND_SMOOTHNESS)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Materials:
    """SoA material table."""

    albedo: jnp.ndarray      # (M, 3)
    specular: jnp.ndarray    # (M, 3)
    emission: jnp.ndarray    # (M, 3)
    smoothness: jnp.ndarray  # (M,)

    @property
    def count(self) -> int:
        return self.albedo.shape[0]

    def take(self, idx):
        """Gather per-ray material params by index array."""
        return (self.albedo[idx], self.specular[idx], self.emission[idx],
                self.smoothness[idx])

    @staticmethod
    def from_list(mats: Sequence[Material]) -> "Materials":
        if not mats:
            mats = [Material()]
        return Materials(
            albedo=np.asarray([m.albedo for m in mats], np.float32),
            specular=np.asarray([m.specular for m in mats], np.float32),
            emission=np.asarray([m.emission for m in mats], np.float32),
            smoothness=np.asarray([m.smoothness for m in mats], np.float32),
        )


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Spheres:
    """SoA sphere set (reference ``Sphere`` struct, RayTraceMaster.cs:116-131)."""

    center: jnp.ndarray       # (S, 3)
    radius: jnp.ndarray       # (S,)
    material_id: jnp.ndarray  # (S,) int32 into scene materials

    @property
    def count(self) -> int:
        return self.center.shape[0]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Triangles:
    """World-space SoA triangle soup with smooth vertex normals.

    The reference's per-mesh record + shared pools (`RayTraceMaster.cs:82-114`)
    flatten to this at build time; ``material_id`` replaces the per-mesh
    ``lighting`` block so shading is a single gather.
    """

    v0: jnp.ndarray           # (T, 3)
    v1: jnp.ndarray           # (T, 3)
    v2: jnp.ndarray           # (T, 3)
    n0: jnp.ndarray           # (T, 3) unit vertex normals (world space)
    n1: jnp.ndarray           # (T, 3)
    n2: jnp.ndarray           # (T, 3)
    material_id: jnp.ndarray  # (T,) int32

    @property
    def count(self) -> int:
        return self.v0.shape[0]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Scene:
    """Complete render-ready scene."""

    spheres: Spheres
    triangles: Triangles
    materials: Materials      # shared table: sphere/tri material_id index here
    ground_enabled: jnp.ndarray   # () float32 0/1 mask (built-in plane y=0,
                                  # RayTraceShader.compute:156-172)
    ground_material_id: jnp.ndarray  # () int32
    skybox: jnp.ndarray       # (Hs, Ws, 3) float32 equirect, row 0 = +y pole
    # Shared-exponent RGBE packing of ``skybox``, baked once at build so the
    # per-frame jitted step never re-packs the environment (ops/shade.py
    # pack_rgbe_np); None when a Scene is assembled by hand.
    skybox_rgbe: Optional[jnp.ndarray] = None  # (Hs*Ws,) uint32

    @property
    def num_spheres(self) -> int:
        return self.spheres.count

    @property
    def num_triangles(self) -> int:
        return self.triangles.count


def compute_smooth_normals(vertices: np.ndarray, indices: np.ndarray,
                           weld_decimals: int = 5) -> np.ndarray:
    """Area-weighted smooth vertex normals with positional welding.

    Replaces the reference's O(V*I) ``ComputeNormals``
    (`RayTraceMaster.cs:340-368`): duplicate positions are welded (its epsilon
    of float.Epsilon*3 is effectively exact-match welding) and un-normalized
    triangle cross products (area weighting) are scatter-added, all vectorized.
    """
    vertices = np.asarray(vertices, np.float64)
    indices = np.asarray(indices, np.int64).reshape(-1, 3)
    # Weld: map each vertex to a canonical id by rounded position.
    key = np.round(vertices, weld_decimals)
    _, weld_ids = np.unique(key, axis=0, return_inverse=True)

    i0, i1, i2 = indices[:, 0], indices[:, 1], indices[:, 2]
    face_n = np.cross(vertices[i1] - vertices[i0], vertices[i2] - vertices[i0])
    acc = np.zeros((weld_ids.max() + 1 if len(weld_ids) else 1, 3), np.float64)
    for col in (i0, i1, i2):
        np.add.at(acc, weld_ids[col], face_n)
    n = acc[weld_ids]
    lens = np.linalg.norm(n, axis=1, keepdims=True)
    n = np.where(lens > 1e-20, n / np.maximum(lens, 1e-20), np.array([0.0, 1.0, 0.0]))
    return n.astype(np.float32)


class SceneBuilder:
    """Host-side scene registry (RayTraceObject/RegisterObject analog).

    Usage mirrors the reference's component registration
    (`RayTraceObject.cs:42,47` -> `RayTraceMaster.cs:215-230`): add objects,
    then ``build()`` flattens everything into a static-shape `Scene`.
    """

    def __init__(self):
        self._sphere_centers: List = []
        self._sphere_radii: List = []
        self._sphere_mats: List[Material] = []
        self._tri_v: List[np.ndarray] = []
        self._tri_n: List[np.ndarray] = []
        self._tri_mat_ids: List[np.ndarray] = []
        self._materials: List[Material] = []
        self._sphere_removed = set()
        self._mesh_removed = set()
        self._ground = True
        self._skybox: Optional[np.ndarray] = None
        self.last_handle = None  # set by add_sphere/add_mesh; pass to remove()
        self.dirty = True

    # -- registration API ---------------------------------------------------
    def _add_material(self, mat: Optional[Material]) -> int:
        mat = mat or Material()
        self._materials.append(mat)
        return len(self._materials) - 1

    def add_sphere(self, center, radius: float,
                   material: Optional[Material] = None) -> "SceneBuilder":
        mid = self._add_material(material)
        self._sphere_centers.append(np.asarray(center, np.float32))
        self._sphere_radii.append(np.float32(radius))
        self._sphere_mats.append(mid)
        self.last_handle = ("sphere", len(self._sphere_centers) - 1)
        self.dirty = True
        return self

    def add_mesh(self, vertices, indices, transform: Optional[np.ndarray] = None,
                 material: Optional[Material] = None,
                 normals: Optional[np.ndarray] = None) -> "SceneBuilder":
        """Register a triangle mesh.

        Args:
          vertices: (V, 3) object-space positions.
          indices: (3*F,) or (F, 3) triangle indices.
          transform: optional (4,4) local-to-world TRS.
          material: per-object material (reference meshes are one material per
            object, RayTraceMaster.cs:86).
          normals: optional (V, 3) object-space vertex normals; computed
            (area-weighted, welded) when omitted — matching ComputeNormals.
        """
        vertices = np.asarray(vertices, np.float32)
        indices = np.asarray(indices, np.int64).reshape(-1, 3)
        if normals is None:
            normals = compute_smooth_normals(vertices, indices)
        else:
            normals = np.asarray(normals, np.float32)

        if transform is not None:
            transform = np.asarray(transform, np.float64)
            vertices = (vertices @ transform[:3, :3].T + transform[:3, 3]).astype(np.float32)
            nmat = normal_matrix(transform)
            normals = normals @ nmat.T
            lens = np.linalg.norm(normals, axis=1, keepdims=True)
            normals = (normals / np.maximum(lens, 1e-20)).astype(np.float32)

        mid = self._add_material(material)
        tri_v = vertices[indices]          # (F, 3, 3)
        tri_n = normals[indices]           # (F, 3, 3)
        # Flip winding if the transform mirrors (negative determinant) so
        # backface culling (det >= EPS, RayTraceShader.compute:211) still
        # accepts front faces.
        if transform is not None and np.linalg.det(np.asarray(transform)[:3, :3]) < 0:
            tri_v = tri_v[:, ::-1, :]
            tri_n = tri_n[:, ::-1, :]
        self._tri_v.append(tri_v)
        self._tri_n.append(tri_n)
        self._tri_mat_ids.append(np.full((len(indices),), mid, np.int32))
        self.last_handle = ("mesh", len(self._tri_v) - 1)
        self.dirty = True
        return self

    def add_obj(self, path, transform: Optional[np.ndarray] = None,
                material: Optional[Material] = None) -> "SceneBuilder":
        """Register a Wavefront OBJ, honoring its .mtl materials.

        Faces are grouped by usemtl material and each group is registered as
        its own mesh (the framework is one-material-per-mesh, matching the
        reference's per-object material, RayTraceMaster.cs:86). ``material``
        overrides everything when given (and for faces with no usemtl).
        Returns self; ``last_handle`` is the LAST group's handle.
        """
        from .models.obj import load_obj_with_materials

        verts, faces, normals, face_mat, mats = load_obj_with_materials(path)
        used = np.unique(face_mat) if len(face_mat) else np.array([0])
        for mid in used:
            group = faces[face_mat == mid] if len(face_mat) else faces
            if not len(group):
                continue
            mat = material if material is not None else mats[mid]
            self.add_mesh(verts, group, transform=transform, material=mat,
                          normals=normals)
        return self

    def remove(self, handle) -> "SceneBuilder":
        """Unregister a previously added object (UnregisterObject analog,
        RayTraceObject.cs:47 -> RayTraceMaster.cs:224): pass the handle
        returned by add_sphere/add_mesh."""
        kind, idx = handle
        if kind == "sphere":
            self._sphere_removed.add(idx)
        else:
            self._mesh_removed.add(idx)
        self.dirty = True
        return self

    def set_ground(self, enabled: bool = True) -> "SceneBuilder":
        self._ground = enabled
        self.dirty = True
        return self

    def set_skybox(self, equirect: np.ndarray) -> "SceneBuilder":
        """Set the environment map: (H, W, 3) float, row 0 = +y pole."""
        self._skybox = np.asarray(equirect, np.float32)
        self.dirty = True
        return self

    # -- build ---------------------------------------------------------------
    def build(self, pad_triangles_to: Optional[int] = None) -> Scene:
        """Flatten registrations into a static-shape Scene pytree."""
        mats = list(self._materials)
        ground_mid = len(mats)
        mats.append(GROUND_MATERIAL)
        materials = Materials.from_list(mats)

        keep_s = [i for i in range(len(self._sphere_centers))
                  if i not in self._sphere_removed]
        if keep_s:
            spheres = Spheres(
                center=np.stack([self._sphere_centers[i] for i in keep_s]
                                ).astype(np.float32),
                radius=np.stack([self._sphere_radii[i] for i in keep_s]
                                ).astype(np.float32),
                material_id=np.asarray([self._sphere_mats[i] for i in keep_s],
                                       np.int32),
            )
        else:
            spheres = Spheres(center=np.zeros((0, 3), np.float32),
                              radius=np.zeros((0,), np.float32),
                              material_id=np.zeros((0,), np.int32))

        keep_m = [i for i in range(len(self._tri_v))
                  if i not in self._mesh_removed]
        if keep_m:
            tv = np.concatenate([self._tri_v[i] for i in keep_m], axis=0)
            tn = np.concatenate([self._tri_n[i] for i in keep_m], axis=0)
            tm = np.concatenate([self._tri_mat_ids[i] for i in keep_m], axis=0)
        else:
            tv = np.zeros((0, 3, 3), np.float32)
            tn = np.zeros((0, 3, 3), np.float32)
            tm = np.zeros((0,), np.int32)

        n_tris = len(tv)
        target = pad_triangles_to if pad_triangles_to is not None else n_tris
        if target < n_tris:
            raise ValueError(f"pad_triangles_to={target} < triangle count {n_tris}")
        if target > n_tris:
            # Degenerate (zero-area) padding: MT97 det == 0 -> guaranteed miss.
            pad = target - n_tris
            tv = np.concatenate([tv, np.zeros((pad, 3, 3), np.float32)], axis=0)
            tn = np.concatenate([tn, np.tile(np.array([[0, 1, 0]], np.float32),
                                             (pad * 3, 1)).reshape(pad, 3, 3)], axis=0)
            tm = np.concatenate([tm, np.zeros((pad,), np.int32)], axis=0)

        triangles = Triangles(
            v0=np.ascontiguousarray(tv[:, 0]), v1=np.ascontiguousarray(tv[:, 1]),
            v2=np.ascontiguousarray(tv[:, 2]),
            n0=np.ascontiguousarray(tn[:, 0]), n1=np.ascontiguousarray(tn[:, 1]),
            n2=np.ascontiguousarray(tn[:, 2]),
            material_id=np.asarray(tm, np.int32),
        )

        if self._skybox is None:
            skybox = np.zeros((2, 4, 3), np.float32)  # black sky
        else:
            skybox = self._skybox
        skybox = np.asarray(skybox, np.float32)

        from .ops.shade import pack_rgbe_np

        self.dirty = False
        # All leaves are host numpy: cheap to build and to feed the accel
        # builders; move to device once with jax.device_put (Renderer does).
        return Scene(
            spheres=spheres,
            triangles=triangles,
            materials=materials,
            ground_enabled=np.float32(1.0 if self._ground else 0.0),
            ground_material_id=np.int32(ground_mid),
            skybox=skybox,
            skybox_rgbe=pack_rgbe_np(skybox),
        )

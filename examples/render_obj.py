"""Render an OBJ mesh (honoring its .mtl materials) over the ground plane
with an HDR or EXR environment.

Usage: python examples/render_obj.py mesh.obj [env.hdr|env.exr] [out.png]
"""

import sys

import os
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from unityraytracer_tpu import Camera, Material, RenderConfig, Renderer, SceneBuilder
from unityraytracer_tpu.models.obj import load_obj_with_materials
from unityraytracer_tpu.models.skybox import load_environment, sun_sky
from unityraytracer_tpu.render import default_tracer
from unityraytracer_tpu.utils.math3d import trs_matrix


def main():
    mesh_path = sys.argv[1]
    env = load_environment(sys.argv[2])[..., :3] if len(sys.argv) > 2 \
        else sun_sky()
    out = sys.argv[3] if len(sys.argv) > 3 else "render.png"

    v, f, n, face_mat, mats = load_obj_with_materials(mesh_path)
    center = v.mean(axis=0)
    size = (v.max(axis=0) - v.min(axis=0)).max()

    b = SceneBuilder()
    offset = -center + (0, size / 2, 0)
    if face_mat.max(initial=0) > 0:  # OBJ ships .mtl materials — honor them
        b.add_obj(mesh_path, transform=trs_matrix(tuple(offset), (0, 0, 0)))
    else:
        b.add_mesh(v + offset, f, normals=n,
                   material=Material(albedo=(0.75, 0.71, 0.65),
                                     specular=(0.05,) * 3, smoothness=0.4))
    b.set_skybox(env)
    scene = b.build()

    cam = Camera.create(position=(0, size * 0.8, -size * 2.2),
                        look_at=(0, size / 2, 0), fov_y_deg=45, aspect=4 / 3)
    cfg = RenderConfig(width=800, height=608, bounces=5,
                       tracer=default_tracer(), wavefront=True)
    r = Renderer(scene, cam, cfg)
    r.step(48)
    print("wrote", r.save_screenshot(out))


if __name__ == "__main__":
    main()

"""Command-line entry point: ``python -m unityraytracer_tpu <cmd> ...``.

The reference is driven from the Unity editor (attach RayTraceMaster, press
play, F12 for screenshots — `RayTraceMaster.cs:751-866`); this CLI is the
headless equivalent: render a built-in fixture scene or an OBJ file to PNG
(and optionally a multi-part AOV EXR), or serve a live progressive preview.

Commands:
  render   one-shot progressive render -> PNG (+ --aovs EXR)
  preview  live refining preview (PNG file + optional local HTTP viewer)
  info     print device/backend and scene statistics

Examples:
  python -m unityraytracer_tpu render --scene scene1 -o out.png --frames 64
  python -m unityraytracer_tpu render --obj mesh.obj --env sky.exr -o out.png
  python -m unityraytracer_tpu preview --scene sample --port 8631
"""

from __future__ import annotations

import argparse
import sys


def _build_scene(args):
    import numpy as np
    from .camera import Camera
    from .models import fixtures
    from .models.skybox import load_environment, sun_sky

    aspect = args.width / args.height
    sky = (load_environment(args.env)[..., :3].astype(np.float32)
           if args.env else None)
    if getattr(args, "unity", None):
        from .models.unity_scene import load_unity_scene

        scene, cam, settings = load_unity_scene(
            args.unity, aspect=aspect, skybox=sky,
            include_disabled=args.include_disabled)
        if settings:
            print(f"unity scene settings: {settings}", file=sys.stderr)
        return scene, cam
    if args.obj:
        from .models.obj import load_obj_with_materials
        from .scene import Material, SceneBuilder
        from .utils.math3d import trs_matrix

        v, f, n, face_mat, mats = load_obj_with_materials(args.obj)
        center = v.mean(axis=0)
        size = float((v.max(axis=0) - v.min(axis=0)).max())
        b = SceneBuilder()
        offset = -center + (0, size / 2, 0)
        if face_mat.max(initial=0) > 0:     # honor shipped .mtl materials
            b.add_obj(args.obj, transform=trs_matrix(tuple(offset),
                                                     (0, 0, 0)))
        else:
            b.add_mesh(v + offset, f, normals=n,
                       material=Material(albedo=(0.75, 0.71, 0.65),
                                         specular=(0.05,) * 3,
                                         smoothness=0.4))
        b.set_skybox(sky if sky is not None else sun_sky())
        scene = b.build()
        cam = Camera.create(position=(0, size * 0.8, -size * 2.2),
                            look_at=(0, size / 2, 0), fov_y_deg=45,
                            aspect=aspect)
        return scene, cam
    if args.scene == "bench":
        scene = fixtures.bench_scene(n_tris=args.tris, skybox=sky)
        cam = Camera.create(position=(0.0, 14.0, -42.0),
                            look_at=(0.0, 2.0, 0.0), fov_y_deg=60.0,
                            aspect=aspect)
        return scene, cam
    if args.scene == "sample":
        return (fixtures.sample_scene(skybox=sky),
                fixtures.sample_scene_camera(aspect=aspect))
    return fixtures.scene1(skybox=sky), fixtures.scene1_camera(aspect=aspect)


def _make_renderer(args):
    from . import RenderConfig, Renderer
    from .render import default_tracer

    tracer = args.tracer or default_tracer()
    shard = getattr(args, "shard", None)
    cfg = RenderConfig(width=args.width, height=args.height, spp=args.spp,
                       bounces=args.bounces, tracer=tracer,
                       wavefront=True, rng_impl=args.rng,
                       dispatch_bands=args.bands)
    scene, cam = _build_scene(args)
    if shard:
        from .parallel.sharding import ShardedRenderer

        return ShardedRenderer(scene, cam, cfg, seed=args.seed, mode=shard)
    return Renderer(scene, cam, cfg, seed=args.seed)


def _add_common(p):
    p.add_argument("--scene", default="scene1",
                   choices=["scene1", "sample", "bench"],
                   help="built-in fixture scene (ignored with --obj)")
    p.add_argument("--obj", default=None, help="render an OBJ file (+.mtl)")
    p.add_argument("--unity", default=None,
                   help="render a Unity .unity scene file (reference "
                        "component model: RayTraceObject + colliders)")
    p.add_argument("--include-disabled", action="store_true",
                   help="with --unity: also load objects whose "
                        "RayTraceObject component is disabled")
    p.add_argument("--env", default=None, help=".hdr/.exr environment map")
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=360)
    p.add_argument("--spp", type=int, default=1)
    p.add_argument("--bounces", type=int, default=8)
    p.add_argument("--tracer", default=None,
                   help="brute|bvh|cluster|pallas (default: pallas on a "
                        "GPU, cluster on the CPU)")
    p.add_argument("--rng", default="threefry2x32",
                   help="threefry2x32|rbg (rbg = XLA RngBitGenerator bits, "
                        "backend-specific streams)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--bands", type=int, default=None,
                   help="render each frame as N band dispatches (bounds "
                        "single-dispatch device time and memory; see "
                        "RenderConfig.dispatch_bands)")
    p.add_argument("--frames", type=int, default=32,
                   help="progressive samples to accumulate")
    p.add_argument("--tris", type=int, default=100_000,
                   help="triangle count for --scene bench")
    p.add_argument("--shard", default=None,
                   choices=["rows", "spp", "scene"],
                   help="multi-device mode over all devices: rows = "
                        "framebuffer bands, spp = sample-parallel pmean, "
                        "scene = 1/n of the triangles per device")


def main(argv=None) -> int:
    from .utils.compcache import enable_persistent_cache

    enable_persistent_cache()  # repeat CLI renders skip the compile
    ap = argparse.ArgumentParser(prog="unityraytracer_tpu",
                                 description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("render", help="render to PNG (+ optional AOV EXR)")
    _add_common(pr)
    pr.add_argument("-o", "--out", default="render.png")
    pr.add_argument("--aovs", default=None,
                    help="also write a multi-part AOV EXR here")
    pr.add_argument("--denoise", action="store_true",
                    help="write the G-buffer-guided denoised image")
    pr.add_argument("--no-tonemap", action="store_true")

    pv = sub.add_parser("preview", help="live refining preview")
    _add_common(pv)
    pv.add_argument("-o", "--out", default="preview.png")
    pv.add_argument("--port", type=int, default=None,
                    help="serve http://localhost:<port>/")
    pv.add_argument("--every", type=int, default=4)

    pi = sub.add_parser("info", help="backend + scene statistics")
    _add_common(pi)

    args = ap.parse_args(argv)

    if args.cmd == "info":
        import jax

        scene, _cam = _build_scene(args)
        print(f"backend: {jax.default_backend()}  devices: {jax.devices()}")
        print(f"scene: {scene.num_spheres} spheres, "
              f"{scene.num_triangles} triangles, "
              f"skybox {tuple(scene.skybox.shape)}")
        return 0

    r = _make_renderer(args)
    if args.cmd == "preview":
        if args.shard:
            print("--shard applies to `render` (preview is single-device)",
                  file=sys.stderr)
            return 2
        r.watch(args.out, every=args.every, frames=args.frames,
                http_port=args.port)
        print(f"wrote {args.out} ({r.sample_count} samples)")
        return 0

    # render
    from .utils.image import tonemap_aces, write_png

    r.step(args.frames)
    img = (r.denoised_image(guided=True)
           if args.denoise and hasattr(r, "denoised_image") else r.image)
    write_png(args.out, img if args.no_tonemap else tonemap_aces(img))
    stats = r.stats
    print(f"wrote {args.out}: {args.frames} samples, "
          f"{stats['ms_per_frame']:.1f} ms/frame, "
          f"{stats['mrays_per_sec']:.1f} Mrays/s")
    if args.aovs:
        if hasattr(r, "save_aovs"):
            r.save_aovs(args.aovs)
            print(f"wrote {args.aovs} (beauty/albedo/normal/depth/emission)")
        else:
            print("--aovs needs the single-device renderer (no --shard)",
                  file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())

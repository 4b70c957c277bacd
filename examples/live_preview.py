"""Progressive live preview of Scene1 — the reference's editor display loop
(`OnRenderImage`/`Graphics.Blit`, RayTraceMaster.cs:848-866) for a headless
box: the render refines in place; open http://localhost:8631/ (or watch
preview.png) to see it converge.

Run:  python examples/live_preview.py [--tracer pallas] [--frames 64]
"""

import argparse


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tracer", default=None,
                    help="brute|cluster|pallas (default: pallas on a GPU, "
                         "cluster on the CPU)")
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=360)
    ap.add_argument("--port", type=int, default=8631)
    ap.add_argument("--out", default="preview.png")
    args = ap.parse_args()

    from unityraytracer_tpu import Renderer, RenderConfig
    from unityraytracer_tpu.models import fixtures
    from unityraytracer_tpu.render import default_tracer

    tracer = args.tracer or default_tracer()
    cfg = RenderConfig(width=args.width, height=args.height, spp=1, bounces=4,
                       tracer=tracer, cluster_size=64)
    scene = fixtures.scene1()
    cam = fixtures.scene1_camera(aspect=args.width / args.height)
    r = Renderer(scene, cam, cfg, seed=0)

    def report(rr):
        s = rr.stats
        print(f"samples={rr.sample_count:4d}  "
              f"{s['ms_per_frame']:7.1f} ms/frame  "
              f"{s['mrays_per_sec']:6.1f} Mrays/s -> {args.out}", flush=True)

    print(f"preview at http://localhost:{args.port}/  (ctrl-c stops)")
    r.watch(args.out, every=4, frames=args.frames, http_port=args.port,
            on_update=report)


if __name__ == "__main__":
    main()

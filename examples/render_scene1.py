"""Render the reference's main demo scene (Scene1) progressively.

Usage: python examples/render_scene1.py [frames] [out.png]
Uses the Pallas (Triton) tracer on a GPU, the cluster tracer on the CPU.
"""

import sys

import os
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from unityraytracer_tpu import RenderConfig, Renderer
from unityraytracer_tpu.models import fixtures
from unityraytracer_tpu.render import default_tracer


def main():
    frames = int(sys.argv[1]) if len(sys.argv) > 1 else 32
    out = sys.argv[2] if len(sys.argv) > 2 else "scene1.png"

    cfg = RenderConfig(width=640, height=480, spp=1, bounces=4,
                       tracer=default_tracer(), wavefront=True)
    scene = fixtures.scene1()
    camera = fixtures.scene1_camera(aspect=cfg.width / cfg.height)

    r = Renderer(scene, camera, cfg)
    r.step(frames)
    print(f"{frames} frames, {r.stats['ms_per_frame']:.1f} ms/frame, "
          f"{r.stats['mrays_per_sec']:.1f} Mrays/s")
    print("wrote", r.save_screenshot(out))


if __name__ == "__main__":
    main()

"""Static render configuration.

The reference exposes its knobs as Unity-serialized MonoBehaviour fields
(`RayTraceMaster.cs:8-18`: ``numBounces``, ``numRays``, resolution implied by the
render target). Here they live in a hashable frozen dataclass that is passed as a
static argument to the jitted frame step, so changing a knob triggers a clean
recompile rather than dynamic shapes.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static (compile-time) rendering knobs.

    Attributes:
      width/height: framebuffer size in pixels.
      spp: rays launched per pixel per frame (reference ``numRays``,
        `RayTraceMaster.cs:18`).
      bounces: path depth (reference ``numBounces``, `RayTraceMaster.cs:17`;
        code default 8).
      tracer: which intersection backend to use:
        - "brute": dense jnp ray x primitive tests (correctness reference)
        - "bvh": pure-jnp masked stackless LBVH traversal
        - "cluster": dense cluster-culling tracer (jnp, XLA-fused)
        - "pallas": Pallas closest-hit kernel compiled through Triton
          (ops/gpu_trace.py; the GPU fast path)
      ray_chunk: number of rays processed per tracer chunk (bounds peak memory
        of the (rays x primitives) brute-force product).
      cluster_size: triangles per LBVH leaf cluster (fast path granularity).
      wavefront: if True, park dead rays between bounces (origins relocated
        far outside every acceleration structure) so the XLA tracers cull
        them naturally. The Pallas tracer skips dead rays regardless of this
        flag: it zero-seeds their best-t so every culling test fails (the
        analog of the early-out at `RayTraceShader.compute:457-460`).
    """

    width: int = 256
    height: int = 256
    spp: int = 1
    bounces: int = 8
    tracer: str = "brute"
    ray_chunk: int = 8192
    cluster_size: int = 64
    wavefront: bool = False
    # Optional cap on traversal iterations for the jnp BVH path. None = 2*depth.
    max_traversal_steps: Optional[int] = None
    # Environment lookup through a packed RGBE plane (4 gathers/frame instead
    # of 12; ~0.4% radiance quantization, far below MC noise).
    sky_rgbe: bool = True
    # Unbiased Russian-roulette path termination from bounce 3 (survivors are
    # reweighted): collapses deep-bounce ray populations so the wavefront
    # parking skips whole tiles.
    russian_roulette: bool = True
    # Russian-roulette decision granularity: "ray" draws an independent
    # uniform per ray (the textbook estimator); "step" shares ONE uniform
    # across each (8 x 128)-pixel group, so deep-bounce survivors collapse
    # into whole groups (correlated RR via common random numbers: each ray
    # still survives with its own probability, so the estimator stays
    # unbiased; within-group deaths are correlated, slightly raising
    # per-frame variance on indirect light).
    rr_group: str = "ray"
    # Samples-per-pixel dispatched per tracer invocation. None = all of
    # ``spp`` in one dispatch. High-spp frames scale every path buffer by
    # spp (the reference's SampleScene quality preset is 25 rays/pixel,
    # SampleScene.unity:433-434 — 51.8M rays at 1080p); with a chunk the
    # frame renders as sequential sub-frames of ``spp_chunk`` samples
    # under ONE jit (lax.map over folded keys) and averages them with
    # exact spp weights. Unbiased (chunk keys are independent folds) and
    # tracer-stream-identical (chunking happens above tracer dispatch),
    # but the pixel<->uniform assignment differs from the unchunked
    # dispatch, so images match unchunked renders only in distribution.
    spp_chunk: Optional[int] = None
    # Host-banded frame dispatch. None/1 = whole frame per dispatch; n > 1
    # makes Renderer.step render each frame as n horizontal-band dispatches
    # (render_frame row0/rows) plus one combine/accumulate dispatch. Each
    # band folds the frame key by its band index — the single-chip analog
    # of mode="rows" sharding's per-device streams — so banded renders are
    # deterministic and unbiased but (like spp_chunk) match unbanded
    # dispatches in distribution, not bitwise. Bounds single-dispatch
    # device time and per-dispatch memory at n-1 extra dispatches per frame.
    # With tracer="pallas", choose n so band heights stay multiples of 8
    # (the 8x16 pixel blocking).
    dispatch_bands: Optional[int] = None
    # PRNG implementation for the per-frame random streams
    # ("threefry2x32" | "rbg"). "rbg" derives keys with threefry but
    # generates bits with the XLA RngBitGenerator. Streams stay
    # deterministic and IDENTICAL across every tracer for a given key (the
    # cross-tracer golden/oracle gates hold for any impl); they differ
    # BETWEEN impls, so changing this changes the noise pattern, not the
    # estimator. Default is JAX's default threefry.
    # PORTABILITY: "rbg" bits are BACKEND-SPECIFIC (XLA RngBitGenerator is
    # free to differ across backends and compiler versions), while
    # threefry is counter-based and bit-identical everywhere. Any
    # cross-backend comparison must therefore run both sides on ONE backend
    # or use threefry — under "rbg" the two images are independent
    # estimates of the same integral, not comparable pixelwise.
    rng_impl: str = "threefry2x32"

    @property
    def num_pixels(self) -> int:
        return self.width * self.height

    @property
    def num_rays(self) -> int:
        return self.width * self.height * self.spp

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)

"""Device-timeline profiling: parser unit tests + Renderer.profile smoke."""

import gzip
import json
import os

import numpy as np

from unityraytracer_tpu.utils.profiling import (DeviceProfile,
                                                parse_device_trace,
                                                profile_stages)


def _write_trace(tmp_path, events):
    path = os.path.join(tmp_path, "host.trace.json.gz")
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": events}, f)
    return path


def test_parse_synthetic_device_trace(tmp_path):
    tmp = str(tmp_path)
    events = [
        {"ph": "M", "pid": 1, "name": "process_name",
         "args": {"name": "python host"}},
        {"ph": "M", "pid": 3, "name": "process_name",
         "args": {"name": "/device:GPU:0"}},
        # Host event: must be excluded from device totals.
        {"ph": "X", "pid": 1, "tid": 1, "ts": 0, "dur": 99000,
         "name": "python_dispatch"},
        # Device events: 3 bounces of the trace kernel + a fusion + misc.
        {"ph": "X", "pid": 3, "tid": 1, "ts": 100, "dur": 2000,
         "name": "gpu_trace_kernel"},
        {"ph": "X", "pid": 3, "tid": 1, "ts": 3000, "dur": 5000,
         "name": "gpu_trace_kernel"},
        {"ph": "X", "pid": 3, "tid": 1, "ts": 9000, "dur": 7000,
         "name": "gpu_trace_kernel"},
        {"ph": "X", "pid": 3, "tid": 1, "ts": 17000, "dur": 1500,
         "name": "loop_add_fusion_42"},
        {"ph": "X", "pid": 3, "tid": 1, "ts": 19000, "dur": 500,
         "name": "custom-call.7"},
    ]
    _write_trace(tmp, events)
    prof = parse_device_trace(tmp)
    assert isinstance(prof, DeviceProfile)
    np.testing.assert_allclose(prof.total_ms, 16.0)
    np.testing.assert_allclose(prof.stages_ms["trace_kernel"], 14.0)
    np.testing.assert_allclose(prof.stages_ms["fusion"], 1.5)
    np.testing.assert_allclose(prof.stages_ms["other"], 0.5)
    # Per-occurrence = per-bounce, in timestamp order.
    np.testing.assert_allclose(prof.per_occurrence_ms["trace_kernel"],
                               [2.0, 5.0, 7.0])
    assert prof.top_ops[0][0] == "gpu_trace_kernel"
    assert "trace_kernel" in prof.report()


def test_parse_uses_self_time_for_nested_events(tmp_path):
    # Device rows nest (module > subcomputation > kernel): parents must be
    # charged only their SELF time, or totals double-count.
    tmp = str(tmp_path)
    events = [
        {"ph": "M", "pid": 3, "name": "process_name",
         "args": {"name": "/device:GPU:0"}},
        {"ph": "X", "pid": 3, "tid": 1, "ts": 0, "dur": 10000,
         "name": "jit_step"},                       # parent: 10 ms span
        {"ph": "X", "pid": 3, "tid": 1, "ts": 1000, "dur": 6000,
         "name": "gpu_trace_kernel"},                  # nested child: 6 ms
        {"ph": "X", "pid": 3, "tid": 1, "ts": 8000, "dur": 1000,
         "name": "loop_fusion.1"},                  # nested child: 1 ms
    ]
    _write_trace(tmp, events)
    prof = parse_device_trace(tmp)
    np.testing.assert_allclose(prof.total_ms, 10.0)  # span, not 17
    np.testing.assert_allclose(prof.stages_ms["trace_kernel"], 6.0)
    np.testing.assert_allclose(prof.stages_ms["fusion"], 1.0)
    # The jit_* umbrella's SELF time is the dispatch/gap overhead bucket.
    np.testing.assert_allclose(prof.stages_ms["dispatch"], 3.0)


def test_parse_falls_back_without_process_names(tmp_path):
    tmp = str(tmp_path)
    events = [
        {"ph": "X", "pid": 3, "tid": 1, "ts": 0, "dur": 4000, "name": "k"},
    ]
    _write_trace(tmp, events)
    prof = parse_device_trace(tmp)
    np.testing.assert_allclose(prof.total_ms, 4.0)


def test_parse_back_to_back_kernels_are_not_nested(tmp_path):
    # GPU stream events abut with rounding overlap (the next kernel starts
    # tens of ns before the previous one "ends"); neither is the other's
    # child, so each keeps its full duration.
    tmp = str(tmp_path)
    events = [
        {"ph": "M", "pid": 1, "name": "process_name",
         "args": {"name": "/device:GPU:0"}},
        {"ph": "X", "pid": 1, "tid": 13, "ts": 0.0, "dur": 2000.0,
         "name": "gpu_trace_kernel"},
        {"ph": "X", "pid": 1, "tid": 13, "ts": 1999.94, "dur": 15.0,
         "name": "loop_compare_select_fusion_15"},
        {"ph": "X", "pid": 1, "tid": 13, "ts": 2014.9, "dur": 500.0,
         "name": "gpu_trace_kernel"},
    ]
    _write_trace(tmp, events)
    prof = parse_device_trace(tmp)
    np.testing.assert_allclose(prof.per_occurrence_ms["trace_kernel"],
                               [2.0, 0.5])
    np.testing.assert_allclose(prof.stages_ms["fusion"], 0.015)
    np.testing.assert_allclose(prof.total_ms, 2.515)


def test_parse_classifies_by_scope_and_module_args(tmp_path):
    # Outside a command buffer an event's args carry its HLO module and
    # scope path; the stage regexes read them beside the kernel name.
    tmp = str(tmp_path)
    events = [
        {"ph": "M", "pid": 1, "name": "process_name",
         "args": {"name": "/device:GPU:0"}},
        {"ph": "X", "pid": 1, "tid": 2, "ts": 0, "dur": 1000,
         "name": "input_concatenate_fusion",
         "args": {"hlo_module": "jit__threefry_split"}},
        {"ph": "X", "pid": 1, "tid": 2, "ts": 2000, "dur": 3000,
         "name": "loop_multiply_fusion",
         "args": {"name": "jit(step)/while/body/shade/mul"}},
        {"ph": "X", "pid": 1, "tid": 2, "ts": 6000, "dur": 500,
         "name": "loop_gather_fusion",
         "args": {"name": "jit(step)/env_lookup/gather"}},
    ]
    _write_trace(tmp, events)
    prof = parse_device_trace(tmp)
    assert prof.stages_ms == {"rng": 1.0, "shade": 3.0, "env": 0.5}
    # top_ops stay keyed by the bare kernel name.
    assert {n for n, _, _ in prof.top_ops} == {
        "input_concatenate_fusion", "loop_multiply_fusion",
        "loop_gather_fusion"}


def test_parse_recorded_gpu_frame():
    # One 1080p, 8-bounce frame step recorded with jax.profiler on an
    # NVIDIA H100 (tests/gpu_step.trace.json.gz, trimmed to the device
    # row and a few host events): the Triton kernel shows once per bounce,
    # the host row is ignored, and nothing is lost to false nesting.
    import gzip

    path = os.path.join(os.path.dirname(__file__), "gpu_step.trace.json.gz")
    with gzip.open(path, "rt") as f:
        events = json.load(f)["traceEvents"]
    device = [e for e in events if e.get("ph") == "X" and e["pid"] == 1]
    prof = parse_device_trace(path)
    assert len(prof.per_occurrence_ms["trace_kernel"]) == 8
    np.testing.assert_allclose(
        prof.total_ms, sum(e["dur"] for e in device) / 1000.0, rtol=1e-9)
    kernel = [e["dur"] / 1000.0 for e in sorted(device, key=lambda e: e["ts"])
              if e["name"] == "gpu_trace_kernel"]
    np.testing.assert_allclose(prof.per_occurrence_ms["trace_kernel"], kernel)
    assert prof.stages_ms["trace_kernel"] > 0.8 * prof.total_ms
    assert prof.top_ops[0][0] == "gpu_trace_kernel"


def test_renderer_profile_smoke():
    # On CPU the "device" rows are host-side, so only sanity is asserted:
    # the call must produce a finite, nonzero breakdown and store it.
    from unityraytracer_tpu import Camera, RenderConfig, Renderer, SceneBuilder

    b = SceneBuilder()
    b.add_sphere((0, 1, 0), 1.0)
    b.set_skybox(np.ones((2, 4, 3), np.float32))
    scene = b.build()
    cam = Camera.create(position=(0, 1.5, -6), look_at=(0, 1, 0),
                        fov_y_deg=60, aspect=1.0)
    cfg = RenderConfig(width=16, height=16, spp=1, bounces=2, tracer="brute")
    r = Renderer(scene, cam, cfg, seed=0)
    prof = r.profile(1)
    assert prof.total_ms >= 0.0
    assert r.stats["device"] is prof
    # profile() runs one warm-up frame (outside the trace) + n_frames.
    assert r.sample_count == 2


def test_profile_stages_runs_real_computation():
    import jax
    import jax.numpy as jnp

    f = jax.jit(lambda x: jnp.tanh(x @ x).sum())
    x = jnp.ones((256, 256))
    f(x)  # compile outside the trace
    prof = profile_stages(lambda: f(x))
    assert prof.total_ms >= 0.0


def test_renderer_profile_integration(tmp_path):
    # The WIRED path (Renderer.profile -> jax.profiler trace -> parser) the
    # perf work steers by — previously only the parser was unit-tested.
    import numpy as np
    from unityraytracer_tpu import (Camera, Material, RenderConfig, Renderer,
                                    SceneBuilder)

    b = SceneBuilder()
    b.add_sphere((0, 1.0, 0), 1.0, Material(albedo=(0.7, 0.3, 0.2)))
    b.set_skybox(np.ones((2, 4, 3), np.float32))
    scene = b.build()
    cam = Camera.create(position=(0, 1.5, -5), look_at=(0, 1, 0),
                        fov_y_deg=60, aspect=1.0)
    cfg = RenderConfig(width=16, height=16, spp=1, bounces=2, tracer="brute")
    r = Renderer(scene, cam, cfg, seed=0)
    prof = r.profile(n_frames=2)
    # CPU backend still emits a parseable trace; the contract is: a
    # DeviceProfile lands in stats with non-negative totals and stage map.
    assert r.stats["device"] is prof
    assert prof.total_ms >= 0.0
    assert isinstance(prof.stages_ms, dict) and "other" in prof.stages_ms
    assert r.sample_count == 3   # warm-up + 2 profiled frames

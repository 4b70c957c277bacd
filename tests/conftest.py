"""Test harness config: force CPU with 8 virtual devices.

Multi-device logic is validated on a virtual device mesh (the analog of
testing multi-node collectives without a cluster); the Pallas (Triton) kernel
runs in interpret mode. Must run before any test imports jax. Tests that only
a GPU can run are phases of chip_smoke.py, not skipped tests here.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from unityraytracer_tpu.utils.compcache import enable_persistent_cache  # noqa: E402

# CPU test compiles are plentiful and deterministic — cache them across runs.
enable_persistent_cache()

import pytest  # noqa: E402

# ---------------------------------------------------------------------------
# Speed tiers. "slow" marks redundant-BREADTH coverage — repeated cross-path
# image sweeps and end-to-end soak configs, each >=12 s in a full-pass
# `--durations` log. The core correctness gates stay fast: golden scene1
# regression, kernel/cluster/bvh-vs-brute identities, and every sub-second
# unit test.
# ---------------------------------------------------------------------------

_SLOW_BASES = {
    # cross-path image sweeps / soak configs
    "test_deep_bounce_rr_cross_path",
    "test_rng_impl_rbg_cross_tracer",
    "test_sample_scene_shipped_quality_settings",
    "test_cli_render_and_info",
    "test_graft_entry_and_dryrun",
    "test_render_aovs_and_multipart_export",
    "test_renderer_denoised_image",
    "test_single_cluster_scene",
    # multi-device breadth
    "test_rows_band_equivalence_deterministic",
    "test_scene_sharding_pallas_matches_single_device",
    "test_rows_scene_composed_2d_mesh_matches_rows",
    "test_sharded_preview_export_surface",
}


def pytest_collection_modifyitems(config, items):
    for it in items:
        if it.name.partition("[")[0] in _SLOW_BASES:
            it.add_marker(pytest.mark.slow)

"""Test configuration: the CPU backend with 8 virtual devices by default.

Unit and golden tests run on the CPU for determinism and speed; multi-chip
sharding tests fake an 8-device mesh on one host.  ``JAX_PLATFORMS`` is set
to ``cpu`` only when it is unset, so ``JAX_PLATFORMS=cuda pytest -m gpu``
runs the ``gpu``-marked tests on a card (they skip without one).
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import pytest  # noqa: E402

# Fast/slow tiers: every test that measured >= ~4 s on a
# 1-CPU box is auto-marked ``slow`` so ``pytest -m "not slow"`` is an
# affordable pre-commit smoke tier (< ~2 min here, < 5 min on a slow box).
# The FULL suite stays the merge bar; this list only adds markers, never
# deselects.  Matching is by test name (parametrized ids inherit their base
# name's mark).  Re-derive with ``pytest --durations=60`` after big changes.
_SLOW_TESTS = {
    "test_checkpoint_rejects_different_scene",
    "test_checkpointed_frame_pool_matches_plain",
    "test_checkpointed_matches_plain",
    "test_cli_jitter_env",
    "test_fuzz_scene_mean_parity",
    "test_practice2_dielectric_and_metal",
    "test_practice5_mc_converges",
    "test_scene001_lit_is_shaded",
    "test_whitted_deep_depth",
    "test_whitted_deterministic",
    "test_whitted_plane_lights_analytic",
    "test_whitted_shadow",
    "test_thousand_light_scene_renders",
    "test_multihost_checkpoint_resume",
    "test_multihost_two_process_desynced_checkpoint_resume",
    "test_multihost_two_processes",
    "test_sharded_large_scene_sort_path",
    "test_sharded_matches_single_device",
    "test_sharded_nondivisible_spp",
    "test_sharded_padded_tail_counter_parity",
    "test_sharded_sample_start_offset",
    "test_sharded_sobol_jitter_matches_single_device",
    "test_env_map_golden",
    "test_env_map_hdr_golden",
    "test_estimator_variance_parity",
    "test_frame_pool_matches_chunked",
    "test_golden_rmse",
    "test_light_triangle_golden",
    "test_nonsquare_aspect_golden",
    "test_packed_permute_estimator_identical",
    "test_persistent_engine_matches_scan",
    "test_persistent_engine_sample_start",
    "test_render_smoke_no_nans",
    "test_sort_keys_observationally_free",
    "test_camera_moves_do_not_recompile",
    "test_renderer_roundtrip",
    "test_atrium_bench_scene_enclosed",
    "test_sah_vs_morton_render_agree",
    "test_quad_pool_bit_equal",
    "test_sample_many_matches_individual_samples",
    "test_leaf_traversal_matches_dense",
    "test_leaf_traversal_small_k_forces_multiround",
    "test_maximal_asset_mean_parity",
    "test_lowdisc_sobol_unbiased_and_quieter",
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: test measured >= ~4 s on a 1-CPU box"
    )
    config.addinivalue_line(
        "markers", "gpu: runs only on a GPU (skips elsewhere)"
    )


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skip ``gpu``-marked tests when JAX's backend is not a GPU (decided
    here, at run time, so every xdist worker collects the same tests)."""
    if request.node.get_closest_marker("gpu") is not None:
        import jax

        if jax.default_backend() != "gpu":
            pytest.skip(f"needs a GPU (JAX backend is {jax.default_backend()})")


def pytest_collection_modifyitems(config, items):
    for item in items:
        if item.originalname in _SLOW_TESTS or item.name in _SLOW_TESTS:
            item.add_marker(pytest.mark.slow)

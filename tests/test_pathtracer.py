"""Integrator tests: smoke, determinism, and golden-image RMSE vs the C++
reference binary's renders (SURVEY §4's "RMSE within noise floor" contract).
"""

import dataclasses
import os

import numpy as np
import pytest

from tpu_pathtracer.config import RenderConfig
from tpu_pathtracer.models.pathtracer import render
from tpu_pathtracer.scene.gltf import parse_gltf_scene
from tpu_pathtracer.utils.image import quantize_u8, read_ppm
from tpu_pathtracer.utils.testscenes import (
    make_cornell_gltf,
    make_textured_cornell_gltf,
)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")


def _load(fixture, tmp_path, w, h):
    p = fixture(str(tmp_path / "scene.gltf"))
    scene = parse_gltf_scene(p, w / h)
    return dataclasses.replace(scene, camera=scene.camera.with_dims(w, h))


def test_render_smoke_no_nans(tmp_path):
    scene = _load(make_cornell_gltf, tmp_path, 32, 32)
    img = render(scene, spp=4, seed=0)
    assert img.shape == (32, 32, 3)
    assert np.isfinite(img).all()
    assert img.max() > 0.05  # scene is lit


def test_render_deterministic(tmp_path):
    scene = _load(make_cornell_gltf, tmp_path, 16, 16)
    a = render(scene, spp=2, seed=7)
    b = render(scene, spp=2, seed=7)
    np.testing.assert_array_equal(a, b)
    c = render(scene, spp=2, seed=8)
    assert np.abs(a - c).max() > 0


def test_ray_depth_zero_returns_background(tmp_path):
    scene = _load(make_cornell_gltf, tmp_path, 8, 8)
    scene = dataclasses.replace(scene, ray_depth=0)
    img = render(scene, spp=1, seed=0)
    np.testing.assert_allclose(img, 1.0)  # white env background


def test_persistent_engine_matches_scan(tmp_path):
    """The persistent-wavefront (path regeneration / stream compaction)
    engine is estimator-identical to the scan engine: per-lane RNG keys
    compose (sample, depth, pixel) exactly like the scan chain."""
    scene = _load(make_cornell_gltf, tmp_path, 24, 24)
    a = render(scene, spp=5, seed=3, config=RenderConfig(compaction=False))
    b = render(scene, spp=5, seed=3, config=RenderConfig(compaction=True))
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


def test_frame_pool_matches_chunked(tmp_path):
    """config.frame_pool pools the whole frame's work into each persistent
    call (accumulator sized to the frame, lanes unchanged).  Same (pixel,
    sample, depth) RNG streams -> identical paths; only the per-pixel fp
    summation order moves, and the measured rays-traced count is EXACTLY the
    chunked engine's because the set of traced paths is identical."""
    scene = _load(make_cornell_gltf, tmp_path, 32, 32)  # 1024 px, 2 chunks
    stats_a, stats_b = {}, {}
    a = render(scene, spp=3, seed=5,
               config=RenderConfig(rays_per_batch=512), stats=stats_a)
    b = render(scene, spp=3, seed=5,
               config=RenderConfig(rays_per_batch=512, frame_pool=True),
               stats=stats_b)
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
    assert stats_a["measured_rays"] == stats_b["measured_rays"]


def test_measured_rays_stats(tmp_path):
    """render(stats=...) reports the TRUE rays traced by the persistent
    engine: at least one ray per (useful pixel, sample) work item, at most
    ray_depth of them — and none for the ray-tile padding (the work pool is
    dense over useful pixels, so out-of-image lanes are never spawned;
    padding would inflate both work and the count)."""
    scene = _load(make_cornell_gltf, tmp_path, 16, 16)
    config = RenderConfig(compaction=True)
    spp = 4
    stats = {}
    img = render(scene, spp=spp, seed=0, config=config, stats=stats)
    assert np.isfinite(img).all()
    n = stats["measured_rays"]
    npix = 16 * 16
    assert npix * spp <= n <= npix * spp * scene.ray_depth
    # Cornell is mostly enclosed: typical paths bounce more than once.
    assert n > int(1.5 * npix * spp)


def test_persistent_engine_sample_start(tmp_path):
    """sample_start routes through the persistent engine's work pool: the
    [0,2) + [2,4) splits average to the [0,4) render."""
    import jax.numpy as jnp
    import jax

    from tpu_pathtracer.models.pathtracer import render_chunk_persistent

    scene = _load(make_cornell_gltf, tmp_path, 8, 8)
    config = RenderConfig(compaction=True)
    base = jax.random.key(9)
    args = lambda s0, spp: (
        scene, jnp.asarray(0, jnp.int32), base, jnp.asarray(s0, jnp.int32),
        64, spp, config,
    )
    lo = np.asarray(render_chunk_persistent(*args(0, 2))[0])
    hi = np.asarray(render_chunk_persistent(*args(2, 2))[0])
    both = np.asarray(render_chunk_persistent(*args(0, 4))[0])
    np.testing.assert_allclose((lo + hi) / 2, both, rtol=0, atol=1e-5)


def test_env_map_golden(tmp_path):
    """Environment-map path vs a reference build compiled with USE_ENV_MAP
    (the reference's env knobs are compile-time; ours are runtime config)."""
    from tpu_pathtracer.utils.testscenes import make_env_image

    path = os.path.join(GOLDEN_DIR, "cornell_env_64x64_4096spp.ppm")
    if not os.path.exists(path):
        pytest.skip("golden not generated")
    ref = read_ppm(path).astype(np.float64)
    env_png = make_env_image(str(tmp_path / "env.png"))
    config = RenderConfig(use_env_map=True, env_map_path=env_png)
    p = make_cornell_gltf(str(tmp_path / "scene.gltf"))
    scene = parse_gltf_scene(p, 1.0, config)
    scene = dataclasses.replace(scene, camera=scene.camera.with_dims(64, 64))
    img = render(scene, spp=64, seed=0, config=config)
    ours = np.asarray(quantize_u8(img), dtype=np.float64)
    rmse = float(np.sqrt(((ours - ref) ** 2).mean()))
    assert rmse < 14.0, f"env-map RMSE vs reference too high: {rmse}"
    assert np.abs(ours.mean() - ref.mean()) < 3.0


def test_env_map_hdr_golden(tmp_path):
    """Radiance-HDR env map vs a reference build whose ENV_MAP_PATH is a real
    .hdr file (the reference's default env format, src/config.h:38), decoded
    by stb_image.  Proves the utils/hdr codec matches stb's HDR->LDR path."""
    from tpu_pathtracer.utils.testscenes import make_env_hdr

    path = os.path.join(GOLDEN_DIR, "cornell_envhdr_64x64_4096spp.ppm")
    if not os.path.exists(path):
        pytest.skip("golden not generated")
    ref = read_ppm(path).astype(np.float64)
    env_hdr = make_env_hdr(str(tmp_path / "env.hdr"))
    config = RenderConfig(use_env_map=True, env_map_path=env_hdr)
    p = make_cornell_gltf(str(tmp_path / "scene.gltf"))
    scene = parse_gltf_scene(p, 1.0, config)
    scene = dataclasses.replace(scene, camera=scene.camera.with_dims(64, 64))
    img = render(scene, spp=64, seed=0, config=config)
    ours = np.asarray(quantize_u8(img), dtype=np.float64)
    rmse = float(np.sqrt(((ours - ref) ** 2).mean()))
    assert rmse < 14.0, f"hdr env-map RMSE vs reference too high: {rmse}"
    assert np.abs(ours.mean() - ref.mean()) < 3.0


def test_light_triangle_golden(tmp_path):
    """ADD_LIGHT_TRIANGLE camera-space extra light (src/scene.h:479-498) vs a
    reference build compiled with the flag on."""
    path = os.path.join(GOLDEN_DIR, "cornell_lt_64x64_4096spp.ppm")
    if not os.path.exists(path):
        pytest.skip("golden not generated")
    ref = read_ppm(path).astype(np.float64)
    config = RenderConfig(add_light_triangle=True)
    p = make_cornell_gltf(str(tmp_path / "scene.gltf"))
    scene = parse_gltf_scene(p, 1.0, config)
    scene = dataclasses.replace(scene, camera=scene.camera.with_dims(64, 64))
    img = render(scene, spp=64, seed=0, config=config)
    ours = np.asarray(quantize_u8(img), dtype=np.float64)
    rmse = float(np.sqrt(((ours - ref) ** 2).mean()))
    assert rmse < 14.0, f"light-triangle RMSE vs reference too high: {rmse}"
    assert np.abs(ours.mean() - ref.mean()) < 3.0


def test_estimator_variance_parity(tmp_path):
    """The estimator's NOISE must match the reference's, not just its mean:
    compare MSE-to-converged of our 16-spp render vs the reference's own
    16-spp render (both against the 4096-spp golden).  A wrong pdf or MIS
    weight inflates variance even when the mean stays right."""
    lo = os.path.join(GOLDEN_DIR, "cornell_64x64_16spp.ppm")
    hi = os.path.join(GOLDEN_DIR, "cornell_64x64_4096spp.ppm")
    if not (os.path.exists(lo) and os.path.exists(hi)):
        pytest.skip("goldens not generated")
    ref16 = read_ppm(lo).astype(np.float64)
    ref = read_ppm(hi).astype(np.float64)
    scene = _load(make_cornell_gltf, tmp_path, 64, 64)
    img = render(scene, spp=16, seed=0)
    ours16 = np.asarray(quantize_u8(img), dtype=np.float64)
    mse_ref = ((ref16 - ref) ** 2).mean()
    mse_ours = ((ours16 - ref) ** 2).mean()
    ratio = mse_ours / mse_ref
    assert 0.7 < ratio < 1.4, f"variance ratio vs reference: {ratio:.3f}"


def test_nonsquare_aspect_golden(tmp_path):
    """96x64 render vs reference: pins the fov_y/aspect derivation."""
    path = os.path.join(GOLDEN_DIR, "cornell_96x64_4096spp.ppm")
    if not os.path.exists(path):
        pytest.skip("golden not generated")
    ref = read_ppm(path).astype(np.float64)
    scene = _load(make_cornell_gltf, tmp_path, 96, 64)
    img = render(scene, spp=64, seed=0)
    ours = np.asarray(quantize_u8(img), dtype=np.float64)
    rmse = float(np.sqrt(((ours - ref) ** 2).mean()))
    assert rmse < 14.0, f"non-square RMSE too high: {rmse}"
    assert np.abs(ours.mean() - ref.mean()) < 3.0


@pytest.mark.parametrize(
    "fixture,golden",
    [
        (make_cornell_gltf, "cornell_64x64_4096spp.ppm"),
        (make_textured_cornell_gltf, "textured_64x64_4096spp.ppm"),
    ],
)
def test_golden_rmse(tmp_path, fixture, golden):
    """Render at modest spp and compare tonemapped u8 output against the C++
    reference's 4096-spp golden.  The tolerance is the test render's MC noise
    floor (measured ~5-8 u8 RMSE at 64 spp on these scenes); a bias bug
    (wrong pdf, flipped normal, missing term) shifts RMSE well above it."""
    path = os.path.join(GOLDEN_DIR, golden)
    if not os.path.exists(path):
        pytest.skip("golden not generated")
    ref = read_ppm(path).astype(np.float64)
    scene = _load(fixture, tmp_path, 64, 64)
    img = render(scene, spp=64, seed=0)
    ours = np.asarray(quantize_u8(img), dtype=np.float64)
    rmse = float(np.sqrt(((ours - ref) ** 2).mean()))
    assert rmse < 14.0, f"RMSE vs reference golden too high: {rmse}"
    # Mean radiance must agree tightly (bias check, noise-independent).
    assert np.abs(ours.mean() - ref.mean()) < 3.0


def test_chunk_retry_recovers_exactly(tmp_path, monkeypatch):
    """A device execution that dies at readback is repaired by recomputing
    the chunk; the recovered render is bit-identical to an undisturbed one."""
    import tpu_pathtracer.models.pathtracer as pt

    scene = _load(make_cornell_gltf, tmp_path, 16, 16)
    want = render(scene, spp=3, seed=4)

    class Bomb:
        """Accumulator whose readback raises like a crashed device worker."""

        def __init__(self, arr):
            self.arr = arr

        def __mul__(self, x):
            return Bomb(self.arr * x)

        def __add__(self, other):
            return Bomb(self.arr + getattr(other, "arr", other))

        def __getitem__(self, sl):
            raise RuntimeError("device worker process crashed (simulated)")

        def __array__(self, *a, **kw):
            raise RuntimeError("device worker process crashed (simulated)")

    # Poison the FIRST chunk's first dispatch only; the retry recomputes it
    # through the (restored) real engine.
    engine = pt.render_chunk_persistent
    state = {"first": True}

    def flaky_engine(*args, **kw):
        rad, nb = engine(*args, **kw)
        if state["first"]:
            state["first"] = False
            # A real worker crash poisons EVERY array of that execution,
            # including the bounce-count scalar: the stats path must survive
            # it too (it used to re-raise at the stats line AFTER a
            # successful recompute — code-review r3 finding).
            return Bomb(rad), Bomb(nb)
        return rad, nb

    monkeypatch.setattr(pt, "render_chunk_persistent", flaky_engine)
    stats = {}
    got = render(scene, spp=3, seed=4, stats=stats)
    np.testing.assert_array_equal(got, want)
    # The recovered render's measured-ray count comes from the recompute and
    # matches the undisturbed render's.
    ref_stats = {}
    render(scene, spp=3, seed=4, stats=ref_stats)
    assert stats["measured_rays"] == ref_stats["measured_rays"] > 0


def test_sort_keys_observationally_free(tmp_path):
    """Wavefront ray sorting is a pure perf knob: every sort_key policy
    (hint / cell / dirhint) renders the bit-identical image, because per-pixel
    counter RNG makes ray order irrelevant to each path's draws.  Engages the
    real sort path: scene capacity > 1024."""
    from tpu_pathtracer.utils.testscenes import make_sphere_field_gltf

    p = make_sphere_field_gltf(
        str(tmp_path / "field.gltf"), n_spheres=4, subdiv=2
    )
    scene = parse_gltf_scene(p, 2.0)
    scene = dataclasses.replace(
        scene, camera=scene.camera.with_dims(64, 32), ray_depth=3
    )
    assert scene.capacity > 1024
    imgs = [
        render(scene, spp=1, seed=5, config=RenderConfig(sort_key=k))
        for k in ("hint", "cell", "dirhint")
    ]
    assert np.isfinite(imgs[0]).all() and imgs[0].max() > 0.01
    np.testing.assert_array_equal(imgs[0], imgs[1])
    np.testing.assert_array_equal(imgs[0], imgs[2])


def test_unknown_sort_key_rejected(tmp_path):
    """Typos must fail loudly: a silent fall-through to the 'cell' key would
    time the wrong variant in an A/B."""
    import pytest

    from tpu_pathtracer.utils.testscenes import make_sphere_field_gltf

    p = make_sphere_field_gltf(str(tmp_path / "f.gltf"), n_spheres=4, subdiv=2)
    scene = parse_gltf_scene(p, 1.0)
    scene = dataclasses.replace(scene, camera=scene.camera.with_dims(64, 64))
    with pytest.raises(ValueError, match="unknown sort_key"):
        render(scene, spp=1, seed=0, config=RenderConfig(sort_key="taget"))


def test_packed_permute_helper_bit_exact():
    """The packed carry permutation (two typed blocks, one wide-row gather
    each) must be bit-for-bit the same data movement as the per-array takes
    — for f32 vec3s and int32/bool scalars alike, under jit."""
    import jax
    import jax.numpy as jnp

    from tpu_pathtracer.models.pathtracer import _permute_carries

    r = 4096
    ks = jax.random.split(jax.random.key(7), 5)
    vec3s = tuple(jax.random.uniform(k, (r, 3), jnp.float32) for k in ks[:4])
    scalars = (
        jax.random.randint(ks[4], (r,), -(2**30), 2**30, jnp.int32),
        jnp.arange(r, dtype=jnp.int32) % 7 == 0,  # bool lane
        jnp.full((r,), -1, jnp.int32),
    )
    perm = jax.random.permutation(ks[0], r)

    @jax.jit
    def both(perm, vec3s, scalars):
        return (_permute_carries(perm, vec3s, scalars, packed=False),
                _permute_carries(perm, vec3s, scalars, packed=True))

    (va, sa), (vb, sb) = both(perm, vec3s, scalars)
    for x, y in zip(va, vb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    for x, y in zip(sa, sb):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_packed_permute_estimator_identical(tmp_path):
    """tuning.packed_permute=1 rides every per-bounce carry through one
    wide f32 row block + one int32 block (single gathers) instead of 10
    narrow takes.  The movement itself is bit-exact (test above), but the
    packed layout changes XLA's fusion of the *producing* ops, so whole
    renders differ by fp-noise-level reassociation (ulp diffs that can flip
    an RR coin on isolated lanes).  Contract: the overwhelming majority of
    pixels bit-equal, the estimator mean unchanged within MC tolerance —
    in both the persistent (compaction) and scan engines."""
    from tpu_pathtracer.config import IntersectTuning
    from tpu_pathtracer.utils.testscenes import make_sphere_field_gltf

    p = make_sphere_field_gltf(
        str(tmp_path / "field.gltf"), n_spheres=4, subdiv=2
    )
    scene = parse_gltf_scene(p, 2.0)
    scene = dataclasses.replace(
        scene, camera=scene.camera.with_dims(64, 32), ray_depth=3
    )
    assert scene.capacity > 1024  # the sorted branch must engage
    for compaction in (True, False):
        base = RenderConfig(compaction=compaction)
        packed = RenderConfig(
            compaction=compaction,
            tuning=IntersectTuning(packed_permute=1),
        )
        a = render(scene, spp=2, seed=5, config=base)
        b = render(scene, spp=2, seed=5, config=packed)
        assert np.isfinite(a).all() and np.isfinite(b).all()
        assert a.max() > 0.01
        # Pure-fp-noise divergence: isolated RR-flipped paths only.
        assert np.mean(a != b) < 0.05, np.mean(a != b)
        assert abs(float(a.mean()) - float(b.mean())) < 0.02 * float(a.mean())


def test_lowdisc_sobol_unbiased_and_quieter(tmp_path):
    """lowdisc='sobol' (Owen-Sobol VNDF + light-point pairs)
    keeps the estimator mean (unbiased: Owen scrambling preserves the
    uniform marginal of every draw) while reducing per-pixel variance on a
    light-sampling-dominated scene.  Both engines dispatch it identically
    (bounce_draws is shared)."""
    scene = _load(make_cornell_gltf, tmp_path, 24, 24)
    base = RenderConfig()
    son = dataclasses.replace(base, lowdisc="sobol")

    # Unbiasedness: image means agree at MC-noise scale.
    a = render(scene, spp=64, seed=1, config=base)
    b = render(scene, spp=64, seed=1, config=son)
    assert abs(a.mean() - b.mean()) < 0.02, (a.mean(), b.mean())

    # Variance: per-pixel MSE against a high-spp converged reference drops.
    ref = render(scene, spp=1024, seed=99, config=base)
    mse_u = float(((a - ref) ** 2).mean())
    mse_s = float(((b - ref) ** 2).mean())
    assert mse_s < mse_u, (mse_s, mse_u)


def test_lowdisc_sobol_engines_agree(tmp_path):
    scene = _load(make_cornell_gltf, tmp_path, 16, 16)
    son = RenderConfig(lowdisc="sobol")
    a = render(
        scene, spp=3, seed=2, config=dataclasses.replace(son, compaction=False)
    )
    b = render(
        scene, spp=3, seed=2, config=dataclasses.replace(son, compaction=True)
    )
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)

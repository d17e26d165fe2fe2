"""Analytic oracles for the homebrew (legacy) integrators.

These go beyond smoke tests.  The compiled C++
reference CANNOT be that oracle: no homebrew scene is triangle-only (every
practice5_* scene has an infinite PLANE, which glTF cannot express), and the
course's MC material semantics (pure Lambert diffuse) differ from the final
glTF estimator's fresnel-mixed dielectric_brdf (src/raytracer.h:300-317), so
a converted scene would render differently *by design*.  Instead these tests
pin the legacy semantics against closed-form expectations:

* white-furnace identities — a single convex primitive under a uniform
  background has EXACT per-pixel values (zero Monte-Carlo variance), because
  every scattered ray escapes to the background:
    diffuse:    L = albedo            (cosine pdf cancels albedo*cos/pi)
    metallic:   L = tint
    dielectric (COLOR 1): L = 1       (Schlick split conserves energy)
    emissive (COLOR 0):   L = emission
* Whitted shading — ambient + attenuated point light + directional light on
  a plane, compared against the formula evaluated in numpy at the exact
  hit points (derived from the shared raygen math), including the shadow
  test and the 1/(c0 + c1 d + c2 d^2) attenuation.
"""

import textwrap

import numpy as np

from tpu_pathtracer.models.legacy import render_homebrew
from tpu_pathtracer.scene.homebrew import parse_homebrew_scene

# A large triangle right in front of a forward-looking camera: the central
# pixel block is guaranteed to hit it.
_MC_HEADER = """
DIMENSIONS 16 16
RAY_DEPTH 6
SAMPLES {samples}
BG_COLOR {bg}
CAMERA_POSITION 0 0 0
CAMERA_RIGHT 1 0 0
CAMERA_UP 0 1 0
CAMERA_FORWARD 0 0 -1
CAMERA_FOV_X 1.0
"""


def _scene(tmp_path, text):
    p = tmp_path / "s.txt"
    p.write_text(textwrap.dedent(text))
    return parse_homebrew_scene(str(p))


def _tri_block(extra):
    # Verts span x,y in [-8, 8] at z = -4: covers the whole 1.0-rad frustum.
    return (
        "NEW_PRIMITIVE\n"
        "TRIANGLE -8 -8 -4 8 -8 -4 0 16 -4\n" + extra
    )


def _render_center(tmp_path, body, samples=8, bg="1 1 1"):
    scene = _scene(tmp_path, _MC_HEADER.format(samples=samples, bg=bg) + body)
    img = render_homebrew(scene, seed=0)
    return img[4:12, 4:12]  # central pixels, all on the triangle


def test_mc_white_furnace_diffuse(tmp_path):
    px = _render_center(tmp_path, _tri_block("COLOR 0.25 0.5 0.75\n"))
    # Exact: every path = albedo * bg(1); zero variance even at 8 spp.
    np.testing.assert_allclose(px, np.broadcast_to([0.25, 0.5, 0.75], px.shape), rtol=0, atol=1e-5)


def test_mc_white_furnace_metallic(tmp_path):
    px = _render_center(
        tmp_path, _tri_block("COLOR 0.6 0.3 0.9\nMETALLIC\n"), samples=2
    )
    np.testing.assert_allclose(px, np.broadcast_to([0.6, 0.3, 0.9], px.shape), rtol=0, atol=1e-5)


def test_mc_energy_conservation_dielectric(tmp_path):
    # COLOR 1: reflected and refracted branches both escape to bg 1, so the
    # Schlick Russian roulette must return exactly 1 whatever the draws.
    px = _render_center(
        tmp_path, _tri_block("COLOR 1 1 1\nDIELECTRIC\nIOR 1.5\n"), samples=4
    )
    np.testing.assert_allclose(px, 1.0, rtol=0, atol=1e-5)


def test_mc_emission_exact(tmp_path):
    px = _render_center(
        tmp_path,
        _tri_block("COLOR 0 0 0\nEMISSION 2 0.5 0.125\n"),
        samples=2,
        bg="0 0 0",
    )
    np.testing.assert_allclose(px, np.broadcast_to([2.0, 0.5, 0.125], px.shape), rtol=0, atol=1e-5)


def test_whitted_plane_lights_analytic(tmp_path):
    """Ambient + point light (with attenuation) + directional light on a
    diffuse plane vs the closed-form value at the exact hit points."""
    ambient = np.array([0.05, 0.1, 0.15])
    color = np.array([0.5, 0.25, 1.0])
    lpos = np.array([0.0, 3.0, -5.0])
    lint = np.array([4.0, 3.0, 2.0])
    att = np.array([1.0, 0.5, 0.25])
    ldir = np.array([0.0, 1.0, 0.0])  # straight up: cos = 1 on the plane
    dint = np.array([0.125, 0.25, 0.5])
    scene = _scene(
        tmp_path,
        f"""
        DIMENSIONS 8 8
        RAY_DEPTH 1
        BG_COLOR 0 0 0
        AMBIENT_LIGHT {ambient[0]} {ambient[1]} {ambient[2]}
        CAMERA_POSITION 0 2 0
        CAMERA_RIGHT 1 0 0
        CAMERA_UP 0 0 -1
        CAMERA_FORWARD 0 -1 0
        CAMERA_FOV_X 0.8
        NEW_LIGHT
        LIGHT_POSITION {lpos[0]} {lpos[1]} {lpos[2]}
        LIGHT_INTENSITY {lint[0]} {lint[1]} {lint[2]}
        LIGHT_ATTENUATION {att[0]} {att[1]} {att[2]}
        NEW_LIGHT
        LIGHT_DIRECTION {ldir[0]} {ldir[1]} {ldir[2]}
        LIGHT_INTENSITY {dint[0]} {dint[1]} {dint[2]}
        NEW_PRIMITIVE
        PLANE 0 1 0
        COLOR {color[0]} {color[1]} {color[2]}
        """,
    )
    img = render_homebrew(scene, seed=0)

    # Closed form at each pixel: camera looks straight down at y=0 plane.
    w = h = 8
    tx = np.tan(0.8 / 2)
    ty = np.tan(np.arctan(tx * h / w))  # fov_y/2 tangent == tx for square
    xs, ys = np.meshgrid(np.arange(w), np.arange(h))
    cx = (2 * (xs + 0.5) / w - 1) * tx
    cy = (2 * (ys + 0.5) / h - 1) * ty
    # camera basis: right=(1,0,0), up=(0,0,-1), forward=(0,-1,0)
    dirs = (
        cx[..., None] * np.array([1.0, 0, 0])
        - cy[..., None] * np.array([0.0, 0, -1.0])
        + np.array([0.0, -1.0, 0])
    )
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    eye = np.array([0.0, 2.0, 0.0])
    t = -eye[1] / dirs[..., 1]
    hitp = eye + t[..., None] * dirs  # y == 0
    n = np.array([0.0, 1.0, 0.0])

    lvec = lpos - hitp
    dist = np.linalg.norm(lvec, axis=-1)
    lam = np.maximum(0.0, (lvec / dist[..., None]) @ n)
    atten = 1.0 / (att[0] + att[1] * dist + att[2] * dist**2)
    irr = ambient + lint * (lam * atten)[..., None] + dint * 1.0  # dir cos=1
    want = color * irr

    np.testing.assert_allclose(img, want.astype(np.float32), rtol=2e-4, atol=2e-5)


def test_whitted_shadow(tmp_path):
    """A box between the plane and the point light leaves only ambient."""
    scene = _scene(
        tmp_path,
        """
        DIMENSIONS 4 4
        RAY_DEPTH 1
        BG_COLOR 0 0 0
        AMBIENT_LIGHT 0.25 0.25 0.25
        CAMERA_POSITION 0 2 0
        CAMERA_RIGHT 1 0 0
        CAMERA_UP 0 0 -1
        CAMERA_FORWARD 0 -1 0
        CAMERA_FOV_X 0.2
        NEW_LIGHT
        LIGHT_POSITION 0 5 0
        LIGHT_INTENSITY 10 10 10
        LIGHT_ATTENUATION 1 0 0
        NEW_PRIMITIVE
        PLANE 0 1 0
        COLOR 1 1 1
        NEW_PRIMITIVE
        BOX 2 0.1 2
        POSITION 0 3.5 0
        COLOR 1 0 0
        """,
    )
    img = render_homebrew(scene, seed=0)
    # Narrow FOV from above: every ray hits the plane under the occluder.
    np.testing.assert_allclose(img, 0.25, rtol=0, atol=1e-5)

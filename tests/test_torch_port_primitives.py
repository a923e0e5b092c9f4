"""Parity of the port's scene rasterizers with momentum_tpu on the CPU:
rasterizer/primitives.py (the host tessellators, instancing, spheres,
cylinders, capsules, the skeleton and the posed character, wireframes and
2-D lines and circles), overlays.py (depth-tested lines, circles, splats),
text.py (the font, measure, 2-D and billboard text) and utils.py (buffers,
alpha_matte, triangulate, rasterize_mesh, the checkerboard, grid, frustum
and transform triads, the planar-shadow matrix, the hand camera). Inputs
come from seeded numpy and feed both packages; every mesh render names its
method on both sides.

Tolerances: the tessellators, the font, triangulation and every host-drawn
image exact (the same numpy arithmetic); mesh renders as
tests/test_torch_port_rasterizer.py holds them (face maps and masks equal
but at edge pixels and depth ties, on all but max(3, 0.1%) of the covered
pixels, colours 1e-5 where the faces agree); the dense overlays' coverage
on all but max(3, 0.1%) of the covered pixels, depth 1e-5 where both
cover and colour 1e-5 on 99% of those (depth ties between primitives);
matrices and cameras 1e-6."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from momentum_tpu import rasterizer as J
from momentum_tpu.camera import Camera, PinholeIntrinsics
from momentum_tpu_torch import rasterizer as P
from momentum_tpu_torch.bridge import camera_from_numpy

from test_torch_port_helpers import (
    camera_to_numpy, jax_fullbody_character, port_fullbody_character)
from test_torch_port_helpers import one_torch_thread  # noqa: F401
from test_torch_port_rasterizer import _assert_render

T = torch.as_tensor
W, H = 96, 64


@pytest.fixture(scope="module")
def cams():
    """A pinhole camera 12 units back along −z, looking at the origin, tilted
    a little, in both packages."""
    from momentum_tpu.math import quaternion as quat

    q = np.asarray(quat.from_axis_angle(jnp.asarray([0.3, 0.0, 0.0])), np.float32)
    state = np.concatenate([[0.5, -0.3, 12.0], q, [1.0]]).astype(np.float32)
    cj = Camera.create(PinholeIntrinsics.create(70.0, 70.0, 47.5, 31.5, image_size=(W, H)),
                       jnp.asarray(state))
    return cj, camera_from_numpy(camera_to_numpy(cj), device="cpu")


# ---- tessellators ----

@pytest.mark.parametrize("make,args", [
    ("make_sphere", (0,)), ("make_sphere", (2,)), ("make_cylinder", (3, 7)),
    ("make_cylinder", (1, 16)), ("make_capsule", (1.0, 0.5, 2.0, 9, 4)),
    ("make_checkerboard", (50.0, 6)), ("make_grid_lines", (40.0, 7.5))])
def test_tessellators_are_bit_equal(make, args):
    a = getattr(J, make)(*args)
    b = getattr(P, make)(*args)
    a, b = (a, b) if isinstance(a, tuple) else ((a,), (b,))
    for x, y in zip(a, b):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(y, x)


def test_subdivide_instance_and_transform_are_bit_equal(rng):
    from momentum_tpu.rasterizer import primitives as jp
    from momentum_tpu_torch.rasterizer import primitives as tp

    v = rng.normal(size=(5, 3))
    f = np.asarray([[0, 1, 2], [1, 3, 2], [2, 3, 4]])
    for x, y in zip(jp.subdivide_mesh(v, f, 2), tp.subdivide_mesh(v, f, 2)):
        np.testing.assert_array_equal(y, x)
    tr = rng.normal(size=(3, 4, 4))
    for x, y in zip(jp._instance(v, f, tr), tp._instance(v, f, tr)):
        np.testing.assert_array_equal(y, x)
    p0, p1 = rng.normal(size=3), rng.normal(size=3)
    np.testing.assert_array_equal(tp._x_aligned_transform(p0, p1, 0.3),
                                  jp._x_aligned_transform(p0, p1, 0.3))


def test_camera_frustum_matches_jax(cams):
    cj, ct = cams
    np.testing.assert_allclose(P.make_camera_frustum(ct, W, H, 5.0),
                               J.make_camera_frustum(cj, W, H, 5.0), atol=1e-5)


# ---- primitive renders ----

@pytest.mark.parametrize("method", ["dense", "windowed"])
def test_primitive_renders_match_jax(cams, rng, method):
    cj, ct = cams
    centers = rng.uniform(-3, 3, (4, 3))
    p0, p1 = rng.uniform(-3, 3, (5, 3)), rng.uniform(-3, 3, (5, 3))
    dirs = rng.uniform(-2, 2, (3, 3))
    radii2 = rng.uniform(0.3, 0.8, (3, 2))
    for name, args in (("rasterize_spheres", (centers, 0.8)),
                       ("rasterize_cylinders", (p0, p1, 0.3)),
                       ("rasterize_capsules", (centers[:3], dirs, radii2))):
        out_j = getattr(J, name)(cj, *args, W, H, method=method)
        out_t = getattr(P, name)(ct, *args, W, H, method=method)
        _assert_render(out_t, out_j)


def test_skeleton_and_character_renders_match_jax(rng):
    """rasterize_skeleton on JAX's states and rasterize_character (the posed
    mesh through character_state) at the body camera, method dense on both
    sides; the character with no mesh draws its skeleton. The bones' faces
    span a few pixels, where the frameworks' last-bit differences in the
    projection move the barycentrics by up to ~1e-4: that is their
    tolerance here (tests/test_raster_pallas.py's attribute tolerance)."""
    from momentum_tpu.rasterizer.utils import create_camera_for_body

    char_j, char_t = jax_fullbody_character(), port_fullbody_character()
    mp = (0.1 * rng.normal(size=char_j.num_model_parameters)).astype(np.float32)
    states = np.asarray(char_j.skeleton_states(jnp.asarray(mp)))
    cj = create_camera_for_body(char_j, states, 96, 128)
    ct = camera_from_numpy(camera_to_numpy(cj), device="cpu")
    out_j = J.rasterize_skeleton(cj, char_j.skeleton, states, 128, 96, bone_radius=2.0,
                                 method="dense")
    out_t = P.rasterize_skeleton(ct, char_t.skeleton, T(states), 128, 96, bone_radius=2.0,
                                 method="dense")
    _assert_render(out_t, out_j, tol=1e-4)
    out_j = J.rasterize_character(cj, char_j, mp, 128, 96, method="dense")
    out_t = P.rasterize_character(ct, char_t, mp, 128, 96, method="dense")
    _assert_render(out_t, out_j, tol=1e-4)
    import dataclasses

    bare_j = dataclasses.replace(char_j, mesh=None, skin_weights=None)
    bare_t = dataclasses.replace(char_t, mesh=None, skin_weights=None)
    out_j = J.rasterize_character(cj, bare_j, mp, 128, 96, method="dense")
    out_t = P.rasterize_character(ct, bare_t, mp, 128, 96, method="dense")
    _assert_render(out_t, out_j, tol=1e-4)


def test_host_drawn_primitives_are_equal(cams, rng):
    cj, ct = cams
    v, f = J.make_sphere(1)
    v = v * 3.0
    np.testing.assert_array_equal(P.rasterize_wireframe(ct, v, f, W, H),
                                  J.rasterize_wireframe(cj, v, f, W, H))
    buf = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    segs = rng.uniform(-10, 100, (6, 2, 2))
    np.testing.assert_array_equal(P.rasterize_lines_2d(T(buf), segs, (1, 0, 0)),
                                  J.rasterize_lines_2d(buf, segs, (1, 0, 0)))
    centers = rng.uniform(0, 90, (3, 2))
    np.testing.assert_array_equal(P.rasterize_circles_2d(buf, centers, [5.0, 9.0, 2.0]),
                                  J.rasterize_circles_2d(buf, centers, [5.0, 9.0, 2.0]))


# ---- overlays ----

def _assert_overlay(got, want):
    """(z, rgb) pairs: coverage equal on all but max(3, 0.1%) of the
    covered pixels (a pixel centre on a coverage boundary may go either
    way), depth where both cover, colour on 99% of those."""
    zt, ct = (x.numpy() for x in got)
    zj, cj = (np.asarray(x) for x in want)
    cov_t, cov_j = np.isfinite(zt), np.isfinite(zj)
    assert np.sum(cov_t != cov_j) <= max(3, int(1e-3 * cov_j.sum()))
    both = cov_t & cov_j
    assert both.sum() > 50
    np.testing.assert_allclose(zt[both], zj[both], rtol=1e-5, atol=1e-5)
    same = both & np.all(np.abs(ct - cj) <= 1e-5, axis=-1)
    assert np.mean(same[both]) >= 0.99  # a depth tie between primitives may go either way


def test_overlays_match_jax(cams, rng):
    cj, ct = cams
    pts = rng.uniform(-3, 3, (20, 3)).astype(np.float32)
    nrm = rng.normal(size=(20, 3)).astype(np.float32)
    z0 = np.full((H, W), 13.0, np.float32)  # a far wall to z-test against
    rgb0 = np.full((H, W, 3), 0.25, np.float32)
    got = P.rasterize_lines(ct, pts, W, H, color=(1, 0, 0), thickness=2.0, z_buffer=z0,
                            rgb_buffer=rgb0, chunk=4)
    want = J.rasterize_lines(cj, pts, W, H, color=(1, 0, 0), thickness=2.0, z_buffer=z0,
                             rgb_buffer=rgb0, chunk=4)
    _assert_overlay(got, want)
    kw = dict(radius=0.5, line_color=(0, 1, 0), fill_color=(0, 0, 1), line_thickness=2.0,
              chunk=7)
    _assert_overlay(P.rasterize_circles(ct, pts, W, H, **kw),
                    J.rasterize_circles(cj, pts, W, H, **kw))
    kw = dict(radius=0.6, chunk=6)
    _assert_overlay(P.rasterize_splats(ct, pts, nrm, W, H, **kw),
                    J.rasterize_splats(cj, pts, nrm, W, H, **kw))
    with pytest.raises(ValueError, match="line_color"):
        P.rasterize_circles(ct, pts, W, H)


# ---- text ----

def test_font_and_text_match_jax(cams, rng):
    from momentum_tpu.rasterizer import text as jt
    from momentum_tpu_torch.rasterizer import text as tt

    assert tt._FONT == jt._FONT
    assert (tt._GLYPH_W, tt._GLYPH_H, tt._SPACING) == (jt._GLYPH_W, jt._GLYPH_H, jt._SPACING)
    assert P.measure_text("Frame 12", 3) == J.measure_text("Frame 12", 3)
    buf = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    for args in (("Hi, 0-9 ~", 3, 4), ("X", -2, 60, (0, 1, 0), 2)):
        np.testing.assert_array_equal(P.rasterize_text_2d(T(buf), *args),
                                      J.rasterize_text_2d(buf, *args))
    cj, ct = cams
    for pos in ([0.5, 0.2, 0.0], [0.0, 0.0, -20.0]):  # in view; behind the camera
        np.testing.assert_array_equal(P.rasterize_text(buf, ct, "F7", pos, scale=2),
                                      J.rasterize_text(buf, cj, "F7", pos, scale=2))


# ---- utils ----

def test_buffers_matte_and_triangulate(rng):
    from momentum_tpu.rasterizer import utils as ju
    from momentum_tpu_torch.rasterizer import utils as tu

    for name in ("create_z_buffer", "create_rgb_buffer", "create_index_buffer"):
        a, b = getattr(ju, name)(7, 5), getattr(tu, name)(7, 5, device="cpu")
        assert b.dtype == {"create_index_buffer": torch.int32}.get(name, torch.float32)
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    z = rng.uniform(1, 2, (5, 7)).astype(np.float32)
    z[rng.uniform(size=z.shape) < 0.4] = np.inf
    rgb, tgt = rng.uniform(size=(2, 5, 7, 3)).astype(np.float32)
    np.testing.assert_allclose(tu.alpha_matte(T(z), T(rgb), T(tgt), 0.3).numpy(),
                               np.asarray(ju.alpha_matte(z, rgb, tgt, 0.3)), atol=1e-7)
    idx, off = [0, 1, 2, 3, 4, 5, 6, 1, 2, 3], [0, 4, 7, 10]
    np.testing.assert_array_equal(tu.triangulate(idx, off), ju.triangulate(idx, off))
    with pytest.raises(ValueError):
        tu.triangulate([0, 1], [0, 2])


def test_scene_rasterizers_match_jax(cams, rng):
    from momentum_tpu.rasterizer import utils as ju
    from momentum_tpu_torch.rasterizer import utils as tu

    cj, ct = cams
    v, f = J.make_sphere(1)
    v = v * 2.0
    z0 = np.full((H, W), 11.0, np.float32)
    rgb0 = np.full((H, W, 3), 0.5, np.float32)
    for zb, rb in ((None, None), (z0, rgb0)):
        got = tu.rasterize_mesh(ct, v, f, W, H, z_buffer=zb, rgb_buffer=rb, method="dense")
        want = ju.rasterize_mesh(cj, v, f, W, H, z_buffer=zb, rgb_buffer=rb, method="dense")
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-5)
    # the floor seen from above it: y up, the camera 6 units over the plane
    from momentum_tpu.math import quaternion as quat

    q = np.asarray(quat.from_axis_angle(jnp.asarray([-0.9, 0.0, 0.0])), np.float32)
    state = np.concatenate([[0.0, 3.0, 12.0], q, [1.0]]).astype(np.float32)
    fj = Camera.create(cj.intrinsics, jnp.asarray(state))
    ft = camera_from_numpy(camera_to_numpy(fj), device="cpu")
    got = tu.rasterize_checkerboard(ft, W, H, half_extent=20.0, squares=6, z_buffer=z0,
                                    rgb_buffer=rgb0, colors=((1, 0, 0), (0, 0, 1)))
    want = ju.rasterize_checkerboard(fj, W, H, half_extent=20.0, squares=6, z_buffer=z0,
                                     rgb_buffer=rgb0, colors=((1, 0, 0), (0, 0, 1)))
    assert np.isfinite(np.asarray(want[0])).mean() > 0.3
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-5, atol=1e-5)
    assert np.mean(got[1].numpy() == np.asarray(want[1])) > 0.999  # square edges may flip
    # a camera 5 units in front of the tilted one, looking the same way
    sj = Camera.create(cj.intrinsics, jnp.asarray([0, 0, -5.0, 0, 0, 0, 1, 1]))
    sh = camera_from_numpy(camera_to_numpy(sj), device="cpu")
    for name, args in (("rasterize_grid", (ft, W, H, 20.0, 5.0)),
                       ("rasterize_camera_frustum", (ct, sh, W, H, 3.0)),
                       ("rasterize_transforms", (ft, rng.normal(size=(3, 4, 4)), W, H, 2.0))):
        jargs = tuple({id(ft): fj, id(ct): cj, id(sh): sj}.get(id(a), a) for a in args)
        got, want = getattr(tu, name)(*args), getattr(ju, name)(*jargs)
        fin = np.isfinite(np.asarray(want[0]))
        assert fin.any(), name
        assert np.mean(np.isfinite(got[0].numpy()) == fin) > 0.995, name
    st = np.concatenate([rng.normal(size=(3, 3)), np.tile([0, 0, 0, 1.0], (3, 1)),
                         np.ones((3, 1))], 1).astype(np.float32)
    got = tu.rasterize_transforms(ft, st, W, H, 3.0)
    want = ju.rasterize_transforms(fj, st, W, H, 3.0)
    assert np.mean(np.isfinite(got[0].numpy()) == np.isfinite(np.asarray(want[0]))) > 0.995


def test_shadow_matrix_and_hand_camera_match_jax():
    from momentum_tpu.rasterizer import utils as ju
    from momentum_tpu_torch.rasterizer import utils as tu

    for args in (((0.3, -1.0, 0.2),), ((1.0, -2.0, 0.5), (0.0, 1.0, 0.0), 3.0)):
        np.testing.assert_allclose(
            tu.create_shadow_projection_matrix(*args, device="cpu").numpy(),
            np.asarray(ju.create_shadow_projection_matrix(*args)), atol=1e-6)
    with pytest.raises(ValueError, match="parallel"):
        tu.create_shadow_projection_matrix((1.0, 0.0, 0.0), device="cpu")
    wrist = np.eye(4)
    wrist[:3, 3] = [120.0, 900.0, -40.0]
    a = camera_to_numpy(ju.create_camera_for_hand(wrist, 480, 640))
    b = camera_to_numpy(tu.create_camera_for_hand(wrist, 480, 640, device="cpu"))
    for k in a:
        np.testing.assert_allclose(b[k], a[k], rtol=1e-6, atol=1e-5, err_msg=k)

"""Parity of the port's rasterizer core (momentum_tpu_torch/rasterizer/
render.py) with momentum_tpu on the CPU: the dense and windowed
z-buffers, the method dispatch and `_auto_window`, Lambert and Phong
shading, attribute interpolation, texture sampling, the textured render,
render_mesh's dense and windowed branches and the shadowed render on them,
and the parameter lists of the three render entry points (ROADMAP F22).
Inputs come from seeded numpy and feed both packages; every call names its
method on both sides.

Tolerances: the port evaluates JAX's formulas in JAX's order, but XLA may
contract a product and a sum into one rounding (an FMA), so a pixel centre
on an edge (a barycentric within 1e-5 of 0) or at a depth tie within 1e-5
may go either way: face maps and masks agree everywhere else, and a mesh
render's on all but max(3, 0.1%) of its covered pixels (random scenes,
whose faces share edges at equal depths, tie far more often). Where the faces agree, depth,
barycentrics and colours agree to 1e-5 abs, depth 1e-5 relative above 1
(tests/test_rasterizer_windowed.py's depth tolerance); shading to 1e-6 on
the same normals; interpolated and sampled attributes to 1e-5."""

import inspect

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from momentum_tpu.rasterizer import render as jr
from momentum_tpu_torch.bridge import camera_from_numpy
from momentum_tpu_torch.rasterizer import render as tr

from test_torch_port_helpers import camera_to_numpy, jax_fullbody_character
from test_torch_port_helpers import one_torch_thread  # noqa: F401

T = torch.as_tensor


def _random_scene(seed, V=60, F=90, W=96, H=64, zlo=0.5):
    rng = np.random.default_rng(seed)
    verts = np.zeros((V, 3), np.float32)
    verts[:, 0] = rng.uniform(-10, W + 10, V)
    verts[:, 1] = rng.uniform(-10, H + 10, V)
    verts[:, 2] = rng.uniform(zlo, 5.0, V)
    faces = rng.integers(0, V, (F, 3)).astype(np.int32)
    return verts, faces, W, H


def _small_tris(seed, n=120, W=96, H=64, size=6.0):
    """n random triangles of at most `size` pixels, a few overlapping."""
    rng = np.random.default_rng(seed)
    c = rng.uniform([0, 0], [W, H], (n, 2))
    off = rng.uniform(-size / 2, size / 2, (n, 3, 2))
    xy = c[:, None] + off
    z = rng.uniform(1.0, 4.0, (n, 1, 1)) + rng.uniform(0, 0.3, (n, 3, 1))
    verts = np.concatenate([xy, z], -1).reshape(-1, 3).astype(np.float32)
    return verts, np.arange(3 * n, dtype=np.int32).reshape(n, 3), W, H


def _assert_buffers(out_t, out_j, tol=1e-5):
    """Face maps equal but at edge pixels and depth ties (module docstring);
    depth and barycentrics where they agree; inf and 0 where empty."""
    ft, fj = out_t["face"].numpy(), np.asarray(out_j["face"])
    dt, dj = out_t["depth"].numpy(), np.asarray(out_j["depth"])
    bt, bj = out_t["bary"].numpy(), np.asarray(out_j["bary"])
    assert ft.dtype == np.int32 and ft.shape == fj.shape
    diff = ft != fj
    edge = (np.abs(bt).min(-1) <= 1e-5) | (np.abs(bj).min(-1) <= 1e-5)
    tie = np.abs(dt - dj) <= tol * np.maximum(1.0, np.abs(dj))
    assert np.all(edge[diff] | tie[diff]), np.argwhere(diff & ~edge & ~tie)[:5]
    same = ~diff & (fj >= 0)
    np.testing.assert_allclose(dt[same], dj[same], rtol=tol, atol=tol)
    np.testing.assert_allclose(bt[same], bj[same], rtol=0, atol=tol)
    assert np.all(np.isinf(dt[ft < 0])) and np.all(bt[ft < 0] == 0.0)


# ---- dense and windowed z-buffers ----

@pytest.mark.parametrize("seed,chunk", [(0, 64), (1, 16), (2, 7)])
def test_dense_rasterize_matches_jax(seed, chunk):
    verts, faces, w, h = _random_scene(seed)
    verts[3] = [1e8, 5.0, 2.0]  # dense draws faces past planes' 1e7 limit (F2)
    faces[4] = [7, 7, 8]  # degenerate: area 0
    out_j = jr.rasterize(jnp.asarray(verts), jnp.asarray(faces), w, h, chunk)
    out_t = tr.rasterize(T(verts), T(faces), w, h, chunk)
    _assert_buffers(out_t, out_j)
    face = out_t["face"].numpy()
    assert (face >= 0).mean() > 0.3 and not (face == 4).any()


@pytest.mark.parametrize("window,big_capacity", [(16, 64), (8, 4), (32, 0), (200, 16)])
def test_windowed_rasterize_matches_jax(window, big_capacity):
    """Small faces, large ones (routed to the dense pass; with capacity 4
    some are left out, as in JAX) and a window wider than the image."""
    sv, sf, w, h = _small_tris(3)
    bv, bf, _, _ = _random_scene(4, V=12, F=10, zlo=3.0)
    verts = np.concatenate([sv, bv])
    faces = np.concatenate([sf, bf + sv.shape[0]])
    out_j = jr.rasterize_windowed(jnp.asarray(verts), jnp.asarray(faces), w, h, window,
                                  big_capacity)
    out_t = tr.rasterize_windowed(T(verts), T(faces), w, h, window, big_capacity)
    _assert_buffers(out_t, out_j)
    assert (out_t["face"].numpy() >= 0).mean() > (0.2 if big_capacity else 0.03)


def test_windowed_big_faces_tie_by_lower_index():
    """More big faces than big_capacity with equal extents: lax.top_k keeps
    the lowest indices, and so does the port's stable sort."""
    w, h = 64, 48
    quads = []
    for i in range(6):  # six identical-extent triangles at depths 6, 5, ..., 1
        quads.append([[-5, -5, 6.0 - i], [w + 5, -5, 6.0 - i], [-5, h + 5, 6.0 - i]])
    verts = np.asarray(quads, np.float32).reshape(-1, 3)
    faces = np.arange(18, dtype=np.int32).reshape(6, 3)
    out_j = jr.rasterize_windowed(jnp.asarray(verts), jnp.asarray(faces), w, h, 8, 3)
    out_t = tr.rasterize_windowed(T(verts), T(faces), w, h, 8, 3)
    _assert_buffers(out_t, out_j)
    assert set(np.unique(out_t["face"].numpy())) == {-1, 2}


def test_windowed_nonfinite_and_behind_camera():
    verts, faces, w, h = _random_scene(5)
    verts[:10, 2] = -1.0
    verts[11] = [np.nan, 3.0, 2.0]
    verts[12] = [np.inf, -np.inf, 2.0]
    out_j = jr.rasterize_windowed(jnp.asarray(verts), jnp.asarray(faces), w, h, 16, 8)
    out_t = tr.rasterize_windowed(T(verts), T(faces), w, h, 16, 8)
    _assert_buffers(out_t, out_j)
    assert np.isfinite(out_t["bary"].numpy()).all()


@pytest.mark.parametrize("f_count,w,h", [(612, 1280, 960), (1, 64, 48), (20000, 640, 480),
                                         (80, 96, 64), (5000, 32, 32)])
def test_auto_window_matches_jax(f_count, w, h):
    assert tr._auto_window(f_count, w, h) == jr._auto_window(f_count, w, h)


@pytest.mark.parametrize("method", ["dense", "windowed", "window", "planes", "auto"])
def test_rasterize_dispatch(method):
    """Each method against JAX's same method; the port's "auto" is planes
    on every device (JAX's CPU "auto" would be windowed here)."""
    verts, faces, w, h = _random_scene(6)
    jax_method = "planes" if method == "auto" else method
    out_j = jr._rasterize_dispatch(jnp.asarray(verts), jnp.asarray(faces), w, h, 32,
                                   jax_method)
    out_t = tr._rasterize_dispatch(T(verts), T(faces), w, h, 32, method)
    if jax_method == "planes":  # the planes tolerance: ties within 1e-5 may differ
        same = out_t["face"].numpy() == np.asarray(out_j["face"])
        assert same.mean() > 0.999
        np.testing.assert_array_equal(out_t["face"].numpy() >= 0, np.asarray(out_j["face"]) >= 0)
    else:
        _assert_buffers(out_t, out_j)


# ---- shading, interpolation, textures ----

def test_shading_matches_jax(rng):
    n = rng.normal(size=(50, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    light = np.asarray([0.3, -0.7, 0.6], np.float32)
    view = np.asarray([0.1, 0.2, -1.0], np.float32)
    np.testing.assert_allclose(tr.shade_lambert(T(n), T(light)).numpy(),
                               np.asarray(jr.shade_lambert(n, light)), atol=1e-6)
    np.testing.assert_allclose(
        tr.shade_phong(T(n), T(view), T(light), albedo=(0.2, 0.5, 0.9), specular=0.4,
                       shininess=8.0).numpy(),
        np.asarray(jr.shade_phong(n, view, light, albedo=(0.2, 0.5, 0.9), specular=0.4,
                                  shininess=8.0)), atol=1e-6)


def test_interpolate_attribute_and_sample_texture_match_jax(rng):
    verts, faces, w, h = _random_scene(7)
    buf_j = jr.rasterize(jnp.asarray(verts), jnp.asarray(faces), w, h)
    buf_t = {k: T(np.asarray(v)) for k, v in buf_j.items()}
    attr = rng.normal(size=(verts.shape[0], 4)).astype(np.float32)
    got = tr.interpolate_attribute(buf_t, T(faces), T(attr)).numpy()
    np.testing.assert_allclose(got, np.asarray(jr.interpolate_attribute(buf_j, faces, attr)),
                               atol=1e-5)
    tex = rng.uniform(0, 1, (9, 13, 3)).astype(np.float32)
    uv = rng.uniform(-0.2, 1.2, (40, 30, 2)).astype(np.float32)  # clamped outside [0, 1]
    np.testing.assert_allclose(tr.sample_texture(T(tex), T(uv)).numpy(),
                               np.asarray(jr.sample_texture(tex, uv)), atol=1e-5)


# ---- renders of the full-body mesh ----

@pytest.fixture(scope="module")
def scene():
    """Frame 0 of a random walk of the full-body fixture, skinned by JAX,
    and JAX's body camera at 128 × 96 carried into the port."""
    import jax

    from momentum_tpu.character.skinning import skin_points
    from momentum_tpu.rasterizer.utils import create_camera_for_body

    char = jax_fullbody_character()
    rng = np.random.default_rng(0)
    motion = np.cumsum(0.02 * rng.normal(size=(2, char.num_model_parameters)),
                       axis=0).astype(np.float32)
    states = np.asarray(jax.vmap(char.skeleton_states)(jnp.asarray(motion)))
    cam_j = create_camera_for_body(char, states, 96, 128)
    verts = np.asarray(skin_points(char.skin_weights, states[0], char.inverse_bind_pose,
                                   char.mesh.vertices))
    return dict(cam_j=cam_j, cam_t=camera_from_numpy(camera_to_numpy(cam_j), device="cpu"),
                verts=verts, faces=np.asarray(char.mesh.faces), w=128, h=96)


def _assert_render(out_t, out_j, keys=("color",), tol=1e-5):
    _assert_buffers(out_t, out_j, tol)
    diff = out_t["face"].numpy() != np.asarray(out_j["face"])
    assert diff.sum() <= max(3, int(1e-3 * (np.asarray(out_j["face"]) >= 0).sum()))
    np.testing.assert_array_equal(out_t["mask"].numpy(), out_t["face"].numpy() >= 0)
    assert out_t["mask"].numpy().sum() > 100
    same = out_t["face"].numpy() == np.asarray(out_j["face"])
    for k in keys:
        np.testing.assert_allclose(out_t[k].numpy()[same], np.asarray(out_j[k])[same], rtol=0,
                                   atol=tol, err_msg=k)


@pytest.mark.parametrize("method", ["dense", "windowed"])
def test_render_mesh_dense_and_windowed_match_jax(scene, method, rng):
    """render_mesh's non-planes branch (per-pixel face normal → Lambert, the
    extra attributes by interpolate_attribute) against JAX's; it replaces
    the test that pinned the raise these methods gave before they were
    ported."""
    s = scene
    extra = rng.normal(size=(s["verts"].shape[0], 2)).astype(np.float32)
    out_j = jr.render_mesh(s["cam_j"], jnp.asarray(s["verts"]), jnp.asarray(s["faces"]),
                           s["w"], s["h"], method=method, extra_vertex_attrs=jnp.asarray(extra))
    out_t = tr.render_mesh(s["cam_t"], T(s["verts"]), T(s["faces"]), s["w"], s["h"],
                           method=method, extra_vertex_attrs=T(extra))
    _assert_render(out_t, out_j, ("color", "extra"))


@pytest.mark.parametrize("method", ["dense", "windowed", "planes"])
def test_render_mesh_textured_matches_jax(scene, method, rng):
    s = scene
    uv = rng.uniform(0, 1, (s["verts"].shape[0], 2)).astype(np.float32)
    tex = rng.uniform(0, 1, (16, 16, 3)).astype(np.float32)
    args = (s["w"], s["h"])
    out_j = jr.render_mesh_textured(s["cam_j"], jnp.asarray(s["verts"]),
                                    jnp.asarray(s["faces"]), jnp.asarray(uv),
                                    jnp.asarray(tex), *args, method=method)
    out_t = tr.render_mesh_textured(s["cam_t"], T(s["verts"]), T(s["faces"]), T(uv), T(tex),
                                    *args, method=method)
    if method == "planes":  # JAX's Pallas kernel in interpret mode: test_torch_port_render's rule
        same = (out_t["face"].numpy() == np.asarray(out_j["face"])) & out_t["mask"].numpy()
        assert np.sum(out_t["mask"].numpy() != np.asarray(out_j["mask"])) <= 3
        np.testing.assert_allclose(out_t["color"].numpy()[same],
                                   np.asarray(out_j["color"])[same], atol=1e-4)
    else:
        _assert_render(out_t, out_j)


@pytest.mark.parametrize("method", ["dense", "windowed"])
def test_render_mesh_shadowed_non_planes_matches_jax(scene, method):
    s = scene
    kw = dict(shadow_resolution=48, method=method)
    out_j = jr.render_mesh_shadowed(s["cam_j"], jnp.asarray(s["verts"]),
                                    jnp.asarray(s["faces"]), s["w"], s["h"], **kw)
    out_t = tr.render_mesh_shadowed(s["cam_t"], T(s["verts"]), T(s["faces"]), s["w"],
                                    s["h"], **kw)
    _assert_buffers(out_t, out_j)
    mj = np.asarray(out_j["mask"])
    lit_same = out_t["shadow"].numpy() == np.asarray(out_j["shadow"])
    assert lit_same[mj].mean() >= 0.99  # a world point on a texel edge may flip
    np.testing.assert_allclose(out_t["color"].numpy()[lit_same],
                               np.asarray(out_j["color"])[lit_same], atol=1e-5)
    sd_j, _ = jr.render_shadow_map(jnp.asarray(s["verts"]), jnp.asarray(s["faces"]),
                                   jnp.asarray(tr.LIGHT_DIR), 48, 64, method)
    sd_t, _ = tr.render_shadow_map(T(s["verts"]), T(s["faces"]), tr.LIGHT_DIR, 48, 64, method)
    fin = np.isfinite(np.asarray(sd_j))
    np.testing.assert_array_equal(np.isfinite(sd_t.numpy()), fin)
    np.testing.assert_allclose(sd_t.numpy()[fin], np.asarray(sd_j)[fin], rtol=1e-5, atol=1e-5)


# ---- F22: the render entry points take JAX's parameters in JAX's order ----

@pytest.mark.parametrize("name", ["render_mesh", "render_shadow_map", "render_mesh_shadowed"])
def test_render_signatures_are_jax(name, scene):
    """Each parameter of JAX's function, by name, position and default, and
    a call that passes every argument positionally (so `chunk` and `method`
    land where JAX puts them) against the same call by keyword."""
    sj = inspect.signature(getattr(jr, name))
    st = inspect.signature(getattr(tr, name))
    assert list(st.parameters) == list(sj.parameters)
    for p in sj.parameters.values():
        want = p.default
        got = st.parameters[p.name].default
        assert (tuple(got) if isinstance(got, (tuple, list)) else got) == \
            (tuple(want) if isinstance(want, (tuple, list)) else want), p.name
    s = scene
    verts, faces = T(s["verts"]), T(s["faces"])
    values = dict(camera=s["cam_t"], vertices=verts, faces=faces, width=s["w"],
                  height=s["h"], vertex_normals=None, light_dir=tr.LIGHT_DIR, chunk=1000,
                  method="dense", extra_vertex_attrs=None, resolution=32,
                  shadow_resolution=32, shadow_bias=5e-2)
    args = [values[n] for n in st.parameters]
    by_pos = getattr(tr, name)(*args)
    by_kw = getattr(tr, name)(**{n: values[n] for n in st.parameters})
    a, b = (by_pos[0], by_kw[0]) if name == "render_shadow_map" else (by_pos["depth"],
                                                                     by_kw["depth"])
    assert torch.equal(a, b)

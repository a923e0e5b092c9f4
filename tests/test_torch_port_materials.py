"""Parity of the port's Phong materials (momentum_tpu_torch/rasterizer/
materials.py) with momentum_tpu on the CPU: the material and light
constructors and the bridge's builders, multi-light Phong shading, the
box-filter resolve, and render_mesh_phong on the full-body mesh through
the dense, windowed and planes rasterizers (JAX's planes in interpret
mode), with culling, offsets, per-vertex colours, textures and 2×
supersampling. Inputs come from seeded numpy and feed both packages.

Tolerances: constructors exact; shading 1e-5 abs (tests/
test_rasterizer_materials.py's colour tolerance) on the same inputs;
downsample 1e-6 and +inf exactly where JAX's is. The renders follow
tests/test_torch_port_rasterizer.py's rule: face maps and masks equal but
at edge pixels and depth ties, on all but max(3, 0.1%) of the covered
pixels, and colours, normals, depth and barycentrics to 1e-5 where the
faces agree (1e-4 on the planes path, tests/test_raster_pallas.py's
attribute tolerance); with supersampling (no full-resolution face map comes back),
colour, alpha, normal and depth to 1e-5 on all but max(3, 0.1%) of the
covered pixels."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from momentum_tpu.rasterizer import materials as jm
from momentum_tpu_torch import bridge
from momentum_tpu_torch.rasterizer import materials as tm

from test_torch_port_rasterizer import scene  # noqa: F401  (module fixture)
from test_torch_port_helpers import one_torch_thread  # noqa: F401

T = torch.as_tensor


def material_to_numpy(m) -> dict:
    d = {k: np.asarray(getattr(m, k)) for k in (
        "diffuse_color", "specular_color", "specular_exponent", "emissive_color")}
    for k in ("diffuse_texture", "emissive_texture"):
        if getattr(m, k) is not None:
            d[k] = np.asarray(getattr(m, k))
    return d


def lights_to_numpy(lights) -> list:
    return [dict(position=np.asarray(li.position), color=np.asarray(li.color), type=li.type)
            for li in lights]


def _pair(rng, textures=False, **kw):
    """One JAX material and its port copy through the bridge."""
    tex = {}
    if textures:
        tex = dict(diffuse_texture=rng.uniform(0, 1, (8, 8, 3)).astype(np.float32),
                   emissive_texture=0.2 * rng.uniform(0, 1, (4, 4, 3)).astype(np.float32))
    mj = jm.PhongMaterial.create(**kw, **tex)
    return mj, bridge.phong_material_from_numpy(material_to_numpy(mj), device="cpu")


def test_constructors_match_jax():
    mj = jm.PhongMaterial.create((0.2, 0.3, 0.4), (0.5, 0.5, 0.5), 7.0, (0.1, 0.0, 0.0),
                                 diffuse_texture=np.ones((2, 2, 3)))
    mt = tm.PhongMaterial.create((0.2, 0.3, 0.4), (0.5, 0.5, 0.5), 7.0, (0.1, 0.0, 0.0),
                                 diffuse_texture=np.ones((2, 2, 3)), device="cpu")
    dj, dt = material_to_numpy(mj), material_to_numpy(mt)
    assert dj.keys() == dt.keys()
    for k in dj:
        assert dt[k].dtype == np.float32
        np.testing.assert_array_equal(dt[k], dj[k], err_msg=k)
    pairs = [(jm.point_light((1, 2, 3), (0.5, 0.5, 0.5)),
              tm.point_light((1, 2, 3), (0.5, 0.5, 0.5), device="cpu")),
             (jm.directional_light((0, -1, 0)), tm.directional_light((0, -1, 0), device="cpu")),
             (jm.ambient_light(), tm.ambient_light(device="cpu")),
             *zip(jm.default_lights(jnp.asarray([0.0, 1.0, 2.0])),
                  tm.default_lights(T([0.0, 1.0, 2.0])))]
    for lj, lt in pairs:
        assert lt.type == lj.type and isinstance(lt.type, int)
        np.testing.assert_array_equal(lt.position.numpy(), np.asarray(lj.position))
        np.testing.assert_array_equal(lt.color.numpy(), np.asarray(lj.color))
    back = bridge.lights_from_numpy(lights_to_numpy([p[0] for p in pairs]), device="cpu")
    assert [li.type for li in back] == [p[0].type for p in pairs]


def test_shade_phong_lights_matches_jax(rng):
    n = 64
    pos = rng.normal(size=(n, 3)).astype(np.float32)
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    view = np.asarray([0.5, 1.0, 5.0], np.float32)
    lights_j = (jm.point_light((2.0, 3.0, 4.0), (0.9, 0.8, 0.7)),
                jm.directional_light((0.3, -1.0, 0.2), (0.4, 0.4, 0.5)),
                jm.ambient_light((0.1, 0.2, 0.1)))
    lights_t = bridge.lights_from_numpy(lights_to_numpy(lights_j), device="cpu")
    mj, mt = _pair(rng, diffuse_color=(0.7, 0.5, 0.3), specular_color=(0.4, 0.4, 0.4),
                   specular_exponent=12.0, emissive_color=(0.05, 0.0, 0.02))
    albedo = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    emissive = 0.1 * rng.uniform(0, 1, (n, 3)).astype(np.float32)
    for kw in ({}, dict(diffuse_albedo=albedo), dict(emissive=emissive)):
        want = jm.shade_phong_lights(pos, nrm, view, mj, lights_j,
                                     **{k: jnp.asarray(v) for k, v in kw.items()})
        got = tm.shade_phong_lights(T(pos), T(nrm), T(view), mt, lights_t,
                                    **{k: T(v) for k, v in kw.items()})
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_downsample_matches_jax(rng):
    img = rng.normal(size=(12, 18, 3)).astype(np.float32)
    depth = rng.uniform(1, 5, (13, 18)).astype(np.float32)  # 13 rows: the last is dropped
    depth[rng.uniform(size=depth.shape) < 0.3] = np.inf
    for a, k in ((img, 1), (img, 2), (img, 3), (depth, 2)):
        np.testing.assert_allclose(tm.downsample(T(a), k).numpy(),
                                   np.asarray(jm.downsample(jnp.asarray(a), k)), atol=1e-6)
    got = -tm.downsample(-T(depth), 2).numpy()
    want = -np.asarray(jm.downsample(-jnp.asarray(depth), 2))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    assert np.isinf(got).any() and np.isfinite(got).any()


def _assert_phong(out_t, out_j, supersample, tol=1e-5):
    from test_torch_port_rasterizer import _assert_buffers

    cov = np.asarray(out_j["mask"]).sum()
    assert cov > 40
    allowed = max(3, int(1e-3 * cov))
    if supersample == 1:
        _assert_buffers(out_t, out_j, tol)
        same = out_t["face"].numpy() == np.asarray(out_j["face"])
        assert (~same).sum() <= allowed
        for k in ("color", "normal", "alpha"):
            np.testing.assert_allclose(out_t[k].numpy()[same], np.asarray(out_j[k])[same],
                                       atol=tol, err_msg=k)
        return
    assert np.sum(out_t["mask"].numpy() != np.asarray(out_j["mask"])) <= allowed
    for k in ("color", "alpha", "normal", "depth"):
        a, b = out_t[k].numpy(), np.asarray(out_j[k])
        fin = np.isfinite(b)
        bad = (np.isfinite(a) != fin) | (fin & (np.abs(a - b) > tol * np.maximum(1.0, np.abs(b))))
        if bad.ndim == 3:
            bad = bad.any(-1)
        assert bad.sum() <= allowed, (k, bad.sum())


@pytest.mark.parametrize("method,supersample", [("dense", 1), ("windowed", 1), ("planes", 1),
                                                ("dense", 2), ("planes", 2)])
def test_render_mesh_phong_matches_jax(scene, rng, method, supersample):  # noqa: F811
    s = scene
    mj, mt = _pair(rng, specular_color=(0.3, 0.3, 0.3), specular_exponent=16.0)
    kw = dict(supersample=supersample, method=method)
    out_j = jm.render_mesh_phong(s["cam_j"], jnp.asarray(s["verts"]), jnp.asarray(s["faces"]),
                                 s["w"], s["h"], material=mj, **kw)
    out_t = tm.render_mesh_phong(s["cam_t"], T(s["verts"]), T(s["faces"]), s["w"], s["h"],
                                 material=mt, **kw)
    assert out_t["color"].shape == (s["h"], s["w"], 3)
    assert out_t["face"].shape == (s["h"], s["w"])
    # the planes barycentrics are plane rows a·x + b·y + c evaluated at the
    # pixel, whose rounding differs between the frameworks by up to ~6e-5:
    # tests/test_raster_pallas.py's 1e-4 attribute tolerance
    _assert_phong(out_t, out_j, supersample, 1e-4 if method == "planes" else 1e-5)


@pytest.mark.parametrize("option", ["no_culling", "offsets", "vertex_colors", "textures",
                                    "lights"])
def test_render_mesh_phong_options_match_jax(scene, rng, option):  # noqa: F811
    s = scene
    v = s["verts"].shape[0]
    mj, mt = _pair(rng, textures=option == "textures")
    kj, kt = {}, {}
    if option == "no_culling":
        kj = kt = dict(backface_culling=False)
    elif option == "offsets":
        kj = kt = dict(depth_offset=0.5, image_offset=(3.0, -2.0))
    elif option == "vertex_colors":
        vc = rng.uniform(0, 1, (v, 3)).astype(np.float32)
        kj, kt = dict(vertex_colors=jnp.asarray(vc)), dict(vertex_colors=T(vc))
    elif option == "textures":
        uv = rng.uniform(0, 1, (v, 2)).astype(np.float32)
        kj, kt = dict(texcoords=jnp.asarray(uv)), dict(texcoords=T(uv))
    else:
        lights = (jm.directional_light((0.2, -1.0, 0.3), (0.7, 0.7, 0.7)),
                  jm.ambient_light((0.2, 0.1, 0.1)))
        kj = dict(lights=lights)
        kt = dict(lights=bridge.lights_from_numpy(lights_to_numpy(lights), device="cpu"))
    out_j = jm.render_mesh_phong(s["cam_j"], jnp.asarray(s["verts"]), jnp.asarray(s["faces"]),
                                 s["w"], s["h"], material=mj, method="dense", **kj)
    out_t = tm.render_mesh_phong(s["cam_t"], T(s["verts"]), T(s["faces"]), s["w"], s["h"],
                                 material=mt, method="dense", **kt)
    _assert_phong(out_t, out_j, 1)


def test_culling_rewrites_back_faces_to_face_zero(scene):  # noqa: F811
    """Culled faces become (0, 0, 0), as in JAX, so they never cover a
    pixel; without culling more faces are visible."""
    s = scene
    kw = dict(method="dense")
    culled = tm.render_mesh_phong(s["cam_t"], T(s["verts"]), T(s["faces"]), s["w"], s["h"], **kw)
    full = tm.render_mesh_phong(s["cam_t"], T(s["verts"]), T(s["faces"]), s["w"], s["h"],
                                backface_culling=False, **kw)
    assert culled["mask"].sum() <= full["mask"].sum()
    assert len(torch.unique(culled["face"])) < len(torch.unique(full["face"]))

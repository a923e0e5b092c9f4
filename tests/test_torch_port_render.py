"""Parity of the port's shadowed-render path with momentum_tpu on the CPU:
the skinned mesh of the full-body fixture, skinning, the auto-framed camera,
the plane rasterizer (against the Pallas kernels K4a/K4b run in interpret
mode, the path the port mirrors; ROADMAP F2) and the shadowed render and
clip. Inputs come from seeded numpy and feed both packages.

Tolerances: the fixture arrays are built by the same numpy arithmetic and
are bit-equal; skinning agrees to 1e-6 (the same f32 formulas, summed in
another order); the camera's intrinsics exactly and its pose to 1e-5.
The rasterizer's are tests/test_raster_pallas.py's: face maps equal, or a
tie within 1e-5 in depth where they differ; barycentrics 1e-5 and
attributes 1e-4 where the faces agree. Depths are held to 1e-5 relative
above 1: the two frameworks round the depth plane's three-term sums
differently, which at depths of ~60 moves the last bits (6e-5 measured).
A render may flip a few silhouette pixels (max(3, 1%)); its colour agrees
to 1e-3 where both pick the same face."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from momentum_tpu.ops.raster_pallas import rasterize_planes as jax_rasterize_planes
from momentum_tpu_torch.bridge import camera_from_numpy
from momentum_tpu_torch.ops import raster
from momentum_tpu_torch.rasterizer import render

from test_torch_port_helpers import (
    TILE_EDGE_SCENES, camera_to_numpy, character_to_numpy, jax_fullbody_character,
    port_fullbody_character, tile_edge_scene, to_numpy)
from test_torch_port_helpers import one_torch_thread  # noqa: F401

T = torch.as_tensor


@pytest.fixture(scope="module")
def chars():
    return jax_fullbody_character(), port_fullbody_character()


def _jax_states(char_j, motion):
    return np.asarray(jax.vmap(char_j.skeleton_states)(jnp.asarray(motion)))


# ---- math, fixture, skinning, camera ----

def test_quaternion_and_skel_state_additions_match_jax(rng):
    from momentum_tpu.math import quaternion as jquat, skel_state as jss
    from momentum_tpu_torch.math import quaternion as tquat, skel_state as tss

    q = rng.normal(size=(32, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    s = np.concatenate([rng.uniform(-1, 1, (32, 3)), q, rng.uniform(0.5, 2, (32, 1))],
                       -1).astype(np.float32)
    v = rng.normal(size=(32, 3)).astype(np.float32)
    r = np.asarray(jquat.to_rotation_matrix(q))
    pairs = [
        (jquat.conjugate(q), tquat.conjugate(T(q))),
        (jquat.normalize(3 * q), tquat.normalize(T(3 * q))),
        (jquat.from_rotation_matrix(r), tquat.from_rotation_matrix(T(r))),
        (jss.inverse(s), tss.inverse(T(s))),
        (jss.to_matrix(s), tss.to_matrix(T(s))),
        (jss.from_translation(v), tss.from_translation(T(v))),
        (jss.rotate_vectors(s, v), tss.rotate_vectors(T(s), T(v))),
    ]
    for want, got in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    # blends of a cluster: the eigenvector's sign is the solver's, so compare
    # rotation matrices (quaternion) and the sign-free parts (skel_state)
    cl = q[:1] + 0.1 * rng.normal(size=(8, 4)).astype(np.float32)
    cl /= np.linalg.norm(cl, axis=-1, keepdims=True)
    w = rng.uniform(0.1, 1.0, 8).astype(np.float32)
    np.testing.assert_allclose(
        tquat.to_rotation_matrix(tquat.blend(T(cl), T(w))).numpy(),
        np.asarray(jquat.to_rotation_matrix(jquat.blend(cl, w))), atol=1e-5)
    sb_j, sb_t = np.asarray(jss.blend(s[:8], w)), tss.blend(T(s[:8]), T(w)).numpy()
    np.testing.assert_allclose(sb_t[[0, 1, 2, 7]], sb_j[[0, 1, 2, 7]], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np.abs(sb_t[3:7] @ sb_j[3:7]), 1.0, atol=1e-5)


def test_fixture_mesh_skin_and_inverse_bind_pose_are_bit_equal():
    from momentum_tpu_torch.testing.fixtures import create_fullbody_character

    j = character_to_numpy(jax_fullbody_character())
    t = character_to_numpy(create_fullbody_character(device="cpu"))
    keys = ("mesh_vertices", "mesh_faces", "skin_index", "skin_weight", "inverse_bind_pose")
    for k in keys:
        assert t[k].dtype == j[k].dtype, k
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    assert t["mesh_vertices"].shape == (612, 3) and t["mesh_faces"].shape == (612, 3)


def test_skinning_and_normals_match_jax(chars, rng):
    from momentum_tpu.character.skinning import (
        skin_points as j_skin, update_normals as j_normals)
    from momentum_tpu_torch.character.skinning import (
        skin_points as t_skin, update_normals as t_normals)

    char_j, char_t = chars
    motion = rng.uniform(-0.4, 0.4, (4, char_j.num_model_parameters)).astype(np.float32)
    states = _jax_states(char_j, motion)
    rest = np.asarray(char_j.mesh.vertices)
    ibp = np.asarray(char_j.inverse_bind_pose)
    faces = np.asarray(char_j.mesh.faces)
    for st in states:
        vj = np.asarray(j_skin(char_j.skin_weights, st, ibp, rest))
        vt = t_skin(char_t.skin_weights, T(st), T(ibp), T(rest)).numpy()
        np.testing.assert_allclose(vt, vj, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(t_normals(T(vj), T(faces)).numpy(),
                                   np.asarray(j_normals(vj, faces)), rtol=1e-6, atol=1e-6)
    # batched over the 4 poses, as the clip skins them
    vb = t_skin(char_t.skin_weights, T(states), T(ibp), T(rest)).numpy()
    np.testing.assert_allclose(vb, np.stack([np.asarray(j_skin(char_j.skin_weights, st, ibp,
                                                               rest)) for st in states]),
                               rtol=1e-6, atol=1e-6)


def test_batched_fk_equals_per_frame_fk(chars, rng):
    """The clip's one batched FK (K1 on the card) gives each frame exactly
    what FK of that frame alone gives."""
    _, char_t = chars
    motion = T(np.cumsum(0.02 * rng.normal(size=(6, char_t.num_model_parameters)),
                         axis=0).astype(np.float32))
    batched = char_t.skeleton_states(motion)
    for i in range(motion.shape[0]):
        assert torch.equal(batched[i], char_t.skeleton_states(motion[i]))


def test_camera_for_body_matches_jax(chars, rng):
    from momentum_tpu.rasterizer.utils import create_camera_for_body as j_camera
    from momentum_tpu_torch.rasterizer import create_camera_for_body as t_camera

    char_j, char_t = chars
    motion = np.cumsum(0.02 * rng.normal(size=(4, char_j.num_model_parameters)),
                       axis=0).astype(np.float32)
    states = _jax_states(char_j, motion)
    cj = camera_to_numpy(j_camera(char_j, states, 960, 1280))
    ct = camera_to_numpy(t_camera(char_t, T(states), 960, 1280))
    for k in ("fx", "fy", "cx", "cy", "image_width", "image_height"):
        assert ct[k] == cj[k], k
    np.testing.assert_allclose(ct["eye_from_world"], cj["eye_from_world"], rtol=1e-5,
                               atol=1e-5)
    # the bridge carries the JAX camera across unchanged, and both project alike
    cam = camera_from_numpy(cj, device="cpu")
    np.testing.assert_array_equal(camera_to_numpy(cam)["eye_from_world"], cj["eye_from_world"])
    p = rng.uniform(-1, 1, (64, 3)).astype(np.float32)
    uvz_j, ok_j = j_camera(char_j, states, 960, 1280).project(jnp.asarray(p))
    uvz_t, ok_t = cam.project(T(p))
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    np.testing.assert_allclose(uvz_t.numpy(), np.asarray(uvz_j), rtol=1e-5, atol=1e-3)


# ---- the plane rasterizer, tests/test_raster_pallas.py's cases ----

def _random_scene(seed, V=40, F=24, W=128, H=8):
    rng = np.random.default_rng(seed)
    verts = np.zeros((V, 3), np.float32)
    verts[:, 0] = rng.uniform(-10, W + 10, V)
    verts[:, 1] = rng.uniform(-5, H + 5, V)
    verts[:, 2] = rng.uniform(0.5, 5.0, V)
    faces = rng.integers(0, V, (F, 3)).astype(np.int32)
    return verts, faces, W, H


def _nonfinite_scene():
    rng = np.random.default_rng(7)
    v = rng.uniform(4, 60, (300, 3)).astype(np.float32)
    faces = rng.integers(0, 300, (200, 3)).astype(np.int32)
    v[5] = [np.inf, np.inf, 3.0]
    v[17] = [np.nan, 1e4, 2.0]
    v[42] = [1e12, -1e12, 5.0]
    attrs = rng.normal(0, 1, (300, 3)).astype(np.float32)
    return v, faces, 128, 64, dict(vertex_attrs=attrs)


def _case(name):
    """(verts, faces, W, H, kwargs) of one tests/test_raster_pallas.py case."""
    if name == "dense":
        return (*_random_scene(0), {})
    if name == "fused_attrs":
        verts, faces, w, h = _random_scene(1)
        rng = np.random.default_rng(2)
        return verts, faces, w, h, dict(
            vertex_attrs=rng.normal(size=(verts.shape[0], 2)).astype(np.float32),
            face_attrs=rng.normal(size=(faces.shape[0], 3)).astype(np.float32))
    if name == "culled_overflow":
        verts, faces, w, h = _random_scene(7, V=80, F=70, W=256, H=40)
        rng = np.random.default_rng(8)
        return verts, faces, w, h, dict(
            vertex_attrs=rng.normal(size=(verts.shape[0], 2)).astype(np.float32),
            face_attrs=rng.normal(size=(faces.shape[0], 1)).astype(np.float32),
            cull=True, chunk=16, th=8, bin_capacity=8)
    if name == "nonaligned":
        return (*_random_scene(3, W=100, H=6), {})
    if name == "empty":
        verts, faces, w, h = _random_scene(3, W=100, H=6)
        verts[:, 2] = -1.0
        return verts, faces, w, h, {}
    if name == "nonfinite":
        return _nonfinite_scene()
    raise KeyError(name)


def _assert_raster_close(out_t, out_j):
    ft, fj = out_t["face"].numpy(), np.asarray(out_j["face"])
    dt, dj = out_t["depth"].numpy(), np.asarray(out_j["depth"])
    assert ft.dtype == np.int32 and ft.shape == fj.shape
    hit = fj >= 0
    np.testing.assert_array_equal(ft >= 0, hit)
    np.testing.assert_allclose(dt[hit], dj[hit], rtol=1e-5, atol=1e-5)
    assert np.all(np.isinf(dt[~hit]))
    same = (ft == fj) & hit
    tie = hit & ~same  # the faces may differ only where their depths tie
    assert np.all(np.abs(dt[tie] - dj[tie]) <= 1e-5 * np.maximum(1.0, np.abs(dj[tie])))
    for key, tol in (("bary", 1e-5), ("attrs", 1e-4)):
        assert (key in out_t) == (key in out_j), key
        if key in out_t:
            at, aj = out_t[key].numpy(), np.asarray(out_j[key])
            np.testing.assert_allclose(at[same], aj[same], rtol=0, atol=tol, err_msg=key)
            assert np.all(at[~hit] == 0.0), key


@pytest.mark.parametrize("name", ["dense", "fused_attrs", "culled_overflow", "nonaligned",
                                  "empty", "nonfinite"])
def test_rasterize_planes_matches_pallas_interpret(name):
    verts, faces, w, h, kw = _case(name)
    out_j = jax_rasterize_planes(jnp.asarray(verts), jnp.asarray(faces), w, h, interpret=True,
                                 **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                                    for k, v in kw.items()})
    out_t = raster.rasterize_planes(T(verts), T(faces), w, h,
                                    **{k: T(v) if isinstance(v, np.ndarray) else v
                                       for k, v in kw.items()})
    _assert_raster_close(out_t, out_j)
    assert out_t["face"].shape == (h, w)
    face = out_t["face"].numpy()
    if name == "empty":
        assert np.all(face == -1)
    if name == "nonfinite":
        cov = face >= 0
        assert cov.any()
        assert np.isfinite(out_t["attrs"].numpy()[cov]).all()
        bad = np.unique(np.where(np.isin(faces, [5, 17, 42]).any(1))[0])
        assert not np.isin(face[cov], bad).any()


def _cross_chunk_tie_scene():
    """300 random faces at 256 × 40 plus two near triangles, each drawn
    twice: faces 20 and 150 (either side of the 128-row chunk boundary) and
    140 and 260 (either side of the next) are identical, so wherever one
    wins, the two tie in depth and the lower id must win."""
    verts, faces, w, h = _random_scene(11, V=120, F=300, W=256, H=40)
    near = np.array([[10, -5, 0.3], [120, -5, 0.3], [10, 60, 0.3],
                     [140, 2, 0.4], [250, 2, 0.4], [200, 45, 0.4]], np.float32)
    verts = np.concatenate([verts, near])
    faces[20] = faces[150] = [120, 121, 122]
    faces[140] = faces[260] = [123, 124, 125]
    return verts, faces, w, h


@pytest.mark.parametrize("bin_capacity", [8, 384])
def test_overflow_chunks_break_depth_ties_by_lower_id(bin_capacity):
    """The plain version's packed-key merge of an overflow tile's 128-row
    chunks against JAX's strict < over ascending chunks (interpret mode):
    with bin_capacity 8 every tile overflows, with 384 (all 384 rows) none
    does and each bin spans three staged passes of the binned scan."""
    verts, faces, w, h = _cross_chunk_tie_scene()
    kw = dict(cull=True, chunk=128, th=8, bin_capacity=bin_capacity)
    out_j = jax_rasterize_planes(jnp.asarray(verts), jnp.asarray(faces), w, h,
                                 interpret=True, **kw)
    out_t = raster.rasterize_planes(T(verts), T(faces), w, h, **kw)
    _, overflow = raster.bin_faces(T(verts), T(faces), 384, w, h, 8, bin_capacity)
    assert int(overflow.sum()) == (overflow.numel() if bin_capacity == 8 else 0)
    _assert_raster_close(out_t, out_j)
    face = out_t["face"].numpy()
    np.testing.assert_array_equal(face, np.asarray(out_j["face"]))
    assert (face == 20).sum() > 1000 and (face == 140).sum() > 1000
    assert not np.isin(face, [150, 260]).any()


def test_binned_and_full_scan_agree_exactly():
    """K4b's binning (overflow tiles included) and K4a's full scan evaluate
    the same planes in the same order, so the plain versions of the two give
    identical images, ties included."""
    verts, faces, w, h, kw = _case("culled_overflow")
    # 29 to 59 faces overlap each of the 10 tiles: capacity 45 bins 4, 6 overflow
    kw = {k: T(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    kw["bin_capacity"] = 45
    binned = raster.rasterize_planes(T(verts), T(faces), w, h, **kw)
    full = raster.rasterize_planes(T(verts), T(faces), w, h, **dict(kw, cull=False, th=4))
    _, overflow = raster.bin_faces(T(verts), T(faces), 80, w, h, 8, 45)
    assert int(overflow.sum()) == 6
    for key in ("depth", "face", "bary", "attrs"):
        assert torch.equal(binned[key], full[key]), key


@pytest.mark.parametrize("th", [4, 8])
@pytest.mark.parametrize("name", TILE_EDGE_SCENES)
def test_tile_reject_is_conservative(name, th):
    """K4a's per-tile reject (`tile_face_may_cover`, the kernel's `may_cover`
    in plain torch) keeps every face that the per-pixel test accepts at some
    pixel centre of the tile, on scenes of edges through tile-corner pixel
    centres, faces across tile borders and depths crossing 0. It also keeps
    every winner of JAX's unculled rasterize_planes (interpret mode), whose
    edge pixels XLA's rounding may decide otherwise than the port's."""
    verts, faces, w, h = tile_edge_scene(name)
    out_j = jax_rasterize_planes(jnp.asarray(verts), jnp.asarray(faces), w, h, cull=False,
                                 th=th, interpret=True)
    v, f = T(verts), T(faces)
    face_j = np.asarray(out_j["face"])
    planes = raster._tables(v, f, None, None, None, 128)[0]
    may = raster.tile_face_may_cover(planes, w, h, th).numpy()
    gi, gj = raster._grid(w, h, th)
    # every (tile, face) pair that the per-pixel test accepts at some pixel
    x, y = raster._pixel_xy(torch.arange(gi * gj), gj, th)
    pl = planes.expand(gi * gj, -1, -1)
    w0, w1, w2, z = (raster._plane(pl, k, x, y) for k in (0, 3, 6, 9))
    hits = ((w0 >= 0) & (w1 >= 0) & (w2 >= 0) & (z > 0)).sum(-1).numpy()
    assert may[hits > 0].all()
    rows, cols = np.nonzero(face_j >= 0)
    assert may[(rows // th) * gj + cols // 128, face_j[rows, cols]].all()
    # the reject drops most pairs, and the scenes reach its edge cases
    assert (~may[:, :faces.shape[0]]).sum() > may[:, :faces.shape[0]].sum() // 2
    if name == "corner_edges":
        assert (hits == 1).sum() >= 20  # faces touching a tile at one pixel centre


# ---- the shadowed render and the clip ----

def test_render_mesh_shadowed_matches_jax(chars, rng):
    from momentum_tpu.character.skinning import skin_points as j_skin
    from momentum_tpu.rasterizer import render_mesh_shadowed as j_render
    from momentum_tpu.rasterizer.utils import create_camera_for_body as j_camera

    char_j, _ = chars
    motion = np.cumsum(0.02 * rng.normal(size=(2, char_j.num_model_parameters)),
                       axis=0).astype(np.float32)
    states = _jax_states(char_j, motion)
    cam_j = j_camera(char_j, states, 96, 128)
    cam_t = camera_from_numpy(camera_to_numpy(cam_j), device="cpu")
    faces = np.asarray(char_j.mesh.faces)
    for st in states:
        verts = np.asarray(j_skin(char_j.skin_weights, st, char_j.inverse_bind_pose,
                                  char_j.mesh.vertices))
        a = j_render(cam_j, jnp.asarray(verts), jnp.asarray(faces), 128, 96,
                     shadow_resolution=64, method="planes")
        b = render.render_mesh_shadowed(cam_t, T(verts), T(faces), 128, 96,
                                        shadow_resolution=64, method="planes")
        ma, mb = np.asarray(a["mask"]), b["mask"].numpy()
        assert ma.sum() > 100
        assert np.sum(ma != mb) <= max(3, int(0.01 * ma.sum()))
        both = ma & mb & (np.asarray(a["face"]) == b["face"].numpy())
        np.testing.assert_allclose(b["color"].numpy()[both], np.asarray(a["color"])[both],
                                   rtol=0, atol=1e-3)
        sa, sb = np.asarray(a["shadow"]), b["shadow"].numpy()
        assert np.mean(sa[ma & mb] == sb[ma & mb]) >= 0.99
        assert np.isfinite(b["color"].numpy()).all()


def test_render_clip_matches_jax_recipe():
    """The whole slice at a small size: build_render_clip + make_render_clip
    (FK, skinning, camera, two raster passes per frame, box filter) against
    config 7's recipe on the JAX planes path, 2 frames at 64 × 48 @ 2×SS."""
    from momentum_tpu.character.skinning import skin_points as j_skin
    from momentum_tpu.rasterizer import render_mesh_shadowed as j_render
    from momentum_tpu.rasterizer.utils import create_camera_for_body as j_camera
    from momentum_tpu_torch.testing.workloads import build_render_clip, make_render_clip

    char_t, motion, cam_t = build_render_clip(frames=2, image_height=96, image_width=128,
                                              device="cpu")
    imgs = make_render_clip(char_t, cam_t, width=64, height=48, shadow_resolution=64)(motion)
    assert imgs.shape == (2, 48, 64, 3) and torch.isfinite(imgs).all()

    char_j = jax_fullbody_character()
    states = _jax_states(char_j, motion.numpy())
    cam_j = j_camera(char_j, states, 96, 128)
    np.testing.assert_allclose(to_numpy(cam_t.eye_from_world), np.asarray(cam_j.eye_from_world),
                               rtol=1e-5, atol=1e-5)
    ref = []
    for st in states:
        verts = j_skin(char_j.skin_weights, st, char_j.inverse_bind_pose, char_j.mesh.vertices)
        out = j_render(cam_j, verts, char_j.mesh.faces, 128, 96, shadow_resolution=64,
                       method="planes")
        ref.append(np.asarray(out["color"]).reshape(48, 2, 64, 2, 3).mean(axis=(1, 3)))
    ref = np.stack(ref)
    got = imgs.numpy()
    cov_t, cov_j = float(np.mean(got > 0)), float(np.mean(ref > 0))
    assert cov_j > 0.01 and abs(cov_t / cov_j - 1) <= 0.02
    # AA pixels on a flipped silhouette pixel may differ; the rest agree
    assert np.mean(np.abs(got - ref) > 1e-3) <= 0.01


def test_render_clip_passes_are_the_clips_passes():
    """workloads.render_clip_passes gives, per frame, the tables and bins of
    the two passes that make_render_clip's render_mesh_shadowed rasterizes:
    their plain scans give its face map and depth, and its shadow map."""
    from momentum_tpu_torch.testing import workloads

    char, motion, cam = workloads.build_render_clip(frames=2, image_height=96,
                                                    image_width=128, device="cpu")
    faces = char.mesh.faces
    passes = workloads.render_clip_passes(char, cam, motion, width=64, height=48,
                                          shadow_resolution=64)
    assert len(passes) == 2
    for verts, frame in zip(workloads.clip_vertices(char, motion), passes):
        assert frame["camera"][5:] == (128, 96, 8) and frame["shadow"][5:] == (64, 64, 8)
        out = render.render_mesh_shadowed(cam, verts, faces, 128, 96, shadow_resolution=64)
        cam_buf = raster._raster_plain(*frame["camera"], 128, True)
        assert torch.equal(cam_buf["face"], out["face"])
        assert torch.equal(cam_buf["depth"], out["depth"])
        sdepth, _ = render.render_shadow_map(verts, faces, render.LIGHT_DIR, 64)
        assert torch.equal(raster._raster_plain(*frame["shadow"], 128, False)["depth"], sdepth)


def test_render_clip_overflow_tiles():
    """The overflow tiles of config 7's 32-frame clip at its full size, as
    PERF.md counts them: camera passes of frames 0-4 one and frame 10 two
    (of 1200 tiles), shadow passes of frames 11, 12, 13, 25 and 27 one (of
    64)."""
    from momentum_tpu_torch.testing import workloads

    char, motion, cam = workloads.build_render_clip(32, seed=0, device="cpu")
    passes = workloads.render_clip_passes(char, cam, motion)
    camera = [int(f["camera"][4].sum()) for f in passes]
    shadow = [int(f["shadow"][4].sum()) for f in passes]
    assert passes[0]["camera"][4].numel() == 1200 and passes[0]["shadow"][4].numel() == 64
    assert camera == [1, 1, 1, 1, 1] + [0] * 5 + [2] + [0] * 21
    assert shadow == [0] * 11 + [1, 1, 1] + [0] * 11 + [1, 0, 1] + [0] * 4

"""Parity of the port's viewer modules with momentum_tpu on the CPU:
character/character_state.py, gui/viewer.py (auto_camera, render_motion
with ground and skeleton overlay, draw_skeleton, draw_markers, the
viewer's cameras, save_motion_gif), gui/gif.py, and the rerun and viser
fallbacks (gui/rerun_vis.py, gui/viser_vis.py). Inputs come from seeded
numpy and feed both packages; the characters cross through the bridge.

Tolerances: character_state's fields 1e-5 (FK and skinning in f32, summed
in another order), its normals 1e-4 (cross products of those vertices'
differences on the full-body mesh's small faces); cameras 1e-5; the GIF bytes equal to JAX's Python
encoder's (its native encoder switched off); the recorded rerun and viser
entries equal in path, archetype, time and keys, their arrays to 1e-5.
render_motion takes no method: in JAX on the CPU it rasterizes windowed,
in the port planes, so its frames are held by colours agreeing to 1e-5 on
≥ 99.9% of the pixels (a silhouette pixel whose centre lies on an edge may
flip between the two rasterizers; flat shading makes every other pixel's
colour its face's)."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from momentum_tpu.gui import gif as jgif, rerun_vis as jrv, viewer as jview, viser_vis as jvv
from momentum_tpu_torch.bridge import character_from_numpy
from momentum_tpu_torch.gui import gif as tgif, rerun_vis as trv, viewer as tview
from momentum_tpu_torch.gui import viser_vis as tvv

from test_torch_port_helpers import (
    camera_to_numpy, character_to_numpy, jax_fullbody_character, port_fullbody_character)
from test_torch_port_helpers import one_torch_thread  # noqa: F401

T = torch.as_tensor


@pytest.fixture(scope="module")
def test_chars():
    """The 4-joint test character (mesh, locators, collision) in both."""
    from momentum_tpu.testing.fixtures import create_test_character

    cj = create_test_character(4)
    return cj, character_from_numpy(character_to_numpy(cj, names=True), device="cpu")


@pytest.fixture(scope="module")
def body():
    return jax_fullbody_character(), port_fullbody_character()


def _motion(char, frames, seed=0, scale=0.2):
    rng = np.random.default_rng(seed)
    return rng.uniform(-scale, scale, (frames, char.num_model_parameters)).astype(np.float32)


def _close(a, b, tol=1e-5, msg=""):
    np.testing.assert_allclose(a.detach().numpy() if isinstance(a, torch.Tensor) else a,
                               np.asarray(b), rtol=tol, atol=tol, err_msg=msg)


# ---- character_state ----

@pytest.mark.parametrize("which", ["test", "body"])
def test_character_state_matches_jax(which, test_chars, body):
    from momentum_tpu.character.character_state import character_state as jcs
    from momentum_tpu_torch.character.character_state import character_state as tcs

    cj, ct = test_chars if which == "test" else body
    mp = _motion(cj, 3)
    cj, ct = cj.with_inverse_bind_pose(), ct.with_inverse_bind_pose()
    for i in range(3):
        a, b = jcs(cj, jnp.asarray(mp[i])), tcs(ct, T(mp[i]))
        for f in dataclasses.fields(a):
            va, vb = getattr(a, f.name), getattr(b, f.name)
            assert (va is None) == (vb is None), f.name
            if va is not None:
                _close(vb, va, 1e-4 if f.name == "mesh_normals" else 1e-5, msg=f.name)
    batched = tcs(ct, T(mp), update_collision=False)  # batch-native: the whole motion at once
    assert batched.collision_origin is None
    _close(batched.mesh_vertices[1], jcs(cj, jnp.asarray(mp[1])).mesh_vertices)
    assert tcs(ct, T(mp[0]), update_mesh=False).mesh_vertices is None


# ---- the viewer ----

def test_auto_camera_and_viewer_cameras_match_jax(body, rng):
    cj, ct = body
    pts = rng.normal(size=(40, 3)) * 30
    for a, b in ((jview.auto_camera(pts, 96, 64), tview.auto_camera(pts, 96, 64, device="cpu")),
                 (jview.create_camera_for_body(cj, _motion(cj, 1)[0], 96, 64),
                  tview.create_camera_for_body(ct, _motion(cj, 1)[0], 96, 64)),
                 (jview.create_camera_for_hand(cj, _motion(cj, 1)[0], 96, 64, "l_wrist"),
                  tview.create_camera_for_hand(ct, _motion(cj, 1)[0], 96, 64, "l_wrist")),
                 (jview.create_camera_for_hand(cj, _motion(cj, 1)[0], 96, 64, "nope"),
                  tview.create_camera_for_hand(ct, _motion(cj, 1)[0], 96, 64, "nope"))):
        na, nb = camera_to_numpy(a), camera_to_numpy(b)
        for k in na:
            _close(nb[k], na[k], msg=k)


@pytest.mark.parametrize("ground,skeleton_overlay", [(False, False), (True, True)])
def test_render_motion_matches_jax(body, ground, skeleton_overlay):
    """Auto-framed without the ground (the character spans a few dozen
    pixels), and at the body camera with the ground and the skeleton."""
    from momentum_tpu.rasterizer.utils import create_camera_for_body as jcam
    from momentum_tpu_torch.bridge import camera_from_numpy

    cj, ct = body
    motion = np.cumsum(0.02 * np.random.default_rng(1).normal(
        size=(3, cj.num_model_parameters)), axis=0).astype(np.float32)
    kw = dict(ground=ground, skeleton_overlay=skeleton_overlay)
    kj, kt = dict(kw), dict(kw)
    if ground:
        kj["camera"] = jcam(cj, jax.vmap(cj.skeleton_states)(jnp.asarray(motion)), 64, 96)
        kt["camera"] = camera_from_numpy(camera_to_numpy(kj["camera"]), device="cpu")
    want = jview.render_motion(cj, jnp.asarray(motion), 96, 64, **kj)
    got = tview.render_motion(ct, T(motion), 96, 64, **kt)
    assert isinstance(got, np.ndarray) and got.shape == want.shape == (3, 64, 96, 3)
    agree = np.all(np.abs(got - want) <= 1e-5, axis=-1)
    assert agree.mean() >= 0.999, agree.mean()
    assert (want.max(-1) > 0).mean() > (0.2 if ground else 0.001)


def test_draw_skeleton_and_markers_are_equal(body, rng):
    from momentum_tpu.rasterizer.utils import create_camera_for_body as jcam
    from momentum_tpu_torch.bridge import camera_from_numpy

    cj, ct = body
    states = np.asarray(cj.skeleton_states(jnp.asarray(_motion(cj, 1)[0])))
    cam_j = jcam(cj, states, 64, 96)
    cam_t = camera_from_numpy(camera_to_numpy(cam_j), device="cpu")
    img = rng.uniform(0, 1, (64, 96, 3)).astype(np.float32)
    np.testing.assert_array_equal(tview.draw_skeleton(T(img), cam_t, ct.skeleton, T(states)),
                                  jview.draw_skeleton(img, cam_j, cj.skeleton, states))
    pts = states[:, :3] + rng.normal(size=(cj.num_joints, 3)).astype(np.float32)
    np.testing.assert_array_equal(tview.draw_markers(img, cam_t, pts, size=2),
                                  jview.draw_markers(img, cam_j, pts, size=2))


# ---- GIF ----

def _jax_python_gif(monkeypatch, path, frames, **kw):
    from momentum_tpu import native

    monkeypatch.setattr(native, "gif_encode", lambda *a, **k: False)
    jgif.save_gif(str(path), frames, **kw)
    return path.read_bytes()


def test_gif_bytes_equal_jax_python_encoder(tmp_path, monkeypatch, rng):
    frames = rng.uniform(0, 1, (3, 40, 48, 3)).astype(np.float32)
    frames[0, :20] = 0.0  # long runs, as a render's background gives
    frames[1] = 0.5
    for kw in (dict(fps=15.0), dict(fps=60.0, loop=2)):
        tgif.save_gif(str(tmp_path / "t.gif"), frames, **kw)
        want = _jax_python_gif(monkeypatch, tmp_path / "j.gif", frames, **kw)
        assert (tmp_path / "t.gif").read_bytes() == want
    u8 = (frames[0] * 255).astype(np.uint8)  # one uint8 frame
    tgif.save_gif(str(tmp_path / "t.gif"), u8)
    assert (tmp_path / "t.gif").read_bytes() == _jax_python_gif(
        monkeypatch, tmp_path / "j.gif", u8)
    # the code table resets past 4096 codes: noise fills it within one frame
    noise = rng.integers(0, 256, (1, 96, 128, 3), dtype=np.uint8)
    assert tgif._lzw_encode(tgif._quantize(noise[0])) == \
        jgif._lzw_encode(jgif._quantize(noise[0]))


def test_save_motion_gif_matches_jax(tmp_path, monkeypatch, test_chars):
    cj, ct = test_chars
    motion = _motion(cj, 2)
    tview.save_motion_gif(str(tmp_path / "t.gif"), ct, T(motion), 48, 40, fps=10.0)
    want = jview.render_motion(cj, jnp.asarray(motion), 48, 40)
    got = tview.render_motion(ct, T(motion), 48, 40)
    assert np.all(np.abs(got - want) <= 1e-5, axis=-1).mean() >= 0.999
    data = (tmp_path / "t.gif").read_bytes()
    assert data[:6] == b"GIF89a" and data.count(b"\x2C\x00\x00\x00\x00") == 2
    tgif.save_gif(str(tmp_path / "g.gif"), got, fps=10.0)
    assert (tmp_path / "g.gif").read_bytes() == data


# ---- rerun and viser fallbacks ----

def _assert_entries(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert (a.path, a.archetype, a.time, a.static) == (b.path, b.archetype, b.time, b.static)
        assert a.payload.keys() == b.payload.keys(), a.path
        for k, vb in b.payload.items():
            va = a.payload[k]
            if isinstance(vb, (list, tuple)) and vb and isinstance(vb[0], str):
                assert list(va) == list(vb)
            elif isinstance(vb, (list, tuple)):
                assert len(va) == len(vb)
                for x, y in zip(va, vb):
                    _close(np.asarray(x, np.float64), np.asarray(y, np.float64), msg=a.path)
            else:
                _close(np.asarray(va), np.asarray(vb), msg=f"{a.path}/{k}")


def test_rerun_fallback_records_jax_entries(test_chars, rng, tmp_path):
    from momentum_tpu.tracking.tracker import MarkerSequence as JM
    from momentum_tpu_torch.tracking.tracker import MarkerSequence as TM

    cj, ct = test_chars
    motion = _motion(cj, 3)
    pos = rng.normal(size=(3, 5, 3)).astype(np.float32)
    occ = rng.uniform(size=(3, 5)) < 0.3
    names = tuple(cj.locators.names[:4]) + ("extra",)
    rj, rt = jrv.make_recording(), trv.make_recording()
    assert isinstance(rt, trv.FallbackRecording)  # no SDK in this image
    states_t = trv.log_animation(rt, "world/c", ct, T(motion),
                                 markers=TM(T(pos), T(occ), names))
    states_j = jrv.log_animation(rj, "world/c", cj, jnp.asarray(motion),
                                 markers=JM(jnp.asarray(pos), jnp.asarray(occ), names))
    _close(states_t, states_j)
    trv.log_model_params(rt, "w", "p", ct.parameter_transform.names, T(motion[0]))
    jrv.log_model_params(rj, "w", "p", cj.parameter_transform.names, motion[0])
    for rec, c, st in ((rt, ct, states_t[0]), (rj, cj, states_j[0])):
        trv_or_jrv = trv if rec is rt else jrv
        trv_or_jrv.log_marker_locator_correspondence(rec, "corr", c, st, pos[0], names,
                                                     occ[0], error_threshold=1.0)
        trv_or_jrv.log_mesh(rec, "mesh", c.mesh.vertices, c.mesh.faces,
                            normals=c.mesh.vertices, colors=np.ones((3,)))
    _assert_entries(rt.entries, rj.entries)
    assert rt.paths() == rj.paths() and rt.count("points3d") == rj.count("points3d")
    rt.save(str(tmp_path / "cap.npz"))
    replayed = trv.FallbackRecording()
    trv.replay(rt, replayed)
    _assert_entries(replayed.entries, rj.entries)


def test_viser_fallback_records_jax_scene(test_chars, rng):
    from momentum_tpu.tracking.tracker import MarkerSequence as JM
    from momentum_tpu_torch.tracking.tracker import MarkerSequence as TM

    cj, ct = test_chars
    motion = _motion(cj, 3)
    pos = rng.normal(size=(3, 5, 3)).astype(np.float32)
    sj, st = jvv.FallbackScene(), tvv.make_scene()
    assert isinstance(st, tvv.FallbackScene)
    seen = []
    tvv.animate_motion(st, ct, T(motion), markers=TM(T(pos), T(pos[..., 0] > 9), ()),
                       frame_callback=seen.append)
    jvv.animate_motion(sj, cj, jnp.asarray(motion), markers=JM(jnp.asarray(pos),
                                                               jnp.asarray(pos[..., 0] > 9)))
    assert seen == [0, 1, 2] and st.updates == sj.updates
    assert st.nodes.keys() == sj.nodes.keys()
    for name, hj in sj.nodes.items():
        ht = st.nodes[name]
        assert ht.kind == hj.kind and ht.props.keys() == hj.props.keys()
        for k, v in hj.props.items():
            if isinstance(v, np.ndarray) or hasattr(v, "shape"):
                _close(np.asarray(ht.props[k]), np.asarray(v), msg=f"{name}.{k}")
            else:
                assert ht.props[k] == v
    states = jax.vmap(cj.skeleton_states)(jnp.asarray(motion))
    verts = np.asarray(cj.mesh.vertices) + 1.0
    hj = jvv.show_character(jvv.FallbackScene(), cj, states[0], mesh_vertices=verts)
    ht = tvv.show_character(tvv.FallbackScene(), ct, ct.skeleton_states(T(motion[0])),
                            mesh_vertices=T(verts))
    _close(ht.mesh.props["vertices"], hj.mesh.props["vertices"])
    tvv.update_character(ht, ct, ct.skeleton_states(T(motion[1])), mesh_vertices=T(verts) * 2)
    jvv.update_character(hj, cj, states[1], mesh_vertices=verts * 2)
    _close(ht.mesh.props["vertices"], hj.mesh.props["vertices"])
    _close(ht.joints.props["points"], hj.joints.props["points"])

"""Parity of the port's glove path with momentum_tpu on the CPU:
math/euler.py, character/utility.py::remove_joints, every function of
tracking/glove_utils.py, per-frame and sequence glove tracking on the
5-joint rig of tests/test_glove_utils.py, the port's one module per hand
against the per-joint split, ROADMAP F21, and config G on a short clip
against tools/jax_reference.py's run of the same recipe.

Tolerances, each with where it comes from:
  * Euler angles and matrices 1e-5 absolute (float32 trigonometry; the
    two-axis fit's 20 Gauss-Newton steps 1e-4), gimbal locks included;
  * glove bones' offsets and pre-rotations 1e-6 (tests/test_glove_utils.py),
    the glove modules' rows rtol 1e-5 / atol 1e-6 and energies 1e-5
    relative (test_torch_port_catalog.py's joint-pair rule);
  * remove_joints: tables exact, the inverse bind pose 1e-6;
  * tracking: the final energies rtol 1e-3 or atol 1e-7
    (test_torch_port_tracking.py's rule); one module per hand against the
    per-joint split: energies 1e-4 relative, motions 1e-4 (the same rows
    summed in another order);
  * config G at 12 frames (per-frame on 4) against the tool: the sequence's
    final error 1e-2 relative, the marker and glove medians 2%, p90 5%
    (chip_smoke.py's holds at 343 frames).
"""

import dataclasses
import itertools
import pathlib
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from momentum_tpu import tracking as jt
from momentum_tpu.character.utility import remove_joints as jremove
from momentum_tpu.math import euler as jeu, skel_state as jss
from momentum_tpu.solver import SkeletonSolverFunction as JSSF
from momentum_tpu.testing.fixtures import (
    create_fullbody_character as jax_fullbody, create_test_character as jax_test_character)
from momentum_tpu.tracking import glove_utils as jg
from momentum_tpu_torch import bridge, tracking as tt
from momentum_tpu_torch.character.utility import remove_joints as tremove
from momentum_tpu_torch.math import euler as teu, skel_state as tss
from momentum_tpu_torch.solver import SkeletonSolverFunction as TSSF
from momentum_tpu_torch.testing import fixtures as tfix, workloads as twork
from momentum_tpu_torch.tracking import glove_utils as tg

from test_torch_port_helpers import character_to_numpy

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "tools"))
import jax_reference  # noqa: E402

EULER_TOL = dict(rtol=0, atol=1e-5)
MODULE_TOL = dict(rtol=1e-5, atol=1e-6)
ENERGY_TOL = dict(rtol=1e-3, atol=1e-7)
SPLIT_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Many small CPU solves run fastest on one thread beside XLA's pool."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---- math/euler.py ----

def _angles(n=64, seed=0):
    """Random angles with gimbal locks of both signs on the middle axis."""
    a = np.random.default_rng(seed).uniform(-np.pi, np.pi, (n, 3)).astype(np.float32)
    a[:8, 1] = np.pi / 2
    a[8:16, 1] = -np.pi / 2
    return a


EULER_CASES = ["xyz", "zyx", "quaternion_zyx", "one_axis", "two_axis"] + [
    f"{''.join('xyz'[i] for i in axes)}_{conv}"
    for axes in [p for p in itertools.product(range(3), repeat=3) if p[0] != p[1] != p[2]]
    for conv in ("intrinsic", "extrinsic")]


@pytest.mark.parametrize("case", EULER_CASES)
def test_euler_matches_jax(case):
    """Every function of math/euler.py against JAX's: the compositions, the
    extractions (each recomposing to the input), the quaternion form, the
    one- and two-axis fits; all 12 sequences in both conventions."""
    a = _angles()
    mj = jeu.euler_xyz_to_matrix(jnp.asarray(a))
    if case in ("xyz", "zyx"):
        to_m, to_a = {"xyz": ("euler_xyz_to_matrix", "rotation_matrix_to_euler_xyz"),
                      "zyx": ("euler_zyx_to_matrix", "rotation_matrix_to_euler_zyx")}[case]
        m_t = getattr(teu, to_m)(torch.as_tensor(a))
        np.testing.assert_allclose(m_t.numpy(), np.asarray(getattr(jeu, to_m)(jnp.asarray(a))),
                                   **EULER_TOL)
        got = getattr(teu, to_a)(m_t)
        np.testing.assert_allclose(got.numpy(), np.asarray(getattr(jeu, to_a)(jnp.asarray(
            m_t.numpy()))), atol=2e-3)  # the locks' branches: angles of ill-posed entries
        recompose = teu.euler_xyz_to_matrix(got) if case == "xyz" else \
            teu.euler_zyx_to_matrix(got.flip(-1))
        np.testing.assert_allclose(recompose.numpy(), m_t.numpy(), atol=1e-4)
    elif case == "quaternion_zyx":
        from momentum_tpu_torch.math import quaternion as tq

        q = tq.euler_to_quaternion(torch.as_tensor(a[16:]))
        got = teu.quaternion_to_euler_zyx(q)
        np.testing.assert_allclose(got.numpy(), np.asarray(jeu.quaternion_to_euler_zyx(
            jnp.asarray(q.numpy()))), **EULER_TOL)
        np.testing.assert_allclose(teu.euler_zyx_to_matrix(got).numpy(),
                                   tq.to_rotation_matrix(q).numpy(), atol=1e-5)
    elif case == "one_axis":
        for axis in range(3):
            np.testing.assert_allclose(
                teu.rotation_matrix_to_one_axis_euler(torch.as_tensor(np.asarray(mj)),
                                                      axis).numpy(),
                np.asarray(jeu.rotation_matrix_to_one_axis_euler(mj, axis)), **EULER_TOL)
    elif case == "two_axis":
        for a0, a1 in ((0, 1), (2, 0), (1, 2)):
            np.testing.assert_allclose(
                teu.rotation_matrix_to_two_axis_euler(torch.as_tensor(np.asarray(mj)), a0,
                                                      a1).numpy(),
                np.asarray(jeu.rotation_matrix_to_two_axis_euler(mj, a0, a1)), atol=1e-4)
        with pytest.raises(ValueError, match="distinct"):
            teu.rotation_matrix_to_two_axis_euler(torch.eye(3), 1, 1)
    else:
        seq, conv = case.split("_")
        axes = tuple("xyz".index(c) for c in seq)
        m_t = teu.euler_to_matrix(torch.as_tensor(a), axes, conv)
        m_j = jeu.euler_to_matrix(jnp.asarray(a), axes, conv)
        np.testing.assert_allclose(m_t.numpy(), np.asarray(m_j), **EULER_TOL)
        got = teu.rotation_matrix_to_euler(m_t, axes, conv)
        want = jeu.rotation_matrix_to_euler(jnp.asarray(m_t.numpy()), axes, conv)
        regular = np.abs(np.cos(a[:, 1])) > 1e-2 if axes[0] != axes[2] else \
            np.abs(np.sin(a[:, 1])) > 1e-2
        np.testing.assert_allclose(got.numpy()[regular], np.asarray(want)[regular], atol=1e-4)
        np.testing.assert_allclose(teu.euler_to_matrix(got, axes, conv).numpy(), m_t.numpy(),
                                   atol=2e-3)
    with pytest.raises(ValueError, match="convention"):
        teu.euler_to_matrix(torch.zeros(3), convention="sideways")


# ---- glove_utils.py on tests/test_glove_utils.py's 5-joint rig ----

@pytest.fixture(scope="module")
def rigs():
    """(JAX 5-joint rig, the port's) with joints 2 and 4 named l_wrist and
    r_wrist, as tests/test_glove_utils.py's fixture."""
    out = []
    for char in (jax_test_character(5), tfix.create_test_character(5, device="cpu")):
        names = list(char.skeleton.joint_names)
        names[2], names[4] = "l_wrist", "r_wrist"
        out.append(dataclasses.replace(char, skeleton=dataclasses.replace(
            char.skeleton, joint_names=tuple(names))))
    return tuple(out)


OFFSETS = ((0.1, 0.2, 0.3, 0.0, 0.0, np.pi / 2), (-0.05, 0.0, 0.1, 0.3, -0.2, 0.1))


def _offsets(module):
    return tuple(module.GloveOffset(translation=np.asarray(o[:3], np.float32),
                                    rotation_euler_xyz=np.asarray(o[3:], np.float32))
                 for o in OFFSETS)


def _same_rig(tchar, jchar, ibp=False):
    assert tchar.skeleton.joint_names == tuple(jchar.skeleton.joint_names)
    np.testing.assert_array_equal(tchar.skeleton.joint_parent.numpy(),
                                  np.asarray(jchar.skeleton.joint_parent))
    for k in ("pre_rotation", "translation_offset"):
        np.testing.assert_allclose(getattr(tchar.skeleton, k).numpy(),
                                   np.asarray(getattr(jchar.skeleton, k)), atol=1e-6)
    pt_t, pt_j = tchar.parameter_transform, jchar.parameter_transform
    assert pt_t.names == pt_j.names
    assert {k: tuple(v) for k, v in pt_t.parameter_sets.items()} == \
        {k: tuple(v) for k, v in pt_j.parameter_sets.items()}
    np.testing.assert_array_equal(pt_t.transform.numpy(), np.asarray(pt_j.transform))
    np.testing.assert_array_equal(pt_t.offsets.numpy(), np.asarray(pt_j.offsets))
    if ibp:
        np.testing.assert_allclose(tchar.inverse_bind_pose.numpy(),
                                   np.asarray(jchar.inverse_bind_pose), atol=1e-6)


def test_glove_bones_and_parameters_match_jax(rigs):
    """add_glove_bones with offsets (idempotent, a missing wrist skipped),
    add_glove_calibration_parameters, create_glove_character and
    extract_glove_offsets_from_character against JAX's."""
    jchar, tchar = rigs
    jb = jg.add_glove_bones(jchar, offsets=_offsets(jg))
    tb = tg.add_glove_bones(tchar, offsets=_offsets(tg))
    _same_rig(tb, jb)
    assert tg.add_glove_bones(tb).num_joints == tb.num_joints
    _same_rig(tg.add_glove_calibration_parameters(tb), jg.add_glove_calibration_parameters(jb))
    jc, tc = jg.create_glove_character(jchar), tg.create_glove_character(tchar)
    _same_rig(tc, jc)
    assert len(tc.parameter_transform.parameter_sets["gloves"]) == 12
    params = np.random.default_rng(3).uniform(-0.5, 0.5, tc.num_model_parameters)
    for got, want in zip(tg.extract_glove_offsets_from_character(tc, params),
                         jg.extract_glove_offsets_from_character(jc, params)):
        np.testing.assert_array_equal(got.translation, want.translation)
        np.testing.assert_array_equal(got.rotation_euler_xyz, want.rotation_euler_xyz)
    plain = tfix.create_test_character(4, device="cpu")
    assert tg.add_glove_bones(plain).num_joints == plain.num_joints
    assert tg.extract_glove_offsets_from_character(plain, np.zeros(
        plain.num_model_parameters))[0].translation.tolist() == [0.0, 0.0, 0.0]


def test_bake_glove_offsets_round_trip_matches_jax(rigs):
    """bake_glove_offsets_from_params into the rig without glove bones and
    into one with bones at other offsets (remove_joints, then the bones at
    the solved offsets) against JAX's; the baked bone's global state equals
    the calibration parameters' at the same pose."""
    jchar, tchar = rigs
    jc, tc = jg.create_glove_character(jchar), tg.create_glove_character(tchar)
    params = np.zeros(tc.num_model_parameters, np.float32)
    i = tc.parameter_transform.names.index("glove_l_wrist_tx")
    params[i:i + 12] = [0.4, 0.0, -0.2, 0.0, 0.3, 0.0, -0.1, 0.2, 0.05, 0.1, 0.0, -0.3]
    params[:6] = [0.1, -0.2, 0.3, 0.2, -0.1, 0.05]
    for jbase, tbase in ((jchar, tchar), (jg.add_glove_bones(jchar, offsets=_offsets(jg)),
                                          tg.add_glove_bones(tchar, offsets=_offsets(tg)))):
        jbaked = jg.bake_glove_offsets_from_params(jbase, params, jc)
        tbaked = tg.bake_glove_offsets_from_params(tbase, params, tc)
        _same_rig(tbaked, jbaked)
        pose = torch.as_tensor(params[:tbaked.num_model_parameters])
        bone = tbaked.skeleton.joint_names.index("glove_l_wrist")
        np.testing.assert_allclose(tbaked.skeleton_states(pose)[bone].numpy(),
                                   tc.skeleton_states(torch.as_tensor(params))[bone].numpy(),
                                   atol=1e-5)
    assert tg.bake_glove_offsets_from_params(tchar, params, tc, cfg=None) is tchar


def test_glove_error_functions_match_jax(rigs):
    """make_glove_error_functions' position and orientation modules (two
    fingers, one sample invalid) against JAX's: rows and energies at random
    poses, the invalid sample's rows zero; the missing bone raises."""
    jchar, tchar = rigs
    jc, tc = jg.create_glove_character(jchar), tg.create_glove_character(tchar)
    rng = np.random.default_rng(4)
    q = rng.normal(0, 1, (2, 2, 4))
    glove = dict(joint_index=np.asarray([3, 1], np.int32),
                 positions=rng.normal(0, 0.3, (2, 2, 3)).astype(np.float32),
                 orientations=(q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32),
                 valid=np.asarray([[True, False], [True, True]]))
    x = rng.uniform(-0.3, 0.3, (3, tc.num_model_parameters)).astype(np.float32)
    for frame in (0, 1):
        jefs = jg.make_glove_error_functions(jc, jg.GloveSequence(**glove), frame, hand=1)
        tefs = tg.make_glove_error_functions(tc, tg.GloveSequence(**glove), frame, hand=1)
        fj, ft = JSSF(jc, jefs), TSSF(tc, tefs)
        rows = ft.residual(torch.as_tensor(x)).numpy()
        np.testing.assert_allclose(rows, np.asarray(fj.residual(jnp.asarray(x))), **MODULE_TOL)
        np.testing.assert_allclose(ft.error(torch.as_tensor(x)).numpy(),
                                   np.asarray(fj.error(jnp.asarray(x))), rtol=1e-5)
        if frame == 0:
            assert np.abs(rows[:, 3:6]).max() == 0.0  # the invalid sample's position rows
    with pytest.raises(ValueError, match="create_glove_character"):
        tg.make_glove_error_functions(tchar, tg.GloveSequence(**glove), 0)


def test_remove_joints_matches_jax():
    """remove_joints on the full-body rig (a hand's tail and a leg, their
    subtrees with them, by name and by index): skeleton, parameter
    transform, locators, skinning re-pointed at the kept ancestors and the
    recomputed inverse bind pose, against JAX's."""
    jchar = jax_fullbody()
    tchar = bridge.character_from_numpy(character_to_numpy(jchar, names=True), device="cpu")
    drop = ["l_hand3", jchar.skeleton.joint_names.index("r_leg1")]
    jout, tout = jremove(jchar, drop), tremove(tchar, drop)
    _same_rig(tout, jout, ibp=True)
    assert tout.num_joints == jchar.num_joints - 4 - 6
    lj, lt = jout.locators, tout.locators
    assert lt.names == tuple(lj.names) and lt.num_locators < 80
    np.testing.assert_array_equal(lt.parent.numpy(), np.asarray(lj.parent))
    np.testing.assert_array_equal(lt.offset.numpy(), np.asarray(lj.offset))
    np.testing.assert_array_equal(tout.skin_weights.index.numpy(),
                                  np.asarray(jout.skin_weights.index))
    assert tout.mesh is tchar.mesh and tout.collision is None and tout.blend_shape is None


# ---- glove tracking ----

def _glove_clip(jc, f, fingers, bone, seed=0):
    """tests/test_glove_utils.py's tracking inputs on glove rig jc: F random
    poses, the locators' positions, the fingers' states relative to the
    glove bone `bone`; (gt, JAX markers, port markers, glove arrays)."""
    rng = np.random.default_rng(seed)
    gt = rng.uniform(-0.2, 0.2, (f, jc.num_model_parameters)).astype(np.float32)
    states = jax.vmap(jc.skeleton_states)(jnp.asarray(gt))
    pos = np.asarray(jax.vmap(jc.locators.world_positions)(states))
    bi = jc.skeleton.joint_names.index(bone)
    rel = np.asarray(jss.multiply(jss.inverse(states[:, bi:bi + 1]), states[:, fingers]))
    names = tuple(jc.locators.names)
    occ = np.zeros(pos.shape[:2], bool)
    glove = dict(joint_index=np.asarray(fingers, np.int32), positions=rel[..., :3],
                 orientations=rel[..., 3:7], valid=np.ones((f, len(fingers)), bool))
    return (gt, jt.MarkerSequence(positions=jnp.asarray(pos), occluded=jnp.asarray(occ),
                                  names=names),
            tt.MarkerSequence(positions=torch.as_tensor(pos), occluded=torch.as_tensor(occ),
                              names=names), glove)


@pytest.mark.parametrize("entry", ["per_frame", "sequence"])
def test_glove_tracking_matches_jax(rigs, entry):
    """track_poses_per_frame and track_sequence with a glove stream of two
    fingers on the 5-joint rig (P = 36, F = 4; tests/test_glove_utils.py's
    case) against JAX's: the final energies, and both below 0.2."""
    jchar, tchar = rigs
    jc, tc = jg.create_glove_character(jchar), tg.create_glove_character(tchar)
    _, jm, tm, glove = _glove_clip(jc, 4, [1, 3], "glove_l_wrist")
    cfg = dict(max_iter=10, method="levenberg_marquardt")
    if entry == "per_frame":
        jres = jt.track_poses_per_frame(jc, jm, jt.TrackingConfig(**cfg),
                                        glove_data=((jg.GloveSequence(**glove), 0),))
        tres = tt.track_poses_per_frame(tc, tm, tt.TrackingConfig(**cfg),
                                        glove_data=((tg.GloveSequence(**glove), 0),))
    else:
        jres, _ = jt.track_sequence(jc, jm, jt.TrackingConfig(**cfg),
                                    glove_data=((jg.GloveSequence(**glove), 0),))
        tres, _ = tt.track_sequence(tc, tm, tt.TrackingConfig(**cfg),
                                    glove_data=((tg.GloveSequence(**glove), 0),))
    np.testing.assert_allclose(tres.errors.numpy(), np.asarray(jres.errors), **ENERGY_TOL)
    assert float(tres.errors.median()) < 0.2


@pytest.fixture(scope="module")
def fullbody_glove():
    """(JAX glove rig, port glove rig) of config G, and a 3-frame clip
    with one 7-finger glove on the left hand."""
    jc = jax_reference.glove_clip(3)[0]
    tc = twork.glove_character("cpu")[0]
    fingers = [jc.skeleton.joint_names.index(n) for n in twork.GLOVE_FINGERS[0]]
    return jc, tc, _glove_clip(jc, 3, fingers, "glove_" + twork.GLOVE_WRISTS[0], seed=5)


def test_one_module_per_hand_equals_the_per_joint_split(fullbody_glove):
    """On config G's rig (P = 169: the sequence solver's analytic per-frame
    Jacobian, F17), the port's one stacked module pair per hand gives the
    energy and motion of the per-joint split that the JAX side needs
    (F21) after one LM iteration: the same normal equations, summed in
    another order (further iterations of a solve this far from its optimum
    grow that order's float32 differences past 1e-4)."""
    _, tc, (_, _, tm, glove) = fullbody_glove
    cfg = tt.TrackingConfig(max_iter=1, regularization=1e-3, smoothing=1e-4,
                            method="levenberg_marquardt")
    gcfg = tg.GloveConfig(wrist_joint_names=twork.GLOVE_WRISTS)
    hand = ((tg.GloveSequence(**glove), 0),)
    split = tuple((tg.GloveSequence(joint_index=glove["joint_index"][s:s + 1],
                                    positions=glove["positions"][:, s:s + 1],
                                    orientations=glove["orientations"][:, s:s + 1],
                                    valid=glove["valid"][:, s:s + 1]), 0)
                  for s in range(7))
    a, _ = tt.track_sequence(tc, tm, cfg, glove_data=hand, glove_config=gcfg)
    b, _ = tt.track_sequence(tc, tm, cfg, glove_data=split, glove_config=gcfg)
    np.testing.assert_allclose(a.errors.numpy(), b.errors.numpy(), rtol=SPLIT_TOL)
    np.testing.assert_allclose(a.motion.numpy(), b.motion.numpy(), atol=SPLIT_TOL)


def test_f21_jax_sequence_raises_on_a_many_joint_glove(fullbody_glove):
    """ROADMAP F21: on the glove rig (P ≥ 64) JAX's track_sequence takes its
    analytic per-frame Jacobian, whose JointToJointOrientation form holds
    for one constraint only (errors/joint_pair.py:234), and raises on a
    7-finger glove; the port's runs, to JAX's energy on the per-joint split
    (ENERGY_TOL)."""
    jc, tc, (_, jm, tm, glove) = fullbody_glove
    cfg = dict(max_iter=3, regularization=1e-3, smoothing=1e-4, method="levenberg_marquardt")
    gj = jg.GloveConfig(wrist_joint_names=twork.GLOVE_WRISTS)
    gt_cfg = tg.GloveConfig(wrist_joint_names=twork.GLOVE_WRISTS)
    with pytest.raises(TypeError, match="reshape"):
        jt.track_sequence(jc, jm, jt.TrackingConfig(**cfg),
                          glove_data=((jg.GloveSequence(**glove), 0),), glove_config=gj)
    tres, _ = tt.track_sequence(tc, tm, tt.TrackingConfig(**cfg),
                                glove_data=((tg.GloveSequence(**glove), 0),),
                                glove_config=gt_cfg)
    assert bool(torch.isfinite(tres.motion).all())
    jres, _ = jt.track_sequence(jc, jm, jt.TrackingConfig(**cfg), glove_data=jax_reference.
                                split_gloves(((jg.GloveSequence(**glove), 0),)), glove_config=gj)
    np.testing.assert_allclose(tres.errors.numpy(), np.asarray(jres.errors), rtol=1e-2)


def test_config_g_matches_the_tool():
    """Config G on its first 12 frames (per-frame tracking on 4) against
    tools/jax_reference.py's run of the same recipe: the draws equal, the
    sequence's final error within 1e-2 relative, the marker error medians
    within 2% and p90 within 5%, the glove residual medians within 2%, the
    per-frame median energy within 2%; the bake round trip of the solved
    glove parameters. The tool runs in a thread meanwhile (XLA runs
    outside the GIL)."""
    d_t = twork.glove_clip_draws(12, 0, 169, 80)
    d_j = jax_reference.glove_clip_draws(12, 0, 169, 80)
    assert d_t.keys() == d_j.keys()
    for k in d_t:
        np.testing.assert_array_equal(d_t[k], d_j[k])
    with ThreadPoolExecutor(1) as pool:
        tool = pool.submit(jax_reference.glove, 12, per_frame=4)
        clip = twork.build_glove_clip(12, device="cpu")
        assert clip.char.num_joints == 53 and clip.char.num_model_parameters == 169
        seq = twork.track_glove_sequence(clip)
        head = twork.glove_clip_head(clip, 4)
        pf = twork.track_glove_per_frame(head)
        want = tool.result()
    got = dict(error=float(seq.errors[0]), **twork.glove_figures(clip, seq.motion))
    np.testing.assert_allclose(got["error"], want["sequence"]["error"], rtol=1e-2)
    for part, figs in (("sequence", got),
                       ("per_frame", dict(median_energy=float(np.median(pf.errors.numpy())),
                                          **twork.glove_figures(head, pf.motion)))):
        for k, v in figs.items():
            if k != "error":
                np.testing.assert_allclose(v, want[part][k], rtol=0.05 if "p90" in k else 0.02,
                                           err_msg=f"{part} {k}")
    base = tg.add_glove_bones(tfix.create_fullbody_character(device="cpu"), clip.config)
    baked = tg.bake_glove_offsets_from_params(base, seq.motion[0], clip.char, clip.config)
    bone = baked.skeleton.joint_names.index("glove_l_arm3")
    np.testing.assert_allclose(baked.skeleton.translation_offset[bone].numpy(),
                               seq.motion[0, 157:160].numpy(), atol=1e-6)

"""Parity of the port's quaternion / skel_state math and forward kinematics
with momentum_tpu on the CPU, including the Pallas FK kernel (K1) run in
interpret mode. Inputs come from seeded numpy and feed both packages.

Tolerances: the math ops are the same float32 formulas (1e-6 abs/rel covers
reassociation in the two frameworks' elementwise code); FK chains up to
~12 composes, so global states agree to ~1e-5 (the lifted JAX product
against the port's lifted or serial one)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from momentum_tpu.character import fk as jfk
from momentum_tpu.math import quaternion as jquat, skel_state as jss
from momentum_tpu_torch.character import fk as tfk
from momentum_tpu_torch.math import quaternion as tquat, skel_state as tss
from momentum_tpu_torch.ops import fk as fk_ops

from test_torch_port_helpers import jax_fullbody_character, port_fullbody_character
from test_torch_port_helpers import one_torch_thread  # noqa: F401

MATH_TOL = dict(rtol=1e-6, atol=1e-6)
FK_TOL = dict(rtol=1e-5, atol=1e-5)


def _quats(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _states(rng, n):
    t = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    s = rng.uniform(0.5, 2.0, (n, 1)).astype(np.float32)
    return np.concatenate([t, _quats(rng, n), s], axis=-1)


@pytest.fixture(scope="module")
def chars():
    return jax_fullbody_character(), port_fullbody_character()


def _joint_params(rng, char_j, batch):
    x = rng.uniform(-0.4, 0.4, (batch, char_j.num_model_parameters)).astype(np.float32)
    return np.array(char_j.parameter_transform.apply(jnp.asarray(x)))


def test_quaternion_ops_match_jax(rng):
    q1, q2 = _quats(rng, 64), _quats(rng, 64)
    v = rng.normal(size=(64, 3)).astype(np.float32)
    ang = rng.uniform(-3, 3, (64, 3)).astype(np.float32)
    T = torch.as_tensor
    pairs = [
        (jquat.multiply(q1, q2), tquat.multiply(T(q1), T(q2))),
        (jquat.rotate_vector(q1, v), tquat.rotate_vector(T(q1), T(v))),
        (jquat.euler_to_quaternion(ang, "ZYX"), tquat.euler_to_quaternion(T(ang), "ZYX")),
        (jquat.to_rotation_matrix(q1), tquat.to_rotation_matrix(T(q1))),
        (jquat.identity((2, 3)), tquat.identity((2, 3))),
    ]
    for j, t in pairs:
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **MATH_TOL)


def test_euler_orders_other_than_zyx_are_refused():
    """The orders other than ZYX were refused until the port took them all
    (ROADMAP M9 part 2); each is now JAX's, and an axis name that is not
    X, Y or Z is refused (a KeyError, as in JAX)."""
    ang = np.random.default_rng(3).uniform(-3, 3, (8, 3)).astype(np.float32)
    for order in ("XYZ", "XZY", "YXZ", "YZX", "ZXY"):
        np.testing.assert_allclose(
            tquat.euler_to_quaternion(torch.as_tensor(ang), order).numpy(),
            np.asarray(jquat.euler_to_quaternion(jnp.asarray(ang), order)), **MATH_TOL)
    with pytest.raises(KeyError):
        tquat.euler_to_quaternion(torch.zeros(3), "XYW")


def test_skel_state_ops_match_jax(rng):
    a, b = _states(rng, 64), _states(rng, 64)
    p = rng.normal(size=(64, 3)).astype(np.float32)
    T = torch.as_tensor
    np.testing.assert_allclose(tss.multiply(T(a), T(b)).numpy(),
                               np.asarray(jss.multiply(a, b)), **MATH_TOL)
    np.testing.assert_allclose(tss.transform_points(T(a), T(p)).numpy(),
                               np.asarray(jss.transform_points(a, p)), **MATH_TOL)
    np.testing.assert_array_equal(tss.identity((5,)).numpy(), np.asarray(jss.identity((5,))))
    t, q, s = tss.split(T(a))
    np.testing.assert_array_equal(tss.join(t, q, s[..., 0]).numpy(), a)


def test_local_global_states_and_axes_match_jax(chars, rng):
    char_j, char_t = chars
    skel_j, skel_t = char_j.skeleton, char_t.skeleton
    jp = _joint_params(rng, char_j, 16)
    local_j = jfk.local_skel_states(skel_j, jnp.asarray(jp))
    global_j = jfk.global_skel_states_lifted(skel_j, local_j)
    local_t = tfk.local_skel_states(skel_t, torch.as_tensor(jp))
    np.testing.assert_allclose(local_t.numpy(), np.asarray(local_j), **MATH_TOL)
    for method in ("lifted", "scan"):
        g = tfk.global_skel_states(skel_t, torch.as_tensor(jp), method=method)
        np.testing.assert_allclose(g.numpy(), np.asarray(global_j), **FK_TOL)
    np.testing.assert_allclose(
        tfk.parent_global_states(skel_t, torch.as_tensor(np.array(global_j))).numpy(),
        np.asarray(jfk.parent_global_states(skel_j, global_j)), **MATH_TOL)
    ta_j, ra_j = jfk.joint_axes(skel_j, jnp.asarray(jp), global_j)
    ta_t, ra_t = tfk.joint_axes(skel_t, torch.as_tensor(jp),
                                torch.as_tensor(np.array(global_j)))
    np.testing.assert_allclose(ta_t.numpy(), np.asarray(ta_j), **MATH_TOL)
    np.testing.assert_allclose(ra_t.numpy(), np.asarray(ra_j), **MATH_TOL)


def test_unbatched_fk_matches_jax(chars, rng):
    char_j, char_t = chars
    jp = _joint_params(rng, char_j, 1)[0]
    g_j = jfk.global_skel_states(char_j.skeleton, jnp.asarray(jp))
    g_t = tfk.global_skel_states(char_t.skeleton, torch.as_tensor(jp))
    assert g_t.shape == (char_t.num_joints, 8)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), **FK_TOL)


def test_fk_matches_pallas_kernel_in_interpret_mode(chars, rng):
    """K1's TPU kernel (ops/fk_pallas.py) run as tests/test_pose_shape_misc.py
    runs it on the CPU, against the port's FK on the same local states."""
    from momentum_tpu.ops.fk_pallas import fk_pallas

    char_j, char_t = chars
    jp = _joint_params(rng, char_j, 8)
    local = jax.vmap(lambda x: jfk.local_skel_states(char_j.skeleton, x))(jnp.asarray(jp))
    out_pallas = np.asarray(fk_pallas(char_j.skeleton, local))
    local_t = torch.as_tensor(np.array(local))
    np.testing.assert_allclose(fk_ops.fk_global(char_t.skeleton, local_t).numpy(),
                               out_pallas, **FK_TOL)
    np.testing.assert_allclose(tfk.global_skel_states_scan(char_t.skeleton, local_t).numpy(),
                               out_pallas, **FK_TOL)


def test_fk_vjp_matches_jax(chars, rng):
    """ROADMAP F8: the port's FK is differentiable through `_FkGlobal` (K1's
    autograd Function: its backward is the VJP of the lifted product), and
    its VJP for one seeded cotangent equals jax.vjp of JAX's
    global_skel_states (atol 1e-4, tests/test_pose_shape_misc.py:174)."""
    char_j, char_t = chars
    jp = _joint_params(rng, char_j, 8)
    cot = rng.normal(size=(8, char_t.num_joints, 8)).astype(np.float32)
    out_j, vjp = jax.vjp(lambda x: jfk.global_skel_states(char_j.skeleton, x), jnp.asarray(jp))
    (g_j,) = vjp(jnp.asarray(cot))
    x = torch.as_tensor(jp).requires_grad_()
    out_t = tfk.global_skel_states(char_t.skeleton, x)
    assert type(out_t.grad_fn).__name__ == "_FkGlobalBackward"
    out_t.backward(torch.as_tensor(cot))
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), **FK_TOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(g_j), rtol=0, atol=1e-4)


def test_skeleton_states_and_locators_match_jax(chars, rng):
    char_j, char_t = chars
    x = rng.uniform(-0.3, 0.3, (8, char_j.num_model_parameters)).astype(np.float32)
    states_j = char_j.skeleton_states(jnp.asarray(x))
    states_t = char_t.skeleton_states(torch.as_tensor(x))
    np.testing.assert_allclose(states_t.numpy(), np.asarray(states_j), **FK_TOL)
    np.testing.assert_allclose(char_t.locators.world_positions(states_t).numpy(),
                               np.asarray(char_j.locators.world_positions(states_j)),
                               **FK_TOL)


def test_hierarchy_tables_match_jax(chars):
    char_j, char_t = chars
    np.testing.assert_array_equal(char_t.skeleton.ancestor_matrix(),
                                  char_j.skeleton.ancestor_matrix())
    levels_j = char_j.skeleton.prefix_levels()
    levels_t = char_t.skeleton.prefix_levels()
    assert len(levels_t) == len(levels_j) == 5
    for a, b in zip(levels_t, levels_j):
        np.testing.assert_array_equal(a, b)


def _skeleton_pair(name, chars):
    """(JAX skeleton, port skeleton) of one hierarchy: the fixture rig, a
    226-joint chain (8 lifting levels), a star and a skeleton of two roots."""
    from momentum_tpu.character.skeleton import make_skeleton as jmake
    from momentum_tpu_torch.character import make_skeleton as tmake

    if name == "fixture":
        return chars[0].skeleton, chars[1].skeleton
    parents = {"chain226": [-1] + list(range(225)),
               "star": [-1] + [0] * 20,
               "two_roots": [-1, 0, 1, 1, -1, 4, 5, 6, 2, 8, 4]}[name]
    return jmake(parents), tmake(parents, device="cpu")


SKELETONS = ["fixture", "chain226", "star", "two_roots"]
LEVELS = {"fixture": 5, "chain226": 8, "star": 1, "two_roots": 3}


@pytest.mark.parametrize("name", SKELETONS)
def test_prefix_table_matches_jax_schedule(chars, name):
    """K1's int32 (L, nJ + 1) lifting table is JAX's prefix_levels() and its
    static prefix_schedule, row for row."""
    skel_j, skel_t = _skeleton_pair(name, chars)
    table = skel_t.prefix_table
    assert table.dtype == torch.int32
    assert table.shape == (LEVELS[name], skel_t.num_joints + 1)
    np.testing.assert_array_equal(table.numpy(), np.stack(skel_j.prefix_levels()))
    np.testing.assert_array_equal(table.numpy(), np.asarray(skel_j.prefix_schedule))


@pytest.mark.parametrize("name", SKELETONS)
def test_plain_fk_by_table_matches_jax(chars, name, rng):
    """fk_global_plain, driven by prefix_table, against JAX's lifted FK and
    its Pallas kernel in interpret mode, on random local states (unit
    rotations, short offsets, scales near 1 so that the 226-joint chain
    stays in range)."""
    from momentum_tpu.ops.fk_pallas import fk_pallas

    skel_j, skel_t = _skeleton_pair(name, chars)
    nj = skel_t.num_joints
    s = _states(rng, 4 * nj).reshape(4, nj, 8)
    s[..., :3] *= 0.05
    s[..., 7] = rng.uniform(0.98, 1.02, (4, nj))
    out = fk_ops.fk_global_plain(skel_t, torch.as_tensor(s)).numpy()
    np.testing.assert_allclose(out, np.asarray(jfk.global_skel_states_lifted(skel_j, s)),
                               **FK_TOL)
    np.testing.assert_allclose(out, np.asarray(fk_pallas(skel_j, jnp.asarray(s))), **FK_TOL)


def test_unsorted_skeleton_is_refused():
    from momentum_tpu_torch.character import make_skeleton

    with pytest.raises(ValueError):
        make_skeleton([-1, 2, 0], device="cpu")


def test_passive_joint_limits_match_jax(rng):
    """The full-body rig has no MinMaxJoint records, so the clamp is tested
    on records of its own: passive ones clamp, a non-passive one does not."""
    from momentum_tpu.character.limits import make_limits as jmake
    from momentum_tpu_torch.character import make_limits as tmake

    records = [(1, 3, -0.1, 0.1, 1.0, 1.0), (2, 4, -0.2, 0.05, 2.0, 1.0),
               (3, 5, -0.1, 0.1, 1.0, 0.0)]
    jp = rng.uniform(-0.5, 0.5, (6, 5 * 7)).astype(np.float32)
    out_j = np.asarray(jmake(minmax_joint=records).apply_passive(jnp.asarray(jp)))
    out_t = tmake(minmax_joint=records, device="cpu").apply_passive(torch.as_tensor(jp)).numpy()
    np.testing.assert_array_equal(out_t, out_j)
    assert np.any(out_t != jp) and np.all(out_t[:, 3 * 7 + 5] == jp[:, 3 * 7 + 5])

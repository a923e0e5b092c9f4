"""Parity of the port's math tail with momentum_tpu on the CPU: every
function of math/quaternion.py and math/skel_state.py (every Euler order,
slerp's two branches, from_matrix on a mirrored matrix), math/trs.py,
math/covariance.py (against a dense solve too), math/coordinate_system.py,
and utils/* (GlobalRandom's numpy stream, logging, progress, profiling).

Tolerances: 1e-6 absolute for the quaternion and skel_state functions (the
same float32 arithmetic; blends compared through their rotation matrices,
since the eigensolver's sign is its own); the TRS functions 1e-5 (an SVD
and 3 × 3 products); the covariance 1e-5 relative against JAX and 1e-4
against the dense float64 solve (float32 Woodbury at κ ~ 1e3); the
coordinate systems' signed permutations exact.
"""

import io
import itertools
import logging

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from momentum_tpu.math import (
    coordinate_system as jcs, covariance as jcov, quaternion as jq, skel_state as jss,
    trs as jtrs)
from momentum_tpu.utils import random as jrandom
from momentum_tpu_torch.math import (
    coordinate_system as tcs, covariance as tcov, quaternion as tq, skel_state as tss,
    trs as ttrs)
from momentum_tpu_torch.utils import random as trandom
from test_torch_port_helpers import one_torch_thread  # noqa: F401

TOL = 1e-6


def _rng(seed=0):
    return np.random.default_rng(seed)


def _quats(n, seed=0):
    q = _rng(seed).normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _states(n, seed=0):
    r = _rng(seed)
    return np.concatenate([r.normal(size=(n, 3)), _quats(n, seed + 1),
                           r.uniform(0.5, 2.0, (n, 1))], axis=-1).astype(np.float32)


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(np.asarray(t.detach() if hasattr(t, "detach") else t),
                               np.asarray(j), rtol=0, atol=tol)


def T(a):
    return torch.as_tensor(np.array(a))


def J(a):
    return jnp.asarray(np.asarray(a))


# ---- quaternion ----

def test_quaternion_names_are_jax_names():
    assert set(jq.__all__) <= set(tq.__all__)


UNARY = ["normalize", "conjugate", "inverse", "to_rotation_matrix", "to_axis_angle",
         "quaternion_to_xyz_euler", "to_rotation_matrix_assume_normalized"]


@pytest.mark.parametrize("name", UNARY)
def test_quaternion_unary(name):
    q = _quats(16) * 1.3  # inverse and normalize see a non-unit norm
    if name not in ("normalize", "inverse", "conjugate"):
        q = _quats(16)
    _close(getattr(tq, name)(T(q)), getattr(jq, name)(J(q)))


def test_quaternion_split_check_identity():
    q = _quats(5)
    for a, b in zip(tq.split(T(q)), jq.split(J(q))):
        _close(a, b)
    _close(tq.identity((2, 3)), jq.identity((2, 3)))
    with pytest.raises(ValueError):
        tq.check(torch.zeros(3, 3))


@pytest.mark.parametrize("name", ["multiply", "multiply_assume_normalized"])
def test_quaternion_multiply(name):
    a, b = _quats(16, 1), _quats(16, 2)
    _close(getattr(tq, name)(T(a), T(b)), getattr(jq, name)(J(a), J(b)))


@pytest.mark.parametrize("name", ["rotate_vector", "rotate_vector_assume_normalized"])
def test_quaternion_rotate(name):
    q, v = _quats(16), _rng(3).normal(size=(16, 3)).astype(np.float32)
    _close(getattr(tq, name)(T(q), T(v)), getattr(jq, name)(J(q), J(v)), 1e-5)


@pytest.mark.parametrize("scale", [1.0, 1e-7, 0.0])
def test_quaternion_from_axis_angle(scale):
    aa = (_rng(4).normal(size=(16, 3)) * scale).astype(np.float32)
    _close(tq.from_axis_angle(T(aa)), jq.from_axis_angle(J(aa)))


def test_quaternion_from_rotation_matrix():
    m = np.asarray(jq.to_rotation_matrix(J(_quats(32, 5))))
    _close(tq.from_rotation_matrix(T(m)), jq.from_rotation_matrix(J(m)))


ORDERS = ["".join(p) for p in itertools.permutations("XYZ")] + ["XYX", "ZXZ"]


@pytest.mark.parametrize("order", ORDERS)
def test_euler_to_quaternion_every_order(order):
    ang = _rng(6).uniform(-3, 3, (16, 3)).astype(np.float32)
    _close(tq.euler_to_quaternion(T(ang), order), jq.euler_to_quaternion(J(ang), order))


@pytest.mark.parametrize("name", ["euler_xyz_to_quaternion", "euler_zyx_to_quaternion"])
def test_euler_named_orders(name):
    ang = _rng(7).uniform(-3, 3, (16, 3)).astype(np.float32)
    _close(getattr(tq, name)(T(ang)), getattr(jq, name)(J(ang)))


@pytest.mark.parametrize("case", ["general", "flipped", "near", "scalar_t"])
def test_quaternion_slerp(case):
    a, b = _quats(16, 8), _quats(16, 9)
    t = _rng(10).uniform(0, 1, 16).astype(np.float32)
    if case == "flipped":  # dot < 0: the shorter arc through −b
        b = -a + 0.05 * b
        b /= np.linalg.norm(b, axis=-1, keepdims=True)
    elif case == "near":  # sin θ < 1e-5: the normalized lerp
        b = a.copy()
        b[:, 0] += 1e-7
    if case == "scalar_t":
        _close(tq.slerp(T(a), T(b), 0.3), jq.slerp(J(a), J(b), 0.3), 1e-5)
    else:
        _close(tq.slerp(T(a), T(b), T(t)), jq.slerp(J(a), J(b), J(t)), 1e-5)


@pytest.mark.parametrize("weighted", [False, True])
def test_quaternion_blends(weighted):
    q = _quats(20, 11).reshape(4, 5, 4)
    w = _rng(12).uniform(0.1, 1, (4, 5)).astype(np.float32) if weighted else None
    tw, jw = (T(w), J(w)) if weighted else (None, None)
    _close(tq.to_rotation_matrix(tq.blend(T(q), tw)),
           jq.to_rotation_matrix(jq.blend(J(q), jw)), 1e-5)
    _close(tq.blend_nlerp(T(q), tw), jq.blend_nlerp(J(q), jw))


def test_quaternion_from_two_vectors():
    a = _rng(13).normal(size=(16, 3)).astype(np.float32)
    b = _rng(14).normal(size=(16, 3)).astype(np.float32)
    b[0] = -a[0]  # antiparallel
    _close(tq.from_two_vectors(T(a), T(b)), jq.from_two_vectors(J(a), J(b)), 1e-5)


@pytest.mark.parametrize("weights", ["none", "given", "zero"])
def test_check_and_normalize_weights(weights):
    q = _quats(6).reshape(2, 3, 4)
    w = {"none": None, "given": np.asarray([[1.0, 2.0, 3.0], [0.5, 0.5, 1.0]], np.float32),
         "zero": np.zeros((2, 3), np.float32)}[weights]
    _close(tq.check_and_normalize_weights(T(q), None if w is None else T(w)),
           jq.check_and_normalize_weights(J(q), None if w is None else J(w)))
    with pytest.raises(ValueError):
        tq.check_and_normalize_weights(T(q), torch.ones(2, 4))


# ---- skel_state ----

def test_skel_state_names_are_jax_names():
    assert set(jss.__all__) <= set(tss.__all__)


@pytest.mark.parametrize("name", ["inverse", "to_matrix"])
def test_skel_state_unary(name):
    s = _states(16)
    _close(getattr(tss, name)(T(s)), getattr(jss, name)(J(s)), 1e-5)


@pytest.mark.parametrize("name", ["multiply", "multiply_assume_normalized"])
def test_skel_state_multiply(name):
    a, b = _states(16, 1), _states(16, 2)
    _close(getattr(tss, name)(T(a), T(b)), getattr(jss, name)(J(a), J(b)), 1e-5)


@pytest.mark.parametrize("name", ["transform_points", "transform_points_assume_normalized",
                                  "rotate_vectors"])
def test_skel_state_points(name):
    s, p = _states(16, 3), _rng(4).normal(size=(16, 3)).astype(np.float32)
    _close(getattr(tss, name)(T(s), T(p)), getattr(jss, name)(J(s), J(p)), 1e-5)


def test_skel_state_constructors():
    t = _rng(5).normal(size=(4, 3)).astype(np.float32)
    q = _quats(4, 6)
    s = _rng(7).uniform(0.5, 2, (4, 1)).astype(np.float32)
    _close(tss.from_translation(T(t)), jss.from_translation(J(t)))
    _close(tss.from_quaternion(T(q)), jss.from_quaternion(J(q)))
    _close(tss.from_scale(T(s)), jss.from_scale(J(s)))
    _close(tss.from_scale(T(s[:, 0])), jss.from_scale(J(s[:, 0])))
    _close(tss.join(T(t), T(q), T(s[:, 0])), jss.join(J(t), J(q), J(s[:, 0])))
    _close(tss.identity((2,)), jss.identity((2,)))
    for a, b in zip(tss.split(T(_states(3))), jss.split(J(_states(3)))):
        _close(a, b)
    with pytest.raises(ValueError):
        tss.check(torch.zeros(2, 7))


@pytest.mark.parametrize("mirrored", [False, True])
def test_skel_state_from_matrix(mirrored):
    m = np.array(jss.to_matrix(J(_states(16, 8))))
    if mirrored:  # det < 0: JAX keeps cbrt's negative scale and divides by 1e-12
        m[:, :3, 0] *= -1.0
    got, want = tss.from_matrix(T(m)), np.asarray(jss.from_matrix(J(m)))
    if mirrored:
        assert (want[:, 7] < 0).all()
    _close(got, want, 2e-6)


@pytest.mark.parametrize("weighted", [False, True])
def test_skel_state_blend(weighted):
    s = _states(12, 9).reshape(3, 4, 8)
    w = _rng(10).uniform(0.1, 1, (3, 4)).astype(np.float32) if weighted else None
    got = tss.blend(T(s), None if w is None else T(w))
    want = jss.blend(J(s), None if w is None else J(w))
    _close(got[..., [0, 1, 2, 7]], np.asarray(want)[..., [0, 1, 2, 7]], 1e-5)
    _close(tq.to_rotation_matrix(got[..., 3:7]), jq.to_rotation_matrix(want[..., 3:7]), 1e-5)


def test_skel_state_slerp():
    a, b = _states(16, 11), _states(16, 12)
    t = _rng(13).uniform(0, 1, 16).astype(np.float32)
    _close(tss.slerp(T(a), T(b), T(t)), jss.slerp(J(a), J(b), J(t)), 1e-5)
    _close(tss.slerp(T(a), T(b), 0.25), jss.slerp(J(a), J(b), 0.25), 1e-5)


# ---- trs ----

def _trs(n, seed):
    s = _states(n, seed)
    return jtrs.from_skeleton_state(J(s)), ttrs.from_skeleton_state(T(s))


def _close_trs(t, j, tol=1e-5):
    for a, b in zip(t, j):
        _close(a, b, tol)


def test_trs_names_are_jax_names():
    assert set(jtrs.__all__) == set(ttrs.__all__)


def test_trs_constructors():
    t = _rng(1).normal(size=(4, 3)).astype(np.float32)
    r = np.asarray(jq.to_rotation_matrix(J(_quats(4, 2))))
    s = _rng(3).uniform(0.5, 2, (4, 1)).astype(np.float32)
    _close_trs(ttrs.from_translation(T(t)), jtrs.from_translation(J(t)))
    _close_trs(ttrs.from_rotation_matrix(T(r)), jtrs.from_rotation_matrix(J(r)))
    _close_trs(ttrs.from_scale(T(s)), jtrs.from_scale(J(s)))
    _close_trs(ttrs.identity((2, 3)), jtrs.identity((2, 3)))


@pytest.mark.parametrize("name", ["inverse", "to_matrix", "to_skeleton_state"])
def test_trs_unary(name):
    j, t = _trs(8, 4)
    got, want = getattr(ttrs, name)(t), getattr(jtrs, name)(j)
    if isinstance(want, tuple):
        _close_trs(got, want)
    else:
        _close(got, want, 1e-5)


def test_trs_binary_and_points():
    (ja, ta), (jb, tb) = _trs(8, 5), _trs(8, 6)
    _close_trs(ttrs.multiply(ta, tb), jtrs.multiply(ja, jb))
    p = _rng(7).normal(size=(8, 3)).astype(np.float32)
    _close(ttrs.transform_points(ta, T(p)), jtrs.transform_points(ja, J(p)), 1e-5)
    m = np.asarray(jtrs.to_matrix(ja))
    _close_trs(ttrs.from_matrix(T(m)), jtrs.from_matrix(J(m)), 1e-5)
    c = np.asarray([True, False] * 4)
    _close_trs(ttrs.where(T(c), ta, tb), jtrs.where(J(c), ja, jb))
    _close_trs(ttrs.index_select(ta, 0, [3, 1]), jtrs.index_select(ja, 0, [3, 1]))


def test_trs_interpolation_and_rotmats():
    (ja, ta), (jb, tb) = _trs(8, 8), _trs(8, 9)
    w = _rng(10).uniform(0, 1, 8).astype(np.float32)
    _close_trs(ttrs.slerp(ta, tb, T(w)), jtrs.slerp(ja, jb, J(w)))
    _close_trs(ttrs.blend([ta, tb], T(np.asarray([0.3, 0.7], np.float32))),
               jtrs.blend([ja, jb], J(np.asarray([0.3, 0.7], np.float32))))
    _close_trs(ttrs.blend([ta, tb]), jtrs.blend([ja, jb]))
    e = _rng(11).uniform(-2, 2, (8, 3)).astype(np.float32)
    _close(ttrs.rotmat_from_euler_xyz(T(e)), jtrs.rotmat_from_euler_xyz(J(e)), 1e-5)
    _close(ttrs.rotmat_inverse(ta[1]), jtrs.rotmat_inverse(ja[1]))
    _close(ttrs.rotmat_multiply(ta[1], tb[1]), jtrs.rotmat_multiply(ja[1], jb[1]), 1e-5)
    _close(ttrs.rotmat_rotate_vector(ta[1], ta[0]), jtrs.rotmat_rotate_vector(ja[1], ja[0]),
           1e-5)


# ---- covariance ----

@pytest.mark.parametrize("rhs", ["vector", "matrix"])
def test_low_rank_covariance(rhs):
    a = _rng(20).normal(size=(4, 12)).astype(np.float32)
    x = _rng(21).normal(size=(12,) if rhs == "vector" else (12, 3)).astype(np.float32)
    j = jcov.LowRankCovarianceMatrix.create(0.7, a)
    t = tcov.LowRankCovarianceMatrix.create(0.7, a, device="cpu")
    assert (t.dim, t.rank) == (j.dim, j.rank)
    for name in ("times_vec", "inverse_times_vec"):
        np.testing.assert_allclose(getattr(t, name)(T(x)).numpy(),
                                   np.asarray(getattr(j, name)(J(x))), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(t.log_determinant()), float(j.log_determinant()),
                               rtol=1e-5)
    np.testing.assert_allclose(float(t.inverse_log_determinant()),
                               float(j.inverse_log_determinant()), rtol=1e-5)
    dense = 0.49 * np.eye(12) + a.T.astype(np.float64) @ a
    np.testing.assert_allclose(t.inverse_times_vec(T(x)).numpy(), np.linalg.solve(dense, x),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(t.log_determinant()), np.linalg.slogdet(dense)[1],
                               rtol=1e-5)


# ---- coordinate systems ----

SYSTEMS = [tcs.CoordinateSystem(up, hand, unit) for up in "xyz" for hand in ("left", "right")
           for unit in ("m", "cm")]


@pytest.mark.parametrize("i", range(0, len(SYSTEMS), 3))
def test_coordinate_system_changes(i):
    src = SYSTEMS[i]
    q = _quats(6, 30)
    v = _rng(31).normal(size=(6, 3)).astype(np.float32)
    r = np.asarray(jq.to_rotation_matrix(J(q)))
    for dst in SYSTEMS:
        js, jd = (jcs.CoordinateSystem(c.up, c.hand, c.unit) for c in (src, dst))
        assert tcs.scale_factor(src, dst) == jcs.scale_factor(js, jd)
        np.testing.assert_array_equal(tcs.permutation_matrix(src, dst, device="cpu").numpy(),
                                      np.asarray(jcs.permutation_matrix(js, jd)))
        _close(tcs.change_vector(T(v), src, dst), jcs.change_vector(J(v), js, jd), 1e-5)
        _close(tcs.change_matrix(T(r), src, dst), jcs.change_matrix(J(r), js, jd))
        _close(tcs.change_quaternion(T(q), src, dst), jcs.change_quaternion(J(q), js, jd))
    assert tcs.MOMENTUM_COORDINATE_SYSTEM == tcs.CoordinateSystem("y", "right", "cm")


# ---- utils ----

def test_global_random_numpy_stream_is_jax_s():
    t, j = trandom.GlobalRandom(7), jrandom.GlobalRandom(7)
    for name, args in (("uniform", (0.0, 2.0, 5)), ("normal", (1.0, 0.5, (2, 3))),
                       ("integers", (0, 100, 7))):
        np.testing.assert_array_equal(getattr(t, name)(*args), getattr(j, name)(*args))
    t.set_seed(3)
    j.set_seed(3)
    assert t.seed == j.seed == 3
    np.testing.assert_array_equal(t.uniform(size=4), j.uniform(size=4))
    gen = t.key(device="cpu")
    assert isinstance(gen, torch.Generator) and gen.initial_seed() == 3
    trandom.set_global_seed(11)
    assert trandom.get_global_random().seed == 11


def test_logging_progress_profiling():
    from momentum_tpu_torch.utils import get_logger, profile_scope, set_log_level
    from momentum_tpu_torch.utils.progress import ProgressBar

    set_log_level("trace")
    assert get_logger().getEffectiveLevel() == logging.DEBUG - 5
    set_log_level("info")
    buf = io.StringIO()
    with ProgressBar("work", 4, stream=buf, force=True) as bar:
        bar.increment(2)
    assert "4/4" in buf.getvalue()
    with profile_scope("a region"):
        assert torch.ones(2).sum() == 2

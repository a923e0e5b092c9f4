"""Parity of the port's rigid error catalog (momentum_tpu_torch/errors/:
geometric, joint_pair, state, collision, camera_projection, Union, the four
limit record types of LimitErrorFunction and the position family's
joint-space Jacobians) with momentum_tpu on the CPU, on the 4-joint test
rig, every module built once in JAX from numpy-seeded inputs
(test_error_catalog.py's recipe) and carried across field by field.

Tolerances, each with where it comes from:
  * rows rtol 1e-4 / atol 1e-5 and energies rtol 1e-4 (float32, FK and the
    modules summed in another order);
  * Jacobians 1e-4 of max|J| (FixedAxisAngle's reaches ~2 000 near its
    clamp, so it is held relative to max|J| like the rest);
  * float64 central differences of every analytic Jacobian to 1e-6 of
    max|J|; the two frozen-parameter approximations (the ellipsoid limit's
    projection, collision's closest-point parameters) to
    test_error_catalog.py's scaled 8e-3.
JAX's Projection Jacobian holds only unbatched (ROADMAP F15) and its
JointToJointOrientation Jacobian only for one constraint (F16): the JAX side
is vmapped over the batch, and the two-constraint JointToJointOrientation
case is held against JAX's forward-mode Jacobian.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from momentum_tpu import errors as jerr
from momentum_tpu.camera import Camera as JCamera, PinholeIntrinsics as JPinhole
from momentum_tpu.character.character import CollisionGeometry as JCollision
from momentum_tpu.character.limits import make_limits as jmake_limits
from momentum_tpu.math.generalized_loss import GeneralizedLoss as JLoss
from momentum_tpu.solver import SkeletonSolverFunction as JSSF
from momentum_tpu.solver import analytic_jacobian as jaj
from momentum_tpu.testing.fixtures import create_test_character as jax_test_character
from momentum_tpu_torch import bridge, errors as terr
from momentum_tpu_torch.math.generalized_loss import GeneralizedLoss as TLoss
from momentum_tpu_torch.solver import SkeletonSolverFunction as TSSF
from momentum_tpu_torch.solver import analytic_jacobian as taj

from test_torch_port_helpers import camera_to_numpy, character_to_numpy

ROW_TOL = dict(rtol=1e-4, atol=1e-5)
JAC_TOL = 1e-4
FD_TOL = 1e-6
FD_APPROX_TOL = 8e-3  # test_error_catalog.py:259-276


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def to_port(x):
    """The port's counterpart of a JAX module (or of any of its fields)."""
    if isinstance(x, (jax.Array, np.ndarray)):
        return torch.as_tensor(np.array(x))
    if isinstance(x, JLoss):
        return TLoss(alpha=x.alpha, c=x.c)
    if isinstance(x, JCamera):
        return bridge.camera_from_numpy(camera_to_numpy(x), device="cpu")
    if isinstance(x, tuple):
        return tuple(to_port(v) for v in x)
    if dataclasses.is_dataclass(x):
        cls = getattr(terr, type(x).__name__)
        return cls(**{f.name: to_port(getattr(x, f.name)) for f in dataclasses.fields(x)})
    return x


def port_character(jchar):
    return bridge.character_from_numpy(character_to_numpy(jchar), device="cpu")


def _unit(rng, n):
    v = rng.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _quat(rng, n):
    v = rng.normal(size=(n, 4))
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _collision_char():
    """test_error_catalog.py's two long fat capsules on joints 1 and 3, so
    that folded poses overlap."""
    char = jax_test_character(4)
    cap_tf = np.zeros((2, 8), np.float32)
    cap_tf[:, 5] = np.sin(np.pi / 4)
    cap_tf[:, 6] = np.cos(np.pi / 4)
    cap_tf[:, 7] = 1.0
    return dataclasses.replace(char, collision=JCollision(
        parent=jnp.asarray([1, 3], jnp.int32), transform=jnp.asarray(cap_tf),
        radius=jnp.full((2, 2), 0.3, jnp.float32), length=jnp.full((2,), 0.8, jnp.float32)))


def _camera():
    eye_from_world = jnp.asarray([0.0, 0.0, 6.0, 0.0, 0.0, 0.0, 1.0, 1.0])
    return JCamera.create(JPinhole.create(500.0, 500.0, 320.0, 240.0), eye_from_world)


def _cases():
    """name -> (JAX module, JAX character or None for the test rig, pose scale)."""
    rng = np.random.default_rng(31)
    char = jax_test_character(4)
    nj, p = char.num_joints, char.num_model_parameters

    def p3(n):
        return rng.uniform(-0.6, 0.6, (n, 3)).astype(np.float32)

    def parents(n):
        return rng.integers(0, nj, n)

    proj = np.zeros((3, 3, 4), np.float32)
    proj[:, 0, 0] = proj[:, 1, 1] = 2.0
    proj[:, 2, 2] = 1.0
    proj[:, 2, 3] = 5.0
    robust = JLoss(alpha=0.5, c=0.7)
    target_state = char.skeleton_states(jnp.asarray(rng.uniform(-0.3, 0.3, p), jnp.float32))
    return {
        "aim_dist": (jerr.AimDistErrorFunction.create(parents(3), p3(3), _unit(rng, 3),
                                                      p3(3) * 2), None, 0.3),
        "aim_dir": (jerr.AimDirErrorFunction.create(parents(3), p3(3), _unit(rng, 3),
                                                    p3(3) * 2, loss=robust), None, 0.3),
        "fixed_axis_diff": (jerr.FixedAxisDiffErrorFunction.create(
            parents(3), _unit(rng, 3), _unit(rng, 3)), None, 0.3),
        "fixed_axis_cos": (jerr.FixedAxisCosErrorFunction.create(
            parents(3), _unit(rng, 3), _unit(rng, 3)), None, 0.3),
        "fixed_axis_angle": (jerr.FixedAxisAngleErrorFunction.create(
            parents(3), _unit(rng, 3), _unit(rng, 3)), None, 0.3),
        "plane": (jerr.PlaneErrorFunction.create(parents(3), p3(3), _unit(rng, 3),
                                                 rng.uniform(-1, 1, 3)), None, 0.3),
        "plane_half": (jerr.PlaneErrorFunction.create(parents(3), p3(3), _unit(rng, 3),
                                                      rng.uniform(-1, 1, 3), half_plane=True),
                       None, 0.3),
        "normal": (jerr.NormalErrorFunction.create(parents(3), p3(3), _unit(rng, 3), p3(3)),
                   None, 0.3),
        "distance": (jerr.DistanceErrorFunction.create(parents(3), p3(3), p3(3) * 3,
                                                       rng.uniform(0.5, 2.0, 3)), None, 0.3),
        "projection": (jerr.ProjectionErrorFunction.create(
            parents(3), p3(3), proj, rng.uniform(-0.5, 0.5, (3, 2)), near_clip=0.01),
            None, 0.3),
        "j2j_position": (jerr.JointToJointPositionErrorFunction.create(
            [nj - 1, nj - 2], [0, 1], p3(2), p3(2), p3(2)), None, 0.3),
        "j2j_distance": (jerr.JointToJointDistanceErrorFunction.create(
            [nj - 1, nj - 2], [0, 1], p3(2), p3(2), rng.uniform(0.5, 2.0, 2)), None, 0.3),
        "j2j_orientation": (jerr.JointToJointOrientationErrorFunction.create(
            [nj - 1], [0], _quat(rng, 1)), None, 0.3),
        "j2j_orientation_two": (jerr.JointToJointOrientationErrorFunction.create(
            [nj - 1, nj - 2], [0, 1], _quat(rng, 2)), None, 0.3),
        "state": (jerr.StateErrorFunction.create(
            target_state, position_weight=rng.uniform(0.5, 2, nj),
            rotation_weight=rng.uniform(0.5, 2, nj), pos_wgt=2.0, rot_wgt=0.5), None, 0.3),
        "state_logmap": (jerr.StateErrorFunction.create(target_state,
                                                        rotation_error_type="logmap"),
                         None, 0.3),
        "position": (jerr.PositionErrorFunction.create(parents(4), p3(4), p3(4) * 2),
                     None, 0.3),
        "orientation": (jerr.OrientationErrorFunction.create(parents(2), _quat(rng, 2)),
                        None, 0.3),
        "collision": (jerr.CollisionErrorFunction.create(_collision_char()), _collision_char(),
                      1.2),
        "plane_collision": (jerr.PlaneCollisionErrorFunction.create(
            char, plane_offset=-0.5), None, 1.2),
        "camera_projection": (jerr.CameraProjectionErrorFunction.create(
            _camera(), parents(3), p3(3), rng.normal(0, 50, (3, 2)) + 300.0), None, 0.3),
        "union": (jerr.UnionErrorFunction(children=(
            jerr.PositionErrorFunction.create(parents(2), p3(2), p3(2) * 2),
            jerr.ModelParametersErrorFunction.create(rng.uniform(-0.2, 0.2, p)),
            jerr.DistanceErrorFunction.create(parents(2), p3(2), p3(2), [0.5, 1.0])),
            weight=jnp.asarray(1.5)), None, 0.3),
    }


CASES = sorted(_cases())
# the port's analytic modules: JAX's camera projection goes by forward mode,
# the port's (a pinhole here) has an analytic Jacobian
ANALYTIC = [c for c in CASES if c not in ("state_logmap", "plane_collision", "union")]
APPROXIMATE = ("collision",)


def _poses(tfn, scale, n=3, seed=7):
    """n poses N(0, scale) at which the module is active (energy > 1e-10),
    the first of 256 draws (test_error_catalog.py's _active_pose)."""
    x = np.random.default_rng(seed).normal(
        0, scale, (256, tfn.character.num_model_parameters)).astype(np.float32)
    active = np.nonzero(tfn.error(torch.as_tensor(x)).numpy() > 1e-10)[0]
    assert len(active) >= n
    return x[active[:n]]


def _setup(name):
    jef, jchar, scale = _cases()[name]
    jchar = jchar or jax_test_character(4)
    return jef, jchar, to_port(jef), port_character(jchar), scale


def _close_jac(got, want, tol=JAC_TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("name", CASES)
def test_module_matches_jax(name):
    """Rows, energy and model-space Jacobian at three poses, against JAX's
    (its Jacobian through the same branch: analytic or forward mode)."""
    jef, jchar, tef, tchar, scale = _setup(name)
    jfn, tfn = JSSF(jchar, (jef,)), TSSF(tchar, (tef,))
    x = _poses(tfn, scale)
    assert tfn.fully_analytic == (name in ANALYTIC)
    xt = torch.as_tensor(x)
    j_rows = jax.jit(jax.vmap(jfn.residual))(jnp.asarray(x))
    np.testing.assert_allclose(tfn.residual(xt).numpy(), np.asarray(j_rows), **ROW_TOL)
    np.testing.assert_allclose(tfn.error(xt).numpy(),
                               np.asarray(jax.jit(jax.vmap(jfn.error))(jnp.asarray(x))),
                               rtol=1e-4, atol=1e-7)
    if name == "j2j_orientation_two":  # JAX's analytic form takes one constraint (F16)
        j_jac = jax.jit(jax.vmap(jax.jacfwd(jfn.residual)))(jnp.asarray(x))
    else:
        _, j_jac = jax.jit(jax.vmap(jfn.residual_and_jacobian))(jnp.asarray(x))
    t_rows, t_jac = tfn.residual_and_jacobian(xt)
    np.testing.assert_allclose(t_rows.numpy(), np.asarray(j_rows), **ROW_TOL)
    _close_jac(t_jac.numpy(), j_jac)


def _double(obj):
    """obj with every float tensor (and its dataclasses') in float64."""
    if isinstance(obj, torch.Tensor):
        return obj.double() if obj.is_floating_point() else obj
    if isinstance(obj, tuple):
        return tuple(_double(v) for v in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{f.name: _double(getattr(obj, f.name))
                                           for f in dataclasses.fields(obj)})
    return obj


def _fd_check(fn, x, approximate=False):
    """The analytic Jacobian against central differences of the rows, to
    FD_TOL of max|J|; an approximate one by its gradient 2·Jᵀr against
    central differences of the energy, to FD_APPROX_TOL of
    max(1, max|∇E|) (test_error_catalog.py's check)."""
    rows, jac = fn.residual_and_jacobian(x)
    h = 1e-6
    eye = torch.eye(x.shape[-1], dtype=torch.float64)
    if not approximate:
        fd = torch.stack([(fn.residual(x + h * e) - fn.residual(x - h * e)) / (2 * h)
                          for e in eye], dim=-1)
        _close_jac(jac.numpy(), fd.numpy(), FD_TOL)
        return
    g = (2.0 * jac.T @ rows).numpy()
    g_fd = np.asarray([float(fn.error(x + h * e) - fn.error(x - h * e)) / (2 * h) for e in eye])
    scale = max(1.0, np.abs(g_fd).max())
    np.testing.assert_allclose(g / scale, g_fd / scale, atol=FD_APPROX_TOL)


@pytest.mark.parametrize("name", ANALYTIC)
def test_analytic_jacobian_matches_finite_differences(name):
    """Every analytic Jacobian against float64 central differences, with an
    L2 loss (a robust loss's row scale is held fixed in the Jacobian, as
    JAX's stop_gradient does); the frozen-parameter approximation
    (collision) by its gradient."""
    jef, jchar, tef, tchar, scale = _setup(name)
    x = torch.as_tensor(_poses(TSSF(tchar, (tef,)), scale, n=1)[0], dtype=torch.float64)
    if hasattr(tef, "loss"):
        tef = dataclasses.replace(tef, loss=TLoss())
    fn = TSSF(_double(tchar), (_double(tef),))
    assert fn.fully_analytic
    _fd_check(fn, x, approximate=name in APPROXIMATE)


LIMIT_CASES = {  # test_error_catalog.py:284-296
    "minmax": dict(minmax=[(3, -0.05, 0.05, 1.0), (7, -0.02, 0.1, 2.0)]),
    "minmax_joint": dict(minmax_joint=[(1, 3, -0.05, 0.05, 1.5, 0.0),
                                       (2, 3, -0.1, 0.02, 1.0, 0.0)]),
    "linear": dict(linear=[(7, 8, 0.5, 0.1, -10.0, 10.0, 1.0),
                           (3, 4, -1.0, 0.0, -10.0, 10.0, 2.0)]),
    "linear_ranged": dict(linear=[(7, 8, 0.5, 0.1, -0.05, 0.05, 1.0)]),
    "linear_joint": dict(linear_joint=[(1 * 7 + 3, 2 * 7 + 3, 0.7, 0.05, -10.0, 10.0, 1.0)]),
    "halfplane": dict(halfplane=[(3, 7, 0.8, 0.6, 0.05, 1.0)]),
    "ellipsoid": dict(ellipsoid=[(3, 0, (0.1, 0.8, 0.0), np.diag([0.5, 0.7, 0.6, 1.0]), 1.0)]),
}


@pytest.mark.parametrize("case", sorted(LIMIT_CASES))
def test_limit_record_type_through_the_bridge(case):
    """Each record type of test_error_catalog.py's sweep, its character
    carried by the bridge: the tables equal JAX's, rows, energy and
    Jacobian against JAX's at three poses (the normal equations too), and
    float64 central differences (the ellipsoid's frozen projection to the
    scaled tolerance); make_limits builds the same tables."""
    jchar = dataclasses.replace(jax_test_character(4), limits=jmake_limits(**LIMIT_CASES[case]))
    tchar = port_character(jchar)
    from momentum_tpu_torch.character import make_limits

    direct = make_limits(**LIMIT_CASES[case], device="cpu")
    for k, v in character_to_numpy(jchar).items():
        if hasattr(direct, k):
            np.testing.assert_array_equal(getattr(tchar.limits, k).numpy(), v, k)
            np.testing.assert_array_equal(getattr(direct, k).numpy(), v, k)
    jfn = JSSF(jchar, (jerr.LimitErrorFunction.create(),))
    tfn = TSSF(tchar, (terr.LimitErrorFunction.create(device="cpu"),))
    x = _poses(tfn, 0.6, seed=11)
    xt = torch.as_tensor(x)
    want = np.asarray(jax.jit(jax.vmap(jfn.error))(jnp.asarray(x)))
    assert float(want.min()) > 0
    np.testing.assert_allclose(tfn.error(xt).numpy(), want, rtol=1e-4)
    j_rows, j_jac = jax.jit(jax.vmap(jfn.residual_and_jacobian))(jnp.asarray(x))
    t_rows, t_jac = tfn.residual_and_jacobian(xt)
    np.testing.assert_allclose(t_rows.numpy(), np.asarray(j_rows), **ROW_TOL)
    _close_jac(t_jac.numpy(), j_jac)
    if tfn.has_structured_modules:
        jtj, jtr, sq = tfn.normal_equations(xt)
        j64 = t_jac.double()
        np.testing.assert_allclose(jtj.numpy(), (j64.transpose(-1, -2) @ j64).numpy(),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(jtr.numpy(), (j64.transpose(-1, -2)
                                                 @ t_rows.double()[..., None])[..., 0].numpy(),
                                   rtol=1e-5, atol=1e-5)
    fn64 = TSSF(_double(tchar), (terr.LimitErrorFunction.create(device="cpu"),))
    _fd_check(fn64, torch.as_tensor(x[0], dtype=torch.float64), approximate=case == "ellipsoid")


def test_limit_tables_concat_and_create():
    """concat_limits and the create_* helpers give JAX's tables."""
    from momentum_tpu.character import limits as jl
    from momentum_tpu_torch.character import limits as tl

    ell = np.diag([0.5, 0.7, 0.6, 1.0])
    calls = [("create_minmax", (3, -0.1, 0.2, 2.0)), ("create_minmax_joint", (1, 3, -0.1, 0.1)),
             ("create_linear", (7, 8, 0.5, 0.1, 2.0, -0.3, 0.4)),
             ("create_linear_joint", (1, 3, 2, 4, 0.7, 0.05)),
             ("create_halfplane", (3, 7, (0.8, 0.6), 0.05)),
             ("create_ellipsoid", (0, 3, (0.1, 0.8, 0.0), ell))]
    jall = tall = None
    for name, args in calls:
        j, t = getattr(jl, name)(*args), getattr(tl, name)(*args, device="cpu")
        jall = j if jall is None else jl.concat_limits(jall, j)
        tall = t if tall is None else tl.concat_limits(tall, t)
    assert tall.counts == jall.counts
    for f in dataclasses.fields(tall):
        np.testing.assert_array_equal(getattr(tall, f.name).numpy(),
                                      np.asarray(getattr(jall, f.name)), f.name)


@pytest.mark.parametrize("which", ["test_rig", "fat_capsules", "catalog"])
def test_collision_valid_pairs_match_jax(which):
    """compute_valid_pairs gives JAX's pair list: the test rig's capsules
    (neighbours overlap at rest), the fat-capsule rig, config C's ten."""
    if which == "catalog":
        import sys
        import pathlib

        sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "tools"))
        import jax_reference
        from momentum_tpu_torch.testing.workloads import catalog_character

        jchar, tchar = jax_reference.catalog_character(), catalog_character(device="cpu")
    else:
        jchar = jax_test_character(4) if which == "test_rig" else _collision_char()
        tchar = port_character(jchar)
    want = jerr.compute_valid_pairs(jchar)
    got = terr.compute_valid_pairs(tchar)
    np.testing.assert_array_equal(got, want)
    if which == "catalog":
        assert len(got) >= 20


def test_port_fixture_carries_the_jax_capsules():
    from momentum_tpu_torch.testing.fixtures import create_test_character

    jcol = jax_test_character(5).collision
    tcol = create_test_character(5, device="cpu").collision
    for k in ("parent", "transform", "radius", "length"):
        np.testing.assert_array_equal(getattr(tcol, k).numpy(), np.asarray(getattr(jcol, k)))
    assert tcol.ptype is None and jcol.ptype is None


def test_closest_points_on_segments_match_jax():
    """Crossing, parallel, degenerate (point) and clamped segment pairs."""
    from momentum_tpu.math.geometry import closest_points_on_segments as jcp
    from momentum_tpu_torch.math.geometry import closest_points_on_segments as tcp

    rng = np.random.default_rng(3)
    o1, d1, o2, d2 = (rng.normal(size=(64, 3)).astype(np.float32) for _ in range(4))
    d2[:8] = d1[:8] * 0.5  # parallel
    d1[8:16] = 0.0  # a point
    d1[16:20] = d2[16:20] = 0.0  # two points
    want = jcp(*(jnp.asarray(a) for a in (o1, d1, o2, d2)))
    got = tcp(*(torch.as_tensor(a) for a in (o1, d1, o2, d2)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)


def test_fused_point_jacobian_unmerged_matches_merged_and_jax():
    """fused_point_jacobian_model (the unmerged form) against the merged
    one, against JAX's, and against the joint-space point Jacobian chained
    through the parameter transform."""
    jchar = jax_test_character(5)
    tchar = port_character(jchar)
    rng = np.random.default_rng(5)
    p = jchar.num_model_parameters
    x = rng.uniform(-0.4, 0.4, (2, p)).astype(np.float32)
    parents = np.asarray([0, 2, 4, 3], np.int32)
    pts = rng.normal(0, 1, (2, 4, 3)).astype(np.float32)
    scale = rng.uniform(0.5, 2.0, (2, 4)).astype(np.float32)
    tfn = TSSF(tchar, ())
    ctx = tfn.context(torch.as_tensor(x))
    jc = taj.make_jacobian_context(tchar, ctx)
    pt = tchar.parameter_transform.transform
    args = (jc, torch.as_tensor(pts), torch.as_tensor(parents), pt)
    unmerged = taj.fused_point_jacobian_model(*args, scale=torch.as_tensor(scale))
    merged = taj.fused_point_jacobian_model_merged(*args, scale=torch.as_tensor(scale))
    _close_jac(unmerged.numpy(), merged.numpy(), 1e-5)
    chained = (taj.point_jacobian(jc, torch.as_tensor(pts), torch.as_tensor(parents)) @ pt)
    _close_jac(unmerged.numpy(), (torch.as_tensor(scale)[..., None, None] * chained).numpy(),
               1e-5)
    jfn = JSSF(jchar, ())

    def jax_fused(xe, pe, se):
        c = jfn.context(xe)
        return jaj.fused_point_jacobian_model(jaj.make_jacobian_context(jchar, c), pe,
                                              jnp.asarray(parents),
                                              jchar.parameter_transform.transform, scale=se)

    want = jax.vmap(jax_fused)(jnp.asarray(x), jnp.asarray(pts), jnp.asarray(scale))
    _close_jac(unmerged.numpy(), want, 1e-5)


@pytest.mark.parametrize("name", ["position", "orientation"])
def test_position_family_joint_space_jacobian(name):
    """PositionErrorFunction.jacobian and OrientationErrorFunction.jacobian
    (the joint-space forms) against JAX's, and chained through the
    parameter transform against the fused jacobian_model the solver takes."""
    jef, jchar, tef, tchar, scale = _setup(name)
    tfn, jfn = TSSF(tchar, (tef,)), JSSF(jchar, (jef,))
    x = _poses(tfn, scale)
    ctx = tfn.context(torch.as_tensor(x))
    jc = taj.make_jacobian_context(tchar, ctx)
    rows, j_jp, j_model = tef.jacobian(tchar, ctx, jc)
    assert j_model is None
    f_rows, f_jac = tef.jacobian_model(tchar, ctx, jc, tchar.parameter_transform.transform)
    np.testing.assert_allclose(rows.numpy(), f_rows.numpy(), **ROW_TOL)
    _close_jac((j_jp @ tchar.parameter_transform.transform).numpy(), f_jac.numpy())

    def jax_joint(xe):
        c = jfn.context(xe)
        return jef.jacobian(jchar, c, jaj.make_jacobian_context(jchar, c))[:2]

    want_rows, want_jp = jax.vmap(jax_joint)(jnp.asarray(x))
    np.testing.assert_allclose(rows.numpy(), np.asarray(want_rows), **ROW_TOL)
    _close_jac(j_jp.numpy(), want_jp)


def test_union_weight_and_mesh_flag():
    """Union's energy is weight × the children's sum, its rows theirs times
    sqrt(weight); needs_mesh follows the children."""
    jef, jchar, tef, tchar, _ = _setup("union")
    x = torch.as_tensor(_poses(TSSF(tchar, (tef,)), 0.3))
    ctx = TSSF(tchar, (tef,)).context(x)
    kids = sum(c.error(tchar, ctx) for c in tef.children)
    np.testing.assert_allclose(tef.error(tchar, ctx).numpy(), (1.5 * kids).numpy(), rtol=1e-6)
    rows = torch.cat([c.residual(tchar, ctx) for c in tef.children], dim=-1)
    np.testing.assert_allclose(tef.residual(tchar, ctx).numpy(),
                               (np.sqrt(1.5) * rows).numpy(), rtol=1e-6)
    assert tef.num_rows() == sum(c.num_rows() for c in tef.children)
    assert not tef.needs_mesh
    vert = terr.VertexPositionErrorFunction.create([0], np.zeros((1, 3)), device="cpu")
    assert terr.UnionErrorFunction(children=(vert,)).needs_mesh

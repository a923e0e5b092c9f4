"""Parity of the port's retargeting and character surgery with momentum_tpu
on the CPU: inverse FK (away from and near the gimbal branch),
transform_pose (ROADMAP F25), torch_interop.transform_pose, every function
of character/utility.py, the Character, ParameterTransform, Skeleton,
Locators, Mesh and PhysicalProperties members, the limit remaps (all seven
record types through the bridge), compat's every name,
texture_classification, the bridge's round trip of a character with every
field set, and config U's recipes, U4's tables and a U3-shaped solve at
B = 8 against JAX's.

Tolerances: surgery tables exactly equal (host numpy on the same float32
arrays), inverse bind poses 1e-6 (FK in each package); inverse FK's joint
parameters 1e-5 away from the gimbal branch, re-FK'd positions 1e-5 near it
(float32 rounding there may take the other branch); transform_pose 1e-5
(JAX's test move); FK and skinning 1e-5; the U3-shaped LM's energies 1e-3
relative where they stand above float32 roundoff (LM 2; the elements still
moving at LM 5), under 1e-10 in both where JAX's converged.
"""

import dataclasses
import pathlib
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import momentum_tpu.compat as jcompat
from momentum_tpu import errors as jerr
from momentum_tpu.character import utility as ju
from momentum_tpu.character.character import (
    Character as JCharacter, Locators as JLocators, PhysicalProperties as JPP)
from momentum_tpu.character.inverse_fk import (
    joint_parameters_from_local_skel_states as jlocal_jp,
    joint_parameters_from_skeleton_states as jinv, local_from_global as jlocal)
from momentum_tpu.character.limits import (
    make_empty_limits as jempty, make_limits as jmake_limits, map_limits as jmap_limits,
    remap_limits_model_parameters as jremap)
from momentum_tpu.character.parameter_transform import (
    ParameterTransform as JPT, make_identity_transform as jidentity)
from momentum_tpu.character.skeleton import make_skeleton as jmake_skeleton
from momentum_tpu.character.texture_classification import (
    classify_triangles_by_texture as jclassify, split_mesh_by_texture_region as jsplit)
from momentum_tpu.character.transform_pose import transform_pose as jtransform_pose
from momentum_tpu.math import quaternion as jq, skel_state as jss
from momentum_tpu.solver import SkeletonSolverFunction as JFn, SolverOptions as JOpts
from momentum_tpu.solver.ik import solve_ik as jsolve_ik
from momentum_tpu.testing.fixtures import create_test_character
import momentum_tpu_torch.compat as tcompat
from momentum_tpu_torch import bridge, torch_interop
from momentum_tpu_torch.character import utility as tu
from momentum_tpu_torch.character.character import (
    Character as TCharacter, Locators as TLocators, Mesh as TMesh, PhysicalProperties as TPP)
from momentum_tpu_torch.character.inverse_fk import (
    joint_parameters_from_local_skel_states as tlocal_jp,
    joint_parameters_from_skeleton_states as tinv, local_from_global as tlocal)
from momentum_tpu_torch.character.limits import (
    make_empty_limits as tempty, map_limits as tmap_limits,
    remap_limits_model_parameters as tremap)
from momentum_tpu_torch.character.parameter_transform import (
    ParameterTransform as TPT, make_identity_transform as tidentity)
from momentum_tpu_torch.character.skeleton import Skeleton as TSkeleton, make_skeleton
from momentum_tpu_torch.character.skinning import SkinWeights as TSkinWeights
from momentum_tpu_torch.math.generalized_loss import GeneralizedLoss as TGeneralizedLoss
from momentum_tpu_torch.character.texture_classification import (
    classify_triangles_by_texture as tclassify, split_mesh_by_texture_region as tsplit)
from momentum_tpu_torch.character.transform_pose import transform_pose as ttransform_pose
from momentum_tpu_torch.errors import CenterOfMassErrorFunction as TCom, PositionErrorFunction
from momentum_tpu_torch.math import quaternion as tq, skel_state as tss
from momentum_tpu_torch.solver import (
    SkeletonSolverFunction as TFn, SolverOptions as TOpts, solve_ik as tsolve_ik)
from momentum_tpu_torch.testing import workloads as twork
from test_torch_port_helpers import LIMIT_KEYS, character_to_numpy, jax_fullbody_character
from test_torch_port_helpers import one_torch_thread  # noqa: F401

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "tools"))
import jax_reference  # noqa: E402

FK_TOL = 1e-5


def T(a):
    return torch.as_tensor(np.array(a))


def J(a):
    return jnp.asarray(np.asarray(a))


def _np(x):
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def full_jax_character(num_joints=5):
    """The JAX test rig with every field the bridge carries set: bodies,
    the locators' optional fields, a textured mesh with confidence and
    polylines, all seven limit record types, a blend shape, parameter sets,
    pose constraints, a name and metadata."""
    base = create_test_character(num_joints)
    skel = base.skeleton
    nj, p = skel.num_joints, base.num_model_parameters
    rng = np.random.default_rng(5)
    bodies = twork.utility_bodies(np.asarray(skel.joint_parent),
                                  np.asarray(skel.translation_offset))
    loc = base.locators
    n_loc = loc.num_locators
    locators = dataclasses.replace(
        loc, locked=J(rng.integers(0, 2, (n_loc, 3)).astype(np.float32)),
        limit_weight=J(rng.uniform(0, 1, (n_loc, 3)).astype(np.float32)),
        limit_origin=J(rng.normal(size=(n_loc, 3)).astype(np.float32)),
        attached_to_skin=J(rng.integers(0, 2, n_loc).astype(np.float32)),
        skin_offset=J(rng.uniform(0, 0.1, n_loc).astype(np.float32)))
    v, f = base.mesh.num_vertices, base.mesh.faces.shape[0]
    mesh = dataclasses.replace(
        base.mesh, texcoords=J(rng.uniform(0, 1, (v, 2)).astype(np.float32)),
        colors=J(rng.uniform(0, 1, (v, 3)).astype(np.float32)),
        normals=J(rng.normal(size=(v, 3)).astype(np.float32)),
        confidence=J(rng.uniform(0, 1, v).astype(np.float32)),
        lines=(J(np.asarray([0, 1, 2], np.int32)),), texcoord_lines=(J(np.asarray([3, 4],
                                                                                np.int32)),))
    ell = np.eye(4, dtype=np.float32)
    ell[:3, :3] = np.diag([0.5, 0.3, 0.4])
    ell[:3, 3] = [0.2, 0.0, 0.1]
    limits = jmake_limits(
        minmax=[(1, -1.0, 1.0, 1.0), (7, -0.5, 0.5, 2.0), (p - 1, -0.3, 0.3, 1.0)],
        minmax_joint=[(1, 3, -0.3, 0.3, 1.0, 0.0), (2, 3, -0.2, 0.2, 1.0, 1.0)],
        linear=[(7, 9, 0.5, 0.1, -1.0, 1.0, 1.0)],
        linear_joint=[(1 * 7 + 3, (nj - 1) * 7 + 3, 0.5, 0.0, -3e38, 3e38, 1.0)],
        halfplane=[(9, 10, 0.6, 0.8, -0.1, 1.0)],
        ellipsoid=[(nj - 1, 0, np.asarray([0.1, 0.0, 0.0], np.float32), ell, 1.0)])
    from momentum_tpu.character.blend_shape import BlendShape

    shape = BlendShape(base_shape=base.mesh.vertices,
                       shape_vectors=J(rng.normal(size=(2, v, 3)).astype(np.float32) * 0.05))
    pt = dataclasses.replace(base.parameter_transform,
                             parameter_sets={"scaling": (6,), "arms": (7, 9)})
    char = dataclasses.replace(
        base, parameter_transform=pt, mesh=mesh, locators=locators, limits=limits,
        physical_properties=JPP(**{k: J(val) for k, val in bodies.items()},
                                joint_names=skel.joint_names),
        name="full", metadata='{"subject": 7}')
    char = ju.add_blend_shape_parameters(char, shape)
    return dataclasses.replace(char, parameter_transform=dataclasses.replace(
        char.parameter_transform, pose_constraints={"rest": ((7, 0.0), (9, 0.25))}))


def to_port(jchar):
    return bridge.character_from_numpy(character_to_numpy(jchar, names=True), device="cpu")


@pytest.fixture(scope="module")
def rigs():
    j = full_jax_character()
    return j, to_port(j)


def assert_tables_equal(tchar, jchar, ibp_tol=1e-6, computed=()):
    """Every table the bridge carries exactly equal (the inverse bind pose,
    and the tables named in `computed`, within ibp_tol), names too."""
    a, b = character_to_numpy(tchar, names=True), character_to_numpy(jchar, names=True)
    assert sorted(a) == sorted(b)
    for k in a:
        if k == "inverse_bind_pose" or k in computed:
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=ibp_tol, err_msg=k)
        elif isinstance(a[k], np.ndarray):
            assert a[k].dtype.kind == np.asarray(b[k]).dtype.kind, k
            np.testing.assert_array_equal(a[k], np.asarray(b[k]), err_msg=k)
        elif k in ("mesh_lines", "mesh_texcoord_lines"):
            for x, y in zip(a[k], b[k]):
                np.testing.assert_array_equal(x, y)
        elif k == "parameter_sets":
            assert {n: v.tolist() for n, v in a[k].items()} == \
                {n: v.tolist() for n, v in b[k].items()}
        else:
            assert a[k] == b[k], k
    assert tchar.parameter_transform.parameter_sets == dict(
        jchar.parameter_transform.parameter_sets)
    assert tchar.name == jchar.name and tchar.metadata == jchar.metadata
    for k in ("blend_shape_param_index", "face_expression_param_index"):
        assert getattr(tchar, k) == getattr(jchar, k), k


def _params(char, n, seed=0, amp=0.4):
    return np.random.default_rng(seed).uniform(-amp, amp, (n, char.num_model_parameters)) \
        .astype(np.float32)


# ---- the bridge ----

def test_bridge_round_trip_of_every_field(rigs):
    j, t = rigs
    assert_tables_equal(t, j, ibp_tol=0.0)
    assert t.parameter_transform.pose_constraints == {"rest": ((7, 0.0), (9, 0.25))}
    assert t.physical_properties.joint_names == j.physical_properties.joint_names
    assert len(t.mesh.texcoord_lines) == 1 and t.mesh.confidence is not None


def test_bridge_covariance():
    from momentum_tpu.math.covariance import LowRankCovarianceMatrix as JCov

    a = np.random.default_rng(1).normal(size=(3, 7)).astype(np.float32)
    jc = JCov.create(0.5, a)
    tc = bridge.covariance_from_numpy(dict(a=np.asarray(jc.a), sigma=np.asarray(jc.sigma)),
                                      device="cpu")
    np.testing.assert_array_equal(tc.a.numpy(), np.asarray(jc.a))
    assert float(tc.sigma) == float(jc.sigma)


# ---- inverse FK ----

@pytest.mark.parametrize("form", ["global", "local_from_global", "local"])
def test_inverse_fk_away_from_the_gimbal_branch(rigs, form):
    j, t = rigs
    x = _params(j, 16, 1)
    jp_j = jax.vmap(j.parameter_transform.apply)(J(x))
    states_j = jax.vmap(j.skeleton_states)(J(x))
    states_t = t.skeleton_states(T(x))
    np.testing.assert_allclose(states_t.numpy(), np.asarray(states_j), atol=FK_TOL)
    if form == "global":
        got, want = tinv(t.skeleton, T(states_j)), jinv(j.skeleton, states_j)
        np.testing.assert_allclose(_np(got), np.asarray(jp_j), atol=1e-5)
    elif form == "local_from_global":
        got, want = tlocal(t.skeleton, T(states_j)), jlocal(j.skeleton, states_j)
    else:
        local = jcompat.model_parameters_to_local_skeleton_state(j, J(x))
        got, want = tlocal_jp(t.skeleton, T(local)), jlocal_jp(j.skeleton, local)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("ry", [np.pi / 2, -np.pi / 2, np.pi / 2 - 1e-4, -np.pi / 2 + 3e-4])
def test_inverse_fk_near_the_gimbal_branch(rigs, ry):
    """At and near ry = ±π/2 the branch pins rz = 0 and float32 rounding may
    take either side: the re-FK'd states are held, not the angles. Within
    the branch's 1e-6 band of |sin ry| = 1 (the two near cases) the pinned
    decomposition drops O(1e-4) of the rotation in both packages, so there
    the port's re-FK is held to JAX's; at ±π/2 both to the states."""
    j, t = rigs
    jp = np.asarray(jax.vmap(j.parameter_transform.apply)(J(_params(j, 4, 2)))).copy()
    jp[:, 1 * 7 + 4] = ry  # joint 1's ry
    jp[:, 1 * 7 + 5] = 0.3
    states = jax.vmap(lambda q: jcompat.joint_parameters_to_skeleton_state(j, q))(J(jp))
    back_t = tinv(t.skeleton, T(states))
    back_j = jinv(j.skeleton, states)
    again_t = tcompat.joint_parameters_to_skeleton_state(t, back_t)
    again_j = jax.vmap(lambda q: jcompat.joint_parameters_to_skeleton_state(j, q))(back_j)
    refs = [np.asarray(again_j)] + ([np.asarray(states)] if abs(ry) == np.pi / 2 else [])
    for ref in refs:
        np.testing.assert_allclose(_np(again_t)[..., :3], ref[..., :3], atol=1e-5)
        np.testing.assert_allclose(np.abs(np.sum(_np(again_t)[..., 3:7] * ref[..., 3:7], -1)),
                                   1.0, atol=1e-5)


# ---- transform_pose ----

def _jax_test_move():
    q = jq.from_axis_angle(jnp.asarray([0.2, 0.1, -0.3]))
    return jss.join(jnp.asarray([1.0, 2.0, -0.5]), q, jnp.ones(1))


def test_transform_pose_matches_jax_at_its_test_move(rigs):
    j, t = rigs
    x = _params(j, 8, 3, amp=0.3)
    xf = _jax_test_move()
    want = np.asarray(jtransform_pose(j, J(x), xf))
    got = ttransform_pose(t, T(x), T(xf))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    moved = t.skeleton_states(got)
    expected = tss.multiply(T(xf), t.skeleton_states(T(x)))
    np.testing.assert_allclose(moved[..., :3].numpy(), expected[..., :3].numpy(), atol=1e-5)
    batched = ttransform_pose(t, T(x[:4].reshape(2, 2, -1)), T(xf))
    assert batched.shape == (2, 2, x.shape[1])
    np.testing.assert_allclose(batched.reshape(4, -1).numpy(), got[:4].numpy(), atol=1e-6)


def test_torch_interop_transform_pose_takes_both_forms(rigs):
    j, t = rigs
    x = _params(j, 8, 4, amp=0.3)
    xf = _jax_test_move()
    m = jss.to_matrix(xf)
    want = np.asarray(jtransform_pose(j, J(x), jss.from_matrix(m)))
    got_m = torch_interop.transform_pose(t, T(x), T(m))
    got_s = torch_interop.transform_pose(t, T(x), T(xf))
    np.testing.assert_allclose(got_m.numpy(), want, atol=1e-5)
    np.testing.assert_allclose(got_m.numpy(), got_s.numpy(), atol=1e-5)


def test_f25_jax_transform_pose_wraps_root_translation():
    """ROADMAP F25: JAX's Euler-continuity step runs over a root's seven
    entries, translations too, so a move of more than π units comes back
    2πk off; the port's steps only the rotation entries, and FK of its
    result is the moved pose."""
    j = create_test_character()
    t = to_port(j)
    x = _params(j, 4, 5, amp=0.3)
    q = jq.from_axis_angle(jnp.asarray([0.2, 0.1, -0.3]))
    xf = jss.join(jnp.asarray([10.0, 0.0, 0.0]), q, jnp.ones(1))
    want = jss.multiply(xf, jax.vmap(j.skeleton_states)(J(x)))
    jax_moved = jax.vmap(j.skeleton_states)(jtransform_pose(j, J(x), xf))
    jax_err = float(jnp.max(jnp.linalg.norm(jax_moved[..., :3] - want[..., :3], axis=-1)))
    port_moved = t.skeleton_states(ttransform_pose(t, T(x), T(xf)))
    port_err = float(np.max(np.linalg.norm(port_moved[..., :3].numpy()
                                           - np.asarray(want)[..., :3], axis=-1)))
    assert jax_err > 1.0
    assert port_err < 1e-5


# ---- Character, ParameterTransform, Skeleton, Locators, Mesh, PhysicalProperties ----

M10_MEMBERS = set()  # every file member is ported (the FBX and URDF ones last)


def _members(cls):
    names = {n for n in dir(cls) if not n.startswith("_")}
    names |= {f.name for f in dataclasses.fields(cls)} if dataclasses.is_dataclass(cls) else set()
    return names


def _error_module_classes():
    """(JAX class, the port's class of that name or None) for every public
    class of every module of momentum_tpu/errors/."""
    import importlib
    import inspect
    import pkgutil

    import momentum_tpu.errors as jerrors

    pairs = []
    for info in pkgutil.iter_modules(jerrors.__path__):
        jmod = importlib.import_module(f"momentum_tpu.errors.{info.name}")
        tmod = importlib.import_module(f"momentum_tpu_torch.errors.{info.name}")
        for name, cls in inspect.getmembers(jmod, inspect.isclass):
            if cls.__module__ == jmod.__name__ and not name.startswith("_"):
                pairs.append((cls, getattr(tmod, name, None)))
    return pairs


_ERROR_CLASSES = _error_module_classes()


@pytest.mark.parametrize("pair", [(JCharacter, TCharacter), (JPT, TPT),
                                  ("Skeleton", TSkeleton), (JLocators, TLocators),
                                  ("Mesh", TMesh), (JPP, TPP), ("SkinWeights", TSkinWeights),
                                  ("GeneralizedLoss", TGeneralizedLoss)] + _ERROR_CLASSES,
                         ids=["Character", "ParameterTransform", "Skeleton", "Locators", "Mesh",
                              "PhysicalProperties", "SkinWeights", "GeneralizedLoss"]
                         + [j.__name__ for j, _ in _ERROR_CLASSES])
def test_class_members_are_jax_members(pair):
    from momentum_tpu.character.character import Mesh as JMesh
    from momentum_tpu.character.skeleton import Skeleton as JSkeleton
    from momentum_tpu.character.skinning import SkinWeights as JSkinWeights
    from momentum_tpu.math.generalized_loss import GeneralizedLoss as JGeneralizedLoss

    jcls, tcls = pair
    jcls = {"Skeleton": JSkeleton, "Mesh": JMesh, "SkinWeights": JSkinWeights,
            "GeneralizedLoss": JGeneralizedLoss}.get(jcls, jcls)
    assert tcls is not None, f"the port has no {jcls.__name__}"
    # prefix_schedule: the TPU lifting schedule, on ROADMAP's "Do not port" list
    missing = _members(jcls) - _members(tcls) - M10_MEMBERS - {"prefix_schedule"}
    assert not missing


def test_physical_properties(rigs):
    j, t = rigs
    jp, tp = j.physical_properties, t.physical_properties
    assert tp.num_bodies == jp.num_bodies
    np.testing.assert_allclose(float(tp.total_mass()), float(jp.total_mass()), rtol=1e-6)
    for a, b in zip(tp.com_constraint(t.num_joints), jp.com_constraint(j.num_joints)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)


def test_center_of_mass_from_physical_properties(rigs):
    j, t = rigs
    x = _params(j, 6, 6)
    target = np.asarray([0.1, 0.9, -0.2], np.float32)
    ef_j = jerr.CenterOfMassErrorFunction.from_physical_properties(j, target, weight=2.0)
    ef_t = TCom.from_physical_properties(t, target, weight=2.0, device="cpu")
    e_j = JFn(j, (ef_j,)).error(J(x))
    e_t = TFn(t, (ef_t,)).error(T(x))
    np.testing.assert_allclose(e_t.numpy(), np.asarray(e_j), rtol=1e-5)
    with pytest.raises(ValueError):
        TCom.from_physical_properties(dataclasses.replace(t, physical_properties=None), target,
                                      device="cpu")


def test_character_queries(rigs):
    j, t = rigs
    x = _params(j, 4, 7)
    np.testing.assert_allclose(t.skel_states(T(x)).numpy(),
                               np.asarray(jax.vmap(j.skel_states)(J(x))), atol=FK_TOL)
    np.testing.assert_allclose(t.pose_mesh(T(x)).numpy(),
                               np.asarray(jax.vmap(j.pose_mesh)(J(x))), atol=FK_TOL)
    np.testing.assert_allclose(t.skin_points(T(x)).numpy(), t.pose_mesh(T(x)).numpy())
    wide = x * 5.0
    np.testing.assert_array_equal(t.apply_model_param_limits(T(wide)).numpy(),
                                  np.asarray(j.apply_model_param_limits(J(wide))))
    names = list(j.locators.names[::-1])
    np.testing.assert_array_equal(t.find_locators(names).numpy(),
                                  np.asarray(j.find_locators(names)))
    with pytest.raises(KeyError):
        t.find_locators(["nope"])
    assert t.has_mesh == j.has_mesh
    assert t.joints_for_parameters([7, 9]) == j.joints_for_parameters([7, 9])
    mask = np.zeros(t.num_model_parameters, bool)
    mask[[0, 10]] = True
    assert t.joints_for_parameters(mask) == j.joints_for_parameters(mask)
    np.testing.assert_array_equal(t.parameters_for_joints([1, 3]),
                                  j.parameters_for_joints([1, 3]))
    assert t.mesh.n_vertices == j.mesh.n_vertices and t.mesh.n_faces == j.mesh.n_faces
    np.testing.assert_array_equal(t.mesh.self_intersections(), j.mesh.self_intersections())


def _setters(c, mod):
    """(label, function of a character) of the with_* updates and the
    member operations that return a character."""
    jax_side = mod is ju
    conv = J if jax_side else T
    loc = c.locators
    return [
        ("with_locators", lambda ch: ch.with_locators(dataclasses.replace(
            loc, offset=loc.offset * 2.0))),
        ("with_collision_geometry", lambda ch: ch.with_collision_geometry(
            dataclasses.replace(ch.collision, length=ch.collision.length + 1.0))),
        ("with_parameter_limits", lambda ch: ch.with_parameter_limits(
            dataclasses.replace(ch.limits, minmax_weight=ch.limits.minmax_weight * 3.0))),
        ("with_name", lambda ch: ch.with_name("renamed")),
        ("with_metadata", lambda ch: ch.with_metadata("meta")),
        ("with_mesh_and_skin_weights", lambda ch: ch.with_mesh_and_skin_weights(
            dataclasses.replace(ch.mesh, vertices=ch.mesh.vertices * 1.5), ch.skin_weights)),
        ("clone", lambda ch: ch.clone()),
        ("rebind_skin", lambda ch: dataclasses.replace(ch, inverse_bind_pose=None)
         .rebind_skin()),
        ("scaled_mass", lambda ch: ch.scaled(1.15, "preserve_mass")),
        ("scaled_density", lambda ch: ch.scaled(0.8, "preserve_density")),
        ("transformed", lambda ch: ch.transformed(conv(np.asarray(
            [0.3, -1.0, 2.0, 0.0, np.sin(0.35), 0.0, np.cos(0.35), 1.0], np.float32)))),
        ("simplify", lambda ch: ch.simplify(np.arange(ch.num_model_parameters) < 8)),
        ("simplify_all", lambda ch: ch.simplify()),
        ("simplify_skeleton", lambda ch: ch.simplify_skeleton([0, 2])),
        ("simplify_parameter_transform", lambda ch: ch.simplify_parameter_transform(
            np.arange(ch.num_model_parameters) % 3 != 1)),
        ("bake_blend_shape", lambda ch: ch.bake_blend_shape(conv(np.asarray([0.5, -0.3],
                                                                            np.float32)))),
        ("remove_joints", lambda ch: mod.remove_joints(ch, ["joint3"])),
        ("remove_joints_index", lambda ch: mod.remove_joints(ch, [2])),
        ("reduce_mesh_by_vertices", lambda ch: mod.reduce_mesh_by_vertices(
            ch, np.arange(ch.mesh.num_vertices) % 4 != 0)),
        ("reduce_mesh_by_faces", lambda ch: mod.reduce_mesh_by_faces(
            ch, np.arange(ch.mesh.faces.shape[0]) % 3 == 0)),
        ("add_rigid_transform_node", lambda ch: mod.add_rigid_transform_node(
            ch, "camera", (0.1, 0.2, 0.3), (0.0, 0.0, np.sin(0.2), np.cos(0.2)))[0]),
        ("simplify_parameter_transform_fn", lambda ch: mod.simplify_parameter_transform(
            ch, np.arange(ch.num_model_parameters) != 7)),
    ]


SETTERS = [
    "with_locators", "with_collision_geometry", "with_parameter_limits", "with_name",
    "with_metadata", "with_mesh_and_skin_weights", "clone", "rebind_skin", "scaled_mass",
    "scaled_density", "transformed", "simplify", "simplify_all", "simplify_skeleton",
    "simplify_parameter_transform", "bake_blend_shape", "remove_joints", "remove_joints_index",
    "reduce_mesh_by_vertices", "reduce_mesh_by_faces", "add_rigid_transform_node",
    "simplify_parameter_transform_fn"]


@pytest.mark.parametrize("label", SETTERS)
def test_character_surgery_tables_equal(rigs, label):
    j, t = rigs
    fj = dict(_setters(j, ju))[label]
    ft = dict(_setters(t, tu))[label]
    out_j, out_t = fj(j), ft(t)
    # the baked vertices are a blend-shape product (einsum): float32 rounding
    assert_tables_equal(out_t, out_j,
                        computed=("mesh_vertices",) if label == "bake_blend_shape" else ())
    if label == "add_rigid_transform_node":
        assert mod_result(tu, t) == mod_result(ju, j)


def mod_result(mod, ch):
    _, bone, start = mod.add_rigid_transform_node(ch, "camera")
    return bone, start


def test_surgery_keeps_the_device():
    """Host-side surgery returns tensors where it found them (the CPU here;
    tests/test_torch_port_cuda.py holds the card)."""
    t = to_port(full_jax_character())
    out = tu.simplify(t.scaled(1.1), np.arange(t.num_model_parameters) < 9)
    assert out.skeleton.joint_parent.device.type == "cpu"
    assert out.physical_properties.mass.device.type == "cpu"


# ---- utility functions that return arrays ----

def test_active_joint_maps_and_split(rigs):
    j, t = rigs
    en = np.arange(t.num_model_parameters) % 2 == 0
    np.testing.assert_array_equal(tu.parameters_to_active_joints(t.parameter_transform, en),
                                  np.asarray(ju.parameters_to_active_joints(
                                      j.parameter_transform, en)))
    act = np.asarray([True, False, True, False, False])
    np.testing.assert_array_equal(tu.active_joints_to_parameters(t.parameter_transform, act),
                                  np.asarray(ju.active_joints_to_parameters(
                                      j.parameter_transform, act)))
    x = _params(j, 3, 8)
    np.testing.assert_array_equal(tu.split_parameters(t.parameter_transform, T(x), en).numpy(),
                                  np.asarray(ju.split_parameters(j.parameter_transform, J(x),
                                                                 en)))


def test_subset_and_map_parameter_transform(rigs):
    j, t = rigs
    keep = np.arange(t.num_model_parameters) % 4 != 2
    tp, jp = (tu.subset_parameter_transform(t.parameter_transform, keep),
              ju.subset_parameter_transform(j.parameter_transform, keep))
    np.testing.assert_array_equal(tp.transform.numpy(), np.asarray(jp.transform))
    assert tp.names == jp.names and tp.parameter_sets == dict(jp.parameter_sets)
    mapping = [2, -1, 0, 1, 3]
    tm = tu.map_parameter_transform_joints(t.parameter_transform, 4, mapping)
    jm = ju.map_parameter_transform_joints(j.parameter_transform, 4, mapping)
    np.testing.assert_array_equal(tm.transform.numpy(), np.asarray(jm.transform))
    np.testing.assert_array_equal(tm.offsets.numpy(), np.asarray(jm.offsets))
    with pytest.raises(ValueError):
        tu.map_parameter_transform_joints(t.parameter_transform, 2, mapping)


@pytest.mark.parametrize("fps", [(30.0, 30.0), (120.0, 30.0), (30.0, 100.0)])
def test_resample_motion(fps):
    poses = np.random.default_rng(9).normal(size=(11, 4)).astype(np.float32)
    np.testing.assert_array_equal(tu.resample_motion(T(poses), *fps),
                                  ju.resample_motion(poses, *fps))


@pytest.mark.parametrize("case", ["basic", "active", "mismatch", "batched"])
def test_extrapolate_model_parameters(case):
    r = np.random.default_rng(10)
    prev, cur = r.normal(size=(2, 5, 6)).astype(np.float32)
    active = None
    if case == "active":
        active = np.asarray([True, False] * 3)
    if case == "mismatch":
        prev = prev[:, :4]
    if case != "batched":
        prev, cur = prev[0], cur[0]
    got = tu.extrapolate_model_parameters(T(prev), T(cur), active)
    want = ju.extrapolate_model_parameters(J(prev), J(cur), active)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-7)


def test_vertex_face_selections_and_bodies(rigs):
    j, t = rigs
    av = np.arange(t.mesh.num_vertices) % 3 != 0
    np.testing.assert_array_equal(tu.vertices_to_faces(t.mesh, av),
                                  ju.vertices_to_faces(j.mesh, av))
    af = np.arange(t.mesh.faces.shape[0]) % 5 == 0
    np.testing.assert_array_equal(tu.faces_to_vertices(t.mesh, af),
                                  ju.faces_to_vertices(j.mesh, af))
    for policy in ("preserve_mass", "preserve_density"):
        a = tu.scale_physical_properties(t.physical_properties, 1.3, policy)
        b = ju.scale_physical_properties(j.physical_properties, 1.3, policy)
        for k in ("mass", "center_of_mass_offset", "inertia"):
            np.testing.assert_array_equal(getattr(a, k).numpy(), np.asarray(getattr(b, k)))
    with pytest.raises(ValueError):
        tu.scale_physical_properties(t.physical_properties, 1.3, "nope")
    assert tu.scale_physical_properties(None, 2.0) is None


# ---- ParameterTransform and Skeleton members ----

def test_parameter_transform_members(rigs):
    j, t = rigs
    tp, jp = t.parameter_transform, j.parameter_transform
    assert tp.size == jp.size
    for k in ("all_parameters", "no_parameters", "scaling_parameters", "rigid_parameters",
              "blend_shape_parameters", "face_expression_parameters", "pose_parameters"):
        np.testing.assert_array_equal(getattr(tp, k), getattr(jp, k), err_msg=k)
    np.testing.assert_array_equal(tp.find_parameters(["root_tx", "joint1_rx"]),
                                  jp.find_parameters(["root_tx", "joint1_rx"]))
    np.testing.assert_array_equal(tp.find_parameters(["x"], allow_missing=True),
                                  jp.find_parameters(["x"], allow_missing=True))
    with pytest.raises(ValueError):
        tp.find_parameters(["x"])
    np.testing.assert_array_equal(tp.parameters_for_joints([0, 2]),
                                  jp.parameters_for_joints([0, 2]))
    assert tp.parameter_index("shared_rz") == jp.parameter_index("shared_rz")
    np.testing.assert_array_equal(tp.parameter_set("arms"), jp.parameter_set("arms"))
    np.testing.assert_array_equal(tp.parameter_set_mask("arms").numpy(),
                                  np.asarray(jp.parameter_set_mask("arms")))
    for params in ([1, 3], np.arange(tp.size) > 9):
        assert tp.add_parameter_set("new", params).parameter_sets == \
            dict(jp.add_parameter_set("new", params).parameter_sets)
    en = np.arange(tp.size) % 2 == 1
    np.testing.assert_array_equal(tp.active_joint_params().numpy(),
                                  np.asarray(jp.active_joint_params()))
    np.testing.assert_array_equal(tp.active_joint_params(T(en)).numpy(),
                                  np.asarray(jp.active_joint_params(J(en))))
    ti, ji = tidentity(3, device="cpu"), jidentity(3)
    np.testing.assert_array_equal(ti.transform.numpy(), np.asarray(ji.transform))
    assert ti.names == ji.names


def test_parameter_transform_pinv_is_computed_once(rigs):
    """pinv() equals JAX's (numpy's pinv of the same float32 matrix), is
    computed on the first call and reused by every later one; a transform
    made by dataclasses.replace computes its own."""
    j, t = rigs
    tp = t.parameter_transform
    first = tp.pinv()
    np.testing.assert_allclose(first.numpy(), np.asarray(j.parameter_transform.pinv()),
                               rtol=0, atol=1e-6)
    assert tp.pinv() is first and tp.inverse()._pinv is first
    other = dataclasses.replace(tp, transform=2.0 * tp.transform)
    torch.testing.assert_close(other.pinv(), 0.5 * first, rtol=1e-6, atol=1e-7)
    with torch.inference_mode():
        fresh = dataclasses.replace(tp).pinv()
    assert not fresh.is_inference()


def test_skeleton_members():
    names = ["root", "b_spine0", "b_spine1", "l_arm", "r_arm", "hip"]
    parents = [-1, 0, 1, 2, 2, 0]
    js = jmake_skeleton(parents, names=names)
    ts = make_skeleton(parents, names=names, device="cpu")
    assert ts.size == js.size and len(ts) == len(js)
    np.testing.assert_array_equal(ts.joint_parents, js.joint_parents)
    np.testing.assert_array_equal(ts.pre_rotations, js.pre_rotations)
    np.testing.assert_array_equal(ts.offsets, js.offsets)
    for jnt in range(6):
        assert ts.get_parent(jnt) == js.get_parent(jnt)
        for rec in (True, False):
            assert ts.get_child_joints(jnt, rec) == js.get_child_joints(jnt, rec)
        for other in range(6):
            assert ts.is_ancestor(jnt, other) == js.is_ancestor(jnt, other)
            assert ts.common_ancestor(jnt, other) == js.common_ancestor(jnt, other)
    assert ts.upper_body_joints == js.upper_body_joints
    assert ts.joint_index("hip") == js.joint_index("hip")
    ts.validate()
    with pytest.raises(ValueError):
        make_skeleton([-1, 0], names=["a", "b"], device="cpu").upper_body_joints


# ---- limits ----

def test_make_empty_limits():
    assert tempty(device="cpu").counts == jempty().counts


def _limits_equal(tl, jl):
    for k in LIMIT_KEYS:
        a, b = getattr(tl, k).numpy(), np.asarray(getattr(jl, k))
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)


def test_remap_limits_model_parameters(rigs):
    j, t = rigs
    keep = np.ones(t.num_model_parameters, bool)
    keep[[1, 9]] = False  # one MinMax, the Linear and the HalfPlane records lose a parameter
    _limits_equal(tremap(t.limits, keep), jremap(j.limits, keep))


@pytest.mark.parametrize("maps", ["identity", "drop_joint", "drop_parameter", "permute"])
def test_map_limits_every_record_type(rigs, maps):
    j, t = rigs
    nj, p = t.num_joints, t.num_model_parameters
    jm, pm = np.arange(nj), np.arange(p)
    if maps == "drop_joint":
        jm = np.where(jm == nj - 1, -1, jm)
    elif maps == "drop_parameter":
        pm = np.where(pm == 9, -1, pm - (pm > 9))
    elif maps == "permute":
        jm, pm = jm[::-1].copy(), pm[::-1].copy()
    _limits_equal(tmap_limits(t.limits, jm, pm), jmap_limits(j.limits, jm, pm))


# ---- replace_skeleton_hierarchy, on tests/test_compat_parity_extra.py's cases ----

def _make_pair():
    def make(names, parents, pnames, drive):
        nj = len(names)
        tf = np.zeros((nj * 7, len(pnames)), np.float32)
        for col, (jnt, k) in enumerate(drive):
            tf[jnt * 7 + k, col] = 1.0
        return JCharacter(skeleton=jmake_skeleton(parents, names=names),
                          parameter_transform=JPT(transform=jnp.asarray(tf),
                                                  offsets=jnp.zeros(nj * 7),
                                                  names=tuple(pnames)))

    tgt = make(["root", "spine", "hand", "finger_t"], [-1, 0, 1, 2],
               ["t_tx", "t_hand_rx", "t_finger"], [(0, 0), (2, 3), (3, 3)])
    src = make(["srcroot", "arm", "hand", "f1", "f2"], [-1, 0, 1, 2, 2],
               ["s_tx", "s_f1_rx", "s_f2_rx"], [(0, 0), (3, 3), (4, 3)])
    return src, tgt


def _with_extras(src, tgt):
    tgt = dataclasses.replace(tgt, locators=JLocators(
        parent=jnp.asarray([1, 3], jnp.int32), offset=jnp.zeros((2, 3)), weight=jnp.ones(2),
        names=("spine_loc", "shared_loc")), limits=jmake_limits(
            minmax=[(1, -1.0, 1.0, 2.0), (2, -1.0, 1.0, 1.0)],
            minmax_joint=[(3, 3, -0.3, 0.3, 1.0, 0)]))
    src = dataclasses.replace(src, locators=JLocators(
        parent=jnp.asarray([3], jnp.int32), offset=jnp.ones((1, 3)), weight=jnp.ones(1),
        names=("shared_loc",), locked=jnp.ones((1, 3))),
        limits=jmake_limits(minmax_joint=[(3, 3, -0.5, 0.5, 1.0, 0)]))
    bodies = lambda n: JPP(  # noqa: E731
        joint_index=jnp.arange(n, dtype=jnp.int32), mass=jnp.arange(1.0, n + 1.0),
        center_of_mass_offset=jnp.ones((n, 3)), inertia=jnp.tile(jnp.eye(3), (n, 1, 1)),
        inertia_rotation=jnp.tile(jnp.asarray([0.0, 0.0, 0.0, 1.0]), (n, 1)))
    return (dataclasses.replace(src, physical_properties=bodies(5)),
            dataclasses.replace(tgt, physical_properties=bodies(4)))


@pytest.mark.parametrize("case", ["plain", "locators_limits_bodies", "with_mesh"])
def test_replace_skeleton_hierarchy(case):
    src, tgt = _make_pair()
    if case != "plain":
        src, tgt = _with_extras(src, tgt)
    if case == "with_mesh":
        rig = create_test_character(4)
        tgt = dataclasses.replace(tgt, mesh=rig.mesh, skin_weights=rig.skin_weights)
    want = ju.replace_skeleton_hierarchy(src, tgt, "hand", "hand")
    got = tu.replace_skeleton_hierarchy(to_port(src), to_port(tgt), "hand", "hand")
    assert got.skeleton.joint_names == ("root", "spine", "hand", "f1", "f2")
    assert_tables_equal(got, want)
    via = tcompat.replace_skeleton_hierarchy(to_port(src), to_port(tgt), "hand", "hand")
    assert_tables_equal(via, want)
    with pytest.raises(ValueError):
        tu.replace_skeleton_hierarchy(to_port(src), to_port(tgt), "nope", "hand")
    with pytest.raises(ValueError):
        tu.replace_skeleton_hierarchy(to_port(src), to_port(tgt), "hand", "nope")


# ---- compat ----

def test_compat_names_are_jax_names():
    m10 = set()
    assert set(tcompat.__all__) == set(jcompat.__all__) - m10
    # the module's other public functions and classes too (JAX's compat
    # imports apply_ssd and skinning_matrices from the skinning module)
    import types

    public = {n for n in dir(jcompat) if not n.startswith("_")
              and not isinstance(getattr(jcompat, n), types.ModuleType)}
    missing = {n for n in public - m10 if not hasattr(tcompat, n)}
    assert not missing, sorted(missing)


@pytest.mark.parametrize("name", [
    "apply_parameter_transform", "model_parameters_to_skeleton_state",
    "model_parameters_to_positions", "skin_points_from_model_parameters",
    "model_parameters_to_blend_shape_coefficients", "model_parameters_to_local_skeleton_state",
    "uniform_random_to_model_parameters"])
def test_compat_model_parameter_functions(rigs, name):
    j, t = rigs
    x = _params(j, 4, 11)
    if name == "uniform_random_to_model_parameters":
        x = np.random.default_rng(12).uniform(0, 1, x.shape).astype(np.float32)
    want = jax.vmap(lambda q: getattr(jcompat, name)(j, q))(J(x))
    np.testing.assert_allclose(getattr(tcompat, name)(t, T(x)).numpy(), np.asarray(want),
                               atol=FK_TOL)


@pytest.mark.parametrize("name", ["joint_parameters_to_skeleton_state",
                                  "joint_parameters_to_positions",
                                  "joint_parameters_to_local_skeleton_state"])
def test_compat_joint_parameter_functions(rigs, name):
    j, t = rigs
    jp = np.asarray(jax.vmap(j.parameter_transform.apply)(J(_params(j, 4, 13))))
    want = jax.vmap(lambda q: getattr(jcompat, name)(j, q))(J(jp))
    np.testing.assert_allclose(getattr(tcompat, name)(t, T(jp)).numpy(), np.asarray(want),
                               atol=FK_TOL)


def test_compat_state_functions(rigs):
    j, t = rigs
    x = _params(j, 4, 14)
    states = jax.vmap(j.skeleton_states)(J(x))
    local = jcompat.model_parameters_to_local_skeleton_state(j, J(x))
    np.testing.assert_allclose(tcompat.skeleton_state_to_joint_parameters(t, T(states)).numpy(),
                               np.asarray(jcompat.skeleton_state_to_joint_parameters(j, states)),
                               atol=1e-5)
    np.testing.assert_allclose(
        tcompat.local_skeleton_state_to_joint_parameters(t, T(local)).numpy(),
        np.asarray(jcompat.local_skeleton_state_to_joint_parameters(j, local)), atol=1e-5)
    other = jax.vmap(j.skeleton_states)(J(x * 1.01))
    got = tcompat.compare_skeleton_states(T(states), T(other))
    want = jcompat.compare_skeleton_states(states, other)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4, atol=1e-6)


def test_compat_surgery_and_selection(rigs):
    j, t = rigs
    keep = [0, 1, 2]
    np.testing.assert_array_equal(tcompat.bones_to_vertices(t, keep),
                                  np.asarray(jcompat.bones_to_vertices(j, keep)))
    assert_tables_equal(tcompat.reduce_mesh_to_bones(t, keep), jcompat.reduce_mesh_to_bones(j, keep))
    en = np.arange(t.num_model_parameters) != 3
    assert_tables_equal(tcompat.reduce_to_selected_model_parameters(t, en),
                        jcompat.reduce_to_selected_model_parameters(j, en))
    assert_tables_equal(tcompat.strip_joints(t, ["joint4"]), jcompat.strip_joints(j, ["joint4"]))
    with pytest.raises(ValueError):
        tcompat.strip_joints(t, ["nope"])
    av = np.arange(t.mesh.num_vertices) % 2 == 0
    assert_tables_equal(tcompat.reduce_mesh_by_vertices(t, av),
                        jcompat.reduce_mesh_by_vertices(j, av))
    af = np.arange(t.mesh.faces.shape[0]) % 2 == 0
    assert_tables_equal(tcompat.reduce_mesh_by_faces(t, af), jcompat.reduce_mesh_by_faces(j, af))
    rest = np.asarray(j.mesh.vertices) * 1.1
    assert_tables_equal(tcompat.replace_rest_mesh(t, rest), jcompat.replace_rest_mesh(j, rest))
    with pytest.raises(ValueError):
        tcompat.replace_rest_mesh(t, rest[:3])
    assert tcompat.is_fbxsdk_available() == jcompat.is_fbxsdk_available()


def test_compat_strip_lower_body_vertices():
    j = jax_fullbody_character()
    t = to_port(j)
    assert_tables_equal(tcompat.strip_lower_body_vertices(t),
                        jcompat.strip_lower_body_vertices(j))
    assert_tables_equal(tcompat.strip_lower_body_vertices(t, 0),
                        jcompat.strip_lower_body_vertices(j, 0))


def test_compat_mapping_functions(rigs):
    j, t = rigs
    other = ju.remove_joints(j, ["joint3"])
    other_t = to_port(other)
    x = _params(j, 3, 15)
    np.testing.assert_array_equal(tcompat.map_model_parameters(T(x), t, other_t).numpy(),
                                  np.asarray(jcompat.map_model_parameters(J(x), j, other)))
    jp = np.asarray(jax.vmap(j.parameter_transform.apply)(J(x)))
    np.testing.assert_array_equal(tcompat.map_joint_parameters(T(jp), t, other_t).numpy(),
                                  np.asarray(jcompat.map_joint_parameters(J(jp), j, other)))
    with pytest.raises(ValueError):
        tcompat.model_parameters_to_face_expression_coefficients(t, T(x))


@pytest.mark.parametrize("case", ["plain", "normals", "max_dist", "batched_tie"])
def test_find_closest_points(case):
    r = np.random.default_rng(16)
    src = r.normal(size=(12, 3)).astype(np.float32)
    tgt = r.normal(size=(20, 3)).astype(np.float32)
    kw = {}
    if case == "normals":
        kw = dict(normals_source=r.normal(size=(12, 3)).astype(np.float32),
                  normals_target=r.normal(size=(20, 3)).astype(np.float32), max_normal_dot=0.1)
    elif case == "max_dist":
        kw = dict(max_dist=0.6)
    elif case == "batched_tie":
        tgt = np.concatenate([tgt[:5], tgt[:5]])  # equal points: the first index wins
        src, tgt = np.stack([src, src * 0.5]), np.stack([tgt, tgt])
    got = tcompat.find_closest_points(T(src), T(tgt), **{k: T(v) if isinstance(v, np.ndarray)
                                                        else v for k, v in kw.items()})
    want = jcompat.find_closest_points(J(src), J(tgt), **kw)
    for a, b in zip(got, want):
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=1e-6)


def test_find_closest_points_on_mesh_and_normals(rigs):
    j, _ = rigs
    v, f = np.asarray(j.mesh.vertices), np.asarray(j.mesh.faces)
    pts = np.random.default_rng(17).normal(size=(10, 3)).astype(np.float32)
    for a, b in zip(tcompat.find_closest_points_on_mesh(T(pts), T(v), T(f)),
                    jcompat.find_closest_points_on_mesh(pts, v, f)):
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=1e-5)
    np.testing.assert_allclose(tcompat.compute_vertex_normals(T(v), T(f)).numpy(),
                               np.asarray(jcompat.compute_vertex_normals(v, f)), atol=1e-6)


# ---- texture classification ----

def _textured():
    """A 4 × 4 grid mesh on a 16 × 16 texture: its left half red, right
    green, a blue block in the middle."""
    xs = np.linspace(0, 1, 5)
    verts = np.asarray([[x, y, 0.0] for y in xs for x in xs], np.float32)
    uv = verts[:, :2].copy()
    faces = []
    for r in range(4):
        for c in range(4):
            a = r * 5 + c
            faces += [[a, a + 1, a + 6], [a, a + 6, a + 5]]
    tex = np.zeros((16, 16, 3), np.uint8)
    tex[:, :8] = (255, 0, 0)
    tex[:, 8:] = (0, 255, 0)
    tex[5:11, 5:11] = (0, 0, 255)
    from momentum_tpu.character.character import Mesh as JMesh

    jm = JMesh(vertices=J(verts), faces=J(np.asarray(faces, np.int32)), texcoords=J(uv))
    tm = TMesh(vertices=T(verts), faces=T(np.asarray(faces, np.int32)), texcoords=T(uv))
    return jm, tm, tex


@pytest.mark.parametrize("samples,threshold", [(1, 0.0), (3, 0.0), (6, 0.5), (10, 0.3)])
def test_classify_triangles_by_texture(samples, threshold):
    jm, tm, tex = _textured()
    colors = np.asarray([[255, 0, 0], [0, 0, 255]], np.uint8)
    for a, b in zip(tclassify(tm, tex, colors, threshold, samples),
                    jclassify(jm, tex, colors, threshold, samples)):
        np.testing.assert_array_equal(a, b)


def test_split_mesh_by_texture_region():
    jm, tm, tex = _textured()
    colors = np.asarray([[0, 0, 255]], np.uint8)
    for a, b in zip(tsplit(tm, tex, colors, 6), jsplit(jm, tex, colors, 6)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tcompat.split_mesh_by_texture_region(tm, tex, colors),
                    jcompat.split_mesh_by_texture_region(jm, tex, colors)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tcompat.classify_triangles_by_texture(tm, tex, colors),
                    jcompat.classify_triangles_by_texture(jm, tex, colors)):
        np.testing.assert_array_equal(a, b)


# ---- config U ----

def test_config_u_recipes_are_the_tools():
    j = jax_fullbody_character()
    parents, offsets = np.asarray(j.skeleton.joint_parent), np.asarray(
        j.skeleton.translation_offset)
    a, b = twork.utility_bodies(parents, offsets), jax_reference.utility_bodies(parents, offsets)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    np.testing.assert_array_equal(twork.utility_xform(), jax_reference.utility_xform())
    assert abs(float(a["mass"].sum()) - twork.UTILITY_TOTAL_MASS) < 1e-4
    assert (twork.UTILITY_TURN, twork.UTILITY_SHIFT, twork.UTILITY_SCALE,
            twork.UTILITY_COM_WEIGHT, twork.UTILITY_DROPPED) == (
        jax_reference.UTILITY_TURN, jax_reference.UTILITY_SHIFT, jax_reference.UTILITY_SCALE,
        jax_reference.UTILITY_COM_WEIGHT, jax_reference.UTILITY_DROPPED)


def test_config_u4_tables_are_jax_s():
    """U4's rig (the mesh reduced to the kept joints' vertices, then
    simplify) built by both packages: joint parents, parameter transform,
    limit records, locator parents and mesh faces equal."""
    prob = twork.build_utility_problem(4, device="cpu")
    _, _, simple_j, cols = jax_reference.utility_problem()
    assert twork.simplified_tables(prob.simplified.char) == jax_reference.utility_tables(
        simple_j)
    assert_tables_equal(prob.simplified.char, simple_j)
    np.testing.assert_array_equal(
        prob.simplified.truth.numpy(), prob.truth.numpy()[:, cols])


def test_config_u3_shaped_solve_matches_jax():
    """U3's recipe on the test rig at B = 8: the rig scaled by
    UTILITY_SCALE (preserve_mass), Position on its locators and the
    bodies' centre of mass from each element's truth, from truth +
    N(0, 0.05): each element's energy after LM 2 and LM 5 against JAX's."""
    base = full_jax_character(5)
    scaled_j = ju.scale_character(base, twork.UTILITY_SCALE, "preserve_mass")
    scaled_t = to_port(base).scaled(twork.UTILITY_SCALE, "preserve_mass")
    assert_tables_equal(scaled_t, scaled_j)
    truth, x0 = twork.catalog_draws(8, 3, base.num_model_parameters)
    states_j = jax.vmap(scaled_j.skeleton_states)(J(truth))
    loc = scaled_j.locators
    pos_j = dataclasses.replace(
        jerr.PositionErrorFunction.create(np.asarray(loc.parent), np.asarray(loc.offset),
                                          np.zeros((loc.num_locators, 3))),
        target=jax.vmap(loc.world_positions)(states_j))
    com_target = np.asarray(twork.center_of_mass(scaled_t, T(states_j)))
    com_j = dataclasses.replace(jerr.CenterOfMassErrorFunction.from_physical_properties(
        scaled_j, np.zeros(3), weight=twork.UTILITY_COM_WEIGHT), target=J(com_target))
    pos_t = bridge.position_error_from_numpy(dict(
        parent=np.asarray(loc.parent), offset=np.asarray(loc.offset),
        target=np.asarray(pos_j.target), cweight=np.asarray(pos_j.cweight),
        weight=np.asarray(pos_j.weight)), device="cpu")
    com_t = dataclasses.replace(TCom.from_physical_properties(
        scaled_t, np.zeros(3), weight=twork.UTILITY_COM_WEIGHT, device="cpu"),
        target=T(com_target))
    assert isinstance(pos_t, PositionErrorFunction)
    fn_j, fn_t = JFn(scaled_j, (pos_j, com_j)), TFn(scaled_t, (pos_t, com_t))

    def energies(iterations):
        opts = dict(max_iterations=iterations, regularization=1e-5)
        res_j = jax.jit(lambda x: jsolve_ik(fn_j, x, None, JOpts(**opts),
                                            method="levenberg_marquardt"))(J(x0))
        res_t = tsolve_ik(fn_t, T(x0), options=TOpts(**opts), method="levenberg_marquardt")
        return (fn_t.error(res_t.params).numpy().astype(np.float64),
                np.asarray(fn_j.error(res_j.params), np.float64))

    # LM 2: every energy far above float32 roundoff, each within 1e-3
    e_t, e_j = energies(2)
    assert e_j.min() > 1e-6
    np.testing.assert_allclose(e_t, e_j, rtol=1e-3)
    # LM 5: the elements still moving within 1e-3; those JAX's solve took to
    # float32 roundoff (under 1e-10, from ≥ 2e-4 after LM 1) there in the port too
    e_t, e_j = energies(5)
    moving = e_j > 1e-8
    assert moving.any() and not moving.all()
    np.testing.assert_allclose(e_t[moving], e_j[moving], rtol=1e-3)
    assert e_t[~moving].max() < 1e-10


# ---- the name gaps closed with the sharded slice ----

def test_skin_weights_members_match_jax(rigs):
    j, t = rigs
    assert t.skin_weights.max_influences_per_vertex == j.skin_weights.max_influences_per_vertex
    assert t.skin_weights.num_joints == j.skin_weights.num_joints


@pytest.mark.parametrize("alpha", [2.0, 1.0, 0.0, -1e9, 0.5, 3.0])
def test_generalized_loss_sqrt_deriv_matches_jax(alpha):
    from momentum_tpu.math.generalized_loss import GeneralizedLoss as JGeneralizedLoss

    sq = np.linspace(0.0, 9.0, 37).astype(np.float32)
    want = np.asarray(JGeneralizedLoss(alpha, 1.5).sqrt_deriv(jnp.asarray(sq)))
    got = TGeneralizedLoss(alpha, 1.5).sqrt_deriv(torch.as_tensor(sq)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_mppca_get_mixture_matches_jax():
    """The mixture recovered from the stored covariance: pi, mu, sigma² and
    W up to each column's sign (an eigenvector's)."""
    from momentum_tpu.errors.pose_prior import Mppca as JMppca
    from momentum_tpu_torch.errors import Mppca as TMppca

    rng = np.random.default_rng(9)
    args = dict(pi=np.asarray([0.6, 0.4]), mu=rng.normal(0, 0.3, (2, 5)),
                w_list=[rng.normal(0, 0.6, (5, 2)) for _ in range(2)],
                sigma2=np.asarray([0.2, 0.5]))
    jm, tm = JMppca.from_components(**args), TMppca.from_components(**args, device="cpu")
    for i in range(2):
        (pj, mj, wj, sj), (pt, mt, wt, st) = jm.get_mixture(i), tm.get_mixture(i)
        assert wt.shape == wj.shape == (5, 2)
        np.testing.assert_allclose([pt, st], [pj, sj], rtol=1e-6)
        np.testing.assert_array_equal(mt, np.asarray(mj))
        np.testing.assert_allclose(np.abs(wt), np.abs(wj), rtol=1e-6, atol=1e-7)
    with pytest.raises(IndexError):
        tm.get_mixture(2)

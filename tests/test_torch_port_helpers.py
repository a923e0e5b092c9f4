"""Shared helpers of the tests/test_torch_port_*.py parity tests (this file
holds no tests): pull the numpy arrays out of momentum_tpu objects in the
layout that momentum_tpu_torch.bridge reads, and out of port objects for
comparison."""

from __future__ import annotations

import numpy as np
import pytest


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for a test module: its CPU work is many small ops
    beside XLA's thread pool, and the suite runs several workers on the
    machine's cores, where more threads a worker only contend (imported
    into a module, it applies to that module's tests)."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# the limit tables of a ParameterLimits (the same field names in both packages)
LIMIT_KEYS = (
    "minmax_index", "minmax_bounds", "minmax_weight", "minmax_joint_index",
    "minmax_joint_bounds", "minmax_joint_weight", "minmax_joint_passive", "linear_ref",
    "linear_tgt", "linear_scale", "linear_offset", "linear_range", "linear_weight",
    "linear_joint_ref", "linear_joint_tgt", "linear_joint_scale", "linear_joint_offset",
    "linear_joint_range", "linear_joint_weight", "halfplane_idx1", "halfplane_idx2",
    "halfplane_normal", "halfplane_offset", "halfplane_weight", "ellipsoid_parent",
    "ellipsoid_frame_parent", "ellipsoid_point_offset", "ellipsoid_mat", "ellipsoid_inv",
    "ellipsoid_weight")
LOCATOR_OPTIONAL = ("locked", "limit_weight", "limit_origin", "attached_to_skin", "skin_offset")
BODY_KEYS = ("joint_index", "mass", "center_of_mass_offset", "inertia", "inertia_rotation")
COLLISION_KEYS = ("parent", "transform", "radius", "length", "ptype", "ellipsoid_radii",
                  "box_half_extents")


def character_to_numpy(char, names: bool = False) -> dict:
    """The arrays of a Character (JAX or port) that bridge.character_from_numpy
    reads, as numpy: every limit table, the collision geometry's, the
    skinned locators' (with their names and parameter index), the locators'
    optional fields and the bodies'; with `names`, the joints', parameters',
    locators' and bodies' names too, the parameter sets, pose constraints,
    name and metadata."""
    d = dict(
        joint_parent=char.skeleton.joint_parent,
        pre_rotation=char.skeleton.pre_rotation,
        translation_offset=char.skeleton.translation_offset,
        transform=char.parameter_transform.transform,
        offsets=char.parameter_transform.offsets,
    )
    d.update({k: getattr(char.limits, k) for k in LIMIT_KEYS})
    if char.collision is not None:
        d.update({f"collision_{k}": getattr(char.collision, k) for k in COLLISION_KEYS
                  if getattr(char.collision, k) is not None})
    if char.locators is not None:
        d.update(locator_parent=char.locators.parent,
                 locator_offset=char.locators.offset,
                 locator_weight=char.locators.weight)
        for k in LOCATOR_OPTIONAL:
            if getattr(char.locators, k, None) is not None:
                d[f"locator_{k}"] = getattr(char.locators, k)
    if char.mesh is not None:
        d.update(mesh_vertices=char.mesh.vertices, mesh_faces=char.mesh.faces)
        for k in ("normals", "texcoords", "texcoord_faces", "colors", "confidence"):
            if getattr(char.mesh, k, None) is not None:
                d[f"mesh_{k}"] = getattr(char.mesh, k)
    pp = getattr(char, "physical_properties", None)
    if pp is not None:
        d.update({f"body_{k}": getattr(pp, k) for k in BODY_KEYS})
    if char.skin_weights is not None:
        d.update(skin_index=char.skin_weights.index, skin_weight=char.skin_weights.weight)
    if char.inverse_bind_pose is not None:
        d.update(inverse_bind_pose=char.inverse_bind_pose)
    for prefix, basis, index in (
            ("blend_shape", char.blend_shape, char.blend_shape_param_index),
            ("face_expression", char.face_expression_blend_shape,
             char.face_expression_param_index)):
        if basis is not None:
            d.update({f"{prefix}_base": basis.base_shape, f"{prefix}_vectors": basis.shape_vectors,
                      f"{prefix}_param_index": np.asarray(index, np.int64)})
    sl = char.skinned_locators
    if sl is not None:
        d.update(skinned_locator_parents=sl.parents, skinned_locator_skin_weights=sl.skin_weights,
                 skinned_locator_rest_position=sl.rest_position)
    if char.skinned_locator_param_index is not None:
        d.update(skinned_locator_param_index=np.asarray(char.skinned_locator_param_index,
                                                        np.int64))
    out = {k: to_numpy(v) for k, v in d.items()}
    if sl is not None:
        out["skinned_locator_names"] = list(sl.names)
    if names:
        out["joint_names"] = list(char.skeleton.joint_names)
        if pp is not None and pp.joint_names:
            out["body_joint_names"] = list(pp.joint_names)
        if char.parameter_transform.parameter_sets:
            out["parameter_sets"] = {k: np.asarray(v, np.int64) for k, v in
                                     char.parameter_transform.parameter_sets.items()}
        if getattr(char.parameter_transform, "pose_constraints", None):
            out["pose_constraints"] = dict(char.parameter_transform.pose_constraints)
        for k in ("name", "metadata"):
            if getattr(char, k, ""):
                out[k] = getattr(char, k)
        out["parameter_names"] = list(char.parameter_transform.names)
        if char.locators is not None:
            out["locator_names"] = list(char.locators.names)
    if char.mesh is not None:
        for k in ("lines", "texcoord_lines"):
            if getattr(char.mesh, k, ()):
                out[f"mesh_{k}"] = [to_numpy(line) for line in getattr(char.mesh, k)]
    return out


def camera_to_numpy(cam) -> dict:
    """The arrays of a Camera (JAX or port) that bridge.camera_from_numpy
    reads, as numpy: the distortion's k and p where the model has them."""
    intr = cam.intrinsics
    d = {k: to_numpy(getattr(intr, k)) for k in ("fx", "fy", "cx", "cy", "k", "p")
         if hasattr(intr, k)}
    d.update(image_width=np.int64(intr.image_width), image_height=np.int64(intr.image_height),
             eye_from_world=to_numpy(cam.eye_from_world))
    return d


def position_error_to_numpy(ef) -> dict:
    """The arrays of a PositionErrorFunction (JAX or port) as numpy."""
    d = {k: to_numpy(getattr(ef, k))
         for k in ("parent", "offset", "target", "cweight", "weight")}
    d.update(loss_alpha=np.float64(ef.loss.alpha), loss_c=np.float64(ef.loss.c))
    return d


# an OrientationErrorFunction has the same fields (quaternion offset and target)
orientation_error_to_numpy = position_error_to_numpy


def limit_error_to_numpy(ef) -> dict:
    """The arrays of a LimitErrorFunction (JAX or port) as numpy."""
    return dict(weight=to_numpy(ef.weight), loss_alpha=np.float64(ef.loss.alpha),
                loss_c=np.float64(ef.loss.c))


def pose_prior_to_numpy(ef) -> dict:
    """The arrays of a PosePriorErrorFunction (JAX or port) as numpy."""
    d = {k: to_numpy(getattr(ef.prior, k)) for k in ("mu", "cinv", "l", "rpre")}
    d.update(weight=to_numpy(ef.weight),
             param_index=np.asarray(ef.param_index, np.int64))
    if ef.sub_jtj is not None:
        d.update(sub_jtj=to_numpy(ef.sub_jtj))
    return d


# the tables of each vertex module, and its scalar settings
VERTEX_FIELDS = {
    "VertexPositionErrorFunction": (("target",), ()),
    "VertexPlaneErrorFunction": (("point", "normal"), ("above",)),
    "VertexNormalErrorFunction": (("target_position", "target_normal"),
                                  ("source_normal_weight", "target_normal_weight")),
    "VertexProjectionErrorFunction": (("projection", "target"), ("near_clip",)),
}


def vertex_error_to_numpy(ef) -> dict:
    """The arrays and settings of a vertex module (JAX or port) that
    bridge.vertex_*_error_from_numpy reads, as numpy."""
    tables, statics = VERTEX_FIELDS[type(ef).__name__]
    d = {k: to_numpy(getattr(ef, k)) for k in ("vertex_index", "cweight", "weight") + tables}
    d.update({k: np.asarray(getattr(ef, k)) for k in statics})
    d.update(loss_alpha=np.float64(ef.loss.alpha), loss_c=np.float64(ef.loss.c))
    return d


def to_numpy(x) -> np.ndarray:
    """numpy copy of a jax array, torch tensor or array-like."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def jax_fullbody_character():
    from momentum_tpu.testing.fixtures import create_fullbody_character

    return create_fullbody_character()


def jax_fullstack_modules(char):
    """bench.py's four full-stack modules on a JAX character, placeholder
    targets: the recipe of momentum_tpu_torch.testing.workloads.
    fullstack_modules."""
    from momentum_tpu import errors as jerr
    from momentum_tpu.errors.pose_prior import Mppca

    p, nj = char.num_model_parameters, char.skeleton.num_joints
    pos = jerr.PositionErrorFunction.create(
        np.asarray(char.locators.parent), np.asarray(char.locators.offset),
        np.zeros((char.locators.num_locators, 3)))
    ori = jerr.OrientationErrorFunction.create(
        np.arange(nj, dtype=np.int32), np.tile(np.asarray([0, 0, 0, 1], np.float32), (nj, 1)))
    prior = Mppca.from_components(
        pi=np.asarray([0.6, 0.4]), mu=np.zeros((2, p), np.float32),
        w_list=[np.full((p, 4), 0.01, np.float32)] * 2, sigma2=np.asarray([1.0, 2.0]),
        names=char.parameter_transform.names)
    return (pos, ori, jerr.LimitErrorFunction.create(),
            jerr.PosePriorErrorFunction.create(prior, char.parameter_transform.names))


def port_fullstack_modules(jax_modules):
    """The four full-stack modules carried into the port through bridge.py,
    on the CPU."""
    from momentum_tpu_torch import bridge

    pos, ori, lim, pp = jax_modules
    return (bridge.position_error_from_numpy(position_error_to_numpy(pos), device="cpu"),
            bridge.orientation_error_from_numpy(orientation_error_to_numpy(ori), device="cpu"),
            bridge.limit_error_from_numpy(limit_error_to_numpy(lim), device="cpu"),
            bridge.pose_prior_from_numpy(pose_prior_to_numpy(pp), device="cpu"))


def port_fullbody_character():
    """The JAX full-body rig carried into the port through bridge.py."""
    from momentum_tpu_torch.bridge import character_from_numpy

    return character_from_numpy(character_to_numpy(jax_fullbody_character()), device="cpu")


TILE_EDGE_SCENES = ("corner_edges", "straddling", "z_crossing")


def tile_edge_scene(name: str):
    """(verts (V, 3), faces (F, 3) int32, width, height) of a 256 × 24 scene
    that probes K4a's per-tile reject at tile heights 4 and 8 (tiles of
    th × 128 pixels):
      corner_edges: triangles whose vertices are tile-corner pixel centres,
        so their edges pass exactly through them (w = 0 there), and thin
        triangles that touch a tile at one corner pixel centre only;
      straddling: small triangles across the tile borders x = 128 and
        y = 4k;
      z_crossing: triangles whose depth crosses 0 inside a tile, or is 0 at
        a corner pixel centre."""
    rng = np.random.default_rng(TILE_EDGE_SCENES.index(name) + 21)
    w, h = 256, 24
    xs = np.array([0.5, 127.5, 128.5, 255.5], np.float32)
    ys = np.array([0.5, 3.5, 4.5, 7.5, 8.5, 11.5, 12.5, 15.5, 16.5, 23.5], np.float32)
    tris = []
    if name == "corner_edges":
        corners = np.stack(np.meshgrid(xs, ys), -1).reshape(-1, 2)
        for _ in range(60):
            tris.append(corners[rng.choice(len(corners), 3, replace=False)])
        for cx in xs:
            for cy in ys:  # touches (cx, cy) and no other pixel centre of its tile
                sx = 1.0 if cx % 128 > 64 else -1.0
                sy = 1.0 if cy % 4 > 2 else -1.0
                tris.append(np.array([[cx, cy], [cx + sx * 30, cy], [cx + sx * 30, cy + sy * 9]]))
                tris.append(np.array([[cx, cy], [cx, cy + sy * 9], [cx + sx * 20, cy + sy * 9]]))
    elif name == "straddling":
        for _ in range(120):
            cx = rng.choice([128.0, 0.0, 256.0]) + rng.uniform(-6, 6)
            cy = 4.0 * rng.integers(0, 7) + rng.uniform(-2, 2)
            tris.append(np.stack([cx + rng.uniform(-8, 8, 3), cy + rng.uniform(-3, 3, 3)], -1))
    elif name == "z_crossing":
        for _ in range(100):
            tris.append(np.stack([rng.uniform(-10, w + 10, 3), rng.uniform(-4, h + 4, 3)], -1))
    else:
        raise KeyError(name)
    tris = np.asarray(tris, np.float32)
    z = rng.uniform(0.5, 5.0, tris.shape[:2]).astype(np.float32)
    if name == "z_crossing":
        z[::2, 0] = -rng.uniform(0.5, 5.0, len(z[::2]))  # crosses 0 inside the face
        z[1::4, 1] = 0.0  # zero at a vertex
    verts = np.concatenate([tris, z[..., None]], -1).reshape(-1, 3)
    faces = np.arange(len(verts), dtype=np.int32).reshape(-1, 3)
    return verts.astype(np.float32), faces, w, h


def io_jax_rig(num_joints: int = 5):
    """A small JAX rig with every table the file layer writes: the test
    character's mesh, skin, locators (with their optional fields) and
    collision capsules, bodies one a joint, all seven limit record types,
    parameter sets and pose presets."""
    import dataclasses

    import jax.numpy as jnp

    from momentum_tpu.character.character import PhysicalProperties
    from momentum_tpu.character.limits import make_limits
    from momentum_tpu.testing.fixtures import create_test_character
    from momentum_tpu_torch.testing.workloads import utility_bodies

    base = create_test_character(num_joints)
    skel = base.skeleton
    nj, p = skel.num_joints, base.num_model_parameters
    rng = np.random.default_rng(31)
    loc = base.locators
    n = loc.num_locators
    locators = dataclasses.replace(
        loc, locked=jnp.asarray(rng.integers(0, 2, (n, 3)).astype(np.float32)),
        limit_weight=jnp.asarray(np.where(rng.random((n, 3)) < 0.5, 0.0,
                                          rng.uniform(0, 1, (n, 3))).astype(np.float32)),
        limit_origin=loc.offset,
        attached_to_skin=jnp.asarray(rng.integers(0, 2, n).astype(np.float32)),
        skin_offset=jnp.asarray(np.where(rng.random(n) < 0.5, 0.0,
                                         rng.uniform(0, 0.1, n)).astype(np.float32)))
    ell = np.eye(4, dtype=np.float32)
    ell[:3, :3] = np.diag([0.5, 0.3, 0.4])
    ell[:3, 3] = [0.2, 0.0, 0.1]
    limits = make_limits(
        minmax=[(1, -1.0, 1.0, 1.0), (7, -0.5, 0.5, 2.0), (p - 1, -0.3, 0.3, 1.0)],
        minmax_joint=[(1, 3, -0.3, 0.3, 1.0, False), (2, 4, -0.2, 0.2, 1.0, True)],
        linear=[(7, 8, 0.5, 0.1, -1.0, 1.0, 1.0)],
        linear_joint=[(1 * 7 + 3, (nj - 1) * 7 + 3, 0.5, 0.0,
                       -float(np.finfo(np.float32).max), float(np.finfo(np.float32).max),
                       1.0)],
        halfplane=[(7, 8, 0.6, 0.8, -0.1, 1.0)],
        ellipsoid=[(nj - 1, 0, np.asarray([0.1, 0.0, 0.0], np.float32), ell, 1.0)])
    bodies = utility_bodies(np.asarray(skel.joint_parent), np.asarray(skel.translation_offset))
    pt = dataclasses.replace(base.parameter_transform,
                             parameter_sets={"scaling": (6,), "arms": (7, 8)},
                             pose_constraints={"rest": ((7, 0.0), (8, 0.25))})
    return dataclasses.replace(
        base, parameter_transform=pt, locators=locators, limits=limits,
        physical_properties=PhysicalProperties(
            **{k: jnp.asarray(v) for k, v in bodies.items()}, joint_names=skel.joint_names))


def port_of(jchar):
    """A JAX character carried into the port through bridge.py, on the CPU."""
    from momentum_tpu_torch.bridge import character_from_numpy

    return character_from_numpy(character_to_numpy(jchar, names=True), device="cpu")


def assert_io_tables_equal(got: dict, want: dict, computed_tol: float = 1e-6):
    """Two dicts of io tables (workloads.character_tables and the like)
    equal bit for bit, the FK-computed ones within computed_tol."""
    from momentum_tpu_torch.testing.workloads import io_mismatches

    bad = io_mismatches(got, want, computed_tol)
    assert not bad, bad

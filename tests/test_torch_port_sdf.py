"""Parity of the port's SDF residual modules (errors/sdf.py),
SdfCollisionSequenceErrorFunction, torch_interop.SdfColliderModule, the
bridge's SDF converters and a config-SC-shaped solve with momentum_tpu on
the CPU. Both sides are built from one set of numpy arrays: the JAX
modules' tables carried into the port by the bridge.

Inputs: the 16-joint test rig with 3 random blend shapes (P = 26, 160
vertices), B = 4 poses U(±0.3); a random 8 × 12 × 6 field whose zero level
crosses the rig's lower bones, so some vertices are inside and some are
clamped outside the grid; the joint-attached grid on joint 2.

Tolerances, each with what it holds:
  * rows 1e-5 absolute, energies 1e-5 relative (float32, as
    test_torch_port_vertex.py);
  * the analytic Jacobians (joint-space rows and blend-shape columns)
    against JAX's analytic form at rtol/atol 1e-5, and the solver's model-
    space Jacobian against jax.jacfwd of JAX's rows within 1e-4 of max|J|,
    for both sdf_parent cases (the joint-attached one by forward mode on
    both sides);
  * SdfColliderModule: values 1e-6, gradients 1e-5 of their largest;
  * the config-SC-shaped solve (B = 8, LM 5): each element's final energy
    within 1e-2 relative of JAX's and the same count of penetrating
    elements before and after.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from momentum_tpu import errors as jerr, torch_interop as jti
from momentum_tpu.axel.sdf import SignedDistanceField as JSdf, mesh_to_sdf as jmesh_to_sdf
from momentum_tpu.character.blend_shape import BlendShape as JBlendShape
from momentum_tpu.character.utility import add_blend_shape_parameters as jadd_blend
from momentum_tpu.rasterizer.primitives import make_sphere
from momentum_tpu.sequence import errors as jse
from momentum_tpu.solver import SkeletonSolverFunction as JFn, SolverOptions as JOpts
from momentum_tpu.solver.analytic_jacobian import make_jacobian_context as jmake_jc
from momentum_tpu.solver.ik import solve_ik as jsolve_ik
from momentum_tpu.testing.fixtures import create_test_character as jax_test_character
from momentum_tpu_torch import bridge, torch_interop as tti
from momentum_tpu_torch.solver import SkeletonSolverFunction as TFn, SolverOptions as TOpts
from momentum_tpu_torch.solver.analytic_jacobian import make_jacobian_context as tmake_jc
from momentum_tpu_torch.solver.ik import solve_ik as tsolve_ik
from momentum_tpu_torch.testing import workloads as twork

from test_torch_port_helpers import character_to_numpy, to_numpy

ROW_TOL = dict(rtol=1e-5, atol=1e-5)
JAC_TOL = dict(rtol=1e-5, atol=1e-5)
JACFWD_TOL = 1e-4
B = 4
PARENT = 2
MODULES = ("vertex_world", "vertex_joint", "collision")


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _grid():
    """A field over x ∈ [−1.4, 1.4], y ∈ [−0.5, 5], z ∈ [−1, 1]: y − 2 plus
    noise, so the rig's lowest vertices are inside and its upper ones
    clamped outside."""
    rng = np.random.default_rng(11)
    shape = (8, 12, 6)
    y = -0.5 + 0.5 * np.arange(shape[1])
    values = np.broadcast_to((y - 2.0)[None, :, None], shape) + rng.normal(0, 0.3, shape)
    return dict(origin=np.asarray([-1.4, -0.5, -1.0], np.float32),
                spacing=np.asarray([0.4, 0.5, 0.4], np.float32),
                values=np.asarray(values, np.float32))


def sdf_to_numpy(sdf, prefix="") -> dict:
    return {prefix + k: to_numpy(getattr(sdf, k)) for k in ("origin", "spacing", "values")}


def sdf_error_to_numpy(ef) -> dict:
    d = sdf_to_numpy(ef.sdf, "sdf_")
    d.update({k: to_numpy(getattr(ef, k)) for k in ("vertex_index", "cweight", "weight")})
    if hasattr(ef, "target_distance"):
        d.update(target_distance=to_numpy(ef.target_distance), sdf_parent=ef.sdf_parent)
    if hasattr(ef, "loss"):
        d.update(loss_alpha=np.float64(ef.loss.alpha), loss_c=np.float64(ef.loss.c))
    return d


@pytest.fixture(scope="module")
def rig():
    """(JAX rig with 3 blend shapes, the port's, poses x (B, P), the JAX
    field)."""
    char = jax_test_character(16)
    v = char.mesh.num_vertices
    rng = np.random.default_rng(0)
    body = JBlendShape(base_shape=char.mesh.vertices, shape_vectors=jnp.asarray(
        rng.normal(0, 0.05, (3, v, 3)).astype(np.float32)))
    char = jadd_blend(char, body)
    tchar = bridge.character_from_numpy(character_to_numpy(char), device="cpu")
    x = rng.uniform(-0.3, 0.3, (B, char.num_model_parameters)).astype(np.float32)
    return char, tchar, x, JSdf(**{k: jnp.asarray(a) for k, a in _grid().items()})


def _modules(rig, name, capacity=None):
    char, _, _, field = rig
    rng = np.random.default_rng(MODULES.index(name) + 20)
    vid = np.arange(0, 60, 3, dtype=np.int32)
    cweight = rng.uniform(0.5, 2.0, len(vid))
    if name == "collision":
        ef = jerr.SdfCollisionErrorFunction.create(field, vid, cweight, weight=40.0,
                                                   capacity=capacity)
        return ef, bridge.sdf_collision_error_from_numpy(sdf_error_to_numpy(ef), device="cpu")
    if name == "vertex_joint":
        vid = np.arange(20, 60, 2, dtype=np.int32)  # bones 2-5, in joint 2's frame
    ef = jerr.VertexSdfErrorFunction.create(
        field, vid, rng.normal(0, 0.2, len(vid)), cweight, weight=30.0,
        sdf_parent=PARENT if name == "vertex_joint" else -1, capacity=capacity)
    return ef, bridge.vertex_sdf_error_from_numpy(sdf_error_to_numpy(ef), device="cpu")


@pytest.fixture(scope="module")
def jax_side(rig):
    """Each module pair, and JAX's rows, energies and jax.jacfwd Jacobian
    of each module alone, per pose (vmapped: its joint-attached form holds
    unbatched only, ROADMAP F23), with the world-fixed modules' analytic
    jacobian (rows, joint-space rows, blend-shape columns) on the batch;
    all in two compiles."""
    char, _, x, _ = rig
    pairs = {name: _modules(rig, name) for name in MODULES}

    def per_pose(v):
        out = {}
        for name, (ef, _) in pairs.items():
            fn = JFn(char, (ef,))
            out[name] = (fn.residual(v), fn.error(v), jax.jacfwd(fn.residual)(v))
        return out

    def analytic(v):
        out = {}
        for name, (ef, _) in pairs.items():
            if ef.has_analytic_jacobian:
                c = JFn(char, (ef,)).context(v)
                out[name] = ef.jacobian(char, c, jmake_jc(char, c))
        return out

    xj = jnp.asarray(x)
    return pairs, jax.jit(jax.vmap(per_pose))(xj), jax.jit(analytic)(xj)


@pytest.mark.parametrize("name", MODULES)
def test_sdf_module_rows_match_jax(rig, jax_side, name):
    """Rows and energies of each module."""
    _, tchar, x, _ = rig
    pairs, per_pose, _ = jax_side
    ef_j, ef_t = pairs[name]
    fn_t = TFn(tchar, (ef_t,))
    xt = torch.as_tensor(x)
    rows_j, err_j = (np.asarray(a) for a in per_pose[name][:2])
    np.testing.assert_allclose(fn_t.residual(xt).numpy(), rows_j, **ROW_TOL)
    np.testing.assert_allclose(fn_t.error(xt).numpy(), err_j, rtol=1e-5)
    assert (rows_j != 0).mean() > (0.2 if name == "collision" else 0.9)
    assert ef_t.has_analytic_jacobian == ef_j.has_analytic_jacobian == (name != "vertex_joint")


@pytest.mark.parametrize("name", MODULES)
def test_sdf_module_jacobian_matches_jax(rig, jax_side, name):
    """The world-fixed modules' analytic jacobian against JAX's (rows, the
    joint-space rows, the blend-shape columns); then the solver's
    model-space Jacobian, by the analytic chain or (joint-attached) forward
    mode as JAX dispatches, against jax.jacfwd of JAX's rows."""
    _, tchar, x, _ = rig
    pairs, per_pose, analytic = jax_side
    ef_t = pairs[name][1]
    fn_t = TFn(tchar, (ef_t,))
    xt = torch.as_tensor(x)
    if name in analytic:
        ctx_t = fn_t.context(xt)
        got = ef_t.jacobian(tchar, ctx_t, tmake_jc(tchar, ctx_t))
        for t, j in zip(got, analytic[name]):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), **JAC_TOL)
        assert np.abs(np.asarray(analytic[name][2])).max() > 0  # blend-shape columns live
    assert (name in analytic) == (name != "vertex_joint")
    rows_t, jac_t = fn_t.residual_and_jacobian(xt)
    jac_fwd = np.asarray(per_pose[name][2])
    scale = np.abs(jac_fwd).max()
    np.testing.assert_allclose(jac_t.numpy() / scale, jac_fwd / scale, rtol=0, atol=JACFWD_TOL)
    np.testing.assert_allclose(rows_t.numpy(), fn_t.residual(xt).numpy(), **ROW_TOL)


def test_sdf_rows_at_zero_and_padding(rig):
    """On a field of zeros every collision row is 0, with its Jacobian (the
    gate is d < 0); rows padded through `capacity` read vertex 0 at weight 0
    and add nothing."""
    char, tchar, x, field = rig
    zero = dataclasses.replace(field, values=jnp.zeros_like(field.values))
    ef_j = jerr.SdfCollisionErrorFunction.create(zero, np.arange(10))
    ef_t = bridge.sdf_collision_error_from_numpy(sdf_error_to_numpy(ef_j), device="cpu")
    rows, jac = TFn(tchar, (ef_t,)).residual_and_jacobian(torch.as_tensor(x))
    assert not rows.any() and not jac.any()
    for name in ("vertex_world", "collision"):
        ef_t = _modules(rig, name)[1]
        padded = _modules(rig, name, capacity=25)[1]
        assert padded.constraint_count() == 25 > ef_t.constraint_count()
        np.testing.assert_allclose(TFn(tchar, (padded,)).error(torch.as_tensor(x)).numpy(),
                                   TFn(tchar, (ef_t,)).error(torch.as_tensor(x)).numpy(),
                                   rtol=1e-6)


def test_f23_jax_joint_attached_grid_holds_unbatched_only(rig, jax_side):
    """ROADMAP F23: JAX maps the vertices into the grid's frame by
    broadcasting the parent's (B, 8) state against (B, C, 3) vertices, so a
    batch of 4 poses over 20 vertices raises; the port's state takes a
    constraint axis and equals JAX's per-pose result."""
    char, tchar, x, _ = rig
    pairs, per_pose, _ = jax_side
    ef_j, ef_t = pairs["vertex_joint"]
    with pytest.raises((TypeError, ValueError)):
        JFn(char, (ef_j,)).residual(jnp.asarray(x))
    np.testing.assert_allclose(TFn(tchar, (ef_t,)).residual(torch.as_tensor(x)).numpy(),
                               np.asarray(per_pose["vertex_joint"][0]), **ROW_TOL)


def test_sdf_collision_sequence_rows_match_jax(rig):
    """SdfCollisionSequenceErrorFunction on window-stacked contexts of the
    poses (W = 2 over 3 windows), carried by the bridge."""
    char, tchar, x, field = rig
    ef_j = jse.SdfCollisionSequenceErrorFunction.create(field, np.arange(0, 40, 4),
                                                        np.linspace(0.5, 1.5, 10), weight=7.0)
    ef_t = bridge.sdf_collision_sequence_error_from_numpy(sdf_error_to_numpy(ef_j),
                                                          device="cpu")
    windows = np.stack([x[:-1], x[1:]], axis=1)  # (3, 2, P)
    pos = jerr.PositionErrorFunction.create([0], np.zeros((1, 3)), np.zeros((1, 3)))
    ctx_j = JFn(char, (pos, ef_j)).context(jnp.asarray(windows))
    ctx_t = TFn(tchar, (ef_t,)).context(torch.as_tensor(windows))
    rows_j = np.asarray(ef_j.residual(char, ctx_j))
    np.testing.assert_allclose(ef_t.residual(tchar, ctx_t).numpy(), rows_j, **ROW_TOL)
    assert rows_j.shape == (3, 20) and (rows_j != 0).any()


@pytest.mark.parametrize("parent", [-1, PARENT])
def test_sdf_collider_module_matches_jax(rig, parent):
    """SdfColliderModule's values and autograd gradients (skeleton states and
    points) against JAX's module, whose gradients are jax.vjp of its
    evaluate; a batched call equals the per-pose ones."""
    char, tchar, x, field = rig
    tsdf = bridge.sdf_from_numpy(sdf_to_numpy(field), device="cpu")
    states = np.array(jax.vmap(char.skeleton_states)(jnp.asarray(x)))
    pts = np.random.default_rng(12).uniform(-1, 3, (B, 30, 3)).astype(np.float32)
    jm, tm = jti.SdfColliderModule(field, parent), tti.SdfColliderModule(tsdf, parent)
    r = torch.as_tensor(np.random.default_rng(13).normal(size=(30,)), dtype=torch.float32)
    for b in range(B):
        outs, grads = [], []
        for m in (jm, tm):
            st = torch.as_tensor(states[b]).clone().requires_grad_()
            p = torch.as_tensor(pts[b]).clone().requires_grad_()
            y = m(st, p)
            (y * r).sum().backward()
            outs.append(y.detach().numpy())
            # a world-fixed collider does not read the states: no gradient
            # reaches them in the port, zeros in JAX's
            grads.append((np.zeros(states[b].shape) if st.grad is None else st.grad.numpy(),
                          p.grad.numpy()))
        np.testing.assert_allclose(outs[1], outs[0], atol=1e-6)
        for t, j in zip(grads[1], grads[0]):
            np.testing.assert_allclose(t, j, rtol=0, atol=1e-5 * max(np.abs(j).max(), 1e-6))
        batched = tm(torch.as_tensor(states), torch.as_tensor(pts)).numpy()
        np.testing.assert_allclose(batched[b], outs[1], atol=1e-6)


def test_config_sc_shaped_solve_matches_jax(rig):
    """Config SC's modules on the test rig at B = 8: Position on its 16
    locators (each element's truth), SdfCollision of all 160 vertices
    against a 320-face sphere's field (16³, winding number) placed across
    the lower bones, VertexSdf holding its 4 lowest rest vertices at 0 from
    a ground slab's field (16³, closest face's normal); LM 5 from truth +
    N(0, 0.05). The fields are JAX's, carried by the bridge."""
    char, tchar, _, _ = rig
    char = jax_test_character(16)
    tchar = bridge.character_from_numpy(character_to_numpy(char), device="cpu")
    sv, sf = make_sphere(2)
    sphere = jmesh_to_sdf(sv * 0.6 + np.asarray([0.4, 1.5, 0.3], np.float32), sf, (16, 16, 16),
                          sign_method="winding")
    rest = np.asarray(char.mesh.vertices)
    gv, gf = twork.ground_slab(float(rest[:, 1].min()), 2.0, 3.0)
    ground = jmesh_to_sdf(gv, gf, (16, 16, 16), sign_method="normal")
    truth, x0 = twork.catalog_draws(8, 3, char.num_model_parameters)
    states = jax.vmap(char.skeleton_states)(jnp.asarray(truth))
    loc = char.locators
    pos_j = jerr.PositionErrorFunction.create(np.asarray(loc.parent), np.asarray(loc.offset),
                                              np.zeros((loc.num_locators, 3)))
    pos_j = dataclasses.replace(pos_j, target=jax.vmap(loc.world_positions)(states))
    col_j = jerr.SdfCollisionErrorFunction.create(sphere, np.arange(char.mesh.num_vertices),
                                                  weight=twork.SDF_COLLISION_WEIGHT)
    floor_j = jerr.VertexSdfErrorFunction.create(
        ground, np.argsort(rest[:, 1], kind="stable")[:4], weight=1.0)
    pos_t = bridge.position_error_from_numpy(dict(
        parent=np.asarray(loc.parent), offset=np.asarray(loc.offset),
        target=np.asarray(pos_j.target), cweight=np.asarray(pos_j.cweight),
        weight=np.asarray(pos_j.weight)), device="cpu")
    col_t = bridge.sdf_collision_error_from_numpy(sdf_error_to_numpy(col_j), device="cpu")
    floor_t = bridge.vertex_sdf_error_from_numpy(sdf_error_to_numpy(floor_j), device="cpu")
    fn_j, fn_t = JFn(char, (pos_j, col_j, floor_j)), TFn(tchar, (pos_t, col_t, floor_t))
    assert fn_t.fully_analytic and fn_j.fully_analytic
    opts = dict(max_iterations=5, regularization=1e-5)
    res_j = jax.jit(lambda x: jsolve_ik(fn_j, x, None, JOpts(**opts),
                                        method="levenberg_marquardt"))(jnp.asarray(x0))
    res_t = tsolve_ik(fn_t, torch.as_tensor(x0), options=TOpts(**opts),
                      method="levenberg_marquardt")
    e_j = np.asarray(fn_j.error(res_j.params), np.float64)
    e_t = fn_t.error(res_t.params).numpy().astype(np.float64)
    np.testing.assert_allclose(e_t, e_j, rtol=1e-2)

    def penetrating(sample, verts):
        return int((np.asarray(sample(verts)).min(-1) < 0).sum())

    for xs_j, xs_t in ((jnp.asarray(x0), torch.as_tensor(x0)), (res_j.params, res_t.params)):
        vj = fn_j.context(xs_j).mesh_vertices
        vt = fn_t.context(xs_t).mesh_vertices
        assert penetrating(sphere.sample, vj) == penetrating(col_t.sdf.sample, vt)
    assert penetrating(sphere.sample, fn_j.context(jnp.asarray(x0)).mesh_vertices) > 0


def test_sdf_recipe_is_the_tools():
    """Config SC's numpy inputs (workloads.sdf_recipe: the obstacle, the
    ground slab and its vertices, the handle and its vertices, the contact
    capsules) equal tools/jax_reference.py's, from the same rig arrays, and
    config 5c's slab is the same ground_slab."""
    import pathlib
    import sys

    from momentum_tpu.testing.fixtures import create_fullbody_character

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "tools"))
    import jax_reference

    char = create_fullbody_character()
    args = (np.asarray(char.mesh.vertices), np.asarray(char.bind_pose()))
    ours, tools = twork.sdf_recipe(*args), jax_reference.sdf_recipe(*args)
    assert ours.keys() == tools.keys()
    for k, v in ours.items():
        for kk in (v if isinstance(v, dict) else {None: v}):
            a = v[kk] if kk else v
            b = tools[k][kk] if kk else tools[k]
            np.testing.assert_array_equal(a, b, err_msg=f"{k} {kk}")
    assert len(ours["obstacle_faces"]) == 1280 and ours["ground_faces"].shape == (12, 3)
    for a, b in zip(twork.ground_slab(0.25), jax_reference.ground_slab(0.25)):
        np.testing.assert_array_equal(a, b)
    for name in ("SDF_RESOLUTION", "SDF_COLLISION_WEIGHT", "SDF_GROUND_WEIGHT", "SDF_HAND",
                 "SDF_HAND_WEIGHT", "SDF_CONTACT_HEIGHT", "SDF_SEQUENCE_VERTICES",
                 "SDF_SEQUENCE_WEIGHT", "SDF_HAND_RESOLUTION"):
        assert getattr(twork, name) == getattr(jax_reference, name), name

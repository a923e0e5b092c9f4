"""Parity of the port's vertex family with momentum_tpu on the CPU: the mesh
context (blend shapes, face-expression deltas, LBS skinning, posed normals),
the four vertex modules with analytic Jacobians (rows, energy, and the
model-space Jacobian through the blockwise chain: joint-space rows times the
parameter transform plus the blend-shape columns), a finite-difference
check of that Jacobian, and benchmarks/bench_suite.py config 4: its single
frame (LM 20 at P = 165) and 4b (GN 4 + 2 on the worst quarter) at B = 16.

Inputs: the full-body rig with config 4's 8 blend shapes and 3 more
face-expression shapes (P = 168), 123 vertices (every 5th), B = 3 poses.
The plane and normal modules pick a sign from a dot product with the mesh
normal; their constraints keep only vertices where every such product is
≥ 1e-2 in magnitude, so both packages pick the same sign.

Tolerances, each with what this file measured:
  * context, rows and Jacobian: TOL = rtol 1e-5, atol 1e-5, as
    test_torch_port_jacobian.py (entries O(1); float32 chains summed in
    another order); energies 1e-5 relative; the posed mesh normals, and
    the blended-normal module that reads them, 1e-4 abs (measured 6.2e-5
    and 1.8e-5): a normal is the normalized sum of cross products of edges
    0.04 long, so the vertices' ~1e-6 differences grow ~25× there;
  * finite differences: step 1e-2 on float32 rows, 2e-3 abs, as
    test_torch_port_jacobian.py;
  * config 4's single frame: final energy 1e-3 relative (measured 1.1e-5);
  * 4b: median_param_sq_err within a factor 1.5 (measured 1.015), each
    element's final energy within a factor 2 (measured 0.61–1.70: near 1e-11
    the energies follow near-null directions, ROADMAP F5), no divergent
    element;
  * the three forward-mode modules (point-triangle in both types, vertex
    distance, camera-vertex projection): rows as above, energies 1e-4
    relative, the Jacobian to 1e-4 of its largest entry against JAX's
    forward-mode one, central differences as above; the geometry helpers
    to 1e-4 relative / 1e-5 absolute; config 4x at B = 16 by each module's
    median final energy within 20% of the tool's JAX run.
"""

import dataclasses
import pathlib
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from momentum_tpu import errors as jerr
from momentum_tpu.character.blend_shape import BlendShape as JBlendShape
from momentum_tpu.character.utility import (
    add_blend_shape_parameters as jadd_blend, add_face_expression_parameters as jadd_face)
from momentum_tpu.solver import SkeletonSolverFunction as JFn
from momentum_tpu.solver import SolverOptions as JOpts
from momentum_tpu.solver import solve_compacted as jax_solve_compacted
from momentum_tpu.solver.ik import solve_ik as jax_solve_ik
from momentum_tpu.testing.fixtures import create_fullbody_character as jax_character
from momentum_tpu_torch import bridge
from momentum_tpu_torch.solver import SkeletonSolverFunction as TFn
from momentum_tpu_torch.testing import workloads as twork

from test_torch_port_helpers import character_to_numpy, vertex_error_to_numpy

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "tools"))
import jax_reference  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
NORMAL_TOL = dict(rtol=1e-5, atol=1e-4)
B = 3
MIN_DOT = 1e-2


@pytest.fixture(scope="module")
def rig():
    """(JAX character, port character, x (B, P), vertex ids (C,), JAX mesh
    context at x)."""
    char = jax_character()
    v = char.mesh.num_vertices
    rng = np.random.default_rng(0)
    body = JBlendShape(base_shape=char.mesh.vertices, shape_vectors=jnp.asarray(
        rng.normal(0, 0.01, (8, v, 3)).astype(np.float32)))
    face = JBlendShape(base_shape=jnp.zeros((v, 3)), shape_vectors=jnp.asarray(
        rng.normal(0, 0.01, (3, v, 3)).astype(np.float32)))
    char = jadd_face(jadd_blend(char, body), face)
    p = char.num_model_parameters
    rng = np.random.default_rng(4)
    x = np.concatenate([rng.uniform(-0.2, 0.2, (B, 157)), rng.uniform(-1, 1, (B, p - 157))],
                       axis=-1).astype(np.float32)
    vid = np.arange(0, v, 5, dtype=np.int32)
    ctx = JFn(char, (jerr.VertexPositionErrorFunction.create(vid, np.zeros((len(vid), 3))),)
              ).context(jnp.asarray(x))
    tchar = bridge.character_from_numpy(character_to_numpy(char), device="cpu")
    return char, tchar, x, vid, ctx


def _modules(rig, name):
    """The JAX module `name` on rig's vertices (targets near the posed
    mesh), and the same module carried into the port."""
    char, _, _, vid, ctx = rig
    rng = np.random.default_rng(MODULES.index(name) + 10)
    unit = rng.normal(0, 1, (len(vid), 3))
    unit /= np.linalg.norm(unit, axis=-1, keepdims=True)
    if name.startswith(("plane", "normal")):  # no sign decided by a near-zero product
        dots = np.einsum("bci,ci->bc", np.asarray(ctx.mesh_normals)[:, vid], unit)
        keep = np.abs(dots).min(axis=0) >= MIN_DOT
        assert keep.mean() >= 0.8
        vid, unit = vid[keep], unit[keep]
    n = len(vid)
    verts = np.asarray(ctx.mesh_vertices)[:, vid]  # (B, C, 3)
    cweight = rng.uniform(0.5, 2.0, n)
    if name == "position":
        ef = jerr.VertexPositionErrorFunction.create(vid, np.zeros((n, 3)), cweight, weight=1.3)
        ef = dataclasses.replace(ef, target=jnp.asarray(
            (verts + rng.normal(0, 0.05, verts.shape)).astype(np.float32)))
    elif name.startswith("plane"):
        ef = jerr.VertexPlaneErrorFunction.create(
            vid, verts[0] + rng.normal(0, 0.05, (n, 3)), unit, cweight, weight=0.7,
            above=name == "plane_above")
    elif name.startswith("normal"):
        snw = 0.0 if name == "normal_target_only" else 0.5
        ef = jerr.VertexNormalErrorFunction.create(
            vid, verts[0] + rng.normal(0, 0.05, (n, 3)), unit, cweight,
            source_normal_weight=snw, target_normal_weight=1.0 - snw)
    else:  # projection: a camera 6 units away, focal 2, so every row has z >= 1
        proj = np.zeros((n, 3, 4), np.float32)
        proj[:, 0, 0] = proj[:, 1, 1] = 2.0
        proj[:, 2, 2] = 1.0
        proj[:, 2, 3] = 6.0
        q = np.einsum("cij,cj->ci", proj[..., :3], verts[0]) + proj[..., 3]
        tgt = q[:, :2] / q[:, 2:3] + rng.normal(0, 0.02, (n, 2))
        ef = jerr.VertexProjectionErrorFunction.create(vid, proj, tgt, cweight)
    from_numpy = getattr(bridge, f"vertex_{name.split('_')[0]}_error_from_numpy")
    return ef, from_numpy(vertex_error_to_numpy(ef), device="cpu")


MODULES = ["position", "plane", "plane_above", "normal", "normal_target_only", "projection"]


def test_mesh_context_matches_jax(rig):
    char, tchar, x, vid, ctx = rig
    ef = bridge.vertex_position_error_from_numpy(vertex_error_to_numpy(
        jerr.VertexPositionErrorFunction.create(vid, np.zeros((len(vid), 3)))), device="cpu")
    tfn = TFn(tchar, (ef,))
    tctx = tfn.context(torch.as_tensor(x))
    for k in ("rest_vertices", "mesh_vertices", "mesh_normals"):
        np.testing.assert_allclose(getattr(tctx, k).numpy(), np.asarray(getattr(ctx, k)),
                                   **(NORMAL_TOL if k == "mesh_normals" else TOL), err_msg=k)
    # no module needs the mesh: no skinning pass
    assert TFn(tchar, ()).context(torch.as_tensor(x)).mesh_vertices is None


@pytest.mark.parametrize("name", MODULES)
def test_vertex_module_matches_jax(rig, name):
    """Rows, energy, and the model-space Jacobian through the blockwise
    chain, port against JAX's analytic path."""
    char, tchar, x, _, _ = rig
    ef_j, ef_t = _modules(rig, name)
    fn_j, fn_t = JFn(char, (ef_j,)), TFn(tchar, (ef_t,))
    assert fn_t.fully_analytic and ef_t.needs_mesh and not fn_t.has_structured_modules
    xt, xj = torch.as_tensor(x), jnp.asarray(x)
    np.testing.assert_allclose(fn_t.residual(xt).numpy(), np.asarray(fn_j.residual(xj)), **TOL)
    np.testing.assert_allclose(fn_t.error(xt).numpy(), np.asarray(fn_j.error(xj)), rtol=1e-5)
    rows_j, jac_j = fn_j.residual_and_jacobian(xj)
    rows_t, jac_t = fn_t.residual_and_jacobian(xt)
    assert jac_t.shape == (B, ef_t.num_rows(), tchar.num_model_parameters)
    tol = NORMAL_TOL if name == "normal" else TOL  # its rows read the mesh normals
    np.testing.assert_allclose(rows_t.numpy(), np.asarray(rows_j), **tol)
    np.testing.assert_allclose(jac_t.numpy(), np.asarray(jac_j), **tol)
    np.testing.assert_allclose(rows_t.numpy(), fn_t.residual(xt).numpy(), **TOL)
    assert np.abs(jac_t.numpy()[..., 157:]).max() > 0  # the blend-shape columns are live


@pytest.mark.parametrize("name", ["position", "plane", "normal_target_only", "projection"])
def test_vertex_jacobian_matches_finite_differences(rig, name):
    """The port's Jacobian is the derivative of its own rows: central
    differences on pose, scale and both kinds of shape coefficient. (The
    blended-normal module's Jacobian treats the source normal as rotating
    rigidly, an approximation, so its exact case, source weight 0, is
    checked.)"""
    _, tchar, x, _, _ = rig
    _, ef_t = _modules(rig, name)
    fn = TFn(tchar, (ef_t,))
    _, jac = fn.residual_and_jacobian(torch.as_tensor(x[:1]))
    eps = 1e-2
    for p in (0, 4, 6, 40, 150, 157, 164, 166):
        dx = np.zeros_like(x[:1])
        dx[0, p] = eps
        hi = fn.residual(torch.as_tensor(x[:1] + dx)).double()
        lo = fn.residual(torch.as_tensor(x[:1] - dx)).double()
        fd = ((hi - lo) / (2 * eps)).numpy()
        np.testing.assert_allclose(jac[0, :, p].numpy(), fd[0], atol=2e-3, err_msg=str(p))


def _jax_config4(batch):
    """bench_suite.py config 4 on the JAX package: (char, ef, 4b targets,
    x0, truths)."""
    char = jax_character()
    rng = np.random.default_rng(0)
    v, k = char.mesh.num_vertices, 8
    char = jadd_blend(char, JBlendShape(base_shape=char.mesh.vertices, shape_vectors=jnp.asarray(
        rng.normal(0, 0.01, (k, v, 3)).astype(np.float32))))
    p = char.num_model_parameters
    gt = jnp.asarray(np.concatenate([rng.uniform(-0.2, 0.2, p - k), rng.uniform(-1, 1, k)]),
                     jnp.float32)
    vid = np.arange(0, v, max(v // 256, 1), dtype=np.int32)
    ef0 = jerr.VertexPositionErrorFunction.create(vid, np.zeros((len(vid), 3)))
    fn0 = JFn(char, (ef0,))
    ef = dataclasses.replace(ef0, target=jnp.take(fn0.context(gt).mesh_vertices,
                                                  jnp.asarray(vid), axis=-2))
    rng_b = np.random.default_rng(1)
    gt_b = jnp.asarray(np.concatenate([rng_b.uniform(-0.2, 0.2, (batch, p - k)),
                                       rng_b.uniform(-1, 1, (batch, k))], axis=-1), jnp.float32)
    targets_b = jnp.take(jax.vmap(fn0.context)(gt_b).mesh_vertices, jnp.asarray(vid), axis=-2)
    x0_b = gt_b + 0.05 * jnp.asarray(rng_b.normal(0, 1, (batch, p)), jnp.float32)
    return char, ef, targets_b, x0_b, gt_b


@pytest.fixture(scope="module")
def config4():
    return _jax_config4(16), twork.build_vertex_fit_problem(16, device="cpu")


def test_config4_problem_matches_jax(config4):
    (char, ef, targets_b, x0_b, gt_b), prob = config4
    assert prob.char.num_model_parameters == char.num_model_parameters == 165
    assert prob.ef0.num_rows() == ef.num_rows() == 918
    np.testing.assert_array_equal(prob.x0.numpy(), np.asarray(x0_b))
    np.testing.assert_array_equal(prob.gt.numpy(), np.asarray(gt_b))
    np.testing.assert_allclose(prob.targets.numpy(), np.asarray(targets_b), rtol=0, atol=1e-5)
    np.testing.assert_allclose(prob.targets_frame.numpy(), np.asarray(ef.target), rtol=0,
                               atol=1e-5)


def test_config4_frame_matches_jax(config4):
    """Config 4's single frame: LM 20 from zero at P = 165 on one system
    (x0 of shape (P,)): the final energy within 1e-3 (measured 1.1e-5)."""
    (char, ef, _, _, _), prob = config4
    p = char.num_model_parameters
    rj = jax_solve_ik(JFn(char, (ef,)), jnp.zeros(p), None, JOpts(max_iterations=20),
                      method="levenberg_marquardt")
    rt = twork.solve_vertex_fit_frame(prob.char, prob.ef0, prob.targets_frame, torch.zeros(p))
    assert rt.params.shape == (p,) and rt.error.shape == () and rt.iterations == 20
    np.testing.assert_allclose(float(rt.error), float(rj.error), rtol=1e-3)


def test_config4b_matches_jax(config4):
    """4b at B = 16 with compaction (GN 4 + 2 on the worst 4):
    median_param_sq_err within a factor 1.5, every element's final energy
    within a factor 2, nothing divergent."""
    (char, ef, targets_b, x0_b, gt_b), prob = config4
    opts = JOpts(regularization=1e-5, energy_from_residual=True)

    def stage(tg, x, it, _lam0):
        return jax_solve_ik(JFn(char, (dataclasses.replace(ef, target=tg),)), x, None,
                            dataclasses.replace(opts, max_iterations=it), method="gauss_newton")

    rj = jax.jit(lambda x: jax_solve_compacted(stage, targets_b, x, capacity=4, k_full=4,
                                               r_refine=2))(x0_b)
    rt = twork.make_vertex_fit_solve(prob.char, prob.ef0, 16)(prob.targets, prob.x0)
    assert rt.iterations == 6
    sq_t = ((rt.params - prob.gt) ** 2).sum(-1).numpy()
    sq_j = np.asarray(jnp.sum((rj.params - gt_b) ** 2, axis=-1))
    assert np.isfinite(sq_t).all() and np.isfinite(sq_j).all()
    assert 1 / 1.5 <= np.median(sq_t) / np.median(sq_j) <= 1.5
    e_t = TFn(prob.char, (dataclasses.replace(prob.ef0, target=prob.targets),)).error(
        rt.params).numpy()
    e_j = np.asarray(jax.vmap(lambda tg, x: JFn(char, (dataclasses.replace(ef, target=tg),))
                              .error(x))(targets_b, rj.params))
    ratio = e_t / e_j
    assert ratio.min() >= 0.5 and ratio.max() <= 2.0, np.sort(ratio)


# ---- the three forward-mode vertex modules, the geometry helpers, config 4x ----

AD_MODULES = ["point_triangle", "point_triangle_plane", "vertex_distance", "camera_vertex"]


def _ad_modules(rig, name):
    """The JAX module `name` on rig's mesh and the port's from the same
    numpy tables (targets near the posed mesh)."""
    from momentum_tpu_torch import errors as terr

    char, _, _, vid, ctx = rig
    verts = np.asarray(ctx.mesh_vertices)  # (B, V, 3)
    faces = np.asarray(char.mesh.faces)
    rng = np.random.default_rng(AD_MODULES.index(name) + 30)
    if name.startswith("point_triangle"):
        tri = faces[::40][:12]
        src = faces[5::40][:12, 1]
        bary = rng.dirichlet(np.ones(3), len(tri))
        kind = "plane" if name.endswith("plane") else "position"
        args = (src, tri, bary, rng.uniform(0.5, 2.0, len(tri)))
        return (jerr.PointTriangleVertexErrorFunction.create(*args, weight=0.8,
                                                             constraint_type=kind),
                terr.PointTriangleVertexErrorFunction.create(*args, weight=0.8,
                                                             constraint_type=kind, device="cpu"))
    if name == "vertex_distance":
        v1 = vid[:20]
        v2 = (v1 + 300) % verts.shape[1]
        dist = np.linalg.norm(verts[:, v1] - verts[:, v2], axis=-1) + rng.normal(0, 0.02, (B, 20))
        dist = dist.astype(np.float32)
        j = jerr.VertexVertexDistanceErrorFunction.create(v1, v2, np.zeros(20), weight=1.5)
        t = terr.VertexVertexDistanceErrorFunction.create(v1, v2, np.zeros(20), weight=1.5,
                                                          device="cpu")
        return (dataclasses.replace(j, target=jnp.asarray(dist)),
                dataclasses.replace(t, target=torch.as_tensor(dist)))
    cam_j = jax_reference.recipe_cameras(jax_reference.catalog_recipe())[0]
    cam_t = twork._recipe_cameras(twork.catalog_recipe(), "cpu")[0]
    px = np.array(cam_j.project(jnp.asarray(verts[:, vid]))[0][..., :2])
    px = (px + rng.normal(0, 2.0, px.shape)).astype(np.float32)
    j = jerr.CameraVertexProjectionErrorFunction.create(cam_j, vid, np.zeros((len(vid), 2)),
                                                       weight=1e-4)
    t = terr.CameraVertexProjectionErrorFunction.create(cam_t, vid, np.zeros((len(vid), 2)),
                                                       weight=1e-4, device="cpu")
    return (dataclasses.replace(j, target=jnp.asarray(px)),
            dataclasses.replace(t, target=torch.as_tensor(px)))


@pytest.mark.parametrize("name", AD_MODULES)
def test_forward_mode_vertex_module_matches_jax(rig, name):
    """Rows, energy and the forward-mode Jacobian (the solver function's
    mixed branch: no analytic Jacobian, as in JAX) against JAX's, and
    against central differences of the port's rows."""
    char, tchar, x, _, _ = rig
    ef_j, ef_t = _ad_modules(rig, name)
    fn_j, fn_t = JFn(char, (ef_j,)), TFn(tchar, (ef_t,))
    assert not fn_t.fully_analytic and ef_t.needs_mesh
    xt, xj = torch.as_tensor(x), jnp.asarray(x)
    tol = NORMAL_TOL if name.endswith("plane") else TOL  # the plane type reads the normals
    np.testing.assert_allclose(fn_t.residual(xt).numpy(), np.asarray(fn_j.residual(xj)), **tol)
    np.testing.assert_allclose(fn_t.error(xt).numpy(), np.asarray(fn_j.error(xj)), rtol=1e-4)
    rows_t, jac_t = fn_t.residual_and_jacobian(xt)
    rows_j, jac_j = fn_j.residual_and_jacobian(xj)
    assert jac_t.shape == (B, ef_t.num_rows(), tchar.num_model_parameters)
    scale = float(np.abs(np.asarray(jac_j)).max())
    np.testing.assert_allclose(rows_t.numpy(), np.asarray(rows_j), **tol)
    np.testing.assert_allclose(jac_t.numpy(), np.asarray(jac_j), rtol=0, atol=1e-4 * scale)
    eps = 1e-2
    for p in (0, 6, 40, 157, 166):
        dx = np.zeros_like(x[:1])
        dx[0, p] = eps
        fd = ((fn_t.residual(torch.as_tensor(x[:1] + dx)).double()
               - fn_t.residual(torch.as_tensor(x[:1] - dx)).double()) / (2 * eps)).numpy()
        np.testing.assert_allclose(jac_t[0, :, p].numpy(), fd[0], atol=2e-3 * max(1.0, scale),
                                   err_msg=str(p))


def test_geometry_helpers_match_jax():
    """closest_point_on_segment and point_triangle_closest_point on random
    points around random triangles (every Voronoi region reached) and
    degenerate segments, against JAX's."""
    from momentum_tpu.math import geometry as jgeo
    from momentum_tpu_torch.math import geometry as tgeo

    rng = np.random.default_rng(5)
    n = 4000
    a, b, c = (rng.normal(0, 1, (n, 3)).astype(np.float32) for _ in range(3))
    p = (rng.normal(0, 2, (n, 3))).astype(np.float32)
    pt_t, bary_t = tgeo.point_triangle_closest_point(*(torch.as_tensor(v) for v in (p, a, b, c)))
    pt_j, bary_j = jgeo.point_triangle_closest_point(*(jnp.asarray(v) for v in (p, a, b, c)))
    np.testing.assert_allclose(bary_t.numpy(), np.asarray(bary_j), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(pt_t.numpy(), np.asarray(pt_j), rtol=1e-4, atol=1e-5)
    b_np = bary_t.numpy()
    regions = {"face": (b_np > 0).all(-1), "vertex": (b_np == 1).any(-1),
               "edge": ((b_np == 0).sum(-1) == 1)}
    assert all(m.any() for m in regions.values()), {k: int(m.sum()) for k, m in regions.items()}
    d = b - a
    d[:10] = 0.0  # degenerate segments
    t_t = tgeo.closest_point_on_segment(torch.as_tensor(a), torch.as_tensor(d),
                                        torch.as_tensor(p))
    t_j = jgeo.closest_point_on_segment(jnp.asarray(a), jnp.asarray(d), jnp.asarray(p))
    np.testing.assert_allclose(t_t.numpy(), np.asarray(t_j), rtol=1e-5, atol=1e-6)
    assert float(t_t[:10].abs().max()) == 0.0


def test_pad_rows_matches_jax():
    from momentum_tpu.errors.base import pad_rows as jpad
    from momentum_tpu_torch.errors.base import pad_rows as tpad

    arr = np.arange(12, dtype=np.int32).reshape(4, 3)
    for fill in (0, -1):
        np.testing.assert_array_equal(tpad(arr, 6, fill), jpad(arr, 6, fill))


def test_vertex_extra_recipe_is_the_tools():
    faces = np.arange(612 * 3, dtype=np.int32).reshape(612, 3) % 612
    ours, theirs = twork.vertex_extra_recipe(612, faces), jax_reference.vertex_extra_recipe(
        612, faces)
    assert ours.keys() == theirs.keys()
    for k in ours:
        if k == "weights":
            assert ours[k] == theirs[k]
        else:
            np.testing.assert_array_equal(ours[k], theirs[k])


def test_config4x_matches_the_tools():
    """Config 4x at B = 16 (config 4b plus the three forward-mode modules, GN
    4 + 2 on the worst 4) against the tool's JAX run: each module's median
    final energy within 20%, as chip_smoke.py holds the card (measured
    within 0.1%), nothing divergent. The tool runs in a thread meanwhile
    (XLA runs outside the GIL)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        with ThreadPoolExecutor(1) as pool:
            tool = pool.submit(jax_reference.config4x, 16, held=16)
            prob = twork.build_vertex_extra_problem(16, device="cpu")
            res = twork.make_vertex_extra_solve(prob)(prob.fit.x0)
            fn = TFn(prob.fit.char, twork.vertex_extra_modules(
                prob, prob.fit.targets, prob.distance.target, prob.camera.target))
            ctx = fn.context(res.params)
            got = [float(np.median(ef.error(prob.fit.char, ctx).numpy()))
                   for ef in fn.error_functions]
            want = tool.result()
    finally:
        torch.set_num_threads(threads)
    assert res.iterations == 6 and bool(torch.isfinite(res.params).all())
    assert want["divergent"] == 0
    for label, g in zip(("vertex_position", "point_triangle", "vertex_distance",
                         "camera_vertex"), got):
        assert abs(g / want["median_energy"][label] - 1) <= 0.2, (label, g, want)

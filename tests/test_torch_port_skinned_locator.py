"""Parity of the port's skinned-locator family with momentum_tpu on the CPU:
the two modules of errors/skinned_locator.py (rows, energies and their
forward-mode Jacobians, the sliding candidates included), SkinnedLocators
and the Character's skinned-locator fields, utility.py's
add_skinned_locator_parameters and skinned_locator_rest_offsets, the four
conversion utilities of tracking/tracker_utils.py on the full-body
fixture, get_locator_error's skinned branch, and config SL at B = 16
against tools/jax_reference.py's run of the same recipe.

Inputs: the full-body rig with its 80 locators converted to skinned
locators by JAX (carried across by the bridge), B = 3 poses U(±0.3).

Tolerances, each with what this file measured:
  * rows rtol 1e-5 / atol 1e-5 and energies 1e-5 relative (float32, the
    skinning summed in another order; tests/test_error_catalog.py's
    module checks); the forward-mode Jacobian to 1e-4 of max|J| against
    JAX's (as test_torch_port_vertex.py's forward-mode modules), plus 2e-5
    absolute for the triangle modules (measured 1.05e-5): their rows are
    the difference of two points that move together, and the triangle's
    normal, from edges 0.04 long, grows the vertices' float32 differences
    ~25× (as test_torch_port_vertex.py's posed normals);
  * float64 central differences of the forward-mode Jacobian at step 1e-6
    to 1e-6 of max|J| (test_torch_port_catalog.py's rule);
  * the conversion tables: indices exact, weights and rest positions
    within 1e-6 (measured: equal); a closest-point search that meets a
    near-tie (two distances within 1e-6) would be printed and pinned here,
    none does on this rig;
  * get_locator_error 1e-5 relative;
  * config SL at B = 16: each module's median final energy within 20% (the
    IK rule, as chip_smoke.py's hold), conv_at_1e5 within one element
    (1/16), get_locator_error within 2%, nothing divergent.
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
from momentum_tpu.character.utility import (
    add_skinned_locator_parameters as jadd_params,
    skinned_locator_rest_offsets as jrest_offsets)
from momentum_tpu.math import skel_state as jss
from momentum_tpu.solver import SkeletonSolverFunction as JSSF
from momentum_tpu.testing.fixtures import create_fullbody_character as jax_character
from momentum_tpu.tracking import MarkerSequence as JMarkers, get_locator_error as jlocerr
from momentum_tpu.tracking import tracker_utils as jtu
from momentum_tpu_torch import bridge, errors as terr
from momentum_tpu_torch.character.utility import (
    add_skinned_locator_parameters as tadd_params,
    skinned_locator_rest_offsets as trest_offsets)
from momentum_tpu_torch.math import skel_state as tss
from momentum_tpu_torch.solver import SkeletonSolverFunction as TSSF
from momentum_tpu_torch.testing import workloads as twork
from momentum_tpu_torch.tracking import MarkerSequence as TMarkers, get_locator_error as tlocerr
from momentum_tpu_torch.tracking import tracker_utils as ttu

from test_torch_port_helpers import character_to_numpy

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "tools"))
import jax_reference  # noqa: E402

ROW_TOL = dict(rtol=1e-5, atol=1e-5)
JAC_TOL = 1e-4
TRI_JAC_ATOL = 2e-5
FD_TOL = 1e-6
TABLE_TOL = 1e-6
B = 3
MODULES = ("position", "triangle", "triangle_sliding")


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def rig():
    """(JAX full-body rig, the same with skinned locators (JAX's
    conversion), the latter carried into the port, the port's own
    conversion of the carried base rig, poses x (B, P))."""
    base = jax_character()
    jsc = jtu.locators_to_skinned_locators(base)
    tbase = bridge.character_from_numpy(character_to_numpy(base, names=True), device="cpu")
    tsc = bridge.character_from_numpy(character_to_numpy(jsc, names=True), device="cpu")
    x = np.random.default_rng(7).uniform(-0.3, 0.3, (B, base.num_model_parameters))
    return base, jsc, tsc, ttu.locators_to_skinned_locators(tbase), x.astype(np.float32)


def _hits(char, module):
    """closest_point_on_mesh_matching_parent of config SL's triangle rows."""
    loc = char.locators
    rows = list(twork.SKINNED_TRIANGLE_ROWS)
    if module is jtu:
        world = np.asarray(jss.transform_points(jnp.take(char.bind_pose(), loc.parent, axis=0),
                                                loc.offset))
    else:
        world = tss.transform_points(char.bind_pose().index_select(0, loc.parent.long()),
                                     loc.offset).numpy()
    parents = np.asarray(loc.parent)
    return [module.closest_point_on_mesh_matching_parent(char, world[i], int(parents[i]))
            for i in rows]


def _modules(rig, name):
    """The JAX module `name` over the rig's skinned locators and the port's
    from the same numpy tables."""
    base, jsc, _, _, x = rig
    sl = jsc.skinned_locators
    tables = [np.asarray(a) for a in (sl.parents, sl.skin_weights, sl.rest_position)]
    rng = np.random.default_rng(MODULES.index(name) + 30)
    if name == "position":
        states = jax.vmap(jsc.skeleton_states)(jnp.asarray(x))
        tgt = np.asarray(jax.vmap(lambda s: sl.world_positions(jsc, s))(states))
        tgt = (tgt + rng.normal(0, 0.02, tgt.shape)).astype(np.float32)
        cw = rng.uniform(0.5, 2.0, sl.num_locators)
        j = jerr.SkinnedLocatorErrorFunction.create(*tables, np.zeros((sl.num_locators, 3)), cw,
                                                    weight=1.3)
        t = terr.SkinnedLocatorErrorFunction.create(*tables, np.zeros((sl.num_locators, 3)), cw,
                                                    weight=1.3, device="cpu")
        return (dataclasses.replace(j, target=jnp.asarray(tgt)),
                dataclasses.replace(t, target=torch.as_tensor(tgt)))
    rows = list(twork.SKINNED_TRIANGLE_ROWS)
    faces = np.asarray(base.mesh.faces)
    r = twork.skinned_triangle_recipe(np.asarray(base.mesh.vertices), faces, _hits(base, jtu))
    depth = rng.uniform(-0.01, 0.01, len(rows))
    kw = dict(depth=depth, cweight=rng.uniform(0.5, 2.0, len(rows)), weight=0.7)
    if name == "triangle_sliding":
        kw.update(candidates=r["candidates"], faces=faces)
    args = [a[rows] for a in tables] + [r["tri_indices"], r["bary"]]
    return (jerr.SkinnedLocatorTriangleErrorFunction.create(*args, **kw),
            terr.SkinnedLocatorTriangleErrorFunction.create(*args, **kw, device="cpu"))


def _close_jac(got, want, tol, atol=0.0):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max() + atol)


@pytest.mark.parametrize("name", MODULES)
def test_skinned_locator_module_matches_jax(rig, name):
    """Rows, energy and the forward-mode Jacobian (no analytic one, in JAX
    or here) against JAX's at B = 3; the sliding module's chosen candidate
    is the same in both (no near-tie at these poses)."""
    _, jsc, tsc, _, x = rig
    jef, tef = _modules(rig, name)
    assert not tef.has_analytic_jacobian and tef.needs_mesh == name.startswith("triangle")
    fn_j, fn_t = JSSF(jsc, (jef,)), TSSF(tsc, (tef,))
    xj, xt = jnp.asarray(x), torch.as_tensor(x)
    np.testing.assert_allclose(fn_t.residual(xt).numpy(), np.asarray(fn_j.residual(xj)),
                               **ROW_TOL)
    np.testing.assert_allclose(fn_t.error(xt).numpy(), np.asarray(fn_j.error(xj)), rtol=1e-5)
    rows_t, jac_t = fn_t.residual_and_jacobian(xt)
    rows_j, jac_j = fn_j.residual_and_jacobian(xj)
    np.testing.assert_allclose(rows_t.numpy(), np.asarray(rows_j), **ROW_TOL)
    assert jac_t.shape == (B, tef.num_rows(), tsc.num_model_parameters)
    _close_jac(jac_t.numpy(), jac_j, JAC_TOL, TRI_JAC_ATOL if name != "position" else 0.0)
    if name == "triangle_sliding":
        ctx = fn_t.context(xt)
        world = terr.skinned_locator._locator_world(tef, tsc, ctx.skel_states)
        v = ctx.mesh_vertices[:, tef.candidate_faces.long()]
        d2 = torch.sum((v.mean(dim=-2) - world[:, :, None]) ** 2, dim=-1)
        gap = torch.sort(d2, dim=-1).values.diff(dim=-1)[..., 0]
        assert float(gap.min()) > 1e-6, gap
        assert bool((torch.argmin(d2, dim=-1) > 0).any())  # the slide leaves the snapped one


def _double(obj):
    """obj with every float tensor (and its dataclasses') in float64."""
    if isinstance(obj, torch.Tensor):
        return obj.double() if obj.is_floating_point() else obj
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{f.name: _double(getattr(obj, f.name))
                                           for f in dataclasses.fields(obj)})
    return obj


@pytest.mark.parametrize("name", MODULES)
def test_forward_mode_jacobian_matches_float64_differences(rig, name):
    """The forward-mode Jacobian of each module on the rig in float64
    against central differences of its rows."""
    _, _, tsc, _, x = rig
    fn = TSSF(_double(tsc), (_double(_modules(rig, name)[1]),))
    x64 = torch.as_tensor(x[0], dtype=torch.float64)
    _, jac = fn.residual_and_jacobian(x64)
    h = 1e-6
    fd = torch.stack([(fn.residual(x64 + h * e) - fn.residual(x64 - h * e)) / (2 * h)
                      for e in torch.eye(x.shape[-1], dtype=torch.float64)], dim=-1)
    _close_jac(jac.numpy(), fd.numpy(), FD_TOL)


def test_conversions_match_jax(rig):
    """The four conversion utilities on the full-body fixture: every
    locator's closest admissible triangle, its blended skin weights, the
    converted tables and their names, and the way back to joint-attached
    locators, against JAX's."""
    base, jsc, tsc, tconv, _ = rig
    tbase = bridge.character_from_numpy(character_to_numpy(base, names=True), device="cpu")
    loc = base.locators
    world = np.asarray(jss.transform_points(jnp.take(base.bind_pose(), loc.parent, axis=0),
                                            loc.offset))
    for i in range(loc.num_locators):
        p = int(loc.parent[i])
        jh = jtu.closest_point_on_mesh_matching_parent(base, world[i], p)
        th = ttu.closest_point_on_mesh_matching_parent(tbase, world[i], p)
        if jh[0] != th[0]:
            print(f"locator {i}: JAX triangle {jh[0]} at {jh[3]}, port {th[0]} at {th[3]}")
            assert abs(jh[3] - th[3]) <= 1e-6
            continue
        np.testing.assert_allclose(th[1], jh[1], atol=TABLE_TOL)
        np.testing.assert_allclose(th[2], jh[2], atol=TABLE_TOL)
        ji, jw = jtu.average_triangle_skin_weights(base, jh[0], jh[1])
        ti, tw = ttu.average_triangle_skin_weights(tbase, th[0], th[1])
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_allclose(tw, jw, atol=TABLE_TOL)
    a, b = jsc.skinned_locators, tconv.skinned_locators
    assert b.num_locators == a.num_locators == 80 and tconv.locators.num_locators == 0
    np.testing.assert_array_equal(b.parents.numpy(), np.asarray(a.parents))
    np.testing.assert_allclose(b.skin_weights.numpy(), np.asarray(a.skin_weights), atol=TABLE_TOL)
    np.testing.assert_allclose(b.rest_position.numpy(), np.asarray(a.rest_position),
                               atol=TABLE_TOL)
    assert b.names == a.names == tuple(loc.names)
    jback, tback = jtu.skinned_locators_to_locators(jsc), ttu.skinned_locators_to_locators(tsc)
    assert tback.skinned_locators is None and tback.locators.names == jback.locators.names
    np.testing.assert_array_equal(tback.locators.parent.numpy(), np.asarray(jback.locators.parent))
    np.testing.assert_allclose(tback.locators.offset.numpy(), np.asarray(jback.locators.offset),
                               atol=TABLE_TOL)
    from momentum_tpu_torch import tracking

    assert tracking.convert_locators_to_skinned_locators is ttu.locators_to_skinned_locators
    assert tracking.convert_skinned_locators_to_locators is ttu.skinned_locators_to_locators


def test_skinned_locator_parameters_and_world_positions(rig):
    """add_skinned_locator_parameters (names, index table, the widened
    transform), skinned_locator_rest_offsets, SkinnedLocators.world_positions
    with a rest offset and Character.skin_skinned_locators, against JAX's;
    the bridge carries the parameter index."""
    _, jsc, tsc, _, x = rig
    active = np.arange(80) % 3 != 1
    jp, tp = jadd_params(jsc, active), tadd_params(tsc, active)
    assert tp.parameter_transform.names == jp.parameter_transform.names
    assert tp.skinned_locator_param_index == jp.skinned_locator_param_index
    np.testing.assert_array_equal(tp.parameter_transform.transform.numpy(),
                                  np.asarray(jp.parameter_transform.transform))
    carried = bridge.character_from_numpy(character_to_numpy(jp, names=True), device="cpu")
    assert carried.skinned_locator_param_index == jp.skinned_locator_param_index
    p = jp.num_model_parameters
    theta = np.random.default_rng(8).uniform(-0.05, 0.05, (B, p)).astype(np.float32)
    theta[:, :157] = x
    jo, to = jrest_offsets(jp, jnp.asarray(theta)), trest_offsets(tp, torch.as_tensor(theta))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    assert float(to[:, 1].abs().max()) == 0.0  # inactive locator
    jst = jax.vmap(jp.skeleton_states)(jnp.asarray(theta))
    tst = tp.skeleton_states(torch.as_tensor(theta))
    jw = jax.vmap(lambda s, o: jp.skinned_locators.world_positions(jp, s, o))(jst, jo)
    tw = tp.skinned_locators.world_positions(tp, tst, to)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), **ROW_TOL)
    rest = np.asarray(jsc.skinned_locators.rest_position) + 0.01
    np.testing.assert_allclose(
        tsc.skin_skinned_locators(tst[0], rest).numpy(),
        np.asarray(jsc.skin_skinned_locators(jst[0], rest)), **ROW_TOL)
    with pytest.raises(ValueError, match="no skinned locators"):
        bridge.character_from_numpy(character_to_numpy(jax_character()),
                                    device="cpu").skin_skinned_locators(tst[0])


def test_get_locator_error_skinned_branch(rig):
    """get_locator_error on a rig with both kinds: the first 40 locators
    joint-attached, all 80 skinned (the regular ones cover their names, the
    skinned branch takes the rest), markers with 10% occluded, against
    JAX's."""
    base, jsc, _, _, x = rig
    loc = base.locators
    jmix = dataclasses.replace(jsc, locators=dataclasses.replace(
        loc, parent=loc.parent[:40], offset=loc.offset[:40], weight=loc.weight[:40],
        names=loc.names[:40]))
    tmix = bridge.character_from_numpy(character_to_numpy(jmix, names=True), device="cpu")
    rng = np.random.default_rng(9)
    states = jax.vmap(jsc.skeleton_states)(jnp.asarray(x))
    pos = np.asarray(jax.vmap(lambda s: jsc.skinned_locators.world_positions(jsc, s))(states))
    pos = (pos + rng.normal(0, 0.01, pos.shape)).astype(np.float32)
    occ = rng.random(pos.shape[:2]) < 0.1
    names = jsc.skinned_locators.names
    want = jlocerr(jmix, JMarkers(positions=jnp.asarray(pos), occluded=jnp.asarray(occ),
                                  names=names), jnp.asarray(x))
    got = tlocerr(tmix, TMarkers(positions=torch.as_tensor(pos), occluded=torch.as_tensor(occ),
                                 names=names), torch.as_tensor(x))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    skinned_only = tlocerr(dataclasses.replace(tmix, locators=None),
                           TMarkers(positions=torch.as_tensor(pos),
                                    occluded=torch.as_tensor(occ), names=names),
                           torch.as_tensor(x))
    assert skinned_only[0] > 0 and skinned_only != got


def test_config_sl_matches_the_tool():
    """Config SL at B = 16 (the port's build_skinned_ik_problem and
    solve_catalog's LM 10) against tools/jax_reference.py's run of the same
    recipe: the skinned-locator tables and the triangle recipe equal, each
    module's median final energy within 20%, conv_at_1e5 within one
    element, get_locator_error of the first 8 within 2%, nothing
    divergent. The tool runs in a thread meanwhile (XLA runs outside the
    GIL)."""
    with ThreadPoolExecutor(1) as pool:
        tool = pool.submit(jax_reference.skinned, 16, chunk=16, frames=8)
        prob = twork.build_skinned_ik_problem(16, device="cpu")
        res = twork.solve_catalog(prob)
        more = twork.solve_catalog(prob, x0=res.params, iterations=20)
        got = twork.catalog_figures(prob, res.params, more.params)
        err = tlocerr(prob.char, twork.skinned_marker_sequence(prob, 8), res.params[:8])
        want = tool.result()
    sl, tables = prob.char.skinned_locators, want["tables"]
    np.testing.assert_array_equal(sl.parents.numpy(), tables["parents"])
    np.testing.assert_allclose(sl.skin_weights.numpy(), tables["skin_weights"], atol=TABLE_TOL)
    np.testing.assert_allclose(sl.rest_position.numpy(), tables["rest_position"], atol=TABLE_TOL)
    tri = prob.modules[1][1]
    np.testing.assert_array_equal(tri.tri_indices.numpy(), tables["tri_indices"])
    np.testing.assert_array_equal(tri.candidates.numpy(), tables["candidates"])
    assert want["divergent"] == got["divergent"] == 0
    for label, med in want["median_energy"].items():
        assert abs(got["median_energy"][label] - med) <= 0.2 * med, (label, got, want)
    assert abs(got["conv_at_1e5"] - want["conv_at_1e5"]) <= 1 / 16 + 1e-9
    np.testing.assert_allclose(err[0], want["locator_error"]["average"], rtol=0.02)

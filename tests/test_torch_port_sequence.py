"""Parity of the port's sequence solving (momentum_tpu_torch/sequence/) with
momentum_tpu on the CPU: the block-tridiagonal solves (Thomas and the SPIKE
partitioned solve with 4 parts at F = 130), banded_to_tridiag, the arrowhead
Schur solve, every ported sequence module, the per-frame Jacobian, the
block-banded normal equations, solve_sequence (plain, with line search, and
in the float64 mode against JAX with x64 enabled, ROADMAP F13) and
benchmarks/bench_suite.py config 5 and 5f at F = 130; and the port's
create_test_character against JAX's.

Tolerances, each with where it comes from:
  * linear solves: relative residual ≤ 1e-5 and x within 1e-4 of max|x| of
    JAX's (float32, random diagonally dominant SPD blocks, κ ~ 10);
  * banded_to_tridiag: bit-equal (it only places blocks);
  * the Schur solve: 1e-4 relative to a float64 dense solve;
  * normal equations: every block at atol 2e-4, JAX's own tolerance against
    its dense reference (tests/test_sequence_solver.py:228-236);
  * Jacobians: rtol 1e-5, atol 1e-5, as test_torch_port_jacobian.py;
  * sequence modules: residuals and energies at rtol 1e-5 (atol 1e-6);
  * solve_sequence: final error within 1e-3 relative, the same iteration
    count, per-frame parameters within 1e-3 absolute; config 5/5f within
    1e-2 relative of JAX CPU's final error.
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from momentum_tpu.errors import PositionErrorFunction as JPos
from momentum_tpu.sequence import block_tridiag as jbt, errors as jse
from momentum_tpu.sequence import solver as jsol, solver_function as jsf
from momentum_tpu.solver import SolverOptions as JOpts
from momentum_tpu.testing.fixtures import (
    create_fullbody_character as jax_fullbody, create_test_character as jax_test_character)
from momentum_tpu_torch.errors import PositionErrorFunction as TPos
from momentum_tpu_torch.sequence import block_tridiag as tbt, errors as tse
from momentum_tpu_torch.sequence import solver as tsol, solver_function as tsf
from momentum_tpu_torch.solver import SolverOptions as TOpts
from momentum_tpu_torch.testing import fixtures as tfix, workloads as twork

from test_torch_port_helpers import character_to_numpy, to_numpy

JAC_TOL = dict(rtol=1e-5, atol=1e-5)
MODULE_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The sequence solve's many small CPU factorizations run fastest on one
    thread beside XLA's thread pool in the same process."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _spd_band(f, p, k, seed):
    """Random diagonally dominant SPD block-tridiagonal system: diag (F, p, p),
    upper (F-1, p, p), rhs (F, p, k), float32, and its dense float64 matrix."""
    rng = np.random.default_rng(seed)
    upper = rng.normal(0, 0.3, (f - 1, p, p))
    m = rng.normal(0, 1, (f, p, p))
    diag = m @ np.swapaxes(m, -1, -2) + 4 * p * np.eye(p)
    rhs = rng.normal(0, 1, (f, p, k))
    dense = np.zeros((f * p, f * p))
    for i in range(f):
        dense[i * p:(i + 1) * p, i * p:(i + 1) * p] = diag[i]
        if i + 1 < f:
            dense[i * p:(i + 1) * p, (i + 1) * p:(i + 2) * p] = upper[i]
            dense[(i + 1) * p:(i + 2) * p, i * p:(i + 1) * p] = upper[i].T
    return tuple(a.astype(np.float32) for a in (diag, upper, rhs)), dense


def _relres(dense, x, rhs):
    r = dense @ x.reshape(-1, x.shape[-1]).astype(np.float64) - rhs.reshape(-1, rhs.shape[-1])
    return float(np.linalg.norm(r) / np.linalg.norm(rhs))


@pytest.mark.parametrize("solver,frames", [("thomas", 9), ("thomas", 130), ("dispatch", 130),
                                           ("partitioned", 40)])
def test_block_tridiag_solve_matches_jax(monkeypatch, solver, frames):
    """Thomas, the dispatch (SPIKE with min(64, max(2, 130 // 32)) = 4 parts
    at F = 130) and SPIKE with a padded last chunk (F = 40, 3 parts of 14):
    the relative residual, and x against JAX's."""
    (diag, upper, rhs), dense = _spd_band(frames, 5, 3, seed=frames)
    parts = []
    if solver == "dispatch":
        real = tbt.block_tridiag_solve_partitioned
        monkeypatch.setattr(tbt, "block_tridiag_solve_partitioned",
                            lambda *a: parts.append(a[3]) or real(*a))
    fns = {"thomas": (jbt.block_tridiag_solve_thomas, tbt.block_tridiag_solve_thomas),
           "dispatch": (jbt.block_tridiag_solve, tbt.block_tridiag_solve),
           "partitioned": (lambda *a: jbt.block_tridiag_solve_partitioned(*a, 3),
                           lambda *a: tbt.block_tridiag_solve_partitioned(*a, 3))}[solver]
    xj = np.asarray(fns[0](*(jnp.asarray(a) for a in (diag, upper, rhs))))
    xt = fns[1](*(torch.as_tensor(a) for a in (diag, upper, rhs))).numpy()
    if solver == "dispatch":
        assert parts == [4]
    assert _relres(dense, xt, rhs) <= 1e-5
    np.testing.assert_allclose(xt, xj, rtol=1e-4, atol=1e-4 * np.abs(xj).max())


@pytest.mark.parametrize("q", [2, 3])
def test_banded_to_tridiag_bit_equal(q):
    rng = np.random.default_rng(q)
    f, p = 4 * q, 3
    diag = rng.normal(0, 1, (f, p, p)).astype(np.float32)
    offs = [rng.normal(0, 1, (f - k, p, p)).astype(np.float32) for k in range(1, q + 1)]
    jd, ju = jbt.banded_to_tridiag(jnp.asarray(diag), [jnp.asarray(o) for o in offs])
    td, tu = tbt.banded_to_tridiag(torch.as_tensor(diag), [torch.as_tensor(o) for o in offs])
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))


def test_schur_arrowhead_matches_dense():
    """nu = 2 universal unknowns coupled to every frame, against a float64
    dense solve of the whole arrowhead system, and against JAX."""
    f, p, nu = 10, 4, 2
    (diag, upper, _), dense = _spd_band(f, p, 1, seed=3)
    rng = np.random.default_rng(4)
    uc = rng.normal(0, 0.3, (f, p, nu)).astype(np.float32)
    ub = (10 * f * np.eye(nu) + rng.normal(0, 0.1, (nu, nu))).astype(np.float32)
    ub = 0.5 * (ub + ub.T)
    rf = rng.normal(0, 1, (f, p)).astype(np.float32)
    ru = rng.normal(0, 1, nu).astype(np.float32)
    full = np.block([[dense, uc.reshape(f * p, nu)], [uc.reshape(f * p, nu).T, ub]])
    want = np.linalg.solve(full, np.concatenate([rf.reshape(-1), ru]).astype(np.float64))
    args = (diag, upper, uc, ub, rf, ru)
    xf, xu = tbt.schur_arrowhead_solve(*(torch.as_tensor(a) for a in args))
    got = np.concatenate([xf.numpy().reshape(-1), xu.numpy()])
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())
    jf, ju = jbt.schur_arrowhead_solve(*(jnp.asarray(a) for a in args))
    np.testing.assert_allclose(got, np.concatenate([np.asarray(jf).reshape(-1), np.asarray(ju)]),
                               rtol=1e-4, atol=1e-4 * np.abs(want).max())


def test_test_character_matches_jax():
    """The port's create_test_character is the JAX fixture's rig, bit for
    bit (the collision capsules aside, which the port's Character does not
    hold), with its parameter names and sets; the full-body rig's "scaling"
    set as JAX's."""
    for nj in (4, 16):
        jchar, tchar = jax_test_character(nj), tfix.create_test_character(nj, device="cpu")
        j, t = character_to_numpy(jchar), character_to_numpy(tchar)
        assert sorted(j) == sorted(t)
        for k in j:
            assert t[k].dtype == j[k].dtype, k
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)
        assert tchar.parameter_transform.names == jchar.parameter_transform.names
        assert tchar.parameter_transform.parameter_sets == jchar.parameter_transform.parameter_sets
    assert (tfix.create_fullbody_character(device="cpu").parameter_transform.parameter_sets
            == jax_fullbody().parameter_transform.parameter_sets == {"scaling": (6,)})


# ---- a small sequence problem on the 4-joint test rig ----

def _sequence_problem(frames, nj=4, universal=(6,), sequence=("smooth",), fullbody=False,
                      seed=0):
    """(JAX fn, port fn, P): position targets of random poses on the test rig
    (or the full-body one), stacked over the frames, with the sequence
    modules named in `sequence`, the parameters `universal` shared."""
    jchar = jax_fullbody() if fullbody else jax_test_character(nj)
    tchar = (tfix.create_fullbody_character(device="cpu") if fullbody
             else tfix.create_test_character(nj, device="cpu"))
    p, nj = jchar.num_model_parameters, jchar.skeleton.num_joints
    rng = np.random.default_rng(seed)
    gt = jnp.asarray(rng.uniform(-0.2, 0.2, (frames, p)), jnp.float32)
    targets = jax.vmap(jchar.locators.world_positions)(jax.vmap(jchar.skeleton_states)(gt))
    args = (np.asarray(jchar.locators.parent), np.asarray(jchar.locators.offset),
            np.zeros((jchar.locators.num_locators, 3)))
    jef = jax.vmap(lambda t: dataclasses.replace(JPos.create(*args), target=t))(targets)
    tef = tsf.stack_frames([dataclasses.replace(TPos.create(*args, device="cpu"),
                                                target=torch.as_tensor(np.asarray(t)))
                            for t in targets])
    made = {"smooth": lambda m, **kw: m.ModelParametersSequenceErrorFunction.create(
                p, weight=0.1, **kw),
            "accel": lambda m, **kw: m.AccelerationSequenceErrorFunction.create(
                nj, weight=0.5, **kw)}
    jseq = tuple(made[name](jse) for name in sequence)
    tseq = tuple(made[name](tse, device="cpu") for name in sequence)
    mask = np.zeros(p, bool)
    mask[list(universal)] = True
    jfn = jsf.SequenceSolverFunction.create(jchar, frames, universal=mask,
                                            per_frame_errors=(jef,), sequence_errors=jseq)
    tfn = tsf.SequenceSolverFunction.create(tchar, frames, universal=mask,
                                            per_frame_errors=(tef,), sequence_errors=tseq)
    return jfn, tfn, p


def _start(jfn, tfn, p, seed=1):
    """The same starting point (pf, u) in both packages: small random poses."""
    rng = np.random.default_rng(seed)
    theta = rng.uniform(-0.1, 0.1, (jfn.num_frames, p)).astype(np.float32)
    jpf, ju = jfn.split(jnp.asarray(theta))
    tpf, tu = tfn.split(torch.as_tensor(theta))
    np.testing.assert_array_equal(tpf.numpy(), np.asarray(jpf))
    return (jpf, ju), (tpf, tu)


def test_stack_frames_keeps_shared_tables():
    """Tables every frame shares stay unstacked; per-frame targets get a
    leading F; a differing index table is refused."""
    efs = [TPos.create([0, 1], np.zeros((2, 3)), np.full((2, 3), float(i)), device="cpu")
           for i in range(3)]
    st = tsf.stack_frames(efs)
    assert st.target.shape == (3, 2, 3) and st.parent.shape == (2,) and st.weight.ndim == 0
    with pytest.raises(ValueError, match="parent"):
        tsf.stack_frames([efs[0], TPos.create([1, 1], np.zeros((2, 3)), np.zeros((2, 3)),
                                              device="cpu")])


def test_normal_equations_match_jax():
    """create_test_character(4), F = 6, one universal parameter, position +
    ModelParameters + Acceleration (q = 2): every block of the banded normal
    equations."""
    jfn, tfn, p = _sequence_problem(6, sequence=("smooth", "accel"))
    (jpf, ju), (tpf, tu) = _start(jfn, tfn, p)
    jout = jax.jit(lambda a, b: jsol._normal_equations(jfn, a, b)[:-1])(jpf, ju) + (2,)
    tout = tsol._normal_equations(tfn, tpf, tu)
    assert tout[-1] == jout[-1] == 2
    names = ("diag", "offs", "u_coupling", "u_block", "rhs_f", "rhs_u")
    for name, j, t in zip(names, jout[:-1], tout[:-1]):
        pairs = zip(j, t) if name == "offs" else [(j, t)]
        for jj, tt in pairs:
            np.testing.assert_allclose(tt.numpy(), np.asarray(jj), rtol=0, atol=2e-4,
                                       err_msg=name)


def test_frame_jacobian_matches_jax_jacfwd():
    """The per-frame Jacobian on the 16-joint rig (P = 23 < 64, where JAX
    takes jacfwd) at F = 3: the port's analytic Jacobian, and its forward-mode
    form (the branch for modules without an analytic Jacobian)."""
    jfn, tfn, p = _sequence_problem(3, nj=16, universal=(6,))
    (jpf, ju), (tpf, tu) = _start(jfn, tfn, p)
    frame_jac = jax.vmap(jsol.make_frame_jacobian(jfn), in_axes=(0, None, 0))
    jrows, jjp, jju = jax.jit(frame_jac)(jpf, ju, jfn.per_frame_errors)
    analytic = tsol.make_frame_jacobian(tfn)(tpf, tu)
    forward = tsol._jacobian_columns(
        lambda a, b: tfn.frame_residual(tfn.join(a, b), tfn.per_frame_errors), tpf, tu)
    for got in (analytic, forward):
        for t, j in zip(got, (jrows, jjp, jju)):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), **JAC_TOL)


def _module_pairs(nj, nv):
    """(name, JAX module, port module) for every ported sequence module."""
    rng = np.random.default_rng(7)
    w = rng.uniform(0.5, 1.5, nj)
    off = np.tile(np.asarray([0, 0, 0, 0, 0, 0, 1, 1], np.float32), (nj, 1))
    off[:, :3] = rng.normal(0, 0.1, (nj, 3))
    specs = {
        "model_parameters": ("ModelParametersSequenceErrorFunction", (None,),
                             dict(pweight=rng.uniform(0.5, 1.5, nj + 7), weight=0.7)),
        "state_matrix": ("StateSequenceErrorFunction", (nj,),
                         dict(position_weight=w, target_offset=off, pos_wgt=2.0, weight=0.9)),
        "state_logmap": ("StateSequenceErrorFunction", (nj,),
                         dict(rotation_weight=w, rotation_error_type="logmap")),
        "acceleration": ("AccelerationSequenceErrorFunction", (nj,),
                         dict(jweight=w, target=rng.normal(0, 0.01, (nj, 3)))),
        "jerk": ("JerkSequenceErrorFunction", (nj,), dict(weight=0.3)),
        "velocity_magnitude": ("VelocityMagnitudeSequenceErrorFunction", (nj,),
                               dict(jweight=w, target_magnitude=0.05)),
        "joint_to_joint": ("JointToJointSequenceErrorFunction",
                           ([1, 3], [0, 2], rng.normal(0, 0.2, (2, 3)),
                            rng.normal(0, 0.2, (2, 3))), dict(cweight=[1.0, 0.5])),
        "vertex": ("VertexSequenceErrorFunction", ([0, 5, 11, nv - 1],), dict(weight=2.0)),
    }
    for name, (cls, args, kw) in specs.items():
        yield (name, getattr(jse, cls).create(*args, **kw),
               getattr(tse, cls).create(*args, device="cpu", **kw))


@pytest.mark.parametrize("name", ["model_parameters", "state_matrix", "state_logmap",
                                  "acceleration", "jerk", "velocity_magnitude",
                                  "joint_to_joint", "vertex"])
def test_sequence_module_matches_jax(name):
    """Each ported sequence module on a random motion of the 4-joint rig
    (F = 5): its rows on every window and the whole objective's error and
    gradient, with position targets per frame."""
    jfn, tfn, p = _sequence_problem(5, universal=(6,), sequence=())
    nj, nv = jfn.character.skeleton.num_joints, jfn.character.mesh.num_vertices
    _, jmod, tmod = next(m for m in _module_pairs(nj, nv) if m[0] == name)
    if name == "model_parameters":
        jmod, tmod = (dataclasses.replace(jmod, pweight=jmod.pweight[:p]),
                      dataclasses.replace(tmod, pweight=tmod.pweight[:p]))
    _hold_sequence_module(jfn, tfn, p, jmod, tmod)


def _hold_sequence_module(jfn, tfn, p, jmod, tmod):
    """The module's rows on every window and the objective's error and
    gradient against JAX's, the module alone in the objective's sequence
    errors."""
    jfn = dataclasses.replace(jfn, sequence_errors=(jmod,))
    tfn = dataclasses.replace(tfn, sequence_errors=(tmod,))
    (jpf, ju), (tpf, tu) = _start(jfn, tfn, p, seed=2)
    w = jmod.window
    @jax.jit
    def jax_side(a, b):
        ctx = jfn._window_contexts(jfn.frame_contexts(jfn.join(a, b)), w)
        rows = jax.vmap(lambda c: jmod.residual(jfn.character, c))(ctx)
        return rows, jfn.error(a, b), jfn.gradient(a, b)

    jrows, jerr, jgrad = jax_side(jpf, ju)
    tctx = tfn._window_contexts(tfn.frame_contexts(tfn.join(tpf, tu)), w)
    np.testing.assert_allclose(tmod.residual(tfn.character, tctx).numpy(), np.asarray(jrows),
                               **MODULE_TOL)
    np.testing.assert_allclose(float(tfn.error(tpf, tu)), float(jerr), **MODULE_TOL)
    for t, j in zip(tfn.gradient(tpf, tu), jgrad):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-4,
                                   atol=1e-4 * max(1.0, float(np.abs(np.asarray(j)).max())))


def test_sdf_collision_waits_for_axel():
    """SdfCollisionSequenceErrorFunction, whose create raised until axel's
    fields were ported, now samples one: a field under the 4-joint rig's
    ribbon whose zero level crosses it, so some windows penetrate, held as
    every sequence module is."""
    from momentum_tpu.axel.sdf import SignedDistanceField as JSdf
    from momentum_tpu_torch.axel.sdf import SignedDistanceField as TSdf

    jfn, tfn, p = _sequence_problem(5, universal=(6,), sequence=())
    nv = jfn.character.mesh.num_vertices
    res = (6, 9, 5)
    ys = np.linspace(-1.0, 3.0, res[1], dtype=np.float32)
    values = np.broadcast_to((ys - 1.1)[None, :, None], res) + np.random.default_rng(3).normal(
        0, 0.05, res)
    grid = dict(origin=np.asarray([-1.5, -1.0, -1.0], np.float32),
                spacing=np.asarray([0.6, 0.5, 0.5], np.float32),
                values=np.asarray(values, np.float32))
    index, cweight = [0, 3, 8, 12, nv - 1], [1.0, 0.5, 2.0, 1.0, 1.5]
    jmod = jse.SdfCollisionSequenceErrorFunction.create(
        JSdf(**{k: jnp.asarray(v) for k, v in grid.items()}), index, cweight, weight=3.0)
    tmod = tse.SdfCollisionSequenceErrorFunction.create(
        TSdf.create(**grid, device="cpu"), index, cweight, weight=3.0, device="cpu")
    _hold_sequence_module(jfn, tfn, p, jmod, tmod)


def test_f24_window_contexts_share_the_rest_mesh():
    """ROADMAP F24: the frame contexts carry the rest mesh of a rig without
    blend shapes once, (V, 3), and the window contexts indexed it by frame:
    out of range once F > V (an IndexError on the CPU, a device assert on
    the card). With 50 frames on the 4-joint rig (40 vertices) the vertex
    sequence module's objective and gradient now equal JAX's, whose vmapped
    frame contexts give every field a frame axis."""
    jfn, tfn, p = _sequence_problem(50, universal=(6,), sequence=())
    assert tfn.character.mesh.num_vertices < 50
    jmod = jse.VertexSequenceErrorFunction.create([0, 5, 11, 39], weight=2.0)
    tmod = tse.VertexSequenceErrorFunction.create([0, 5, 11, 39], weight=2.0, device="cpu")
    jfn = dataclasses.replace(jfn, sequence_errors=(jmod,))
    tfn = dataclasses.replace(tfn, sequence_errors=(tmod,))
    (jpf, ju), (tpf, tu) = _start(jfn, tfn, p, seed=4)
    ctx = tfn._window_contexts(tfn.frame_contexts(tfn.join(tpf, tu)), 2)
    assert ctx.rest_vertices.shape == (40, 3) and ctx.mesh_vertices.shape[:2] == (49, 2)
    np.testing.assert_allclose(float(tfn.error(tpf, tu)), float(jax.jit(jfn.error)(jpf, ju)),
                               **MODULE_TOL)
    for t, j in zip(tfn.gradient(tpf, tu), jax.jit(jfn.gradient)(jpf, ju)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-4,
                                   atol=1e-4 * max(1.0, float(np.abs(np.asarray(j)).max())))


def _check_solve(jres, tres, rtol=1e-3):
    assert tres.iterations == int(jres.iterations)
    assert bool(tres.converged) == bool(jres.converged)
    assert abs(float(tres.error) / float(jres.error) - 1) <= rtol
    np.testing.assert_allclose(tres.per_frame.numpy(), np.asarray(jres.per_frame), rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(tres.universal.numpy(), np.asarray(jres.universal), rtol=0,
                               atol=1e-3)


@pytest.mark.parametrize("frames,line_search", [(8, False), (8, True), (130, False),
                                                (130, True)])
def test_solve_sequence_matches_jax(frames, line_search):
    """solve_sequence on the 4-joint rig with the global scale universal:
    F = 8 (Thomas) plain and with the Armijo line search, F = 130 (SPIKE)."""
    jfn, tfn, p = _sequence_problem(frames)
    (jpf, ju), (tpf, tu) = _start(jfn, tfn, p)
    kw = dict(max_iterations=6, do_line_search=line_search)
    jres = jax.jit(lambda a, b: jsol.solve_sequence(jfn, a, b, JOpts(**kw)))(jpf, ju)
    _check_solve(jres, tsol.solve_sequence(tfn, tpf, tu, TOpts(**kw)))


def test_solve_sequence_f64_matches_jax_x64():
    """ROADMAP F13: the f64 mode follows JAX with x64 enabled: float64
    accumulation and factorization, float64 guards, a float32 step."""
    jfn, tfn, p = _sequence_problem(8, sequence=("smooth", "accel"))
    (jpf, ju), (tpf, tu) = _start(jfn, tfn, p)
    kw = dict(max_iterations=4, f64_normal_equations=True)
    with jax.enable_x64():
        jres = jax.jit(lambda a, b: jsol.solve_sequence(jfn, a, b, JOpts(**kw)))(jpf, ju)
        jres = jax.tree_util.tree_map(np.asarray, jres)
    tres = tsol.solve_sequence(tfn, tpf, tu, TOpts(**kw))
    assert tres.per_frame.dtype == torch.float32
    _check_solve(jres, tres)


@pytest.mark.parametrize("fullbody", [False, True], ids=["5", "5f"])
def test_config5_matches_jax(fullbody):
    """bench_suite.py config 5 (16-joint test rig) and 5f (full-body rig)
    cut to F = 130 frames (SPIKE with 4 parts): the port's workload against
    the JAX recipe (tools/jax_reference.py), final error within 1e-2."""
    prob = twork.build_sequence_problem(130, fullbody=fullbody, device="cpu")
    jfn, tfn, p = _sequence_problem(130, nj=16, universal=(6,) if fullbody else (),
                                    fullbody=fullbody, seed=0)
    np.testing.assert_allclose(to_numpy(prob.fn.per_frame_errors[0].target),
                               to_numpy(tfn.per_frame_errors[0].target), rtol=0, atol=1e-5)
    assert prob.fn.universal_index == jfn.universal_index
    jpf, ju = jfn.split(jnp.zeros((130, p)))
    with ThreadPoolExecutor(1) as pool:  # XLA runs outside the GIL
        jax_run = pool.submit(jax.jit(lambda a, b: jsol.solve_sequence(
            jfn, a, b, JOpts(max_iterations=8))), jpf, ju)
        tres = twork.make_sequence_solve(prob.fn)(prob.pf0, prob.u0)
        jres = jax_run.result()
    assert tres.iterations == int(jres.iterations) == 8
    assert abs(float(tres.error) / float(jres.error) - 1) <= 1e-2

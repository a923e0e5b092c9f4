"""Parity of the port's skinning family with momentum_tpu on the CPU, on the
full-body rig and numpy-seeded inputs: BlendShape, PoseShape, the
flattened-COO skinning, the inverse skinning (and its round trip), the
blended vertex matrices, the dense SkinWeights conversions, the mesh's
recomputed normals, and the rig extensions add_blend_shape_parameters /
add_face_expression_parameters.

Tolerance rtol 1e-5 (atol 1e-6 for entries near zero): both sides are
float32 chains of a few products whose summation order differs between the
frameworks. Integer and selection results (indices, parameter maps, names)
must be equal."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from momentum_tpu.character import skinning as jskin
from momentum_tpu.character.blend_shape import BlendShape as JBlendShape
from momentum_tpu.character.pose_shape import PoseShape as JPoseShape
from momentum_tpu.character.utility import (
    add_blend_shape_parameters as jadd_blend, add_face_expression_parameters as jadd_face)
from momentum_tpu_torch.bridge import character_from_numpy
from momentum_tpu_torch.character import skinning as tskin
from momentum_tpu_torch.character.blend_shape import BlendShape
from momentum_tpu_torch.character.pose_shape import PoseShape
from momentum_tpu_torch.character.utility import (
    add_blend_shape_parameters, add_face_expression_parameters)

from test_torch_port_helpers import (
    character_to_numpy, jax_fullbody_character, port_fullbody_character)

TOL = dict(rtol=1e-5, atol=1e-6)
B = 4


@pytest.fixture(scope="module")
def rig():
    """JAX and port rigs, B random poses and their JAX global states."""
    char_j = jax_fullbody_character()
    char_t = port_fullbody_character()
    rng = np.random.default_rng(11)
    x = rng.uniform(-0.3, 0.3, (B, char_j.num_model_parameters)).astype(np.float32)
    states = np.asarray(jax.vmap(char_j.skeleton_states)(jnp.asarray(x)))
    return char_j, char_t, x, states


def _bases(v, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.normal(0, 0.3, (v, 3)).astype(np.float32)
    vectors = rng.normal(0, 0.01, (5, v, 3)).astype(np.float32)
    coeffs = rng.uniform(-1, 1, (B, 5)).astype(np.float32)
    return base, vectors, coeffs


def test_blend_shape_matches_jax():
    base, vectors, coeffs = _bases(612)
    bj = JBlendShape(base_shape=jnp.asarray(base), shape_vectors=jnp.asarray(vectors))
    bt = BlendShape(base_shape=torch.as_tensor(base), shape_vectors=torch.as_tensor(vectors))
    assert (bt.num_shapes, bt.num_vertices) == (bj.num_shapes, bj.num_vertices) == (5, 612)
    np.testing.assert_allclose(bt.apply(torch.as_tensor(coeffs)).numpy(),
                               np.asarray(bj.apply(jnp.asarray(coeffs))), **TOL)
    np.testing.assert_allclose(bt.compute_deltas(torch.as_tensor(coeffs)).numpy(),
                               np.asarray(bj.compute_deltas(jnp.asarray(coeffs))), **TOL)
    target = np.asarray(bj.apply(jnp.asarray(coeffs)))
    for reg in (1.0, 1e-6):
        got = bt.estimate_coefficients(torch.as_tensor(target), regularization=reg).numpy()
        want = np.asarray(bj.estimate_coefficients(jnp.asarray(target), regularization=reg))
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    # with (almost) no ridge the fit recovers the coefficients
    np.testing.assert_allclose(
        bt.estimate_coefficients(torch.as_tensor(target), regularization=1e-6).numpy(),
        coeffs, atol=1e-3)


def test_pose_shape_matches_jax(rig):
    char_j, _, _, states = rig
    rng = np.random.default_rng(3)
    v, drivers = 40, (3, 7, 20)
    args = dict(base_rot=np.asarray([0.1, -0.2, 0.05, 0.97], np.float32),
                base_shape=rng.normal(0, 0.3, (v, 3)).astype(np.float32),
                shape_vectors=rng.normal(0, 0.05, (v, 3, 4 * len(drivers))).astype(np.float32))
    pj = JPoseShape(**{k: jnp.asarray(a) for k, a in args.items()}, base_joint=1,
                    joint_map=drivers)
    pt = PoseShape(**{k: torch.as_tensor(a) for k, a in args.items()}, base_joint=1,
                   joint_map=drivers)
    np.testing.assert_allclose(pt.compute(torch.as_tensor(states)).numpy(),
                               np.asarray(pj.compute(jnp.asarray(states))), **TOL)


def _coo(char_j, batch):
    """The rig's (V, 8) influences flattened to COO, the zero weights kept;
    batched: joint index b·nJ + j, vertex index b·V + v."""
    idx = np.asarray(char_j.skin_weights.index)
    w = np.asarray(char_j.skin_weights.weight)
    v, k = idx.shape
    nj = char_j.skeleton.num_joints
    verts = np.repeat(np.arange(v), k)
    if batch is None:
        return idx.reshape(-1), w.reshape(-1), verts
    b = np.arange(batch)[:, None]
    return ((b * nj + idx.reshape(1, -1)).reshape(-1), np.tile(w.reshape(-1), batch),
            (b * v + verts[None]).reshape(-1))


@pytest.mark.parametrize("batched", [False, True])
def test_skin_points_coo_matches_jax_and_dense_skinning(rig, batched):
    char_j, char_t, _, states = rig
    rest = np.asarray(char_j.mesh.vertices)
    ibp = np.asarray(char_j.inverse_bind_pose)
    st = states if batched else states[0]
    si, sw, vi = _coo(char_j, B if batched else None)
    want = np.asarray(jskin.skin_points_coo(jnp.asarray(rest), jnp.asarray(st), jnp.asarray(ibp),
                                            jnp.asarray(si.astype(np.int32)), jnp.asarray(sw),
                                            jnp.asarray(vi.astype(np.int32))))
    got = tskin.skin_points_coo(torch.as_tensor(rest), torch.as_tensor(st), torch.as_tensor(ibp),
                                torch.as_tensor(si), torch.as_tensor(sw),
                                torch.as_tensor(vi)).numpy()
    assert got.shape == want.shape == st.shape[:-2] + rest.shape
    np.testing.assert_allclose(got, want, **TOL)
    dense = tskin.skin_points(char_t.skin_weights, torch.as_tensor(st),
                              char_t.inverse_bind_pose, char_t.mesh.vertices).numpy()
    np.testing.assert_allclose(got, dense, **TOL)


def test_blended_matrices_and_inverse_skinning_match_jax(rig):
    """blended_vertex_matrices and apply_inverse_ssd against JAX, and the
    round trip unskin_points(skin_points(rest)) == rest."""
    char_j, char_t, _, states = rig
    ibp_t, st_t = char_t.inverse_bind_pose, torch.as_tensor(states)
    mats_j = jskin.skinning_matrices(jnp.asarray(states), char_j.inverse_bind_pose)
    mats_t = tskin.skinning_matrices(st_t, ibp_t)
    np.testing.assert_allclose(
        tskin.blended_vertex_matrices(char_t.skin_weights, mats_t).numpy(),
        np.asarray(jskin.blended_vertex_matrices(char_j.skin_weights, mats_j)), **TOL)
    posed = tskin.skin_points(char_t.skin_weights, st_t, ibp_t, char_t.mesh.vertices)
    rest_t = tskin.unskin_points(char_t.skin_weights, st_t, ibp_t, posed).numpy()
    rest_j = np.asarray(jskin.unskin_points(char_j.skin_weights, jnp.asarray(states),
                                            char_j.inverse_bind_pose,
                                            jnp.asarray(posed.numpy())))
    np.testing.assert_allclose(rest_t, rest_j, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(rest_t, np.broadcast_to(char_t.mesh.vertices.numpy(),
                                                       rest_t.shape), atol=1e-5)
    np.testing.assert_allclose(
        tskin.apply_inverse_ssd(char_t.skin_weights, mats_t, posed).numpy(), rest_t, **TOL)


def test_skin_weights_dense_conversions_match_jax(rig):
    char_j, char_t, _, _ = rig
    nj = char_j.skeleton.num_joints
    dense_j = char_j.skin_weights.to_dense(nj)
    dense_t = char_t.skin_weights.to_dense(nj)
    np.testing.assert_array_equal(dense_t.numpy(), dense_j)
    with pytest.raises(ValueError):
        char_t.skin_weights.to_dense(nj - 1)
    rng = np.random.default_rng(5)
    dense = rng.uniform(0, 1, (30, 12)).astype(np.float32)
    dense[dense < 0.6] = 0.0  # sparse rows, some with fewer than 4 influences
    dense[3] = 0.0  # an empty row
    dense[4, :3] = 0.25  # a tie
    for max_influences, threshold in ((4, 1e-6), (8, 0.7), (16, 0.0)):
        sj = jskin.SkinWeights.from_dense(dense, threshold, max_influences)
        st = tskin.SkinWeights.from_dense(torch.as_tensor(dense), threshold, max_influences)
        np.testing.assert_array_equal(st.index.numpy(), np.asarray(sj.index))
        np.testing.assert_allclose(st.weight.numpy(), np.asarray(sj.weight), **TOL)
    raw = tskin.SkinWeights(index=st.index, weight=2.5 * st.weight)
    np.testing.assert_allclose(
        raw.normalize_weights().weight.numpy(),
        np.asarray(jskin.SkinWeights(index=sj.index,
                                     weight=2.5 * sj.weight).normalize_weights().weight), **TOL)
    np.testing.assert_array_equal(raw.normalize_weights().weight.numpy()[3], 0.0)


def test_mesh_normals_match_jax(rig):
    char_j, char_t, _, _ = rig
    np.testing.assert_allclose(char_t.mesh.with_updated_normals().normals.numpy(),
                               np.asarray(char_j.mesh.with_updated_normals().normals), **TOL)


def test_shape_parameters_extend_the_rig_like_jax(rig):
    """add_blend_shape_parameters then add_face_expression_parameters: the
    same parameter transform, names and coefficient indices as JAX, carried
    through the bridge unchanged."""
    char_j, char_t, _, _ = rig
    v = char_j.mesh.num_vertices
    base, vectors, _ = _bases(v, seed=1)
    face = np.random.default_rng(2).normal(0, 0.01, (3, v, 3)).astype(np.float32)
    jb = JBlendShape(base_shape=jnp.asarray(base), shape_vectors=jnp.asarray(vectors))
    jf = JBlendShape(base_shape=jnp.zeros((v, 3)), shape_vectors=jnp.asarray(face))
    tb = BlendShape(base_shape=torch.as_tensor(base), shape_vectors=torch.as_tensor(vectors))
    tf = BlendShape(base_shape=torch.zeros(v, 3), shape_vectors=torch.as_tensor(face))
    ext_j = jadd_face(jadd_blend(char_j, jb), jf)
    ext_t = add_face_expression_parameters(add_blend_shape_parameters(char_t, tb), tf)
    assert ext_t.blend_shape_param_index == ext_j.blend_shape_param_index == tuple(range(157, 162))
    assert (ext_t.face_expression_param_index == ext_j.face_expression_param_index
            == tuple(range(162, 165)))
    # the bridge carries no names, so the port's rig names only the new ones
    assert ext_t.parameter_transform.names == ext_j.parameter_transform.names[157:]
    np.testing.assert_array_equal(ext_t.parameter_transform.transform.numpy(),
                                  np.asarray(ext_j.parameter_transform.transform))
    # the methods on Character are the same surgery
    assert char_t.with_blend_shape(tb).blend_shape_param_index == ext_t.blend_shape_param_index
    assert (char_t.with_face_expression_blend_shape(tf).face_expression_param_index
            == (157, 158, 159))
    d = character_to_numpy(ext_j)
    back = character_to_numpy(character_from_numpy(d, device="cpu"))
    assert back.keys() == d.keys()
    for k in d:
        np.testing.assert_array_equal(back[k], d[k], err_msg=k)
    assert dataclasses.replace(ext_t).shape_bases[1][1].tolist() == [162, 163, 164]

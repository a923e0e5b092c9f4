"""Parity of the port's axel (momentum_tpu_torch/axel/), mesh_ops,
support_polygon and support_contacts with momentum_tpu on the CPU, every
input made once in numpy and given to both.

Inputs: random fields of at most 11 × 9 × 7 voxels; a 320-face ellipsoid
(make_sphere(2), scaled and moved) and a 12-face box; grids of 16³; the
4-joint test rig for the support contacts.

Tolerances, each with what it holds:
  * SignedDistanceField.sample within 1e-6 relative to the field's largest
    value (measured: equal); gradient within 1e-5 of max|∇| of jax.grad's
    (measured 4e-7: the derivative summed in another order), exactly 0 on
    a clamped axis and halved exactly on a clamp bound in both; autograd
    through sample (reverse and forward) against jax.grad likewise;
  * mesh_to_sdf: |values| within 1e-5 of the grid's extent, signs equal on
    ≥ 99% of the voxels, every sign that differs at a crease tie (two
    faces within 1e-6 of the closest distance, float64); origin and
    spacing equal;
  * winding numbers 1e-5 absolute; morphology exact;
  * closest points 1e-5, squared distances 1e-5 relative (measured
    3.4e-6: cp − p cancels for near points), the face index
    exact wherever the second-closest face is over 1e-6 farther (float64);
  * rays: hit masks and face indices exact, t within 1e-5; knn indices
    exact (ties in index order, as lax.top_k), squared distances 1e-6;
    grid tables exact, grid queries as the brute-force ones;
  * solve_cubic and times_coplanar: valid masks exact, valid roots within
    1e-3 (the float32 trigonometric and Cardano forms, cbrt as a power; a
    root near a double root moves by ~√eps, 3.5e-4: measured 1.8e-4 against
    jitted JAX); the CCD predicates exact;
  * hole filling, support_polygon, convex_hull_2d: exact (the same numpy
    code), support_polygon_from_world_points 1e-6 (the plane coordinates
    summed in another order: measured 1.2e-7); sdf_to_mesh 1e-6, dual_contouring 1e-5 (F4: the float32 Newton
    projection of both, iterating past the clamp);
  * sdf_io: the written bytes equal JAX's, and a round trip is exact;
  * mesh_ops: the intersection predicate and the pair list exact;
  * support contacts: positions 1e-5, masks exact.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import momentum_tpu.axel as jax_axel
from momentum_tpu.axel import ccd as jccd, sdf as jsdf, sdf_io as jio
from momentum_tpu.character import support_contacts as jsc
from momentum_tpu.math import mesh_ops as jmo, support_polygon as jsp
from momentum_tpu.rasterizer.primitives import make_sphere
from momentum_tpu.testing.fixtures import create_test_character as jax_test_character
import momentum_tpu_torch.axel as tax
from momentum_tpu_torch import bridge
from momentum_tpu_torch.axel import ccd as tccd, sdf as tsdf, sdf_io as tio
from momentum_tpu_torch.character import support_contacts as tsc
from momentum_tpu_torch.math import mesh_ops as tmo, support_polygon as tsp

from test_torch_port_helpers import character_to_numpy
from test_torch_port_helpers import one_torch_thread  # noqa: F401

GRAD_TOL = 1e-5
EXTENT_TOL = 1e-5
SIGN_SHARE = 0.99
TIE = 1e-6


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _field(seed=0, shape=(11, 9, 7)):
    rng = np.random.default_rng(seed)
    return dict(origin=np.asarray([-0.4, 0.1, -0.3], np.float32),
                spacing=np.asarray([0.12, 0.09, 0.15], np.float32),
                values=rng.normal(0, 0.5, shape).astype(np.float32))


def _both(d):
    return (jsdf.SignedDistanceField(**{k: jnp.asarray(v) for k, v in d.items()}),
            tsdf.SignedDistanceField.create(**d, device="cpu"))


def _points(d, seed=1):
    """Points inside, outside, exactly on each face and on the 8 corners of
    the field's grid box [origin, origin + (n − 1)·spacing]."""
    rng = np.random.default_rng(seed)
    lo = d["origin"].astype(np.float64)
    hi = lo + d["spacing"] * (np.asarray(d["values"].shape) - 1)
    pts = [rng.uniform(lo, hi, (60, 3)), rng.uniform(lo - 0.5, hi + 0.5, (60, 3))]
    for axis in range(3):
        for bound in (lo, hi):
            face = rng.uniform(lo, hi, (6, 3))
            face[:, axis] = bound[axis]
            pts.append(face)
    pts.append(np.stack(np.meshgrid(*zip(lo, hi), indexing="ij"), -1).reshape(-1, 3))
    return np.concatenate(pts).astype(np.float32)


def test_sample_and_gradient_match_jax():
    d = _field()
    js, ts = _both(d)
    p = _points(d)
    sj = np.asarray(js.sample(jnp.asarray(p)))
    st = ts.sample(_t(p)).numpy()
    np.testing.assert_allclose(st, sj, rtol=0, atol=1e-6 * np.abs(d["values"]).max())
    gj = np.asarray(js.gradient(jnp.asarray(p)))
    gt = ts.gradient(_t(p)).numpy()
    np.testing.assert_allclose(gt, gj, rtol=0, atol=GRAD_TOL * np.abs(gj).max())
    g0 = (p - d["origin"]) / d["spacing"]
    top = np.asarray(d["values"].shape, np.float32) - 1 - np.float32(1e-6)
    clamped = (g0 < 0) | (g0 > top)
    assert clamped.any() and (gt[clamped] == 0).all() and (gj[clamped] == 0).all()
    # on a bound the clamp's derivative is split 0.5/0.5 (JAX's maximum):
    # the same there as half the interior derivative of the same lerps
    on_lo = g0 == 0
    assert on_lo.any()
    np.testing.assert_allclose(gt[on_lo], gj[on_lo], rtol=0, atol=GRAD_TOL * np.abs(gj).max())
    # autograd through sample, reverse and forward mode, gives the same
    x = _t(p).requires_grad_()
    ts.sample(x).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), gj, rtol=0, atol=GRAD_TOL * np.abs(gj).max())
    for axis in range(3):
        e = torch.zeros_like(_t(p))
        e[:, axis] = 1.0
        _, tan = torch.func.jvp(ts.sample, (_t(p),), (e,))
        np.testing.assert_allclose(tan.numpy(), gj[:, axis], rtol=0,
                                   atol=GRAD_TOL * np.abs(gj).max())
    vj, gwj = js.sample_with_gradient(jnp.asarray(p[:5]))
    vt, gwt = ts.sample_with_gradient(_t(p[:5]))
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=1e-6)
    np.testing.assert_allclose(gwt.numpy(), np.asarray(gwj), atol=GRAD_TOL)


def test_sample_of_a_nan_point_is_nan():
    """A NaN point's corner index is clamped in range (ROADMAP F3) and its
    sample stays NaN, as JAX's clamped gather gives."""
    js, ts = _both(_field())
    p = np.asarray([[np.nan, 0.2, 0.1], [0.1, 0.3, 0.0]], np.float32)
    st = ts.sample(_t(p)).numpy()
    assert np.isnan(st[0]) and np.isfinite(st[1])
    assert np.isnan(np.asarray(js.sample(jnp.asarray(p)))[0])


def test_field_member_surface():
    d = _field(shape=(5, 4, 3))
    js, ts = _both(d)
    q = np.asarray([[0.0, 0.2, 0.0], [5.0, 0.0, 0.0], [-0.4, 0.1, -0.3]], np.float32)
    assert ts.resolution == tuple(js.resolution) and ts.total_voxels == js.total_voxels
    for name in ("voxel_size", "min_corner", "max_corner"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(), np.asarray(getattr(js, name)))
    for a, b in zip(ts.bounds, js.bounds):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_allclose(ts.world_to_grid(q).numpy(), np.asarray(js.world_to_grid(q)),
                               atol=1e-6)
    np.testing.assert_allclose(ts.grid_to_world(q).numpy(), np.asarray(js.grid_to_world(q)),
                               atol=1e-6)
    np.testing.assert_array_equal(ts.contains(q).numpy(), np.asarray(js.contains(q)))
    for ijk in ((0, 0, 0), (4, 3, 2), (5, 0, 0), (0, -1, 0)):
        assert ts.is_valid_index(*ijk) == js.is_valid_index(*ijk)


def _ellipsoid():
    v, f = make_sphere(2)
    v = v * np.asarray([0.5, 0.7, 0.4], np.float32) + np.asarray([0.1, -0.2, 0.3], np.float32)
    return v.astype(np.float32), np.asarray(f, np.int32)


def _box():
    v = np.asarray([[x, y, z] for x in (0.0, 1.0) for y in (0.0, 0.6) for z in (0.0, 0.8)],
                   np.float32)
    quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1), (2, 3, 7, 6), (0, 2, 6, 4), (1, 5, 7, 3)]
    f = [[a, b, c] for a, b, c, _ in quads] + [[a, c, d] for a, _, c, d in quads]
    return v, np.asarray(f, np.int32)


def _crease_tie(p, v, f):
    """Whether two faces lie within TIE of p's closest distance (float64)."""
    from momentum_tpu_torch.math.geometry import point_triangle_closest_point

    tri = torch.as_tensor(v.astype(np.float64))[torch.as_tensor(f.astype(np.int64))]
    pt = torch.as_tensor(p.astype(np.float64))
    cp, _ = point_triangle_closest_point(pt[None], tri[:, 0], tri[:, 1], tri[:, 2])
    dist = np.sort(torch.linalg.vector_norm(cp - pt, dim=-1).numpy())
    return dist[1] - dist[0] <= TIE


@pytest.mark.parametrize("mesh", ["ellipsoid", "box"])
@pytest.mark.parametrize("sign_method", ["normal", "winding"])
def test_mesh_to_sdf_matches_jax(mesh, sign_method):
    v, f = _ellipsoid() if mesh == "ellipsoid" else _box()
    res = (16, 16, 16)
    js = jsdf.mesh_to_sdf(v, f, res, sign_method=sign_method)
    ts = tsdf.mesh_to_sdf(v, f, res, sign_method=sign_method, device="cpu")
    np.testing.assert_array_equal(ts.origin.numpy(), np.asarray(js.origin))
    np.testing.assert_array_equal(ts.spacing.numpy(), np.asarray(js.spacing))
    jv, tv = np.asarray(js.values), ts.values.numpy()
    extent = float(np.max(np.asarray(js.spacing) * 15))
    np.testing.assert_allclose(np.abs(tv), np.abs(jv), rtol=0, atol=EXTENT_TOL * extent)
    differ = np.sign(tv) != np.sign(jv)
    assert 1 - differ.mean() >= SIGN_SHARE
    grid = np.stack(np.meshgrid(*[np.asarray(js.origin)[i] + np.arange(16) * np.asarray(
        js.spacing)[i] for i in range(3)], indexing="ij"), -1)
    assert all(_crease_tie(p, v, f) for p in grid[differ])


def test_mesh_to_sdf_cleanup_and_winding_match_jax():
    v, f = _ellipsoid()
    kw = dict(sign_method="normal", open_iters=1, close_iters=1)
    js = jsdf.mesh_to_sdf(v, f, (16, 16, 16), **kw)
    ts = tsdf.mesh_to_sdf(v, f, (16, 16, 16), device="cpu", **kw)
    np.testing.assert_array_equal(np.sign(ts.values.numpy()), np.sign(np.asarray(js.values)))
    p = np.random.default_rng(2).uniform(-1, 1, (200, 3)).astype(np.float32)
    np.testing.assert_allclose(tsdf.winding_number(p, v, f, chunk=64).numpy(),
                               np.asarray(jsdf.winding_number(p, v, f, chunk=64)), atol=1e-5)
    mask = np.random.default_rng(3).uniform(size=(7, 6, 5)) > 0.4
    for o, c in ((1, 0), (0, 1), (2, 1)):
        np.testing.assert_array_equal(
            tsdf.morphological_cleanup(_t(mask), o, c).numpy(),
            np.asarray(jsdf.morphological_cleanup(jnp.asarray(mask), o, c)))


def test_closest_point_matches_jax():
    """120 points, JAX's default chunk: the shapes of the grid test's
    brute-force pass, whose compile the two share; the port in chunks of
    32."""
    v, f = _ellipsoid()
    p = np.random.default_rng(4).uniform(-1, 1, (120, 3)).astype(np.float32)
    jcp, jfi, jbary, jd2 = (np.asarray(a) for a in jax_axel.closest_point_on_mesh(
        jnp.asarray(p), jnp.asarray(v), jnp.asarray(f)))
    tcp, tfi, tbary, td2 = (a.numpy() for a in tax.closest_point_on_mesh(p, v, f, chunk=32))
    np.testing.assert_allclose(tcp, jcp, atol=1e-5)
    np.testing.assert_allclose(td2, jd2, rtol=1e-5, atol=1e-9)
    tie = np.asarray([_crease_tie(q, v, f) for q in p])
    assert (~tie).sum() >= 30  # outside points mostly meet a vertex, shared by 5-6 faces
    np.testing.assert_array_equal(tfi[~tie], jfi[~tie])
    np.testing.assert_allclose(tbary[~tie], jbary[~tie], atol=1e-4)


def test_ray_and_knn_match_jax():
    v, f = _ellipsoid()
    rng = np.random.default_rng(5)
    o = rng.uniform(-2, 2, (100, 3)).astype(np.float32)
    d = (v.mean(0) - o + rng.normal(0, 0.4, (100, 3))).astype(np.float32)
    jt, jfi, jhit = (np.asarray(a) for a in jax_axel.ray_mesh_intersect(o, d, v, f))
    tt, tfi, thit = (a.numpy() for a in tax.ray_mesh_intersect(o, d, v, f))
    assert 20 < jhit.sum() < 100
    np.testing.assert_array_equal(thit, jhit)
    np.testing.assert_array_equal(tfi, jfi)
    np.testing.assert_allclose(tt[jhit], jt[jhit], rtol=1e-5)
    # knn, with duplicated points making exact distance ties
    pts = np.concatenate([v, v[:40]]).astype(np.float32)
    q = rng.uniform(-1, 1, (30, 3)).astype(np.float32)
    q[:5] = v[:5]
    ji, jd = (np.asarray(a) for a in jax_axel.knn(jnp.asarray(pts), jnp.asarray(q), 7))
    ti, td = (a.numpy() for a in tax.knn(pts, q, 7))
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(td, jd, rtol=1e-6, atol=1e-9)


def test_triangle_grid_matches_jax():
    v, f = _ellipsoid()
    jg = jax_axel.build_triangle_grid(v, f, resolution=6)
    tg = tax.build_triangle_grid(v, f, resolution=6, device="cpu")
    np.testing.assert_array_equal(tg.cells.numpy(), np.asarray(jg.cells))
    np.testing.assert_array_equal(tg.origin.numpy(), np.asarray(jg.origin))
    assert float(tg.cell_size) == float(jg.cell_size) and tg.max_per_cell == jg.max_per_cell
    carried = bridge.triangle_grid_from_numpy(
        dict(cells=np.asarray(jg.cells), origin=np.asarray(jg.origin),
             cell_size=np.asarray(jg.cell_size), resolution=jg.resolution), device="cpu")
    np.testing.assert_array_equal(carried.cells.numpy(), tg.cells.numpy())
    rng = np.random.default_rng(6)
    p = rng.uniform(-0.8, 0.8, (120, 3)).astype(np.float32)
    for exact in (True, False):
        jcp, jfi, jd2 = (np.asarray(a) for a in jax_axel.closest_point_on_mesh_grid(
            jg, p, jnp.asarray(v), jnp.asarray(f), exact=exact))
        tcp, tfi, td2 = (a.numpy() for a in tax.closest_point_on_mesh_grid(tg, p, v, f, exact))
        np.testing.assert_allclose(tcp, jcp, atol=1e-5)
        np.testing.assert_allclose(td2, jd2, rtol=1e-5, atol=1e-9)
        tie = np.asarray([_crease_tie(q, v, f) for q in p])
        np.testing.assert_array_equal(tfi[~tie], jfi[~tie])
    o = rng.uniform(-2, 2, (60, 3)).astype(np.float32)
    d = (-o + rng.normal(0, 0.2, (60, 3))).astype(np.float32)
    jt, jfi, jhit = (np.asarray(a) for a in jax_axel.ray_mesh_intersect_grid(
        jg, o, d, jnp.asarray(v), jnp.asarray(f)))
    tt, tfi, thit = (a.numpy() for a in tax.ray_mesh_intersect_grid(tg, o, d, v, f))
    assert jhit.sum() > 30
    np.testing.assert_array_equal(thit, jhit)
    np.testing.assert_array_equal(tfi, jfi)
    np.testing.assert_allclose(tt[jhit], jt[jhit], rtol=1e-5)


def test_solve_cubic_and_ccd_match_jax():
    rng = np.random.default_rng(7)
    c = rng.normal(0, 1, (4, 400)).astype(np.float32)
    c[0, :40] = 0.0  # quadratic
    c[:2, 40:80] = 0.0  # linear
    c[:3, 80:90] = 0.0  # nothing left
    c[0, 90:100] = 1e-31  # below the degenerate threshold
    jr, jv = (np.asarray(a) for a in jax.jit(jccd.solve_cubic)(*map(jnp.asarray, c)))
    tr, tv = (a.numpy() for a in tccd.solve_cubic(*map(_t, c)))
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_allclose(tr[jv], jr[jv], rtol=1e-3, atol=1e-3)
    x = rng.normal(0, 1, (8, 300, 3)).astype(np.float32)
    v = rng.normal(0, 1, (8, 300, 3)).astype(np.float32)
    jargs, targs = [jnp.asarray(a) for a in (*x[:4], *v[:4])], [_t(a) for a in (*x[:4], *v[:4])]
    names = ("ccd_edge_edge", "ccd_vertex_triangle")
    (jroots, jvalid), jhits, jdist = jax.jit(lambda *a: (
        jccd.times_coplanar(*a), [getattr(jccd, n)(*a, 0.3, 1.0) for n in names],
        jccd.distance_edge_edge(*a[:4])))(*jargs)
    troots, tvalid = tccd.times_coplanar(*targs)
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))
    jvm = np.asarray(jvalid)
    np.testing.assert_allclose(troots.numpy()[jvm], np.asarray(jroots)[jvm], rtol=1e-3,
                               atol=1e-3)
    for name, j in zip(names, jhits):
        j = np.asarray(j)
        t = getattr(tccd, name)(*targs, 0.3, 1.0).numpy()
        assert 0 < j.sum() < len(j)
        np.testing.assert_array_equal(t, j)
    js, jt, jd, jn = (np.asarray(a) for a in jdist)
    ts, tt, td, tn = (a.numpy() for a in tccd.distance_edge_edge(*targs[:4]))
    np.testing.assert_allclose(td, jd, atol=1e-5)
    np.testing.assert_array_equal(tn, jn)


def _punctured():
    """The ellipsoid with faces cut out around three vertices and a band:
    holes of several sizes."""
    v, f = _ellipsoid()
    keep = ~np.isin(f, [0, 7, 30]).any(1)
    keep &= ~((v[f][:, :, 1].mean(1) > 0.35) & (v[f][:, :, 0].mean(1) > 0.2))
    return v, f[keep]


@pytest.mark.parametrize("method", ["centroid", "ear_clipping", "spherical_cap", "auto"])
def test_hole_filling_matches_jax(method):
    v, f = _punctured()
    jh = jax_axel.detect_mesh_holes(v, f)
    th = tax.detect_mesh_holes(v, f)
    assert len(jh) == len(th) >= 3
    for a, b in zip(jh, th):
        np.testing.assert_array_equal(b.vertices, a.vertices)
        np.testing.assert_array_equal(b.center, a.center)
        assert b.radius == a.radius
    for a, b in zip(jax_axel.fill_hole(jh[0], v, method), tax.fill_hole(th[0], v, method)):
        np.testing.assert_array_equal(b, a)
    kw = dict(method=method, max_hole_size=12, smoothing_iterations=2)
    for a, b in zip(jax_axel.fill_holes(v, f, **kw), tax.fill_holes(v, f, **kw)):
        np.testing.assert_array_equal(b, a)
    mask = np.arange(len(v)) % 3 == 0
    np.testing.assert_array_equal(tax.smooth_mesh_laplacian(v, f, mask, 2),
                                  jax_axel.smooth_mesh_laplacian(v, f, mask, 2))


def test_surface_extraction_matches_jax():
    """sdf_to_mesh, and dual_contouring under F4 (the float32 Newton
    projection, iterating on after the 2×-voxel clamp), from one field."""
    v, f = _ellipsoid()
    js = jsdf.mesh_to_sdf(v, f, (8, 8, 8), sign_method="winding")
    ts = bridge.sdf_from_numpy({k: np.asarray(getattr(js, k))
                                for k in ("origin", "spacing", "values")}, device="cpu")
    jv, jf = (np.asarray(a) for a in jsdf.sdf_to_mesh(js))
    tv, tf = (a.numpy() for a in tsdf.sdf_to_mesh(ts))
    assert len(jf) > 50
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_allclose(tv, jv, atol=1e-6)
    jv, jq = jsdf.dual_contouring(js, 0.05)
    tv, tq = tsdf.dual_contouring(ts, 0.05)
    assert tv.dtype == np.float64 and len(jq) > 50
    np.testing.assert_array_equal(tq, jq)
    np.testing.assert_allclose(tv, jv, atol=1e-5)
    np.testing.assert_array_equal(tsdf.triangulate_quads(tq), jsdf.triangulate_quads(jq))


def test_sdf_io_bytes_equal_jax(tmp_path):
    d = _field(shape=(5, 4, 3))
    js, ts = _both(d)
    jio.save_sdf_to_msgpack(js, tmp_path / "j.msgpack")
    tio.save_sdf_to_msgpack(ts, tmp_path / "t.msgpack")
    assert (tmp_path / "t.msgpack").read_bytes() == (tmp_path / "j.msgpack").read_bytes()
    back = tio.load_sdf_from_msgpack(tmp_path / "j.msgpack", device="cpu")
    for k in ("values", "origin"):
        np.testing.assert_array_equal(getattr(back, k).numpy(), getattr(ts, k).numpy())
    np.testing.assert_allclose(back.spacing.numpy(), ts.spacing.numpy(), rtol=1e-6)
    jio.save_sdfs_to_msgpack({"a": js, "b": (js, "joint2")}, tmp_path / "jm.msgpack")
    tio.save_sdfs_to_msgpack({"a": ts, "b": (ts, "joint2")}, tmp_path / "tm.msgpack")
    assert (tmp_path / "tm.msgpack").read_bytes() == (tmp_path / "jm.msgpack").read_bytes()
    many = tio.load_sdfs_from_msgpack(tmp_path / "jm.msgpack", device="cpu")
    assert set(many) == {"a", "b"} and many["b"][1] == "joint2" and many["a"][1] == ""
    np.testing.assert_array_equal(many["b"][0].values.numpy(), d["values"])


def test_mesh_ops_match_jax():
    rng = np.random.default_rng(8)
    tris = rng.normal(0, 1, (6, 500, 3)).astype(np.float32)
    j = np.asarray(jmo._tri_tri_intersect(*map(jnp.asarray, tris)))
    t = tmo._tri_tri_intersect(*map(_t, tris)).numpy()
    assert 0 < j.sum() < len(j)
    np.testing.assert_array_equal(t, j)
    v, f = make_sphere(1)  # 80 faces, and a copy moved half a radius
    v2 = np.concatenate([v, v + np.asarray([0.5, 0.1, 0.0], np.float32)]).astype(np.float32)
    f2 = np.concatenate([f, f + len(v)]).astype(np.int32)
    jp = jmo.intersect_mesh_brute_force(jnp.asarray(v2), f2)
    tp = tmo.intersect_mesh_brute_force(v2, f2)
    assert len(jp) > 0
    np.testing.assert_array_equal(tp, jp)
    pts = rng.uniform(-1, 1, (40, 3)).astype(np.float32)
    np.testing.assert_array_equal(tmo.support_polygon(pts, 1, 0.8),
                                  jmo.support_polygon(pts, 1, 0.8))


def test_support_plane_and_hull_match_jax():
    rng = np.random.default_rng(9)
    pts = rng.normal(0, 1, (50, 3)).astype(np.float32)
    for kw in (dict(), dict(normal=(0.2, 1.0, -0.3), offset=0.4),
               dict(normal=(1.0, 0.0, 0.0), u_hint=(2.0, 0.0, 0.0))):
        jp, tp = jsp.SupportPlane.create(**kw), tsp.SupportPlane.create(device="cpu", **kw)
        for name in ("normal", "offset", "u_axis", "v_axis"):
            np.testing.assert_array_equal(getattr(tp, name).numpy(), np.asarray(getattr(jp, name)))
        for name in ("signed_distance", "project_point", "coordinates"):
            np.testing.assert_allclose(getattr(tp, name)(_t(pts)).numpy(),
                                       np.asarray(getattr(jp, name)(jnp.asarray(pts))), atol=1e-6)
        uv = pts[:, :2]
        np.testing.assert_allclose(tp.point_from_coordinates(_t(uv)).numpy(),
                                   np.asarray(jp.point_from_coordinates(jnp.asarray(uv))),
                                   atol=1e-6)
        np.testing.assert_allclose(tsp.support_polygon_from_world_points(pts, tp),
                                   jsp.support_polygon_from_world_points(pts, jp), atol=1e-6)
    np.testing.assert_allclose(tsp.cross2d(pts[:, :2], pts[::-1, :2], pts[:, 1:]).numpy(),
                               np.asarray(jsp.cross2d(pts[:, :2], pts[::-1, :2], pts[:, 1:])),
                               atol=1e-6)
    for cloud in (pts[:, :2], pts[:2, :2], np.zeros((0, 2)),
                  np.stack([np.arange(5.0), 2 * np.arange(5.0)], 1)):
        np.testing.assert_array_equal(tsp.convex_hull_2d(cloud), jsp.convex_hull_2d(cloud))
    with pytest.raises(ValueError):
        tsp.SupportPlane.create(normal=(0.0, 0.0, 0.0), device="cpu")


def test_support_contacts_match_jax():
    """The six public names on the 4-joint test rig (its four capsules along
    +Y) with two of its locators renamed as floor locators, B = 3 poses
    against the plane y = 0.3: the port batched, JAX unbatched per pose
    (its per-parent dedup holds unbatched only, ROADMAP F23)."""
    import dataclasses

    jchar = jax_test_character(4)
    names = ("Floor_a", "l1", "FloorB", "l3")
    jchar = dataclasses.replace(jchar, locators=dataclasses.replace(jchar.locators, names=names))
    tchar = bridge.character_from_numpy(character_to_numpy(jchar, names=True), device="cpu")
    x = np.random.default_rng(10).uniform(-0.5, 0.5, (3, jchar.num_model_parameters))
    x = x.astype(np.float32)
    jplane = jsp.SupportPlane.create(offset=0.3)
    tplane = tsp.SupportPlane.create(offset=0.3, device="cpu")
    tstates = tchar.skeleton_states(_t(x))
    assert tsc.is_floor_locator_name("Floor_x") and not tsc.is_floor_locator_name("l_Floor")
    np.testing.assert_array_equal(tsc.floor_locator_mask(tchar.locators),
                                  jsc.floor_locator_mask(jchar.locators))
    for b in range(3):
        jst = jchar.skeleton_states(jnp.asarray(x[b]))
        for name, margin in (("floor_locator_support_contacts", 0.5),
                             ("plane_collision_support_contacts", 0.2)):
            j = getattr(jsc, name)(jchar, jst, margin, jplane)
            t = getattr(tsc, name)(tchar, tstates, margin, tplane)
            for k, v in j.items():
                tv = t[k][b] if t[k].ndim > np.ndim(v) else t[k]
                if np.asarray(v).dtype == bool or k == "parent":
                    np.testing.assert_array_equal(tv.numpy(), np.asarray(v))
                else:
                    np.testing.assert_allclose(tv.numpy(), np.asarray(v), atol=1e-5)
        jpos, jact = jsc.support_contact_positions(jchar, jst, 0.2, jplane)
        tpos, tact = tsc.support_contact_positions(tchar, tstates, 0.2, tplane)
        np.testing.assert_allclose(tpos[b].numpy(), np.asarray(jpos), atol=1e-5)
        np.testing.assert_array_equal(tact[b].numpy(), np.asarray(jact))
        np.testing.assert_allclose(
            tsc.support_polygon_from_contacts(tchar, tstates[b], 0.2, tplane),
            jsc.support_polygon_from_contacts(jchar, jst, 0.2, jplane), atol=1e-5)
    assert tsc.support_contacts is tsc.support_contact_positions
    assert tsc.support_polygon is tsc.support_polygon_from_contacts
    assert tsc.plane_collision_contacts_by_parent is tsc.plane_collision_support_contacts


def test_axel_exports_are_jax():
    public = {n for n in dir(jax_axel) if not n.startswith("_")}
    assert public <= set(dir(tax))
    assert tax.fill_holes is tax.fill_mesh_holes

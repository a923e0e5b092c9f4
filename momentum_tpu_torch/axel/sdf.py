"""Signed distance fields: trilinear grid sampling and mesh → SDF conversion,
after momentum_tpu/axel/sdf.py (the reference's
axel/SignedDistanceField.h:29 and axel/MeshToSdf.h:24-230).

`sample` is the trilinear lookup with JAX's border rules: the grid
coordinate clamped to [0, n − 1 − 1e-6] (as minimum(maximum(·)), whose
derivative splits a tie 0.5/0.5 in both autograd modes, as JAX's does),
the lower corner i0 = floor(g) with the fraction taken before i0 is capped
at n − 2, the eight corners lerped in JAX's order. `gradient` is the
closed-form derivative of the same lerps times the clamp's derivative (0
along an axis where the point is clamped, 0.5 exactly on a clamp bound),
which is what jax.grad of `sample` gives.

`mesh_to_sdf` builds the grid by brute-force closest-triangle queries over
every face (axel/queries.py) in chunks, signed by the closest face's normal
or by the generalized winding number; on the card when the caller does not
ask for the CPU. `sdf_to_mesh` and `dual_contouring` extract the zero level
set on the host, the latter pushing its vertices onto the surface by a
float32 Newton projection on the field's device (ROADMAP F4: what the JAX
code does, which iterates on after its 2×-voxel clamp fires).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from momentum_tpu_torch.axel.queries import closest_point_on_mesh
from momentum_tpu_torch.device import resolve, to_host

__all__ = ["SignedDistanceField", "mesh_to_sdf", "mesh_grid", "mesh_distances",
           "winding_number", "morphological_cleanup", "sdf_to_mesh", "dual_contouring",
           "triangulate_quads"]


def _norm(x: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """‖x‖ over the last axis as jnp.linalg.norm computes it."""
    return torch.sqrt(torch.sum(x * x, dim=-1, keepdim=keepdim))


@dataclasses.dataclass(frozen=True, eq=False)
class SignedDistanceField:
    origin: torch.Tensor  # (3,)
    spacing: torch.Tensor  # (3,)
    values: torch.Tensor  # (nx, ny, nz)

    @classmethod
    def create(cls, origin, spacing, values, device="cuda") -> "SignedDistanceField":
        """A field from array-likes, float32 on `device` (the card unless the
        caller asks for the CPU)."""
        device = resolve(device, "SignedDistanceField.create")
        f32 = lambda a: torch.as_tensor(np.array(to_host(a), np.float32), device=device)
        return cls(origin=f32(origin), spacing=f32(spacing), values=f32(values))

    @property
    def resolution(self):
        return tuple(self.values.shape)

    def _grid(self, points: torch.Tensor):
        """(clamped grid coordinates g (..., 3), unclamped g0, the clamp's
        upper bound (3,))."""
        g0 = (points - self.origin) / self.spacing
        hi = torch.tensor([n - 1 for n in self.values.shape], dtype=g0.dtype,
                          device=g0.device) - 1e-6
        return torch.minimum(torch.maximum(g0, g0.new_zeros(())), hi), g0, hi

    def _corners(self, g: torch.Tensor):
        """(the 8 corner values, keyed (dx, dy, dz), each (...), fractions
        (..., 3)). The fraction is taken before i0 is capped at n − 2, as in
        JAX."""
        i0 = torch.floor(g).to(torch.int64)
        f = g - i0.to(g.dtype)
        nx, ny, nz = self.values.shape
        i0 = torch.minimum(i0, torch.tensor([nx - 2, ny - 2, nz - 2], device=g.device))
        # a NaN point's corner is no index at all: clamp it in range (ROADMAP
        # F3, JAX's clamped gather); its fraction keeps the sample NaN
        i0 = torch.clamp(i0, min=0)
        flat = self.values.reshape(-1)
        ix, iy, iz = i0.unbind(-1)
        base = (ix * ny + iy) * nz + iz
        at = {(dx, dy, dz): flat[base + (dx * ny + dy) * nz + dz]
              for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)}
        return at, f

    @staticmethod
    def _lerps(at, f):
        """The x-lerps (c00, c10, c01, c11), the y-lerps (c0, c1) and the
        value, in JAX's order."""
        fx, fy, fz = f.unbind(-1)
        c00 = at[0, 0, 0] * (1 - fx) + at[1, 0, 0] * fx
        c10 = at[0, 1, 0] * (1 - fx) + at[1, 1, 0] * fx
        c01 = at[0, 0, 1] * (1 - fx) + at[1, 0, 1] * fx
        c11 = at[0, 1, 1] * (1 - fx) + at[1, 1, 1] * fx
        c0 = c00 * (1 - fy) + c10 * fy
        c1 = c01 * (1 - fy) + c11 * fy
        return (c00, c10, c01, c11), (c0, c1), c0 * (1 - fz) + c1 * fz

    def sample(self, points: torch.Tensor) -> torch.Tensor:
        """Trilinear sample at world points (..., 3), clamped at the border
        (SignedDistanceField.h sample)."""
        return self._lerps(*self._corners(self._grid(points)[0]))[2]

    def gradient(self, points: torch.Tensor) -> torch.Tensor:
        """∇sdf at world points (..., 3): the lerps' derivative in the grid
        coordinate times the clamp's (1 inside, 0 clamped, 0.5 on a bound),
        over the spacing."""
        g, g0, hi = self._grid(points)
        at, f = self._corners(g)
        (c00, c10, c01, c11), (c0, c1), _ = self._lerps(at, f)
        _, fy, fz = f.unbind(-1)
        # d/dfx of each x-lerp, carried through the y and z lerps
        dx = {k: at[(1,) + k] - at[(0,) + k] for k in ((0, 0), (1, 0), (0, 1), (1, 1))}
        ddx = ((dx[0, 0] * (1 - fy) + dx[1, 0] * fy) * (1 - fz)
               + (dx[0, 1] * (1 - fy) + dx[1, 1] * fy) * fz)
        ddy = (c10 - c00) * (1 - fz) + (c11 - c01) * fz
        d_lerp = torch.stack([ddx, ddy, c1 - c0], dim=-1)
        m = torch.maximum(g0, g0.new_zeros(()))
        d_lo = torch.where(g0 == 0, 0.5, (g0 > 0).to(g0.dtype))
        d_hi = torch.where(m == hi, 0.5, (m < hi).to(g0.dtype))
        return d_lerp * d_lo * d_hi / self.spacing

    # ---- pymomentum.axel SignedDistanceField member surface
    # (axel_pybind.cpp; SignedDistanceField.h:60-262) ----

    @property
    def voxel_size(self) -> torch.Tensor:
        """(3,) voxel extents (SignedDistanceField voxelSize)."""
        return self.spacing

    @property
    def min_corner(self) -> torch.Tensor:
        return self.origin

    @property
    def max_corner(self) -> torch.Tensor:
        return self.origin + self.spacing * torch.tensor(
            self.values.shape, dtype=self.origin.dtype, device=self.origin.device)

    @property
    def bounds(self):
        """(min_corner, max_corner) tuple."""
        return self.min_corner, self.max_corner

    @property
    def total_voxels(self) -> int:
        nx, ny, nz = self.values.shape
        return nx * ny * nz

    def sample_with_gradient(self, points: torch.Tensor):
        """(values, gradients) in one call (SignedDistanceField
        sampleWithGradient)."""
        return self.sample(points), self.gradient(points)

    def _f32(self, points) -> torch.Tensor:
        return torch.as_tensor(points, dtype=torch.float32, device=self.origin.device)

    def world_to_grid(self, points) -> torch.Tensor:
        """World → fractional grid coordinates (SignedDistanceField.cpp:210)."""
        return (self._f32(points) - self.origin) / self.spacing

    def grid_to_world(self, grid_pos) -> torch.Tensor:
        return self.origin + self._f32(grid_pos) * self.spacing

    def contains(self, points) -> torch.Tensor:
        """Bool: world point inside the grid bounds."""
        g = self.world_to_grid(points)
        hi = torch.tensor(self.values.shape, dtype=g.dtype, device=g.device)
        return torch.all((g >= 0) & (g <= hi), dim=-1)

    def is_valid_index(self, i: int, j: int, k: int) -> bool:
        nx, ny, nz = self.values.shape
        return 0 <= i < nx and 0 <= j < ny and 0 <= k < nz


def winding_number(points, vertices, faces, chunk: int = 512) -> torch.Tensor:
    """Generalized winding number of `points` (N, 3) with respect to the mesh
    (Jacobson et al.): Σ signed solid angles (Van Oosterom-Strackee) / 4π,
    ≈ 1 inside a closed surface and ≈ 0 outside (MeshToSdf.h
    SignMethod::Winding). Chunks of `chunk` points against every face, on
    the points' device."""
    points = torch.as_tensor(points, dtype=torch.float32)
    vertices = torch.as_tensor(vertices, dtype=torch.float32, device=points.device)
    faces = torch.as_tensor(faces, device=points.device).long()
    tri = vertices[faces]  # (F, 3, 3)
    out = []
    for p in points.split(chunk):
        a = tri[None, :, 0] - p[:, None]
        b = tri[None, :, 1] - p[:, None]
        c = tri[None, :, 2] - p[:, None]
        la, lb, lc = _norm(a), _norm(b), _norm(c)
        num = torch.sum(torch.linalg.cross(a, b) * c, dim=-1)
        den = (la * lb * lc + torch.sum(a * b, dim=-1) * lc
               + torch.sum(b * c, dim=-1) * la + torch.sum(a * c, dim=-1) * lb)
        out.append(torch.sum(2.0 * torch.atan2(num, den), dim=-1))
    omega = torch.cat(out) if out else points.new_zeros((0,))
    return omega / (4.0 * math.pi)


def _morph_unit(mask: torch.Tensor, op: str) -> torch.Tensor:
    """One 6-connected binary erosion or dilation step of a 3D bool grid
    (periodic at the border, as jnp.roll is)."""
    m = mask.to(torch.float32)
    shifted = [m] + [torch.roll(m, s, dims=axis) for axis in range(3) for s in (1, -1)]
    stack = torch.stack(shifted)
    return (stack.amin(0) > 0.5) if op == "erode" else (stack.amax(0) > 0.5)


def morphological_cleanup(inside, open_iters: int = 0, close_iters: int = 0) -> torch.Tensor:
    """Binary open (erode → dilate, removes speckles) then close (dilate →
    erode, fills pinholes) of the inside mask (MeshToSdf.h:24-230)."""
    inside = torch.as_tensor(inside)
    for op, n in (("erode", open_iters), ("dilate", open_iters),
                  ("dilate", close_iters), ("erode", close_iters)):
        for _ in range(n):
            inside = _morph_unit(inside, op)
    return inside


def _linspace(lo: torch.Tensor, hi: torch.Tensor, num: int) -> torch.Tensor:
    """jnp.linspace's float32 arithmetic: lo·(1 − i/(n−1)) + hi·i/(n−1),
    the last point hi itself."""
    step = torch.arange(num - 1, dtype=torch.float32, device=lo.device) / float(num - 1)
    return torch.cat([lo * (1 - step) + hi * step, hi[None]])


def mesh_grid(vertices: torch.Tensor, resolution, padding: float = 0.1):
    """mesh_to_sdf's grid: (origin (3,), spacing (3,), the sample points
    (nx·ny·nz, 3) in x-major order), the mesh's bounds padded by `padding`
    of their extent and 1e-3, `resolution` samples per axis end to end."""
    lo = vertices.amin(0)
    hi = vertices.amax(0)
    extent = hi - lo
    lo = lo - padding * extent - 1e-3
    hi = hi + padding * extent + 1e-3
    res = [int(r) for r in resolution]
    spacing = (hi - lo) / torch.tensor([r - 1 for r in res], dtype=torch.float32,
                                       device=vertices.device)
    xs = [_linspace(lo[i], hi[i], res[i]) for i in range(3)]
    return lo, spacing, torch.stack(torch.meshgrid(*xs, indexing="ij"), dim=-1).reshape(-1, 3)


def mesh_distances(points, vertices, faces, sign_method: str = "normal", chunk: int = 2048):
    """(the unsigned distance (N,) of each point to the mesh, inside (N,)
    bool): mesh_to_sdf's per-point work before any cleanup, on the points'
    device."""
    cp, fi, _, d2 = closest_point_on_mesh(points, vertices, faces, chunk=chunk)
    if sign_method == "winding":
        inside = winding_number(points, vertices, faces, chunk=chunk) > 0.5
    else:
        # the closest face's normal (cheaper than angle-weighted pseudo
        # normals, and as JAX's code does)
        a, b, c = (vertices[faces[:, k]] for k in range(3))
        n = torch.linalg.cross(b - a, c - a)[fi]
        inside = torch.sum((points - cp) * n, dim=-1) < 0
    return torch.sqrt(torch.clamp(d2, min=0.0)), inside


def mesh_to_sdf(vertices, faces, resolution=(32, 32, 32), padding=0.1, chunk=2048,
                sign_method: str = "normal", open_iters: int = 0, close_iters: int = 0,
                device="cuda") -> SignedDistanceField:
    """Brute-force signed distance grid (MeshToSdf.h:24-230) on `device`
    (the card unless the caller asks for the CPU), over mesh_grid's points,
    each the distance to its closest point on any face, in chunks of
    `chunk` points.

    sign_method: "normal" (inside where the point lies behind the closest
    face's normal) or "winding" (generalized winding number > 0.5).
    open_iters/close_iters apply morphological open/close to the inside
    mask before signing."""
    device = resolve(device, "mesh_to_sdf")
    vertices = torch.as_tensor(np.asarray(to_host(vertices), np.float32), device=device)
    faces = torch.as_tensor(np.asarray(to_host(faces), np.int64), device=device)
    res = [int(r) for r in resolution]
    lo, spacing, grid = mesh_grid(vertices, res, padding)
    dist, inside = mesh_distances(grid, vertices, faces, sign_method, chunk)
    if open_iters or close_iters:
        inside = morphological_cleanup(inside.reshape(res), open_iters, close_iters).reshape(-1)
    dist = torch.where(inside, -1.0, 1.0) * dist
    return SignedDistanceField(origin=lo, spacing=spacing, values=dist.reshape(res))


def sdf_to_mesh(sdf: SignedDistanceField):
    """The zero isosurface as a mesh (axel/DualContouring.h analog, naive
    surface nets: one vertex per sign-changing cell at the mean of its edge
    crossings, two triangles per sign-changing grid edge), on the host;
    → (vertices (V, 3) float32, faces (F, 3) int32) on the field's device."""
    vals = to_host(sdf.values)
    origin = to_host(sdf.origin)
    spacing = to_host(sdf.spacing)

    cell_vertex = {}
    verts = []

    def cell_point(cx, cy, cz):
        key = (cx, cy, cz)
        if key in cell_vertex:
            return cell_vertex[key]
        crossings = []
        corners = [(cx + dx, cy + dy, cz + dz)
                   for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)]
        edges = [(a, b) for i, a in enumerate(corners) for b in corners[i + 1:]
                 if sum(abs(a[k] - b[k]) for k in range(3)) == 1]
        for a, b in edges:
            va, vb = vals[a], vals[b]
            if (va < 0) != (vb < 0):
                t = va / (va - vb)
                crossings.append(np.asarray(a) + t * (np.asarray(b) - np.asarray(a)))
        p = np.mean(crossings, axis=0) if crossings else np.asarray(
            [cx + 0.5, cy + 0.5, cz + 0.5])
        idx = len(verts)
        verts.append(origin + p * spacing)
        cell_vertex[key] = idx
        return idx

    faces = []
    sign = vals < 0
    for axis in range(3):
        sl_a = tuple(slice(0, s - (1 if k == axis else 0)) for k, s in enumerate(vals.shape))
        sl_b = tuple(slice((1 if k == axis else 0), s) for k, s in enumerate(vals.shape))
        change = sign[sl_a] != sign[sl_b]
        u_ax, v_ax = [a for a in range(3) if a != axis]
        for x, y, z in zip(*np.nonzero(change)):
            e = np.asarray([x, y, z])
            # the edge (e → e + axis) is shared by 4 cells offset along u/v
            cells = []
            ok = True
            for du in (-1, 0):
                for dv in (-1, 0):
                    c = e.copy()
                    c[u_ax] += du
                    c[v_ax] += dv
                    if (c < 0).any() or (c >= np.asarray(vals.shape) - 1).any():
                        ok = False
                    cells.append(tuple(c))
            if not ok:
                continue
            q = [cell_point(*c) for c in cells]
            a_, b_, c_, d_ = (q[0], q[1], q[3], q[2])
            if bool(sign[x, y, z]):  # oriented by the sign of the lower endpoint
                faces += [[a_, b_, c_], [a_, c_, d_]]
            else:
                faces += [[c_, b_, a_], [d_, c_, a_]]

    device = sdf.values.device
    return (torch.as_tensor(np.asarray(verts, np.float32).reshape(-1, 3), device=device),
            torch.as_tensor(np.asarray(faces, np.int32).reshape(-1, 3), device=device))


def dual_contouring(sdf: SignedDistanceField, isovalue: float = 0.0):
    """Dual-contour the isosurface into quads (axel/DualContouring.h;
    pymomentum.axel dual_contouring): one vertex per sign-changing cell,
    pushed onto the level set by the reference's Newton projection
    (DualContouring.cpp pushVertexToSurface: from the cell centre, step
    −(value − iso)/‖∇‖·∇̂, 10 iterations, tolerance 1e-6, the total offset
    clamped to 2× the largest voxel size), batched over all cells in
    float32 on the field's device; one quad per sign-changing grid edge over
    its 4 cells, wound by the sign direction. ROADMAP F4: the projection
    runs in float32 and goes on iterating after the clamp fires, as JAX's
    code does. → (vertices (V, 3) float64, quads (Q, 4) int32), numpy."""
    vals = to_host(sdf.values).astype(np.float64) - isovalue
    origin = to_host(sdf.origin).astype(np.float64)
    spacing = to_host(sdf.spacing).astype(np.float64)

    sgn = vals < 0
    inside8 = np.stack([sgn[dx:sgn.shape[0] - 1 + dx, dy:sgn.shape[1] - 1 + dy,
                            dz:sgn.shape[2] - 1 + dz]
                        for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)])
    crossing = inside8.any(0) & ~inside8.all(0)
    cidx = np.stack(np.nonzero(crossing), axis=-1)  # (C, 3)

    verts_np = np.zeros((0, 3), np.float64)
    if len(cidx):
        centers = origin + (cidx + 0.5) * spacing
        pos = torch.as_tensor(centers, dtype=torch.float32, device=sdf.values.device)
        start = pos
        max_off = 2.0 * float(np.max(spacing))
        for _ in range(10):
            value = sdf.sample(pos) - isovalue
            grad = sdf.gradient(pos)
            gn = _norm(grad, keepdim=True)
            active = (torch.abs(value)[..., None] > 1e-6) & (gn > 1e-6)
            step = (value[..., None] / torch.clamp(gn, min=1e-12)) * grad / torch.clamp(
                gn, min=1e-12)
            pos = torch.where(active, pos - step, pos)
            off = pos - start
            on = _norm(off, keepdim=True)
            pos = torch.where(on > max_off, start + off / torch.clamp(on, min=1e-12) * max_off,
                              pos)
        verts_np = to_host(pos).astype(np.float64)

    # every 4-cell ring around a sign-changing edge is itself sign-changing,
    # so the lookup always hits
    cell_vertex = {tuple(c): i for i, c in enumerate(cidx)}
    quads = []
    shape = vals.shape
    for axis in range(3):
        u_ax, v_ax = [a for a in range(3) if a != axis]
        sl_a = tuple(slice(0, s - (1 if k == axis else 0)) for k, s in enumerate(shape))
        sl_b = tuple(slice((1 if k == axis else 0), s) for k, s in enumerate(shape))
        change = sgn[sl_a] != sgn[sl_b]
        for x, y, z in zip(*np.nonzero(change)):
            e = np.asarray([x, y, z])
            cells = []
            for du, dv in ((0, 0), (1, 0), (1, 1), (0, 1)):
                c = e.copy()
                c[u_ax] -= du
                c[v_ax] -= dv
                if (c < 0).any() or any(c[k] >= shape[k] - 1 for k in range(3)):
                    cells = None
                    break
                cells.append(cell_vertex[tuple(c)])
            if cells is None:
                continue
            if sgn[tuple(e)]:  # orient by which side is inside
                cells = cells[::-1]
            quads.append(cells)

    return (np.asarray(list(verts_np), np.float64).reshape(-1, 3),
            np.asarray(quads, np.int32).reshape(-1, 4))


def triangulate_quads(quads) -> np.ndarray:
    """(Q, 4) quads → (2Q, 3) triangles (pymomentum.axel triangulate_quads)."""
    quads = np.asarray(to_host(quads), np.int64).reshape(-1, 4)
    a, b, c, d = quads.T
    return np.concatenate([np.stack([a, b, c], 1), np.stack([a, c, d], 1)]).astype(np.int32)

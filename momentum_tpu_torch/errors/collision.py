"""Collision residual modules, after momentum_tpu/errors/collision.py
(collision_error_function.{h,cpp}, plane_collision_error_function.cpp):

  * a capsule's world state (collision_geometry_state.cpp:27-49):
      T = T_parent · T_local; origin = T.t;
      direction = T.R·ex · T.s · length; radii = local radii · s_parent
  * CollisionErrorFunction, tapered-capsule self-penetration
    (collision_geometry_state.h:120-157): (s, t, dist) of the closest
    points of a pair's centrelines, overlap = (rA0 + s·ΔA + rB0 + t·ΔB) −
    dist, a row where overlap > 0 and dist ≥ 1e-8; energy
    kCollisionWeight (5e-3, collision_error_function.h:139) · weight ·
    Σ overlap² (collision_error_function.cpp:286-338)
  * PlaneCollisionErrorFunction, primitives against a fixed world plane
    (plane_collision_error_function.cpp:140-169): per capsule the larger
    endpoint overlap radius − signedDistance, per ellipsoid or box the
    support radius along the normal minus the centre's distance.

The reference's BVH broadphase becomes a static pair list: every capsule
pair but same-joint pairs and pairs already overlapping at the bind pose
(its excluded pairs), enumerated once on the host (`compute_valid_pairs`)
and evaluated densely. The pair module has the analytic Jacobian with the
closest-point parameters frozen; the plane module's rows reach the solver
by forward mode, as in JAX.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from momentum_tpu_torch.device import resolve
from momentum_tpu_torch.errors.base import EvalContext, VectorErrorFunction
from momentum_tpu_torch.errors.geometric import _dot_j, clamped
from momentum_tpu_torch.math import quaternion as quat, skel_state as ss
from momentum_tpu_torch.math.generalized_loss import GeneralizedLoss
from momentum_tpu_torch.math.geometry import closest_points_on_segments

__all__ = ["CollisionErrorFunction", "PlaneCollisionErrorFunction", "compute_valid_pairs",
           "capsule_states", "primitive_states", "support_radius_along", "K_COLLISION_WEIGHT"]

K_COLLISION_WEIGHT = 5e-3  # collision_error_function.h:139
_LN2 = 0.6931471805599453


def _world(collision, skel_states):
    """(parents' states, the primitives' full world states)."""
    parent_states = skel_states.index_select(
        -2, collision.parent.clamp(0, skel_states.shape[-2] - 1))  # ROADMAP F3
    return parent_states, ss.multiply(parent_states, collision.transform)


def capsule_states(collision, skel_states):
    """World capsules: (origin (..., C, 3), direction (..., C, 3), radii (..., C, 2))
    (CollisionGeometryStateT::update, collision_geometry_state.cpp:27-49)."""
    return primitive_states(collision, skel_states)[:3]


def primitive_states(collision, skel_states):
    """World primitives (collision_geometry_state.h:20-60): (origin,
    direction, radii, orientation q, ellipsoid radii, box half extents),
    the radii scaled by the parent joint's world scale, the shapes by the
    primitive's."""
    parent_states, full = _world(collision, skel_states)
    t, q, s = ss.split(full)
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=t.dtype, device=t.device).expand(t.shape)
    direction = quat.rotate_vector(q, ex) * s * collision.length[..., None]
    radii = collision.radius * parent_states[..., 7:8]
    return (t, direction, radii, q, collision.shape3("ellipsoid_radii") * s,
            collision.shape3("box_half_extents") * s)


def support_radius_along(ptype, q, ell, box, n):
    """The support radius of a centred primitive along the world direction n
    (plane_collision_query.cpp centeredPrimitiveRadiusAlongDirection):
    ellipsoid ‖radii ∘ n_local‖, box Σ|h_i·n_local_i|, by select. The
    ellipsoid's norm is kept off 0: a capsule row has zero radii and its
    unselected branch must not give a NaN derivative."""
    n_local = quat.rotate_vector(quat.conjugate(q), n.expand(q[..., :3].shape))
    sq = torch.sum(torch.square(ell * n_local), dim=-1)
    r_ell = torch.where(sq > 0, torch.sqrt(torch.clamp(sq, min=1e-20)), 0.0)
    r_box = torch.sum(torch.abs(box * n_local), dim=-1)
    return torch.where(ptype == 1, r_ell, r_box)


def compute_valid_pairs(character) -> np.ndarray:
    """The static (NP, 2) candidate list: every capsule pair but same-joint
    pairs, pairs with another primitive type (capsule-capsule narrowphase
    only, as upstream) and pairs overlapping at the bind pose (the
    reference's excluded pairs, collision_error_function.cpp
    computeBroadPhase). Host code, once per module, in float32 as JAX's."""
    col = character.collision
    o, d, r = (x.detach().cpu() for x in capsule_states(col, character.bind_pose()))
    parent = col.parent.cpu().numpy()
    ptypes = col.primitive_types().cpu().numpy()
    pairs = []
    for i in range(col.num_capsules):
        for j in range(i + 1, col.num_capsules):
            if parent[i] == parent[j] or ptypes[i] != 0 or ptypes[j] != 0:
                continue
            s, t, dist = (x.numpy() for x in closest_points_on_segments(o[i], d[i], o[j], d[j]))
            ri, rj = r[i].numpy(), r[j].numpy()
            overlap = (ri[0] + s * (ri[1] - ri[0]) + rj[0] + t * (rj[1] - rj[0])) - dist
            if overlap > 0:
                continue  # overlapping at rest: excluded for good
            pairs.append((i, j))
    return np.asarray(pairs, np.int32).reshape(-1, 2)


@dataclasses.dataclass(frozen=True, eq=False)
class CollisionErrorFunction(VectorErrorFunction):
    pair_a: torch.Tensor  # (NP,) int32 capsule indices
    pair_b: torch.Tensor  # (NP,)
    pweight: torch.Tensor  # (..., NP) 0 = padding
    weight: torch.Tensor
    loss: GeneralizedLoss = GeneralizedLoss()

    D = 1
    has_analytic_jacobian = True

    def constraint_count(self) -> int:
        return self.pair_a.shape[0]

    def _pairs(self, character, ctx: EvalContext):
        """(both capsules' parent joints, closest points p_a and p_b, their
        distance, both radii at the closest points)."""
        col = character.collision
        o, d, r = capsule_states(col, ctx.skel_states)
        a, b = self.pair_a, self.pair_b
        oa, ob, da, db = (x.index_select(-2, i) for x, i in ((o, a), (o, b), (d, a), (d, b)))
        ra, rb = r.index_select(-2, a), r.index_select(-2, b)
        s, t, dist = closest_points_on_segments(oa, da, ob, db)
        rad_a = ra[..., 0] + s * (ra[..., 1] - ra[..., 0])
        rad_b = rb[..., 0] + t * (rb[..., 1] - rb[..., 0])
        return (col.parent.index_select(0, a), col.parent.index_select(0, b),
                oa + s[..., None] * da, ob + t[..., None] * db, dist, rad_a, rad_b)

    def raw(self, character, ctx: EvalContext):
        *_, dist, rad_a, rad_b = self._pairs(character, ctx)
        overlap = rad_a + rad_b - dist
        active = (overlap > 0) & (dist >= 1e-8)
        return torch.where(active, overlap, 0.0)[..., None], self.pweight * K_COLLISION_WEIGHT

    def jacobian(self, character, ctx: EvalContext, jc):
        """Rows with the closest-point parameters (s, t) frozen (the
        reference's collision gradient, collision_error_function.cpp:80+):
        d overlap = d rad − û·(dp_a − dp_b), û the separation direction and
        p_a, p_b rigid attachments of the two capsules' joints; d rad is the
        ln2 column of every scale DoF of an ancestor, since the radii scale
        with the parent's global scale. At the minimizer ∂dist/∂(s, t) = 0,
        so this matches AD but for the tapered radius's ∂rad/∂s·∂s/∂θ (zero
        for uniform radii)."""
        from momentum_tpu_torch.solver.analytic_jacobian import point_jacobian

        par_a, par_b, p_a, p_b, dist, rad_a, rad_b = self._pairs(character, ctx)
        par_a, par_b = clamped(par_a, ctx), clamped(par_b, ctx)
        overlap = rad_a + rad_b - dist
        active = (overlap > 0) & (dist >= 1e-8)
        f = torch.where(active, overlap, 0.0)
        scale = self._row_scale(self.pweight * K_COLLISION_WEIGHT, f * f)
        u = (p_a - p_b) / torch.clamp(dist, min=1e-8)[..., None]
        j_dist = _dot_j(u, point_jacobian(jc, p_a, par_a) - point_jacobian(jc, p_b, par_b))
        drad = _LN2 * (rad_a[..., None] * jc.anc_mask.index_select(1, par_a).T
                       + rad_b[..., None] * jc.anc_mask.index_select(1, par_b).T)  # (..., NP, nJ)
        j_rad = torch.nn.functional.pad(drad[..., None], (6, 0))  # scale DoF, column 6 of 7
        j_rad = j_rad.reshape(j_dist.shape)
        gate = scale * active.to(scale.dtype)
        return scale * f, gate[..., None] * (j_rad - j_dist), None

    @classmethod
    def create(cls, character, pairs=None, weight=1.0, loss=None, device="cuda"):
        """Over `pairs` (NP, 2), by default compute_valid_pairs(character)."""
        device = resolve(device, "CollisionErrorFunction.create")
        if pairs is None:
            pairs = compute_valid_pairs(character)
        pairs = np.asarray(pairs, np.int32).reshape(-1, 2)
        return cls(pair_a=torch.as_tensor(pairs[:, 0].copy(), device=device),
                   pair_b=torch.as_tensor(pairs[:, 1].copy(), device=device),
                   pweight=torch.ones(pairs.shape[0], dtype=torch.float32, device=device),
                   weight=torch.tensor(weight, dtype=torch.float32, device=device),
                   loss=loss or GeneralizedLoss())


@dataclasses.dataclass(frozen=True, eq=False)
class PlaneCollisionErrorFunction(VectorErrorFunction):
    """Primitives against the world plane n·x = offset; energy
    kCollisionWeight (5e-3) · weight · Σ overlap²."""

    plane_normal: torch.Tensor  # (3,) unit
    plane_offset: torch.Tensor  # ()
    pweight: torch.Tensor  # (..., C) per-primitive weight
    weight: torch.Tensor
    loss: GeneralizedLoss = GeneralizedLoss()

    D = 1

    def constraint_count(self) -> int:
        return self.pweight.shape[-1]

    def raw(self, character, ctx: EvalContext):
        col = character.collision
        o, d, r, q, ell, box = primitive_states(col, ctx.skel_states)
        n = self.plane_normal
        # capsule: the worse endpoint (plane_collision_query.cpp:181-199)
        d0 = torch.sum(o * n, dim=-1) - self.plane_offset
        d1 = torch.sum((o + d) * n, dim=-1) - self.plane_offset
        over_cap = torch.maximum(r[..., 0] - d0, r[..., 1] - d1)
        # ellipsoid and box: the centre's distance against the support
        # radius along the normal (plane_collision_query.cpp:200-228)
        ptype = col.primitive_types()
        over_cen = support_radius_along(ptype, q, ell, box, n) - d0
        overlap = torch.clamp(torch.where(ptype == 0, over_cap, over_cen), min=0.0)
        return overlap[..., None], self.pweight * K_COLLISION_WEIGHT

    @classmethod
    def create(cls, character, plane_normal=(0.0, 1.0, 0.0), plane_offset=0.0, weight=1.0,
               loss=None, device="cuda"):
        device = resolve(device, "PlaneCollisionErrorFunction.create")
        n = np.asarray(plane_normal, np.float32)
        n = n / np.linalg.norm(n)
        return cls(plane_normal=torch.as_tensor(n, device=device),
                   plane_offset=torch.tensor(plane_offset, dtype=torch.float32, device=device),
                   pweight=torch.ones(character.collision.num_capsules, dtype=torch.float32,
                                      device=device),
                   weight=torch.tensor(weight, dtype=torch.float32, device=device),
                   loss=loss or GeneralizedLoss())

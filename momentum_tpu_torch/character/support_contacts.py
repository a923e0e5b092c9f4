"""Support-contact queries, floor locators and plane-collision contacts,
after momentum_tpu/character/support_contacts.py (the reference's
character_solver/support_contacts.{h,cpp}): the points through which the
ground plane supports the character (floor locators within contactHeight
of the plane, and collision primitives that overlap it), for balance
support polygons.

Every query returns fixed-shape tensors and an `active` mask on the skeleton
states' device; `support_polygon_from_contacts` hulls the active ones on the
host.
"""

from __future__ import annotations

import numpy as np
import torch

from momentum_tpu_torch.device import to_host
from momentum_tpu_torch.math import quaternion as quat, skel_state as ss
from momentum_tpu_torch.math.support_polygon import (
    SupportPlane, support_polygon_from_world_points)

__all__ = ["is_floor_locator_name", "floor_locator_mask", "floor_locator_support_contacts",
           "plane_collision_support_contacts", "support_contact_positions",
           "support_polygon_from_contacts"]


def _plane(plane, skel_states) -> SupportPlane:
    """`plane`, or by default the Y-up plane through the origin on the
    states' device."""
    return SupportPlane.create(device=skel_states.device) if plane is None else plane


def is_floor_locator_name(name: str) -> bool:
    """support_contacts.cpp:22-24: the 'Floor' name prefix convention."""
    return name.startswith("Floor")


def floor_locator_mask(locators) -> np.ndarray:
    """The (L,) bool mask of floor locators, from their names (host)."""
    names = locators.names or ()
    out = np.zeros(locators.num_locators, bool)
    for i, n in enumerate(names[: locators.num_locators]):
        out[i] = is_floor_locator_name(str(n))
    return out


def _parent_offset(parent_states, world_points):
    """The parent-local offset that gives world_points under the parent
    transform (support_contacts.cpp parentOffsetFromWorldPoint)."""
    t, q, s = ss.split(parent_states)
    rel = quat.rotate_vector(quat.conjugate(q), world_points - t)
    return rel / torch.clamp(torch.abs(s), min=1e-8) * torch.sign(s + (s == 0).to(s.dtype))


def floor_locator_support_contacts(character, skel_states, contact_height,
                                   plane: SupportPlane | None = None) -> dict:
    """computeFloorLocatorSupportContacts: positions (..., L, 3), parent
    (L,), parent_offset (..., L, 3), signed_distance (..., L), active (...,
    L) where a floor locator lies within contact_height of the plane, and
    floor_mask (L,)."""
    plane = _plane(plane, skel_states)
    locs = character.locators
    parent_states = skel_states.index_select(-2, locs.parent)
    positions = ss.transform_points(parent_states, locs.offset)
    sd = plane.signed_distance(positions)
    fmask = torch.as_tensor(floor_locator_mask(locs), device=skel_states.device)
    return dict(positions=positions, parent=locs.parent,
                parent_offset=_parent_offset(parent_states, positions), signed_distance=sd,
                active=fmask & (sd <= contact_height), floor_mask=fmask)


def plane_collision_support_contacts(character, skel_states, contact_margin,
                                     plane: SupportPlane | None = None) -> dict:
    """computePlaneCollisionSupportContacts: per collision primitive the
    deepest surface point toward the plane (plane_collision_query.cpp
    checkCollision), active where overlap = support radius − signed
    distance > −contact_margin, and `deepest_per_parent` keeping the deepest
    active contact of each parent joint (the reference's per-parent
    dedup)."""
    from momentum_tpu_torch.errors.collision import primitive_states, support_radius_along

    plane = _plane(plane, skel_states)
    col = character.collision
    if col is None:
        z = skel_states.new_zeros((0, 3))
        none = torch.zeros((0,), dtype=torch.bool, device=skel_states.device)
        return dict(positions=z, parent=torch.zeros((0,), dtype=torch.int32,
                                                    device=skel_states.device),
                    parent_offset=z, overlap=skel_states.new_zeros((0,)), active=none,
                    deepest_per_parent=none)
    o, d, r, q, ell, box = primitive_states(col, skel_states)
    n = plane.normal
    ptype = col.primitive_types()
    # a capsule's worst endpoint; a centred primitive's centre less its
    # support offset
    d0 = torch.einsum("...i,i->...", o, n) - plane.offset
    d1 = torch.einsum("...i,i->...", o + d, n) - plane.offset
    worst_is_0 = (d0 - r[..., 0]) <= (d1 - r[..., 1])
    cap_sd = torch.where(worst_is_0, d0, d1)
    cap_r = torch.where(worst_is_0, r[..., 0], r[..., 1])
    cap_pos = torch.where(worst_is_0[..., None], o, o + d) - cap_r[..., None] * n
    r_sup = support_radius_along(ptype, q, ell, box, n)
    # the support offset (plane_collision_query.cpp:214-227)
    n_local = quat.rotate_vector(quat.conjugate(q), n.expand(q[..., :3].shape))
    denom = torch.clamp(r_sup, min=1e-8)[..., None]
    ell_off = quat.rotate_vector(q, ell * ell * n_local) / denom
    box_off = quat.rotate_vector(q, torch.abs(box) * torch.where(n_local >= 0, 1.0, -1.0))
    cen_pos = o - torch.where((ptype == 1)[..., None], ell_off, box_off)

    is_cap = ptype == 0
    sd = torch.where(is_cap, cap_sd, d0)
    radius = torch.where(is_cap, cap_r, r_sup)
    positions = torch.where(is_cap[..., None], cap_pos, cen_pos)
    overlap = radius - sd
    active = overlap > -contact_margin
    # the deepest contact of each parent joint (updateActiveParentCollisions)
    ov_masked = torch.where(active, overlap, -torch.inf)
    same_parent = col.parent[:, None] == col.parent[None, :]  # (C, C)
    best = torch.where(same_parent, ov_masked[..., None, :], -torch.inf).amax(-1)
    parent_states = skel_states.index_select(-2, col.parent)
    return dict(positions=positions, parent=col.parent,
                parent_offset=_parent_offset(parent_states, positions), overlap=overlap,
                active=active, deepest_per_parent=active & (ov_masked >= best))


def support_contact_positions(character, skel_states, contact_height,
                              plane: SupportPlane | None = None):
    """computeSupportContactPositions: the floor locators' and the collision
    contacts' world positions (..., L + C, 3) and their active mask, fixed
    shape."""
    plane = _plane(plane, skel_states)
    fl = floor_locator_support_contacts(character, skel_states, contact_height, plane)
    pc = plane_collision_support_contacts(character, skel_states, contact_height, plane)
    positions = torch.cat([fl["positions"], pc["positions"]], dim=-2)
    active = torch.cat([fl["active"], pc["deepest_per_parent"]], dim=-1)
    return positions, active


def support_polygon_from_contacts(character, skel_states, contact_height,
                                  plane: SupportPlane | None = None) -> np.ndarray:
    """The 2-D support polygon of the active contacts of one pose (host)."""
    plane = _plane(plane, skel_states)
    positions, active = support_contact_positions(character, skel_states, contact_height, plane)
    pts = to_host(positions)[to_host(active)]
    return support_polygon_from_world_points(torch.as_tensor(pts, device=plane.normal.device),
                                             plane)


# pymomentum.geometry binding spellings (support_contacts_pybind.cpp:341-443)
plane_collision_contacts_by_parent = plane_collision_support_contacts
support_contacts = support_contact_positions
support_polygon = support_polygon_from_contacts

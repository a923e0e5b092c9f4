"""Shared helpers of the tests/test_torch_port_*.py parity tests (this file
holds no tests): pull the numpy arrays out of momentum_tpu objects in the
layout that momentum_tpu_torch.bridge reads, and out of port objects for
comparison."""

from __future__ import annotations

import numpy as np


# limit record types the port's ParameterLimits does not hold
UNPORTED_LIMITS = ("linear", "linear_joint", "halfplane", "ellipsoid")


def character_to_numpy(char) -> dict:
    """The arrays of a Character (JAX or port) that bridge.character_from_numpy
    reads, as numpy, with the counts of the limit records the port does not
    hold (0 for a port character)."""
    lim = char.limits
    counts = lim.counts
    d = dict(
        joint_parent=char.skeleton.joint_parent,
        pre_rotation=char.skeleton.pre_rotation,
        translation_offset=char.skeleton.translation_offset,
        transform=char.parameter_transform.transform,
        offsets=char.parameter_transform.offsets,
        minmax_index=lim.minmax_index,
        minmax_bounds=lim.minmax_bounds,
        minmax_weight=lim.minmax_weight,
        minmax_joint_index=lim.minmax_joint_index,
        minmax_joint_bounds=lim.minmax_joint_bounds,
        minmax_joint_weight=lim.minmax_joint_weight,
        minmax_joint_passive=lim.minmax_joint_passive,
    )
    d.update({f"{k}_count": np.int64(counts.get(k, 0)) for k in UNPORTED_LIMITS})
    if char.locators is not None:
        d.update(locator_parent=char.locators.parent,
                 locator_offset=char.locators.offset,
                 locator_weight=char.locators.weight)
    if char.mesh is not None:
        d.update(mesh_vertices=char.mesh.vertices, mesh_faces=char.mesh.faces)
    if char.skin_weights is not None:
        d.update(skin_index=char.skin_weights.index, skin_weight=char.skin_weights.weight)
    if char.inverse_bind_pose is not None:
        d.update(inverse_bind_pose=char.inverse_bind_pose)
    return {k: to_numpy(v) for k, v in d.items()}


def camera_to_numpy(cam) -> dict:
    """The arrays of a pinhole Camera (JAX or port) that
    bridge.camera_from_numpy reads, as numpy."""
    intr = cam.intrinsics
    d = {k: to_numpy(getattr(intr, k)) for k in ("fx", "fy", "cx", "cy")}
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


def to_numpy(x) -> np.ndarray:
    """numpy copy of a jax array, torch tensor or array-like."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def jax_fullbody_character():
    from momentum_tpu.testing.fixtures import create_fullbody_character

    return create_fullbody_character()


def port_fullbody_character():
    """The JAX full-body rig carried into the port through bridge.py."""
    from momentum_tpu_torch.bridge import character_from_numpy

    return character_from_numpy(character_to_numpy(jax_fullbody_character()))


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

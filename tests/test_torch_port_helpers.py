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

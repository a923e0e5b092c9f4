"""Forward kinematics: joint parameters → per-joint global skeleton states.

Semantics of momentum_tpu/character/fk.py (joint_state.cpp:22-66):

    local.t = translationOffset + params[0:3]
    local.R = Rpre · Rz(rz) · Ry(ry) · Rx(rx)
    local.s = exp2(params[6])
    global  = parent_global * local

`global_skel_states` sends CUDA tensors through kernel K1
(ops/fk.py::fk_global, csrc/fk.cu) and CPU tensors through the binary-lifting
prefix product with an index gather (`global_skel_states_lifted`). Both are
differentiable: K1's backward is the VJP of the lifted product, as JAX's
custom_jvp around its Pallas FK (ops/fk.py::_FkGlobal).
`global_skel_states_scan` is the serial joint walk (joint_state.cpp's order).

The derivative axes (`joint_axes`) follow from the global states as in the
JAX package:

    translationAxis(j) = s_par(j) · R_par(j)
    rotationAxis(j) = [ R_g(j)·ex,  R_g(j)·Rx(-rx)·ey,  R_g(j)·Rx(-rx)·Ry(-ry)·ez ]
"""

from __future__ import annotations

import torch

from momentum_tpu_torch.character.skeleton import PARAMS_PER_JOINT, Skeleton
from momentum_tpu_torch.math import quaternion as quat, skel_state as ss
from momentum_tpu_torch.ops import fk as fk_ops

__all__ = [
    "local_skel_states",
    "global_skel_states",
    "global_skel_states_scan",
    "global_skel_states_lifted",
    "joint_axes",
    "parent_global_states",
]


def _per_joint(joint_params: torch.Tensor) -> torch.Tensor:
    if joint_params.shape[-1] == PARAMS_PER_JOINT:
        return joint_params
    return joint_params.reshape(joint_params.shape[:-1] + (-1, PARAMS_PER_JOINT))


def local_skel_states(skeleton: Skeleton, joint_params: torch.Tensor) -> torch.Tensor:
    """(..., nJ*7) or (..., nJ, 7) joint params → (..., nJ, 8) local states."""
    jp = _per_joint(joint_params)
    t = skeleton.translation_offset + jp[..., 0:3]
    q = quat.multiply(skeleton.pre_rotation,
                      quat.euler_to_quaternion(jp[..., 3:6], order="ZYX"))
    return ss.join(t, q, torch.exp2(jp[..., 6:7]))


def global_skel_states_scan(skeleton: Skeleton, local_states: torch.Tensor) -> torch.Tensor:
    """Serial walk over topologically ordered joints (a root's global state
    is its local state)."""
    out = []
    for j, p in enumerate(skeleton.parents_np):
        local_j = local_states[..., j, :]
        out.append(local_j if p < 0 else ss.multiply(out[p], local_j))
    return torch.stack(out, dim=-2)


def global_skel_states_lifted(skeleton: Skeleton, local_states: torch.Tensor) -> torch.Tensor:
    """Binary-lifting prefix product: log2(depth) rounds of parent gather +
    compose (ops/fk.py::fk_global_plain)."""
    return fk_ops.fk_global_plain(skeleton, local_states)


def global_skel_states(skeleton: Skeleton, joint_params: torch.Tensor,
                       method: str = "lifted") -> torch.Tensor:
    """(..., nJ*7) joint params → (..., nJ, 8) global skeleton states.
    method="lifted" takes kernel K1 for CUDA tensors (with the lifted
    product's VJP as its backward) and the lifted product for CPU tensors;
    method="scan" takes the serial walk."""
    local = local_skel_states(skeleton, joint_params)
    if method == "scan":
        return global_skel_states_scan(skeleton, local)
    if method != "lifted":
        raise ValueError(f"unknown FK method {method!r}")
    return fk_ops.fk_global(skeleton, local)


def parent_global_states(skeleton: Skeleton, global_states: torch.Tensor) -> torch.Tensor:
    """Each joint's parent global state (identity for roots)."""
    ident = ss.identity(global_states.shape[:-2] + (1,), dtype=global_states.dtype,
                        device=global_states.device)
    padded = torch.cat([global_states, ident], dim=-2)
    return padded.index_select(-2, skeleton.parent_index)


def joint_axes(skeleton: Skeleton, joint_params: torch.Tensor,
               global_states: torch.Tensor):
    """(translation_axis, rotation_axis), each (..., nJ, 3, 3) with COLUMN i
    the world-space axis of DoF i (joint_state.h:62-70)."""
    jp = _per_joint(joint_params)
    _, q_par, s_par = ss.split(parent_global_states(skeleton, global_states))
    trans_axis = quat.to_rotation_matrix(q_par) * s_par[..., None]

    q_g = global_states[..., 3:7]
    rx = jp[..., 3]
    ry = jp[..., 4]
    zero = torch.zeros_like(rx)
    ax = quat.rotate_vector(q_g, torch.stack([torch.ones_like(rx), zero, zero], dim=-1))
    # R_g·Rx(-rx)·ey = R_g·(0, cos rx, -sin rx)
    ay = quat.rotate_vector(q_g, torch.stack([zero, torch.cos(rx), -torch.sin(rx)], dim=-1))
    # R_g·Rx(-rx)·Ry(-ry)·ez
    v = torch.stack([-torch.sin(ry), torch.sin(rx) * torch.cos(ry),
                     torch.cos(rx) * torch.cos(ry)], dim=-1)
    az = quat.rotate_vector(q_g, v)
    return trans_axis, torch.stack([ax, ay, az], dim=-1)

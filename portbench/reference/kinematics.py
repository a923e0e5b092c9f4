"""Plain PyTorch forward kinematics, locator positions and position
residuals, written from the rig's semantics (momentum's joint_state.cpp):

    joint params  = T · θ                       (the parameter transform)
    local.t       = translation_offset + jp[0:3]
    local.R       = Rz(jp[5]) · Ry(jp[4]) · Rx(jp[3])
    local.s       = 2 ** jp[6]
    global        = parent_global ∘ local:  t = t_p + s_p·R_p·t_l,  R = R_p·R_l,  s = s_p·s_l
    locator       = t_g + s_g·R_g·offset
    residual      = locator − target            (weight 1, L2)

Rotations are 3 × 3 matrices composed joint by joint; nothing here imports
the port or calls its kernels. Products are `torch.matmul`, so this code
runs in whatever matmul precision the process sets.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from portbench.rig import PARAMS_PER_JOINT, Rig


class RefRig(NamedTuple):
    parents: list
    offsets: torch.Tensor  # (J, 3)
    transform: torch.Tensor  # (J*7, P)
    loc_parents: torch.Tensor  # (L,) int64
    loc_offsets: torch.Tensor  # (L, 3)


def reference_rig(rig: Rig, device, dtype=torch.float32) -> RefRig:
    return RefRig(parents=rig.parents.tolist(),
                  offsets=torch.as_tensor(rig.translation_offsets, dtype=dtype, device=device),
                  transform=torch.as_tensor(rig.transform, dtype=dtype, device=device),
                  loc_parents=torch.as_tensor(rig.locator_parents, device=device),
                  loc_offsets=torch.as_tensor(rig.locator_offsets, dtype=dtype, device=device))


def _rotation_zyx(r: torch.Tensor) -> torch.Tensor:
    """(..., 3) angles (rx, ry, rz) → (..., 3, 3) Rz·Ry·Rx."""
    cx, cy, cz = torch.cos(r[..., 0]), torch.cos(r[..., 1]), torch.cos(r[..., 2])
    sx, sy, sz = torch.sin(r[..., 0]), torch.sin(r[..., 1]), torch.sin(r[..., 2])
    m = torch.stack([
        cz * cy, cz * sy * sx - sz * cx, cz * sy * cx + sz * sx,
        sz * cy, sz * sy * sx + cz * cx, sz * sy * cx - cz * sx,
        -sy, cy * sx, cy * cx], dim=-1)
    return m.reshape(r.shape[:-1] + (3, 3))


def global_transforms(rr: RefRig, theta: torch.Tensor):
    """θ (..., P) → (t (..., J, 3), R (..., J, 3, 3), s (..., J))."""
    jp = (theta @ rr.transform.T).reshape(theta.shape[:-1] + (-1, PARAMS_PER_JOINT))
    t_l = rr.offsets + jp[..., 0:3]
    r_l = _rotation_zyx(jp[..., 3:6])
    s_l = torch.exp2(jp[..., 6])
    ts, rs, ss = [], [], []
    for j, p in enumerate(rr.parents):
        if p < 0:
            ts.append(t_l[..., j, :])
            rs.append(r_l[..., j, :, :])
            ss.append(s_l[..., j])
            continue
        ts.append(ts[p] + ss[p][..., None] * (rs[p] @ t_l[..., j, :, None])[..., 0])
        rs.append(rs[p] @ r_l[..., j, :, :])
        ss.append(ss[p] * s_l[..., j])
    return torch.stack(ts, -2), torch.stack(rs, -3), torch.stack(ss, -1)


def locator_positions(rr: RefRig, theta: torch.Tensor) -> torch.Tensor:
    """θ (..., P) → (..., L, 3) world positions of the locators."""
    t, r, s = global_transforms(rr, theta)
    tp = t.index_select(-2, rr.loc_parents)
    rp = r.index_select(-3, rr.loc_parents)
    sp = s.index_select(-1, rr.loc_parents)
    return tp + sp[..., None] * (rp @ rr.loc_offsets[..., None])[..., 0]


def residual(rr: RefRig, theta: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """(..., 3L) rows of locator − target."""
    d = locator_positions(rr, theta) - targets
    return d.reshape(d.shape[:-2] + (-1,))


def energy(rr: RefRig, theta: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    r = residual(rr, theta, targets)
    return torch.sum(r * r, dim=-1)


def residual_and_jacobian(rr: RefRig, theta: torch.Tensor, targets: torch.Tensor):
    """(rows (B, R), J (B, R, P)) by forward mode: one JVP per parameter
    direction, each direction set on every element at once."""
    p = theta.shape[-1]
    eye = torch.eye(p, dtype=theta.dtype, device=theta.device)

    def f(x):
        return residual(rr, x, targets)

    rows, cols = torch.func.vmap(
        lambda e: torch.func.jvp(f, (theta,), (e.expand_as(theta),)))(eye)
    return rows[0], cols.permute(1, 2, 0)

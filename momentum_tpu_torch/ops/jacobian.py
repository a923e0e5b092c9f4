"""K6: the position rows' model-space Jacobian — `point_jacobian_kernel`
(csrc/jacobian.cu).

Replaces no TPU kernel: JAX computes this function with jnp operators
(momentum_tpu/solver/analytic_jacobian.py::fused_point_jacobian_model_merged),
and the port's plain version is the same merged form in PyTorch,
`solver/analytic_jacobian.py::fused_point_jacobian_model_merged`, kept as it
is. On the card that form writes and reads back a dozen intermediates the
size of J or of (B, nJ, 3, P); the kernel writes J once and keeps the rest in
shared memory. It is bound by bytes: J is (B, 3C, P) float32, 2.35 GB at the
IK cell's B = 65536, C = 41, P = 73. Each block sums the per-joint factors of
a tile of the P columns down the skeleton's tree, element after element, and
stores J row by row in coalesced streaming stores (the note at the top of
csrc/jacobian.cu has the design and its numbers).

`kernel_takes` is the rule by which the forward chooses between the two,
from the device and dtype before any launch: CUDA float32 inputs launch
the kernel (or the call raises); CPU tensors and float64 take the plain
version.

Derivatives: `point_jacobian_model` goes through `_PointJacobian`, a
`torch.autograd.Function` whose forward is the kernel (the plain version
where `kernel_takes` says no) and whose derivatives are those of the plain
version at the saved inputs: `backward` its VJP, `jvp` its JVP, and `vmap`
folds a vmapped dimension of the per-element inputs into the kernel's
leading batch (one launch a slice where the mask, the parents or the
transform are vmapped), so J that is differentiated or vmapped still comes
from the kernel, as K1's global states do (ops/fk.py). There is no
derivative kernel.

K6's projection form, `projection_jacobian_kernel` (the same source): the
rows of K cameras' pixel residuals of the same C points, (..., 2KC, P),
camera k's 2C rows in a block, row 2c + v component v of point c. Each
element's point Jacobian is formed as above and, for every (camera, point)
pair, chained through s·dπ/dp_eye·R_eye (2 × 3: the OpenCV model's
derivative at the eye-space point R_eye·p + t_eye, its rotation and the
row scale s) before J is stored, so J is written once and nothing of
J's size is read back. `projection_jacobian_model` chooses between it and
`projection_jacobian_model_plain` by the same `kernel_takes` rule, through
`_ProjectionJacobian`, whose derivatives are the plain form's; a launch
adds one to `projection_launches`.
"""

from __future__ import annotations

import ctypes
import math

import torch

from momentum_tpu_torch.camera.models import project_opencv_jacobian
from momentum_tpu_torch.ops import build
from momentum_tpu_torch.solver.analytic_jacobian import (
    JacobianContext, fused_point_jacobian_model_merged)

__all__ = ["KERNEL", "PROJECTION_KERNEL", "kernel_takes", "launches", "point_jacobian_model",
           "point_jacobian_model_plain", "point_jacobian_tile", "projection_jacobian_model",
           "projection_jacobian_model_plain", "projection_jacobian_tile",
           "projection_launches"]

# times point_jacobian_kernel was launched in this process (reset it to measure a run)
launches = 0
KERNEL = "point_jacobian_kernel"
# times projection_jacobian_kernel was launched in this process
projection_launches = 0
PROJECTION_KERNEL = "projection_jacobian_kernel"

point_jacobian_model_plain = fused_point_jacobian_model_merged


def _lib():
    lib = build.load("jacobian")
    if lib.point_jacobian_launch.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.point_jacobian_launch.argtypes = [p, p, p, p, ll, i, p, p, ll, p, p, p,
                                              i, i, i, i, p]
        lib.point_jacobian_launch.restype = i
        lib.point_jacobian_tile.argtypes = [i, i, i]
        lib.point_jacobian_tile.restype = i
        lib.projection_jacobian_launch.argtypes = [p, p, p, p, ll, i, p, p, p, p, p, p, i, i,
                                                   i, i, i, p]
        lib.projection_jacobian_launch.restype = i
        lib.projection_jacobian_tile.argtypes = [i, i, i, i]
        lib.projection_jacobian_tile.restype = i
    return lib


def point_jacobian_tile(nj: int, c: int, p: int) -> int:
    """The columns of P one block of the kernel takes for a rig of nJ joints,
    C constraints and P parameters: P where a block of all P fits three to
    an SM, fewer (the rest in further tiles) where not; 0 where not one
    column fits a block's shared memory."""
    return _lib().point_jacobian_tile(nj, c, p)


def _inputs(jc: JacobianContext, points, pt_mat, scale):
    tensors = [jc.anc_mask, jc.joint_pos, jc.trans_axis, jc.rot_axis, points, pt_mat]
    return tensors if scale is None else tensors + [scale]


def kernel_takes(jc: JacobianContext, points: torch.Tensor, pt_mat: torch.Tensor,
                 scale=None) -> bool:
    """Whether the forward of `point_jacobian_model` launches
    point_jacobian_kernel: every floating input on the card in float32 (the
    rest, CPU tensors and float64, which the kernel's float32 arithmetic
    would not honour, take the plain version). Decided from the device and
    dtype before any launch; inside the domain the kernel launches or
    raises."""
    return all(t.is_cuda and t.dtype == torch.float32
               for t in _inputs(jc, points, pt_mat, scale))


def _forward(anc, pos, trans, rot, points, parents, pt_mat, scale):
    """J by the kernel where `kernel_takes` says so, else by the plain version."""
    jc = JacobianContext(anc, pos, trans, rot)
    if kernel_takes(jc, points, pt_mat, scale):
        return _point_jacobian_kernel(jc, points, parents, pt_mat, scale)
    return point_jacobian_model_plain(jc, points, parents, pt_mat, scale=scale)


def _point_plain(anc, pos, trans, rot, points, parents, pt_mat, scale):
    """The plain version in the argument order of `_PointJacobian.forward`."""
    return point_jacobian_model_plain(JacobianContext(anc, pos, trans, rot), points, parents,
                                      pt_mat, scale=scale)


def _plain_of(plain, args, idx):
    """`plain` as a function of the inputs at the positions `idx` of `args`
    (its own argument order), the rest held."""

    def fn(*vals):
        full = list(args)
        for i, v in zip(idx, vals):
            full[i] = v
        return plain(*full)

    return fn


def _backward(plain, ctx, grad_out):
    """The VJP of `plain` at the saved inputs, for the inputs that need it."""
    args = ctx.saved_tensors
    idx = [i for i, need in enumerate(ctx.needs_input_grad) if need]
    _, vjp = torch.func.vjp(_plain_of(plain, args, idx), *(args[i] for i in idx))
    grads = dict(zip(idx, vjp(grad_out)))
    return tuple(grads.get(i) for i in range(len(args)))


def _jvp(plain, ctx, tangents):
    """The JVP of `plain` at the saved inputs."""
    args = ctx.saved_tensors
    idx = [i for i, t in enumerate(tangents) if t is not None]
    return torch.func.jvp(_plain_of(plain, args, idx), tuple(args[i] for i in idx),
                          tuple(tangents[i] for i in idx))[1]


def _vmap(apply, element_dims, info, in_dims, args):
    """A vmapped dimension of the per-element inputs (`element_dims`: their
    positions and the trailing dims each has past its leading, batch, dims)
    becomes the leading batch dimension of one launch: it moves to the
    front, past as many unit dims as the widest input has leading dims, and
    the inputs not vmapped broadcast against it from the right. Any other
    vmapped input takes one launch a slice."""
    if all(d is None for d in in_dims):
        return apply(*args), None
    if any(in_dims[i] is not None for i in range(len(args)) if i not in element_dims):
        return torch.stack([apply(*(a if d is None else a.select(d, k)
                                    for a, d in zip(args, in_dims)))
                            for k in range(info.batch_size)]), 0
    lead = max(args[i].ndim - (in_dims[i] is not None) - t
               for i, t in element_dims.items() if args[i] is not None)
    moved = list(args)
    for i, t in element_dims.items():
        if in_dims[i] is not None:
            a = args[i].movedim(in_dims[i], 0)
            moved[i] = a.reshape(a.shape[:1] + (1,) * (lead + t + 1 - a.ndim) + a.shape[1:])
    return apply(*moved), 0


# the per-element inputs of `_PointJacobian.forward` by position, and the
# trailing dims each has past its leading (batch) dims
_ELEMENT_DIMS = {1: 2, 2: 3, 3: 3, 4: 2, 7: 1}


class _PointJacobian(torch.autograd.Function):
    """J by the kernel (or, outside `kernel_takes`, the plain version); the
    derivatives are those of the plain version at the saved inputs."""

    @staticmethod
    def forward(anc, pos, trans, rot, points, parents, pt_mat, scale):
        return _forward(anc, pos, trans, rot, points, parents, pt_mat, scale)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)
        ctx.save_for_forward(*inputs)

    @staticmethod
    def backward(ctx, grad_out):
        return _backward(_point_plain, ctx, grad_out)

    @staticmethod
    def jvp(ctx, *tangents):
        return _jvp(_point_plain, ctx, tangents)

    @staticmethod
    def vmap(info, in_dims, *args):
        """One launch for a vmapped per-element input, one a slice for a
        vmapped mask, parents or transform (`_vmap`)."""
        return _vmap(_PointJacobian.apply, _ELEMENT_DIMS, info, in_dims, args)


def point_jacobian_model(jc: JacobianContext, points: torch.Tensor, parents: torch.Tensor,
                         pt_mat: torch.Tensor, scale=None) -> torch.Tensor:
    """d(world point)/d(MODEL parameters), (..., C, 3, P), of points
    (..., C, 3) attached to the joints `parents` (C,), pt_mat (nJ*7, P),
    optional row scale (C,) or (..., C): the kernel where `kernel_takes`
    says so, else `point_jacobian_model_plain` (the same arguments). The
    call goes through `_PointJacobian` on either device, so reverse mode,
    forward mode and torch.func's transforms reach the kernel through its
    rules."""
    return _PointJacobian.apply(jc.anc_mask, jc.joint_pos, jc.trans_axis, jc.rot_axis, points,
                                parents, pt_mat, scale)


def _point_jacobian_kernel(jc: JacobianContext, points: torch.Tensor, parents: torch.Tensor,
                           pt_mat: torch.Tensor, scale) -> torch.Tensor:
    """Launch point_jacobian_kernel on the current stream; raise on inputs
    it does not take. Leading dims broadcast as in the plain version; the
    joint positions may be the skeleton states' first three columns as
    they lie, a (C,) scale is read as one row for every element."""
    global launches
    nj, c, p = jc.anc_mask.shape[0], parents.shape[0], pt_mat.shape[1]
    device = points.device
    if (jc.anc_mask.shape != (nj, nj) or jc.joint_pos.shape[-2:] != (nj, 3)
            or jc.trans_axis.shape[-3:] != (nj, 3, 3) or jc.rot_axis.shape[-3:] != (nj, 3, 3)
            or points.shape[-2:] != (c, 3) or parents.ndim != 1
            or pt_mat.shape != (7 * nj, p) or (scale is not None and scale.shape[-1:] != (c,))):
        raise ValueError("point_jacobian_kernel: inconsistent shapes: anc_mask "
                         f"{tuple(jc.anc_mask.shape)}, joint_pos {tuple(jc.joint_pos.shape)}, "
                         f"axes {tuple(jc.trans_axis.shape)}, {tuple(jc.rot_axis.shape)}, "
                         f"points {tuple(points.shape)}, parents {tuple(parents.shape)}, "
                         f"pt_mat {tuple(pt_mat.shape)}, scale "
                         f"{None if scale is None else tuple(scale.shape)}")
    tensors = _inputs(jc, points, pt_mat, scale) + [parents]
    if any(t.device != device for t in tensors):
        raise ValueError("point_jacobian_kernel takes every input on one CUDA device")
    batch = torch.broadcast_shapes(jc.joint_pos.shape[:-2], jc.trans_axis.shape[:-3],
                                   jc.rot_axis.shape[:-3], points.shape[:-2],
                                   () if scale is None else scale.shape[:-1])
    out = torch.empty(batch + (c, 3, p), dtype=torch.float32, device=device)
    b = math.prod(batch)
    if b == 0 or c == 0 or p == 0:
        return out.zero_()
    lib = _lib()
    if point_jacobian_tile(nj, c, p) < 1:
        raise ValueError(f"point_jacobian_kernel: a rig of {nj} joints and {c} constraints "
                         "does not fit a block's shared memory")
    trans = jc.trans_axis.expand(batch + (nj, 3, 3)).reshape(b, nj, 9).contiguous()
    rot = jc.rot_axis.expand(batch + (nj, 3, 3)).reshape(b, nj, 9).contiguous()
    pos = jc.joint_pos.expand(batch + (nj, 3)).reshape(b, nj, 3)
    if pos.stride(-1) != 1:
        pos = pos.contiguous()
    pts = points.expand(batch + (c, 3)).reshape(b, c, 3).contiguous()
    if scale is None:
        scale_rows, scale_es = None, 0
    elif scale.numel() == c:  # one row for every element
        scale_rows, scale_es = scale.reshape(c).contiguous(), 0
    else:
        scale_rows, scale_es = scale.expand(batch + (c,)).reshape(b, c).contiguous(), c
    anc = jc.anc_mask.contiguous()
    pt = pt_mat.contiguous()
    cpar = parents.to(torch.int32).contiguous()
    with torch.cuda.device(device):
        rc = lib.point_jacobian_launch(
            anc.data_ptr(), trans.data_ptr(), rot.data_ptr(), pos.data_ptr(), pos.stride(0),
            pos.stride(1), pts.data_ptr(), None if scale_rows is None else scale_rows.data_ptr(),
            scale_es, cpar.data_ptr(), pt.data_ptr(), out.data_ptr(), b, c, nj, p,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"point_jacobian_kernel launch failed: CUDA error {rc}")
    launches += 1
    return out


def projection_jacobian_tile(nj: int, c: int, k: int, p: int) -> int:
    """The columns of P one block of the projection form takes for a rig of
    nJ joints, C points, K cameras and P parameters, by K6's rule; 0 where
    not one column fits a block's shared memory."""
    return _lib().projection_jacobian_tile(nj, c, k, p)


def projection_jacobian_model_plain(jc: JacobianContext, points: torch.Tensor,
                                    parents: torch.Tensor, pt_mat: torch.Tensor,
                                    cam_rot: torch.Tensor, cam_trans: torch.Tensor,
                                    cam_params: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """d(rows)/d(MODEL parameters), (..., 2KC, P), of K cameras' pixel rows
    of the points (..., C, 3) attached to `parents` (C,): the merged point
    Jacobian (..., C, 3, P) chained, for each (camera k, point c), through
    s_kc·dπ_k/dp_eye·R_k at p_eye = R_k·p_c + t_k. cam_rot (K, 3, 3) and
    cam_trans (K, 3) map world to eye space, cam_params (K, 12) are the
    OpenCV intrinsics (camera/models.py::stack_opencv_parameters), scale
    (..., K, C) the rows' scales; a pair of scale 0 has rows of zeros."""
    jw = point_jacobian_model_plain(jc, points, parents, pt_mat)  # (..., C, 3, P)
    p_eye = torch.einsum("kwv,...cv->...kcw", cam_rot, points) + cam_trans[:, None, :]
    m = project_opencv_jacobian(p_eye, cam_params[:, None, :]) @ cam_rot[:, None]
    m = torch.where((scale != 0)[..., None, None], scale[..., None, None] * m, 0.0)
    j = torch.einsum("...kcvw,...cwp->...kcvp", m, jw)
    return j.reshape(j.shape[:-4] + (-1, j.shape[-1]))


def _projection_plain(anc, pos, trans, rot, points, parents, pt_mat, cam_rot, cam_trans,
                      cam_params, scale):
    """The plain form in the argument order of `_ProjectionJacobian.forward`."""
    return projection_jacobian_model_plain(JacobianContext(anc, pos, trans, rot), points,
                                           parents, pt_mat, cam_rot, cam_trans, cam_params, scale)


def _projection_forward(anc, pos, trans, rot, points, parents, pt_mat, cam_rot, cam_trans,
                        cam_params, scale):
    """J by the kernel where `kernel_takes` says so, else by the plain form."""
    jc = JacobianContext(anc, pos, trans, rot)
    if kernel_takes(jc, points, pt_mat, scale) and all(
            t.is_cuda and t.dtype == torch.float32 for t in (cam_rot, cam_trans, cam_params)):
        return _projection_jacobian_kernel(jc, points, parents, pt_mat, cam_rot, cam_trans,
                                           cam_params, scale)
    return _projection_plain(anc, pos, trans, rot, points, parents, pt_mat, cam_rot, cam_trans,
                             cam_params, scale)


# the per-element inputs of `_ProjectionJacobian.forward` and their trailing dims
_PROJECTION_ELEMENT_DIMS = {1: 2, 2: 3, 3: 3, 4: 2, 10: 2}


class _ProjectionJacobian(torch.autograd.Function):
    """J by the projection kernel (or, outside `kernel_takes`, the plain
    form); the derivatives are those of the plain form at the saved inputs."""

    @staticmethod
    def forward(anc, pos, trans, rot, points, parents, pt_mat, cam_rot, cam_trans, cam_params,
                scale):
        return _projection_forward(anc, pos, trans, rot, points, parents, pt_mat, cam_rot,
                                   cam_trans, cam_params, scale)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)
        ctx.save_for_forward(*inputs)

    @staticmethod
    def backward(ctx, grad_out):
        return _backward(_projection_plain, ctx, grad_out)

    @staticmethod
    def jvp(ctx, *tangents):
        return _jvp(_projection_plain, ctx, tangents)

    @staticmethod
    def vmap(info, in_dims, *args):
        return _vmap(_ProjectionJacobian.apply, _PROJECTION_ELEMENT_DIMS, info, in_dims, args)


def projection_jacobian_model(jc: JacobianContext, points: torch.Tensor, parents: torch.Tensor,
                              pt_mat: torch.Tensor, cam_rot: torch.Tensor,
                              cam_trans: torch.Tensor, cam_params: torch.Tensor,
                              scale: torch.Tensor) -> torch.Tensor:
    """K cameras' pixel rows' d(rows)/d(MODEL parameters), (..., 2KC, P):
    the projection kernel where `kernel_takes` says so, else
    `projection_jacobian_model_plain` (the same arguments), through
    `_ProjectionJacobian` on either device."""
    return _ProjectionJacobian.apply(jc.anc_mask, jc.joint_pos, jc.trans_axis, jc.rot_axis,
                                     points, parents, pt_mat, cam_rot, cam_trans, cam_params,
                                     scale)


def _projection_jacobian_kernel(jc: JacobianContext, points, parents, pt_mat, cam_rot,
                                cam_trans, cam_params, scale) -> torch.Tensor:
    """Launch projection_jacobian_kernel on the current stream; raise on
    inputs it does not take. Leading dims broadcast as in the plain form."""
    global projection_launches
    nj, c, p = jc.anc_mask.shape[0], parents.shape[0], pt_mat.shape[1]
    k = cam_rot.shape[0]
    device = points.device
    if (jc.anc_mask.shape != (nj, nj) or jc.joint_pos.shape[-2:] != (nj, 3)
            or jc.trans_axis.shape[-3:] != (nj, 3, 3) or jc.rot_axis.shape[-3:] != (nj, 3, 3)
            or points.shape[-2:] != (c, 3) or parents.ndim != 1
            or pt_mat.shape != (7 * nj, p) or cam_rot.shape != (k, 3, 3)
            or cam_trans.shape != (k, 3) or cam_params.shape != (k, 12)
            or scale.shape[-2:] != (k, c)):
        raise ValueError("projection_jacobian_kernel: inconsistent shapes: anc_mask "
                         f"{tuple(jc.anc_mask.shape)}, joint_pos {tuple(jc.joint_pos.shape)}, "
                         f"axes {tuple(jc.trans_axis.shape)}, {tuple(jc.rot_axis.shape)}, "
                         f"points {tuple(points.shape)}, parents {tuple(parents.shape)}, "
                         f"pt_mat {tuple(pt_mat.shape)}, cameras {tuple(cam_rot.shape)}, "
                         f"{tuple(cam_trans.shape)}, {tuple(cam_params.shape)}, scale "
                         f"{tuple(scale.shape)}")
    tensors = [jc.anc_mask, jc.joint_pos, jc.trans_axis, jc.rot_axis, points, pt_mat, cam_rot,
               cam_trans, cam_params, scale, parents]
    if any(t.device != device for t in tensors):
        raise ValueError("projection_jacobian_kernel takes every input on one CUDA device")
    batch = torch.broadcast_shapes(jc.joint_pos.shape[:-2], jc.trans_axis.shape[:-3],
                                   jc.rot_axis.shape[:-3], points.shape[:-2], scale.shape[:-2])
    out = torch.empty(batch + (2 * k * c, p), dtype=torch.float32, device=device)
    b = math.prod(batch)
    if b == 0 or c == 0 or p == 0 or k == 0:
        return out.zero_()
    lib = _lib()
    if projection_jacobian_tile(nj, c, k, p) < 1:
        raise ValueError(f"projection_jacobian_kernel: a rig of {nj} joints and {c} points "
                         "does not fit a block's shared memory")
    trans = jc.trans_axis.expand(batch + (nj, 3, 3)).reshape(b, nj, 9).contiguous()
    rot = jc.rot_axis.expand(batch + (nj, 3, 3)).reshape(b, nj, 9).contiguous()
    pos = jc.joint_pos.expand(batch + (nj, 3)).reshape(b, nj, 3)
    if pos.stride(-1) != 1:
        pos = pos.contiguous()
    pts = points.expand(batch + (c, 3)).reshape(b, c, 3).contiguous()
    sc = scale.expand(batch + (k, c)).reshape(b, k * c).contiguous()
    cams = torch.cat([cam_rot.reshape(k, 9), cam_trans, cam_params], dim=1).contiguous()
    anc = jc.anc_mask.contiguous()
    pt = pt_mat.contiguous()
    cpar = parents.to(torch.int32).contiguous()
    with torch.cuda.device(device):
        rc = lib.projection_jacobian_launch(
            anc.data_ptr(), trans.data_ptr(), rot.data_ptr(), pos.data_ptr(), pos.stride(0),
            pos.stride(1), pts.data_ptr(), sc.data_ptr(), cams.data_ptr(), cpar.data_ptr(),
            pt.data_ptr(), out.data_ptr(), b, c, k, nj, p,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"projection_jacobian_kernel launch failed: CUDA error {rc}")
    projection_launches += 1
    return out

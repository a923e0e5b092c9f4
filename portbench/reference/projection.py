"""Plain multi-view keypoint fitting: the pixel residuals of calibrated
cameras and a batched Levenberg-Marquardt with a compacted tail, written
from the published camera model (OpenCV's, as the CMU Panoptic Studio's
calibration states it) and the semantics of reference/ik.py's LM:

  world → eye      p_eye = R·p + t                       (R, t per camera)
  perspective      x' = x/z, y' = y/z
  distortion       r² = x'² + y'²
                   x'' = x'·(1 + k1r² + k2r⁴ + k3r⁶)/(1 + k4r² + k5r⁴ + k6r⁶)
                         + 2p1x'y' + p2(r² + 2x'²)
                   y'' = y'·(the same ratio) + p1(r² + 2y'²) + 2p2x'y'
  pixels           u = fx·x'' + cx,  v = fy·y'' + cy
  residual         r = sqrt(w·c)·(uv − target), zero where z < near_clip or
                   z ≤ 0 (w the module weight, c the keypoint's confidence;
                   a NaN depth is neither, so a failed step's rows are NaN)
  energy           Σ r² per frame, float32

The locators come from reference/kinematics.py's FK. The Jacobian is
forward mode (torch.func.jvp) through that FK and this projection, in two
stages chained, in blocks of frames, each block's JᵀJ and Jᵀr formed where
its J is, so that no batch's whole J is held. LM as reference/ik.py
states it. Products are torch.matmul, so the code runs in whatever matmul
precision the process sets; TF32 is off unless a caller turns it on.

Departures from the published description: OpenCV's k4..k6 are zero in the
source's 5-coefficient model and kept here as the general rational form;
the points are the rig's locators (the source's keypoints are detected
joints); the residual is zero behind the near clip, as momentum's camera
projection error function makes it. Nothing here imports the port or calls
its kernels.
"""

from __future__ import annotations

import json
from typing import NamedTuple

import torch

from portbench.reference import kinematics as kin
from portbench.rig import ROOT

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

_FLT_EPS = float(torch.finfo(torch.float32).eps)
_FLT_MIN = float(torch.finfo(torch.float32).tiny)
_BIG = 3.0e38


class RefCameras(NamedTuple):
    rotation: torch.Tensor  # (K, 3, 3) world → eye
    translation: torch.Tensor  # (K, 3)
    focal: torch.Tensor  # (K, 2) fx, fy
    centre: torch.Tensor  # (K, 2) cx, cy
    k: torch.Tensor  # (K, 6) radial k1..k6
    p: torch.Tensor  # (K, 2) tangential p1, p2
    image_size: tuple  # (width, height)
    near_clip: float


def load_cameras(path: str) -> dict:
    """The camera file named relative to the root of the checkout."""
    return json.loads((ROOT / path).read_text())


def reference_cameras(doc: dict, near_clip: float, device,
                      dtype=torch.float32) -> RefCameras:
    cams = doc["cameras"]

    def t(key):
        return torch.as_tensor([c[key] for c in cams], dtype=dtype, device=device)

    return RefCameras(rotation=t("rotation"), translation=t("translation_m"),
                      focal=torch.stack([t("fx"), t("fy")], -1),
                      centre=torch.stack([t("cx"), t("cy")], -1), k=t("k"), p=t("p"),
                      image_size=tuple(doc["image_size"]), near_clip=float(near_clip))


def project(cams: RefCameras, points: torch.Tensor):
    """World points (..., L, 3) → (pixels (..., K, L, 2), depth (..., K, L))."""
    p_eye = (torch.matmul(cams.rotation, points[..., None, :, :].transpose(-1, -2))
             .transpose(-1, -2) + cams.translation[:, None, :])
    z = p_eye[..., 2]
    safe = torch.where(torch.abs(z) > 1e-12, z, torch.ones_like(z))
    x, y = p_eye[..., 0] / safe, p_eye[..., 1] / safe
    k = cams.k[:, None, :].unbind(-1)
    p1, p2 = cams.p[:, None, :].unbind(-1)
    r2 = x * x + y * y
    ratio = ((1.0 + r2 * (k[0] + r2 * (k[1] + r2 * k[2])))
             / (1.0 + r2 * (k[3] + r2 * (k[4] + r2 * k[5]))))
    xd = x * ratio + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * ratio + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    uv = (torch.stack([xd, yd], -1) * cams.focal[:, None, :] + cams.centre[:, None, :])
    return uv, z


def point_rows(cams: RefCameras, points, targets, confidence, weight: float = 1.0):
    """(..., K, L, 2) rows of world points (..., L, 3) against pixel
    targets (..., K, L, 2) with confidences (..., K, L)."""
    uv, z = project(cams, points)
    behind = (z <= 0) | (z < cams.near_clip)
    f = torch.where(behind[..., None], 0.0, uv - targets)
    return torch.sqrt(torch.clamp(weight * confidence, min=0.0))[..., None] * f


def residual(rr, cams: RefCameras, theta, targets, confidence, weight: float = 1.0):
    """(..., K·L·2) rows, camera by camera, of θ (..., P)."""
    r = point_rows(cams, kin.locator_positions(rr, theta), targets, confidence, weight)
    return r.reshape(r.shape[:-3] + (-1,))


def energy(rr, cams, theta, targets, confidence):
    r = residual(rr, cams, theta, targets, confidence)
    return torch.sum(r * r, dim=-1)


def energies(rr, cams, theta, targets, confidence, block: int = 4096):
    """Σ r² of each frame, evaluated in blocks."""
    return torch.cat([energy(rr, cams, theta[i:i + block], targets[i:i + block],
                             confidence[i:i + block])
                      for i in range(0, theta.shape[0], block)])


def residual_and_jacobian(rr, cams, theta, targets, confidence):
    """(rows (B, R), J (B, R, P)) by forward mode in two stages: the
    locators' Jacobian through FK (one JVP a parameter direction, set on
    every frame at once), then the rows' derivatives in their points (one
    JVP a world axis, set on every point at once: a row depends on its own
    point alone), chained."""
    eye = torch.eye(theta.shape[-1], dtype=theta.dtype, device=theta.device)
    points, d_points = torch.func.vmap(lambda e: torch.func.jvp(
        lambda x: kin.locator_positions(rr, x), (theta,), (e.expand_as(theta),)))(eye)
    points = points[0]  # (B, L, 3); d_points (P, B, L, 3)
    axes = torch.eye(3, dtype=theta.dtype, device=theta.device)
    rows, d_rows = torch.func.vmap(lambda a: torch.func.jvp(
        lambda p: point_rows(cams, p, targets, confidence), (points,),
        (a.expand_as(points),)))(axes)  # (3, B, K, L, 2)
    jac = torch.einsum("abklv,pbla->bklvp", d_rows, d_points)
    return rows[0].reshape(rows.shape[1], -1), jac.reshape(jac.shape[0], -1, jac.shape[-1])


def normal_equations(rr, cams, theta, targets, confidence, block: int):
    """(JᵀJ (B, P, P), Jᵀr (B, P)), J formed `block` frames at a time."""
    jtj, jtr = [], []
    for i in range(0, theta.shape[0], block):
        sl = slice(i, i + block)
        rows, jac = residual_and_jacobian(rr, cams, theta[sl], targets[sl], confidence[sl])
        jt = jac.transpose(-1, -2)
        jtj.append(jt @ jac)
        jtr.append((jt @ rows[..., None])[..., 0])
        del rows, jac, jt
    return torch.cat(jtj), torch.cat(jtr)


def _step(rr, cams, x, targets, confidence, lam, opts, block):
    jtj, jtr = normal_equations(rr, cams, x, targets, confidence, block)
    diag = torch.clamp(torch.diagonal(jtj, dim1=-2, dim2=-1), min=1e-12)
    damp = lam[:, None] * diag + opts["regularization"]
    chol, info = torch.linalg.cholesky_ex(jtj + torch.diag_embed(damp))
    delta = torch.cholesky_solve(jtr[..., None], chol)[..., 0]
    delta = torch.where((info != 0)[:, None], torch.full_like(delta, float("nan")), delta)
    return x - delta


def levenberg_marquardt(rr, cams, targets, confidence, x0, iters: int, lam0, opts: dict,
                        block: int):
    """(x, energy, λ) after up to `iters` LM iterations on every frame."""
    batch = x0.shape[0]
    lam = (torch.full((batch,), opts["lambda_init"], dtype=x0.dtype, device=x0.device)
           if lam0 is None else lam0.clone())
    x = x0
    err = energies(rr, cams, x, targets, confidence)
    done = torch.zeros(batch, dtype=torch.bool, device=x0.device)
    for it in range(iters):
        if bool(done.all()):
            break
        x_trial = _step(rr, cams, x, targets, confidence, lam, opts, block)
        err_trial = energies(rr, cams, x_trial, targets, confidence)
        accept = err_trial < err
        conv = accept & (torch.abs(err - err_trial) / (torch.abs(err_trial) + _FLT_MIN)
                         <= opts["threshold"] * _FLT_EPS)
        lam_new = torch.clamp(torch.where(accept, lam * opts["lambda_down"],
                                          lam * opts["lambda_up"]),
                              opts["lambda_min"], opts["lambda_max"])
        x = torch.where((done | ~accept)[:, None], x, x_trial)
        err = torch.where(done | ~accept, err, err_trial)
        lam = torch.where(done, lam, lam_new)
        done = done | ((it + 1 >= opts["min_iterations"]) & conv)
    return x, err, lam


def solve_compacted(rr, cams, targets, confidence, x0, opts: dict, k_full: int, r_refine: int,
                    capacity: int, block: int = 2048):
    """(x, energy) of the compacted schedule on one batch of frames."""
    x, err, lam = levenberg_marquardt(rr, cams, targets, confidence, x0, k_full, None, opts,
                                      block)
    key = torch.nan_to_num(err, nan=_BIG, posinf=_BIG)
    idx = torch.topk(key, capacity).indices
    x2, err2, _ = levenberg_marquardt(rr, cams, targets[idx], confidence[idx], x[idx], r_refine,
                                      lam[idx], opts, block)
    return x.index_copy(0, idx, x2), err.index_copy(0, idx, err2)

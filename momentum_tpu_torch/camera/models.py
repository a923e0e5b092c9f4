"""Camera models: pinhole, OpenCV (rational radial + tangential) and OpenCV
fisheye intrinsics, and the camera's extrinsics T_eye_from_world
(camera.h:29-640), after momentum_tpu/camera/models.py.

Conventions (camera.h): `project(p_eye)` maps eye-space points to (u, v, z),
pixel coordinates plus the eye-space depth, with valid = z > 0; eye-space +Z
looks forward and +Y points down.

  * OpenCV distortion (camera.cpp:313-344):
      radial = (1 + r²(k1 + r²(k2 + r²k3))) / (1 + r²(k4 + r²(k5 + r²k6)))
      x'' = x'·radial + 2p1x'y' + p2(r² + 2x'²); y'' symmetric
  * fisheye (camera.cpp:759-815): θd = θ(1 + k1θ² + k2θ⁴ + k3θ⁶ + k4θ⁸),
    scale θd/r (1 on the axis)
  * unproject inverts the distortion by a fixed 10-step Newton solve
    (camera.h:72-78), each step's 2×2 Jacobian by two forward-mode JVPs.

`project_jacobian(p_eye)` gives the projection's derivative in the
eye-space point, d(u, v)/d p_eye (..., 2, 3), in closed form for pinhole and
OpenCV intrinsics (`has_analytic_jacobian`); with (x', y') = (x, y)/z and
the distortion's 2×2 Jacobian [[a, b], [c, d]] = d(x'', y'')/d(x', y'),

    du/dp = fx/z·[a, b, −(a·x' + b·y')],  dv/dp = fy/z·[c, d, −(c·x' + d·y')]

the OpenCV one, with g = d radial/d r² = (num' − radial·den')/den,
    a = radial + 2x'²g + 2p1y' + 6p2x',  b = c = 2x'y'g + 2p1x' + 2p2y',
    d = radial + 2y'²g + 6p1y' + 2p2x'.
The fisheye model has none (its rows go by forward mode).
`stack_opencv_parameters` writes a camera's intrinsics as the 12 numbers
(fx, fy, cx, cy, k1..k6, p1, p2) of the OpenCV model, a pinhole's with zero
distortion, which the model computes to the same bits.

The intrinsics are float32 tensors on the camera's device, so they may be
solver variables (camera_intrinsics_parameters.h): `project_intrinsics_jacobian`
differentiates the projection in them by forward mode. `Camera.frame` and
`Camera.look_at` are host numpy code, as in the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from momentum_tpu_torch.device import resolve
from momentum_tpu_torch.math import quaternion as quat, skel_state as ss

__all__ = ["PinholeIntrinsics", "OpenCVIntrinsics", "OpenCVFisheyeIntrinsics", "Camera",
           "opencv_distort", "opencv_distort_jacobian", "project_opencv", "project_opencv_jacobian",
           "stack_opencv_parameters"]


def _tensors(device, **values):
    return {k: torch.as_tensor(np.asarray(v, np.float32), device=device)
            for k, v in values.items()}


def opencv_distort(xp, yp, k, p):
    """OpenCV's rational radial and tangential distortion of normalized
    (x', y'): k the six radial coefficients and p (p1, p2), each a tensor
    that broadcasts against xp."""
    r2 = xp * xp + yp * yp
    radial = ((1.0 + r2 * (k[0] + r2 * (k[1] + r2 * k[2])))
              / (1.0 + r2 * (k[3] + r2 * (k[4] + r2 * k[5]))))
    p1, p2 = p[0], p[1]
    xpp = xp * radial + 2.0 * p1 * xp * yp + p2 * (r2 + 2.0 * xp * xp)
    ypp = yp * radial + p1 * (r2 + 2.0 * yp * yp) + 2.0 * p2 * xp * yp
    return xpp, ypp


def opencv_distort_jacobian(xp, yp, k, p):
    """(a, b, c, d) = d(x'', y'')/d(x', y') of `opencv_distort`, row-major."""
    r2 = xp * xp + yp * yp
    num = 1.0 + r2 * (k[0] + r2 * (k[1] + r2 * k[2]))
    den = 1.0 + r2 * (k[3] + r2 * (k[4] + r2 * k[5]))
    radial = num / den
    d_num = k[0] + r2 * (2.0 * k[1] + 3.0 * r2 * k[2])
    d_den = k[3] + r2 * (2.0 * k[4] + 3.0 * r2 * k[5])
    g = (d_num - radial * d_den) / den
    p1, p2 = p[0], p[1]
    cross = 2.0 * xp * yp * g + 2.0 * p1 * xp + 2.0 * p2 * yp
    a = radial + 2.0 * xp * xp * g + 2.0 * p1 * yp + 6.0 * p2 * xp
    d = radial + 2.0 * yp * yp * g + 6.0 * p1 * yp + 2.0 * p2 * xp
    return a, cross, cross, d


def _perspective(p_eye):
    """(x', y', 1/z, z) of eye-space points, z = 0 read as 1, as `project` divides."""
    z = p_eye[..., 2]
    safe_z = torch.where(torch.abs(z) > 1e-12, z, torch.ones_like(z))
    return p_eye[..., 0] / safe_z, p_eye[..., 1] / safe_z, 1.0 / safe_z, z


def _chain_perspective(fx, fy, xp, yp, inv_z, a, b, c, d):
    """d(u, v)/d p_eye (..., 2, 3) from the distortion's Jacobian [[a, b], [c, d]]."""
    du = torch.stack([a, b, -(a * xp + b * yp)], dim=-1) * (fx * inv_z)[..., None]
    dv = torch.stack([c, d, -(c * xp + d * yp)], dim=-1) * (fy * inv_z)[..., None]
    return torch.stack([du, dv], dim=-2)


def project_opencv(p_eye, params):
    """(uv (..., 2), z (...,)) of eye-space points through OpenCV intrinsics
    given as `stack_opencv_parameters`' 12 numbers, `params` (..., 12)
    broadcasting against p_eye's leading dims: `project`'s arithmetic."""
    xp, yp, _, z = _perspective(p_eye)
    q = params.unbind(-1)
    xpp, ypp = opencv_distort(xp, yp, q[4:10], q[10:12])
    return torch.stack([q[0] * xpp + q[2], q[1] * ypp + q[3]], dim=-1), z


def project_opencv_jacobian(p_eye, params):
    """d(u, v)/d p_eye (..., 2, 3) of `project_opencv`."""
    xp, yp, inv_z, _ = _perspective(p_eye)
    q = params.unbind(-1)
    return _chain_perspective(q[0], q[1], xp, yp, inv_z,
                              *opencv_distort_jacobian(xp, yp, q[4:10], q[10:12]))


def stack_opencv_parameters(intrinsics) -> torch.Tensor:
    """(K, 12): each pinhole or OpenCV intrinsics of the sequence as
    (fx, fy, cx, cy, k1..k6, p1, p2), a pinhole's distortion zero."""
    return torch.stack([intr.opencv_parameters() for intr in intrinsics])


class _IntrinsicsBase:
    """project(p) -> ((..., 3) [u, v, z], valid); _distort maps normalized
    (x', y') to distorted (x'', y''). The pymomentum IntrinsicsModel surface
    (camera.h:85-160): the intrinsic parameter vector, its projection
    Jacobian, and resize / crop / down- and upsample when the image size is
    known."""

    _scalar_params = ("fx", "fy", "cx", "cy")
    _vector_params = ()  # (field, length) pairs, in the parameter vector's order
    # whether `project_jacobian` has a closed form (`_distort_jacobian`)
    has_analytic_jacobian = False

    def _distort(self, xp, yp):
        return xp, yp

    def _distort_jacobian(self, xp, yp):
        raise NotImplementedError(f"{type(self).__name__} has no analytic projection Jacobian")

    def opencv_parameters(self) -> torch.Tensor:
        """(12,) (fx, fy, cx, cy, k1..k6, p1, p2): the model as OpenCV's, a
        pinhole's distortion zero."""
        if not self.has_analytic_jacobian:
            raise ValueError(f"{type(self).__name__} has no OpenCV form")
        fields = [getattr(self, f).reshape(1) for f in ("fx", "fy", "cx", "cy")]
        dist = ([self.k.reshape(6), self.p.reshape(-1)[:2]] if hasattr(self, "k")
                else [fields[0].new_zeros(8)])
        return torch.cat(fields + dist)

    def parameter_names(self):
        names = list(self._scalar_params)
        for field, length in self._vector_params:
            names += [f"{field}{i + 1}" for i in range(length)]
        return names

    @property
    def num_intrinsic_parameters(self) -> int:
        return len(self._scalar_params) + sum(n for _, n in self._vector_params)

    def get_intrinsic_parameters(self) -> torch.Tensor:
        return torch.cat([getattr(self, f).reshape(1) for f in self._scalar_params]
                         + [getattr(self, f).reshape(n) for f, n in self._vector_params])

    def set_intrinsic_parameters(self, params):
        """A new model with the parameter vector `params` (setIntrinsicParameters)."""
        params = torch.as_tensor(params, dtype=torch.float32, device=self.fx.device)
        if params.shape[-1] != self.num_intrinsic_parameters:
            raise ValueError(f"expected {self.num_intrinsic_parameters} parameters, got "
                             f"{params.shape[-1]}")
        kw = {f: params[i] for i, f in enumerate(self._scalar_params)}
        off = len(self._scalar_params)
        for f, n in self._vector_params:
            kw[f] = params[off: off + n]
            off += n
        return dataclasses.replace(self, **kw)

    def clone(self):
        return dataclasses.replace(self)

    def to(self, device):
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device) for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})

    def project_intrinsics_jacobian(self, p_eye):
        """(uvz, d(u, v)/d(intrinsics) (..., 2, N), valid): the reference's
        projectIntrinsicsJacobian (camera.h:166-175), by forward mode."""
        p_eye = torch.as_tensor(p_eye, dtype=torch.float32, device=self.fx.device)

        def uv(vec):
            return self.set_intrinsic_parameters(vec).project(p_eye)[0][..., :2]

        uvz, valid = self.project(p_eye)
        return uvz, torch.func.jacfwd(uv)(self.get_intrinsic_parameters()), valid

    def _require_size(self):
        if not self.image_width or not self.image_height:
            raise ValueError("intrinsics carry no image size; pass image_size to create()")

    def resize(self, image_width: int, image_height: int):
        """Rescale to a new resolution, pixel centres mapping exactly
        (the half-pixel convention, camera.cpp:144-159)."""
        self._require_size()
        sx = image_width / self.image_width
        sy = image_height / self.image_height
        return dataclasses.replace(self, fx=self.fx * sx, fy=self.fy * sy,
                                   cx=(self.cx + 0.5) * sx - 0.5,
                                   cy=(self.cy + 0.5) * sy - 0.5,
                                   image_width=int(image_width),
                                   image_height=int(image_height))

    def crop(self, top: int, left: int, new_width: int, new_height: int):
        """A sub-region of the image: the principal point shifts, the focal
        length stays (camera.h:107-118)."""
        return dataclasses.replace(self, cx=self.cx - left, cy=self.cy - top,
                                   image_width=int(new_width), image_height=int(new_height))

    def downsample(self, factor: float):
        self._require_size()
        return self.resize(int(self.image_width / factor), int(self.image_height / factor))

    def upsample(self, factor: float):
        self._require_size()
        return self.resize(int(self.image_width * factor), int(self.image_height * factor))

    def project(self, p_eye: torch.Tensor):
        """(..., 3) eye-space points → ((..., 3) [u, v, z], (...,) z > 0)."""
        z = p_eye[..., 2]
        safe_z = torch.where(torch.abs(z) > 1e-12, z, torch.ones_like(z))
        xpp, ypp = self._distort(p_eye[..., 0] / safe_z, p_eye[..., 1] / safe_z)
        return torch.stack([self.fx * xpp + self.cx, self.fy * ypp + self.cy, z], dim=-1), z > 0

    def project_jacobian(self, p_eye: torch.Tensor):
        """(uvz (..., 3), valid (...,), d(u, v)/d p_eye (..., 2, 3)): `project`
        and its derivative in the eye-space point, in closed form (the
        models with `has_analytic_jacobian`)."""
        xp, yp, inv_z, z = _perspective(p_eye)
        xpp, ypp = self._distort(xp, yp)
        uvz = torch.stack([self.fx * xpp + self.cx, self.fy * ypp + self.cy, z], dim=-1)
        return uvz, z > 0, _chain_perspective(self.fx, self.fy, xp, yp, inv_z,
                                              *self._distort_jacobian(xp, yp))

    def unproject(self, uvz: torch.Tensor, iterations: int = 10) -> torch.Tensor:
        """Eye-space points of pixels (u, v) at depth z (camera.h:72-78):
        `iterations` Newton steps on the distortion from the undistorted
        guess, each step's 2×2 Jacobian by two JVPs."""
        target = torch.stack([(uvz[..., 0] - self.cx) / self.fx,
                              (uvz[..., 1] - self.cy) / self.fy], dim=-1)

        def distort(q):
            return torch.stack(self._distort(q[..., 0], q[..., 1]), dim=-1)

        e0 = torch.zeros_like(target)
        e0[..., 0] = 1.0
        e1 = torch.zeros_like(target)
        e1[..., 1] = 1.0
        xy = target
        for _ in range(iterations):
            out, j0 = torch.func.jvp(distort, (xy,), (e0,))
            j1 = torch.func.jvp(distort, (xy,), (e1,))[1]
            resid = out - target
            det = j0[..., 0] * j1[..., 1] - j1[..., 0] * j0[..., 1]
            inv_det = torch.where(torch.abs(det) > 1e-12, 1.0 / det, 0.0)
            dx = inv_det * (j1[..., 1] * resid[..., 0] - j1[..., 0] * resid[..., 1])
            dy = inv_det * (-j0[..., 1] * resid[..., 0] + j0[..., 0] * resid[..., 1])
            xy = xy - torch.stack([dx, dy], dim=-1)
        z = uvz[..., 2]
        return torch.stack([xy[..., 0] * z, xy[..., 1] * z, z], dim=-1)


@dataclasses.dataclass(frozen=True, eq=False)
class PinholeIntrinsics(_IntrinsicsBase):
    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    image_width: int = 0  # 0 = unknown; resize, crop and `Camera.frame` need the size
    image_height: int = 0

    has_analytic_jacobian = True

    def _distort_jacobian(self, xp, yp):
        one, zero = torch.ones_like(xp), torch.zeros_like(xp)
        return one, zero, zero, one

    @classmethod
    def create(cls, fx, fy, cx, cy, image_size=(0, 0), device="cuda") -> "PinholeIntrinsics":
        device = resolve(device, "PinholeIntrinsics.create")
        return cls(**_tensors(device, fx=fx, fy=fy, cx=cx, cy=cy),
                   image_width=int(image_size[0]), image_height=int(image_size[1]))


@dataclasses.dataclass(frozen=True, eq=False)
class OpenCVIntrinsics(_IntrinsicsBase):
    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    k: torch.Tensor  # (6,) rational radial k1..k6
    # (4,) tangential p1, p2 and thin-prism p3, p4: p3 and p4 ride in the
    # parameter vector but not in the distortion, as in the reference
    # (camera.cpp:687-689)
    p: torch.Tensor
    image_width: int = 0
    image_height: int = 0

    _vector_params = (("k", 6), ("p", 4))
    has_analytic_jacobian = True

    def _distort(self, xp, yp):
        return opencv_distort(xp, yp, self.k, self.p)

    def _distort_jacobian(self, xp, yp):
        return opencv_distort_jacobian(xp, yp, self.k, self.p)

    @classmethod
    def create(cls, fx, fy, cx, cy, k=(0.0,) * 6, p=(0.0, 0.0), image_size=(0, 0),
               device="cuda") -> "OpenCVIntrinsics":
        device = resolve(device, "OpenCVIntrinsics.create")
        p = tuple(p) + (0.0,) * (4 - len(tuple(p)))  # (p1, p2) alone is accepted
        return cls(**_tensors(device, fx=fx, fy=fy, cx=cx, cy=cy, k=k, p=p),
                   image_width=int(image_size[0]), image_height=int(image_size[1]))


@dataclasses.dataclass(frozen=True, eq=False)
class OpenCVFisheyeIntrinsics(_IntrinsicsBase):
    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    k: torch.Tensor  # (4,) θ-polynomial k1..k4
    image_width: int = 0
    image_height: int = 0

    _vector_params = (("k", 4),)

    def _distort(self, xp, yp):
        r = torch.sqrt(xp * xp + yp * yp + 1e-20)
        theta = torch.arctan(r)
        t2 = theta * theta
        k = self.k
        theta_d = theta * (1.0 + t2 * (k[0] + t2 * (k[1] + t2 * (k[2] + t2 * k[3]))))
        scale = torch.where(r > 1e-8, theta_d / r, 1.0)
        return xp * scale, yp * scale

    @classmethod
    def create(cls, fx, fy, cx, cy, k=(0.0,) * 4, image_size=(0, 0),
               device="cuda") -> "OpenCVFisheyeIntrinsics":
        device = resolve(device, "OpenCVFisheyeIntrinsics.create")
        return cls(**_tensors(device, fx=fx, fy=fy, cx=cx, cy=cy, k=k),
                   image_width=int(image_size[0]), image_height=int(image_size[1]))


@dataclasses.dataclass(frozen=True, eq=False)
class Camera:
    """Intrinsics + extrinsics (T_eye_from_world as an (8,) skel_state),
    camera.h:180-310."""

    intrinsics: _IntrinsicsBase
    eye_from_world: torch.Tensor

    @classmethod
    def create(cls, intrinsics, eye_from_world=None) -> "Camera":
        device = intrinsics.fx.device
        if eye_from_world is None:
            eye_from_world = ss.identity(device=device)
        return cls(intrinsics=intrinsics,
                   eye_from_world=torch.as_tensor(eye_from_world, dtype=torch.float32,
                                                  device=device))

    def to(self, device) -> "Camera":
        return Camera(self.intrinsics.to(device), self.eye_from_world.to(device))

    def clone(self) -> "Camera":
        return dataclasses.replace(self)

    def world_to_eye(self, p_world: torch.Tensor) -> torch.Tensor:
        return ss.transform_points(self.eye_from_world, p_world)

    def project(self, p_world: torch.Tensor):
        return self.intrinsics.project(self.world_to_eye(p_world))

    def project_jacobian(self, p_world: torch.Tensor):
        """(uvz, valid, d(u, v)/d p_world (..., 2, 3)): the intrinsics'
        `project_jacobian` at the eye-space point, composed with
        eye_from_world's rotation (times its scale)."""
        uvz, valid, jac = self.intrinsics.project_jacobian(self.world_to_eye(p_world))
        return uvz, valid, jac @ ss.to_matrix(self.eye_from_world)[:3, :3]

    def unproject(self, uvz: torch.Tensor, iterations: int = 10) -> torch.Tensor:
        """World points of pixels (u, v) at eye-space depth z."""
        return ss.transform_points(ss.inverse(self.eye_from_world),
                                   self.intrinsics.unproject(uvz, iterations))

    def get_intrinsic_parameters(self) -> torch.Tensor:
        return self.intrinsics.get_intrinsic_parameters()

    def set_intrinsic_parameters(self, params) -> "Camera":
        return dataclasses.replace(self,
                                   intrinsics=self.intrinsics.set_intrinsic_parameters(params))

    def project_intrinsics_jacobian(self, p_world):
        p_world = torch.as_tensor(p_world, dtype=torch.float32,
                                  device=self.eye_from_world.device)
        return self.intrinsics.project_intrinsics_jacobian(self.world_to_eye(p_world))

    def resize(self, image_width: int, image_height: int) -> "Camera":
        return dataclasses.replace(self, intrinsics=self.intrinsics.resize(image_width,
                                                                           image_height))

    def crop(self, top: int, left: int, new_width: int, new_height: int) -> "Camera":
        return dataclasses.replace(self, intrinsics=self.intrinsics.crop(top, left, new_width,
                                                                         new_height))

    def downsample(self, factor: float) -> "Camera":
        return dataclasses.replace(self, intrinsics=self.intrinsics.downsample(factor))

    def upsample(self, factor: float) -> "Camera":
        return dataclasses.replace(self, intrinsics=self.intrinsics.upsample(factor))

    def look_at(self, position, target=(0.0, 0.0, 0.0), up=(0.0, 1.0, 0.0)) -> "Camera":
        """The camera placed at `position` looking at `target`
        (camera.cpp:1246-1287). Eye-space +Z looks forward and +Y points down
        (pixel (0, 0) top-left), so the world up vector flips in the basis.
        Degenerate inputs return the camera unchanged. Host numpy."""
        device = self.eye_from_world.device
        position = np.asarray(position, np.float64)
        diff = np.asarray(target, np.float64) - position
        n = np.linalg.norm(diff)
        if n == 0.0:
            return self
        z = diff / n
        x = np.cross(diff, -np.asarray(up, np.float64) / max(np.linalg.norm(up), 1e-30))
        if np.linalg.norm(x) == 0.0:
            # up along the look direction: any roll does; align +Z alone
            q = quat.from_two_vectors(torch.tensor([0.0, 0.0, 1.0]),
                                      torch.as_tensor(z, dtype=torch.float32))
            r = quat.to_rotation_matrix(q).numpy()
        else:
            y = np.cross(x, z)
            y /= np.linalg.norm(y)
            x = np.cross(y, z)
            x /= np.linalg.norm(x)
            r = np.stack([x, y, z], axis=1)  # eye → world columns
        if np.linalg.det(r) < 0.9:
            return self
        # eye_from_world = (eye_to_world)⁻¹: R_efw = Rᵀ, t_efw = −Rᵀ·position
        r_efw = r.T
        q_efw = quat.from_rotation_matrix(torch.as_tensor(r_efw, dtype=torch.float32))
        state = torch.cat([torch.as_tensor(-r_efw @ position, dtype=torch.float32), q_efw,
                           torch.ones(1)])
        return dataclasses.replace(self, eye_from_world=state.to(device))

    def frame(self, points, min_z: float = 0.1, edge_padding: float = 0.05) -> "Camera":
        """Translate the camera (orientation kept) so every point projects
        inside the padded image rect (framePoints, camera.cpp:1289-1345):
        recentre laterally on the eye-space bbox, put the near plane at the
        closest point, then dolly until every point meets its field-of-view
        and min-z constraints. Host numpy, as in the JAX package."""
        efw0 = self.eye_from_world
        points = torch.as_tensor(points, dtype=torch.float32,
                                 device=efw0.device).reshape(-1, 3)
        if points.shape[0] == 0:
            return self
        intr = self.intrinsics
        intr._require_size()
        w, h = intr.image_width, intr.image_height
        cx, cy = w / 2.0, h / 2.0  # geometric centre, ignoring the principal point
        fx, fy = float(intr.fx), float(intr.fy)

        p_eye = self.world_to_eye(points).cpu().numpy()
        lo, hi = p_eye.min(axis=0), p_eye.max(axis=0)
        center = 0.5 * (lo + hi)
        shift = np.asarray([-center[0], -center[1], -lo[2]], np.float32)
        efw = ss.multiply(ss.from_translation(torch.as_tensor(shift, device=efw0.device)),
                          efw0)

        p_eye2 = p_eye + shift[None, :]
        max_x = (1.0 - 2.0 * edge_padding) * max(cx, (w - 1) - cx)
        max_y = (1.0 - 2.0 * edge_padding) * max(cy, (h - 1) - cy)
        # the clip-plane constraint counts only for points inside min_z
        # (camera.cpp:1330-1332); the field-of-view ones always, so the dolly
        # may be negative and move the camera closer
        dz_clip = np.where(p_eye2[:, 2] < min_z, min_z - p_eye2[:, 2], -np.inf)
        dz_x = fx * np.abs(p_eye2[:, 0]) / max_x - p_eye2[:, 2]
        dz_y = fy * np.abs(p_eye2[:, 1]) / max_y - p_eye2[:, 2]
        max_dz = float(np.max(np.concatenate([dz_clip, dz_x, dz_y])))
        dolly = torch.as_tensor([0.0, 0.0, max_dz], dtype=torch.float32, device=efw0.device)
        return dataclasses.replace(self, eye_from_world=ss.multiply(ss.from_translation(dolly),
                                                                    efw))

    def projection_matrix(self) -> torch.Tensor:
        """(3, 4) pinhole-equivalent matrix K·[s·R | t] (for
        ProjectionErrorFunction when the distortion is zero)."""
        t, q, s = ss.split(self.eye_from_world)
        intr = self.intrinsics
        zero, one = torch.zeros_like(intr.fx), torch.ones_like(intr.fx)
        kmat = torch.stack([torch.stack([intr.fx, zero, intr.cx]),
                            torch.stack([zero, intr.fy, intr.cy]),
                            torch.stack([zero, zero, one])])
        rt = torch.cat([quat.to_rotation_matrix(q) * s[..., None], t[..., None]], dim=-1)
        return kmat @ rt

"""Markerless multi-view cells: every frame of a take seen by a dome of
calibrated cameras, each giving the 2D keypoints of the rig's locators; each
call one batch of frames solved by the port's compacted LM
(`solver.solve_compacted` over `solver.gauss_newton.solve_levenberg_marquardt`
on `SkeletonSolverFunction(character, one CameraProjectionErrorFunction a
camera)`, its analytic `residual_and_jacobian` as the Jacobian): the batched
stage of `tracking/tracker.py::track_poses_batched` with camera keypoints
and no markers. The modules are built as the tracker builds its keypoint
modules (`_keypoint_templates`): one template a camera over the same
locator tables, the frames' keypoints as targets and their confidences as
weights.

Inputs come from the seed on the device: motion.py's walk, resampled to the
traffic's rate and bent onto a circle about the dome's centre (the root's
x, y on the circle, its heading along it), each camera's projection of the
true locators plus N(0, noise_px) a coordinate as the targets, confidence
0 for a random share of keypoints (occlusion) and for every keypoint
outside the image or behind the near clip, 1 elsewhere; each frame started
from its keyframes' interpolated poses.

The answers judged are the parameters a call returns, each held against
the plain reference's own solve of the same batch (reference/projection.py),
both evaluated by the reference's float32 pixel energy Σ r² per frame:
  energy_median_ratio  the median of the program's energies over the
                       judged calls ÷ the reference's;
  energy_p99_ratio     the same of the 99th percentiles (the refined tail).
The widest per-frame gap is printed beside them and not compared.
"""

from __future__ import annotations

import dataclasses
import math
import time

import torch

from portbench import motion
from portbench.reference import kinematics as kin
from portbench.reference import projection as ref_proj
from portbench.rig import load_rig, port_character, sync


def _ref_options(config: dict) -> dict:
    o = config["solver"]["options"]
    return {k: o[k] for k in ("regularization", "lambda_init", "lambda_up", "lambda_down",
                              "lambda_min", "lambda_max", "threshold", "min_iterations")}


def draw_circle_takes(rr, walk: dict, count: int, frames: int, num_params: int, gen,
                      device) -> torch.Tensor:
    """(count, F, P) true poses: motion.py's walk (its period in frames
    at the traffic's rate), the root's straight path bent onto a circle of
    `circle_radius_m` about the origin, arc length the walk's distance, the
    heading turned along the circle."""
    truth, _ = motion.draw_takes(rr, walk, count, frames, num_params, gen, device)
    t = torch.arange(frames, dtype=truth.dtype, device=device) / walk["period_frames"]
    phi = walk["walk_m"] * t / walk["circle_radius_m"]
    truth[..., 0] = walk["circle_radius_m"] * torch.cos(phi)
    truth[..., 1] = walk["circle_radius_m"] * torch.sin(phi)
    truth[..., 5] = truth[..., 5] + phi + 0.5 * math.pi
    return truth


def draw_keypoints(rr, cams, truth: torch.Tensor, keypoints: dict, gen):
    """(targets (..., K, L, 2), confidence (..., K, L)) of the true poses."""
    uv, z = ref_proj.project(cams, kin.locator_positions(rr, truth))
    width, height = cams.image_size
    seen = ((z > 0) & (z >= cams.near_clip) & (uv[..., 0] >= 0) & (uv[..., 0] < width)
            & (uv[..., 1] >= 0) & (uv[..., 1] < height))
    occluded = torch.rand(z.shape, generator=gen, device=z.device) < keypoints["occluded_share"]
    noise = keypoints["noise_px"] * torch.randn(uv.shape, generator=gen, device=uv.device)
    confidence = (seen & ~occluded).to(uv.dtype)
    targets = torch.where(seen[..., None], uv + noise, 0.0)
    return targets, confidence


class MultiviewCell:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic, self.device = config, traffic, device
        self.spans = False
        rig = load_rig(config["rig"])
        self.rr = kin.reference_rig(rig, device)
        self.camera_doc = ref_proj.load_cameras(config["cameras"])
        self.cams = ref_proj.reference_cameras(self.camera_doc, config["near_clip"], device)
        batch, p = traffic["batch"], rig.num_parameters
        sched = config["solver"]["schedule"]
        self.k_full, self.r_refine = sched["k_full"], sched["r_refine"]
        self.capacity = batch // sched["refine_divisor"]
        self.frames_per_call = batch
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        truth = draw_circle_takes(self.rr, traffic["motion"], traffic["pool"], batch, p, gen,
                                  device)
        targets, confidence = draw_keypoints(self.rr, self.cams, truth, traffic["keypoints"],
                                             gen)
        starts = motion.keyframe_starts(truth, traffic["keyframe_stride"])
        self.pool = list(zip(targets.unbind(0), confidence.unbind(0), starts.unbind(0)))
        cameras, points = len(self.camera_doc["cameras"]), rig.locator_parents.size
        self.work = {"stages": [], "refine_s": [], "rows": 2 * cameras * points, "n": p,
                     "cameras": cameras, "points": points, "joints": rig.parents.size}
        self._build_program(rig)

    def _port_cameras(self):
        """The port's Camera of each camera of the file: its OpenCV
        intrinsics and eye_from_world from the frozen rotation and
        translation."""
        from momentum_tpu_torch.camera import Camera, OpenCVIntrinsics
        from momentum_tpu_torch.math import quaternion as quat

        out = []
        for c in self.camera_doc["cameras"]:
            intr = OpenCVIntrinsics.create(c["fx"], c["fy"], c["cx"], c["cy"], k=c["k"],
                                           p=c["p"], image_size=self.camera_doc["image_size"],
                                           device=self.device)
            q = quat.from_rotation_matrix(torch.as_tensor(c["rotation"], dtype=torch.float32))
            eye = torch.cat([torch.as_tensor(c["translation_m"], dtype=torch.float32), q,
                             torch.ones(1)])
            out.append(Camera.create(intr, eye.to(self.device)))
        return out

    def _build_program(self, rig):
        from momentum_tpu_torch.errors import CameraProjectionErrorFunction
        from momentum_tpu_torch.ops import jacobian as jac_ops, psd
        from momentum_tpu_torch.solver import (
            SkeletonSolverFunction, SolverOptions, solve_compacted)
        from momentum_tpu_torch.solver.gauss_newton import solve_levenberg_marquardt

        self._psd, self._jac = psd, jac_ops
        char = port_character(rig, self.device)
        loc = char.locators
        n = loc.num_locators
        cams = self._port_cameras()
        # one template a camera over the same locator tables, as the tracker's
        first = CameraProjectionErrorFunction.create(
            cams[0], loc.parent.cpu().numpy(), loc.offset.cpu().numpy(),
            torch.zeros(n, 2).numpy(), cweight=torch.zeros(n).numpy(),
            weight=self.config["modules"][0]["weight"], near_clip=self.config["near_clip"],
            device=self.device)
        templates = [dataclasses.replace(first, camera=c) for c in cams]
        opts = SolverOptions(**self.config["solver"]["options"])
        batch = self.traffic["batch"]

        def stage(inputs, x0, iters, lam0):
            targets, confidence = inputs
            refine = x0.shape[0] < batch
            if refine and self.spans:
                sync(self.device)
                t0 = time.perf_counter()
            modules = tuple(dataclasses.replace(t, target=targets[:, k], cweight=confidence[:, k])
                            for k, t in enumerate(templates))
            fn = SkeletonSolverFunction(char, modules)
            res = solve_levenberg_marquardt(
                fn.residual, fn.error, x0,
                options=dataclasses.replace(opts, max_iterations=iters),
                jacobian_fn=fn.residual_and_jacobian, lambda0=lam0)
            if refine and self.spans:
                sync(self.device)
                self.work["refine_s"].append(time.perf_counter() - t0)
            self.work["stages"].append((x0.shape[0], res.iterations))
            return res

        def solve(targets, confidence, x0):
            return solve_compacted(stage, (targets, confidence), x0, capacity=self.capacity,
                                   k_full=self.k_full, r_refine=self.r_refine).params

        self._solve = solve

    def warm(self):
        """One call warms every shape: the pool's takes share them. Its
        answers are those of the window's first call, on the same take, so
        a warm-up answer that is not finite ends the run here: that call
        would fail in the window, and the run could not be correct."""
        out = self.call(0)
        sync(self.device)
        if not bool(torch.isfinite(out).all()):
            raise RuntimeError("the warm-up call's answers are not all finite: the window's "
                               "calls on the same take would fail")
        self.reset_work()

    def reset_work(self):
        self.work["stages"].clear()
        self.work["refine_s"].clear()

    def call(self, i: int) -> torch.Tensor:
        return self._solve(*self.pool[i % len(self.pool)])

    def counters(self) -> dict:
        """K2+K3's launches and, where the program counts them, the
        projection form's (a program without the counter reports none)."""
        out = {"k2k3_launches": self._psd.launches}
        launches = getattr(self._jac, "projection_launches", None)
        if launches is not None:
            out["projection_launches"] = launches
        return out

    def release(self):
        self._solve = None

    def reference_call(self, i: int) -> torch.Tensor:
        """The reference's answer for call i: the plain LM put in the
        program's place (calibrate.py runs it in a lower precision)."""
        targets, confidence, x0 = self.pool[i % len(self.pool)]
        return ref_proj.solve_compacted(self.rr, self.cams, targets, confidence, x0,
                                        _ref_options(self.config), self.k_full, self.r_refine,
                                        self.capacity)[0]

    def judge(self, kept: list) -> dict:
        """The numbers compared, over the kept calls' answers."""
        e_prog, e_ref, answers = [], [], {}
        for i, params in kept:
            slot = i % len(self.pool)
            if slot not in answers:
                answers[slot] = self.reference_call(slot)
            targets, confidence, _ = self.pool[slot]
            e_prog.append(ref_proj.energies(self.rr, self.cams, params, targets, confidence))
            e_ref.append(ref_proj.energies(self.rr, self.cams, answers[slot], targets,
                                           confidence))
        e_prog, e_ref = torch.cat(e_prog).double(), torch.cat(e_ref).double()
        e_prog = torch.nan_to_num(e_prog, nan=float("inf"))
        out = {}
        for name, q in (("median", 0.5), ("p99", 0.99)):
            qp, qr = float(torch.quantile(e_prog, q)), float(torch.quantile(e_ref, q))
            out[f"energy_{name}_ratio"] = qp / qr
            out[f"energy_{name}_program"], out[f"energy_{name}_reference"] = qp, qr
        out["energy_gap_max"] = float(torch.max(e_prog - e_ref))
        return out


def build(config, traffic, seed, device):
    return MultiviewCell(config, traffic, seed, device)

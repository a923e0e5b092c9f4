"""Batched IK cells: a pool of batches of frames, each call one batch
solved by the port's compacted LM (`solver.solve_compacted` over
`solver.gauss_newton.solve_levenberg_marquardt` on
`SkeletonSolverFunction(character, (position,))`, its analytic
`residual_and_jacobian` as the Jacobian).

Inputs come from the seed on the device (motion.py): each batch is every
frame of one take, its noisy markers the targets, each frame started from
its keyframes' interpolated poses (every `keyframe_stride`-th frame), as the
batched stage of keyframe-seeded tracking starts them.

The answers judged are the parameters a call returns. Each is held against
the plain reference's own solve of the same batch (reference/ik.py), both
evaluated by the reference's float32 energy Σ r² per element:
  energy_median_ratio  the median of the program's energies over the
                       judged calls ÷ the reference's: every layer's error
                       shows in the typical element;
  energy_p99_ratio     the same of the 99th percentiles: the elements the
                       compacted tail refines.
The widest per-element gap is printed beside them and not compared: an
element near a fork of LM's accept/reject path can land in another
minimum in either implementation.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from portbench import motion
from portbench.reference import ik as ref_ik
from portbench.reference import kinematics as kin
from portbench.rig import load_rig, port_character, sync


def _ref_options(config: dict) -> dict:
    o = config["solver"]["options"]
    return {k: o[k] for k in ("regularization", "lambda_init", "lambda_up", "lambda_down",
                              "lambda_min", "lambda_max", "threshold", "min_iterations")}


class IkCell:
    # host spans the driver records while `spans` is set: the compacted stage's wall
    span_names = ("refine_s",)

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic, self.device = config, traffic, device
        self.spans = False
        rig = load_rig(config["rig"])
        self.rr = kin.reference_rig(rig, device)
        batch, p = traffic["batch"], rig.num_parameters
        sched = config["solver"]["schedule"]
        self.k_full, self.r_refine = sched["k_full"], sched["r_refine"]
        self.capacity = batch // sched["refine_divisor"]
        self.frames_per_call = batch
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        truth, markers = motion.draw_takes(self.rr, traffic["motion"], traffic["pool"], batch, p,
                                           gen, device)
        starts = motion.keyframe_starts(truth, traffic["keyframe_stride"])
        self.pool = list(zip(markers.unbind(0), starts.unbind(0)))
        self.work = {"stages": [], "refine_s": [], "rows": 3 * rig.locator_parents.size,
                     "n": p}
        self._build_program(rig)

    def _build_program(self, rig):
        from momentum_tpu_torch.errors import PositionErrorFunction
        from momentum_tpu_torch.ops import psd
        from momentum_tpu_torch.solver import (
            SkeletonSolverFunction, SolverOptions, solve_compacted)
        from momentum_tpu_torch.solver.gauss_newton import solve_levenberg_marquardt

        self._psd = psd
        char = port_character(rig, self.device)
        ef0 = PositionErrorFunction.create(rig.locator_parents, rig.locator_offsets,
                                           0.0 * rig.locator_offsets, device=self.device)
        opts = SolverOptions(**self.config["solver"]["options"])
        batch = self.traffic["batch"]

        def stage(targets, x0, iters, lam0):
            refine = x0.shape[0] < batch
            if refine and self.spans:
                sync(self.device)
                t0 = time.perf_counter()
            fn = SkeletonSolverFunction(char, (dataclasses.replace(ef0, target=targets),))
            res = solve_levenberg_marquardt(
                fn.residual, fn.error, x0,
                options=dataclasses.replace(opts, max_iterations=iters),
                jacobian_fn=fn.residual_and_jacobian, lambda0=lam0)
            if refine and self.spans:
                sync(self.device)
                self.work["refine_s"].append(time.perf_counter() - t0)
            self.work["stages"].append((x0.shape[0], res.iterations))
            return res

        def solve(targets, x0):
            return solve_compacted(stage, targets, x0, capacity=self.capacity,
                                   k_full=self.k_full, r_refine=self.r_refine).params

        self._solve = solve

    def warm(self):
        for i in range(2):
            self.call(i)
        sync(self.device)
        self.reset_work()

    def reset_work(self):
        self.work["stages"].clear()
        self.work["refine_s"].clear()

    def call(self, i: int) -> torch.Tensor:
        return self._solve(*self.pool[i % len(self.pool)])

    def counters(self) -> dict:
        return {"k2k3_launches": self._psd.launches}

    def release(self):
        self._solve = None

    def reference_call(self, i: int) -> torch.Tensor:
        """The reference's answer for call i: the plain LM put in the
        program's place (calibrate.py runs it in a lower precision)."""
        targets, x0 = self.pool[i % len(self.pool)]
        return ref_ik.solve_compacted(self.rr, targets, x0, _ref_options(self.config),
                                      self.k_full, self.r_refine, self.capacity)[0]

    def judge(self, kept: list) -> dict:
        """The numbers compared, over the kept calls' answers."""
        e_prog, e_ref, answers = [], [], {}
        for i, params in kept:
            slot = i % len(self.pool)
            if slot not in answers:
                answers[slot] = self.reference_call(slot)
            targets = self.pool[slot][0]
            e_prog.append(ref_ik.energies(self.rr, params, targets))
            e_ref.append(ref_ik.energies(self.rr, answers[slot], targets))
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
    return IkCell(config, traffic, seed, device)

"""Whole-take cells: a pool of takes, each call one take solved by the
port's `sequence.solve_sequence` on `SequenceSolverFunction.create(...)`:
one stacked PositionErrorFunction over every frame's locators, a
ModelParametersSequenceErrorFunction, the rig's named parameter set
shared by all frames, Gauss-Newton from the tracker's seed.

Inputs come from the seed on the device (motion.py): each take is
continuous motion, its noisy markers the targets, and every frame starts
with every parameter zero but the root's translation, at its markers'
centroid.

The answers judged are the per-frame and universal parameters a call
returns, held against the plain reference's own solve of the same take
(reference/sequence.py):
  angle_gap_max        the widest gap between the program's parameters and
                       the reference's over every frame's angles and the
                       universal scale (the root's translation, in m, is
                       printed apart as translation_gap_max);
  frame_energy_gap_max the widest gap by which a frame's position energy
                       (the reference's float32 evaluation, m²) lies above
                       the reference's answer's.
The relative gap of the whole objective is printed beside them and not
compared.
"""

from __future__ import annotations

import torch

from portbench import motion
from portbench.reference import kinematics as kin
from portbench.reference import sequence as ref_seq
from portbench.rig import load_rig, port_character, sync, universal_mask

# the motion term's constant factor (momentum's kMotionWeight,
# model_parameters_sequence_error_function.h): its rows are
# √(weight·K_MOTION)·(θ_{f+1} − θ_f)
K_MOTION = 0.1


class SequenceCell:
    span_names = ()

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic, self.device = config, traffic, device
        rig = load_rig(config["rig"])
        self.rr = kin.reference_rig(rig, device)
        frames, p = traffic["frames"], rig.num_parameters
        self.frames_per_call = frames
        self.universal = universal_mask(rig, config["universal_set"])
        self.smooth_weight = config["smoothness_weight"]
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        _, markers = motion.draw_takes(self.rr, traffic["motion"], traffic["pool"], frames, p,
                                       gen, device)
        self.pool = list(markers.unbind(0))
        self.takes = [ref_seq.Take(self.rr, t, torch.as_tensor(self.universal, device=device),
                                   (self.smooth_weight * K_MOTION) ** 0.5) for t in self.pool]
        starts = motion.centroid_starts(markers, p)[..., torch.as_tensor(~self.universal)]
        self.starts = list(starts.unbind(0))
        self.u0 = torch.zeros(int(self.universal.sum()), device=device)
        self.translation = torch.as_tensor(
            [n.endswith(("_tx", "_ty", "_tz")) for n, u in zip(rig.parameter_names, self.universal)
             if not u], device=device)
        self.work = {"iterations": 0, "iterations_each": []}
        self._build_program(rig)

    def _build_program(self, rig):
        import dataclasses

        from momentum_tpu_torch.errors import PositionErrorFunction
        from momentum_tpu_torch.ops import psd
        from momentum_tpu_torch.sequence import (
            ModelParametersSequenceErrorFunction, SequenceSolverFunction, solve_sequence)
        from momentum_tpu_torch.solver import SolverOptions

        self._psd = psd
        char = port_character(rig, self.device)
        ef0 = PositionErrorFunction.create(rig.locator_parents, rig.locator_offsets,
                                           0.0 * rig.locator_offsets, device=self.device)
        fns = [SequenceSolverFunction.create(
            char, self.traffic["frames"], universal=self.universal,
            per_frame_errors=(dataclasses.replace(ef0, target=targets),),
            sequence_errors=(ModelParametersSequenceErrorFunction.create(
                rig.num_parameters, weight=self.smooth_weight, device=self.device),))
            for targets in self.pool]
        opts = SolverOptions(**self.config["solver"]["options"])

        def solve(i):
            k = i % len(fns)
            res = solve_sequence(fns[k], self.starts[k], self.u0, opts)
            self.work["iterations"] += res.iterations
            self.work["iterations_each"].append(res.iterations)
            return res.per_frame, res.universal

        self._solve = solve

    def warm(self):
        self.call(0)
        sync(self.device)
        self.reset_work()

    def reset_work(self):
        self.work["iterations"] = 0
        self.work["iterations_each"].clear()

    def call(self, i: int):
        return self._solve(i)

    def counters(self) -> dict:
        return {"k2k3_launches": self._psd.launches}

    def release(self):
        self._solve = None

    def reference_call(self, i: int):
        """The reference's answer for call i: the plain GN put in the
        program's place (calibrate.py runs it in a lower precision)."""
        opts = {**self.config["solver"]["options"], **self.config["solver"]["equilibration"]}
        k = i % len(self.takes)
        pf, u, _, _ = ref_seq.gauss_newton(self.takes[k], self.starts[k], self.u0, opts)
        return pf, u

    def judge(self, kept: list) -> dict:
        """The numbers compared, over the kept calls' answers."""
        out = {"angle_gap_max": 0.0, "translation_gap_max": 0.0,
               "frame_energy_gap_max": -float("inf"), "objective_gap": 0.0}
        answers = {}
        for i, (pf, u) in kept:
            slot = i % len(self.takes)
            if slot not in answers:
                answers[slot] = self.reference_call(slot)
            pf_r, u_r = answers[slot]
            take = self.takes[slot]
            gap = torch.nan_to_num((pf - pf_r).abs(), nan=float("inf"))
            angles = torch.cat([gap[:, ~self.translation].flatten(),
                                torch.nan_to_num((u - u_r).abs(), nan=float("inf"))])
            out["angle_gap_max"] = max(out["angle_gap_max"], float(angles.max()))
            out["translation_gap_max"] = max(out["translation_gap_max"],
                                             float(gap[:, self.translation].max()))
            e_gap = (torch.nan_to_num(take.frame_energies(pf, u).double(), nan=float("inf"))
                     - take.frame_energies(pf_r, u_r).double())
            out["frame_energy_gap_max"] = max(out["frame_energy_gap_max"], float(e_gap.max()))
            e_p, e_r = float(take.energy(pf, u)), float(take.energy(pf_r, u_r))
            out["objective_gap"] = max(out["objective_gap"], abs(e_p - e_r) / e_r)
        return out


def build(config, traffic, seed, device):
    return SequenceCell(config, traffic, seed, device)

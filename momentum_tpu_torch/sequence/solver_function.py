"""SequenceSolverFunction: the multi-frame objective with its per-frame and
universal parameters, after momentum_tpu/sequence/solver_function.py (the
reference's sequence_solver_function.h:31-131).

The parameters split into per-frame indices and universal indices, shared
by all frames (scale, shape). Per-frame error functions are "stacked": one
module per type whose tensors have a leading F where they differ between
frames, so one batched FK over (F, P) evaluates every frame (the
reference's frame-parallel FK, sequence_solver_function.cpp:171-198).
Sequence error functions evaluate on sliding windows of the frames'
contexts.

Unknowns: pf (F, n_pf) per-frame values and u (n_u,) universal values;
`join` places them into the (F, P) model parameters of every frame (the
joined-vector layout of sequence_solver_function.h:55-60).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from momentum_tpu_torch.character.character import Character
from momentum_tpu_torch.errors.base import EvalContext
from momentum_tpu_torch.solver.skeleton_solver_function import SkeletonSolverFunction
from momentum_tpu_torch.utils.profiling import host_sync

__all__ = ["SequenceSolverFunction", "stack_frames", "broadcast_frames"]


def stack_frames(efs):
    """One module for a list of per-frame modules of one type (the
    reference's addErrorFunction(frame, ef) for every frame).

    A tensor that differs between the frames is stacked with a leading F;
    one that every frame shares stays as it is and broadcasts against the
    frames. The port's modules batch their per-constraint tables (targets,
    constraint weights), not their index tables or scalar weights: those
    must agree across the frames, or this raises ValueError."""
    first = efs[0]
    fields = {}
    for field in dataclasses.fields(first):
        vals = [getattr(ef, field.name) for ef in efs]
        if not isinstance(vals[0], torch.Tensor):
            fields[field.name] = vals[0]
            continue
        if all(torch.equal(v, vals[0]) for v in vals[1:]):
            fields[field.name] = vals[0]
            continue
        if vals[0].ndim == 0 or not vals[0].is_floating_point():
            raise ValueError(f"{type(first).__name__}.{field.name} differs between frames; "
                             "the port's modules take per-frame values only in their "
                             "per-constraint float tables")
        fields[field.name] = torch.stack(vals)
    return dataclasses.replace(first, **fields)


def broadcast_frames(ef, num_frames: int):
    """One module applied to every frame (the reference's kAllFrames,
    sequence_solver_function.h:84-86): its tensors broadcast against the
    frames as they are."""
    return ef


@dataclasses.dataclass(frozen=True, eq=False)
class SequenceSolverFunction:
    character: Character
    per_frame_errors: tuple  # stacked per-frame error functions
    sequence_errors: tuple  # sequence error functions (window W each)
    num_frames: int
    universal_index: tuple
    per_frame_index: tuple

    # ---- parameter packing ----

    @property
    def num_per_frame(self) -> int:
        return len(self.per_frame_index)

    @property
    def num_universal(self) -> int:
        return len(self.universal_index)

    def _index(self, name: str, device) -> torch.Tensor:
        # a copy from the host, which waits for the card's queue to drain
        return host_sync("sequence.index", torch.as_tensor, getattr(self, name),
                         dtype=torch.int64, device=device)

    def join(self, pf: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        """(..., n_pf), (n_u,) → (..., P) full model parameters. A gather
        of [pf | u], so forward-mode AD and vmap pass through it."""
        order = np.argsort(np.asarray(self.per_frame_index + self.universal_index, np.int64))
        both = torch.cat([pf, u.expand(pf.shape[:-1] + u.shape[-1:])], dim=-1)
        return both.index_select(
            -1, host_sync("sequence.index", torch.as_tensor, order, device=pf.device))

    def split(self, thetas: torch.Tensor):
        """(F, P) → (pf (F, n_pf), u (n_u,) from frame 0)."""
        pf = thetas.index_select(-1, self._index("per_frame_index", thetas.device))
        u = thetas[..., 0, :].index_select(-1, self._index("universal_index", thetas.device))
        return pf, u

    # ---- evaluation ----

    def _context(self, theta: torch.Tensor, states: bool = True) -> EvalContext:
        """The context of the frames `theta` (..., P). The sequence modules
        count for its needs_mesh too. states=False (no module to be
        evaluated reads the skeleton states) gives the model parameters
        alone, without FK."""
        if not states:
            return EvalContext(model_params=theta, joint_params=None, skel_states=None)
        efs = self.per_frame_errors + self.sequence_errors
        return SkeletonSolverFunction(self.character, efs).context(theta)

    def frame_contexts(self, thetas: torch.Tensor) -> EvalContext:
        """(F, P) → EvalContext with a leading F: one batched FK."""
        return self._context(thetas)

    def frame_residual(self, thetas: torch.Tensor, ef_frame) -> torch.Tensor:
        """Residual rows of frames `thetas` (..., P) under the (stacked or
        single-frame) modules `ef_frame`."""
        ctx = self._context(thetas)
        rows = [ef.residual(self.character, ctx) for ef in ef_frame]
        if not rows:
            return thetas.new_zeros(thetas.shape[:-1] + (0,))
        return torch.cat(rows, dim=-1)

    def frame_error(self, thetas: torch.Tensor, ef_frame) -> torch.Tensor:
        """Per-frame energies (...,) of frames `thetas` (..., P)."""
        ctx = self._context(thetas)
        total = thetas.new_zeros(thetas.shape[:-1])
        for ef in ef_frame:
            total = total + ef.error(self.character, ctx)
        return total

    def _window_contexts(self, ctxs: EvalContext, window: int) -> EvalContext:
        """Sliding windows: leading axis F → (F-W+1, W). The rest mesh of a
        rig without blend shapes (V, 3) has no frame axis and is shared by
        every window (ROADMAP F24)."""
        f = self.num_frames
        idx = (torch.arange(f - window + 1)[:, None] + torch.arange(window)[None, :])
        idx = host_sync("sequence.index", idx.to, ctxs.model_params.device)

        def windows(name, t):
            if t is None or (name == "rest_vertices" and t.ndim == 2):
                return t
            return t[idx]

        return EvalContext(**{fld.name: windows(fld.name, getattr(ctxs, fld.name))
                              for fld in dataclasses.fields(ctxs)})

    def error(self, pf: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        ctxs = self.frame_contexts(self.join(pf, u))
        total = pf.new_zeros(())
        for ef in self.per_frame_errors:
            total = total + torch.sum(ef.error(self.character, ctxs))
        for sef in self.sequence_errors:
            ctx_w = self._window_contexts(ctxs, sef.window)
            total = total + torch.sum(sef.error(self.character, ctx_w))
        return total

    def gradient(self, pf: torch.Tensor, u: torch.Tensor):
        """(d error/d pf, d error/d u) by reverse mode."""
        with torch.enable_grad():
            pf = pf.detach().requires_grad_()
            u = u.detach().requires_grad_()
            return torch.autograd.grad(self.error(pf, u), (pf, u), allow_unused=True,
                                       materialize_grads=True)

    # ---- construction ----

    @classmethod
    def create(cls, character: Character, num_frames: int,
               universal: Optional[np.ndarray] = None,  # bool/0-1 mask over model params
               per_frame_errors=(), sequence_errors=()):
        p = character.num_model_parameters
        universal = np.zeros(p, bool) if universal is None else np.asarray(universal).astype(bool)
        return cls(character=character, per_frame_errors=tuple(per_frame_errors),
                   sequence_errors=tuple(sequence_errors), num_frames=num_frames,
                   universal_index=tuple(int(i) for i in np.nonzero(universal)[0]),
                   per_frame_index=tuple(int(i) for i in np.nonzero(~universal)[0]))

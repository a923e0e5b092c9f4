"""Skeleton: per-joint arrays in topological order (skeleton.h:138-193).

    joint_parent        (nJ,)   int32, -1 for roots; on the device, where the
                                FK kernel reads it
    pre_rotation        (nJ, 4) quaternion (x, y, z, w)
    translation_offset  (nJ, 3)

Each joint has 7 parameters (tx, ty, tz, rx, ry, rz, log2-scale). The
hierarchy queries (`ancestor_matrix`, `prefix_levels`) are host numpy, as in
momentum_tpu/character/skeleton.py; their device copies (`ancestor_mask`,
`prefix_table`) are cached on the skeleton.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Sequence

import numpy as np
import torch

from momentum_tpu_torch.device import resolve

__all__ = ["PARAMS_PER_JOINT", "INVALID_INDEX", "Skeleton", "make_skeleton"]

PARAMS_PER_JOINT = 7
INVALID_INDEX = -1


@dataclasses.dataclass(frozen=True, eq=False)
class Skeleton:
    joint_parent: torch.Tensor
    pre_rotation: torch.Tensor
    translation_offset: torch.Tensor
    joint_names: tuple = ()

    def __post_init__(self):
        parents = self.parents_np
        bad = [j for j, p in enumerate(parents) if p != INVALID_INDEX and not 0 <= p < j]
        if bad:
            raise ValueError(f"skeleton not topologically sorted at joints {bad}")

    @property
    def num_joints(self) -> int:
        return self.pre_rotation.shape[0]

    @property
    def num_joint_parameters(self) -> int:
        return self.num_joints * PARAMS_PER_JOINT

    @functools.cached_property
    def parents_np(self) -> np.ndarray:
        """(nJ,) int32 host copy of joint_parent."""
        return self.joint_parent.cpu().numpy().astype(np.int32)

    def joint_index(self, name: str) -> int:
        return self.joint_names.index(name)

    # ---- pymomentum.geometry.Skeleton's spellings (skeleton_pybind.cpp:109-260),
    # host numpy ----

    @property
    def size(self) -> int:
        return self.num_joints

    def __len__(self) -> int:
        return self.num_joints

    @property
    def joint_parents(self) -> np.ndarray:
        """(nJ,) parent indices, -1 for roots."""
        return self.parents_np.copy()

    @property
    def pre_rotations(self) -> np.ndarray:
        """(nJ, 4) pre-rotation quaternions (x, y, z, w)."""
        return self.pre_rotation.detach().cpu().numpy()

    @property
    def offsets(self) -> np.ndarray:
        """(nJ, 3) translation offsets."""
        return self.translation_offset.detach().cpu().numpy()

    def get_parent(self, joint_index: int) -> int:
        """A joint's parent, -1 for a root."""
        return int(self.parents_np[joint_index])

    def get_child_joints(self, root_joint_index: int, recursive: bool = True) -> list:
        """The joints under `root_joint_index` (itself excluded); with
        recursive=False its direct children only."""
        parents = self.parents_np
        if not recursive:
            return [int(j) for j in np.nonzero(parents == root_joint_index)[0]]
        out = np.zeros(len(parents), bool)
        out[root_joint_index] = True
        for j in range(len(parents)):  # parents come before their children
            if parents[j] != INVALID_INDEX and out[parents[j]]:
                out[j] = True
        out[root_joint_index] = False
        return [int(j) for j in np.nonzero(out)[0]]

    @property
    def upper_body_joints(self) -> list:
        """'b_spine0' and the joints under it (skeleton_pybind.cpp:201-206)."""
        if "b_spine0" not in self.joint_names:
            raise ValueError("skeleton has no 'b_spine0' joint")
        root = self.joint_names.index("b_spine0")
        return [root] + self.get_child_joints(root, recursive=True)

    def is_ancestor(self, joint_index: int, ancestor_joint_index: int) -> bool:
        """Whether `ancestor_joint_index` is `joint_index` or one of its
        ancestors (skeleton.h isAncestor, inclusive)."""
        parents = self.parents_np
        a = joint_index
        while a != INVALID_INDEX:
            if a == ancestor_joint_index:
                return True
            a = int(parents[a])
        return False

    def common_ancestor(self, a: int, b: int) -> int:
        """The nearest joint that is an ancestor-or-self of both, -1 if none."""
        parents = self.parents_np
        chain = set()
        x = a
        while x != INVALID_INDEX:
            chain.add(x)
            x = int(parents[x])
        x = b
        while x != INVALID_INDEX:
            if x in chain:
                return x
            x = int(parents[x])
        return INVALID_INDEX

    def validate(self) -> None:
        """Raise unless every joint's parent comes before it."""
        for j, p in enumerate(self.parents_np):
            if p != INVALID_INDEX and p >= j:
                raise ValueError(f"skeleton not topologically sorted: joint {j} has parent {p}")

    def ancestor_matrix(self) -> np.ndarray:
        """Boolean (nJ, nJ): out[a, j] iff a is j's ancestor-or-self."""
        parents = self.parents_np
        n = len(parents)
        out = np.zeros((n, n), dtype=bool)
        for j in range(n):
            a = j
            while a != INVALID_INDEX:
                out[a, j] = True
                a = parents[a]
        return out

    def prefix_levels(self) -> list[np.ndarray]:
        """Pointer-doubling parent schedule for binary-lifting FK over a
        virtual identity node nJ (roots point at it, it points at itself):
        g_{k+1}[j] = g_k[p_k[j]] ∘ g_k[j];  p_{k+1} = p_k[p_k]. Arrays have
        length nJ + 1."""
        parents = self.parents_np
        n = len(parents)
        p = np.empty(n + 1, dtype=np.int32)
        p[:n] = np.where(parents == INVALID_INDEX, n, parents)
        p[n] = n
        levels = []
        while not np.all(p == n):
            levels.append(p.copy())
            p = p[p]
        return levels

    @functools.cached_property
    def prefix_table(self) -> torch.Tensor:
        """`prefix_levels` as one int32 (L, nJ + 1) table on the skeleton's
        device, row k = p_k: the table kernel K1 reads, and the rows
        `fk_global_plain` gathers with."""
        levels = self.prefix_levels()
        table = (np.stack(levels) if levels
                 else np.zeros((0, self.num_joints + 1), dtype=np.int32))
        return torch.as_tensor(table, dtype=torch.int32, device=self.joint_parent.device)

    @functools.cached_property
    def parent_index(self) -> torch.Tensor:
        """(nJ,) int64 parent indices with roots pointing at the virtual
        identity node nJ, on the skeleton's device."""
        parents = self.parents_np
        idx = np.where(parents == INVALID_INDEX, self.num_joints, parents)
        return torch.as_tensor(idx, dtype=torch.int64, device=self.joint_parent.device)

    @functools.cached_property
    def ancestor_mask(self) -> torch.Tensor:
        """`ancestor_matrix` as a float 0/1 tensor on the skeleton's device."""
        return torch.as_tensor(self.ancestor_matrix(), dtype=self.pre_rotation.dtype,
                               device=self.pre_rotation.device)


def make_skeleton(parents: Sequence[int], pre_rotations=None,
                  translation_offsets=None, names: Sequence[str] | None = None,
                  dtype=torch.float32, device="cuda") -> Skeleton:
    device = resolve(device, "make_skeleton")
    n = len(parents)
    if pre_rotations is None:
        pre_rotations = np.tile([0.0, 0.0, 0.0, 1.0], (n, 1))
    if translation_offsets is None:
        translation_offsets = np.zeros((n, 3))
    if names is None:
        names = tuple(f"joint{i}" for i in range(n))
    return Skeleton(
        joint_parent=torch.as_tensor(np.asarray(parents, np.int32), device=device),
        pre_rotation=torch.as_tensor(np.asarray(pre_rotations), dtype=dtype, device=device),
        translation_offset=torch.as_tensor(np.asarray(translation_offsets), dtype=dtype,
                                           device=device),
        joint_names=tuple(names),
    )

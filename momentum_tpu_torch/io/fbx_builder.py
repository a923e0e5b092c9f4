"""FbxBuilder: fluent multi-entity FBX scene writer (pymomentum.geometry
FbxBuilder, fbx_builder_pybind.cpp:30-200 / momentum/io/fbx fbx_builder —
which the reference gates behind the Autodesk SDK; this build writes the
binary container itself via io/fbx_writer.py).

Everything is lowered onto the character scene builder: a rigid body is a
character whose mesh is 100%-skinned to one joint (identical deformation
semantics), an animated mesh is a single-joint character whose root carries
the animation, and a marker sequence becomes one animated null joint per
marker. Entries share one uid counter so the merged document stays
consistent. The entries' characters take tensors on any device;
`to_bytes` and `save` write momentum_tpu/io/fbx_builder.py's bytes for the
same content.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from momentum_tpu_torch.device import resolve, to_host

__all__ = ["FbxBuilder"]


class FbxBuilder:
    def __init__(self):
        self._entries = []  # dicts: character, name, joint_params, fps

    # ---- entries ----------------------------------------------------------

    def add_character(self, character, name: str = "", options=None) -> "FbxBuilder":
        """Add a skinned character (fbx_builder_pybind add_character)."""
        self._entries.append(dict(
            character=character, name=name or character.name or f"character{len(self._entries)}",
            joint_params=None, fps=120.0))
        return self

    def add_motion(self, motion, fps: float = 120.0, character_name: str = "") -> "FbxBuilder":
        """Attach model-parameter motion (F, P) to a character (by name, else
        the most recent one), mapped through its parameter transform on the
        character's device."""
        e = self._find(character_name)
        pt = e["character"].parameter_transform
        e["joint_params"] = pt.apply(torch.as_tensor(motion, dtype=torch.float32).to(
            pt.transform.device))
        e["fps"] = float(fps)
        return self

    def add_motion_with_joint_params(self, joint_params, fps: float = 120.0,
                                     character_name: str = "") -> "FbxBuilder":
        """Attach per-frame joint parameters (F, nJ·7) directly."""
        e = self._find(character_name)
        e["joint_params"] = to_host(joint_params).astype(np.float32)
        e["fps"] = float(fps)
        return self

    def add_rigid_body(self, character, name: str = "", parent_joint: int = 0,
                       options=None) -> "FbxBuilder":
        """Mesh moving rigidly with one joint — no per-vertex weights
        (fbx_builder_pybind add_rigid_body). Lowered to a 100%-to-one-joint
        skinning, which deforms identically; on the character's device."""
        from momentum_tpu_torch.character.skinning import SkinWeights

        if character.mesh is None:
            raise ValueError("rigid body needs a mesh")
        nv = character.mesh.num_vertices
        device = character.mesh.vertices.device
        idx = torch.zeros((nv, 8), dtype=torch.int32, device=device)
        idx[:, 0] = int(parent_joint)
        w = torch.zeros((nv, 8), dtype=torch.float32, device=device)
        w[:, 0] = 1.0
        rigid = dataclasses.replace(
            character, skin_weights=SkinWeights(index=idx, weight=w)).with_inverse_bind_pose()
        return self.add_character(rigid, name=name)

    def add_animated_mesh(self, mesh_or_character, name: str = "", fps: float = 120.0,
                          joint_params=None, translation_offset=(0.0, 0.0, 0.0),
                          device="cuda") -> "FbxBuilder":
        """Standalone mesh whose node transform is animated from root joint
        parameters (fbx_builder_pybind add_animated_mesh overloads). The
        entry's character is built on `device` (the card unless the caller
        asks for the CPU)."""
        from momentum_tpu_torch.character import (
            Character, Mesh, make_empty_limits, make_identity_transform, make_skeleton)

        device = resolve(device, "FbxBuilder.add_animated_mesh")
        mesh = getattr(mesh_or_character, "mesh", mesh_or_character)
        if mesh is None:
            raise ValueError("animated mesh entry needs a mesh")
        char = Character(
            skeleton=make_skeleton(
                [-1], translation_offsets=np.asarray([translation_offset], np.float32),
                names=(name or f"mesh{len(self._entries)}",), device=device),
            parameter_transform=make_identity_transform(1, device=device),
            limits=make_empty_limits(device=device),
            mesh=Mesh(vertices=torch.as_tensor(to_host(mesh.vertices).astype(np.float32),
                                               device=device),
                      faces=torch.as_tensor(to_host(mesh.faces).astype(np.int32), device=device)),
        )
        self.add_rigid_body(char, name=name, parent_joint=0)
        if joint_params is not None:
            self.add_motion_with_joint_params(to_host(joint_params).reshape(-1, 7), fps=fps)
        return self

    def add_marker_sequence(self, markers, fps: float = None, device="cuda") -> "FbxBuilder":
        """Mocap markers as animated null joints, one per marker
        (fbx_builder_pybind add_marker_sequence). The entry's character is
        built on `device` (the card unless the caller asks for the CPU)."""
        from momentum_tpu_torch.character import (
            Character, make_empty_limits, make_identity_transform, make_skeleton)

        device = resolve(device, "FbxBuilder.add_marker_sequence")
        pos = to_host(markers.positions).astype(np.float32)
        occ = to_host(markers.occluded).astype(bool)
        names = list(getattr(markers, "names", ())) or [f"M{i}" for i in range(pos.shape[1])]
        f_cnt, m_cnt = pos.shape[0], pos.shape[1]
        char = Character(
            skeleton=make_skeleton([-1] + [0] * m_cnt, names=("markers_root",) + tuple(names),
                                   device=device),
            parameter_transform=make_identity_transform(1 + m_cnt, device=device),
            limits=make_empty_limits(device=device))
        jp = np.zeros((f_cnt, (1 + m_cnt) * 7), np.float32)
        filled = np.where(occ[..., None], np.nan, pos)
        # hold the last visible position through occlusions
        for m in range(m_cnt):
            col = filled[:, m]
            last = np.zeros(3, np.float32)
            for f in range(f_cnt):
                if np.isfinite(col[f]).all():
                    last = col[f]
                jp[f, (1 + m) * 7:(1 + m) * 7 + 3] = last
        self._entries.append(dict(
            character=char, name="markers", joint_params=jp,
            fps=float(fps if fps is not None else getattr(markers, "fps", 120.0) or 120.0)))
        return self

    # ---- output -----------------------------------------------------------

    def to_bytes(self) -> bytes:
        """The merged scene as binary FBX 7.4."""
        from momentum_tpu_torch.io.fbx_writer import _build_scene, _document_bytes

        if not self._entries:
            raise ValueError("nothing to save: no entries added")
        uid_counter = [100000]
        objects, connections = [], []
        for e in self._entries:
            o, c = _build_scene(e["character"], e["joint_params"], e["fps"],
                                uid_counter=uid_counter)
            objects.extend(o)
            connections.extend(c)
        return _document_bytes(objects, connections, self._entries[0]["fps"])

    def save(self, filename, options=None) -> None:
        """Write the merged scene as binary FBX 7.4."""
        data = self.to_bytes()
        with open(str(filename), "wb") as f:
            f.write(data)

    # ---- helpers ----------------------------------------------------------

    def _find(self, character_name: str):
        if not self._entries:
            raise ValueError("add a character before attaching motion")
        if not character_name:
            return self._entries[-1]
        for e in self._entries:
            if e["name"] == character_name:
                return e
        raise ValueError(f"no character named {character_name!r}")

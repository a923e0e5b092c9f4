"""Fluent multi-character GLB writer (gltf_builder.h GltfBuilder).

Reference: momentum/io/gltf/gltf_builder.h — accumulate characters, motions,
skeleton-state animations and marker sequences, then `save()`. Capabilities
mirrored here:

  * `add_character` (any number; each gets its own node subtree + skin)
  * `set_fps`
  * `add_motion` — model-parameter motion stored in the FB_momentum
    extension (loadable back as parameters)
  * `add_skeleton_states` — written as STANDARD glTF animation channels
    (per-joint translation/rotation/scale samplers, linear interpolation),
    so the output plays in any glTF viewer (gltf_builder.h:83-97 semantics:
    states are GLOBAL skeleton states; they are converted to per-node local
    TRS here)
  * `add_marker_sequence`
  * `save(path)` — single-character documents are byte-compatible with
    save_character_glb (the classic FB_momentum layout); multi-character
    documents additionally record per-character metadata under
    FB_momentum["characters"], which `load_all_characters_glb` reads back.

The builder takes tensors on any device; the global → local conversion of
skeleton states runs on their device, and the bytes are written from the
host.
"""

from __future__ import annotations

import numpy as np
import torch

from momentum_tpu_torch.device import resolve, to_host

__all__ = ["GltfBuilder", "load_all_characters_glb"]


class GltfBuilder:
    def __init__(self):
        self._entries = []  # dicts: name, character, motion, states
        self._fps = 120.0
        self._markers = None

    # ------------------------------------------------------------- fluent API
    def add_character(self, character, name: str = None) -> "GltfBuilder":
        if name is None:
            name = f"character{len(self._entries)}" if self._entries else "character"
        if any(e["name"] == name for e in self._entries):
            raise ValueError(f"duplicate character name {name!r}")
        self._entries.append(dict(name=name, character=character, motion=None, states=None))
        return self

    def set_fps(self, fps: float) -> "GltfBuilder":
        self._fps = float(fps)
        return self

    def _entry(self, character_name):
        if not self._entries:
            raise ValueError("add_character must be called first")
        if character_name is None:
            return self._entries[-1]
        for e in self._entries:
            if e["name"] == character_name:
                return e
        raise ValueError(f"unknown character {character_name!r}")

    def add_motion(self, motion, character_name: str = None,
                   timestamps=None) -> "GltfBuilder":
        """(F, P) model-parameter motion for a character (gltf_builder.h:74).
        Optional per-frame int64 `timestamps` ride in the motion section
        (gltf_builder.cpp:1114)."""
        e = self._entry(character_name)
        e["motion"] = to_host(motion).astype(np.float32)
        if timestamps is not None:
            e["timestamps"] = [int(t) for t in to_host(timestamps)]
        return self

    def add_skeleton_states(self, skel_states, character_name: str = None) -> "GltfBuilder":
        """(F, nJ, 8) GLOBAL skeleton states → standard glTF animation
        channels (gltf_builder.h:85)."""
        e = self._entry(character_name)
        e["states"] = (skel_states.to(torch.float32) if isinstance(skel_states, torch.Tensor)
                       else torch.as_tensor(np.asarray(skel_states, np.float32)))
        return self

    def add_marker_sequence(self, markers) -> "GltfBuilder":
        self._markers = markers
        return self

    def add_mesh(self, vertices, faces=None, name: str = None,
                 device="cuda") -> "GltfBuilder":
        """Add a bare (non-skinned) mesh as its own character entry — the
        reference's GltfBuilder::addMesh (gltf_builder.h), used e.g. for
        marker meshes and props. `faces` may be omitted for point clouds.
        The entry's character is built on `device` (the card unless the
        caller asks for the CPU)."""
        from momentum_tpu_torch.character import (
            Character, Mesh, SkinWeights, make_empty_limits, make_identity_transform,
            make_skeleton)

        device = resolve(device, "GltfBuilder.add_mesh")
        vertices = to_host(vertices).astype(np.float32).reshape(-1, 3)
        faces = (np.zeros((0, 3), np.int32) if faces is None
                 else to_host(faces).astype(np.int32).reshape(-1, 3))
        nv = vertices.shape[0]
        # bind every vertex rigidly to the single root so the mesh survives
        # the skinned-GLB export path
        sw = SkinWeights(
            index=torch.zeros((nv, 8), dtype=torch.int32, device=device),
            weight=torch.as_tensor(np.pad(np.ones((nv, 1), np.float32), ((0, 0), (0, 7))),
                                   device=device))
        char = Character(
            skeleton=make_skeleton([-1], names=(name or f"mesh{len(self._entries)}",),
                                   device=device),
            parameter_transform=make_identity_transform(1, device=device),
            limits=make_empty_limits(device=device),
            mesh=Mesh(vertices=torch.as_tensor(vertices, device=device),
                      faces=torch.as_tensor(faces, device=device)),
            skin_weights=sw,
        ).with_inverse_bind_pose()
        return self.add_character(char, name=name)

    # ---------------------------------------------------------------- saving
    def to_bytes(self) -> bytes:
        """Serialize the built document to GLB bytes (pybind
        GltfBuilder.to_bytes) without touching the filesystem."""
        if not self._entries:
            raise ValueError("nothing to save: no characters added")
        if len(self._entries) == 1 and self._entries[0]["states"] is None:
            from momentum_tpu_torch.io.gltf import _character_glb_bytes

            e = self._entries[0]
            return _character_glb_bytes(e["character"], motion=e["motion"], fps=self._fps,
                                        markers=self._markers, timestamps=e.get("timestamps"))
        return self._multi_bytes()

    def save(self, path) -> None:
        data = self.to_bytes()
        with open(str(path), "wb") as f:
            f.write(data)

    def _multi_bytes(self) -> bytes:
        from momentum_tpu_torch.io.gltf import (
            _BinWriter, _add_capsule_nodes, _add_locator_nodes, _glb_container, _joint_nodes,
            _markers_extension, _mesh_accessors, _rig_extension)

        w = _BinWriter()
        nodes, meshes, skins, scene_nodes, animations = [], [], [], [], []
        char_meta = []

        for e in self._entries:
            character = e["character"]
            nj = character.skeleton.num_joints
            base = len(nodes)
            joint_nodes, roots = _joint_nodes(character, character_name=e["name"])
            for node in joint_nodes:
                if "children" in node:
                    node["children"] = [base + c for c in node["children"]]
            nodes.extend(joint_nodes)
            scene_nodes.extend(base + r for r in roots)
            _add_locator_nodes(nodes, character, base)
            _add_capsule_nodes(nodes, character, base, prefix=f"{e['name']}_")

            mesh_index = None
            if character.mesh is not None and character.skin_weights is not None:
                ibm_acc, attrs, idx_acc = _mesh_accessors(w, character)
                mesh_index = len(meshes)
                meshes.append(dict(name=f"{e['name']}_mesh",
                                   primitives=[dict(attributes=attrs, indices=idx_acc)]))
                skins.append(dict(inverseBindMatrices=ibm_acc,
                                  joints=[base + j for j in range(nj)],
                                  skeleton=base + int(roots[0])))
                mesh_node = len(nodes)
                nodes.append(dict(name=f"{e['name']}_meshnode", mesh=mesh_index,
                                  skin=len(skins) - 1))
                scene_nodes.append(mesh_node)

            meta = {"name": e["name"], "jointNodes": [base + j for j in range(nj)]}
            meta.update(_rig_extension(character))
            if e["motion"] is not None:
                meta["motion"] = {
                    "parameterNames": list(character.parameter_transform.names),
                    "poses": w.add(e["motion"].reshape(-1), "SCALAR"),
                    "nframes": int(e["motion"].shape[0]),
                    "fps": self._fps,
                }
            if mesh_index is not None:
                meta["meshIndex"] = mesh_index
            char_meta.append(meta)

            # skeleton states → standard glTF animation channels
            if e["states"] is not None:
                local = _local_states(character.skeleton, e["states"])
                f = local.shape[0]
                times = (np.arange(f) / self._fps).astype(np.float32)
                t_acc = w.add(times, "SCALAR")
                w.accessors[t_acc]["min"] = [float(times.min())]
                w.accessors[t_acc]["max"] = [float(times.max())]
                samplers, channels = [], []
                for j in range(nj):
                    t = np.ascontiguousarray(local[:, j, 0:3])
                    q = local[:, j, 3:7]
                    q = np.ascontiguousarray(
                        q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-12))
                    s = np.repeat(local[:, j, 7:8], 3, axis=1)
                    for path_name, data in (("translation", t), ("rotation", q),
                                            ("scale", s)):
                        out_acc = w.add(data.astype(np.float32),
                                        "VEC4" if path_name == "rotation" else "VEC3")
                        samplers.append(dict(input=t_acc, output=out_acc,
                                             interpolation="LINEAR"))
                        channels.append(dict(sampler=len(samplers) - 1,
                                             target=dict(node=base + j, path=path_name)))
                animations.append(dict(name=f"{e['name']}_motion", samplers=samplers,
                                       channels=channels))

        ext = {"characters": char_meta}
        # back-compat mirror of the first character at the document level
        first = char_meta[0]
        ext["transform"] = first["transform"]
        for k in ("parameterSet", "parameterLimits", "poseConstraints", "motion"):
            if k in first:
                ext[k] = first[k]
        if self._markers is not None:
            ext["markers"] = _markers_extension(w, self._markers)

        doc = dict(
            asset=dict(version="2.0", generator="momentum_tpu"),
            scene=0,
            scenes=[dict(nodes=scene_nodes)],
            nodes=nodes,
            accessors=w.accessors,
            bufferViews=w.views,
            buffers=[dict(byteLength=w.offset)],
            extensionsUsed=["FB_momentum"],
            extensions={"FB_momentum": ext},
        )
        if meshes:
            doc["meshes"] = meshes
            doc["skins"] = skins
        if animations:
            doc["animations"] = animations
        return _glb_container(doc, w.blob())


def _local_states(skeleton, states: torch.Tensor) -> np.ndarray:
    """(F, nJ, 8) global states → each joint's state relative to its
    parent's (a root's own), on the states' device, copied to the host."""
    from momentum_tpu_torch.math import skel_state as ss

    parents = torch.as_tensor(skeleton.parents_np, dtype=torch.int64, device=states.device)
    parent_states = torch.where((parents >= 0)[None, :, None],
                                states.index_select(1, torch.clamp(parents, min=0)),
                                ss.identity((states.shape[0], states.shape[1]),
                                            dtype=states.dtype, device=states.device))
    return to_host(ss.multiply(ss.inverse(parent_states), states))


def load_all_characters_glb(path, device="cuda"):
    """Load every character from a (possibly multi-character) GLB written by
    GltfBuilder → list of (name, Character, (F, P) motion or None), on `device`
    (the card unless the caller asks for the CPU). Falls back to the
    single-character loader for classic documents."""
    from momentum_tpu_torch.io.gltf import (
        _attached_nodes, _character_from_meta, _load_character_doc, _mesh_from_primitive,
        _parent_of, _parse_glb, _read_accessor, _read_binary_source, _skeleton_from_nodes)

    device = resolve(device, "load_all_characters_glb")
    doc, blob = _parse_glb(_read_binary_source(path))
    metas = doc.get("extensions", {}).get("FB_momentum", {}).get("characters")
    if not metas:
        character, motion, _ = _load_character_doc(doc, blob, False, device)
        return [("character", character, motion)]

    nodes = doc.get("nodes", [])
    parent_of = _parent_of(doc)
    out = []
    for meta in metas:
        joint_ids = meta["jointNodes"]
        skeleton, node_to_joint, physical_properties = _skeleton_from_nodes(
            nodes, joint_ids, parent_of, device)
        locators, collision = _attached_nodes(nodes, parent_of, node_to_joint, device)
        mesh = skin_weights = None
        if "meshIndex" in meta and doc.get("meshes"):
            mesh, skin_weights = _mesh_from_primitive(
                doc, blob, doc["meshes"][meta["meshIndex"]]["primitives"][0], device,
                normals=False)
        character = _character_from_meta(skeleton, meta, mesh, skin_weights, locators,
                                         collision, physical_properties, device,
                                         name=meta["name"])
        motion = None
        if "motion" in meta:
            m = meta["motion"]
            motion = torch.as_tensor(_read_accessor(doc, blob, m["poses"]).astype(
                np.float32).reshape(m["nframes"], -1), device=device)
        out.append((meta["name"], character, motion))
    return out

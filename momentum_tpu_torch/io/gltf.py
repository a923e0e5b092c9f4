"""glTF 2.0 (.glb) character + motion IO, from scratch (no external deps).

Reference: momentum/io/gltf/{gltf_io,gltf_builder,gltf_skeleton_io,...}.cpp.
Interop points preserved:
  * joints are glTF nodes: node.rotation = preRotation, node.translation =
    translationOffset (gltf_builder.cpp:742-744, gltf_skeleton_io.cpp:271-272)
  * the FB_momentum document extension carries the rig: "transform" uses the
    same JSON schema as the reference (json_utils.cpp:169-202 —
    {"parameters": [names], "joints": {joint: {attr: {param: value}}}}),
    "parameterSet" maps set name → parameter names, "motion" holds
    {"parameterNames", "poses" (accessor), "offsets" (joint-param offsets)}
  * locator / collision-capsule nodes are children of their joint with
    extension type "locator" / "collision_capsule"
    (gltf_skeleton_io.cpp:180-245, gltf_builder.cpp:374-383)
  * skinned mesh: POSITION/NORMAL + JOINTS_0/WEIGHTS_0 (+ _1 for the upper 4
    of the 8 momentum influences, skin_weights.h:19) + inverseBindMatrices

GLB container: 12-byte header + JSON chunk + 4-aligned BIN chunk. The file
is parsed on the host; the loaders build the character (and the motion, the
marker sequence, the skeleton states) on `device`, the card unless the
caller asks for the CPU. Skeleton states come from FK on that device (kernel
K1 on the card).
"""

from __future__ import annotations

import dataclasses
import json
import struct

import numpy as np
import torch

from momentum_tpu_torch.device import resolve, to_host

__all__ = ["save_character_glb", "load_character_glb", "load_motion_glb",
           "load_motion_timestamps", "load_character_glb_with_skel_states"]

_COMPONENT_DTYPES = {
    5120: np.int8, 5121: np.uint8, 5122: np.int16, 5123: np.uint16,
    5125: np.uint32, 5126: np.float32,
}
_TYPE_SIZE = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}


class _BinWriter:
    def __init__(self):
        self.chunks = []
        self.views = []
        self.accessors = []
        self.offset = 0

    def add(self, arr, gltf_type, component=None, target=None):
        arr = np.ascontiguousarray(arr)
        if component is None:
            component = {np.float32: 5126, np.uint16: 5123, np.uint32: 5125,
                         np.uint8: 5121}[arr.dtype.type]
        data = arr.tobytes()
        pad = (-len(data)) % 4
        view = dict(buffer=0, byteOffset=self.offset, byteLength=len(data))
        if target:
            view["target"] = target
        self.views.append(view)
        self.chunks.append(data + b"\0" * pad)
        self.offset += len(data) + pad
        count = arr.size // _TYPE_SIZE[gltf_type]
        acc = dict(bufferView=len(self.views) - 1, componentType=component,
                   count=count, type=gltf_type)
        if gltf_type == "VEC3" and component == 5126:
            a2 = arr.reshape(-1, 3)
            acc["min"] = [float(x) for x in a2.min(axis=0)]
            acc["max"] = [float(x) for x in a2.max(axis=0)]
        self.accessors.append(acc)
        return len(self.accessors) - 1

    def blob(self):
        return b"".join(self.chunks)


def _glb_container(doc: dict, blob: bytes) -> bytes:
    """A glTF document and its binary chunk as GLB bytes."""
    jbytes = json.dumps(doc).encode()
    jbytes += b" " * ((-len(jbytes)) % 4)
    total = 12 + 8 + len(jbytes) + 8 + len(blob)
    return (struct.pack("<III", 0x46546C67, 2, total)
            + struct.pack("<II", len(jbytes), 0x4E4F534A) + jbytes
            + struct.pack("<II", len(blob), 0x004E4942) + blob)


def _pt_to_json(character):
    """json_utils.cpp:169-202 schema."""
    from momentum_tpu_torch.io.model_definition import JOINT_PARAMETER_NAMES

    pt = character.parameter_transform
    mat = to_host(pt.transform)
    joints = {}
    for row in range(mat.shape[0]):
        j, a = divmod(row, 7)
        cols = np.nonzero(mat[row])[0]
        if len(cols) == 0:
            continue
        jname = character.skeleton.joint_names[j]
        joints.setdefault(jname, {}).setdefault(JOINT_PARAMETER_NAMES[a], {})
        for c in cols:
            joints[jname][JOINT_PARAMETER_NAMES[a]][pt.names[c]] = float(mat[row, c])
    out = {"parameters": list(pt.names), "joints": joints}
    if character.blend_shape_param_index:
        out["blendShapeParameters"] = list(character.blend_shape_param_index)
    return out


def _pt_from_json(j, skeleton):
    from momentum_tpu_torch.character.parameter_transform import ParameterTransform
    from momentum_tpu_torch.io.model_definition import JOINT_PARAMETER_NAMES

    names = list(j.get("parameters", []))
    n_jp = skeleton.num_joints * 7
    mat = np.zeros((n_jp, len(names)), np.float64)
    name_idx = {n: i for i, n in enumerate(names)}
    joint_idx = {n: i for i, n in enumerate(skeleton.joint_names)}
    attr_idx = {n: i for i, n in enumerate(JOINT_PARAMETER_NAMES)}
    for jname, attrs in j.get("joints", {}).items():
        if jname not in joint_idx:
            continue
        for aname, params in attrs.items():
            row = joint_idx[jname] * 7 + attr_idx[aname]
            for pname, val in params.items():
                mat[row, name_idx[pname]] = val
    device = skeleton.joint_parent.device
    return ParameterTransform(
        transform=torch.as_tensor(mat.astype(np.float32), device=device),
        offsets=torch.zeros(n_jp, dtype=torch.float32, device=device),
        names=tuple(names),
    )


def _read_binary_source(source) -> bytes:
    """Accept a filesystem path or raw bytes (the reference's *_from_bytes
    loader variants, character_pybind.cpp load_gltf_from_bytes etc.)."""
    if isinstance(source, (bytes, bytearray, memoryview)):
        return bytes(source)
    with open(source, "rb") as f:
        return f.read()


def _joint_nodes(character, character_name=None) -> tuple:
    """(joint nodes, roots): each joint a node with its rest rotation and
    offset, its bodies in the node extension, its child joints."""
    from momentum_tpu_torch.io._physical import physical_properties_by_joint

    skel = character.skeleton
    nj = skel.num_joints
    parents = skel.parents_np
    children = [[] for _ in range(nj)]
    roots = []
    for j in range(nj):
        p = parents[j]
        (roots if p < 0 else children[p]).append(j)
    pre, offs = to_host(skel.pre_rotation), to_host(skel.translation_offset)
    # per-joint physical bodies into the joint-node extension
    # (gltf_builder.cpp:746-752 / json_utils.cpp:310-336 schema)
    phys_by_joint = physical_properties_by_joint(character)
    nodes = []
    for j in range(nj):
        node = dict(name=skel.joint_names[j],
                    rotation=[float(x) for x in pre[j]],
                    translation=[float(x) for x in offs[j]])
        node["extensions"] = {"FB_momentum": {"type": "skeleton_joint"}}
        if character_name is not None:
            node["extensions"]["FB_momentum"]["character"] = character_name
        if j in phys_by_joint:
            node["extensions"]["FB_momentum"]["physicalProperties"] = phys_by_joint[j]
        if children[j]:
            node["children"] = list(children[j])
        nodes.append(node)
    return nodes, roots


def _add_locator_nodes(nodes, character, base=0):
    """Locators as child nodes of their joints (gltf_builder.cpp:374)."""
    loc = character.locators
    if loc is None:
        return
    lp, lo, lw = (to_host(a) for a in (loc.parent, loc.offset, loc.weight))
    for i in range(loc.num_locators):
        idx = len(nodes)
        nodes.append(dict(
            name=loc.names[i] if i < len(loc.names) else f"locator{i}",
            translation=[float(x) for x in lo[i]],
            extensions={"FB_momentum": {"type": "locator", "weight": float(lw[i])}},
        ))
        nodes[base + lp[i]].setdefault("children", []).append(idx)


def _add_capsule_nodes(nodes, character, base=0, prefix=""):
    col = character.collision
    if col is None:
        return
    cp, ct, cr, cl = (to_host(a) for a in (col.parent, col.transform, col.radius, col.length))
    for i in range(col.num_capsules):
        idx = len(nodes)
        nodes.append(dict(
            name=f"{prefix}capsule{i}",
            translation=[float(x) for x in ct[i, :3]],
            rotation=[float(x) for x in ct[i, 3:7]],
            scale=[float(ct[i, 7])] * 3,
            extensions={"FB_momentum": {
                "type": "collision_capsule",
                "radius": [float(cr[i, 0]), float(cr[i, 1])],
                "length": float(cl[i]),
            }},
        ))
        nodes[base + cp[i]].setdefault("children", []).append(idx)


def _mesh_accessors(w: _BinWriter, character) -> tuple:
    """(inverse-bind accessor, primitive attributes, index accessor) of a
    skinned character's mesh."""
    from momentum_tpu_torch.math import skel_state as ss

    char_b = character.with_inverse_bind_pose()
    ibp = to_host(ss.to_matrix(char_b.inverse_bind_pose))
    ibm_acc = w.add(np.ascontiguousarray(np.transpose(ibp, (0, 2, 1)).astype(np.float32)),
                    "MAT4")  # column-major per glTF
    attrs = {"POSITION": w.add(to_host(character.mesh.vertices).astype(np.float32), "VEC3",
                               target=34962)}
    if character.mesh.normals is not None:
        attrs["NORMAL"] = w.add(to_host(character.mesh.normals).astype(np.float32), "VEC3",
                                target=34962)
    si = to_host(character.skin_weights.index).astype(np.uint16)
    sw = to_host(character.skin_weights.weight).astype(np.float32)
    for g in range(2):
        attrs[f"JOINTS_{g}"] = w.add(np.ascontiguousarray(si[:, 4 * g: 4 * g + 4]), "VEC4",
                                     target=34962)
        attrs[f"WEIGHTS_{g}"] = w.add(np.ascontiguousarray(sw[:, 4 * g: 4 * g + 4]), "VEC4",
                                      target=34962)
    idx_acc = w.add(to_host(character.mesh.faces).astype(np.uint32).reshape(-1), "SCALAR",
                    target=34963)
    return ibm_acc, attrs, idx_acc


def _rig_extension(character) -> dict:
    """The FB_momentum rig entries of a character: its transform, parameter
    sets, limits and pose presets (gltf_builder.cpp:1005-1007)."""
    from momentum_tpu_torch.io.limits_json import limits_to_json, pose_constraints_to_json

    pt = character.parameter_transform
    ext = {"transform": _pt_to_json(character)}
    if pt.parameter_sets:
        ext["parameterSet"] = {k: [pt.names[i] for i in v] for k, v in pt.parameter_sets.items()}
    limits_json = limits_to_json(character)
    if limits_json:
        ext["parameterLimits"] = limits_json
    pose_json = pose_constraints_to_json(character)
    if pose_json:
        ext["poseConstraints"] = pose_json
    return ext


def _markers_extension(w: _BinWriter, markers) -> dict:
    m_pos = to_host(markers.positions).astype(np.float32)
    m_occ = to_host(markers.occluded).astype(np.uint8)
    return {"names": list(markers.names),
            "positions": w.add(m_pos.reshape(-1), "SCALAR"),
            "occluded": w.add(m_occ.reshape(-1), "SCALAR"),
            "nframes": int(m_pos.shape[0])}


def _character_glb_bytes(character, motion=None, fps=120.0, markers=None, identity=None,
                         timestamps=None) -> bytes:
    """save_character_glb's bytes."""
    w = _BinWriter()
    nodes, roots = _joint_nodes(character)
    _add_locator_nodes(nodes, character)
    _add_capsule_nodes(nodes, character)

    meshes, skins = [], []
    scene_nodes = list(roots)
    if character.mesh is not None and character.skin_weights is not None:
        ibm_acc, attrs, idx_acc = _mesh_accessors(w, character)
        meshes.append(dict(primitives=[dict(attributes=attrs, indices=idx_acc)]))
        skins.append(dict(inverseBindMatrices=ibm_acc,
                          joints=list(range(character.skeleton.num_joints)),
                          skeleton=int(roots[0])))
        scene_nodes.append(len(nodes))
        nodes.append(dict(name="mesh", mesh=0, skin=0))

    ext = _rig_extension(character)
    if motion is not None:
        motion = to_host(motion).astype(np.float32)
        ext["motion"] = {
            "parameterNames": list(character.parameter_transform.names),
            "poses": w.add(motion.reshape(-1), "SCALAR"),
            "nframes": int(motion.shape[0]),
            "fps": float(fps),
        }
    if identity is not None:
        # per-joint identity vector as joint parameters (the reference's
        # motion "offsets"/"jointNames" section, gltf_builder.cpp:648-650;
        # loadMotion returns it as IdentityParameters)
        identity = to_host(identity).astype(np.float32).reshape(-1)
        ext.setdefault("motion", {})
        ext["motion"]["offsets"] = w.add(identity, "SCALAR")
        ext["motion"]["jointNames"] = list(character.skeleton.joint_names)
    if timestamps is not None:
        # per-frame int64 timestamps (gltf_builder.cpp:1114; read back by
        # load_motion_timestamps / gltf_io.h:57 loadMotionTimestamps)
        ext.setdefault("motion", {})
        ext["motion"]["timestamps"] = [int(t) for t in to_host(timestamps)]
    if markers is not None:
        ext["markers"] = _markers_extension(w, markers)

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
    return _glb_container(doc, w.blob())


def save_character_glb(path, character, motion=None, fps=120.0, markers=None,
                       identity=None, timestamps=None) -> None:
    """Write character (+ optional (F, P) model-parameter motion, + optional
    marker sequence) as .glb. `markers` is a tracking.MarkerSequence or a
    RawMarkerData (saveMarkerSequence analog, gltf_builder.cpp:374-383).
    Tensors on any device are copied to the host."""
    data = _character_glb_bytes(character, motion, fps, markers, identity, timestamps)
    with open(path, "wb") as f:
        f.write(data)


def _read_accessor(doc, blob, idx):
    acc = doc["accessors"][idx]
    view = doc["bufferViews"][acc["bufferView"]]
    dtype = _COMPONENT_DTYPES[acc["componentType"]]
    n_comp = _TYPE_SIZE[acc["type"]]
    count = acc["count"]
    start = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
    stride = view.get("byteStride", 0)
    itemsize = np.dtype(dtype).itemsize * n_comp
    if stride and stride != itemsize:
        arr = np.zeros((count, n_comp), dtype)
        for i in range(count):
            arr[i] = np.frombuffer(blob, dtype, n_comp, start + i * stride)
    else:
        arr = np.frombuffer(blob, dtype, count * n_comp, start).reshape(count, n_comp)
    return arr if n_comp > 1 else arr[:, 0]


def _parse_glb(data: bytes):
    """GLB container → (doc, blob). Shared by every loader entry point."""
    magic, _version, _ = struct.unpack_from("<III", data, 0)
    if magic != 0x46546C67:
        raise ValueError("not a GLB file")
    off = 12
    doc, blob = None, b""
    while off < len(data):
        clen, ctype = struct.unpack_from("<II", data, off)
        off += 8
        chunk = data[off: off + clen]
        off += clen
        if ctype == 0x4E4F534A:
            doc = json.loads(chunk.decode())
        elif ctype == 0x004E4942:
            blob = chunk
    return doc, blob


def _node_ext(n):
    return n.get("extensions", {}).get("FB_momentum", {})


def _discover_joint_ids(doc):
    """Joint node ids: skins[0].joints, or skeleton_joint-tagged nodes, or
    every non-special hierarchy node."""
    nodes = doc.get("nodes", [])
    if doc.get("skins"):
        return list(doc["skins"][0]["joints"])
    joint_ids = [i for i, n in enumerate(nodes) if _node_ext(n).get("type") == "skeleton_joint"]
    if not joint_ids:
        special = {"locator", "marker", "collision_capsule", "collision_ellipsoid",
                   "collision_box"}
        joint_ids = [i for i, n in enumerate(nodes)
                     if _node_ext(n).get("type") not in special and "mesh" not in n]
    return joint_ids


def _parent_of(doc) -> dict:
    parent_of = {}
    for i, n in enumerate(doc.get("nodes", [])):
        for c in n.get("children", []):
            parent_of[c] = i
    return parent_of


def _sorted_joint_ids(doc, joint_ids):
    """Topologically sort joint node ids (glTF imposes no parent-first node
    order; the reference re-sorts on load, sort_joints.glb). Returns
    (sorted_ids, perm, parent_of) with perm[old_slot] = sorted_slot."""
    parent_of = _parent_of(doc)
    joint_set = set(joint_ids)
    order = []
    seen = set()

    def _visit(nid):
        if nid in seen or nid not in joint_set:
            return
        p = parent_of.get(nid)
        if p is not None and p in joint_set:
            _visit(p)
        seen.add(nid)
        order.append(nid)

    for nid in joint_ids:
        _visit(nid)
    slot = {nid: k for k, nid in enumerate(order)}
    perm = np.asarray([slot[nid] for nid in joint_ids], np.int64)
    return order, perm, parent_of


def _skeleton_from_nodes(nodes, joint_ids, parent_of, device):
    """(skeleton, names, node → joint) from the joint nodes, in the order of
    `joint_ids`, with the bodies of their node extensions."""
    from momentum_tpu_torch.character import make_skeleton
    from momentum_tpu_torch.io._physical import body_from_json, rows_to_physical_properties

    node_to_joint = {n: j for j, n in enumerate(joint_ids)}
    parents, pre, offs, names, phys_rows = [], [], [], [], []
    for j, nid in enumerate(joint_ids):
        n = nodes[nid]
        p = parent_of.get(nid)
        parents.append(node_to_joint.get(p, -1) if p is not None else -1)
        pre.append(n.get("rotation", [0, 0, 0, 1]))
        offs.append(n.get("translation", [0, 0, 0]))
        names.append(n.get("name", f"joint{j}"))
        e = _node_ext(n)
        # per-joint physical bodies (gltf_skeleton_io.cpp:151-153,
        # json_utils.cpp:338-374 schema; inertiaRotation stored [w,x,y,z])
        if "physicalProperties" in e:
            phys_rows.append((j,) + body_from_json(e["physicalProperties"]) + (names[j],))
    skeleton = make_skeleton(parents, np.asarray(pre), np.asarray(offs), names, device=device)
    return skeleton, node_to_joint, rows_to_physical_properties(phys_rows, device)


def _attached_nodes(nodes, parent_of, node_to_joint, device):
    """(locators, collision) from the locator and capsule nodes whose parent
    is a joint node."""
    from momentum_tpu_torch.character import CollisionGeometry, Locators

    loc_rows, cap_rows = [], []
    for i, n in enumerate(nodes):
        e = _node_ext(n)
        p = parent_of.get(i)
        pj = node_to_joint.get(p, -1) if p is not None else -1
        if e.get("type") in ("locator", "marker") and pj >= 0:
            loc_rows.append((pj, n.get("translation", [0, 0, 0]), e.get("weight", 1.0),
                             n.get("name", f"l{i}")))
        elif e.get("type") == "collision_capsule" and pj >= 0:
            tf = (n.get("translation", [0, 0, 0]) + n.get("rotation", [0, 0, 0, 1])
                  + [n.get("scale", [1, 1, 1])[0]])
            cap_rows.append((pj, tf, e.get("radius", [1.0, 1.0]), e.get("length", 1.0)))

    def col(rows, k, dtype=np.float32):
        return torch.as_tensor(np.asarray([r[k] for r in rows], dtype), device=device)

    locators = collision = None
    if loc_rows:
        locators = Locators(parent=col(loc_rows, 0, np.int32), offset=col(loc_rows, 1),
                            weight=col(loc_rows, 2), names=tuple(r[3] for r in loc_rows))
    if cap_rows:
        collision = CollisionGeometry(parent=col(cap_rows, 0, np.int32),
                                      transform=col(cap_rows, 1), radius=col(cap_rows, 2),
                                      length=col(cap_rows, 3))
    return locators, collision


def _mesh_from_primitive(doc, blob, prim, device, joint_perm=None, normals=True):
    """(mesh, skin weights or None) of a primitive; skin joints remapped
    through `joint_perm` (old joint slot → sorted slot) where given."""
    from momentum_tpu_torch.character import Mesh, SkinWeights

    attrs = prim["attributes"]
    verts = _read_accessor(doc, blob, attrs["POSITION"]).astype(np.float32)
    faces = _read_accessor(doc, blob, prim["indices"]).astype(np.int32).reshape(-1, 3)
    nrm = None
    if normals and "NORMAL" in attrs:
        nrm = torch.as_tensor(_read_accessor(doc, blob, attrs["NORMAL"]).astype(np.float32),
                              device=device)
    mesh = Mesh(vertices=torch.as_tensor(verts, device=device),
                faces=torch.as_tensor(faces, device=device), normals=nrm)
    skin_weights = None
    if "JOINTS_0" in attrs:
        v = verts.shape[0]
        si = np.zeros((v, 8), np.int32)
        sw = np.zeros((v, 8), np.float32)
        for g in range(2):
            if f"JOINTS_{g}" in attrs:
                si[:, 4 * g: 4 * g + 4] = _read_accessor(doc, blob, attrs[f"JOINTS_{g}"])
                sw[:, 4 * g: 4 * g + 4] = _read_accessor(doc, blob, attrs[f"WEIGHTS_{g}"])
        if joint_perm is not None:
            # skin joints index the ORIGINAL skins[0].joints order; remap
            # through the topological-sort permutation
            si = joint_perm[np.clip(si, 0, len(joint_perm) - 1)].astype(np.int32)
        skin_weights = SkinWeights(index=torch.as_tensor(si, device=device),
                                   weight=torch.as_tensor(sw, device=device))
    return mesh, skin_weights


def _character_from_meta(skeleton, meta, mesh, skin_weights, locators, collision,
                         physical_properties, device, name=""):
    """The Character from a skeleton and an FB_momentum rig entry (the
    document extension, or one character's entry of a multi-character
    file)."""
    from momentum_tpu_torch.character import Character, make_empty_limits
    from momentum_tpu_torch.character.parameter_transform import make_identity_transform
    from momentum_tpu_torch.io.limits_json import limits_from_json, pose_constraints_from_json

    if "transform" in meta:
        pt = _pt_from_json(meta["transform"], skeleton)
    else:
        pt = make_identity_transform(skeleton.num_joints, device=device)
    if "parameterSet" in meta:
        name_idx = {n: i for i, n in enumerate(pt.names)}
        pt = dataclasses.replace(pt, parameter_sets={
            k: tuple(name_idx[n] for n in v if n in name_idx)
            for k, v in meta["parameterSet"].items()})
    stub = Character(skeleton=skeleton, parameter_transform=pt,
                     limits=make_empty_limits(device=device))
    if "poseConstraints" in meta:
        pt = dataclasses.replace(pt, pose_constraints=pose_constraints_from_json(
            stub, meta["poseConstraints"]))
    limits = (limits_from_json(stub, meta["parameterLimits"], device)
              if "parameterLimits" in meta else stub.limits)
    character = Character(skeleton=skeleton, parameter_transform=pt, limits=limits,
                          locators=locators, name=name, mesh=mesh, skin_weights=skin_weights,
                          collision=collision, physical_properties=physical_properties)
    if mesh is not None and skin_weights is not None:
        character = character.with_inverse_bind_pose()
    return character


def _motion_from_ext(doc, blob, m, param_names):
    """The (F, P) float32 motion of an FB_momentum motion entry."""
    poses = m["poses"]
    if isinstance(poses, int):
        flat = _read_accessor(doc, blob, poses).astype(np.float32)
    else:
        flat = np.asarray(poses, np.float32).reshape(-1)
    nf = int(m.get("nframes", 0)) or (len(flat) // max(1, len(param_names)))
    return flat.reshape(nf, -1)


def load_character_glb(path, return_markers=False, device="cuda"):
    """→ (Character, motion (F, P) float32 or None, fps)
    [+ MarkerSequence or None when return_markers], on `device` (the card
    unless the caller asks for the CPU). `path` is a path or the file's
    bytes."""
    device = resolve(device, "load_character_glb")
    doc, blob = _parse_glb(_read_binary_source(path))
    return _load_character_doc(doc, blob, return_markers, device)


def _load_character_doc(doc, blob, return_markers, device):
    nodes = doc.get("nodes", [])
    joint_ids, joint_perm, parent_of = _sorted_joint_ids(doc, _discover_joint_ids(doc))
    skeleton, node_to_joint, physical_properties = _skeleton_from_nodes(
        nodes, joint_ids, parent_of, device)
    locators, collision = _attached_nodes(nodes, parent_of, node_to_joint, device)
    mesh = skin_weights = None
    if doc.get("meshes"):
        mesh, skin_weights = _mesh_from_primitive(doc, blob, doc["meshes"][0]["primitives"][0],
                                                  device, joint_perm)
    ext = doc.get("extensions", {}).get("FB_momentum", {})
    character = _character_from_meta(skeleton, ext, mesh, skin_weights, locators, collision,
                                     physical_properties, device)
    pt = character.parameter_transform

    motion = None
    fps = 120.0
    if "motion" in ext:
        m = ext["motion"]
        fps = float(m.get("fps", 120.0))
        motion = torch.as_tensor(_motion_from_ext(doc, blob, m,
                                                  m.get("parameterNames", pt.names)),
                                 device=device)
    elif doc.get("animations"):
        # standard glTF animation fallback (Blender-style exports): sample
        # the node TRS channels at the file's native keyframe rate
        # (gltf_io.cpp extracts motion at the stored rate, not a fixed
        # clock) and invert into momentum joint parameters
        fps = float(_animation_fps(doc, blob) or fps)
        jp = _animation_to_joint_params(doc, blob, joint_ids, skeleton, fps)
        if jp is not None:
            # joint params → model params through the rig pseudo-inverse
            # (inverse_parameter_transform.h precedent)
            pinv, offsets = to_host(pt.pinv()), to_host(pt.offsets)
            motion = torch.as_tensor((jp - offsets[None, :]) @ pinv.T, device=device)
    if not return_markers:
        return character, motion, fps
    markers = None
    if "markers" in ext:
        from momentum_tpu_torch.tracking import MarkerSequence

        mk = ext["markers"]
        names = tuple(mk.get("names", ()))
        nf = int(mk["nframes"])
        pos = _read_accessor(doc, blob, mk["positions"]).astype(np.float32)
        occ = _read_accessor(doc, blob, mk["occluded"]).astype(bool)
        nm = len(names) or (pos.size // (nf * 3))
        markers = MarkerSequence(positions=torch.as_tensor(pos.reshape(nf, nm, 3), device=device),
                                 occluded=torch.as_tensor(occ.reshape(nf, nm), device=device),
                                 names=names)
    return character, motion, fps, markers


def load_motion_glb(path):
    """Load ONLY the motion section from a momentum GLB, without building the
    character (pymomentum.geometry.load_motion / gltf_io.h:48 loadMotion).

    → (motion (F, P) float32 or None, parameter_names,
       identity (nJ·7,) float32 or None, joint_names) as numpy — the
    reference's [motionData, motionParameterNames, identityData,
    identityParameterNames].
    """
    doc, blob = _parse_glb(_read_binary_source(path))
    m = doc.get("extensions", {}).get("FB_momentum", {}).get("motion", {})
    param_names = tuple(m.get("parameterNames", ()))
    motion = _motion_from_ext(doc, blob, m, param_names) if "poses" in m else None
    identity = None
    joint_names = tuple(m.get("jointNames", ()))
    if "offsets" in m:
        offs = m["offsets"]
        identity = (_read_accessor(doc, blob, offs).astype(np.float32)
                    if isinstance(offs, int) else np.asarray(offs, np.float32).reshape(-1))
    return motion, param_names, identity, joint_names


def _animation_fps(doc, blob):
    """Infer the keyframe rate of the first animation's samplers (median
    spacing of input times); None when no animation exists."""
    for anim in doc.get("animations") or []:
        for sampler in anim.get("samplers", []):
            times = _read_accessor(doc, blob, sampler["input"]).astype(np.float64).reshape(-1)
            if times.size >= 2:
                dt = np.median(np.diff(np.sort(times)))
                if dt > 0:
                    return float(round(1.0 / dt, 6))
    return None


def load_motion_timestamps(path):
    """Per-frame timestamps from a momentum GLB (gltf_io.h:57
    loadMotionTimestamps; pybind Character.load_motion_timestamps).
    → int64 numpy array (empty when the file carries none)."""
    doc, _ = _parse_glb(_read_binary_source(path))
    ext = doc.get("extensions", {}).get("FB_momentum", {})
    return np.asarray(ext.get("motion", {}).get("timestamps", []), np.int64)


def _animation_to_joint_params(doc, blob, joint_ids, skeleton, fps):
    """Standard glTF animation channels → (F, nJ·7) momentum joint params
    (numpy float32, computed on the host).

    Channels are linearly resampled onto a uniform clock at `fps`. Per
    momentum's joint model (joint_state.h:17-163): translation params =
    node translation − rest translationOffset; rotation params solve
    preRotation ⊗ R(rz,ry,rx) = node rotation (the loader folded the rest
    rotation into preRotation, so the euler extraction is against it);
    scale param = log2(uniform node scale). Returns None when no channel
    targets a joint node."""
    from momentum_tpu_torch.math import quaternion as quat
    from momentum_tpu_torch.math.euler import quaternion_to_euler_zyx

    node_to_joint = {n: j for j, n in enumerate(joint_ids)}
    nj = skeleton.num_joints

    # gather (joint, path) → (times, values)
    tracks = {}
    t_max = 0.0
    for anim in doc["animations"]:
        samplers = anim.get("samplers", [])
        for ch in anim.get("channels", []):
            tgt = ch.get("target", {})
            j = node_to_joint.get(tgt.get("node"))
            path = tgt.get("path")
            if j is None or path not in ("translation", "rotation", "scale"):
                continue
            s = samplers[ch["sampler"]]
            times = _read_accessor(doc, blob, s["input"]).astype(np.float64).reshape(-1)
            vals = _read_accessor(doc, blob, s["output"]).astype(np.float32)
            if times.size == 0:
                continue
            vals = vals.reshape(times.size, -1)
            if s.get("interpolation") == "CUBICSPLINE":
                # 3 output elements per key: [in-tangent, value, out-tangent]
                # — keep the value, resampled linearly below
                vals = vals.reshape(times.size, 3, -1)[:, 1, :]
            t_max = max(t_max, float(times[-1]))
            tracks[(j, path)] = (times, vals)
    if not tracks:
        return None

    num_frames = int(round(t_max * fps)) + 1
    sample_t = np.arange(num_frames, dtype=np.float64) / fps

    rest_pre = to_host(skeleton.pre_rotation)
    rest_off = to_host(skeleton.translation_offset)
    jp = np.zeros((num_frames, nj * 7), np.float32)

    def resample(times, vals):
        out = np.empty((num_frames, vals.shape[1]), np.float64)
        for c in range(vals.shape[1]):
            out[:, c] = np.interp(sample_t, times, vals[:, c].astype(np.float64))
        return out

    for j in range(nj):
        base = j * 7
        tr = tracks.get((j, "translation"))
        if tr is not None:
            jp[:, base:base + 3] = (resample(*tr) - rest_off[j][None, :]).astype(np.float32)
        rot = tracks.get((j, "rotation"))
        if rot is not None:
            q = resample(*rot)
            q /= np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
            rel = quat.multiply(quat.conjugate(torch.as_tensor(rest_pre[j], dtype=torch.float32)),
                                torch.as_tensor(q, dtype=torch.float32))
            jp[:, base + 3:base + 6] = quaternion_to_euler_zyx(rel).numpy()
        sc = tracks.get((j, "scale"))
        if sc is not None:
            s = resample(*sc).mean(axis=1)
            jp[:, base + 6] = np.log2(np.maximum(s, 1e-12)).astype(np.float32)
    return jp


def load_character_glb_with_skel_states(path, fps: float = None, device="cuda"):
    """→ (Character, skel_states (F, nJ, 8) or None, fps) on `device` (the
    card unless the caller asks for the CPU) — the
    save_gltf_from_skel_states counterpart (character_pybind
    load_gltf_with_skel_states): motion reconstructed as GLOBAL skeleton
    states by FK over every frame (kernel K1 on the card). Exact for
    standard glTF animation channels (no rig pseudo-inverse round trip: the
    sampled joint parameters feed FK directly); FB_momentum model-parameter
    motion goes through the rig.

    fps=None (default) samples animations at the file's own rate (inferred
    from the sampler keyframe spacing); pass a value to resample."""
    from momentum_tpu_torch.character import fk

    device = resolve(device, "load_character_glb_with_skel_states")
    doc, blob = _parse_glb(_read_binary_source(path))
    character, motion, file_fps = _load_character_doc(doc, blob, False, device)
    if fps is None:
        fps = _animation_fps(doc, blob) or 120.0

    ext = doc.get("extensions", {}).get("FB_momentum", {})
    if "motion" not in ext and doc.get("animations"):
        # exact path: sampled joint params → FK. Joint ids must be in the
        # same topologically-sorted order the skeleton was built with.
        joint_ids, _, _ = _sorted_joint_ids(doc, _discover_joint_ids(doc))
        jp = _animation_to_joint_params(doc, blob, joint_ids, character.skeleton, fps)
        if jp is not None:
            states = fk.global_skel_states(character.skeleton, torch.as_tensor(jp, device=device))
            return character, states, fps
    if motion is None:
        return character, None, file_fps
    return character, character.skeleton_states(motion), file_fps

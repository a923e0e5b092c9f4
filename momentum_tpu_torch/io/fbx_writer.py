"""FBX binary export (characters: skeleton + mesh + skinning + motion).

Reference: momentum/io/fbx/fbx_io.h:77-131 saveFbx / saveFbxWithJointParams /
saveFbxModel — in the reference these are gated behind the proprietary
Autodesk FBX SDK (fbx_builder.cpp:12 `#ifdef MOMENTUM_WITH_FBX_SDK`) and are
unavailable in the OSS build. This module is a from-scratch writer of the
standard Kaydara FBX binary container (version 7.4, u32 record offsets):

  header "Kaydara FBX Binary  \\x00\\x1a\\x00" + version; nested node records
  (EndOffset, NumProperties, PropertyListLen, NameLen, Name) with typed
  properties (Y/C/I/F/D/L scalars, f/d/l/i arrays — large arrays
  zlib-deflated with encoding 1); 13-byte null records terminate child lists.

Scene mapping mirrors the reference builder's (fbx_builder.cpp:197-260
skeleton nodes, :143-196 mesh + skin clusters, fbx_io.cpp curve export):
  * joints → Model("LimbNode") nodes; translationOffset → Lcl Translation,
    preRotation → PreRotation Euler (XYZ degrees, the composition
    Rz·Ry·Rx matching the loader's _euler_xyz_deg_to_quat)
  * physical mass bodies → the `physicalProperties` custom string property
    on the joint Model (openfbx_loader.cpp:138-143 schema)
  * mesh → Geometry (Vertices + PolygonVertexIndex with end-of-polygon
    bitwise-complement indices) under a Model("Mesh")
  * skinning → Deformer("Skin") + one Deformer("Cluster") per influencing
    joint (Indexes/Weights), connected joint-Model → Cluster
  * motion (7 params/joint) → AnimationCurveNode T/R/S per animated joint +
    AnimationCurve KeyTime/KeyValueFloat channels, OP-connected
    ("Lcl Translation"/"Lcl Rotation"/"Lcl Scaling", axes "d|X".."d|Z");
    rotations written in degrees, scale as 2**param (loader samples these
    back at fps, fbx.py load_fbx_with_motion)

The writer takes characters and motions on any device and writes
momentum_tpu/io/fbx_writer.py's bytes for the same content. The rest
pose's global states (the clusters' bind matrices) come from FK on the
character's device (kernel K1 on the card); every other float it writes is
read from the character or the motion.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch

from momentum_tpu_torch.device import to_host

__all__ = ["save_fbx", "save_fbx_with_joint_params", "save_fbx_model"]

_MAGIC = b"Kaydara FBX Binary  \x00\x1a\x00"
_VERSION = 7400
_KTIME_PER_SECOND = 46186158000.0  # FBX KTime ticks per second
_COMPRESS_THRESHOLD = 1024  # bytes; arrays above this are zlib-deflated


class _N:
    """Writer-side node: name, typed props, children."""

    __slots__ = ("name", "props", "children")

    def __init__(self, name, props=(), children=()):
        self.name = name
        self.props = list(props)
        self.children = list(children)


# ---------------------------------------------------------------- properties

def _p_long(v):
    return ("L", int(v))


def _p_int(v):
    return ("I", int(v))


def _p_double(v):
    return ("D", float(v))


def _p_str(v):
    return ("S", v)


def _p_arr(tag, arr):
    return (tag, arr)


_ARRAY_FMT = {"f": ("<f4", 4), "d": ("<f8", 8), "l": ("<i8", 8), "i": ("<i4", 4)}


def _ser_prop(p) -> bytes:
    tag, v = p
    if tag == "Y":
        return b"Y" + struct.pack("<h", v)
    if tag == "C":
        return b"C" + struct.pack("<B", 1 if v else 0)
    if tag == "I":
        return b"I" + struct.pack("<i", v)
    if tag == "F":
        return b"F" + struct.pack("<f", v)
    if tag == "D":
        return b"D" + struct.pack("<d", v)
    if tag == "L":
        return b"L" + struct.pack("<q", v)
    if tag == "S" or tag == "R":
        raw = v.encode("utf-8") if isinstance(v, str) else bytes(v)
        return tag.encode() + struct.pack("<I", len(raw)) + raw
    if tag in _ARRAY_FMT:
        fmt, _item = _ARRAY_FMT[tag]
        raw = np.ascontiguousarray(np.asarray(v), dtype=fmt).tobytes()
        if len(raw) > _COMPRESS_THRESHOLD:
            comp = zlib.compress(raw)
            return (tag.encode()
                    + struct.pack("<III", np.asarray(v).size, 1, len(comp))
                    + comp)
        return (tag.encode()
                + struct.pack("<III", np.asarray(v).size, 0, len(raw)) + raw)
    raise ValueError(f"unknown FBX writer property tag {tag!r}")


# ---------------------------------------------------------------- records

_NULL_RECORD = b"\x00" * 13      # v7400: 3×u32 + u8 name-len sentinel
_NULL_RECORD_BIG = b"\x00" * 25  # v7500+: 3×u64 + u8 (openfbx_loader.h reads
                                 # both; the SDK emits 64-bit from 7.5)


def _ser_node(node: _N, off: int, big: bool = False) -> bytes:
    """Serialize one node record at absolute file offset `off`.

    big=False → v7400 u32 (EndOffset, NumProperties, PropertyListLen);
    big=True  → v7500+ u64 record headers (the modern SDK layout the
    reference's goldens use — character.fbx/motion.fbx are v7700)."""
    name = node.name.encode("utf-8")
    props = b"".join(_ser_prop(p) for p in node.props)
    header_len = (25 if big else 13) + len(name)
    child_off = off + header_len + len(props)
    children = b""
    if node.children:
        parts = []
        co = child_off
        for c in node.children:
            b = _ser_node(c, co, big)
            co += len(b)
            parts.append(b)
        children = b"".join(parts) + (_NULL_RECORD_BIG if big else _NULL_RECORD)
    end = off + header_len + len(props) + len(children)
    fmt = "<QQQ" if big else "<III"
    return (struct.pack(fmt, end, len(node.props), len(props))
            + bytes([len(name)]) + name + props + children)


def _ser_document(top_nodes, version: int = _VERSION) -> bytes:
    big = version >= 7500
    out = bytearray(_MAGIC)
    out += struct.pack("<I", version)
    off = len(out)
    for n in top_nodes:
        b = _ser_node(n, off, big)
        off += len(b)
        out += b
    out += _NULL_RECORD_BIG if big else _NULL_RECORD
    # footer: unknown id + pad-to-16 + version + 120 zeros + closing magic
    out += bytes(16)
    out += bytes((16 - len(out) % 16) % 16)
    out += struct.pack("<I", version)
    out += bytes(120)
    out += bytes.fromhex("f85a8c6a de f5 d9 7e ec e9 0c e3 75 8f 29 0b".replace(" ", ""))
    return bytes(out)


# ---------------------------------------------------------------- scene build

def _prop70(name, type_name, flags, *values, value_type="D"):
    props = [_p_str(name), _p_str(type_name), _p_str(""), _p_str(flags)]
    make = {"S": _p_str, "L": _p_long, "I": _p_int}.get(value_type, _p_double)
    for v in values:
        props.append(make(v))
    return _N("P", props)


def _quat_to_euler_xyz_deg(q_xyzw) -> np.ndarray:
    """(..., 3) (rx, ry, rz) degrees with R = Rz·Ry·Rx — the loader's
    composition (fbx.py _euler_xyz_deg_to_quat builds qz ⊗ qy ⊗ qx) — in
    float32 on the host, as momentum_tpu's computes it."""
    from momentum_tpu_torch.math.euler import quaternion_to_euler_zyx

    q = torch.as_tensor(to_host(q_xyzw), dtype=torch.float32)
    return np.degrees(quaternion_to_euler_zyx(q).numpy())


def _header_nodes(fps):
    hdr = _N("FBXHeaderExtension", children=[
        _N("FBXHeaderVersion", [_p_int(1003)]),
        _N("FBXVersion", [_p_int(_VERSION)]),
        _N("Creator", [_p_str("momentum_tpu fbx writer")]),
    ])
    gs = _N("GlobalSettings", children=[
        _N("Version", [_p_int(1000)]),
        _N("Properties70", children=[
            _prop70("UpAxis", "int", "", 1),
            _prop70("UpAxisSign", "int", "", 1),
            _prop70("FrontAxis", "int", "", 2),
            _prop70("CoordAxis", "int", "", 0),
            _prop70("UnitScaleFactor", "double", "", 1.0),
            _prop70("TimeMode", "enum", "", 14),
            _prop70("CustomFrameRate", "double", "", float(fps)),
        ]),
    ])
    # FileId / CreationTime / Creator: the FBX-SDK golden
    # (convert_model/test_data/character.fbx) carries these three records
    # between the header extension and GlobalSettings; SDK-based readers
    # expect the sequence. FileId is 16 opaque bytes ('R'); a fixed id keeps
    # the writer deterministic.
    file_id = _N("FileId", [("R", bytes(range(16)))])
    ctime = _N("CreationTime", [_p_str("1970-01-01 00:00:00:000")])
    creator = _N("Creator", [_p_str("momentum_tpu fbx writer")])
    return [hdr, file_id, ctime, creator, gs]


def _build_scene(character, joint_params=None, fps: float = 120.0,
                 uid_counter=None):
    """→ (objects children list, connections children list). `uid_counter`
    is a mutable [next_id] shared across entries when several scenes merge
    into one document (FbxBuilder)."""
    import json

    skel = character.skeleton
    nj = skel.num_joints
    offs = to_host(skel.translation_offset).astype(np.float64)
    parents = skel.parents_np

    next_uid = uid_counter if uid_counter is not None else [100000]

    def uid():
        next_uid[0] += 1
        return next_uid[0]

    objects = []
    connections = []

    from momentum_tpu_torch.io._physical import physical_properties_by_joint

    phys_by_joint = {j: json.dumps(b) for j, b in physical_properties_by_joint(character).items()}

    # joints → Model("LimbNode"); every pre-rotation's Euler angles at once
    pre_euler = _quat_to_euler_xyz_deg(skel.pre_rotation)
    joint_uid = np.empty(nj, np.int64)
    for j in range(nj):
        u = uid()
        joint_uid[j] = u
        e = pre_euler[j]
        p70 = [
            _prop70("Lcl Translation", "Lcl Translation", "A", *offs[j]),
            _prop70("PreRotation", "Vector3D", "A", float(e[0]), float(e[1]),
                    float(e[2])),
            _prop70("Lcl Rotation", "Lcl Rotation", "A", 0.0, 0.0, 0.0),
            _prop70("Lcl Scaling", "Lcl Scaling", "A", 1.0, 1.0, 1.0),
        ]
        if j in phys_by_joint:
            p70.append(_prop70("physicalProperties", "KString", "U",
                               phys_by_joint[j], value_type="S"))
        objects.append(_N("Model", [
            _p_long(u), _p_str(skel.joint_names[j] + "\x00\x01Model"),
            _p_str("LimbNode"),
        ], [_N("Version", [_p_int(232)]), _N("Properties70", children=p70)]))
        parent = 0 if parents[j] < 0 else int(joint_uid[parents[j]])
        connections.append(_N("C", [_p_str("OO"), _p_long(u), _p_long(parent)]))

    # mesh → Model("Mesh") + Geometry
    if character.mesh is not None:
        verts = to_host(character.mesh.vertices).astype(np.float64)
        faces = to_host(character.mesh.faces).astype(np.int64)
        poly = faces.copy()
        poly[:, 2] = -poly[:, 2] - 1  # end-of-polygon complement encoding
        gu, mu = uid(), uid()
        geom_children = [
            _N("Vertices", [_p_arr("d", verts.reshape(-1))]),
            _N("PolygonVertexIndex", [_p_arr("i", poly.reshape(-1))]),
            _N("GeometryVersion", [_p_int(124)]),
        ]
        if character.mesh.texcoords is not None:
            # ByPolygonVertex + IndexToDirect is the general encoding: it
            # carries texcoord_faces exactly even when UV topology differs
            # from vertex topology (mesh.h:55 texcoord_faces semantics)
            tc = to_host(character.mesh.texcoords).astype(np.float64)
            tf = to_host(
                character.mesh.texcoord_faces
                if character.mesh.texcoord_faces is not None
                else character.mesh.faces).astype(np.int32)
            geom_children.append(_N("LayerElementUV", [_p_int(0)], [
                _N("Version", [_p_int(101)]),
                _N("Name", [_p_str("st")]),
                _N("MappingInformationType", [_p_str("ByPolygonVertex")]),
                _N("ReferenceInformationType", [_p_str("IndexToDirect")]),
                _N("UV", [_p_arr("d", tc.reshape(-1))]),
                _N("UVIndex", [_p_arr("i", tf.reshape(-1))]),
            ]))
            geom_children.append(_N("Layer", [_p_int(0)], [
                _N("Version", [_p_int(100)]),
                _N("LayerElement", children=[
                    _N("Type", [_p_str("LayerElementUV")]),
                    _N("TypedIndex", [_p_int(0)]),
                ]),
            ]))
        objects.append(_N("Geometry", [
            _p_long(gu), _p_str("mesh\x00\x01Geometry"), _p_str("Mesh"),
        ], geom_children))
        objects.append(_N("Model", [
            _p_long(mu), _p_str("mesh\x00\x01Model"), _p_str("Mesh"),
        ], [_N("Version", [_p_int(232)])]))
        connections.append(_N("C", [_p_str("OO"), _p_long(mu), _p_long(0)]))
        connections.append(_N("C", [_p_str("OO"), _p_long(gu), _p_long(mu)]))

        # skinning → Skin + per-joint Clusters
        if character.skin_weights is not None:
            sw_i = to_host(character.skin_weights.index)
            sw_w = to_host(character.skin_weights.weight).astype(np.float64)
            su = uid()
            objects.append(_N("Deformer", [
                _p_long(su), _p_str("\x00\x01Deformer"), _p_str("Skin"),
            ], [_N("Version", [_p_int(101)])]))
            connections.append(_N("C", [_p_str("OO"), _p_long(su), _p_long(gu)]))
            # Bind matrices: TransformLink = joint world rest transform,
            # Transform = its inverse × mesh world (identity here). Standard
            # importers (Maya/Blender/Autodesk SDK) reconstruct the bind pose
            # from these; without them skinning collapses to identity.
            from momentum_tpu_torch.math import skel_state as _ss

            # the rest pose by FK on the character's device (K1 on the card)
            bind = to_host(_ss.to_matrix(character.bind_pose())).astype(np.float64)
            for j in range(nj):
                mask = (sw_i == j) & (sw_w > 0)
                vi = np.nonzero(mask.any(axis=1))[0]
                if vi.size == 0:
                    continue
                wv = np.where(mask[vi], sw_w[vi], 0.0).sum(axis=1)
                cu = uid()
                # FBX matrices are flattened column-by-column (translation at
                # flat indices 12-14), i.e. M.T in row-major
                link = bind[j]
                inv = np.linalg.inv(link)
                objects.append(_N("Deformer", [
                    _p_long(cu),
                    _p_str(f"cluster_{skel.joint_names[j]}\x00\x01SubDeformer"),
                    _p_str("Cluster"),
                ], [
                    _N("Version", [_p_int(100)]),
                    _N("Indexes", [_p_arr("i", vi.astype(np.int64))]),
                    _N("Weights", [_p_arr("d", wv)]),
                    _N("Transform", [_p_arr("d", inv.T.reshape(-1))]),
                    _N("TransformLink", [_p_arr("d", link.T.reshape(-1))]),
                ]))
                connections.append(
                    _N("C", [_p_str("OO"), _p_long(cu), _p_long(su)]))
                connections.append(_N("C", [
                    _p_str("OO"), _p_long(int(joint_uid[j])), _p_long(cu)]))

    # motion → T/R/S AnimationCurveNodes + curves, bound to a stack/layer
    # (standard importers resolve curves through AnimationLayer→Stack)
    if joint_params is not None:
        motion = to_host(joint_params).astype(np.float64).reshape(-1, nj * 7)
        num_frames = motion.shape[0]
        ktimes = np.round(np.arange(num_frames, dtype=np.float64)
                          / float(fps) * _KTIME_PER_SECOND).astype(np.int64)
        stop = int(ktimes[-1]) if num_frames else 0

        stack_u, layer_u = uid(), uid()
        objects.append(_N("AnimationStack", [
            _p_long(stack_u), _p_str("Take 001\x00\x01AnimStack"), _p_str(""),
        ], [_N("Properties70", children=[
            _prop70("LocalStop", "KTime", "", stop, value_type="L"),
            _prop70("ReferenceStop", "KTime", "", stop, value_type="L"),
        ])]))
        objects.append(_N("AnimationLayer", [
            _p_long(layer_u), _p_str("BaseLayer\x00\x01AnimLayer"), _p_str(""),
        ]))
        connections.append(_N("C", [_p_str("OO"), _p_long(layer_u),
                                    _p_long(stack_u)]))

        def add_curve_node(j, prop_name, label, values3):
            cn = uid()
            objects.append(_N("AnimationCurveNode", [
                _p_long(cn), _p_str(label + "\x00\x01AnimCurveNode"),
                _p_str(""),
            ], [_N("Properties70", children=[
                _prop70("d|X", "Number", "A", float(values3[0, 0])),
                _prop70("d|Y", "Number", "A", float(values3[0, 1])),
                _prop70("d|Z", "Number", "A", float(values3[0, 2])),
            ])]))
            connections.append(_N("C", [_p_str("OO"), _p_long(cn),
                                        _p_long(layer_u)]))
            connections.append(_N("C", [
                _p_str("OP"), _p_long(cn), _p_long(int(joint_uid[j])),
                _p_str(prop_name)]))
            for a, axis in enumerate("XYZ"):
                cu = uid()
                objects.append(_N("AnimationCurve", [
                    _p_long(cu), _p_str("\x00\x01AnimCurve"), _p_str(""),
                ], [
                    _N("Default", [_p_double(values3[0, a])]),
                    _N("KeyVer", [_p_int(4008)]),
                    _N("KeyTime", [_p_arr("l", ktimes)]),
                    _N("KeyValueFloat",
                       [_p_arr("f", values3[:, a].astype(np.float32))]),
                ]))
                connections.append(_N("C", [
                    _p_str("OP"), _p_long(cu), _p_long(cn),
                    _p_str(f"d|{axis}")]))

        for j in range(nj):
            base = j * 7
            t = motion[:, base:base + 3] + offs[j][None, :]
            r = np.degrees(motion[:, base + 3:base + 6])
            s = np.exp2(motion[:, base + 6])
            add_curve_node(j, "Lcl Translation", "T", t)
            add_curve_node(j, "Lcl Rotation", "R", r)
            if np.any(motion[:, base + 6] != 0.0):
                add_curve_node(j, "Lcl Scaling", "S",
                               np.repeat(s[:, None], 3, axis=1))

    return objects, connections


def _definitions_node(objects):
    """ObjectType count templates — importers that honor Definitions refuse
    documents whose object counts are absent (fbx_builder.cpp scene setup
    delegates this to the SDK)."""
    counts = {}
    for o in objects:
        counts[o.name] = counts.get(o.name, 0) + 1
    children = [_N("Version", [_p_int(100)]),
                _N("Count", [_p_int(1 + sum(counts.values()))]),
                _N("ObjectType", [_p_str("GlobalSettings")],
                   [_N("Count", [_p_int(1)])])]
    for name, cnt in sorted(counts.items()):
        children.append(_N("ObjectType", [_p_str(name)],
                           [_N("Count", [_p_int(cnt)])]))
    return _N("Definitions", children=children)


def _documents_node():
    return _N("Documents", children=[
        _N("Count", [_p_int(1)]),
        _N("Document", [_p_long(999999), _p_str("Scene"), _p_str("Scene")], [
            _N("Properties70", children=[
                _prop70("SourceObject", "object", ""),
                _prop70("ActiveAnimStackName", "KString", "", "",
                        value_type="S"),
            ]),
            _N("RootNode", [_p_long(0)]),
        ]),
    ])


def _document_bytes(objects, connections, fps: float, version: int = _VERSION) -> bytes:
    """The binary document of a scene's objects and connections."""
    doc = _header_nodes(fps) + [
        _documents_node(),
        _N("References"),
        _definitions_node(objects),
        _N("Objects", children=objects),
        _N("Connections", children=connections),
        # trailing Takes section (golden sequence; empty Current take)
        _N("Takes", children=[_N("Current", [_p_str("")])]),
    ]
    return _ser_document(doc, version)


def _write_document(path, objects, connections, fps: float,
                    version: int = _VERSION) -> None:
    with open(path, "wb") as f:
        f.write(_document_bytes(objects, connections, fps, version))


def save_fbx_with_joint_params(path, character, joint_params=None,
                               fps: float = 120.0,
                               version: int = _VERSION) -> None:
    """Save character (+ optional per-frame joint parameters, (F, nJ·7), on
    any device) as binary FBX (fbx_io.h:100 saveFbxWithJointParams).

    version: 7400 (u32 record headers, widest importer support) or ≥7500
    (u64 big headers — the modern SDK layout; the reference's goldens are
    v7700)."""
    objects, connections = _build_scene(character, joint_params, fps)
    _write_document(path, objects, connections, fps, version)


def save_fbx(path, character, motion=None, fps: float = 120.0,
             version: int = _VERSION) -> None:
    """Save character with optional model-parameter motion (F, P), mapped
    through the parameter transform on the character's device (fbx_io.h:77
    saveFbx)."""
    jp = None
    if motion is not None:
        pt = character.parameter_transform
        jp = pt.apply(torch.as_tensor(motion, dtype=torch.float32).to(pt.transform.device))
    save_fbx_with_joint_params(path, character, jp, fps, version)


def save_fbx_model(path, character, version: int = _VERSION) -> None:
    """Save character rest data only (fbx_io.h:131 saveFbxModel)."""
    save_fbx_with_joint_params(path, character, None, version=version)

"""FBX import, binary AND ASCII containers (skeleton + mesh + skinning).

Reference: momentum/io/fbx/ loads FBX through the bundled OpenFBX C++ parser
(openfbx_loader.h; ofbx::load handles both text and binary files; saving
requires the proprietary Autodesk SDK and is not supported there,
CMakeLists.txt:69-80). This is a from-scratch reader of both standard
containers feeding one shared character-assembly path:

  binary: header "Kaydara FBX Binary  \\x00" + version; nested node records
  (u32 offsets < v7500, u64 from v7500) with typed properties
  (Y/C/I/F/D/L scalars, f/d/l/i/b arrays with optional zlib encoding 1).

  ASCII: `Name: props { children }` records with `;` comments; 7.x `*N
  { a: ... }` arrays and 6.x direct comma-separated arrays / name-based
  `Connect:` records are normalized to the binary-7.x node conventions
  (_normalize_ascii).

Character assembly mirrors the reference's mapping:
  * Model nodes of type LimbNode/Root → joints; Lcl Translation →
    translationOffset, PreRotation+Lcl Rotation (XYZ degrees) → preRotation
  * Geometry → mesh (PolygonVertexIndex fan-triangulated)
  * Deformer/Cluster → skin weights (top-8 influences, renormalized)
  * Connections (OO) define the hierarchy

The file is parsed on the host; the loaders build the character (and the
sampled motion, in float64 on the host as momentum_tpu's does, then cast)
on `device`, the card unless the caller asks for the CPU. The inverse bind
pose of a skinned mesh comes from FK on that device (kernel K1 on the
card).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch

from momentum_tpu_torch.device import resolve

__all__ = ["load_fbx", "load_fbx_with_motion"]

_MAGIC = b"Kaydara FBX Binary  \x00"


class _Node:
    __slots__ = ("name", "props", "children")

    def __init__(self, name, props):
        self.name = name
        self.props = props
        self.children = []

    def find(self, name):
        return [c for c in self.children if c.name == name]

    def first(self, name):
        for c in self.children:
            if c.name == name:
                return c
        return None


def _read_array(data, off, fmt, itemsize):
    n, enc, comp_len = struct.unpack_from("<III", data, off)
    off += 12
    if enc == 0:
        raw = data[off: off + n * itemsize]
        off += n * itemsize
    else:
        raw = zlib.decompress(data[off: off + comp_len])
        off += comp_len
    return np.frombuffer(raw, fmt, n), off


def _read_property(data, off):
    t = data[off: off + 1]
    off += 1
    if t == b"Y":
        return struct.unpack_from("<h", data, off)[0], off + 2
    if t == b"C":
        return bool(data[off]), off + 1
    if t == b"I":
        return struct.unpack_from("<i", data, off)[0], off + 4
    if t == b"F":
        return struct.unpack_from("<f", data, off)[0], off + 4
    if t == b"D":
        return struct.unpack_from("<d", data, off)[0], off + 8
    if t == b"L":
        return struct.unpack_from("<q", data, off)[0], off + 8
    if t == b"f":
        return _read_array(data, off, "<f4", 4)
    if t == b"d":
        return _read_array(data, off, "<f8", 8)
    if t == b"l":
        return _read_array(data, off, "<i8", 8)
    if t == b"i":
        return _read_array(data, off, "<i4", 4)
    if t == b"b":
        return _read_array(data, off, "<u1", 1)
    if t == b"S" or t == b"R":
        (n,) = struct.unpack_from("<I", data, off)
        off += 4
        raw = data[off: off + n]
        return (raw.decode("utf-8", "replace") if t == b"S" else raw), off + n
    raise ValueError(f"unknown FBX property type {t!r}")


def _read_node(data, off, big):
    if big:
        end, n_props, _plen = struct.unpack_from("<QQQ", data, off)
        off += 24
    else:
        end, n_props, _plen = struct.unpack_from("<III", data, off)
        off += 12
    name_len = data[off]
    off += 1
    name = data[off: off + name_len].decode("utf-8", "replace")
    off += name_len
    if end == 0 and not name:
        return None, off
    props = []
    for _ in range(n_props):
        v, off = _read_property(data, off)
        props.append(v)
    node = _Node(name, props)
    while off < end:
        child, off = _read_node(data, off, big)
        if child is None:
            break
    # consume remaining null record if any
        node.children.append(child)
    return node, max(off, end)


def _parse(data):
    if data.startswith(_MAGIC):
        version = struct.unpack_from("<I", data, 23)[0]
        big = version >= 7500
        off = 27
        root = _Node("", [])
        while off < len(data) - 16:
            node, off = _read_node(data, off, big)
            if node is None:
                break
            root.children.append(node)
        return root, version
    # ASCII FBX (the reference's bundled OpenFBX parses both containers,
    # openfbx_loader.h; ofbx::load handles text and binary alike)
    try:
        text = data.decode("utf-8")
    except UnicodeDecodeError:
        raise ValueError("not an FBX file (no binary magic, not UTF-8 text)")
    if "FBXHeaderExtension" not in text[:8192]:
        raise ValueError("not an FBX file (no binary magic, no ASCII header)")
    return _parse_ascii(text)


# --------------------------------------------------------------------------
# ASCII container: `Name: prop, prop, ... { children }` records with `;`
# line comments. Arrays appear either as `*N { a: v,v,... }` (7.x text) or
# as direct comma-separated values on known array nodes (6.x text). The
# parser produces the SAME _Node tree as the binary reader so the character
# assembly below is container-agnostic.
# --------------------------------------------------------------------------

# nodes whose payload is one homogeneous numeric array in the binary form
_ARRAY_NODES = frozenset({
    "Vertices", "PolygonVertexIndex", "Normals", "NormalsIndex", "UV",
    "UVIndex", "Indexes", "Weights", "Matrix", "Transform", "TransformLink",
    "Points", "KeyTime", "KeyValueFloat", "KeyAttrFlags", "KeyAttrDataFloat",
    "KeyAttrRefCount",
})


def _tokenize_ascii(text):
    i, n = 0, len(text)
    toks = []
    while i < n:
        c = text[i]
        if c in " \t\r\n":
            i += 1
            continue
        if c == ";":
            j = text.find("\n", i)
            i = n if j < 0 else j + 1
            continue
        if c == '"':
            j = text.find('"', i + 1)
            if j < 0:
                raise ValueError("FBX ASCII: unterminated string")
            toks.append(("str", text[i + 1:j]))
            i = j + 1
            continue
        if c in "{},":
            toks.append((c, c))
            i += 1
            continue
        if c == "*":
            j = i + 1
            while j < n and text[j].isdigit():
                j += 1
            toks.append(("count", int(text[i + 1:j] or 0)))
            i = j
            continue
        j = i
        while j < n and text[j] not in " \t\r\n{},;\"":
            j += 1
        tok = text[i:j]
        i = j
        if tok.endswith(":"):
            toks.append(("name", tok[:-1]))
        else:
            toks.append(("atom", tok))
    return toks


def _coerce_atom(tok):
    try:
        return int(tok)
    except ValueError:
        pass
    try:
        return float(tok)
    except ValueError:
        return tok


def _parse_ascii_children(toks, pos):
    children = []
    while pos < len(toks):
        kind, val = toks[pos]
        if kind == "}":
            return children, pos + 1
        if kind != "name":
            raise ValueError(f"FBX ASCII: expected node name, got {val!r}")
        pos += 1
        props = []
        is_array = False
        while pos < len(toks) and toks[pos][0] in ("atom", "str", "count", ","):
            k2, v2 = toks[pos]
            pos += 1
            if k2 == ",":
                continue
            if k2 == "count":
                is_array = True
                continue
            props.append(_coerce_atom(v2) if k2 == "atom" else v2)
        node = _Node(val, props)
        if pos < len(toks) and toks[pos][0] == "{":
            node.children, pos = _parse_ascii_children(toks, pos + 1)
        if is_array or (val in _ARRAY_NODES and node.children == []
                        and len(props) > 0
                        and all(isinstance(p, (int, float)) for p in props)):
            # collapse `*N { a: ... }` / direct numeric payload into the
            # single ndarray property the binary reader produces
            payload = props
            a = node.first("a")
            if a is not None:
                payload = a.props
            arr = np.asarray(payload)
            if arr.dtype == object:  # mixed tokens: force float
                arr = np.asarray([float(x) for x in payload])
            node.props = [arr]
            node.children = []
        children.append(node)
    return children, pos


def _parse_ascii(text):
    toks = _tokenize_ascii(text)
    children, _ = _parse_ascii_children(toks, 0)
    root = _Node("", [])
    root.children = children
    version = 7400
    hdr = root.first("FBXHeaderExtension")
    if hdr is not None:
        v = hdr.first("FBXVersion")
        if v is not None and v.props:
            version = int(v.props[0])
    _normalize_ascii(root, version)
    return root, version


def _normalize_ascii(root, version):
    """Bring the ASCII node tree to binary-7.x conventions in place:

    - object names: text files carry "Class::name"; the binary carries
      "name\\x00\\x01Class" and the assembly takes split("\\x00")[0] — strip
      the class prefix here so both containers agree.
    - FBX 6.x text has no uids and name-based `Connect:` records: synthesize
      uid = the full "Class::name" string (uids are only dict keys) and remap
      Connect → C with "Model::Scene" as the root (0).
    - Properties60/`Property:` records (values at props[3:]) → Properties70/
      `P:` records (values at props[4:]).
    """
    objects = root.first("Objects")
    if objects is None:
        return
    pre70 = version < 7000
    for node in objects.children:
        if pre70 and node.props and isinstance(node.props[0], str) \
                and "::" in node.props[0]:
            node.props = [node.props[0]] + list(node.props)
        if len(node.props) > 1 and isinstance(node.props[1], str) \
                and "::" in node.props[1]:
            node.props[1] = node.props[1].split("::", 1)[1]
        p60 = node.first("Properties60")
        if p60 is not None:
            p60.name = "Properties70"
            for pn in p60.children:
                if pn.name == "Property":
                    pn.name = "P"
                    pn.props = [pn.props[0], pn.props[1], "",
                                pn.props[2] if len(pn.props) > 2 else ""] \
                        + list(pn.props[3:])
    conns = root.first("Connections")
    if conns is not None and pre70:
        for c in conns.children:
            if c.name == "Connect":
                c.name = "C"
                c.props = [c.props[0]] + [
                    0 if p == "Model::Scene" else p for p in c.props[1:]]


def _euler_xyz_deg_to_quat(rx, ry, rz):
    """FBX default rotation order XYZ (applied as Rx then Ry then Rz in world:
    matrix Rz·Ry·Rx... FBX eEulerXYZ means M = Rx·Ry·Rz with row-vector
    convention = Rz·Ry·Rx column convention)."""
    import math

    def axis_q(a, ax):
        q = [0.0, 0.0, 0.0, math.cos(a / 2)]
        q[ax] = math.sin(a / 2)
        return np.asarray(q)

    def qmul(a, b):
        x1, y1, z1, w1 = a
        x2, y2, z2, w2 = b
        return np.asarray([
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        ])

    import math
    r = [math.radians(v) for v in (rx, ry, rz)]
    return qmul(axis_q(r[2], 2), qmul(axis_q(r[1], 1), axis_q(r[0], 0)))


def _layer_scalar(layer, name, default=""):
    node = layer.first(name)
    if node is None or not node.props:
        return default
    v = node.props[0]
    if isinstance(v, bytes):
        v = v.decode("utf-8", "replace")
    return v


def _extract_uvs(geom, faces, corner_faces):
    """LayerElementUV → (texcoords (T, 2) f32, texcoord_faces (F, 3) i32).

    Handles the two FBX addressing axes (mesh.h:51-55 target layout):
    MappingInformationType ByVertice/ByControlPoint (one UV slot per control
    point) vs ByPolygonVertex (one slot per polygon corner), each crossed
    with ReferenceInformationType Direct (slot IS the UV row) vs
    IndexToDirect (slot indexes UVIndex). Returns (None, None) when the
    geometry has no UV layer — Mesh.texcoords stays unset, matching the
    reference loader's optional texcoords (openfbx_loader.cpp mesh walk).
    """
    layer = geom.first("LayerElementUV")
    if layer is None:
        return None, None
    uv_node = layer.first("UV")
    if uv_node is None or not uv_node.props or len(uv_node.props[0]) == 0:
        return None, None
    uv = np.asarray(uv_node.props[0], np.float32).reshape(-1, 2)
    mapping = _layer_scalar(layer, "MappingInformationType")
    ref = _layer_scalar(layer, "ReferenceInformationType", "Direct")
    idx_node = layer.first("UVIndex")
    uvindex = None
    if idx_node is not None and idx_node.props and len(idx_node.props[0]):
        uvindex = np.asarray(idx_node.props[0], np.int64)

    if mapping in ("ByVertice", "ByVertex", "ByControlPoint"):
        if ref == "IndexToDirect" and uvindex is not None:
            per_vertex = uvindex
        else:
            per_vertex = np.arange(uv.shape[0], dtype=np.int64)
        tf = per_vertex[faces.astype(np.int64)]
    elif mapping == "ByPolygonVertex":
        if ref == "IndexToDirect" and uvindex is not None:
            per_corner = uvindex
        else:
            per_corner = np.arange(uv.shape[0], dtype=np.int64)
        tf = per_corner[corner_faces]
    elif mapping == "AllSame":
        tf = np.zeros_like(faces, dtype=np.int64)
    else:
        return None, None
    if tf.size and int(tf.max()) >= uv.shape[0]:
        return None, None  # malformed indices: drop the layer, keep the mesh
    return uv, tf.astype(np.int32)


def load_fbx(path, strip_namespaces: bool = True, device="cuda"):
    """→ Character (skeleton + optional skinned mesh) on `device` (the card
    unless the caller asks for the CPU). `path` is a path or the file's
    bytes. `strip_namespaces` drops FBX "ns:" prefixes from joint names
    (character_pybind.cpp:743, default true like the reference loader)."""
    character, _ctx = _load_fbx_impl(path, strip_namespaces, resolve(device, "load_fbx"))
    return character


def _fan_triangulate(poly):
    """PolygonVertexIndex (end-of-polygon bitwise complement) → (faces
    (F, 3) int32, the corners' positions in `poly` (F, 3) int64)."""
    faces, corner_faces = [], []
    start = 0
    for k, idx in enumerate(poly):
        if idx < 0:
            ring = list(poly[start:k]) + [-idx - 1]
            corners = list(range(start, k + 1))
            for t in range(1, len(ring) - 1):
                faces.append([ring[0], ring[t], ring[t + 1]])
                corner_faces.append([corners[0], corners[t], corners[t + 1]])
            start = k + 1
    return np.asarray(faces, np.int32), np.asarray(corner_faces, np.int64)


def _load_fbx_impl(path, strip_namespaces: bool, device):
    from momentum_tpu_torch.character import (
        Character, Mesh, SkinWeights, make_empty_limits, make_skeleton)
    from momentum_tpu_torch.character.parameter_transform import make_identity_transform

    from momentum_tpu_torch.io.gltf import _read_binary_source

    root, _version = _parse(_read_binary_source(path))  # a path or bytes (:744)

    objects = None
    connections = None
    for c in root.children:
        if c.name == "Objects":
            objects = c
        elif c.name == "Connections":
            connections = c
    if objects is None:
        raise ValueError("FBX: no Objects section")

    models = {}
    geoms = {}
    clusters = {}
    anim_curves = {}
    anim_curve_nodes = {}
    for node in objects.children:
        if node.name == "AnimationCurve":
            anim_curves[node.props[0]] = node
        elif node.name == "AnimationCurveNode":
            anim_curve_nodes[node.props[0]] = node
        elif node.name == "Model":
            models[node.props[0]] = (node, node.props[2] if len(node.props) > 2 else "")
        elif node.name == "Geometry":
            geoms[node.props[0]] = node
        elif node.name == "Deformer":
            if (node.props[2] if len(node.props) > 2 else "") == "Cluster":
                clusters[node.props[0]] = node

    # connections: child -> parent (OO); OP links carry the target property
    parent_of = {}
    links = []  # (src, dst)
    op_links = []  # (src, dst, property)
    if connections is not None:
        for c in connections.children:
            if c.name == "C" and len(c.props) >= 3 and c.props[0] == "OO":
                src, dst = c.props[1], c.props[2]
                links.append((src, dst))
                if src in models and (dst in models or dst == 0):
                    parent_of[src] = dst
            elif c.name == "C" and len(c.props) >= 4 and c.props[0] == "OP":
                op_links.append((c.props[1], c.props[2], c.props[3]))

    # joints = models whose type is LimbNode/Root/Null reachable in hierarchy
    joint_types = {"LimbNode", "Root", "Null", "Skeleton"}
    joint_uids = [uid for uid, (_, t) in models.items() if t in joint_types]
    if not joint_uids:
        joint_uids = list(models.keys())
    joint_set = set(joint_uids)

    # topological order: parents before children
    order = []
    seen = set()

    def visit(uid):
        if uid in seen or uid not in joint_set:
            return
        p = parent_of.get(uid, 0)
        if p in joint_set:
            visit(p)
        seen.add(uid)
        order.append(uid)

    for uid in joint_uids:
        visit(uid)

    uid_to_idx = {u: i for i, u in enumerate(order)}
    names, parents, pre, offs = [], [], [], []
    rest_rot, rest_scale = [], []
    phys_json = {}  # joint index → JSON string (openfbx_loader.cpp:138-143)
    for uid in order:
        node, _ = models[uid]
        raw_name = node.props[1] if len(node.props) > 1 else f"j{uid}"
        name = raw_name.split("\x00")[0] or f"j{uid}"
        if strip_namespaces and ":" in name:
            name = name.rsplit(":", 1)[1] or name
        names.append(name)
        parents.append(uid_to_idx.get(parent_of.get(uid, 0), -1))
        t = [0.0, 0.0, 0.0]
        r = [0.0, 0.0, 0.0]
        pr = [0.0, 0.0, 0.0]
        sc = [1.0, 1.0, 1.0]
        p70 = node.first("Properties70")
        if p70 is not None:
            for pn in p70.children:
                key = pn.props[0] if pn.props else ""
                if key == "Lcl Translation":
                    t = [float(x) for x in pn.props[4:7]]
                elif key == "Lcl Rotation":
                    r = [float(x) for x in pn.props[4:7]]
                elif key == "PreRotation":
                    pr = [float(x) for x in pn.props[4:7]]
                elif key == "Lcl Scaling":
                    sc = [float(x) for x in pn.props[4:7]]
                elif key == "physicalProperties" and len(pn.props) > 4:
                    # custom string user property carrying the mass-body JSON
                    v = pn.props[4]
                    if isinstance(v, bytes):
                        v = v.decode("utf-8", "replace")
                    if isinstance(v, str):
                        phys_json[len(names) - 1] = v
        rest_rot.append(r)
        rest_scale.append(sc[0])
        x1, y1, z1, w1 = _euler_xyz_deg_to_quat(*pr)
        x2, y2, z2, w2 = _euler_xyz_deg_to_quat(*r)
        pre.append([
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        ])
        offs.append(t)

    skeleton = make_skeleton(parents, np.asarray(pre), np.asarray(offs), names, device=device)

    physical_properties = None
    if phys_json:
        import json

        from momentum_tpu_torch.io._physical import body_from_json, rows_to_physical_properties

        rows = []
        for j, s in sorted(phys_json.items()):
            try:
                rows.append((j,) + body_from_json(json.loads(s)) + (names[j],))
            except (ValueError, TypeError, KeyError, IndexError):
                continue  # malformed entries skipped (openfbx_loader.cpp:133-136)
        physical_properties = rows_to_physical_properties(rows, device)

    def on(a):
        return None if a is None else torch.as_tensor(a, device=device)

    # mesh: first geometry
    mesh = None
    skin_weights = None
    if geoms:
        g = next(iter(geoms.values()))
        v_node = g.first("Vertices")
        i_node = g.first("PolygonVertexIndex")
        if v_node is not None and i_node is not None:
            verts = np.asarray(v_node.props[0], np.float32).reshape(-1, 3)
            faces, corner_faces = _fan_triangulate(np.asarray(i_node.props[0], np.int64))
            texcoords, texcoord_faces = _extract_uvs(g, faces, corner_faces)
            mesh = Mesh(vertices=on(verts), faces=on(faces), texcoords=on(texcoords),
                        texcoord_faces=on(texcoord_faces))

            # skinning via clusters: every joint's influence, the top 8 kept
            v = verts.shape[0]
            acc = np.zeros((v, len(order)), np.float32)
            cluster_joint = {}
            for (src, dst) in links:
                if src in models and dst in clusters and src in uid_to_idx:
                    cluster_joint[dst] = uid_to_idx[src]
            for cuid, cl in clusters.items():
                j = cluster_joint.get(cuid)
                if j is None:
                    continue
                idx_node = cl.first("Indexes")
                w_node = cl.first("Weights")
                if idx_node is None or w_node is None:
                    continue
                vi = np.asarray(idx_node.props[0], np.int64)
                wv = np.asarray(w_node.props[0], np.float64)
                ok = vi < v
                acc[vi[ok], j] += wv[ok].astype(np.float32)
            if acc.any():
                top = np.argsort(-acc, axis=1)[:, :8]
                w8 = np.take_along_axis(acc, top, axis=1)
                norm = w8.sum(axis=1, keepdims=True)
                w8 = np.where(norm > 0, w8 / np.maximum(norm, 1e-12), 0.0)
                skin_weights = SkinWeights(index=on(top.astype(np.int32)),
                                           weight=on(w8.astype(np.float32)))

    character = Character(
        skeleton=skeleton,
        parameter_transform=make_identity_transform(skeleton.num_joints, device=device),
        limits=make_empty_limits(device=device), mesh=mesh, skin_weights=skin_weights,
        physical_properties=physical_properties)
    if mesh is not None and skin_weights is not None:
        character = character.with_inverse_bind_pose()
    ctx = dict(
        uid_to_idx=uid_to_idx, op_links=op_links, anim_curves=anim_curves,
        anim_curve_nodes=anim_curve_nodes, rest_rot=np.asarray(rest_rot),
        rest_scale=np.asarray(rest_scale),
        translation_offset=np.asarray(offs, np.float64),
    )
    return character, ctx


_KTIME_PER_SECOND = 46186158000.0  # FBX KTime ticks per second


def _curve_channels(ctx, curve_node_uid):
    """dict axis('X'/'Y'/'Z') → (times_sec, values) for one AnimationCurveNode."""
    out = {}
    for (src, dst, prop) in ctx["op_links"]:
        if dst != curve_node_uid or src not in ctx["anim_curves"]:
            continue
        axis = prop.split("|")[-1].strip("\x00 ")
        cur = ctx["anim_curves"][src]
        tnode = cur.first("KeyTime")
        vnode = cur.first("KeyValueFloat")
        if tnode is None or vnode is None:
            continue
        times = np.asarray(tnode.props[0], np.float64) / _KTIME_PER_SECOND
        vals = np.asarray(vnode.props[0], np.float64)
        if times.size:
            out[axis] = (times, vals)
    return out


def _curve_defaults(node):
    """AnimationCurveNode Properties70 d|X/d|Y/d|Z defaults."""
    d = {"X": 0.0, "Y": 0.0, "Z": 0.0}
    p70 = node.first("Properties70")
    if p70 is not None:
        for pn in p70.children:
            key = (pn.props[0] if pn.props else "").strip("\x00")
            if key in ("d|X", "d|Y", "d|Z") and len(pn.props) >= 5:
                d[key[-1]] = float(pn.props[4])
    return d


def load_fbx_with_motion(path, fps: float = 120.0, strip_namespaces: bool = True,
                         device="cuda"):
    """→ (Character, motion (F, nJ·7) float32, fps) on `device` (the card
    unless the caller asks for the CPU).

    Reference: io/fbx/fbx_io.h:49-63 loadFbxCharacterWithMotion +
    openfbx_loader.cpp:1087-1210 — sample the Lcl Translation / Lcl Rotation /
    Lcl Scaling animation curves at `fps` with linear interpolation into
    7-per-joint parameters: translation minus the rest translationOffset,
    rotation Euler XYZ degrees→radians, uniform scale stored log2. Channels
    without curves keep the rest pose (rotation/scale only — rest translation
    lives in the skeleton's translationOffset). The curves are sampled in
    float64 on the host and cast to float32 there, momentum_tpu's bits; the
    finished motion moves to `device` once.
    """
    device = resolve(device, "load_fbx_with_motion")
    character, ctx = _load_fbx_impl(path, strip_namespaces, device)
    nj = character.skeleton.num_joints
    uid_to_idx = ctx["uid_to_idx"]

    # gather (joint, mode, curve_node) with mode 0=T 1=R 2=S
    tracks = []
    t_max = 0.0
    for (src, dst, prop) in ctx["op_links"]:
        if src not in ctx["anim_curve_nodes"] or dst not in uid_to_idx:
            continue
        mode = {"Lcl Translation": 0, "Lcl Rotation": 1,
                "Lcl Scaling": 2}.get(prop.strip("\x00 "))
        if mode is None:
            continue
        chans = _curve_channels(ctx, src)
        for times, _ in chans.values():
            t_max = max(t_max, float(times[-1]))
        tracks.append((uid_to_idx[dst], mode, _curve_defaults(ctx["anim_curve_nodes"][src]),
                       chans))

    num_frames = int(np.ceil(t_max * fps)) + 1
    motion = np.zeros((num_frames, nj * 7), np.float32)
    # rest fill (openfbx_loader.cpp:1121-1136): rotations + log2 scale
    motion[:, 3::7] = np.deg2rad(ctx["rest_rot"][:, 0])
    motion[:, 4::7] = np.deg2rad(ctx["rest_rot"][:, 1])
    motion[:, 5::7] = np.deg2rad(ctx["rest_rot"][:, 2])
    motion[:, 6::7] = np.log2(np.maximum(ctx["rest_scale"], 1e-12))

    sample_t = np.arange(num_frames, dtype=np.float64) / fps
    for (j, mode, defaults, chans) in tracks:
        vals = np.empty((num_frames, 3), np.float64)
        for a, axis in enumerate("XYZ"):
            if axis in chans:
                times, v = chans[axis]
                vals[:, a] = np.interp(sample_t, times, v)
            else:
                vals[:, a] = defaults[axis]
        base = j * 7
        if mode == 0:
            motion[:, base:base + 3] = (
                vals - ctx["translation_offset"][j][None, :]).astype(np.float32)
        elif mode == 1:
            motion[:, base + 3:base + 6] = np.deg2rad(vals).astype(np.float32)
        else:
            motion[:, base + 6] = np.log2(np.maximum(vals.mean(axis=1), 1e-12)).astype(np.float32)
    return character, torch.as_tensor(motion, device=device), float(fps)

"""USD IO: UsdSkel characters + motion as .usda text and .usdc crate binary.

Reference capability: momentum/io/usd/usd_io.{h,cpp} (loadUsdCharacter /
saveUsd through the pxr runtime), usd_skeleton_io.cpp (Skeleton prim,
topology derived from '/'-separated joint paths, restTransforms preferred
over world bindTransforms:127-215; locator + collision custom prims with
momentum:* attributes:260-470), usd_mesh_io.cpp (points / faceVertex* /
primvars:st / skin primvars with elementSize influences, top-8 kept:218-265),
usd_io.cpp:196-240 (momentum metadata: parameter transform / limits as JSON
attributes on the SkelRoot), usd_animation_io.cpp:40-87 (SkelAnimation joint
transforms + momentum:motion:* model-parameter attributes).

The UsdSkel schema is implemented directly over a small prim/attribute
document model, as momentum_tpu/io/usd.py does, with no pxr runtime:

- `.usda` text: full parser + writer.
- `.usdc`: the crate binary, written and read by io/usdc_crate.py in the
  public crate layout (version 0.2.0). Files of the earlier private
  container (version 0.0.1) remain readable.

Files are parsed and written on the host. The loaders build the character
(and its motion and skeleton states) on `device`, the card unless the
caller asks for the CPU: every table is built on the host and moved once,
and skeleton states come from one batched FK over every frame (kernel K1
on the card). The writers take characters and motions on any device; the
rest and bind poses and the motion's local transforms are computed on the
character's device.

Entry points: save_usd / load_usd dispatch on extension; save_usda /
load_usda keep their original signatures.
"""

from __future__ import annotations

import dataclasses
import json
import re
import struct

import numpy as np
import torch

from momentum_tpu_torch.device import resolve, to_host

__all__ = [
    "save_usd", "load_usd", "save_usda", "load_usda",
    "Prim", "Attr", "parse_usda", "write_usda",
    "write_usdc", "read_usdc",
    # pymomentum io_usd binding surface
    "is_usd_available", "load_character", "load_character_from_bytes",
    "load_character_with_motion", "load_character_with_motion_from_bytes",
    "load_character_with_skel_states",
    "load_character_with_skel_states_from_bytes",
    "save_character", "save_character_from_skel_states",
]


# --------------------------------------------------------------------------
# document model
# --------------------------------------------------------------------------

@dataclasses.dataclass
class Attr:
    name: str
    type: str  # usda type string, e.g. "matrix4d[]", "token", "float[]"
    value: object = None
    meta: dict = dataclasses.field(default_factory=dict)
    time_samples: dict = dataclasses.field(default_factory=dict)
    uniform: bool = False


@dataclasses.dataclass
class Prim:
    name: str
    type: str = ""  # e.g. "SkelRoot", "Skeleton", "Mesh", "" for plain def
    meta: dict = dataclasses.field(default_factory=dict)
    attrs: dict = dataclasses.field(default_factory=dict)
    children: list = dataclasses.field(default_factory=list)

    def attr(self, name, default=None):
        a = self.attrs.get(name)
        return a.value if a is not None else default

    def find(self, prim_type):
        """Depth-first search for all prims of a type."""
        out = []
        if self.type == prim_type:
            out.append(self)
        for c in self.children:
            out.extend(c.find(prim_type))
        return out

    def walk(self):
        yield self
        for c in self.children:
            yield from c.walk()


@dataclasses.dataclass
class Stage:
    meta: dict = dataclasses.field(default_factory=dict)
    roots: list = dataclasses.field(default_factory=list)

    def walk(self):
        for r in self.roots:
            yield from r.walk()

    def find(self, prim_type):
        out = []
        for r in self.roots:
            out.extend(r.find(prim_type))
        return out


# --------------------------------------------------------------------------
# .usda tokenizer / parser
# --------------------------------------------------------------------------

_TOKEN_RE = re.compile(r"""
      "(?:[^"\\]|\\.)*"        # quoted string
    | @[^@]*@                  # asset path
    | <[^>]*>                  # prim path reference (rel / .connect targets)
    | [A-Za-z_][\w:.]*         # identifier (incl. namespaced a:b.c)
    | -?\d+\.?\d*(?:[eE][-+]?\d+)?   # number
    | \.\w+                    # .connect-style suffix
    | [=\[\]{}(),;:]           # punctuation (incl. timeSamples-dict colon)
""", re.X)


def _tokenize(text):
    # strip comments (# to end of line, outside strings)
    out = []
    for m in re.finditer(r'"(?:[^"\\]|\\.)*"|@[^@]*@|#[^\n]*|[^"#@]+', text):
        tok = m.group(0)
        if tok.startswith("#"):
            continue
        if tok.startswith('"') or tok.startswith("@"):
            out.append(tok)
        else:
            out.extend(_TOKEN_RE.findall(tok))
    return out


class _Parser:
    def __init__(self, tokens):
        self.toks = tokens
        self.i = 0

    def peek(self, k=0):
        j = self.i + k
        return self.toks[j] if j < len(self.toks) else None

    def next(self):
        t = self.peek()
        self.i += 1
        return t

    def expect(self, t):
        got = self.next()
        if got != t:
            raise ValueError(f"usda parse: expected {t!r}, got {got!r} @ {self.i}")
        return got

    # -- values ------------------------------------------------------------
    def parse_value(self):
        t = self.peek()
        if t == "[":
            return self.parse_list()
        if t == "(":
            return self.parse_tuple()
        if t == "{":
            return self.parse_dict()
        t = self.next()
        if t is None:
            raise ValueError("usda parse: unexpected EOF in value")
        if t.startswith('"'):
            return _unquote(t)
        if t.startswith("@") or t.startswith("<"):
            return t[1:-1]
        if t in ("true", "false"):
            return t == "true"
        if t == "None":
            return None
        try:
            return int(t)
        except ValueError:
            pass
        try:
            return float(t)
        except ValueError:
            return t  # bare token (e.g. enum-ish identifiers)

    def parse_list(self):
        self.expect("[")
        items = []
        while self.peek() != "]":
            items.append(self.parse_value())
            if self.peek() == ",":
                self.next()
        self.expect("]")
        return items

    def parse_tuple(self):
        self.expect("(")
        items = []
        while self.peek() != ")":
            items.append(self.parse_value())
            if self.peek() == ",":
                self.next()
        self.expect(")")
        return tuple(items)

    def parse_dict(self):
        self.expect("{")
        d = {}
        while self.peek() != "}":
            key = self.parse_value()
            self.expect(":")
            d[key] = self.parse_value()
            if self.peek() == ",":
                self.next()
            if self.peek() == ";":
                self.next()
        self.expect("}")
        return d

    # -- metadata blocks ---------------------------------------------------
    def parse_meta_block(self):
        """( key = value ... ) — also swallows `prepend apiSchemas = [...]`
        and doc strings."""
        meta = {}
        self.expect("(")
        while self.peek() != ")":
            t = self.next()
            if t in ("prepend", "append", "add", "delete", "uniform", "custom"):
                continue
            if t.startswith('"'):
                meta.setdefault("doc", _unquote(t))
                continue
            if self.peek() == "=":
                self.next()
                meta[t] = self.parse_value()
            # else: stray token (qualifier) — skip
        self.expect(")")
        return meta

    # -- prims / attributes --------------------------------------------------
    def parse_stage(self):
        stage = Stage()
        if self.peek() == "(":
            stage.meta = self.parse_meta_block()
        while self.peek() is not None:
            stage.roots.append(self.parse_prim())
        return stage

    def parse_prim(self):
        kw = self.next()
        if kw not in ("def", "over", "class"):
            raise ValueError(f"usda parse: expected prim keyword, got {kw!r}")
        ptype = ""
        t = self.next()
        if not t.startswith('"'):
            ptype = t
            t = self.next()
        name = _unquote(t)
        prim = Prim(name=name, type=ptype)
        if self.peek() == "(":
            prim.meta = self.parse_meta_block()
        self.expect("{")
        while self.peek() != "}":
            if self.peek() in ("def", "over", "class"):
                prim.children.append(self.parse_prim())
            else:
                self.parse_attr_into(prim)
        self.expect("}")
        return prim

    def parse_attr_into(self, prim):
        uniform = False
        t = self.next()
        while t in ("uniform", "custom", "varying", "prepend", "append", "delete"):
            uniform = uniform or (t == "uniform")
            t = self.next()
        atype = t
        if self.peek() == "[" and self.peek(1) == "]":
            self.next()
            self.next()
            atype += "[]"
        name = self.next()
        # e.g. transforms.timeSamples
        is_ts = False
        if name.endswith(".timeSamples"):
            name = name[: -len(".timeSamples")]
            is_ts = True
        elif self.peek() == ".timeSamples":
            self.next()
            is_ts = True
        attr = prim.attrs.get(name) or Attr(name=name, type=atype, uniform=uniform)
        if self.peek() == "=":
            self.next()
            val = self.parse_value()
            if is_ts:
                attr.time_samples = val
            else:
                attr.value = val
        if self.peek() == "(":
            attr.meta.update(self.parse_meta_block())
        prim.attrs[name] = attr


def _unquote(t):
    if t.startswith('"""'):
        return t[3:-3]
    if t.startswith('"'):
        body = t[1:-1]
        return body.replace('\\"', '"').replace("\\\\", "\\")
    return t


def parse_usda(text) -> Stage:
    return _Parser(_tokenize(text)).parse_stage()


# --------------------------------------------------------------------------
# .usda writer
# --------------------------------------------------------------------------

def _fmt_value(v):
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, str):
        return '"' + v.replace("\\", "\\\\").replace('"', '\\"') + '"'
    if isinstance(v, (int, np.integer)):
        return str(int(v))
    if isinstance(v, (float, np.floating)):
        return f"{float(v):.8g}"
    if isinstance(v, tuple):
        return "(" + ", ".join(_fmt_value(x) for x in v) + ")"
    if isinstance(v, (list, np.ndarray)):
        return "[" + ", ".join(_fmt_value(x) for x in _aslist(v)) + "]"
    if isinstance(v, dict):
        return "{" + ", ".join(f"{_fmt_value(k)}: {_fmt_value(x)}"
                               for k, x in v.items()) + "}"
    if v is None:
        return "None"
    return str(v)


def _aslist(v):
    if isinstance(v, np.ndarray):
        return [tuple(r) if r.ndim else r.item() for r in
                (v if v.ndim <= 1 else list(v))] if v.ndim <= 2 else [
                    tuple(map(tuple, m)) for m in v]
    return v


def _write_prim(prim, lines, indent):
    pad = "    " * indent
    head = f"{pad}def {prim.type} \"{prim.name}\"" if prim.type else \
        f"{pad}def \"{prim.name}\""
    if prim.meta:
        lines.append(head + " (")
        for k, v in prim.meta.items():
            if k == "apiSchemas":
                lines.append(f"{pad}    prepend apiSchemas = {_fmt_value(v)}")
            else:
                lines.append(f"{pad}    {k} = {_fmt_value(v)}")
        lines.append(pad + ")")
    else:
        lines.append(head)
    lines.append(pad + "{")
    for attr in prim.attrs.values():
        q = "uniform " if attr.uniform else ""
        decl = f"{pad}    {q}{attr.type} {attr.name}"
        meta = ""
        if attr.meta:
            meta = " (" + ", ".join(
                f"{k} = {_fmt_value(v)}" for k, v in attr.meta.items()) + ")"
        if attr.time_samples:
            lines.append(decl + ".timeSamples = {")
            for k in sorted(attr.time_samples):
                lines.append(f"{pad}        {k}: "
                             f"{_fmt_value(attr.time_samples[k])},")
            lines.append(pad + "    }" + meta)
        elif attr.value is None and not attr.meta:
            lines.append(decl)
        else:
            lines.append(decl + f" = {_fmt_value(attr.value)}" + meta)
    for child in prim.children:
        _write_prim(child, lines, indent + 1)
    lines.append(pad + "}")


def write_usda(stage: Stage) -> str:
    lines = ["#usda 1.0"]
    if stage.meta:
        lines.append("(")
        for k, v in stage.meta.items():
            lines.append(f"    {k} = {_fmt_value(v)}")
        lines.append(")")
    for prim in stage.roots:
        lines.append("")
        _write_prim(prim, lines, 0)
    return "\n".join(lines) + "\n"


# --------------------------------------------------------------------------
# .usdc crate container: public-layout encode/decode lives in usdc_crate.py.
# Below: the version-dispatching entry points plus the decoder of the
# earlier private container (version 0.0.1), kept for old files.
# --------------------------------------------------------------------------

_USDC_IDENT = b"PXR-USDC"


def _unpack_value(buf, pos):
    tag = buf[pos:pos + 1]
    pos += 1
    if tag == b"b":
        return bool(buf[pos]), pos + 1
    if tag == b"i":
        return struct.unpack_from("<q", buf, pos)[0], pos + 8
    if tag == b"d":
        return struct.unpack_from("<d", buf, pos)[0], pos + 8
    if tag == b"s":
        n = struct.unpack_from("<I", buf, pos)[0]
        pos += 4
        return buf[pos:pos + n].decode(), pos + n
    if tag in (b"t", b"l"):
        n = struct.unpack_from("<I", buf, pos)[0]
        pos += 4
        items = []
        for _ in range(n):
            x, pos = _unpack_value(buf, pos)
            items.append(x)
        return (tuple(items) if tag == b"t" else items), pos
    if tag == b"m":
        n = struct.unpack_from("<I", buf, pos)[0]
        pos += 4
        d = {}
        for _ in range(n):
            k, pos = _unpack_value(buf, pos)
            x, pos = _unpack_value(buf, pos)
            d[k] = x
        return d, pos
    if tag == b"n":
        return None, pos
    raise ValueError(f"usdc: bad value tag {tag!r} @ {pos - 1}")



def write_usdc(stage: Stage, path) -> None:
    """Serialize the stage as a crate file (public layout, version 0.2.0 —
    see io/usdc_crate.py for the encoding)."""
    from momentum_tpu_torch.io.usdc_crate import write_crate

    write_crate(stage, path)



def read_usdc(path) -> Stage:
    if isinstance(path, bytes):
        buf = path
    else:
        with open(path, "rb") as f:
            buf = f.read()
    if buf[:8] != _USDC_IDENT:
        raise ValueError("not a usdc file (bad ident)")
    if tuple(buf[8:11]) >= (0, 1, 0):
        from momentum_tpu_torch.io.usdc_crate import read_crate

        return read_crate(buf)
    return _read_usdc_legacy(buf)


def _read_usdc_legacy(buf) -> Stage:
    toc_off = struct.unpack_from("<q", buf, 16)[0]
    nsec = struct.unpack_from("<q", buf, toc_off)[0]
    secs = {}
    pos = toc_off + 8
    for _ in range(nsec):
        name = buf[pos:pos + 16].rstrip(b"\0").decode()
        start, size = struct.unpack_from("<qq", buf, pos + 16)
        secs[name] = buf[start:start + size]
        pos += 32

    tsec = secs["TOKENS"]
    ntok = struct.unpack_from("<q", tsec, 0)[0]
    tokens = tsec[8:].split(b"\0")[:ntok]
    tokens = [t.decode() for t in tokens]

    fsec = secs["FIELDS"]
    nf = struct.unpack_from("<q", fsec, 0)[0]
    fields = []
    pos = 8
    for _ in range(nf):
        ln = struct.unpack_from("<I", fsec, pos)[0]
        pos += 4
        fields.append(fsec[pos:pos + ln])
        pos += ln

    ssec = secs["SPECS"]
    ns = struct.unpack_from("<q", ssec, 0)[0]
    prims = []
    stage = Stage()
    pos = 8
    for _ in range(ns):
        name_t, type_t, parent, meta_f, attrs_f = struct.unpack_from(
            "<IIiii", ssec, pos)
        pos += 20
        meta, _ = _unpack_value(fields[meta_f], 0)
        attrs_list, _ = _unpack_value(fields[attrs_f], 0)
        prim = Prim(name=tokens[name_t], type=tokens[type_t], meta=meta)
        for a in attrs_list:
            prim.attrs[a["name"]] = Attr(
                name=a["name"], type=a["type"], value=a["value"],
                meta=a["meta"], time_samples=a["timeSamples"],
                uniform=a["uniform"])
        prims.append(prim)
        if parent < 0:
            stage.roots.append(prim)
        else:
            prims[parent].children.append(prim)
    stage_meta_f = struct.unpack_from("<i", ssec, pos)[0]
    stage.meta, _ = _unpack_value(fields[stage_meta_f], 0)
    return stage


# --------------------------------------------------------------------------
# Character <-> stage
# --------------------------------------------------------------------------

_MAX_SKIN = 8


def _matrices(m: torch.Tensor) -> list:
    """(..., 4, 4) column-vector matrices → USD's row-vector convention
    (transposed), float64 on the host, as nested tuples."""
    usd = np.swapaxes(to_host(m), -1, -2).astype(np.float64)
    return [tuple(map(tuple, x)) for x in usd.reshape(-1, 4, 4)]


def _character_to_stage(character, motion=None, fps=24.0) -> Stage:
    """The character's stage. The rest locals, the bind pose (FK, K1 on the
    card) and a motion's per-frame local transforms are computed on the
    character's device, every frame in one batched call."""
    from momentum_tpu_torch.character import fk
    from momentum_tpu_torch.math import skel_state as ss

    skel = character.skeleton
    nj = skel.num_joints
    parents = skel.parents_np
    names = list(skel.joint_names)
    paths = _joint_paths(names, parents)
    dev = skel.translation_offset.device

    rest_local = ss.to_matrix(fk.local_skel_states(
        skel, torch.zeros(nj * 7, dtype=torch.float32, device=dev)))
    skeleton_prim = Prim(name="Skel", type="Skeleton", attrs={
        "joints": Attr("joints", "token[]", list(paths), uniform=True),
        "bindTransforms": Attr("bindTransforms", "matrix4d[]",
                               _matrices(ss.to_matrix(character.bind_pose())), uniform=True),
        "restTransforms": Attr("restTransforms", "matrix4d[]", _matrices(rest_local),
                               uniform=True),
    })

    if motion is not None:
        motion = torch.as_tensor(motion, dtype=torch.float32).to(dev)
        jp = character.parameter_transform.apply(motion)
        locals_usd = _matrices(ss.to_matrix(fk.local_skel_states(skel, jp)))
        ts = {i: locals_usd[i * nj:(i + 1) * nj] for i in range(motion.shape[0])}
        anim = Prim(name="Anim", type="SkelAnimation", attrs={
            "joints": Attr("joints", "token[]", list(paths), uniform=True),
            "transforms": Attr("transforms", "matrix4d[]", time_samples=ts),
            # lossless momentum motion (usd_animation_io.cpp:40-50)
            "momentum:motion:parameterNames": Attr(
                "momentum:motion:parameterNames", "string[]",
                list(character.parameter_transform.names)),
            "momentum:motion:poses": Attr(
                "momentum:motion:poses", "float[]", to_host(motion).reshape(-1).tolist()),
            "momentum:motion:numFrames": Attr(
                "momentum:motion:numFrames", "int", int(motion.shape[0])),
            "momentum:motion:numParams": Attr(
                "momentum:motion:numParams", "int", int(motion.shape[1])),
        })
        skeleton_prim.children.append(anim)

    root = Prim(name="Root", type="SkelRoot", children=[skeleton_prim])

    # momentum metadata (usd_io.cpp:196-240): parameter transform as JSON
    pt = character.parameter_transform
    pt_json = {
        "names": list(pt.names),
        "transform": to_host(pt.transform).tolist(),
        "offsets": to_host(pt.offsets).tolist(),
    }
    root.attrs["momentum:parameterTransform"] = Attr(
        "momentum:parameterTransform", "string", json.dumps(pt_json))
    if character.name:
        root.attrs["momentum:characterName"] = Attr(
            "momentum:characterName", "string", character.name)

    if character.mesh is not None:
        mesh = character.mesh
        v = to_host(mesh.vertices)
        fc = to_host(mesh.faces)
        mesh_prim = Prim(
            name="Body", type="Mesh",
            meta={"apiSchemas": ["SkelBindingAPI"]},
            attrs={
                "faceVertexCounts": Attr("faceVertexCounts", "int[]", [3] * fc.shape[0]),
                "faceVertexIndices": Attr("faceVertexIndices", "int[]",
                                          fc.reshape(-1).tolist()),
                "points": Attr("points", "point3f[]", [tuple(map(float, p)) for p in v]),
            })
        if mesh.texcoords is not None and mesh.texcoords.numel():
            mesh_prim.attrs["primvars:st"] = Attr(
                "primvars:st", "texCoord2f[]",
                [tuple(map(float, t)) for t in to_host(mesh.texcoords)],
                meta={"interpolation": "vertex"})
        if character.skin_weights is not None:
            si = to_host(character.skin_weights.index)
            sw = to_host(character.skin_weights.weight)
            k = si.shape[1]
            mesh_prim.attrs["primvars:skel:jointIndices"] = Attr(
                "primvars:skel:jointIndices", "int[]", si.reshape(-1).tolist(),
                meta={"elementSize": k, "interpolation": "vertex"})
            mesh_prim.attrs["primvars:skel:jointWeights"] = Attr(
                "primvars:skel:jointWeights", "float[]", sw.reshape(-1).tolist(),
                meta={"elementSize": k, "interpolation": "vertex"})
        root.children.append(mesh_prim)

    # locators as custom prims (usd_skeleton_io.cpp:400-445)
    if character.locators is not None and character.locators.parent.numel():
        loc = character.locators
        scope = Prim(name="Locators", type="Scope")
        lp, lo, lw = (to_host(a) for a in (loc.parent, loc.offset, loc.weight))
        for i in range(lp.shape[0]):
            lname = loc.names[i] if loc.names else f"locator_{i}"
            scope.children.append(Prim(name=_sanitize(f"{lname}_{i}"), attrs={
                "momentum:type": Attr("momentum:type", "string", "locator"),
                "momentum:name": Attr("momentum:name", "string", lname),
                "momentum:parent": Attr("momentum:parent", "string", names[int(lp[i])]),
                "momentum:offset": Attr("momentum:offset", "float3", tuple(map(float, lo[i]))),
                "momentum:weight": Attr("momentum:weight", "float", float(lw[i])),
            }))
        root.children.append(scope)

    # collision prims (usd_skeleton_io.cpp:260-300); tapered capsules
    if character.collision is not None and character.collision.parent.numel():
        col = character.collision
        scope = Prim(name="Collision", type="Scope")
        cp, ct, cr, cl = (to_host(a) for a in (col.parent, col.transform, col.radius,
                                               col.length))
        for i in range(cp.shape[0]):
            jname = names[int(cp[i])]
            scope.children.append(Prim(name=_sanitize(f"{jname}_col_{i}"), attrs={
                "momentum:type": Attr("momentum:type", "string", "collision_capsule"),
                "momentum:parent": Attr("momentum:parent", "string", jname),
                "momentum:length": Attr("momentum:length", "float", float(cl[i])),
                "momentum:radius": Attr("momentum:radius", "float2",
                                        (float(cr[i, 0]), float(cr[i, 1]))),
                "momentum:transform": Attr("momentum:transform", "float[]",
                                           [float(x) for x in ct[i]]),
            }))
        root.children.append(scope)

    # per-joint mass bodies (usd_io.cpp:241-270 savePhysicalPropertiesToUsd:
    # a PhysicalProperties scope, one prim per body with momentum:joint +
    # momentum:physicalProperties JSON, tokens at usd_io.cpp:89-90)
    pp = character.physical_properties
    if pp is not None and pp.num_bodies:
        from momentum_tpu_torch.io._physical import body_to_json

        scope = Prim(name="PhysicalProperties", type="Scope")
        pj, pm, pc, pi, pq = (to_host(a) for a in (pp.joint_index, pp.mass,
                                                   pp.center_of_mass_offset, pp.inertia,
                                                   pp.inertia_rotation))
        for b in range(pp.num_bodies):
            jname = pp.joint_names[b] if pp.joint_names else names[int(pj[b])]
            scope.children.append(Prim(name=_sanitize(f"{jname}_body_{b}"), attrs={
                "momentum:joint": Attr("momentum:joint", "string", jname),
                "momentum:physicalProperties": Attr(
                    "momentum:physicalProperties", "string",
                    json.dumps(body_to_json(pm[b], pc[b], pi[b], pq[b]))),
            }))
        root.children.append(scope)

    return Stage(
        meta={"defaultPrim": "Root", "metersPerUnit": 1, "upAxis": "Y",
              "timeCodesPerSecond": float(fps)},
        roots=[root])


def _sanitize(name):
    return re.sub(r"[^\w]", "_", name)


def _joint_paths(names, parents):
    paths = []
    for i, n in enumerate(names):
        if parents[i] < 0:
            paths.append(n)
        else:
            paths.append(paths[parents[i]] + "/" + n)
    return paths


def _mat_list(value):
    """attribute value (list of 4-tuples of 4-tuples) → (N, 4, 4) float."""
    return np.asarray([[list(row) for row in m] for m in value], np.float64)


def _stage_to_character(stage: Stage, device):
    """Stage → (Character on `device`, motion). Reference load semantics
    (usd_skeleton_io.cpp:127-215): topology from '/'-separated joint paths,
    restTransforms preferred as local, world bindTransforms fallback
    composed against the parent's inverse. The joints' rest rotations and
    offsets are taken from the local matrices on the host, all joints at
    once in float32; motion is (F, P) model parameters on `device` when the
    file carries momentum metadata, else (F, nJ, 4, 4) joint-local matrices
    (float64 numpy), else None."""
    from momentum_tpu_torch.character import (
        Character, CollisionGeometry, Locators, Mesh, SkinWeights, make_empty_limits,
        make_skeleton)
    from momentum_tpu_torch.character.parameter_transform import (
        ParameterTransform, make_identity_transform)
    from momentum_tpu_torch.io._physical import body_from_json, rows_to_physical_properties
    from momentum_tpu_torch.math import skel_state as ss

    skels = stage.find("Skeleton")
    if not skels:
        raise ValueError("no Skeleton prim found")
    skel_prim = skels[0]

    paths = [str(p) for p in skel_prim.attr("joints", [])]
    names = [p.split("/")[-1] for p in paths]
    nj = len(names)
    path_idx = {p: i for i, p in enumerate(paths)}
    parents = []
    for p in paths:
        parent_path = "/".join(p.split("/")[:-1])
        parents.append(path_idx.get(parent_path, -1))

    rest_v = skel_prim.attr("restTransforms")
    bind_v = skel_prim.attr("bindTransforms")
    local = None
    if rest_v is not None and len(rest_v) == nj:
        local = np.transpose(_mat_list(rest_v), (0, 2, 1))
    elif bind_v is not None and len(bind_v) == nj:
        world = np.transpose(_mat_list(bind_v), (0, 2, 1))
        local = np.empty_like(world)
        for i in range(nj):
            if parents[i] >= 0:
                local[i] = np.linalg.inv(world[parents[i]]) @ world[i]
            else:
                local[i] = world[i]

    if local is not None and nj:
        t, q, _ = ss.split(ss.from_matrix(torch.as_tensor(local, dtype=torch.float32)))
        offs, pre = t.numpy(), q.numpy()
    else:
        offs = np.zeros((nj, 3))
        pre = np.tile([0.0, 0.0, 0.0, 1.0], (nj, 1))
    skeleton = make_skeleton(parents, pre, offs, names, device=device)

    def on(a, dtype=None):
        return torch.as_tensor(np.asarray(a, dtype), device=device)

    # mesh + skinning (usd_mesh_io.cpp; fan-triangulate n-gons)
    mesh = skin = None
    meshes = stage.find("Mesh")
    if meshes:
        mp = meshes[0]
        pts = mp.attr("points")
        counts = mp.attr("faceVertexCounts")
        idx = mp.attr("faceVertexIndices")
        if pts is not None and counts is not None and idx is not None:
            verts = np.asarray([list(p) for p in pts], np.float32)
            tris = []
            pos = 0
            for c in counts:
                c = int(c)
                for k in range(1, c - 1):
                    tris.append([idx[pos], idx[pos + k], idx[pos + k + 1]])
                pos += c
            kw = {}
            st = mp.attrs.get("primvars:st")
            if st is not None and st.value is not None and len(st.value) == len(verts):
                kw["texcoords"] = on([list(t) for t in st.value], np.float32)
            mesh = Mesh(vertices=on(verts), faces=on(tris, np.int32), **kw)
            ji = mp.attrs.get("primvars:skel:jointIndices")
            jw = mp.attrs.get("primvars:skel:jointWeights")
            if ji is not None and jw is not None and ji.value:
                k = int(ji.meta.get("elementSize", len(ji.value) // len(verts)))
                si = np.asarray(ji.value, np.int64).reshape(len(verts), k)
                sw = np.asarray(jw.value, np.float32).reshape(len(verts), k)
                # keep top-_MAX_SKIN by weight (usd_mesh_io.cpp:245-263)
                kk = min(k, _MAX_SKIN)
                order = np.argsort(-sw, axis=1)[:, :kk]
                rows = np.arange(len(verts))[:, None]
                si8 = np.zeros((len(verts), _MAX_SKIN), np.int32)
                sw8 = np.zeros((len(verts), _MAX_SKIN), np.float32)
                si8[:, :kk] = si[rows, order]
                sw8[:, :kk] = sw[rows, order]
                skin = SkinWeights(index=on(si8), weight=on(sw8))

    # locators / collision / physical-body custom prims
    name_idx = {n: i for i, n in enumerate(names)}
    loc_rows, col_rows, phys_rows = [], [], []
    for prim in stage.walk():
        pj_json = prim.attr("momentum:physicalProperties")
        if pj_json:
            jname = prim.attr("momentum:joint", "")
            if jname in name_idx:
                phys_rows.append((name_idx[jname],) + body_from_json(json.loads(pj_json))
                                 + (jname,))
            continue
        ptype = prim.attr("momentum:type")
        if ptype == "locator":
            loc_rows.append((
                prim.attr("momentum:name", prim.name),
                name_idx.get(prim.attr("momentum:parent", ""), 0),
                [float(x) for x in prim.attr("momentum:offset", (0.0, 0.0, 0.0))],
                float(prim.attr("momentum:weight", 1.0))))
        elif ptype == "collision_capsule":
            col_rows.append((
                name_idx.get(prim.attr("momentum:parent", ""), 0),
                float(prim.attr("momentum:length", 1.0)),
                [float(x) for x in prim.attr("momentum:radius", (0.1, 0.1))],
                prim.attr("momentum:transform")))

    locators = None
    if loc_rows:
        locators = Locators(parent=on([r[1] for r in loc_rows], np.int32),
                            offset=on([r[2] for r in loc_rows], np.float32),
                            weight=on([r[3] for r in loc_rows], np.float32),
                            names=tuple(r[0] for r in loc_rows))
    collision = None
    if col_rows:
        tf = [[float(x) for x in r[3]] if r[3] is not None
              else [0.0] * 3 + [0.0, 0.0, 0.0, 1.0, 1.0] for r in col_rows]
        collision = CollisionGeometry(parent=on([r[0] for r in col_rows], np.int32),
                                      transform=on(tf, np.float32),
                                      radius=on([r[2] for r in col_rows], np.float32),
                                      length=on([r[1] for r in col_rows], np.float32))

    # parameter transform from momentum metadata, else identity rig
    pt = None
    cname = ""
    for prim in stage.walk():
        v = prim.attr("momentum:parameterTransform")
        if v:
            d = json.loads(v)
            pt = ParameterTransform(transform=on(d["transform"], np.float32),
                                    offsets=on(d["offsets"], np.float32),
                                    names=tuple(d["names"]))
        cname = prim.attr("momentum:characterName", cname) or cname
    if pt is None:
        pt = make_identity_transform(nj, device=device)

    character = Character(
        skeleton=skeleton, parameter_transform=pt, limits=make_empty_limits(device=device),
        mesh=mesh, skin_weights=skin, locators=locators, collision=collision,
        physical_properties=rows_to_physical_properties(phys_rows, device),
        name=cname or "usd_character")
    if mesh is not None and skin is not None:
        character = character.with_inverse_bind_pose()

    # motion: prefer lossless momentum model params, else joint transforms
    motion = None
    for prim in stage.find("SkelAnimation"):
        poses = prim.attr("momentum:motion:poses")
        nf = prim.attr("momentum:motion:numFrames")
        npar = prim.attr("momentum:motion:numParams")
        if poses and nf and npar:
            motion = on(np.asarray(poses, np.float32).reshape(int(nf), int(npar)))
            break
        tattr = prim.attrs.get("transforms")
        if tattr is not None and tattr.time_samples:
            frames = [np.transpose(_mat_list(tattr.time_samples[k]), (0, 2, 1))
                      for k in sorted(tattr.time_samples)]
            motion = np.stack(frames)  # (F, nJ, 4, 4) joint-local matrices
            break
    return character, motion


# --------------------------------------------------------------------------
# public entry points
# --------------------------------------------------------------------------

def save_usda(path, character, motion=None, fps=24.0) -> None:
    """Write character (+ optional (F, P) model-parameter motion) as .usda
    with UsdSkel Skeleton/SkelAnimation + skinned Mesh + locator/collision
    prims + momentum metadata (usd_io.h saveUsd capability)."""
    stage = _character_to_stage(character, motion, fps)
    with open(path, "w") as f:
        f.write(write_usda(stage))


def load_usda(path, device="cuda"):
    """→ (Character, motion) on `device` (the card unless the caller asks
    for the CPU). motion is (F, P) model params when the file carries
    momentum metadata, else (F, nJ, 4, 4) joint-local matrices, else None."""
    device = resolve(device, "load_usda")
    with open(path) as f:
        stage = parse_usda(f.read())
    return _stage_to_character(stage, device)


def save_usd(path, character, motion=None, fps=24.0) -> None:
    """Dispatch on extension: .usda text or .usdc crate binary."""
    if str(path).endswith(".usdc"):
        write_usdc(_character_to_stage(character, motion, fps), path)
    else:
        save_usda(path, character, motion, fps)


def load_usd(path, device="cuda"):
    """Load .usda/.usdc onto `device` (the card unless the caller asks for
    the CPU). Prefers the pxr runtime when importable (reference parity:
    usd_io.cpp loadUsdCharacter), as momentum_tpu's does; falls back to the
    built-in parsers."""
    device = resolve(device, "load_usd")
    path = str(path)
    try:
        import pxr  # noqa: F401
        # A pxr-backed path opens the stage and exports it to usda text,
        # flattened through the text parser for a single load path.
        from pxr import Usd

        stage = Usd.Stage.Open(path)
        return _stage_to_character(parse_usda(stage.GetRootLayer().ExportToString()), device)
    except ImportError:
        pass
    if path.endswith(".usdc"):
        return _stage_to_character(read_usdc(path), device)
    with open(path, "rb") as f:
        head = f.read(8)
    if head == _USDC_IDENT:
        return _stage_to_character(read_usdc(path), device)
    return load_usda(path, device)


# ---- pymomentum.geometry USD binding surface (io_usd_pybind.cpp:329-520) ----


def is_usd_available() -> bool:
    """Always True: the package reads and writes usda and usdc itself (the
    reference gates USD behind an optional pxr build)."""
    return True


def _stage_from_any(source) -> Stage:
    """Path or raw bytes → parsed Stage."""
    if isinstance(source, (bytes, bytearray)):
        data = bytes(source)
        if data[:8] == _USDC_IDENT:
            return read_usdc(data)
        return parse_usda(data.decode("utf-8", errors="replace"))
    path = str(source)
    if path.endswith(".usdc"):
        return read_usdc(path)
    with open(path, "rb") as f:
        head = f.read(8)
    if head == _USDC_IDENT:
        return read_usdc(path)
    with open(path) as f:
        return parse_usda(f.read())


def _stage_fps(stage: Stage) -> float:
    return float(stage.meta.get("timeCodesPerSecond", 24.0))


def load_character(source, device="cuda"):
    """Character only (io_usd_pybind load_character) on `device` (the card
    unless the caller asks for the CPU); accepts a path or raw USD bytes."""
    device = resolve(device, "load_character")
    char, _ = _stage_to_character(_stage_from_any(source), device)
    return char


def load_character_from_bytes(data: bytes, device="cuda"):
    return load_character(bytes(data), device)


def load_character_with_motion(source, device="cuda"):
    """→ (character, motion (F, P) or None, identity (nJ·7,), fps) on
    `device` (the card unless the caller asks for the CPU) — the
    io_usd_pybind load_character_with_motion tuple. The identity vector is
    zero: this loader bakes bone offsets into the skeleton rest pose."""
    device = resolve(device, "load_character_with_motion")
    stage = _stage_from_any(source)
    char, motion = _stage_to_character(stage, device)
    identity = torch.zeros(char.skeleton.num_joints * 7, dtype=torch.float32, device=device)
    return char, motion, identity, _stage_fps(stage)


def load_character_with_motion_from_bytes(data: bytes, device="cuda"):
    return load_character_with_motion(bytes(data), device)


def load_character_with_skel_states(source, device="cuda"):
    """→ (character, skel_states (F, nJ, 8), fps) on `device` (the card
    unless the caller asks for the CPU): the motion resolved through one
    batched FK over every frame, kernel K1 at B = F on the card
    (io_usd_pybind load_character_with_skel_states)."""
    device = resolve(device, "load_character_with_skel_states")
    stage = _stage_from_any(source)
    char, motion = _stage_to_character(stage, device)
    if motion is None:
        motion = torch.zeros((1, char.num_model_parameters), dtype=torch.float32,
                             device=device)
    return char, char.skeleton_states(torch.as_tensor(motion, device=device)), \
        _stage_fps(stage)


def load_character_with_skel_states_from_bytes(data: bytes, device="cuda"):
    return load_character_with_skel_states(bytes(data), device)


def save_character(path, character, fps: float = 24.0, motion=None) -> None:
    """io_usd_pybind save_character."""
    save_usd(path, character, motion=motion, fps=fps)


def save_character_from_skel_states(path, character, skel_states,
                                    fps: float = 24.0) -> None:
    """Save with motion given as GLOBAL skeleton states (F, nJ, 8) or
    (nJ, 8) on any device: inverted to model parameters on the character's
    device through constrained inverse FK and the rig's cached
    pseudo-inverse (io_usd_pybind save_character_from_skel_states)."""
    from momentum_tpu_torch.character.inverse_fk import joint_parameters_from_skeleton_states

    states = torch.as_tensor(skel_states, dtype=torch.float32).to(
        character.skeleton.translation_offset.device)
    if states.ndim == 2:
        states = states[None]
    jp = joint_parameters_from_skeleton_states(character.skeleton, states)
    pt = character.parameter_transform
    save_usd(path, character, motion=(jp - pt.offsets) @ pt.pinv().T, fps=fps)

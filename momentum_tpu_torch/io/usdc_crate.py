"""Usd crate (.usdc) binary encoding — public-layout writer + reader.

Reference capability: momentum/io/usd/usd_io.cpp:60-240 round-trips
characters through the pxr USD runtime, whose binary serialization is the
crate container. This module implements the crate layout directly, with
no pxr runtime, targeting **file version 0.2.0** —
the last layout revision before compressed structural sections (0.4.0)
— so every section is a plain little-endian struct array:

  bootstrap (88 B)   ident "PXR-USDC" (8) + version uint8[8] + tocOffset
                     int64 + reserved (64)
  TOC                int64 numSections; per section: name char[16] +
                     start int64 + size int64
  TOKENS             uint64 numTokens; null-terminated UTF-8 strings
  STRINGS            uint64 n; n x uint32 (StringIndex -> TokenIndex)
  FIELDS             uint64 n; n x Field{TokenIndex uint32, pad uint32,
                     ValueRep uint64}  (16 B, C struct alignment)
  FIELDSETS          uint64 n; n x uint32 FieldIndex, runs terminated by
                     0xFFFFFFFF
  PATHS              uint64 numPaths; DFS path tree of
                     PathItemHeader{PathIndex uint32, TokenIndex uint32,
                     bits uint8, pad uint8[3]} (12 B); when a node has
                     both a child and a sibling the header is followed by
                     an int64 absolute offset to the sibling subtree
  SPECS              uint64 n; n x Spec{PathIndex uint32, FieldSetIndex
                     uint32, SdfSpecType uint32} (12 B)

ValueRep is the 64-bit descriptor used throughout:

  bit 63 IsArray | bit 62 IsInlined | bit 61 IsCompressed |
  bits 48-55 type enum | bits 0-47 payload (inline bytes or absolute
  file offset of the out-of-line data)

Type enums follow pxr crateDataTypes.h (Bool=1 ... TimeSamples=46).
Out-of-line scalars store their raw bytes at the payload offset; arrays
store uint32 count + contiguous elements (the pre-0.7.0 array layout);
TokenVector stores uint64 count + uint32 token indexes; Dictionary
stores uint64 count then per entry a uint32 StringIndex + nested
ValueRep; TimeSamples stores a ValueRep for the times array, uint64
count, then count value ValueReps; ListOps store a uint8 flag byte then
one counted uint32-index vector per present sublist.

Caveat: byte-for-byte conformance against files produced by pxr is not
verified (there is no pxr to write them). The two halves of this module
are written as INDEPENDENT codepaths (the reader never calls writer
helpers and vice versa, sharing only the layout constants above).
Everything above the value level is pinned to the published container
structure byte-for-byte. Pure bytes code on the host, the same as
momentum_tpu/io/usdc_crate.py, whose bytes it writes.
"""

from __future__ import annotations

import struct

import numpy as np

__all__ = ["write_crate", "read_crate"]

IDENT = b"PXR-USDC"
VERSION = (0, 2, 0)

# --- ValueRep bits (crateFile.h) ------------------------------------------
ARRAY_BIT = 1 << 63
INLINED_BIT = 1 << 62
COMPRESSED_BIT = 1 << 61
PAYLOAD_MASK = (1 << 48) - 1

# --- type enums (crateDataTypes.h) ----------------------------------------
T_BOOL = 1
T_UCHAR = 2
T_INT = 3
T_UINT = 4
T_INT64 = 5
T_UINT64 = 6
T_HALF = 7
T_FLOAT = 8
T_DOUBLE = 9
T_STRING = 10
T_TOKEN = 11
T_ASSETPATH = 12
T_QUATD = 13
T_QUATF = 14
T_QUATH = 15
T_VEC2D = 16
T_VEC2F = 17
T_VEC2H = 18
T_VEC2I = 19
T_VEC3D = 20
T_VEC3F = 21
T_VEC3H = 22
T_VEC3I = 23
T_VEC4D = 24
T_VEC4F = 25
T_VEC4H = 26
T_VEC4I = 27
T_MATRIX2D = 28
T_MATRIX3D = 29
T_MATRIX4D = 30
T_DICTIONARY = 31
T_TOKEN_LIST_OP = 32
T_PATH_LIST_OP = 34
T_PATH_VECTOR = 40
T_TOKEN_VECTOR = 41
T_SPECIFIER = 42
T_PERMISSION = 43
T_VARIABILITY = 44
T_TIME_SAMPLES = 46
T_DOUBLE_VECTOR = 48

# --- SdfSpecType ------------------------------------------------------------
SPEC_ATTRIBUTE = 1
SPEC_PRIM = 6
SPEC_PSEUDO_ROOT = 7
SPEC_RELATIONSHIP = 8

# --- SdfSpecifier / SdfVariability ------------------------------------------
SPECIFIER_DEF = 0
VARIABILITY_VARYING = 0
VARIABILITY_UNIFORM = 1

# --- path tree bits ---------------------------------------------------------
PATH_HAS_CHILD = 1 << 0
PATH_HAS_SIBLING = 1 << 1
PATH_IS_PRIM_PROPERTY = 1 << 2

INVALID_INDEX = 0xFFFFFFFF

# ListOp flag byte (shared by Token/Path list ops)
LISTOP_EXPLICIT = 1 << 0
LISTOP_EXPLICIT_ITEMS = 1 << 1

# usda attribute type name -> (crate type enum, numpy dtype, components)
_SCALAR_TYPES = {
    "bool": (T_BOOL, None, 1),
    "uchar": (T_UCHAR, np.uint8, 1),
    "int": (T_INT, np.int32, 1),
    "uint": (T_UINT, np.uint32, 1),
    "int64": (T_INT64, np.int64, 1),
    "uint64": (T_UINT64, np.uint64, 1),
    "float": (T_FLOAT, np.float32, 1),
    "double": (T_DOUBLE, np.float64, 1),
    "timecode": (T_DOUBLE, np.float64, 1),
    "string": (T_STRING, None, 1),
    "token": (T_TOKEN, None, 1),
    "asset": (T_ASSETPATH, None, 1),
    "float2": (T_VEC2F, np.float32, 2),
    "texCoord2f": (T_VEC2F, np.float32, 2),
    "double2": (T_VEC2D, np.float64, 2),
    "int2": (T_VEC2I, np.int32, 2),
    "float3": (T_VEC3F, np.float32, 3),
    "point3f": (T_VEC3F, np.float32, 3),
    "normal3f": (T_VEC3F, np.float32, 3),
    "color3f": (T_VEC3F, np.float32, 3),
    "vector3f": (T_VEC3F, np.float32, 3),
    "double3": (T_VEC3D, np.float64, 3),
    "point3d": (T_VEC3D, np.float64, 3),
    "int3": (T_VEC3I, np.int32, 3),
    "float4": (T_VEC4F, np.float32, 4),
    "color4f": (T_VEC4F, np.float32, 4),
    "double4": (T_VEC4D, np.float64, 4),
    "int4": (T_VEC4I, np.int32, 4),
    "quatf": (T_QUATF, np.float32, 4),
    "quatd": (T_QUATD, np.float64, 4),
    "matrix2d": (T_MATRIX2D, np.float64, 4),
    "matrix3d": (T_MATRIX3D, np.float64, 9),
    "matrix4d": (T_MATRIX4D, np.float64, 16),
}

# crate type enum -> usda scalar name (first name wins for aliases)
_ENUM_TO_NAME = {}
for _name, (_enum, _dt, _nc) in _SCALAR_TYPES.items():
    _ENUM_TO_NAME.setdefault(_enum, _name)

_NUMERIC_STRUCT = {
    T_UCHAR: "<B", T_INT: "<i", T_UINT: "<I", T_INT64: "<q",
    T_UINT64: "<Q", T_FLOAT: "<f", T_DOUBLE: "<d",
}


def _rep(ty, payload, array=False, inlined=False):
    r = (ty & 0xFF) << 48 | (payload & PAYLOAD_MASK)
    if array:
        r |= ARRAY_BIT
    if inlined:
        r |= INLINED_BIT
    return r


# ===========================================================================
# writer
# ===========================================================================


class _Writer:
    """Serializes a Stage document model (io/usd.py) into a crate file."""

    def __init__(self):
        self.tokens: list[str] = []
        self.tok_idx: dict[str, int] = {}
        self.strings: list[int] = []  # StringIndex -> TokenIndex
        self.str_idx: dict[str, int] = {}
        self.fields: list[tuple[int, int]] = []  # (tokenIndex, ValueRep)
        self.field_idx: dict[tuple[int, int], int] = {}
        self.fieldsets: list[int] = []
        self.paths: dict[str, int] = {}  # path string -> PathIndex
        self.path_children: dict[str, list[str]] = {}
        self.path_elem: dict[str, tuple[str, bool]] = {}  # elem tok, is_prop
        self.specs: list[tuple[int, int, int]] = []
        self.data = bytearray()  # out-of-line value payloads
        self.data_base = 88  # absolute offset of the data area

    # -- interning ----------------------------------------------------------
    def token(self, s: str) -> int:
        if s not in self.tok_idx:
            self.tok_idx[s] = len(self.tokens)
            self.tokens.append(s)
        return self.tok_idx[s]

    def string(self, s: str) -> int:
        if s not in self.str_idx:
            self.str_idx[s] = len(self.strings)
            self.strings.append(self.token(s))
        return self.str_idx[s]

    def path(self, p: str, elem: str, is_prop: bool, parent: str) -> int:
        if p in self.paths:
            return self.paths[p]
        self.paths[p] = len(self.paths)
        self.path_elem[p] = (elem, is_prop)
        if parent is not None:
            self.path_children.setdefault(parent, []).append(p)
        return self.paths[p]

    # -- out-of-line data ----------------------------------------------------
    def put(self, blob: bytes, align: int = 1) -> int:
        """Append to the data area, returning the ABSOLUTE file offset."""
        if align > 1:
            pad = (-(self.data_base + len(self.data))) % align
            self.data.extend(b"\0" * pad)
        off = self.data_base + len(self.data)
        self.data.extend(blob)
        return off

    # -- value encoding ------------------------------------------------------
    def encode_scalar(self, usda_type: str, v) -> int:
        ty, dt, nc = _SCALAR_TYPES[usda_type]
        if ty == T_BOOL:
            return _rep(T_BOOL, 1 if v else 0, inlined=True)
        if ty == T_TOKEN:
            return _rep(T_TOKEN, self.token(str(v)), inlined=True)
        if ty == T_ASSETPATH:
            return _rep(T_ASSETPATH, self.token(str(v)), inlined=True)
        if ty == T_STRING:
            return _rep(T_STRING, self.string(str(v)), inlined=True)
        if ty == T_INT and -(1 << 31) <= int(v) < (1 << 31):
            return _rep(T_INT, int(v) & 0xFFFFFFFF, inlined=True)
        if ty == T_FLOAT:
            bits = struct.unpack("<I", struct.pack("<f", float(v)))[0]
            return _rep(T_FLOAT, bits, inlined=True)
        if ty == T_DOUBLE:
            f32 = struct.unpack("<f", struct.pack("<f", float(v)))[0]
            if f32 == float(v):  # losslessly float-representable: inline
                bits = struct.unpack("<I", struct.pack("<f", f32))[0]
                return _rep(T_DOUBLE, bits, inlined=True)
            return _rep(T_DOUBLE, self.put(struct.pack("<d", float(v)), 8))
        if ty in _NUMERIC_STRUCT:  # remaining out-of-line numeric scalars
            return _rep(ty, self.put(struct.pack(_NUMERIC_STRUCT[ty],
                                                 int(v)), 8))
        # fixed-width vector / matrix scalars: out-of-line raw components
        arr = np.asarray(v, dt).reshape(nc)
        return _rep(ty, self.put(arr.tobytes(), 8))

    def encode_array(self, usda_type: str, v) -> int:
        base = usda_type[:-2]
        ty, dt, nc = _SCALAR_TYPES[base]
        items = _listify(v)
        n = len(items)
        if ty == T_TOKEN:
            blob = struct.pack("<I", n) + b"".join(
                struct.pack("<I", self.token(str(s))) for s in items)
            return _rep(T_TOKEN, self.put(blob, 4), array=True)
        if ty == T_STRING:
            blob = struct.pack("<I", n) + b"".join(
                struct.pack("<I", self.string(str(s))) for s in items)
            return _rep(T_STRING, self.put(blob, 4), array=True)
        arr = np.asarray(items, dt)
        arr = arr.reshape(n, nc) if nc > 1 else arr.reshape(n)
        blob = struct.pack("<I", n) + arr.tobytes()
        return _rep(ty, self.put(blob, 8), array=True)

    def encode_token_vector(self, names) -> int:
        blob = struct.pack("<Q", len(names)) + b"".join(
            struct.pack("<I", self.token(str(s))) for s in names)
        return _rep(T_TOKEN_VECTOR, self.put(blob, 8))

    def encode_dictionary(self, d: dict) -> int:
        # depth-first: nested payloads land before the dict body
        entries = []
        for k, v in d.items():
            if v is None:
                continue
            entries.append((self.string(str(k)), self.encode_any(v)))
        blob = struct.pack("<Q", len(entries)) + b"".join(
            struct.pack("<IQ", si, rep) for si, rep in entries)
        return _rep(T_DICTIONARY, self.put(blob, 8))

    def encode_any(self, v) -> int:
        """Best-effort typed encoding for metadata values."""
        if isinstance(v, bool):
            return self.encode_scalar("bool", v)
        if isinstance(v, (int, np.integer)):
            return self.encode_scalar("int", v)
        if isinstance(v, (float, np.floating)):
            return self.encode_scalar("double", v)
        if isinstance(v, str):
            return self.encode_scalar("string", v)
        if isinstance(v, dict):
            return self.encode_dictionary(v)
        if isinstance(v, (list, tuple, np.ndarray)):
            items = _listify(v)
            if all(isinstance(x, str) for x in items):
                return self.encode_array("string[]", items)
            flat = np.asarray(v, np.float64)
            if flat.ndim == 2 and flat.shape[1] == 3:
                return self.encode_array("double3[]", v)
            return self.encode_array("double[]", flat.reshape(-1))
        raise TypeError(f"usdc: cannot encode metadata value {type(v)}")

    def encode_path_list_op(self, targets) -> int:
        idxs = [self.paths[t] for t in targets]
        blob = struct.pack("<B", LISTOP_EXPLICIT | LISTOP_EXPLICIT_ITEMS)
        blob += struct.pack("<Q", len(idxs)) + b"".join(
            struct.pack("<I", i) for i in idxs)
        return _rep(T_PATH_LIST_OP, self.put(blob, 8))

    def encode_time_samples(self, samples: dict, usda_type: str) -> int:
        times = sorted(samples.keys(), key=float)
        # value payloads first (depth-first), then times, then the body
        val_reps = [self.encode_value(usda_type, samples[t]) for t in times]
        times_rep = self.encode_array(
            "double[]", np.asarray([float(t) for t in times], np.float64))
        blob = struct.pack("<Q", times_rep)
        blob += struct.pack("<Q", len(val_reps))
        blob += b"".join(struct.pack("<Q", r) for r in val_reps)
        return _rep(T_TIME_SAMPLES, self.put(blob, 8))

    def encode_value(self, usda_type: str, v) -> int:
        if usda_type.endswith("[]"):
            return self.encode_array(usda_type, v)
        if usda_type in _SCALAR_TYPES:
            return self.encode_scalar(usda_type, v)
        raise TypeError(f"usdc: unsupported attribute type {usda_type!r}")

    # -- fields / fieldsets ----------------------------------------------------
    def field(self, name: str, rep: int) -> int:
        key = (self.token(name), rep)
        if key not in self.field_idx:
            self.field_idx[key] = len(self.fields)
            self.fields.append(key)
        return self.field_idx[key]

    def fieldset(self, field_indexes) -> int:
        start = len(self.fieldsets)
        self.fieldsets.extend(field_indexes)
        self.fieldsets.append(INVALID_INDEX)
        return start

    # -- structural emission -----------------------------------------------------
    def write_path_tree(self, out: bytearray, p: str, has_sibling: bool):
        elem, is_prop = self.path_elem[p]
        kids = self.path_children.get(p, ())
        bits = ((PATH_HAS_CHILD if kids else 0)
                | (PATH_HAS_SIBLING if has_sibling else 0)
                | (PATH_IS_PRIM_PROPERTY if is_prop else 0))
        out.extend(struct.pack("<IIB3x", self.paths[p], self.token(elem),
                               bits))
        if kids and has_sibling:
            hole = len(out)
            out.extend(struct.pack("<q", 0))  # patched to sibling offset
        for i, c in enumerate(kids):
            self.write_path_tree(out, c, has_sibling=i + 1 < len(kids))
        if kids and has_sibling:
            struct.pack_into("<q", out, hole, len(out))

    def tobytes(self) -> bytes:
        paths_body = bytearray()
        self.write_path_tree(paths_body, "/", has_sibling=False)

        sections = [
            (b"TOKENS", struct.pack("<Q", len(self.tokens))
             + b"".join(t.encode() + b"\0" for t in self.tokens)),
            (b"STRINGS", struct.pack("<Q", len(self.strings))
             + b"".join(struct.pack("<I", t) for t in self.strings)),
            (b"FIELDS", struct.pack("<Q", len(self.fields))
             + b"".join(struct.pack("<I4xQ", t, r) for t, r in self.fields)),
            (b"FIELDSETS", struct.pack("<Q", len(self.fieldsets))
             + b"".join(struct.pack("<I", i) for i in self.fieldsets)),
            (b"PATHS", struct.pack("<Q", len(self.paths)) + bytes(paths_body)),
            (b"SPECS", struct.pack("<Q", len(self.specs))
             + b"".join(struct.pack("<III", *s) for s in self.specs)),
        ]
        out = bytearray()
        out += IDENT
        out += bytes(VERSION) + b"\0" * 5
        toc_pos = len(out)
        out += struct.pack("<q", 0)
        out += b"\0" * 64
        assert len(out) == self.data_base
        out += self.data
        toc = []
        for name, body in sections:
            toc.append((name, len(out), len(body)))
            out += body
        struct.pack_into("<q", out, toc_pos, len(out))
        out += struct.pack("<q", len(sections))
        for name, start, size in toc:
            out += name.ljust(16, b"\0") + struct.pack("<qq", start, size)
        return bytes(out)


def _listify(v):
    if isinstance(v, np.ndarray):
        return list(v)
    if isinstance(v, (list, tuple)):
        return list(v)
    return [v]


def _prim_path(parent_path: str, name: str) -> str:
    return (parent_path.rstrip("/") + "/" + name) if parent_path != "/" \
        else "/" + name


def write_crate(stage, path) -> None:
    """Write a Stage (io/usd.py document model) as a crate file."""
    w = _Writer()
    # token 0 conventionally the empty token; path 0 is the pseudo-root
    w.token("")
    w.path("/", "", False, None)

    # pre-register every prim / property path so PathListOp targets resolve
    def reg(prim, parent_path):
        p = _prim_path(parent_path, prim.name)
        w.path(p, prim.name, False, parent_path)
        for a in prim.attrs.values():
            w.path(p + "." + a.name, a.name, True, p)
        for c in prim.children:
            reg(c, p)

    for r in stage.roots:
        reg(r, "/")

    def emit_attr(prim_path, a):
        fs = []
        is_rel = a.type == "rel"
        if not is_rel:
            fs.append(w.field("typeName", _rep(
                T_TOKEN, w.token(a.type), inlined=True)))
        if a.uniform:
            fs.append(w.field("variability", _rep(
                T_VARIABILITY, VARIABILITY_UNIFORM, inlined=True)))
        if is_rel:
            targets = [t.strip("<>") for t in _listify(a.value)
                       if isinstance(t, str)]
            targets = [t for t in targets if t in w.paths]
            fs.append(w.field("targetPaths", w.encode_path_list_op(targets)))
        elif a.value is not None:
            fs.append(w.field("default", w.encode_value(a.type, a.value)))
        if a.time_samples:
            fs.append(w.field("timeSamples",
                              w.encode_time_samples(a.time_samples, a.type)))
        if a.meta:
            known = dict(a.meta)
            interp = known.pop("interpolation", None)
            esize = known.pop("elementSize", None)
            if interp is not None:
                fs.append(w.field("interpolation", _rep(
                    T_TOKEN, w.token(str(interp)), inlined=True)))
            if esize is not None:
                fs.append(w.field("elementSize", _rep(
                    T_INT, int(esize) & 0xFFFFFFFF, inlined=True)))
            if known:
                fs.append(w.field("customData", w.encode_dictionary(known)))
        spec_type = SPEC_RELATIONSHIP if is_rel else SPEC_ATTRIBUTE
        w.specs.append((w.paths[prim_path + "." + a.name],
                        w.fieldset(fs), spec_type))

    def emit_prim(prim, parent_path):
        p = _prim_path(parent_path, prim.name)
        fs = [w.field("specifier", _rep(T_SPECIFIER, SPECIFIER_DEF,
                                        inlined=True))]
        if prim.type:
            fs.append(w.field("typeName", _rep(
                T_TOKEN, w.token(prim.type), inlined=True)))
        if prim.children:
            fs.append(w.field("primChildren", w.encode_token_vector(
                [c.name for c in prim.children])))
        if prim.attrs:
            fs.append(w.field("properties", w.encode_token_vector(
                [a.name for a in prim.attrs.values()])))
        if prim.meta:
            fs.append(w.field("customData", w.encode_dictionary(prim.meta)))
        w.specs.append((w.paths[p], w.fieldset(fs), SPEC_PRIM))
        for a in prim.attrs.values():
            emit_attr(p, a)
        for c in prim.children:
            emit_prim(c, p)

    # pseudo-root spec: layer metadata + root prim ordering
    root_fs = [w.field("primChildren", w.encode_token_vector(
        [r.name for r in stage.roots]))]
    meta = dict(stage.meta or {})
    for key, ty in (("upAxis", "token"), ("defaultPrim", "token"),
                    ("metersPerUnit", "double"), ("kilogramsPerUnit", "double"),
                    ("timeCodesPerSecond", "double"),
                    ("framesPerSecond", "double"), ("startTimeCode", "double"),
                    ("endTimeCode", "double"), ("documentation", "string")):
        if key in meta:
            root_fs.append(w.field(key, w.encode_scalar(ty, meta.pop(key))))
    if meta:
        root_fs.append(w.field("customLayerData", w.encode_dictionary(meta)))
    w.specs.append((w.paths["/"], w.fieldset(root_fs), SPEC_PSEUDO_ROOT))

    for r in stage.roots:
        emit_prim(r, "/")

    blob = w.tobytes()
    with open(path, "wb") as f:
        f.write(blob)


# ===========================================================================
# reader — independent decode path (shares only the layout constants)
# ===========================================================================


class _Reader:
    def __init__(self, buf: bytes):
        self.buf = buf
        if buf[:8] != IDENT:
            raise ValueError("not a usdc file (bad ident)")
        self.version = tuple(buf[8:11])
        if self.version[:2] > (0, 3):
            raise ValueError(
                f"usdc version {self.version} uses compressed structural "
                "sections (>= 0.4.0), which this reader does not support")
        toc_off = struct.unpack_from("<q", buf, 16)[0]
        nsec = struct.unpack_from("<q", buf, toc_off)[0]
        self.sections = {}
        pos = toc_off + 8
        for _ in range(nsec):
            name = buf[pos:pos + 16].rstrip(b"\0").decode()
            start, size = struct.unpack_from("<qq", buf, pos + 16)
            self.sections[name] = (start, size)
            pos += 32
        self.tokens = self._read_tokens()
        self.strings = self._read_indexes("STRINGS")
        self.fields = self._read_fields()
        self.fieldsets = self._read_indexes("FIELDSETS")
        self.path_strs, self.path_props = self._read_paths()

    def _sec(self, name):
        start, size = self.sections[name]
        return self.buf[start:start + size]

    def _read_tokens(self):
        sec = self._sec("TOKENS")
        n = struct.unpack_from("<Q", sec, 0)[0]
        toks = sec[8:].split(b"\0")[:n]
        return [t.decode() for t in toks]

    def _read_indexes(self, name):
        sec = self._sec(name)
        n = struct.unpack_from("<Q", sec, 0)[0]
        return list(struct.unpack_from(f"<{n}I", sec, 8))

    def _read_fields(self):
        sec = self._sec("FIELDS")
        n = struct.unpack_from("<Q", sec, 0)[0]
        out = []
        for i in range(n):
            tok, rep = struct.unpack_from("<I4xQ", sec, 8 + 16 * i)
            out.append((self.tokens[tok], rep))
        return out

    def _read_paths(self):
        sec = self._sec("PATHS")
        n = struct.unpack_from("<Q", sec, 0)[0]
        strs = {}
        props = {}
        pos = 8

        # iterative DFS: the stack holds the parent path for the next
        # node to decode (child subtree first, then the pending sibling)
        stack = [""]
        while stack:
            parent = stack.pop()
            idx, elem_t, bits = struct.unpack_from("<IIB3x", sec, pos)
            pos += 12
            elem = self.tokens[elem_t]
            if bits & PATH_IS_PRIM_PROPERTY:
                full = parent + "." + elem
            elif parent in ("", "/"):
                full = "/" if elem == "" else "/" + elem
            else:
                full = parent + "/" + elem
            strs[idx] = full
            props[idx] = bool(bits & PATH_IS_PRIM_PROPERTY)
            has_child = bits & PATH_HAS_CHILD
            has_sib = bits & PATH_HAS_SIBLING
            if has_child and has_sib:
                pos += 8  # sibling offset: DFS order makes it redundant
            if has_sib:
                stack.append(parent)
            if has_child:
                stack.append(full)
        assert len(strs) == n, f"path tree decoded {len(strs)} of {n}"
        return strs, props

    # -- value decoding ------------------------------------------------------
    def value(self, rep: int):
        ty = (rep >> 48) & 0xFF
        arr = bool(rep & ARRAY_BIT)
        inl = bool(rep & INLINED_BIT)
        payload = rep & PAYLOAD_MASK
        if arr:
            return self._array(ty, payload)
        if ty == T_BOOL:
            return bool(payload)
        if ty == T_TOKEN or ty == T_ASSETPATH:
            return self.tokens[payload]
        if ty == T_STRING:
            return self.tokens[self.strings[payload]]
        if ty == T_INT and inl:
            return struct.unpack("<i", struct.pack("<I",
                                                   payload & 0xFFFFFFFF))[0]
        if ty == T_FLOAT and inl:
            return struct.unpack("<f", struct.pack("<I",
                                                   payload & 0xFFFFFFFF))[0]
        if ty == T_DOUBLE and inl:
            return float(struct.unpack(
                "<f", struct.pack("<I", payload & 0xFFFFFFFF))[0])
        if ty == T_SPECIFIER or ty == T_VARIABILITY or ty == T_PERMISSION:
            return int(payload)
        if ty in _NUMERIC_STRUCT:
            fmt = _NUMERIC_STRUCT[ty]
            return struct.unpack_from(fmt, self.buf, payload)[0]
        if ty == T_DICTIONARY:
            return self._dict(payload)
        if ty == T_TOKEN_VECTOR:
            n = struct.unpack_from("<Q", self.buf, payload)[0]
            idxs = struct.unpack_from(f"<{n}I", self.buf, payload + 8)
            return [self.tokens[i] for i in idxs]
        if ty == T_TIME_SAMPLES:
            return self._time_samples(payload)
        if ty == T_PATH_LIST_OP:
            return self._path_list_op(payload)
        if ty in _ENUM_TO_NAME:  # fixed-width vec/matrix scalar
            name = _ENUM_TO_NAME[ty]
            _, dt, nc = _SCALAR_TYPES[name]
            a = np.frombuffer(self.buf, dt, nc, payload)
            if name.startswith("matrix"):
                d = int(round(nc ** 0.5))
                return tuple(tuple(r) for r in a.reshape(d, d).tolist())
            return tuple(a.tolist())
        raise ValueError(f"usdc: cannot decode ValueRep type {ty}")

    def _array(self, ty, off):
        if ty == T_TOKEN or ty == T_STRING:
            n = struct.unpack_from("<I", self.buf, off)[0]
            idxs = struct.unpack_from(f"<{n}I", self.buf, off + 4)
            if ty == T_STRING:
                return [self.tokens[self.strings[i]] for i in idxs]
            return [self.tokens[i] for i in idxs]
        name = _ENUM_TO_NAME.get(ty)
        if name is None:
            raise ValueError(f"usdc: cannot decode array type {ty}")
        _, dt, nc = _SCALAR_TYPES[name]
        n = struct.unpack_from("<I", self.buf, off)[0]
        a = np.frombuffer(self.buf, dt, n * nc, off + 4)
        if name.startswith("matrix"):
            d = int(round(nc ** 0.5))  # doc model nests matrices row-wise
            return [tuple(tuple(r) for r in row.reshape(d, d).tolist())
                    for row in a.reshape(n, nc)]
        if nc > 1:
            return [tuple(row.tolist()) for row in a.reshape(n, nc)]
        return a.tolist()

    def _dict(self, off):
        n = struct.unpack_from("<Q", self.buf, off)[0]
        out = {}
        pos = off + 8
        for _ in range(n):
            si, rep = struct.unpack_from("<IQ", self.buf, pos)
            pos += 12
            out[self.tokens[self.strings[si]]] = self.value(rep)
        return out

    def _time_samples(self, off):
        times_rep = struct.unpack_from("<Q", self.buf, off)[0]
        times = self.value(times_rep)
        n = struct.unpack_from("<Q", self.buf, off + 8)[0]
        reps = struct.unpack_from(f"<{n}Q", self.buf, off + 16)
        return {float(t): self.value(r) for t, r in zip(times, reps)}

    def _path_list_op(self, off):
        flags = self.buf[off]
        pos = off + 1
        out = []
        if flags & (LISTOP_EXPLICIT_ITEMS | LISTOP_EXPLICIT):
            n = struct.unpack_from("<Q", self.buf, pos)[0]
            idxs = struct.unpack_from(f"<{n}I", self.buf, pos + 8)
            # doc-model convention (parse_usda): bare path strings, no <>
            out = [self.path_strs[i] for i in idxs]
        return out


def read_crate(path_or_bytes):
    """Read a crate file back into a Stage (io/usd.py document model)."""
    from momentum_tpu_torch.io.usd import Attr, Prim, Stage

    if isinstance(path_or_bytes, bytes):
        buf = path_or_bytes
    else:
        with open(path_or_bytes, "rb") as f:
            buf = f.read()
    r = _Reader(buf)

    sec = r._sec("SPECS")
    n = struct.unpack_from("<Q", sec, 0)[0]
    specs = [struct.unpack_from("<III", sec, 8 + 12 * i) for i in range(n)]

    def fieldset(fs_idx):
        out = {}
        i = fs_idx
        while i < len(r.fieldsets) and r.fieldsets[i] != INVALID_INDEX:
            name, rep = r.fields[r.fieldsets[i]]
            out[name] = rep
            i += 1
        return out

    stage = Stage()
    prims_by_path = {}
    # pass 1: prims (and layer metadata off the pseudo-root)
    prim_children = {}
    for path_i, fs_i, spec_ty in specs:
        p = r.path_strs[path_i]
        fields = fieldset(fs_i)
        if spec_ty == SPEC_PSEUDO_ROOT:
            meta = {}
            for name, rep in fields.items():
                if name == "primChildren":
                    prim_children["/"] = r.value(rep)
                elif name == "customLayerData":
                    meta.update(r.value(rep))
                else:
                    meta[name] = r.value(rep)
            stage.meta = meta
        elif spec_ty == SPEC_PRIM:
            prim = Prim(name=p.rsplit("/", 1)[-1])
            for name, rep in fields.items():
                if name == "typeName":
                    prim.type = r.value(rep)
                elif name == "primChildren":
                    prim_children[p] = r.value(rep)
                elif name == "customData":
                    prim.meta = r.value(rep)
                elif name == "properties":
                    pass  # property specs carry everything needed
            prims_by_path[p] = prim

    # attach children in authored order
    for p, prim in prims_by_path.items():
        parent = p.rsplit("/", 1)[0] or "/"
        if parent == "/":
            stage.roots.append(prim)
        else:
            prims_by_path[parent].children.append(prim)
    stage.roots.sort(key=lambda pr: _order(prim_children.get("/", ()),
                                           pr.name))
    for p, prim in prims_by_path.items():
        prim.children.sort(key=lambda pr: _order(prim_children.get(p, ()),
                                                 pr.name))

    # pass 2: properties
    for path_i, fs_i, spec_ty in specs:
        if spec_ty not in (SPEC_ATTRIBUTE, SPEC_RELATIONSHIP):
            continue
        p = r.path_strs[path_i]
        # prim paths never contain '.'; attr names may ("….connect")
        prim_path, attr_name = p.split(".", 1)
        prim = prims_by_path.get(prim_path)
        if prim is None:
            continue
        fields = fieldset(fs_i)
        a = Attr(name=attr_name, type="rel")
        if spec_ty == SPEC_RELATIONSHIP:
            if "targetPaths" in fields:
                tgts = r.value(fields["targetPaths"])
                a.value = tgts[0] if len(tgts) == 1 else tgts
        else:
            a.type = r.value(fields["typeName"]) if "typeName" in fields \
                else ""
            if "default" in fields:
                a.value = r.value(fields["default"])
            if "timeSamples" in fields:
                a.time_samples = r.value(fields["timeSamples"])
        if fields.get("variability") is not None \
                and (fields["variability"] & PAYLOAD_MASK) \
                == VARIABILITY_UNIFORM:
            a.uniform = True
        for meta_key in ("interpolation", "elementSize"):
            if meta_key in fields:
                a.meta[meta_key] = r.value(fields[meta_key])
        if "customData" in fields:
            a.meta.update(r.value(fields["customData"]))
        prim.attrs[attr_name] = a
    return stage


def _order(names, name):
    try:
        return list(names).index(name)
    except ValueError:
        return 1 << 30

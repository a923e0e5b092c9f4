"""ParameterLimits / pose-constraints ↔ the reference's JSON schema.

Reference: momentum/io/common/json_utils.cpp:400-676 (per-type limit objects
keyed by parameter/joint NAME, ellipsoid lengths stored in meters while
momentum works in cm — toJson ×toM at :504-507, fromJson ÷toM at :591-594)
and :138-167 (poseConstraints = {pose: {param name: value}}). Used by the GLB
document extension (gltf_builder.cpp:1005-1007) and legacy JSON.
"""

from __future__ import annotations

import numpy as np

from momentum_tpu_torch.character.limits import ParameterLimits, make_limits
from momentum_tpu_torch.device import to_host

__all__ = ["limits_to_json", "limits_from_json",
           "pose_constraints_to_json", "pose_constraints_from_json"]

_TO_M = 0.01
_FLT_MAX = float(np.finfo(np.float32).max)

# kJointParameterNames (character/types.h)
_JOINT_PARAM_NAMES = ("tx", "ty", "tz", "rx", "ry", "rz", "sc")


def character_device(character):
    """The device a character's tensors live on: what the loaders that
    extend a character build on unless told otherwise."""
    return character.skeleton.joint_parent.device


def limits_to_json(character) -> list:
    """Character → the reference's parameterLimits JSON array."""
    lm: ParameterLimits = character.limits
    pnames = character.parameter_transform.names
    jnames = character.skeleton.joint_names
    h = {k: to_host(getattr(lm, k)) for k in (
        "minmax_index", "minmax_bounds", "minmax_weight", "minmax_joint_index",
        "minmax_joint_bounds", "minmax_joint_weight", "minmax_joint_passive",
        "halfplane_idx1", "halfplane_idx2", "halfplane_normal", "halfplane_offset",
        "halfplane_weight", "ellipsoid_parent", "ellipsoid_frame_parent",
        "ellipsoid_point_offset", "ellipsoid_mat", "ellipsoid_weight")}
    out = []

    mm_i, mm_b, mm_w = h["minmax_index"], h["minmax_bounds"], h["minmax_weight"]
    for k in range(mm_i.shape[0]):
        out.append({"type": "minmax", "weight": float(mm_w[k]),
                    "parameter": pnames[int(mm_i[k])],
                    "limits": [[float(mm_b[k, 0]), float(mm_b[k, 1])]]})

    mj_i, mj_b = h["minmax_joint_index"], h["minmax_joint_bounds"]
    mj_w, mj_p = h["minmax_joint_weight"], h["minmax_joint_passive"]
    for k in range(mj_i.shape[0]):
        flat = int(mj_i[k])
        out.append({
            "type": "minmax_joint_passive" if bool(mj_p[k]) else "minmax_joint",
            "weight": float(mj_w[k]),
            "jointIndex": jnames[flat // 7],
            "jointParameter": _JOINT_PARAM_NAMES[flat % 7],
            "limits": [[float(mj_b[k, 0]), float(mj_b[k, 1])]]})

    def _linear(prefix, typ, ref_key, tgt_key, names, joint=False):
        ref, tgt, scale, offset, rng, weight = (to_host(getattr(lm, f"{prefix}_{k}")) for k in (
            "ref", "tgt", "scale", "offset", "range", "weight"))
        rows = []
        for k in range(ref.shape[0]):
            li = {"type": typ, "weight": float(weight[k]),
                  "scale": float(scale[k]), "offset": float(offset[k])}
            if not joint:
                li[ref_key] = names[int(ref[k])]
                li[tgt_key] = names[int(tgt[k])]
            else:
                li[ref_key] = names[int(ref[k]) // 7]
                li[ref_key + "Parameter"] = int(ref[k]) % 7
                li[tgt_key] = names[int(tgt[k]) // 7]
                li[tgt_key + "Parameter"] = int(tgt[k]) % 7
            if rng[k, 0] > -_FLT_MAX / 2:
                li["rangeMin"] = float(rng[k, 0])
            if rng[k, 1] < _FLT_MAX / 2:
                li["rangeMax"] = float(rng[k, 1])
            rows.append(li)
        return rows

    out += _linear("linear", "linear", "referenceParameter", "targetParameter", pnames)
    out += _linear("linear_joint", "linear_joint", "referenceJoint", "targetJoint", jnames,
                   joint=True)

    hp_1, hp_2, hp_n = h["halfplane_idx1"], h["halfplane_idx2"], h["halfplane_normal"]
    hp_o, hp_w = h["halfplane_offset"], h["halfplane_weight"]
    for k in range(hp_1.shape[0]):
        out.append({"type": "half_plane", "weight": float(hp_w[k]),
                    "param1": pnames[int(hp_1[k])],
                    "param2": pnames[int(hp_2[k])],
                    "normal": [float(hp_n[k, 0]), float(hp_n[k, 1])],
                    "offset": float(hp_o[k])})

    e_p, e_ep, e_o = h["ellipsoid_parent"], h["ellipsoid_frame_parent"], h["ellipsoid_point_offset"]
    e_m, e_w = h["ellipsoid_mat"], h["ellipsoid_weight"]
    for k in range(e_p.shape[0]):
        mat = np.array(e_m[k], np.float64)
        mat[:3, 3] *= _TO_M  # JSON stores meters (json_utils.cpp:504-507)
        out.append({"type": "ellipsoid", "weight": float(e_w[k]),
                    "parent": jnames[int(e_p[k])],
                    "ellipsoidParent": jnames[int(e_ep[k])],
                    "offset": [float(x) for x in e_o[k] * _TO_M],
                    "ellipsoid": mat.tolist()})
    return out


def _limits_pair(el):
    """Vector2f "limits" field: the reference serializes Eigen vectors in a
    nested form ([[lo, hi]], json_utils.cpp:409; observed in
    model_with_motion.glb); accept flat [lo, hi] too."""
    arr = np.asarray(el.get("limits", [0.0, 0.0]), np.float64).reshape(-1)
    return float(arr[0]), float(arr[1])


def limits_from_json(character, j, device=None) -> ParameterLimits:
    """The reference's parameterLimits JSON array → ParameterLimits on
    `device` (the character's when None; json_utils.cpp:640-676; unknown
    names are skipped rather than thrown so partial assets still load)."""
    pidx = {n: i for i, n in enumerate(character.parameter_transform.names)}
    jidx = {n: i for i, n in enumerate(character.skeleton.joint_names)}
    jp_idx = {n: i for i, n in enumerate(_JOINT_PARAM_NAMES)}
    minmax, minmax_joint = [], []
    linear, linear_joint, halfplane, ellipsoid = [], [], [], []
    for el in j or []:
        typ = el.get("type", "")
        w = float(el.get("weight", 0.0))
        if typ == "minmax" and el.get("parameter") in pidx:
            lo, hi = _limits_pair(el)
            minmax.append((pidx[el["parameter"]], lo, hi, w))
        elif typ in ("minmax_joint", "minmax_joint_passive") and \
                el.get("jointIndex") in jidx:
            lo, hi = _limits_pair(el)
            attr = jp_idx.get(el.get("jointParameter", "rx"), 3)
            minmax_joint.append((jidx[el["jointIndex"]], attr, lo, hi, w,
                                 typ.endswith("passive")))
        elif typ == "linear" and el.get("referenceParameter") in pidx and \
                el.get("targetParameter") in pidx:
            linear.append((pidx[el["referenceParameter"]],
                           pidx[el["targetParameter"]],
                           float(el.get("scale", 1.0)),
                           float(el.get("offset", 0.0)),
                           float(el.get("rangeMin", -_FLT_MAX)),
                           float(el.get("rangeMax", _FLT_MAX)), w))
        elif typ == "linear_joint" and el.get("referenceJoint") in jidx and \
                el.get("targetJoint") in jidx:
            rj = jidx[el["referenceJoint"]] * 7 + int(el.get("referenceJointParameter", 0))
            tj = jidx[el["targetJoint"]] * 7 + int(el.get("targetJointParameter", 0))
            linear_joint.append((rj, tj, float(el.get("scale", 1.0)),
                                 float(el.get("offset", 0.0)),
                                 float(el.get("rangeMin", -_FLT_MAX)),
                                 float(el.get("rangeMax", _FLT_MAX)), w))
        elif typ == "half_plane" and el.get("param1") in pidx and \
                el.get("param2") in pidx:
            n = el.get("normal", [1.0, 0.0])
            halfplane.append((pidx[el["param1"]], pidx[el["param2"]],
                              float(n[0]), float(n[1]),
                              float(el.get("offset", 0.0)), w))
        elif typ in ("ellipsoid", "elipsoid"):
            key = "ellipsoidParent" if typ == "ellipsoid" else "elipsoidParent"
            mkey = "ellipsoid" if typ == "ellipsoid" else "elipsoid"
            if el.get("parent") not in jidx or el.get(key) not in jidx \
                    or el.get(mkey) is None:
                continue
            mat = np.asarray(el[mkey], np.float64)
            mat[:3, 3] /= _TO_M
            off = np.asarray(el.get("offset", [0, 0, 0]), np.float64) / _TO_M
            ellipsoid.append((jidx[el["parent"]], jidx[el[key]], off.tolist(), mat, w))
    return make_limits(minmax=minmax, minmax_joint=minmax_joint, linear=linear,
                       linear_joint=linear_joint, halfplane=halfplane,
                       ellipsoid=ellipsoid,
                       device=character_device(character) if device is None else device)


def pose_constraints_to_json(character) -> dict:
    """{pose: ((param idx, value), ...)} → {pose: {param name: value}}
    (json_utils.cpp:138-148)."""
    pnames = character.parameter_transform.names
    pc = getattr(character.parameter_transform, "pose_constraints", None) or {}
    return {pose: {pnames[i]: float(v) for i, v in pairs if i < len(pnames)}
            for pose, pairs in pc.items()}


def pose_constraints_from_json(character, j) -> dict:
    """Inverse of the above (json_utils.cpp:150-167; unknown names skipped)."""
    pidx = {n: i for i, n in enumerate(character.parameter_transform.names)}
    return {pose: tuple((pidx[n], float(v)) for n, v in d.items() if n in pidx)
            for pose, d in (j or {}).items()}

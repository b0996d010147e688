"""GLB (glTF 2.0 binary) export: static meshes and skinned, animated avatars
(the port's own copy of ``tpubody.mesh.gltf``; a file either package
writes for the same avatar is the same bytes).

A capability the reference lacks entirely: its rigged reconstruction can only
be consumed by re-running its own python stack (avatar pickles,
lib/mesh2smpl_model.py:377-385) or watching rendered MP4s
(lib/model2video.py:498-522).  Here the avatar exports as an engine-ready
skinned GLB — joint hierarchy, inverse bind matrices, vertex colors, and
per-frame animation channels — usable in Blender/three.js/Unity/Unreal.

The export is exact, not approximate: glTF skinning composes node-local
``T(J_i - J_parent) . R_i`` down the hierarchy and applies
``G_i . translate(-J_rest_i)`` per joint, which is term-for-term the SMPL LBS
used by ``core/lbs.py``/``mesh/rigging.py::animate`` (reference
models/smpl_np.py:179-202).

Everything here is host-side IO (numpy + struct) — no device work.
"""
from __future__ import annotations

import json
import struct
from typing import Optional, Tuple

import numpy as np

_MAGIC = 0x46546C67          # "glTF"
_CHUNK_JSON = 0x4E4F534A     # "JSON"
_CHUNK_BIN = 0x004E4942      # "BIN\0"

_FLOAT = 5126
_UINT32 = 5125
_USHORT = 5123

_TYPE_COUNT = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}


class _Builder:
    """Accumulates the single GLB binary buffer + bufferViews/accessors."""

    def __init__(self):
        self.blob = bytearray()
        self.buffer_views = []
        self.accessors = []

    def _align(self, n: int = 4) -> None:
        while len(self.blob) % n:
            self.blob += b"\0"

    def add(self, array: np.ndarray, gl_type: str, component: int,
            target: Optional[int] = None, minmax: bool = False) -> int:
        """Append an array as bufferView+accessor; returns the accessor id."""
        arr = np.ascontiguousarray(array)
        self._align()
        view = {"buffer": 0, "byteOffset": len(self.blob),
                "byteLength": arr.nbytes}
        if target is not None:
            view["target"] = target
        self.blob += arr.tobytes()
        self.buffer_views.append(view)
        n = int(arr.size // _TYPE_COUNT[gl_type])
        acc = {"bufferView": len(self.buffer_views) - 1,
               "componentType": component, "count": n, "type": gl_type}
        if minmax:
            flat = arr.reshape(n, -1)
            acc["min"] = [float(v) for v in flat.min(axis=0)]
            acc["max"] = [float(v) for v in flat.max(axis=0)]
        self.accessors.append(acc)
        return len(self.accessors) - 1


def _write_glb(path: str, gltf: dict, blob: bytes) -> None:
    js = json.dumps(gltf, separators=(",", ":")).encode()
    js += b" " * (-len(js) % 4)
    bb = bytes(blob) + b"\0" * (-len(blob) % 4)
    total = 12 + 8 + len(js) + 8 + len(bb)
    with open(path, "wb") as f:
        f.write(struct.pack("<III", _MAGIC, 2, total))
        f.write(struct.pack("<II", len(js), _CHUNK_JSON))
        f.write(js)
        f.write(struct.pack("<II", len(bb), _CHUNK_BIN))
        f.write(bb)


def read_glb(path: str) -> Tuple[dict, bytes]:
    """Minimal GLB parser: returns (gltf json dict, binary chunk bytes)."""
    with open(path, "rb") as f:
        data = f.read()
    magic, version, total = struct.unpack_from("<III", data, 0)
    if magic != _MAGIC or version != 2:
        raise ValueError(f"not a glTF 2.0 binary: magic={magic:#x} v{version}")
    if total != len(data):
        raise ValueError(f"glb length mismatch: header {total}, file {len(data)}")
    off = 12
    gltf, blob = None, b""
    while off < len(data):
        clen, ctype = struct.unpack_from("<II", data, off)
        off += 8
        chunk = data[off:off + clen]
        off += clen
        if ctype == _CHUNK_JSON:
            gltf = json.loads(chunk.decode())
        elif ctype == _CHUNK_BIN:
            blob = chunk
    if gltf is None:
        raise ValueError("glb has no JSON chunk")
    return gltf, blob


def read_accessor(gltf: dict, blob: bytes, index: int) -> np.ndarray:
    """Decode accessor ``index`` from the binary chunk (tight packing only,
    which is all this writer emits)."""
    acc = gltf["accessors"][index]
    view = gltf["bufferViews"][acc["bufferView"]]
    dtype = {_FLOAT: np.float32, _UINT32: np.uint32,
             _USHORT: np.uint16}[acc["componentType"]]
    k = _TYPE_COUNT[acc["type"]]
    start = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
    out = np.frombuffer(blob, dtype, count=acc["count"] * k, offset=start)
    if acc["type"] == "MAT4":
        return out.reshape(acc["count"], 4, 4)
    return out.reshape(acc["count"], k) if k > 1 else out


def _mesh_primitive(b: _Builder, verts, faces, colors=None, extra=None):
    verts = np.asarray(verts, np.float32)
    faces = np.asarray(faces, np.uint32)
    attrs = {"POSITION": b.add(verts, "VEC3", _FLOAT, target=34962,
                               minmax=True)}
    if colors is not None:
        c = np.asarray(colors, np.float32)
        if c.max(initial=0.0) > 1.0:   # 0..255 -> 0..1
            c = c / 255.0
        attrs["COLOR_0"] = b.add(np.clip(c, 0.0, 1.0), "VEC3", _FLOAT,
                                 target=34962)
    if extra:
        attrs.update(extra)
    idx = b.add(faces.reshape(-1), "SCALAR", _UINT32, target=34963)
    return {"attributes": attrs, "indices": idx, "mode": 4}


def export_glb(path: str, verts: np.ndarray, faces: np.ndarray,
               colors: Optional[np.ndarray] = None,
               name: str = "tpubody") -> None:
    """Write a static triangle mesh (optionally vertex-colored) as a GLB."""
    b = _Builder()
    prim = _mesh_primitive(b, verts, faces, colors)
    gltf = {
        "asset": {"version": "2.0", "generator": "tpubody"},
        "scene": 0,
        "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0, "name": name}],
        "meshes": [{"primitives": [prim], "name": name}],
        "buffers": [{"byteLength": len(b.blob)}],
        "bufferViews": b.buffer_views,
        "accessors": b.accessors,
    }
    _write_glb(path, gltf, b.blob)


def _skin_sets(weights: np.ndarray, max_influences: int):
    """Top-k joint influences per vertex -> glTF JOINTS_n/WEIGHTS_n vec4 sets.

    ``max_influences`` rounds up to a multiple of 4; truncated weights are
    renormalized so each vertex still sums to 1 (glTF requirement).
    """
    w = np.asarray(weights, np.float64)
    V, J = w.shape
    k = min(max(4, int(np.ceil(max_influences / 4) * 4)), int(np.ceil(J / 4) * 4))
    take = min(k, J)
    order = np.argsort(-w, axis=1)[:, :take]
    top = np.take_along_axis(w, order, axis=1)
    joints = np.zeros((V, k), np.uint16)
    vals = np.zeros((V, k), np.float64)
    joints[:, :take] = order.astype(np.uint16)
    vals[:, :take] = top
    total = np.maximum(vals.sum(axis=1, keepdims=True), 1e-12)
    vals = vals / total
    # Zero-weight slots must reference joint 0 per spec recommendation.
    joints[vals == 0.0] = 0
    return [(joints[:, i:i + 4], vals[:, i:i + 4].astype(np.float32))
            for i in range(0, k, 4)]


def _quat_xyzw(poses: np.ndarray) -> np.ndarray:
    """Axis-angle (..., 3) -> glTF quaternions (..., 4) in xyzw order."""
    r = np.asarray(poses, np.float64)
    theta = np.sqrt((r * r).sum(axis=-1, keepdims=True) + 1e-16)
    axis = r / theta
    half = theta * 0.5
    xyz = np.sin(half) * axis
    return np.concatenate([xyz, np.cos(half)], axis=-1).astype(np.float32)


def export_avatar_glb(
    path: str,
    avatar,
    poses: Optional[np.ndarray] = None,
    trans: Optional[np.ndarray] = None,
    fps: float = 30.0,
    max_influences: int = 8,
    clip_name: str = "motion",
    zero_ignored: bool = True,
) -> None:
    """Export a ``rigging.RiggedAvatar`` as a skinned GLB.

    poses: optional (F, J, 3) axis-angle clip -> a glTF animation with one
    rotation channel per joint (and a root translation channel when ``trans``
    (F, 3) is given), sampled at ``fps``.  ``zero_ignored`` applies the same
    chest/hand pose-zeroing as ``rigging.animate`` (IGNORED_JOINTS) so the
    exported motion matches the in-framework renderer frame-for-frame.

    max_influences: joint influences kept per vertex (rounded up to vec4
    sets).  8 (two sets) is lossless for typical rasterized SMPL weights;
    pass ``avatar.weights.shape[1]`` for exact dense weights (engines that
    only honor JOINTS_0 will use the 4 strongest, renormalized).
    """
    from tpubody_torch.mesh import rigging as rigging_lib

    J = np.asarray(avatar.joints, np.float64)      # (J, 3) T-pose, global
    parents = tuple(int(p) for p in avatar.parents)
    nj = len(parents)

    b = _Builder()
    sets = _skin_sets(avatar.weights, max_influences)
    extra = {}
    for i, (jnts, wts) in enumerate(sets):
        extra[f"JOINTS_{i}"] = b.add(jnts, "VEC4", _USHORT, target=34962)
        extra[f"WEIGHTS_{i}"] = b.add(wts, "VEC4", _FLOAT, target=34962)
    prim = _mesh_primitive(b, avatar.v_template, avatar.faces,
                           avatar.color, extra)

    # Nodes: 0 = skinned mesh, 1+j = joint j.  Local translation is the
    # T-pose bone offset; glTF composes T.R down the chain exactly like the
    # SMPL kinematic chain (models/smpl_np.py:179-188).
    nodes = [{"mesh": 0, "skin": 0, "name": "avatar"}]
    for j in range(nj):
        local = J[j] - (J[parents[j]] if parents[j] >= 0 else 0.0)
        node = {"name": f"joint_{j}",
                "translation": [float(v) for v in local]}
        nodes.append(node)
    for j in range(nj):
        if parents[j] >= 0:
            nodes[1 + parents[j]].setdefault("children", []).append(1 + j)

    # Inverse bind matrices: translate(-J_global) per joint, column-major —
    # identical to the reference's G' = G - pack(G.[J,0]) rest-removal
    # (models/smpl_np.py:192-197).
    ibm = np.tile(np.eye(4, dtype=np.float32), (nj, 1, 1))
    ibm[:, 3, :3] = -J.astype(np.float32)  # column-major: row 3 = translation
    ibm_acc = b.add(ibm, "MAT4", _FLOAT)

    gltf = {
        "asset": {"version": "2.0", "generator": "tpubody"},
        "scene": 0,
        "scenes": [{"nodes": [0, 1]}],
        "nodes": nodes,
        "meshes": [{"primitives": [prim], "name": "avatar"}],
        "skins": [{"inverseBindMatrices": ibm_acc,
                   "joints": [1 + j for j in range(nj)],
                   "skeleton": 1}],
        "buffers": [{"byteLength": 0}],
        "bufferViews": b.buffer_views,
        "accessors": b.accessors,
    }

    if poses is not None:
        p = np.asarray(poses, np.float64)
        if p.ndim == 2:
            p = p[None]
        F = p.shape[0]
        if zero_ignored and nj == 24:
            p = p.copy()
            p[:, list(rigging_lib.IGNORED_JOINTS), :] = 0.0
        times = (np.arange(F, dtype=np.float32) / float(fps))
        t_acc = b.add(times, "SCALAR", _FLOAT, minmax=True)
        quats = _quat_xyzw(p)                      # (F, J, 4)
        samplers, channels = [], []
        for j in range(nj):
            out = b.add(np.ascontiguousarray(quats[:, j]), "VEC4", _FLOAT)
            samplers.append({"input": t_acc, "output": out,
                             "interpolation": "LINEAR"})
            channels.append({"sampler": len(samplers) - 1,
                             "target": {"node": 1 + j, "path": "rotation"}})
        if trans is not None:
            tr = np.asarray(trans, np.float32).reshape(F, 3)
            # Root node carries rest offset J[0]; the channel overrides the
            # node translation, so bake J[0] in.
            out = b.add(tr + J[0].astype(np.float32), "VEC3", _FLOAT)
            samplers.append({"input": t_acc, "output": out,
                             "interpolation": "LINEAR"})
            channels.append({"sampler": len(samplers) - 1,
                             "target": {"node": 1, "path": "translation"}})
        gltf["animations"] = [{"name": clip_name, "samplers": samplers,
                               "channels": channels}]

    gltf["buffers"][0]["byteLength"] = len(b.blob)
    _write_glb(path, gltf, b.blob)

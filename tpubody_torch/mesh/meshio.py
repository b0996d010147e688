"""Colored mesh export: PLY (binary/ascii) and OBJ (the port's own copy
of ``tpubody.mesh.meshio``, numpy only).

Replaces the reference's hand-rolled PLY writer (lib/Depth2Mesh_Bspline.py:
526-594) and trimesh exports.  Pure host-side IO boundary.
"""
from __future__ import annotations

import struct

import numpy as np


def write_ply(path: str, verts: np.ndarray, faces: np.ndarray,
              colors: np.ndarray = None, binary: bool = True) -> None:
    """verts (N,3) float; faces (F,3) int; colors (N,3) in [0,255] or [0,1]."""
    verts = np.asarray(verts, np.float32)
    faces = np.asarray(faces, np.int32)
    has_color = colors is not None
    if has_color:
        colors = np.asarray(colors)
        if colors.max() <= 1.0 + 1e-6:
            colors = colors * 255.0
        colors = np.clip(colors, 0, 255).astype(np.uint8)

    header = ["ply",
              "format binary_little_endian 1.0" if binary else
              "format ascii 1.0",
              f"element vertex {verts.shape[0]}",
              "property float x", "property float y", "property float z"]
    if has_color:
        header += ["property uchar red", "property uchar green",
                   "property uchar blue"]
    header += [f"element face {faces.shape[0]}",
               "property list uchar int vertex_indices", "end_header"]

    if binary:
        with open(path, "wb") as fp:
            fp.write(("\n".join(header) + "\n").encode())
            # Vectorized record packing (a python pack loop costs seconds
            # at the pipeline's ~700k-face meshes).
            if has_color:
                vrec = np.empty(
                    verts.shape[0],
                    dtype=[("xyz", "<f4", 3), ("rgb", "u1", 3)])
                vrec["xyz"] = verts
                vrec["rgb"] = colors
                fp.write(vrec.tobytes())
            else:
                fp.write(verts.astype("<f4").tobytes())
            frec = np.empty(faces.shape[0],
                            dtype=[("n", "u1"), ("idx", "<i4", 3)])
            frec["n"] = 3
            frec["idx"] = faces
            fp.write(frec.tobytes())
    else:
        with open(path, "w") as fp:
            fp.write("\n".join(header) + "\n")
            for i, v in enumerate(verts):
                line = f"{v[0]} {v[1]} {v[2]}"
                if has_color:
                    c = colors[i]
                    line += f" {c[0]} {c[1]} {c[2]}"
                fp.write(line + "\n")
            for f in faces:
                fp.write(f"3 {f[0]} {f[1]} {f[2]}\n")


def read_ply(path: str):
    """Minimal PLY reader (both formats written above)."""
    with open(path, "rb") as fp:
        data = fp.read()
    head_end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:head_end].decode().splitlines()
    binary = any("binary" in h for h in header)
    n_verts = n_faces = 0
    has_color = any("red" in h for h in header)
    for h in header:
        if h.startswith("element vertex"):
            n_verts = int(h.split()[-1])
        elif h.startswith("element face"):
            n_faces = int(h.split()[-1])
    verts = np.zeros((n_verts, 3), np.float32)
    colors = np.zeros((n_verts, 3), np.uint8) if has_color else None
    faces = np.zeros((n_faces, 3), np.int32)
    if binary:
        off = head_end
        vsize = 12 + (3 if has_color else 0)
        for i in range(n_verts):
            verts[i] = struct.unpack_from("<fff", data, off)
            if has_color:
                colors[i] = struct.unpack_from("<BBB", data, off + 12)
            off += vsize
        for i in range(n_faces):
            cnt = data[off]
            faces[i] = struct.unpack_from("<iii", data, off + 1)
            off += 1 + 4 * cnt
    else:
        lines = data[head_end:].decode().splitlines()
        for i in range(n_verts):
            parts = lines[i].split()
            verts[i] = [float(x) for x in parts[:3]]
            if has_color:
                colors[i] = [int(x) for x in parts[3:6]]
        for i in range(n_faces):
            parts = lines[n_verts + i].split()
            faces[i] = [int(x) for x in parts[1:4]]
    return verts, faces, colors


def write_obj(path: str, verts: np.ndarray, faces: np.ndarray) -> None:
    verts = np.asarray(verts)
    with open(path, "w") as fp:
        for v in verts:
            fp.write(f"v {v[0]:f} {v[1]:f} {v[2]:f}\n")
        for f in np.asarray(faces) + 1:
            fp.write(f"f {f[0]} {f[1]} {f[2]}\n")


def read_obj(path: str):
    verts, faces = [], []
    with open(path) as fp:
        for line in fp:
            if line.startswith("v "):
                verts.append([float(x) for x in line.split()[1:4]])
            elif line.startswith("f "):
                faces.append([int(t.split("/")[0]) - 1
                              for t in line.split()[1:4]])
    return np.asarray(verts, np.float64), np.asarray(faces, np.int64)


def write_off(path: str, verts: np.ndarray, faces: np.ndarray) -> None:
    """ASCII OFF export (reference lib/reconstruct/obj_functions.py:298-307)."""
    verts = np.asarray(verts, np.float64)
    faces = np.asarray(faces, np.int64)
    with open(path, "w") as fp:
        fp.write("OFF\n")
        fp.write(f"{verts.shape[0]} {faces.shape[0]} 0\n")
        fp.write("".join(f"{v[0]:g} {v[1]:g} {v[2]:g}\n" for v in verts))
        fp.write("".join(f"3 {f[0]} {f[1]} {f[2]}\n" for f in faces))


def read_off(path: str):
    """ASCII OFF import; tolerates comments, blank lines, and counts on the
    header line ("OFF nv nf ne")."""
    with open(path) as fp:
        tokens = []
        for line in fp:
            line = line.split("#", 1)[0].strip()
            if line:
                tokens.extend(line.split())
    if not tokens or not tokens[0].upper().endswith("OFF"):
        raise ValueError(f"not an OFF file: {path}")
    tokens = tokens[1:]
    n_verts, n_faces = int(tokens[0]), int(tokens[1])
    pos = 3  # skip edge count
    verts = np.array(tokens[pos:pos + 3 * n_verts],
                     np.float64).reshape(n_verts, 3)
    pos += 3 * n_verts
    faces = np.empty((n_faces, 3), np.int64)
    for i in range(n_faces):
        cnt = int(tokens[pos])
        if cnt != 3:
            raise ValueError("only triangular OFF faces supported")
        faces[i] = [int(t) for t in tokens[pos + 1:pos + 4]]
        pos += 1 + cnt
    return verts, faces

"""Minimal PLY mesh IO (ascii + binary little/big endian).

Counterpart of ``tropical/utils/ply.py`` (numpy on the host: meshes are
read and written as files).  Only vertex positions and triangular faces are
handled; other properties are skipped on read.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

_DTYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


@dataclass
class Mesh:
    vertices: np.ndarray  # [V, 3] float
    faces: np.ndarray     # [F, 3] int

    def export(self, path: str):
        write_ply(path, self.vertices, self.faces)


def read_ply(path: str) -> Mesh:
    with open(path, "rb") as f:
        data = f.read()

    header_end = data.find(b"end_header\n")
    if header_end < 0:
        raise ValueError(f"not a PLY file: {path}")
    header = data[:header_end].decode("ascii", "replace").splitlines()
    body = data[header_end + len(b"end_header\n"):]

    fmt = None
    elements = []  # (name, count, [(prop_kind, ...)])
    for line in header:
        parts = line.strip().split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append([parts[1], int(parts[2]), []])
        elif parts[0] == "property":
            if parts[1] == "list":
                elements[-1][2].append(("list", _DTYPES[parts[2]],
                                        _DTYPES[parts[3]], parts[4]))
            else:
                elements[-1][2].append(("scalar", _DTYPES[parts[1]], parts[2]))

    endian = {"binary_little_endian": "<", "binary_big_endian": ">"}.get(fmt)
    vertices, faces = None, None

    if fmt == "ascii":
        tokens = body.decode("ascii").split("\n")
        ti = 0
        for name, count, props in elements:
            rows = []
            for _ in range(count):
                while ti < len(tokens) and not tokens[ti].strip():
                    ti += 1
                rows.append(tokens[ti].split())
                ti += 1
            if name == "vertex":
                cols = [i for i, p in enumerate(props) if p[0] == "scalar"]
                names = [props[i][2] for i in cols]
                arr = np.asarray([[float(r[i]) for i in cols] for r in rows])
                vertices = arr[:, [names.index("x"), names.index("y"),
                                   names.index("z")]]
            elif name == "face":
                # keep as a list of rows: polygons may have mixed arity
                faces = [np.asarray([int(v) for v in r[1:1 + int(r[0])]],
                                    np.int64) for r in rows]
    else:
        off = 0
        for name, count, props in elements:
            if all(p[0] == "scalar" for p in props):
                dt = np.dtype([(f"p{i}", endian + p[1])
                               for i, p in enumerate(props)])
                arr = np.frombuffer(body, dt, count, off)
                off += dt.itemsize * count
                if name == "vertex":
                    names = [p[2] for p in props]
                    vertices = np.stack([
                        arr[f"p{names.index(n)}"].astype(np.float64)
                        for n in ("x", "y", "z")], axis=-1)
            else:
                # list property (faces): parse row by row
                rows = []
                for _ in range(count):
                    for p in props:
                        if p[0] == "list":
                            cnt_dt = np.dtype(endian + p[1])
                            n = int(np.frombuffer(body, cnt_dt, 1, off)[0])
                            off += cnt_dt.itemsize
                            idx_dt = np.dtype(endian + p[2])
                            vals = np.frombuffer(body, idx_dt, n, off)
                            off += idx_dt.itemsize * n
                            rows.append(vals.astype(np.int64))
                        else:
                            off += np.dtype(endian + p[1]).itemsize
                if name == "face":
                    faces = rows

    if vertices is None:
        raise ValueError(f"PLY without vertex element: {path}")

    # triangulate polygonal faces (fan)
    tris = []
    if faces is not None:
        for row in faces:
            row = np.asarray(row, np.int64)
            for j in range(1, len(row) - 1):
                tris.append((row[0], row[j], row[j + 1]))
    faces = (np.asarray(tris, np.int64) if tris
             else np.empty((0, 3), np.int64))
    return Mesh(np.asarray(vertices, np.float64), faces)


def write_ply(path: str, vertices: np.ndarray, faces: np.ndarray):
    """Binary little-endian PLY with float32 vertices and int32 face indices."""
    vertices = np.asarray(vertices, np.float32)
    faces = np.asarray(faces, np.int32)
    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        f.write(b"comment tropical-torch\n")
        f.write(f"element vertex {len(vertices)}\n".encode())
        f.write(b"property float x\nproperty float y\nproperty float z\n")
        f.write(f"element face {len(faces)}\n".encode())
        f.write(b"property list uchar int vertex_indices\n")
        f.write(b"end_header\n")
        f.write(vertices.astype("<f4").tobytes())
        if len(faces):
            rec = np.empty(len(faces),
                           np.dtype([("n", "u1"), ("v", "<i4", (3,))]))
            rec["n"] = 3
            rec["v"] = faces
            f.write(rec.tobytes())

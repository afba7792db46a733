"""Minimal PLY reader and writer (a copy of the JAX package's utils/ply.py;
replaces pytorch3d.io.load_ply for dataset reading).

Supports ascii and binary little/big endian, vertex x/y/z properties and
optional triangular faces (uchar/int list). Returns numpy arrays.
"""

from __future__ import annotations

import struct
from io import BytesIO
from typing import BinaryIO, Optional, Tuple, Union

import numpy as np

_TYPES = {
    "char": "i1", "uchar": "u1", "int8": "i1", "uint8": "u1",
    "short": "i2", "ushort": "u2", "int16": "i2", "uint16": "u2",
    "int": "i4", "uint": "u4", "int32": "i4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}


def load_ply(fh: Union[str, BinaryIO, BytesIO]
             ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    if isinstance(fh, str):
        with open(fh, "rb") as f:
            return load_ply(f)

    magic = fh.readline().strip()
    if magic != b"ply":
        raise ValueError("not a PLY file")
    fmt = None
    elements = []  # (name, count, [(prop_name, dtype) or ('list', idx_t, cnt_t, name)])
    cur = None
    while True:
        line = fh.readline().decode("ascii").strip()
        if line.startswith("comment"):
            continue
        if line.startswith("format"):
            fmt = line.split()[1]
        elif line.startswith("element"):
            _, name, count = line.split()
            cur = (name, int(count), [])
            elements.append(cur)
        elif line.startswith("property"):
            parts = line.split()
            if parts[1] == "list":
                cur[2].append(("list", _TYPES[parts[2]], _TYPES[parts[3]],
                               parts[4]))
            else:
                cur[2].append((parts[2], _TYPES[parts[1]]))
        elif line == "end_header":
            break

    endian = {"binary_little_endian": "<", "binary_big_endian": ">"}.get(fmt)
    verts = None
    faces = None
    for name, count, props in elements:
        if fmt == "ascii":
            rows = [fh.readline().split() for _ in range(count)]
            if name == "vertex":
                names = [p[0] for p in props]
                arr = np.asarray(rows, np.float64)
                xi, yi, zi = names.index("x"), names.index("y"), names.index("z")
                verts = arr[:, [xi, yi, zi]].astype(np.float32)
            elif name == "face":
                faces = np.asarray(
                    [[int(v) for v in r[1:4]] for r in rows], np.int64)
        else:
            if all(p[0] != "list" for p in props):
                dt = np.dtype([(p[0], endian + p[1]) for p in props])
                arr = np.frombuffer(fh.read(dt.itemsize * count), dt)
                if name == "vertex":
                    verts = np.stack(
                        [arr["x"], arr["y"], arr["z"]], -1).astype(np.float32)
            else:
                # list properties read row by row (faces)
                out = []
                for _ in range(count):
                    for p in props:
                        if p[0] == "list":
                            n = np.frombuffer(
                                fh.read(np.dtype(endian + p[1]).itemsize),
                                endian + p[1])[0]
                            idx = np.frombuffer(
                                fh.read(int(n) * np.dtype(endian + p[2]).itemsize),
                                endian + p[2])
                            out.append(idx[:3])
                        else:
                            fh.read(np.dtype(endian + p[1]).itemsize)
                if name == "face":
                    faces = np.asarray(out, np.int64)
    return verts, faces


def save_ply(path: str, verts: np.ndarray,
             faces: Optional[np.ndarray] = None) -> None:
    """Binary little-endian PLY writer (for fixtures and exports)."""
    with open(path, "wb") as f:
        hdr = [b"ply", b"format binary_little_endian 1.0",
               f"element vertex {len(verts)}".encode(),
               b"property float x", b"property float y", b"property float z"]
        if faces is not None:
            hdr += [f"element face {len(faces)}".encode(),
                    b"property list uchar int vertex_indices"]
        hdr.append(b"end_header")
        f.write(b"\n".join(hdr) + b"\n")
        f.write(np.asarray(verts, "<f4").tobytes())
        if faces is not None:
            for face in np.asarray(faces, "<i4"):
                f.write(struct.pack("<B", 3) + face.tobytes())

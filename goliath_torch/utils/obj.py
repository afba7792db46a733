"""Minimal Wavefront OBJ loader (port of the JAX package's utils/obj.py;
host-side numpy in both packages)."""

from __future__ import annotations

from typing import BinaryIO, Dict, Union

import numpy as np


def load_obj(path_or_fh: Union[str, BinaryIO]) -> Dict[str, np.ndarray]:
    """Load v/vt/f from an OBJ; triangulates polygon faces by fanning.

    Returns dict with v [V,3] f32, vt [T,2] f32, vi [F,3] i32, vti [F,3] i32
    (vt and vti only where the file has them)."""
    if isinstance(path_or_fh, str):
        with open(path_or_fh, "r") as f:
            lines = f.readlines()
    else:
        lines = [
            ln.decode() if isinstance(ln, bytes) else ln
            for ln in path_or_fh.readlines()
        ]

    v, vt, vi, vti = [], [], [], []
    for line in lines:
        parts = line.strip().split()
        if not parts:
            continue
        if parts[0] == "v":
            v.append([float(x) for x in parts[1:4]])
        elif parts[0] == "vt":
            vt.append([float(x) for x in parts[1:3]])
        elif parts[0] == "f":
            idx = []
            tidx = []
            for tok in parts[1:]:
                comps = tok.split("/")
                idx.append(int(comps[0]) - 1)
                if len(comps) > 1 and comps[1]:
                    tidx.append(int(comps[1]) - 1)
            for k in range(1, len(idx) - 1):  # fan triangulation
                vi.append([idx[0], idx[k], idx[k + 1]])
                if tidx:
                    vti.append([tidx[0], tidx[k], tidx[k + 1]])

    out = {
        "v": np.asarray(v, np.float32),
        "vi": np.asarray(vi, np.int32),
    }
    if vt:
        out["vt"] = np.asarray(vt, np.float32)
    if vti:
        out["vti"] = np.asarray(vti, np.int32)
    return out

"""Environment-map file IO (port of the JAX package's utils/hdr.py, kept
here as its own copy: the port imports nothing of the JAX package).

Reads Radiance ``.hdr`` (new-style RLE and flat scanlines), ``.npy`` /
``.npz`` arrays and, through PIL imported only then, LDR images. Returns
float32 [H, W, 3] linear RGB. Host-side numpy, as in the JAX package, so
both give the same bits.
"""

from __future__ import annotations

import os

import numpy as np


def _read_hdr(path: str) -> np.ndarray:
    """Radiance RGBE (.hdr) reader (new-style RLE + uncompressed)."""
    with open(path, "rb") as f:
        line = f.readline().strip()
        if not line.startswith(b"#?"):
            raise ValueError("not a Radiance HDR file")
        while True:
            line = f.readline()
            if line.strip() == b"":
                break
        dims = f.readline().split()
        # expect: -Y H +X W
        H = int(dims[1])
        W = int(dims[3])
        data = np.zeros((H, W, 4), np.uint8)
        for y in range(H):
            head = f.read(4)
            if len(head) < 4:
                raise ValueError("truncated HDR")
            if head[0] == 2 and head[1] == 2 and (head[2] << 8 | head[3]) == W:
                # new-style RLE: 4 channel-planes
                for c in range(4):
                    x = 0
                    while x < W:
                        n = f.read(1)[0]
                        if n > 128:  # run
                            v = f.read(1)[0]
                            data[y, x: x + n - 128, c] = v
                            x += n - 128
                        else:  # literal
                            data[y, x: x + n, c] = np.frombuffer(
                                f.read(n), np.uint8)
                            x += n
            else:
                # flat RGBE scanline
                rest = np.frombuffer(f.read(4 * (W - 1)), np.uint8)
                row = np.concatenate(
                    [np.frombuffer(head, np.uint8), rest]).reshape(W, 4)
                data[y] = row
    rgbe = data.astype(np.float32)
    e = rgbe[..., 3]
    scale = np.where(e > 0, np.ldexp(1.0, e.astype(np.int32) - 136), 0.0)
    return rgbe[..., :3] * scale[..., None]


def load_envmap(path: str) -> np.ndarray:
    ext = os.path.splitext(path)[1].lower()
    if ext == ".hdr":
        return _read_hdr(path)
    if ext in (".npy",):
        return np.asarray(np.load(path), np.float32)
    if ext == ".npz":
        return np.asarray(np.load(path)["envmap"], np.float32)
    from PIL import Image

    img = np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0
    return img**2.2  # approximate linearization


def resize_area(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """Area resize [H, W, C] via block averaging / bilinear fallback."""
    H, W = img.shape[:2]
    if H % h == 0 and W % w == 0:
        return img.reshape(h, H // h, w, W // w, -1).mean(axis=(1, 3))
    ys = np.clip((np.arange(h) + 0.5) * H / h - 0.5, 0, H - 1)
    xs = np.clip((np.arange(w) + 0.5) * W / w - 0.5, 0, W - 1)
    y0 = np.floor(ys).astype(int)
    x0 = np.floor(xs).astype(int)
    y1 = np.minimum(y0 + 1, H - 1)
    x1 = np.minimum(x0 + 1, W - 1)
    wy = (ys - y0)[:, None, None]
    wx = (xs - x0)[None, :, None]
    return ((img[y0][:, x0] * (1 - wx) + img[y0][:, x1] * wx) * (1 - wy)
            + (img[y1][:, x0] * (1 - wx) + img[y1][:, x1] * wx) * wy)

"""Evaluation loop (port of the JAX package's test.py).

No-grad forward, per-batch losses accumulated to means, optional 4-panel
PNG dumps (gt / pred / mask / L2 x 20).
"""

from __future__ import annotations

import logging
import os
import struct
import time
import zlib
from collections import defaultdict
from typing import Any, Callable, Dict, Iterator, List, Mapping, Optional

import numpy as np
import torch

logger = logging.getLogger(__name__)


def _save_png(path: str, img: np.ndarray) -> None:
    """img: [H, W, 3] uint8; minimal PNG writer (no PIL dependency)."""
    h, w = img.shape[:2]
    raw = b"".join(
        b"\x00" + img[i].astype(np.uint8).tobytes() for i in range(h)
    )

    def chunk(tag, data):
        c = tag + data
        return struct.pack(">I", len(data)) + c + struct.pack(
            ">I", zlib.crc32(c) & 0xFFFFFFFF
        )

    png = (b"\x89PNG\r\n\x1a\n"
           + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
           + chunk(b"IDAT", zlib.compress(raw))
           + chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(png)


def to_device(batch: Mapping[str, Any], device: torch.device
              ) -> Dict[str, torch.Tensor]:
    """numpy (or tensor) batch -> tensors on ``device`` (string fields are
    dropped)."""
    return {k: (v if isinstance(v, torch.Tensor)
                else torch.as_tensor(np.asarray(v))).to(device)
            for k, v in batch.items() if not isinstance(v, (list, str))}


def test(
    model,
    loss_fn,
    test_data: Iterator,
    config: Mapping[str, Any],
    batch_filter_fn: Optional[Callable] = None,
    vis_path: Optional[str] = None,
    logging_enabled: bool = True,
    frame_seconds: Optional[List[float]] = None,
) -> Dict[str, float]:
    """Returns mean losses over the test set. With ``frame_seconds`` given,
    appends each batch's wall time (forward and losses, ending when the
    losses reach the host)."""
    sums: Dict[str, float] = defaultdict(float)
    count = 0
    if vis_path:
        os.makedirs(vis_path, exist_ok=True)

    for i, batch in enumerate(test_data):
        if batch is None:
            continue
        if batch_filter_fn is not None:
            batch = batch_filter_fn(batch)
        tb = to_device(batch, model.device)
        t0 = time.perf_counter()
        with torch.no_grad():
            preds = model.apply(tb, train=False)
            _, ldict = loss_fn(preds, tb, iteration=0)
            means = {k: float(v.mean()) for k, v in ldict.items()}
        if frame_seconds is not None:
            frame_seconds.append(time.perf_counter() - t0)
        for k, v in means.items():
            sums[k] += v
        count += 1

        if vis_path and "rgb" in preds and "image" in tb:
            gt = tb["image"][0].cpu().numpy().transpose(1, 2, 0)
            pred = preds["rgb"][0].cpu().numpy().transpose(1, 2, 0)
            mask = tb.get("image_mask", torch.ones_like(tb["image"]))[0]
            mask = mask.cpu().numpy()
            if mask.shape[0] == 1:
                mask = np.repeat(mask, 3, axis=0)
            mask = mask.transpose(1, 2, 0)
            l2 = np.clip(((gt - pred) ** 2) * 20.0, 0, 1)
            scale = 255.0 if gt.max() <= 2.0 else 1.0
            panel = np.concatenate(
                [gt * scale, pred * scale, mask * 255.0, l2 * 255.0], axis=1
            )
            _save_png(
                os.path.join(vis_path, f"test_{i:04d}.png"),
                np.clip(panel, 0, 255).astype(np.uint8),
            )

        if logging_enabled and i % config.get("test", {}).get(
            "log_every_n_steps", 1
        ) == 0:
            logger.info(f"eval batch {i}: " + " ".join(
                f"{k}={v:.4f}" for k, v in means.items()))

    means = {k: v / max(count, 1) for k, v in sums.items()}
    logger.info(f"eval means: {means}")
    return means

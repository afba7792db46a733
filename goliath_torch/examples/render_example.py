"""Checkpoint-render example (port of the JAX package's
examples/render_example.py, the reference's
notebooks/render_example_cca.ipynb): load a config and its data, drop the
training-only camera modules (``cal``, ``pixel_cal``, ``learn_blur``), build
the model, optionally restore a checkpoint, run the first 4 samples through
the forward at ``train=False`` and write their ``rgb`` as an image grid.

    python -m goliath_torch.examples.render_example <config.yml> [ckpt] [out.png]

The checkpoint is anything ``goliath_torch.convert.load_params`` reads: a
checkpoint directory (through ``latest``), a ``.pt`` file of this package
or an orbax checkpoint directory of the JAX package. Without one the model
keeps its seeded initialization (the synthetic fixture needs no
downloads). Runs on the card unless ``render(..., device="cpu")``.
"""

from __future__ import annotations

import sys
from typing import Any, Dict, Optional

import numpy as np
import torch

from goliath_torch.config import Config, load_config, load_from_config
from goliath_torch.convert import load_params
from goliath_torch.ops.backend import resolve_device
from goliath_torch.scripts.run_train import build_dataset
from goliath_torch.test import _save_png

N_SAMPLES = 4


def image_grid(imgs: np.ndarray, nrow: int = 4) -> np.ndarray:
    """[B, 3, H, W] -> [H', W', 3] tiled grid (torchvision make_grid)."""
    b, c, h, w = imgs.shape
    ncol = min(nrow, b)
    nr = -(-b // ncol)
    pad = nr * ncol - b
    imgs = np.concatenate([imgs, np.zeros((pad, c, h, w), imgs.dtype)])
    grid = imgs.reshape(nr, ncol, c, h, w).transpose(0, 3, 1, 4, 2)
    return grid.reshape(nr * h, ncol * w, c)


def to_uint8_grid(rgb: np.ndarray) -> np.ndarray:
    """[B, 3, H, W] float -> the example's [H', W', 3] uint8 grid (the body
    models emit 0..255, the others 0..1)."""
    scale = 255.0 if rgb.max() > 2.0 else 1.0
    grid = np.clip(image_grid(rgb) / scale, 0, 1)
    return (grid * 255).astype(np.uint8)


def render(config: Config, ckpt: Optional[str] = None,
           out_path: str = "render_example.png",
           device: str = "cuda") -> Dict[str, Any]:
    """Render the first samples of ``config``'s data with its model (from
    ``ckpt`` where given) and write the grid to ``out_path``. Returns the
    grid (``"grid"``, [H', W', 3] uint8), the batch and the model."""
    device = resolve_device(device)
    dataset = build_dataset(dict(config.data), device=device)

    # the training-only camera modules are off, as in the reference notebook
    model_cfg = Config.wrap(dict(config.model))
    model_cfg.pop("cal", None)
    model_cfg.pop("pixel_cal", None)
    model_cfg["learn_blur"] = False
    model = load_from_config(model_cfg, assets=dataset.static_assets,
                             device=device)

    samples = [dataset[i] for i in range(min(N_SAMPLES, len(dataset)))]
    batch = {
        k: torch.as_tensor(np.stack([np.asarray(s[k]) for s in samples]))
        .to(device)
        for k in samples[0] if not isinstance(samples[0][k], (str, bytes))
    }
    if ckpt:
        load_params(model.module, str(ckpt))

    with torch.no_grad():
        preds = model.apply(batch, train=False)
    grid = to_uint8_grid(preds["rgb"].float().cpu().numpy())
    _save_png(out_path, grid)
    print(f"wrote {out_path} ({grid.shape[1]}x{grid.shape[0]})")
    return {"grid": grid, "batch": batch, "model": model}


def main() -> None:
    cfg_path = sys.argv[1] if len(sys.argv) > 1 else "configs/rgca_synthetic.yml"
    ckpt = sys.argv[2] if len(sys.argv) > 2 else None
    out_path = sys.argv[3] if len(sys.argv) > 3 else "render_example.png"
    render(load_config(cfg_path), ckpt, out_path)


if __name__ == "__main__":
    main()

"""Relighting visualization (port of the JAX package's
scripts/run_vis_relight.py).

Renders a point-light sweep (``SingleLightCycleDecorator``) and, where
``vis.envmap_path`` names an envmap (``.hdr``, ``.npy``, ``.npz`` or an LDR
image), an HDRI spin (``EnvSpinDecorator``, the RGCA envmap branch: each
frame holds the composite, diffuse and specular panels side by side) of
the model of a config, ``vis.n_frames`` frames each, as PNGs under
``vis.output_dir`` (``light_sweep/``, ``env_spin/``); with ``ffmpeg`` on
PATH each sequence is also encoded to an mp4. The model drops ``cal`` and
runs without ``learn_blur``; ``test.ckpt.ckpt_path`` (a checkpoint
directory, the JAX package's orbax checkpoint or a ``.pt`` file) is loaded
where given, else the weights are those drawn from seed 0. A
``vis.envmap_path`` that does not exist raises. Runs on the card unless
``device="cpu"``.

    python -m goliath_torch.scripts.run_vis_relight <config.yml> [a.b=value ...]
"""

from __future__ import annotations

import logging
import os
import shutil
import subprocess
import sys

import numpy as np
import torch

from goliath_torch.config import Config, load_config, load_from_config
from goliath_torch.convert import load_params
from goliath_torch.data.pipeline import collate
from goliath_torch.ops.backend import resolve_device
from goliath_torch.scripts.run_train import build_dataset
from goliath_torch.test import _save_png, to_device
from goliath_torch.utils.image import linear2srgb
from goliath_torch.utils.light_decorator import (
    EnvSpinDecorator,
    SingleLightCycleDecorator,
)

logger = logging.getLogger(__name__)


def _encode_video(frame_dir: str, out_path: str, fps: int = 30) -> None:
    if shutil.which("ffmpeg") is None:
        logger.info(f"ffmpeg not available; frames left in {frame_dir}")
        return
    subprocess.run(
        ["ffmpeg", "-y", "-framerate", str(fps), "-i",
         os.path.join(frame_dir, "%04d.png"), "-pix_fmt", "yuv420p", out_path],
        check=False,
    )


def _save_frame(path: str, rgb: torch.Tensor) -> None:
    img = linear2srgb(rgb[0].clamp(0.0, 1.0)).cpu().numpy()
    img = (img.transpose(1, 2, 0) * 255).astype(np.uint8)
    _save_png(path, img)


def _render_frames(deco, batch, n_frames: int, frame_dir: str) -> None:
    os.makedirs(frame_dir, exist_ok=True)
    for i in range(n_frames):
        b = dict(batch)
        b["index"] = np.asarray([i])
        with torch.no_grad():
            preds = deco.apply(b, train=False)
        _save_frame(os.path.join(frame_dir, f"{i:04d}.png"), preds["rgb"])


def main(config: Config, device: str = "cuda") -> None:
    device = resolve_device(device)
    vis_cfg = config.get("vis", Config())
    n_frames = int(vis_cfg.get("n_frames", 16))
    out_dir = vis_cfg.get("output_dir", "runs/vis_relight")
    envmap_path = vis_cfg.get("envmap_path", None)
    if envmap_path and not os.path.exists(str(envmap_path)):
        raise FileNotFoundError(f"vis.envmap_path {envmap_path!r} does not "
                                f"exist")

    test_cfg = config.get("test", Config())
    dataset = build_dataset(dict(test_cfg.get("data", config.data)),
                            device=device)
    model_cfg = Config.wrap(dict(config.model))
    model_cfg.pop("cal", None)
    model_cfg["learn_blur"] = False
    model = load_from_config(model_cfg, assets=dataset.static_assets,
                             device=device)
    ckpt = test_cfg.get("ckpt", None)
    if ckpt is not None:
        load_params(model.module, str(ckpt["ckpt_path"]))
    batch = to_device(collate([dataset[0]]), device)

    # 1) point-light sweep
    sweep_dir = os.path.join(out_dir, "light_sweep")
    _render_frames(SingleLightCycleDecorator(model, cycle=n_frames), batch,
                   n_frames, sweep_dir)
    _encode_video(sweep_dir, os.path.join(out_dir, "light_sweep.mp4"))
    logger.info(f"wrote point-light sweep to {sweep_dir}")

    # 2) HDRI spin: rgb holds the [composite | diffuse | specular] panels
    if not envmap_path:
        logger.info("no vis.envmap_path configured; skipping HDRI spin")
        return
    spin_dir = os.path.join(out_dir, "env_spin")
    deco = EnvSpinDecorator(model, envmap_path=str(envmap_path),
                            cycle=n_frames)
    _render_frames(deco, batch, n_frames, spin_dir)
    _encode_video(spin_dir, os.path.join(out_dir, "env_spin.mp4"))
    logger.info(f"wrote env spin to {spin_dir}")


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main(load_config(sys.argv[1], overrides=sys.argv[2:]))

"""CLI eval entry (port of the JAX package's scripts/run_test.py).

Injects a ``psnr`` metric, strips train-only losses, samples
``n_test_frames`` random frames at batch size 1, and drops the per-camera
color calibration and blur. Runs on the card unless ``device="cpu"``.

    python -m goliath_torch.scripts.run_test configs/rgca.yml [a.b=value ...]
"""

from __future__ import annotations

import logging
import random
import sys
from typing import Dict, List, Optional

from goliath_torch import test as test_lib
from goliath_torch.config import Config, load_config, load_from_config
from goliath_torch.convert import load_params
from goliath_torch.data.pipeline import DataLoader
from goliath_torch.losses import ModularLoss
from goliath_torch.ops.backend import resolve_device
from goliath_torch.scripts.run_train import build_dataset

logger = logging.getLogger(__name__)

TRAIN_ONLY_LOSSES = {"learn_blur", "backlit_reg", "kl", "face_kl",
                     "pose_shadow_l2"}


def main(config: Config, device: str = "cuda",
         frame_seconds: Optional[List[float]] = None) -> Dict[str, float]:
    """Evaluate the model of ``config`` on its test split; returns (and
    prints) the loss means."""
    device = resolve_device(device)
    test_cfg = config.get("test", Config())
    dataset = build_dataset(dict(test_cfg.get("data", config.data)))
    static_assets = dataset.static_assets

    model_cfg = Config.wrap(dict(config.model))
    model_cfg.pop("cal", None)
    model_cfg["learn_blur"] = False
    model = load_from_config(model_cfg, assets=static_assets, device=device)

    losses_cfg = {k: v for k, v in dict(config.loss.losses).items()
                  if k not in TRAIN_ONLY_LOSSES}
    losses_cfg["psnr"] = {
        "src_key": "rgb", "tgt_key": "image", "mask_key": "image_weight",
        "weight": 0.0,
    }
    loss_fn = ModularLoss(losses_cfg, assets=static_assets)

    n_frames = int(test_cfg.get("n_test_frames", 12))
    random.seed(42)
    idxs = random.sample(range(len(dataset)), min(n_frames, len(dataset)))

    class Subset:
        def __len__(self):
            return len(idxs)

        def __getitem__(self, i):
            return dataset[idxs[i]]

    loader = DataLoader(Subset(), batch_size=1, shuffle=False, num_workers=0,
                        n_epochs=1)

    ckpt = test_cfg.get("ckpt", None)
    if ckpt is not None:
        load_params(model.module, str(ckpt["ckpt_path"]))

    means = test_lib.test(
        model, loss_fn, iter(loader), config,
        batch_filter_fn=getattr(dataset, "batch_filter", None),
        vis_path=test_cfg.get("vis_path", None),
        frame_seconds=frame_seconds,
    )
    print(means)
    return means


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main(load_config(sys.argv[1], overrides=sys.argv[2:]))

"""CLI train entry (port of the JAX package's scripts/run_train.py).

    python -m goliath_torch.scripts.run_train <config.yml> [a.b=value ...]

Builds dataset, model, optimizer, loss, data loader and summary writer, then
runs the train loop; resumes from ``latest`` if ``train.resume`` is set (the
default) and a checkpoint exists (the port's ``.pt`` or the JAX package's
orbax checkpoint). Runs on the card unless ``device="cpu"``: the data
loader's ``cache_device`` and the synthetic fixture's rendered targets use
the run's device too. A config without ``data.synthetic`` reads a capture
(``BodyDataset``: ``data.root_path`` and ``data.shared_assets_path``).
"""

from __future__ import annotations

import logging
import os
import sys
from typing import Any, Dict, Tuple

import torch
import yaml

from goliath_torch import train as train_lib
from goliath_torch.config import Config, load_config, load_from_config
from goliath_torch.data.pipeline import DataLoader
from goliath_torch.ops.backend import resolve_device
from goliath_torch.optim import build_optimizer

logger = logging.getLogger(__name__)


def build_dataset(data_cfg: Dict[str, Any],
                  device: torch.device | str = "cuda", **kwargs):
    """The dataset a config's ``data`` section names: the synthetic fixture
    (``data.synthetic``; ``device`` is where it renders its targets) or a
    capture read by ``BodyDataset`` on the host."""
    data_cfg = dict(data_cfg)
    if data_cfg.pop("synthetic", False):
        from goliath_torch.data.synthetic import SyntheticDataset

        for k in ("root_path", "shared_assets_path", "split",
                  "fully_lit_only"):
            data_cfg.pop(k, None)
        return SyntheticDataset(**data_cfg, device=device, **kwargs)
    from goliath_torch.data.dataloader import BodyDataset

    return BodyDataset(**data_cfg, **kwargs)


def main(config: Config, device: str = "cuda"
         ) -> Tuple[int, Dict[str, float]]:
    """Train the model of ``config``; returns the final iteration and the
    last step's losses. ``train.seed`` seeds the parameters and the training
    draws."""
    device = resolve_device(device)
    dataset = build_dataset(config.data, device=device)
    static_assets = dataset.static_assets

    generator = torch.Generator().manual_seed(
        int(config.train.get("seed", 0)))
    model = load_from_config(config.model, assets=static_assets,
                             device=device, generator=generator)
    loss_fn = load_from_config(config.loss, assets=static_assets)
    summary_fn = (load_from_config(config.summary)
                  if "summary" in config else None)

    loader = DataLoader(dataset, device=device,
                        **config.get("dataloader", {"batch_size": 1}))
    train_dir = config.train.get("run_dir", "runs/default")
    os.makedirs(train_dir, exist_ok=True)
    with open(os.path.join(train_dir, "config.yml"), "w") as f:
        yaml.safe_dump(config.to_dict(), f)

    # optimizer: top-level `lr` feeds the default group
    opt_cfg = dict(config.optimizer)
    opt_cfg.setdefault("lr", config.get("lr", 1e-3))
    optimizer = build_optimizer(opt_cfg, model.module)

    iteration = 0
    ckpt_dir = config.train.ckpt_dir
    if config.train.get("resume", True) and train_lib.has_checkpoint(ckpt_dir):
        iteration = train_lib.restore_train_state(
            model, optimizer,
            train_lib.load_checkpoint(ckpt_dir, map_location=device))
        logger.info(f"resumed from iteration {iteration}")

    writer = train_lib.SummaryWriterish(
        config.train.get("tb_dir", train_dir + "/tb"))
    try:
        return train_lib.train(
            model, loss_fn, optimizer, iter(loader), config,
            train_writer=writer,
            summary_fn=summary_fn,
            batch_filter_fn=getattr(dataset, "batch_filter", None),
            iteration=iteration,
        )
    finally:
        writer.close()


if __name__ == "__main__":
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s: %(message)s")
    main(load_config(sys.argv[1], overrides=sys.argv[2:]))

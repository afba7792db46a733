"""The port's training loop on the CPU at ``configs/rgca_synthetic.yml``
size: ``scripts.run_train.main`` end to end (losses, checkpoints, resume,
logged scalars), the explosion rollback, the profile window and the
checkpoint helpers. No JAX here: the step's arithmetic is held against the
JAX package in tests/test_torch_rgca_train.py and tests/test_torch_optim.py.
"""

import json
import logging
import math
import os

import torch

from goliath_torch import train as train_lib
from goliath_torch.config import load_config, load_from_config
from goliath_torch.data.pipeline import DataLoader
from goliath_torch.optim import build_optimizer
from goliath_torch.scripts import run_train

# tiny shapes: more intra-op threads only contend with the other test
# workers of a parallel run
torch.set_num_threads(1)

_CFG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "configs", "rgca_synthetic.yml")


def _config(run_dir, *extra):
    return load_config(_CFG, overrides=[f"train.run_dir={run_dir}",
                                        *extra])


def _scalars(run_dir):
    with open(os.path.join(run_dir, "tb", "scalars.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_run_train_writes_checkpoints_logs_and_resumes(tmp_path):
    run = tmp_path / "run"
    it, last = run_train.main(_config(run, "train.n_max_iters=4"),
                              device="cpu")
    assert it == 4
    assert set(last) >= {"loss_total", "loss_rgb_l1", "loss_kl",
                         "loss_learn_blur"}
    assert all(math.isfinite(v) for v in last.values())
    ckpt = run / "checkpoints"
    # ckpt_every_n_steps is 5: iteration 0, then the final save
    assert sorted(os.listdir(ckpt)) == ["000000.pt", "000004.pt", "latest"]
    assert (ckpt / "latest").read_text() == "000004.pt"
    assert (run / "config.yml").exists()

    recs = _scalars(run)
    tags = {r["tag"] for r in recs}
    assert {"Losses/loss_total", "Losses/loss_rgb_l1", "Losses/loss_geom_l2",
            "Losses/loss_kl", "Perf/steps_per_sec"} <= tags
    # log_every_n_steps is 2
    assert sorted({r["step"] for r in recs}) == [0, 2]
    totals = [r["value"] for r in recs if r["tag"] == "Losses/loss_total"]
    assert all(math.isfinite(v) for v in totals) and totals[0] != totals[1]

    saved = train_lib.load_checkpoint(str(ckpt))
    assert saved["iteration"] == 4
    assert set(saved) == {"model", "optimizer", "iteration"}
    assert train_lib.load_checkpoint(str(ckpt), iteration=0)["iteration"] == 0

    # resume: continues from the saved iteration with the saved state
    seen = []
    orig = train_lib.make_train_step

    def spy(model, loss_fn, optimizer):
        for name, p in model.module.named_parameters():
            assert torch.equal(p.detach(), saved["model"][name]), name
        steps = {s["step"].item()
                 for s in optimizer.state_dict()["state"].values()}
        assert steps == {4.0}
        step = orig(model, loss_fn, optimizer)

        def wrapped(batch, iteration):
            seen.append(iteration)
            return step(batch, iteration)

        return wrapped

    train_lib.make_train_step = spy
    try:
        it, _ = run_train.main(_config(run, "train.n_max_iters=6"),
                               device="cpu")
    finally:
        train_lib.make_train_step = orig
    assert it == 6 and seen == [4, 5]
    assert (ckpt / "latest").read_text() == "000006.pt"
    # train.resume=false starts over
    it, _ = run_train.main(_config(run, "train.n_max_iters=1",
                                   "train.resume=false"), device="cpu")
    assert it == 1


def _loop_parts(cfg):
    dataset = run_train.build_dataset(cfg.data)
    model = load_from_config(cfg.model, assets=dataset.static_assets,
                             device="cpu",
                             generator=torch.Generator().manual_seed(0))
    loss_fn = load_from_config(cfg.loss, assets=dataset.static_assets)
    opt_cfg = dict(cfg.optimizer)
    opt_cfg.setdefault("lr", cfg.lr)
    optimizer = build_optimizer(opt_cfg, model.module)
    loader = DataLoader(dataset, batch_size=2, shuffle=True, num_workers=0)
    return model, loss_fn, optimizer, loader


def test_explosion_rolls_back_to_the_checkpoint(tmp_path, caplog):
    """A loss that returns a huge value once (at iteration 3): the lagged
    check sees it one step later, reloads the checkpoint of iteration 2 and
    runs the rolled-back iterations again."""
    cfg = _config(tmp_path / "run", "train.n_max_iters=6",
                  "train.ckpt_every_n_steps=2")
    model, loss_fn, optimizer, loader = _loop_parts(cfg)
    calls = []
    at_rollback = {}

    def exploding(preds, batch, iteration):
        total, ldict = loss_fn(preds, batch, iteration)
        calls.append(iteration)
        if len(calls) == 4:
            total = total * 1e6
        if len(calls) == 6:   # the first step after the rollback
            ckpt = train_lib.load_checkpoint(cfg.train.ckpt_dir, iteration=2)
            at_rollback["same"] = all(
                torch.equal(p.detach(), ckpt["model"][n])
                for n, p in model.module.named_parameters())
        return total, ldict

    with caplog.at_level(logging.INFO, logger="goliath_torch.train"):
        it, last = train_lib.train(model, exploding, optimizer, iter(loader),
                                   cfg)
    assert "explosion detected: iter=3" in caplog.text
    assert calls == [0, 1, 2, 3, 4, 2, 3, 4, 5]
    assert at_rollback["same"]
    assert it == 6 and math.isfinite(last["loss_total"])
    assert last["loss_total"] < 1e5


def test_explosion_without_a_checkpoint_goes_on(tmp_path, caplog):
    cfg = _config(tmp_path / "run", "train.n_max_iters=4")
    model, loss_fn, optimizer, loader = _loop_parts(cfg)
    calls = []

    def exploding(preds, batch, iteration):
        total, ldict = loss_fn(preds, batch, iteration)
        calls.append(iteration)
        return (total * 1e6 if len(calls) == 2 else total), ldict

    with caplog.at_level(logging.INFO, logger="goliath_torch.train"):
        it, _ = train_lib.train(model, exploding, optimizer, iter(loader), cfg,
                                saving_enabled=False)
    assert "explosion detected: iter=1" in caplog.text
    assert calls == [0, 1, 2, 3] and it == 4
    assert not os.path.exists(cfg.train.ckpt_dir)


def test_profile_window_and_summary_images(tmp_path):
    """train.profile traces the named steps with torch.profiler; the summary
    function's image grids are computed at summary steps."""
    prof_dir = tmp_path / "prof"
    cfg = _config(tmp_path / "run", "train.n_max_iters=3",
                  f"train.profile={{dir: {prof_dir}, start_step: 1, "
                  "n_steps: 1}")
    model, loss_fn, optimizer, loader = _loop_parts(cfg)
    summary_fn = load_from_config(cfg.summary)
    grids = {}

    class Writer(train_lib.SummaryWriterish):
        def add_image(self, tag, img, global_step):
            grids[tag] = (img.shape, float(img.min()), float(img.max()),
                          global_step)

    writer = Writer(str(tmp_path / "tb"))
    try:
        it, _ = train_lib.train(model, loss_fn, optimizer, iter(loader), cfg,
                                train_writer=writer, summary_fn=summary_fn)
    finally:
        writer.close()
    assert it == 3
    trace = json.loads((prof_dir / "trace.json").read_text())
    assert len(trace["traceEvents"]) > 100
    assert {"Images/render", "Images/gt", "Images/diff", "Images/sh_slab",
            "Images/opacity_slab", "Images/alpha"} <= set(grids)
    shape, lo, hi, step = grids["Images/render"]
    assert shape == (3, 64, 64) and 0.0 <= lo <= hi <= 1.0 and step == 0
    assert grids["Images/sh_slab"][0] == (3, 32, 32)

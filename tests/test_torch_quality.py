"""The quality recipe through the port's entry points on the CPU, at a small
cut of ``configs/rgca_synthetic_quality.yml`` (64x64 images, uv 32, 3 + 6
cameras, 2 frames; rendered targets, ``cache_device``, the checkpoint
directory of ``test.ckpt.ckpt_path``), against the JAX package.

- Both ``run_test`` read one orbax checkpoint directory that the JAX
  package wrote: the loss means agree to rtol 1e-4 (the RGCA eval parity
  tolerance; the two fixtures' targets differ by float32 rounding only at
  this size, no mask pixel flips).
- The port's ``run_train`` takes 2 steps into its checkpoint directory,
  resumes from it for a third, and ``run_test`` reads the directory.
- The port resumes from the JAX package's orbax checkpoint (Adam moments
  from one JAX step) and takes one step; the JAX step from the same
  checkpoint on the same batch gives the same update. The parameter
  updates and the new moments are held at rtol 1e-3 + 1e-3 of each
  parameter's largest entry (ROADMAP's gradient rule: the gradients pass
  through the compositor backward, whose per-prim sums are differences of
  float32 prefixes taken in other orders); an update also by one float32
  ulp of its parameter, to which each package rounds the updated value
  (measured: one entry of 16,384 of ``decoder.encmod.weight_g``). The encoder noise is off
  (``noise_std`` 0) on both sides: the packages cannot draw the same
  numbers. The backlit direction both draw feeds no loss of this config.
"""

import ast
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goliath_torch import train as t_train
from goliath_torch.config import load_config as t_load_config
from goliath_torch.config import load_from_config as t_load_from_config
from goliath_torch.convert import load_checkpoint, params_from_jax
from goliath_torch.data.synthetic import SyntheticDataset
from goliath_torch.optim import build_optimizer
from goliath_torch.scripts import run_test as t_run_test
from goliath_torch.scripts import run_train as t_run_train
from goliath_tpu import train as j_train
from goliath_tpu.config import load_config, load_from_config
from goliath_tpu.data.pipeline import DataLoader as JDataLoader
from goliath_tpu.data.synthetic import SyntheticDataset as JSyntheticDataset
from goliath_tpu.optim import build_optimizer as j_build_optimizer
from goliath_tpu.scripts import run_test as j_run_test

# tiny shapes: more intra-op threads only contend with the other test
# workers of a parallel run
torch.set_num_threads(1)

QUALITY_CFG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "configs", "rgca_synthetic_quality.yml")
# the config's widths cut to a CPU test's (its render settings, losses,
# optimizer groups, cal and learn_blur kept)
SMALL = ["data.img_h=64", "data.img_w=64", "data.uv_size=32", "data.n_cams=3",
         "data.n_frames=2", "model.image_height=64", "model.image_width=64",
         "model.uv_size=32", "test.data.img_h=64", "test.data.img_w=64",
         "test.data.uv_size=32", "test.data.n_cams=6", "test.data.n_frames=2",
         "test.n_test_frames=4", "test.vis_path=null"]
MEANS_RTOL = 1e-4
STEP_RTOL = STEP_OF_LARGEST = 1e-3


def flax_tree(state_dict):
    """A ``state_dict`` as the flax parameter tree of the same names
    (nested dicts of numpy)."""
    tree = {}
    for name, v in state_dict.items():
        node = tree
        *parts, last = name.split(".")
        for p in parts:
            node = node.setdefault(p, {})
        node[last] = v.detach().cpu().numpy().copy()
    return tree


def merged_moments(state):
    """Adam's moments of the JAX package's optimizer state (scrub, clip,
    Adam; with per_module groups a multi_transform state whose groups each
    hold their own parameters' moments), merged into one nested numpy tree
    each, and the step count."""
    base = state[2]
    adam = ([g.inner_state[0] for g in base.inner_states.values()]
            if hasattr(base, "inner_states") else [base[0]])
    counts = {int(a.count) for a in adam}
    assert len(counts) == 1
    merged = []
    for field in ("mu", "nu"):
        tree = {}
        for a in adam:
            for path, leaf in jax.tree_util.tree_leaves_with_path(
                    getattr(a, field)):
                node = tree
                *parts, last = [p.key for p in path]
                for k in parts:
                    node = node.setdefault(k, {})
                assert last not in node
                node[last] = np.asarray(leaf)
        merged.append(tree)
    return merged[0], merged[1], counts.pop()


def port_model(cfg):
    """The port's training model of ``cfg`` (cal and learn_blur included)
    on the CPU, initialized from seed 0."""
    kw = dict(cfg.data)
    kw.pop("synthetic")
    return t_load_from_config(
        cfg.model, assets=SyntheticDataset(**kw).static_assets, device="cpu",
        generator=torch.Generator().manual_seed(0))


def _port_init_tree(cfg):
    """The port's initialization as a flax ``{"params": ...}`` tree."""
    return {"params": flax_tree(port_model(cfg).module.state_dict())}


def test_both_run_tests_read_a_jax_checkpoint_directory(tmp_path, capsys):
    ckpt_dir = str(tmp_path / "checkpoints")
    overrides = SMALL + [f"test.ckpt.ckpt_path={ckpt_dir}"]
    params = _port_init_tree(t_load_config(QUALITY_CFG, overrides=overrides))
    j_train.save_checkpoint(ckpt_dir, {"model": params}, iteration=4)

    j_run_test.main(load_config(QUALITY_CFG, overrides=overrides))
    ref = ast.literal_eval(capsys.readouterr().out.strip().splitlines()[-1])
    got = t_run_test.main(t_load_config(QUALITY_CFG, overrides=overrides),
                          device="cpu")
    assert set(got) == set(ref) and "loss_psnr" in got
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=MEANS_RTOL,
                                   err_msg=k)


def test_run_train_resumes_and_run_test_reads_the_directory(tmp_path):
    run = tmp_path / "run"
    ckpt = run / "checkpoints"
    overrides = SMALL + [f"train.run_dir={run}", "train.ckpt_every_n_steps=1",
                         f"test.ckpt.ckpt_path={ckpt}"]
    it, last = t_run_train.main(
        t_load_config(QUALITY_CFG, overrides=overrides + [
            "train.n_max_iters=2"]), device="cpu")
    assert it == 2 and all(math.isfinite(v) for v in last.values())
    assert sorted(os.listdir(ckpt)) == ["000000.pt", "000001.pt",
                                        "000002.pt", "latest"]
    cfg = t_load_config(QUALITY_CFG, overrides=overrides + [
        "train.n_max_iters=3"])
    it, _ = t_run_train.main(cfg, device="cpu")
    assert it == 3 and (ckpt / "latest").read_text() == "000003.pt"

    means = t_run_test.main(cfg, device="cpu")
    assert all(math.isfinite(v) for v in means.values())
    # the directory stands for its latest checkpoint
    again = t_run_test.main(t_load_config(QUALITY_CFG, overrides=SMALL + [
        f"test.ckpt.ckpt_path={ckpt / '000003.pt'}"]), device="cpu")
    assert again == means


def _hold(got, ref, name, rounding=0.0):
    allowed = (STEP_RTOL * np.abs(ref) + STEP_OF_LARGEST * np.abs(ref).max()
               + rounding)
    over = np.abs(got - ref) > allowed
    assert not over.any(), (name, int(over.sum()), got[over][:4],
                            ref[over][:4])


def test_resumed_step_from_a_jax_checkpoint_matches_jax(tmp_path):
    run = tmp_path / "run"
    ckpt_dir = str(run / "checkpoints")
    overrides = SMALL + [f"train.run_dir={run}", "model.encoder.noise_std=0",
                         "train.n_max_iters=2",
                         "train.ckpt_every_n_steps=1000"]
    cfg = load_config(QUALITY_CFG, overrides=overrides)
    kw = dict(cfg.data)
    kw.pop("synthetic")
    ds = JSyntheticDataset(**kw)
    model = load_from_config(cfg.model, assets=ds.static_assets)
    loss_fn = load_from_config(cfg.loss, assets=ds.static_assets)
    opt_cfg = dict(cfg.optimizer)
    opt_cfg.setdefault("lr", cfg.lr)
    params = jax.tree_util.tree_map(jnp.asarray, _port_init_tree(
        t_load_config(QUALITY_CFG, overrides=overrides)))
    optimizer = j_build_optimizer(opt_cfg, params)
    step = j_train.make_train_step(model, loss_fn, optimizer)
    # the batch the port's loader yields first: the same index stream
    batch = next(iter(JDataLoader(ds, **cfg.dataloader)))
    jb = {k: jnp.asarray(v) for k, v in batch.items()
          if not isinstance(v, (list, str))}
    key = jax.random.PRNGKey(0)
    params, state, _, _ = step(params, optimizer.init(params), jb, key,
                               jnp.asarray(0))
    saved = {"model": jax.device_get(params),
             "optimizer": jax.device_get(state)}
    j_train.save_checkpoint(ckpt_dir, saved, iteration=1)
    params2, state2, _, _ = step(params, state, jb, key, jnp.asarray(1))

    it, last = t_run_train.main(t_load_config(QUALITY_CFG,
                                              overrides=overrides),
                                device="cpu")
    assert it == 2 and all(math.isfinite(v) for v in last.values())
    got = load_checkpoint(ckpt_dir)
    assert got["iteration"] == 2
    before = params_from_jax(saved["model"])
    after = params_from_jax(jax.device_get(params2))
    assert set(got["model"]) == set(after)
    for name in after:
        # each package rounds its updated parameter to float32: one ulp
        _hold((got["model"][name] - before[name]).numpy(),
              (after[name] - before[name]).numpy(), name,
              rounding=np.spacing(np.abs(after[name].numpy())))

    # the new moments, merged over the per-module groups
    mu, nu, count = merged_moments(state2)
    assert count == 2
    mu, nu = params_from_jax(mu), params_from_jax(nu)
    tm = port_model(t_load_config(QUALITY_CFG, overrides=overrides))
    topt = build_optimizer(opt_cfg, tm.module)
    t_train.restore_train_state(tm, topt, got)
    for name, p in tm.module.named_parameters():
        s = topt.inner.state[p]
        assert float(s["step"]) == 2.0
        _hold(s["exp_avg"].numpy(), mu[name].numpy(), f"{name} mu")
        _hold(s["exp_avg_sq"].numpy(), nu[name].numpy(), f"{name} nu")

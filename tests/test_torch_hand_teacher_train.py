"""Parity of one OLAT teacher training step of the port with the JAX package
on the CPU, at the sizes of tests/test_torch_hand_teacher.py (uv 32,
primsize (8, 8, 4), i.e. 16 prims, 2 lights, n_pose_dims 6) with 32x32
images and batch 1, with configs/hand_teacher_mvp.yml's three losses
(rgb_l2, mask_l1 at iteration 0, learn_blur): every loss term and every
parameter gradient, through the march (its template's rgb channels only:
the geometry is evaluated as at eval and detached), the UNet under
``torch.utils.checkpoint``, ``texolat`` and CalV5 on a colour camera. The
step runs as ``run_train`` runs it (no iteration: the shadow warm-up never
applies, in either package) and through a direct call at iteration 0 (the
deep shadows stand for the predicted ones). Also ``texolat``'s tie at 0,
one AdamW update against optax's (the geometry, which takes zero
gradients, decays), the optimizer's groups against the JAX package's
labels, ``HandMVPSummary`` on a training step's predictions and
``run_train.main`` on configs/hand_teacher_mvp.yml.

The set-up is tests/test_torch_hand_mvp_train.py's: the jittered template,
the port's initialization (seed 0) as the JAX tree, the JAX step under
``jax.jit`` compiled once with the iteration traced (at iteration 2000 the
JAX warm-up selects the predicted shadows, the function it computes
without an iteration). mask_l1 reads ``image_mask`` (synthetic data has no
``segmentation_fgbg``).

Tolerances: losses rtol 1e-4; gradients rtol 1e-3 plus 1e-3 of the
parameter's largest |reference| entry, with the spread rule of
tests/test_torch_hand_mvp_train.py; the AdamW update's parameters to 1e-6
(absolute, as tests/test_torch_optim.py).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from goliath_torch.config import load_config as t_load_config
from goliath_torch.convert import params_from_jax
from goliath_torch.losses import ModularLoss as TModularLoss
from goliath_torch.models import hand_teacher_mvp as tt
from goliath_torch.optim import build_optimizer
from goliath_torch.test import to_device
from goliath_tpu.config import load_config as j_load_config
from goliath_tpu.data.pipeline import collate
from goliath_tpu.data.synthetic import SyntheticDataset
from goliath_tpu.losses import ModularLoss as JModularLoss
from goliath_tpu.models import hand_teacher_mvp as jt
from goliath_tpu.optim import build_optimizer as j_build_optimizer

from tests.test_torch_hand_mvp_train import (
    grads_of,
    hold_step,
    jax_groups,
    jax_tree,
    opt_groups,
    spread_of,
)
from tests.test_torch_hand_teacher import RAYMARCHER
from tests.test_torch_hand_teacher import _model_kw as _eval_model_kw
from tests.test_torch_mesh_vae import jitter_template

torch.set_num_threads(1)

CPU = torch.device("cpu")
# run_train's first step, where mask_l1 (start_at = end_at = 0) counts
LOSS_ITERATION = 0
RTOL = 1e-4
# the iterations the JAX step is compiled for: in the shadow warm-up
# (< 1000) and after it
ITERATIONS = {"warm_up": 0, "live": 2000}
_CFG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "configs", "hand_teacher_mvp.yml")
CONFIG_LOSSES = t_load_config(_CFG, overrides=[
    "loss.losses.mask_l1.tgt_key=image_mask"]).loss.losses.to_dict()
# the eval test's raymarcher with a window of 32 steps, exact at dt 4 and
# prim_scale 12 (tests/test_torch_hand_mvp_train.py)
TRAIN_RAYMARCHER = dict(RAYMARCHER, window_steps=32)
IMG = 32
GEOMETRY = ("poseencoder.", "geomdecoder.")


def _model_kw(ds):
    return dict(_eval_model_kw(ds), image_height=IMG, image_width=IMG,
                raymarcher=TRAIN_RAYMARCHER)


def _dataset():
    return jitter_template(SyntheticDataset(
        n_cams=2, n_frames=2, img_h=IMG, img_w=IMG, uv_size=32, n_lights=2,
        seed=5))


@pytest.fixture(scope="module")
def jax_step():
    """The JAX package's train=True losses and gradients at each of
    ITERATIONS, one compile with the iteration traced: batch 1 of frame 1
    (both lights on) in camera 1 (a colour camera)."""
    ds = _dataset()
    batch = collate([ds.get(1, 1)])
    batch = {k: v for k, v in batch.items() if not isinstance(v, list)}
    assert list(batch["camera_idx"]) == [1]
    assert (batch["light_intensity"] > 0).all()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    kw = _model_kw(ds)
    jm = jt.AutoEncoder(**kw)
    tm = tt.AutoEncoder(**kw, device="cpu")
    params = jax_tree(tm.module.state_dict())
    loss_fn = JModularLoss(CONFIG_LOSSES, assets=ds.static_assets)

    def loss_inner(p, iteration):
        preds = jm.apply(p, dict(jb, iteration=iteration), train=True)
        total, ldict = loss_fn(preds, jb, LOSS_ITERATION)
        return total, (ldict, preds)

    step = jax.jit(jax.value_and_grad(loss_inner, has_aux=True))
    runs = {}
    for name, it in ITERATIONS.items():
        (total, (ldict, preds)), grads = step(params,
                                              jnp.asarray(it, jnp.int32))
        runs[name] = dict(
            total=float(total),
            ldict={k: float(v) for k, v in ldict.items()},
            grads=params_from_jax(jax.device_get(grads)),
            jax_grads=jax.device_get(grads),
            preds=jax.device_get(preds))
    return dict(ds=ds, batch=batch, params=jax.device_get(params),
                runs=runs, model=tm)


def _port_step(jax_step, iteration, state=None):
    """One train=True forward of the port from the JAX step's parameters
    (or ``state``), the losses and the backward: (model, preds, total,
    loss dict)."""
    ds, tm = jax_step["ds"], jax_step["model"]
    tm.module.load_state_dict(
        state or params_from_jax(jax_step["params"]), strict=True)
    tm.module.zero_grad(set_to_none=True)
    loss_fn = TModularLoss(CONFIG_LOSSES, assets=ds.static_assets)
    tb = to_device(jax_step["batch"], CPU)
    if iteration is not None:
        tb = dict(tb, iteration=torch.tensor(iteration))
    preds = tm.apply(tb, train=True)
    total, ldict = loss_fn(preds, tb, LOSS_ITERATION)
    total.backward()
    return tm, preds, total, ldict


@pytest.mark.parametrize("case", ["run_train", "warm_up"])
def test_train_step_losses_and_gradients_match_jax(jax_step, case):
    """The step as run_train takes it against the JAX step at iteration
    2000 (the port's steps at 2000 and without an iteration equal bit for
    bit), and the step at iteration 0, whose shadows are the deep ones."""
    it = None if case == "run_train" else ITERATIONS[case]
    ref = jax_step["runs"]["live" if case == "run_train" else case]
    tm, preds, total, ldict = _port_step(jax_step, it)
    if case == "run_train":
        first = grads_of(tm)
        _, _, live_total, _ = _port_step(jax_step, ITERATIONS["live"])
        assert live_total.item() == total.item()
        for name, g in grads_of(tm).items():
            assert (g is None and first[name] is None) or torch.equal(
                g, first[name]), name
    assert set(preds) == set(ref["preds"]) >= {"texolat", "primshadow"}
    for k, r in ref["ldict"].items():
        # learn_blur's weights start at 1, where its loss is 0
        assert (r == 0) == (k == "loss_learn_blur"), k

    def step(state):
        return _port_step(jax_step, it, state)[0]

    step.params = jax_step["params"]
    zero = hold_step(tm, total, ldict, ref, CONFIG_LOSSES,
                     lambda: spread_of(step, grads_of(tm)))
    # the detached geometry takes none; nor, in the warm-up, the biases of
    # the UNet's shadow channels
    geometry = {n for n in ref["grads"] if n.startswith(GEOMETRY)}
    assert geometry <= set(zero) and all(
        grads_of(tm)[n] is None for n in geometry)
    assert set(zero) - geometry <= {"relightdecoder.unet.dec4.bias"}


def test_one_adamw_update_matches_optax(jax_step):
    """configs/hand_teacher_mvp.yml's optimizer, one update from the JAX
    step's gradients (the run_train case), against optax's: every
    parameter to 1e-6. The geometry's gradients are left unset, as the
    backward leaves them; it takes AdamW's decoupled decay alone in both
    packages, p (1 - lr wd)."""
    ref = jax_step["runs"]["live"]
    params = jax_step["params"]
    jcfg = j_load_config(_CFG)
    jopt = j_build_optimizer(dict(jcfg.optimizer, lr=jcfg.lr), params)

    def update(grads, p):
        updates, _ = jopt.update(grads, jopt.init(p), p)
        return optax.apply_updates(p, updates)

    want = params_from_jax(jax.device_get(jax.jit(update)(ref["jax_grads"],
                                                          params)))
    tm = jax_step["model"]
    start = params_from_jax(params)
    tm.module.load_state_dict(start, strict=True)
    cfg = t_load_config(_CFG)
    opt = build_optimizer(dict(cfg.optimizer, lr=cfg.lr), tm.module)
    for name, p in tm.module.named_parameters():
        p.grad = (None if name.startswith(GEOMETRY)
                  else ref["grads"][name].clone())
    opt.step()
    decay = 1.0 - cfg.lr * 1e-2
    moved = 0
    for name, p in tm.module.named_parameters():
        got = p.detach()
        np.testing.assert_allclose(got.numpy(), want[name].numpy(), rtol=0,
                                   atol=1e-6, err_msg=name)
        if name.startswith(GEOMETRY):
            np.testing.assert_allclose(got.numpy(),
                                       start[name].numpy() * decay,
                                       rtol=1e-7, atol=0, err_msg=name)
            moved += int(not torch.equal(got, start[name]))
    assert moved > 0


def test_optimizer_groups_match_jax_labels(jax_step):
    """Its four groups and the default group of the detached geometry,
    with the members the JAX package labels so."""
    tm = jax_step["model"]
    cfg = t_load_config(_CFG)
    opt = build_optimizer(dict(cfg.optimizer, lr=cfg.lr), tm.module)
    got = opt_groups(opt, tm)
    assert got == jax_groups(j_build_optimizer, j_load_config(_CFG),
                             jax_step["params"])
    assert [(g["name"], g["lr"]) for g in opt.inner.param_groups] == [
        ("poseencoder2", 5e-4), ("relightdecoder", 5e-4), ("cal", 5e-4),
        ("learn_blur", 1e-3), ("__default__", 5e-4)]
    assert {n.split(".")[0] for n in got["__default__"]} == {
        "poseencoder", "geomdecoder"}


DATA = {"synthetic": True, "img_h": IMG, "img_w": IMG, "uv_size": 32,
        "n_cams": 2, "n_frames": 2, "n_lights": 2, "seed": 5}

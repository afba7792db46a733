"""Parity of one MVP hand training step of the port with the JAX package on
the CPU, at the widths of tests/test_torch_hand_mvp.py (uv 64, primsize
(8, 8, 4), i.e. 64 prims, n_pose_dims 6) with 32x32 images, a sampling
window of 32 steps and batch 2, with configs/hand_mvp.yml's six losses
(rgb_l2, vgg, mask_l1, learn_blur, alphaprior, primvolsum): every loss
term and every parameter gradient, through the tile-culled march (each
tile group recomputed in the backward), CalV5 on a colour camera and the
learnable blur. The step runs as ``run_train`` runs it (the model gets no
iteration, so the deltas' warm-up never applies, in either package) and
through a direct call at iteration 0 (the deltas held at their rest
values). Also ``primalpha``'s tie at 0, the optimizer's groups against the
JAX package's labels, ``HandMVPSummary`` on a training step's predictions
and ``run_train.main`` on configs/hand_mvp.yml.

Both sides take the jittered template of tests/test_torch_mesh_vae.py and
the port's initialization (seed 0), put into the JAX tree by name
(``jax_tree``). The JAX step runs under ``jax.jit``, compiled once with
the iteration as a traced argument: at iteration 2000 its warm-up
multiplies the deltas by exactly 1 and adds exactly 0, the function the
step computes without an iteration, which is the reference of the
``run_train`` case (and the port's steps with and without the iteration
are held bit for bit). The losses read ``image_mask`` where the config
reads ``segmentation_fgbg`` (synthetic data has none); vgg takes the JAX
package's random VGG19 features, written to an .npz that the port's loss
reads (tests/test_torch_perceptual.py).

Tolerances: losses rtol 1e-4 (float32 sums in other orders); parameter
gradients rtol 1e-3 plus 1e-3 of the parameter's largest |reference|
gradient entry, as the mesh_vae and URHand steps, and, as URHand's,
within 4 times the gradient's own spread under one-ulp moves of the
parameters for at most 4 parameters: the untied biases of the slab
decoders' last layers, one voxel's gradient an entry, move by ~1e-3 of
their largest entry under such moves.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goliath_torch.config import load_config as t_load_config
from goliath_torch.convert import params_from_jax
from goliath_torch.losses import ModularLoss as TModularLoss
from goliath_torch.models import hand_mvp as th
from goliath_torch.optim import build_optimizer
from goliath_torch.test import to_device
from goliath_tpu.data.pipeline import collate
from goliath_tpu.data.synthetic import SyntheticDataset
from goliath_tpu.losses import ModularLoss as JModularLoss
from goliath_tpu.models import hand_mvp as jh

from tests.test_torch_hand_mvp import RAYMARCHER
from tests.test_torch_hand_mvp import _model_kw as _eval_model_kw
from tests.test_torch_mesh_vae import jitter_template
from tests.test_torch_perceptual import clear_jax_features, jax_feature_files

torch.set_num_threads(1)

CPU = torch.device("cpu")
# run_train's first step: the losses' iteration (no loss here has a
# schedule)
LOSS_ITERATION = 0
RTOL = 1e-4
GRAD_RTOL = GRAD_OF_SCALE = 1e-3
# a gradient may move by this many times its largest move under one-ulp
# perturbations of the parameters, beyond the rule above (as URHand's)
SPREAD_MULT = 4.0
SPREAD_SEEDS = (1, 2, 3)
# at most this many parameters may need the spread (at the warm-up three:
# the untied biases of the slab decoders' last layers, whose entries are
# single voxels' gradients)
MAX_SPREAD_PARAMS = 4
# the iterations the JAX step is compiled for: in the deltas' warm-up
# (< primposstart 1000) and after it
ITERATIONS = {"warm_up": 0, "live": 2000}
_CFG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "configs", "hand_mvp.yml")
# the config's losses as synthetic data allows (chip_smoke.HAND_MVP_CUTS)
SYNTHETIC_CUTS = {"rgb_l2": {"mask_key": "image_mask"},
                  "vgg": {"mask_key": "image_mask"},
                  "mask_l1": {"tgt_key": "image_mask"}}
CONFIG_LOSSES = {k: dict(v, **SYNTHETIC_CUTS.get(k, {}))
                 if isinstance(v, dict) else v
                 for k, v in t_load_config(_CFG).loss.losses.to_dict().items()}


# the eval test's raymarcher with a window of 32 steps: at dt 4 and
# prim_scale 12 a prim's diagonal spans ~29 steps, so the window is exact,
# as the config's 16 is at full width
TRAIN_RAYMARCHER = dict(RAYMARCHER, window_steps=32)
IMG = 32


def _model_kw(ds):
    return dict(_eval_model_kw(ds), image_height=IMG, image_width=IMG,
                raymarcher=TRAIN_RAYMARCHER)


def _dataset():
    return jitter_template(SyntheticDataset(
        n_cams=2, n_frames=2, img_h=IMG, img_w=IMG, uv_size=64, seed=1))


@pytest.fixture(scope="module")
def jax_step(tmp_path_factory):
    """The JAX package's train=True losses and gradients at each of
    ITERATIONS, one compile with the iteration traced (module scope:
    compiling the step is the slow part): batch 2
    of frame 0 in camera 0 (cal's identity camera) and frame 1 in camera 1
    (a colour camera)."""
    mp = pytest.MonkeyPatch()
    try:
        files = jax_feature_files(tmp_path_factory.mktemp("hand_mvp_train"),
                                  mp, nets=("vgg",))
        ds = _dataset()
        batch = collate([ds.get(0, 0), ds.get(1, 1)])
        batch = {k: v for k, v in batch.items() if not isinstance(v, list)}
        assert list(batch["camera_idx"]) == [0, 1]
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        kw = _model_kw(ds)
        jm = jh.AutoEncoder(**kw)
        tm = th.AutoEncoder(**kw, device="cpu")
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
                preds=jax.device_get(preds))
        out = dict(ds=ds, batch=batch, params=jax.device_get(params),
                   vgg_npz=files["vgg"], runs=runs, model=tm)
    finally:
        mp.undo()
        clear_jax_features()
    return out


def jax_tree(state):
    """The flax parameter tree of the port's ``state_dict``: the two
    packages keep the same names and layouts (goliath_torch/convert.py),
    and flax refuses a parameter of another shape."""
    tree = {}
    for key, v in state.items():
        *path, leaf = key.split(".")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = jnp.asarray(v.numpy())
    return {"params": tree}


def port_losses(vgg_npz):
    return {k: dict(v, weights_npz=vgg_npz) if k == "vgg" else v
            for k, v in CONFIG_LOSSES.items()}


def _port_step(jax_step, iteration, state=None):
    """One train=True forward of the port from the JAX step's parameters
    (or ``state``), the losses and the backward: (model, preds, total,
    loss dict)."""
    ds, tm = jax_step["ds"], jax_step["model"]
    tm.module.load_state_dict(
        state or params_from_jax(jax_step["params"]), strict=True)
    tm.module.zero_grad(set_to_none=True)
    loss_fn = TModularLoss(port_losses(jax_step["vgg_npz"]),
                           assets=ds.static_assets)
    tb = to_device(jax_step["batch"], CPU)
    if iteration is not None:
        tb = dict(tb, iteration=torch.tensor(iteration))
    preds = tm.apply(tb, train=True)
    total, ldict = loss_fn(preds, tb, LOSS_ITERATION)
    total.backward()
    return tm, preds, total, ldict


def grads_of(tm):
    return {n: p.grad for n, p in tm.module.named_parameters()}


def spread_of(step, base):
    """The largest move of each gradient of ``base`` when every parameter
    is scaled by (1 + 1e-7 N(0, 1)), about one ulp, over SPREAD_SEEDS;
    ``step(state)`` runs the port's step from ``state`` and returns its
    model."""
    state = params_from_jax(step.params)
    spread = {n: 0.0 for n in base}
    for seed in SPREAD_SEEDS:
        gen = torch.Generator().manual_seed(seed)
        moved = step({k: v * (1 + 1e-7 * torch.randn(v.shape, generator=gen))
                      for k, v in state.items()})
        for n, g in grads_of(moved).items():
            if g is not None and base[n] is not None:
                spread[n] = max(spread[n], float((g - base[n]).abs().max()))
    return spread


def hold_step(tm, total, ldict, ref, config_losses, spread):
    """The port's step (its model after the backward, its total and loss
    dict) against the JAX step ``ref``: losses at RTOL; every parameter's
    gradient at GRAD_RTOL plus GRAD_OF_SCALE of its largest |reference|
    entry, a parameter that got none counting as zeros (references of zeros
    must be met by zeros), or else within SPREAD_MULT times its spread
    (``spread()``, measured only when a gradient needs it) beyond that, for
    at most MAX_SPREAD_PARAMS parameters. Returns the names of the
    parameters with a zero reference."""
    assert set(ldict) == set(ref["ldict"]) == {
        f"loss_{k}" for k in config_losses} | {"loss_total"}
    np.testing.assert_allclose(total.item(), ref["total"], rtol=RTOL)
    for k, r in ref["ldict"].items():
        np.testing.assert_allclose(ldict[k].item(), r, rtol=RTOL, atol=1e-9,
                                   err_msg=k)
    named = grads_of(tm)
    assert set(named) == set(ref["grads"])
    zero, need, moves = [], [], {}
    for name, g in named.items():
        r = ref["grads"][name].numpy()
        g = np.zeros_like(r) if g is None else g.numpy()
        assert g.shape == r.shape and np.isfinite(r).all(), name
        scale = float(np.abs(r).max())
        if scale == 0:
            assert float(np.abs(g).max()) == 0, name
            zero.append(name)
            continue
        usual = GRAD_RTOL * np.abs(r) + GRAD_OF_SCALE * scale
        diff = np.abs(g - r)
        if (diff <= usual).all():
            continue
        moves = moves or spread()
        need.append(f"{name} (error {float(diff.max()) / scale:.2e}, spread "
                    f"{moves[name] / scale:.2e} of its largest entry)")
        np.testing.assert_array_less(diff, usual + SPREAD_MULT * moves[name],
                                     err_msg=name)
    print(f"gradients that need their ulp-perturbation spread: {need}")
    assert len(need) <= MAX_SPREAD_PARAMS, need
    return zero


@pytest.mark.parametrize("case", ["run_train", "warm_up"])
def test_train_step_losses_and_gradients_match_jax(jax_step, case):
    """The step as run_train takes it (no iteration) against the JAX step
    at iteration 2000: there the warm-up multiplies the deltas by exactly 1
    and adds exactly 0, so the JAX package computes the same function (and
    the port's step at 2000 equals its step without an iteration, bit for
    bit); and the step at iteration 0, in the warm-up."""
    it = None if case == "run_train" else ITERATIONS[case]
    ref = jax_step["runs"]["live" if case == "run_train" else case]
    tm, preds, total, ldict = _port_step(jax_step, it)
    if case == "run_train":
        first = grads_of(tm)
        _, _, live_total, _ = _port_step(jax_step, ITERATIONS["live"])
        assert live_total.item() == total.item()
        for name, g in grads_of(tm).items():
            assert torch.equal(g, first[name]), name
    assert set(preds) == set(ref["preds"])
    for k, r in ref["ldict"].items():
        # learn_blur's weights start at 1, where its loss is 0
        assert (r == 0) == (k == "loss_learn_blur"), k

    def step(state):
        return _port_step(jax_step, it, state)[0]

    step.params = jax_step["params"]
    zero = hold_step(tm, total, ldict, ref, CONFIG_LOSSES,
                     lambda: spread_of(step, grads_of(tm)))
    # every parameter takes a gradient, but the deltas' decoder in the
    # warm-up, where the deltas are held at their rest values
    warm = {n for n in ref["grads"]
            if n.startswith("geomdecoder.transdecoder.")}
    assert set(zero) == (warm if case == "warm_up" else set()), zero
    assert float(preds["mvp_window_overflow"]) == pytest.approx(
        float(ref["preds"]["mvp_window_overflow"]), rel=RTOL)


def test_optimizer_groups_match_jax_labels(jax_step):
    """configs/hand_mvp.yml's optimizer over the MVP hand's parameters: its
    five groups with the members the JAX package labels so, and no
    default group."""
    from goliath_tpu.config import load_config as j_load_config
    from goliath_tpu.optim import build_optimizer as j_build_optimizer

    tm = jax_step["model"]
    cfg = t_load_config(_CFG)
    opt = build_optimizer(dict(cfg.optimizer, lr=cfg.lr), tm.module)
    assert opt_groups(opt, tm) == jax_groups(
        j_build_optimizer, j_load_config(_CFG), jax_step["params"])
    assert [(g["name"], g["lr"]) for g in opt.inner.param_groups] == [
        ("poseencoder", 5e-4), ("geomdecoder", 5e-4), ("rgbdecoder", 5e-4),
        ("cal", 5e-4), ("learn_blur", 1e-3)]
    assert all(g["weight_decay"] == 1e-2 for g in opt.inner.param_groups)


def opt_groups(opt, tm):
    names = {id(p): n for n, p in tm.module.named_parameters()}
    return {g["name"]: {names[id(p)] for p in g["params"]}
            for g in opt.inner.param_groups}


def jax_groups(j_build_optimizer, jcfg, params):
    """The JAX optimizer's groups and the parameter names each labels."""
    state = j_build_optimizer(dict(jcfg.optimizer, lr=jcfg.lr),
                              params).init(params)
    ref = {}
    for group, inner in state[-1].inner_states.items():
        mu = inner.inner_state[0].mu
        ref[group] = {".".join(str(k.key) for k in path[1:]) for path, _ in
                      jax.tree_util.tree_flatten_with_path(mu)[0]}
    return {k: v for k, v in ref.items() if v}


def test_summary_of_a_training_step_matches_jax(jax_step):
    """HandMVPSummary on the JAX training step's predictions and batch."""
    preds = jax_step["runs"]["live"]["preds"]
    batch = jax_step["batch"]
    ref = jh.HandMVPSummary()({k: preds[k] for k in ("rgb", "alpha")}, batch)
    got = th.HandMVPSummary()({k: torch.from_numpy(np.asarray(preds[k]))
                               for k in ("rgb", "alpha")},
                              to_device(batch, CPU))
    assert set(got) == set(ref) == {"render", "alpha", "gt"}
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-6, atol=1e-7,
                                   err_msg=k)
    assert float(ref["alpha"].max()) > 0.05   # the hand is visible


DATA = {"synthetic": True, "img_h": IMG, "img_w": IMG, "uv_size": 64,
        "n_cams": 2, "n_frames": 2, "seed": 1}


def train_overrides(run_dir, data=DATA, raymarcher=TRAIN_RAYMARCHER,
                    extra=()):
    return [f"data={json.dumps(data)}", f"model.image_height={IMG}",
            f"model.image_width={IMG}", "model.primsize=[8, 8, 4]",
            "model.n_embs=8", "model.n_pose_dims=6", "model.volradius=400.0",
            "model.prim_scale=12.0", "model.global_scaling=1.0",
            *(f"model.raymarcher.{k}={v}" for k, v in raymarcher.items()),
            *extra, f"train.run_dir={run_dir}", "train.n_max_iters=2",
            "train.resume=false", "train.log_every_n_steps=1",
            "dataloader.num_workers=0"]

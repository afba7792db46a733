"""Parity of one URHand training step of the port with the JAX package on
the CPU, at the sizes of tests/test_torch_urhand.py (48x48 images, uv 32,
32x32 shadow maps, 2 lights) and batch 2, with configs/urhand.yml's five
losses (rgb_l1_focus, effnet, rgb_l1_phys, effnet_phys, list_l1_reg): every
loss term and every parameter gradient, through the two shadow passes of
B x L light views, the rgb and phys renders' edge-gradient backward and
CalV5 on a colour camera. Also CalV5's scaled gradients alone, the
optimizer's groups against the JAX package's labels, ``URHandSummary`` on
a training step's predictions and ``run_train.main`` on configs/urhand.yml.

Both sides take the jittered template of tests/test_torch_mesh_vae.py and
the port's initialization (seed 0) put into the JAX tree by name
(``jax.eval_shape`` of ``init``, as in tests/test_torch_urhand.py). The
JAX step runs under ``jax.jit``, compiled once. The two effnet losses take
the JAX package's fixed-seed random EfficientNet-B0 features, written to an
.npz that the port's losses read (tests/test_torch_perceptual.py).

Tolerances: losses rtol 1e-4 (float32 sums in other orders). Parameter
gradients rtol 1e-3 plus 1e-3 of the parameter's largest |reference|
gradient entry (as the mesh_vae step), plus a few times that parameter's
own spread: the largest move of its gradient in the port when every
parameter is scaled by (1 + 1e-7 N(0, 1)), about one ulp, over a few seeds.
A few gradients move by percents under such a perturbation, in either
package: ``decoder_relight.texmod0_*`` multiplies in the view conditioning,
which is resampled from the TBN frame of the displaced geometry, whose
normals are ill-conditioned at the UV border (tests/test_torch_urhand.py's
``normal_allowance``). The test names the parameters that need the spread
and holds their number down.
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
from goliath_torch.models import urhand as tu
from goliath_torch.optim import build_optimizer
from goliath_torch.test import to_device
from goliath_tpu.data.pipeline import collate
from goliath_tpu.data.synthetic import SyntheticDataset
from goliath_tpu.losses import ModularLoss as JModularLoss
from goliath_tpu.models import urhand as ju
from goliath_tpu.optim import build_optimizer as j_build_optimizer

from tests.test_torch_mesh_vae import jitter_template
from tests.test_torch_mesh_vae_train import _jax_params
from tests.test_torch_perceptual import clear_jax_features, jax_feature_files
from tests.test_torch_urhand import MODEL_KW

torch.set_num_threads(1)

CPU = torch.device("cpu")
ITERATION = 100
RTOL = 1e-4
GRAD_RTOL = GRAD_OF_SCALE = 1e-3
# a gradient may move by this many times its largest move under the
# one-ulp perturbations of the parameters, beyond the rule above
SPREAD_MULT = 4.0
SPREAD_SEEDS = (1, 2, 3)
# at most this many parameters may need the spread (four at the fixture:
# decoder_relight.texmod0_1.bias, texmod0_2.weight_v, texmod0_2.bias and
# texmod0_3.bias)
MAX_SPREAD_PARAMS = 5
_CFG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "configs", "urhand.yml")
CONFIG_LOSSES = t_load_config(_CFG).loss.losses.to_dict()
PERCEPTUAL = ("effnet", "effnet_phys")


def _port_losses(effnet_npz):
    """The config's losses, the effnet ones reading ``effnet_npz``."""
    return {k: dict(v, weights_npz=effnet_npz) if k in PERCEPTUAL else v
            for k, v in CONFIG_LOSSES.items()}


def _dataset():
    return jitter_template(SyntheticDataset(
        n_cams=2, n_frames=2, img_h=48, img_w=48, uv_size=32, n_lights=2,
        seed=4))


def _model_kw(ds):
    return dict(MODEL_KW, assets=ds.static_assets,
                cal={"identity_camera": ds.static_assets.camera_ids[0]})


def _perturbed(state, seed):
    gen = torch.Generator().manual_seed(seed)
    return {k: v * (1 + 1e-7 * torch.randn(v.shape, generator=gen))
            for k, v in state.items()}


@pytest.fixture(scope="module")
def jax_step(tmp_path_factory):
    """One train=True step of the JAX package (module scope: compiling the
    step is the slow part): batch 2 of frame 0 in camera 0 (cal's identity
    camera) and frame 1 in camera 1 (a colour camera)."""
    mp = pytest.MonkeyPatch()
    try:
        files = jax_feature_files(tmp_path_factory.mktemp("urhand_train"), mp,
                                  nets=("effnet",))
        ds = _dataset()
        batch = collate([ds.get(0, 0), ds.get(1, 1)])
        batch = {k: v for k, v in batch.items() if not isinstance(v, list)}
        assert list(batch["camera_idx"]) == [0, 1]
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        kw = _model_kw(ds)
        jm = ju.AutoEncoder(**kw)
        state = tu.AutoEncoder(**kw, device="cpu").module.state_dict()
        params = _jax_params(jax.eval_shape(
            lambda: jm.init(jax.random.PRNGKey(0), jb)), state)
        loss_fn = JModularLoss(CONFIG_LOSSES, assets=ds.static_assets)

        def loss_inner(p):
            preds = jm.apply(p, jb, train=True)
            total, ldict = loss_fn(preds, jb, ITERATION)
            return total, (ldict, preds)

        (total, (ldict, preds)), grads = jax.jit(jax.value_and_grad(
            loss_inner, has_aux=True))(params)
        out = dict(
            ds=ds, batch=batch, params=jax.device_get(params),
            effnet_npz=files["effnet"], total=float(total),
            ldict={k: float(v) for k, v in ldict.items()},
            grads=params_from_jax(jax.device_get(grads)),
            preds=jax.device_get(preds))
    finally:
        mp.undo()
        clear_jax_features()
    return out


def _port_step(jax_step, state=None):
    """One train=True forward, the losses and backward of the port from
    the JAX step's parameters (or ``state``): (model, preds, total, loss
    dict)."""
    ds = jax_step["ds"]
    tm = tu.AutoEncoder(**_model_kw(ds), device="cpu")
    tm.module.load_state_dict(state or params_from_jax(jax_step["params"]),
                              strict=True)
    loss_fn = TModularLoss(_port_losses(jax_step["effnet_npz"]),
                           assets=ds.static_assets)
    tb = to_device(jax_step["batch"], CPU)
    preds = tm.apply(tb, train=True)
    total, ldict = loss_fn(preds, tb, ITERATION)
    total.backward()
    return tm, preds, total, ldict


def test_train_step_losses_and_gradients_match_jax(jax_step):
    tm, preds, total, ldict = _port_step(jax_step)
    assert set(preds) == set(jax_step["preds"])
    assert set(ldict) == set(jax_step["ldict"]) == {
        f"loss_{k}" for k in CONFIG_LOSSES} | {"loss_total"}
    np.testing.assert_allclose(total.item(), jax_step["total"], rtol=RTOL)
    for k, ref in jax_step["ldict"].items():
        np.testing.assert_allclose(ldict[k].item(), ref, rtol=RTOL,
                                   atol=1e-9, err_msg=k)
        assert ref > 0, k

    ref_grads = jax_step["grads"]
    named = dict(tm.module.named_parameters())
    assert set(named) == set(ref_grads)
    base = {n: p.grad.clone() for n, p in named.items()}
    spread = {n: 0.0 for n in named}
    state = params_from_jax(jax_step["params"])
    for seed in SPREAD_SEEDS:
        other, *_ = _port_step(jax_step, _perturbed(state, seed))
        for n, p in other.module.named_parameters():
            spread[n] = max(spread[n], float((p.grad - base[n]).abs().max()))
    need = []
    for name, g in base.items():
        r = ref_grads[name].numpy()
        assert g.shape == r.shape and np.isfinite(r).all(), name
        g = g.numpy()
        scale = float(np.abs(r).max())
        if scale == 0:   # a reference of zeros is met by zeros
            assert float(np.abs(g).max()) == 0, name
            continue
        usual = GRAD_RTOL * np.abs(r) + GRAD_OF_SCALE * scale
        diff = np.abs(g - r)
        if (diff <= usual).all():
            continue
        need.append(f"{name} (error {float(diff.max()) / scale:.2e}, spread "
                    f"{spread[name] / scale:.2e} of its largest entry)")
        np.testing.assert_array_less(
            diff, usual + SPREAD_MULT * spread[name], err_msg=name)
    print(f"gradients that need their ulp-perturbation spread: {need}")
    assert len(need) <= MAX_SPREAD_PARAMS, need


def test_tbn_norm_of_a_zero_vector():
    """The TBN frame's normalization, x / max(|x|, 1e-5), against the JAX
    package's expression (``_norm_cf`` inside ConvTeacherDecoder,
    goliath_tpu/models/urhand.py): the same values bit for bit, zero
    vectors included, and the same gradient wherever the JAX package's is
    finite. At a zero vector the JAX package's gradient is NaN (the norm's
    path adds 0 * inf, the sqrt's derivative at 0 under the clip), which
    its optimizer's scrub then zeroes, for every entry of the parameters it
    reaches through a convolution; the port's is that of x / eps. The
    full-width synthetic sphere's poles give such vectors (one point
    repeated along a texel row)."""
    def j_norm_cf(x, eps=1e-5):
        return x / jnp.clip(jnp.sqrt(jnp.sum(x * x, axis=1, keepdims=True)),
                            min=eps)

    rng = np.random.RandomState(6)
    x = rng.randn(2, 3, 4, 5).astype(np.float32)
    x[0, :, 1, 2] = 0.0                  # a zero vector
    x[1, :, 3, 4] = (3e-6, -2e-6, 1e-6)  # a clamped one
    x[1, :, 0, 0] = (1e-20, 0.0, 0.0)    # a denormal sum of squares
    up = rng.randn(*x.shape).astype(np.float32)
    ref, vjp = jax.vjp(j_norm_cf, jnp.asarray(x))
    ref_g = np.asarray(vjp(jnp.asarray(up))[0])
    xt = torch.from_numpy(x).requires_grad_()
    got = tu._norm_cf(xt)
    (got * torch.from_numpy(up)).sum().backward()
    assert np.array_equal(got.detach().numpy(), np.asarray(ref))
    finite = np.isfinite(ref_g)
    assert not finite[0, :, 1, 2].any() and not finite[1, :, 0, 0].any()
    assert finite.sum() == finite.size - 6
    # float32 derivatives of one formula evaluated in other orders
    np.testing.assert_allclose(xt.grad.numpy()[finite], ref_g[finite],
                               rtol=1e-5, atol=1e-6)
    # there x / eps with eps constant: the upstream gradient over eps
    for i, h, w in ((0, 1, 2), (1, 0, 0)):
        np.testing.assert_allclose(xt.grad.numpy()[i, :, h, w],
                                   up[i, :, h, w] / 1e-5, rtol=1e-6)


def test_optimizer_groups_match_jax_labels(jax_step):
    """configs/urhand.yml's optimizer over URHand's parameters: the groups
    decoder_relight and cal, with the members the JAX package labels so."""
    from goliath_tpu.config import load_config as j_load_config

    ds = jax_step["ds"]
    tm = tu.AutoEncoder(**_model_kw(ds), device="cpu")
    cfg = t_load_config(_CFG)
    opt_cfg = dict(cfg.optimizer, lr=cfg.lr)
    opt = build_optimizer(opt_cfg, tm.module)
    names = {id(p): n for n, p in tm.module.named_parameters()}
    got = {g["name"]: {names[id(p)] for p in g["params"]}
           for g in opt.inner.param_groups}
    assert {g["lr"] for g in opt.inner.param_groups} == {1e-4}

    jcfg = j_load_config(_CFG)
    params = jax_step["params"]
    state = j_build_optimizer(dict(jcfg.optimizer, lr=jcfg.lr),
                              params).init(params)
    multi = state[-1]
    ref = {}
    for group, inner in multi.inner_states.items():
        mu = inner.inner_state[0].mu
        ref[group] = {".".join(str(k.key) for k in path[1:])
                      for path, _ in jax.tree_util.tree_flatten_with_path(mu)[0]}
    ref = {k: v for k, v in ref.items() if v}
    assert got == ref
    assert set(got) == {"decoder_relight", "cal"}
    assert got["cal"] == {"cal.cal_params"}


def test_summary_of_a_training_step_matches_jax(jax_step):
    """URHandSummary on the JAX training step's predictions and batch."""
    preds, batch = jax_step["preds"], jax_step["batch"]
    keys = ("rgb", "rendered_phys_rgb", "normals")
    ref = ju.URHandSummary()({k: preds[k] for k in keys}, batch)
    got = tu.URHandSummary()({k: torch.from_numpy(np.asarray(preds[k]))
                              for k in keys}, to_device(batch, CPU))
    assert set(got) == set(ref) == {"render", "phys", "normals", "gt"}
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-6, atol=1e-7,
                                   err_msg=k)
    assert float(np.abs(ref["phys"]).max()) > 0


DATA = {"synthetic": True, "img_h": 48, "img_w": 48, "uv_size": 32,
        "n_cams": 2, "n_frames": 2, "n_lights": 2, "seed": 4}


def _train_overrides(run_dir):
    small = {
        "data": DATA,
        "model.renderer": {"image_height": 48, "image_width": 48,
                           "max_faces_per_tile": 128, "chunk": 16},
    }
    return [f"{k}={json.dumps(v)}" for k, v in small.items()] + [
        "model.relight.uv_size=32", "model.relight.init_uv_size=8",
        "model.relight.pose_enc_dims=12",
        "model.relight.disp_enc_dims=[8, 8, 8]",
        "model.relight.disp_scale=0.3", "model.relight.init_channels=16",
        "model.global_scaling=1.0", "model.shadow_size=32",
        "loss.losses.effnet.allow_random_features=true",
        "loss.losses.effnet_phys.allow_random_features=true",
        f"train.run_dir={run_dir}", "train.n_max_iters=2",
        "train.resume=false", "train.log_every_n_steps=1",
        "dataloader.num_workers=0"]

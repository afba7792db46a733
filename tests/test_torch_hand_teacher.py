"""Parity of the port's OLAT teacher (models/hand_teacher_mvp.py) with the
JAX package on the CPU, at tests/test_hand_teacher.py's sizes with 48x48
images (uv 32, primsize (8, 8, 4), i.e. 16 prims, 2 lights, n_pose_dims 6
for the synthetic 3-joint skeleton), and of ``run_test.main`` on
configs/hand_teacher_mvp.yml at those sizes against the JAX package's
evaluation of the same config and frames.

Both packages take the port's initialization (seed 0), put into the JAX
tree by name with ``jax.eval_shape`` of ``init`` and carried back by
params_from_jax (a round trip), on the template moved by N(0, 0.5) per
vertex (tests/test_torch_mesh_vae.py's ``jitter_template``): under
``jax.jit`` XLA's fused multiply-adds turn the sphere's zero pole TBN
frames into rotations. The JAX forward runs under ``jax.jit``. The
decoder test feeds the JAX forward's geometry to both decoders, its alpha
slab scaled by 60 so that the shadows reach ~0.5 (random weights leave
them near 0.02), in both shadow modes. The reference of ``run_test`` is
the body of the JAX package's ``scripts/run_test.main``
(tests/test_torch_hand_mvp.py's ``jax_eval``); mask_l1 reads ``image_mask``
(synthetic data has no ``segmentation_fgbg``).

Tolerance: the voxel-centre axis bit for bit; rtol 1e-4 plus 1e-4 of the
output's largest |value| on the forward's and the decoder's outputs, rtol
1e-4 on the loss means (float32 convolutions, shadow sums and the march's
sums taken in other orders).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goliath_torch.convert import params_from_jax
from goliath_torch.models import hand_teacher_mvp as tt
from goliath_tpu.data.synthetic import SyntheticDataset
from goliath_tpu.models import hand_teacher_mvp as jt

from tests.test_torch_mesh_vae import close_to_scale, jitter_template
from tests.test_torch_mesh_vae_train import _jax_params

torch.set_num_threads(1)

RTOL = 1e-4
_CFG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "configs", "hand_teacher_mvp.yml")
RAYMARCHER = {"dt": 4.0, "max_steps": 48, "max_prims_per_tile": 16,
              "chunk": 8}
ALPHA_GAIN = 60.0


def T(a):
    return torch.from_numpy(np.array(a))


def _model_kw(ds):
    return dict(assets=ds.static_assets, image_height=48, image_width=48,
                cal={"identity_camera": ds.static_assets.camera_ids[0]},
                n_pose_dims=6, n_embs=8, volradius=400.0, primsize=(8, 8, 4),
                uv_size=32, prim_scale=12.0, global_scaling=1.0,
                raymarcher=RAYMARCHER)


@pytest.fixture(scope="module")
def both():
    """The jitted JAX forward (train=False, batch 1, 2 lights) and the
    port's on the same parameters and batch, with both models."""
    ds = jitter_template(SyntheticDataset(n_cams=2, n_frames=2, img_h=48,
                                          img_w=48, uv_size=32, n_lights=2,
                                          seed=5))
    kw = _model_kw(ds)
    batch = next(ds.batches(1, 1))
    batch = {k: v for k, v in batch.items() if not isinstance(v, list)}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jm = jt.AutoEncoder(**kw)
    tm = tt.AutoEncoder(**kw, device="cpu")
    state = tm.module.state_dict()
    params = _jax_params(jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), jb)), state)
    ref = jax.device_get(jax.jit(lambda p, b: jm.apply(p, b, train=False))(
        params, jb))
    tm.module.load_state_dict(params_from_jax(jax.device_get(params)))
    with torch.no_grad():
        got = tm.apply({k: T(v) for k, v in batch.items()}, train=False)
    return dict(got=got, ref=ref, params=params, state=state, tm=tm,
                batch=batch)


def test_params_from_jax_carries_teacher_tree(both):
    """The teacher's whole tree, and no rgbdecoder: the JAX teacher's
    __call__ replaces the base's, so its tree has none."""
    state = both["state"]
    round_trip = params_from_jax(jax.device_get(both["params"]))
    assert set(round_trip) == set(state)
    assert all(torch.equal(round_trip[k], v) for k, v in state.items())
    assert not any(k.startswith("rgbdecoder") for k in state)
    tops = {k.split(".")[0] for k in state}
    assert tops == {"poseencoder", "geomdecoder", "poseencoder2",
                    "relightdecoder", "cal", "learn_blur"}
    for part in [f"enc{i}" for i in range(5)] + [f"dec{i}" for i in
                                                 range(5)]:
        for leaf in ("weight_v", "weight_g", "bias"):
            assert f"relightdecoder.unet.{part}.{leaf}" in state
    assert state["relightdecoder.unet.dec4.bias"].shape == (16, 32, 32)


@pytest.mark.parametrize("mode", ["grid", "exact"])
def test_olat_decoder_matches_jax(both, mode):
    """OLATRGBDecoder alone on the JAX forward's geometry (alpha x 60),
    random joint features and the batch's 2 lights."""
    ref, batch, tm = both["ref"], both["batch"], both["tm"]
    net = tm.module
    rng = np.random.RandomState(4)
    joint = rng.randn(1, 8, 4, 4).astype(np.float32)
    args = (batch["campos"], ref["primpos"], ref["primrot"],
            ref["primscale"], np.asarray(ref["primalpha"]) * ALPHA_GAIN,
            net.valid_prims.numpy(), joint, batch["light_pos"],
            batch["light_intensity"])
    jdec = jt.OLATRGBDecoder(32, (8, 8, 4), 4, 4, 400.0, shadow_mode=mode)
    dparams = {"params": both["params"]["params"]["relightdecoder"]}
    jout = jax.device_get(jax.jit(lambda p, *a: jdec.apply(p, *a))(
        dparams, *[jnp.asarray(np.asarray(a)) for a in args]))
    dec = net.relightdecoder
    dec.shadow_mode = mode
    try:
        with torch.no_grad():
            out = dec(*[T(np.asarray(a)) for a in args])
    finally:
        dec.shadow_mode = "grid"
    assert set(out) == set(jout) == {"primrgb", "primshadow"}
    shadow = np.asarray(jout["primshadow"])
    assert 0.3 < float(shadow.max()) <= 1.0
    for k in out:
        close_to_scale(out[k].numpy(), jout[k], err_msg=k)


def test_hand_teacher_summary(both):
    diag = tt.HandMVPSummary()(both["got"], {"image": both["got"]["rgb"]})
    assert set(diag) == {"render", "alpha", "gt"}
    assert all(v.shape == (1, 3, 48, 48) and 0 <= v.min() and v.max() <= 1
               for v in diag.values())


def _overrides():
    data = {"synthetic": True, "img_h": 48, "img_w": 48, "uv_size": 32,
            "n_cams": 2, "n_frames": 2, "n_lights": 2, "seed": 5}
    return [f"data={json.dumps(data)}", f"test.data={json.dumps(data)}",
            "model.image_height=48", "model.image_width=48",
            "model.uv_size=32", "model.primsize=[8, 8, 4]",
            "model.n_embs=8", "model.n_pose_dims=6", "model.volradius=400.0",
            "model.prim_scale=12.0", "model.global_scaling=1.0",
            *(f"model.raymarcher.{k}={v}" for k, v in RAYMARCHER.items()),
            # synthetic data has no segmentation_fgbg
            "loss.losses.mask_l1.tgt_key=image_mask",
            "test.ckpt=null", "test.vis_path=null", "test.n_test_frames=3"]

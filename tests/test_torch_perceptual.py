"""Parity of the port's perceptual losses (goliath_torch/losses/perceptual.py:
VGG19 and EfficientNet-B0 features, the losses vgg, effnet and effnet_phys)
with the JAX package on the CPU, on 64x64 images with a mask; and the
port's handling of its weights: the refusal without weights or an opt-in,
the per-loss opt-in, random features drawn reproducibly from their seeds,
and no variable of the JAX package read.

The two packages cannot draw the same random numbers, so the JAX package's
fixed-seed random features (``_vgg19_weights()``, ``_effnet_weights()``)
are written to an ``.npz`` in the JAX package's layout for the port to
load. The images hold exact 0s and 255s: a render's background is exactly
0, where the normalization's clip is at its bound and both packages give
half the gradient.

Tolerances: features rtol 1e-4 plus 1e-4 of the map's largest |value|
(float32 convolutions summed in other orders; JAX writes the depthwise
convs as k^2 shifted multiply-adds, the port as grouped convolutions);
losses rtol 1e-4; input gradients rtol 1e-3 plus 1e-3 of the largest
|gradient| (they sum the same float32 terms back through 5 to 13 convs).
"""


import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goliath_torch.losses import ModularLoss as TModularLoss
from goliath_torch.losses import perceptual as tp
from goliath_tpu.losses import ModularLoss as JModularLoss
from goliath_tpu.losses import perceptual as jp

from tests.test_torch_mesh_vae import close_to_scale

torch.set_num_threads(1)

RTOL = 1e-4
GRAD_RTOL = 1e-3
JAX_ENV = ("GOLIATH_TPU_ALLOW_RANDOM_FEATURES", "GOLIATH_TPU_VGG19_NPZ",
           "GOLIATH_TPU_EFFNET_NPZ")
PORT_ENV = (tp.ALLOW_RANDOM_ENV, tp.VGG19_ENV, tp.EFFNET_ENV)


def jax_feature_files(d, mp, nets=("vgg", "effnet")):
    """Writes the JAX package's random features of ``nets`` (VGG19 as
    ``vgg19.npz``, EfficientNet-B0 as ``effnet.npz``), drawn by its own
    functions (under ``jax.jit``: eagerly each draw compiles on its own,
    ~17 s), into the directory ``d``, and points the JAX package at them
    through the MonkeyPatch ``mp`` with its cache refilled from them (so no
    draw happens inside a later ``jax.jit``). Returns {net: path} and
    {net + "_w": arrays}; ``mp.undo()`` and ``clear_jax_features()`` undo
    it."""
    import jax

    for k in JAX_ENV:
        mp.delenv(k, raising=False)
    mp.setenv("GOLIATH_TPU_ALLOW_RANDOM_FEATURES", "1")
    out = {}
    if "vgg" in nets:
        vgg = {}
        for i, (w, b) in enumerate(jax.jit(jp._vgg19_weights.__wrapped__)()):
            vgg[f"conv{i}_w"], vgg[f"conv{i}_b"] = (np.asarray(w),
                                                    np.asarray(b))
        np.savez(d / "vgg19.npz", **vgg)
        out.update(vgg=str(d / "vgg19.npz"), vgg_w=vgg)
        mp.setenv("GOLIATH_TPU_VGG19_NPZ", out["vgg"])
    if "effnet" in nets:
        eff = {k: np.asarray(v) for k, v in
               jax.jit(jp._effnet_weights.__wrapped__)().items()}
        np.savez(d / "effnet.npz", **eff)
        out.update(effnet=str(d / "effnet.npz"), effnet_w=eff)
        mp.setenv("GOLIATH_TPU_EFFNET_NPZ", out["effnet"])
    clear_jax_features()
    if "vgg" in nets:
        jp._vgg19_weights()
    if "effnet" in nets:
        jp._effnet_weights()
    return out


def clear_jax_features():
    jp._vgg19_weights.cache_clear()
    jp._effnet_weights.cache_clear()


@pytest.fixture(scope="module")
def npz(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    yield jax_feature_files(tmp_path_factory.mktemp("perceptual"), mp)
    mp.undo()
    clear_jax_features()


@pytest.fixture
def clean_env(monkeypatch):
    """None of the port's variables, and the JAX package's opt-in (which
    tests/conftest.py sets) unset."""
    for k in PORT_ENV + JAX_ENV[:1]:
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


def _images(seed=0, shape=(2, 3, 64, 64)):
    """Images in [0, 255] with an exact-0 background block and a saturated
    block, a target, and a soft mask."""
    rng = np.random.RandomState(seed)
    x = (rng.rand(*shape) * 300 - 20).astype(np.float32)
    x[:, :, :16, :24] = 0.0
    x[:, :, 40:, 50:] = 255.0
    y = (rng.rand(*shape) * 255).astype(np.float32)
    mask = (rng.rand(shape[0], 1, *shape[2:]) > 0.3).astype(np.float32)
    mask[:, :, 20:30] = 0.5
    return x, y, mask


def test_features_match_jax(npz):
    import jax

    x, _, _ = _images()
    xn = tp.normalize_imagenet(torch.from_numpy(x))
    close_to_scale(xn.numpy(), jp._normalize_imagenet(jnp.asarray(x)))
    cases = (("vgg", tp.vgg19_features, jp._vgg19_features, 5),
             ("effnet", tp.effnet_features, jp._effnet_features, 3))
    for name, t_fn, j_fn, n in cases:
        ws = {k: torch.from_numpy(v) for k, v in npz[f"{name}_w"].items()}
        got = t_fn(xn, ws)
        ref = jax.jit(j_fn)(jnp.asarray(xn.numpy()))
        assert len(got) == len(ref) == n
        for i, (g, r) in enumerate(zip(got, ref)):
            assert tuple(g.shape) == r.shape, (name, i)
            close_to_scale(g.numpy(), r, err_msg=f"{name} feature {i}")
            assert float(np.abs(np.asarray(r)).max()) > 0
    # stride-2 padding on odd sizes: 64 -> 32 -> 16 -> 8 above, 37x45 here
    ws = {k: torch.from_numpy(v) for k, v in npz["effnet_w"].items()}
    odd = tp.normalize_imagenet(torch.from_numpy(_images(1, (1, 3, 37, 45))[0]))
    for g, r in zip(tp.effnet_features(odd, ws),
                    jax.jit(jp._effnet_features)(jnp.asarray(odd.numpy()))):
        assert tuple(g.shape) == r.shape
        close_to_scale(g.numpy(), r, err_msg="effnet, odd size")


@pytest.mark.parametrize("name,src_key", [("vgg", "rendered_rgb"),
                                          ("effnet", "rendered_rgb"),
                                          ("effnet_phys", "rendered_phys_rgb")])
def test_losses_and_input_gradients_match_jax(npz, clean_env, name, src_key):
    """The registered loss through ModularLoss, with the mask read from
    the predictions (configs/urhand.yml's ``mask_key: rendered_mask``):
    value, the gradient of the rendered image, and none of the mask."""
    import jax

    x, y, mask = _images(2)
    net = "vgg" if name == "vgg" else "effnet"
    cfg = {name: {"weight": 0.7, "tgt_key": "image",
                  "mask_key": "rendered_mask"}}
    if name == "vgg":
        cfg[name]["src_key"] = src_key

    def jloss(img, m):
        total, d = JModularLoss(cfg)({src_key: img, "rendered_mask": m},
                                     {"image": jnp.asarray(y)})
        return total, d

    (jtotal, jd), (jg_img, jg_mask) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jnp.asarray(x),
                                              jnp.asarray(mask))
    assert float(np.abs(np.asarray(jg_mask)).max()) == 0

    t_cfg = {name: dict(cfg[name], weights_npz=npz[net])}
    img = torch.from_numpy(x).requires_grad_()
    m = torch.from_numpy(mask).requires_grad_()
    ttotal, td = TModularLoss(t_cfg)({src_key: img, "rendered_mask": m},
                                     {"image": torch.from_numpy(y)})
    ttotal.backward()
    assert set(td) == set(jd)
    for k in jd:
        np.testing.assert_allclose(td[k].item(), float(jd[k]), rtol=RTOL,
                                   err_msg=k)
    assert m.grad is None
    ref = np.asarray(jg_img)
    np.testing.assert_allclose(img.grad.numpy(), ref, rtol=GRAD_RTOL,
                               atol=GRAD_RTOL * float(np.abs(ref).max()))
    # the clip's bounds: half the gradient at exactly 0 and 255, none beyond
    at_bound = (x == 0.0) | (x == 255.0)
    assert float(np.abs(ref[at_bound]).max()) > 0
    assert float(np.abs(ref[(x < 0) | (x > 255)]).max()) == 0

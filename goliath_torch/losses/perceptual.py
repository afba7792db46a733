"""Perceptual losses (port of the JAX package's losses/perceptual.py).

VGG19 5-slice masked feature L1 (weights [20, 5, .9, .5, .5]) and an
EfficientNet-B0 3-stage masked feature L1 (weights [.8, .1, .1]), on images
normalized from [0, 255] with the ImageNet mean and deviation.

Feature weights are read from an ``.npz`` (the JAX package's layout:
``conv{i}_w`` / ``conv{i}_b`` in OIHW for VGG19; ``stem_w/b`` and
``mb{j}_{expand,dw,se1,se2,proj}_w/b`` with BatchNorm folded in for
EfficientNet-B0) named by the loss config's ``weights_npz`` or by
``GOLIATH_TORCH_VGG19_NPZ`` / ``GOLIATH_TORCH_EFFNET_NPZ``. Without weights a
loss refuses to be built unless random features are asked for: the loss
config's ``allow_random_features: true`` (for that loss alone) or
``GOLIATH_TORCH_ALLOW_RANDOM_FEATURES=1``. Random features are drawn from a
``torch.Generator`` with the JAX package's seeds (1234 for VGG19, 4321 for
EfficientNet-B0) and He scales: their cost is that of the real networks,
their values are not ImageNet's, and a run trained on them does not reach
the reference's quality.

Ties are differentiated as the JAX package does: ``jnp.clip`` and
``jnp.maximum`` give half the gradient to each side where the two are equal
(``torch.clamp`` and ``torch.relu`` give all or none), which matters at a
render's background pixels, exactly 0 before the normalization's clip.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from goliath_torch.losses import _abs, register_loss
from goliath_torch.utils.image import clip, erode
from goliath_torch.utils.sampling import interpolate_bilinear

logger = logging.getLogger(__name__)

ALLOW_RANDOM_ENV = "GOLIATH_TORCH_ALLOW_RANDOM_FEATURES"
VGG19_ENV = "GOLIATH_TORCH_VGG19_NPZ"
EFFNET_ENV = "GOLIATH_TORCH_EFFNET_NPZ"
VGG19_SEED, EFFNET_SEED = 1234, 4321

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)

# VGG19 conv ladder of torchvision's ``features`` 0-29: the 5 feature maps
# are relu1_1, relu2_1, relu3_1, relu4_1 and relu5_1, after convs 0, 2, 4, 8
# and 12 of the 13 convs reached
_VGG19_CONVS = [64, 64, 128, 128, 256, 256, 256, 256, 512, 512, 512, 512,
                512]
_VGG19_POOL_BEFORE = {2, 4, 8, 12}
_VGG19_SLICE_AFTER = {0, 2, 4, 8, 12}

# EfficientNet-B0 features[0..3]: the stem (cin, cout, kernel, stride) and
# the MBConv blocks (cin, expand, kernel, stride, cout, se_squeeze); the
# features are taken after blocks 0, 2 and 4
_B0_STEM = (3, 32, 3, 2)
_B0_BLOCKS = [
    (32, 1, 3, 1, 16, 8),
    (16, 6, 3, 2, 24, 4),
    (24, 6, 3, 1, 24, 6),
    (24, 6, 5, 2, 40, 6),
    (40, 6, 5, 1, 40, 10),
]
_B0_STAGE_AFTER_BLOCK = {0, 2, 4}

Weights = Dict[str, torch.Tensor]


def weights_source(net: str, env_var: str, path: Optional[str],
                   allow_random: bool) -> Optional[str]:
    """The ``.npz`` that ``net``'s weights come from (``path``, else the
    environment variable ``env_var``), or None for random features, which
    are taken only when ``allow_random`` or ALLOW_RANDOM_ENV=1 asks for
    them."""
    path = path or os.environ.get(env_var, "")
    if path:
        if not os.path.exists(path):
            raise FileNotFoundError(f"{net} weights {path!r} not found")
        return path
    if allow_random or os.environ.get(ALLOW_RANDOM_ENV) == "1":
        logger.warning(
            "%s pretrained weights unavailable (set %s); using fixed-seed "
            "RANDOM features: training quality will NOT match the "
            "reference.", net, env_var)
        return None
    raise RuntimeError(
        f"{net} pretrained weights not found: set {env_var} or the loss's "
        "`weights_npz` to an .npz of them. Training against random features "
        "silently diverges from reference quality; to accept that for a "
        f"smoke run, set {ALLOW_RANDOM_ENV}=1 or `allow_random_features: "
        "true` in the loss config.")


def _load_npz(path: str) -> Weights:
    with np.load(path) as data:
        logger.info(f"loaded perceptual weights from {path}")
        return {k: torch.from_numpy(np.asarray(data[k], np.float32))
                for k in data.files}


def _he_normal(gen: torch.Generator, shape: Tuple[int, ...], fan_in: int
               ) -> torch.Tensor:
    return torch.randn(shape, generator=gen) * float(np.sqrt(2.0 / fan_in))


def vgg19_weights(path: Optional[str] = None) -> Weights:
    """The VGG19 convs' ``conv{i}_w`` / ``conv{i}_b`` from ``path``, or
    random ones from VGG19_SEED when it is None."""
    if path is not None:
        return _load_npz(path)
    gen = torch.Generator().manual_seed(VGG19_SEED)
    ws, cin = {}, 3
    for i, cout in enumerate(_VGG19_CONVS):
        ws[f"conv{i}_w"] = _he_normal(gen, (cout, cin, 3, 3), cin * 9)
        ws[f"conv{i}_b"] = torch.zeros(cout)
        cin = cout
    return ws


def effnet_weights(path: Optional[str] = None) -> Weights:
    """EfficientNet-B0 features[0..3] with BatchNorm folded (``stem_w/b``;
    per block j ``mb{j}_expand_w/b`` unless its expansion is 1, and
    ``mb{j}_{dw,se1,se2,proj}_w/b``) from ``path``, or random ones from
    EFFNET_SEED when it is None."""
    if path is not None:
        return _load_npz(path)
    gen = torch.Generator().manual_seed(EFFNET_SEED)
    cin, cout, k, _ = _B0_STEM
    ws = {"stem_w": _he_normal(gen, (cout, cin, k, k), cin * k * k),
          "stem_b": torch.zeros(cout)}
    for j, (cin, exp, k, _s, cout, sq) in enumerate(_B0_BLOCKS):
        mid = cin * exp
        shapes = ([("expand", (mid, cin, 1, 1), cin)] if exp != 1 else []) + [
            ("dw", (mid, 1, k, k), k * k), ("se1", (sq, mid, 1, 1), mid),
            ("se2", (mid, sq, 1, 1), sq), ("proj", (cout, mid, 1, 1), mid)]
        for name, shape, fan_in in shapes:
            ws[f"mb{j}_{name}_w"] = _he_normal(gen, shape, fan_in)
            ws[f"mb{j}_{name}_b"] = torch.zeros(shape[0])
    return ws


def normalize_imagenet(batch: torch.Tensor) -> torch.Tensor:
    """[B, 3, H, W] in [0, 255] -> clipped to [0, 1], ImageNet-normalized
    (``jnp.clip``'s half gradient at 0 and 1 kept)."""
    mean = batch.new_tensor(_IMAGENET_MEAN).reshape(1, 3, 1, 1)
    std = batch.new_tensor(_IMAGENET_STD).reshape(1, 3, 1, 1)
    return (clip(batch / 255.0, 0.0, 1.0) - mean) / std


def vgg19_features(x: torch.Tensor, ws: Weights) -> List[torch.Tensor]:
    feats, h = [], x
    for i in range(len(_VGG19_CONVS)):
        if i in _VGG19_POOL_BEFORE:
            h = F.max_pool2d(h, 2)
        h = F.conv2d(h, ws[f"conv{i}_w"], ws[f"conv{i}_b"], padding=1)
        h = torch.maximum(h, h.new_zeros(()))   # jnp.maximum's ties
        if i in _VGG19_SLICE_AFTER:
            feats.append(h)
    return feats


def _conv(x: torch.Tensor, ws: Weights, name: str, stride: int = 1,
          groups: int = 1) -> torch.Tensor:
    w = ws[f"{name}_w"]
    return F.conv2d(x, w, ws[f"{name}_b"], stride=stride,
                    padding=(w.shape[-1] - 1) // 2, groups=groups)


def effnet_features(x: torch.Tensor, ws: Weights) -> List[torch.Tensor]:
    """The stem and the 5 MBConv blocks (expansion, depthwise conv,
    squeeze-excitation, linear projection, the skip where shapes allow; the
    depthwise convs as grouped convolutions)."""
    h = F.silu(_conv(x, ws, "stem", stride=_B0_STEM[3]))
    feats = []
    for j, (cin, exp, _k, s, cout, _sq) in enumerate(_B0_BLOCKS):
        inp = h
        if exp != 1:
            h = F.silu(_conv(h, ws, f"mb{j}_expand"))
        h = F.silu(_conv(h, ws, f"mb{j}_dw", stride=s, groups=cin * exp))
        se = F.silu(_conv(h.mean((2, 3), keepdim=True), ws, f"mb{j}_se1"))
        h = h * torch.sigmoid(_conv(se, ws, f"mb{j}_se2"))
        h = _conv(h, ws, f"mb{j}_proj")
        if s == 1 and cin == cout:
            h = h + inp   # stochastic depth is the identity in eval mode
        if j in _B0_STAGE_AFTER_BLOCK:
            feats.append(h)
    return feats


class _MaskedFeatureL1:
    """Sum over feature maps of weight * mean |(f(x) - f(y)) * mask|, the
    mask bilinearly resampled to each map and detached. The weights live
    on the host until the first call puts them on the images' device."""

    features = staticmethod(vgg19_features)

    def __init__(self, weights: Weights, slice_weights: List[float]):
        self.weights = slice_weights
        self._host, self._on = weights, {}

    def on(self, device: torch.device) -> Weights:
        if device not in self._on:
            self._on[device] = {k: v.to(device)
                                for k, v in self._host.items()}
        return self._on[device]

    def __call__(self, x: torch.Tensor, y: torch.Tensor, mask=None
                 ) -> torch.Tensor:
        ws = self.on(x.device)
        fx = self.features(normalize_imagenet(x), ws)
        fy = self.features(normalize_imagenet(y), ws)
        loss = x.new_zeros(())
        for w, a, b in zip(self.weights, fx, fy):
            m = 1.0
            if isinstance(mask, torch.Tensor):
                m = interpolate_bilinear(mask.to(a.dtype),
                                         size=tuple(a.shape[-2:])).detach()
            loss = loss + w * torch.mean(_abs((a - b) * m))
        return loss


class VGGLossMasked(_MaskedFeatureL1):
    """Masked VGG19 feature L1 over relu1_1 ... relu5_1."""

    def __init__(self, weights: Weights,
                 slice_weights: Optional[List[float]] = None):
        super().__init__(weights, slice_weights or [20.0, 5.0, 0.9, 0.5, 0.5])


class EfficientNetLoss(_MaskedFeatureL1):
    """Masked EfficientNet-B0 stage feature L1."""

    features = staticmethod(effnet_features)

    def __init__(self, weights: Weights,
                 slice_weights: Optional[List[float]] = None):
        super().__init__(weights, slice_weights or [0.8, 0.1, 0.1])


class BasePerceptualLoss:
    """``net(preds[src_key], targets[tgt_key] or preds[dst_key], mask)``,
    the mask read from the targets or else the predictions, optionally
    eroded. ``allow_random_features`` lets this loss alone take random
    features when no weights are given."""

    net_name = env_var = ""

    def __init__(self, assets, src_key="rendered_rgb", tgt_key="image",
                 dst_key=None, mask_key="image_mask", mask_erode=None,
                 allow_random_features=False, weights_npz=None):
        self.src_key, self.tgt_key, self.dst_key = src_key, tgt_key, dst_key
        self.mask_key, self.mask_erode = mask_key, mask_erode
        self.weights_path = weights_source(self.net_name, self.env_var,
                                           weights_npz, allow_random_features)
        self.net = self.make_net(self.weights_path)

    def make_net(self, path: Optional[str]):
        raise NotImplementedError

    def __call__(self, preds, targets):
        fg_mask = (targets[self.mask_key] if self.mask_key in targets
                   else preds[self.mask_key])
        if self.mask_erode is not None:
            fg_mask = erode(fg_mask, self.mask_erode)
        src = preds[self.src_key]
        tgt = (targets[self.tgt_key] if self.dst_key is None
               else preds[self.dst_key])
        return self.net(src, tgt, fg_mask)


@register_loss("vgg")
class VGGLoss(BasePerceptualLoss):
    net_name, env_var = "VGG19", VGG19_ENV

    def make_net(self, path):
        return VGGLossMasked(vgg19_weights(path))


@register_loss("effnet")
class EfficientNetLossImpl(BasePerceptualLoss):
    net_name, env_var = "EfficientNet-B0", EFFNET_ENV

    def make_net(self, path):
        return EfficientNetLoss(effnet_weights(path))


@register_loss("effnet_phys")
class EfficientNetLossImplPhys(EfficientNetLossImpl):
    def __init__(self, assets, **kwargs):
        super().__init__(assets, src_key="rendered_phys_rgb", **kwargs)

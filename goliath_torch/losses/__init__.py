"""Modular loss system (port of the JAX package's losses/__init__.py).

A string registry maps loss names to constructors ``(assets, **kwargs) ->
callable(preds, targets) -> scalar``. ``ModularLoss`` aggregates the losses
of a config's ``loss.losses`` section with fixed weights or schedules.

Ported: every loss the RGCA configs name, for eval and training (rgb_l1,
rgb_l2, rgb_ssim, psnr, mask_l1, geom_l2, the Laplacian and region geometry
losses, kl, face_kl, learn_blur, backlit_reg, l2_reg, list_l1_reg,
bound_primscale, negcolor, primvolsum, alphaprior), mesh_vae's
pose_shadow_l2, URHand's rgb_l1_focus and rgb_l1_phys, region_rgb_l1, and
the perceptual losses vgg, effnet and effnet_phys (``losses/perceptual.py``,
which registers itself on import). ``.detach()`` stands where the JAX
package has ``stop_gradient``.
"""

from __future__ import annotations

import copy
import logging
import math
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from goliath_torch.config import load_from_config
from goliath_torch.utils.image import absolute as _abs
from goliath_torch.utils.image import erode
from goliath_torch.utils.ssim import ssim

logger = logging.getLogger(__name__)

loss_registry: Dict[str, Callable] = {}


def register_loss_by_fn(loss_name: Optional[str] = None):
    def _register(fn):
        name = loss_name or fn.__name__
        if name in loss_registry:
            logger.warning(f"loss {name} already registered")

        def ctor(assets, **kwargs):
            def call(preds, targets):
                return fn(preds, targets, **kwargs)

            return call

        loss_registry[name] = ctor
        return fn

    return _register


def register_loss(loss_name: str):
    """Register a class ``(assets, **kwargs) -> callable(preds, targets)``."""

    def _register(cls):
        if loss_name in loss_registry:
            logger.warning(f"loss {loss_name} already registered")
        loss_registry[loss_name] = cls
        return cls

    return _register


def get_loss(name: str, assets=None, init_kwargs: Optional[Dict] = None):
    if name not in loss_registry:
        raise ValueError(f"loss {name} not registered!")
    return loss_registry[name](assets, **(init_kwargs or {}))


# ---------------------------------------------------------------------------
# weight schedules
# ---------------------------------------------------------------------------


class StepWeightSchedule:
    def __init__(self, start: int, end: int, value: float):
        self.start, self.end, self.value = start, end, value

    def __call__(self, iteration) -> float:
        return self.value if self.start <= iteration <= self.end else 0.0


class MonotonicWeightSchedule:
    def __init__(self, start: int, end: int, init_value: float,
                 target_value: float):
        self.start, self.end = start, end
        self.init_value, self.target_value = init_value, target_value
        self.delta = (target_value - init_value) / (end - start)

    def __call__(self, iteration) -> float:
        t = min(max(float(iteration), self.start), self.end) - self.start
        return self.init_value + t * self.delta


class CyclicWeightSchedule:
    def __init__(self, cycle: int, min_value: float, max_value: float):
        self.cycle, self.min_value, self.max_value = cycle, min_value, max_value
        self.delta = (max_value - min_value) / cycle

    def __call__(self, iteration) -> float:
        it = float(iteration) % (self.cycle * 2)
        return min(self.min_value + self.delta * it, self.max_value)


# ---------------------------------------------------------------------------
# ModularLoss
# ---------------------------------------------------------------------------


class ModularLoss:
    """Aggregates named losses with weights / schedules / iteration gating.

    ``iteration`` is a host integer, so the schedules and the start/end
    gates are plain Python (the JAX package keeps them traceable for jit)."""

    def __init__(self, losses: Mapping[str, Any], assets=None):
        self.weights: Dict[str, float] = {}
        self.schedule: Dict[str, Any] = {}
        self.start_at: Dict[str, int] = {}
        self.end_at: Dict[str, int] = {}
        self.fns: Dict[str, Callable] = {}

        for loss_name, loss_def in losses.items():
            loss_def = copy.deepcopy(loss_def)
            init_kwargs: Dict[str, Any] = {}
            loss_class_name = loss_name
            if isinstance(loss_def, Mapping):
                loss_def = dict(loss_def)
                init_kwargs = dict(loss_def.pop("init_kwargs", {}))
                if "loss_type" in loss_def:
                    loss_class_name = loss_def.pop("loss_type")
                if "weight" in loss_def:
                    self.weights[loss_name] = float(loss_def.pop("weight"))
                elif "schedule" in loss_def:
                    self.schedule[loss_name] = load_from_config(
                        loss_def.pop("schedule"))
                else:
                    raise ValueError(
                        f"loss {loss_name} needs weight or schedule")
                if "start_at" in loss_def:
                    self.start_at[loss_name] = loss_def.pop("start_at")
                if "end_at" in loss_def:
                    self.end_at[loss_name] = loss_def.pop("end_at")
                init_kwargs.update(**loss_def)
            elif isinstance(loss_def, (float, int)):
                self.weights[loss_name] = float(loss_def)
            else:
                raise ValueError(f"unsupported loss definition: {loss_def!r}")
            self.fns[loss_name] = get_loss(loss_class_name, assets, init_kwargs)

    def __call__(self, preds, targets, iteration: Optional[int] = None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        loss_total = None
        losses_dict: Dict[str, torch.Tensor] = {}
        for loss_name, loss_fn in self.fns.items():
            value = loss_fn(preds, targets)
            losses_dict[f"loss_{loss_name}"] = value
            if loss_name in self.weights:
                weight = self.weights[loss_name]
            else:
                if iteration is None:
                    raise ValueError(f"loss {loss_name} has a schedule and "
                                     "needs `iteration`")
                weight = self.schedule[loss_name](iteration)
            if iteration is not None and loss_name in self.start_at:
                weight *= float(iteration >= self.start_at[loss_name])
            if iteration is not None and loss_name in self.end_at:
                weight *= float(iteration <= self.end_at[loss_name])
            term = weight * value
            loss_total = term if loss_total is None else loss_total + term
        if loss_total is None:
            loss_total = torch.zeros(())
        losses_dict["loss_total"] = loss_total
        return loss_total, losses_dict


# ---------------------------------------------------------------------------
# registered losses
# ---------------------------------------------------------------------------


def kl_loss(mu, logvar):
    return -0.5 * torch.mean(1.0 + logvar - mu**2 - torch.exp(logvar))


def compute_laplacian(x, nbs_idxs, nbs_weights):
    return x + (x[:, nbs_idxs] * nbs_weights[None, :, :, None]).sum(2)


def _get_mask(preds, targets, mask_key, like, mask_erode=None,
              ddisc_key="depth_disc_mask"):
    mask = targets.get(mask_key, preds.get(mask_key, None))
    if mask is None:
        mask = torch.ones_like(like)
    mask = mask.to(like.dtype)
    if mask_erode is not None:
        mask = erode(mask, mask_erode)
    if ddisc_key in preds:
        mask = mask * (1.0 - preds[ddisc_key].to(like.dtype))
    return mask


class _TopologyLoss:
    """Base of the losses that read the mesh topology from the assets. The
    neighbour tables follow the device of the tensors they meet."""

    def __init__(self, assets, region_mask_name=None):
        topo = assets.topology
        self.nbs_idxs = torch.from_numpy(np.asarray(topo.nbs_idxs)).long()
        self.nbs_weights = torch.from_numpy(
            np.asarray(topo.nbs_weights, np.float32))
        self.weight_mask = None
        if region_mask_name is not None:
            self.weight_mask = torch.from_numpy(
                np.asarray(assets[region_mask_name], np.float32))

    def _to(self, device):
        if self.nbs_idxs.device != device:
            self.nbs_idxs = self.nbs_idxs.to(device)
            self.nbs_weights = self.nbs_weights.to(device)
            if self.weight_mask is not None:
                self.weight_mask = self.weight_mask.to(device)

    def laplacian(self, x):
        self._to(x.device)
        return compute_laplacian(x, self.nbs_idxs, self.nbs_weights)

    def region(self, x):
        self._to(x.device)
        return x * self.weight_mask[None, :, None]


@register_loss("geom_lap")
class LaplacianLoss(_TopologyLoss):
    def __init__(self, assets, src_key="geom", tgt_key="registration_vertices"):
        super().__init__(assets)
        self.src_key, self.tgt_key = src_key, tgt_key

    def __call__(self, preds, targets):
        lp = self.laplacian(preds[self.src_key])
        lt = self.laplacian(targets[self.tgt_key])
        return torch.mean((lp - lt) ** 2)


@register_loss("geom_lap_penalty")
class LaplacianPenaltyLoss(_TopologyLoss):
    def __init__(self, assets, src_key="geom"):
        super().__init__(assets)
        self.src_key = src_key

    def __call__(self, preds, targets):
        lp = self.laplacian(preds[self.src_key])
        return torch.mean(torch.mean(lp**2, dim=-1))


@register_loss("geom_lap_template")
class LaplacianTemplateLoss(_TopologyLoss):
    def __init__(self, assets, src_key="geom", dst_key="geom_template_posed"):
        super().__init__(assets)
        self.src_key, self.dst_key = src_key, dst_key

    def __call__(self, preds, targets):
        lp = self.laplacian(preds[self.src_key])
        lt = self.laplacian(preds[self.dst_key].detach())
        return torch.mean((lp - lt) ** 2)


@register_loss("region_geom_l2")
class RegionGeomL2Loss(_TopologyLoss):
    def __init__(self, assets, region_mask_name, src_key="geom",
                 tgt_key="registration_vertices"):
        super().__init__(assets, region_mask_name)
        self.src_key, self.tgt_key = src_key, tgt_key

    def __call__(self, preds, batch):
        return torch.mean(
            self.region(preds[self.src_key] - batch[self.tgt_key]) ** 2)


@register_loss("region_lap")
class RegionLaplacianLoss(_TopologyLoss):
    def __init__(self, assets, region_mask_name, src_key="geom",
                 tgt_key="registration_vertices"):
        super().__init__(assets, region_mask_name)
        self.src_key, self.tgt_key = src_key, tgt_key

    def __call__(self, preds, batch):
        lp = self.laplacian(preds[self.src_key])
        lt = self.laplacian(batch[self.tgt_key])
        return torch.mean(self.region(lp - lt) ** 2)


@register_loss("region_lap_penalty")
class RegionLaplacianPenaltyLoss(_TopologyLoss):
    def __init__(self, assets, region_mask_name, src_key="geom"):
        super().__init__(assets, region_mask_name)
        self.src_key = src_key

    def __call__(self, preds, batch):
        return torch.mean(
            self.region(self.laplacian(preds[self.src_key])) ** 2)


@register_loss("head_geom_l2")
class HeadGeomL2Loss(RegionGeomL2Loss):
    def __init__(self, assets, **kwargs):
        super().__init__(assets, region_mask_name="full_head_mask_geom",
                         **kwargs)


@register_loss("head_lap")
class HeadLaplacianLoss(RegionLaplacianLoss):
    def __init__(self, assets, **kwargs):
        super().__init__(assets, region_mask_name="full_head_mask_geom",
                         **kwargs)


@register_loss("mouth_eyes_lap_penalty")
class MouthEyesLaplacianLoss(RegionLaplacianPenaltyLoss):
    def __init__(self, assets, **kwargs):
        super().__init__(assets, region_mask_name="mouth_eyes_mask_geom",
                         **kwargs)


@register_loss_by_fn("geom_l2")
def loss_geom_l2(preds, targets, src_key="geom",
                 tgt_key="registration_vertices", dst_key=None):
    src = preds[src_key]
    tgt = preds[dst_key].detach() if dst_key is not None else targets[tgt_key]
    return torch.mean((src - tgt) ** 2)


@register_loss_by_fn()
def rgb_l2(preds, targets, src_key="rendered_rgb", tgt_key="image",
           mask_key="image_mask", ddisc_key="depth_disc_mask", mask_erode=None):
    mask = _get_mask(preds, targets, mask_key, preds[src_key], mask_erode,
                     ddisc_key)
    return torch.mean(((preds[src_key] - targets[tgt_key]) * mask) ** 2)


@register_loss_by_fn()
def rgb_l1(preds, targets, src_key="rendered_rgb", tgt_key="image",
           mask_key="image_mask", ddisc_key="depth_disc_mask", mask_erode=None):
    mask = _get_mask(preds, targets, mask_key, preds[src_key], mask_erode,
                     ddisc_key)
    return torch.mean(_abs((preds[src_key] - targets[tgt_key]) * mask))


@register_loss_by_fn()
def psnr(preds, targets, src_key="rendered_rgb", tgt_key="image",
         mask_key="image_mask", data_range=1.0, ddisc_key="depth_disc_mask",
         mask_erode=None):
    mask = _get_mask(preds, targets, mask_key, preds[src_key], mask_erode,
                     ddisc_key)
    msqerr = torch.mean(((preds[src_key] - targets[tgt_key]) * mask) ** 2)
    psnr_base_e = 2 * math.log(data_range) - torch.log(msqerr)
    return psnr_base_e * (10.0 / math.log(10.0))


@register_loss_by_fn()
def mask_l1(preds, targets, src_key="rendered_mask", tgt_key="image_mask"):
    return torch.mean(_abs(preds[src_key] - targets[tgt_key]))


@register_loss("region_rgb_l1")
class RegionRGBL1Loss:
    """Sum of |rgb - image| over the foreground segmentation times the
    rendered region mask (no gradient through the region mask), over 1 plus
    the mask's sum."""

    def __init__(self, assets, src_key="rgb", tgt_key="image",
                 mask_key="seg_fg", region_mask_key="rendered_region_mask"):
        self.src_key, self.tgt_key = src_key, tgt_key
        self.mask_key, self.region_mask_key = mask_key, region_mask_key

    def __call__(self, preds, targets):
        mask = targets[self.mask_key] * preds[self.region_mask_key].detach()
        delta = preds[self.src_key] - targets[self.tgt_key]
        return torch.sum(_abs(delta * mask)) / (1.0 + torch.sum(mask))


@register_loss_by_fn()
def rgb_ssim(preds, targets, src_key="rendered_rgb", tgt_key="image",
             mask_key="image_mask", normalize_mask=True):
    mask = targets.get(mask_key, preds.get(mask_key, None))
    if mask is None:
        mask = torch.ones_like(preds[src_key])
    if normalize_mask:
        return 1.0 - ssim(targets[tgt_key], preds[src_key], mask=mask)
    return 1.0 - ssim(mask * targets[tgt_key], mask * preds[src_key])


def _focus_loss(prediction, targets, preds, mask_erode, self_mask):
    """Mean |error| weighted by exp(|error| / 255), the weights taking no
    gradient; the mask is the model's own (detached) rendered mask with
    ``self_mask``, else the target's."""
    if self_mask:
        mask = preds["rendered_mask"].detach()
    else:
        mask = targets["image_mask"]
    mask = mask.to(prediction.dtype)
    if mask_erode is not None:
        mask = erode(mask, mask_erode)
    if "depth_disc_mask" in preds:
        mask = mask * (1.0 - preds["depth_disc_mask"].to(prediction.dtype))
    abs_error = _abs((prediction - targets["image"]) * mask)
    error_weights = torch.exp(abs_error / 255.0).detach()
    return torch.mean(abs_error * error_weights)


@register_loss_by_fn()
def rgb_l1_focus(preds, targets, mask_erode=None, img_blur=False,
                 self_mask=False):
    pred = preds["rendered_rgb_blur"] if img_blur else preds["rendered_rgb"]
    return _focus_loss(pred, targets, preds, mask_erode, self_mask)


@register_loss_by_fn()
def rgb_l1_phys(preds, targets, mask_erode=None, img_blur=False,
                self_mask=False):
    return _focus_loss(preds["rendered_phys_rgb"], targets, preds, mask_erode,
                       self_mask)


@register_loss_by_fn("learn_blur")
def learn_blur_reg_loss(preds, batch=None):
    return torch.mean(_abs(preds["learn_blur_weights"] - 1.0))


@register_loss_by_fn("kl")
def loss_kl(preds, batch=None, prefix="embs_"):
    return kl_loss(preds[f"{prefix}mu"], preds[f"{prefix}logvar"])


@register_loss_by_fn("face_kl")
def loss_face_kl(preds, batch=None, prefix="face_embs_"):
    return kl_loss(preds[f"{prefix}mu"], preds[f"{prefix}logvar"])


@register_loss_by_fn("pose_shadow_l2")
def pose_to_shadow_l2_loss(preds, batch=None):
    return torch.mean(
        (preds["pose_shadow_map"] - preds["shadow_map"].detach()) ** 2)


@register_loss_by_fn("bound_primscale")
def loss_bound_primscale(preds, batch=None, key="primscale_preclip",
                         min_scale=0.1, max_scale=20.0):
    ps = preds[key]
    return torch.mean(
        torch.where(
            ps < min_scale,
            1.0 / ps.clamp(min=1e-7),
            torch.where(ps > max_scale, (ps - max_scale) ** 2, 0.0),
        )
    )


@register_loss_by_fn("negcolor")
def loss_negcolor(preds, batch=None, key="diff_color"):
    return torch.mean(preds[key].clamp(max=0.0) ** 2)


@register_loss_by_fn("l2_reg")
def loss_l2_reg(preds, batch=None, key="spec_dnml"):
    return torch.mean(preds[key] ** 2)


@register_loss_by_fn("list_l1_reg")
def loss_list_l1_reg(preds, batch=None, key="spec_dnml"):
    loss = 0.0
    for term in preds[key]:
        loss = loss + torch.mean(_abs(term))
    return loss


@register_loss_by_fn("backlit_reg")
def loss_backlit_reg(preds, batch=None, key="color_rand",
                     cos_key="cos_weight"):
    weight = (-preds[cos_key]).clamp(min=0.0) ** 2
    return torch.sum(weight * preds[key].clamp(min=0.0)) / (
        1.0 + torch.sum(weight))


@register_loss_by_fn("primvolsum")
def loss_primvolsum(preds, batch=None, primscale_ref=100.0):
    primscale = preds["primscale"]
    return torch.mean(torch.sum(torch.prod(primscale_ref / primscale, dim=-1),
                                dim=-1))


@register_loss_by_fn("alphaprior")
def loss_alphaprior(preds, batch=None, key="alpha"):
    alpha = preds[key]
    flat = alpha.reshape(alpha.shape[0], -1)
    return torch.mean(
        torch.log(0.1 + flat) + torch.log(0.1 + 1.0 - flat) - (-2.20727))


# perceptual losses register themselves on import
from goliath_torch.losses import perceptual  # noqa: E402,F401

"""Optimizer construction (port of the JAX package's optim.py).

``Adam`` / ``AdamW`` hold a config's optimizer section (``torch.optim.Adam``
class names in configs remap here, see goliath_torch/config.py).
``build_optimizer`` returns the JAX package's chain as one object: scrub
non-finite gradient entries, clip by global norm, then Adam, with
per-module learning rates as ``torch.optim`` param groups keyed on the
top-level module name (``encoder``, ``decoder``, ...), warning about
submodules without a group as the JAX package does.

The arithmetic is optax's: the clip scales by ``clip / norm`` only when
``norm >= clip`` and adds no epsilon to the norm
(``torch.nn.utils.clip_grad_norm_`` adds 1e-6); ``eps`` stands outside the
square root of the bias-corrected second moment, as in ``torch.optim.Adam``;
weight decay is always decoupled (``optax.adamw``), so a non-zero
``weight_decay`` selects ``torch.optim.AdamW`` for either class.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch
import torch.nn as nn

logger = logging.getLogger(__name__)


class Adam:
    def __init__(self, lr: float = 1e-3,
                 betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0,
                 per_module: Optional[Mapping[str, Mapping[str, Any]]] = None):
        self.lr = float(lr)
        self.betas = (float(betas[0]), float(betas[1]))
        self.eps = float(eps)
        self.weight_decay = float(weight_decay)
        self.per_module = dict(per_module or {})

    def make(self, param_groups: List[Dict[str, Any]]
             ) -> torch.optim.Optimizer:
        """The torch optimizer over ``param_groups`` (each with its ``lr``)."""
        if self.weight_decay:
            return torch.optim.AdamW(param_groups, lr=self.lr,
                                     betas=self.betas, eps=self.eps,
                                     weight_decay=self.weight_decay)
        return torch.optim.Adam(param_groups, lr=self.lr, betas=self.betas,
                                eps=self.eps)


class AdamW(Adam):
    """``Adam`` with a default weight decay of 1e-2."""

    def __init__(self, lr: float = 1e-3, betas=(0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 1e-2,
                 per_module=None):
        super().__init__(lr, betas, eps, weight_decay, per_module)


def scrub_nonfinite_(grads: List[torch.Tensor]) -> None:
    """Zero the NaN/Inf entries of each gradient, in place."""
    for g in grads:
        g.nan_to_num_(nan=0.0, posinf=0.0, neginf=0.0)


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float
                         ) -> torch.Tensor:
    """optax's ``clip_by_global_norm`` in place: every gradient becomes
    ``g / norm * max_norm`` when the norm over all of them reaches
    ``max_norm``, and stays as it is below. Returns the norm. No value
    leaves the device."""
    norm = torch.sqrt(torch.stack([g.square().sum() for g in grads]).sum())
    below = norm < max_norm
    div = torch.where(below, torch.ones_like(norm), norm)
    mul = torch.where(below, torch.ones_like(norm),
                      torch.full_like(norm, max_norm))
    for g in grads:
        g.div_(div).mul_(mul)
    return norm


class ChainedOptimizer:
    """scrub -> clip -> Adam over a module's parameters. ``inner`` is the
    ``torch.optim`` optimizer; its param groups carry a ``name``."""

    def __init__(self, inner: torch.optim.Optimizer, clip_grad_norm: float):
        self.inner = inner
        self.clip_grad_norm = float(clip_grad_norm)

    def zero_grad(self) -> None:
        self.inner.zero_grad(set_to_none=True)

    def step(self) -> None:
        """Update from the ``.grad`` of every parameter. A parameter the
        loss did not reach takes a zero gradient (as a parameter of the JAX
        package's tree does), so its moments and decay advance alike."""
        grads = []
        for group in self.inner.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
                grads.append(p.grad)
        with torch.no_grad():
            scrub_nonfinite_(grads)
            clip_by_global_norm_(grads, self.clip_grad_norm)
        self.inner.step()

    def state_dict(self) -> Dict[str, Any]:
        return self.inner.state_dict()

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.inner.load_state_dict(state)


def build_optimizer(cfg: Mapping[str, Any], module: nn.Module,
                    clip_grad_norm: float = 1.0) -> ChainedOptimizer:
    """Build scrub -> clip(1.0) -> (per-module) Adam from a config section
    for the parameters of ``module``."""
    from goliath_torch.config import load_class

    cfg = dict(cfg)
    cls = load_class(cfg.pop("class_name", "goliath_torch.optim.Adam"))
    opt = cls(**cfg)

    if opt.per_module:
        by_top: Dict[str, List[nn.Parameter]] = {}
        for name, p in module.named_parameters():
            by_top.setdefault(name.split(".", 1)[0], []).append(p)
        missing = [k for k in by_top if k not in opt.per_module]
        if missing:
            logger.warning(
                f"submodules without explicit optimizer group: {missing}; "
                f"using base lr {opt.lr}")
        groups = [dict(name=name, params=by_top[name],
                       lr=float(sub.get("lr", opt.lr)))
                  for name, sub in opt.per_module.items() if name in by_top]
        rest = [p for k in missing for p in by_top[k]]
        if rest:
            groups.append(dict(name="__default__", params=rest, lr=opt.lr))
    else:
        groups = [dict(name="__default__", params=list(module.parameters()),
                       lr=opt.lr)]
    return ChainedOptimizer(opt.make(groups), clip_grad_norm)

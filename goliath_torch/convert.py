"""Parameter formats: the JAX package's flax params -> this package's
``state_dict``, and the ``.pt`` checkpoints the port reads and writes.

Modules here carry the flax names (``encoder.tex0.weight_v``) and layouts:
linear weights (out, in), conv weights (out, in, kh, kw), transposed-conv
weights (in, out, kh, kw) and untied biases (C, H, W) are stored alike in
both packages. So the conversion only flattens the tree: RGCA's,
mesh_vae's and URHand's (``decoder_relight`` with its ``geo_refiner``,
``featenc`` with bias-free ``Conv2dWN``s, which carry no ``bias`` entry in
either package, ``joint_conv_block_tex``, ``texmod0_*`` / ``texmod1_*`` and
the two scalars ``global_albedo_scale`` / ``global_scale``; ``cal`` when
present) and the MVP hand's (``poseencoder``, ``geomdecoder`` with its
``transdecoder`` and the ``alphadecoder`` slab, ``rgbdecoder.texdecoder``;
``cal`` and ``learn_blur`` when present), and the OLAT teacher's (the MVP
hand's without ``rgbdecoder``, with ``poseencoder2`` and
``relightdecoder.unet.enc0``-``enc4`` / ``dec0``-``dec4``, untied biases
included). Flax's ``nn.remat`` wrappers of the two slab decoders and of the
teacher's UNet add no level to the tree: their parameters sit under
``geomdecoder.alphadecoder``, ``rgbdecoder.texdecoder`` and
``relightdecoder.unet`` as the port's do.
"""

from __future__ import annotations

import os
from collections import OrderedDict
from typing import Any, Dict, Mapping

import numpy as np
import torch
import torch.nn as nn


def params_from_jax(tree: Mapping[str, Any]) -> "OrderedDict[str, torch.Tensor]":
    """Flax params (nested dict of numpy arrays, with or without the
    top-level ``"params"`` collection) -> a ``state_dict`` whose keys join
    the tree path with dots."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()

    def walk(node: Mapping[str, Any], prefix: str) -> None:
        for k, v in node.items():
            key = f"{prefix}{k}"
            if isinstance(v, Mapping):
                walk(v, key + ".")
            else:
                out[key] = torch.from_numpy(np.array(v, np.float32))

    walk(tree, "")
    return out


def save_params(path: str, module: nn.Module) -> None:
    """Write ``module``'s parameters to a ``.pt`` file."""
    torch.save(module.state_dict(), path)


def load_params(module: nn.Module, path: str) -> None:
    """Load a ``.pt`` file written by ``save_params`` (or ``torch.save`` of
    ``params_from_jax``'s result) into ``module``; keys and shapes must
    match exactly."""
    if os.path.isdir(path) or not str(path).endswith(".pt"):
        raise ValueError(
            f"{path!r} is not a .pt checkpoint of this package. Orbax "
            "checkpoint directories of the JAX package cannot be read "
            "without JAX (ROADMAP queue 1, orbax checkpoint import); convert "
            "them with goliath_torch.convert.params_from_jax in a process "
            "that has JAX, then torch.save the result to a .pt file")
    device = next(module.parameters()).device
    state: Dict[str, torch.Tensor] = torch.load(path, map_location=device,
                                                weights_only=True)
    module.load_state_dict(state, strict=True)


def opt_state_from_jax(optimizer, module: nn.Module, mu: Mapping[str, Any],
                       nu: Mapping[str, Any], count: int) -> None:
    """Load an ``optax.adam`` / ``adamw`` state into the port's optimizer
    (``goliath_torch.optim.ChainedOptimizer``) in place.

    ``mu`` and ``nu`` are the first and second moments as flax-shaped trees
    of numpy arrays over all of ``module``'s parameters, ``count`` the number
    of steps taken. Where the JAX optimizer was built with ``per_module``
    groups, each group's ``ScaleByAdamState`` holds the moments of its own
    parameters only (the others are masked): merge the groups' trees into
    one before the call, in the process that has JAX; their counts are
    equal."""
    mu, nu = params_from_jax(mu), params_from_jax(nu)
    state = optimizer.inner.state
    for name, p in module.named_parameters():
        state[p] = {
            "step": torch.tensor(float(count)),
            "exp_avg": mu[name].to(p.device).reshape(p.shape).clone(),
            "exp_avg_sq": nu[name].to(p.device).reshape(p.shape).clone(),
        }

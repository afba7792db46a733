"""Parameter and checkpoint formats: the JAX package's flax params -> this
package's ``state_dict``; the JAX package's orbax checkpoints, read without
JAX; and the ``.pt`` checkpoints the port writes.

``load_checkpoint`` takes what the JAX package's ``load_checkpoint``
takes: a checkpoint directory (it follows ``latest``), or one checkpoint:
an orbax directory of the JAX package (it holds ``_METADATA``; read with
the ``tensorstore`` package) or a ``.pt`` file of the port (a train state
of ``goliath_torch.train.save_checkpoint``, or parameters alone from
``save_params``).

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
``relightdecoder.unet`` as the port's do. The list modules of nn/layers.py
(``Sequential``, ``ConcatPyramid``) register their members under flax's
names for a list attribute (``layers_0``, ``branch_2``; the index counts
plain callables too), so their trees flatten alike.
"""

from __future__ import annotations

import json
import logging
import os
from collections import OrderedDict
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn as nn

logger = logging.getLogger(__name__)


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


def read_orbax(path: str) -> Dict[str, Any]:
    """The tree of an orbax checkpoint directory (``_METADATA`` beside an
    OCDBT store of zarr arrays, as orbax's ``PyTreeCheckpointer`` writes
    it) as a nested dict of numpy arrays; list indices become string keys
    (``"0"``). Leaves stored as None (optax's empty states, the parameters
    a ``multi_transform`` group masks out) are left out; scalars come back
    as numpy scalars. Reads through ``tensorstore``, without JAX."""
    try:
        import tensorstore as ts
    except ImportError as e:
        raise ImportError(
            f"reading the orbax checkpoint {path!r} needs the tensorstore "
            f"package, which cannot be imported ({e})") from e
    with open(os.path.join(path, "_METADATA")) as f:
        meta = json.load(f)
    if not meta.get("use_ocdbt") or meta.get("use_zarr3"):
        raise ValueError(
            f"{path!r}: only orbax's OCDBT store of zarr v2 arrays is read "
            f"(use_ocdbt={meta.get('use_ocdbt')}, "
            f"use_zarr3={meta.get('use_zarr3')})")
    base = "file://" + os.path.abspath(path)
    leaves = []
    for entry in meta["tree_metadata"].values():
        if entry["value_metadata"]["value_type"] == "None":
            continue
        keys = [str(k["key"]) for k in entry["key_metadata"]]
        leaves.append((keys, ts.open({
            "driver": "zarr",
            "kvstore": {"driver": "ocdbt", "base": base,
                        "path": ".".join(keys)}}, open=True, read=True)))
    reads = [(keys, opened.result().read()) for keys, opened in leaves]
    tree: Dict[str, Any] = {}
    for keys, read in reads:
        arr = read.result()
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = arr[()] if arr.ndim == 0 else arr
    return tree


def _merge_into(dst: Dict[str, Any], src: Mapping[str, Any],
                where: str) -> None:
    for k, v in src.items():
        if isinstance(v, Mapping):
            _merge_into(dst.setdefault(k, {}), v, f"{where}.{k}")
        elif k in dst:
            raise ValueError(f"{where}.{k} is set in two optimizer groups")
        else:
            dst[k] = v


def train_state_from_orbax(tree: Mapping[str, Any]) -> Dict[str, Any]:
    """A train state of the JAX package (``read_orbax`` of what
    ``goliath_tpu.train.save_checkpoint`` writes: ``model``, ``optimizer``,
    ``iteration``) -> ``{"model": state_dict, "adam": {"mu", "nu",
    "count"}, "iteration"}`` (the keys the tree has).

    The optimizer is the JAX package's chain (scrub, clip, Adam): its third
    state is Adam's, or with ``per_module`` groups an
    ``optax.multi_transform`` state with one masked Adam state per group.
    Each parameter's moments are stored in the one group that holds it, so
    the groups' ``mu`` and ``nu`` trees are merged into one each; their
    counts are equal. ``opt_state_from_jax`` takes the result."""
    out: Dict[str, Any] = {"model": params_from_jax(tree["model"])}
    if "iteration" in tree:
        out["iteration"] = int(tree["iteration"])
    if "optimizer" in tree:
        base = tree["optimizer"]["2"]
        if "inner_states" in base:
            states = [g["inner_state"]["0"]
                      for g in base["inner_states"].values()]
        else:
            states = [base["0"]]
        counts = {int(s["count"]) for s in states}
        if len(counts) != 1:
            raise ValueError(f"the optimizer groups' step counts differ: "
                             f"{sorted(counts)}")
        mu: Dict[str, Any] = {}
        nu: Dict[str, Any] = {}
        for s in states:
            _merge_into(mu, s.get("mu", {}), "mu")
            _merge_into(nu, s.get("nu", {}), "nu")
        out["adam"] = {"mu": mu, "nu": nu, "count": counts.pop()}
    return out


def load_checkpoint(path: str, iteration: Optional[int] = None,
                    map_location: Any = None) -> Dict[str, Any]:
    """Read a checkpoint. A directory with ``latest`` stands for the
    checkpoint that ``latest`` names (or, with ``iteration``, its
    ``{iteration:06d}.pt`` or ``{iteration:06d}``). A directory that holds
    ``_METADATA`` is an orbax checkpoint of the JAX package
    (``train_state_from_orbax``); a ``.pt`` file is the port's
    (``torch.load``: a train state with ``model``, ``optimizer`` and
    ``iteration``, or a ``state_dict`` alone). Anything else raises."""
    if os.path.isdir(path) and os.path.exists(os.path.join(path, "latest")):
        if iteration is None:
            with open(os.path.join(path, "latest")) as f:
                name = f.read().strip()
        else:
            name = f"{iteration:06d}.pt"
            if not os.path.exists(os.path.join(path, name)):
                name = f"{iteration:06d}"
        path = os.path.join(path, name)
    logger.info(f"loading checkpoint {path}")
    if os.path.isfile(os.path.join(path, "_METADATA")):
        return train_state_from_orbax(read_orbax(path))
    if os.path.isfile(path) and str(path).endswith(".pt"):
        return torch.load(path, map_location=map_location, weights_only=True)
    raise ValueError(
        f"{path!r} holds no checkpoint: expected a .pt file of this package, "
        "an orbax checkpoint directory of the JAX package (with _METADATA) "
        "or a checkpoint directory with latest")


def load_params(module: nn.Module, path: str) -> None:
    """Load the model parameters of the checkpoint at ``path`` (anything
    ``load_checkpoint`` reads) into ``module``. Parameters of top-level
    submodules that ``module`` lacks are skipped, as the JAX package's
    apply ignores them (``run_test`` drops ``cal`` and ``learn_blur`` from
    the trained model); every other key and shape must match exactly."""
    device = next(module.parameters()).device
    state = load_checkpoint(path, map_location=device)
    if isinstance(state.get("model"), Mapping):
        state = state["model"]
    own = {k.split(".", 1)[0] for k in module.state_dict()}
    skipped = sorted({k.split(".", 1)[0] for k in state} - own)
    if skipped:
        logger.info(f"not loading the checkpoint's {skipped}: the model has "
                    f"no such submodule")
    module.load_state_dict(
        {k: v for k, v in state.items() if k.split(".", 1)[0] in own},
        strict=True)


def opt_state_from_jax(optimizer, module: nn.Module, mu: Mapping[str, Any],
                       nu: Mapping[str, Any], count: int) -> None:
    """Load an ``optax.adam`` / ``adamw`` state into the port's optimizer
    (``goliath_torch.optim.ChainedOptimizer``) in place.

    ``mu`` and ``nu`` are the first and second moments as flax-shaped trees
    of numpy arrays over all of ``module``'s parameters, ``count`` the number
    of steps taken. Where the JAX optimizer was built with ``per_module``
    groups, each group's ``ScaleByAdamState`` holds the moments of its own
    parameters only: ``train_state_from_orbax`` merges them into one tree
    each."""
    mu, nu = params_from_jax(mu), params_from_jax(nu)
    state = optimizer.inner.state
    for name, p in module.named_parameters():
        state[p] = {
            "step": torch.tensor(float(count)),
            "exp_avg": mu[name].to(p.device).reshape(p.shape).clone(),
            "exp_avg_sq": nu[name].to(p.device).reshape(p.shape).clone(),
        }

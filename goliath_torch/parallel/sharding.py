"""Data parallelism over the batch (port of the JAX package's
parallel/sharding.py).

The JAX package compiles one global program over a named device mesh: the
parameters replicated, the batch sharded on its leading axis, and XLA
inserting the gradient allreduce. The port drives every shard from one
process, as the JAX package's single controller does:

  * ``Mesh`` holds named axes and an array of ``torch.device`` of the
    mesh's shape. A device may repeat: four shards on ``cuda:0`` (or on
    ``cpu``) play the role of XLA's forced host device count.
  * ``make_sharded_train_step`` runs each shard's forward on its piece of
    the batch, gathers the predictions on the mesh's first device, and
    takes ONE loss, ONE backward and ONE optimizer step over the one
    parameter set: autograd sums the shards' gradients into it (the JAX
    allreduce). It computes what the unsharded step
    (``goliath_torch.train.make_train_step``) computes on the whole batch.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from goliath_torch.ops.backend import resolve_device


def canonical_device(device) -> torch.device:
    """``device`` with its index: "cuda" names the current card."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """Named axes over an array of devices (the counterpart of
    ``jax.sharding.Mesh``). ``devices`` is a (nested) sequence or an array
    of ``torch.device`` (or device strings) whose shape gives the axes'
    sizes; ``mesh.shape[axis]`` is an axis's size, as in JAX."""

    def __init__(self, devices, axis_names: Sequence[str]):
        arr = np.asarray(devices, dtype=object)
        self.devices = np.vectorize(torch.device, otypes=[object])(arr)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"a mesh of shape {self.devices.shape} needs "
                             f"{self.devices.ndim} axis names, got "
                             f"{self.axis_names}")
        self.shape = dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def axis_devices(self, axis: str,
                     through: Optional[torch.device] = None
                     ) -> List[torch.device]:
        """The devices along ``axis``, on the line of the mesh through the
        first position of ``through`` (through index 0 of every other axis
        when ``through`` is None or not in the mesh)."""
        k = self.axis_names.index(axis)
        at = [0] * self.devices.ndim
        if through is not None:
            line = np.vectorize(canonical_device, otypes=[object])(
                self.devices)
            hits = np.argwhere(line == canonical_device(through))
            if len(hits):
                at = list(hits[0])
        at[k] = slice(None)
        return list(self.devices[tuple(at)])


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "data",
              device: str | torch.device = "cuda") -> Mesh:
    """A 1-D mesh over the first ``n_devices`` devices of ``device``'s kind
    (all of them when None): the visible CUDA devices, or the one CPU. A
    mesh with more shards than devices is built explicitly with ``Mesh``
    (e.g. ``Mesh([torch.device("cuda:0")] * 4, ("data",))``): asking this
    function for more devices than there are raises."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    else:
        devices = [torch.device("cpu")]
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(
                f"{n_devices} devices asked for, {len(devices)} "
                f"{dev.type} device(s) present; build a mesh that repeats a "
                f"device explicitly with Mesh([...] * n, axis_names)")
        devices = devices[:n_devices]
    return Mesh(devices, (axis_name,))


def _split_fields(batch: Dict[str, Any], mesh: Mesh) -> Dict[str, bool]:
    """The JAX rules: list and str fields are dropped; a field whose leading
    dim divides by the mesh's size is split, any other replicated."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, (list, str)):
            continue
        t = torch.as_tensor(v)
        out[k] = t.dim() >= 1 and t.shape[0] % mesh.size == 0
    return out


def shard_batch(batch: Dict[str, Any], mesh: Mesh,
                axis_name: str = "data") -> List[Dict[str, torch.Tensor]]:
    """A host or device batch as one dict per shard of ``mesh[axis_name]``,
    each on its shard's device. As in the JAX package, list and str fields
    are dropped, a field whose leading dim divides by the mesh's size is
    split along it into contiguous pieces, and any other field is
    replicated whole to every shard."""
    devices = mesh.axis_devices(axis_name)
    n = len(devices)
    shards: List[Dict[str, torch.Tensor]] = [{} for _ in devices]
    for k, split in _split_fields(batch, mesh).items():
        t = torch.as_tensor(batch[k])
        for i, dev in enumerate(devices):
            if split:
                m = t.shape[0] // n
                shards[i][k] = t[i * m:(i + 1) * m].to(dev)
            else:
                shards[i][k] = t.to(dev)
    return shards


def replicate(tree: Any, mesh: Mesh) -> List[Any]:
    """One copy of ``tree`` (tensors in nested dicts, lists and tuples) on
    each device of the mesh, in the mesh's order."""

    def to(x, dev):
        if isinstance(x, torch.Tensor):
            return x.to(dev)
        if isinstance(x, dict):
            return {k: to(v, dev) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(to(v, dev) for v in x)
        return x

    return [to(tree, dev) for dev in mesh.devices.flat]


# Predictions that are not batched on axis 0, by key, and how the global
# program reduces them over the batch: "mean", a mean over all of the
# batch's entries (equal shards: the mean of the shards' values). A list
# of batched tensors (URHand's interm_features2reg) is gathered entry by
# entry. Any other unbatched prediction is refused.
UNBATCHED_PREDS = {
    # hand_mvp, hand_teacher: share of the [B, K] prims over the window
    "mvp_window_overflow": "mean",
}


def gather_preds(shard_preds: List[Dict[str, Any]], local_batch: int,
                 family: str, device: torch.device) -> Dict[str, Any]:
    """The global batch's predictions from the shards' (each of
    ``local_batch`` samples) on ``device``: each tensor batched on axis 0
    concatenated in shard order (``.to`` carries the gradient back to each
    shard), lists entry by entry, and the unbatched entries of
    ``UNBATCHED_PREDS`` reduced as the global program would; raises, naming
    ``family`` and the key, for any other."""

    def cat(key, vals):
        if isinstance(vals[0], (list, tuple)):
            return type(vals[0])(cat(f"{key}[{i}]", [v[i] for v in vals])
                                 for i in range(len(vals[0])))
        if not isinstance(vals[0], torch.Tensor):
            raise ValueError(f"{family}: prediction {key!r} is a "
                             f"{type(vals[0]).__name__}, which the sharded "
                             f"step cannot gather")
        if UNBATCHED_PREDS.get(key) == "mean" and vals[0].dim() == 0:
            return torch.stack([v.to(device) for v in vals]).mean()
        if vals[0].dim() == 0 or vals[0].shape[0] != local_batch:
            raise ValueError(
                f"{family}: prediction {key!r} of shape "
                f"{tuple(vals[0].shape)} is not batched on axis 0 (local "
                f"batch {local_batch}) and has no rule for the sharded step")
        return torch.cat([v.to(device) for v in vals])

    return {key: cat(key, [p[key] for p in shard_preds])
            for key in shard_preds[0]}


def make_sharded_train_step(model, loss_fn, optimizer, mesh: Mesh,
                            axis_name: str = "data",
                            donate: bool = True) -> Callable:
    """The data-parallel train step over ``mesh[axis_name]``: returns
    step(batch, iteration) -> (total, loss dict), which updates the model's
    parameters and the optimizer's state in place, as
    ``goliath_torch.train.make_train_step`` does.

    The training draws (the encoders' noise, RGCA's backlit direction) are
    made once for the global batch from the model's generator, as the
    unsharded step makes them, and split with it. The batch is split by
    ``shard_batch``'s rules; each shard's forward runs on its device (the
    model's: a replica of the model on another device is not built, so a
    mesh whose data axis lies on other devices is refused). The
    predictions are gathered on the mesh's first device (``gather_preds``)
    and the loss, its backward and the optimizer step run once there:
    autograd sums every shard's gradient into the one parameter set.

    ``donate`` is accepted for the JAX signature and does nothing: the
    update is in place already, so there is no buffer to donate."""
    del donate
    devices = mesh.axis_devices(axis_name)
    home = mesh.devices.flat[0]
    on_model = canonical_device(model.device)
    if any(canonical_device(d) != on_model for d in devices + [home]):
        raise ValueError(
            f"the sharded step runs each shard on the model's device "
            f"({model.device}); the mesh's {axis_name!r} axis is on "
            f"{[str(d) for d in devices]}: build it of shards on "
            f"{model.device}")
    module = model.module
    family = type(module).__module__
    draws = getattr(module, "training_draws", None)

    def step(batch: Dict[str, Any], iteration: int
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        optimizer.zero_grad()
        batch = {k: torch.as_tensor(v).to(home) for k, v in batch.items()
                 if not isinstance(v, (list, str))}
        split = _split_fields(batch, mesh)
        sizes = {batch[k].shape[0] for k, s in split.items() if s}
        if len(sizes) > 1:
            raise ValueError(f"the split fields' leading dims differ: "
                             f"{sorted(sizes)}; the sharded step splits "
                             f"the batch dim only")
        size = sizes.pop() if sizes else None
        if draws is not None and size is not None:
            batch.update(draws(size, home, batch))
        if size is None:
            # nothing divides by the mesh: the batch is replicated, and
            # every replica would compute the whole of it
            preds = model.apply(batch, train=True)
        else:
            preds = gather_preds(
                [model.apply(s, train=True)
                 for s in shard_batch(batch, mesh, axis_name)],
                size // len(devices), family, home)
        total, ldict = loss_fn(preds, batch, iteration)
        total.backward()
        optimizer.step()
        return total.detach(), {k: v.detach() for k, v in ldict.items()}

    return step

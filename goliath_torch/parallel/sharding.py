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
    the batch and its device: on the model itself where the shard lies on
    the model's device, else on that device's replica of the model
    (``replicate_model``, built once with the step). It gathers the
    predictions on the model's device and takes ONE loss and ONE backward
    there: autograd sums the shards on the model's device into its
    parameters' gradients and carries each other shard's back to its
    replica through ``.to``; the replicas' gradients are then added into
    the model's (the JAX allreduce) and ONE optimizer step runs on the
    model's device. It computes what the unsharded step
    (``goliath_torch.train.make_train_step``) computes on the whole batch.
"""

from __future__ import annotations

import copy
import types
from typing import (Any, Callable, Dict, Iterator, List, Optional, Sequence,
                    Tuple)

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
        """The devices along ``axis``, on the line of the mesh that starts
        at ``through`` (a data shard's own row of a ("data", "tile") mesh,
        whose first column holds the data shards' devices), else the line
        through the first position of ``through``, else the line through
        index 0 of every other axis (``through`` None or not in the
        mesh)."""
        k = self.axis_names.index(axis)
        at = [0] * self.devices.ndim
        if through is not None:
            line = np.vectorize(canonical_device, otypes=[object])(
                self.devices)
            hits = np.argwhere(line == canonical_device(through))
            starts = [h for h in hits if h[k] == 0]
            if len(hits):
                at = list((starts or hits)[0])
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


# What a replica shares with its model instead of copying: values, host
# arrays, the training draws' generator (the draws are made once for the
# global batch on the model's device) and code.
_SHARED = (str, bytes, int, float, complex, bool, type(None), np.ndarray,
           np.generic, torch.dtype, torch.Generator, type, types.ModuleType,
           types.FunctionType, types.BuiltinFunctionType)


def _fields(obj) -> Iterator[Tuple[str, Any]]:
    """(name, value) of what a container or an object holds."""
    if isinstance(obj, dict):
        yield from ((f"[{k!r}]", v) for k, v in obj.items())
    if isinstance(obj, (list, tuple, set, frozenset)):
        yield from ((f"[{i}]", v) for i, v in enumerate(obj))
    if hasattr(obj, "__dict__") and not isinstance(obj, _SHARED):
        yield from ((f".{k}", v) for k, v in vars(obj).items())


def _copy_to(obj, src: torch.device, dev: torch.device,
             memo: Dict[int, Any]):
    """``obj`` with every tensor it reaches copied to ``dev`` (a parameter
    stays a parameter, with its ``requires_grad``) and every
    ``torch.device`` equal to ``src`` replaced by ``dev``; containers and
    objects copied around them, objects reached twice copied once."""
    if id(obj) in memo:
        return memo[id(obj)]
    if isinstance(obj, torch.Tensor):
        moved = obj.detach().to(dev, copy=True)
        new = (torch.nn.Parameter(moved, requires_grad=obj.requires_grad)
               if isinstance(obj, torch.nn.Parameter) else moved)
    elif isinstance(obj, torch.device):
        new = dev if canonical_device(obj) == src else obj
    elif isinstance(obj, _SHARED) or not (
            hasattr(obj, "__dict__")
            or isinstance(obj, (dict, list, tuple, set, frozenset))):
        return obj
    elif isinstance(obj, (tuple, set, frozenset)):
        items = [_copy_to(v, src, dev, memo) for v in obj]
        new = obj._make(items) if hasattr(obj, "_make") else type(obj)(items)
    else:
        new = memo[id(obj)] = copy.copy(obj)
        if isinstance(obj, list):
            new[:] = [_copy_to(v, src, dev, memo) for v in obj]
        elif isinstance(obj, dict):
            for k, v in obj.items():
                new[k] = _copy_to(v, src, dev, memo)
        if hasattr(obj, "__dict__"):
            for k, v in vars(obj).items():
                new.__dict__[k] = _copy_to(v, src, dev, memo)
    memo[id(obj)] = new
    return new


def _check_device_exists(dev: torch.device) -> None:
    if dev.type == "cuda":
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if dev.index >= count:
            raise ValueError(f"cannot replicate the model to {dev}: "
                             f"{count} CUDA device(s) visible")
    elif dev.type != "cpu":
        raise ValueError(f"cannot replicate the model to {dev}: the port "
                         f"runs on cuda and cpu devices only")


def reachable_tensors(obj, name: str = "replica"
                      ) -> Dict[str, torch.Tensor]:
    """Every tensor that ``obj`` reaches through containers and object
    attributes, by the first path (from ``name``) that reaches it."""
    found: Dict[str, torch.Tensor] = {}
    seen, todo = set(), [(name, obj)]
    while todo:
        path, x = todo.pop()
        if id(x) in seen:
            continue
        seen.add(id(x))
        if isinstance(x, torch.Tensor):
            found[path] = x
        else:
            todo.extend(reversed([(path + k, v) for k, v in _fields(x)]))
    return found


def check_replica(replica, device) -> None:
    """Raises, naming the attribute, if a tensor that ``replica`` reaches
    lies on another device than ``device``."""
    dev = canonical_device(device)
    for path, t in reachable_tensors(replica).items():
        if canonical_device(t.device) != dev:
            raise ValueError(f"the replica on {dev} holds {path} on "
                             f"{t.device}")


def replicate_model(model, device):
    """A copy of the model facade ``model`` whose parameters, buffers and
    device-bound tables (every tensor the facade reaches: the geometry's
    UV tables, the skinning's, the renderers') lie on ``device``, and
    whose ``device`` is ``device``. Its parameters hold the model's
    values; it shares the model's generator and host arrays. Raises for a
    device that is not there, and (``check_replica``) for any tensor left
    elsewhere."""
    dev = canonical_device(device)
    _check_device_exists(dev)
    replica = _copy_to(model, canonical_device(model.device), dev, {})
    check_replica(replica, dev)
    return replica


def _named_state(model) -> List[Tuple[str, torch.Tensor]]:
    """The model's parameters then buffers, named."""
    return (list(model.module.named_parameters())
            + list(model.module.named_buffers()))


def sync_replica(model, replica) -> None:
    """Copies the model's parameters and buffers into ``replica``'s and
    clears the replica's gradients."""
    with torch.no_grad():
        for (_, p), (_, r) in zip(_named_state(model),
                                  _named_state(replica)):
            r.copy_(p)
            r.grad = None


def replica_mismatches(want: Dict[str, torch.Tensor], replica
                       ) -> List[str]:
    """The names of ``replica``'s parameters and buffers that ``want``
    (name -> tensor, on any device) holds and that differ from it, bit for
    bit."""
    return [n for n, r in _named_state(replica)
            if n in want and not torch.equal(want[n], r.to(want[n].device))]


def reduce_gradients(model, replicas: Sequence) -> None:
    """Adds each replica's parameter gradients, in the order given, into
    the model's (the data-parallel allreduce)."""
    for replica in replicas:
        for p, r in zip(model.module.parameters(),
                        replica.module.parameters()):
            if r.grad is None:
                continue
            if p.grad is None:
                p.grad = r.grad.to(p.device, copy=True)
            else:
                p.grad += r.grad.to(p.device)


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
    ``shard_batch``'s rules. A shard on the model's device runs on the
    model; a shard on another device runs on that device's replica
    (``replicate_model``, one a device, built here; ``step.replicas`` maps
    each device to it), into which each step first copies the model's
    parameters and buffers. The predictions are gathered on the model's
    device (``gather_preds``) and the loss and its backward run once
    there; the replicas' gradients are added into the model's in shard
    order (``reduce_gradients``), and the optimizer, whose state lives on
    the model's device only, steps once.

    ``donate`` is accepted for the JAX signature and does nothing: the
    update is in place already, so there is no buffer to donate."""
    del donate
    devices = mesh.axis_devices(axis_name)
    home = canonical_device(model.device)
    replicas: Dict[torch.device, Any] = {}
    for d in map(canonical_device, devices):
        if d != home and d not in replicas:
            replicas[d] = replicate_model(model, d)
    module = model.module
    family = type(module).__module__
    draws = getattr(module, "training_draws", None)

    def step(batch: Dict[str, Any], iteration: int
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        optimizer.zero_grad()
        for replica in replicas.values():
            sync_replica(model, replica)
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
                [replicas.get(canonical_device(d), model).apply(
                    s, train=True)
                 for d, s in zip(devices,
                                 shard_batch(batch, mesh, axis_name))],
                size // len(devices), family, home)
        total, ldict = loss_fn(preds, batch, iteration)
        total.backward()
        reduce_gradients(model, list(replicas.values()))
        optimizer.step()
        return total.detach(), {k: v.detach() for k, v in ldict.items()}

    step.replicas = replicas
    return step

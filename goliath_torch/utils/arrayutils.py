"""Array utilities (port of the JAX package's utils/arrayutils.py).

``index`` (a dimension-generic gather), ``to_device`` (a host batch ->
tensors on a device, recursively) and ``ParamHolder`` (a named-key row
lookup over a numpy table; the learnable tables are the parameters of
``nn/color_cal.py``).
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Union

import numpy as np
import torch

# the JAX package's arrays are 32-bit unless x64 is enabled: jnp.asarray
# narrows 64-bit host values, and so does to_device here
_NARROW = {torch.float64: torch.float32, torch.int64: torch.int32,
           torch.complex128: torch.complex64}


def index(x: torch.Tensor, idxs: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` indexed along ``dim`` by the index array ``idxs``: the result
    has ``idxs``' shape in place of that dimension (``jnp.take``)."""
    dim = dim % x.dim()
    return x[(slice(None),) * dim + (torch.as_tensor(idxs).long(),)]


def to_device(batch: Any,
              device: Optional[Union[str, torch.device]] = None) -> Any:
    """Recursively move a host batch to tensors on ``device`` (the default
    device when None). Strings, lists of strings and None stay as they
    are; 64-bit host numbers become 32-bit tensors, as ``jnp.asarray``
    makes them; tensors keep their dtype."""
    if isinstance(batch, dict):
        return {k: to_device(v, device) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        if batch and isinstance(batch[0], str):
            return batch
        return type(batch)(to_device(v, device) for v in batch)
    if isinstance(batch, (str, bytes)) or batch is None:
        return batch
    if isinstance(batch, torch.Tensor):
        return batch.to(device)
    arr = torch.as_tensor(np.asarray(batch))
    return arr.to(device=device, dtype=_NARROW.get(arr.dtype, arr.dtype))


class ParamHolder:
    """Named-key -> row lookup over a numpy table."""

    def __init__(self, shape, keys: Sequence[str],
                 init_value: Optional[np.ndarray] = None):
        if isinstance(shape, int):
            shape = (shape,)
        self.key_list = list(keys)
        self.params = np.zeros((len(self.key_list),) + tuple(shape),
                               np.float32)
        if init_value is not None:
            self.params[:] = init_value

    def to_idx(self, keys: Sequence[str]) -> np.ndarray:
        return np.asarray([self.key_list.index(k) for k in keys], np.int64)

    def from_idx(self, idxs: Sequence[int]) -> list:
        return [self.key_list[i] for i in idxs]

    def __call__(self, idxs: np.ndarray) -> np.ndarray:
        return self.params[np.asarray(idxs)]

"""Scatter-add by sorting (port of the JAX package's ops/scatter.py).

``indexed_add_cf`` sums value columns into target columns. Its sorted branch
sorts by target index, takes the prefix sums of the value rows on the scan
K3 (``gsplat_cuda.cumsum_cols``) and reads each target's sum as the
difference of the prefix at its bounds, with no atomics and so in one
order from run to run. The JAX package takes that branch on its accelerator
when the targets receive fewer than about 8 updates each on average; the
port keeps the same density rule for CUDA tensors and ``_force_sorted`` for
tests, and otherwise uses ``index_add_``.

``take_cols`` is a gather whose backward runs through ``indexed_add_cf``.
"""

from __future__ import annotations

import torch

from goliath_torch.ops import gsplat_cuda
from goliath_torch.ops.backend import target_backend


def indexed_add(indices: torch.Tensor, values: torch.Tensor,
                num_segments: int, _force_sorted: bool = False
                ) -> torch.Tensor:
    """sum values[i] into out[indices[i]]: [P] int, [P, C] -> [N, C]
    (row-major wrapper over ``indexed_add_cf``)."""
    return indexed_add_cf(indices, values.T, num_segments,
                          _force_sorted=_force_sorted).T


def indexed_add_cf(indices: torch.Tensor, values_cf: torch.Tensor,
                   num_segments: int, _force_sorted: bool = False
                   ) -> torch.Tensor:
    """sum values_cf[:, i] into out[:, indices[i]]: [P] int, [C, P] ->
    [C, N] (out-of-range indices are dropped)."""
    C, P = values_cf.shape
    ok = (indices >= 0) & (indices < num_segments)
    use_sorted = _force_sorted or (target_backend(values_cf) == "cuda"
                                   and num_segments * 8 >= P)
    vals = torch.where(ok[None, :], values_cf, 0.0)
    if not use_sorted:
        idx = torch.where(ok, indices, 0).long()
        return values_cf.new_zeros(C, num_segments).index_add_(1, idx, vals)

    key = torch.where(ok, indices, num_segments).to(torch.int32)
    key_s, order = torch.sort(key)
    csum = gsplat_cuda.cumsum_cols(vals.float()[:, order].contiguous())
    # ends[n] = #{i : key_s[i] <= n}: a bincount plus a prefix sum (K4)
    marks = torch.bincount(key_s[key_s < num_segments].long(),
                           minlength=num_segments).to(torch.int32)
    ends = gsplat_cuda.cumsum1d(marks)                          # [N]
    bounds = torch.cat([ends.new_zeros(1), ends]).long()        # [N + 1]
    bvals = torch.where((bounds > 0)[None, :],
                        csum[:, (bounds - 1).clamp(0, P - 1)], 0.0)
    return (bvals[:, 1:] - bvals[:, :-1]).to(values_cf.dtype)


class _TakeCols(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.n = table.shape[1]
        return table[:, idx.long()]

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        flat_g = g.reshape(g.shape[0], -1)                      # [C, P]
        return indexed_add_cf(idx.reshape(-1), flat_g, ctx.n), None


def take_cols(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table [C, N] gathered at idx [...] -> [C, ...]; the gradient with
    respect to ``table`` runs through ``indexed_add_cf``."""
    return _TakeCols.apply(table, idx)
